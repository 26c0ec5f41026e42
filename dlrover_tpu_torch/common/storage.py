"""POSIX checkpoint storage: the port's copy of ``PosixDiskStorage`` from
``dlrover_tpu/common/storage.py`` (local, NFS or FUSE mounts). Writes are
fsynced and moves are atomic, which the manifest chain's commit protocol
relies on. Object stores (``gs://``) are not ported."""

import os
from typing import List

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common.constants import ChaosSite


class PosixDiskStorage:
    def write(self, content, path: str) -> None:
        mode = ("wb" if isinstance(content, (bytes, bytearray, memoryview))
                else "w")
        with open(path, mode) as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())

    def read(self, path: str, mode: str = "rb"):
        if not os.path.exists(path):
            return None
        with open(path, mode) as f:
            return f.read()

    def read_at(self, path: str, offset: int, nbytes: int):
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return None
        try:
            buf = bytearray(nbytes)
            mv = memoryview(buf)
            pos = 0
            while pos < nbytes:
                got = os.preadv(fd, [mv[pos:]], offset + pos)
                if got <= 0:
                    return None
                pos += got
            return buf
        except OSError:
            return None
        finally:
            os.close(fd)

    def write_stripes(self, path: str, total: int, stripes,
                      executor=None) -> None:
        """``stripes``: ``(offset, data, ctx)`` pieces of a ``total``-byte
        file, written with pwrite (on ``executor`` when given). Fires the
        ``storage.persist`` chaos site once per stripe."""
        inj = get_injector()
        fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
        try:
            os.ftruncate(fd, total)

            def _one(offset, data, ctx):
                if inj is not None:
                    inj.fire(ChaosSite.STORAGE_PERSIST, path=path,
                             offset=offset, **(ctx or {}))
                mv = memoryview(data).cast("B")
                pos = 0
                while pos < len(mv):
                    pos += os.pwrite(fd, mv[pos:], offset + pos)

            stripes = list(stripes)
            if executor is None or len(stripes) <= 1:
                for offset, data, ctx in stripes:
                    _one(offset, data, ctx)
            else:
                for f in [executor.submit(_one, *s) for s in stripes]:
                    f.result()
            os.fsync(fd)
        finally:
            os.close(fd)

    def safe_makedirs(self, dir_path: str) -> None:
        os.makedirs(dir_path, exist_ok=True)

    def safe_move(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def listdir(self, path: str) -> List[str]:
        try:
            return sorted(os.listdir(path))
        except OSError:
            return []


def get_checkpoint_storage(ckpt_dir: str = "") -> PosixDiskStorage:
    if ckpt_dir.startswith("gs://"):
        raise NotImplementedError("gs:// checkpoint storage is not ported")
    return PosixDiskStorage()
