"""Shared-memory checkpoint frame: layout, writer and readers.

The port's copy of ``dlrover_tpu/ckpt/shm_handler.py``, byte for byte the
same frame, so the JAX package's agent saver persists a port worker's
frame and either engine restores the other's:

    [0:8)              little-endian uint64 = len(meta)
    [8:8+len(meta))    msgpack meta
    [data_start:...]   tensor bytes at meta-recorded offsets

meta = {"step", "ts", "job", "node_rank", "local_rank", "rank",
"world_size", "expected_frames", "leaves": [{"path", "kind": "array" |
"value", "value" (kind value), "dtype", "gshape", "shards": [{"offset",
"nbytes", "lshape", "start", "crc", "dig", "abs_offset"}]}]}. ``start`` is
the shard's global start index per dimension; ``crc`` (4-byte big-endian
crc32) and ``dig`` (crc32 + adler32, 8 bytes) are stamped per shard.

The writer streams: a buffer may be a numpy array or any object with
``nbytes`` and ``chunks()`` (yielding byte views in order), so a state far
larger than the pinned staging ring passes through it. The crash-safe
order is the reference's: zero the length word, write the data and the
meta, seal by writing the length word last.

A handler's mapped segment is its ``staging`` claim in the memory ledger
(``observability/memory.py``), synced to the mapped size whenever the
segment is created, opened or closed (0: released).

A replica store's copy of a frame goes back into a segment verbatim
(:meth:`SharedMemoryHandler.write_raw`), once :func:`verify_frame_blob`
passed it; a restarted agent unlinks its predecessor's segments
(:func:`cleanup_orphan_segments`).
"""

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common import msgpack
from dlrover_tpu_torch.common.constants import (
    ChaosSite,
    ConfigKey,
    EnvKey,
    env_flag,
    env_str,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import (
    create_shared_memory,
    unlink_shared_memory,
)

_U64 = struct.Struct("<Q")
_CRC = struct.Struct(">I")
_DIG = struct.Struct(">II")
# shards are CRC-stamped and verified on this many threads (zlib releases
# the GIL on large buffers); a staged piece is copied into the segment in
# parts of at least _COPY_PART bytes on up to _COPY_THREADS threads (numpy
# copies release it too)
_CRC_THREADS = 8
_COPY_THREADS = 4
_COPY_PART = 16 << 20


def shard_digest(data) -> bytes:
    """The 8-byte content digest of one shard's bytes, as stamped in
    ``dig``."""
    return _DIG.pack(zlib.crc32(data) & 0xFFFFFFFF,
                     zlib.adler32(data) & 0xFFFFFFFF)


def _crc_enabled() -> bool:
    return env_flag(ConfigKey.CKPT_CRC, default=True)


def shm_name(job_name: str, node_rank: int, local_rank: int,
             incarnation: Optional[str] = None) -> str:
    """Segment name for one worker's frame; ``incarnation`` (default: the
    agent's nonce from the environment) keeps a restarted agent off its
    predecessor's segments."""
    if incarnation is None:
        incarnation = env_str(EnvKey.SHM_INCARNATION)
    base = f"dlrtpu_{job_name}_{node_rank}_{local_rank}"
    return f"{base}_i{incarnation}" if incarnation else base


def cleanup_orphan_segments(job_name: str, node_rank: int,
                            incarnation: Optional[str] = None) -> List[str]:
    """Unlink this node's segments that a previous agent incarnation left
    (another nonce, or none while this one has one); returns their names.
    A crashed agent cannot clean up after itself, and its segments would
    hold ``/dev/shm`` until reboot."""
    if incarnation is None:
        incarnation = env_str(EnvKey.SHM_INCARNATION)
    prefix = f"dlrtpu_{job_name}_{node_rank}_"
    keep_suffix = f"_i{incarnation}" if incarnation else None
    removed: List[str] = []
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return removed
    for name in sorted(names):
        if not name.startswith(prefix):
            continue
        if keep_suffix is not None and name.endswith(keep_suffix):
            continue  # this incarnation's
        if keep_suffix is None and "_i" not in name[len(prefix):]:
            continue  # un-nonced, as this agent runs: its own
        unlink_shared_memory(name)
        removed.append(name)
    if removed:
        logger.warning("unlinked %d orphan shm segment(s) of a previous "
                       "agent incarnation: %s", len(removed), removed)
    return removed


class TensorShard:
    """One contiguous saved shard of one array."""

    def __init__(self, offset: int, nbytes: int, lshape: List[int],
                 start: List[int]):
        self.offset = offset
        self.nbytes = nbytes
        self.lshape = lshape
        self.start = start

    def to_meta(self) -> Dict:
        return {"offset": self.offset, "nbytes": self.nbytes,
                "lshape": self.lshape, "start": self.start}


def pack_frame(meta: Dict) -> bytes:
    meta_bytes = msgpack.packb(meta)
    return _U64.pack(len(meta_bytes)) + meta_bytes


def _chunks_of(b):
    if hasattr(b, "chunks"):
        yield from b.chunks()
    else:
        yield np.ascontiguousarray(b).reshape(-1).view(np.uint8)


def _copy(pool, dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[:] = src``, in parts on ``pool`` when large."""
    n = src.nbytes
    parts = min(_COPY_THREADS, max(1, n // _COPY_PART))
    if parts == 1:
        np.copyto(dst, src)
        return
    cuts = [n * i // parts for i in range(parts + 1)]
    for f in [pool.submit(np.copyto, dst[a:b], src[a:b])
              for a, b in zip(cuts, cuts[1:])]:
        f.result()


class SharedMemoryHandler:
    """Owns one shm segment holding one checkpoint frame."""

    def __init__(self, name: str):
        self._name = name
        self._shm = None
        self._fd = None
        self._fd_shm = None

    @property
    def name(self) -> str:
        return self._name

    def _ledger(self) -> None:
        """Sync this segment's claim in the memory ledger to its mapped
        size (0 = released)."""
        from dlrover_tpu_torch.common.constants import MetricLabel
        from dlrover_tpu_torch.observability.memory import get_accountant

        get_accountant().adjust(
            MetricLabel.MEM_STAGING, f"ckpt_shm/{self._name}",
            int(self._shm.size) if self._shm is not None else 0)

    def _ensure(self, size: int) -> bool:
        if self._shm is not None and self._shm.size >= size:
            return True
        if self._shm is not None:
            self._shm.close()
            self._shm = None
        alloc = max(1024, int(size * 1.05))
        self._shm = create_shared_memory(self._name, create=True, size=alloc)
        self._ledger()
        return self._shm is not None

    def open(self) -> bool:
        if self._shm is not None:
            return True
        self._shm = create_shared_memory(self._name, create=False)
        self._ledger()
        return self._shm is not None

    def close(self) -> None:
        if self._shm is not None:
            self._shm.close()
            self._shm = None
            self._ledger()
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
            self._fd_shm = None

    def unlink(self) -> None:
        self.close()
        unlink_shared_memory(self._name)

    def _shard_fd(self) -> Optional[int]:
        """fd on the segment's /dev/shm file: pread beats walking a large
        mapping page by page."""
        if self._fd is not None and self._fd_shm is self._shm:
            return self._fd
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        try:
            self._fd = os.open("/dev/shm/" + self._shm.name.lstrip("/"),
                               os.O_RDONLY)
            self._fd_shm = self._shm
        except OSError:
            self._fd = None
        return self._fd

    # -- write -------------------------------------------------------------

    def write_frame(self, meta: Dict, buffers: List[Any]) -> None:
        """Write meta + tensor buffers. ``meta['leaves']`` offsets must
        match the order and sizes of ``buffers`` (numpy arrays, or objects
        with ``nbytes`` and ``chunks()``)."""
        compute_crc = _crc_enabled()
        sizes = [int(b.nbytes) for b in buffers]
        if compute_crc:
            # fixed-width CRC slots reserved before sizing the header, so
            # the sealed re-pack keeps every abs_offset
            rel, expected = 0, {}
            for n in sizes:
                expected[rel] = n
                rel += n
            for leaf in meta["leaves"]:
                for shard in leaf.get("shards", []):
                    if expected.get(shard["offset"]) == shard["nbytes"]:
                        shard["crc"] = b"\x00\x00\x00\x00"
                        shard["dig"] = b"\x00" * 8
        header = pack_frame(meta)
        data_start = len(header)
        for leaf in meta["leaves"]:
            for shard in leaf.get("shards", []):
                shard["abs_offset"] = data_start + shard["offset"]
        header = pack_frame(meta)
        while len(header) != data_start:
            data_start = len(header)
            for leaf in meta["leaves"]:
                for shard in leaf.get("shards", []):
                    shard["abs_offset"] = data_start + shard["offset"]
            header = pack_frame(meta)
        total = data_start + sum(sizes)
        if not self._ensure(total):
            raise RuntimeError(f"cannot create shm segment {self._name}")
        buf = self._shm.buf
        dst = np.frombuffer(buf, dtype=np.uint8, count=total)
        try:
            buf[:8] = _U64.pack(0)
            pos = data_start
            spans = []
            with ThreadPoolExecutor(_COPY_THREADS) as copiers:
                for b, n in zip(buffers, sizes):
                    spans.append((pos - data_start, pos, n))
                    end = pos + n
                    for piece in _chunks_of(b):
                        piece = np.frombuffer(piece, dtype=np.uint8)
                        _copy(copiers, dst[pos:pos + piece.nbytes], piece)
                        pos += piece.nbytes
                    if pos != end:
                        raise ValueError(
                            f"buffer wrote {pos - end + n} of {n} bytes")
            if compute_crc:
                with ThreadPoolExecutor(_CRC_THREADS) as pool:
                    digs = dict(zip(
                        (rel for rel, _, _ in spans),
                        pool.map(lambda s: shard_digest(dst[s[1]:s[1] + s[2]]),
                                 spans)))
                for leaf in meta["leaves"]:
                    for shard in leaf.get("shards", []):
                        dig = digs.get(shard["offset"])
                        if dig is not None and "crc" in shard:
                            shard["crc"] = dig[:4]
                            shard["dig"] = dig
                sealed = pack_frame(meta)
                assert len(sealed) == len(header), \
                    "CRC stamp changed header size"
                header = sealed
        finally:
            del dst
        buf[8:len(header)] = header[8:]
        buf[:8] = header[:8]
        self._maybe_inject_corruption(meta)

    def _maybe_inject_corruption(self, meta: Dict) -> None:
        """``shm.write`` injection site: mutate the sealed frame's data as
        bit rot or a torn copy would; the seal stays valid, only the CRCs
        can catch it. A torn write zeroes the tail half of the last shard
        whose tail is not zero already: zeroing a small scalar's high bytes
        (a step counter ends a sorted state) would change nothing."""
        inj = get_injector()
        if inj is None:
            return
        act = inj.fire(ChaosSite.SHM_WRITE, step=meta.get("step"))
        if act is None:
            return
        shards = [(leaf.get("path", "?"), shard)
                  for leaf in meta.get("leaves", [])
                  for shard in leaf.get("shards", [])
                  if "abs_offset" in shard and shard.get("nbytes", 0) > 0]
        if not shards:
            return
        buf = self._shm.buf
        if act["kind"] == "torn":
            # zero the tail half of a shard: a write that stopped partway
            # but was sealed as if complete
            for path, shard in reversed(shards):
                off, n = shard["abs_offset"], shard["nbytes"]
                cut = n // 2
                if np.frombuffer(buf, np.uint8, n - cut, off + cut).any():
                    break
            else:
                return
            buf[off + cut:off + n] = bytes(n - cut)
        else:  # bitflip
            path, shard = shards[0]
            off, n = shard["abs_offset"], shard["nbytes"]
            at = off + int(act.get("rnd", 0.0) * max(1, n - 1))
            buf[at] = buf[at] ^ 0xFF
        logger.warning("chaos: injected %s into shm frame %s shard %r "
                       "(step %s)", act["kind"], self._name, path,
                       meta.get("step"))

    def write_raw(self, blob) -> None:
        """Write a whole sealed frame blob (a replica store's copy) into
        the segment verbatim, in the writer's order: length word last."""
        if not self._ensure(len(blob)):
            raise RuntimeError(f"cannot create shm segment {self._name}")
        buf = self._shm.buf
        buf[:8] = _U64.pack(0)
        np.copyto(np.frombuffer(buf, np.uint8, len(blob) - 8, 8),
                  np.frombuffer(blob, np.uint8, len(blob) - 8, 8))
        buf[:8] = bytes(blob[:8])

    # -- read --------------------------------------------------------------

    @staticmethod
    def _preadv_full(fd, buf, offset: int) -> bool:
        """Read exactly ``len(buf)`` bytes at ``offset`` (one preadv stops
        at ~2 GB)."""
        mv = memoryview(buf).cast("B")
        pos, n = 0, len(mv)
        while pos < n:
            try:
                got = os.preadv(fd, [mv[pos:]], offset + pos)
            except OSError:
                return False
            if got <= 0:
                return False
            pos += got
        return True

    def read_meta(self) -> Optional[Dict]:
        if not self.open():
            return None
        try:
            (meta_len,) = _U64.unpack(bytes(self._shm.buf[:8]))
            if meta_len == 0 or meta_len > self._shm.size:
                return None
            return msgpack.unpackb(bytes(self._shm.buf[8:8 + meta_len]))
        except Exception:  # noqa: BLE001 — torn/empty frame → None
            return None

    def read_shard_bytes(self, shard_meta: Dict):
        """Bytes of one shard (a writable bytearray on the pread path)."""
        if not self.open():
            return None
        off, n = shard_meta["abs_offset"], shard_meta["nbytes"]
        fd = self._shard_fd()
        if fd is not None:
            buf = bytearray(n)
            if self._preadv_full(fd, buf, off):
                return buf
        return bytes(self._shm.buf[off:off + n])

    def read_shard_into(self, shard_meta: Dict, out) -> bool:
        """Read one shard into ``out``, a writable contiguous buffer of
        exactly the shard's size."""
        mv = memoryview(out)
        if mv.nbytes != shard_meta["nbytes"] or not mv.contiguous:
            return False
        return self.read_range_into(shard_meta, 0, mv)

    def read_range_into(self, shard_meta: Dict, lo: int, out) -> bool:
        """Read ``len(out)`` bytes of one shard, from its byte ``lo``, into
        the writable buffer ``out``."""
        if not self.open():
            return False
        mv = memoryview(out).cast("B")
        off = shard_meta["abs_offset"] + lo
        if lo + mv.nbytes > shard_meta["nbytes"]:
            return False
        fd = self._shard_fd()
        if fd is not None and self._preadv_full(fd, mv, off):
            return True
        mv[:] = self._shm.buf[off:off + mv.nbytes]
        return True

    def read_frame_bytes(self):
        """The whole frame (header + data), or None when none is sealed.
        The copy lands in fresh pages that ``preadv`` faults in with the
        GIL released: a ``bytearray`` would zero them first under the GIL
        (seconds for a 6 GB frame, stalling every other thread of the
        process, the agent's IPC and RPC servers among them)."""
        meta = self.read_meta()
        if meta is None:
            return None
        end = 8 + len(msgpack.packb(meta))
        for leaf in meta["leaves"]:
            for shard in leaf.get("shards", []):
                end = max(end, shard["abs_offset"] + shard["nbytes"])
        fd = self._shard_fd()
        if fd is not None:
            buf = memoryview(np.empty(end, np.uint8))
            if self._preadv_full(fd, buf, 0):
                return buf
        return bytes(self._shm.buf[:end])

    def frame_view(self):
        """A zero-copy view of the whole sealed frame (None when there is
        none); release it before :meth:`close`."""
        meta = self.read_meta()
        if meta is None:
            return None
        end = 8 + len(msgpack.packb(meta))
        for leaf in meta["leaves"]:
            for shard in leaf.get("shards", []):
                end = max(end, shard["abs_offset"] + shard["nbytes"])
        return self._shm.buf[:end]

    @property
    def step(self) -> int:
        meta = self.read_meta()
        return int(meta["step"]) if meta else -1

    def verify_frame(self) -> List[str]:
        """Names (``leafpath@offset``) of shards whose stored CRC does not
        match their bytes; empty when intact or unsealed."""
        meta = self.read_meta()
        if meta is None:
            return []
        buf = self._shm.buf

        def _view(shard_meta: Dict):
            off, n = shard_meta["abs_offset"], shard_meta["nbytes"]
            if off + n > len(buf):
                return None
            return buf[off:off + n]

        return _verify_shards(meta, _view)


def parse_frame(blob) -> Optional[Dict]:
    """A persisted frame blob → its meta, with the blob under ``_blob``."""
    if len(blob) < 8:
        return None
    (meta_len,) = _U64.unpack(bytes(blob[:8]))
    if 8 + meta_len > len(blob):
        return None
    meta = msgpack.unpackb(memoryview(blob)[8:8 + meta_len])
    meta["_blob"] = blob
    return meta


def frame_shard_bytes(meta: Dict, shard_meta: Dict):
    off = shard_meta["abs_offset"]
    return memoryview(meta["_blob"])[off:off + shard_meta["nbytes"]]


def _verify_shards(meta: Dict, read: Callable[[Dict], Any]) -> List[str]:
    stamped = [(leaf.get("path", "?"), shard)
               for leaf in meta.get("leaves", [])
               for shard in leaf.get("shards", [])
               if shard.get("crc") and "abs_offset" in shard]

    def bad(item) -> bool:
        data = read(item[1])
        return (data is None or (zlib.crc32(data) & 0xFFFFFFFF)
                != _CRC.unpack(item[1]["crc"])[0])

    with ThreadPoolExecutor(_CRC_THREADS) as pool:
        flags = list(pool.map(bad, stamped))
    return [f"{path}@{shard['offset']}"
            for (path, shard), flag in zip(stamped, flags) if flag]


def verify_parsed_frame(meta: Dict) -> List[str]:
    """CRC-check a :func:`parse_frame` result; returns the corrupt shard
    names (``leafpath@offset``)."""
    return _verify_shards(meta, lambda shard: frame_shard_bytes(meta, shard))


def verify_frame_blob(blob) -> List[str]:
    """CRC-check a whole frame blob; an unparseable one counts as one
    corrupt ``<frame>`` entry (its seal is broken)."""
    try:
        meta = parse_frame(blob)
    except Exception:  # noqa: BLE001 — a torn header is corrupt
        meta = None
    if meta is None:
        return ["<frame>"]
    return verify_parsed_frame(meta)
