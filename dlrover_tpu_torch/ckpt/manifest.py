"""Manifest chains on storage: the worker-side write and the reader.

The port's trim of ``dlrover_tpu/ckpt/manifest.py``. Each persisted step
holds one link per frame, ``manifest_<node>_<local>.mf`` (a msgpack map:
the frame header, the parent link's digest, and a fully resolved shard
map into payload files), committed write-temp → fsync → atomic replace.

The port **writes** full-base links only — what the reference writes with
``DLROVER_TPU_CKPT_DELTA=0`` — and **reads** any chain, delta links
included: a delta link's shard map already points each unchanged shard at
its ancestor's payload, so the reader walks the parent digests to the base
(proving the chain was never torn) and then fetches every shard from the
file its entry names, checking its CRC. The delta writer, chain GC and the
data-state sidecar are not ported (ROADMAP).
"""

import hashlib
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common import msgpack
from dlrover_tpu_torch.common.constants import (
    ChaosSite,
    CheckpointConstant,
    ConfigKey,
    env_int,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.storage import (
    PosixDiskStorage,
    get_checkpoint_storage,
)

_U64 = struct.Struct("<Q")
_MANIFEST_VERSION = 1
_IO_THREADS = 8


def stripe_bytes() -> int:
    return max(1 << 20, env_int(ConfigKey.CKPT_STRIPE_BYTES, 64 << 20))


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def frame_file(ckpt_dir: str, step: int, node_rank: int,
               local_rank: int) -> str:
    return os.path.join(
        step_dir(ckpt_dir, step),
        f"frame_{node_rank}_{local_rank}{CheckpointConstant.FRAME_SUFFIX}")


def manifest_file(ckpt_dir: str, step: int, node_rank: int,
                  local_rank: int) -> str:
    return os.path.join(
        step_dir(ckpt_dir, step),
        f"{CheckpointConstant.MANIFEST_PREFIX}{node_rank}_{local_rank}"
        f"{CheckpointConstant.MANIFEST_SUFFIX}")


def parse_manifest_name(name: str) -> Optional[Tuple[int, int]]:
    """``manifest_<node>_<local>.mf`` → (node, local), else None."""
    pre, suf = (CheckpointConstant.MANIFEST_PREFIX,
                CheckpointConstant.MANIFEST_SUFFIX)
    if not (name.startswith(pre) and name.endswith(suf)):
        return None
    node, sep, local = name[len(pre):-len(suf)].partition("_")
    if not sep:
        return None
    try:
        return int(node), int(local)
    except ValueError:
        return None


class ChainError(Exception):
    """A manifest chain failed verification; ``reason`` names why."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


def commit_file(storage: PosixDiskStorage, content, path: str,
                **ctx) -> None:
    """Atomic commit: write a durable temp file, fire the
    ``storage.commit`` chaos site, then replace."""
    tmp = path + ".tmp"
    storage.write(content, tmp)
    inj = get_injector()
    if inj is not None:
        inj.fire(ChaosSite.STORAGE_COMMIT, path=path, **ctx)
    storage.safe_move(tmp, path)


def _link_digest(link_bytes) -> bytes:
    return hashlib.sha1(bytes(link_bytes)).digest()


def _frame_shards(meta: Dict, blob) -> List[Dict]:
    """The sealed meta's shards in manifest form, keyed by data-relative
    offset; crc/dig from the seal stamps, or computed when unstamped."""
    from dlrover_tpu_torch.ckpt.shm_handler import shard_digest

    mv = memoryview(blob)
    out = []
    for leaf in meta.get("leaves", []):
        for shard in leaf.get("shards", []):
            if "abs_offset" not in shard or shard.get("nbytes", 0) <= 0:
                continue
            off, n = shard["abs_offset"], shard["nbytes"]
            dig = shard.get("dig") or shard_digest(mv[off:off + n])
            stamp = shard.get("crc")
            crc = (struct.unpack(">I", stamp)[0] if stamp
                   else struct.unpack(">I", dig[:4])[0])
            out.append({"k": shard["offset"], "abs": off, "n": n,
                        "crc": crc, "dig": bytes(dig)})
    return out


def persist_frame(storage: PosixDiskStorage, ckpt_dir: str, step: int,
                  meta: Dict, blob, executor=None) -> Dict:
    """Persist one sealed frame as a full-base chain link: the payload
    file first (durably), then the link. Returns the link's summary."""
    node, local = meta["node_rank"], meta["local_rank"]
    (meta_len,) = _U64.unpack(bytes(blob[:8]))
    hdr = bytes(blob[:8 + meta_len])
    shards = _frame_shards(meta, blob)
    total = max([len(hdr)] + [s["abs"] + s["n"] for s in shards])
    storage.safe_makedirs(step_dir(ckpt_dir, step))
    path = frame_file(ckpt_dir, step, node, local)
    mv = memoryview(blob)
    size = stripe_bytes()
    storage.write_stripes(
        path, total, [(off, mv[off:off + min(size, total - off)], None)
                      for off in range(0, total, size)], executor=executor)
    rel = os.path.relpath(path, ckpt_dir)
    link = {
        "v": _MANIFEST_VERSION, "step": step, "kind": "base",
        "node": node, "local": local,
        "expected_frames": int(meta.get("expected_frames") or 1),
        "parent_step": -1, "parent_digest": b"", "chain_len": 1,
        "hdr": hdr, "total": total,
        "dirty": sorted(s["k"] for s in shards),
        "shards": [{"k": s["k"], "f": rel, "o": s["abs"], "n": s["n"],
                    "crc": s["crc"], "dig": s["dig"], "s": step}
                   for s in sorted(shards, key=lambda s: s["k"])],
    }
    link_bytes = msgpack.packb(link)
    commit_file(storage, link_bytes,
                manifest_file(ckpt_dir, step, node, local))
    logger.info("persisted base link for frame %s_%s step %s: %.1f MB",
                node, local, step, total / 1e6)
    return {"step": step, "node": node, "local": local, "kind": "base",
            "bytes_total": total, "link_digest": _link_digest(link_bytes)}


def _read_link(storage: PosixDiskStorage, ckpt_dir: str, step: int,
               node: int, local: int) -> Optional[Tuple[Dict, bytes]]:
    blob = storage.read(manifest_file(ckpt_dir, step, node, local))
    if blob is None:
        return None
    try:
        link = msgpack.unpackb(blob)
    except Exception:  # noqa: BLE001 — a torn link is a chain failure
        logger.warning("manifest link for step %s (%s_%s) is unparseable",
                       step, node, local)
        return None
    if not isinstance(link, dict) or link.get("v") != _MANIFEST_VERSION:
        return None
    return link, bytes(blob)


def verify_chain(storage: PosixDiskStorage, ckpt_dir: str,
                 link: Dict) -> int:
    """Walk ``link``'s parents to its base, checking every link digest.
    Returns the base step; raises :class:`ChainError` on a torn chain."""
    node, local = link["node"], link["local"]
    cur = link
    hops = 0
    while cur["kind"] != "base":
        if hops > 100000:
            raise ChainError("chain_cycle", f"frame {node}_{local}")
        got = _read_link(storage, ckpt_dir, cur["parent_step"], node, local)
        if got is None:
            raise ChainError("missing_link", f"frame {node}_{local} parent "
                             f"step {cur['parent_step']}")
        parent, parent_bytes = got
        if _link_digest(parent_bytes) != cur["parent_digest"]:
            raise ChainError("link_digest_mismatch", f"frame {node}_{local} "
                             f"parent step {cur['parent_step']}")
        cur = parent
        hops += 1
    return cur["step"]


def _reconstruct_frame(storage: PosixDiskStorage, ckpt_dir: str, link: Dict,
                       executor=None) -> Dict:
    """One frame blob from a verified link: its header, then every shard
    read from the payload file its entry resolves to, CRC-checked."""
    from dlrover_tpu_torch.ckpt.shm_handler import parse_frame

    hdr = bytes(link["hdr"])
    blob = bytearray(link["total"])
    blob[:len(hdr)] = hdr
    meta = msgpack.unpackb(hdr[8:])
    abs_by_key = {shard["offset"]: shard["abs_offset"]
                  for leaf in meta.get("leaves", [])
                  for shard in leaf.get("shards", [])
                  if "abs_offset" in shard}

    def fill(entry: Dict) -> None:
        abs_off = abs_by_key.get(entry["k"])
        if abs_off is None:
            raise ChainError("shard_key_unknown",
                             f"step {link['step']} shard {entry['k']}")
        data = storage.read_at(os.path.join(ckpt_dir, entry["f"]),
                               entry["o"], entry["n"])
        if data is None:
            raise ChainError("missing_payload", f"step {link['step']} shard "
                             f"{entry['k']} ← {entry['f']}")
        if (zlib.crc32(data) & 0xFFFFFFFF) != entry["crc"]:
            raise ChainError("payload_crc_mismatch", f"step {link['step']} "
                             f"shard {entry['k']} ← {entry['f']}")
        blob[abs_off:abs_off + entry["n"]] = data

    if executor is None:
        for entry in link["shards"]:
            fill(entry)
    else:
        for f in [executor.submit(fill, e) for e in link["shards"]]:
            f.result()
    frame = parse_frame(blob)
    if frame is None:
        raise ChainError("frame_unparseable", f"step {link['step']}")
    return frame


def manifest_links(ckpt_dir: str, step: int,
                   storage: Optional[PosixDiskStorage] = None) -> List[Dict]:
    """Parsed manifest links present for ``step`` (unverified)."""
    storage = storage or get_checkpoint_storage(ckpt_dir)
    links = []
    for name in storage.listdir(step_dir(ckpt_dir, step)):
        who = parse_manifest_name(name)
        if who is not None:
            got = _read_link(storage, ckpt_dir, step, *who)
            if got is not None:
                links.append(got[0])
    return links


def load_step_frames(ckpt_dir: str, step: int,
                     storage: Optional[PosixDiskStorage] = None) -> List[Dict]:
    """Every frame of ``step`` rebuilt from its manifest links. Raises
    :class:`ChainError` unless the step is provably complete: all expected
    links present, each digest walk reaching a base, every payload range
    passing its CRC."""
    storage = storage or get_checkpoint_storage(ckpt_dir)
    links = manifest_links(ckpt_dir, step, storage)
    if not links:
        raise ChainError("no_committed_links", f"step {step}")
    expected = max(link["expected_frames"] for link in links)
    if len(links) < expected:
        raise ChainError("incomplete_quorum",
                         f"step {step}: {len(links)}/{expected} links")
    for link in links:
        verify_chain(storage, ckpt_dir, link)
    with ThreadPoolExecutor(_IO_THREADS,
                            thread_name_prefix="ckpt-chain-read") as pool:
        return [_reconstruct_frame(storage, ckpt_dir, link, executor=pool)
                for link in links]
