"""Checkpoint-free elastic resharding: the live-reshard rung.

The port's copy of ``dlrover_tpu/ckpt/reshard.py``, on the same wire (the
cut record's KV key and JSON, the ``reshard_meta`` method, the fabric's
``reshard/{local}/{shard}/{path}`` key), so either package's survivors
feed either package's relaunched workers. On a rendezvous world cut that
changed the node set the master publishes a cut record
(:class:`ReshardCoordinator`), and every agent serves its workers' last
sealed shm frames (:class:`ReshardService`). A worker of the new world
(:class:`ReshardRestorer`) reads the cut, gathers the survivors' frame
metas, proves that their shards cover every region its tensors need
before a byte moves (:func:`plan_reshard`, :class:`CoverageError`), pulls
the shards it needs over the fabric (its own frame's from its segment)
and hands them to the engine's assembly, which streams them to the card
through its pinned staging ring. No storage read.

The spec layer: :class:`ReshardSpec` (where each saved shard of a leaf
lives), :class:`NeedSpec` (the regions this rank must fill),
:class:`Transfer` and :class:`ReshardPlan`. Every failure is a
:class:`ReshardAbort` with a short reason, which the engine journals as
``reshard_aborted`` before it falls to the next rung. A survivor whose
workers sealed a newer frame answers a fetch at the old step "not found"
(the fabric's step guard), so steps never mix. Chaos sites:
``reshard.plan`` before planning, and the fabric's ``fabric.connect`` /
``fabric.stripe`` in the transfers.

The cut record keeps the decomposition (``old_decomp`` = ``new_decomp``,
``parallel/replan.py``): the re-decomposition planner is not ported.
"""

import json
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.chaos import InjectedError, InjectedFault, get_injector
from dlrover_tpu_torch.common import comm, fabric, msgpack
from dlrover_tpu_torch.common.constants import (
    ChaosSite,
    ConfigKey,
    EnvKey,
    SpanName,
    env_float,
    env_int,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import (
    RPCClient,
    RPCError,
    RPCServer,
    local_host_ip,
)
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.journal import JournalEvent

# one bad peer never ends the loop over the others
_PEER_ERRORS = (ConnectionError, OSError, RPCError)


def cut_key(job_name: str, round_: int) -> str:
    """The KV key of one rendezvous round's cut record."""
    return f"reshard/{job_name}/cut/r{int(round_)}"


def addr_key(job_name: str, node_rank: int) -> str:
    """The KV key of an agent's reshard service address."""
    return f"reshard/{job_name}/addr/{int(node_rank)}"


def shard_key(local_rank: int, shard_index: int, path: str) -> str:
    """The fabric key of one saved shard on a survivor."""
    return f"reshard/{int(local_rank)}/{int(shard_index)}/{path}"


# fabric abort reasons -> the rung's abort reasons
_FABRIC_REASONS = {
    "fault_injected": "fault_injected",
    "no_sources": "shard_gone",
    "sources_lost": "transfer_failed",
    "content_mismatch": "transfer_failed",
    "timeout": "transfer_failed",
}


def _np_dtype(name: str) -> np.dtype:
    """A frame dtype name as numpy stores it (bf16 as its 16-bit
    patterns)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


class CoverageError(Exception):
    """The surviving frames cannot cover a region the new world needs."""


class ReshardAbort(RuntimeError):
    """The rung failed; the restore falls to the next one. ``reason`` is
    the journal's token."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


# -- the spec layer -------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class ShardSource:
    """One saved shard of one leaf on a survivor. ``alt`` lists other
    survivors' ``(node_rank, local_rank, shard_index)`` holding the same
    extent: the planner sees one shard per extent, the fabric fetches
    from all of them."""

    path: str
    node_rank: int
    local_rank: int
    shard_index: int
    start: Tuple[int, ...]
    shape: Tuple[int, ...]
    nbytes: int
    alt: Tuple[Tuple[int, int, int], ...] = ()


@dataclass(frozen=True, slots=True)
class ReshardSpec:
    """Where every saved shard of one leaf lives in the old world."""

    path: str
    dtype: str
    gshape: Tuple[int, ...]
    shards: Tuple[ShardSource, ...]


@dataclass(frozen=True, slots=True)
class NeedSpec:
    """The global regions of one leaf this process must fill."""

    path: str
    dtype: str
    gshape: Tuple[int, ...]
    regions: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]


@dataclass(frozen=True, slots=True)
class Transfer:
    """Copy ``src[lo - src.start : hi - src.start]`` into region
    ``region_index`` of ``path`` at ``lo - region start``; ``nbytes`` is
    the volume moved."""

    path: str
    src: ShardSource
    region_index: int
    lo: Tuple[int, ...]
    hi: Tuple[int, ...]
    nbytes: int


@dataclass(slots=True)
class ReshardPlan:
    step: int
    transfers: List[Transfer]

    @property
    def total_bytes(self) -> int:
        return sum(t.nbytes for t in self.transfers)

    def sources(self) -> List[ShardSource]:
        """The distinct source shards, in first-use order."""
        seen, out = set(), []
        for t in self.transfers:
            if t.src not in seen:
                seen.add(t.src)
                out.append(t.src)
        return out


def layout_from_frames(frames: Sequence[Dict]
                       ) -> Tuple[Dict[str, ReshardSpec], Dict[str, Dict]]:
    """The old world's layout from survivors' frame metas (each carrying
    its ``node_rank`` and ``local_rank``): ``(specs, values)``, the array
    leaves by path and the plain value leaves (the first frame's). Equal
    extents on several survivors fold into one shard with ``alt``
    sources, so the planner's volume sum, which assumes disjoint shards,
    stays exact."""
    values: Dict[str, Dict] = {}
    acc: Dict[str, Dict[str, Any]] = {}
    for frame in frames:
        node = int(frame.get("node_rank", 0))
        local = int(frame.get("local_rank", 0))
        for leaf in frame.get("leaves", []):
            path = leaf.get("path", "")
            if leaf.get("kind") == "value":
                values.setdefault(path, leaf)
                continue
            entry = acc.setdefault(path, {
                "dtype": leaf.get("dtype", "float32"),
                "gshape": tuple(leaf.get("gshape", ())),
                "shards": [], "extents": {}})
            for i, sh in enumerate(leaf.get("shards", [])):
                extent = (tuple(sh["start"]), tuple(sh["lshape"]))
                known = entry["extents"].get(extent)
                if known is not None:
                    prev = entry["shards"][known]
                    entry["shards"][known] = replace(
                        prev, alt=prev.alt + ((node, local, i),))
                    continue
                entry["extents"][extent] = len(entry["shards"])
                entry["shards"].append(ShardSource(
                    path=path, node_rank=node, local_rank=local,
                    shard_index=i, start=extent[0], shape=extent[1],
                    nbytes=int(sh["nbytes"])))
    specs = {path: ReshardSpec(path=path, dtype=e["dtype"],
                               gshape=e["gshape"], shards=tuple(e["shards"]))
             for path, e in acc.items()}
    return specs, values


def needs_from_state(state) -> Dict[str, NeedSpec]:
    """The region THIS rank must restore for each tensor leaf of
    ``state``, keyed by the reference's leaf names; plain values carry
    none."""
    import torch
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.convert import named_leaves
    from dlrover_tpu_torch.parallel import sharding

    needs: Dict[str, NeedSpec] = {}
    for path, leaf in named_leaves(state):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        if not isinstance(leaf, torch.Tensor):
            continue
        gshape = tuple(leaf.shape)
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            region = sharding.region_for(
                gshape, sharding.dtensor_spec(leaf),
                sharding.mesh_sizes(mesh), sharding.mesh_coords(mesh))
        else:
            region = ((0,) * len(gshape), gshape)
        needs[path] = NeedSpec(path=path,
                               dtype=str(leaf.dtype).removeprefix("torch."),
                               gshape=gshape, regions=(region,))
    return needs


def plan_reshard(layout: Dict[str, ReshardSpec], needs: Dict[str, NeedSpec],
                 step: int = -1) -> ReshardPlan:
    """Intersect every needed region with the surviving shards. Raises
    :class:`CoverageError` naming the first region they do not cover,
    before any byte moves."""
    transfers: List[Transfer] = []
    for path, need in needs.items():
        spec = layout.get(path)
        if spec is None:
            raise CoverageError(f"no surviving frame holds leaf {path}")
        if tuple(spec.gshape) != tuple(need.gshape):
            raise CoverageError(f"{path}: saved gshape {list(spec.gshape)} "
                                f"!= target {list(need.gshape)}")
        itemsize = _np_dtype(need.dtype).itemsize
        for ridx, (rstart, rshape) in enumerate(need.regions):
            want = int(np.prod(rshape)) if rshape else 1
            filled = 0
            for src in spec.shards:
                lo = tuple(max(a, b) for a, b in zip(rstart, src.start))
                hi = tuple(min(a + da, b + db) for a, da, b, db in
                           zip(rstart, rshape, src.start, src.shape))
                if any(lo_ >= hi_ for lo_, hi_ in zip(lo, hi)):
                    continue
                vol = (int(np.prod([h - lo_ for lo_, h in zip(lo, hi)]))
                       if lo else 1)
                transfers.append(Transfer(path=path, src=src,
                                          region_index=ridx, lo=lo, hi=hi,
                                          nbytes=vol * itemsize))
                filled += vol
            if filled < want:
                raise CoverageError(
                    f"{path}: region start={list(rstart)} "
                    f"shape={list(rshape)} covered {filled}/{want} "
                    f"elements by surviving shards")
    return ReshardPlan(step=step, transfers=transfers)


def execute_plan(plan: ReshardPlan, needs: Dict[str, NeedSpec],
                 fetch: Callable[[ShardSource], bytes]
                 ) -> Dict[str, List[np.ndarray]]:
    """Every needed region on the host from a plan; ``fetch(src)`` gives
    one source shard's bytes. The engine's rung assembles through its own
    staged path instead."""
    out = {p: [np.zeros(rshape, dtype=_np_dtype(n.dtype))
               for (_, rshape) in n.regions]
           for p, n in needs.items()}
    for t in plan.transfers:
        need = needs[t.path]
        rstart, _ = need.regions[t.region_index]
        arr = np.frombuffer(fetch(t.src), dtype=_np_dtype(need.dtype)
                            ).reshape(t.src.shape)
        src_sl = tuple(slice(lo - b, h - b)
                       for lo, h, b in zip(t.lo, t.hi, t.src.start))
        dst_sl = tuple(slice(lo - w, h - w)
                       for lo, h, w in zip(t.lo, t.hi, rstart))
        out[t.path][t.region_index][dst_sl] = arr[src_sl]
    return out


# -- the agent's side: serve the sealed frames by shard -------------------------


class ReshardService:
    """Runs in the agent, so the last sealed frames outlive the workers:
    serves their metas (``reshard_meta``) and each saved shard's bytes
    through a fabric provider (``reshard/{local}/{shard}/{path}``).
    ``shm_provider`` returns this host's frame handlers."""

    def __init__(self, shm_provider: Callable[[], List],
                 host: str = "0.0.0.0", port: int = 0):
        self._shm_provider = shm_provider
        self._server = RPCServer(host, port)
        self._server.register("reshard_meta", self._on_meta)
        self.fabric = fabric.FabricServer(server=self._server)
        self.fabric.register_provider("reshard", self._provide_shard)

    @property
    def port(self) -> int:
        return self._server.port

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop()

    def register(self, master_client, job_name: str, node_rank: int,
                 host: Optional[str] = None) -> str:
        """Publish this service's address in the master KV."""
        addr = f"{host or local_host_ip()}:{self.port}"
        master_client.kv_set(addr_key(job_name, node_rank), addr.encode())
        return addr

    def _frames(self):
        out = []
        for handler in self._shm_provider():
            try:
                meta = handler.read_meta()
            except (OSError, ValueError):
                continue
            if meta is not None:
                out.append((handler, meta))
        return out

    def _on_meta(self, req) -> comm.ReshardMetaResponse:
        frames = []
        node_rank = -1
        for _, meta in self._frames():
            node_rank = int(meta.get("node_rank", node_rank))
            slim = {k: v for k, v in meta.items() if not k.startswith("_")}
            frames.append([int(meta.get("local_rank", 0)),
                           int(meta.get("step", -1)), msgpack.packb(slim)])
        return comm.ReshardMetaResponse(found=bool(frames),
                                        node_rank=node_rank, frames=frames)

    def _provide_shard(self, rest: str):
        """A step-tagged ranged reader of one saved shard of a sealed
        frame; a frame sealed at a newer step answers a fetch pinned to
        the old one "not found"."""
        parts = rest.split("/", 2)
        if len(parts) != 3:
            return None
        local_rank, sidx, path = int(parts[0]), int(parts[1]), parts[2]
        for handler, meta in self._frames():
            if int(meta.get("local_rank", 0)) != local_rank:
                continue
            step = int(meta.get("step", -1))
            for leaf in meta.get("leaves", []):
                if leaf.get("path") != path:
                    continue
                shards = leaf.get("shards", [])
                if not 0 <= sidx < len(shards):
                    return None
                shard = shards[sidx]
                total = int(shard["nbytes"])

                def read_fn(off: int, n: int, handler=handler, shard=shard,
                            total=total):
                    if off < 0 or off + n > total:
                        return None
                    sub = dict(shard)
                    sub["abs_offset"] = int(shard["abs_offset"]) + off
                    sub["nbytes"] = n
                    return handler.read_shard_bytes(sub)

                return step, total, step, read_fn
            return None
        return None


# -- the master's side: announce the cut ----------------------------------------


class ReshardCoordinator:
    """Attached to the master's training rendezvous: on a world cut
    whose node set changed it publishes the cut record the new world's
    workers key their reshard on, and journals ``reshard_planned``. With
    no planner the record keeps the decomposition the job runs (fsdp
    absorbs the world, as ``parallel/mesh.py`` plans it).

    ``progress(round)`` (the step reports the master took from agents
    in that round or later) keys the record on the last world that
    trained: when no step was reported in or after the last cut's round,
    the world that cut formed never trained (its
    workers were restarted before a step: a survivor that restarts twice,
    once for its failed peers and once on the master's word; a returning
    node that formed a world alone while the survivor was still saving),
    so its frames are not the newest and the record names the last cut's
    old world instead, with ``carried_from``. The reference names the
    previous world always, so the new world falls past the reshard rung
    there."""

    def __init__(self, job_name: str, kv_store, journal=None,
                 progress: Optional[Callable[[int], int]] = None):
        self._job = job_name
        self._kv = kv_store
        self._journal = journal
        self._progress = progress
        # the last published cut
        self._last: Optional[Dict] = None

    def on_world_cut(self, old_ranks, new_ranks,
                     round_: int) -> Optional[Dict]:
        from dlrover_tpu_torch.parallel.replan import Decomposition

        old = sorted(int(r) for r in old_ranks)
        new = sorted(int(r) for r in new_ranks)
        carried_from = None
        last = self._last
        if (old and last is not None and self._progress is not None
                and self._progress(last["round"]) == 0):
            # the last cut's world took no step
            old, carried_from = list(last["old"]), last["round"]
        if not old or old == new:
            return None
        cut = {"round": int(round_), "old": old, "new": new}
        if carried_from is not None:
            cut["carried_from"] = carried_from
        decomp = Decomposition(fsdp=max(1, len(old))).to_wire()
        cut["old_decomp"] = decomp
        cut["new_decomp"] = list(decomp)
        self._kv.set(cut_key(self._job, round_), json.dumps(cut).encode())
        if self._journal is not None:
            self._journal.record(
                JournalEvent.RESHARD_PLANNED, round=int(round_),
                old_world=old, new_world=new,
                old_decomp=cut["old_decomp"], new_decomp=cut["new_decomp"])
        logger.info("reshard cut r%s published: old=%s new=%s decomp %s%s",
                    round_, old, new, decomp,
                    f" (carried from r{carried_from}: no step since)"
                    if carried_from is not None else "")
        self._last = cut
        return cut


# -- the worker's side: read the cut, plan, pull, assemble ----------------------


class ReshardRestorer:
    """One live-reshard attempt of a new world's worker, inside the
    engine's restore span (its plan, transfer and apply spans share that
    trace). Every failure becomes a :class:`ReshardAbort`."""

    def __init__(self, job_name: str, master_client, node_rank: int,
                 local_rank: int = 0, rank: int = 0, own_shm=None,
                 timeout_s: Optional[float] = None, reporter=None):
        self._job = job_name
        self._master = master_client
        self._node = node_rank
        self._local = local_rank
        self._rank = rank
        self._own_shm = own_shm
        self._timeout_s = (timeout_s if timeout_s is not None
                           else env_float(ConfigKey.RESHARD_TIMEOUT_S, 60.0))
        self._reporter = reporter
        self._clients: Dict[int, RPCClient] = {}
        self._addrs: Dict[int, str] = {}
        self._cache: Dict[ShardSource, bytes] = {}
        self._source = f"worker_{rank}"

    # -- discovery -------------------------------------------------------------

    def read_cut(self, round_: Optional[int] = None) -> Optional[Dict]:
        """This worker's rendezvous round's cut record, or None when the
        world did not change."""
        if self._master is None:
            return None
        if round_ is None:
            round_ = env_int(EnvKey.RDZV_ROUND, 0)
        getter = getattr(self._master, "kv_get", None)
        if getter is None:
            return None
        raw = getter(cut_key(self._job, round_))
        if not raw:
            return None
        try:
            cut = json.loads(bytes(raw).decode())
        except (ValueError, UnicodeDecodeError):
            return None
        if not cut.get("old") or sorted(cut["old"]) == sorted(
                cut.get("new", [])):
            return None
        return cut

    def _addr(self, rank: int) -> Optional[str]:
        addr = self._addrs.get(rank)
        if addr is not None:
            return addr
        getter = getattr(self._master, "kv_get", None)
        raw = getter(addr_key(self._job, rank)) if getter else None
        if not raw:
            return None
        addr = bytes(raw).decode()
        self._addrs[rank] = addr
        return addr

    def _client(self, rank: int) -> Optional[RPCClient]:
        client = self._clients.get(rank)
        if client is not None:
            return client
        addr = self._addr(rank)
        if addr is None:
            return None
        client = RPCClient(addr, timeout_s=self._timeout_s, retries=2)
        self._clients[rank] = client
        return client

    def gather_frames(self, source_ranks: Sequence[int]
                      ) -> Dict[int, List[Tuple[int, int, Dict]]]:
        """Every old-world agent's sealed frame metas; an unreachable one
        is skipped (the planner decides whether the rest cover)."""
        out: Dict[int, List[Tuple[int, int, Dict]]] = {}
        for rank in sorted({int(r) for r in source_ranks}):
            client = self._client(rank)
            if client is None:
                continue
            try:
                resp = client.call("reshard_meta", comm.ReshardMetaRequest(
                    node_rank=self._node))
            except _PEER_ERRORS as e:
                logger.info("reshard: source agent %s unreachable (%r)",
                            rank, e)
                self._clients.pop(rank, None)
                continue
            if not resp.found:
                continue
            metas = []
            for local, step, blob in resp.frames:
                try:
                    meta = msgpack.unpackb(blob)
                except (ValueError, TypeError):
                    continue
                meta.setdefault("node_rank", rank)
                meta.setdefault("local_rank", local)
                metas.append((int(local), int(step), meta))
            if metas:
                out[rank] = metas
        return out

    # -- execution -------------------------------------------------------------

    def restore(self, target, assemble, cut: Dict,
                needs: Optional[Dict[str, NeedSpec]] = None
                ) -> Tuple[Any, int, Dict[str, Any]]:
        """Plan, pull and assemble: ``assemble(target, lookup)`` fills the
        target from a lookup of leaf metas whose shards carry their bytes
        (``_frame`` = ``{"_blob": bytes}``, ``abs_offset`` 0). Returns
        ``(state, step, stats)``; raises :class:`ReshardAbort`."""
        return self._guarded(
            lambda: self._restore(target, assemble, cut, needs))

    def _guarded(self, attempt):
        try:
            return attempt()
        except ReshardAbort:
            raise
        except CoverageError as e:
            raise ReshardAbort("coverage", str(e)) from e
        except (InjectedError, InjectedFault) as e:
            raise ReshardAbort("fault_injected", repr(e)) from e
        except _PEER_ERRORS as e:
            raise ReshardAbort("transfer_failed", repr(e)) from e
        except (RuntimeError, ValueError, KeyError) as e:
            raise ReshardAbort("apply_failed", repr(e)) from e

    def _plan_from_cut(self, cut, needs, inj):
        """Gather the survivors' frames and prove coverage, newest step
        first: ``(plan, layout, values, step)``."""
        with tracing.span(SpanName.RESHARD_PLAN, source=self._source,
                          round=cut.get("round")) as sp:
            if inj is not None:
                inj.fire(ChaosSite.RESHARD_PLAN, round=cut.get("round"),
                         node_rank=self._node)
            frames_by_rank = self.gather_frames(cut.get("old", ()))
            if not frames_by_rank:
                raise ReshardAbort("no_sources",
                                   "no surviving reshard source is reachable")
            all_frames = [e for metas in frames_by_rank.values()
                          for e in metas]
            steps = sorted({s for _, s, _ in all_frames if s >= 0},
                           reverse=True)
            plan = layout = values = None
            chosen = -1
            last_err: Optional[CoverageError] = None
            for step in steps:
                metas = [m for _, s, m in all_frames if s == step]
                layout, values = layout_from_frames(metas)
                try:
                    plan = plan_reshard(layout, needs, step=step)
                    chosen = step
                    break
                except CoverageError as e:
                    last_err = e
            if plan is None:
                raise ReshardAbort(
                    "coverage", str(last_err) if last_err is not None
                    else "survivors hold no complete step")
            sp.add_event("planned", step=chosen,
                         transfers=len(plan.transfers),
                         bytes=plan.total_bytes)
        return plan, layout, values, chosen

    def _restore(self, target, assemble, cut, needs=None):
        inj = get_injector()
        t0 = time.monotonic()
        if needs is None:
            needs = needs_from_state(target)
        plan, layout, values, chosen = self._plan_from_cut(cut, needs, inj)
        with tracing.span(SpanName.RESHARD_XFER, source=self._source,
                          step=chosen) as sp:
            stats = self._prefetch(plan, chosen)
            sp.add_event("fetched", **stats)
        with tracing.span(SpanName.RESHARD_APPLY, source=self._source,
                          step=chosen):
            state = assemble(target, self._merged_lookup(layout, values))
        stats.update(step=chosen, round=int(cut.get("round", -1)),
                     transfers=len(plan.transfers), bytes=plan.total_bytes,
                     duration_s=time.monotonic() - t0)
        return state, chosen, stats

    def _merged_lookup(self, layout: Dict[str, ReshardSpec],
                       values: Dict[str, Dict]) -> Dict[str, Dict]:
        """The survivors' layout as the engine's leaf metas; each planned
        shard carries its fetched bytes, unplanned ones are left out."""
        lookup: Dict[str, Dict] = {}
        for path, spec in layout.items():
            lookup[path] = {
                "path": path, "kind": "array", "dtype": spec.dtype,
                "gshape": list(spec.gshape),
                "shards": [{"start": list(src.start),
                            "lshape": list(src.shape),
                            "nbytes": src.nbytes, "offset": 0,
                            "abs_offset": 0,
                            "_frame": {"_blob": self._cache[src]}}
                           for src in spec.shards if src in self._cache]}
        for path, leaf in values.items():
            lookup.setdefault(path, leaf)
        return lookup

    def _prefetch(self, plan: ReshardPlan, step: int) -> Dict[str, Any]:
        """Every distinct source shard of the plan: its own frame's read
        here, each remote node's on a thread of its own (one client per
        thread)."""
        own: List[ShardSource] = []
        by_rank: Dict[int, List[ShardSource]] = {}
        for src in plan.sources():
            if self._is_own(src, step):
                own.append(src)
            else:
                by_rank.setdefault(src.node_rank, []).append(src)
        bytes_local = sum(len(self._shard_bytes(src, step)) for src in own)
        parent = tracing.current_context()

        def fetch_rank(srcs: List[ShardSource]) -> int:
            with tracing.activate(parent):
                return sum(len(self._shard_bytes(src, step)) for src in srcs)

        bytes_remote = 0
        if by_rank:
            with ThreadPoolExecutor(
                    max_workers=max(1, min(8, len(by_rank))),
                    thread_name_prefix="reshard-fetch") as pool:
                for n in pool.map(fetch_rank, by_rank.values()):
                    bytes_remote += n
        return {"bytes_local": bytes_local, "bytes_remote": bytes_remote,
                "peers": len(by_rank),
                "sources": len(own) + sum(len(v) for v in by_rank.values())}

    def _is_own(self, src: ShardSource, step: int) -> bool:
        return (self._own_shm is not None and src.node_rank == self._node
                and src.local_rank == self._local
                and self._own_shm.step == step)

    def _shard_bytes(self, src: ShardSource, step: int) -> bytes:
        cached = self._cache.get(src)
        if cached is not None:
            return cached
        blob = (self._read_own(src) if self._is_own(src, step)
                else self._fetch_remote(src, step))
        self._cache[src] = blob
        return blob

    def _read_own(self, src: ShardSource):
        meta = self._own_shm.read_meta()
        if meta is None:
            raise ReshardAbort("shard_gone",
                               "own shm frame vanished mid-reshard")
        for leaf in meta.get("leaves", []):
            if leaf.get("path") != src.path:
                continue
            shards = leaf.get("shards", [])
            if src.shard_index < len(shards):
                data = self._own_shm.read_shard_bytes(
                    shards[src.shard_index])
                if data is not None:
                    return data
        raise ReshardAbort("shard_gone", f"own shm no longer holds "
                                         f"{src.path}#{src.shard_index}")

    def _fetch_remote(self, src: ShardSource, step: int):
        """One fabric session a shard: its holder and every ``alt``
        duplicate are the sources, so a survivor dying mid-transfer only
        re-queues its missing stripes."""
        sources: List[fabric.FabricSource] = []
        holders = ((src.node_rank, src.local_rank, src.shard_index),)
        for node, local, sidx in holders + src.alt:
            addr = self._addr(node)
            if addr is None:
                continue
            sources.append(fabric.FabricSource(
                addr=addr, rank=node, key=shard_key(local, sidx, src.path)))
        if not sources:
            raise ReshardAbort("peer_unreachable", f"no reshard service "
                               f"address for node {src.node_rank}")
        try:
            _, blob, _ = fabric.fetch(
                sources, shard_key(src.local_rank, src.shard_index, src.path),
                expect_step=step, timeout_s=self._timeout_s,
                reporter=self._reporter)
        except fabric.FabricAbort as e:
            raise ReshardAbort(
                _FABRIC_REASONS.get(e.reason, "transfer_failed"),
                f"{src.path}#{src.shard_index}: {e}") from e
        if len(blob) != src.nbytes:
            raise ReshardAbort(
                "short_read", f"{src.path}#{src.shard_index}: got "
                f"{len(blob)} of {src.nbytes} bytes from node "
                f"{src.node_rank}")
        return blob
