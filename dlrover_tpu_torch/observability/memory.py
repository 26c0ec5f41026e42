"""Device memory accounting: a live ledger of the card's bytes and OOM
forensics.

The port's copy of ``dlrover_tpu/observability/memory.py``. Two halves:

- :class:`MemoryAccountant` — one per worker process. Owning subsystems
  (the serving engine's KV buffers, the prefix cache, the checkpoint's shm
  frames, fabric staging sessions, the trainer's state) ``register`` /
  ``release`` their buffers into a per-category ledger drawn from
  ``MetricLabel.MEMORY_CATEGORIES``. The ledger is *reconciled* against
  the card's own view (:func:`device_bytes`: the caching allocator's
  allocated bytes, not the blocks it keeps reserved, against the card's
  total) and, in a process that does not use CUDA, a synthetic
  ``DLROVER_TPU_HBM_LIMIT_BYTES`` limit. Watermarks, the
  ``dlrover_memory_*`` gauges, pressure with hysteresis journaling
  ``memory_pressure{category, headroom_frac}``, and a breach hook that
  captures a flight-recorder bundle whose ``memory.json`` replays the
  ledger (snapshot, top buffers, category waterfall, recent deltas, step
  watermarks).
- :class:`FleetMemoryMonitor` — one per master. Per-rank wire snapshots
  ride the agent heartbeat (``HeartbeatRequest.memory``), the servicer
  feeds them here, and the min-headroom rank is journaled on change,
  gauged and served on ``GET /memory``.

The chaos site ``mem.pressure`` forces a breach: an injected error there
runs the pressure → journal → bundle arc without exhausting the card.
Fleet snapshots are stamped with the master's monotonic clock. Where the
reference reads PJRT ``memory_stats()`` and falls back to
``jax.live_arrays()``, the port reads ``torch.cuda.memory_stats`` and
``mem_get_info`` and falls back to ``torch.cuda.memory_allocated``. Left
out: the race detector's registration of the ledger maps, and the
brain's pre-scale guard that reads the fleet headroom (ROADMAP A14).
"""

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import (
    ChaosSite,
    ConfigKey,
    MetricLabel,
    env_float,
    env_int,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.journal import JournalEvent

# synthetic device limit for a CPU process (no card to read): the
# accountant reconciles against ConfigKey.HBM_LIMIT_BYTES instead, so
# pressure thresholds and the KV-ceiling projection stay testable without
# a card

# headroom_frac below this journals memory_pressure + captures a bundle
DEFAULT_PRESSURE_FRAC = 0.1
# re-arm hysteresis: the episode closes only after headroom recovers past
# threshold + this margin, so a ledger oscillating at the threshold
# journals one episode, not one event per register call
PRESSURE_REARM_MARGIN = 0.02
# bounded forensic detail in snapshots/memory.json
TOP_BUFFERS = 10
RECENT_DELTAS = 64
STEP_WATERMARKS = 32

DEFAULT_FLEET_STALE_S = 90.0


def _env_limit_bytes() -> int:
    return env_int(ConfigKey.HBM_LIMIT_BYTES, 0)


def _cuda_device():
    """This process's card, or None where CUDA is not in use (a CPU
    process; a card process before its first CUDA call)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def device_bytes() -> Optional[Tuple[int, int]]:
    """(bytes_in_use, bytes_limit) of this process's card: the caching
    allocator's ``allocated_bytes.all.current`` (what live tensors hold,
    not the blocks it keeps reserved) and the card's total from
    ``mem_get_info``; ``torch.cuda.memory_allocated`` where the allocator
    keeps no stats. A process that does not use CUDA has no device tally
    (torch keeps none for host tensors): (0, 0), the limit then coming from
    ``DLROVER_TPU_HBM_LIMIT_BYTES``. ``None`` when the card cannot be read
    (the caller journals the degradation)."""
    try:
        import torch

        dev = _cuda_device()
        if dev is None:
            return 0, 0
        stats = torch.cuda.memory_stats(dev)
        used = int(stats.get("allocated_bytes.all.current",
                             torch.cuda.memory_allocated(dev)))
        _free, total = torch.cuda.mem_get_info(dev)
        return used, int(total)
    except Exception:  # noqa: BLE001 — a broken device view: None IS the
        # signal; reconcile() journals memory_degraded once per episode
        return None


def per_device_stats() -> Dict[int, Dict[str, float]]:
    """``{card index: {hbm_used_mb, hbm_total_mb, hbm_reserved_mb,
    hbm_peak_mb}}`` of this process's card — allocated, the card's total,
    what the caching allocator holds reserved beside the allocated bytes,
    and the allocated peak; ``{}`` where CUDA is not in use. The worker's
    memory publish reads it right after the accountant's sweep, so the
    sweep and the agent uplink share one collection path."""
    try:
        import torch

        dev = _cuda_device()
        if dev is None:
            return {}
        stats = torch.cuda.memory_stats(dev)
        _free, total = torch.cuda.mem_get_info(dev)
        mb = float(1 << 20)
        return {dev.index: {
            "hbm_used_mb": stats.get("allocated_bytes.all.current", 0) / mb,
            "hbm_total_mb": total / mb,
            "hbm_reserved_mb": stats.get("reserved_bytes.all.current", 0)
            / mb,
            "hbm_peak_mb": stats.get("allocated_bytes.all.peak", 0) / mb,
        }}
    except Exception:  # noqa: BLE001 — the accountant's reconcile()
        # journals the degradation
        return {}


class MemoryAccountant:
    """Per-process byte ledger with device reconciliation. Thread-safe:
    ``register``/``release`` are called from serving threads, the ckpt
    saver, and fabric sessions concurrently with ``reconcile()`` sweeps
    (one lock guards the ledger maps)."""

    def __init__(
        self,
        journal=None,
        registry=None,
        source: str = "worker",
        limit_bytes: Optional[int] = None,
        pressure_frac: Optional[float] = None,
        breach_hook: Optional[Callable[[Dict[str, Any]], None]] = None,
        monotonic: Callable[[], float] = time.monotonic,
    ):
        self._journal = journal
        self._source = source
        self._monotonic = monotonic
        self._limit_override = limit_bytes
        if pressure_frac is None:
            pressure_frac = env_float(ConfigKey.MEM_PRESSURE_FRAC,
                                      DEFAULT_PRESSURE_FRAC)
        self._pressure_frac = pressure_frac
        # bundle-capture hook: called with the pressure event data on a
        # headroom breach (the master/worker wires the flight recorder's
        # capture here — same shape as FlightRecorder.worst_traces_fn)
        self._breach_hook = breach_hook
        self._lock = threading.Lock()
        # category -> {buffer name -> bytes}; written by every owning
        # subsystem's register/release, read by reconcile + snapshots
        self._ledger: Dict[str, Dict[str, int]] = {
            c: {} for c in MetricLabel.MEMORY_CATEGORIES}
        # rolling forensic detail for memory.json
        self._deltas: deque = deque(maxlen=RECENT_DELTAS)
        self._step_watermarks: deque = deque(maxlen=STEP_WATERMARKS)
        self._watermarks: Dict[str, int] = {
            c: 0 for c in MetricLabel.MEMORY_CATEGORIES}
        self._peak_total = 0
        self._seq = 0
        self._pressure_open = False
        self._degraded = False
        self._last_reconcile: Dict[str, Any] = {}
        if registry is None:
            from dlrover_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        self._g_bytes = registry.gauge(
            "dlrover_memory_bytes",
            "Ledgered device bytes per category (observability/memory.py)",
            labelnames=("category",),
        )
        self._g_watermark = registry.gauge(
            "dlrover_memory_watermark_bytes",
            "Peak ledgered bytes per category since process start",
            labelnames=("category",),
        )
        self._g_limit = registry.gauge(
            "dlrover_memory_limit_bytes",
            "Reconciled device byte limit (the card's total or the "
            "synthetic DLROVER_TPU_HBM_LIMIT_BYTES)",
        )
        self._g_headroom = registry.gauge(
            "dlrover_memory_headroom_bytes",
            "limit - max(ledger, device in-use); negative = over-claimed",
        )
        self._g_headroom_frac = registry.gauge(
            "dlrover_memory_headroom_frac",
            "Headroom as a fraction of the limit (1.0 = empty device)",
        )
        self._g_unattributed = registry.gauge(
            "dlrover_memory_unattributed_bytes",
            "Device in-use bytes no subsystem registered — the "
            "reconciliation gap the ledger exists to keep near zero",
        )
        self._c_pressure = registry.counter(
            "dlrover_memory_pressure_total",
            "Headroom-breach episodes journaled, by dominant category",
            labelnames=("category",),
        )

        def collect(_self=self) -> None:
            with _self._lock:
                for cat in MetricLabel.MEMORY_CATEGORIES:
                    _self._g_bytes.labels(category=cat).set(
                        float(sum(_self._ledger[cat].values())))
                    _self._g_watermark.labels(category=cat).set(
                        float(_self._watermarks[cat]))

        registry.add_collect_hook(collect)
        self._registry = registry
        self._collect_hook = collect

    def close(self) -> None:
        """Take this accountant's collect hook off its registry (an owner
        that stops, such as a master, leaves no hook behind)."""
        if self._collect_hook is not None:
            self._registry.remove_collect_hook(self._collect_hook)
            self._collect_hook = None

    # -- ledger ------------------------------------------------------------

    def register(self, category: str, name: str, nbytes: int) -> None:
        """Claim ``nbytes`` for buffer ``name`` under ``category`` (must
        be a ``MetricLabel.MEMORY_CATEGORIES`` member — the vocabulary is
        the DLR013 contract). Re-registering a name replaces its claim
        (buffers resize; they don't double-count)."""
        if category not in MetricLabel.MEMORY_CATEGORIES:
            raise ValueError(
                f"unknown memory category {category!r} — use a "
                "MetricLabel.MEMORY_CATEGORIES member")
        nbytes = int(nbytes)
        now = self._monotonic()
        with self._lock:
            prev = self._ledger[category].get(name, 0)
            self._ledger[category][name] = nbytes
            self._note_delta_locked(now, category, name, nbytes - prev)

    def release(self, category: str, name: str) -> int:
        """Drop a buffer's claim; returns the bytes released (0 when the
        name was never registered — release is idempotent)."""
        if category not in MetricLabel.MEMORY_CATEGORIES:
            raise ValueError(
                f"unknown memory category {category!r} — use a "
                "MetricLabel.MEMORY_CATEGORIES member")
        now = self._monotonic()
        with self._lock:
            prev = self._ledger[category].pop(name, 0)
            if prev:
                self._note_delta_locked(now, category, name, -prev)
            return prev

    def adjust(self, category: str, name: str, nbytes: int) -> None:
        """Set a buffer's claim to ``nbytes`` (register) or drop it when
        ``nbytes`` <= 0 — the convenience shape for caches whose resident
        size is a single number (prefix cache, shm pool)."""
        if nbytes > 0:
            self.register(category, name, nbytes)
        else:
            self.release(category, name)

    def _note_delta_locked(self, now: float, category: str, name: str,
                           delta: int) -> None:
        if delta:
            self._deltas.append({
                "t": round(now, 3), "category": category, "name": name,
                "delta_bytes": delta,
            })
        total_cat = sum(self._ledger[category].values())
        if total_cat > self._watermarks[category]:
            self._watermarks[category] = total_cat
        total = sum(sum(per.values()) for per in self._ledger.values())
        if total > self._peak_total:
            self._peak_total = total

    def bytes_for(self, category: str) -> int:
        with self._lock:
            return sum(self._ledger.get(category, {}).values())

    def total_bytes(self) -> int:
        with self._lock:
            return sum(sum(per.values()) for per in self._ledger.values())

    def step_mark(self, step: int) -> None:
        """Record the per-step watermark row: the category totals as of
        the end of ``step`` (the report CLI renders these as the peak
        watermark table)."""
        with self._lock:
            row = {cat: sum(per.values())
                   for cat, per in self._ledger.items()}
            self._step_watermarks.append({"step": int(step), **row})

    # -- reconciliation + pressure ----------------------------------------

    def limit_bytes(self) -> int:
        """The device byte limit the headroom math divides by: explicit
        override > the card's total from the last sweep > synthetic env
        limit. 0 = unknown (headroom undefined; pressure never fires)."""
        if self._limit_override:
            return int(self._limit_override)
        device_limit = int(self._last_reconcile.get("device_limit", 0))
        return device_limit or _env_limit_bytes()

    def reconcile(self) -> Dict[str, Any]:
        """One device sweep: compare the ledger against the device's own
        in-use bytes, refresh the headroom gauges, and run the pressure
        threshold. The ONE collection path (worker.py's HBM publish calls
        this — replacing its old ad-hoc ``memory_stats()`` read); a sweep
        that can't see the device where one was expected journals
        ``memory_degraded`` once per episode instead of debug-swallowing."""
        dev = device_bytes()
        ledger_total = self.total_bytes()
        if dev is None:
            if not self._degraded:
                self._degraded = True
                logger.warning("memory accountant: device sweep degraded "
                               "(the card's allocator stats unreadable)")
                if self._journal is not None:
                    self._journal.record(
                        JournalEvent.MEMORY_DEGRADED, source=self._source,
                        reason="device stats unavailable",
                        ledger_bytes=ledger_total,
                    )
            device_used, device_limit = 0, 0
        else:
            self._degraded = False
            device_used, device_limit = dev
        limit = (int(self._limit_override or 0) or device_limit
                 or _env_limit_bytes())
        used = max(ledger_total, device_used)
        headroom = limit - used if limit else 0
        headroom_frac = (headroom / limit) if limit else 1.0
        unattributed = max(0, device_used - ledger_total)
        out = {
            "ledger_bytes": ledger_total,
            "device_used": device_used,
            "device_limit": device_limit,
            "limit_bytes": limit,
            "headroom_bytes": headroom,
            "headroom_frac": round(headroom_frac, 4),
            "unattributed_bytes": unattributed,
            "degraded": self._degraded,
        }
        with self._lock:
            self._last_reconcile = out
            self._seq += 1
        self._g_limit.set(float(limit))
        self._g_headroom.set(float(headroom))
        self._g_headroom_frac.set(float(headroom_frac))
        self._g_unattributed.set(float(unattributed))
        self._check_pressure(limit, headroom_frac)
        return out

    def _dominant_category(self) -> str:
        with self._lock:
            totals = {cat: sum(per.values())
                      for cat, per in self._ledger.items()}
        best = max(totals, key=lambda c: totals[c])
        return best if totals[best] > 0 else MetricLabel.MEM_OTHER

    def _check_pressure(self, limit: int, headroom_frac: float) -> None:
        forced = False
        from dlrover_tpu_torch.chaos import get_injector

        inj = get_injector()
        if inj is not None:
            try:
                inj.fire(ChaosSite.MEM_PRESSURE,
                         headroom_frac=round(headroom_frac, 4))
            except Exception:  # noqa: DLR003 — not swallowed: an injected
                # error here IS the drill signal; it forces the breach
                # path below (pressure journal + bundle capture)
                forced = True
        breached = forced or (limit > 0
                              and headroom_frac < self._pressure_frac)
        if not breached:
            # hysteresis re-arm: the episode closes only after recovery
            if self._pressure_open and (
                limit == 0 or headroom_frac
                >= self._pressure_frac + PRESSURE_REARM_MARGIN
            ):
                self._pressure_open = False
            return
        if self._pressure_open:
            return  # one journal event per episode, not per sweep
        self._pressure_open = True
        category = self._dominant_category()
        data = {
            "category": category,
            "headroom_frac": round(headroom_frac, 4),
            "limit_bytes": limit,
            "total_bytes": self.total_bytes(),
            "forced": forced,
        }
        self._c_pressure.labels(category=category).inc()
        if self._journal is not None:
            self._journal.record(JournalEvent.MEMORY_PRESSURE,
                                 source=self._source, **data)
        logger.warning("memory pressure: %s", data)
        if self._breach_hook is not None:
            try:
                self._breach_hook(data)
            except Exception:  # noqa: BLE001 — forensics must not become the fault
                logger.warning("memory breach hook failed", exc_info=True)

    def set_breach_hook(
        self, hook: Optional[Callable[[Dict[str, Any]], None]]
    ) -> None:
        self._breach_hook = hook

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``memory.json`` payload: ledger snapshot, top-N buffers,
        category waterfall, recent deltas, step watermarks, and the last
        reconciliation — everything OOM forensics needs offline."""
        with self._lock:
            categories = {cat: sum(per.values())
                          for cat, per in self._ledger.items()}
            buffers = [
                {"category": cat, "name": name, "bytes": nbytes}
                for cat, per in self._ledger.items()
                for name, nbytes in per.items()
            ]
            buffers.sort(key=lambda b: (-b["bytes"], b["category"],
                                        b["name"]))
            total = sum(categories.values())
            return {
                "seq": self._seq,
                "categories": categories,
                "total_bytes": total,
                "peak_total_bytes": max(self._peak_total, total),
                "watermarks": dict(self._watermarks),
                "top_buffers": buffers[:TOP_BUFFERS],
                "recent_deltas": list(self._deltas),
                "step_watermarks": list(self._step_watermarks),
                "reconcile": dict(self._last_reconcile),
            }

    def wire_snapshot(self) -> Dict[str, Any]:
        """The compact per-heartbeat payload (HeartbeatRequest.memory):
        category totals + headroom, small enough to ride every beat."""
        with self._lock:
            rec = dict(self._last_reconcile)
            return {
                "seq": self._seq,
                "categories": {cat: sum(per.values())
                               for cat, per in self._ledger.items()},
                "total_bytes": sum(sum(per.values())
                                   for per in self._ledger.values()),
                "limit_bytes": rec.get("limit_bytes", 0),
                "headroom_bytes": rec.get("headroom_bytes", 0),
                "headroom_frac": rec.get("headroom_frac", 1.0),
            }


_default_accountant: Optional[MemoryAccountant] = None
_default_lock = threading.Lock()


def get_accountant() -> MemoryAccountant:
    """The process-wide accountant owning subsystems register into.
    Created lazily (journal-less) so a bare serving engine still ledgers;
    ``set_accountant`` swaps in a journal-wired one at bootstrap."""
    global _default_accountant
    with _default_lock:
        if _default_accountant is None:
            _default_accountant = MemoryAccountant()
        return _default_accountant


def set_accountant(accountant: MemoryAccountant) -> MemoryAccountant:
    global _default_accountant
    with _default_lock:
        _default_accountant = accountant
    return accountant


def reset_accountant() -> None:
    """Test hook: drop the process accountant (a fresh registry follows
    observability.registry.reset_registry in conftest)."""
    global _default_accountant
    with _default_lock:
        _default_accountant = None


class FleetMemoryMonitor:
    """Master-side aggregation of per-rank accountant snapshots riding
    the heartbeat — the memory twin of the skew monitor: min-headroom
    rank surfaced as a journaled verdict + gauges + ``GET /memory``."""

    def __init__(
        self,
        event_journal=None,
        registry=None,
        pressure_frac: float = DEFAULT_PRESSURE_FRAC,
        stale_s: float = DEFAULT_FLEET_STALE_S,
        monotonic: Callable[[], float] = time.monotonic,
    ):
        self._journal = event_journal
        self._pressure_frac = pressure_frac
        self._stale_s = stale_s
        self._monotonic = monotonic
        self._lock = threading.Lock()
        # rank -> (master-monotonic arrival, snapshot); heartbeat RPC
        # threads and the persister tick share it
        self._snaps: Dict[int, Tuple[float, Dict[str, Any]]] = {}
        self._rank_node: Dict[int, int] = {}
        self._journaled_pressure: Optional[int] = None  # rank, or None
        if registry is None:
            from dlrover_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        self._g_min_frac = registry.gauge(
            "dlrover_fleet_memory_min_headroom_frac",
            "Smallest per-rank reconciled headroom fraction across fresh "
            "ranks (1.0 = fleet empty / no reports)",
        )
        self._g_min_rank = registry.gauge(
            "dlrover_fleet_memory_min_headroom_rank",
            "Rank holding the smallest headroom (-1 = no fresh reports)",
        )
        self._g_fleet_bytes = registry.gauge(
            "dlrover_fleet_memory_bytes",
            "Fleet-wide ledgered bytes per category, summed over fresh "
            "ranks",
            labelnames=("category",),
        )

    # -- ingest (heartbeat RPC path) ---------------------------------------

    def observe(self, node_id: int, memory: Dict[str, Any]) -> None:
        """Ingest one heartbeat's memory payload: ``{str(global_rank):
        wire_snapshot}`` and re-evaluate the fleet verdict inline (the
        math is one scan over at most world-size snapshots)."""
        arrival = self._monotonic()
        with self._lock:
            for rank_key, snap in (memory or {}).items():
                try:
                    rank = int(rank_key)
                    snap = dict(snap)
                except (TypeError, ValueError):
                    logger.warning("malformed memory snapshot key %r from "
                                   "node %s", rank_key, node_id)
                    continue
                self._rank_node[rank] = node_id
                self._snaps[rank] = (arrival, snap)
        self.evaluate()

    # -- evaluation --------------------------------------------------------

    def _fresh_locked(self, now: float) -> Dict[int, Dict[str, Any]]:
        return {rank: snap for rank, (t, snap) in self._snaps.items()
                if now - t <= self._stale_s}

    def evaluate(self) -> Dict[str, Any]:
        """Recompute the min-headroom verdict; journals verdict *changes*
        (a rank staying under pressure is one event, not one per beat)."""
        now = self._monotonic()
        with self._lock:
            fresh = self._fresh_locked(now)
            worst_rank, worst = None, None
            for rank in sorted(fresh):
                frac = float(fresh[rank].get("headroom_frac", 1.0))
                if worst is None or frac < worst:
                    worst_rank, worst = rank, frac
            pressured = (worst_rank if worst is not None
                         and worst < self._pressure_frac else None)
            changed = pressured is not None \
                and pressured != self._journaled_pressure
            if pressured is None or changed:
                self._journaled_pressure = pressured
            event_data = None
            if changed:
                snap = fresh[pressured]
                cats = snap.get("categories") or {}
                dominant = (max(cats, key=lambda c: cats[c])
                            if cats else MetricLabel.MEM_OTHER)
                event_data = {
                    "category": dominant,
                    "headroom_frac": round(worst, 4),
                    "limit_bytes": int(snap.get("limit_bytes", 0)),
                    "total_bytes": int(snap.get("total_bytes", 0)),
                    "rank": pressured,
                    "node_id": self._rank_node.get(pressured, -1),
                }
            totals: Dict[str, float] = {}
            for snap in fresh.values():
                for cat, nbytes in (snap.get("categories") or {}).items():
                    totals[cat] = totals.get(cat, 0.0) + float(nbytes)
        if event_data is not None and self._journal is not None:
            self._journal.record(JournalEvent.MEMORY_PRESSURE,
                                 source="memory_monitor", **event_data)
        self._g_min_frac.set(1.0 if worst is None else worst)
        self._g_min_rank.set(-1 if worst_rank is None else worst_rank)
        for cat in MetricLabel.MEMORY_CATEGORIES:
            self._g_fleet_bytes.labels(category=cat).set(
                totals.get(cat, 0.0))
        return {"min_headroom_frac": worst, "min_headroom_rank": worst_rank}

    # -- consumers ---------------------------------------------------------

    def fleet_headroom_bytes(self) -> Optional[int]:
        """The tightest fresh rank's absolute headroom — what a pre-scale
        check divides KV projections against. ``None`` until
        any rank has reported."""
        now = self._monotonic()
        with self._lock:
            fresh = self._fresh_locked(now)
            vals = [int(s.get("headroom_bytes", 0)) for s in fresh.values()
                    if int(s.get("limit_bytes", 0)) > 0]
        return min(vals) if vals else None

    def kv_bytes_per_replica(self) -> int:
        """Largest fresh rank's ledgered kv_cache bytes — the projection
        unit for 'would one more decode replica fit'. 0 until any rank
        ledgers KV."""
        now = self._monotonic()
        with self._lock:
            fresh = self._fresh_locked(now)
            vals = [int((s.get("categories") or {})
                        .get(MetricLabel.MEM_KV_CACHE, 0))
                    for s in fresh.values()]
        return max(vals) if vals else 0

    def status(self) -> Dict[str, Any]:
        """The ``GET /memory`` payload."""
        now = self._monotonic()
        with self._lock:
            fresh = self._fresh_locked(now)
            ranks = {
                str(rank): dict(snap, node_id=self._rank_node.get(rank, -1),
                                age_s=round(now - self._snaps[rank][0], 1))
                for rank, snap in fresh.items()
            }
            stale = sorted(set(self._snaps) - set(fresh))
        verdict = self.evaluate()
        return {
            "ranks": ranks,
            "stale_ranks": stale,
            "min_headroom_frac": verdict["min_headroom_frac"],
            "min_headroom_rank": verdict["min_headroom_rank"],
            "pressure_frac": self._pressure_frac,
        }


def kv_bytes_per_slot_theoretical(config, cache_len: int,
                                  quantize: bool = False) -> int:
    """What one decode slot's KV residency *should* cost for a model
    config: n_layers × 2 (k+v) × n_kv_heads × cache_len × head_dim ×
    dtype bytes, plus the per-token f32 scale pair when quantized.
    ``bench.py memory`` compares the accountant's measured bytes/slot
    against this (acceptance: within 10%)."""
    elem = 1 if quantize else 2  # int8 vs bf16
    per_slot = (config.n_layers * 2 * config.n_kv_heads
                * cache_len * config.head_dim * elem)
    if quantize:
        per_slot += config.n_layers * 2 * config.n_kv_heads * cache_len * 4
    return int(per_slot)


def max_slots_ceiling(kv_bytes_per_slot: int, headroom_bytes: int) -> int:
    """How many MORE decode slots fit in the given headroom — ROADMAP
    item 4's acceptance instrument ('report the new ceiling')."""
    if kv_bytes_per_slot <= 0:
        return 0
    return max(0, int(headroom_bytes // kv_bytes_per_slot))
