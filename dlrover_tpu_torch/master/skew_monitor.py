"""Cross-worker skew & hang attribution from per-rank op-class telemetry.

The port's copy of ``dlrover_tpu/master/skew_monitor.py``, whole: the
master-side consumer of the op-telemetry uplink (``observability/
op_telemetry.py`` → ``worker.publish_step`` → the agent's heartbeat →
``master/servicer.py``). It keeps a sliding window of every rank's
cumulative histograms, diffs consecutive snapshots into per-window means,
and turns cross-rank comparison into *verdicts*:

- ``straggler(rank, cause ∈ {compute, collective, input})`` — the rank's
  mean op duration for that class exceeds ``skew_multiple`` (default 2×)
  times the cross-rank LOWER median (``times[(n-1)//2]``: with the upper
  median a 2-rank world could never flag anyone);
- ``hang(collective, entered_ranks, missing_ranks)`` — every rank's
  last-entered-collective counter stalled across the window AND the
  counters are unequal: the ranks at the max count are parked inside a
  collective the lagging ranks never entered. Equal stalled counters blame
  nobody.

Verdicts are journaled once per episode (``straggler_detected``,
``hang_attributed``) and gauged (``dlrover_skew_*``, ``dlrover_hang_*``);
``node_straggler_counts`` is the history the training rendezvous's world
cut consults, and ``export_straggler_state`` / ``restore_straggler_state``
carry it across a master restart. Clocks: snapshots are stamped with the
MASTER's monotonic arrival time; agent clocks never enter a comparison. A
rank whose observation counter goes backwards restarted: its window is
reset, never diffed across incarnations. Nothing of the reference is left
out; :meth:`SkewMonitor.last_collectives` and
:meth:`SkewMonitor.forget_node` (the master drops a failed node's windows,
ROADMAP C17) are the port's additions.
"""

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import ConfigKey, env_float, env_int
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.journal import JournalEvent
from dlrover_tpu_torch.observability.op_telemetry import (
    OpClass,
    OpClassHistogram,
)

# op classes a straggler verdict can blame: ckpt durations are dominated
# by per-rank shard sizes, so cross-rank ckpt skew is expected, not a fault
_BLAMEABLE_CLASSES = (OpClass.COMPUTE, OpClass.COLLECTIVE, OpClass.HOST_INPUT)

DEFAULT_SKEW_MULTIPLE = 2.0
DEFAULT_WINDOW = 8          # snapshots kept per rank
DEFAULT_STALE_S = 90.0      # ignore ranks whose agent stopped reporting
DEFAULT_HANG_MIN_SAMPLES = 3  # stalled snapshots before a hang verdict


def _lower_median(values: List[float]) -> float:
    ordered = sorted(values)
    return ordered[(len(ordered) - 1) // 2]


class SkewMonitor:
    """Sliding-window skew/hang attribution; one instance per master.

    ``observe()`` is called from the heartbeat RPC path and re-evaluates
    verdicts inline — the math is a few dict scans over at most
    ``window`` snapshots per rank, far cheaper than the RPC itself."""

    def __init__(
        self,
        event_journal=None,
        registry=None,
        skew_multiple: Optional[float] = None,
        window: Optional[int] = None,
        stale_s: float = DEFAULT_STALE_S,
        hang_min_samples: int = DEFAULT_HANG_MIN_SAMPLES,
        monotonic: Callable[[], float] = time.monotonic,
    ):
        self._journal = event_journal
        self._skew_multiple = skew_multiple if skew_multiple is not None \
            else env_float(ConfigKey.SKEW_THRESHOLD, DEFAULT_SKEW_MULTIPLE)
        self._window = window if window is not None \
            else env_int(ConfigKey.SKEW_WINDOW, DEFAULT_WINDOW)
        self._stale_s = stale_s
        self._hang_min_samples = max(2, hang_min_samples)
        self._monotonic = monotonic
        self._lock = threading.Lock()
        # rank → deque[(master-monotonic arrival, snapshot)]
        self._snaps: Dict[int, deque] = {}
        self._rank_node: Dict[int, int] = {}
        # rank → number of distinct straggler verdicts emitted against it
        # (rdzv world-cutting consults this history via the master wiring)
        self._straggler_counts: Dict[int, int] = {}
        self._current_stragglers: List[Dict[str, Any]] = []
        self._current_hang: Optional[Dict[str, Any]] = None
        self._journaled_stragglers: set = set()
        self._journaled_hang = None
        self._last_ratios: Dict[str, Dict[int, float]] = {}
        if registry is None:
            from dlrover_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        self._g_ratio = registry.gauge(
            "dlrover_skew_ratio",
            "Worst cross-rank skew ratio (rank mean / lower median) per "
            "op class over the current window",
            labelnames=("op_class",),
        )
        self._g_rank_ratio = registry.gauge(
            "dlrover_skew_rank_ratio",
            "Per-rank skew ratio (rank mean / lower median) per op class",
            labelnames=("op_class", "rank"),
        )
        self._g_straggler_rank = registry.gauge(
            "dlrover_skew_straggler_rank",
            "Rank currently flagged as straggler per cause (-1 = none)",
            labelnames=("cause",),
        )
        self._c_verdicts = registry.counter(
            "dlrover_skew_verdicts_total",
            "Straggler verdicts emitted, by cause",
            labelnames=("cause",),
        )
        self._g_hang = registry.gauge(
            "dlrover_hang_suspected",
            "1 while a hang verdict is active, else 0",
        )
        self._g_hang_missing = registry.gauge(
            "dlrover_hang_missing_ranks",
            "Ranks that never entered the hung collective (0 = no hang)",
        )
        self._c_hangs = registry.counter(
            "dlrover_hang_verdicts_total", "Hang verdicts emitted",
        )
        for cause in _BLAMEABLE_CLASSES:
            self._g_straggler_rank.labels(cause=cause).set(-1)

    # -- ingest -------------------------------------------------------------

    def observe(self, node_id: int, op_telemetry: Dict[str, Any]) -> None:
        """Ingest one heartbeat's worth of per-rank snapshots (keyed by
        str(global_rank)) and re-evaluate verdicts."""
        self.observe_many([(node_id, op_telemetry)])

    def observe_many(self, items) -> None:
        """Ingest several nodes' telemetry — the fan-in path: an
        aggregator's compound envelope carries a whole subtree's
        snapshots, absorbed under one lock pass and ONE re-evaluation
        instead of one per child heartbeat. ``items`` is an iterable of
        ``(node_id, op_telemetry)`` pairs."""
        arrival = self._monotonic()
        with self._lock:
            for node_id, op_telemetry in items:
                self._ingest_one_locked(node_id, op_telemetry, arrival)
        self.evaluate()

    def _ingest_one_locked(self, node_id: int,
                           op_telemetry: Dict[str, Any],
                           arrival: float) -> None:
        for rank_key, snap in (op_telemetry or {}).items():
            try:
                rank = int(rank_key)
                snap = dict(snap)
                seq = int(snap.get("seq", 0))
            except (TypeError, ValueError):
                logger.warning("malformed op-telemetry for key %r from "
                               "node %s", rank_key, node_id)
                continue
            self._rank_node[rank] = node_id
            dq = self._snaps.get(rank)
            if dq is None:
                dq = deque(maxlen=self._window)
                self._snaps[rank] = dq
            if dq and seq < int(dq[-1][1].get("seq", 0)):
                # observation counter went backwards: the worker
                # restarted — never diff across incarnations
                dq.clear()
            dq.append((arrival, snap))

    # -- evaluation ---------------------------------------------------------

    def evaluate(self) -> Dict[str, Any]:
        """Recompute verdicts from the current windows; journals verdict
        *changes* (a persisting straggler is one event, not one per
        heartbeat) and refreshes the gauge families. Returns the current
        verdict dict (also available via :meth:`current_verdicts`)."""
        now = self._monotonic()
        with self._lock:
            windows = self._fresh_windows(now)
            stragglers = self._find_stragglers(windows)
            hang = self._find_hang(windows)
            self._current_stragglers = stragglers
            self._current_hang = hang
            new_events = self._diff_for_journal(stragglers, hang)
        # journal + counters OUTSIDE the monitor lock (the journal takes
        # its own lock and fans out to listeners)
        for kind, data in new_events:
            if kind == JournalEvent.STRAGGLER_DETECTED:
                self._c_verdicts.labels(cause=data["cause"]).inc()
            else:
                self._c_hangs.inc()
            if self._journal is not None:
                self._journal.record(kind, source="skew_monitor", **data)
            logger.warning("skew verdict: %s %s", kind, data)
        self._set_gauges(stragglers, hang)
        return {"stragglers": stragglers, "hang": hang}

    def _fresh_windows(self, now: float) -> Dict[int, List[Dict[str, Any]]]:
        """rank → [oldest snapshot, ..., newest] for ranks still being
        reported on (agent heartbeat within ``stale_s``) with at least two
        snapshots to diff. Caller holds the lock."""
        out: Dict[int, List[Dict[str, Any]]] = {}
        for rank, dq in self._snaps.items():
            if len(dq) < 2 or now - dq[-1][0] > self._stale_s:
                continue
            out[rank] = [snap for _, snap in dq]
        return out

    def _find_stragglers(
        self, windows: Dict[int, List[Dict[str, Any]]]
    ) -> List[Dict[str, Any]]:
        stragglers: List[Dict[str, Any]] = []
        self._last_ratios: Dict[str, Dict[int, float]] = {}
        for op_class in _BLAMEABLE_CLASSES:
            means: Dict[int, float] = {}
            for rank, snaps in windows.items():
                first = OpClassHistogram.from_wire(
                    snaps[0].get("classes", {}).get(op_class, {}))
                last = OpClassHistogram.from_wire(
                    snaps[-1].get("classes", {}).get(op_class, {}))
                dn = last.count - first.count
                dsum = last.sum_us - first.sum_us
                if dn > 0 and dsum >= 0:
                    means[rank] = dsum / dn
            if len(means) < 2:
                continue
            median = _lower_median(list(means.values()))
            if median <= 0:
                continue
            ratios = {rank: mean / median for rank, mean in means.items()}
            self._last_ratios[op_class] = ratios
            for rank, ratio in sorted(ratios.items()):
                if ratio > self._skew_multiple:
                    stragglers.append({
                        "rank": rank,
                        "node_id": self._rank_node.get(rank, -1),
                        "cause": op_class,
                        "ratio": round(ratio, 3),
                        "mean_us": round(means[rank], 1),
                        "median_us": round(median, 1),
                    })
        return stragglers

    def _find_hang(
        self, windows: Dict[int, List[Dict[str, Any]]]
    ) -> Optional[Dict[str, Any]]:
        """All fresh ranks' last-entered-collective counters stalled for
        the whole window AND unequal ⇒ the max-count ranks are inside a
        collective the lagging ranks never entered. Caller holds lock."""
        if len(windows) < 2:
            return None
        seqs: Dict[int, int] = {}
        names: Dict[int, str] = {}
        for rank, snaps in windows.items():
            if len(snaps) < self._hang_min_samples:
                return None  # not enough evidence of a stall yet
            lc_first = snaps[-self._hang_min_samples].get(
                "last_collective", {}) or {}
            lc_last = snaps[-1].get("last_collective", {}) or {}
            if int(lc_last.get("seq", 0)) != int(lc_first.get("seq", 0)):
                return None  # this rank is still entering collectives
            seqs[rank] = int(lc_last.get("seq", 0))
            names[rank] = str(lc_last.get("name", ""))
        max_seq = max(seqs.values())
        if max_seq == 0 or min(seqs.values()) == max_seq:
            # nobody in a collective, or everyone stalled at the SAME
            # point — stalled-but-equal is a compute/input stall, not a
            # collective hang; blame nothing
            return None
        entered = sorted(r for r, s in seqs.items() if s == max_seq)
        missing = sorted(r for r, s in seqs.items() if s < max_seq)
        return {
            "collective": names[entered[0]],
            "entered_ranks": entered,
            "missing_ranks": missing,
        }

    def _diff_for_journal(self, stragglers, hang):
        """Dedup verdicts against what was already journaled; re-arming
        happens when a verdict clears (a flapping straggler journals once
        per episode, and its straggler_count grows per episode). Caller
        holds the lock."""
        events = []
        keys = set()
        for s in stragglers:
            key = (s["rank"], s["cause"])
            keys.add(key)
            if key not in self._journaled_stragglers:
                self._straggler_counts[s["rank"]] = \
                    self._straggler_counts.get(s["rank"], 0) + 1
                events.append((JournalEvent.STRAGGLER_DETECTED, dict(s)))
        self._journaled_stragglers = keys
        hang_key = None if hang is None else (
            hang["collective"], tuple(hang["missing_ranks"]))
        if hang_key is not None and hang_key != self._journaled_hang:
            events.append((JournalEvent.HANG_ATTRIBUTED, dict(hang)))
        self._journaled_hang = hang_key
        return events

    def _set_gauges(self, stragglers, hang) -> None:
        ratios = getattr(self, "_last_ratios", {})
        for op_class in _BLAMEABLE_CLASSES:
            per_rank = ratios.get(op_class, {})
            self._g_ratio.labels(op_class=op_class).set(
                max(per_rank.values()) if per_rank else 0.0)
            for rank, ratio in per_rank.items():
                self._g_rank_ratio.labels(
                    op_class=op_class, rank=str(rank)).set(ratio)
        flagged = {s["cause"]: s["rank"] for s in stragglers}
        for cause in _BLAMEABLE_CLASSES:
            self._g_straggler_rank.labels(cause=cause).set(
                flagged.get(cause, -1))
        self._g_hang.set(0.0 if hang is None else 1.0)
        self._g_hang_missing.set(
            0.0 if hang is None else len(hang["missing_ranks"]))

    # -- consumers ----------------------------------------------------------

    def current_verdicts(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "stragglers": [dict(s) for s in self._current_stragglers],
                "hang": None if self._current_hang is None
                else dict(self._current_hang),
            }

    def window_deltas(self) -> Dict[str, Dict[int, Dict[str, float]]]:
        """op_class → rank → {mean_us, count} over the current fresh
        window — the per-tick op-histogram delta the TelemetryPersister
        batches into the brain datastore (same diff math as the straggler
        verdicts, exposed as data instead of a verdict)."""
        now = self._monotonic()
        out: Dict[str, Dict[int, Dict[str, float]]] = {}
        with self._lock:
            windows = self._fresh_windows(now)
            for op_class in _BLAMEABLE_CLASSES:
                per_rank: Dict[int, Dict[str, float]] = {}
                for rank, snaps in windows.items():
                    first = OpClassHistogram.from_wire(
                        snaps[0].get("classes", {}).get(op_class, {}))
                    last = OpClassHistogram.from_wire(
                        snaps[-1].get("classes", {}).get(op_class, {}))
                    dn = last.count - first.count
                    dsum = last.sum_us - first.sum_us
                    if dn > 0 and dsum >= 0:
                        per_rank[rank] = {
                            "mean_us": round(dsum / dn, 1),
                            "count": float(dn),
                        }
                if per_rank:
                    out[op_class] = per_rank
        return out

    def node_straggler_counts(self) -> Dict[int, int]:
        """node_id → accumulated straggler-episode count across its ranks
        — the history rdzv_manager consults when cutting a world down."""
        with self._lock:
            out: Dict[int, int] = {}
            for rank, count in self._straggler_counts.items():
                node = self._rank_node.get(rank, -1)
                out[node] = out.get(node, 0) + count
            return out

    def last_collectives(self) -> Dict[int, Dict[str, Any]]:
        """rank → the last-entered-collective marker of its newest
        snapshot (``{"name", "seq"}``), for every rank still reported on.
        The port's addition: a steady world shows equal counters."""
        now = self._monotonic()
        with self._lock:
            return {rank: dict(dq[-1][1].get("last_collective") or {})
                    for rank, dq in self._snaps.items()
                    if dq and now - dq[-1][0] <= self._stale_s}

    def forget_node(self, node_id: int) -> None:
        """Drop the windows of every rank the node reported (it left the
        world): a dead node's last snapshots would otherwise stay fresh
        for ``stale_s`` and, stalled beside the survivors' restarted
        counters, read as a hang. The port's addition; the straggler
        history is kept."""
        with self._lock:
            for rank, node in self._rank_node.items():
                if node == node_id:
                    self._snaps.pop(rank, None)

    def reset_rank(self, rank: int) -> None:
        """Drop a rank's window (e.g. its node left the world)."""
        with self._lock:
            self._snaps.pop(rank, None)

    # -- failover persistence ----------------------------------------------

    def export_straggler_state(self) -> Dict[str, Any]:
        """Straggler-episode history for MasterStateStore snapshots. Keys
        are stringified (state_store.load unpacks with string map keys
        only); the rank→node map rides along so restored counts still
        aggregate per node for the rdzv world-cut bias."""
        with self._lock:
            return {
                "counts": {str(r): c
                           for r, c in self._straggler_counts.items()},
                "rank_node": {str(r): n
                              for r, n in self._rank_node.items()},
            }

    def restore_straggler_state(self, state: Dict[str, Any]) -> None:
        """Re-seed straggler history after a master restart — without
        this, repeat-straggler world-cut biasing silently resets on
        failover. Telemetry windows are NOT restored (they are stale by
        definition); only the episode counts and rank→node attribution."""
        if not state:
            return
        with self._lock:
            for rank_key, count in (state.get("counts") or {}).items():
                try:
                    self._straggler_counts[int(rank_key)] = int(count)
                except (TypeError, ValueError):
                    continue
            for rank_key, node in (state.get("rank_node") or {}).items():
                try:
                    self._rank_node.setdefault(int(rank_key), int(node))
                except (TypeError, ValueError):
                    continue
