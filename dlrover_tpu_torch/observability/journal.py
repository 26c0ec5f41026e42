"""The master's event journal and goodput attribution.

The port's copy of ``dlrover_tpu/observability/journal.py``. The master
holds one append-only sequence of typed job events. Master-side
components record directly; agents, workers and replicas report over the
``report_event`` RPC and the master stamps the arrival time, so the
timestamps are job-relative monotonic seconds on the master's clock and
no two hosts' clocks are ever compared.

From that sequence every second of wall time is classified into exactly
one phase (productive, detect, rendezvous, restore, recompile, reshard,
serving) by a small state machine (:func:`phase_segments`). On the
serving plane a replica's registration opens ``serving``, an unplanned
replica loss opens ``detect`` until the autoscaler's replacement
registers, and a planned drain is informational.

What the journal cannot see: the time between a fault and its detection
is attributed to the phase the job was in when the fault hit, because no
event exists until the detection.

The journal is served as JSON by ``GET /events`` on the master's and a
replica's HTTP server (``common/http_server.py``), and rides every
flight-recorder bundle (``journal.json``), whose ``incidents.json`` and
chrome-trace tracks (``observability/incidents.py``,
``observability/timeline.py``) are built from it. Trimmed to the kinds
the port records or reads: every kind outside ``_TRANSITIONS`` is
informational and moves no phase.
"""

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import logger


class JournalEvent:
    """Typed event kinds: plain strings on the wire and in JSON."""

    FAULT_DETECTED = "fault_detected"
    RDZV_START = "rdzv_start"
    RDZV_COMPLETE = "rdzv_complete"
    RESTORE_START = "restore_start"
    RESTORE_COMPLETE = "restore_complete"
    RECOMPILE_START = "recompile_start"
    RECOMPILE_COMPLETE = "recompile_complete"
    STEP_RESUMED = "step_resumed"
    # informational: a fault the injection plane fired, and the ring's own
    # overflow (one note per burst of drops)
    FAULT_INJECTED = "fault_injected"
    JOURNAL_RING_OVERFLOW = "journal_ring_overflow"
    # the live-reshard leg: start enters the reshard phase, completion
    # the recompile phase, an abort falls back to the restore phase
    RESHARD_START = "reshard_start"
    RESHARD_COMPLETE = "reshard_complete"
    RESHARD_ABORTED = "reshard_aborted"
    # the elastic decode-serving plane: replica lifecycle (up drives the
    # serving phase, an unplanned loss drives detect until the
    # autoscaler restores capacity, a planned drain is informational),
    # the router's request outcomes (a failed attempt and the re-route
    # that saves it), and applied serving scale plans
    SERVE_REPLICA_UP = "serve_replica_up"
    SERVE_REPLICA_LOST = "serve_replica_lost"
    SERVE_REPLICA_DRAINED = "serve_replica_drained"
    SERVE_REQUEST_FAILED = "serve_request_failed"
    SERVE_REROUTED = "serve_rerouted"
    SERVE_SCALE = "serve_scale"
    # the serving SLO plane: a multi-window burn-rate breach, data
    # {slo, tier, window, rate, slow_rate}; informational
    SLO_BURN_ALERT = "slo_burn_alert"
    # informational, recorded by the port: a flight-recorder bundle was
    # written; a reused prefix and a reuse dropped to the cold prefill
    # (serving/prefix_cache.py); a slow request's attributed cause
    # (serving/tail.py); a fabric source failed, a stripe re-queued, and
    # a transfer session's outcome (common/fabric.py)
    TRACE_BUNDLE_CAPTURED = "trace_bundle_captured"
    SERVE_PREFIX_HIT = "serve_prefix_hit"
    SERVE_PREFIX_DROPPED = "serve_prefix_dropped"
    REQUEST_TAIL_ATTRIBUTED = "request_tail_attributed"
    FABRIC_SOURCE_FAILED = "fabric_source_failed"
    FABRIC_STRIPE_RETRIED = "fabric_stripe_retried"
    FABRIC_SESSION_COMPLETE = "fabric_session_complete"
    FABRIC_SESSION_ABORTED = "fabric_session_aborted"
    # informational, recorded by the port's attribution plane: the skew
    # monitor's verdicts (master/skew_monitor.py), the evidence an agent
    # captured for a straggler verdict, the memory accountant's pressure
    # and degraded sweeps (observability/memory.py) and the compile
    # watch's storms (observability/compile_watch.py)
    STRAGGLER_DETECTED = "straggler_detected"
    HANG_ATTRIBUTED = "hang_attributed"
    STACK_DUMP_CAPTURED = "stack_dump_captured"
    MEMORY_PRESSURE = "memory_pressure"
    MEMORY_DEGRADED = "memory_degraded"
    RECOMPILE_STORM = "recompile_storm"
    # informational kinds of the reference's planes the port has not
    # ported, read by the incident stitcher and the timeline's tracks
    # when a JAX peer's journal carries them
    CKPT_COMMITTED = "ckpt_committed"
    # informational: a frame failed its CRCs, a replica's copy repaired
    # it, and a restarted agent unlinked its predecessor's segments
    CKPT_CORRUPT = "ckpt_corrupt"
    CKPT_REPAIRED = "ckpt_repaired"
    SHM_ORPHANS_CLEANED = "shm_orphans_cleaned"
    CKPT_CHAIN_TRUNCATED = "ckpt_chain_truncated"
    RESHARD_PLANNED = "reshard_planned"
    RESHARD_REPLAN_DEGRADED = "reshard_replan_degraded"
    BRAIN_PREDICTED_FAILURE = "brain_predicted_failure"
    BRAIN_PREDICTED_RAMP = "brain_predicted_ramp"
    BRAIN_PREDICTED_STRAGGLER = "brain_predicted_straggler"
    BRAIN_PREDICTION_SCORED = "brain_prediction_scored"
    BRAIN_ACTION = "brain_action"
    BRAIN_DEGRADED = "brain_degraded"
    BRAIN_RECOVERED = "brain_recovered"
    BRAIN_PRESCALE_REFUSED = "brain_prescale_refused"

    ALL = (
        FAULT_DETECTED, RDZV_START, RDZV_COMPLETE, RESTORE_START,
        RESTORE_COMPLETE, RECOMPILE_START, RECOMPILE_COMPLETE, STEP_RESUMED,
        FAULT_INJECTED, JOURNAL_RING_OVERFLOW, RESHARD_START,
        RESHARD_COMPLETE, RESHARD_ABORTED,
        SERVE_REPLICA_UP, SERVE_REPLICA_LOST, SERVE_REPLICA_DRAINED,
        SERVE_REQUEST_FAILED, SERVE_REROUTED, SERVE_SCALE, SLO_BURN_ALERT,
        TRACE_BUNDLE_CAPTURED, SERVE_PREFIX_HIT, SERVE_PREFIX_DROPPED,
        REQUEST_TAIL_ATTRIBUTED, FABRIC_SOURCE_FAILED, FABRIC_STRIPE_RETRIED,
        FABRIC_SESSION_COMPLETE, FABRIC_SESSION_ABORTED, CKPT_COMMITTED,
        CKPT_CORRUPT, CKPT_REPAIRED, SHM_ORPHANS_CLEANED,
        CKPT_CHAIN_TRUNCATED, RESHARD_PLANNED, RESHARD_REPLAN_DEGRADED,
        STRAGGLER_DETECTED, HANG_ATTRIBUTED, STACK_DUMP_CAPTURED,
        BRAIN_PREDICTED_FAILURE,
        BRAIN_PREDICTED_RAMP, BRAIN_PREDICTED_STRAGGLER,
        BRAIN_PREDICTION_SCORED, BRAIN_ACTION, BRAIN_DEGRADED,
        BRAIN_RECOVERED, BRAIN_PRESCALE_REFUSED, MEMORY_PRESSURE,
        MEMORY_DEGRADED, RECOMPILE_STORM,
    )


class Phase:
    PRODUCTIVE = "productive"
    DETECT = "detect"
    RENDEZVOUS = "rendezvous"
    RESTORE = "restore"
    RECOMPILE = "recompile"
    RESHARD = "reshard"
    # serving: the registered replica capacity is up and taking traffic;
    # serving goodput over a window is the serving share of the window
    SERVING = "serving"

    ALL = (PRODUCTIVE, DETECT, RENDEZVOUS, RESTORE, RECOMPILE, RESHARD,
           SERVING)


# event kind → the phase the job enters when the event lands
_TRANSITIONS: Dict[str, str] = {
    JournalEvent.FAULT_DETECTED: Phase.DETECT,
    JournalEvent.RDZV_START: Phase.RENDEZVOUS,
    JournalEvent.RDZV_COMPLETE: Phase.RESTORE,
    JournalEvent.RESTORE_START: Phase.RESTORE,
    JournalEvent.RESTORE_COMPLETE: Phase.RECOMPILE,
    JournalEvent.RECOMPILE_START: Phase.RECOMPILE,
    JournalEvent.RECOMPILE_COMPLETE: Phase.PRODUCTIVE,
    JournalEvent.STEP_RESUMED: Phase.PRODUCTIVE,
    JournalEvent.RESHARD_START: Phase.RESHARD,
    JournalEvent.RESHARD_COMPLETE: Phase.RECOMPILE,
    JournalEvent.RESHARD_ABORTED: Phase.RESTORE,
    JournalEvent.SERVE_REPLICA_UP: Phase.SERVING,
    JournalEvent.SERVE_REPLICA_LOST: Phase.DETECT,
}


class EventJournal:
    """Append-only bounded ring of typed events with job-relative
    monotonic timestamps. Thread-safe; one per master."""

    def __init__(self, capacity: int = 4096,
                 overflow_note_gap_s: float = 60.0):
        self._capacity = capacity
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._seq = 0
        self._dropped = 0
        self._t0 = time.monotonic()
        self._wall0 = time.time()
        self._listeners: List[Callable[[Dict[str, Any]], None]] = []
        self._phase = Phase.PRODUCTIVE
        # drop bursts closer together than the gap are one episode and
        # get one overflow note, so an overflow cannot flood the ring
        self._overflow_note_gap_s = overflow_note_gap_s
        self._last_drop_t: Optional[float] = None

    @property
    def start_wall_ts(self) -> float:
        return self._wall0

    def now(self) -> float:
        """Job-relative monotonic seconds (since the journal was made)."""
        return time.monotonic() - self._t0

    def add_listener(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """``fn(event)`` is called, under no lock, for every event."""
        with self._lock:
            self._listeners.append(fn)

    def record(self, kind: str, source: str = "master",
               **data: Any) -> Dict[str, Any]:
        """Append one event and return it. ``source`` names the reporting
        component ("master", "router", "agent_3")."""
        with self._lock:
            self._seq += 1
            event = {
                "seq": self._seq,
                "t": time.monotonic() - self._t0,
                "ts": time.time(),
                "kind": str(kind),
                "source": str(source),
                "data": dict(data),
            }
            self._events.append(event)
            self._phase = _TRANSITIONS.get(event["kind"], self._phase)
            overflow_note = None
            if len(self._events) > self._capacity:
                drop = len(self._events) - self._capacity
                del self._events[:drop]
                self._dropped += drop
                gap = (None if self._last_drop_t is None
                       else event["t"] - self._last_drop_t)
                self._last_drop_t = event["t"]
                if ((gap is None or gap > self._overflow_note_gap_s)
                        and event["kind"]
                        != JournalEvent.JOURNAL_RING_OVERFLOW):
                    overflow_note = {"dropped_total": self._dropped,
                                     "capacity": self._capacity}
            listeners = list(self._listeners)
        if overflow_note is not None:
            # outside the lock; the kind check above ends any recursion
            self.record(JournalEvent.JOURNAL_RING_OVERFLOW, **overflow_note)
        for fn in listeners:
            try:
                fn(event)
            except Exception:  # noqa: BLE001 — telemetry must not kill work
                logger.warning("journal listener %r failed on %s event",
                               fn, event["kind"], exc_info=True)
        return event

    def current_phase(self) -> str:
        """The phase the state machine's last transition left in effect."""
        with self._lock:
            return self._phase

    def events(self, since_seq: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events if e["seq"] > since_seq]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def to_json(self, since_seq: int = 0) -> str:
        return json.dumps({
            "start_wall_ts": self._wall0,
            "now_t": self.now(),
            "dropped": self.dropped,
            "events": self.events(since_seq),
        })

    # -- attribution -------------------------------------------------------

    def phase_seconds(self, now_t: Optional[float] = None
                      ) -> Dict[str, float]:
        return attribute_phases(self.events(),
                                self.now() if now_t is None else now_t)

    def attach_gauges(self, registry) -> Callable[[], None]:
        """Register the goodput-attribution gauges on ``registry``: one a
        phase plus the wall seconds, all refreshed from one snapshot at
        each scrape, so the phases sum to the wall gauge exactly. Returns
        the collect hook, for ``registry.remove_collect_hook``."""
        gauges = {
            phase: registry.gauge(
                f"dlrover_goodput_{phase}_seconds",
                f"Wall seconds attributed to the {phase} phase")
            for phase in Phase.ALL
        }
        wall = registry.gauge(
            "dlrover_goodput_wall_seconds",
            "Wall seconds since master start (sum of the phase gauges)")
        events_total = registry.gauge(
            "dlrover_journal_events", "Events currently in the journal ring")
        dropped_total = registry.counter(
            "dlrover_journal_dropped_total",
            "Journal events dropped from the ring by overflow")
        exported = {"dropped": 0}

        def collect() -> None:
            now_t = self.now()
            seconds = self.phase_seconds(now_t)
            for phase, g in gauges.items():
                g.set(seconds.get(phase, 0.0))
            wall.set(now_t)
            events_total.set(len(self))
            d = self.dropped
            if d > exported["dropped"]:
                dropped_total.inc(d - exported["dropped"])
                exported["dropped"] = d

        registry.add_collect_hook(collect)
        return collect


def recovery_open(journal: "EventJournal") -> bool:
    """Whether the journal's latest ``fault_detected`` has not been
    followed by a ``step_resumed``: a recovery is under way."""
    for e in reversed(journal.events()):
        if e["kind"] == JournalEvent.STEP_RESUMED:
            return False
        if e["kind"] == JournalEvent.FAULT_DETECTED:
            return True
    return False


def phase_segments(events: List[Dict[str, Any]], now_t: float,
                   start_t: float = 0.0) -> List[Tuple[str, float, float]]:
    """Classify [start_t, now_t] into contiguous (phase, begin, end)
    segments. Kinds that move no phase are skipped."""
    segs: List[Tuple[str, float, float]] = []
    phase = Phase.PRODUCTIVE
    cursor = start_t
    for e in sorted(events, key=lambda e: (e.get("t", 0.0), e.get("seq", 0))):
        nxt = _TRANSITIONS.get(e.get("kind", ""))
        if nxt is None:
            continue
        t = min(max(float(e.get("t", 0.0)), cursor), now_t)
        if nxt != phase:
            if t > cursor:
                segs.append((phase, cursor, t))
            phase, cursor = nxt, t
    if now_t > cursor:
        segs.append((phase, cursor, now_t))
    return segs


def attribute_phases(events: List[Dict[str, Any]], now_t: float,
                     start_t: float = 0.0) -> Dict[str, float]:
    """Seconds a phase over [start_t, now_t]; they sum to the window."""
    out = {phase: 0.0 for phase in Phase.ALL}
    for phase, begin, end in phase_segments(events, now_t, start_t):
        out[phase] += end - begin
    return out
