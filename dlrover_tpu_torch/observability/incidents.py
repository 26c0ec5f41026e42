"""Incident anatomy: per-recovery forensics on the event journal.

The port's copy of ``dlrover_tpu/observability/incidents.py``. The
journal says that goodput was lost; this says which incident cost what.
:func:`stitch_incidents` folds the events into :class:`Incident`
records, one a fault → recovery episode, by correlating

    fault_detected → rdzv_start/complete → reshard_* → restore
    → recompile → step_resumed

Each carries a phase waterfall whose segments sum to its detect → first
step time, the rollback distance, the restore rung that won and those
that aborted, the ``trace_id`` of the master's ``fault.relaunch`` arc, and
a counterfactual line for a pre-emptive save.

- Only ``fault_detected`` opens an incident. The master never records it
  for a serving node (a replica's loss is a serving event), so serving
  events open no incident and never recolour one.
- A second fault while incidents are open opens another; all open ones
  close at the same ``step_resumed``.
- An incident still open at the end closes ``unresolved`` at ``now_t``.

Served by the master's ``GET /incidents``, written into every bundle as
``incidents.json``, and drawn as the timeline's "incidents" track; the
``dlrover_incident_*`` families come from
:meth:`IncidentStitcher.attach_metrics`; the post-mortem CLI
(``python -m dlrover_tpu_torch.observability.report``) renders them as
text.
"""

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import MetricLabel
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.journal import (
    JournalEvent,
    Phase,
    attribute_phases,
    phase_segments,
)

# every journal kind the stitcher reads that is not a phase transition
CORRELATED_KINDS: Tuple[str, ...] = (
    JournalEvent.RESHARD_PLANNED,
    JournalEvent.RESHARD_REPLAN_DEGRADED,
    JournalEvent.CKPT_CHAIN_TRUNCATED,
    JournalEvent.FAULT_INJECTED,
    JournalEvent.BRAIN_ACTION,
    JournalEvent.CKPT_COMMITTED,
)

RESOLVED = "resolved"
UNRESOLVED = "unresolved"


@dataclass
class Incident:
    """One fault→recovery episode stitched from the journal."""

    incident_id: int  # seq of the opening fault_detected event (stable)
    node_id: Any
    status: str
    trace_id: Optional[str]
    t_fault: float
    t_end: float
    resolution: str = UNRESOLVED
    t_first_action: Optional[float] = None
    step_at_fault: Optional[int] = None
    restored_step: Optional[int] = None
    resumed_step: Optional[int] = None
    rollback_steps: Optional[int] = None
    recompute_s: Optional[float] = None
    rung: str = MetricLabel.RUNG_UNKNOWN
    rungs_failed: List[Dict[str, Any]] = field(default_factory=list)
    phases: Dict[str, float] = field(default_factory=dict)
    waterfall: List[Dict[str, float]] = field(default_factory=list)
    counterfactual: Optional[Dict[str, Any]] = None
    event_count: int = 0

    @property
    def mttr_s(self) -> float:
        """Fault detected → first productive step (or now, if open)."""
        return self.t_end - self.t_fault

    @property
    def mttd_s(self) -> Optional[float]:
        """Fault detected → first recovery action (the control plane's
        reaction time; the detector's blind window precedes the journal —
        see journal.py's module docstring)."""
        if self.t_first_action is None:
            return None
        return self.t_first_action - self.t_fault

    @property
    def goodput_loss_s(self) -> float:
        """Window seconds NOT attributed to productive/serving."""
        return sum(
            s for phase, s in self.phases.items()
            if phase not in (Phase.PRODUCTIVE, Phase.SERVING)
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "incident_id": self.incident_id,
            "node_id": self.node_id,
            "status": self.status,
            "trace_id": self.trace_id,
            "t_fault": self.t_fault,
            "t_end": self.t_end,
            "resolution": self.resolution,
            "mttr_s": self.mttr_s,
            "mttd_s": self.mttd_s,
            "goodput_loss_s": self.goodput_loss_s,
            "step_at_fault": self.step_at_fault,
            "restored_step": self.restored_step,
            "resumed_step": self.resumed_step,
            "rollback_steps": self.rollback_steps,
            "recompute_s": self.recompute_s,
            "rung": self.rung,
            "rungs_failed": list(self.rungs_failed),
            "phases": dict(self.phases),
            "waterfall": list(self.waterfall),
            "counterfactual": self.counterfactual,
            "event_count": self.event_count,
        }


# journal kinds that mark the control plane's FIRST recovery action for
# MTTD purposes — whichever lands first after the fault
_FIRST_ACTION_KINDS = (
    JournalEvent.RDZV_START,
    JournalEvent.RESHARD_PLANNED,
    JournalEvent.RESHARD_START,
)

# rungs_failed rows: journal kind → the ladder rung that gave up there
_ABORT_RUNGS = {
    JournalEvent.RESHARD_ABORTED: MetricLabel.RUNG_RESHARD,
    JournalEvent.CKPT_CHAIN_TRUNCATED: MetricLabel.RUNG_CHAIN,
}


def _finalize(inc: Incident, window: List[Dict[str, Any]], t_end: float,
              step_time_s: Optional[float]) -> Incident:
    """Close one incident over its [t_fault, t_end] event window: phase
    waterfall, rung attribution, rollback math."""
    inc.t_end = t_end
    events = [e for e in window
              if inc.t_fault <= float(e.get("t", 0.0)) <= t_end]
    inc.event_count = len(events)
    inc.phases = attribute_phases(events, t_end, start_t=inc.t_fault)
    inc.waterfall = [
        {"phase": phase, "begin": begin, "end": end}
        for phase, begin, end in phase_segments(
            events, t_end, start_t=inc.t_fault)
    ]
    for e in events:
        kind = e.get("kind", "")
        data = e.get("data", {}) or {}
        t = float(e.get("t", 0.0))
        if (kind in _FIRST_ACTION_KINDS
                and inc.t_first_action is None):
            inc.t_first_action = t
        if kind == JournalEvent.RESTORE_COMPLETE:
            # the LAST restore to land is the one training resumed from
            inc.rung = data.get("medium", MetricLabel.RUNG_UNKNOWN)
            if data.get("step") is not None:
                inc.restored_step = int(data["step"])
        elif kind in _ABORT_RUNGS:
            inc.rungs_failed.append({
                "rung": _ABORT_RUNGS[kind],
                "reason": data.get("reason", ""),
            })
        elif kind == JournalEvent.RESHARD_REPLAN_DEGRADED:
            inc.rungs_failed.append({
                "rung": MetricLabel.RUNG_RESHARD,
                "reason": f"replan_degraded:{data.get('reason', '')}",
            })
    if inc.rung not in MetricLabel.RESTORE_RUNGS:
        inc.rung = MetricLabel.RUNG_UNKNOWN
    if (inc.step_at_fault is not None
            and inc.restored_step is not None):
        inc.rollback_steps = max(0, inc.step_at_fault - inc.restored_step)
        if step_time_s:
            inc.recompute_s = inc.rollback_steps * step_time_s
    if inc.counterfactual is not None and step_time_s:
        saved = inc.counterfactual.get("steps_saved")
        if saved is not None:
            inc.counterfactual["goodput_saved_s"] = saved * step_time_s
    return inc


def stitch_incidents(
    events: List[Dict[str, Any]],
    now_t: float,
    step_time_s: Optional[float] = None,
) -> List[Incident]:
    """Fold a journal event list into Incident records. ``events`` are
    journal dicts (seq/t/kind/source/data) in any order; ``now_t`` closes
    still-open incidents as unresolved; ``step_time_s`` (the brain's
    step-time EWMA, when known) converts rollback steps and
    counterfactually-saved steps into seconds."""
    incidents: List[Incident] = []
    open_ids: List[int] = []  # indexes into `incidents`
    window: List[Dict[str, Any]] = []  # events shared by open incidents
    # counterfactual baselines, tracked as the stream replays
    last_periodic_step: Optional[int] = None
    last_preempt_action: Optional[Dict[str, Any]] = None
    last_preempt_commit: Optional[Dict[str, Any]] = None

    for e in sorted(events,
                    key=lambda e: (e.get("t", 0.0), e.get("seq", 0))):
        kind = e.get("kind", "")
        data = e.get("data", {}) or {}
        t = float(e.get("t", 0.0))
        if kind == JournalEvent.CKPT_COMMITTED:
            step = data.get("step")
            if data.get("trigger") == MetricLabel.CKPT_TRIGGER_PREEMPTIVE:
                last_preempt_commit = {"t": t, "step": step}
            elif step is not None:
                last_periodic_step = int(step)
            continue
        if (kind == JournalEvent.BRAIN_ACTION
                and data.get("action") == "preempt_ckpt"):
            last_preempt_action = {
                "t": t,
                "node_id": data.get("node_id"),
                "probability": data.get("probability"),
            }
            continue
        if kind == JournalEvent.FAULT_DETECTED:
            inc = Incident(
                incident_id=int(e.get("seq", len(incidents) + 1)),
                node_id=data.get("node_id"),
                status=str(data.get("status", "")),
                trace_id=data.get("trace_id"),
                t_fault=t,
                t_end=now_t,
                step_at_fault=(int(data["step"])
                               if data.get("step") is not None else None),
            )
            if last_preempt_action is not None:
                committed = (last_preempt_commit.get("step")
                             if last_preempt_commit is not None else None)
                steps_saved = 0
                if committed is not None:
                    steps_saved = max(
                        0, int(committed) - (last_periodic_step or 0))
                inc.counterfactual = {
                    "preempt_t": last_preempt_action["t"],
                    "predicted_node_id": last_preempt_action["node_id"],
                    "probability": last_preempt_action["probability"],
                    "hit": last_preempt_action["node_id"]
                    == data.get("node_id"),
                    "committed_step": committed,
                    "last_periodic_step": last_periodic_step,
                    "steps_saved": steps_saved,
                    "goodput_saved_s": None,  # filled by _finalize
                }
                # one pre-emptive save is scored against the first fault
                # it precedes — never re-credited to later incidents
                last_preempt_action = None
                last_preempt_commit = None
            if not open_ids:
                window = []
            incidents.append(inc)
            open_ids.append(len(incidents) - 1)
            window.append(e)
            continue
        if not open_ids:
            continue
        if kind in _TRACKED_KINDS:
            window.append(e)
        if kind == JournalEvent.STEP_RESUMED:
            resumed = (int(data["step"])
                       if data.get("step") is not None else None)
            for i in open_ids:
                incidents[i].resolution = RESOLVED
                incidents[i].resumed_step = resumed
                _finalize(incidents[i], window, t, step_time_s)
            open_ids = []
            window = []
    for i in open_ids:
        _finalize(incidents[i], window, now_t, step_time_s)
    return incidents


# everything an open incident's window collects: the phase-transition
# kinds (minus serving — SERVE events belong to the serving plane and
# must not recolor a training incident's waterfall) plus the correlated
# informational kinds above
_TRACKED_KINDS = frozenset(
    (
        JournalEvent.FAULT_DETECTED,
        JournalEvent.RDZV_START,
        JournalEvent.RDZV_COMPLETE,
        JournalEvent.RESTORE_START,
        JournalEvent.RESTORE_COMPLETE,
        JournalEvent.RECOMPILE_START,
        JournalEvent.RECOMPILE_COMPLETE,
        JournalEvent.RESHARD_START,
        JournalEvent.RESHARD_COMPLETE,
        JournalEvent.RESHARD_ABORTED,
        JournalEvent.STEP_RESUMED,
    )
) | frozenset(CORRELATED_KINDS)


def stitch_journal_dict(journal: Dict[str, Any],
                        step_time_s: Optional[float] = None
                        ) -> List[Incident]:
    """Stitch a serialized journal (``EventJournal.to_json()`` payload /
    a bundle's journal.json) — the offline twin of ``stitch_incidents``."""
    return stitch_incidents(
        journal.get("events", []) or [],
        float(journal.get("now_t", 0.0)),
        step_time_s=step_time_s,
    )


class IncidentStitcher:
    """Live stitcher over one master's EventJournal. ``step_time_fn``
    returns the current seconds-per-step estimate (or None) — the master
    wires it to the brain's step-time EWMA with the perf monitor's
    running speed as fallback."""

    def __init__(self, journal,
                 step_time_fn: Optional[Callable[[], Optional[float]]]
                 = None):
        self._journal = journal
        self._step_time_fn = step_time_fn

    def step_time_s(self) -> Optional[float]:
        if self._step_time_fn is None:
            return None
        try:
            got = self._step_time_fn()
            return float(got) if got and got > 0.0 else None
        except Exception:  # noqa: BLE001 — forensics must not throw
            logger.warning("step-time estimate failed", exc_info=True)
            return None

    def stitch(self, now_t: Optional[float] = None) -> List[Incident]:
        return stitch_incidents(
            self._journal.events(),
            self._journal.now() if now_t is None else now_t,
            step_time_s=self.step_time_s(),
        )

    def to_json(self) -> str:
        incidents = self.stitch()
        return json.dumps({
            "now_t": self._journal.now(),
            "incidents": [inc.to_dict() for inc in incidents],
            "resolved": sum(1 for i in incidents
                            if i.resolution == RESOLVED),
        })

    def attach_metrics(self, registry) -> Callable[[], None]:
        """Register the ``dlrover_incident_*`` families; a collect hook
        re-stitches per scrape and exports each RESOLVED incident exactly
        once (keyed by its opening seq, stable across re-stitches).
        Returns the hook, for ``registry.remove_collect_hook``."""
        mttr = registry.histogram(
            "dlrover_incident_mttr_seconds",
            "Fault detected → first productive step, per incident",
        )
        mttd = registry.histogram(
            "dlrover_incident_mttd_seconds",
            "Fault detected → first recovery action, per incident",
        )
        rollback = registry.histogram(
            "dlrover_incident_rollback_steps",
            "Steps lost to rollback (step at fault - restored step)",
            buckets=(0, 1, 2, 5, 10, 25, 50, 100, 250, 1000),
        )
        loss = registry.counter(
            "dlrover_incident_goodput_loss_seconds_total",
            "Recovery wall seconds, by the phase that consumed them",
            ("phase",),
        )
        rung_total = registry.counter(
            "dlrover_incident_restore_rung_total",
            "Resolved incidents by the restore-ladder rung that won",
            ("rung",),
        )
        total = registry.counter(
            "dlrover_incident_total", "Incidents stitched, by resolution",
            ("resolution",),
        )
        exported: set = set()

        def collect() -> None:
            for inc in self.stitch():
                if inc.resolution != RESOLVED:
                    continue
                if inc.incident_id in exported:
                    continue
                exported.add(inc.incident_id)
                mttr.observe(inc.mttr_s, exemplar=inc.trace_id)
                if inc.mttd_s is not None:
                    mttd.observe(inc.mttd_s)
                if inc.rollback_steps is not None:
                    rollback.observe(inc.rollback_steps)
                for phase, seconds in inc.phases.items():
                    if phase in (Phase.PRODUCTIVE, Phase.SERVING):
                        continue
                    if seconds > 0.0:
                        loss.labels(phase=phase).inc(seconds)
                rung_total.labels(rung=inc.rung).inc()
                total.labels(resolution=inc.resolution).inc()

        registry.add_collect_hook(collect)
        return collect
