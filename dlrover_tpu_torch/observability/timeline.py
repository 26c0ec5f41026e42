"""Chrome-trace tracks built from a journal and from spans.

The port's copy of the pure track builders of
``dlrover_tpu/observability/timeline.py``. Each takes a serialized journal
(``EventJournal.to_json()``, a bundle's ``journal.json``) or a list of
tracing spans and returns chrome-trace events on a synthetic process of
its own: the job phases, cross-worker skew, the brain's predictions,
stitched incidents, the device plane, and per-request serving
waterfalls. Journal tracks are on the journal's clock (job-relative
microseconds); the flight recorder maps span stamps onto it, so one
perfetto load lines every track up. A track of a plane the port has not
ported is empty of events but for its name, as the reference's is on a
journal without those kinds. Fetching workers' traces and merging them,
and the per-host daemon, are not ported (ROADMAP A11c).
"""

from typing import List, Optional

# pids for the synthetic tracks — far above any worker rank
_JOB_PHASES_PID = 9999
_SKEW_TRACK_PID = 9998
_BRAIN_TRACK_PID = 9997
_SERVING_TRACK_PID = 9996
_INCIDENTS_PID = 9995
_DEVICE_PLANE_PID = 9994

# chrome-trace palette names per goodput phase, so an incident's
# waterfall reads at a glance (green = productive, red = waiting on
# detection, shades in between for the recovery legs)
_PHASE_CNAME = {
    "productive": "good",
    "detect": "terrible",
    "rendezvous": "yellow",
    "restore": "olive",
    "recompile": "grey",
    "reshard": "rail_animation",
    "serving": "good",
}


def job_phase_events(journal: dict) -> List[dict]:
    """Chrome-trace events for the journal's goodput attribution: one
    top-level track of complete ("X") slices — productive / detect /
    rendezvous / restore / recompile — plus an instant per raw journal
    event. Timestamps are journal-relative microseconds, matching the
    job-relative monotonic clock the master stamps."""
    from dlrover_tpu_torch.observability.journal import phase_segments

    raw = journal.get("events", [])
    now_t = float(journal.get("now_t", 0.0))
    events: List[dict] = [
        {
            "ph": "M", "pid": _JOB_PHASES_PID, "name": "process_name",
            "args": {"name": "job phases"},
        },
        {
            "ph": "M", "pid": _JOB_PHASES_PID, "tid": 0,
            "name": "thread_name", "args": {"name": "goodput attribution"},
        },
    ]
    for phase, begin, end in phase_segments(raw, now_t):
        events.append({
            "ph": "X", "pid": _JOB_PHASES_PID, "tid": 0,
            "name": phase, "cat": "job_phase",
            "ts": begin * 1e6, "dur": (end - begin) * 1e6,
        })
    for e in raw:
        events.append({
            "ph": "i", "pid": _JOB_PHASES_PID, "tid": 0, "s": "p",
            "name": e.get("kind", "?"), "cat": "journal",
            "ts": float(e.get("t", 0.0)) * 1e6,
            "args": {"source": e.get("source", ""), **e.get("data", {})},
        })
    return events


def skew_track_events(journal: dict) -> List[dict]:
    """Chrome-trace events for the skew monitor's verdicts: a per-rank
    counter ("C") track of the skew ratio at each ``straggler_detected``
    verdict, plus an instant per ``hang_attributed`` verdict — so the
    moment a rank fell behind lines up with its kernel/collective slices
    in the same perfetto load."""
    from dlrover_tpu_torch.observability.journal import JournalEvent

    raw = journal.get("events", [])
    events: List[dict] = [
        {
            "ph": "M", "pid": _SKEW_TRACK_PID, "name": "process_name",
            "args": {"name": "cross-worker skew"},
        },
        {
            "ph": "M", "pid": _SKEW_TRACK_PID, "tid": 0,
            "name": "thread_name", "args": {"name": "skew verdicts"},
        },
    ]
    for e in raw:
        kind = e.get("kind", "")
        data = e.get("data", {}) or {}
        ts_us = float(e.get("t", 0.0)) * 1e6
        if kind == JournalEvent.STRAGGLER_DETECTED:
            events.append({
                "ph": "C", "pid": _SKEW_TRACK_PID, "tid": 0,
                "name": "skew_ratio", "cat": "skew", "ts": ts_us,
                "args": {f"rank{data.get('rank', '?')}":
                         float(data.get("ratio", 0.0))},
            })
            events.append({
                "ph": "i", "pid": _SKEW_TRACK_PID, "tid": 0, "s": "p",
                "name": (f"straggler rank{data.get('rank', '?')} "
                         f"({data.get('cause', '?')})"),
                "cat": "skew", "ts": ts_us, "args": dict(data),
            })
        elif kind == JournalEvent.HANG_ATTRIBUTED:
            events.append({
                "ph": "i", "pid": _SKEW_TRACK_PID, "tid": 0, "s": "p",
                "name": (f"hang in {data.get('collective', '?')} "
                         f"missing={data.get('missing_ranks', [])}"),
                "cat": "skew", "ts": ts_us, "args": dict(data),
            })
    return events


def brain_track_events(journal: dict) -> List[dict]:
    """Chrome-trace events for the brain's predictive loop: an instant
    per prediction/action (``brain_predicted_*``, ``brain_action``), an
    instant per hit/miss verdict (``brain_prediction_scored``), and the
    degraded/recovered outage brackets — so every proactive action lines
    up with the fault/phase tracks that vindicate (or refute) it."""
    from dlrover_tpu_torch.observability.journal import JournalEvent

    _NAMES = {
        JournalEvent.BRAIN_PREDICTED_FAILURE: lambda d:
            f"predict failure node{d.get('node_id', '?')} "
            f"p={d.get('probability', '?')}",
        JournalEvent.BRAIN_PREDICTED_RAMP: lambda d:
            f"predict ramp → {d.get('target', '?')} replicas",
        JournalEvent.BRAIN_PREDICTED_STRAGGLER: lambda d:
            f"predict straggler node{d.get('node_id', '?')}",
        JournalEvent.BRAIN_PREDICTION_SCORED: lambda d:
            f"{d.get('prediction_kind', '?')} #"
            f"{d.get('prediction_id', '?')}: {d.get('outcome', '?')}",
        JournalEvent.BRAIN_ACTION: lambda d:
            f"action {d.get('action', '?')}",
        JournalEvent.BRAIN_DEGRADED: lambda d: "brain degraded",
        JournalEvent.BRAIN_RECOVERED: lambda d: "brain recovered",
    }
    raw = journal.get("events", [])
    events: List[dict] = [
        {
            "ph": "M", "pid": _BRAIN_TRACK_PID, "name": "process_name",
            "args": {"name": "brain predictions"},
        },
        {
            "ph": "M", "pid": _BRAIN_TRACK_PID, "tid": 0,
            "name": "thread_name", "args": {"name": "predictions"},
        },
    ]
    for e in raw:
        kind = e.get("kind", "")
        namer = _NAMES.get(kind)
        if namer is None:
            continue
        data = e.get("data", {}) or {}
        events.append({
            "ph": "i", "pid": _BRAIN_TRACK_PID, "tid": 0, "s": "p",
            "name": namer(data), "cat": "brain",
            "ts": float(e.get("t", 0.0)) * 1e6, "args": dict(data),
        })
    return events


def incident_track_events(journal: dict) -> List[dict]:
    """Chrome-trace events for stitched fault→recovery incidents
    (observability/incidents.py): an "incidents" track with one lane
    (tid) per incident, complete ("X") slices per phase-waterfall segment
    colored by phase, and instants for the rungs that aborted — so each
    recovery's anatomy reads as one left-to-right waterfall under the
    same clock as the job-phases track."""
    from dlrover_tpu_torch.observability.incidents import stitch_journal_dict

    incidents = stitch_journal_dict(journal)
    if not incidents:
        return []
    events: List[dict] = [
        {
            "ph": "M", "pid": _INCIDENTS_PID, "name": "process_name",
            "args": {"name": "incidents"},
        },
    ]
    for lane, inc in enumerate(incidents):
        events.append({
            "ph": "M", "pid": _INCIDENTS_PID, "tid": lane,
            "name": "thread_name",
            "args": {"name": (f"incident {inc.incident_id}: "
                              f"node {inc.node_id} ({inc.resolution})")},
        })
        for seg in inc.waterfall:
            events.append({
                "ph": "X", "pid": _INCIDENTS_PID, "tid": lane,
                "name": seg["phase"], "cat": "incident",
                "cname": _PHASE_CNAME.get(seg["phase"], "grey"),
                "ts": seg["begin"] * 1e6,
                "dur": (seg["end"] - seg["begin"]) * 1e6,
                "args": {
                    "incident_id": inc.incident_id,
                    "mttr_s": inc.mttr_s,
                    "rung": inc.rung,
                    "rollback_steps": inc.rollback_steps,
                    "trace_id": inc.trace_id,
                },
            })
        for failed in inc.rungs_failed:
            events.append({
                "ph": "i", "pid": _INCIDENTS_PID, "tid": lane, "s": "t",
                "name": (f"rung {failed.get('rung', '?')} aborted "
                         f"({failed.get('reason', '?')})"),
                "cat": "incident", "ts": inc.t_fault * 1e6,
                "args": dict(failed),
            })
    return events


def device_track_events(journal: dict) -> List[dict]:
    """Chrome-trace events for the device plane (observability/memory.py
    + compile_watch.py): a headroom-fraction counter ("C") sampled at
    each ``memory_pressure`` verdict, instants for pressure / degraded /
    recompile-storm / brain-prescale-refusal events — so an HBM squeeze
    or a retrace storm lines up with the kernel slices and job phases it
    actually stole time from."""
    from dlrover_tpu_torch.observability.journal import JournalEvent

    raw = journal.get("events", [])
    events: List[dict] = [
        {
            "ph": "M", "pid": _DEVICE_PLANE_PID, "name": "process_name",
            "args": {"name": "device plane"},
        },
        {
            "ph": "M", "pid": _DEVICE_PLANE_PID, "tid": 0,
            "name": "thread_name", "args": {"name": "memory / compile"},
        },
    ]
    for e in raw:
        kind = e.get("kind", "")
        data = e.get("data", {}) or {}
        ts_us = float(e.get("t", 0.0)) * 1e6
        if kind == JournalEvent.MEMORY_PRESSURE:
            events.append({
                "ph": "C", "pid": _DEVICE_PLANE_PID, "tid": 0,
                "name": "headroom_frac", "cat": "memory", "ts": ts_us,
                "args": {"headroom_frac":
                         float(data.get("headroom_frac", 0.0))},
            })
            events.append({
                "ph": "i", "pid": _DEVICE_PLANE_PID, "tid": 0, "s": "p",
                "name": (f"memory pressure ({data.get('category', '?')} "
                         f"headroom={data.get('headroom_frac', '?')})"),
                "cat": "memory", "ts": ts_us, "args": dict(data),
            })
        elif kind == JournalEvent.MEMORY_DEGRADED:
            events.append({
                "ph": "i", "pid": _DEVICE_PLANE_PID, "tid": 0, "s": "p",
                "name": f"memory degraded ({data.get('reason', '?')})",
                "cat": "memory", "ts": ts_us, "args": dict(data),
            })
        elif kind == JournalEvent.RECOMPILE_STORM:
            events.append({
                "ph": "i", "pid": _DEVICE_PLANE_PID, "tid": 0, "s": "p",
                "name": (f"recompile storm {data.get('fn', '?')} "
                         f"dim={data.get('dim', '?')} "
                         f"×{data.get('count', '?')}"),
                "cat": "compile", "ts": ts_us, "args": dict(data),
            })
        elif kind == JournalEvent.BRAIN_PRESCALE_REFUSED:
            events.append({
                "ph": "i", "pid": _DEVICE_PLANE_PID, "tid": 0, "s": "p",
                "name": (f"prescale → {data.get('target', '?')} refused "
                         "(KV would not fit)"),
                "cat": "memory", "ts": ts_us, "args": dict(data),
            })
    return events


def serving_request_events(spans: List, t0: Optional[float] = None,
                           now_t: Optional[float] = None) -> List[dict]:
    """Chrome-trace events for per-request serving waterfalls: a
    "serving requests" track with one lane (tid) per trace_id, so each
    request's queue-wait → prefill-compute → first-step → decode
    decomposition reads as one left-to-right waterfall. ``spans`` are
    tracing.Span objects (finished or live); request-lifecycle spans are
    selected by their ``serve.``-prefixed names. ``t0`` is the raw
    monotonic instant mapping to timeline zero (same contract as
    ``tracing.to_chrome_events``)."""
    import time as _time

    serve_spans = [sp for sp in spans
                   if str(getattr(sp, "name", "")).startswith("serve.")]
    if not serve_spans:
        return []
    if t0 is None:
        t0 = min(sp.start_t for sp in serve_spans)
    if now_t is None:
        now_t = _time.monotonic()
    events: List[dict] = [
        {
            "ph": "M", "pid": _SERVING_TRACK_PID, "name": "process_name",
            "args": {"name": "serving requests"},
        },
    ]
    lanes = {}
    for sp in sorted(serve_spans, key=lambda s: s.start_t):
        lane = lanes.get(sp.trace_id)
        if lane is None:
            lane = lanes[sp.trace_id] = len(lanes)
            rid = sp.attrs.get("request_id", sp.trace_id)
            events.append({
                "ph": "M", "pid": _SERVING_TRACK_PID, "tid": lane,
                "name": "thread_name", "args": {"name": f"request {rid}"},
            })
        end_t = sp.end_t if sp.end_t is not None else max(now_t, sp.start_t)
        events.append({
            "ph": "X", "pid": _SERVING_TRACK_PID, "tid": lane,
            "name": sp.name, "cat": "serve_request",
            "ts": (sp.start_t - t0) * 1e6,
            "dur": (end_t - sp.start_t) * 1e6,
            "args": {
                "trace_id": sp.trace_id, "span_id": sp.span_id,
                "parent_id": sp.parent_id, "status": sp.status,
                **sp.attrs,
            },
        })
        for ev in sp.events:
            events.append({
                "ph": "i", "pid": _SERVING_TRACK_PID, "tid": lane,
                "s": "t", "name": ev["name"], "cat": "serve_request_event",
                "ts": (ev["t"] - t0) * 1e6,
                "args": dict(ev.get("attrs", {}), trace_id=sp.trace_id),
            })
    return events
