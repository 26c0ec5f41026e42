"""The flight recorder: one self-contained post-mortem bundle.

The port's copy of ``dlrover_tpu/observability/flight_recorder.py``. When
something dies (an unhandled exception in the agent, a node the master
fails, an injected chaos fault) or an operator asks (``GET /debug/bundle``
on a master, agent or replica), :meth:`FlightRecorder.capture` writes a
directory that replays the process's last minutes without it::

    <trace_dir>/bundle_<source>_<reason>_<n>_<pid>/
        manifest.json        reason, source, span and event counts, files
        traces.json          chrome trace: the tracing ring (finished and
                             live spans) with the serving-request track
                             and, given a journal, its job-phase, skew,
                             brain, incident and device tracks, one clock
        worst_requests.json  a replica's worst requests with their spans
        journal.json         the event journal (EventJournal.to_json())
        incidents.json       the journal stitched into incidents
        metrics.prom         a /metrics snapshot
        config.json          every ConfigKey/EnvKey knob set in the env
        stacks.txt           a stack dump of every live thread

``<trace_dir>`` is ``DLROVER_TPU_TRACE_DIR`` (default: a directory under
the temp dir). Every capture is journaled as ``trace_bundle_captured``
and counted in ``dlrover_trace_bundles_total{reason}``. Captures are
best-effort and rate-limited per reason
(``DLROVER_TPU_TRACE_BUNDLE_COOLDOWN_S``, 30 s); ``force`` bypasses the
limit (an HTTP request always captures). Not ported: the memory ledger
(``memory.json``, ROADMAP A11b) and the partition-degraded reason.
"""

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    ConfigKey,
    EnvKey,
    env_float,
    env_str,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.incidents import stitch_journal_dict
from dlrover_tpu_torch.observability.journal import JournalEvent
from dlrover_tpu_torch.observability.timeline import (
    brain_track_events,
    device_track_events,
    incident_track_events,
    job_phase_events,
    serving_request_events,
    skew_track_events,
)

# capture reasons (bundle dir names + journal/metric labels)
REASON_HTTP = "http_request"
REASON_CRASH = "unhandled_exception"
REASON_CHAOS = "chaos_fault"
REASON_NODE_FAULT = "node_fault"

DEFAULT_COOLDOWN_S = 30.0


def default_trace_dir() -> str:
    d = env_str(ConfigKey.TRACE_DIR)
    if d:
        return d
    import tempfile

    return os.path.join(tempfile.gettempdir(), "dlrover_tpu_bundles")


def config_fingerprint() -> Dict[str, str]:
    """Every registered knob (ConfigKey + EnvKey) that is currently set —
    enough to reproduce the process's configuration without the process."""
    out: Dict[str, str] = {}
    for registry_cls in (ConfigKey, EnvKey):
        for attr in sorted(vars(registry_cls)):
            if attr.startswith("_"):
                continue
            name = getattr(registry_cls, attr)
            if not isinstance(name, str):
                continue
            value = env_str(name, "")
            if value:
                out[name] = value
    return out


def thread_stacks() -> str:
    """One formatted stack per live thread (named where possible)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks: List[str] = []
    for ident, frame in sorted(sys._current_frames().items()):
        chunks.append(
            f"--- thread {names.get(ident, '?')} (ident={ident}) ---\n"
            + "".join(traceback.format_stack(frame))
        )
    return "\n".join(chunks)


class FlightRecorder:
    """Bundle writer for one process. ``journal`` and ``registry`` are
    optional: the master and a replica pass both, an agent its registry
    only, and every bundle still holds traces, config and stacks. A
    recorder given a registry adds a collect hook to it; :meth:`close`
    takes it off (a stopped owner leaves no hook behind)."""

    def __init__(
        self,
        source: str,
        out_dir: Optional[str] = None,
        journal=None,
        registry=None,
        cooldown_s: Optional[float] = None,
        worst_traces_fn=None,
    ):
        self.source = source
        self.out_dir = out_dir or default_trace_dir()
        self.journal = journal
        self.registry = registry
        # () -> list of worst-request summaries (TailAttributor on a
        # serving replica): bundles then embed the N worst waterfalls
        self.worst_traces_fn = worst_traces_fn
        self.cooldown_s = (
            env_float(ConfigKey.TRACE_BUNDLE_COOLDOWN_S, DEFAULT_COOLDOWN_S)
            if cooldown_s is None else cooldown_s
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._last_capture_t: Dict[str, float] = {}
        # the directories written, oldest first
        self.bundles: List[str] = []
        self._collect = None
        self._bundles_total = None
        if registry is not None:
            self._bundles_total = registry.counter(
                "dlrover_trace_bundles_total",
                "Flight-recorder bundles written, by capture reason",
                ("reason",),
            )
            spans_gauge = registry.gauge(
                "dlrover_trace_ring_spans",
                "Finished spans currently held in the tracing ring",
            )
            dropped_gauge = registry.gauge(
                "dlrover_trace_spans_dropped",
                "Finished spans evicted from the tracing ring by overflow",
            )

            def collect() -> None:
                tr = tracing.get_tracer()
                counts = tr.counts()
                spans_gauge.set(counts["ring"])
                dropped_gauge.set(counts["dropped"])

            registry.add_collect_hook(collect)
            self._collect = collect

    def close(self) -> None:
        """Take this recorder's collect hook off its registry."""
        if self._collect is not None:
            self.registry.remove_collect_hook(self._collect)
            self._collect = None

    # -- capture ---------------------------------------------------------

    def capture(self, reason: str, extra: Optional[Dict[str, Any]] = None,
                force: bool = False) -> Optional[str]:
        """Write one bundle; returns its directory path, or ``None`` when
        rate-limited or the write failed (capture must never become the
        crash). ``force=True`` bypasses the per-reason cooldown (explicit
        HTTP requests always capture)."""
        with self._lock:
            now = time.monotonic()
            last = self._last_capture_t.get(reason)
            if (not force and last is not None
                    and now - last < self.cooldown_s):
                return None
            self._last_capture_t[reason] = now
            self._seq += 1
            seq = self._seq
        try:
            return self._write_bundle(reason, seq, extra or {})
        except Exception as e:  # noqa: BLE001 — never the crash itself
            logger.warning("flight recorder capture(%s) failed: %s",
                           reason, e)
            return None

    def _write_bundle(self, reason: str, seq: int,
                      extra: Dict[str, Any]) -> str:
        bundle_dir = os.path.join(
            self.out_dir,
            f"bundle_{self.source}_{reason}_{seq}_{os.getpid()}",
        )
        os.makedirs(bundle_dir, exist_ok=True)

        tracer = tracing.get_tracer()
        finished = tracer.finished_spans()
        live = tracer.live_spans()
        journal_dict = None
        if self.journal is not None:
            journal_dict = json.loads(self.journal.to_json())

        # one clock for every track: when a journal is present, map raw
        # monotonic span stamps onto its job-relative zero so span slices
        # line up under the "job phases" track in the same perfetto load
        if journal_dict is not None:
            now_t = float(journal_dict.get("now_t", 0.0))
            t0 = time.monotonic() - now_t
        else:
            now_t = None
            t0 = None
        events = tracing.to_chrome_events(finished + live, t0=t0)
        events.extend(serving_request_events(finished + live, t0=t0))
        if journal_dict is not None:
            events.extend(job_phase_events(journal_dict))
            events.extend(skew_track_events(journal_dict))
            events.extend(brain_track_events(journal_dict))
            events.extend(incident_track_events(journal_dict))
            events.extend(device_track_events(journal_dict))
        with open(os.path.join(bundle_dir, "traces.json"), "w") as f:
            json.dump({"traceEvents": events}, f)

        worst = None
        if self.worst_traces_fn is not None:
            try:
                worst = list(self.worst_traces_fn())
            except Exception:  # noqa: BLE001 — optional serving detail,
                # never the reason a crash bundle fails to write
                logger.warning("worst-request dump failed", exc_info=True)
            if worst is not None:
                span_index = {}
                for sp in finished + live:
                    span_index.setdefault(sp.trace_id, []).append(
                        sp.to_dict())
                with open(os.path.join(bundle_dir, "worst_requests.json"),
                          "w") as f:
                    json.dump([
                        dict(rec, spans=span_index.get(
                            rec.get("trace_id"), []))
                        for rec in worst
                    ], f)

        if journal_dict is not None:
            with open(os.path.join(bundle_dir, "journal.json"), "w") as f:
                json.dump(journal_dict, f)
            # the stitched fault→recovery forensics for the same journal
            # tail — the bundle answers "which incident cost what"
            # without re-running the stitcher offline
            incidents = stitch_journal_dict(journal_dict)
            with open(os.path.join(bundle_dir, "incidents.json"),
                      "w") as f:
                json.dump({
                    "now_t": journal_dict.get("now_t", 0.0),
                    "incidents": [inc.to_dict() for inc in incidents],
                }, f)

        if self.registry is not None:
            with open(os.path.join(bundle_dir, "metrics.prom"), "w") as f:
                f.write(self.registry.render())

        with open(os.path.join(bundle_dir, "config.json"), "w") as f:
            json.dump(config_fingerprint(), f, indent=2, sort_keys=True)

        with open(os.path.join(bundle_dir, "stacks.txt"), "w") as f:
            f.write(thread_stacks())

        manifest = {
            "reason": reason,
            "source": self.source,
            "seq": seq,
            "pid": os.getpid(),
            "wall_ts": time.time(),  # reported, never compared
            "spans_finished": len(finished),
            "spans_live": len(live),
            "spans_dropped": tracer.dropped(),
            "journal_events": (len(journal_dict.get("events", []))
                               if journal_dict is not None else 0),
            "files": sorted(os.listdir(bundle_dir)) + ["manifest.json"],
            **extra,
        }
        with open(os.path.join(bundle_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)

        if self._bundles_total is not None:
            self._bundles_total.labels(reason=reason).inc()
        if self.journal is not None:
            self.journal.record(
                JournalEvent.TRACE_BUNDLE_CAPTURED,
                source=self.source,
                reason=reason,
                path=bundle_dir,
                spans=len(finished) + len(live),
            )
        with self._lock:
            self.bundles.append(bundle_dir)
        logger.info("flight recorder: %s bundle -> %s", reason, bundle_dir)
        return bundle_dir

    # -- triggers --------------------------------------------------------

    def http_handler(self):
        """``GET /debug/bundle`` handler for common/http_server.py's
        ``add_get_route``: captures a bundle and returns its path."""

        def handle():
            path = self.capture(REASON_HTTP, force=True)
            body = json.dumps({
                "ok": path is not None,
                "path": path,
                "files": sorted(os.listdir(path)) if path else [],
            })
            return "application/json", body

        return handle

    def wrap_fault_reporter(self, inner=None):
        """Compose with the chaos plane's single ``set_reporter`` slot:
        the returned callable journals through ``inner`` (the existing
        reporter, if any) and then captures a rate-limited bundle, so an
        injected fault leaves an artifact even when recovery succeeds."""

        def report(event: Dict[str, Any]) -> None:
            if inner is not None:
                inner(event)
            self.capture(REASON_CHAOS, extra={
                "fault_site": event.get("site", ""),
                "fault_kind": event.get("fault", ""),
            })

        return report
