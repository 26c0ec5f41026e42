"""Causal tracing across RPC, thread and checkpoint boundaries.

The port's copy of ``dlrover_tpu/observability/tracing.py``. One trace is
one causal arc across processes (a rendezvous round, a checkpoint save, a
detect → relaunch cycle, one served request). Every span carries
``trace_id`` (shared by the arc), ``span_id`` and ``parent_id``. The
current context is thread-local; a boundary is crossed by putting the
context into the envelope that already crosses it:

- RPC: the client puts ``inject_wire()`` under the frame key
  :data:`WIRE_KEY` (``"tc"``, payload ``{"t": trace_id, "s": span_id}``)
  and the server activates it around the handler, on the binary and the
  HTTP transport alike; a JAX peer's frames carry the same key;
- master → agent: a diagnosis action carries the context in its data;
- worker → saver: the checkpoint SAVE event dict carries it over the
  agent's SharedQueue;
- threads: capture ``current_context()`` and ``activate()`` it there.

Timestamps are ``time.monotonic()`` (a span is a duration); the wall time
is stamped once a span, for reports. Finished spans land in a bounded
ring (``DLROVER_TPU_TRACE_RING``, 2048), which the flight recorder turns
into a chrome-trace track. ``DLROVER_TPU_TRACE=0`` makes ``span()``
return a shared no-op span and ``inject_wire()`` None after one cached
check. Tracing is on by default.
"""

import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import ConfigKey, env_flag, env_int

# request-envelope key carrying {"t": trace_id, "s": span_id}. Short on
# purpose: it rides every RPC frame when a context is active.
WIRE_KEY = "tc"

DEFAULT_RING_SPANS = 2048

_tls = threading.local()


class TraceContext(Tuple[str, str]):
    """(trace_id, span_id) — the part of a span that crosses boundaries."""

    __slots__ = ()

    def __new__(cls, trace_id: str, span_id: str) -> "TraceContext":
        return tuple.__new__(cls, (trace_id, span_id))

    @property
    def trace_id(self) -> str:
        return self[0]

    @property
    def span_id(self) -> str:
        return self[1]


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed operation. Used as a context manager: entering makes it
    the thread's current context, exiting ends it and restores the
    previous context. For work that finishes on another thread, don't
    carry the Span across — carry ``current_context()`` and ``activate()``
    it there, then open child spans."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "source", "start_t",
        "end_t", "start_wall_ts", "status", "attrs", "events", "_tracer",
        "_prev_ctx",
    )

    def __init__(self, tracer: "Tracer", name: str, source: str,
                 trace_id: str, parent_id: Optional[str],
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.source = source
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start_t = time.monotonic()
        self.end_t: Optional[float] = None
        self.start_wall_ts = time.time()  # reported, never compared
        self.status = "ok"
        self.attrs = dict(attrs)
        self.events: List[Dict[str, Any]] = []
        self._prev_ctx: Optional[TraceContext] = None

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def add_event(self, name: str, **attrs: Any) -> None:
        """Attach a point-in-time annotation (retry attempt, breaker
        verdict, injected fault) to this span."""
        self.events.append(
            {"name": str(name), "t": time.monotonic(), "attrs": attrs}
        )

    def end(self, status: Optional[str] = None) -> None:
        if self.end_t is not None:
            return
        if status is not None:
            self.status = status
        self.end_t = time.monotonic()
        self._tracer._finish(self)

    def __enter__(self) -> "Span":
        self._prev_ctx = current_context()
        _tls.ctx = self.context
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", repr(exc))
        _tls.ctx = self._prev_ctx
        self.end()
        return False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "source": self.source,
            "start_t": self.start_t,
            "end_t": self.end_t,
            "start_wall_ts": self.start_wall_ts,
            "status": self.status,
            "attrs": dict(self.attrs),
            "events": [dict(e) for e in self.events],
        }


class _NoopSpan:
    """Shared do-nothing stand-in returned when tracing is disabled."""

    __slots__ = ()
    trace_id = span_id = parent_id = context = None
    name = source = ""

    @property
    def attrs(self) -> Dict[str, Any]:
        return {}

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def add_event(self, name: str, **attrs: Any) -> None:
        pass

    def end(self, status: Optional[str] = None) -> None:
        pass


_NOOP = _NoopSpan()


class Tracer:
    """Bounded in-memory span store. One per process (``get_tracer()``);
    the enabled flag and ring size are read from env once at creation so
    the disabled check stays a plain attribute load."""

    def __init__(self, enabled: Optional[bool] = None,
                 ring_size: Optional[int] = None):
        self.enabled = (env_flag(ConfigKey.TRACE, True)
                        if enabled is None else bool(enabled))
        if ring_size is None:
            ring_size = env_int(ConfigKey.TRACE_RING, DEFAULT_RING_SPANS)
        self._ring: "deque[Span]" = deque(maxlen=max(1, ring_size))
        self._lock = threading.Lock()
        self._live: Dict[str, Span] = {}
        self._started = 0
        self._finished = 0

    def span(self, name: str, source: str = "",
             parent: Optional[TraceContext] = None, **attrs: Any):
        """Open a span under ``parent`` (default: the thread's current
        context; a fresh trace when there is none)."""
        if not self.enabled:
            return _NOOP
        if parent is None:
            parent = current_context()
        if parent is not None:
            trace_id, parent_id = parent[0], parent[1]
        else:
            trace_id, parent_id = _new_id(), None
        sp = Span(self, name, source, trace_id, parent_id, attrs)
        with self._lock:
            self._started += 1
            self._live[sp.span_id] = sp
        return sp

    def _finish(self, span: Span) -> None:
        with self._lock:
            self._live.pop(span.span_id, None)
            self._finished += 1
            self._ring.append(span)

    # -- introspection (flight recorder / tests) ------------------------

    def finished_spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def live_spans(self) -> List[Span]:
        with self._lock:
            return list(self._live.values())

    def spans_for_trace(self, trace_id: str) -> List[Span]:
        """Every span (finished or live) still retained for one trace,
        start-ordered — the request waterfall the TailAttributor and the
        flight recorder's worst-request dump read."""
        with self._lock:
            out = [sp for sp in self._ring if sp.trace_id == trace_id]
            out.extend(sp for sp in self._live.values()
                       if sp.trace_id == trace_id)
        return sorted(out, key=lambda sp: sp.start_t)

    def dropped(self) -> int:
        """Finished spans evicted from the ring by overflow."""
        with self._lock:
            return self._finished - len(self._ring)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {
                "started": self._started,
                "finished": self._finished,
                "live": len(self._live),
                "ring": len(self._ring),
                "dropped": self._finished - len(self._ring),
            }


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _tracer
    tr = _tracer
    if tr is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
            tr = _tracer
    return tr


def reset_tracer() -> None:
    """Drop the process tracer and this thread's context (tests; the next
    ``get_tracer()`` re-reads DLROVER_TPU_TRACE/DLROVER_TPU_TRACE_RING)."""
    global _tracer
    with _tracer_lock:
        _tracer = None
    _tls.ctx = None


def enabled() -> bool:
    return get_tracer().enabled


# -- thread-local context ---------------------------------------------------


def current_context() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


@contextmanager
def activate(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Make ``ctx`` current for the block (server-side restore, thread
    handoff). ``None`` is allowed and clears the context — callers don't
    need to branch on whether the wire carried one."""
    prev = current_context()
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def span(name: str, source: str = "",
         parent: Optional[TraceContext] = None, **attrs: Any):
    """Module-level convenience for ``get_tracer().span(...)``."""
    return get_tracer().span(name, source=source, parent=parent, **attrs)


def add_span_event(name: str, **attrs: Any) -> None:
    """Attach an event to the thread's current *live* span, if any.
    Cheap no-op when tracing is off or no span is open — safe to call
    from hot retry paths."""
    tr = get_tracer()
    if not tr.enabled:
        return
    ctx = current_context()
    if ctx is None:
        return
    with tr._lock:
        sp = tr._live.get(ctx.span_id)
    if sp is not None:
        sp.add_event(name, **attrs)


# -- wire propagation -------------------------------------------------------


def inject_wire() -> Optional[Dict[str, str]]:
    """The envelope payload for the active context, or ``None`` when
    tracing is off / no context is active (the caller then omits the
    key entirely — old peers never see it)."""
    tr = _tracer
    if tr is None:
        tr = get_tracer()
    if not tr.enabled:
        return None
    ctx = current_context()
    if ctx is None:
        return None
    return {"t": ctx.trace_id, "s": ctx.span_id}


def extract_wire(payload: Any) -> Optional[TraceContext]:
    """Parse a peer's envelope payload; tolerant of missing/garbage input
    (old clients, hand-rolled frames)."""
    if not isinstance(payload, dict):
        return None
    trace_id = payload.get("t")
    if not trace_id:
        return None
    return TraceContext(str(trace_id), str(payload.get("s", "")))


# -- chrome-trace export ----------------------------------------------------

# synthetic pid for the trace track — below timeline.py's job-phases
# (9999) and skew (9998) tracks in the same perfetto load
TRACE_TRACK_PID = 9997


def to_chrome_events(spans: List[Span], t0: Optional[float] = None,
                     pid: int = TRACE_TRACK_PID,
                     now_t: Optional[float] = None) -> List[dict]:
    """Chrome-trace events for ``spans``: one complete ("X") slice per
    finished span, one "B" (begin, still open) per live span clamped at
    ``now_t``, and an instant per span event. ``t0`` is the raw-monotonic
    instant that maps to timeline zero — pass
    ``time.monotonic() - journal.now()`` to line the track up with the
    journal tracks; defaults to the earliest span start."""
    if not spans:
        return []
    if t0 is None:
        t0 = min(sp.start_t for sp in spans)
    if now_t is None:
        now_t = time.monotonic()
    out: List[dict] = [
        {
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": "control-plane traces"},
        },
    ]
    tids: Dict[str, int] = {}
    for sp in spans:
        source = sp.source or "untagged"
        if source not in tids:
            tids[source] = len(tids)
            out.append({
                "ph": "M", "pid": pid, "tid": tids[source],
                "name": "thread_name", "args": {"name": source},
            })
        tid = tids[source]
        args = {
            "trace_id": sp.trace_id,
            "span_id": sp.span_id,
            "parent_id": sp.parent_id,
            "status": sp.status,
            **sp.attrs,
        }
        end_t = sp.end_t if sp.end_t is not None else max(now_t, sp.start_t)
        out.append({
            "ph": "X", "pid": pid, "tid": tid,
            "name": sp.name, "cat": "span",
            "ts": (sp.start_t - t0) * 1e6,
            "dur": (end_t - sp.start_t) * 1e6,
            "args": args if sp.end_t is not None
            else dict(args, incomplete=True),
        })
        for ev in sp.events:
            out.append({
                "ph": "i", "pid": pid, "tid": tid, "s": "t",
                "name": ev["name"], "cat": "span_event",
                "ts": (ev["t"] - t0) * 1e6,
                "args": dict(ev.get("attrs", {}),
                             trace_id=sp.trace_id, span_id=sp.span_id),
            })
    return out
