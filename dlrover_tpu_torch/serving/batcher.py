"""Continuous-batching scheduler for one decode replica.

The port's copy of ``dlrover_tpu/serving/batcher.py``. A request goes
``queued`` (awaiting prefill) → ``ready`` (prefilled, awaiting a slot) →
``active`` (owns a cache slot, decoded every step) → ``done``. The
invariants:

- **bucket admission**: a prompt is padded to the smallest configured
  bucket that holds it, so prefill shapes come from a fixed set;
- **freed slots are reused within one decode step**: completions are
  processed and freed slots refilled from the ready set before the next
  step (``max_reuse_lag_steps`` measures it; 0 = the invariant holds);
- **prefill overlaps decode**: prefill workers call the engine's pure
  ``prefill_rows`` outside every lock while the decode thread steps; the
  decode thread alone commits rows (``insert``) and steps;
- **drain completes all in flight**: ``drain()`` stops admission and waits
  for queued + ready + active to empty.

Completion is checked only after a step, so a request for one new token
gets two (the reference's behaviour, kept; ROADMAP Queue C, C6).

On the card, every thread binds the engine's device and runs on the
legacy default stream, so a prefill and a decode step of two threads run
one after the other on the device, never at once.

Each request is one trace: ``serve.queue_wait`` opens at ``submit`` under
the caller's context (the replica's ``serve.generate``, itself under the
router's ``serve.route``), then ``serve.prefill_compute``,
``serve.first_step`` and ``serve.decode``; the segments of
:meth:`ServeRequest.segments` are stamped at the same boundaries, and
queue + prefill + first step is the TTFT. The engine reads the first
token back to the host inside its prefill (and every step's tokens
inside its step), so on the card the prefill segment closes after the
device work it timed, not after its launch. Spans are per request, never
per step. A completion goes to ``on_complete`` (the replica's tail
attributor) and the TTFT and TPOT observations carry the trace id as
their exemplar. Not ported: the race-detector registration.
"""

import threading
import time
from typing import Callable, List, Optional, Sequence

import torch

from dlrover_tpu_torch.common.constants import SpanName
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.registry import get_registry


class BatcherClosed(RuntimeError):
    """submit() refused: the batcher is draining or stopped."""


class ServeRequest:
    """One request's lifecycle record and the caller's handle: wait on
    ``done``, then read ``tokens`` / ``error``."""

    def __init__(self, request_id: str, prompt: Sequence[int],
                 max_new_tokens: int, bucket_len: int,
                 rerouted: bool = False):
        self.request_id = request_id
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.bucket_len = bucket_len
        self.rerouted = rerouted
        self.enqueue_t = time.monotonic()
        self.prefill = None
        self.slot = -1
        self.tokens: List[int] = []
        self.t_first = 0.0
        self.t_done = 0.0
        self.error = ""
        self.done = threading.Event()
        # the waterfall: segment stamps, and the segment spans, made
        # un-entered (they end on other threads) and ended at each edge
        self.trace_ctx = None
        self.t_dequeue = 0.0
        self.t_prefill_done = 0.0
        self.prefix_enabled = False
        self.prefix_hit = False
        self.peer_rounds = 0
        self.peer_sum = 0
        self.span_queue = None
        self.span_prefill = None
        self.span_first = None
        self.span_decode = None

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace_ctx.trace_id if self.trace_ctx else None

    def segments(self) -> dict:
        """The TTFT/TPOT decomposition the tail attributor classifies,
        with the interference, re-route and prefix context."""
        rounds = max(0, len(self.tokens) - 1)
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "latency_s": max(0.0, self.t_done - self.enqueue_t),
            "queue_s": max(0.0, self.t_dequeue - self.enqueue_t),
            "prefill_s": max(0.0, self.t_prefill_done - self.t_dequeue),
            "first_step_s": max(0.0, self.t_first - self.t_prefill_done),
            "decode_s": max(0.0, self.t_done - self.t_first),
            "rounds": rounds,
            "mean_peers": (self.peer_sum / self.peer_rounds
                           if self.peer_rounds else 1.0),
            "prefix_enabled": self.prefix_enabled,
            "prefix_hit": self.prefix_hit,
            "rerouted": self.rerouted,
        }


def _bind_device(engine) -> None:
    """Make the engine's CUDA device current on this thread."""
    dev = getattr(engine, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)


class ContinuousBatcher:
    def __init__(self, engine, buckets: Sequence[int] = (8, 16),
                 max_new_cap: int = 64,
                 journal_fn: Optional[Callable] = None,
                 prefill_workers: int = 1, idle_wait_s: float = 0.05,
                 registry=None, on_complete: Optional[Callable] = None,
                 source: str = "batcher",
                 on_step: Optional[Callable[[int], None]] = None):
        self._engine = engine
        if journal_fn is not None and hasattr(engine, "attach_journal"):
            # the prefix cache journals into the request events' stream
            engine.attach_journal(journal_fn)
        # on_complete(req.segments()) after every successful completion
        self._on_complete = on_complete
        self._source = source
        # on_step(steps), under the lock right after each decode step (a
        # port addition: the replica snapshots its kernel launches there)
        self._on_step = on_step
        self._buckets = tuple(sorted(buckets))
        if self._buckets and self._buckets[-1] > engine.cache_len:
            raise ValueError(
                f"largest bucket {self._buckets[-1]} exceeds cache length "
                f"{engine.cache_len}")
        self._max_new_cap = max_new_cap
        self._idle_wait_s = idle_wait_s
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[ServeRequest] = []   # awaiting prefill
        self._ready: List[ServeRequest] = []   # awaiting a slot
        self._slot_map = {}                    # slot -> request
        self._free = list(range(engine.slots))
        self._last_token = [0] * engine.slots
        self._draining = False
        self._stopped = threading.Event()
        self._step_index = 0
        # slot freed while prefilled work waited → its step index
        self._pending_reuse = {}
        self.max_reuse_lag_steps = 0
        self.completed = 0
        self.failed = 0
        reg = registry or get_registry()
        self._m_ttft = reg.histogram(
            "dlrover_serving_ttft_seconds",
            "request enqueue → first token",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30),
        )
        self._m_tpot = reg.histogram(
            "dlrover_serving_tpot_seconds",
            "mean per-output-token latency after the first token",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 1, 5),
        )
        self._m_tokens = reg.counter(
            "dlrover_serving_tokens_total", "generated tokens")
        self._m_requests = reg.counter(
            "dlrover_serving_requests_total",
            "completed requests by outcome", labelnames=("status",))
        reg.gauge(
            "dlrover_serving_queue_depth",
            "requests admitted but not yet decoding",
        ).set_function(lambda: len(self._queue) + len(self._ready))
        reg.gauge(
            "dlrover_serving_active_slots", "cache slots decoding now",
        ).set_function(lambda: len(self._slot_map))
        self._threads = [
            threading.Thread(target=self._decode_loop, name="serve-decode",
                             daemon=True)
        ] + [
            threading.Thread(target=self._prefill_loop,
                             name=f"serve-prefill-{i}", daemon=True)
            for i in range(prefill_workers)
        ]

    @property
    def steps(self) -> int:
        """Decode steps run so far."""
        return self._step_index

    # -- public API --------------------------------------------------------

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def bucket_for(self, prompt_len: int) -> int:
        for b in self._buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds largest bucket "
            f"{self._buckets[-1]}")

    def submit(self, request_id: str, prompt: Sequence[int],
               max_new_tokens: int, rerouted: bool = False) -> ServeRequest:
        bucket = self.bucket_for(len(prompt))
        # the cache holds the bucket and the continuation
        max_new = min(max_new_tokens, self._max_new_cap,
                      self._engine.cache_len - bucket)
        req = ServeRequest(request_id, prompt, max(1, max_new), bucket,
                           rerouted=rerouted)
        # queue-wait opens now, under the submitter's context
        req.span_queue = tracing.span(
            SpanName.SERVE_QUEUE_WAIT, source=self._source,
            request_id=request_id)
        # the waterfall's root: the caller's span, else the queue span
        req.trace_ctx = (tracing.current_context()
                         or getattr(req.span_queue, "context", None))
        with self._lock:
            if self._draining or self._stopped.is_set():
                req.span_queue.end(status="refused")
                raise BatcherClosed("replica is draining")
            self._queue.append(req)
            self._cond.notify_all()
        return req

    def queue_depth(self) -> int:
        return len(self._queue) + len(self._ready)

    def active(self) -> int:
        return len(self._slot_map)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admission and finish every in-flight sequence; True when
        all of them completed in time."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            self._draining = True
            self._cond.notify_all()
            while self._queue or self._ready or self._slot_map:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(0.1, remaining))
        return True

    def stop(self) -> None:
        """Abrupt teardown: fail whatever is still in flight so no waiter
        hangs."""
        self._stopped.set()
        with self._lock:
            self._cond.notify_all()
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=10.0)
        with self._lock:
            leftovers = (self._queue + self._ready
                         + list(self._slot_map.values()))
            self._queue.clear()
            self._ready.clear()
            self._slot_map.clear()
        for req in leftovers:
            req.error = req.error or "replica stopped"
            for sp in (req.span_queue, req.span_prefill, req.span_first,
                       req.span_decode):
                if sp is not None:
                    sp.end(status="aborted")
            req.done.set()

    # -- prefill workers ---------------------------------------------------

    def _prefill_loop(self) -> None:
        _bind_device(self._engine)
        while True:
            with self._lock:
                while not self._queue and not self._stopped.is_set():
                    self._cond.wait(self._idle_wait_s)
                if self._stopped.is_set():
                    return
                req = self._queue.pop(0)
            req.t_dequeue = time.monotonic()
            req.span_queue.end()
            req.span_prefill = tracing.span(
                SpanName.SERVE_PREFILL_COMPUTE, source=self._source,
                parent=req.trace_ctx, request_id=req.request_id)
            # the prefix cache's hit counter moving across this call means
            # this prompt reused a prefix (exact with one prefill worker)
            hits0 = getattr(self._engine, "hits", None)
            req.prefix_enabled = hits0 is not None
            try:
                prefill = self._engine.prefill_rows(req.prompt,
                                                    req.bucket_len)
            except Exception:  # noqa: BLE001 — fail this request, not the
                # worker that serves every later one
                logger.exception("prefill failed for %s", req.request_id)
                req.span_prefill.end(status="error")
                req.error = "prefill failed"
                self.failed += 1
                self._m_requests.labels(status="error").inc()
                req.done.set()
                continue
            if hits0 is not None:
                req.prefix_hit = self._engine.hits > hits0
                req.span_prefill.attrs["prefix_hit"] = req.prefix_hit
            req.t_prefill_done = time.monotonic()
            req.span_prefill.end()
            # first-step: the wait for a slot, the insert, the first token
            req.span_first = tracing.span(
                SpanName.SERVE_FIRST_STEP, source=self._source,
                parent=req.trace_ctx, request_id=req.request_id)
            with self._lock:
                req.prefill = prefill
                self._ready.append(req)
                self._cond.notify_all()

    # -- decode loop -------------------------------------------------------

    def _admissions(self) -> List[ServeRequest]:
        """Pop (under the lock) every ready request a free slot takes."""
        admitted = []
        with self._lock:
            while self._ready and self._free:
                req = self._ready.pop(0)
                req.slot = self._free.pop(0)
                self._slot_map[req.slot] = req
                admitted.append(req)
                lag = self._step_index - self._pending_reuse.pop(
                    req.slot, self._step_index)
                self.max_reuse_lag_steps = max(self.max_reuse_lag_steps, lag)
        return admitted

    def _decode_loop(self) -> None:
        _bind_device(self._engine)
        while not self._stopped.is_set():
            # 1) admit into free slots (insert is decode-thread-only)
            for req in self._admissions():
                first = self._engine.insert(req.prefill, req.slot)
                req.prefill = None  # the rows live in the cache now
                with self._lock:
                    req.t_first = time.monotonic()
                    req.tokens.append(first)
                    self._last_token[req.slot] = first
                if req.span_first is not None:
                    req.span_first.end()
                req.span_decode = tracing.span(
                    SpanName.SERVE_DECODE, source=self._source,
                    parent=req.trace_ctx, request_id=req.request_id)
                self._m_ttft.observe(req.t_first - req.enqueue_t,
                                     exemplar=req.trace_id)
                self._m_tokens.inc()
            with self._lock:
                active = [s in self._slot_map
                          for s in range(self._engine.slots)]
                tokens = list(self._last_token)
                idle = not self._slot_map
                if idle:
                    self._cond.wait(self._idle_wait_s)
            if idle:
                continue
            # 2) one decode step for every active slot, outside the lock
            nxt = self._engine.step(tokens, active)
            finished: List[ServeRequest] = []
            with self._lock:
                self._step_index += 1
                if self._on_step is not None:
                    self._on_step(self._step_index)
                co_active = len(self._slot_map)
                for slot, req in list(self._slot_map.items()):
                    tok = nxt[slot]
                    req.tokens.append(tok)
                    self._last_token[slot] = tok
                    # how crowded this request's decode rounds were
                    req.peer_rounds += 1
                    req.peer_sum += co_active
                    if len(req.tokens) >= req.max_new_tokens:
                        del self._slot_map[slot]
                        self._free.append(slot)
                        if self._ready:
                            # prefilled work waits: refill before the next
                            # step (the reuse-lag invariant)
                            self._pending_reuse[slot] = self._step_index
                        finished.append(req)
                self._cond.notify_all()
            for req in finished:
                req.t_done = time.monotonic()
                self.completed += 1
                self._m_tokens.inc(len(req.tokens) - 1)
                self._m_requests.labels(status="ok").inc()
                if len(req.tokens) > 1:
                    self._m_tpot.observe(
                        (req.t_done - req.t_first) / (len(req.tokens) - 1),
                        exemplar=req.trace_id)
                if req.span_decode is not None:
                    req.span_decode.attrs.update(
                        rounds=len(req.tokens) - 1,
                        mean_peers=round(req.peer_sum
                                         / max(1, req.peer_rounds), 2))
                    req.span_decode.end()
                if self._on_complete is not None:
                    try:
                        self._on_complete(req.segments())
                    except Exception:  # noqa: BLE001 — attribution is
                        # telemetry: it must never wedge the decode loop
                        logger.warning("on_complete hook failed for %s",
                                       req.request_id, exc_info=True)
                req.done.set()
