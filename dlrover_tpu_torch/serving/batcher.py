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

Not ported yet: tracing spans, the journal, the tail-attribution hook
(with the per-request segments and reroute and prefix-hit marks it reads)
and the race-detector registration.
"""

import threading
import time
from typing import Callable, List, Optional, Sequence

import torch

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.registry import get_registry


class BatcherClosed(RuntimeError):
    """submit() refused: the batcher is draining or stopped."""


class ServeRequest:
    """One request's lifecycle record and the caller's handle: wait on
    ``done``, then read ``tokens`` / ``error``."""

    def __init__(self, request_id: str, prompt: Sequence[int],
                 max_new_tokens: int, bucket_len: int):
        self.request_id = request_id
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.bucket_len = bucket_len
        self.enqueue_t = time.monotonic()
        self.prefill = None
        self.slot = -1
        self.tokens: List[int] = []
        self.t_first = 0.0
        self.t_done = 0.0
        self.error = ""
        self.done = threading.Event()


def _bind_device(engine) -> None:
    """Make the engine's CUDA device current on this thread."""
    dev = getattr(engine, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)


class ContinuousBatcher:
    def __init__(self, engine, buckets: Sequence[int] = (8, 16),
                 max_new_cap: int = 64, prefill_workers: int = 1,
                 idle_wait_s: float = 0.05, registry=None,
                 on_step: Optional[Callable[[int], None]] = None):
        self._engine = engine
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
               max_new_tokens: int) -> ServeRequest:
        bucket = self.bucket_for(len(prompt))
        # the cache holds the bucket and the continuation
        max_new = min(max_new_tokens, self._max_new_cap,
                      self._engine.cache_len - bucket)
        req = ServeRequest(request_id, prompt, max(1, max_new), bucket)
        with self._lock:
            if self._draining or self._stopped.is_set():
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
            try:
                prefill = self._engine.prefill_rows(req.prompt,
                                                    req.bucket_len)
            except Exception:  # noqa: BLE001 — fail this request, not the
                # worker that serves every later one
                logger.exception("prefill failed for %s", req.request_id)
                req.error = "prefill failed"
                self.failed += 1
                self._m_requests.labels(status="error").inc()
                req.done.set()
                continue
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
                self._m_ttft.observe(req.t_first - req.enqueue_t)
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
                for slot, req in list(self._slot_map.items()):
                    tok = nxt[slot]
                    req.tokens.append(tok)
                    self._last_token[slot] = tok
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
                        (req.t_done - req.t_first) / (len(req.tokens) - 1))
                req.done.set()
