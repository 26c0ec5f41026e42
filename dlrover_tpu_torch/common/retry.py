"""Retry budgets and a circuit breaker for the HTTP RPC client.

The port's trim of ``dlrover_tpu/common/retry.py`` to what
``common/http_server.py``'s :class:`HttpRPCClient` needs: a
:class:`RetryPolicy` (``DEFAULT`` rides out a master restart, ``PROBE``
tries once and ignores the breaker; ``from_retries`` maps the older
``retries=N`` argument onto them), :func:`retry_call`, which runs one call
under a policy and puts each failed attempt on the caller's trace as a
``rpc.retry`` span event, and a per-client :class:`CircuitBreaker`: after
``threshold`` consecutive exhausted calls it opens, and calls that respect
it fail fast with :class:`CircuitOpenError` (a ``ConnectionError``) until
a half-open trial a cooldown later succeeds.
"""

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from dlrover_tpu_torch.common.constants import SpanName
from dlrover_tpu_torch.common.log import logger

_tracing = None


def _trace_event(name: str, **attrs) -> None:
    """Attach a span event to the caller's active trace span (lazy import
    keeps this module import-light; no-op when tracing is off or no span
    is open)."""
    global _tracing
    if _tracing is None:
        from dlrover_tpu_torch.observability import tracing as _t

        _tracing = _t
    _tracing.add_span_event(name, **attrs)


class CircuitOpenError(ConnectionError):
    """Failing fast: the peer has been unreachable for enough consecutive
    calls that retrying immediately is pointless."""


class CircuitBreaker:
    """Counts consecutive whole-call failures; thread-safe."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0):
        self._threshold = threshold
        self._cooldown_s = cooldown_s
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._lock = threading.Lock()

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._opened_at is not None

    def allow(self) -> bool:
        """True if a call may proceed. While open, one half-open trial is
        granted per cooldown period."""
        with self._lock:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at >= self._cooldown_s:
                # grant this trial; push the next one a full cooldown out
                self._opened_at = time.monotonic()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._failures >= self._threshold and self._opened_at is None:
                self._opened_at = time.monotonic()
                logger.warning(
                    "circuit breaker OPEN after %d consecutive failed calls "
                    "(cooldown %.1fs)", self._failures, self._cooldown_s,
                )


@dataclass(frozen=True)
class RetryPolicy:
    """Budget for one call class. ``deadline_s`` bounds the whole call
    (attempts + sleeps); ``respect_breaker=False`` means the call must try
    even when the client's breaker is open (rendezvous, probes)."""

    max_attempts: int = 30
    base_backoff_s: float = 0.1
    multiplier: float = 1.6
    max_backoff_s: float = 5.0
    jitter: float = 0.2
    deadline_s: Optional[float] = None
    respect_breaker: bool = True

    def backoff_s(self, attempt: int) -> float:
        b = min(self.base_backoff_s * self.multiplier ** attempt,
                self.max_backoff_s)
        if self.jitter:
            b *= 1.0 + random.uniform(-self.jitter, self.jitter)
        return max(0.0, b)

    @classmethod
    def from_retries(cls, retries: int) -> "RetryPolicy":
        """Legacy ``retries=N`` shape (pre-policy RPCClient semantics)."""
        if retries <= 1:
            return PROBE
        return RetryPolicy(max_attempts=retries)


DEFAULT = RetryPolicy()
PROBE = RetryPolicy(max_attempts=1, respect_breaker=False)

def jittered(seconds: float, jitter: float = 0.2) -> float:
    """``seconds`` spread by ±``jitter`` — used wherever many clients act
    on the same trigger (master backoff hints, reconnect stampedes) so
    their next attempts don't land in one synchronized burst."""
    if seconds <= 0.0:
        return 0.0
    return max(0.0, seconds * (1.0 + random.uniform(-jitter, jitter)))


RetryPolicy.DEFAULT = DEFAULT  # type: ignore[attr-defined]
RetryPolicy.PROBE = PROBE  # type: ignore[attr-defined]


def retry_call(
    fn: Callable[[], "object"],
    policy: RetryPolicy,
    breaker: Optional[CircuitBreaker] = None,
    retry_on: Tuple[Type[BaseException], ...] = (ConnectionError, OSError),
    describe: str = "call",
):
    """Run ``fn`` under ``policy``. The breaker is consulted once up front
    (fail fast while open) and fed one verdict per whole call, so a patient
    policy's in-flight retries are never aborted mid-ladder."""
    if (breaker is not None and policy.respect_breaker
            and not breaker.allow()):
        raise CircuitOpenError(f"{describe}: circuit open, failing fast")
    deadline = (time.monotonic() + policy.deadline_s
                if policy.deadline_s is not None else None)
    last: Optional[BaseException] = None
    attempts = 0
    for attempt in range(policy.max_attempts):
        attempts = attempt + 1
        try:
            result = fn()
        except retry_on as e:
            last = e
            # visible in the causal trace: each failed attempt becomes a
            # span event on whatever arc this call serves
            _trace_event(SpanName.EVT_RPC_RETRY, describe=describe,
                         attempt=attempts, error=repr(e))
            if attempts >= policy.max_attempts:
                break
            delay = policy.backoff_s(attempt)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                delay = min(delay, remaining)
            time.sleep(delay)
        else:
            if breaker is not None:
                breaker.record_success()
            return result
    if breaker is not None:
        breaker.record_failure()
        if breaker.is_open:
            _trace_event(SpanName.EVT_BREAKER_OPEN, describe=describe)
    raise ConnectionError(
        f"{describe} failed after {attempts} attempts: {last!r}"
    )
