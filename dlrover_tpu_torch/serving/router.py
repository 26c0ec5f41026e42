"""Request router: load-balances generate requests over live replicas.

The port's copy of ``dlrover_tpu/serving/router.py``. The membership comes
from a caller's ``replicas_fn`` (the master registry's ``live`` in
process, or ``MasterClient.serve_replicas`` across hosts). What the
router owns is the retry contract: generation is greedy over
replica-identical weights, so a request is idempotent, and a replica's
death mid-request is absorbed by sending the same request (same
``request_id``) to another replica. A lost request is a bug.

Per attempt:

- transport error, an injected fault (site ``serve.request``) or replica
  death mid-call → journal ``serve_request_failed`` and re-route
  (``serve_rerouted``) to a replica not yet tried;
- a ``draining`` or ``timeout`` refusal → re-route (the replica is
  healthy, just closed);
- a deterministic refusal (prompt too long) → fail at once;
- no live replica → wait out the membership gap until the deadline,
  consuming no attempt.

The autoscaler reads its signals here (``inflight``, ``ttft_p99``,
``tokens_per_s``), and the SLO plane reads the router's TTFT histogram
(the reference's name and buckets), each observation carrying the
replica's ``trace_id`` as its exemplar. Each request is one
``serve.route`` span, the root of its trace: its context rides the
``serve_generate`` frame, an injected fault and each re-route are span
events on it. Not ported yet: the router's own RPC surface
(``rpc_serve_submit``) and its ``drain``.
"""

import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import ChaosSite, SpanName
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import RPCClient
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.journal import JournalEvent
from dlrover_tpu_torch.observability.registry import get_registry

SERVE_REQUEST_SITE = ChaosSite.SERVE_REQUEST

# deterministic refusals: no other replica can answer them differently
_PERMANENT = ("exceeds largest bucket",)
# the window of ``tokens_per_s``
TOKENS_WINDOW_S = 30.0


class RequestRouter:
    def __init__(self, replicas_fn: Callable[[], List[Dict]],
                 journal_fn: Optional[Callable] = None,
                 max_attempts: int = 4, request_timeout_s: float = 60.0,
                 no_replica_wait_s: float = 0.1, registry=None):
        self._replicas_fn = replicas_fn
        self._journal_fn = journal_fn
        self._max_attempts = max_attempts
        self._request_timeout_s = request_timeout_s
        self._no_replica_wait_s = no_replica_wait_s
        self._lock = threading.Lock()
        self._inflight: Dict[int, int] = {}  # node_id -> attempts in flight
        self._clients: Dict[str, RPCClient] = {}
        self._ttft_samples: List[float] = []
        self._token_marks: List[tuple] = []  # (t_done, n_tokens)
        self._pacer = threading.Event()  # pacing only, never set
        self.completed = 0
        self.lost = 0
        self.rerouted = 0
        reg = registry or get_registry()
        self._m_requests = reg.counter(
            "dlrover_serving_router_requests_total",
            "routed requests by outcome", labelnames=("status",))
        self._m_rerouted = reg.counter(
            "dlrover_serving_rerouted_total",
            "requests re-routed after a replica failure")
        self._m_ttft = reg.histogram(
            "dlrover_serving_ttft_seconds",
            "request enqueue → first token",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30),
        )
        reg.gauge(
            "dlrover_serving_router_inflight", "requests in flight",
        ).set_function(lambda: float(sum(self._inflight.values())))

    def _record(self, kind: str, **data) -> None:
        if self._journal_fn is not None:
            self._journal_fn(kind, **data)

    def _client_for(self, addr: str) -> RPCClient:
        with self._lock:
            client = self._clients.get(addr)
            if client is None:
                # no transport retries: the router owns failover
                client = RPCClient(addr, timeout_s=self._request_timeout_s,
                                   retries=0)
                self._clients[addr] = client
        return client

    def _pick(self, tried: set) -> Optional[Dict]:
        """The least-loaded live replica, preferring ones not yet tried
        for this request."""
        live = self._replicas_fn()
        if not live:
            return None
        with self._lock:
            def load(r):
                return (self._inflight.get(r["node_id"], 0)
                        / max(1, r.get("slots", 1)))

            fresh = [r for r in live if r["node_id"] not in tried]
            return min(fresh or live, key=load)

    def _mark(self, node_id: int, delta: int) -> None:
        with self._lock:
            n = self._inflight.get(node_id, 0) + delta
            if n <= 0:
                self._inflight.pop(node_id, None)
            else:
                self._inflight[node_id] = n

    def _reroute(self, req, request_id, node_id, reason=None) -> None:
        logger.warning("request %s re-routed from replica %s: %s",
                       request_id, node_id, reason or "transport")
        self.rerouted += 1
        self._m_rerouted.inc()
        req.rerouted = True
        tracing.add_span_event(SpanName.EVT_SERVE_REROUTED,
                               from_node=node_id,
                               reason=reason or "transport")
        extra = {} if reason is None else {"reason": reason}
        self._record(JournalEvent.SERVE_REROUTED, request_id=request_id,
                     from_node=node_id, **extra)

    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None
               ) -> comm.ServeGenerateResponse:
        request_id = request_id or uuid.uuid4().hex[:12]
        deadline = time.monotonic() + (deadline_s or self._request_timeout_s)
        req = comm.ServeGenerateRequest(request_id=request_id,
                                        prompt=list(prompt),
                                        max_new_tokens=max_new_tokens)
        tried: set = set()
        attempts = 0
        last_err = "no live replica"
        with tracing.span(SpanName.SERVE_ROUTE, source="router",
                          request_id=request_id):
            while attempts < self._max_attempts:
                if time.monotonic() >= deadline:
                    last_err = f"deadline exceeded ({last_err})"
                    break
                inj = get_injector()
                if inj is not None:
                    try:
                        inj.fire(SERVE_REQUEST_SITE, request_id=request_id,
                                 attempt=attempts)
                    except (ConnectionError, RuntimeError) as e:
                        attempts += 1
                        last_err = f"injected: {e!r}"
                        tracing.add_span_event(
                            SpanName.EVT_FAULT_INJECTED,
                            site=SERVE_REQUEST_SITE, attempt=attempts)
                        self._record(JournalEvent.SERVE_REQUEST_FAILED,
                                     request_id=request_id, node_id=-1,
                                     attempt=attempts, error=repr(e))
                        continue
                target = self._pick(tried)
                if target is None:
                    # a membership gap: wait, consuming no attempt
                    self._pacer.wait(self._no_replica_wait_s)
                    continue
                node_id = target["node_id"]
                attempts += 1
                self._mark(node_id, +1)
                try:
                    resp = self._client_for(target["addr"]).call(
                        "serve_generate", req)
                except (ConnectionError, OSError, RuntimeError) as e:
                    last_err = repr(e)
                    tried.add(node_id)
                    self._record(JournalEvent.SERVE_REQUEST_FAILED,
                                 request_id=request_id, node_id=node_id,
                                 attempt=attempts, error=last_err)
                    self._reroute(req, request_id, node_id)
                    continue
                finally:
                    self._mark(node_id, -1)
                if resp.success:
                    self._done_ok(resp)
                    return resp
                last_err = resp.message
                tried.add(node_id)
                if any(m in resp.message for m in _PERMANENT):
                    break
                self._reroute(req, request_id, node_id, resp.message)
        with self._lock:
            self.lost += 1
        self._m_requests.labels(status="lost").inc()
        self._record(JournalEvent.SERVE_REQUEST_FAILED,
                     request_id=request_id, node_id=-1, attempt=attempts,
                     error=f"exhausted: {last_err}", terminal=True)
        return comm.ServeGenerateResponse(
            request_id=request_id, success=False,
            message=f"exhausted after {attempts} attempts: {last_err}")

    def _done_ok(self, resp: comm.ServeGenerateResponse) -> None:
        now = time.monotonic()
        with self._lock:
            self.completed += 1
            self._ttft_samples.append(resp.ttft_s)
            del self._ttft_samples[:-512]
            self._token_marks.append((now, len(resp.tokens)))
            cutoff = now - TOKENS_WINDOW_S
            while self._token_marks and self._token_marks[0][0] < cutoff:
                self._token_marks.pop(0)
        self._m_requests.labels(status="ok").inc()
        self._m_ttft.observe(resp.ttft_s, exemplar=resp.trace_id or None)

    # -- the autoscaler's signals ------------------------------------------

    def inflight(self) -> int:
        with self._lock:
            return sum(self._inflight.values())

    def ttft_p99(self) -> float:
        """TTFT p99 over the last 512 completions."""
        with self._lock:
            samples = sorted(self._ttft_samples)
        if not samples:
            return 0.0
        return samples[min(len(samples) - 1, int(len(samples) * 0.99))]

    def tokens_per_s(self) -> float:
        """Completed tokens a second over the last ``TOKENS_WINDOW_S``."""
        now = time.monotonic()
        with self._lock:
            marks = [(t, n) for t, n in self._token_marks
                     if t >= now - TOKENS_WINDOW_S]
        if not marks:
            return 0.0
        span = max(1e-3, now - marks[0][0])
        return sum(n for _, n in marks) / span
