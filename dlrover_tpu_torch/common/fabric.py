"""Striped multi-source bulk transfers: the state-movement fabric.

The port's trim of ``dlrover_tpu/common/fabric.py`` to what a serving
replica's weight warm-start uses. A transfer is a content-addressed
session: a describe phase agrees on ``(step, total_bytes, content_crc)``
across the candidate sources, the payload is split into fixed-size
stripes, each fetched with its own CRC, and worker threads pull distinct
stripes from every source at once. A stripe that fails (transport error
after the retry budget, a CRC or length mismatch, an object that went
away) fails its source; the source's missing stripes are re-queued onto
the survivors and the session completes without restarting. A saturated
source answers ``busy`` (its cap on concurrent fetches): the fetcher
backs off and re-queues, it does not fail the source. With no source
left the session raises :class:`FabricAbort` with a short reason.

Serving side, :class:`FabricServer` mounts ``fabric_describe`` and
``fabric_fetch`` on an :class:`RPCServer` and routes keys ``<prefix>/<rest>``
to registered providers, each answering ``(step, total_bytes, etag,
read_fn)`` with ``read_fn(offset, nbytes)`` a ranged read. Method names
and messages are the reference's, so the JAX package's fetcher pulls from
a port server and the port's fetcher from a JAX one.

Chaos sites: ``fabric.connect`` fires before each source's describe (an
injected fault makes the source unreachable for this session) and
``fabric.stripe`` before each stripe fetch (an error fails the source;
``torn``/``bitflip`` corrupt the received stripe, which its CRC must
catch).

A session is one ``fabric.fetch`` span (with ``described`` and
``complete`` events); ``fetch``'s ``reporter(kind, data)`` takes its
journal events (``fabric_source_failed``, ``fabric_stripe_retried``,
``fabric_session_complete`` / ``_aborted``), and the process registry
counts ``dlrover_fabric_bytes_total{source}``,
``dlrover_fabric_stripe_retries_total``,
``dlrover_fabric_sessions_total{outcome}`` and
``dlrover_fabric_session_seconds``, the reference's families. A fetch's
assembly buffer is a ``staging`` claim in the memory ledger
(``observability/memory.py``) from the session's start until ``run``
hands the payload off. Not ported yet: topology-ranked sources and
per-source key aliases.
"""

import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.chaos import InjectedError, get_injector
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    ChaosSite,
    ConfigKey,
    MetricLabel,
    SpanName,
    env_int,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import RPCClient, RPCError, RPCServer
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.journal import JournalEvent
from dlrover_tpu_torch.observability.memory import get_accountant
from dlrover_tpu_torch.observability.registry import get_registry

FABRIC_CONNECT_SITE = ChaosSite.FABRIC_CONNECT
FABRIC_STRIPE_SITE = ChaosSite.FABRIC_STRIPE

DEFAULT_STRIPE_BYTES = 16 * 1024 * 1024
DEFAULT_CONNS = 4
DEFAULT_ADMIT = 4
# back-off after a busy reply; it rides the session's abort event, so a
# finishing session wakes the fetcher at once
BUSY_BACKOFF_S = 0.05
# transport attempts of one stripe before its source is failed
_STRIPE_RETRIES = 3

_PEER_ERRORS = (ConnectionError, OSError, RPCError)


class FabricAbort(RuntimeError):
    """The session cannot complete. ``reason``: ``no_sources`` (nobody
    serves the object), ``sources_lost`` (every source died mid-transfer),
    ``fault_injected`` (as either, when every failure was an injected
    fault), ``content_mismatch`` (the assembled bytes fail the content
    address) or ``timeout``."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


@dataclass(frozen=True)
class FabricSource:
    """One candidate peer of a session. ``key``, when set, is what this
    source serves the session's object under (a reshard alternate holds
    the same bytes at another shard index; the content CRC proves it)."""

    addr: str
    rank: int = -1
    key: str = ""


def plan_stripes(total_bytes: int,
                 stripe_bytes: int) -> List[Tuple[int, int]]:
    """``total_bytes`` as ``(offset, length)`` stripes: an exact cover, no
    overlap, the last stripe short."""
    if total_bytes < 0:
        raise ValueError(f"negative transfer size {total_bytes}")
    if stripe_bytes <= 0:
        raise ValueError(f"non-positive stripe size {stripe_bytes}")
    return [(off, min(stripe_bytes, total_bytes - off))
            for off in range(0, total_bytes, stripe_bytes)]


# provider(rest_of_key) -> (step, total_bytes, etag, read_fn) or None;
# read_fn(offset, nbytes) -> bytes-like or None
Provider = Callable[
    [str], Optional[Tuple[int, int, int, Callable[[int, int], Any]]]
]


class FabricServer:
    """Serves ``fabric_describe`` / ``fabric_fetch`` for registered
    providers on ``server``. Concurrent fetches are capped (``admit``,
    default ``DLROVER_TPU_FABRIC_ADMIT`` or 4): a fetch past the cap is
    answered ``busy`` rather than queued."""

    def __init__(self, server: RPCServer, admit: Optional[int] = None):
        self._server = server
        self._providers: Dict[str, Provider] = {}
        self.admit_cap = max(
            1, admit if admit is not None
            else env_int(ConfigKey.FABRIC_ADMIT, DEFAULT_ADMIT))
        self._sem = threading.BoundedSemaphore(self.admit_cap)
        self._lock = threading.Lock()
        self.busy_replies = 0
        # content CRC by (key, step, total, etag): the etag versions the
        # object, so an overwrite at the same step is never served stale
        self._crc_memo: Dict[Tuple, int] = {}
        server.register("fabric_describe", self._on_describe)
        server.register("fabric_fetch", self._on_fetch)

    def register_provider(self, prefix: str, provider: Provider) -> None:
        """Route keys ``<prefix>/<rest>`` to ``provider(rest)``."""
        self._providers[prefix] = provider

    def _resolve(self, key: str):
        prefix, _, rest = key.partition("/")
        provider = self._providers.get(prefix)
        if provider is None:
            return None
        try:
            return provider(rest)
        except (OSError, ValueError, KeyError, TypeError) as e:
            # a vanished object or a malformed key is "not served here"
            logger.debug("fabric provider %r failed for %r: %r",
                         prefix, rest, e)
            return None

    def _content_crc(self, key, step, total, etag, read_fn) -> Optional[int]:
        memo_key = (key, step, total, etag)
        with self._lock:
            crc = self._crc_memo.get(memo_key)
        if crc is not None:
            return crc
        crc = 0
        for off, n in plan_stripes(total, DEFAULT_STRIPE_BYTES):
            data = read_fn(off, n)
            if data is None or len(data) != n:
                return None
            crc = zlib.crc32(data, crc)
        with self._lock:
            self._crc_memo[memo_key] = crc
        return crc

    def _on_describe(self, req: comm.FabricDescribeRequest
                     ) -> comm.FabricDescribeResponse:
        ans = self._resolve(req.key)
        if ans is None:
            return comm.FabricDescribeResponse(found=False)
        step, total, etag, read_fn = ans
        if req.step >= 0 and step != req.step:
            return comm.FabricDescribeResponse(found=False, step=step)
        crc = self._content_crc(req.key, step, total, etag, read_fn)
        if crc is None:
            return comm.FabricDescribeResponse(found=False, step=step)
        return comm.FabricDescribeResponse(found=True, step=step,
                                           total_bytes=total,
                                           content_crc=crc)

    def _on_fetch(self, req: comm.FabricFetchRequest
                  ) -> comm.FabricStripeResponse:
        if not self._sem.acquire(blocking=False):
            with self._lock:
                self.busy_replies += 1
            return comm.FabricStripeResponse(found=False, busy=True)
        try:
            ans = self._resolve(req.key)
            if ans is None:
                return comm.FabricStripeResponse(found=False)
            step, total, _etag, read_fn = ans
            if req.step >= 0 and step != req.step:
                return comm.FabricStripeResponse(found=False, step=step)
            off = max(0, int(req.offset))
            n = (total - off if req.nbytes <= 0
                 else min(int(req.nbytes), total - off))
            data = read_fn(off, n) if n > 0 else None
            if data is None or len(data) != n:
                return comm.FabricStripeResponse(found=False, step=step)
            data = memoryview(data)
            return comm.FabricStripeResponse(found=True, step=step,
                                             data=data,
                                             crc=zlib.crc32(data))
        finally:
            self._sem.release()


class _FetchSession:
    """The state of one running transfer, mutated under ``_cond``."""

    def __init__(self, key: str, step: int, total: int, crc: int,
                 sources: List[FabricSource],
                 stripes: List[Tuple[int, int]], reporter=None):
        self.key = key
        self.reporter = reporter
        self.step = step
        self.total = total
        self.crc = crc
        self.sources = list(sources)
        self.stripes = stripes
        self.buf = bytearray(total)
        # the assembly buffer is the fabric's staging claim in the memory
        # ledger, released when run() hands the payload off
        self._ledger_name = f"fabric/{key}/{step}"
        get_accountant().register(
            MetricLabel.MEM_STAGING, self._ledger_name, total)
        self._cond = threading.Condition()
        self._abort_evt = threading.Event()
        self._missing = set(range(len(stripes)))
        # take from the tail, re-queue at the head: a re-queued stripe is
        # not re-taken at once by a sibling connection of the same source
        self._pending = list(range(len(stripes)))
        self._failed: set = set()
        # every source failure so far was an injected fault
        self._all_injected = True
        self._bytes_by_source: Dict[str, int] = {}
        self.stripe_fetches = 0
        self.stripe_retries = 0
        self.busy = 0
        self._abort: Optional[str] = None
        self._detail = ""

    def _next_stripe(self, src: FabricSource) -> Optional[int]:
        with self._cond:
            while True:
                if (self._abort is not None or not self._missing
                        or src.addr in self._failed):
                    return None
                if self._pending:
                    return self._pending.pop()
                self._cond.wait(0.1)  # all in flight: wake on a change

    def _requeue_busy(self, idx: int) -> None:
        with self._cond:
            self._pending.insert(0, idx)
            self.busy += 1
            self._cond.notify_all()
        self._abort_evt.wait(BUSY_BACKOFF_S * random.uniform(0.8, 1.2))

    def _fail_source(self, src: FabricSource, idx: int, detail: str,
                     injected: bool = False) -> None:
        with self._cond:
            self.stripe_retries += 1
            self._all_injected = self._all_injected and injected
            newly_failed = src.addr not in self._failed
            self._failed.add(src.addr)
            self._pending.insert(0, idx)
            survivors = sum(s.addr not in self._failed for s in self.sources)
            if not survivors and self._missing:
                self._abort = ("fault_injected" if self._all_injected
                               else "sources_lost")
                self._detail = detail
                self._abort_evt.set()
            self._cond.notify_all()
            left = len(self._missing)
        if newly_failed:
            _report(self.reporter, JournalEvent.FABRIC_SOURCE_FAILED, {
                "key": self.key, "addr": src.addr, "detail": detail,
                "survivors": survivors,
                "stripes_missing": left,
            })
            logger.warning(
                "fabric: source %s failed (%s); %d stripe(s) re-queued "
                "onto %d survivor(s)", src.addr, detail, left, survivors)
        _report(self.reporter, JournalEvent.FABRIC_STRIPE_RETRIED, {
            "key": self.key, "stripe": idx, "addr": src.addr,
            "detail": detail,
        })

    def _commit(self, src: FabricSource, idx: int, data) -> None:
        off, n = self.stripes[idx]
        with self._cond:
            self.stripe_fetches += 1
            if idx in self._missing:
                self.buf[off:off + n] = data
                self._missing.discard(idx)
                self._bytes_by_source[src.addr] = (
                    self._bytes_by_source.get(src.addr, 0) + n)
            if not self._missing:
                self._abort_evt.set()
                self._cond.notify_all()

    def _fetch_one(self, src: FabricSource, client: RPCClient,
                   idx: int, inj) -> None:
        off, n = self.stripes[idx]
        action = None
        try:
            if inj is not None:
                action = inj.fire(FABRIC_STRIPE_SITE, key=self.key,
                                  addr=src.addr, stripe=idx, offset=off,
                                  nbytes=n, step=self.step)
            resp = client.call(
                "fabric_fetch",
                comm.FabricFetchRequest(key=src.key or self.key,
                                        step=self.step, offset=off,
                                        nbytes=n),
                retries=_STRIPE_RETRIES)
        except (InjectedError, *_PEER_ERRORS) as e:
            self._fail_source(src, idx, repr(e),
                              injected=isinstance(e, InjectedError))
            return
        if resp.busy:
            self._requeue_busy(idx)
            return
        if not resp.found:
            self._fail_source(src, idx,
                              f"object gone (source at step {resp.step})")
            return
        data = resp.data
        if action is not None and data:
            # wire corruption of the received stripe: its CRC must catch it
            mut = bytearray(data)
            if action["kind"] == "bitflip":
                mut[int(action["rnd"] * len(mut)) % len(mut)] ^= 0xFF
            elif action["kind"] == "torn":
                mut = mut[:len(mut) // 2]
            data = bytes(mut)
        if len(data) != n or zlib.crc32(data) != resp.crc:
            # corruption is not transient on a reliable transport: fail
            # the source so the refetch lands elsewhere
            self._fail_source(
                src, idx, f"stripe CRC/length mismatch ({len(data)}/{n})")
            return
        self._commit(src, idx, data)

    def _worker(self, src: FabricSource, client: RPCClient, inj) -> None:
        while True:
            idx = self._next_stripe(src)
            if idx is None:
                return
            self._fetch_one(src, client, idx, inj)

    def run(self, clients: Dict[str, RPCClient], conns_per_source: int,
            timeout_s: float) -> Tuple[Optional[str], str]:
        """Drive the transfer: ``(abort reason or None, detail)``, the
        payload in ``self.buf``."""
        inj = get_injector()
        seats = self.sources * max(1, conns_per_source)
        seats = seats[:max(1, min(len(seats), len(self.stripes)))]
        threads = [
            threading.Thread(target=self._worker,
                             args=(src, clients[src.addr], inj),
                             name=f"fabric-fetch-{i}", daemon=True)
            for i, src in enumerate(seats)
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._missing and self._abort is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._abort = "timeout"
                    self._detail = (f"{len(self._missing)} stripe(s) still "
                                    f"missing after {timeout_s:.1f}s")
                    break
                self._cond.wait(min(0.2, remaining))
            abort, detail = self._abort, self._detail
        self._abort_evt.set()
        for t in threads:
            t.join(timeout=5.0)
        if abort is None:
            got = zlib.crc32(self.buf)
            if got != self.crc:
                abort = "content_mismatch"
                detail = f"assembled crc {got} != content address {self.crc}"
        get_accountant().release(MetricLabel.MEM_STAGING, self._ledger_name)
        return abort, detail

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "step": self.step,
                "bytes": self.total,
                "stripes": len(self.stripes),
                "stripe_fetches": self.stripe_fetches,
                "stripe_retries": self.stripe_retries,
                "busy": self.busy,
                "sources": len(self.sources),
                "sources_failed": sorted(self._failed),
                "bytes_by_source": dict(self._bytes_by_source),
            }


def _report(reporter, kind: str, data: Dict[str, Any]) -> None:
    if reporter is None:
        return
    try:
        reporter(kind, data)
    except Exception:  # noqa: BLE001 — telemetry must not fail a transfer
        logger.debug("fabric journal %r failed", kind, exc_info=True)


def _count_session(outcome: str) -> None:
    get_registry().counter(
        "dlrover_fabric_sessions_total",
        "Fabric transfer sessions by outcome",
        labelnames=("outcome",)).labels(outcome=outcome).inc()


def _record_metrics(stats: Dict[str, Any], outcome: str) -> None:
    reg = get_registry()
    by_source = reg.counter(
        "dlrover_fabric_bytes_total",
        "Bytes transferred through the fabric, by source address",
        labelnames=("source",))
    for addr, n in stats.get("bytes_by_source", {}).items():
        by_source.labels(source=addr).inc(n)
    reg.counter(
        "dlrover_fabric_stripe_retries_total",
        "Stripes re-queued after a source failure or CRC reject",
    ).inc(stats.get("stripe_retries", 0))
    _count_session(outcome)
    reg.histogram(
        "dlrover_fabric_session_seconds",
        "Wall-clock duration of fabric transfer sessions",
    ).observe(stats.get("duration_s", 0.0))


def fetch(sources: Sequence[FabricSource], key: str, *,
          expect_step: int = -1, stripe_bytes: Optional[int] = None,
          conns_per_source: Optional[int] = None, timeout_s: float = 60.0,
          reporter: Optional[Callable[[str, Dict[str, Any]], None]] = None
          ) -> Tuple[int, bytearray, Dict[str, Any]]:
    """Describe, stripe, fan out, fail over: ``(step, payload, stats)``.
    The payload is the session's own assembly buffer (a ``bytearray``; a
    multi-gigabyte object is not copied again). ``expect_step`` pins the
    step (-1: the newest the sources agree on); ``reporter(kind, data)``
    takes the session's journal events. Raises :class:`FabricAbort` when
    the session cannot complete."""
    ranked = sorted({s.addr: s for s in sources}.values(),
                    key=lambda s: s.addr)
    with tracing.span(SpanName.FABRIC_FETCH, key=key, step=expect_step,
                      candidates=len(ranked)) as sp:
        return _fetch(ranked, key, expect_step, stripe_bytes,
                      conns_per_source, timeout_s, reporter, sp)


def _abort_session(reporter, key: str, reason: str, detail: str,
                   t0: float) -> None:
    _count_session(reason)
    _report(reporter, JournalEvent.FABRIC_SESSION_ABORTED, {
        "key": key, "reason": reason, "detail": detail,
        "duration_s": time.monotonic() - t0,
    })
    raise FabricAbort(reason, detail)


def _fetch(ranked, key, expect_step, stripe_bytes, conns_per_source,
           timeout_s, reporter, sp):
    stripe_bytes = (
        stripe_bytes if stripe_bytes and stripe_bytes > 0
        else env_int(ConfigKey.FABRIC_STRIPE_BYTES, DEFAULT_STRIPE_BYTES))
    conns = (
        conns_per_source if conns_per_source and conns_per_source > 0
        else env_int(ConfigKey.FABRIC_CONNS, DEFAULT_CONNS))
    t0 = time.monotonic()
    clients: Dict[str, RPCClient] = {}
    candidates = []
    failures = injected = 0
    inj = get_injector()
    for src in ranked:
        # the first describe of a large object computes its content CRC
        # (12 GB for a full-width 7B blob): the session's whole budget
        client = RPCClient(src.addr, timeout_s=max(5.0, timeout_s))
        try:
            if inj is not None:
                inj.fire(FABRIC_CONNECT_SITE, addr=src.addr, key=key)
            resp = client.call(
                "fabric_describe",
                comm.FabricDescribeRequest(key=src.key or key,
                                           step=expect_step),
                retries=1)
        except (InjectedError, *_PEER_ERRORS) as e:
            failures += 1
            injected += isinstance(e, InjectedError)
            logger.info("fabric: source %s unreachable (%r)", src.addr, e)
            continue
        if resp.found:
            clients[src.addr] = client
            candidates.append((src, resp))
    if not candidates:
        _abort_session(reporter, key,
                       "fault_injected" if failures and injected == failures
                       else "no_sources",
                       f"0 of {len(ranked)} sources serve {key!r}", t0)
    # the largest (step, total, crc) group at the newest step
    groups: Dict[Tuple[int, int, int], List[FabricSource]] = {}
    for src, resp in candidates:
        groups.setdefault((resp.step, resp.total_bytes, resp.content_crc),
                          []).append(src)
    best_step = max(step for step, _, _ in groups)
    step, total, crc = max((g for g in groups if g[0] == best_step),
                           key=lambda g: len(groups[g]))
    chosen = groups[(step, total, crc)]
    sp.add_event("described", step=step, bytes=total, sources=len(chosen))
    session = _FetchSession(key, step, total, crc, chosen,
                            plan_stripes(total, stripe_bytes),
                            reporter=reporter)
    abort, detail = (session.run(clients, conns, timeout_s)
                     if session.stripes else (None, ""))
    stats = session.stats()
    duration = time.monotonic() - t0
    stats["duration_s"] = duration
    stats["rate_mbps"] = total / (1024 * 1024) / duration if duration else 0.0
    if abort is not None:
        stats["reason"] = abort
        _record_metrics(stats, outcome=abort)
        _report(reporter, JournalEvent.FABRIC_SESSION_ABORTED, {
            "key": key, "reason": abort, "detail": detail,
            **{k: stats[k] for k in
               ("stripes", "stripe_retries", "sources_failed")}})
        raise FabricAbort(abort, detail)
    _record_metrics(stats, outcome="complete")
    _report(reporter, JournalEvent.FABRIC_SESSION_COMPLETE, {
        "key": key, **{k: stats[k] for k in
                       ("step", "bytes", "stripes", "stripe_fetches",
                        "stripe_retries", "sources", "duration_s")}})
    sp.add_event("complete", **{k: stats[k] for k in
                                ("bytes", "stripes", "stripe_retries")})
    return step, session.buf, stats
