"""Deterministic, seeded fault-injection plane.

The port's copy of ``dlrover_tpu/chaos/injector.py``: the same grammar,
per-rule seeded rngs and decision log, so one schedule and seed give the
same faults in either package. The port's sites are the transport
(``rpc.send``/``rpc.recv``), the shm frame writer (``shm.write``), storage
(``storage.persist``/``storage.commit``), the master's KV wait, rendezvous
join and shard dispatch (``data.dispatch``).

DLRover's promise is surviving faults without losing goodput; this module
makes those faults *reproducible*. A process-local :class:`FaultInjector`
is configured from the environment (``DLROVER_FAULT_SCHEDULE`` +
``DLROVER_FAULT_SEED``) and consulted at named injection sites woven into
the RPC transport, the checkpoint shm writer, and the master's kv/
rendezvous services. Every decision is driven by per-rule counters and a
per-rule ``random.Random`` seeded from (seed, rule ordinal, site), so two
runs with the same seed + schedule produce the *identical* fault sequence
— drills become replayable and CI failures reproducible from one integer.

Schedule grammar (``;``-separated rules)::

    site:kind[@param=value[,param=value...]]

    rpc.send:drop@p=0.05          # drop 5% of sends (pre-send ConnectionError)
    rpc.recv:delay=2s             # sleep 2s after every receive
    rpc.recv:delay=2s@p=0.1       # ... on 10% of receives
    shm.write:torn@step=3         # tear the frame written for step 3
    shm.write:bitflip@nth=2       # flip bits in the 2nd frame written
    kv.wait:partition@t=10s..25s  # kv waits fail from t=+10s to t=+25s
    rpc.send:partition@t=5s..20s  # master unreachable for a 15s window

A JSON schedule (``[{"site": ..., "kind": ..., "p": ...}, ...]`` literal or
``@/path/to/file.json``) is accepted too. Kinds:

========== ==============================================================
``drop``       raise :class:`InjectedFault` (a ``ConnectionError``) —
               rides the transport-retry paths
``partition``  same raise, but conventionally windowed with ``t=a..b`` to
               model a network partition
``delay``      ``time.sleep`` for the rule's duration
``error``      raise :class:`InjectedError` (a ``RuntimeError``) — models
               a server-side handler fault (NOT retried by clients)
``torn``       returned to the site as an action dict; the site applies
               the mutation (shm writer zeroes the tail of the last shard)
``bitflip``    action dict; the site inverts bytes inside the first shard
========== ==============================================================

Rule params: ``p`` (probability per matching call), ``nth`` (fire on
exactly the n-th matching call, 1-based), ``every`` (every k-th call),
``step`` (fire only when the site's context carries that step), ``times``
(max fires), ``t=a..b`` (active window, seconds since injector start),
``delay``/``dur`` (sleep seconds for ``delay``).

Fired faults are pushed to a pluggable reporter (the master wires the
event journal, agents wire ``report_event``) and recorded in an in-memory
decision log used by determinism tests.
"""

import json
import re
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import logger

SCHEDULE_ENV = "DLROVER_FAULT_SCHEDULE"
SEED_ENV = "DLROVER_FAULT_SEED"


class InjectedFault(ConnectionError):
    """A deliberately injected transport-level fault (drop/partition)."""


class InjectedError(RuntimeError):
    """A deliberately injected handler-level fault."""


_DUR_RE = re.compile(r"^([0-9]*\.?[0-9]+)(ms|s|m)?$")


def _parse_dur(text: str) -> float:
    m = _DUR_RE.match(text.strip())
    if not m:
        raise ValueError(f"bad duration {text!r} (want e.g. 2s, 250ms, 1.5)")
    val = float(m.group(1))
    unit = m.group(2) or "s"
    return val * {"ms": 0.001, "s": 1.0, "m": 60.0}[unit]


@dataclass
class FaultRule:
    site: str
    kind: str
    p: float = 1.0
    nth: Optional[int] = None
    every: Optional[int] = None
    step: Optional[int] = None
    times: Optional[int] = None
    window: Optional[tuple] = None  # (start_s, end_s) since injector start
    dur: float = 0.0  # delay seconds (delay kind); partition fallback dur
    # runtime state
    calls: int = 0
    fires: int = 0
    rng: Any = field(default=None, repr=False)

    KINDS = ("drop", "delay", "torn", "bitflip", "partition", "error")

    def matches_site(self, site: str) -> bool:
        if self.site.endswith("*"):
            return site.startswith(self.site[:-1])
        return site == self.site


def parse_rule(text: str) -> FaultRule:
    """Parse one ``site:kind[=dur][@k=v,...]`` rule."""
    text = text.strip()
    head, _, params = text.partition("@")
    site, sep, kindspec = head.partition(":")
    if not sep or not site or not kindspec:
        raise ValueError(f"bad fault rule {text!r} (want site:kind[@params])")
    kind, _, inline_val = kindspec.partition("=")
    kind = kind.strip()
    if kind not in FaultRule.KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r} in {text!r} "
            f"(want one of {FaultRule.KINDS})"
        )
    rule = FaultRule(site=site.strip(), kind=kind)
    if inline_val:
        rule.dur = _parse_dur(inline_val)
    for part in filter(None, (s.strip() for s in params.split(","))):
        k, _, v = part.partition("=")
        k = k.strip()
        v = v.strip()
        if k == "p":
            rule.p = float(v)
        elif k == "nth":
            rule.nth = int(v)
        elif k == "every":
            rule.every = int(v)
        elif k == "step":
            rule.step = int(v)
        elif k == "times":
            rule.times = int(v)
        elif k in ("delay", "dur"):
            rule.dur = _parse_dur(v)
        elif k == "t":
            a, sep2, b = v.partition("..")
            if not sep2:
                raise ValueError(f"bad window {v!r} (want t=10s..25s)")
            rule.window = (_parse_dur(a), _parse_dur(b))
        else:
            raise ValueError(f"unknown fault param {k!r} in {text!r}")
    return rule


def parse_schedule(text: str) -> List[FaultRule]:
    """Parse a schedule: compact grammar, a JSON list literal, or
    ``@/path.json``."""
    text = text.strip()
    if not text:
        return []
    if text.startswith("@"):
        with open(text[1:], "r", encoding="utf-8") as f:
            text = f.read().strip()
    if text.startswith("["):
        rules = []
        for obj in json.loads(text):
            rule = FaultRule(site=obj["site"], kind=obj["kind"])
            for k in ("p", "nth", "every", "step", "times", "dur"):
                if k in obj:
                    setattr(rule, k, obj[k])
            if "t" in obj:
                a, b = obj["t"]
                rule.window = (float(a), float(b))
            if rule.kind not in FaultRule.KINDS:
                raise ValueError(f"unknown fault kind {rule.kind!r}")
            rules.append(rule)
        return rules
    return [parse_rule(r) for r in filter(None,
                                          (s.strip() for s in text.split(";")))]


class FaultInjector:
    """Process-local injector. ``fire(site, **ctx)`` applies every matching
    rule: sleeps for ``delay``, raises for ``drop``/``partition``/``error``,
    and returns an action dict for data-corruption kinds (``torn``/
    ``bitflip``) that the site applies itself."""

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 schedule_text: str = ""):
        import random

        self.seed = seed
        self.schedule_text = schedule_text
        self.rules = rules
        self._start = time.monotonic()
        self._lock = threading.Lock()
        # decisions: (site, kind, per-site fire ordinal) — same seed + same
        # call sequence ⇒ identical log; drills assert on this
        self.decisions: List[tuple] = []
        self._reporter: Optional[Callable[[Dict[str, Any]], None]] = None
        # re-entrancy guard: an agent's reporter is itself an RPC, whose
        # send/recv sites fire() again on the same thread — those nested
        # fires must not re-report (and must never run under _lock)
        self._tls = threading.local()
        for i, rule in enumerate(self.rules):
            mix = zlib.crc32(f"{rule.site}:{rule.kind}:{i}".encode())
            rule.rng = random.Random((seed << 32) ^ mix)

    def set_reporter(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        """``fn(event)`` receives ``{"site", "fault", "ordinal", ...ctx}``
        for every injected fault (master → journal, agent → report_event)."""
        self._reporter = fn

    def describe(self) -> str:
        """Env repro line for this run's fault plane."""
        return (f"{SEED_ENV}={self.seed} "
                f"{SCHEDULE_ENV}='{self.schedule_text}'")

    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def _report(self, site: str, rule: FaultRule, ordinal: int,
                ctx: Dict[str, Any]) -> None:
        event = {"site": site, "fault": rule.kind, "ordinal": ordinal}
        for k, v in ctx.items():
            if isinstance(v, (str, int, float, bool)) or v is None:
                event[k] = v
        logger.warning("fault injected: %s %s #%d %s",
                       site, rule.kind, ordinal, event)
        reporter = self._reporter
        if reporter is None or getattr(self._tls, "reporting", False):
            return
        self._tls.reporting = True
        try:
            reporter(event)
        except Exception:  # noqa: BLE001 — reporting must not add faults
            logger.exception("fault reporter failed")
        finally:
            self._tls.reporting = False

    def fire(self, site: str, **ctx) -> Optional[Dict[str, Any]]:
        """Evaluate all rules for ``site``. Returns an action dict for
        ``torn``/``bitflip`` (or None); raises/sleeps for the other kinds."""
        action: Optional[Dict[str, Any]] = None
        raise_exc: Optional[BaseException] = None
        sleep_s = 0.0
        fired: List[tuple] = []  # (rule, ordinal) — reported OUTSIDE _lock
        now = self.elapsed()
        with self._lock:
            for rule in self.rules:
                if not rule.matches_site(site):
                    continue
                if rule.window is not None and not (
                    rule.window[0] <= now < rule.window[1]
                ):
                    continue
                if rule.step is not None and ctx.get("step") != rule.step:
                    continue
                rule.calls += 1
                if rule.times is not None and rule.fires >= rule.times:
                    continue
                if rule.nth is not None and rule.calls != rule.nth:
                    continue
                if rule.every is not None and rule.calls % rule.every != 0:
                    continue
                if rule.p < 1.0 and rule.rng.random() >= rule.p:
                    continue
                rule.fires += 1
                ordinal = len(self.decisions)
                self.decisions.append((site, rule.kind, ordinal))
                fired.append((rule, ordinal))
                if rule.kind == "delay":
                    sleep_s += rule.dur
                elif rule.kind in ("drop", "partition"):
                    raise_exc = InjectedFault(
                        f"injected {rule.kind} at {site} (#{ordinal})"
                    )
                elif rule.kind == "error":
                    raise_exc = InjectedError(
                        f"injected error at {site} (#{ordinal})"
                    )
                else:  # torn / bitflip — the site applies the mutation
                    action = {"kind": rule.kind, "ordinal": ordinal,
                              "rnd": rule.rng.random()}
        for rule, ordinal in fired:
            self._report(site, rule, ordinal, ctx)
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        if raise_exc is not None:
            raise raise_exc
        return action


# ---------------------------------------------------------------------------
# process-local singleton, lazily configured from the environment


_instance: Optional[FaultInjector] = None
_configured = False
_last_repro: Optional[str] = None
_lock = threading.Lock()


def get_injector() -> Optional[FaultInjector]:
    """The process's injector, or None when no schedule is configured.

    The None fast path is a cached bool check — hot paths (every RPC,
    every shm frame write) stay within the <1% regression budget."""
    global _instance, _configured, _last_repro
    if _configured:
        return _instance
    with _lock:
        if not _configured:
            from dlrover_tpu_torch.common.constants import (
                ConfigKey,
                env_int,
                env_str,
            )

            schedule = env_str(ConfigKey.FAULT_SCHEDULE, "")
            if schedule:
                seed = env_int(ConfigKey.FAULT_SEED, 0)
                try:
                    _instance = FaultInjector(
                        parse_schedule(schedule), seed=seed,
                        schedule_text=schedule,
                    )
                    _last_repro = _instance.describe()
                    logger.warning("fault injection ACTIVE: %s",
                                   _instance.describe())
                except ValueError:
                    logger.exception("bad %s — injection disabled",
                                     SCHEDULE_ENV)
            _configured = True
    return _instance


def configure(schedule: str, seed: int = 0) -> FaultInjector:
    """Install an injector explicitly (tests/drills). Returns it."""
    global _instance, _configured, _last_repro
    with _lock:
        _instance = FaultInjector(
            parse_schedule(schedule), seed=seed, schedule_text=schedule
        )
        _configured = True
        _last_repro = _instance.describe()
    return _instance


def reset_injector() -> None:
    """Drop the injector (tests); next get_injector() re-reads the env."""
    global _instance, _configured
    with _lock:
        _instance = None
        _configured = False


def active_repro() -> Optional[str]:
    """Repro line (seed + schedule) of the current — or most recently
    configured — injector; used by the pytest failure hook so any chaos
    failure prints how to replay it."""
    inj = _instance
    if inj is not None:
        return inj.describe()
    return _last_repro
