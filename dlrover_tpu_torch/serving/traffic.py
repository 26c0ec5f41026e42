"""Open-loop traffic for the serving plane.

The port's copy of ``dlrover_tpu/serving/traffic.py``. Closed-loop load
(N clients, each waiting for its answer before the next request)
throttles itself when the server slows, so tail latency under overload
is never seen. This generator is open loop: the arrival schedule is
computed up front as pure data (the same profile and seed give the same
arrivals, lengths and shared prefixes as the reference's), and dispatch
follows the schedule's clock, not the server's, so the queueing the
server causes lands in the measured TTFT.

Knobs:

- **arrivals**: Poisson (exponential gaps) or bursty (Poisson with
  periodic high-rate windows: the p99-TTFT-under-burst shape);
- **envelope**: flat, a linear ramp or one sine period over the run
  (``offered_rps(t)`` exposes it for ``ServingSignals``);
- **prompt mixture**: weighted length bands and a shared-prefix family
  knob: a fraction of prompts open with one of ``prefix_families`` fixed
  preambles, the structure the radix prefix cache exploits.
"""

import math
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(
        q / 100.0 * (len(ordered) - 1)))))
    return ordered[idx]


@dataclass
class TrafficProfile:
    """Everything :meth:`OpenLoopGenerator.schedule` needs: pure data,
    no clocks."""

    rps: float = 20.0
    duration_s: float = 2.0
    arrival: str = "poisson"            # "poisson" | "bursty"
    burst_factor: float = 4.0           # rate multiplier inside a burst
    burst_period_s: float = 1.0         # one burst window a period
    burst_fraction: float = 0.25        # share of the period bursting
    diurnal: str = "flat"               # "flat" | "ramp" | "sine"
    ramp_start_frac: float = 0.2        # ramp: start at this × rps
    # weighted (weight, lo, hi) prompt-length bands
    length_mix: Tuple[Tuple[float, int, int], ...] = (
        (0.6, 6, 12), (0.3, 12, 24), (0.1, 24, 40))
    shared_prefix_frac: float = 0.6     # prompts opening with a preamble
    prefix_families: int = 3
    prefix_len: int = 8
    max_new_lo: int = 4
    max_new_hi: int = 12
    vocab: int = 32
    seed: int = 0


@dataclass
class _Arrival:
    t: float
    prompt: List[int]
    max_new_tokens: int
    family: int


@dataclass
class RequestRecord:
    scheduled_t: float
    ttft_s: float = 0.0
    latency_s: float = 0.0
    tokens: int = 0
    ok: bool = False
    error: str = ""
    extra: Dict = field(default_factory=dict)


class OpenLoopGenerator:
    def __init__(self, submit_fn: Callable, profile: TrafficProfile,
                 workers: int = 16):
        """``submit_fn(prompt, max_new_tokens)`` returns the router's
        response (``success``, ``ttft_s``, ``tokens``) or any truthy or
        falsy value; an exception counts as a failure."""
        self._submit_fn = submit_fn
        self.profile = profile
        self._workers = workers
        self.records: List[RequestRecord] = []
        self._lock = threading.Lock()

    # -- the schedule (a pure function of the profile) ---------------------

    def _rate(self, t: float) -> float:
        """The offered rate at schedule time ``t``: arrivals × envelope."""
        p = self.profile
        rate = p.rps
        if p.diurnal == "ramp":
            frac = min(1.0, t / max(p.duration_s, 1e-9))
            rate *= p.ramp_start_frac + (1.0 - p.ramp_start_frac) * frac
        elif p.diurnal == "sine":
            frac = t / max(p.duration_s, 1e-9)
            rate *= 0.5 + 0.5 * math.sin(2.0 * math.pi * frac
                                         - math.pi / 2.0)
            rate = max(rate, 0.05 * p.rps)
        if p.arrival == "bursty":
            phase = (t % p.burst_period_s) / p.burst_period_s
            if phase < p.burst_fraction:
                rate *= p.burst_factor
        return max(rate, 1e-6)

    def offered_rps(self, t: float) -> float:
        """The envelope at ``t`` (a leading signal for the autoscaler)."""
        return self._rate(t)

    def schedule(self) -> List[_Arrival]:
        p = self.profile
        rng = random.Random(p.seed)
        # fixed per-family preambles: a replayed schedule walks the same
        # radix-trie paths
        fam_rng = random.Random(p.seed ^ 0x5EED)
        prefixes = [[fam_rng.randrange(p.vocab) for _ in range(p.prefix_len)]
                    for _ in range(p.prefix_families)]
        out: List[_Arrival] = []
        t = 0.0
        while True:
            # step by the local rate (exact for piecewise-constant
            # envelopes at this scale)
            t += rng.expovariate(self._rate(t))
            if t >= p.duration_s:
                return out
            r = rng.random()
            acc = 0.0
            lo, hi = p.length_mix[-1][1], p.length_mix[-1][2]
            for w, wlo, whi in p.length_mix:
                acc += w
                if r <= acc:
                    lo, hi = wlo, whi
                    break
            length = rng.randint(lo, hi)
            family = -1
            if rng.random() < p.shared_prefix_frac and length > p.prefix_len:
                family = rng.randrange(p.prefix_families)
                prompt = prefixes[family] + [
                    rng.randrange(p.vocab)
                    for _ in range(length - p.prefix_len)]
            else:
                prompt = [rng.randrange(p.vocab) for _ in range(length)]
            out.append(_Arrival(
                t=t, prompt=prompt,
                max_new_tokens=rng.randint(p.max_new_lo, p.max_new_hi),
                family=family))

    # -- dispatch (open loop: the schedule's clock) ------------------------

    def _one(self, arrival: _Arrival, t0: float) -> None:
        rec = RequestRecord(scheduled_t=arrival.t)
        # TTFT counts from the scheduled instant: the queueing a request
        # suffered before it was sent is real latency
        lag = (time.monotonic() - t0) - arrival.t
        try:
            resp = self._submit_fn(arrival.prompt, arrival.max_new_tokens)
            rec.latency_s = (time.monotonic() - t0) - arrival.t
            rec.ok = bool(getattr(resp, "success", resp))
            rec.ttft_s = max(0.0, lag) + float(getattr(resp, "ttft_s", 0.0))
            rec.tokens = len(getattr(resp, "tokens", ()) or ())
            if not rec.ok:
                rec.error = str(getattr(resp, "message", "refused"))
        except Exception as e:  # noqa: BLE001 — measured, not swallowed:
            # the failure lands in the record
            rec.ok = False
            rec.error = repr(e)
            rec.latency_s = (time.monotonic() - t0) - arrival.t
        with self._lock:
            self.records.append(rec)

    def run(self) -> Dict[str, float]:
        """Dispatch the whole schedule and wait for every result; returns
        :meth:`results`."""
        arrivals = self.schedule()
        t0 = time.monotonic()
        with ThreadPoolExecutor(max_workers=self._workers,
                                thread_name_prefix="traffic-gen") as pool:
            for a in arrivals:
                delay = a.t - (time.monotonic() - t0)
                if delay > 0:
                    time.sleep(delay)
                pool.submit(self._one, a, t0)
        return self.results()

    def results(self) -> Dict[str, float]:
        with self._lock:
            recs = list(self.records)
        ok = [r for r in recs if r.ok]
        ttfts = [r.ttft_s for r in ok]
        wall = max((r.scheduled_t + r.latency_s for r in recs), default=0.0)
        return {
            "offered": len(recs),
            "completed": len(ok),
            "failed": len(recs) - len(ok),
            "offered_rps": (len(recs) / self.profile.duration_s
                            if self.profile.duration_s else 0.0),
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p99_s": percentile(ttfts, 99),
            "tokens": sum(r.tokens for r in ok),
            "tokens_per_s": (sum(r.tokens for r in ok) / wall
                             if wall > 0 else 0.0),
        }
