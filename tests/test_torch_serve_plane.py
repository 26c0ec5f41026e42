"""The port's elastic serving plane against the JAX package's, module by
module, on the same inputs in one process: the serving optimizer, the
training optimizer and the auto-scaler's tick, the train↔serve loan, the
journal's phase attribution, the SLO plane, the open-loop schedule; then
the chaos sites the slice adds (``serve.request``, ``serve.replica``,
``serve.prefix``, ``fabric.connect``, ``fabric.stripe``) and the master's
journal. Clocks are injected (a module's ``time`` replaced by one fake
clock, or a ``monotonic`` argument), so both sides see one timeline.
Every comparison is exact: these are control-plane decisions.
"""

import gc
import math
import threading
import time
import types
import weakref

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from dlrover_tpu import chaos as jchaos  # noqa: E402
from dlrover_tpu.master import auto_scaler as jas  # noqa: E402
from dlrover_tpu.master import rdzv_manager as jrdzv  # noqa: E402
from dlrover_tpu.master import resource as jres  # noqa: E402
from dlrover_tpu.observability import journal as jj  # noqa: E402
from dlrover_tpu.observability import registry as jreg  # noqa: E402
from dlrover_tpu.observability import slo as jslo  # noqa: E402
from dlrover_tpu.serving import autoscaler as jsa  # noqa: E402
from dlrover_tpu.serving import traffic as jtr  # noqa: E402

from dlrover_tpu_torch import chaos as tchaos  # noqa: E402
from dlrover_tpu_torch.common import comm as tcomm  # noqa: E402
from dlrover_tpu_torch.common import fabric as tfab  # noqa: E402
from dlrover_tpu_torch.common.rpc import RPCServer  # noqa: E402
from dlrover_tpu_torch.master import auto_scaler as tas  # noqa: E402
from dlrover_tpu_torch.master import rdzv_manager as trdzv  # noqa: E402
from dlrover_tpu_torch.master import resource as tres  # noqa: E402
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402
from dlrover_tpu_torch.observability import journal as tj  # noqa: E402
from dlrover_tpu_torch.observability import registry as treg  # noqa: E402
from dlrover_tpu_torch.observability import slo as tslo  # noqa: E402
from dlrover_tpu_torch.serving import autoscaler as tsa  # noqa: E402
from dlrover_tpu_torch.serving import prefix_cache as tpc  # noqa: E402
from dlrover_tpu_torch.serving import traffic as ttr  # noqa: E402
from dlrover_tpu_torch.serving.engine import (  # noqa: E402
    ToyEngine,
    build_tiny_engine,
)
from dlrover_tpu_torch.serving.replica import DecodeReplica  # noqa: E402
from dlrover_tpu_torch.serving.router import RequestRouter  # noqa: E402

SIDES = ("jax", "port")
SETTINGS = settings(max_examples=60, deadline=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])
# the router's TTFT buckets (the SLO plane reads this family)
TTFT_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30)


class FakeClock:
    def __init__(self, start: float = 1000.0):
        self.now = start

    def monotonic(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


def _install_clock(monkeypatch, modules, clock):
    fake = types.SimpleNamespace(monotonic=clock.monotonic,
                                 time=clock.monotonic, sleep=clock.advance)
    for mod in modules:
        monkeypatch.setattr(mod, "time", fake)


@pytest.fixture()
def no_injectors():
    """No fault plane on either side before or after the test."""
    jchaos.reset_injector()
    tchaos.reset_injector()
    yield
    jchaos.reset_injector()
    tchaos.reset_injector()


# -- the serving optimizer ----------------------------------------------------

_TICK = st.fixed_dictionaries(dict(
    live=st.integers(0, 4), target=st.integers(0, 4),
    queue=st.integers(0, 12), inflight=st.integers(0, 12),
    ttft=st.floats(0.0, 5.0), dt=st.floats(0.0, 4.0)))


@SETTINGS
@given(min_r=st.integers(1, 2), extra=st.integers(0, 3),
       slo=st.floats(0.1, 3.0), queue_hi=st.integers(0, 8),
       grow_cd=st.floats(0.0, 5.0), shrink_cd=st.floats(0.0, 10.0),
       ticks=st.lists(_TICK, min_size=1, max_size=30))
def test_serving_optimizer_plans_like_jax(min_r, extra, slo, queue_hi,
                                          grow_cd, shrink_cd, ticks):
    """Restore, grow and shrink on random signal sequences, cooldowns on
    one fake clock: the same ServePlan, reason included, every tick."""
    clock = FakeClock()
    opts = {side: mod.ServingOptimizer(
        min_replicas=min_r, max_replicas=min_r + extra, ttft_slo_s=slo,
        queue_hi=queue_hi, grow_cooldown_s=grow_cd,
        shrink_cooldown_s=shrink_cd, monotonic=clock.monotonic)
        for side, mod in zip(SIDES, (jsa, tsa))}
    for t in ticks:
        clock.advance(t["dt"])
        plans = {}
        for side, mod in zip(SIDES, (jsa, tsa)):
            plan = opts[side].plan(mod.ServingSignals(
                live_replicas=t["live"], target_replicas=t["target"],
                queue_depth=t["queue"], inflight=t["inflight"],
                ttft_p99_s=t["ttft"]))
            plans[side] = (plan.replica_num, plan.reason, plan.empty())
        assert plans["port"] == plans["jax"]


def test_serving_optimizer_reads_the_env_knobs_like_jax(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SERVE_TTFT_SLO_S", "0.7")
    monkeypatch.setenv("DLROVER_TPU_SERVE_QUEUE_HI", "5")
    monkeypatch.setenv("DLROVER_TPU_SERVE_GROW_COOLDOWN_S", "1.5")
    monkeypatch.setenv("DLROVER_TPU_SERVE_SHRINK_COOLDOWN_S", "9")
    knobs = [(o.ttft_slo_s, o.queue_hi, o.grow_cooldown_s,
              o.shrink_cooldown_s)
             for o in (jsa.ServingOptimizer(), tsa.ServingOptimizer())]
    assert knobs[0] == knobs[1] == (0.7, 5, 1.5, 9.0)


# -- the training optimizer and the auto-scaler's tick ------------------------

_STATS = st.fixed_dictionaries(dict(
    running=st.integers(0, 8), pending=st.integers(0, 3),
    target=st.integers(1, 8), stragglers=st.lists(st.integers(0, 7),
                                                  max_size=3),
    oldest=st.floats(0.0, 2000.0), dt=st.floats(0.0, 900.0)))


@SETTINGS
@given(min_n=st.integers(1, 3), extra=st.integers(0, 5),
       unit=st.integers(1, 2), pending_timeout=st.floats(10.0, 1000.0),
       grow_cd=st.floats(0.0, 1200.0),
       seq=st.lists(_STATS, min_size=1, max_size=20))
def test_local_optimizer_plans_like_jax(monkeypatch, min_n, extra, unit,
                                        pending_timeout, grow_cd, seq):
    """Unschedulable shrink, straggler shrink and the recovery grow with
    its cooldown: the same ResourcePlan for the same ScalingStats."""
    clock = FakeClock()
    _install_clock(monkeypatch, (jres, tres), clock)
    opts = {side: mod.LocalOptimizer(pending_timeout_s=pending_timeout,
                                     grow_cooldown_s=grow_cd)
            for side, mod in zip(SIDES, (jres, tres))}
    for s in seq:
        clock.advance(s["dt"])
        plans = {}
        for side, mod in zip(SIDES, (jres, tres)):
            plan = opts[side].plan(mod.ScalingStats(
                running_nodes=s["running"], pending_nodes=s["pending"],
                target_nodes=s["target"], min_nodes=min_n,
                max_nodes=min_n + extra, node_unit=unit,
                straggler_nodes=list(s["stragglers"]),
                oldest_pending_s=s["oldest"]))
            plans[side] = (plan.node_num, plan.reason, plan.empty())
        assert plans["port"] == plans["jax"]


@pytest.mark.parametrize("n,unit", [(0, 1), (5, 1), (5, 2), (7, 4), (3, 0)])
def test_round_to_unit_like_jax(n, unit):
    assert tres.round_to_unit(n, unit) == jres.round_to_unit(n, unit)


_NODE_STATUS = st.sampled_from(
    ["running", "pending", "initial", "failed", "succeeded"])


@SETTINGS
@given(min_n=st.integers(1, 3), extra=st.integers(0, 4),
       unit=st.integers(1, 2), speed=st.floats(0.0, 10.0),
       ticks=st.lists(st.fixed_dictionaries(dict(
           statuses=st.lists(_NODE_STATUS, min_size=1, max_size=8),
           stragglers=st.lists(st.integers(0, 7), max_size=2),
           dt=st.floats(0.0, 1500.0))), min_size=1, max_size=12))
def test_auto_scaler_tick_and_execute_like_jax(monkeypatch, min_n, extra,
                                               unit, speed, ticks):
    """``collect_stats`` over a node table and the perf monitor, the
    optimizer's plan, and ``execute``'s clamp: the same plans, the same
    target, and the same rendezvous params on each side's manager."""
    clock = FakeClock()
    _install_clock(monkeypatch, (jres, tres, jas, tas), clock)
    stragglers = []
    nodes = {}
    scalers, managers = {}, {}
    for side, (asm, rdzv) in zip(SIDES, ((jas, jrdzv), (tas, trdzv))):
        managers[side] = rdzv.ElasticTrainingRendezvousManager()
        managers[side].update_rdzv_params(min_n, min_n + extra,
                                          waiting_timeout=2.0,
                                          node_unit=unit)
        scalers[side] = asm.JobAutoScaler(
            types.SimpleNamespace(nodes=nodes),
            types.SimpleNamespace(running_speed=lambda: speed),
            None, rdzv_managers={"training": managers[side]},
            optimizer=(jres if side == "jax" else tres).LocalOptimizer(
                pending_timeout_s=600.0, grow_cooldown_s=900.0),
            min_nodes=min_n, max_nodes=min_n + extra, node_unit=unit,
            straggler_provider=lambda: list(stragglers))
    for t in ticks:
        clock.advance(t["dt"])
        nodes.clear()
        for i, status in enumerate(t["statuses"]):
            nodes[i] = types.SimpleNamespace(
                status=status, create_time=clock.now - 100.0 * i)
        stragglers[:] = t["stragglers"]
        got = {}
        for side in SIDES:
            plan = scalers[side].tick()
            p = managers[side]._rdzv_params
            got[side] = (None if plan is None else (plan.node_num,
                                                    plan.reason),
                         scalers[side].target_nodes,
                         (p.min_nodes, p.max_nodes, p.node_unit,
                          p.waiting_timeout))
        assert got["port"] == got["jax"]


@pytest.mark.parametrize("plan_n", [0, 1, 3, 9])
def test_execute_clamps_to_bounds_like_jax(plan_n):
    got = {}
    for side, (asm, res, rdzv) in zip(
            SIDES, ((jas, jres, jrdzv), (tas, tres, trdzv))):
        m = rdzv.ElasticTrainingRendezvousManager()
        m.update_rdzv_params(2, 4, waiting_timeout=1.0)
        scaler = asm.JobAutoScaler(
            types.SimpleNamespace(nodes={}),
            types.SimpleNamespace(running_speed=lambda: 0.0), None,
            rdzv_managers={"training": m}, min_nodes=2, max_nodes=4)
        scaler.execute(res.ResourcePlan(node_num=plan_n, reason="test"))
        p = m._rdzv_params
        got[side] = (scaler.target_nodes, p.min_nodes, p.max_nodes)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("arg", ["scaler", "strategy_generator",
                                 "brain_advisor"])
def test_auto_scaler_refuses_what_is_not_ported(arg):
    with pytest.raises(NotImplementedError, match=arg):
        tas.JobAutoScaler(types.SimpleNamespace(nodes={}),
                          types.SimpleNamespace(running_speed=lambda: 0.0),
                          **{arg: object()})


class _FixedPlan:
    def __init__(self, mod, n, reason):
        self._plan = mod.ServePlan(n, reason)

    def plan(self, signals):
        return self._plan


@pytest.mark.parametrize("reason", ["restore lost replica (1/2 live)",
                                    "traffic grow (queue=9, ttft_p99=0.1s)"])
def test_serve_tick_journals_a_repeated_plan_once_like_jax(reason):
    """A restore plan repeats every tick until the replacement registers:
    executed every tick (the scaler respawns a replica that died
    starting), journaled once; an empty plan resets the memory."""
    got = {}
    for side, (asm, sa, jmod) in zip(SIDES, ((jas, jsa, jj),
                                             (tas, tsa, tj))):
        journal = jmod.EventJournal()
        scaled = []
        plans = [_FixedPlan(sa, 2, reason)]

        class _Opt:
            def plan(self, signals):
                return plans[0].plan(signals)

        scaler = asm.JobAutoScaler(
            types.SimpleNamespace(nodes={}),
            types.SimpleNamespace(running_speed=lambda: 0.0), None,
            serving_optimizer=_Opt(),
            serving_signals=lambda: sa.ServingSignals(live_replicas=1,
                                                      target_replicas=2),
            serve_scaler=types.SimpleNamespace(
                scale_to=lambda n, reason="": scaled.append((n, reason))),
            event_journal=journal)
        for _ in range(5):
            scaler.serve_tick()
        plans[0] = types.SimpleNamespace(plan=lambda s: sa.ServePlan())
        scaler.serve_tick()
        plans[0] = _FixedPlan(sa, 2, reason)
        scaler.serve_tick()
        got[side] = (scaled, [(e["kind"], e["data"])
                              for e in journal.events()])
    assert got["port"] == got["jax"]
    scaled, events = got["port"]
    assert len(scaled) == 6 and len(events) == 2


def test_train_serve_coordinator_borrows_and_hands_back_like_jax():
    """Hot at its maximum with an idle training node: borrow one replica's
    worth; the loan is spent after one; a journaled ``rdzv_start`` hands
    it back through the scaler."""
    got = {}
    for side, (sa, jmod) in zip(SIDES, ((jsa, jj), (tsa, tj))):
        opt = sa.ServingOptimizer(min_replicas=1, max_replicas=2,
                                  ttft_slo_s=1.0, queue_hi=4)
        journal = jmod.EventJournal()
        scaled = []
        coord = sa.TrainServeCoordinator(
            opt, serve_scaler=types.SimpleNamespace(
                scale_to=lambda n, reason="": scaled.append((n, reason))),
            event_journal=journal, idle_provider=lambda: 1, max_borrow=1)
        hot = sa.ServingSignals(live_replicas=2, target_replicas=2,
                                ttft_p99_s=3.0)
        cold = sa.ServingSignals(live_replicas=2, target_replicas=2)
        steps = [coord.maybe_borrow(cold), coord.maybe_borrow(hot),
                 opt.max_replicas, coord.maybe_borrow(hot)]
        journal.record("rdzv_start", round=1)
        steps += [opt.max_replicas, coord.borrowed]
        coord.handback()  # nothing borrowed: a no-op
        got[side] = (steps, scaled,
                     [(e["kind"], e["source"], e["data"])
                      for e in journal.events()])
    assert got["port"] == got["jax"]
    steps, scaled, _ = got["port"]
    assert steps == [False, True, 3, False, 2, 0]
    assert scaled[0][0] == 3 and scaled[-1][0] == 2
    assert "handback" in scaled[-1][1]


# -- the journal ----------------------------------------------------------------

_EVENT = st.fixed_dictionaries(dict(
    kind=st.sampled_from(sorted(set(jj.JournalEvent.ALL)) + ["unknown"]),
    t=st.floats(0.0, 100.0)))


@SETTINGS
@given(events=st.lists(_EVENT, max_size=40), now_t=st.floats(0.0, 120.0),
       start_t=st.floats(0.0, 50.0))
def test_phase_segments_and_attribution_like_jax(events, now_t, start_t):
    """The phase state machine on random event lists (every JAX kind,
    informational ones included): the same segments and seconds."""
    evs = [dict(e, seq=i + 1) for i, e in enumerate(events)]
    assert (tj.phase_segments(evs, now_t, start_t)
            == jj.phase_segments(evs, now_t, start_t))
    assert (tj.attribute_phases(evs, now_t, start_t)
            == jj.attribute_phases(evs, now_t, start_t))
    assert tuple(tj.Phase.ALL) == tuple(jj.Phase.ALL)


def test_port_journal_kinds_are_the_references():
    assert set(tj.JournalEvent.ALL) <= set(jj.JournalEvent.ALL)
    for name in dir(tj.JournalEvent):
        if name.isupper() and name != "ALL":
            assert getattr(tj.JournalEvent, name) == getattr(
                jj.JournalEvent, name)
    assert tj._TRANSITIONS == jj._TRANSITIONS


def test_event_journal_ring_overflow_and_phase_like_jax():
    got = {}
    for side, mod in zip(SIDES, (jj, tj)):
        journal = mod.EventJournal(capacity=5)
        seen = []
        journal.add_listener(lambda e: seen.append(e["kind"]))
        for i, kind in enumerate(["serve_replica_up", "fault_injected",
                                  "serve_replica_lost", "serve_scale",
                                  "serve_replica_up", "serve_rerouted",
                                  "serve_request_failed", "slo_burn_alert"]):
            journal.record(kind, source="s", i=i)
        got[side] = ([(e["seq"], e["kind"], e["source"], e["data"])
                      for e in journal.events()],
                     journal.dropped, journal.current_phase(), seen,
                     len(journal), sorted(
                         __import__("json").loads(journal.to_json()).keys()))
    assert got["port"] == got["jax"]
    assert got["port"][2] == "serving"


def test_journal_gauges_sum_to_wall_like_jax():
    names = {}
    for side, (jmod, rmod) in zip(SIDES, ((jj, jreg), (tj, treg))):
        reg = rmod.MetricsRegistry()
        journal = jmod.EventJournal()
        journal.attach_gauges(reg)
        journal.record("serve_replica_up", node_id=1)
        text = reg.render()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("dlrover_goodput_")]
        values = {ln.split()[0]: float(ln.split()[1]) for ln in lines}
        wall = values.pop("dlrover_goodput_wall_seconds")
        assert math.isclose(sum(values.values()), wall, abs_tol=1e-9)
        names[side] = sorted([*values, "wall"]) + sorted(
            ln.split()[0] for ln in text.splitlines()
            if ln.startswith("dlrover_journal_"))
    assert names["port"] == names["jax"]


def test_histogram_bucket_counts_like_jax():
    values = [0.004, 0.01, 0.3, 2.4, 2.5, 7.0, 31.0, 0.05]
    got = []
    for mod in (jreg, treg):
        h = mod.MetricsRegistry().histogram(
            "dlrover_serving_ttft_seconds", "ttft", buckets=TTFT_BUCKETS)
        for v in values:
            h.observe(v)
        got.append(h.bucket_counts())
    assert got[0] == got[1]
    assert got[1][math.inf] == len(values)


# -- the SLO plane ----------------------------------------------------------------


@SETTINGS
@given(obs=st.lists(st.tuples(st.floats(0.0, 40.0), st.floats(0.0, 3.0),
                              st.sampled_from(["ok", "error", "lost"])),
                    min_size=1, max_size=50),
       fast=st.floats(0.5, 3.0), slow=st.floats(1.0, 10.0),
       threshold=st.floats(0.5, 20.0), cooldown=st.floats(0.0, 8.0),
       ttft_slo=st.sampled_from([0.1, 1.0, 2.0, 2.7]))
def test_slo_plane_burns_and_alerts_like_jax(monkeypatch, obs, fast, slow,
                                             threshold, cooldown, ttft_slo):
    """The same histogram observations and outcome counts on each side's
    registry, ticked on one clock: the same fast burns every tick, the
    same alerts, the same journaled payloads."""
    monkeypatch.setenv("DLROVER_TPU_SERVE_TTFT_SLO_S", str(ttft_slo))
    clock = FakeClock()
    sides = {}
    for side, (smod, rmod) in zip(SIDES, ((jslo, jreg), (tslo, treg))):
        reg = rmod.MetricsRegistry()
        hist = reg.histogram("dlrover_serving_ttft_seconds", "ttft",
                             buckets=TTFT_BUCKETS)
        outcomes = reg.counter("dlrover_serving_requests_total",
                               "by outcome", labelnames=("status",))
        journal = []
        plane = smod.SLOPlane(
            registry=reg, fast_window_s=fast, slow_window_s=slow,
            burn_threshold=threshold, alert_cooldown_s=cooldown,
            journal_fn=lambda kind, _j=journal, **d: _j.append((kind, d)),
            monotonic=clock.monotonic)
        sides[side] = (hist, outcomes, plane, journal)
    for ttft, dt, status in obs:
        for hist, outcomes, _, _ in sides.values():
            hist.observe(ttft)
            outcomes.labels(status=status).inc()
        clock.advance(dt)
        ticks = {side: s[2].tick() for side, s in sides.items()}
        assert ticks["port"] == ticks["jax"]
        assert (sides["port"][2].burn_rate()
                == sides["jax"][2].burn_rate())
    assert sides["port"][2].alerts == sides["jax"][2].alerts
    assert sides["port"][3] == sides["jax"][3]


def test_default_slos_like_jax(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SERVE_GOODPUT_SLO", "0.9")
    got = [[(s.name, s.tier, s.ttft_threshold_s, s.target, s.goodput_target,
             s.metric, s.counter_metric, s.error_budget())
            for s in mod.default_slos()] for mod in (jslo, tslo)]
    assert got[0] == got[1]


# -- the open-loop schedule ------------------------------------------------------


@SETTINGS
@given(rps=st.floats(1.0, 60.0), duration=st.floats(0.1, 5.0),
       arrival=st.sampled_from(["poisson", "bursty"]),
       diurnal=st.sampled_from(["flat", "ramp", "sine"]),
       frac=st.floats(0.0, 1.0), families=st.integers(1, 4),
       prefix_len=st.integers(1, 64), vocab=st.integers(2, 32000),
       seed=st.integers(0, 2 ** 31))
def test_open_loop_schedule_like_jax(rps, duration, arrival, diurnal, frac,
                                     families, prefix_len, vocab, seed):
    """One profile and seed: identical arrival times, prompts (shared
    preambles included), lengths and families, and the same envelope."""
    kw = dict(rps=rps, duration_s=duration, arrival=arrival,
              diurnal=diurnal, shared_prefix_frac=frac,
              prefix_families=families, prefix_len=prefix_len,
              length_mix=((0.7, 64, 512), (0.3, 512, 1024)),
              max_new_lo=16, max_new_hi=32, vocab=vocab, seed=seed)
    gens = [mod.OpenLoopGenerator(lambda p, n: True,
                                  mod.TrafficProfile(**kw))
            for mod in (jtr, ttr)]
    arrivals = [[(a.t, a.prompt, a.max_new_tokens, a.family)
                 for a in g.schedule()] for g in gens]
    assert arrivals[1] == arrivals[0]
    for t in np.linspace(0.0, duration, 7):
        assert gens[1].offered_rps(float(t)) == gens[0].offered_rps(float(t))


def test_open_loop_run_counts_like_jax():
    """A short run against an instant server: the same offered,
    completed, failed and token counts (every other request refused)."""
    profile = dict(rps=40.0, duration_s=0.3, seed=3)
    got = []
    for mod in (jtr, ttr):
        calls = [0]

        def submit(prompt, max_new, _c=calls):
            _c[0] += 1
            return types.SimpleNamespace(success=len(prompt) % 2 == 0,
                                         ttft_s=0.0, tokens=[1] * max_new,
                                         message="refused")
        res = mod.OpenLoopGenerator(submit, mod.TrafficProfile(**profile),
                                    workers=4).run()
        got.append({k: res[k] for k in ("offered", "completed", "failed",
                                        "offered_rps", "tokens")})
    assert got[1] == got[0] and got[1]["offered"] > 0


# -- chaos sites --------------------------------------------------------------------


class _FakeReplica:
    def __init__(self, node_id):
        self.node_id = node_id

    def rpc_serve_generate(self, req):
        return tcomm.ServeGenerateResponse(
            request_id=req.request_id, success=True,
            tokens=list(req.prompt)[:req.max_new_tokens], ttft_s=0.01,
            replica_id=self.node_id)


def test_chaos_serve_request_retries_to_success(no_injectors):
    """Site ``serve.request``: an injected router-side error takes one
    attempt and is journaled; the same request then completes."""
    tchaos.configure("serve.request:error@nth=1", seed=3)
    server = RPCServer(host="127.0.0.1", port=0)
    server.register_object(_FakeReplica(1))
    server.start()
    journal = []
    router = RequestRouter(
        replicas_fn=lambda: [{"node_id": 1,
                              "addr": f"127.0.0.1:{server.port}",
                              "slots": 4}],
        journal_fn=lambda kind, **d: journal.append((kind, d)),
        request_timeout_s=10.0, registry=treg.MetricsRegistry())
    try:
        resp = router.submit([5, 6, 7], max_new_tokens=3, request_id="c1")
        assert resp.success and resp.replica_id == 1
        assert (router.completed, router.lost) == (1, 0)
        failed = [d for kind, d in journal if kind == "serve_request_failed"]
        assert len(failed) == 1 and failed[0]["node_id"] == -1
        assert "injected" in failed[0]["error"].lower()
        assert router.ttft_p99() == 0.01 and router.inflight() == 0
        assert router.tokens_per_s() > 0
    finally:
        server.stop()


def test_router_journals_the_reroute_off_a_dead_replica():
    server = RPCServer(host="127.0.0.1", port=0)
    server.register_object(_FakeReplica(2))
    server.start()
    journal = []
    router = RequestRouter(
        replicas_fn=lambda: [
            {"node_id": 1, "addr": "127.0.0.1:1", "slots": 64},
            {"node_id": 2, "addr": f"127.0.0.1:{server.port}",
             "slots": 1}],
        journal_fn=lambda kind, **d: journal.append((kind, d)),
        request_timeout_s=10.0, registry=treg.MetricsRegistry())
    try:
        assert router.submit([1] * 8, 2, request_id="rr1").success
        kinds = [kind for kind, _ in journal]
        assert kinds == ["serve_request_failed", "serve_rerouted"]
        assert journal[1][1] == {"request_id": "rr1", "from_node": 1}
    finally:
        server.stop()


def test_chaos_serve_replica_crashes_the_replica(no_injectors):
    """Site ``serve.replica`` fires in the heartbeat loop: the injected
    error crashes the replica (no drain, no deregister), the master's
    journal holds the injected fault and the replica's loss."""
    from dlrover_tpu_torch.common.config import get_context

    tchaos.configure("serve.replica:error@nth=3", seed=7)
    ctx = get_context()
    saved = (ctx.heartbeat_interval_s, ctx.conn_drop_grace_s)
    ctx.set("heartbeat_interval_s", 0.05)
    ctx.set("conn_drop_grace_s", 0.1)
    master = LocalJobMaster(job_name="serve-chaos", node_num=1, min_nodes=1)
    master.prepare()
    crashed = threading.Event()
    replica = DecodeReplica(master.addr, node_id=300,
                            engine=ToyEngine(slots=2), buckets=(8,),
                            heartbeat_interval_s=0.05,
                            on_crash=crashed.set)
    try:
        replica.start()
        assert master.serve_registry.count() == 1
        assert crashed.wait(10.0), "the injected heartbeat fault never fired"
        assert replica.crashed
        deadline = time.monotonic() + 10.0
        while (master.serve_registry.count()
               and time.monotonic() < deadline):
            time.sleep(0.05)
        kinds = [e["kind"] for e in master.event_journal.events()]
        assert kinds.count("fault_injected") == 1
        assert "serve_replica_lost" in kinds
        assert "serve_replica_drained" not in kinds
        assert master.event_journal.current_phase() == "detect"
    finally:
        replica.stop()
        master.stop()
        ctx.set("heartbeat_interval_s", saved[0])
        ctx.set("conn_drop_grace_s", saved[1])


def test_chaos_serve_prefix_drops_the_reuse_to_a_cold_prefill(no_injectors):
    """Site ``serve.prefix`` fires on every reuse: an injected fault drops
    the entry, and the request's cold prefill gives the tokens a reuse
    would have."""
    wrapped = tpc.PrefixCachingEngine(
        build_tiny_engine(slots=2, cache_len=48, device="cpu"),
        cache=tpc.RadixPrefixCache(max_bytes=1 << 20, block=4),
        registry=treg.MetricsRegistry())
    base = [3, 1, 4, 1, 5, 9, 2, 6]
    first = wrapped.prefill_rows(base + [5, 3], 16).first_token
    tchaos.configure("serve.prefix:bitflip@nth=1", seed=1)
    dropped = wrapped.prefill_rows(base + [5, 3], 16).first_token
    reused = wrapped.prefill_rows(base + [5, 3], 16).first_token
    st_ = wrapped.stats()
    assert first == dropped == reused
    assert (st_["dropped"], st_["hits"], st_["misses"]) == (1, 1, 2)


def _blob(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _sources(blob, n=2):
    servers, addrs = [], []
    for _ in range(n):
        server = RPCServer(host="127.0.0.1", port=0)
        fab = tfab.FabricServer(server=server)
        fab.register_provider(
            "blob", lambda rest: (7, len(blob), 0,
                                  lambda off, k: blob[off:off + k]))
        server.start()
        servers.append(server)
        addrs.append(f"127.0.0.1:{server.port}")
    return servers, [tfab.FabricSource(addr=a) for a in addrs]


@pytest.mark.parametrize("schedule,failed", [
    ("fabric.stripe:bitflip@nth=1", 1),
    ("fabric.stripe:torn@nth=2", 1),
    ("fabric.stripe:error@nth=1", 1),
    ("fabric.connect:error@nth=1", 0),
])
def test_chaos_fabric_sites_fail_a_source_and_the_session_completes(
        no_injectors, schedule, failed):
    """``fabric.stripe``: a corrupted stripe fails its CRC (an error
    fails the source at once) and its stripes re-queue onto the other
    source; ``fabric.connect``: the first source is unreachable for the
    session. The payload arrives intact either way."""
    blob = _blob(40_000, seed=4)
    servers, sources = _sources(blob)
    tchaos.configure(schedule, seed=2)
    try:
        _, got, stats = tfab.fetch(sources, "blob/x", stripe_bytes=4096,
                                   conns_per_source=1)
        assert bytes(got) == blob
        assert len(stats["sources_failed"]) == failed
        assert stats["sources"] == (1 if "connect" in schedule else 2)
        assert tchaos.get_injector().decisions
    finally:
        for s in servers:
            s.stop()


# -- the master's journal ----------------------------------------------------------


def test_master_journals_reported_events_and_the_serve_registry():
    master = LocalJobMaster(job_name="journal", node_num=1, min_nodes=1)
    servicer = master.servicer
    servicer.rpc_report_event(tcomm.EventReport(
        node_id=3, kind="restore_start", data={"source": "w", "step": 5}))
    master.serve_registry.register(101, "127.0.0.1:1", 4)
    master.serve_registry.register(102, "127.0.0.1:2", 4)
    master.serve_registry.deregister(101, reason="drain")
    assert master.serve_registry.on_node_lost(102)
    assert not master.serve_registry.on_node_lost(102)
    events = master.event_journal.events()
    assert [(e["kind"], e["source"]) for e in events] == [
        ("restore_start", "agent_3"), ("serve_replica_up", "master"),
        ("serve_replica_up", "master"), ("serve_replica_drained", "master"),
        ("serve_replica_lost", "master")]
    assert events[0]["data"] == {"payload_source": "w", "step": 5}
    assert master.event_journal.current_phase() == "detect"
    text = master.metrics_registry.render()
    assert "dlrover_goodput_serving_seconds" in text
    assert "dlrover_serving_replicas" in text


def test_master_journals_a_training_node_failure():
    master = LocalJobMaster(job_name="journal-fail", node_num=2,
                            min_nodes=1)
    master.job_manager.update_node_status(0, "running")
    master.job_manager.update_node_status(0, "failed")
    kinds = [e["kind"] for e in master.event_journal.events()]
    # the fault, then the node_fault bundle the flight recorder wrote
    # after it (the reference master's sequence)
    assert kinds == ["fault_detected", "trace_bundle_captured"]


def test_a_stopped_master_leaves_no_collect_hook():
    """Each master hangs its goodput gauges on the process registry; a
    stopped one takes its hook away, so no dead journal is rendered."""
    master = LocalJobMaster(job_name="hook", node_num=1, min_nodes=1)
    master.prepare()
    reg = master.metrics_registry
    assert master._gauge_hook in reg._hooks
    master.stop()
    assert master._gauge_hook not in reg._hooks
    assert "dlrover_goodput_wall_seconds" in reg.render()


def _handler_threads():
    return [t for t in threading.enumerate()
            if "process_request_thread" in t.name]


def test_a_stopped_rpc_server_closes_its_open_connections():
    """A stopped server answers nothing more on a connection a client
    still holds, and its handler thread ends, dropping what the handlers
    reach (ROADMAP C21: the reference's handler threads go on serving)."""
    from dlrover_tpu_torch.common.rpc import RPCClient

    class Service:
        def rpc_ping(self, req):
            return tcomm.BaseResponse()

    service = Service()
    gone = weakref.ref(service)
    server = RPCServer("127.0.0.1", 0)
    server.register_object(service)
    server.start()
    before = len(_handler_threads())
    client = RPCClient(f"127.0.0.1:{server.port}", timeout_s=5.0)
    client.call("ping", tcomm.BaseRequest())
    assert len(_handler_threads()) == before + 1
    server.stop()
    del service, server
    deadline = time.monotonic() + 5
    while len(_handler_threads()) > before and time.monotonic() < deadline:
        time.sleep(0.02)
    gc.collect()
    assert len(_handler_threads()) == before
    assert gone() is None
    with pytest.raises(OSError):
        client.call("ping", tcomm.BaseRequest(), retries=1)


def test_a_stopped_replica_lets_go_of_its_engine():
    """A replica behind a prefix cache, called over a connection its
    caller keeps: once stopped and dropped, nothing holds its engine (the
    weights a card would keep through every later phase), neither its RPC
    handler thread nor the process registry's prefix-bytes gauge."""
    from dlrover_tpu_torch.common.rpc import RPCClient
    from dlrover_tpu_torch.master.servicer import start_master

    master_server, _ = start_master()
    engine = build_tiny_engine(device="cpu")
    gone = weakref.ref(engine)
    replica = DecodeReplica(f"127.0.0.1:{master_server.port}", 1,
                            tpc.PrefixCachingEngine(engine),
                            buckets=(8, 16), heartbeat_interval_s=0.2,
                            registry=treg.MetricsRegistry())
    try:
        replica.start()
        client = RPCClient(replica.addr, timeout_s=5.0)
        client.call("serve_ping", tcomm.BaseRequest())
    finally:
        replica.stop()
        master_server.stop()
    del engine, replica
    deadline = time.monotonic() + 5
    while gone() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert gone() is None
    # the gauge reads a dropped engine as empty
    assert "dlrover_serving_prefix_bytes 0" in treg.get_registry().render()
