"""The port's attribution plane against the JAX package's, on the CPU.

The same seeded inputs go through ``dlrover_tpu`` and
``dlrover_tpu_torch`` in one process:

- op-class histograms, ``classify`` and the accumulator give equal wire
  snapshots, and each package's skew monitor reads the other's snapshots
  to the same verdicts;
- every verdict scenario of the reference's skew tests (uniform ranks, a
  slow compute or collective rank, a two-rank world, a missing-rank hang,
  equal or progressing collective counters, a flapping straggler, a
  worker restart, a stale rank) gives equal verdicts, journal events,
  gauges and straggler history;
- the straggler history survives export/restore alike, and biases the
  training rendezvous's world cut alike;
- the runtime-straggler and metric-stall rules resolve equal actions on
  the same verdicts and series;
- the timer's Python spans feed the accumulator (no native library) with
  the collective's entry marked before it runs.
"""

import numpy as np
import pytest

from dlrover_tpu.common import metric as jax_metric
from dlrover_tpu.common.comm import NodeMeta as JaxNodeMeta
from dlrover_tpu.diagnosis import diagnosis_master as jax_dm
from dlrover_tpu.master import rdzv_manager as jax_rdzv
from dlrover_tpu.master import skew_monitor as jax_skew
from dlrover_tpu.observability import journal as jax_journal
from dlrover_tpu.observability import op_telemetry as jax_optel
from dlrover_tpu.observability import registry as jax_registry

from dlrover_tpu_torch.common import metric as port_metric
from dlrover_tpu_torch.common.comm import NodeMeta as PortNodeMeta
from dlrover_tpu_torch.diagnosis import diagnosis_master as port_dm
from dlrover_tpu_torch.master import rdzv_manager as port_rdzv
from dlrover_tpu_torch.master import skew_monitor as port_skew
from dlrover_tpu_torch.observability import journal as port_journal
from dlrover_tpu_torch.observability import op_telemetry as port_optel
from dlrover_tpu_torch.observability import registry as port_registry
from dlrover_tpu_torch.observability import tpu_timer as port_tt

PKGS = {
    "jax": dict(optel=jax_optel, skew=jax_skew, journal=jax_journal,
                registry=jax_registry, dm=jax_dm, rdzv=jax_rdzv,
                metric=jax_metric, meta=JaxNodeMeta),
    "torch": dict(optel=port_optel, skew=port_skew, journal=port_journal,
                  registry=port_registry, dm=port_dm, rdzv=port_rdzv,
                  metric=port_metric, meta=PortNodeMeta),
}


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def make_snapshot(pkg, n, mean_us=100.0, op_class="compute", coll_seq=0,
                  coll_name="all_reduce_0", extra_classes=None):
    """A cumulative wire snapshot with ``n`` observations of ``mean_us``,
    built with ``pkg``'s histogram."""
    hist = PKGS[pkg]["optel"].OpClassHistogram
    h = hist()
    for _ in range(n):
        h.observe(mean_us)
    classes = {op_class: h.to_wire()}
    for cls, (cn, cmean) in (extra_classes or {}).items():
        ch = hist()
        for _ in range(cn):
            ch.observe(cmean)
        classes[cls] = ch.to_wire()
    return {"seq": n + coll_seq, "classes": classes,
            "last_collective": {"name": coll_name, "seq": coll_seq}}


def _skew_lines(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith(("dlrover_skew", "dlrover_hang")))


class Run:
    """One package's monitor on a fake clock, fed beat by beat."""

    def __init__(self, pkg, **kw):
        p = PKGS[pkg]
        self.pkg = pkg
        self.clock = FakeClock()
        self.journal = p["journal"].EventJournal()
        self.registry = p["registry"].MetricsRegistry()
        kw.setdefault("window", 8)
        self.monitor = p["skew"].SkewMonitor(
            event_journal=self.journal, registry=self.registry,
            monotonic=self.clock, **kw)

    def feed(self, beats, step_s=1.0):
        for beat in beats:
            self.clock.t += step_s
            for rank, snap in beat.items():
                self.monitor.observe(node_id=rank,
                                     op_telemetry={str(rank): snap})

    def result(self):
        return {
            "verdicts": self.monitor.current_verdicts(),
            "journal": [(e["kind"], e["source"], e["data"])
                        for e in self.journal.events()],
            "gauges": _skew_lines(self.registry.render()),
            "history": self.monitor.node_straggler_counts(),
            "deltas": self.monitor.window_deltas(),
        }


# -- the verdict scenarios (the reference's skew tests) ----------------------


def _uniform(pkg, run):
    run.feed([{r: make_snapshot(pkg, 10 * b, 100.0, coll_seq=b)
               for r in range(4)} for b in (1, 2, 3)])


def _slow_compute(pkg, run):
    run.feed([{r: make_snapshot(pkg, 10 * b, 350.0 if r == 3 else 100.0,
                                coll_seq=b) for r in range(4)}
              for b in (1, 2)])


def _slow_collective(pkg, run):
    run.feed([{r: make_snapshot(
        pkg, 10 * b, 100.0, coll_seq=b,
        extra_classes={"collective": (10 * b, 900.0 if r == 1 else 200.0)})
        for r in range(4)} for b in (1, 2)])


def _two_ranks(pkg, run):
    run.feed([{0: make_snapshot(pkg, 10 * b, 100.0, coll_seq=b),
               1: make_snapshot(pkg, 10 * b, 300.0, coll_seq=b)}
              for b in (1, 2)])


def _missing_rank_hang(pkg, run):
    beats = []
    for _ in range(3):
        beat = {r: make_snapshot(pkg, 30, 100.0, coll_seq=18,
                                 coll_name="all_reduce_17")
                for r in range(3)}
        beat[3] = make_snapshot(pkg, 30, 100.0, coll_seq=17,
                                coll_name="all_reduce_16")
        beats.append(beat)
    run.feed(beats)


def _equal_stalled(pkg, run):
    run.feed([{r: make_snapshot(pkg, 30, 100.0, coll_seq=9)
               for r in range(4)} for _ in range(4)])


def _progressing(pkg, run):
    run.feed([{r: make_snapshot(pkg, 10 * b, 100.0,
                                coll_seq=b + (0 if r else 1))
               for r in range(4)} for b in (1, 2, 3, 4)])


def _flapping(pkg, run):
    def beats(rng, slow):
        return [{r: make_snapshot(pkg, 10 * b,
                                  400.0 if (slow and r == 2) else 100.0,
                                  coll_seq=b) for r in range(4)}
                for b in rng]
    run.feed(beats((1, 2, 3), True))
    run.feed(beats(range(4, 13), False))
    run.feed(beats(range(13, 21), True))


def _restart(pkg, run):
    run.feed([{r: make_snapshot(pkg, 10 * b, 100.0, coll_seq=b)
               for r in range(2)} for b in (1, 2, 3)])
    run.feed([{1: make_snapshot(pkg, 1, 100.0, coll_seq=0)}])


def _stale(pkg, run):
    run.feed([{r: make_snapshot(pkg, 10 * b, 500.0 if r == 0 else 100.0,
                                coll_seq=b) for r in range(3)}
              for b in (1, 2)])
    run.clock.t += 100.0
    run.feed([{r: make_snapshot(pkg, 30 + 10 * b, 100.0, coll_seq=2 + b)
               for r in (1, 2)} for b in (1, 2)])


# scenario -> (driver, monitor kwargs, what the reference's test holds)
SCENARIOS = {
    "uniform": (_uniform, {}, lambda r: r["verdicts"] == {
        "stragglers": [], "hang": None} and r["journal"] == []),
    "slow_compute": (_slow_compute, {}, lambda r: [
        (s["rank"], s["cause"], s["ratio"])
        for s in r["verdicts"]["stragglers"]] == [(3, "compute", 3.5)]
        and 'dlrover_skew_ratio{op_class="compute"} 3.5' in r["gauges"]),
    "slow_collective": (_slow_collective, {}, lambda r: {
        (s["rank"], s["cause"]) for s in r["verdicts"]["stragglers"]}
        == {(1, "collective")}),
    "two_ranks": (_two_ranks, {}, lambda r: [
        s["rank"] for s in r["verdicts"]["stragglers"]] == [1]),
    "missing_rank_hang": (_missing_rank_hang, {"hang_min_samples": 3},
                          lambda r: r["verdicts"]["hang"] == {
                              "collective": "all_reduce_17",
                              "entered_ranks": [0, 1, 2],
                              "missing_ranks": [3]}
                          and "dlrover_hang_suspected 1" in r["gauges"]),
    "equal_stalled": (_equal_stalled, {"hang_min_samples": 3},
                      lambda r: r["verdicts"]["hang"] is None),
    "progressing": (_progressing, {"hang_min_samples": 3},
                    lambda r: r["verdicts"]["hang"] is None),
    "flapping": (_flapping, {}, lambda r: [
        k for k, _, _ in r["journal"]].count("straggler_detected") == 2
        and r["history"] == {2: 2}),
    "restart": (_restart, {}, lambda r: r["verdicts"]["stragglers"] == []
                and r["journal"] == []),
    "stale": (_stale, {"stale_s": 30.0},
              lambda r: r["verdicts"]["stragglers"] == []
              and r["journal"][0][2]["rank"] == 0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_verdicts_match_the_reference(name):
    drive, kw, holds = SCENARIOS[name]
    results = {}
    for pkg in PKGS:
        run = Run(pkg, **kw)
        drive(pkg, run)
        results[pkg] = run.result()
    assert results["torch"] == results["jax"]
    assert holds(results["torch"]), results["torch"]


# -- histograms, classify, the accumulator and the wire ----------------------


def test_histograms_classify_and_accumulator_match():
    rng = np.random.default_rng(13)
    durs = rng.lognormal(mean=6.0, sigma=3.0, size=400).tolist() + [
        0.0, -5.0, 10.0, 10.0001, 10_485_760.0, 10_485_761.0]
    names = ["train_step", "next_batch", "DataLoad_x", "ckpt.persist",
             "save_to_memory", "restore", "host_fetch", "psum", "", "Input"]
    out = {}
    for pkg, p in PKGS.items():
        h = p["optel"].OpClassHistogram()
        acc = p["optel"].OpTelemetryAccumulator()
        for i, d in enumerate(durs):
            h.observe(d)
            name = names[i % len(names)]
            kind = 1 if name == "psum" else 0
            if kind == 1:
                acc.enter_collective(f"{name}_{i}")
            acc.observe_span(kind, name, d)
        other = p["optel"].OpClassHistogram.from_wire(h.to_wire())
        other.merge(h)
        out[pkg] = {
            "hist": h.to_wire(), "merged": other.to_wire(),
            "classes": [p["optel"].classify(k, n)
                        for k in (0, 1, 2) for n in names],
            "snapshot": acc.snapshot(),
            "bounds": p["optel"].BUCKET_BOUNDS_US,
        }
    assert out["torch"] == out["jax"]
    assert out["torch"]["hist"]["n"] == len(durs)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_each_monitor_reads_the_other_packages_snapshots(direction):
    """Seeded per-rank durations through one package's accumulators, their
    snapshots into the other package's monitor: the verdicts equal those
    of the snapshots' own package."""
    src, dst = (("torch", "jax") if direction == "port_to_jax"
                else ("jax", "torch"))
    rng = np.random.default_rng(7)
    accs = {r: PKGS[src]["optel"].OpTelemetryAccumulator()
            for r in range(3)}
    beats = []
    for b in range(4):
        beat = {}
        for r, acc in accs.items():
            scale = 4.0 if r == 2 else 1.0
            for d in rng.uniform(100, 200, size=12):
                acc.observe("compute", float(d) * scale)
            acc.enter_collective(f"all_reduce_{b}")
            acc.observe("collective", float(rng.uniform(50, 60)))
            beat[r] = acc.snapshot()
        beats.append(beat)
    results = {}
    for pkg in (src, dst):
        run = Run(pkg)
        run.feed(beats)
        results[pkg] = run.result()
    assert results[dst] == results[src]
    assert [(s["rank"], s["cause"])
            for s in results[dst]["verdicts"]["stragglers"]] == [
        (2, "compute")]


def test_timer_spans_feed_the_accumulator_without_the_library():
    port_optel.reset_accumulator()
    timer = port_tt.TpuTimer()
    timer._lib = None  # the CPU path: no native engine
    try:
        with timer.span("train_step"):
            pass
        with timer.span("all_reduce_x", kind=port_tt.KIND_COLL):
            # entry is marked before the collective runs
            inside = port_optel.get_accumulator().snapshot()
        timer.record(port_tt.KIND_MM, "next_batch", 5.0)
        snap = timer.op_telemetry()
    finally:
        port_optel.reset_accumulator()
    assert inside["last_collective"] == {"name": "all_reduce_x", "seq": 1}
    assert "collective" not in inside["classes"]
    assert {c: w["n"] for c, w in snap["classes"].items()} == {
        "compute": 1, "collective": 1, "input": 1}
    assert snap["seq"] == 4


# -- history: export/restore and the world cut -------------------------------


def test_straggler_history_export_restore_match():
    out = {}
    for pkg in PKGS:
        run = Run(pkg)
        _flapping(pkg, run)
        state = run.monitor.export_straggler_state()
        fresh = Run(pkg)
        fresh.monitor.restore_straggler_state(state)
        fresh.monitor.restore_straggler_state({"counts": {"x": 1}})
        out[pkg] = (state, fresh.monitor.node_straggler_counts())
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == {2: 2}


@pytest.mark.parametrize("history", [None, {1: 4}, {0: 0}, {3: 1, 0: 2}])
def test_world_cut_matches_the_reference(history):
    worlds = {}
    for pkg, p in PKGS.items():
        manager = p["rdzv"].ElasticTrainingRendezvousManager()
        manager.update_rdzv_params(min_nodes=3, max_nodes=3, node_unit=1)
        if history is not None:
            manager.straggler_history = lambda h=history: dict(h)
        for rank in range(4):
            manager.join_rendezvous(p["meta"](node_id=rank, node_rank=rank))
        _, _, world = manager.get_comm_world(0)
        worlds[pkg] = sorted(world)
    assert worlds["torch"] == worlds["jax"]
    if history == {1: 4}:
        assert worlds["torch"] == [0, 2, 3]


# -- the diagnosis rules ------------------------------------------------------


def test_runtime_straggler_rule_matches():
    out = {}
    for pkg, p in PKGS.items():
        run = Run(pkg)
        run.feed([{r: make_snapshot(pkg, 10 * b,
                                    400.0 if r == 2 else 100.0, coll_seq=b)
                   for r in range(4)} for b in (1, 2)])
        rule = p["dm"].RuntimeStragglerDiagnostician(run.monitor)
        first = rule.diagnose()
        again = rule.diagnose()  # the same episode: no second dump
        # the verdict clears, then relapses: a new episode, a new dump
        _uniform(pkg, run)
        run.feed([{r: make_snapshot(pkg, 100 + 10 * b, 100.0, coll_seq=9 + b)
                   for r in range(4)} for b in range(8)])
        cleared = rule.diagnose()
        run.feed([{r: make_snapshot(pkg, 200 + 10 * b,
                                    400.0 if r == 2 else 100.0,
                                    coll_seq=20 + b)
                   for r in range(4)} for b in range(8)])
        relapse = rule.diagnose()
        out[pkg] = [(a.action_type, a.instance, a.reason, a.data)
                    for a in (first, again, cleared, relapse)]
    assert out["torch"] == out["jax"]
    kinds = [a[0] for a in out["torch"]]
    assert kinds == ["stack_dump", "no_action", "no_action", "stack_dump"]
    assert out["torch"][0][1] == 2  # the culprit's node
    assert out["torch"][0][3]["cause"] == "compute"


@pytest.mark.parametrize("series", ["stalled", "busy", "no_duty_cycle",
                                    "empty"])
def test_metric_stall_rule_matches(series):
    rng = np.random.default_rng(3)
    out = {}
    for pkg, p in PKGS.items():
        ctx = p["metric"].JobMetricContext()
        for node in range(3):
            for _ in range(0 if series == "empty" else 5):
                util = {"stalled": float(rng.uniform(0, 0.4)),
                        "busy": float(rng.uniform(0, 90)),
                        "no_duty_cycle": None}[series]
                ctx.add_node_metrics(p["metric"].NodeMetrics(
                    node_id=node, cpu_percent=5.0,
                    devices=[p["metric"].TpuMetric(
                        device_id=0, duty_cycle_pct=util,
                        hbm_used_mb=100.0, hbm_total_mb=1000.0)]))
        rule = p["dm"].MetricStallDiagnostician(ctx, window_s=300.0)
        action = rule.diagnose()
        out[pkg] = (action.action_type, action.data)
        rng = np.random.default_rng(3)  # the same series for both
    assert out["torch"] == out["jax"]
    assert (out["torch"][1].get("event_type") == "device_stall") == (
        series == "stalled")


def test_a_forgotten_node_leaves_no_hang_verdict():
    """The port's master drops a failed node's windows: its ranks'
    stalled counters beside the survivors' restarted ones read as a hang
    in the reference's monitor (ROADMAP C17), not after ``forget_node``."""
    verdicts = {}
    for forget in (False, True):
        run = Run("torch", hang_min_samples=3)
        # a paced step: every rank idles at one collective count
        run.feed([{r: make_snapshot("torch", 40, 100.0, coll_seq=43)
                   for r in range(4)} for _ in range(3)])
        if forget:
            run.monitor.forget_node(2)
            run.monitor.forget_node(3)
        # node 2 and 3 died; 0 and 1 restarted (counters reset) and wait
        # in the world's re-formation
        run.feed([{r: make_snapshot("torch", 5, 100.0, coll_seq=1)
                   for r in (0, 1)} for _ in range(3)])
        verdicts[forget] = run.monitor.current_verdicts()["hang"]
    assert verdicts[False] == {"collective": "all_reduce_0",
                               "entered_ranks": [2, 3],
                               "missing_ranks": [0, 1]}
    assert verdicts[True] is None
