"""The port's serving drills on the CPU, and across packages.

- ``run_serving_drill`` with the toy backend and with ``--backend torch
  --config tiny --device cpu`` replicas: a SIGKILL mid-traffic loses no
  request, the master detects the kill, the router re-routes, the
  autoscaler restores the fleet, and the replacement gives the
  survivor's greedy tokens (the tiny one warm-started from it);
- ``run_traffic_drill``: the open-loop burst journals a grow, and with a
  tight TTFT objective an SLO burn alert;
- both wire directions: port replicas spawned by the port's manager
  under the JAX package's drill (its ``LocalJobMaster``,
  ``RequestRouter``, ``JobAutoScaler`` and ``ServingOptimizer``), and
  JAX toy replicas spawned by the JAX manager under the port's drill
  (its master, router and autoscaler).

These are the assertions of the reference's
``tests/test_serving_plane.py::test_serving_e2e_replica_kill_loses_zero_requests``
and ``tests/test_serving_observability.py::test_burst_drill_burn_alert_leads_reactive_grow``.
In both wire directions the drill process's traces (span names per
trace and their parent links) and its journal kinds equal between the
two packages' drills, and every TTFT exemplar the router recorded (the
trace id a replica answered with) is a ``serve.route`` trace of the
router's process: the context crossed the wire both ways.
"""

import pytest

pytest.importorskip("torch")

from dlrover_tpu.serving import drill as jdrill  # noqa: E402
from dlrover_tpu.serving import replica as jreplica  # noqa: E402

from dlrover_tpu.observability import registry as jregistry  # noqa: E402
from dlrover_tpu.observability import tracing as jtracing  # noqa: E402

from dlrover_tpu_torch import chaos as tchaos  # noqa: E402
from dlrover_tpu_torch.observability import registry as tregistry  # noqa: E402,E501
from dlrover_tpu_torch.observability import tracing as ttracing  # noqa: E402
from dlrover_tpu_torch.serving import drill as tdrill  # noqa: E402
from dlrover_tpu_torch.serving import replica as treplica  # noqa: E402


@pytest.fixture(autouse=True)
def _no_injectors():
    from dlrover_tpu import chaos as jchaos

    jchaos.reset_injector()
    tchaos.reset_injector()
    yield
    jchaos.reset_injector()
    tchaos.reset_injector()


def _assert_kill_drill(result, requests):
    assert result["completed"] == result["requests"] == requests
    assert result["lost"] == 0
    assert result["failed_responses"] == 0
    assert result["killed_node"] is not None
    assert result["kill_detected"]
    assert result["replicas_restored"]
    assert result["live_replicas_end"] == 2
    assert result["rerouted"] >= 1  # the kill landed mid-traffic
    journal = result["journal"]
    assert journal.get("fault_injected", 0) >= 1
    assert journal.get("serve_replica_lost", 0) >= 1
    assert journal.get("serve_rerouted", 0) >= 1
    assert journal.get("serve_scale", 0) >= 1  # the restore plan
    assert journal.get("serve_replica_up", 0) >= 3
    assert result["tokens_total"] > 0
    assert 0.0 < result["serving_goodput"] <= 1.0


@pytest.mark.parametrize("backend", ["toy", "torch"])
def test_port_kill_drill_loses_no_request_and_restores(backend):
    kw = ({} if backend == "toy"
          else dict(config="tiny", device="cpu"))
    result = tdrill.run_serving_drill(replicas=2, backend=backend,
                                      num_requests=24, **kw)
    _assert_kill_drill(result, 24)
    # the port's additions: the kill's timings on the journal's clock, the
    # replacement's tokens, and no live replica declared dead
    assert result["false_deaths"] == []
    assert 0.0 < result["detect_s"] < result["restore_s"]
    restored = result["restored_node"]
    assert restored is not None and restored != result["killed_node"]
    probe = result["probe_tokens"]
    assert len(probe) == 2 and len({tuple(t) for t in probe.values()}) == 1
    gauges = result["replica_gauges"]
    assert restored in gauges and gauges[restored]["serve_decode_steps"] > 0
    # no decode kernel on the CPU
    assert all(g["serve_decode_kernel_launches"] == 0
               for g in gauges.values())
    if backend == "torch":
        warm = result["warm_start"]
        assert warm is not None and warm["bytes"] == result["blob_bytes"] > 0
    else:
        assert result["warm_start"] is None


def test_port_burst_drill_journals_a_grow_and_an_slo_alert(monkeypatch):
    """The open-loop burst piles a queue on one toy replica: the queue
    rule grows the fleet (journaled) and, under an objective below the
    toy's contended TTFT, the SLO plane journals a burn alert."""
    monkeypatch.setenv("DLROVER_TPU_SERVE_TTFT_SLO_S", "0.011")
    result = tdrill.run_traffic_drill(seed=5, ttft_slo_s=30.0)
    assert result["completed"] == result["offered"] > 0
    assert result["lost"] == 0
    assert result["grow_events"] >= 1, "the burst never triggered a grow"
    assert result["journal"].get("serve_scale", 0) >= 1
    assert result["slo_alerts"] >= 1
    assert result["journal"].get("slo_burn_alert", 0) >= 1
    assert result["first_alert_t"] is not None
    assert result["first_grow_t"] is not None


def test_port_replicas_under_the_jax_drill(monkeypatch):
    """Port replicas, spawned by the port's manager, under the JAX
    package's master, router, autoscaler and chaos plane."""
    monkeypatch.setattr(jdrill, "LocalReplicaManager",
                        treplica.LocalReplicaManager)
    result = jdrill.run_serving_drill(replicas=2, backend="toy",
                                      num_requests=24)
    _assert_kill_drill(result, 24)


def test_jax_replicas_under_the_port_drill(monkeypatch):
    """JAX toy replicas, spawned by the JAX manager, under the port's
    master, router, autoscaler and chaos plane."""
    monkeypatch.setattr(tdrill, "LocalReplicaManager",
                        jreplica.LocalReplicaManager)
    result = tdrill.run_serving_drill(replicas=2, backend="toy",
                                      num_requests=24)
    _assert_kill_drill(result, 24)
    assert result["false_deaths"] == []
    assert len({tuple(t) for t in result["probe_tokens"].values()}) == 1


def test_manager_raises_with_the_exit_code_of_a_replica_that_never_registered():
    """A child that dies before it registers (here a bucket longer than
    its cache) makes ``wait_live`` raise with its exit code and the tail
    of its stderr, not time out."""
    manager = treplica.LocalReplicaManager(
        "127.0.0.1:1", live_fn=lambda: [], backend="torch", config="tiny",
        device="cpu", slots=2, buckets=(64,), cache_len=16)
    try:
        manager.scale_to(1, reason="test")
        with pytest.raises(RuntimeError,
                           match=r"(?s)exited with 1 before it registered"
                                 r".*exceeds cache length"):
            manager.wait_live(1, timeout_s=60.0)
    finally:
        manager.stop_all()


def test_manager_spawns_the_ports_flags():
    toy = treplica.LocalReplicaManager("h:1", live_fn=lambda: [])
    cmd = toy._cmd(100)
    assert cmd[1:3] == ["-m", "dlrover_tpu_torch.serving.replica"]
    assert "--device" not in cmd and "--config" not in cmd
    llama = treplica.LocalReplicaManager(
        "h:1", live_fn=lambda: [], backend="torch", config="llama",
        device="cpu", quantize=True, prefix_cache=True, seed=3)
    cmd = llama._cmd(101)
    for flag, value in (("--backend", "torch"), ("--config", "llama"),
                        ("--device", "cpu"), ("--seed", "3")):
        assert cmd[cmd.index(flag) + 1] == value
    llama.seed = 4  # the seed of the replicas spawned from now on
    cmd = llama._cmd(102)
    assert cmd[cmd.index("--seed") + 1] == "4"
    assert "--quantize" in cmd and "--prefix-cache" in cmd
    assert "JAX_PLATFORMS" not in toy._spawn_env() or (
        toy._spawn_env()["JAX_PLATFORMS"]
        == __import__("os").environ.get("JAX_PLATFORMS"))
    with pytest.raises(ValueError, match="takes no device"):
        treplica.LocalReplicaManager("h:1", live_fn=lambda: [],
                                     device="cpu")


def _trace_shapes(tracer):
    """Each trace of the ring as its sorted (span, parent span) names."""
    by_trace = {}
    for sp in tracer.finished_spans():
        by_trace.setdefault(sp.trace_id, []).append(sp)
    shapes = set()
    for spans in by_trace.values():
        names = {sp.span_id: sp.name for sp in spans}
        shapes.add(tuple(sorted((sp.name, names.get(sp.parent_id))
                                for sp in spans)))
    return shapes


def _ttft_exemplars(registry):
    return dict(registry.histogram(
        "dlrover_serving_ttft_seconds", "request enqueue → first token",
        buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30),
    ).exemplars())


def _drill_observed(run, tracing_mod, registry_mod):
    tracing_mod.reset_tracer()
    before = _ttft_exemplars(registry_mod.get_registry())
    result = run()
    _assert_kill_drill(result, 24)
    after = _ttft_exemplars(registry_mod.get_registry())
    tracer = tracing_mod.get_tracer()
    routes = {sp.trace_id for sp in tracer.finished_spans()
              if sp.name == "serve.route"}
    fresh = {ex[0] for b, ex in after.items() if before.get(b) != ex}
    # the replicas answered with the router's trace ids
    assert fresh and fresh <= routes
    return _trace_shapes(tracer), set(result["journal"])


def test_trace_arcs_and_journal_kinds_match_in_both_wire_directions(
        monkeypatch, tmp_path):
    monkeypatch.setenv("DLROVER_TPU_TRACE_DIR", str(tmp_path))
    # the JAX drill (its router, master and autoscaler) over port replicas
    monkeypatch.setattr(jdrill, "LocalReplicaManager",
                        treplica.LocalReplicaManager)
    jax_side = _drill_observed(
        lambda: jdrill.run_serving_drill(replicas=2, backend="toy",
                                         num_requests=24),
        jtracing, jregistry)
    # the port's drill over JAX replicas
    monkeypatch.setattr(tdrill, "LocalReplicaManager",
                        jreplica.LocalReplicaManager)
    port_side = _drill_observed(
        lambda: tdrill.run_serving_drill(replicas=2, backend="toy",
                                         num_requests=24),
        ttracing, tregistry)
    assert port_side[0] == jax_side[0]
    assert (("serve.route", None),) in port_side[0]
    assert (("serve.scale", None),) in port_side[0]
    assert port_side[1] == jax_side[1]
    assert "trace_bundle_captured" in port_side[1]
