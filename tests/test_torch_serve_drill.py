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
"""

import pytest

pytest.importorskip("torch")

from dlrover_tpu.serving import drill as jdrill  # noqa: E402
from dlrover_tpu.serving import replica as jreplica  # noqa: E402

from dlrover_tpu_torch import chaos as tchaos  # noqa: E402
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
