"""The port's incident stitcher and timeline tracks against the reference's.

``stitch_journal_dict`` (each incident's ``to_dict()``, floats within
1e-9), ``IncidentStitcher``'s ``to_json`` and metric text, and every
track builder (``job_phase_events``, ``skew_track_events``,
``brain_track_events``, ``incident_track_events``,
``device_track_events``) give the reference's output on the same journal
dicts: hand-written training fault arcs, seeded random mixes of every
kind the builders read, and the journals of the port's CPU kill and
burst drills. The kill drill's master bundle holds the kill.
"""

import math

import numpy as np
import pytest

pytest.importorskip("torch")

from dlrover_tpu.observability import incidents as jinc  # noqa: E402
from dlrover_tpu.observability import timeline as jtl  # noqa: E402
from dlrover_tpu.observability.journal import (  # noqa: E402
    EventJournal as JaxJournal,
)
from dlrover_tpu.observability.registry import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)

from dlrover_tpu_torch import chaos as tchaos  # noqa: E402
from dlrover_tpu_torch.common.constants import ConfigKey  # noqa: E402
from dlrover_tpu_torch.observability import incidents as inc  # noqa: E402
from dlrover_tpu_torch.observability import timeline as tl  # noqa: E402
from dlrover_tpu_torch.observability.journal import (  # noqa: E402
    EventJournal,
)
from dlrover_tpu_torch.observability.registry import (  # noqa: E402
    MetricsRegistry,
)
from dlrover_tpu_torch.serving import drill as tdrill  # noqa: E402

BUILDERS = ("job_phase_events", "skew_track_events", "brain_track_events",
            "incident_track_events", "device_track_events")


def assert_close(a, b, path="$"):
    """Equal structures, floats within 1e-9."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), (
            path, a, b)
        assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9), (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def assert_same_as_reference(journal):
    ours = [i.to_dict() for i in inc.stitch_journal_dict(journal)]
    ref = [i.to_dict() for i in jinc.stitch_journal_dict(journal)]
    assert_close(ours, ref)
    for step_time in (None, 0.75):
        assert_close(
            [i.to_dict() for i in inc.stitch_journal_dict(journal,
                                                          step_time)],
            [i.to_dict() for i in jinc.stitch_journal_dict(journal,
                                                           step_time)])
    for name in BUILDERS:
        assert_close(getattr(tl, name)(journal), getattr(jtl, name)(journal),
                     name)
    return ours


def _event(seq, t, kind, source="master", **data):
    return {"seq": seq, "t": t, "ts": 1.7e9 + t, "kind": kind,
            "source": source, "data": data}


def _training_journal():
    """Two faults sharing one recovery, a reshard abort, a chain
    truncation, a pre-emptive save scored against the first fault, and a
    third fault left open."""
    ev = []

    def add(t, kind, **data):
        ev.append(_event(len(ev) + 1, t, kind, **data))

    add(1.0, "ckpt_committed", step=10, trigger="periodic", frames=2)
    add(2.0, "brain_action", action="preempt_ckpt", node_id=3,
        probability=0.81)
    add(2.5, "ckpt_committed", step=14, trigger="preemptive", frames=2)
    add(3.0, "fault_detected", node_id=3, status="failed", step=16,
        trace_id="abc123")
    add(3.2, "fault_detected", node_id=4, status="failed", step=16,
        trace_id="def456")
    add(3.5, "reshard_planned", round=2)
    add(3.6, "rdzv_start", round=2)
    add(4.0, "reshard_start")
    add(4.4, "reshard_aborted", reason="peer_lost")
    add(4.5, "reshard_replan_degraded", reason="planner")
    add(4.6, "ckpt_chain_truncated", reason="torn_link")
    add(5.0, "rdzv_complete", round=2)
    add(5.5, "restore_start")
    add(7.0, "restore_complete", medium="storage", step=14)
    add(7.2, "serve_replica_up", node_id=101)
    add(8.0, "recompile_start")
    add(9.0, "recompile_complete")
    add(9.1, "step_resumed", step=15)
    add(9.5, "fault_injected", site="rpc.send", fault="drop")
    add(11.0, "fault_detected", node_id=5, status="deleted", step=20)
    add(11.5, "rdzv_start", round=3)
    add(12.0, "restore_complete", medium="bogus_rung")
    return {"start_wall_ts": 1.7e9, "now_t": 13.0, "dropped": 0,
            "events": ev}


def test_training_journal_stitches_as_the_reference():
    incidents = assert_same_as_reference(_training_journal())
    assert [i["resolution"] for i in incidents] == [
        "resolved", "resolved", "unresolved"]
    assert incidents[0]["trace_id"] == "abc123"
    assert incidents[0]["rung"] == "storage"
    assert incidents[0]["rollback_steps"] == 2
    assert incidents[0]["counterfactual"]["hit"] is True
    assert incidents[2]["rung"] == "unknown"
    # the waterfall sums to the incident's detect → first step
    first = incidents[0]
    assert sum(first["phases"].values()) == pytest.approx(first["mttr_s"])


KINDS = (
    "fault_detected", "rdzv_start", "rdzv_complete", "restore_start",
    "restore_complete", "recompile_start", "recompile_complete",
    "step_resumed", "reshard_start", "reshard_complete", "reshard_aborted",
    "reshard_planned", "reshard_replan_degraded", "ckpt_chain_truncated",
    "fault_injected", "brain_action", "ckpt_committed",
    "serve_replica_up", "serve_replica_lost", "serve_rerouted",
    "straggler_detected", "hang_attributed", "brain_predicted_failure",
    "brain_predicted_ramp", "brain_predicted_straggler",
    "brain_prediction_scored", "brain_degraded", "brain_recovered",
    "memory_pressure", "memory_degraded", "recompile_storm",
    "brain_prescale_refused", "trace_bundle_captured",
)


def _random_journal(seed):
    rng = np.random.default_rng(seed)
    ev, t = [], 0.0
    for i in range(int(rng.integers(5, 60))):
        t += float(rng.exponential(0.5))
        kind = KINDS[int(rng.integers(len(KINDS)))]
        data = {}
        if rng.random() < 0.7:
            data["node_id"] = int(rng.integers(0, 4))
        if rng.random() < 0.6:
            data["step"] = int(rng.integers(0, 40))
        if kind == "restore_complete":
            data["medium"] = str(rng.choice(["shm", "storage", "chain",
                                             "replica", "nope"]))
        if kind == "ckpt_committed":
            data["trigger"] = str(rng.choice(["periodic", "preemptive"]))
        if kind == "brain_action":
            data.update(action=str(rng.choice(["preempt_ckpt", "scale"])),
                        probability=float(rng.random()))
        if kind in ("straggler_detected",):
            data.update(rank=int(rng.integers(0, 8)),
                        ratio=float(rng.uniform(1, 3)), cause="compute")
        if kind == "memory_pressure":
            data.update(category="kv_cache",
                        headroom_frac=float(rng.random()))
        if kind in ("reshard_aborted", "reshard_replan_degraded",
                    "ckpt_chain_truncated", "memory_degraded"):
            data["reason"] = str(rng.choice(["a", "b"]))
        if kind == "fault_detected" and rng.random() < 0.5:
            data["trace_id"] = f"{int(rng.integers(1 << 30)):x}"
        # out-of-order stamps happen: reported events land late
        ev.append(_event(i + 1, t - float(rng.uniform(0, 0.2)), kind,
                         **data))
    return {"start_wall_ts": 1.7e9, "now_t": t + 1.0, "dropped": 0,
            "events": ev}


@pytest.mark.parametrize("seed", range(8))
def test_random_journals_stitch_and_draw_as_the_reference(seed):
    assert_same_as_reference(_random_journal(seed))


def test_journals_recorded_by_both_journals_agree():
    """The same kinds recorded through each package's EventJournal give
    the same phase tracks (the port journal's state machine is the
    reference's)."""
    ours, ref = EventJournal(), JaxJournal()
    for kind, data in (("fault_detected", {"node_id": 1}),
                       ("rdzv_start", {}), ("restore_complete",
                                            {"medium": "shm", "step": 3}),
                       ("trace_bundle_captured", {"reason": "node_fault"}),
                       ("serve_prefix_hit", {"matched": 16}),
                       ("step_resumed", {"step": 4})):
        a, b = ours.record(kind, **data), ref.record(kind, **data)
        b["t"], b["ts"] = a["t"], a["ts"]
    now = ours.now()
    dump_ours = {"now_t": now, "events": ours.events()}
    dump_ref = {"now_t": now, "events": ref.events()}
    assert_close(dump_ours, dump_ref)
    assert ours.current_phase() == ref.current_phase() == "productive"
    assert_same_as_reference(dump_ours)


def test_incident_stitcher_json_and_metrics_match_the_reference():
    journal = _training_journal()

    class Frozen:
        def events(self):
            return journal["events"]

        def now(self):
            return journal["now_t"]

    texts, dumps = [], []
    for mod, reg in ((inc, MetricsRegistry()), (jinc, JaxRegistry())):
        st = mod.IncidentStitcher(Frozen(), step_time_fn=lambda: 0.5)
        st.attach_metrics(reg)
        texts.append(reg.render())
        dumps.append(st.to_json())
    assert texts[0] == texts[1]
    assert 'dlrover_incident_total{resolution="resolved"} 2' in texts[0]
    assert dumps[0] == dumps[1]
    # the port's hook comes back for removal
    reg = MetricsRegistry()
    hook = inc.IncidentStitcher(Frozen()).attach_metrics(reg)
    reg.remove_collect_hook(hook)
    assert reg._hooks == []


@pytest.fixture()
def drill_env(tmp_path, monkeypatch):
    monkeypatch.setenv(ConfigKey.TRACE_DIR, str(tmp_path / "bundles"))
    tchaos.reset_injector()
    yield
    tchaos.reset_injector()


def test_kill_drill_journal_stitches_and_draws_as_the_reference(drill_env):
    result = tdrill.run_serving_drill(replicas=2, backend="toy",
                                      num_requests=24)
    assert result["lost"] == 0 and result["replicas_restored"]
    journal = result["journal_dump"]
    kinds = {e["kind"] for e in journal["events"]}
    assert {"serve_replica_up", "serve_replica_lost", "serve_rerouted",
            "fault_injected", "trace_bundle_captured"} <= kinds
    # a replica's loss opens no training incident, as in the reference
    assert assert_same_as_reference(journal) == []
    # the master's node_fault bundle of the kill
    bundle = result["node_fault_bundle"]
    assert bundle is not None
    assert bundle["manifest"]["node_id"] == result["killed_node"]
    assert bundle["manifest"]["role"] == "serve"
    assert bundle["victim_lost"] and bundle["incidents"] == []
    # the start order: every registration, the replacement warm-starts
    # from nobody (toy engines serve no weights)
    order = result["start_order"]
    # either first replica may register first (ROADMAP C12)
    assert sorted(o["node_id"] for o in order) == [100, 101, 102]
    assert order[-1]["node_id"] == 102
    assert all(o["warm_start_from"] is None for o in order)
    times = [o["registered_t"] for o in order]
    assert times == sorted(times)
    # every live replica answered its /metrics, equal to its last beat
    scrapes = result["replica_scrapes"]
    assert len(scrapes) == 2
    for row in scrapes.values():
        assert row["error"] is None
        assert row["steps"] == row["beat_steps"]
        assert row["launches"] == row["beat_launches"] == 0


def test_burst_drill_journal_stitches_and_draws_as_the_reference(
        drill_env, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SERVE_TTFT_SLO_S", "0.011")
    result = tdrill.run_traffic_drill(seed=5, ttft_slo_s=30.0)
    assert result["lost"] == 0
    journal = result["journal_dump"]
    assert {"serve_scale", "slo_burn_alert"} <= {
        e["kind"] for e in journal["events"]}
    assert assert_same_as_reference(journal) == []
    assert result["replica_scrapes"]
    for row in result["replica_scrapes"].values():
        assert row["error"] is None
        assert row["steps"] == row["beat_steps"]
