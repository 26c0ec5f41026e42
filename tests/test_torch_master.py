"""The port's training control plane against the JAX package's, module by
module, on the same seeded inputs in one process: the rendezvous manager,
the dataset splitters, the shard ledger, the job manager, the hang rule,
the fault injector and the goodput analysis. Clocks are injected (each
module's ``time`` replaced by one fake clock), so both sides see the same
timeline. Every comparison is exact: these are control-plane decisions,
not arithmetic.
"""

import json
import random
import time
import types

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from dlrover_tpu.chaos import injector as jax_injector  # noqa: E402
from dlrover_tpu.common import comm as jax_comm  # noqa: E402
from dlrover_tpu.common import config as jax_config  # noqa: E402
from dlrover_tpu.common import event as jax_event  # noqa: E402
from dlrover_tpu.common import node as jax_node  # noqa: E402
from dlrover_tpu.diagnosis import diagnosis_master as jax_diag  # noqa: E402
from dlrover_tpu.master import dataset_splitter as jax_split  # noqa: E402
from dlrover_tpu.master import job_manager as jax_jm  # noqa: E402
from dlrover_tpu.master import perf_monitor as jax_perf  # noqa: E402
from dlrover_tpu.master import rdzv_manager as jax_rdzv  # noqa: E402
from dlrover_tpu.master import task_manager as jax_tm  # noqa: E402

from dlrover_tpu_torch.chaos import injector as pt_injector  # noqa: E402
from dlrover_tpu_torch.common import comm as pt_comm  # noqa: E402
from dlrover_tpu_torch.common import config as pt_config  # noqa: E402
from dlrover_tpu_torch.common import event as pt_event  # noqa: E402
from dlrover_tpu_torch.common import node as pt_node  # noqa: E402
from dlrover_tpu_torch.diagnosis import diagnosis_master as pt_diag  # noqa: E402
from dlrover_tpu_torch.master import dataset_splitter as pt_split  # noqa: E402
from dlrover_tpu_torch.master import job_manager as pt_jm  # noqa: E402
from dlrover_tpu_torch.master import perf_monitor as pt_perf  # noqa: E402
from dlrover_tpu_torch.master import rdzv_manager as pt_rdzv  # noqa: E402
from dlrover_tpu_torch.master import task_manager as pt_tm  # noqa: E402

SIDES = ("jax", "port")


class FakeClock:
    """``time.monotonic`` and ``time.time`` on one advancing counter."""

    def __init__(self, start: float = 1000.0):
        self.now = start

    def monotonic(self) -> float:
        return self.now

    def time(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.now += s

    def advance(self, s: float) -> None:
        self.now += s


def _install_clock(monkeypatch, modules, clock):
    fake = types.SimpleNamespace(monotonic=clock.monotonic, time=clock.time,
                                 sleep=clock.sleep)
    for mod in modules:
        monkeypatch.setattr(mod, "time", fake)


@pytest.fixture()
def contexts():
    """Fresh config singletons on both sides, reset afterwards."""
    jax_config.Context.reset()
    pt_config.Context.reset()
    yield jax_config.get_context(), pt_config.get_context()
    jax_config.Context.reset()
    pt_config.Context.reset()


# -- rendezvous ------------------------------------------------------------


def _meta(mod, rank):
    return mod.NodeMeta(node_id=rank, node_rank=rank,
                        host=f"10.0.0.{rank}", local_world_size=1,
                        free_port=9000 + rank)


def _world(world):
    return {r: (m.node_id, m.node_rank, m.host, m.free_port, m.comm_rank)
            for r, m in world.items()}


_RDZV_OP = st.one_of(
    st.tuples(st.just("join"), st.integers(0, 5)),
    st.tuples(st.just("remove"), st.integers(0, 5)),
    st.tuples(st.just("advance"), st.floats(0.0, 2.0)),
    st.tuples(st.just("waiting"), st.just(0)),
    st.tuples(st.just("world"), st.integers(0, 5)),
)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(min_nodes=st.integers(1, 3), extra=st.integers(0, 3),
       node_unit=st.integers(1, 2), lastcall=st.floats(0.1, 1.5),
       ops=st.lists(_RDZV_OP, min_size=1, max_size=40))
def test_rendezvous_same_rounds_worlds_coordinators_and_waiting(
        monkeypatch, contexts, min_nodes, extra, node_unit, lastcall, ops):
    """Mirrors tests/test_rdzv_manager.py on random sequences: the world
    cut at max_nodes or after the last call, node-unit truncation, the
    coordinator of comm rank 0 and the immediate shrink after a known
    death, with one injected clock on both managers."""
    clock = FakeClock()
    _install_clock(monkeypatch, (jax_rdzv, pt_rdzv), clock)
    managers = {"jax": jax_rdzv.ElasticTrainingRendezvousManager(),
                "port": pt_rdzv.ElasticTrainingRendezvousManager()}
    metas = {"jax": jax_comm, "port": pt_comm}
    for m in managers.values():
        m.update_rdzv_params(min_nodes, min_nodes + extra,
                             waiting_timeout=lastcall, node_unit=node_unit)
    for op, arg in ops:
        got = {}
        for side, m in managers.items():
            if op == "join":
                got[side] = m.join_rendezvous(_meta(metas[side], arg))
            elif op == "remove":
                got[side] = m.remove_alive_node(arg)
            elif op == "waiting":
                got[side] = m.num_nodes_waiting()
            elif op == "world":
                rnd, group, world = m.get_comm_world(arg)
                got[side] = (rnd, group, _world(world),
                             m.coordinator_addr() if world else "")
        if op == "advance":
            clock.advance(arg)
        assert got.get("jax") == got.get("port"), (op, arg, got)
    assert (managers["jax"].rdzv_round == managers["port"].rdzv_round)


def test_rendezvous_immediate_shrink_after_known_death(monkeypatch,
                                                       contexts):
    clock = FakeClock()
    _install_clock(monkeypatch, (jax_rdzv, pt_rdzv), clock)
    out = {}
    for side, rdzv, mod in (("jax", jax_rdzv, jax_comm),
                            ("port", pt_rdzv, pt_comm)):
        m = rdzv.ElasticTrainingRendezvousManager()
        m.update_rdzv_params(1, 2, waiting_timeout=30.0)
        m.join_rendezvous(_meta(mod, 0))
        m.join_rendezvous(_meta(mod, 1))
        first = sorted(m.get_comm_world(0)[2])
        m.remove_alive_node(1)
        m.join_rendezvous(_meta(mod, 0))
        shrunk = sorted(m.get_comm_world(0)[2])
        m.join_rendezvous(_meta(mod, 1))
        m.join_rendezvous(_meta(mod, 0))
        back = sorted(m.get_comm_world(0)[2])
        out[side] = (first, shrunk, back, m.coordinator_addr())
    assert out["jax"] == out["port"] == (
        [0, 1], [0], [0, 1], "10.0.0.0:9000")


# -- splitters -------------------------------------------------------------


def _shards(shards):
    return [(s.name, s.start, s.end, list(s.record_indices or []))
            for s in shards]


@pytest.mark.parametrize("splitter", ["batch", "text", "streaming"])
@settings(max_examples=40, deadline=None)
@given(size=st.integers(0, 200), batch=st.integers(1, 16),
       minibatches=st.integers(1, 4), epochs=st.integers(1, 3),
       shuffle=st.booleans(), seed=st.integers(0, 2**31 - 1))
def test_splitters_give_identical_shards(splitter, size, batch, minibatches,
                                         epochs, shuffle, seed):
    shards = {}
    for side, split, comm in (("jax", jax_split, jax_comm),
                              ("port", pt_split, pt_comm)):
        params = comm.DatasetShardParams(
            batch_size=batch, num_epochs=epochs, dataset_size=size,
            shuffle=shuffle, num_minibatches_per_shard=minibatches,
            dataset_name="ds", splitter=splitter)
        sp = split.DatasetSplitter.build(params)
        random.seed(seed)
        out = []
        while not sp.epoch_finished():
            got = sp.create_shards()
            out.append(_shards(got))
            if not got:
                break
        shards[side] = (type(sp).__name__, sp.epoch, out)
    assert shards["jax"] == shards["port"]


# -- the shard ledger ------------------------------------------------------


def _task(t):
    if t is None:
        return None
    s = t.shard
    return (t.task_id, t.task_type, t.dataset_name,
            None if s is None else (s.name, s.start, s.end,
                                    list(s.record_indices or [])))


def _managers(contexts, clock, lease_s=10.0):
    for ctx in contexts:
        ctx.set("shard_lease_timeout_s", lease_s)
    return {"jax": jax_tm.TaskManager(monotonic=clock.monotonic),
            "port": pt_tm.TaskManager(monotonic=clock.monotonic)}


_TASK_OP = st.one_of(
    st.tuples(st.just("get"), st.integers(0, 2)),
    st.tuples(st.just("ok"), st.integers(0, 2)),
    st.tuples(st.just("fail"), st.integers(0, 2)),
    st.tuples(st.just("recover"), st.integers(0, 2)),
    st.tuples(st.just("advance"), st.floats(0.0, 8.0)),
    st.tuples(st.just("leases"), st.just(0)),
    st.tuples(st.just("ckpt"), st.just(0)),
)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(size=st.integers(1, 60), shuffle=st.booleans(),
       splitter=st.sampled_from(["batch", "text"]),
       seed=st.integers(0, 1000),
       ops=st.lists(_TASK_OP, min_size=1, max_size=50))
def test_task_manager_same_tasks_and_checkpoints(contexts, size, shuffle,
                                                 splitter, seed, ops):
    """One op sequence (get, report ok/fail, recover_tasks, check_leases
    on an injected clock, the shard checkpoint) gives the same tasks,
    verdicts and checkpoint JSON."""
    clock = FakeClock()
    managers = _managers(contexts, clock)
    comms = {"jax": jax_comm, "port": pt_comm}
    for side, tm in managers.items():
        random.seed(seed)
        tm.new_dataset(comms[side].DatasetShardParams(
            batch_size=3, num_epochs=2, dataset_size=size, shuffle=shuffle,
            num_minibatches_per_shard=1, dataset_name="ds",
            splitter=splitter))
    held = {0: [], 1: [], 2: []}
    for i, (op, arg) in enumerate(ops):
        got = {}
        for side, tm in managers.items():
            # an epoch's shuffle runs lazily in get_task: each side draws
            # from the same global random state
            random.seed(seed * 1000 + i)
            if op == "get":
                got[side] = _task(tm.get_task(arg, "ds"))
            elif op in ("ok", "fail") and held[arg]:
                # the reference's report_task_result is its ack_task
                # without the verdict
                report = (tm.ack_task if side == "jax"
                          else tm.report_task_result)
                got[side] = report("ds", held[arg][0], arg, op == "ok")
            elif op == "recover":
                tm.recover_tasks(arg)
            elif op == "leases":
                got[side] = tm.check_leases()
            elif op == "ckpt":
                got[side] = tm.get_shard_checkpoint("ds")
            got[side + "_done"] = (tm.finished("ds"),
                                   tm.completed_count("ds"))
        if op == "advance":
            clock.advance(arg)
        if op == "get" and got["jax"] is not None:
            held[arg].append(got["jax"][0])
        if op in ("ok", "fail") and held[arg]:
            held[arg].pop(0)
        assert got.get("jax") == got.get("port"), (op, arg, got)
        assert got["jax_done"] == got["port_done"]
    assert (managers["jax"].get_shard_checkpoint("ds")
            == managers["port"].get_shard_checkpoint("ds"))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_shard_checkpoint_restores_across_packages(contexts, direction):
    """A checkpoint taken on one side and restored into the other gives
    the same next tasks as restoring it on its own side."""
    clock = FakeClock()
    comms = {"jax": jax_comm, "port": pt_comm}
    src_side, dst_side = (("port", "jax") if direction == "port_to_jax"
                          else ("jax", "port"))

    def fresh(side):
        tm = _managers(contexts, clock)[side]
        random.seed(7)
        tm.new_dataset(comms[side].DatasetShardParams(
            batch_size=4, num_epochs=2, dataset_size=50, shuffle=True,
            num_minibatches_per_shard=1, dataset_name="ds",
            splitter="text"))
        return tm

    src = fresh(src_side)
    t0 = src.get_task(0, "ds")
    t1 = src.get_task(1, "ds")
    src.report_task_result("ds", t0.task_id, 0, True)
    src.get_task(0, "ds")
    content = src.get_shard_checkpoint("ds")
    nexts = {}
    for side in (src_side, dst_side):
        tm = fresh(side)
        tm.restore_shard_checkpoint(content)
        report = (tm.ack_task if side == "jax" else tm.report_task_result)
        out = []
        while True:
            t = tm.get_task(2, "ds")
            if t is None:
                break
            out.append(_task(t))
            report("ds", t.task_id, 2, True)
        # the acked anchor survived: a late report of t0 is a duplicate
        out.append(report("ds", t0.task_id, 0, True))
        out.append(report("ds", t1.task_id, 1, True))
        nexts[side] = out
    assert nexts[src_side] == nexts[dst_side]
    assert nexts[dst_side][-2] == "duplicate"


# -- the job manager ---------------------------------------------------------


def _action(a):
    return (a.action_type, a.instance, a.reason, dict(a.data))


def test_job_manager_heartbeat_timeout_and_failure_timeline(monkeypatch,
                                                            contexts):
    """Heartbeats, a heartbeat timeout, a released node coming back and
    a fatal failure: the same statuses, failure events and delivered
    actions."""
    for ctx in contexts:
        ctx.set("heartbeat_timeout_s", 30.0)
    clock = FakeClock()
    _install_clock(monkeypatch, (jax_jm, pt_jm, jax_node, pt_node), clock)
    out = {}
    for side, jm_mod in (("jax", jax_jm), ("port", pt_jm)):
        jm = jm_mod.JobManager("job", 3, min_nodes=2)
        events = []
        jm.add_event_callback(
            lambda e, ev=events: ev.append((e.node.id, e.node.status,
                                            e.node.exit_reason)))
        jm.start()
        log = []
        for nid in range(3):
            log.append(_action(jm.report_heartbeat(nid, clock.time())))
        clock.advance(10.0)
        for nid in (0, 1):
            jm.report_heartbeat(nid, clock.time())
        clock.advance(25.0)
        jm.check_heartbeats()  # node 2 silent for 35 s: failed, released
        log.append([(n.id, n.status, n.is_released, n.exit_reason)
                    for n in jm.list_nodes()])
        # node 2 returns and is readmitted
        log.append(_action(jm.report_heartbeat(2, clock.time())))
        log.append(jm.nodes[2].status)
        # a broadcast and a targeted action
        jm.enqueue_action(jm_mod.DiagnosisAction(
            "restart_worker", instance=-2, reason="hang",
            data={"wedged": True}))
        jm.enqueue_action(jm_mod.DiagnosisAction(
            "restart_worker", instance=1, reason="peer"))
        for nid in (0, 1, 1, 2, 0):
            log.append(_action(jm.report_heartbeat(nid, clock.time())))
        # a fatal failure below min_nodes aborts the job
        jm.report_failure(0, "boom", "process_error", 0)
        jm.update_node_status(0, "failed")
        jm.report_failure(1, "boom", "process_error", 0)
        jm.update_node_status(1, "failed")
        log.append(jm.job_stage)
        log.append(_action(jm.report_heartbeat(2, clock.time())))
        jm.stop()
        out[side] = (log, events)
    assert out["jax"] == out["port"]
    assert out["port"][0][-2] == "failed"


def test_job_manager_connection_drop_grace(contexts):
    """A dropped heartbeat connection fails a silent node after the grace
    and spares one that re-contacts (real clock, short grace)."""
    for ctx in contexts:
        ctx.set("conn_drop_grace_s", 0.2)
        ctx.set("heartbeat_interval_s", 0.05)
    out = {}
    for side, jm_mod in (("jax", jax_jm), ("port", pt_jm)):
        jm = jm_mod.JobManager("job", 3, min_nodes=1)
        events = []
        jm.add_event_callback(
            lambda e, ev=events: ev.append((e.node.id, e.node.status)))
        for nid in range(3):
            jm.report_heartbeat(nid, time.time())
        jm.report_connection_lost(1)
        jm.report_connection_lost(2)
        time.sleep(0.05)
        jm.report_heartbeat(2, time.time())  # re-contact inside the grace
        time.sleep(0.5)
        out[side] = ([(n.id, n.status, n.is_released, n.exit_reason)
                      for n in jm.list_nodes()], events,
                     [_action(jm.report_heartbeat(n, time.time()))
                      for n in (0, 2)])
        jm.stop()
    assert out["jax"] == out["port"]
    assert out["port"][0][1][1:] == ("failed", True, "no_heartbeat")


# -- the hang rule -----------------------------------------------------------


def test_hang_rule_same_observations_and_actions(monkeypatch, contexts):
    """PerfMonitor and the hang rule on one step timeline: no action
    before hang_downtime_s, none right after a re-rendezvous, a wedged
    RESTART_WORKER broadcast after a stall, an observe-only event when
    the restart is off."""
    for ctx in contexts:
        ctx.set("hang_downtime_s", 20.0)
        ctx.set("hang_restart_workers", True)
    clock = FakeClock()
    _install_clock(monkeypatch, (jax_perf, pt_perf, jax_diag, pt_diag),
                   clock)
    out = {}
    for side, perf, diag in (("jax", jax_perf, jax_diag),
                             ("port", pt_perf, pt_diag)):
        pm = perf.PerfMonitor()
        rule = diag.TrainingHangDiagnostician(pm, {})
        log = []

        def probe():
            ob = rule.observe()
            act = rule.diagnose()
            log.append((ob.problem, dict(ob.data), _action(act)))

        probe()  # no steps yet
        for step in range(1, 6):
            clock.advance(2.0)
            pm.collect_global_step(step, clock.time(), rdzv_round=1)
            probe()
        clock.advance(19.0)
        probe()  # 19 s stalled: below the downtime
        clock.advance(2.0)
        probe()  # 21 s: hang
        pm.reset_running_speed_monitor(min_round=2)  # a re-rendezvous
        probe()
        pm.collect_global_step(9, clock.time(), rdzv_round=1)  # stale
        clock.advance(30.0)
        probe()
        pm.collect_global_step(6, clock.time(), rdzv_round=2)
        clock.advance(25.0)
        contexts[SIDES.index(side)].set("hang_restart_workers", False)
        probe()
        log.append(pm.completed_global_step)
        out[side] = log
    assert out["jax"] == out["port"]
    kinds = [entry[0] for entry in out["port"][:-1]]
    assert kinds == ["", "", "", "", "", "", "", "training_hang", "", "",
                     "training_hang"]
    assert out["port"][7][2] == ("restart_worker", -2, "training hang",
                                 {"wedged": True})
    assert out["port"][-2][2][0] == "event"


# -- the fault injector ------------------------------------------------------

GRAMMAR = [
    "rpc.send:drop@p=0.05",
    "rpc.recv:delay=2s",
    "rpc.recv:delay=2s@p=0.1",
    "shm.write:torn@step=3",
    "shm.write:bitflip@nth=2",
    "kv.wait:partition@t=10s..25s",
    "rpc.send:partition@t=5s..20s",
    "rdzv.join:error@every=3,times=2",
    "storage.*:delay=250ms@p=0.5",
    "data.dispatch:drop@nth=4;shm.write:torn@step=6",
]


def _rules(rules):
    return [(r.site, r.kind, r.p, r.nth, r.every, r.step, r.times,
             r.window, r.dur) for r in rules]


@pytest.mark.parametrize("text", GRAMMAR + [json.dumps([
    {"site": "rpc.send", "kind": "drop", "p": 0.3},
    {"site": "shm.write", "kind": "bitflip", "step": 4, "times": 1},
    {"site": "kv.wait", "kind": "partition", "t": [1, 2]},
])])
def test_injector_parses_the_grammar_alike(text):
    assert (_rules(jax_injector.parse_schedule(text))
            == _rules(pt_injector.parse_schedule(text)))


def test_injector_rejects_bad_rules_alike():
    for bad in ("rpc.send", "rpc.send:melt", "x:drop@q=1", "x:drop@t=5s"):
        for mod in (jax_injector, pt_injector):
            with pytest.raises(ValueError):
                mod.parse_schedule(bad)


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_injector_same_decisions_and_actions(monkeypatch, seed):
    """One seeded call sequence: the same decision log, raises and action
    dicts (delays advance a fake clock instead of sleeping)."""
    schedule = ("rpc.send:drop@p=0.3;rpc.recv:delay=1s@every=3;"
                "shm.write:torn@step=6;shm.write:bitflip@p=0.5,times=2;"
                "kv.wait:partition@t=5s..8s;rdzv.join:error@nth=2;"
                "data.dispatch:drop@p=0.2")
    calls = [("rpc.send", {}), ("rpc.recv", {}), ("shm.write", {"step": 6}),
             ("shm.write", {"step": 5}), ("kv.wait", {"key": "k"}),
             ("rdzv.join", {}), ("data.dispatch", {"task_id": 1})] * 6
    out = {}
    for side, mod in (("jax", jax_injector), ("port", pt_injector)):
        clock = FakeClock()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=clock.monotonic, time=clock.time, sleep=clock.sleep))
        inj = mod.FaultInjector(mod.parse_schedule(schedule), seed=seed,
                                schedule_text=schedule)
        reported = []
        inj.set_reporter(reported.append)
        log = []
        for i, (site, ctx) in enumerate(calls):
            clock.advance(0.25)
            try:
                log.append(("ok", inj.fire(site, **ctx)))
            except ConnectionError as e:
                log.append(("conn", str(e)))
            except RuntimeError as e:
                log.append(("err", str(e)))
        out[side] = (log, list(inj.decisions), reported, inj.describe())
    assert out["jax"] == out["port"]
    assert out["port"][1]


# -- goodput -----------------------------------------------------------------


def _rec(ts, name, phase, eid):
    return {"ts": ts, "target": "worker_0", "name": name, "phase": phase,
            "event_id": eid, "content": {}}


@pytest.mark.parametrize("case", ["plain", "overlap", "unterminated",
                                  "empty"])
def test_compute_goodput_alike(case):
    train = "train#training"
    records = {
        "plain": [_rec(0.0, train, "BEGIN", 1), _rec(4.0, train, "END", 1),
                  _rec(10.0, "agent#restart", "INSTANT", 2)],
        "overlap": [_rec(0.0, train, "BEGIN", 1), _rec(1.0, train, "BEGIN", 2),
                    _rec(3.0, train, "END", 1), _rec(5.0, train, "END", 2),
                    _rec(6.0, train, "BEGIN", 3), _rec(8.0, train, "END", 3)],
        # a crash inside the first span: unproductive from its BEGIN
        "unterminated": [_rec(0.0, train, "BEGIN", 1),
                         _rec(2.0, train, "BEGIN", 2),
                         _rec(3.0, train, "END", 2),
                         _rec(9.0, "agent#restart", "INSTANT", 3)],
        "empty": [],
    }[case]
    want = jax_event.compute_goodput(records)
    assert pt_event.compute_goodput(records) == want


def test_load_events_skips_a_torn_tail(tmp_path):
    path = tmp_path / "events.jsonl"
    path.write_text(json.dumps(_rec(1.0, "train#training", "BEGIN", 1))
                    + "\n\n" + '{"ts": 2.0, "na')
    assert pt_event.load_events(str(path)) == jax_event.load_events(
        str(path))
    assert len(pt_event.load_events(str(path))) == 1
