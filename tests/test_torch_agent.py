"""The port's elastic agent and sharding clients, against the JAX
package's and across the two packages' wires.

- ``_worker_env`` of the port's agent equals the JAX agent's for the same
  configuration, but for the shm incarnation nonce and the package path;
- ``ShardingClient`` / ``IndexShardingClient`` consume every record once
  and requeue a dead worker's shard, against the JAX master and against
  the port's (mirrors ``tests/test_data.py:79-183``);
- real agents, masters and worker subprocesses (mirrors
  ``tests/test_e2e_agent.py:66-140``): one worker to the end, a crash →
  restart → resume, an exhausted restart budget, two agents at world 2;
- the port's agent against a JAX master (``--master-addr``), and the JAX
  agent running the port's twin against the port's master;
- a worker's SIGABRT is node-level, as in the reference, unless another
  rank or node failed in the same round; the agent's saver persists the
  steps of a restarted incarnation that restored an older step.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from dlrover_tpu.agent.config import ElasticLaunchConfig as JaxConfig  # noqa: E402,E501
from dlrover_tpu.agent.master_client import MasterClient as JaxClient  # noqa: E402,E501
from dlrover_tpu.agent.training import ElasticTrainingAgent as JaxAgent  # noqa: E402,E501
from dlrover_tpu.master.master import LocalJobMaster as JaxMaster  # noqa: E402

from dlrover_tpu_torch.agent.config import ElasticLaunchConfig  # noqa: E402
from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.agent.training import (  # noqa: E402
    ElasticTrainingAgent,
)
from dlrover_tpu_torch.ckpt.ckpt_saver import AsyncCheckpointSaver  # noqa: E402
from dlrover_tpu_torch.common import comm  # noqa: E402
from dlrover_tpu_torch.common.constants import (  # noqa: E402
    DiagnosisActionType,
    EnvKey,
    RendezvousName,
)
from dlrover_tpu_torch.common.multi_process import (  # noqa: E402
    LocalIPCServer,
    unlink_shared_memory,
)
from dlrover_tpu_torch.diagnosis.action import DiagnosisAction  # noqa: E402
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402
from dlrover_tpu_torch.trainer.data import (  # noqa: E402
    ElasticDataLoader,
    IndexShardingClient,
    ShardingClient,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "data", "torch_elastic_train.py")
TWIN = os.path.join(REPO, "examples", "llama_elastic_pretrain_torch.py")


def _unlink_job(job):
    for name in os.listdir("/dev/shm"):
        if name.startswith(f"dlrtpu_{job}_"):
            unlink_shared_memory(name)


@pytest.fixture()
def job():
    name = f"ta{os.getpid()}{threading.get_ident() % 1000}"
    yield name
    _unlink_job(name)


def _subprocess_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.update({"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
                "JAX_PLATFORMS": "cpu", "DLROVER_TPU_LOG_LEVEL": "WARNING"})
    return env


# -- the worker environment --------------------------------------------------


def test_worker_env_matches_the_jax_agent(job):
    """Same keys and values, the shm incarnation nonce and the package
    path aside (both agents put the repository root on PYTHONPATH)."""
    fields = dict(min_nodes=1, max_nodes=2, nproc_per_node=2, node_rank=1,
                  node_id=1, job_name=job, master_addr="127.0.0.1:1",
                  max_restarts=3, entrypoint=SCRIPT, args=["a", "b"],
                  worker_env={"EXTRA": "1"}, ckpt_replica=2)
    envs = {}
    for side, cfg_cls, agent_cls, client_cls, extra in (
            ("jax", JaxConfig, JaxAgent, JaxClient, {"warm_spawn": False}),
            ("port", ElasticLaunchConfig, ElasticTrainingAgent,
             MasterClient, {})):
        cfg = cfg_cls(**fields, **extra)
        agent = agent_cls(cfg, client_cls(cfg.master_addr, 1, 1))
        try:
            from dlrover_tpu_torch.common.comm import NodeMeta

            agent._world = {0: NodeMeta(), 1: NodeMeta()}
            agent._current_round = 4
            agent._restart_count = 2
            envs[side] = agent._worker_env(1, 3, 4, "10.0.0.1:5555")
        finally:
            agent._ipc_server.stop()
    for env in envs.values():
        env.pop(EnvKey.SHM_INCARNATION)
    assert envs["jax"]["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert envs["port"]["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert envs["jax"] == envs["port"]
    assert envs["port"][EnvKey.RANK] == "3"
    assert envs["port"][EnvKey.RESTART_COUNT] == "2"
    assert envs["port"]["EXTRA"] == "1"


# -- sharding clients against either master ----------------------------------


@pytest.fixture(params=["jax", "port"])
def master(request):
    m = (JaxMaster if request.param == "jax" else LocalJobMaster)(
        job_name=f"shard{request.param}", node_num=2, min_nodes=1,
        max_nodes=2)
    m.prepare()
    yield m
    m.stop()


def test_sharding_client_consumes_all_records(master):
    client = ShardingClient(MasterClient(master.addr, 0), "ds1",
                            batch_size=4, dataset_size=40,
                            num_minibatches_per_shard=2)
    seen = []
    while True:
        shard = client.fetch_shard()
        if shard is None:
            break
        seen.extend(range(shard.start, shard.end))
        client.report_task_done()
    assert sorted(seen) == list(range(40))


def test_index_sharding_client_batches(master):
    client = IndexShardingClient(MasterClient(master.addr, 0), "ds2",
                                 batch_size=4, dataset_size=20)
    flat = []
    while True:
        idxs = client.fetch_batch_indices(4)
        if idxs is None:
            break
        flat.extend(idxs)
    assert sorted(flat) == list(range(20))


def test_failed_worker_shard_requeued(master):
    client = ShardingClient(MasterClient(master.addr, 0), "ds3",
                            batch_size=2, dataset_size=8,
                            num_minibatches_per_shard=1)
    assert client.fetch_shard() is not None
    # node 0 dies without reporting; the master requeues its shard
    master.task_manager.recover_tasks(0)
    client1 = ShardingClient(MasterClient(master.addr, 1), "ds3",
                             batch_size=2, dataset_size=8,
                             num_minibatches_per_shard=1)
    seen = []
    while True:
        shard = client1.fetch_shard()
        if shard is None:
            break
        seen.extend(range(shard.start, shard.end))
        client1.report_task_done()
    assert sorted(seen) == list(range(8))


def test_shard_checkpoint_round_trips(master):
    client = ShardingClient(MasterClient(master.addr, 0), "ds5",
                            batch_size=2, dataset_size=12,
                            num_minibatches_per_shard=1)
    client.fetch_shard()
    client.report_task_done()
    content = client.shard_checkpoint()
    rest = []
    while (shard := client.fetch_shard()) is not None:
        rest.append((shard.start, shard.end))
        client.report_task_done()
    client.restore_shard_checkpoint(content)
    again = []
    while (shard := client.fetch_shard()) is not None:
        again.append((shard.start, shard.end))
        client.report_task_done()
    assert again == rest and len(rest) == 5


def test_dataloader_sharded_end_to_end(master):
    import numpy as np

    data = [{"y": np.int32(i)} for i in range(24)]
    sharding = IndexShardingClient(MasterClient(master.addr, 0), "ds4",
                                   batch_size=6, dataset_size=24)
    batches = list(ElasticDataLoader(data, batch_size=6,
                                     sharding_client=sharding))
    assert len(batches) == 4
    assert sorted(int(y) for b in batches for y in b["y"]) == list(
        range(24))
    with pytest.raises(ValueError):
        ElasticDataLoader(data, 6, sampler=object(),
                          sharding_client=sharding)


# -- agents, masters and workers end to end ----------------------------------


def _run_agent(job, tmp_path, crash_step=-1, max_restarts=3,
               worker_env=None, save_at_breakpoint=True, ckpt=True):
    master = LocalJobMaster(job_name=job, node_num=1)
    master.prepare()
    ckpt_dir = str(tmp_path / "ckpt")
    out_file = str(tmp_path / "out.txt")
    env = {"CRASH_AT_STEP": str(crash_step), **(worker_env or {})}
    config = ElasticLaunchConfig(
        min_nodes=1, max_nodes=1, nproc_per_node=1, job_name=job,
        master_addr=master.addr, max_restarts=max_restarts,
        monitor_interval_s=0.1, entrypoint=SCRIPT,
        args=[ckpt_dir, out_file], ckpt_dir=ckpt_dir,
        save_at_breakpoint=save_at_breakpoint,
        worker_env={**_subprocess_env(), **env})
    saver = (AsyncCheckpointSaver(ckpt_dir=ckpt_dir, node_rank=0,
                                  local_world_size=1, expected_frames=1)
             if ckpt else None)
    agent = ElasticTrainingAgent(config, MasterClient(master.addr, 0, 0),
                                 ckpt_saver=saver)
    try:
        code = agent.run()
    finally:
        master.stop()
    return code, out_file, master


def test_single_worker_e2e(job, tmp_path):
    code, out_file, master = _run_agent(job, tmp_path)
    assert code == 0
    content = open(out_file).read()
    assert "done w=10.0" in content and "start=0" in content
    assert master.perf_monitor.completed_global_step == 9
    assert master.job_manager.job_stage == "succeeded"


def test_crash_restart_resumes_from_checkpoint(job, tmp_path):
    """The worker crashes at step 5; the agent restarts it; it resumes
    from the checkpoint and ends on the exact weight."""
    code, out_file, _ = _run_agent(job, tmp_path, crash_step=5)
    assert code == 0
    content = open(out_file).read()
    assert "done w=10.0" in content  # no step lost, none doubled
    assert "start=0" not in content
    assert "restarts=1" in content


def test_restart_budget_exhausted(job, tmp_path):
    """A worker that always crashes fails the agent after max_restarts."""
    code, _, master = _run_agent(
        job, tmp_path, max_restarts=1, save_at_breakpoint=False, ckpt=False,
        worker_env={"CRASH_IMMEDIATELY": "1"})
    assert code == 1
    assert master.job_manager.nodes[0].exit_reason == "relaunched"


def test_two_agents_rendezvous_world2(job, tmp_path):
    """Two agents rendezvous through one master (min 1, max 2) and train
    a world-2 job to the end."""
    master = LocalJobMaster(job_name=job, node_num=2, min_nodes=1,
                            max_nodes=2)
    master.prepare()
    ckpt_dir = str(tmp_path / "ckpt")
    out_file = str(tmp_path / "out.txt")
    codes = {}

    def _run(rank):
        config = ElasticLaunchConfig(
            min_nodes=1, max_nodes=2, nproc_per_node=1, node_rank=rank,
            node_id=rank, job_name=job, master_addr=master.addr,
            max_restarts=3, monitor_interval_s=0.1, entrypoint=SCRIPT,
            args=[ckpt_dir, out_file], ckpt_dir=ckpt_dir,
            save_at_breakpoint=False, worker_env=_subprocess_env())
        saver = AsyncCheckpointSaver(
            ckpt_dir=ckpt_dir, node_rank=rank, local_world_size=1,
            expected_frames=1, is_commit_leader=(rank == 0))
        codes[rank] = ElasticTrainingAgent(
            config, MasterClient(master.addr, rank, rank),
            ckpt_saver=saver).run()

    threads = [threading.Thread(target=_run, args=(r,), daemon=True)
               for r in (0, 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "agents hung"
    finally:
        master.stop()
    assert codes == {0: 0, 1: 0}
    for r in (0, 1):
        content = open(f"{out_file}.r{r}").read()
        assert "done w=10.0" in content and "world=2" in content, content
    assert master.perf_monitor.completed_global_step == 9


# -- across the two packages' wires -------------------------------------------

AGENT_CODE = (
    "import sys\n"
    "from dlrover_tpu_torch.agent import run\n"
    "code = run.main(sys.argv[1:])\n"
    "bad = [m for m in sys.modules\n"
    "       if m.split('.')[0] in ('jax', 'jaxlib', 'dlrover_tpu')]\n"
    "print('agent forbidden modules', bad, flush=True)\n"
    "sys.exit(code or (3 if bad else 0))\n"
)


def _communicate(proc, timeout):
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            proc.communicate()
    return out


def test_port_agent_against_a_jax_master(job, tmp_path):
    """The port's agent joins a JAX master by address, trains through a
    crash and restart; the JAX master sees its steps and its success."""
    master = JaxMaster(job_name=job, node_num=1)
    master.prepare()
    env = {**_subprocess_env(), "CRASH_AT_STEP": "4"}
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c", AGENT_CODE, f"--master-addr={master.addr}",
             f"--job_name={job}", "--nproc-per-node=1",
             "--monitor-interval=0.1", f"--ckpt_dir={tmp_path / 'ckpt'}",
             SCRIPT, str(tmp_path / "ckpt"), str(tmp_path / "out.txt")],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        out = _communicate(proc, 120)
        assert proc.returncode == 0, out[-3000:]
        assert "agent forbidden modules []" in out
        assert "done w=10.0" in (tmp_path / "out.txt").read_text()
        assert "restarts=1" in (tmp_path / "out.txt").read_text()
        assert master.perf_monitor.completed_global_step == 9
        assert master.job_manager.nodes[0].status == "succeeded"
    finally:
        master.stop()


def test_jax_agent_runs_the_port_twin_against_the_port_master(job, tmp_path):
    """The JAX package's agent, pointed at the port's master, runs the
    port's twin to the end: the port master serves its rendezvous, KV,
    heartbeats, steps and status."""
    master = LocalJobMaster(job_name=job, node_num=1)
    master.prepare()
    ckpt_dir = str(tmp_path / "ckpt")
    env = {**_subprocess_env(), "DEVICE": "cpu", "TRAIN_STEPS": "3",
           "SEQ_LEN": "32", "CKPT_DIR": ckpt_dir,
           "DLROVER_TPU_WARM_PREIMPORT": "numpy,torch"}
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu.agent.run",
             f"--master-addr={master.addr}", f"--job_name={job}",
             "--nproc-per-node=1", f"--ckpt_dir={ckpt_dir}", TWIN],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        out = _communicate(proc, 180)
        assert proc.returncode == 0, out[-3000:]
        assert '{"done": 3, "start_step": -1, "restored_from": null}' in out
        assert master.perf_monitor.completed_global_step == 3
        assert master.job_manager.nodes[0].status == "succeeded"
        assert master.rdzv_managers["training"].rdzv_round == 1
    finally:
        master.stop()


# -- aborts and the saver's lineage --------------------------------------------


def test_lone_abort_is_node_level(job, tmp_path):
    """A worker that aborts (SIGABRT) with no peer failure makes the agent
    give up in place at once, as the reference's rule does."""
    code, _, master = _run_agent(
        job, tmp_path, max_restarts=3, save_at_breakpoint=False, ckpt=False,
        worker_env={"ABORT_IMMEDIATELY": "1"})
    assert code == 1
    assert master.job_manager.nodes[0].exit_reason == "relaunched"
    # one rendezvous: no restart in place
    assert master.rdzv_managers[RendezvousName.TRAINING].rdzv_round == 1


@pytest.mark.parametrize("evidence", ["none", "local_rank", "peer_node"])
def test_abort_retried_in_place_only_after_a_peer_failed(job, evidence):
    """SIGABRT on its own is node-level; beside another local rank's
    failure, or once the master says a peer node left the world, it is
    the world's failure and the workers restart in place."""
    master = LocalJobMaster(job_name=job, node_num=2, min_nodes=1,
                            max_nodes=2)
    master.prepare()
    try:
        config = ElasticLaunchConfig(
            min_nodes=1, max_nodes=2, nproc_per_node=2, job_name=job,
            master_addr=master.addr, max_restarts=3, entrypoint=SCRIPT)
        agent = ElasticTrainingAgent(config, MasterClient(master.addr, 0, 0))
        codes = {0: -6}
        if evidence == "local_rank":
            codes[1] = -9
        if evidence == "peer_node":
            master.job_manager.enqueue_action(DiagnosisAction(
                DiagnosisActionType.RESTART_WORKER, instance=0,
                reason="peer node 1 left the world"))
        verdict = agent._diagnose_training_failure(codes)
        assert verdict == (DiagnosisActionType.RELAUNCH_WORKER
                           if evidence == "none"
                           else DiagnosisActionType.RESTART_WORKER)
        # the peer's word is taken: it does not restart the world twice
        assert agent._take_pending_action() == (None, {})
        # a segfault stays node-level whatever else failed
        assert (agent._diagnose_training_failure({0: -11, 1: -9})
                == DiagnosisActionType.RELAUNCH_WORKER)
    finally:
        master.stop()


def test_a_short_incarnation_closes_its_recovery_before_its_fault(
        job, monkeypatch):
    """Two incarnations in a row each publish a step and fail before the
    agent's next progress poll: each still reports ``step_resumed`` before
    its failure, so the master's journal holds one incident a fault and
    the first is resolved."""
    from dlrover_tpu_torch.agent.monitor import TrainingMonitor
    from dlrover_tpu_torch.agent.training import RunResult, WorkerState
    from dlrover_tpu_torch.observability.incidents import stitch_incidents

    master = LocalJobMaster(job_name=job, node_num=1)
    master.prepare()
    try:
        config = ElasticLaunchConfig(
            min_nodes=1, max_nodes=1, nproc_per_node=1, job_name=job,
            master_addr=master.addr, max_restarts=3, entrypoint=SCRIPT)
        agent = ElasticTrainingAgent(config, MasterClient(master.addr, 0, 0))
        published = {}

        class _Server:
            """The workers' progress dict, as the agent's IPC serves it."""

            def local_dict(self, name):
                return published

        # the periodic poll never runs: an hour between polls
        agent._training_monitor = TrainingMonitor(
            _Server(), agent._client, on_step=agent.observe_global_step,
            interval_s=3600.0)

        def restart(reason, grace_s=None):
            # what a restart does to the progress bookkeeping; no workers
            agent._last_global_step = 0
            agent._last_step_ts = 0.0
            agent._training_monitor.reset()

        monkeypatch.setattr(agent, "_restart_workers", restart)
        monkeypatch.setattr(agent, "_diagnose_training_failure",
                            lambda codes: DiagnosisActionType.RESTART_WORKER)
        for step in (3, 6):
            published.update(step=step, ts=time.time())
            assert agent._handle_worker_failure(
                RunResult(WorkerState.FAILED, {0: -9}))
        events = master.event_journal.events()
        assert [e["kind"] for e in events] == [
            "step_resumed", "fault_detected", "step_resumed",
            "fault_detected"]
        incidents = stitch_incidents(events, now_t=time.time())
        assert [i.resolution for i in incidents] == ["resolved",
                                                     "unresolved"]
        assert master.perf_monitor.completed_global_step == 6
    finally:
        master.stop()


def test_saver_persists_a_new_lineage_after_an_older_restore(job, tmp_path,
                                                              monkeypatch):
    """Storage holds step 5; a breakpoint save persists step 7, whose
    commit never comes (its peer is dead); the restarted workers restore
    step 5 and save step 6 to storage: the tracker reaches 6. Two local
    workers' identical events for one step write its frame once."""
    from dlrover_tpu_torch.ckpt import ckpt_saver, manifest
    from dlrover_tpu_torch.ckpt.engine import CheckpointEngine

    writes = []
    persist_frame = manifest.persist_frame

    def _counting(storage, path, step, meta, blob, **kw):
        writes.append(step)
        return persist_frame(storage, path, step, meta, blob, **kw)

    monkeypatch.setattr(manifest, "persist_frame", _counting)
    ckpt_dir = str(tmp_path / "ckpt")
    server = LocalIPCServer(str(tmp_path / "ipc.sock"))
    server.start()
    # the world's quorum is two frames: this host's alone commits nothing
    saver = AsyncCheckpointSaver(ckpt_dir=ckpt_dir, node_rank=0,
                                 local_world_size=1, expected_frames=2)
    saver.start(server)
    engine = CheckpointEngine(ckpt_dir, job_name=job, node_rank=0,
                              local_rank=0, ipc_socket=server.path,
                              world_size=1, rank=0)

    def state(step):
        return {"w": torch.full((4, 4), float(step)),
                "step": torch.tensor(step)}

    def wait_tracker(step):
        deadline = time.time() + 20
        while (ckpt_saver.latest_step(ckpt_dir) != step
               and time.time() < deadline):
            time.sleep(0.05)
        return ckpt_saver.latest_step(ckpt_dir)

    try:
        assert engine.save_to_storage(5, state(5))
        assert wait_tracker(5) == 5
        assert engine.wait_drained()
        assert engine.save_to_memory(7, state(7), blocking=True)
        assert saver.save_shm_to_storage(reason="peer died",
                                         workers_dead=True,
                                         async_commit=True) == 1
        assert ckpt_saver.latest_step(ckpt_dir) == 5
        saver.forget_persisted()  # the agent's restart
        assert engine.save_to_storage(6, state(6))
        assert wait_tracker(6) == 6
        saver.save_step_checkpoint(6, ckpt_dir)  # the second worker's event
        assert writes == [5, 7, 6]
    finally:
        saver.stop()
        server.stop()
