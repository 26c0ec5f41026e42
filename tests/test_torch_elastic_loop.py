"""The elastic pretraining loop end to end: the port's twin of
``examples/llama_elastic_pretrain.py`` under the JAX package's standalone
agent and under the port's own, with 2 gloo workers, against the JAX
example on the same data.

The JAX example's initial state (its config, ``PRNGKey(0)`` params, optax
adamw, the sampler position) is saved by the JAX checkpoint engine as step
0 in the twin's checkpoint directory, so the twin starts from the same
weights: it restores a 1-process JAX save onto 2 ranks. The twin's rank 0
SIGKILLs itself once step 7's memory frame is sealed; the agent restarts
both workers, which resume from shared memory at step 7 and run to step
10. Every step's loss (the killed incarnation's 1-7, the resumed 8-10)
matches the JAX example's unkilled run to the trainer tests' tolerance.
The drill leans on the agent's local restart of a failed worker group
only, not on the paral-plan pipe or a heartbeat-timeout relaunch.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.ckpt.engine import CheckpointEngine  # noqa: E402
from dlrover_tpu.common.multi_process import (  # noqa: E402
    unlink_shared_memory,
)
from dlrover_tpu.models import llama  # noqa: E402
from dlrover_tpu.parallel.mesh import build_mesh, plan_mesh  # noqa: E402
from dlrover_tpu.parallel.sharding import (  # noqa: E402
    global_batch_from_local,
    shard_tree,
)
from dlrover_tpu.trainer.data import (  # noqa: E402
    ElasticDataLoader,
    ElasticDistributedSampler,
)
from dlrover_tpu.trainer.elastic import (  # noqa: E402
    ElasticTrainer,
    make_train_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN = os.path.join(REPO, "examples", "llama_elastic_pretrain_torch.py")
STEPS, GLOBAL_BATCH, SEQ_LEN, KILL_AT = 10, 8, 64, 7


def _jax_example(ckpt_dir, job):
    """The JAX example's loop on one process for STEPS steps; its step-0
    state goes to ``ckpt_dir`` first. Returns the per-step losses."""
    config = llama.LlamaConfig(
        vocab_size=2048, dim=128, n_layers=4, n_heads=4, n_kv_heads=2,
        ffn_dim=256, max_seq_len=SEQ_LEN, remat=True, dtype=jnp.float32,
    )
    plan = plan_mesh(1, tp=1, sp=1)
    mesh = build_mesh(plan, jax.devices()[:1])
    params = shard_tree(mesh, llama.init_params(config,
                                                jax.random.PRNGKey(0)),
                        llama.param_logical_axes(config))
    trainer = ElasticTrainer(
        loss_fn=lambda p, t: llama.next_token_loss(p, t, config, mesh),
        optimizer=optax.adamw(3e-4), global_batch_size=GLOBAL_BATCH,
        micro_batch_per_replica=max(1, GLOBAL_BATCH // (2 * plan.dp_total)),
    )
    trainer.configure_for_world(plan)
    state = make_train_state(params, trainer._optimizer)
    state["sampler_epoch"] = jnp.zeros((), jnp.int32)
    state["sampler_completed"] = jnp.zeros((), jnp.int32)
    engine = CheckpointEngine(ckpt_dir, job_name=job, node_rank=0,
                              local_rank=0, ipc_socket="/nonexistent",
                              world_size=1, rank=0)
    assert engine.save_to_storage(0, state)
    engine._shm.unlink()
    rng = np.random.default_rng(0)
    data = rng.integers(0, config.vocab_size, size=(4096, SEQ_LEN + 1),
                        dtype=np.int32)
    sampler = ElasticDistributedSampler(len(data), num_replicas=1, rank=0,
                                        shuffle=True)
    global_bs = trainer.micro_batch_global * trainer.grad_accum_steps
    loader = ElasticDataLoader(data, batch_size=global_bs, sampler=sampler)
    losses = []
    for batch in loader:
        if len(losses) >= STEPS:
            break
        sampler.record_batch(global_bs)
        tokens = global_batch_from_local(mesh, batch).reshape(
            trainer.grad_accum_steps, trainer.micro_batch_global,
            SEQ_LEN + 1)
        state, result = trainer.train_step(state, tokens)
        losses.append(float(result.loss))
    return losses


def test_twin_under_the_agent_matches_jax_and_resumes_from_shm(tmp_path):
    job = f"twin{os.getpid()}"
    ckpt_dir = str(tmp_path / "ckpt")
    want = _jax_example(ckpt_dir, f"seed{os.getpid()}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.update({
        "DEVICE": "cpu", "TRAIN_STEPS": str(STEPS),
        "GLOBAL_BATCH": str(GLOBAL_BATCH), "SEQ_LEN": str(SEQ_LEN),
        "KILL_AT_STEP": str(KILL_AT), "CKPT_DIR": ckpt_dir,
        "JAX_PLATFORMS": "cpu", "DLROVER_TPU_LOG_LEVEL": "WARNING",
        "DLROVER_TPU_WARM_PREIMPORT": "numpy,torch,dlrover_tpu_torch.worker",
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": REPO,
    })
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu.agent.run", "--standalone",
         "--nproc-per-node=2", f"--job_name={job}",
         f"--ckpt_dir={ckpt_dir}", TWIN],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            proc.communicate()
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrtpu_{job}_"):
                unlink_shared_memory(name)
    assert proc.returncode == 0, out[-3000:]
    records = [json.loads(ln) for ln in out.splitlines()
               if ln.startswith("{")]
    losses = {r["step"]: r["loss"] for r in records if "loss" in r}
    done = [r for r in records if "done" in r]
    # one incarnation killed after step 7, one resumed there from shm
    assert done == [{"done": STEPS, "start_step": KILL_AT,
                     "restored_from": "shm"}], out[-3000:]
    assert "worker failure" in out
    assert sorted(losses) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([losses[s] for s in range(1, STEPS + 1)],
                               want, rtol=1e-5)


# -- the twin's records on a shared stdout ------------------------------------


def test_twin_writes_each_record_in_one_write(monkeypatch):
    """Every record of the twin goes through ``emit`` (no ``print``, which
    writes the text and its newline apart on an unbuffered stream), and
    ``emit`` hands the stream the whole line in one write."""
    import ast
    import importlib.util

    with open(TWIN) as f:
        tree = ast.parse(f.read())
    prints = [node.lineno for node in ast.walk(tree)
              if isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "print"]
    assert prints == []
    spec = importlib.util.spec_from_file_location("twin_records", TWIN)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    writes = []

    class Stream:
        def write(self, text):
            writes.append(text)
            return len(text)

        def flush(self):
            pass

    monkeypatch.setattr(sys, "stdout", Stream())
    twin.emit({"killed_at_step": 7, "ts": 1.5})
    assert writes == ['{"killed_at_step": 7, "ts": 1.5}\n']


RECORD_WRITER = (
    "import importlib.util, sys, time\n"
    "spec = importlib.util.spec_from_file_location('twin', sys.argv[1])\n"
    "twin = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(twin)\n"
    "time.sleep(max(0.0, float(sys.argv[2]) - time.time()))\n"
    "for i in range(400):\n"
    "    twin.emit({'killed_at_step': i, 'ts': time.time(),\n"
    "               'rank': int(sys.argv[3])})\n"
)


def test_twin_records_from_two_ranks_stay_whole_lines():
    """Two processes on one unbuffered stdout pipe (as the agent's workers
    share theirs) emit records at the same instants: every line parses."""
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=REPO)
    read, write = os.pipe()
    start = str(time.time() + 8.0)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RECORD_WRITER, TWIN, start, str(r)],
        env=env, stdout=write) for r in range(2)]
    os.close(write)
    with os.fdopen(read) as f:
        lines = f.read().splitlines()
    for p in procs:
        assert p.wait(timeout=60) == 0
    records = [json.loads(ln) for ln in lines]
    assert sorted((r["rank"], r["killed_at_step"]) for r in records) == [
        (r, i) for r in range(2) for i in range(400)]


# -- the twin under the port's own agent ---------------------------------------

PORT_AGENT = (
    "import sys\n"
    "from dlrover_tpu_torch.agent import run\n"
    "code = run.main(sys.argv[1:])\n"
    "bad = sorted(m for m in sys.modules\n"
    "             if m.split('.')[0] in ('jax', 'jaxlib', 'dlrover_tpu'))\n"
    "print('AGENT_FORBIDDEN ' + ','.join(bad), flush=True)\n"
    "sys.exit(code or (3 if bad else 0))\n"
)


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """The JAX example's losses, and a checkpoint directory holding its
    step-0 state for each run to copy."""
    seed_dir = tmp_path_factory.mktemp("seed") / "ckpt"
    losses = _jax_example(str(seed_dir), f"pseed{os.getpid()}")
    return losses, str(seed_dir)


def _port_agent_run(tmp_path, jax_reference, extra_env, extra_args=()):
    import shutil

    want, seed_dir = jax_reference
    job = f"pt{os.getpid()}{len(os.listdir(tmp_path))}"
    ckpt_dir = str(tmp_path / "ckpt")
    shutil.copytree(seed_dir, ckpt_dir)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT_"))}
    env.update({
        "DEVICE": "cpu", "TRAIN_STEPS": str(STEPS),
        "GLOBAL_BATCH": str(GLOBAL_BATCH), "SEQ_LEN": str(SEQ_LEN),
        "CKPT_DIR": ckpt_dir, "DLROVER_TPU_LOG_LEVEL": "WARNING",
        "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO, **extra_env,
    })
    proc = subprocess.Popen(
        [sys.executable, "-c", PORT_AGENT, "--standalone",
         "--nproc-per-node=2", f"--job_name={job}",
         f"--ckpt_dir={ckpt_dir}", *extra_args, TWIN],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            proc.communicate()
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrtpu_{job}_"):
                unlink_shared_memory(name)
    assert proc.returncode == 0, out[-3000:]
    records = [json.loads(ln) for ln in out.splitlines()
               if ln.startswith("{")]
    losses = {r["step"]: r["loss"] for r in records if "loss" in r}
    # rtol 1e-5: the trainer tests' tolerance for the port against JAX
    assert sorted(losses) == list(range(1, STEPS + 1)), out[-3000:]
    np.testing.assert_allclose([losses[s] for s in range(1, STEPS + 1)],
                               want, rtol=1e-5)
    # no process of the run loaded JAX or the JAX package
    assert "AGENT_FORBIDDEN \n" in out + "\n", out[-3000:]
    modules = [r["forbidden_modules"] for r in records
               if "forbidden_modules" in r]
    assert modules and not any(modules), modules
    return records, out


def test_twin_under_the_port_agent_matches_jax_and_resumes_from_shm(
        tmp_path, jax_reference):
    """``python -m dlrover_tpu_torch.agent.run --standalone
    --nproc-per-node=2`` runs the twin on gloo; a SIGKILL after step 7
    resumes from shm at 7 on the JAX example's losses."""
    records, out = _port_agent_run(tmp_path, jax_reference,
                                   {"KILL_AT_STEP": str(KILL_AT)})
    done = [r for r in records if "done" in r]
    assert done == [{"done": STEPS, "start_step": KILL_AT,
                     "restored_from": "shm"}], out[-3000:]
    assert "worker failure" in out


def test_twin_under_the_port_agent_torn_frame_then_hang(tmp_path,
                                                        jax_reference):
    """A torn step-7 frame (the injector) and a SIGKILL after it: the
    agent's saver refuses the frame, the restart restores from storage
    (step 0, the seed); then the workers wedge after step 9 and the
    master's hang rule restarts them, from shm at 9. The losses stay the
    JAX example's."""
    records, out = _port_agent_run(
        tmp_path, jax_reference, {
            "KILL_AT_STEP": str(KILL_AT),
            "DLROVER_FAULT_SCHEDULE": f"shm.write:torn@step={KILL_AT}",
            "HANG_AFTER_STEP": "9",
            "HANG_MARKER": str(tmp_path / "hang.marker"),
            "DLROVER_TPU_HANG_RESTART_WORKERS": "1",
            "DLROVER_TPU_HANG_DOWNTIME_S": "8",
            "DLROVER_TPU_DIAGNOSIS_INTERVAL_S": "0.5",
            "DLROVER_TPU_HEARTBEAT_INTERVAL_S": "0.5",
        })
    wedged = [r for r in records if "wedged_after_step" in r]
    assert wedged == [{"wedged_after_step": 9, "start_step": 0,
                       "restored_from": "storage"}], out[-3000:]
    done = [r for r in records if "done" in r]
    assert done == [{"done": STEPS, "start_step": 9,
                     "restored_from": "shm"}], out[-3000:]
    assert "refusing to persist" in out
    assert "training hang detected" in out
