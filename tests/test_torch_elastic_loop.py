"""The elastic pretraining loop end to end: the port's twin of
``examples/llama_elastic_pretrain.py`` under the JAX package's standalone
agent, with 2 gloo workers, against the JAX example on the same data.

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
