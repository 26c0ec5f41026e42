"""End-to-end elastic Llama pretraining on the PyTorch/CUDA port.

The port's twin of ``examples/llama_elastic_pretrain.py``, with the same
constants, synthetic data (``default_rng(0)``), model configuration and
checkpoint cadence:

- ``worker.init()`` — agent env → ``torch.distributed`` (NCCL on the card,
  gloo on the CPU) + master client
- mesh planning from the live world size (tp/sp fixed, fsdp absorbs), the
  params sharded as DTensors by their logical axes
- ``ElasticTrainer`` — fixed global batch through grad-accum, the loss
  computing on each rank's ``fsdp`` and ``tp`` blocks (``local_axes``)
- ``ElasticDataLoader`` + ``ElasticDistributedSampler`` — resumable
- Flash Checkpoint — memory saves every step, storage every 10; the
  sampler's position rides the checkpoint
- the training span and per-step publishing to the agent and the master

Run on the CPU under the port's elastic agent (its ``dlrover-run``), 2
workers over gloo::

    DEVICE=cpu CKPT_DIR=/tmp/llama_ckpt \\
    python -m dlrover_tpu_torch.agent.run --standalone --nproc-per-node=2 \\
        --ckpt-dir /tmp/llama_ckpt examples/llama_elastic_pretrain_torch.py

(the JAX package's agent, ``python -m dlrover_tpu.agent.run``, runs it the
same way). The agent leaves the ``dlrtpu_<job>_*`` segments in
``/dev/shm``: unlink them after the run. The leader prints one JSON line
per step (``{"step", "loss"}``) and one at the end; every rank prints
``{"rank", "forbidden_modules"}``, the JAX modules its process loaded
(none when it runs under the port's agent).

``KILL_AT_STEP=N`` makes the first incarnation SIGKILL itself once step
N's memory frame is sealed (a fault drill: the agent restarts the
workers, which resume from shared memory). ``HANG_AFTER_STEP=N`` with
``HANG_MARKER=<path>`` makes the incarnation that finds no marker stop
after step N, outside the training span, and write the marker (a hang
drill: the master's hang rule has the agent restart the workers). ``train`` is the body, for
callers with another configuration: the card's attention kernels take bf16
with head_dim 64 or 128, so this example's f32, head_dim-32 model runs on
the CPU's plain path.
"""

import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu_torch import worker  # noqa: E402
from dlrover_tpu_torch.ckpt.checkpointer import (  # noqa: E402
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.models import llama  # noqa: E402
from dlrover_tpu_torch.parallel.mesh import build_mesh, plan_mesh  # noqa: E402
from dlrover_tpu_torch.parallel.sharding import (  # noqa: E402
    global_batch_from_local,
    shard_tree,
)
from dlrover_tpu_torch.trainer.data import (  # noqa: E402
    ElasticDataLoader,
    ElasticDistributedSampler,
)
from dlrover_tpu_torch.trainer.elastic import (  # noqa: E402
    ElasticTrainer,
    make_train_state,
)
from dlrover_tpu_torch.trainer.optim import adamw  # noqa: E402

TOTAL_STEPS = int(os.getenv("TRAIN_STEPS", "30"))
GLOBAL_BATCH = int(os.getenv("GLOBAL_BATCH", "8"))
SEQ_LEN = int(os.getenv("SEQ_LEN", "64"))
CKPT_EVERY = 10


def emit(record) -> None:
    """``record`` as one JSON line, in one write. The ranks share stdout,
    and with ``PYTHONUNBUFFERED`` set ``print`` writes the text and its
    newline apart, so two ranks' records could land on one line."""
    sys.stdout.write(json.dumps(record) + "\n")
    sys.stdout.flush()


def example_config(seq_len: int = SEQ_LEN) -> llama.LlamaConfig:
    return llama.LlamaConfig(
        vocab_size=2048, dim=128, n_layers=4, n_heads=4, n_kv_heads=2,
        ffn_dim=256, max_seq_len=seq_len, remat=True, dtype=torch.float32,
    )


def synthetic_dataset(vocab: int, seq_len: int, n: int = 4096):
    rng = np.random.default_rng(0)
    return rng.integers(0, vocab, size=(n, seq_len + 1), dtype=np.int32)


def train(config, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: str, ctx, ckpt_every: int = CKPT_EVERY,
          kill_at_step=None, on_step=None, on_start=None,
          micro_batch_per_replica=None) -> dict:
    """Train ``steps`` steps (resuming from any checkpoint in shm or
    ``ckpt_dir``) on ``ctx``'s world. Returns the start step, where the
    restore came from, the per-step losses and grad norms and the
    checkpointer. ``on_start(start_step, checkpointer, trainer)`` runs
    after the restore and ``on_step(step, loss)`` after each step's save;
    ``micro_batch_per_replica`` fixes the micro batch (default: half the
    global batch over the replicas), so a smaller world takes more
    accumulation steps."""
    device = ctx.device
    # mesh from the live world: model axes fixed, fsdp absorbs the rest
    plan = plan_mesh(ctx.world_size, tp=1, sp=1)
    mesh = build_mesh(plan, device.type)
    params = shard_tree(
        mesh,
        llama.init_params(config,
                          torch.Generator(device=device).manual_seed(0),
                          device),
        llama.param_logical_axes(config),
    )
    # the model computes on this rank's fsdp and tp blocks: each layer
    # gathers its fsdp blocks in its forward and its recompute
    trainer = ElasticTrainer(
        loss_fn=lambda p, t: llama.next_token_loss(p, t, config, mesh),
        optimizer=adamw(3e-4),
        global_batch_size=global_batch,
        micro_batch_per_replica=micro_batch_per_replica or max(
            1, global_batch // (2 * plan.dp_total)),
        device=device,
        local_axes=("fsdp", "tp"),
    )
    trainer.configure_for_world(plan)
    state = make_train_state(params, trainer._optimizer)

    data = synthetic_dataset(config.vocab_size, seq_len)
    sampler = ElasticDistributedSampler(
        len(data), num_replicas=ctx.world_size, rank=ctx.rank, shuffle=True,
    )
    global_bs = trainer.micro_batch_global * trainer.grad_accum_steps
    per_host = global_bs // ctx.world_size

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    ckpt = Checkpointer(
        ckpt_dir, job_name=ctx.job_name, node_rank=ctx.node_rank,
        local_rank=ctx.local_rank, rank=ctx.rank, world_size=ctx.world_size,
        local_world_size=ctx.local_world_size,
    )
    state["sampler_epoch"] = scalar(0)
    state["sampler_completed"] = scalar(0)
    state, start_step = ckpt.load_checkpoint(state)
    sampler.load_state_dict({
        "epoch": int(state["sampler_epoch"]),
        "completed": int(state["sampler_completed"]),
    })
    loader = ElasticDataLoader(data, batch_size=per_host, sampler=sampler)
    if on_start is not None:
        on_start(start_step, ckpt, trainer)

    step = max(start_step, 0)
    losses, norms = {}, {}
    with ctx.training_span(steps=steps):
        for batch in loader:
            if step >= steps:
                break
            step += 1
            sampler.record_batch(global_bs)
            tokens = global_batch_from_local(mesh, batch).reshape(
                trainer.grad_accum_steps, trainer.micro_batch_global,
                seq_len + 1)
            state, result = trainer.train_step(state, tokens)
            sd = sampler.state_dict()
            state["sampler_epoch"] = scalar(sd["epoch"])
            state["sampler_completed"] = scalar(sd["completed"])
            if step == kill_at_step:
                # the drill needs this step's frame: wait out the last drain
                # so the save is not skipped as busy
                ckpt.engine.wait_drained()
            ckpt.save_checkpoint(
                step, state,
                storage_type=StorageType.DISK if step % ckpt_every == 0
                else StorageType.MEMORY,
            )
            losses[step], norms[step] = result.loss, result.grad_norm
            if on_step is not None:
                on_step(step, result.loss)
            if step == kill_at_step and ckpt.engine.wait_drained():
                emit({"killed_at_step": step, "ts": time.time()})
                os.kill(os.getpid(), signal.SIGKILL)
            ctx.publish_step(step)
            if ctx.is_leader:
                # cross-host RPC only from the leader; other ranks' progress
                # reaches the master through the agent's SharedDict
                ctx.report_step(step)
    ckpt.engine.wait_drained()
    return {
        "start_step": start_step,
        "restored_from": ckpt.engine.last_restore.get("medium"),
        "losses": {s: float(v) for s, v in losses.items()},
        "grad_norms": {s: float(v) for s, v in norms.items()},
        "final_step": step,
        "checkpointer": ckpt,
    }


def main() -> int:
    ctx = worker.init(device=os.getenv("DEVICE", "cuda"))
    kill = int(os.getenv("KILL_AT_STEP", "0")) or None
    hang = int(os.getenv("HANG_AFTER_STEP", "0")) or None
    marker = os.getenv("HANG_MARKER", "")
    wedge = bool(hang and marker and not os.path.exists(marker))

    engine = []

    def on_step(step, loss):
        if ctx.is_leader:
            emit({"step": step, "loss": float(loss)})
        if wedge and step + 1 == hang:
            # the hang drill restores the wedged step's frame: wait out
            # this drain so that step's save is not skipped as busy
            engine[0].wait_drained()

    out = train(example_config(SEQ_LEN), hang if wedge else TOTAL_STEPS,
                GLOBAL_BATCH, SEQ_LEN, os.getenv("CKPT_DIR", "/tmp/llama_ckpt"),
                ctx, kill_at_step=kill if ctx.restart_count == 0 else None,
                on_step=on_step,
                on_start=lambda start, ckpt, trainer: engine.append(
                    ckpt.engine))
    emit({"rank": ctx.rank, "forbidden_modules": sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu"))})
    if wedge:
        # the hang drill: stop stepping outside the training span until
        # the agent's restart kills this worker
        if ctx.is_leader:
            with open(marker, "w") as f:
                f.write(str(time.time()))
            emit({"wedged_after_step": out["final_step"],
                  "start_step": out["start_step"],
                  "restored_from": out["restored_from"]})
        time.sleep(3600)
    if ctx.is_leader:
        emit({"done": out["final_step"], "start_step": out["start_step"],
              "restored_from": out["restored_from"]})
    worker.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
