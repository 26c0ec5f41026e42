"""One rank of a multi-process CPU (gloo) run of the port, for the tests.

    DLROVER_TPU_RANK=r DLROVER_TPU_WORLD_SIZE=n ... python torch_ranks.py \
        <mode> <plan json> <out dir>

Each rank prints one ``RESULT <json>`` line. ``mode`` picks the checks:
``shard`` (regions, DTensor locals, trainer steps against the plain step),
``ckpt`` (``shard``, then the checkpoint engine across ranks) or ``moe``
(``ckpt`` on the tiny MoE model, for an ``ep`` plan).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu_torch import worker  # noqa: E402
from dlrover_tpu_torch.ckpt.engine import CheckpointEngine  # noqa: E402
from dlrover_tpu_torch.ckpt.reshard import needs_from_state  # noqa: E402
from dlrover_tpu_torch.ckpt.shm_handler import (  # noqa: E402
    SharedMemoryHandler,
    shm_name,
)
from dlrover_tpu_torch.convert import named_leaves  # noqa: E402
from dlrover_tpu_torch.models import llama, moe  # noqa: E402
from dlrover_tpu_torch.parallel.mesh import build_mesh, plan_mesh  # noqa: E402
from dlrover_tpu_torch.parallel.sharding import (  # noqa: E402
    global_batch_from_local,
    shard_tree,
)
from dlrover_tpu_torch.trainer.elastic import (  # noqa: E402
    ElasticTrainer,
    make_train_state,
)
from dlrover_tpu_torch.trainer.optim import adamw, tree_leaves  # noqa: E402

GLOBAL_BATCH, SEQ, STEPS = 4, 16, 3


def config(mode="shard"):
    family = moe.MoEConfig if mode == "moe" else llama.LlamaConfig
    return dataclasses.replace(family.tiny(), dtype=torch.float32,
                               use_flash_attention=False)


def model(c):
    """The module of ``c``'s family (init_params, param_logical_axes,
    next_token_loss)."""
    return moe if isinstance(c, moe.MoEConfig) else llama


def batches(c):
    rng = np.random.default_rng(1)
    return rng.integers(0, c.vocab_size, (STEPS, GLOBAL_BATCH, SEQ + 1)
                        ).astype(np.int32)


def trainer(c, plan):
    t = ElasticTrainer(lambda p, x: model(c).next_token_loss(p, x, c),
                       adamw(3e-4), GLOBAL_BATCH,
                       max(1, GLOBAL_BATCH // (2 * plan.dp_total)),
                       device="cpu")
    t.configure_for_world(plan)
    return t


def main(mode, plan_kw, out_dir):
    ctx = worker.init(device="cpu")
    c = config(mode)
    m = model(c)
    plan = plan_mesh(ctx.world_size, **plan_kw)
    mesh = build_mesh(plan, "cpu")
    full = m.init_params(c, torch.Generator().manual_seed(0), "cpu")
    params = shard_tree(mesh, full, m.param_logical_axes(c))
    res = {"rank": ctx.rank}
    res["needs"] = {k: [list(map(list, r)) for r in v.regions]
                    for k, v in needs_from_state({"params": params}).items()}
    named_full = dict(named_leaves({"params": full}))
    needs = needs_from_state({"params": params})
    res["locals_match"] = all(
        torch.equal(p.to_local(), named_full[name][tuple(
            slice(s, s + n) for s, n in zip(*needs[name].regions[0]))])
        for name, p in named_leaves({"params": params}))

    # the same 3 steps across ranks and as one plain process
    tt = trainer(c, plan)
    state = make_train_state(params, tt._optimizer)
    n_data = plan.dp_total
    data_index = ctx.rank // (ctx.world_size // n_data)
    losses = []
    for b in batches(c):
        local = b.reshape(n_data, -1, SEQ + 1)[data_index]
        tokens = global_batch_from_local(mesh, local).reshape(
            tt.grad_accum_steps, tt.micro_batch_global, SEQ + 1)
        state, r = tt.train_step(state, tokens)
        losses.append([float(r.loss), float(r.grad_norm)])
    ref_t = trainer(c, plan)
    ref = make_train_state(
        m.init_params(c, torch.Generator().manual_seed(0), "cpu"),
        ref_t._optimizer)
    ref_losses = []
    for b in batches(c):
        ref, r = ref_t.train_step(ref, b.reshape(
            ref_t.grad_accum_steps, ref_t.micro_batch_global, SEQ + 1))
        ref_losses.append([float(r.loss), float(r.grad_norm)])
    res["losses"], res["ref_losses"] = losses, ref_losses
    res["param_err"] = max(
        float((p.full_tensor() - q).abs().max())
        for p, q in zip(tree_leaves(state["params"]),
                        tree_leaves(ref["params"])))
    res["mu_err"] = max(
        float((p.full_tensor() - q).abs().max())
        for p, q in zip(tree_leaves(state["opt_state"]["mu"]),
                        tree_leaves(ref["opt_state"]["mu"])))
    if mode in ("ckpt", "moe"):
        res.update(ckpt_checks(ctx, mesh, c, state, out_dir))
    print("RESULT " + json.dumps(res), flush=True)
    worker.shutdown()


def ckpt_checks(ctx, mesh, c, state, out_dir):
    job = os.environ["TEST_JOB"]
    engine = CheckpointEngine(
        out_dir, job_name=job, node_rank=0, local_rank=ctx.rank,
        rank=ctx.rank, world_size=ctx.world_size,
        local_world_size=ctx.world_size, ipc_socket="/nonexistent")
    res = {}
    assert engine.save_to_memory(3, state) and engine.wait_drained(60)
    meta = SharedMemoryHandler(shm_name(job, 0, ctx.rank)).read_meta()
    res["saved_shards"] = {leaf["path"]: len(leaf.get("shards", []))
                           for leaf in meta["leaves"]}
    # a save goes ahead on all ranks or on none: rank 1 is busy draining
    release = threading.Event()
    if ctx.rank == 1:
        engine._drain_thread = threading.Thread(target=release.wait)
        engine._drain_thread.start()
    res["busy_save"] = engine.save_to_memory(4, state)
    release.set()
    if engine._drain_thread is not None:
        engine._drain_thread.join()
    res["next_save"] = engine.save_to_memory(5, state)
    assert engine.wait_drained(60)
    # shm restore on every rank (a rank without the replicated leaves
    # reads them from its local peer's frame), then storage
    m = model(c)
    target = make_train_state(
        shard_tree(mesh, m.init_params(
            c, torch.Generator().manual_seed(9), "cpu"),
            m.param_logical_axes(c)), adamw(3e-4))
    restored, step = engine.load(target)
    res["shm_restore"] = [step, engine.last_restore["medium"], all(
        torch.equal(a.to_local() if hasattr(a, "to_local") else a,
                    b.to_local() if hasattr(b, "to_local") else b)
        for a, b in zip(tree_leaves(restored), tree_leaves(state)))]
    res["storage_save"] = engine.save_to_storage(6, state)
    return res


def launch(n, mode, plan_kw, out_dir, job, timeout=150):
    """Run ``n`` ranks of this script; returns their RESULT dicts by rank
    (raises with the output when a rank fails)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DLROVER_TPU_")}
        env.update({
            "DLROVER_TPU_RANK": str(r), "DLROVER_TPU_WORLD_SIZE": str(n),
            "DLROVER_TPU_LOCAL_RANK": str(r),
            "DLROVER_TPU_LOCAL_WORLD_SIZE": str(n),
            "DLROVER_TPU_COORDINATOR_ADDR": f"127.0.0.1:{port}",
            "DLROVER_TPU_LOG_LEVEL": "WARNING", "TEST_JOB": job,
            "OMP_NUM_THREADS": "1",
        })
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode,
             json.dumps(plan_kw), out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = {}
    for p, out in zip(procs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"rank failed ({p.returncode}):\n{out}")
        res = json.loads(lines[-1][len("RESULT "):])
        results[res["rank"]] = res
    return results


if __name__ == "__main__":
    main(sys.argv[1], json.loads(sys.argv[2]), sys.argv[3])
