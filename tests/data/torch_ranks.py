"""One rank of a multi-process CPU (gloo) run of the port, for the tests.

    DLROVER_TPU_RANK=r DLROVER_TPU_WORLD_SIZE=n ... python torch_ranks.py \
        <mode> <plan json> <out dir>

Each rank prints one ``RESULT <json>`` line. ``mode`` picks the checks:
``shard`` (regions, DTensor locals, trainer steps against the plain step),
``ckpt`` (``shard``, then the checkpoint engine across ranks), ``moe``
(``ckpt`` on the tiny MoE model, for an ``ep`` plan), ``sp`` (ring and
Ulysses attention, the sequence-parallel loss and trainer steps, for an
``sp`` plan), ``pp`` (``pipeline_apply``, ``next_token_loss_pp`` and
trainer steps on the whole stack and on the stage's own layers, for a
``pp`` plan with or without ``dp``), ``moe_ep`` (the MoE loss on the
rank's own experts and trainer steps that keep them local, for an ``ep``
plan) or ``moe_sp`` (the same with ring and Ulysses attention, for an
``ep`` × ``sp`` plan), or one of the block layouts of
:data:`BLOCK_LAYOUTS` (``fsdp2``, ``tp2``, ``fsdp4``, ``fsdp_tp``,
``tp_sp``, ``pp_fsdp``, ``tp4``, ``moe_fsdp``, ``moe_tp``: the loss and
every leaf's
mean grad, and trainer steps, with ``fsdp`` and ``tp`` among the local
axes). These may run in one launch, each on its own mesh: mode ``sp,pp``
with the plan ``{"sp": <plan>, "pp": <plan>}``. Each reads its inputs
from ``<out dir>/<mode>_inputs.npz`` and writes its tensors to
``<out dir>/<mode><world>_<rank>.npz``.
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
from dlrover_tpu_torch.observability.memory import (  # noqa: E402
    get_accountant,
)
from dlrover_tpu_torch.parallel.sharding import (  # noqa: E402
    global_batch_from_local,
    mesh_coords,
    mesh_sizes,
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


def flat(tree, prefix=""):
    """A nested dict → ``{"a/b": leaf}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflat(named, prefix):
    """The nested dict of tensors under ``prefix`` in ``named`` arrays."""
    tree = {}
    for name, a in named.items():
        if not name.startswith(prefix):
            continue
        *path, leaf = name[len(prefix):].split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = torch.from_numpy(np.array(a))
    return tree


# the tiny model of the sp and pp modes (f32; the test builds the JAX twin)
PARALLEL_MODEL = dict(vocab_size=64, dim=32, n_heads=4, n_kv_heads=2,
                      ffn_dim=64, max_seq_len=64)


def parallel_config(**kw):
    return dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32,
                               **{**PARALLEL_MODEL, **kw})


def _grads(loss, tree, prefix, arrays):
    names, leaves = zip(*flat(tree).items())
    for name, g in zip(names, torch.autograd.grad(loss, leaves)):
        arrays[f"{prefix}{name}"] = g.numpy()


def _steps(mesh, plan, c, loss_fn, inp, params, res, arrays, key,
           local_axes=()):
    """3 trainer steps on every rank's copy of the global batches; the
    losses and norms into ``res[key]``, the final params into arrays.
    With ``local_axes``, also what the first micro step computed on: the
    layer leaves' shapes ``loss_fn`` took, the f32 accumulators' shapes
    and their claimed bytes (``res[key + "_live"]``)."""
    tt = ElasticTrainer(loss_fn, adamw(3e-4), GLOBAL_BATCH,
                        max(1, GLOBAL_BATCH // (2 * plan.dp_total)),
                        device="cpu", local_axes=local_axes)
    tt.configure_for_world(plan)
    state = make_train_state(
        shard_tree(mesh, params, model(c).param_logical_axes(c)),
        tt._optimizer)
    res[key] = []
    live, accums = {}, []
    real_add = torch._foreach_add_
    if local_axes:
        def seen(p, x, loss_fn=loss_fn):
            if not live:
                live.update({n: list(t.shape)
                             for n, t in p["layers"].items()})
            return loss_fn(p, x)

        def add(acc, *a, **k):
            if not accums:
                accums.append([list(t.shape) for t in acc])
            return real_add(acc, *a, **k)

        tt._loss_fn = seen
        torch._foreach_add_ = add
    try:
        for b in inp["batches"]:
            state, r = tt.train_step(state, b.reshape(
                tt.grad_accum_steps, tt.micro_batch_global, -1))
            res[key].append([float(r.loss), float(r.grad_norm)])
    finally:
        torch._foreach_add_ = real_add
    if local_axes:
        res[key + "_live"] = dict(
            layers=live, accum_shapes=accums[0],
            accum_bytes=get_accountant().bytes_for("activations"))
    for name, p in flat(state["params"]).items():
        arrays[f"{key}/{name}"] = p.full_tensor().numpy()


def _block(params, mesh, axis, names, dim):
    """``params`` with the leaves ``names`` of ``params["layers"]`` cut to
    this rank's block along ``dim`` over the mesh ``axis``."""
    n, r = mesh_sizes(mesh)[axis], mesh_coords(mesh)[axis]
    layers = dict(params["layers"])
    for name in names:
        w = layers[name]
        e = w.shape[dim] // n
        layers[name] = w.narrow(dim, r * e, e).clone()
    return {**params, "layers": layers}


def sp_checks(ctx, n, mesh, plan, inp, res, arrays):
    """Ring (both bodies) and Ulysses on this rank's chunks, the sp loss
    and its grads, and 3 trainer steps per strategy."""
    from dlrover_tpu_torch.parallel.ring_attention import ring_attention
    from dlrover_tpu_torch.parallel.ulysses import ulysses_attention

    r = ctx.rank

    def chunk(name):
        a = inp[name]
        s = a.shape[2] // n
        return torch.from_numpy(np.array(a[:, :, r * s:(r + 1) * s]))

    q, k, v, kv_k, kv_v, w = (chunk(x) for x in
                              ("q", "k", "v", "kv_k", "kv_v", "w"))
    cases = [("ring_flash", ring_attention, True, k, v),
             ("ring_dense", ring_attention, False, k, v)]
    if n == 2:
        cases += [("ulysses_flash", ulysses_attention, True, kv_k, kv_v),
                  ("ulysses_dense", ulysses_attention, False, kv_k, kv_v)]
    else:
        try:
            ulysses_attention(q, kv_k, kv_v, mesh)
        except ValueError as e:
            res["ulysses_error"] = str(e)
    for name, fn, use_flash, kk, vv in cases:
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, kk, vv))
        out = fn(qs, ks, vs, mesh, use_flash=use_flash)
        arrays[f"{name}/out"] = out.detach().numpy()
        for g_name, g in zip(("dq", "dk", "dv"), torch.autograd.grad(
                (out * w).sum(), (qs, ks, vs))):
            arrays[f"{name}/{g_name}"] = g.numpy()
    tokens = torch.from_numpy(np.array(inp["tokens"]))
    for strategy in (("ring", "ulysses") if n == 2 else ("ring",)):
        c = parallel_config(n_layers=2, sp_attention=strategy,
                            use_flash_attention=True, remat=True)
        params = unflat(inp, "params/")
        for t in flat(params).values():
            t.requires_grad_(True)
        loss = llama.next_token_loss(params, tokens, c, mesh)
        arrays[f"loss_{strategy}"] = loss.detach().numpy()
        _grads(loss, params, f"grad_{strategy}/", arrays)
        _steps(mesh, plan, c,
               lambda p, x, c=c: llama.next_token_loss(p, x, c, mesh),
               inp, unflat(inp, "params/"), res, arrays, f"train_{strategy}")


def pp_checks(mesh, plan, inp, res, arrays):
    """``pipeline_apply`` on the linear toy stage, ``next_token_loss_pp``
    and its grads on this rank's rows, and 3 trainer steps."""
    from dlrover_tpu_torch.parallel.pipeline import pipeline_apply
    from dlrover_tpu_torch.parallel.sharding import mesh_coords

    n_data = plan.dp_total
    d = mesh_coords(mesh)["dp"]

    def rows(a, axis):
        s = a.shape[axis] // n_data
        return torch.from_numpy(np.array(
            np.take(a, range(d * s, (d + 1) * s), axis=axis)))

    def stage_fn(w, h):
        for wi in w:
            h = torch.tanh(h @ wi)
        return h

    ws = torch.from_numpy(np.array(inp["ws"])).requires_grad_()
    x = rows(inp["x"], 1).requires_grad_()
    y = pipeline_apply(stage_fn, ws, x, mesh)
    arrays["toy/y"] = y.detach().numpy()
    gw, gx = torch.autograd.grad((y ** 2).mean(), (ws, x))
    arrays["toy/gw"], arrays["toy/gx"] = gw.numpy(), gx.numpy()

    c = parallel_config(n_layers=4, remat=False)
    params = unflat(inp, "params/")
    for t in flat(params).values():
        t.requires_grad_(True)
    loss = llama.next_token_loss_pp(params, rows(inp["tokens"], 0), c, mesh)
    arrays["loss_pp"] = loss.detach().numpy()
    _grads(loss, params, "grad_pp/", arrays)
    # the stage's own layers alone
    stage = _block(unflat(inp, "params/"), mesh, "pp",
                   list(params["layers"]), 0)
    for t in flat(stage).values():
        t.requires_grad_(True)
    loss = llama.next_token_loss_pp(stage, rows(inp["tokens"], 0), c, mesh)
    arrays["loss_pp_local"] = loss.detach().numpy()
    _grads(loss, stage, "grad_pp_local/", arrays)
    c = parallel_config(n_layers=4, remat=True)
    _steps(mesh, plan, c,
           lambda p, t: llama.next_token_loss_pp(p, t, c, mesh),
           inp, unflat(inp, "params/"), res, arrays, "train_pp")
    _steps(mesh, plan, c,
           lambda p, t: llama.next_token_loss_pp(p, t, c, mesh),
           inp, unflat(inp, "params/"), res, arrays, "train_pp_local",
           local_axes=("pp",))


EXPERT_LEAVES = ("w1", "w3", "w2")


def moe_config(**kw):
    """The tiny MoE of the moe_ep and moe_sp modes (f32, remat "dots",
    the flash path's plain versions)."""
    return dataclasses.replace(moe.MoEConfig.tiny(), dtype=torch.float32,
                               use_flash_attention=True, remat=True, **kw)


def moe_checks(mesh, plan, inp, res, arrays, strategies):
    """The MoE loss and its grads on this rank's experts (and chunk, under
    an sp strategy) for each of ``strategies``, the expert products'
    batch sizes, and 3 trainer steps that keep the experts local, with
    the first strategy."""
    tokens = torch.from_numpy(np.array(inp["tokens"]))
    for strategy in strategies:
        tag = strategy or "ep"
        c = moe_config(sp_attention=strategy)
        params = _block(unflat(inp, "params/"), mesh, "ep", EXPERT_LEAVES,
                        1)
        for t in flat(params).values():
            t.requires_grad_(True)
        batches, real_bmm = [], torch.bmm

        def bmm(a, b, **k):
            batches.append(a.shape[0])
            return real_bmm(a, b, **k)

        torch.bmm = bmm
        try:
            loss = moe.next_token_loss(params, tokens, c, mesh)
            _grads(loss, params, f"grad_{tag}/", arrays)
        finally:
            torch.bmm = real_bmm
        arrays[f"loss_{tag}"] = loss.detach().numpy()
        res[f"bmm_{tag}"] = sorted(set(batches))
    c = moe_config(sp_attention=strategies[0])
    _steps(mesh, plan, c,
           lambda p, x: moe.next_token_loss(p, x, c, mesh),
           inp, unflat(inp, "params/"), res, arrays, "train",
           local_axes=("ep",))


# the layouts that compute on blocks along fsdp and tp: the model family
# ("llama": PARALLEL_MODEL; "tiny": LlamaConfig.tiny(), whose KV heads at
# tp 4 are split finer than a head; "moe": moe_config()), its config
# overrides and the trainer's local axes (the plan is the launch's)
BLOCK_LAYOUTS = {
    "fsdp2": dict(family="llama", local=("fsdp", "tp")),
    "tp2": dict(family="llama", local=("fsdp", "tp")),
    "fsdp4": dict(family="llama", local=("fsdp", "tp")),
    "fsdp_tp": dict(family="llama", local=("fsdp", "tp")),
    "tp_sp": dict(family="llama", local=("fsdp", "tp"),
                  config=dict(sp_attention="ring")),
    "pp_fsdp": dict(family="llama", local=("pp", "fsdp", "tp"),
                    config=dict(n_layers=4)),
    "tp4": dict(family="tiny", local=("fsdp", "tp")),
    "moe_fsdp": dict(family="moe", local=("ep", "fsdp")),
    "moe_tp": dict(family="moe", local=("ep", "tp")),
}


def block_config(layout):
    """The f32 config of a block layout (remat "dots", the flash path's
    plain versions on the CPU)."""
    spec = BLOCK_LAYOUTS[layout]
    kw = dict(spec.get("config", {}))
    if spec["family"] == "moe":
        return moe_config(**kw)
    kw.setdefault("n_layers", 2)
    base = (dataclasses.replace(llama.LlamaConfig.tiny(),
                                dtype=torch.float32)
            if spec["family"] == "tiny" else parallel_config())
    return dataclasses.replace(base, remat=True, use_flash_attention=True,
                               **kw)


def block_loss(c, mesh):
    """The layout's loss on this rank's rows, given the mesh."""
    if isinstance(c, moe.MoEConfig):
        return lambda p, t: moe.next_token_loss(p, t, c, mesh)
    if mesh_sizes(mesh)["pp"] > 1:
        return lambda p, t: llama.next_token_loss_pp(p, t, c, mesh)
    return lambda p, t: llama.next_token_loss(p, t, c, mesh)


def block_checks(layout, mesh, plan, inp, res, arrays):
    """The loss and every leaf's grad on the trainer's views (blocks along
    the local axes, ``_compute_view``) reduced to the placements by the
    trainer's own reduction and gathered whole (``grad/``, ``loss``);
    what the step computed on: the layer leaves' shapes, every
    all-gather's block shape and dim, the heads of every K1 call
    (``seen``); then 3 trainer steps. ``tp2`` also runs the loss with tp
    not local (whole weights entering the region through f:
    ``grad_whole/``, ``loss_whole``)."""
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import collectives
    from dlrover_tpu_torch.trainer import elastic
    from dlrover_tpu_torch.trainer.optim import tree_unflatten

    c = block_config(layout)
    local = BLOCK_LAYOUTS[layout]["local"]
    loss_fn = block_loss(c, mesh)
    tokens = torch.from_numpy(np.array(inp["tokens"]))
    rows = ElasticTrainer._rows_of_this_rank(mesh, tokens[None])[0]
    seen = dict(gathers=[], heads=[])
    real_gather, real_fwd = collectives._all_gather, fa.flash_attention_plain

    def gather(x, group, dim):
        seen["gathers"].append([list(x.shape), dim])
        return real_gather(x, group, dim)

    def fwd(q, *a, **k):
        seen["heads"].append(q.shape[1])
        return real_fwd(q, *a, **k)

    variants = [("", local)]
    if layout == "tp2":
        variants.append(("_whole", ("fsdp",)))
    for tag, axes in variants:
        sharded = shard_tree(mesh, unflat(inp, "params/"),
                             model(c).param_logical_axes(c))
        leaves = tree_leaves(sharded)
        views = [elastic._compute_view(p, axes).detach().requires_grad_()
                 for p in leaves]
        params = tree_unflatten(sharded, views)
        collectives._all_gather, fa.flash_attention_plain = gather, fwd
        try:
            loss = loss_fn(params, rows)
            grads = torch.autograd.grad(loss, views)
        finally:
            collectives._all_gather = real_gather
            fa.flash_attention_plain = real_fwd
        if not tag:
            res["seen"] = dict(
                seen, layers={n: list(t.shape)
                              for n, t in params["layers"].items()})
        out, _, mean_loss = elastic._reduce_to_placements(
            mesh, leaves, [g.float() for g in grads], loss.detach().float(),
            axes)
        arrays[f"loss{tag}"] = mean_loss.numpy()
        whole = tree_unflatten(sharded, [
            DTensor.from_local(g, mesh, p.placements, run_check=False,
                               shape=p.shape, stride=p.stride()
                               ).full_tensor()
            for p, g in zip(leaves, out)])
        for name, g in flat(whole).items():
            arrays[f"grad{tag}/{name}"] = g.numpy()
    _steps(mesh, plan, c, loss_fn, inp, unflat(inp, "params/"), res, arrays,
           "train", local_axes=local)


def parallel_main(ctx, modes, plans, out_dir):
    res = {"rank": ctx.rank}
    for mode in modes:
        plan = plan_mesh(ctx.world_size, **plans[mode])
        mesh = build_mesh(plan, "cpu")
        inp = dict(np.load(os.path.join(out_dir, f"{mode}_inputs.npz")))
        res[mode], arrays = {}, {}
        if mode == "sp":
            sp_checks(ctx, ctx.world_size, mesh, plan, inp, res[mode], arrays)
        elif mode == "pp":
            pp_checks(mesh, plan, inp, res[mode], arrays)
        elif mode in BLOCK_LAYOUTS:
            block_checks(mode, mesh, plan, inp, res[mode], arrays)
        elif mode == "moe_ep":
            moe_checks(mesh, plan, inp, res[mode], arrays, [None])
        else:
            moe_checks(mesh, plan, inp, res[mode], arrays,
                       ["ring", "ulysses"])
        np.savez(os.path.join(
            out_dir, f"{mode}{ctx.world_size}_{ctx.rank}.npz"), **arrays)
    print("RESULT " + json.dumps(res), flush=True)
    worker.shutdown()


def main(mode, plan_kw, out_dir):
    ctx = worker.init(device="cpu")
    modes = mode.split(",")
    if set(modes) <= {"sp", "pp", "moe_ep", "moe_sp", *BLOCK_LAYOUTS}:
        return parallel_main(ctx, modes, plan_kw, out_dir)
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
