"""The port's compute on ``fsdp`` and ``tp`` blocks against the JAX package.

In process: ``collectives.gather_shard`` (its forward gathers along any
dim, its backward reduce-scatters in f32), *f* and *g*
(``collectives.to_region`` / ``from_region``, in bf16 and f32) and
``gather_from_region`` on a fake two-rank group, ``sharding.held_block``
and ``sharding.tp_heads``.

Across gloo ranks (``tests/data/torch_ranks.py``, its block layouts, in
one launch of 2 ranks and one of 4): fsdp 2, tp 2, fsdp 4, fsdp 2 × tp 2,
tp 2 × sp 2 (ring), pp 2 × fsdp 2, tp 4 on ``LlamaConfig.tiny()`` (its
2 KV heads split finer than a head at tp 4, so the ranks gather them)
and the MoE at ep 2 × fsdp 2 and at ep 2 × tp 2 (its experts' columns
split over tp), each with the trainer's local axes holding ``fsdp`` and
``tp``. Each rank computes the loss on its rows and its
blocks, and the trainer's own reduction takes its grads to the leaves'
placements: the loss and every leaf's mean grad equal ``jax.grad`` of the
reference's loss on its 8-device CPU mesh (the params sharded by their
logical axes), and 3 ``ElasticTrainer`` steps equal the JAX trainer's
with ``optax.adamw``. The ranks also record what they computed on: the
layer leaves at their block shapes, each fsdp gather one layer's block
(in the forward and again in the recompute), K1 on the rank's own heads,
the f32 accumulators and the ledger's ``trainer/grad_accum`` claim at the
blocks' size. f32 throughout; the port's flash path runs the plain
versions of K1-K3.
"""

import dataclasses
import importlib.util
import math
import os
from collections import Counter

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.models import moe as jm  # noqa: E402
from dlrover_tpu.parallel import mesh as jmesh  # noqa: E402
from dlrover_tpu.parallel import sharding as jsharding  # noqa: E402
from dlrover_tpu.trainer import elastic as je  # noqa: E402
from dlrover_tpu_torch.parallel import collectives  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as tsharding  # noqa: E402

# the model's loss and leaf grads, and the trainer's steps: the
# tolerances of tests/test_torch_parallel.py
LOSS_ATOL, GRAD_ATOL = 1e-5, 1e-4
STEP_LOSS_RTOL, STEP_NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
GLOBAL_BATCH, SEQ = 4, 16


def _ranks_module():
    spec = importlib.util.spec_from_file_location(
        "torch_ranks", os.path.join(os.path.dirname(__file__), "data",
                                    "torch_ranks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RANKS = _ranks_module()

# the two launches: ranks → each layout's plan (its own mesh)
LAUNCHES = {
    2: {"fsdp2": {"fsdp": 2}, "tp2": {"tp": 2, "fsdp": 1}},
    4: {"fsdp4": {"fsdp": 4}, "fsdp_tp": {"fsdp": 2, "tp": 2},
        "tp_sp": {"tp": 2, "sp": 2, "fsdp": 1},
        "pp_fsdp": {"pp": 2, "fsdp": 2}, "tp4": {"tp": 4, "fsdp": 1},
        "moe_fsdp": {"ep": 2, "fsdp": 2}, "moe_tp": {"ep": 2, "tp": 2}},
}
LAYOUTS = {name: n for n, plans in LAUNCHES.items() for name in plans}


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


# ---------------------------------------------------------------------------
# in process: the collectives on a fake two-rank group
# ---------------------------------------------------------------------------


class _FakeDist:
    """``torch.distributed`` for rank 0 of a two-rank group whose peer
    holds ``peer`` (keyed by shape): the collectives combine this rank's
    tensor with the peer's, and record the dtypes they moved."""

    def __init__(self, peer):
        self.peer, self.dtypes = peer, []

    def get_world_size(self, group=None):
        return 2

    def get_rank(self, group=None):
        return 0

    def _peer(self, t):
        return self.peer[tuple(t.shape)].to(t.dtype)

    def all_reduce(self, t, group=None):
        self.dtypes.append(("all_reduce", t.dtype))
        t += self._peer(t)

    def all_gather_into_tensor(self, out, x, group=None):
        self.dtypes.append(("all_gather", x.dtype))
        out.copy_(torch.cat([x, self._peer(x)]))

    def reduce_scatter_tensor(self, out, inp, group=None):
        self.dtypes.append(("reduce_scatter", inp.dtype))
        out.copy_((inp + self._peer(inp)).reshape(2, *out.shape)[0])


def _normal(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_gather_shard_gathers_and_reduce_scatters_in_f32(monkeypatch, dim):
    """The forward is the two blocks joined along ``dim`` (rank 0's
    first); the backward is rank 0's block of the sum of both ranks'
    cotangents, reduced in f32 and returned in the block's dtype."""
    x = _normal(3, 4, 6, seed=1).to(torch.bfloat16)
    peer_x = _normal(3, 4, 6, seed=2).to(torch.bfloat16)
    whole = list(x.shape)
    whole[dim] *= 2
    g = _normal(*whole, seed=3).to(torch.bfloat16)
    peer_g = _normal(*whole, seed=4)
    # the peer's cotangent as the reduce-scatter's (2 · block, ...) input
    # holds it: block j along dim for rank j
    peer_chunks = peer_g.unflatten(dim, (2, x.shape[dim])).movedim(dim, 0)
    fake = _FakeDist({
        tuple(x.shape): peer_x,
        (2 * x.shape[0], *x.shape[1:]):
        peer_chunks.reshape(2 * x.shape[0], *x.shape[1:])})
    monkeypatch.setattr(collectives, "dist", fake)
    xs = x.clone().requires_grad_()
    out = collectives.gather_shard(xs, None, dim)
    torch.testing.assert_close(out, torch.cat([x, peer_x], dim), rtol=0,
                               atol=0)
    (grad,) = torch.autograd.grad(out, xs, g)
    want = (g.float() + peer_g).narrow(dim, 0, x.shape[dim])
    assert grad.dtype == torch.bfloat16
    torch.testing.assert_close(grad, want.to(torch.bfloat16), rtol=0,
                               atol=0)
    assert fake.dtypes == [("all_gather", torch.bfloat16),
                           ("reduce_scatter", torch.float32)]


def test_gather_from_region_keeps_the_rank_block_of_the_cotangent(
        monkeypatch):
    x, peer = _normal(2, 3, 5, seed=5), _normal(2, 3, 5, seed=6)
    fake = _FakeDist({(2, 3, 5): peer})
    monkeypatch.setattr(collectives, "dist", fake)
    xs = x.clone().requires_grad_()
    out = collectives.gather_from_region(xs, None, 2)
    torch.testing.assert_close(out, torch.cat([x, peer], 2), rtol=0,
                               atol=0)
    g = _normal(2, 3, 10, seed=7)
    (grad,) = torch.autograd.grad(out, xs, g)
    torch.testing.assert_close(grad, g[..., :5], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_f_and_g_are_adjoint(monkeypatch, dtype):
    """*f* is the identity forward and sums the cotangents over the group
    backward; *g* sums forward and passes the cotangent backward. Over
    the two-rank world (this rank's values and the peer's), the dot
    product of g's output with a cotangent equals that of the inputs
    with f's backward of it, and both sums run in f32 and come back in
    the tensors' dtype."""
    to_region, from_region = collectives.to_region, collectives.from_region
    x, peer_x = _normal(4, 6, seed=8), _normal(4, 6, seed=9)
    y = _normal(4, 6, seed=10)
    fake = _FakeDist({(4, 6): peer_x})
    monkeypatch.setattr(collectives, "dist", fake)
    xs = x.to(dtype).clone().requires_grad_()
    out = from_region(xs, None)
    assert out.dtype == dtype
    torch.testing.assert_close(
        out, (x.to(dtype).float() + peer_x).to(dtype),
        rtol=0, atol=0)
    (gx,) = torch.autograd.grad(out, xs, y.to(dtype))
    torch.testing.assert_close(gx, y.to(dtype), rtol=0, atol=0)
    fake.peer[(4, 6)] = y   # the peer's cotangent of f's output
    ys = x.to(dtype).clone().requires_grad_()
    (u,) = to_region((ys,), None)
    torch.testing.assert_close(u, x.to(dtype), rtol=0, atol=0)
    (gy,) = torch.autograd.grad(u, ys, y.to(dtype))
    assert gy.dtype == dtype
    torch.testing.assert_close(gy, (y.to(dtype).float() + y).to(dtype),
                               rtol=0, atol=0)
    # <g(x_0, x_1), y> = <x_0, y> + <x_1, y> = <(x_0, x_1), f^T y>
    lhs = float(((x + peer_x) * y).sum())
    rhs = float((x * y).sum() + (peer_x * y).sum())
    assert math.isclose(lhs, rhs, rel_tol=1e-5)
    assert {d for _, d in fake.dtypes} == {torch.float32}


def test_held_block_reads_whole_and_split_dims(monkeypatch):
    monkeypatch.setattr(tsharding, "mesh_sizes", lambda mesh: {"tp": 4})
    monkeypatch.setattr(tsharding, "mesh_coords", lambda mesh: {"tp": 3})
    assert tsharding.held_block(object(), "tp", 32, 32) == (0, 32)
    assert tsharding.held_block(object(), "tp", 8, 32) == (24, 8)
    assert tsharding.held_block(None, "tp", 32, 32) == (0, 32)
    with pytest.raises(ValueError, match="neither whole nor a block"):
        tsharding.held_block(object(), "tp", 16, 32)


@pytest.mark.parametrize("H,KV,tp,want", [
    (32, 8, 4, [(0, 8, 0, 2), (8, 16, 2, 4), (16, 24, 4, 6),
                (24, 32, 6, 8)]),
    (4, 2, 4, [(0, 1, 0, 1), (1, 2, 0, 1), (2, 3, 1, 2), (3, 4, 1, 2)]),
    (4, 2, 2, [(0, 2, 0, 1), (2, 4, 1, 2)]),
    (8, 8, 2, [(0, 4, 0, 4), (4, 8, 4, 8)]),
])
def test_tp_heads_read_the_kv_heads_of_their_q_heads(H, KV, tp, want):
    got = [tsharding.tp_heads(H, KV, tp, t) for t in range(tp)]
    assert got == want
    rep = H // KV
    for h0, h1, kv0, kv1 in got:
        assert {h // rep for h in range(h0, h1)} == set(range(kv0, kv1))


def test_tp_heads_refuse_heads_that_do_not_split():
    with pytest.raises(ValueError, match="do not split over tp"):
        tsharding.tp_heads(6, 2, 4, 0)
    with pytest.raises(ValueError, match="neither split"):
        tsharding.tp_heads(12, 3, 2, 0)


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------


def _jax_config(layout):
    """The JAX twin of ``torch_ranks.block_config(layout)`` (dense
    attention: the port's side runs the flash path's plain versions)."""
    spec = RANKS.BLOCK_LAYOUTS[layout]
    kw = dict(spec.get("config", {}))
    if spec["family"] == "moe":
        return dataclasses.replace(jm.MoEConfig.tiny(), dtype=jnp.float32,
                                   remat=True, use_flash_attention=False,
                                   **kw)
    kw.setdefault("n_layers", 2)
    if spec["family"] == "llama":
        kw = {**RANKS.PARALLEL_MODEL, **kw}
    return dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                               remat=True, use_flash_attention=False, **kw)


def _family(jc):
    return jm if isinstance(jc, jm.MoEConfig) else jl


def _inputs(layout):
    """The params (the JAX init), a batch for the loss and the trainer's
    batches. The MoE layout takes the batches of
    ``tests/test_torch_moe.py::test_three_trainer_steps_match_jax`` and
    the pipeline layout the tokens and batches of
    ``tests/test_torch_parallel.py``'s pp mode (9 tokens a row): on other
    draws Adam can lift one element's f32 rounding past PARAM_ATOL after
    3 steps, one process alone included."""
    jc = _jax_config(layout)
    params = _family(jc).init_params(jc, jax.random.PRNGKey(0))
    if layout == "pp_fsdp":
        rng = np.random.default_rng(3)
        rng.standard_normal((2, 2, 8, 8))   # that mode's toy stage's draws
        rng.standard_normal((4, 8, 8))
        tokens = rng.integers(0, jc.vocab_size, (8, 9))
        batches = rng.integers(0, jc.vocab_size, (3, GLOBAL_BATCH, 9))
    elif isinstance(jc, jm.MoEConfig):
        rng = np.random.default_rng(12)
        tokens = rng.integers(0, jc.vocab_size, (2, SEQ + 1))
        batches = np.random.default_rng(1).integers(
            0, jc.vocab_size, (3, GLOBAL_BATCH, SEQ + 1))
    else:
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, jc.vocab_size, (GLOBAL_BATCH, SEQ + 1))
        batches = rng.integers(0, jc.vocab_size, (3, GLOBAL_BATCH, SEQ + 1))
    return dict(tokens=tokens.astype(np.int32),
                batches=batches.astype(np.int32),
                **{f"params/{k}": v
                   for k, v in RANKS.flat(_np(params)).items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(layout)`` → ``(inputs, RESULT dicts by rank, arrays by
    rank)``; each launch runs once, all its layouts."""
    done = {}

    def get(layout):
        n = LAYOUTS[layout]
        if n not in done:
            out = str(tmp_path_factory.mktemp(f"blocks{n}"))
            inputs = {m: _inputs(m) for m in LAUNCHES[n]}
            for m, inp in inputs.items():
                np.savez(os.path.join(out, f"{m}_inputs.npz"), **inp)
            res = RANKS.launch(n, ",".join(LAUNCHES[n]), LAUNCHES[n], out,
                               f"b{n}_{os.getpid()}", timeout=300)
            done[n] = out, inputs, res
        out, inputs, res = done[n]
        arrays = [dict(np.load(os.path.join(out, f"{layout}{n}_{r}.npz")))
                  for r in range(n)]
        return inputs[layout], {r: v[layout] for r, v in res.items()}, arrays

    return get


def _jax_mesh(layout):
    n = LAYOUTS[layout]
    plan = jmesh.plan_mesh(n, **LAUNCHES[n][layout])
    return jmesh.build_mesh(plan, jax.devices()[:n])


def _jax_loss_and_grads(inp, layout):
    jc = _jax_config(layout)
    fam = _family(jc)
    mesh = _jax_mesh(layout)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          RANKS.unflat(inp, "params/"))
    params = jsharding.shard_tree(mesh, params, fam.param_logical_axes(jc))
    if layout == "pp_fsdp":
        def loss_fn(p, t):
            return jl.next_token_loss_pp(p, t, jc, mesh)
    else:
        def loss_fn(p, t):
            return fam.next_token_loss(p, t, jc, mesh)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(inp["tokens"]))
    return float(loss), RANKS.flat(_np(grads))


def _assert_leaves(got, ref, atol):
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=atol,
                                   err_msg=name)


def _prefixed(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_loss_and_grads_on_blocks_match_jax(ranks, layout):
    """Every rank's mean loss and every leaf's mean grad (the trainer's
    reduction of the ranks' block grads, gathered whole) against the
    reference's loss and ``jax.grad`` on its mesh of the same layout."""
    inp, _, arrays = ranks(layout)
    loss, grads = _jax_loss_and_grads(inp, layout)
    for a in arrays:
        np.testing.assert_allclose(float(a["loss"]), loss, atol=LOSS_ATOL)
    _assert_leaves(_prefixed(arrays[0], "grad/"), grads, GRAD_ATOL)


def test_whole_weights_under_tp_enter_the_region_through_f(ranks):
    """tp 2 with ``tp`` not among the local axes: the ranks hold whole
    weights, attend with their own heads and columns of them (each
    entering the region through f, so the slices' grads sum over tp),
    and the loss and grads are the reference's."""
    inp, _, arrays = ranks("tp2")
    loss, grads = _jax_loss_and_grads(inp, "tp2")
    for a in arrays:
        np.testing.assert_allclose(float(a["loss_whole"]), loss,
                                   atol=LOSS_ATOL)
    _assert_leaves(_prefixed(arrays[0], "grad_whole/"), grads, GRAD_ATOL)


def _jax_steps(inp, layout):
    """3 steps of the JAX trainer (plain loss, one device) from the same
    params on the same batches: losses, norms, final params."""
    jc = _jax_config(layout)
    fam = _family(jc)
    jt = je.ElasticTrainer(lambda p, t: fam.next_token_loss(p, t, jc),
                           optax.adamw(3e-4), GLOBAL_BATCH,
                           GLOBAL_BATCH // 2)
    jt.configure_for_world(jmesh.plan_mesh(1))
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          RANKS.unflat(inp, "params/"))
    state = je.make_train_state(params, jt._optimizer)
    steps = []
    for b in inp["batches"]:
        state, r = jt.train_step(state, jnp.asarray(b.reshape(
            jt.grad_accum_steps, jt.micro_batch_global, -1)))
        steps.append([float(r.loss), float(r.grad_norm)])
    return steps, RANKS.flat(_np(state["params"]))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_trainer_steps_on_blocks_match_jax(ranks, layout):
    """3 ``ElasticTrainer`` steps with ``fsdp`` and ``tp`` local against
    the JAX trainer: every rank reports the same steps, and the final
    params are the reference's."""
    inp, res, arrays = ranks(layout)
    ref_steps, ref_params = _jax_steps(inp, layout)
    got = np.array(res[0]["train"])
    for r in res:
        assert res[r]["train"] == res[0]["train"]
    ref = np.array(ref_steps)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=STEP_NORM_RTOL)
    _assert_leaves(_prefixed(arrays[0], "train/"), ref_params, PARAM_ATOL)


def _blocks(inp, layout, rank):
    """``name -> (block shape, whole shape)`` of every leaf at ``rank``
    under the layout's plan (the port's placement rules)."""
    n = LAYOUTS[layout]
    plan = LAUNCHES[n][layout]
    from dlrover_tpu_torch.parallel.mesh import plan_coords, plan_mesh

    mesh_plan = plan_mesh(n, **plan)
    sizes, coords = mesh_plan.axes, plan_coords(mesh_plan, rank)
    jc = _jax_config(layout)
    axes = RANKS.flat(_family(jc).param_logical_axes(jc))
    out = {}
    for name, a in _prefixed(inp, "params/").items():
        spec = tsharding.valid_spec_for(sizes, a.shape, axes[name])
        out[name] = (tsharding.region_for(a.shape, spec, sizes, coords)[1],
                     a.shape)
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_the_step_computes_on_blocks(ranks, layout):
    """What each rank computed on: the layer leaves the loss took, the
    trainer's f32 accumulators and the ledger's ``trainer/grad_accum``
    claim are the rank's blocks; each fsdp gather is one layer's block,
    run in the forward and again in the recompute (remat "dots"); every
    K1 call attends with the rank's own q heads."""
    inp, res, _ = ranks(layout)
    n = LAYOUTS[layout]
    plan = LAUNCHES[n][layout]
    jc = _jax_config(layout)
    tp, fsdp = plan.get("tp", 1), plan.get("fsdp", 1)
    for r in res:
        blocks = _blocks(inp, layout, r)
        seen = res[r]["seen"]
        layers = {n_[len("layers/"):]: list(b)
                  for n_, (b, _) in blocks.items()
                  if n_.startswith("layers/")}
        assert seen["layers"] == layers
        live = res[r]["train_live"]
        want = sorted(tuple(b) for b, _ in blocks.values())
        assert sorted(map(tuple, live["accum_shapes"])) == want
        assert live["accum_bytes"] == 4 * sum(math.prod(s) for s in want)
        if layout == "fsdp4":
            # every leaf with an embed dim holds a quarter of it
            for name, (b, whole) in blocks.items():
                if "norm" not in name:
                    assert 4 * math.prod(b) == math.prod(whole), name
        assert set(seen["heads"]) == {jc.n_heads // tp}
        gathers = Counter((tuple(s), d) for s, d in seen["gathers"])
        axes = RANKS.flat(_family(jc).param_logical_axes(jc))
        L = jc.n_layers // plan.get("pp", 1)
        want = Counter()
        for name, (b, whole) in blocks.items():
            layer = name.startswith("layers/")
            # the embed dim, where fsdp splits it: one layer's block in
            # the forward and the recompute, an end's once
            lead = 1 if layer else 0
            for d, ax in enumerate(axes[name][lead:]):
                if ax == "embed" and b[lead + d] != whole[lead + d]:
                    want[(tuple(b[lead:]), d)] += 2 * L if layer else 1
        hd = jc.dim // jc.n_heads
        kv_cols = jc.n_kv_heads * hd
        if tp > 1 and kv_cols // tp % hd:
            # KV heads split finer than a head: wk and wv gathered over tp
            want[((jc.dim, kv_cols // tp), 1)] += 2 * 2 * L
        if tp > 1 and jc.vocab_size % tp == 0:
            # the vocab-split logits of the rank's rows and chunk
            rows = inp["tokens"].shape[0] // (fsdp * plan.get("dp", 1))
            want[((rows, SEQ // plan.get("sp", 1), jc.vocab_size // tp),
                  2)] += 1
        if layout == "pp_fsdp":
            # a pipeline stage runs its layers at every tick
            for key, k in want.items():
                assert gathers[key] >= k, (key, gathers)
        else:
            assert gathers == want
        # no gather of a whole stacked leaf: each is one layer's, or an
        # end's (tok_embed, lm_head), or a KV block split finer than a head
        for shape, d in gathers:
            assert len(shape) <= 3, shape
