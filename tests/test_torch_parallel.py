"""The port's sequence and pipeline parallelism against the JAX package's.

In process: ``_merge_partials`` (empty rows included), the stage packing
helpers, ``_local_heads``, and an sp config with no mesh, which computes
plain attention. Across gloo ranks (``tests/data/torch_ranks.py`` modes
``sp`` and ``pp``, in two launches of 2 and 4 ranks): ring attention at
sp = 2 and 4 (both bodies), Ulysses at sp = 2 with GQA and its refusal
at sp = 4, the sequence-parallel loss with every leaf's grad,
``pipeline_apply`` on the reference tests' linear stage and
``next_token_loss_pp`` at pp = 2 and pp × dp, on the whole stack and on
the stage's own layers, and 3 ``ElasticTrainer`` steps per layout (for pp
also with ``local_axes=("pp",)``, where a stage's live layers and f32
accumulators hold its L/pp layers). The ranks read the same numpy inputs
the JAX side gets (on its 8-device CPU mesh); a rank's gradients are its
part of the gradient of the sum of the ranks' losses, so their mean (the
trainer's reduction) is the gradient of the mean loss. f32 throughout;
the port's flash path runs the plain version of K1-K3.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.parallel import pipeline as jp  # noqa: E402
from dlrover_tpu.parallel import ring_attention as jr  # noqa: E402
from dlrover_tpu.parallel import ulysses as ju  # noqa: E402
from dlrover_tpu.parallel.mesh import plan_mesh as jplan  # noqa: E402
from dlrover_tpu.trainer import elastic as je  # noqa: E402
from dlrover_tpu_torch.convert import params_from_jax  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.parallel import pipeline as tp  # noqa: E402
from dlrover_tpu_torch.parallel import ring_attention as tr  # noqa: E402
from dlrover_tpu_torch.parallel import ulysses as tu  # noqa: E402

B, H, KV, S, D = 2, 4, 2, 16, 8
GLOBAL_BATCH = 4
# tests/test_parallel.py, test_ulysses.py and test_pipeline.py
ATTN_ATOL, ATTN_GRAD_ATOL, PIPE_ATOL = 2e-5, 2e-4, 1e-5
# the model's loss and leaf grads (tests/test_torch_llama.py) and the
# trainer's steps (tests/test_torch_trainer.py)
LOSS_ATOL, GRAD_ATOL = 1e-5, 1e-4
STEP_LOSS_RTOL, STEP_NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5


def _ranks_module():
    spec = importlib.util.spec_from_file_location(
        "torch_ranks", os.path.join(os.path.dirname(__file__), "data",
                                    "torch_ranks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RANKS = _ranks_module()


def _jax_config(**kw):
    return dataclasses.replace(
        jl.LlamaConfig.tiny(), dtype=jnp.float32,
        **{**RANKS.PARALLEL_MODEL, **kw})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


def _partials(case):
    rng = np.random.default_rng(0)
    o1, o2 = (rng.standard_normal((B, H, S, D)).astype(np.float32)
              for _ in range(2))
    lse1, lse2 = (rng.standard_normal((B, H, S)).astype(np.float32) * 3
                  for _ in range(2))
    if case in ("one_empty", "both_empty"):
        lse2[:, :, ::2] = -1e30
    if case == "both_empty":
        lse1[:, :, ::4] = -1e30
    return o1, lse1, o2, lse2


@pytest.mark.parametrize("case", ["random", "one_empty", "both_empty"])
def test_merge_partials_matches_jax(case):
    """Values, and the vjp into both partials' o and lse."""
    args = _partials(case)
    rng = np.random.default_rng(1)
    do = rng.standard_normal((B, H, S, D)).astype(np.float32)
    dlse = rng.standard_normal((B, H, S)).astype(np.float32)
    ref, vjp = jax.vjp(jr._merge_partials, *map(jnp.asarray, args))
    ref_grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    o, lse = tr._merge_partials(*targs)
    grads = torch.autograd.grad(
        (o, lse), targs, (torch.from_numpy(do), torch.from_numpy(dlse)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref[0]),
                               atol=1e-6)
    np.testing.assert_array_equal(lse.detach().numpy() == -1e30,
                                  np.asarray(ref[1]) == -1e30)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(ref[1]),
                               atol=1e-5)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_stage_helpers_match_jax():
    w = np.arange(24, dtype=np.float32).reshape(6, 4)
    tree = {"w": w, "n": {"v": w[:, :1]}}
    for n in (1, 2, 3, 6):
        ref = _np(jp.stack_stages(jax.tree.map(jnp.asarray, tree), n))
        got = tp.stack_stages(jax.tree.map(torch.from_numpy, tree), n)
        np.testing.assert_array_equal(got["w"].numpy(), ref["w"])
        np.testing.assert_array_equal(got["n"]["v"].numpy(), ref["n"]["v"])
        back = tp.unstack_stages(got)
        np.testing.assert_array_equal(back["w"].numpy(), w)
    x = np.arange(24, dtype=np.float32).reshape(6, 2, 2)
    for n in (1, 2, 3, 6):
        mb = tp.microbatch(torch.from_numpy(x), n)
        np.testing.assert_array_equal(
            mb.numpy(), np.asarray(jp.microbatch(jnp.asarray(x), n)))
        np.testing.assert_array_equal(tp.unmicrobatch(mb).numpy(), x)
    for s, m in ((1, 1), (2, 4), (4, 12), (4, 16), (8, 3)):
        assert tp.bubble_fraction(s, m) == jp.bubble_fraction(s, m)


def test_stage_helpers_raise_as_jax():
    w = {"w": np.zeros((6, 4), np.float32)}
    with pytest.raises(ValueError, match="not divisible into 4") as ref:
        jp.stack_stages(jax.tree.map(jnp.asarray, w), 4)
    with pytest.raises(ValueError) as got:
        tp.stack_stages(jax.tree.map(torch.from_numpy, w), 4)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        jp.microbatch(jnp.zeros((6, 2)), 4)
    with pytest.raises(ValueError) as got:
        tp.microbatch(torch.zeros((6, 2)), 4)
    assert str(got.value) == str(ref.value)


def test_local_heads_matches_jax():
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("dp", "sp", "tp"))
    for spec in ((None, None, "sp", None), (None, "tp", "sp", None),
                 (("dp",), ("dp", "tp"), None, None), ()):
        for n in (8, 12):
            assert tu._local_heads(dict(mesh.shape), spec, n) == \
                ju._local_heads(mesh, spec, n)


@pytest.mark.parametrize("sp", [dict(sp_attention="ring"),
                                dict(sp_attention="ulysses"),
                                dict(use_ring_attention=True)],
                         ids=["ring", "ulysses", "legacy"])
def test_sp_config_without_mesh_is_plain_attention(sp):
    """With no mesh an sp config computes plain attention, as the
    reference's: the loss and every leaf's grad match JAX's."""
    jc = _jax_config(n_layers=2, use_flash_attention=False, **sp)
    tc = RANKS.parallel_config(n_layers=2, use_flash_attention=False, **sp)
    params = jl.init_params(jc, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 17)).astype(np.int32)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p, t: jl.next_token_loss(p, t, jc)))(params,
                                                     jnp.asarray(tokens))
    tparams = params_from_jax(_np(params), "cpu")
    named = RANKS.flat(tparams)
    for t in named.values():
        t.requires_grad_(True)
    loss = tl.next_token_loss(tparams, torch.from_numpy(tokens), tc)
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=LOSS_ATOL)
    ref_named = RANKS.flat(_np(ref_grads))
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), ref_named[name],
                                   atol=GRAD_ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

# the two launches: ranks → each mode's plan (its own mesh over the ranks)
LAUNCHES = {2: {"sp": {"sp": 2}, "pp": {"pp": 2}},
            4: {"sp": {"sp": 4}, "pp": {"pp": 2, "dp": 2, "fsdp": 1}}}
# a layout → (mode, ranks)
LAYOUTS = {"sp2": ("sp", 2), "sp4": ("sp", 4), "pp2": ("pp", 2),
           "pp2dp2": ("pp", 4)}


def _sp_inputs():
    rng = np.random.default_rng(2)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    jc = _jax_config(n_layers=2)
    return dict(
        q=normal(B, H, S, D), k=normal(B, H, S, D), v=normal(B, H, S, D),
        kv_k=normal(B, KV, S, D), kv_v=normal(B, KV, S, D),
        w=normal(B, H, S, D),
        tokens=rng.integers(0, jc.vocab_size, (2, S + 1)).astype(np.int32),
        batches=rng.integers(0, jc.vocab_size, (3, GLOBAL_BATCH, S + 1)
                             ).astype(np.int32),
        **{f"params/{k}": v for k, v in RANKS.flat(_np(jl.init_params(
            jc, jax.random.PRNGKey(0)))).items()})


def _pp_inputs():
    rng = np.random.default_rng(3)
    jc = _jax_config(n_layers=4)
    return dict(
        ws=(rng.standard_normal((2, 2, D, D)) * 0.3).astype(np.float32),
        x=rng.standard_normal((4, 8, D)).astype(np.float32),
        tokens=rng.integers(0, jc.vocab_size, (8, 9)).astype(np.int32),
        batches=rng.integers(0, jc.vocab_size, (3, GLOBAL_BATCH, 9)
                             ).astype(np.int32),
        **{f"params/{k}": v for k, v in RANKS.flat(_np(jl.init_params(
            jc, jax.random.PRNGKey(0)))).items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(layout)`` → ``(inputs, the mode's RESULT dicts by rank,
    arrays by rank)``; each launch runs once, both its modes."""
    done = {}
    inputs = {"sp": _sp_inputs(), "pp": _pp_inputs()}

    def get(layout):
        mode, n = LAYOUTS[layout]
        if n not in done:
            out = str(tmp_path_factory.mktemp(f"ranks{n}"))
            for m, inp in inputs.items():
                np.savez(os.path.join(out, f"{m}_inputs.npz"), **inp)
            done[n] = out, RANKS.launch(n, "sp,pp", LAUNCHES[n], out,
                                        f"t{n}_{os.getpid()}")
        out, res = done[n]
        arrays = [dict(np.load(os.path.join(out, f"{mode}{n}_{r}.npz")))
                  for r in range(n)]
        return inputs[mode], {r: v[mode] for r, v in res.items()}, arrays

    return get


def _sp_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _chunks(arrays, name):
    """The ranks' sequence chunks of ``name``, joined in rank order."""
    return np.concatenate([a[name] for a in arrays], axis=2)


@pytest.mark.parametrize("key", ["sp2", "sp4"])
@pytest.mark.parametrize("body", ["flash", "dense"])
def test_ring_attention_matches_jax(ranks, key, body):
    """Output and dq, dk, dv (each chunk's grads land on its own rank
    through the reverse hops) against ``jax.grad`` of the reference's ring
    (its Pallas body in interpret mode for ``flash``)."""
    inp, _, arrays = ranks(key)
    mesh = _sp_mesh(int(key[2:]))

    def f(q, k, v):
        out = jr.ring_attention(q, k, v, mesh, use_pallas=body == "flash",
                                block_q=8, block_k=8)
        return (out * jnp.asarray(inp["w"])).sum(), out

    (_, ref), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(inp[x]) for x in "qkv"))
    np.testing.assert_allclose(_chunks(arrays, f"ring_{body}/out"),
                               np.asarray(ref), atol=ATTN_ATOL)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_chunks(arrays, f"ring_{body}/{name}"),
                                   np.asarray(g), atol=ATTN_GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("body", ["flash", "dense"])
def test_ulysses_gqa_matches_jax(ranks, body):
    """sp = 2, 4 q heads over 2 unrepeated KV heads."""
    inp, _, arrays = ranks("sp2")
    mesh = _sp_mesh(2)

    def f(q, k, v):
        out = ju.ulysses_attention(q, k, v, mesh, use_pallas=body == "flash",
                                   block_q=8, block_k=8)
        return (out * jnp.asarray(inp["w"])).sum(), out

    (_, ref), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(inp[x]) for x in ("q", "kv_k", "kv_v")))
    np.testing.assert_allclose(_chunks(arrays, f"ulysses_{body}/out"),
                               np.asarray(ref), atol=ATTN_ATOL)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_chunks(arrays, f"ulysses_{body}/{name}"),
                                   np.asarray(g), atol=ATTN_GRAD_ATOL,
                                   err_msg=name)


def test_ulysses_refuses_indivisible_kv_heads_as_jax(ranks):
    inp, res, _ = ranks("sp4")
    with pytest.raises(ValueError) as ref:
        ju.ulysses_attention(*(jnp.asarray(inp[x])
                               for x in ("q", "kv_k", "kv_v")), _sp_mesh(4))
    assert [res[r]["ulysses_error"] for r in range(4)] == [str(ref.value)] * 4


def _mean_tree(arrays, prefix):
    names = [k[len(prefix):] for k in arrays[0] if k.startswith(prefix)]
    return {n: np.mean([a[prefix + n] for a in arrays], axis=0)
            for n in names}


def _assert_leaves(got, ref, atol):
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("key,strategy", [("sp2", "ring"),
                                          ("sp2", "ulysses"),
                                          ("sp4", "ring")])
def test_sp_loss_and_grads_match_jax(ranks, key, strategy):
    """The mean of the ranks' chunk losses and of their grads (what the
    trainer takes) against the reference's loss and ``jax.grad`` on its
    sp mesh."""
    inp, _, arrays = ranks(key)
    jc = _jax_config(n_layers=2, sp_attention=strategy, remat=True,
                     use_flash_attention=False)
    params = RANKS.unflat(inp, "params/")
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    mesh = _sp_mesh(int(key[2:]))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jl.next_token_loss(p, t, jc, mesh)))(
            params, jnp.asarray(inp["tokens"]))
    got = np.mean([a[f"loss_{strategy}"] for a in arrays])
    np.testing.assert_allclose(got, float(loss), atol=LOSS_ATOL)
    _assert_leaves(_mean_tree(arrays, f"grad_{strategy}/"),
                   RANKS.flat(_np(grads)), GRAD_ATOL)


def _jax_steps(inp, n_layers, micro):
    """3 steps of the JAX trainer (plain loss, one device) from the same
    params on the same batches: losses, norms, final params."""
    jc = _jax_config(n_layers=n_layers, use_flash_attention=False)
    jt = je.ElasticTrainer(lambda p, t: jl.next_token_loss(p, t, jc),
                           optax.adamw(3e-4), GLOBAL_BATCH, micro)
    jt.configure_for_world(jplan(1))
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          RANKS.unflat(inp, "params/"))
    state = je.make_train_state(params, jt._optimizer)
    steps = []
    for b in inp["batches"]:
        state, r = jt.train_step(state, jnp.asarray(b.reshape(
            jt.grad_accum_steps, jt.micro_batch_global, -1)))
        steps.append([float(r.loss), float(r.grad_norm)])
    return steps, RANKS.flat(_np(state["params"]))


def _assert_steps(res, arrays, key, ref_steps, ref_params):
    got = np.array(res[0][key])
    for r in res:
        assert res[r][key] == res[0][key]
    ref = np.array(ref_steps)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=STEP_NORM_RTOL)
    _assert_leaves({n[len(key) + 1:]: v for n, v in arrays[0].items()
                    if n.startswith(key + "/")}, ref_params, PARAM_ATOL)


@pytest.mark.parametrize("key,strategy", [("sp2", "ring"),
                                          ("sp2", "ulysses"),
                                          ("sp4", "ring")])
def test_sp_trainer_steps_match_jax(ranks, key, strategy):
    """3 steps (accum 2) with the sp loss: the trainer must average the
    ranks' chunk grads and losses over sp to take the JAX trainer's
    steps."""
    inp, res, arrays = ranks(key)
    _assert_steps(res, arrays, f"train_{strategy}",
                  *_jax_steps(inp, 2, GLOBAL_BATCH // 2))


def _pp_mesh(key):
    if key == "pp2":
        return Mesh(np.array(jax.devices()[:2]), ("pp",))
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pp", "dp"))


def _rows(a, d, n_data, axis):
    s = a.shape[axis] // n_data
    return np.take(a, range(d * s, (d + 1) * s), axis=axis)


@pytest.mark.parametrize("key", ["pp2", "pp2dp2"])
def test_pipeline_apply_matches_jax(ranks, key):
    """The reference tests' linear stage (tanh(h @ w) per layer): every
    rank returns the last stage's outputs of its rows; the mean of the
    ranks' grads of W is ``jax.grad``'s, and per data rank the mean over
    its pp ranks of the input grads, over the data ranks, is the input's."""
    inp, _, arrays = ranks(key)
    mesh = _pp_mesh(key)
    n_data = 1 if key == "pp2" else 2

    def stage_fn(w, h):
        def layer(h, wi):
            return jnp.tanh(h @ wi), None
        h, _ = jax.lax.scan(layer, h, w)
        return h

    axes = None if key == "pp2" else ("dp",)

    def f(ws, x):
        y = jp.pipeline_apply(stage_fn, ws, x, mesh, batch_axes=axes)
        return (y ** 2).mean(), y

    (_, y), (gw, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(inp["ws"]), jnp.asarray(inp["x"]))
    n = len(arrays)
    for r, a in enumerate(arrays):
        d = r % n_data
        np.testing.assert_allclose(a["toy/y"], _rows(np.asarray(y), d, n_data,
                                                      1), atol=PIPE_ATOL)
    np.testing.assert_allclose(np.mean([a["toy/gw"] for a in arrays], 0),
                               np.asarray(gw), atol=PIPE_ATOL)
    gx_got = np.concatenate([
        np.sum([arrays[r]["toy/gx"] for r in range(n) if r % n_data == d],
               axis=0) / n for d in range(n_data)], axis=1)
    np.testing.assert_allclose(gx_got, np.asarray(gx), atol=PIPE_ATOL)


@pytest.mark.parametrize("key", ["pp2", "pp2dp2"])
def test_next_token_loss_pp_matches_jax(ranks, key):
    """M = the default (largest divisor of the rows ≤ 4·pp), every stage
    checkpointed per tick (remat off); loss and every leaf's grad."""
    inp, _, arrays = ranks(key)
    jc = _jax_config(n_layers=4, remat=False, use_flash_attention=False)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          RANKS.unflat(inp, "params/"))
    mesh = _pp_mesh(key)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jl.next_token_loss_pp(p, t, jc, mesh)))(
            params, jnp.asarray(inp["tokens"]))
    np.testing.assert_allclose(np.mean([a["loss_pp"] for a in arrays]),
                               float(loss), atol=LOSS_ATOL)
    _assert_leaves(_mean_tree(arrays, "grad_pp/"), RANKS.flat(_np(grads)),
                   GRAD_ATOL)


@pytest.mark.parametrize("key", ["pp2", "pp2dp2"])
def test_pp_trainer_steps_match_jax(ranks, key):
    """3 steps of ``next_token_loss_pp`` (remat per layer): the trainer's
    mean over pp must count the ends' and the stages' grads once."""
    inp, res, arrays = ranks(key)
    _assert_steps(res, arrays, "train_pp",
                  *_jax_steps(inp, 4, GLOBAL_BATCH // 2))


def _stage_grads(arrays, key, prefix, n_layers):
    """The mean over ranks of the stage-local grads as whole-model grads:
    a stage's layer grads in its rows of the stack (zeros elsewhere, as
    no other stage touches them), the ends as they are."""
    pp = 2
    n_data = len(arrays) // pp
    out = {}
    for name in (k[len(prefix):] for k in arrays[0] if k.startswith(prefix)):
        if not name.startswith("layers/"):
            out[name] = np.mean([a[prefix + name] for a in arrays], axis=0)
            continue
        block = arrays[0][prefix + name].shape[0]
        assert block == n_layers // pp
        full = np.zeros((n_layers,) + arrays[0][prefix + name].shape[1:],
                        np.float32)
        for r, a in enumerate(arrays):
            stage = r // n_data
            full[stage * block:(stage + 1) * block] += a[prefix + name]
        out[name] = full / len(arrays)
    return out


@pytest.mark.parametrize("key", ["pp2", "pp2dp2"])
def test_next_token_loss_pp_on_stage_layers_matches_jax(ranks, key):
    """Each stage given only its own L/pp layers: its grads are those
    layers' (the whole model's, placed in the stage's rows, against
    ``jax.grad``) and the ends'; the loss is the reference's."""
    inp, _, arrays = ranks(key)
    jc = _jax_config(n_layers=4, remat=False, use_flash_attention=False)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          RANKS.unflat(inp, "params/"))
    mesh = _pp_mesh(key)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jl.next_token_loss_pp(p, t, jc, mesh)))(
            params, jnp.asarray(inp["tokens"]))
    np.testing.assert_allclose(np.mean([a["loss_pp_local"] for a in arrays]),
                               float(loss), atol=LOSS_ATOL)
    _assert_leaves(_stage_grads(arrays, key, "grad_pp_local/", 4),
                   RANKS.flat(_np(grads)), GRAD_ATOL)


@pytest.mark.parametrize("key", ["pp2", "pp2dp2"])
def test_pp_trainer_steps_on_stage_layers_match_jax(ranks, key):
    """3 steps with ``local_axes=("pp",)``: a stage gathers, computes and
    accumulates its own 2 of the 4 layers (the live layer leaves and
    their f32 accumulators, and the bytes the ledger claims), and the
    steps are the JAX trainer's."""
    inp, res, arrays = ranks(key)
    _assert_steps(res, arrays, "train_pp_local",
                  *_jax_steps(inp, 4, GLOBAL_BATCH // 2))
    whole = {n: v.shape for n, v in arrays[0].items()
             if n.startswith("train_pp_local/")}
    want = sorted(
        (2,) + tuple(shape[1:]) if name.startswith("train_pp_local/layers/")
        else tuple(shape) for name, shape in whole.items())
    for r in res:
        live = res[r]["train_pp_local_live"]
        assert {n: s[0] for n, s in live["layers"].items()} == dict.fromkeys(
            live["layers"], 2)
        assert sorted(map(tuple, live["accum_shapes"])) == want
        assert live["accum_bytes"] == 4 * sum(int(np.prod(s)) for s in want)
