"""The port's Mixtral-class MoE against the JAX package's.

The same JAX-initialised params (f32 unless stated, carried over with
``params_from_jax``) and the same seeded numpy inputs go through
``dlrover_tpu.models.moe`` / ``models.decode`` / ``serving.engine`` /
``trainer.elastic`` and their counterparts in ``dlrover_tpu_torch``:

- ``_route``: the dispatch and combine tensors the port's indices stand
  for equal the reference's (dispatch exactly), and the aux term, with
  capacity drops, with ``route_group_size``, and with exact ties (two
  router columns equal, duplicated token rows);
- ``_moe_ffn`` (f32 and bf16), ``forward`` logits and aux (1e-4, as
  ``test_torch_llama.py``), loss and grads against ``jax.grad`` of
  ``next_token_loss`` with remat off, "dots" and None, the router's grad
  included;
- ``num_params`` and the configs (46.7B total, 12.9B active);
- prefill, decode_step (5e-4, as ``tests/test_decode.py``) and greedy
  ``generate`` tokens on the f32 and int8 cache; cached steps
  teacher-forced against ``forward`` at ``capacity_factor = n_experts``;
- the engine on ragged slots, ``prefill_with_prefix`` and
  ``decode_window`` against the JAX engine and function, one case at a
  low capacity factor where the bucket's pads change the routing in both
  packages alike;
- ``params_from_jax`` / ``train_state_from_jax`` on a MoE train state,
  and 3 ``ElasticTrainer`` steps against the JAX trainer with
  ``optax.adamw``;
- the ``expert`` → ``ep`` regions against the JAX package's on its
  8-device CPU mesh, and 2 gloo ranks at ``ep=2`` (``tests/data/
  torch_ranks.py`` mode ``moe``): the ranks' expert blocks, 3 trainer
  steps against one plain process, a Flash Checkpoint round trip.
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

from dlrover_tpu.models import decode as jd  # noqa: E402
from dlrover_tpu.models import moe as jm  # noqa: E402
from dlrover_tpu.parallel import mesh as jmesh  # noqa: E402
from dlrover_tpu.parallel import sharding as jsharding  # noqa: E402
from dlrover_tpu.serving import engine as je  # noqa: E402
from dlrover_tpu.trainer import elastic as jt  # noqa: E402
from dlrover_tpu_torch.ckpt.shm_handler import shm_name  # noqa: E402
from dlrover_tpu_torch.common.multi_process import (  # noqa: E402
    unlink_shared_memory,
)
from dlrover_tpu_torch.convert import (  # noqa: E402
    jax_leaf_name,
    named_leaves,
    params_from_jax,
    train_state_from_jax,
)
from dlrover_tpu_torch.models import decode as td  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.models import moe as tm  # noqa: E402
from dlrover_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from dlrover_tpu_torch.serving import engine as te  # noqa: E402
from dlrover_tpu_torch.trainer import elastic as tt  # noqa: E402
from dlrover_tpu_torch.trainer.optim import adamw  # noqa: E402

ATOL = 1e-4          # logits, as tests/test_torch_llama.py
DECODE_ATOL = 5e-4   # cached decode, as tests/test_decode.py


def _configs(dtype=None, **kw):
    kw.setdefault("max_seq_len", 64)
    jc = dataclasses.replace(jm.MoEConfig.tiny(),
                             dtype=dtype or jnp.float32, **kw)
    tc = dataclasses.replace(
        tm.MoEConfig.tiny(),
        dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32,
        **kw)
    return jc, tc


def _tp(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _params(jc, seed=0):
    params = jm.init_params(jc, jax.random.PRNGKey(seed))
    return params, _tp(params)


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# -- routing -----------------------------------------------------------------


def _dense_route(expert, slot, kept, gates, E, C):
    """The (G, g, E, C) dispatch and combine tensors the port's indices
    stand for."""
    G, g, k = expert.shape
    dispatch = np.zeros((G, g, E, C), np.float32)
    combine = np.zeros((G, g, E, C), np.float32)
    for gi, t, ki in zip(*np.nonzero(kept.numpy())):
        e, c = int(expert[gi, t, ki]), int(slot[gi, t, ki])
        dispatch[gi, t, e, c] += 1.0
        combine[gi, t, e, c] += float(gates[gi, t, ki])
    return dispatch, combine


# (config overrides, token rows, sequence, tie): "drops" at a low capacity
# factor, "groups" routing 8-token groups across rows, "ties" with two
# equal router columns and duplicated token rows
ROUTE_CASES = {
    "plain": (dict(), 2, 24, False),
    "drops": (dict(capacity_factor=0.5), 2, 24, False),
    "groups": (dict(route_group_size=8), 3, 16, False),
    "ties": (dict(capacity_factor=0.75), 2, 24, True),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_matches_jax(case):
    kw, B, S, tie = ROUTE_CASES[case]
    jc, tc = _configs(**kw)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, jc.dim)).astype(np.float32)
    router = (rng.standard_normal((jc.dim, jc.n_experts))
              * jc.dim ** -0.5).astype(np.float32)
    if tie:
        router[:, 2] = router[:, 1]
        x[:, 1::3] = x[:, 0::3]
    g = jm._group_size(jc, B, S)
    cap = jm.expert_capacity(jc, B, S)
    assert (tm._group_size(tc, B, S), tm.expert_capacity(tc, B, S)) == (
        g, cap)
    xg = x.reshape(B * S // g, g, jc.dim)
    dispatch, combine, aux = jm._route(jnp.asarray(xg), jnp.asarray(router),
                                       jc, cap)
    expert, slot, kept, gates, taux = tm._route(
        torch.from_numpy(xg), torch.from_numpy(router), tc, cap)
    d, c = _dense_route(expert, slot, kept, gates, jc.n_experts, cap)
    np.testing.assert_array_equal(d, np.asarray(dispatch))
    np.testing.assert_allclose(c, np.asarray(combine), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-6)
    if case in ("drops", "ties"):
        assert not bool(kept.all())  # the case really drops choices
    if tie:
        # the lower expert of a tie comes first, as lax.top_k
        both = (expert == 1).any(-1) & (expert == 2).any(-1)
        assert bool(both.any())
        assert not bool(((expert[..., 0] == 2) & both).any())
        # a tie at the k-th place keeps expert 1, never expert 2 alone
        assert not bool(((expert == 2).any(-1)
                         & ~(expert == 1).any(-1)).any())


# sequence-parallel routing folds: (token rows, sequence, group size) with
# the group one sequence (it spans every chunk), two sequences, inside a
# chunk, and 16 tokens, which straddle the chunk boundaries
SP_ROUTE_CASES = {
    "sequence": (2, 24, None),
    "two_sequences": (4, 24, 48),
    "inside_chunk": (2, 24, 6),
    "straddle": (4, 24, 16),
}


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("case", sorted(SP_ROUTE_CASES))
def test_sp_route_chunks_equal_whole_sequence_routing(case, sp):
    """The sp ranks' routing (``fold_routes`` of each chunk's choices:
    every chunk's top-k gathered, the slots taken on whole groups, the
    probability sums added), folded on one process: each chunk's
    experts, slots, kept flags and gates are exactly those of routing the
    whole batch at once, and its aux term is the reference's
    ``_route``'s."""
    B, S, g = SP_ROUTE_CASES[case]
    jc, tc = _configs(route_group_size=g)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, jc.dim)).astype(np.float32)
    router = (rng.standard_normal((jc.dim, jc.n_experts))
              * jc.dim ** -0.5).astype(np.float32)
    g = tm._group_size(tc, B, S)
    cap = tm.expert_capacity(tc, B, S)
    whole = tm._route(torch.from_numpy(x.reshape(B * S // g, g, jc.dim)),
                      torch.from_numpy(router), tc, cap)
    _, _, ref_aux = jm._route(jnp.asarray(x.reshape(B * S // g, g, jc.dim)),
                              jnp.asarray(router), jc, cap)
    s = S // sp
    chunks = tm.fold_routes(
        [tm._choices(torch.from_numpy(x[:, r * s:(r + 1) * s]),
                     torch.from_numpy(router), tc) for r in range(sp)],
        tc, cap, g)
    for i, name in enumerate(("expert", "slot", "kept", "gates")):
        got = torch.cat([out[i] for out in chunks], dim=1)
        assert torch.equal(got, whole[i].reshape(B, S, -1)), name
    for out in chunks:
        np.testing.assert_allclose(float(out[4]), float(ref_aux), rtol=1e-6)
    if case == "inside_chunk":
        assert not bool(whole[2].all())  # the case really drops choices


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jc, tc = _configs(jdt)
    params, tparams = _params(jc)
    layer = jax.tree.map(lambda w: w[0], params["layers"])
    tlayer = tl.layer_params(tparams, 0)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, jc.dim)).astype(np.float32)
    ref, raux = jm._moe_ffn(jnp.asarray(x, jdt), layer, jc)
    out, aux = tm._moe_ffn(
        torch.from_numpy(x).to(tc.dtype), tlayer, tc)
    assert out.dtype == tc.dtype
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-5)
    else:
        # bf16 products rounded at other points: a few bf16 ulps of the
        # output's scale
        err = np.abs(_f32(out) - _f32(ref)).max() / np.abs(_f32(ref)).max()
        assert err <= 2e-2, err


# -- forward, loss and grads --------------------------------------------------


@pytest.mark.parametrize("flash", [False, True])
def test_forward_logits_and_aux_match_jax(flash):
    jc, tc = _configs(use_flash_attention=flash)
    params, tparams = _params(jc)
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 24)).astype(np.int32)
    ref, raux = jm.forward(params, jnp.asarray(tokens), jc)
    out, aux = tm.forward(tparams, torch.from_numpy(tokens), tc)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def test_bf16_forward_close_to_jax():
    """bf16 params and activations: logits within the serving limit of
    ``chip_smoke.py`` (5e-2 of the largest logit)."""
    jc, tc = _configs(jnp.bfloat16)
    params, tparams = _params(jc)
    tokens = np.random.default_rng(2).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    ref, _ = jm.forward(params, jnp.asarray(tokens), jc)
    out, _ = tm.forward(tparams, torch.from_numpy(tokens), tc)
    err = np.abs(_f32(out) - _f32(ref)).max() / np.abs(_f32(ref)).max()
    assert err <= 5e-2, err


def _leaves(tree):
    return [tree["tok_embed"], tree["final_norm"], tree["lm_head"],
            *(tree["layers"][n] for n in sorted(tree["layers"]))]


@pytest.mark.parametrize("remat", [dict(remat=False),
                                   dict(remat=True, remat_policy="dots"),
                                   dict(remat=True, remat_policy=None)],
                         ids=["off", "dots", "full"])
def test_loss_and_grads_match_jax(remat):
    jc, tc = _configs(**remat)
    params, tparams = _params(jc)
    tokens = np.random.default_rng(5).integers(
        0, jc.vocab_size, (2, 25)).astype(np.int32)
    ref_loss, ref_grads = jax.value_and_grad(jm.next_token_loss)(
        params, jnp.asarray(tokens), jc)
    leaves = _leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss = tm.next_token_loss(tparams, torch.from_numpy(tokens), tc)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=ATOL)
    names = ["tok_embed", "final_norm", "lm_head",
             *sorted(tparams["layers"])]
    for name, g, r in zip(names, grads, _leaves(ref_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   err_msg=name)
    router = dict(zip(names, grads))["router"]
    assert router.dtype == torch.float32 and float(router.abs().max()) > 0


def test_remat_dots_recomputes_the_expert_products(monkeypatch):
    """Under "dots" the expert products (batched over experts) are
    recomputed in backward and the projections are not, as
    ``dots_with_no_batch_dims_saveable`` treats the reference's."""
    counts = {"bmm": 0}
    real = torch.bmm

    def bmm(*a, **k):
        counts["bmm"] += 1
        return real(*a, **k)

    jc, tc = _configs(remat=True, remat_policy="dots")
    _, tparams = _params(jc)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, jc.vocab_size, (1, 9)).astype(np.int64))
    leaves = _leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    monkeypatch.setattr(torch, "bmm", bmm)
    loss = tm.next_token_loss(tparams, tokens, tc)
    forward_bmm = counts["bmm"]
    torch.autograd.grad(loss, leaves)
    assert forward_bmm == 3 * tc.n_layers
    assert counts["bmm"] == 2 * forward_bmm


@pytest.mark.parametrize("sp", [dict(sp_attention="ring"),
                                dict(sp_attention="ulysses"),
                                dict(use_ring_attention=True)],
                         ids=["ring", "ulysses", "legacy"])
def test_moe_sp_config_without_mesh_is_plain_attention(sp):
    """With no mesh a sequence-parallel MoE config computes plain
    attention over whole sequences, as the reference's: the loss is the
    non-sp config's bit for bit, and JAX's."""
    jc, tc = _configs(**sp)
    jparams, tparams = _params(jc)
    tokens = np.random.default_rng(4).integers(
        0, jc.vocab_size, (2, 17)).astype(np.int32)
    ref = jm.next_token_loss(jparams, jnp.asarray(tokens), jc)
    got = tm.next_token_loss(tparams, torch.from_numpy(tokens), tc)
    plain = tm.next_token_loss(tparams, torch.from_numpy(tokens),
                               _configs()[1])
    assert torch.equal(got, plain)
    np.testing.assert_allclose(float(got), float(ref), atol=ATOL)


def test_dense_llama_entry_points_refuse_a_moe_config():
    """Only ``moe.*`` and ``decode.ffn`` take a MoE config: the dense
    forward would broadcast the (E, D, F) expert weights through ``mlp``
    into logits of the wrong shape."""
    _, tc = _configs()
    _, tparams = _params(_configs()[0])
    with pytest.raises(NotImplementedError, match="models/moe.py"):
        tl.forward(tparams, torch.zeros((1, 4), dtype=torch.long), tc)
    with pytest.raises(NotImplementedError, match="models/moe.py"):
        tl.init_params(tc, torch.Generator().manual_seed(0), "cpu")


def test_router_product_runs_in_full_f32(monkeypatch):
    seen = []
    real = torch.matmul

    def matmul(a, b, **k):
        seen.append(torch.get_float32_matmul_precision())
        return real(a, b, **k)

    jc, tc = _configs()
    x = torch.randn(2, 8, jc.dim)
    router = torch.randn(jc.dim, jc.n_experts)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        monkeypatch.setattr(torch, "matmul", matmul)
        tm._route(x, router, tc, 4)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen == ["highest"]


# -- configs and params ---------------------------------------------------


def test_configs_and_num_params_match_jax():
    for jc, tc in ((jm.MoEConfig.mixtral8x7b(), tm.MoEConfig.mixtral8x7b()),
                   (jm.MoEConfig.tiny(), tm.MoEConfig.tiny())):
        jd_ = dataclasses.asdict(jc)
        td_ = dataclasses.asdict(tc)
        assert jd_.pop("dtype") == jnp.bfloat16
        assert td_.pop("dtype") == torch.bfloat16
        assert td_ == jd_
        assert (tc.head_dim, tc.sp_strategy) == (jc.head_dim, jc.sp_strategy)
        assert tm.num_params(tc) == jm.num_params(jc)
    total, active = tm.num_params(tm.MoEConfig.mixtral8x7b())
    assert round(total / 1e9, 1) == 46.7 and round(active / 1e9, 1) == 12.9


def test_init_params_shapes_dtypes_and_count_match_jax():
    jc, tc = _configs()
    ref = {jax.tree_util.keystr(p): (a.shape, str(a.dtype)) for p, a in
           jax.tree_util.tree_flatten_with_path(
               jm.init_params(jc, jax.random.PRNGKey(0)))[0]}
    params = tm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    got = {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for name, t in named_leaves(params)}
    assert got == ref
    assert got["['layers']['router']"][1] == "float32"
    assert sum(t.numel() for _, t in named_leaves(params)) == \
        tm.num_params(tc)[0]


# -- serving: decode and the engine ------------------------------------------


@pytest.mark.parametrize("quantize", [False, True])
def test_prefill_and_decode_step_match_jax(quantize):
    jc, tc = _configs()
    params, tparams = _params(jc)
    tokens = np.random.default_rng(8).integers(
        0, jc.vocab_size, (2, 9)).astype(np.int32)
    T = 256  # the decode kernel's route needs whole 256-key blocks
    lj, cj = jd.prefill(params, jnp.asarray(tokens[:, :8]), jc, T,
                        quantize=quantize)
    lt, ct = td.prefill(tparams, torch.from_numpy(tokens[:, :8]), tc, T,
                        quantize=quantize)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=DECODE_ATOL)
    for flash in (True, False):
        lj2, _ = jd.decode_step(params, jnp.asarray(tokens[:, 8]), cj, jc,
                                flash=flash)
        lt2, _ = td.decode_step(tparams, torch.from_numpy(tokens[:, 8]),
                                {**ct}, tc, flash=flash)
        np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2),
                                   atol=DECODE_ATOL, err_msg=f"{flash}")


@pytest.mark.parametrize("quantize", [False, True])
def test_greedy_generate_tokens_match_jax(quantize):
    jc, tc = _configs()
    params, tparams = _params(jc)
    prompt = np.random.default_rng(9).integers(
        0, jc.vocab_size, (2, 7)).astype(np.int32)
    ref = jd.generate(params, jnp.asarray(prompt), jc, jax.random.PRNGKey(0),
                      10, temperature=0.0, quantize_cache=quantize)
    out = td.generate(tparams, torch.from_numpy(prompt), tc, None, 10,
                      temperature=0.0, quantize_cache=quantize)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_teacher_forced_decode_matches_forward():
    """At capacity_factor = n_experts nothing drops at any group size, so
    the cached steps reproduce the forward's logits (the port's and the
    JAX package's), as ``tests/test_decode.py``'s MoE case."""
    jc, tc = _configs(capacity_factor=4.0)
    params, tparams = _params(jc)
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 16)).astype(np.int32)
    ref, _ = jm.forward(params, jnp.asarray(tokens), jc)
    own, _ = tm.forward(tparams, torch.from_numpy(tokens), tc)
    logits, cache = td.prefill(tparams, torch.from_numpy(tokens[:, :6]), tc,
                               24)
    for i in range(6, tokens.shape[1]):
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref[:, i - 1]),
                                   atol=DECODE_ATOL, rtol=DECODE_ATOL)
        np.testing.assert_allclose(logits.numpy(),
                                   own[:, i - 1].detach().numpy(),
                                   atol=DECODE_ATOL)
        logits, cache = td.decode_step(tparams, torch.from_numpy(tokens[:, i]),
                                       cache, tc)


def test_decode_ffn_routes_per_token_under_a_group_size():
    """A training route_group_size cannot divide a decode step's token
    count; the decode FFN routes per sequence of the call instead, as the
    JAX ``_ffn`` does."""
    jc, tc = _configs(route_group_size=8)
    params, tparams = _params(jc)
    layer = jax.tree.map(lambda w: w[1], params["layers"])
    x = np.random.default_rng(4).standard_normal(
        (3, 1, jc.dim)).astype(np.float32)
    ref = jd._ffn(jnp.asarray(x), layer, jc)
    out = td.ffn(torch.from_numpy(x), tl.layer_params(tparams, 1), tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError, match="route_group_size"):
        tm._moe_ffn(torch.from_numpy(x), tl.layer_params(tparams, 1), tc)


SLOTS, CACHE_LEN = 3, 48
# (admit at step, prompt length, bucket, new tokens)
_SCHEDULE = [(0, 6, 8, 9), (2, 11, 16, 7), (3, 3, 8, 12), (9, 13, 16, 6)]


def _engines(quantize, **kw):
    jc, tc = _configs(max_seq_len=CACHE_LEN, **kw)
    params, tparams = _params(jc)
    jeng = je.BatchDecodeEngine(params, jc, slots=SLOTS, cache_len=CACHE_LEN,
                                quantize=quantize)
    teng = te.BatchDecodeEngine(tparams, tc, slots=SLOTS,
                                cache_len=CACHE_LEN, quantize=quantize,
                                device="cpu")
    return jeng, teng


def _serve(engine, schedule=_SCHEDULE):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 256, n).tolist() for _, n, _, _ in schedule]
    active = [None] * SLOTS
    done = {}
    pending = list(range(len(schedule)))
    step = 0
    while pending or any(a is not None for a in active):
        for s in range(SLOTS):
            if (active[s] is None and pending
                    and schedule[pending[0]][0] <= step):
                r = pending.pop(0)
                res = engine.prefill_rows(prompts[r], schedule[r][2])
                active[s] = [r, [engine.insert(res, s)]]
        live = [a is not None for a in active]
        if any(live):
            nxt = engine.step([a[1][-1] if a else 0 for a in active], live)
            for s, a in enumerate(active):
                if a is None:
                    continue
                a[1].append(nxt[s])
                if len(a[1]) == schedule[a[0]][3]:
                    done[a[0]] = a[1]
                    active[s] = None
        step += 1
    return [done[r] for r in range(len(schedule))]


@pytest.mark.parametrize("quantize", [False, True])
def test_engine_tokens_match_jax_on_ragged_slots(quantize, monkeypatch):
    jeng, teng = _engines(quantize)
    ref = _serve(jeng)
    assert _serve(teng) == ref
    # the decode kernel's route (its plain version here) keeps the tokens
    monkeypatch.setattr(te, "flash_decode_wanted", lambda *a, **k: True)
    _, teng = _engines(quantize)
    assert teng._flash and _serve(teng) == ref


def _record_kept(patch):
    """Wrap the port's ``moe._route`` through ``patch`` (a monkeypatch):
    the returned list gathers each call's kept flags."""
    kept = []
    real = tm._route

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        kept.append(out[2])
        return out

    patch.setattr(tm, "_route", recording)
    return kept


def test_bucket_pads_change_routing_alike_at_low_capacity(monkeypatch):
    """At a low capacity factor a prompt's pads claim expert slots before
    the real tokens' second choices, and the bucket sets the capacity: the
    first token depends on the bucket in the JAX engine, and the port's
    equals it bucket for bucket (a reference behaviour the port matches)."""
    jeng, teng = _engines(False, capacity_factor=0.5)
    prompt = np.random.default_rng(12).integers(1, 256, 10).tolist()
    firsts = {}
    for bucket in (16, 32, 48):
        ref = jeng.prefill_rows(prompt, bucket)
        res = teng.prefill_rows(prompt, bucket)
        assert res.first_token == ref.first_token, bucket
        for a, b in zip(ref.payload, res.payload):
            np.testing.assert_allclose(_f32(b), _f32(a), atol=1e-5)
        firsts[bucket] = res.first_token
        with monkeypatch.context() as patch:
            kept = _record_kept(patch)
            teng.prefill_rows(prompt, bucket)
        # every layer drops choices at this capacity
        assert len(kept) == teng.config.n_layers
        assert all(not bool(k.all()) for k in kept)
    assert len(set(firsts.values())) > 1, firsts


@pytest.mark.parametrize("m,plen,bucket", [(16, 27, 32), (8, 20, 48)])
def test_prefill_with_prefix_matches_jax(m, plen, bucket):
    """The suffix prefill routes only the suffix group, as the JAX engine
    does: first token and rows equal the JAX ``prefill_with_prefix``'s.
    (A cold prefill routes the whole bucket as one group, so it need not
    give the same first token.)"""
    jeng, teng = _engines(False)
    rng = np.random.default_rng(m + plen)
    shared = rng.integers(1, 256, m).tolist()
    donor = shared + rng.integers(1, 256, 40 - m).tolist()
    prompt = shared + rng.integers(1, 256, plen - m).tolist()
    jentry, _ = jeng.prefix_entry(jeng.prefill_rows(donor, 48))
    tentry, _ = teng.prefix_entry(teng.prefill_rows(donor, 48))
    jres = jeng.prefill_with_prefix(prompt, bucket, jentry, m)
    tres = teng.prefill_with_prefix(prompt, bucket, tentry, m)
    assert tres.first_token == jres.first_token
    for a, b in zip(jres.payload, tres.payload):
        np.testing.assert_allclose(_f32(b), _f32(a), atol=1e-5)


@pytest.mark.parametrize("quantize", [False, True])
def test_decode_window_matches_jax(quantize):
    jc, tc = _configs()
    params, tparams = _params(jc)
    T, K = 32, 4
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, 256, (2, 6)).astype(np.int32)
    toks = rng.integers(0, 256, (2, K)).astype(np.int32)
    _, jcache = jd.prefill(params, jnp.asarray(prompt), jc, T, quantize)
    jlog, jcache = jd.decode_window(params, jnp.asarray(toks), jcache, jc)
    _, tcache = td.prefill(tparams, torch.from_numpy(prompt), tc, T,
                           quantize=quantize)
    tlog, tcache = td.decode_window(tparams, torch.from_numpy(toks), tcache,
                                    tc)
    assert tcache["pos"] == int(jcache["pos"]) == 6 + K
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=DECODE_ATOL)


# -- carrying state over, and training ---------------------------------------


GLOBAL_BATCH, SEQ = 4, 16


def _trainers(accum):
    jc, tc = _configs(use_flash_attention=False)
    micro = GLOBAL_BATCH // accum
    jtr = jt.ElasticTrainer(lambda p, t: jm.next_token_loss(p, t, jc),
                            optax.adamw(3e-4), GLOBAL_BATCH, micro)
    ttr = tt.ElasticTrainer(lambda p, t: tm.next_token_loss(p, t, tc),
                            adamw(3e-4), GLOBAL_BATCH, micro, device="cpu")
    assert jtr.configure_for_world(jmesh.plan_mesh(1)) == accum
    assert ttr.configure_for_world(tmesh.plan_mesh(1)) == accum
    return jc, jtr, ttr


def _batches(jc, accum, n, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (n, GLOBAL_BATCH, SEQ + 1))
    return [t.astype(np.int32).reshape(accum, GLOBAL_BATCH // accum, SEQ + 1)
            for t in toks]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _assert_tree_close(ttree, jtree, atol):
    for path, ref in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = ttree
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.detach().numpy(), ref, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_params_and_train_state_from_jax_carry_moe():
    """A MoE train state after one JAX step: the f32 router arrives f32,
    bf16 experts bitwise, the leaf names are the JAX checkpoints', and the
    port's next step equals the JAX trainer's."""
    bparams = jm.init_params(jm.MoEConfig.tiny(), jax.random.PRNGKey(0))
    carried = _tp(bparams)
    assert carried["layers"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(
        carried["layers"]["router"].numpy(),
        np.asarray(bparams["layers"]["router"]))
    np.testing.assert_array_equal(
        carried["layers"]["w1"].view(torch.uint16).numpy(),
        np.asarray(bparams["layers"]["w1"]).view(np.uint16))
    jc, jtr, ttr = _trainers(2)
    batches = _batches(jc, 2, 2)
    jstate = jt.make_train_state(jm.init_params(jc, jax.random.PRNGKey(0)),
                                 jtr._optimizer)
    jstate, _ = jtr.train_step(jstate, jnp.asarray(batches[0]))
    tstate = train_state_from_jax(_np_tree(jstate), "cpu")
    ref_names = {jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(
                     {"params": jstate["params"]})[0]}
    names = {n for n, _ in named_leaves({"params": tstate["params"]})}
    assert names == ref_names
    assert "['params']['layers']['router']" in names
    assert tuple(tstate["params"]["layers"]["w1"].shape)[:2] == (
        jc.n_layers, jc.n_experts)
    jstate, jres = jtr.train_step(jstate, jnp.asarray(batches[1]))
    tstate, tres = ttr.train_step(tstate, batches[1])
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=1e-5)
    _assert_tree_close(tstate["params"], _np_tree(jstate["params"]), 1e-5)
    adam = jstate["opt_state"][0]
    _assert_tree_close(tstate["opt_state"]["mu"], _np_tree(adam.mu), 1e-7)


@pytest.mark.parametrize("accum", [1, 2])
def test_three_trainer_steps_match_jax(accum):
    jc, jtr, ttr = _trainers(accum)
    params = jm.init_params(jc, jax.random.PRNGKey(0))
    tstate = tt.make_train_state(params_from_jax(_np_tree(params), "cpu"),
                                 ttr._optimizer)
    jstate = jt.make_train_state(params, jtr._optimizer)
    for batch in _batches(jc, accum, 3):
        jstate, jres = jtr.train_step(jstate, jnp.asarray(batch))
        tstate, tres = ttr.train_step(tstate, batch)
        np.testing.assert_allclose(float(tres.loss), float(jres.loss),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tres.grad_norm),
                                   float(jres.grad_norm), rtol=1e-4)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    _assert_tree_close(tstate["params"], _np_tree(jstate["params"]), 1e-5)


# -- expert-axis sharding --------------------------------------------------


EP_PLANS = {"ep2": dict(n=2, ep=2), "ep4_fsdp2": dict(n=8, ep=4),
            "ep2_tp2_fsdp2": dict(n=8, ep=2, tp=2)}


def _jax_regions(plan, config, n):
    mesh = jmesh.build_mesh(plan, jax.devices()[:n])
    params = jm.init_params(config, jax.random.PRNGKey(0))
    state = jsharding.shard_tree(mesh, {"params": params},
                                 {"params": jm.param_logical_axes(config)})
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        per_dev = {}
        for dev, index in leaf.sharding.addressable_devices_indices_map(
                leaf.shape).items():
            start = tuple(int(sl.start or 0) for sl in index)
            shape = tuple(int((sl.stop if sl.stop is not None else g)
                              - (sl.start or 0))
                          for sl, g in zip(index, leaf.shape))
            per_dev[dev.id] = (start, shape)
        out[jax.tree_util.keystr(path)] = per_dev
    return out


def _axes_by_name(config):
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], path + (k,))
        else:
            out[jax_leaf_name(path)] = tree

    walk({"params": tm.param_logical_axes(config)}, ())
    return out


def _coords(plan, rank):
    shape = tuple(plan.size(a) for a in tmesh.AXIS_ORDER)
    return dict(zip(tmesh.AXIS_ORDER,
                    (int(i) for i in np.unravel_index(rank, shape))))


@pytest.mark.parametrize("plan_name", sorted(EP_PLANS))
def test_expert_regions_equal_jax_regions(plan_name):
    kw = dict(EP_PLANS[plan_name])
    n = kw.pop("n")
    jplan, tplan = jmesh.plan_mesh(n, **kw), tmesh.plan_mesh(n, **kw)
    assert tplan.axes == jplan.axes
    jc, tc = _configs()
    per_device = _jax_regions(jplan, jc, n)
    params = tm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    logical = _axes_by_name(tc)
    sizes = dict(tplan.axes)
    assert set(logical) == set(per_device)
    for name, leaf in named_leaves({"params": params}):
        spec = tsharding.valid_spec_for(sizes, leaf.shape, logical[name])
        for rank in range(n):
            region = tsharding.region_for(leaf.shape, spec, sizes,
                                          _coords(tplan, rank))
            assert region == per_device[name][rank], (name, rank)
    # each ep rank holds its own experts' block of w1
    spec = tsharding.valid_spec_for(sizes, params["layers"]["w1"].shape,
                                    logical["['params']['layers']['w1']"])
    assert "ep" in tsharding.entry_axes(spec[1])


def _ranks_module():
    spec = importlib.util.spec_from_file_location(
        "torch_ranks", os.path.join(os.path.dirname(__file__), "data",
                                    "torch_ranks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_ep_ranks_hold_jax_regions_train_and_checkpoint(tmp_path):
    """2 gloo ranks at ep=2: each rank's DTensor locals are the regions
    the JAX package's device at its coordinate holds; 3 trainer steps
    equal one plain process's (f32 round-off); a Flash Checkpoint save
    and shm restore of that state is bitwise."""
    ranks = _ranks_module()
    job = f"tm{os.getpid() % 10000}"
    try:
        res = ranks.launch(2, "moe", {"ep": 2}, str(tmp_path), job)
    finally:
        for lr in range(2):
            unlink_shared_memory(shm_name(job, 0, lr))
    jc, _ = _configs()
    per_device = _jax_regions(jmesh.plan_mesh(2, ep=2), jc, 2)
    for rank, r in res.items():
        assert r["locals_match"]
        for name, regions in r["needs"].items():
            got = tuple(map(tuple, regions[0]))
            assert got == per_device[name][rank], (name, rank)
        np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=1e-5)
        assert r["param_err"] < 1e-5 and r["mu_err"] < 1e-6
        step, medium, equal = r["shm_restore"]
        assert (step, medium, equal) == (5, "shm", True)
    w1 = "['params']['layers']['w1']"
    assert res[0]["needs"][w1] != res[1]["needs"][w1]


# -- expert-local and sequence-parallel training across gloo ranks ------------

# the two launches: ranks → mode and plan
MOE_LAUNCHES = {2: ("moe_ep", {"ep": 2}), 4: ("moe_sp", {"ep": 2, "sp": 2})}
LOSS_ATOL, GRAD_ATOL = 1e-5, 1e-4    # as tests/test_torch_parallel.py
STEP_LOSS_RTOL, STEP_NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
EXPERTS = ("w1", "w3", "w2")


def _rank_inputs():
    """The params and trainer batches of ``test_three_trainer_steps_match_
    jax`` (on other draws Adam's normalisation can lift one element's f32
    rounding past PARAM_ATOL after 3 steps, one process alone included)
    and a batch for the loss."""
    jc, _ = _configs(remat=True)
    rng = np.random.default_rng(12)
    params = jm.init_params(jc, jax.random.PRNGKey(0))
    return dict(
        tokens=rng.integers(0, jc.vocab_size, (2, SEQ + 1)).astype(np.int32),
        batches=np.stack([b.reshape(GLOBAL_BATCH, SEQ + 1)
                          for b in _batches(jc, 2, 3)]),
        **{f"params/{k}": v for k, v in _ranks_module().flat(
            _np_tree(params)).items()})


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    """``moe_ranks(n)`` → (inputs, RESULT dicts by rank, arrays by rank)
    of the ``n``-rank launch, run once."""
    ranks = _ranks_module()
    inputs = _rank_inputs()
    done = {}

    def get(n):
        mode, plan = MOE_LAUNCHES[n]
        if n not in done:
            out = str(tmp_path_factory.mktemp(f"moe{n}"))
            np.savez(os.path.join(out, f"{mode}_inputs.npz"), **inputs)
            res = ranks.launch(n, mode, {mode: plan}, out,
                               f"me{n}_{os.getpid()}")
            arrays = [dict(np.load(os.path.join(out, f"{mode}{n}_{r}.npz")))
                      for r in range(n)]
            done[n] = ({r: v[mode] for r, v in res.items()}, arrays)
        return (inputs, *done[n])

    return get


def _jax_loss_and_grads(inputs, n, strategy):
    """The reference's loss and ``jax.grad`` on its CPU mesh of ``n``
    devices (ep 2, and sp 2 for a strategy), the params sharded by their
    logical axes."""
    jc, _ = _configs(remat=True, sp_attention=strategy)
    kw = dict(ep=2, sp=2) if strategy else dict(ep=2)
    mesh = jmesh.build_mesh(jmesh.plan_mesh(n, **kw), jax.devices()[:n])
    ranks = _ranks_module()
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          ranks.unflat(inputs, "params/"))
    params = jsharding.shard_tree(mesh, params, jm.param_logical_axes(jc))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jm.next_token_loss(p, t, jc, mesh)))(
            params, jnp.asarray(inputs["tokens"]))
    return float(loss), ranks.flat(_np_tree(grads))


def _ep_coord(n, rank):
    """The ep coordinate of ``rank`` in the launch of ``n`` ranks (the
    mesh order puts sp inside ep)."""
    return rank // 2 if n == 4 else rank


def _assert_ep_grads(arrays, n, prefix, ref):
    """Each leaf's grad against ``ref``: the mean over the ranks that
    hold the same block (the sp ranks; the trainer's reduction), the
    expert leaves' blocks joined in ep order. The ep ranks agree on
    every replicated leaf."""
    names = sorted(k[len(prefix):] for k in arrays[0] if k.startswith(prefix))
    assert names == sorted(ref)
    for name in names:
        blocks = []
        for e in range(2):
            same = [a[prefix + name] for r, a in enumerate(arrays)
                    if _ep_coord(n, r) == e]
            blocks.append(np.mean(same, axis=0))
        if name.split("/")[-1] in EXPERTS:
            got = np.concatenate(blocks, axis=1)
        else:
            np.testing.assert_array_equal(blocks[0], blocks[1],
                                          err_msg=name)
            got = blocks[0]
        np.testing.assert_allclose(got, ref[name], atol=GRAD_ATOL,
                                   err_msg=name)


def test_ep_loss_and_grads_on_local_experts_match_jax(moe_ranks):
    """ep = 2: each rank's expert products run its 2 of the 4 experts
    alone; its loss is the whole loss, its grads the whole gradient of
    every replicated leaf and its experts' block of the expert leaves."""
    inputs, res, arrays = moe_ranks(2)
    loss, grads = _jax_loss_and_grads(inputs, 2, None)
    for r in range(2):
        assert res[r]["bmm_ep"] == [2]
        np.testing.assert_allclose(float(arrays[r]["loss_ep"]), loss,
                                   atol=LOSS_ATOL)
    _assert_ep_grads(arrays, 2, "grad_ep/", grads)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_ep_sp_loss_and_grads_match_jax(moe_ranks, strategy):
    """ep 2 × sp 2: each rank routes its chunk in groups that span both
    chunks (the default group, one sequence) and runs its 2 experts; the
    mean of the sp ranks' losses is the reference's loss, and the mean of
    their grads its ``jax.grad``."""
    inputs, res, arrays = moe_ranks(4)
    loss, grads = _jax_loss_and_grads(inputs, 4, strategy)
    for r in range(4):
        assert res[r][f"bmm_{strategy}"] == [2]
    for e in range(2):
        got = np.mean([float(arrays[r][f"loss_{strategy}"])
                       for r in range(4) if _ep_coord(4, r) == e])
        np.testing.assert_allclose(got, loss, atol=LOSS_ATOL)
    _assert_ep_grads(arrays, 4, f"grad_{strategy}/", grads)


def _jax_trainer_steps(inputs):
    """3 steps of the JAX trainer (plain loss, one device) from the same
    params on the same batches: losses, norms, final params."""
    jc, _ = _configs(remat=True)
    jtr = jt.ElasticTrainer(lambda p, t: jm.next_token_loss(p, t, jc),
                            optax.adamw(3e-4), GLOBAL_BATCH,
                            GLOBAL_BATCH // 2)
    jtr.configure_for_world(jmesh.plan_mesh(1))
    ranks = _ranks_module()
    state = jt.make_train_state(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                     ranks.unflat(inputs, "params/")), jtr._optimizer)
    steps = []
    for b in inputs["batches"]:
        state, r = jtr.train_step(state, jnp.asarray(b.reshape(
            jtr.grad_accum_steps, jtr.micro_batch_global, -1)))
        steps.append([float(r.loss), float(r.grad_norm)])
    return steps, ranks.flat(_np_tree(state["params"]))


@pytest.mark.parametrize("n", [2, 4], ids=["ep2", "ep2sp2"])
def test_ep_trainer_steps_on_local_experts_match_jax(moe_ranks, n):
    """3 ``ElasticTrainer`` steps (accum 2) with ``local_axes=("ep",)``
    against the JAX trainer: the loss takes each rank's 2 experts (the
    live expert leaves and their f32 accumulators hold E/ep experts, and
    the ledger claims those bytes), every rank reports the same steps."""
    inputs, res, arrays = moe_ranks(n)
    ref_steps, ref_params = _jax_trainer_steps(inputs)
    got = np.array(res[0]["train"])
    for r in range(n):
        assert res[r]["train"] == res[0]["train"]
    np.testing.assert_allclose(got[:, 0], np.array(ref_steps)[:, 0],
                               rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(got[:, 1], np.array(ref_steps)[:, 1],
                               rtol=STEP_NORM_RTOL)
    params = {k[len("train/"):]: v for k, v in arrays[0].items()
              if k.startswith("train/")}
    assert sorted(params) == sorted(ref_params)
    for name, ref in ref_params.items():
        np.testing.assert_allclose(params[name], ref, atol=PARAM_ATOL,
                                   err_msg=name)
    jc, _ = _configs()
    E, L = jc.n_experts, jc.n_layers
    full = {k: v.shape for k, v in ref_params.items()}
    for r in range(n):
        live = res[r]["train_live"]
        for name in EXPERTS:
            assert live["layers"][name][:2] == [L, E // 2]
        shapes = sorted(map(tuple, live["accum_shapes"]))
        want = sorted(
            (shape[0], E // 2) + tuple(shape[2:])
            if name.split("/")[-1] in EXPERTS else tuple(shape)
            for name, shape in full.items())
        assert shapes == want
        assert live["accum_bytes"] == 4 * sum(int(np.prod(s)) for s in want)
