"""The port's Llama model against the JAX package's.

JAX params (f32, from ``init_params``) are carried over with
``params_from_jax``; the same seeded tokens go through both forwards.
Logits agree within 1e-4 on the dense path and on the flash path (the
JAX flash kernel in Pallas interpret mode; the port's plain version of
its CUDA kernel on the CPU).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu_torch.convert import (  # noqa: E402
    params_from_jax,
    tensor_from_numpy,
)
from dlrover_tpu_torch.models import llama as tl  # noqa: E402


def _configs(**kw):
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                             max_seq_len=64, **kw)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32,
                             max_seq_len=64, **kw)
    return jc, tc


@pytest.mark.parametrize("flash", [False, True])
def test_forward_logits_match_jax(flash):
    jc, tc = _configs(use_flash_attention=flash)
    params = jl.init_params(jc, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 24)).astype(np.int32)
    ref = jl.forward(params, jnp.asarray(tokens), jc)
    out = tl.forward(tparams, torch.from_numpy(tokens), tc)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_rope_rotates_interleaved_pairs():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    positions = np.tile(np.arange(5), (2, 1)).astype(np.int32)
    ref = jl._rope(jnp.asarray(x), jnp.asarray(positions), 10000.0)
    out = tl.rope(torch.from_numpy(x), torch.from_numpy(positions), 10000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_rms_norm_scales_after_the_cast_in_bf16():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    ref = jl._rms_norm(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16), 1e-5)
    out = tl.rms_norm(tensor_from_numpy(np.asarray(x, jnp.bfloat16), "cpu"),
                      tensor_from_numpy(np.asarray(w, jnp.bfloat16), "cpu"),
                      1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=1e-2)


def test_params_from_jax_carries_bf16_bitwise():
    params = jl.init_params(jl.LlamaConfig.tiny(), jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    ref = np.asarray(params["layers"]["wq"])
    got = tparams["layers"]["wq"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  ref.view(np.uint16))


def test_init_params_shapes_and_count_match_jax():
    jc, tc = _configs()
    ref = jax.tree.map(np.shape, jl.init_params(jc, jax.random.PRNGKey(0)))
    params = tl.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    got = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
               if isinstance(v, dict) else tuple(v.shape))
           for k, v in params.items()}
    assert got == ref
    n = sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("tok_embed", "final_norm", "lm_head"))
    assert n == tl.num_params(tc) == jl.num_params(jc)
    assert tl.num_params(tl.LlamaConfig()) == jl.num_params(jl.LlamaConfig())


@pytest.mark.parametrize("sp", [dict(sp_attention="ulysses"),
                                dict(use_ring_attention=True)])
def test_sequence_parallel_configs_raise(sp):
    _, tc = _configs(**sp)
    params = tl.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        tl.forward(params, torch.zeros((1, 4), dtype=torch.long), tc)


def _loss_and_grads(jc, tc, seed=0):
    params = jl.init_params(jc, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed + 1).integers(
        0, jc.vocab_size, (2, 25)).astype(np.int32)
    ref_loss, ref_grads = jax.value_and_grad(jl.next_token_loss)(
        params, jnp.asarray(tokens), jc)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    leaves = [tparams["tok_embed"], tparams["final_norm"],
              tparams["lm_head"], *tparams["layers"].values()]
    for t in leaves:
        t.requires_grad_(True)
    loss = tl.next_token_loss(tparams, torch.from_numpy(tokens), tc)
    grads = torch.autograd.grad(loss, leaves)
    ref = [ref_grads["tok_embed"], ref_grads["final_norm"],
           ref_grads["lm_head"], *(ref_grads["layers"][n]
                                   for n in tparams["layers"])]
    return loss, ref_loss, grads, ref


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("remat", [dict(remat=False),
                                   dict(remat=True, remat_policy="dots"),
                                   dict(remat=True, remat_policy=None)],
                         ids=["off", "dots", "full"])
def test_loss_and_grads_match_jax(flash, remat):
    jc, tc = _configs(use_flash_attention=flash, **remat)
    loss, ref_loss, grads, ref = _loss_and_grads(jc, tc)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               atol=1e-4)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    targets = rng.integers(0, 50, (2, 7)).astype(np.int32)
    ref = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    out = tl.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(targets))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


@pytest.mark.parametrize("policy", ["dots", None])
def test_remat_recomputes_attention_once_per_layer(monkeypatch, policy):
    """Under remat the flash forward runs in the forward pass and once more
    in backward for each layer (2·L a step); without remat once (L)."""
    from dlrover_tpu_torch.ops import flash_attention as tfa

    calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    for remat, want in ((True, 2), (False, 1)):
        _, tc = _configs(use_flash_attention=True, remat=remat,
                         remat_policy=policy)
        params = tl.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        for t in params["layers"].values():
            t.requires_grad_(True)
        calls.clear()
        loss = tl.next_token_loss(params, torch.zeros((2, 9), dtype=torch.long),
                                  tc)
        torch.autograd.grad(loss, list(params["layers"].values()))
        assert len(calls) == want * tc.n_layers, (remat, policy, len(calls))


def test_unknown_remat_policy_raises():
    _, tc = _configs(remat=True, remat_policy="everything")
    params = tl.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    params["lm_head"].requires_grad_(True)
    with pytest.raises(ValueError, match="remat_policy"):
        tl.forward(params, torch.zeros((1, 4), dtype=torch.long), tc)


def test_llama7b_and_tiny_configs_match_jax():
    for name in ("llama7b", "tiny"):
        ref = getattr(jl.LlamaConfig, name)()
        got = getattr(tl.LlamaConfig, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "ffn_dim", "max_seq_len", "remat", "remat_policy"):
            assert getattr(got, f) == getattr(ref, f), (name, f)
    assert tl.num_params(tl.LlamaConfig.llama7b()) == jl.num_params(
        jl.LlamaConfig.llama7b())
