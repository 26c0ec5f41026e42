"""The port's KV-cache decoding against the JAX package's.

The same JAX params (f32, carried over with ``params_from_jax``) and the
same seeded prompts go through ``dlrover_tpu.models.decode`` and
``dlrover_tpu_torch.models.decode`` on the CPU. Logits agree within 1e-4;
int8 cache rows are bitwise equal (their f32 scales to f32 rounding, since
the k/v rows come out of matmuls summed in another order than XLA's, and
``_quantize`` itself is checked bitwise on identical inputs); greedy
``generate`` tokens are exactly equal, for the f32 and the int8 cache,
tight and preallocated. Where the JAX side runs a Pallas kernel (prefill at
P >= 256 with ``use_flash_attention=True``, ``decode_step(flash=True)``) it
runs in interpret mode and the port runs the kernel's plain version.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import decode as jd  # noqa: E402
from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu_torch.convert import params_from_jax  # noqa: E402
from dlrover_tpu_torch.models import decode as td  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402

ATOL = 1e-4


def _setup(use_flash=None, max_seq_len=64, B=2, S=24, seed=1):
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                             max_seq_len=max_seq_len,
                             use_flash_attention=use_flash)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32,
                             max_seq_len=max_seq_len,
                             use_flash_attention=use_flash)
    params = jl.init_params(jc, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(seed).integers(
        0, jc.vocab_size, (B, S)).astype(np.int32)
    return jc, tc, params, tparams, tokens


def _check_cache(jcache, tcache):
    assert int(jcache["pos"]) == tcache["pos"]
    for name in ("k", "v", "k_scale", "v_scale"):
        if name not in jcache:
            assert name not in tcache
            continue
        for li, (a, b) in enumerate(zip(jcache[name], tcache[name])):
            a = np.asarray(a)
            b = b.numpy()
            if a.dtype == np.int8:
                np.testing.assert_array_equal(b, a, err_msg=f"{name}[{li}]")
            elif name.endswith("scale"):
                # absmax/127 of f32 rows whose matmuls summed in another
                # order than XLA's: equal to f32 rounding, not bitwise
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=0,
                                           err_msg=f"{name}[{li}]")
            else:
                np.testing.assert_allclose(b, a, atol=ATOL,
                                           err_msg=f"{name}[{li}]")


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("P,use_flash", [(8, None), (256, True)])
def test_prefill_and_decode_step_match_jax(quantize, P, use_flash):
    """Dense prefill (P=8) and the flash-kernel prefill (P=256), then one
    decode step through the decode kernel's route and one through the
    dense attend; int8 rows bitwise."""
    T = 512
    jc, tc, params, tparams, tokens = _setup(use_flash, max_seq_len=T,
                                             S=P + 1)
    lj, cj = jd.prefill(params, jnp.asarray(tokens[:, :P]), jc, T,
                        quantize=quantize)
    lt, ct = td.prefill(tparams, torch.from_numpy(tokens[:, :P]), tc, T,
                        quantize=quantize)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    _check_cache(cj, ct)
    nxt = tokens[:, P]
    for flash in (True, False):
        lj2, cj2 = jd.decode_step(params, jnp.asarray(nxt), cj, jc,
                                  flash=flash)
        lt2, ct2 = td.decode_step(tparams, torch.from_numpy(nxt), ct, tc,
                                  flash=flash)
        np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2), atol=ATOL,
                                   err_msg=f"flash={flash}")
        _check_cache(cj2, ct2)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("max_len", [None, 256])
def test_greedy_generate_tokens_match_jax(quantize, max_len):
    """Greedy tokens exactly equal, tight cache (max_len=None) and
    preallocated (256)."""
    jc, tc, params, tparams, tokens = _setup()
    prompt = tokens[:, :7]
    ref = jd.generate(params, jnp.asarray(prompt), jc,
                      jax.random.PRNGKey(0), 12, temperature=0.0,
                      max_len=max_len, quantize_cache=quantize)
    out = td.generate(tparams, torch.from_numpy(prompt), tc, None, 12,
                      temperature=0.0, max_len=max_len,
                      quantize_cache=quantize)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 19)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_teacher_forced_decode_matches_port_forward():
    """Cached decode steps reproduce the full forward's logits."""
    _, tc, _, tparams, tokens = _setup()
    ref = tl.forward(tparams, torch.from_numpy(tokens), tc)
    logits, cache = td.prefill(tparams, torch.from_numpy(tokens[:, :8]),
                               tc, 32)
    for i in range(8, tokens.shape[1]):
        np.testing.assert_allclose(logits.numpy(), ref[:, i - 1].numpy(),
                                   atol=ATOL)
        logits, cache = td.decode_step(
            tparams, torch.from_numpy(tokens[:, i]), cache, tc, flash=True)


def test_quantize_is_bitwise_jax_quantize():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 7, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero vector: scale 0, divisor clamped
    x[1, 1, 1] *= 1e-12
    qj, sj = jd._quantize(jnp.asarray(x))
    qt, st = td._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        td._dequantize(qt, st, torch.float32).numpy(),
        np.asarray(jd._dequantize(qj, sj, jnp.float32)))


@pytest.mark.parametrize("T,quantized,live_len", [
    (256, False, 10), (12, False, 12), (256, True, 12), (256, True, None),
    (4096, False, 1088), (4096, False, None), (2304, True, 2080),
])
def test_flash_policy_matches_jax_and_needs_cuda(T, quantized, live_len):
    """On the CPU both policies say no. With the device CUDA the port's
    policy is the JAX policy with its TPU check read as true, computed
    here from the JAX function's own rules (the env knob cleared)."""
    assert not jd.flash_decode_wanted(T, quantized, live_len)
    assert not td.flash_decode_wanted(T, quantized, live_len, device="cpu")
    blocks = T % 256 == 0
    if quantized:
        expect = blocks and (live_len is None or T <= live_len * 4)
    else:
        expect = (blocks and live_len is not None and T >= 2 * live_len
                  and T - live_len >= 256)
    assert td.flash_decode_wanted(T, quantized, live_len,
                                  device="cuda") == expect


def test_flash_policy_env_override(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_FLASH_DECODE", "0")
    assert not td.flash_decode_wanted(256, True, device="cuda")
    monkeypatch.setenv("DLROVER_TPU_FLASH_DECODE", "1")
    assert td.flash_decode_wanted(4096, False, 4000, device="cuda")
    assert not td.flash_decode_wanted(4096, False, 4000, device="cpu")


@pytest.mark.parametrize("quantize", [False, True])
def test_planned_cache_len_matches_jax_on_cpu(quantize):
    for total, max_len in ((12, None), (300, None), (300, 512)):
        assert td.planned_cache_len(total, quantize, max_len,
                                    device="cpu") == \
            jd.planned_cache_len(total, quantize, max_len)


def test_generate_refuses_cache_overflow():
    _, tc, _, tparams, tokens = _setup()
    with pytest.raises(ValueError, match="exceeds cache length"):
        td.generate(tparams, torch.from_numpy(tokens[:, :10]), tc, None, 10,
                    temperature=0.0, max_len=16)


def test_sampling_uses_the_generator():
    logits = torch.randn((4, 50), generator=torch.Generator().manual_seed(0))
    a = td.sample_token(logits, torch.Generator().manual_seed(1), 1.0, 5)
    b = td.sample_token(logits, torch.Generator().manual_seed(1), 1.0, 5)
    assert torch.equal(a, b) and a.dtype == torch.int32
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert all(int(a[i]) in top5[i].tolist() for i in range(4))


def test_serving_entry_points_build_no_graph():
    """The model forward is differentiable now; the serving entry points
    keep their own no_grad, so params that require grad (as in a trainer
    sharing them) still build no autograd graph and hold no activations."""
    from dlrover_tpu_torch.serving.engine import BatchDecodeEngine

    _, tc, _, tparams, tokens = _setup(use_flash=True)
    for t in [*tparams["layers"].values(), tparams["tok_embed"],
              tparams["lm_head"], tparams["final_norm"]]:
        t.requires_grad_(True)
    prompt = torch.from_numpy(tokens[:, :8])
    logits, cache = td.prefill(tparams, prompt, tc, 16)
    step_logits, cache = td.decode_step(tparams, prompt[:, -1], cache, tc)
    out = td.generate(tparams, prompt, tc, None, 3, temperature=0.0)
    assert all(t.grad_fn is None for t in (logits, step_logits, out))
    assert all(t.grad_fn is None for t in cache["k"] + cache["v"])
    engine = BatchDecodeEngine(tparams, tc, slots=2, cache_len=16,
                               device="cpu")
    engine.insert(engine.prefill_rows([3, 1, 4], 8), 0)
    engine.step([1, 0], [True, False])
    assert all(t.grad_fn is None for t in engine._k + engine._v)
    assert tl.forward(tparams, prompt, tc).grad_fn is not None
