"""The port's attention ops against the JAX package's Pallas kernels.

The same seeded numpy inputs go through ``dlrover_tpu.ops.flash_attention``
(Pallas in interpret mode on the CPU, as tests/test_flash_attention.py runs
it) and through ``dlrover_tpu_torch.ops.flash_attention`` on CPU tensors,
which takes the plain PyTorch version of each kernel. f32 throughout, at the
reference's own tolerances (2e-5 forward, 1e-4 for grads). The backward is
held against ``jax.vjp`` of the Pallas ``flash_attention`` (its custom VJP,
so the Pallas backward kernels). The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

jfa = importlib.import_module("dlrover_tpu.ops.flash_attention")
from dlrover_tpu_torch.ops import flash_attention as tfa  # noqa: E402

ATOL = 2e-5


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "B,H,Sq,Sk,D,causal",
    [
        (2, 3, 64, 64, 32, True),     # causal
        (2, 3, 64, 64, 32, False),    # non-causal
        (2, 3, 56, 56, 32, True),     # ragged: S not a block multiple
        (2, 2, 32, 48, 16, False),    # cross: Sq != Sk
        (2, 2, 40, 24, 16, True),     # cross + causal: top-left alignment
        # where the CUDA kernel's 128 x 128 tiles end (the JAX function
        # refuses Sk = 0, so that case is held on the card only)
        (1, 2, 127, 127, 16, True),   # one row short of a tile
        (1, 2, 128, 128, 16, True),   # exactly one tile
        (1, 2, 129, 129, 16, True),   # one row into a second tile
        (2, 2, 1, 40, 16, True),      # one query row, causal: sees key 0
        (2, 2, 1, 40, 16, False),     # one query row sees every key
        (1, 2, 100, 64, 16, True),    # Sk under one tile, Sq > Sk
    ],
)
def test_flash_forward_matches_pallas(B, H, Sq, Sk, D, causal):
    rng = np.random.default_rng(B * 1000 + Sq + Sk)
    q = _normal(rng, (B, H, Sq, D))
    k = _normal(rng, (B, H, Sk, D))
    v = _normal(rng, (B, H, Sk, D))
    o_ref, lse_ref = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16, return_lse=True)
    o, lse = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=16, block_k=16, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_takes_q_as_the_transposed_view(causal):
    """The models pass q as the ``(B, S, H, D) -> (B, H, S, D)`` view of
    their projection; the result equals the one for the same values laid
    out contiguously, and the Pallas kernel's."""
    rng = np.random.default_rng(5)
    q_bshd = _normal(rng, (2, 40, 3, 16))
    k = _normal(rng, (2, 3, 40, 16))
    v = _normal(rng, (2, 3, 40, 16))
    q_view = torch.from_numpy(q_bshd).transpose(1, 2)
    assert not q_view.is_contiguous()
    o, lse = tfa.flash_attention(q_view, torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 return_lse=True)
    o_c, lse_c = tfa.flash_attention(q_view.contiguous(), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal,
                                     return_lse=True)
    torch.testing.assert_close(o, o_c, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_c, rtol=0, atol=0)
    o_ref, lse_ref = jfa.flash_attention(
        jnp.asarray(q_bshd.transpose(0, 2, 1, 3)), jnp.asarray(k),
        jnp.asarray(v), causal=causal, block_q=16, block_k=16,
        return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL)


def test_flash_forward_default_output_is_o_only():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 2, 16, 8)))
               for _ in range(3))
    o = tfa.flash_attention(q, k, v)
    assert isinstance(o, torch.Tensor) and o.shape == q.shape


GRAD_ATOL = 1e-4
BWD_CASES = [
    (2, 3, 64, 64, 32, True),     # causal
    (2, 3, 64, 64, 32, False),    # non-causal
    (2, 3, 56, 56, 32, True),     # ragged: S not a block multiple
    (2, 2, 32, 48, 16, False),    # cross: Sq < Sk
    (2, 2, 40, 24, 16, True),     # cross + causal, Sq > Sk
    (2, 2, 24, 40, 16, True),     # cross + causal, Sq < Sk
    # where the CUDA kernels' tiles end (K2: 128 query rows x 64 keys; K3:
    # 128 keys x 64 query rows)
    (1, 2, 127, 127, 16, True),   # one row short of a tile
    (1, 2, 128, 128, 16, True),   # exactly one tile
    (1, 2, 129, 129, 16, True),   # one row into a second tile
    (2, 2, 1, 40, 16, True),      # one query row, causal: sees key 0
    (2, 2, 1, 40, 16, False),     # one query row sees every key
    (1, 2, 100, 64, 16, True),    # Sk under one tile, Sq > Sk
]


def _bwd_inputs(B, H, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, H, Sq, D))
    k = _normal(rng, (B, H, Sk, D))
    v = _normal(rng, (B, H, Sk, D))
    do = _normal(rng, (B, H, Sq, D))
    dlse = _normal(rng, (B, H, Sq))
    return q, k, v, do, dlse


def _jax_vjp(q, k, v, do, dlse, causal):
    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, block_q=16,
                                   block_k=16, return_lse=True)

    (o, lse), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v))
    return o, lse, vjp((jnp.asarray(do), jnp.asarray(dlse)))


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", BWD_CASES)
def test_flash_backward_matches_pallas_vjp(B, H, Sq, Sk, D, causal,
                                           with_dlse):
    q, k, v, do, dlse = _bwd_inputs(B, H, Sq, Sk, D, Sq * 7 + Sk)
    if not with_dlse:
        dlse = np.zeros_like(dlse)
    _, _, ref = _jax_vjp(q, k, v, do, dlse, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    outs, cots = ((o, lse), (torch.from_numpy(do), torch.from_numpy(dlse)))
    if not with_dlse:  # lse unused: its cotangent is absent, read as zeros
        outs, cots = (o,), (torch.from_numpy(do),)
    got = torch.autograd.grad(outs, (tq, tk, tv), cots)
    for name, g, r in zip("dq dk dv".split(), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal", BWD_CASES)
def test_flash_backward_plain_matches_pallas_vjp(B, H, Sq, Sk, D, causal):
    """The plain backward from the forward's saved (o, lse): what the CUDA
    kernels are held against on the card."""
    q, k, v, do, dlse = _bwd_inputs(B, H, Sq, Sk, D, Sq + Sk)
    o, lse, ref = _jax_vjp(q, k, v, do, dlse, causal)
    got = tfa.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(do), torch.from_numpy(dlse), causal=causal)
    for name, g, r in zip("dq dk dv".split(), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_takes_q_and_do_as_transposed_views(causal):
    """The models pass q, and autograd then passes do, as ``(B, S, H, D) ->
    (B, H, S, D)`` views; the backward equals the one for the same values
    laid out contiguously, and the Pallas VJP."""
    rng = np.random.default_rng(9)
    q_bshd = _normal(rng, (2, 40, 3, 16))
    do_bshd = _normal(rng, (2, 40, 3, 16))
    k = _normal(rng, (2, 3, 40, 16))
    v = _normal(rng, (2, 3, 40, 16))
    q_view = torch.from_numpy(q_bshd).transpose(1, 2)
    do_view = torch.from_numpy(do_bshd).transpose(1, 2)
    assert not (q_view.is_contiguous() or do_view.is_contiguous())
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    o, lse = tfa.flash_attention(q_view, tk, tv, causal=causal,
                                 return_lse=True)
    got = tfa.flash_attention_bwd(q_view, tk, tv, o, lse, do_view,
                                  causal=causal)
    again = tfa.flash_attention_bwd(q_view.contiguous(), tk, tv, o, lse,
                                    do_view.contiguous(), causal=causal)
    for g, a in zip(got, again):
        torch.testing.assert_close(g, a, rtol=0, atol=0)
    q = q_bshd.transpose(0, 2, 1, 3)
    do = do_bshd.transpose(0, 2, 1, 3)
    _, _, ref = _jax_vjp(q, k, v, do, np.zeros(q.shape[:3], np.float32),
                         causal)
    for name, g, r in zip("dq dk dv".split(), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   err_msg=name)


def test_flash_backward_lse_only_cotangent():
    """Grads flowing only through the returned lse (the ring-merge path),
    against the reference test's dense oracle: jax.grad of sum(lse^2)."""
    q, k, v, _, _ = _bwd_inputs(2, 2, 32, 32, 16, 11)

    def loss_ref(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
        return (jax.nn.logsumexp(s, axis=-1) ** 2).sum()

    ref = jax.grad(loss_ref, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    _, lse = tfa.flash_attention(tq, tk, tv, causal=False, return_lse=True)
    got = torch.autograd.grad((lse ** 2).sum(), (tq, tk, tv))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_ATOL)


def test_flash_backward_handles_strided_and_broadcast_cotangent():
    """Autograd may hand the backward a transposed view or a broadcast as
    ``do``; the result equals the one for the same values laid out
    contiguously."""
    q, k, v, do, _ = _bwd_inputs(1, 2, 16, 16, 8, 3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv)
    for cot in (torch.from_numpy(do).transpose(1, 2).contiguous()
                .transpose(1, 2), torch.ones(()).expand_as(o)):
        got = torch.autograd.grad(o, (tq, tk, tv), cot, retain_graph=True)
        ref = torch.autograd.grad(o, (tq, tk, tv), cot.contiguous(),
                                  retain_graph=True)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r)


def test_flash_forward_under_no_grad_builds_no_graph():
    q = torch.zeros((1, 1, 8, 8), requires_grad=True)
    k = v = torch.zeros((1, 1, 8, 8))
    with torch.no_grad():
        o = tfa.flash_attention(q, k, v)
    assert o.grad_fn is None and not o.requires_grad
    assert tfa.flash_attention(q, k, v).grad_fn is not None


def test_repeat_kv_matches_jnp_repeat():
    rng = np.random.default_rng(1)
    k = _normal(rng, (2, 3, 5, 4))
    v = _normal(rng, (2, 3, 5, 4))
    kr, vr = jfa.repeat_kv(jnp.asarray(k), jnp.asarray(v), 4)
    tk, tv = tfa.repeat_kv(torch.from_numpy(k), torch.from_numpy(v), 4)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vr))
    # query head h reads KV head h // rep, never h % KV
    np.testing.assert_array_equal(tk[:, 5].numpy(), k[:, 1])


def _quant(x):
    s = np.max(np.abs(x), axis=-1) / np.float32(127.0)
    safe = np.maximum(s, np.float32(1e-9))
    q = np.clip(np.round(x / safe[..., None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _decode_inputs(quantized, seed=0, B=2, KV=4, G=2, Dh=16, T=64):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, KV, G, Dh))
    k = _normal(rng, (B, KV, T, Dh))
    v = _normal(rng, (B, KV, T, Dh))
    if not quantized:
        return q, k, v, None, None
    kq, ks = _quant(k)
    vq, vs = _quant(v)
    return q, kq, vq, ks, vs


def _decode_pair(inputs, pos_jax, pos_torch):
    q, k, v, ks, vs = inputs
    jkw = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs))
    tkw = {} if ks is None else dict(k_scale=torch.from_numpy(ks),
                                     v_scale=torch.from_numpy(vs))
    ref = jfa.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos_jax,
        block_k=16, **jkw)
    out = tfa.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        pos_torch, block_k=16, **tkw)
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("pos", [0, 7, 31, 37, 63])
def test_flash_decode_matches_pallas(quantized, pos):
    ref, out = _decode_pair(_decode_inputs(quantized), pos, pos)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_flash_decode_per_row_pos_matches_per_row_calls(quantized):
    """The port's kernel takes one position per batch row; each row must
    equal the JAX kernel called with that row's scalar position."""
    inputs = _decode_inputs(quantized, seed=3, B=3)
    pos = np.array([0, 37, 63], np.int32)
    _, out = _decode_pair(inputs, 0, torch.from_numpy(pos))
    for b, p in enumerate(pos):
        ref, _ = _decode_pair(inputs, int(p), int(p))
        np.testing.assert_allclose(out[b], ref[b], atol=ATOL,
                                   err_msg=f"row {b} pos {p}")


def test_flash_decode_cache_need_not_divide_block():
    """The JAX kernel refuses T % block_k != 0; the port's masks its own
    tail, so any T works and matches the masked oracle."""
    q, k, v, _, _ = _decode_inputs(False, T=60)
    out = tfa.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 59,
        block_k=16)
    s = np.einsum("bkgd,bktd->bkgt", q, k) * q.shape[-1] ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bkgt,bktd->bkgd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_flash_decode_rejects_k_scale_without_v_scale():
    q, k, v, ks, _ = _decode_inputs(True)
    with pytest.raises(ValueError, match="v_scale"):
        tfa.flash_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            3, k_scale=torch.from_numpy(ks))


def test_flash_decode_pos_past_cache_attends_every_key():
    """A position past the cache (a serving slot that ran over its end)
    attends all T keys, as the kernel's clamp at T - 1 and the JAX
    engine's full mask do: each row equals the call at T - 1."""
    inputs = _decode_inputs(True, seed=4, B=2)
    pos = torch.tensor([64, 75], dtype=torch.int32)
    _, out = _decode_pair(inputs, 63, pos)
    ref, _ = _decode_pair(inputs, 63, 63)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_decode_splits_cover_the_cache():
    """The decode kernel's grid: one split of DECODE_SPLIT keys per CTA,
    ceil(T / DECODE_SPLIT) of them, whatever the positions; the constant
    is the kernel's own kSplit."""
    import re

    from dlrover_tpu_torch.ops import _build

    src = _build.sources()["flash_decode"].read_text()
    assert re.search(r"constexpr int kSplit = (\d+);", src).group(1) == str(
        tfa.DECODE_SPLIT)
    assert tfa.DECODE_SPLIT == 256
    for T, want in ((1, 1), (255, 1), (256, 1), (257, 2), (4096, 16),
                    (4100, 17), (32768, 128)):
        assert tfa._decode_splits(T) == want
        assert (want - 1) * tfa.DECODE_SPLIT < T <= want * tfa.DECODE_SPLIT
    assert tfa._decode_splits(0) == 0


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point in csrc/ is called through ctypes with exactly
    the parameter types its declaration has (a missing or extra pointer,
    such as the decode kernel's workspace, would shift every argument)."""
    import ctypes
    import re

    from dlrover_tpu_torch.ops import _build

    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    found = {}
    for src in _build.sources().values():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            found[name] = [
                kinds[re.sub(r"\s*\w+$", "", p.strip()).replace(" *", "*")]
                for p in params.split(",")]
    assert set(found) == set(tfa._SIGNATURES)
    for name, want in found.items():
        assert tfa._SIGNATURES[name] == want, name


def test_launch_counts_stay_zero_on_cpu():
    tfa.reset_launch_counts()
    q, k, v, _, _ = _decode_inputs(False)
    tfa.flash_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), 5)
    assert all(n == 0 for n in tfa.LAUNCHES.values())
