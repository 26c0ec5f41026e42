"""Flash attention for the port: forward, backward and the decode attend.

Counterpart of ``dlrover_tpu/ops/flash_attention.py``. Each kernel has two
implementations, chosen by where its tensors live:

- on a CUDA tensor it launches its hand-written kernel from ``csrc/``
  (the forward of :func:`flash_attention` → ``flash_fwd.cu``, its backward
  :func:`flash_attention_bwd` → ``flash_bwd.cu``, :func:`flash_decode_attention`
  → ``flash_decode.cu``) and raises on anything that kernel does not take;
  there is no fallback;
- on a CPU tensor it runs the plain PyTorch version beside it
  (:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`,
  :func:`flash_decode_plain`), which the CPU tests hold against the JAX
  package and which the card compares each kernel with.

:func:`flash_attention` is a ``torch.autograd.Function`` (the counterpart of
the reference's ``_flash`` custom VJP): it saves ``(q, k, v, o, lse)`` and
its backward takes a cotangent on the returned lse too (the ring-merge path).

Every kernel launch adds one to :data:`LAUNCHES` under the kernel's name,
so a run can show that its main path went through the kernels.
"""

import ctypes
from typing import Dict, Optional

import torch

from dlrover_tpu_torch.ops import _build

NEG_INF = float(-1e30)  # masked score; never -inf, as in the TPU kernels

# kernel name → launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "flash_decode_bf16": 0,
    "flash_decode_int8": 0,
}

_SIGNATURES = {
    "flash_fwd_bf16": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    ),
    "flash_bwd_dq_bf16": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    ),
    "flash_bwd_dkv_bf16": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    ),
    "flash_decode_bf16": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    ),
    "flash_decode_int8": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    ),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _entry(source: str, symbol: str):
    lib = _build.load(source)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def repeat_kv(k, v, rep: int):
    """Broadcast grouped-query K/V heads up to the query head count: head
    axis 1, ``(B, KV, S, D) → (B, KV*rep, S, D)``, each KV head repeated
    ``rep`` times in a row, so query head ``h`` reads KV head ``h // rep``."""
    if rep <= 1:
        return k, v
    return (k.repeat_interleave(rep, dim=1),
            v.repeat_interleave(rep, dim=1))


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _mask(Sq: int, Sk: int, causal: bool, device) -> torch.Tensor:
    """``(Sq, Sk)`` visibility: ``col < Sk`` and, when causal, ``col <= row``
    (top-left alignment: row is the absolute query index)."""
    rows = torch.arange(Sq, device=device)[:, None]
    cols = torch.arange(Sk, device=device)[None, :]
    mask = cols < Sk
    if causal:
        mask = mask & (cols <= rows)
    return mask


def flash_attention_plain(q, k, v, causal: bool = True,
                          scale: Optional[float] = None):
    """Plain PyTorch version of the flash forward, in f32: returns
    ``(o, lse)`` with ``o`` in q's dtype. Same masks and fill values as the
    kernel: ``col < Sk`` and, when causal, ``col <= row`` (top-left
    alignment); a row with no visible key gives ``o = 0``, ``lse = -1e30``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mask = _mask(q.shape[2], k.shape[2], causal, q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)
    o = (torch.matmul(p, v.float()) / safe).to(q.dtype)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(safe))[..., 0]
    return o, lse


def _check_operands(what: str, device, **tensors) -> None:
    """The kernels take bf16 ``(B, H, S, D)`` operands on one device with
    the head dim contiguous and 16-byte aligned rows; raise otherwise."""
    for name, t in tensors.items():
        _require(t.is_cuda and t.device == device,
                 f"{what}: {name} must be on {device}")
        _require(t.dtype == torch.bfloat16,
                 f"{what} kernel takes bf16, {name} is {t.dtype}")
        _require(t.dim() == 4 and t.stride(-1) == 1,
                 f"{what}: {name} must be (B, H, S, D) with the head dim "
                 "contiguous")
        _require(all(s % 8 == 0 for s in t.stride()[:3])
                 and t.data_ptr() % 16 == 0,
                 f"{what}: {name} rows must be 16-byte aligned")


def _check_shapes(what: str, q, k, v) -> None:
    B, H, _, D = q.shape
    Sk = k.shape[2]
    _require(k.shape == (B, H, Sk, D) and v.shape == k.shape,
             f"{what}: k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not "
             f"match q {tuple(q.shape)}")
    _require(D in (64, 128),
             f"{what} kernel takes head_dim 64 or 128, not {D}")


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    _check_operands("flash_attention", q.device, q=q, k=k, v=v)
    _check_shapes("flash_attention", q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    o = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    rc = _entry("flash_fwd", "flash_fwd_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, Sq, Sk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(bool(causal)), _stream(q),
    )
    _build.check(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _delta(o, do, dlse):
    """``rowsum(do * o) - dlse`` in f32, ``(B, H, Sq)``: computed outside the
    kernels, as the reference does (``_bwd`` :341-345)."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def flash_attention_bwd_plain(q, k, v, o, lse, do, dlse=None,
                              causal: bool = True,
                              scale: Optional[float] = None):
    """Plain PyTorch version of the flash backward, in f32: returns
    ``(dq, dk, dv)`` in the dtypes of q, k, v. It is the reference's
    recomputation formula, not autograd of the forward: ``p = exp(s - lse)``
    masked to 0 after the exp, ``delta = rowsum(do * o) - dlse``,
    ``ds = p * (do v^T - delta)``, ``dq = scale * ds k``,
    ``dk = scale * ds^T q``, ``dv = p^T do``. ``dlse`` None means zeros."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mask = _mask(q.shape[2], k.shape[2], causal, q.device)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.where(mask, torch.matmul(qf, kf.transpose(-1, -2)) * scale,
                    NEG_INF)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - _delta(o, do, dlse)[..., None])
    dq = scale * torch.matmul(ds, kf)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_layout(t):
    """``t`` itself when the kernels can read it through its strides (head
    dim contiguous, 16-byte aligned rows), else a contiguous copy: autograd
    may hand over a broadcast or a misaligned view as ``do``."""
    if (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def _check_bwd(q, k, v, do, lse, delta):
    """What both backward kernels take; returns the stride arguments."""
    what = "flash_attention_bwd"
    _check_operands(what, q.device, q=q, k=k, v=v, do=do)
    _check_shapes(what, q, k, v)
    _require(do.shape == q.shape, f"{what}: do must match q")
    B, H, Sq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        _require(t.device == q.device and t.dtype == torch.float32
                 and t.shape == (B, H, Sq) and t.is_contiguous(),
                 f"{what}: {name} must be contiguous f32 ({B}, {H}, {Sq}) "
                 f"on {q.device}")
    return [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3]]


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool,
                       scale: float):
    """K2 (``flash_bwd.cu`` ``flash_bwd_dq_bf16``): dq in q's dtype."""
    strides = _check_bwd(q, k, v, do, lse, delta)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dq = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    rc = _entry("flash_bwd", "flash_bwd_dq_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Sq, Sk, D,
        *strides, float(scale), int(bool(causal)), _stream(q),
    )
    _build.check(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool,
                        scale: float):
    """K3 (``flash_bwd.cu`` ``flash_bwd_dkv_bf16``): dk, dv in k's dtype."""
    strides = _check_bwd(q, k, v, do, lse, delta)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dk = torch.empty((B, H, Sk, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, H, Sk, D), dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    rc = _entry("flash_bwd", "flash_bwd_dkv_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Sq, Sk, D, *strides, float(scale), int(bool(causal)),
        _stream(q),
    )
    _build.check(rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, dlse=None, causal: bool = True,
                        scale: Optional[float] = None):
    """Backward of :func:`flash_attention` from its saved ``(q, k, v, o,
    lse)`` and the cotangents ``do`` and ``dlse`` (None means zeros).
    Returns ``(dq, dk, dv)``. On CUDA tensors it launches K2 then K3 of
    ``flash_bwd.cu``; on CPU tensors it runs
    :func:`flash_attention_bwd_plain`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not any(t.is_cuda for t in (q, k, v, o, lse, do)):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, dlse, causal,
                                         scale)
    delta = _delta(o, do, dlse).contiguous()
    do = _kernel_layout(do)
    lse = lse.contiguous()
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the reference's ``_flash`` custom VJP (:423-454)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if any(t.is_cuda for t in (q, k, v)):
            o, lse = _flash_fwd_cuda(q, k, v, causal, scale)
        else:
            o, lse = flash_attention_plain(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        # an output that got no gradient arrives as zeros (autograd
        # materialises it), so an absent lse cotangent reads as zeros
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, dlse,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q, k, v,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 1024,
    return_lse: bool = False,
):
    """Fused blockwise attention with its backward. q/k/v: ``(B, H, S, D)``;
    GQA callers repeat KV heads first (:func:`repeat_kv`).

    Returns ``o`` ``(B, H, Sq, D)``, plus the per-row log-sum-exp
    ``(B, H, Sq)`` f32 when ``return_lse``; gradients flow from both. On
    CUDA tensors the forward launches ``flash_fwd.cu`` and the backward
    ``flash_bwd.cu`` (bf16, head_dim 64 or 128, any lengths); on CPU
    tensors they run :func:`flash_attention_plain` and
    :func:`flash_attention_bwd_plain`.

    ``block_q``/``block_k`` keep the JAX signature; whatever they say, the
    forward kernel tiles 128 query rows x 128 keys, the dq kernel 128 query
    rows x 64 keys and the dk/dv kernel 128 keys x 64 query rows, and the
    plain versions do not tile. q (and so do) may be a strided view (the
    models pass ``(B, S, H, D)`` transposed): the kernels read them in
    place.
    """
    del block_q, block_k
    if scale is None:
        scale = q.shape[-1] ** -0.5
    o, lse = _FlashAttention.apply(q, k, v, bool(causal), float(scale))
    return (o, lse) if return_lse else o


# ---------------------------------------------------------------------------
# decode (single-token) attention against a KV cache
# ---------------------------------------------------------------------------


# keys per split of the decode kernel (``kSplit`` in ``flash_decode.cu``):
# one CTA per split of each (batch row, KV head)
DECODE_SPLIT = 256


def _decode_splits(T: int) -> int:
    """Splits of the decode kernel's grid for a cache of ``T`` keys,
    ``ceil(T / DECODE_SPLIT)``: a function of T alone, never of the
    positions, so the launch reads nothing back from the device."""
    return -(-T // DECODE_SPLIT)


def _pos_vector(pos, batch: int, device) -> torch.Tensor:
    """``pos`` (int, 0-d or ``(B,)`` tensor) → ``(B,)`` int32 on device."""
    p = torch.as_tensor(pos, dtype=torch.int32).to(device)
    if p.dim() == 0:
        p = p.expand(batch)
    _require(p.shape == (batch,),
             f"pos must be a scalar or ({batch},), not {tuple(p.shape)}")
    return p.contiguous()


def flash_decode_plain(q, k, v, pos, scale: Optional[float] = None,
                       k_scale=None, v_scale=None):
    """Plain PyTorch version of the decode attend, in f32. Same math as the
    kernel, int8 scales folded the same way (``ks`` into the scores,
    ``vs`` into p)."""
    B, KV, G, Dh = q.shape
    T = k.shape[2]
    if scale is None:
        scale = Dh ** -0.5
    p_b = _pos_vector(pos, B, q.device)
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k.float()) * scale
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    mask = (torch.arange(T, device=q.device)[None, :]
            <= p_b[:, None])[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = p * v_scale.float()[:, :, None, :] if v_scale is not None else p
    out = torch.einsum("bkgt,bktd->bkgd", pv, v.float())
    return (out / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def _flash_decode_cuda(q, k, v, pos, scale, k_scale, v_scale):
    B, KV, G, Dh = q.shape
    T = k.shape[2]
    quantized = k_scale is not None
    _require(q.dtype == torch.bfloat16,
             f"flash_decode kernel takes a bf16 query, not {q.dtype}")
    _require(Dh in (64, 128) and 1 <= G <= 8,
             f"flash_decode kernel takes head_dim 64/128 and 1-8 query "
             f"heads per KV head, not Dh={Dh} G={G}")
    want = torch.int8 if quantized else torch.bfloat16
    for name, t in (("k", k), ("v", v)):
        _require(t.is_cuda and t.device == q.device,
                 f"flash_decode: {name} must be on {q.device}")
        _require(t.dtype == want,
                 f"flash_decode: {name} must be {want}, not {t.dtype}")
        _require(t.shape == (B, KV, T, Dh) and t.is_contiguous()
                 and t.data_ptr() % 16 == 0,
                 f"flash_decode: {name} must be a contiguous, 16-byte "
                 f"aligned ({B}, {KV}, T, {Dh}) cache, not "
                 f"{tuple(t.shape)}")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _require(t.is_cuda and t.device == q.device
                     and t.dtype == torch.float32
                     and t.shape == (B, KV, T) and t.is_contiguous(),
                     f"flash_decode: {name} must be contiguous f32 "
                     f"({B}, {KV}, {T}) on {q.device}")
    qc = q.contiguous()
    if qc.data_ptr() % 16:  # the kernel reads q in aligned pairs
        qc = qc.clone()
    p_b = _pos_vector(pos, B, q.device)
    out = torch.empty_like(qc)
    if out.numel() == 0:
        return out
    # each split's unnormalised o (G, Dh), then its m and l (G each), f32
    ws = torch.empty(B * KV * _decode_splits(T) * G * (Dh + 2),
                     dtype=torch.float32, device=q.device)
    if quantized:
        name = "flash_decode_int8"
        rc = _entry("flash_decode", name)(
            qc.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), p_b.data_ptr(), ws.data_ptr(),
            out.data_ptr(), B, KV, G, T, Dh, float(scale), _stream(q),
        )
    else:
        name = "flash_decode_bf16"
        rc = _entry("flash_decode", name)(
            qc.data_ptr(), k.data_ptr(), v.data_ptr(), p_b.data_ptr(),
            ws.data_ptr(), out.data_ptr(), B, KV, G, T, Dh, float(scale),
            _stream(q),
        )
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def flash_decode_attention(
    q, k, v, pos,
    scale: Optional[float] = None,
    block_k: int = 256,
    k_scale=None,
    v_scale=None,
):
    """Single-token attention against a KV cache, fused.

    q: ``(B, KV, G, Dh)`` — the current token's query heads grouped by KV
    head. k/v: ``(B, KV, T, Dh)`` — the head-major cache. ``pos``: a scalar
    or one position per batch row ``(B,)``; row ``b`` attends cache slots
    ``[0, pos[b]]`` only, and the kernel reads nothing past them. With
    ``k_scale``/``v_scale`` ``(B, KV, T)`` f32, k/v are int8 and the kernel
    folds the per-vector scales in without dequantizing the cache.

    On CUDA tensors it launches ``flash_decode.cu`` (bf16 or int8 cache):
    a split kernel on a ``(B * KV, ceil(T / DECODE_SPLIT))`` grid, each CTA
    taking up to 256 keys of one row and KV head (those past the row's
    position exit at once), then a combine kernel that merges the splits'
    partial results in a fixed order, so the output is deterministic. The
    wrapper allocates the f32 workspace between them. On CPU tensors it
    runs :func:`flash_decode_plain`. ``block_k`` keeps the JAX signature:
    the kernel's splits and 64-key tiles mask their own tail, so T need not
    divide by it. A position past the cache attends all T keys. Returns
    ``(B, KV, G, Dh)`` in q's dtype.
    """
    del block_k
    if k_scale is not None and v_scale is None:
        raise ValueError("k_scale given without v_scale")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if any(t.is_cuda for t in (q, k, v)):
        return _flash_decode_cuda(q, k, v, pos, scale, k_scale, v_scale)
    return flash_decode_plain(q, k, v, pos, scale, k_scale, v_scale)
