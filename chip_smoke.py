#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --decode   # the decode kernel (K4) alone

Builds the port's CUDA kernels from ``dlrover_tpu_torch/ops/csrc`` and runs
four phases, each printing one JSON line (the serving runs one each):

1. ``kernels`` — each kernel against its plain PyTorch version on the card,
   in bf16 at its path's shapes, with the error, the kernel's time, the
   plain version's time and, as a yardstick only, the time of PyTorch's
   ``scaled_dot_product_attention`` on the same inputs (forward, decode)
   or of its autograd backward (for the backward pair; the port never
   calls it). The forward (K1) is also held where its 128 x 128 tiles end
   (S 127/128/129, Sq 1, Sk 64, Sk 0), on ragged, cross and head_dim-64
   shapes and with q passed transposed, and timed at both prefill shapes
   and the training shape with its TFLOP/s. The backward pair (K2, K3)
   is held likewise where its tiles end (S 127/128/129, Sq 1, Sq 300 over
   Sk 64, Sk 0 and Sq 0 exactly 0), on ragged, cross, head_dim-64 and
   lse-cotangent shapes and with q and do transposed (bitwise equal to
   contiguous), must give bitwise-equal results on two launches, and is
   timed at the training shape with its TFLOP/s and the time of the
   ``_delta`` pass before it. The decode kernel (K4, bf16 and int8 cache)
   is held where its 256-key splits and 64-key tiles end (positions 0,
   255, 256, 257, T - 1 and past the cache, T 4100, G 1 and 8, Dh 64, one
   row of T 32768), must give bitwise-equal results on two launches, and
   is timed warm and with L2 flushed beside SDPA under a pinned backend;
2. ``generate`` — ``decode.generate`` on ``LlamaConfig()`` at full width
   and depth (the Llama-2-7B shape with 8 KV heads, random weights from a
   seed), batch 8, greedy: (a) bf16 cache, prompt 1024, 64 new tokens,
   preallocated 4096 slots; (b) int8 cache, prompt 2048, 32 new tokens,
   tight cache. Both prefill through the flash-forward kernel and decode
   through the decode kernel; the launch counts must show it. Prefill and
   first-step logits are compared with the dense path;
3. ``engine`` — ``BatchDecodeEngine`` with an int8 cache, 8 slots, 4096
   cache slots, serving 16 requests of ragged lengths with slot reuse;
   every step must go through the decode kernel, ragged or not;
4. ``train`` — ``ElasticTrainer.train_step`` with ``adamw(3e-4)`` on
   ``LlamaConfig()`` at full width and 8 layers (bf16 params, f32 grad
   accumulators and moments), remat "dots", global batch 8 as 2 micro
   batches of 4, sequence 2048, fed by the port's sampler and loader: 3
   counted steps whose launches must be K1 = 2·L·accum (forward and remat
   recompute) and K2 = K3 = L·accum a step; one micro step on the kernel
   path against the dense path; a fixed batch whose loss must fall over 3
   steps; a profile of one step, tokens/s and MFU.

Then one JSON line with every kernel's numbers, the card's name and power
limit from ``nvidia-smi``, and, last, ``{"ok": true, "device": ...}``.
``--decode`` builds K4 alone and runs only its rows, with no result line:
the quick loop for work on that kernel. Any
mismatch, refused launch or fault exits non-zero. Without CUDA the script
exits non-zero and prints no result.

TF32 is switched off for matmuls and cuDNN, so f32 reference products on
the card are full f32.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from dlrover_tpu_torch.models import decode, llama
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.parallel.mesh import plan_mesh
from dlrover_tpu_torch.serving.engine import BatchDecodeEngine
from dlrover_tpu_torch.trainer.data import (
    ElasticDataLoader,
    ElasticDistributedSampler,
    stack_microbatches,
)
from dlrover_tpu_torch.trainer.elastic import (
    ElasticTrainer,
    global_norm,
    make_train_state,
)
from dlrover_tpu_torch.trainer.optim import adamw, tree_leaves, tree_unflatten

# H100 SXM peaks (NVIDIA data sheet, dense): the roofline for bound_ms
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# Kernel vs plain version (o of K1 and K4; dq, dk, dv of K2 and K3), both
# bf16 outputs compared in f32, element by element:
#   |err| <= RTOL * |ref| + ROW_ATOL * rms(ref row) + FLOOR * rms(ref),
# and over the whole output ||err|| <= REL_L2 * ||ref||. A row is one
# head_dim vector: a query row of o and dq, a key row of dk and dv. The two
# sides round their results to bf16 separately (2^-8 relative: the RTOL
# term). The kernels also feed p (and ds) to their products in bf16 (2^-9
# relative each) and sum in another order; those errors add with random
# signs over the row's terms, to about 1e-3 of the row's own size and, in
# the far tail of some 10^7 elements, to nearly 1e-2 of it (ROW_ATOL keeps
# 2x room). So an element near 0 is held to its row's size and not to the
# tensor's largest value: in a causal sequence the last rows are ~sqrt(1/S)
# the size of the first, and a fault confined to them must not hide under
# the first rows' scale. FLOOR only covers rows that are 0 up to f32
# rounding (dq of the first causal row, where ds = p * (dp - delta) cancels
# exactly).
KERNEL_RTOL, KERNEL_ROW_ATOL, KERNEL_FLOOR = 2e-2, 2e-2, 1e-3
KERNEL_REL_L2 = 1e-2
# lse is f32 on both sides from the same bf16 products: only the summation
# order and exp/log rounding differ
LSE_ATOL = 1e-3

# Kernel path vs dense path of the whole 32-layer model, logits compared in
# f32 relative to the reference's largest logit. Both paths are bf16; they
# round attention probabilities at different points (the kernel before its
# PV product in its own order, the dense attend after an f32 softmax), and
# the int8 decode folds the scales in f32 where the dense path dequantizes
# to bf16 first. Those differences pass through 32 residual layers.
LOGITS_REL_TOL = 5e-2
# Engine tokens held against a teacher-forced dense forward of the same
# sequence (bf16 weights, exact bf16 k/v instead of the int8 cache): the
# share of greedy tokens the forward's argmax reproduces.
TEACHER_AGREE_MIN = 0.9

SEED = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# cycles the card idles before a timed window (about 0.3 ms per call timed)
# while the host queues the calls, so the events measure the device's work
# and not the host's: the decode kernel's wrapper takes longer on the host
# than the kernel takes on the card
QUEUE_AHEAD_CYCLES = 500_000


def _queued_ms(fn, iters, cycles, before=None):
    """Device time per call of ``iters`` calls of ``fn`` queued while the
    card idles ``cycles`` (after ``before()``, untimed). Taken again with
    twice the idle while the card reached the window's first event before
    the host had queued the last call (the window would then hold host
    time); fails after four tries."""
    for _ in range(4):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        queued_in_time = not start.query()
        end.record()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        cycles *= 2
        print(f"timing: window retaken with {cycles} idle cycles",
              file=sys.stderr, flush=True)
    raise AssertionError(
        f"timing: the host still queued calls after the card had idled "
        f"{cycles // 2} cycles; the window would measure the host")


def time_ms(fn, iters, device, queue_ahead=True):
    """Mean time of ``fn`` over ``iters`` calls after one warm-up call:
    CUDA events on the card, the host clock elsewhere. With
    ``queue_ahead`` the calls are queued while the card idles, so the
    time is the device's; without it they run back to back as the host
    issues them, so it is what a caller that waits on each call pays,
    host included."""
    fn()
    _sync(device)
    if device.type == "cuda" and queue_ahead:
        return _queued_ms(fn, iters, QUEUE_AHEAD_CYCLES * iters)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_profile(fn, iters, device, top=5, match=None):
    """``fn`` run ``iters`` times under ``torch.profiler`` (device activity
    only, so the host pays little for the tracing): wall time and device
    kernel time per call, the device's idle share, the ``top`` kernels
    that took most of it and, with ``match``, the device time per call of
    the kernels whose name contains it."""
    from torch.profiler import ProfilerActivity, profile

    act = (ProfilerActivity.CUDA if device.type == "cuda"
           else ProfilerActivity.CPU)
    _sync(device)
    with profile(activities=[act]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    out = dict(
        steps=iters, wall_ms=wall_s * 1e3 / iters,
        device_busy_ms=busy_s * 1e3 / iters, idle_share=1 - busy_s / wall_s,
        top_kernels_ms=[[e.key[:80], e.self_device_time_total / 1e3 / iters]
                        for e in ranked],
    )
    if match is not None:
        out[f"{match}_ms"] = sum(e.self_device_time_total for e in kernels
                                 if match in e.key) / 1e3 / iters
    return out


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def emit(obj):
    print(json.dumps(obj), flush=True)


def _check_close(name, out, ref):
    """Hold a kernel's output against its plain version at the KERNEL_*
    tolerance. Returns the largest |err|, ||err|| / ||ref||, and the
    largest share of its element's limit that an error takes."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    row_rms = ref.square().mean(dim=-1, keepdim=True).sqrt()
    lim = (KERNEL_RTOL * ref.abs() + KERNEL_ROW_ATOL * row_rms
           + KERNEL_FLOOR * float(ref.square().mean().sqrt()))
    bad = int((err > lim).sum())
    rel_l2 = float(torch.linalg.vector_norm(err)
                   / torch.linalg.vector_norm(ref))
    share = float((err / lim).max())
    if bad or rel_l2 > KERNEL_REL_L2 or not torch.isfinite(out).all():
        raise AssertionError(
            f"{name}: {bad} elements outside |err| <= {KERNEL_RTOL}*|ref| + "
            f"{KERNEL_ROW_ATOL}*rms(row) + {KERNEL_FLOOR}*rms(ref) (worst "
            f"{share:.3g} of its limit), ||err||/||ref|| {rel_l2:.3g} "
            f"(limit {KERNEL_REL_L2}), max err {float(err.max()):.4g}")
    return dict(max_abs_err=float(err.max()), rel_l2=rel_l2,
                share_of_limit=share)


def _worst(checks):
    """The largest of each number over several _check_close results."""
    return {key: max(c[key] for c in checks) for key in checks[0]}


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------


def _fwd_case(gen, device, B, H, Sq, Sk, D, causal, transposed_q=False):
    """K1 against its plain version on one case; ``transposed_q`` passes q
    as the ``(B, S, H, D) -> (B, H, S, D)`` view the models pass, and the
    result must also equal the one for the same q laid out contiguously.
    With Sk = 0 the plain version has no key to reduce over: every row must
    then give o = 0 and lse = -1e30 exactly."""
    shape = (B, Sq, H, D) if transposed_q else (B, H, Sq, D)
    q = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    if transposed_q:
        q = q.transpose(1, 2)
    k, v = (torch.randn((B, H, Sk, D), generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    tag = (f"flash_fwd B{B} H{H} Sq{Sq} Sk{Sk} D{D} causal={causal}"
           + (" q transposed" if transposed_q else ""))
    if Sk == 0:
        if not (torch.equal(o, torch.zeros_like(o))
                and bool((lse == fa.NEG_INF).all())):
            raise AssertionError(f"{tag}: rows with no key must give o = 0 "
                                 f"and lse = {fa.NEG_INF}")
        return (q, k, v), dict(max_abs_err=0.0, rel_l2=0.0,
                               share_of_limit=0.0)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=causal)
    check = _check_close(tag, o, o_ref)
    lse_err = float((lse - lse_ref).abs().max())
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"{tag} lse: max err {lse_err:.4g} > {LSE_ATOL}")
    if transposed_q:
        o2, lse2 = fa.flash_attention(q.contiguous(), k, v, causal=causal,
                                      return_lse=True)
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{tag}: differs from the contiguous q")
    return (q, k, v), check


def _visible_pairs(Sq, Sk, causal):
    if not causal:
        return Sq * Sk
    rows = torch.arange(Sq)
    return int(torch.clamp(rows + 1, max=Sk).sum())


def _bwd_case(gen, device, B, H, Sq, Sk, D, causal, with_dlse=False,
              transposed=False):
    """K1 forward, then K2 + K3 against the plain backward on the same
    (o, lse, do, dlse); returns the inputs and the check of each output.
    ``transposed`` passes q and do as the ``(B, S, H, D) -> (B, H, S, D)``
    views the models pass, and the result must also equal, bit for bit, the
    one for the same values laid out contiguously. With Sk = 0 (no key) dq
    must be exactly 0, and with Sq = 0 (no query) dk and dv."""

    def rows(s):
        shape = (B, s, H, D) if transposed else (B, H, s, D)
        t = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        return t.transpose(1, 2) if transposed else t

    q, do = rows(Sq), rows(Sq)
    k, v = (torch.randn((B, H, Sk, D), generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    dlse = (torch.randn((B, H, Sq), generator=gen, device=device)
            if with_dlse else None)
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, dlse, causal)
    tag = (f"flash_bwd B{B} H{H} Sq{Sq} Sk{Sk} D{D} causal={causal} "
           f"dlse={with_dlse}" + (" q, do transposed" if transposed else ""))
    if Sk == 0 or Sq == 0:
        zero = got[:1] if Sk == 0 else got[1:]
        if not all(torch.equal(g, torch.zeros_like(g)) for g in zero):
            raise AssertionError(f"{tag}: gradients with nothing to sum over "
                                 "must be exactly 0")
        none = dict(max_abs_err=0.0, rel_l2=0.0, share_of_limit=0.0)
        return (q, k, v, o, lse, do), dict.fromkeys(("dq", "dk", "dv"), none)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, dlse, causal)
    checks = {name: _check_close(f"{tag} {name}", out, r)
              for name, out, r in zip(("dq", "dk", "dv"), got, ref)}
    if transposed:
        again = fa.flash_attention_bwd(q.contiguous(), k, v, o, lse,
                                       do.contiguous(), dlse, causal)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: differs from contiguous q and do")
    return (q, k, v, o, lse, do), checks


def bwd_kernel_rows(gen, device, shape, iters):
    """K2 and K3 at the training shape (causal) and where their tiles end
    (S 127/128/129, Sq 1, Sq 300 over Sk 64, Sk 0, Sq 0), on ragged, cross
    (both causal alignments), head_dim-64 and lse-cotangent cases and with
    q and do passed transposed; two launches on the same inputs must agree
    bit for bit. Each kernel is timed alone by CUDA events, with its
    TFLOP/s, beside the plain backward and, as the library time of each,
    autograd of SDPA timed for its backward alone (it computes dq, dk and
    dv together: no single PyTorch call computes K2 or K3 alone). The rows
    also give the time of ``_delta``, the plain PyTorch pass that every
    backward call makes before the kernels."""
    B, H, S, D = shape
    (q, k, v, o, lse, do), checks = _bwd_case(gen, device, B, H, S, S, D,
                                              True)
    extra = {
        name: _bwd_case(gen, device, *args)[1] for name, args in (
            ("S127", (2, 8, 127, 127, D, True)),
            ("S128", (2, 8, 128, 128, D, True)),
            ("S129", (2, 8, 129, 129, D, True)),
            # with an lse cotangent: without one, the single visible key
            # gives ds = dp - delta = 0 up to rounding, and dq and dk would
            # be held to f32 noise
            ("Sq1 Sk1000 causal", (2, 8, 1, 1000, D, True, True)),
            ("Sq1 Sk1000", (2, 8, 1, 1000, D, False)),
            ("Sq300 Sk64 causal", (2, 8, 300, 64, D, True)),
            ("Sq300 Sk0 causal", (2, 8, 300, 0, D, True)),
            ("Sq0 Sk300 causal", (2, 8, 0, 300, D, True)),
            ("ragged S1000", (2, 8, 1000, 1000, D, True)),
            ("cross Sq300 Sk1000 D64", (2, 8, 300, 1000, 64, False)),
            ("cross causal Sq300 Sk1000", (2, 8, 300, 1000, D, True)),
            ("cross causal Sq1000 Sk300 D64", (2, 8, 1000, 300, 64, True)),
            ("S1000 D64", (2, 8, 1000, 1000, 64, True)),
            ("lse cotangent S1000", (2, 8, 1000, 1000, D, True, True)),
            ("q, do transposed S1000", (2, 8, 1000, 1000, D, True, False,
                                        True)),
        )
    }
    scale = D ** -0.5
    delta = fa._delta(o, do, None).contiguous()
    delta_ms = time_ms(lambda: fa._delta(o, do, None), iters, device)
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, None, True), max(1, iters // 3), device)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                           is_causal=True)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True), iters, device)
    pairs = B * H * _visible_pairs(S, S, True)
    row_bytes = B * H * S * D * 2  # one (B, H, S, D) bf16 tensor
    reads = 4 * row_bytes + 2 * B * H * S * 4  # q, k, v, do; lse, delta
    shape_tag = f"B{B} H{H} S{S} D{D} causal bf16"
    rows = {}
    for name, fn, flops, nbytes, outs in (
            ("flash_bwd_dq", fa._flash_bwd_dq_cuda, 6 * D * pairs,
             reads + row_bytes, ("dq",)),
            ("flash_bwd_dkv", fa._flash_bwd_dkv_cuda, 8 * D * pairs,
             reads + 2 * row_bytes, ("dk", "dv"))):
        def launch():
            return fn(q, k, v, do, lse, delta, True, scale)

        first, second = launch(), launch()
        if name == "flash_bwd_dq":
            first, second = (first,), (second,)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ")
        bms, by = bound_ms(nbytes, flops)
        ms = time_ms(launch, iters, device)
        rows[name] = dict(
            shape=shape_tag, **_worst([checks[n] for n in outs]),
            other_cases={c: _worst([e[n] for n in outs])
                         for c, e in extra.items()},
            deterministic=True, ms=ms, tflops=flops / ms / 1e9,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=sdpa_bwd_ms,
            library="scaled_dot_product_attention backward (dq, dk, dv)",
            delta_ms=delta_ms,
        )
    return rows


def _decode_case(gen, device, B, KV, G, Dh, T, pos, quant):
    """K4 on one case: two launches must be bitwise equal, and the output
    must agree with ``flash_decode_plain``. Returns the inputs and the
    check."""
    q = torch.randn((B, KV, G, Dh), generator=gen,
                    device=device).to(torch.bfloat16)
    kf = torch.randn((B, KV, T, Dh), generator=gen, device=device)
    vf = torch.randn((B, KV, T, Dh), generator=gen, device=device)
    if quant:
        (k, ks), (v, vs) = decode._quantize(kf), decode._quantize(vf)
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        ks = vs = None
    del kf, vf
    pos = torch.tensor(pos, dtype=torch.int32, device=device)
    out = fa.flash_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
    again = fa.flash_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
    tag = (f"flash_decode_{'int8' if quant else 'bf16'} B{B} KV{KV} G{G} "
           f"Dh{Dh} T{T} pos {pos.tolist()}")
    if not torch.equal(out, again):
        raise AssertionError(f"{tag}: two launches on the same inputs differ")
    ref = fa.flash_decode_plain(q, k, v, pos, k_scale=ks, v_scale=vs)
    return (q, k, v, ks, vs, pos), _check_close(tag, out, ref)


def _sdpa_decode(q, k, v, pos):
    """K4's function as one SDPA call under a pinned backend: cuDNN, the
    fastest fused backend that takes a bool mask with ``enable_gqa`` on
    the card (EFFICIENT_ATTENTION does not take ``enable_gqa`` and was
    slower with the G heads as query rows; FLASH takes no mask). The G
    query heads of a KV head are its ``enable_gqa`` group. SDPA reads all
    T keys; K4 reads [0, pos]."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, KV, G, Dh = q.shape
    T = k.shape[2]
    qh = q.reshape(B, KV * G, 1, Dh)
    mask = (torch.arange(T, device=q.device)[None, :]
            <= pos[:, None])[:, None, None, :]           # (B, 1, 1, T)

    def call():
        with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask, enable_gqa=True)
    return call, ("scaled_dot_product_attention, backend pinned to "
                  "CUDNN_ATTENTION (enable_gqa, bool mask; reads all T "
                  "keys)")


def _cold_ms(fn, iters, device):
    """Mean device time of ``fn`` over ``iters`` launches, each timed alone
    by CUDA events after 128 MB are written, so its inputs start outside
    the 50 MB L2 cache as they do between the layers of a decode step (the
    card idles between the write and the launch while the host queues
    it)."""
    if device.type != "cuda":
        return time_ms(fn, iters, device)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=device)
    fn()
    return sum(_queued_ms(fn, 1, QUEUE_AHEAD_CYCLES, before=flush.zero_)
               for _ in range(iters)) / iters


def decode_kernel_rows(gen, device, shape, iters):
    """K4, bf16 and int8 cache, at the timed row ``shape`` (B, KV, G, Dh,
    T) with ragged positions that include 0 and T - 1, and on the cases
    where its 256-key splits and 64-key tiles end: positions 0, 255, 256,
    257, T - 1 and one past the cache; T = 4100 (a tail tile in a partial
    last split); G 1 and 8; Dh 64; one row of T = 32768. Every case takes
    two launches that must agree bit for bit. Timed by CUDA events: warm
    (the mean of ``iters`` launches queued while the card idles), with L2
    flushed before each launch, and back to back as the host issues them
    (the host's cost included); beside the plain version and (bf16) SDPA
    under a pinned backend on the same inputs."""
    B, KV, G, Dh, T = shape
    rng = np.random.default_rng(SEED)
    pos_np = rng.integers(0, T, B)
    pos_np[0], pos_np[-1] = 0, T - 1  # both ends of the cache
    visible = KV * int((np.minimum(pos_np, T - 1) + 1).sum())
    extra_cases = (
        ("pos 0/255/256/257/T-1/T+5", (6, KV, G, Dh, T,
                                       [0, 255, 256, 257, T - 1, T + 5])),
        ("T4100", (3, KV, G, Dh, 4100, [4099, 4096, 1000])),
        ("G1", (2, KV, 1, Dh, T, [T - 1, 1234])),
        ("G8", (2, KV, 8, Dh, T, [T - 1, 1234])),
        ("Dh64", (2, KV, G, 64, T, [T - 1, 777])),
        ("B1 KV1 T32768", (1, 1, G, Dh, 32768, [32767])),
    )
    rows = {}
    for name, quant in (("flash_decode_bf16", False),
                        ("flash_decode_int8", True)):
        (q, k, v, ks, vs, pos), check = _decode_case(
            gen, device, B, KV, G, Dh, T, pos_np.tolist(), quant)
        extra = {c: _decode_case(gen, device, *args, quant)[1]
                 for c, args in extra_cases}
        per_vec = Dh + 4 if quant else 2 * Dh
        nbytes = 2 * visible * per_vec + 2 * q.numel() * 2 + B * 4
        flops = 4 * G * Dh * visible
        bms, by = bound_ms(nbytes, flops)

        def launch():
            return fa.flash_decode_attention(q, k, v, pos, k_scale=ks,
                                             v_scale=vs)

        library_ms = cold_library_ms = b2b_library_ms = library = None
        if not quant:
            sdpa, library = _sdpa_decode(q, k, v, pos)
            library_ms = time_ms(sdpa, iters, device)
            b2b_library_ms = time_ms(sdpa, iters, device, queue_ahead=False)
            cold_library_ms = _cold_ms(sdpa, iters, device)
        rows[name] = dict(
            shape=(f"B{B} KV{KV} G{G} Dh{Dh} T{T} ragged pos "
                   f"{pos_np.tolist()}"),
            **check, other_cases=extra, deterministic=True,
            grid=[B * KV, fa._decode_splits(T)],
            ms=time_ms(launch, iters, device),
            # host included: the wrapper's checks, workspace and ctypes
            # call, which a decode step that waits on the host pays
            back_to_back_ms=time_ms(launch, iters, device,
                                    queue_ahead=False),
            cold_ms=_cold_ms(launch, iters, device),
            # device time per call of the split and the combine kernel
            profile=device_profile(launch, iters, device, top=2),
            plain_ms=time_ms(lambda: fa.flash_decode_plain(
                q, k, v, pos, k_scale=ks, v_scale=vs),
                max(1, iters // 3), device),
            bound_ms=bms, bound_by=by, library_ms=library_ms,
            back_to_back_library_ms=b2b_library_ms,
            cold_library_ms=cold_library_ms, library=library,
        )
        del q, k, v, ks, vs
    return rows


def kernel_phase(device, fwd_shape, bwd_shape, decode_shape, iters=10,
                 fwd_timed=()):
    """Hold every kernel against its plain version; returns the JSON rows
    of the kernel table (without launches). K1 is timed at ``fwd_shape``
    and at each causal ``(B, H, S)`` of ``fwd_timed`` (same head_dim)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    B, H, S, D = fwd_shape
    cases = {}
    (q, k, v), check = _fwd_case(gen, device, B, H, S, S, D, True)
    # edges of the 128 x 128 tiles, ragged and cross shapes (both causal
    # alignments), head_dim 64, and q as the models pass it
    extra = {
        name: _fwd_case(gen, device, *args)[1] for name, args in (
            ("S127", (2, 8, 127, 127, D, True)),
            ("S128", (2, 8, 128, 128, D, True)),
            ("S129", (2, 8, 129, 129, D, True)),
            ("Sq1 Sk1000 causal", (2, 8, 1, 1000, D, True)),
            ("Sq1 Sk1000", (2, 8, 1, 1000, D, False)),
            ("Sq300 Sk64 causal", (2, 8, 300, 64, D, True)),
            ("Sq300 Sk0 causal", (2, 8, 300, 0, D, True)),
            ("ragged S1000", (2, 8, 1000, 1000, D, True)),
            ("cross Sq300 Sk1000 D64", (2, 8, 300, 1000, 64, False)),
            ("cross causal Sq1000 Sk300 D64", (2, 8, 1000, 300, 64, True)),
            ("S1000 D64", (2, 8, 1000, 1000, 64, True)),
            ("q transposed S1000", (2, 8, 1000, 1000, D, True, True)),
        )
    }
    timings = {}
    for tb, th, ts in dict.fromkeys([(B, H, S), *fwd_timed]):
        if (tb, th, ts) == (B, H, S):
            tq, tk, tv = q, k, v
        else:
            tq, tk, tv = (torch.randn((tb, th, ts, D), generator=gen,
                                      device=device).to(torch.bfloat16)
                          for _ in range(3))
        flops = 4 * D * tb * th * _visible_pairs(ts, ts, True)
        bms, by = bound_ms(4 * tb * th * ts * D * 2 + tb * th * ts * 4, flops)
        ms = time_ms(lambda: fa.flash_attention(tq, tk, tv, causal=True),
                     iters, device)
        timings[f"B{tb} H{th} S{ts}"] = dict(
            ms=ms, tflops=flops / ms / 1e9, bound_ms=bms, bound_by=by,
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    tq, tk, tv, is_causal=True), iters, device))
        del tq, tk, tv
    main = timings[f"B{B} H{H} S{S}"]
    cases["flash_fwd"] = dict(
        shape=f"B{B} H{H} S{S} D{D} causal bf16", **check,
        other_cases=extra, ms=main["ms"], tflops=main["tflops"],
        plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                         max(1, iters // 3), device),
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"],
        library="scaled_dot_product_attention (causal)",
        timings=timings,
    )
    del q, k, v
    cases.update(bwd_kernel_rows(gen, device, bwd_shape, iters))

    cases.update(decode_kernel_rows(gen, device, decode_shape, iters))
    emit({"phase": "kernels", **cases})
    return cases


# ---------------------------------------------------------------------------
# phase 2: generate at full width
# ---------------------------------------------------------------------------


def _launches():
    return dict(fa.LAUNCHES)


def _rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def generate_phase(params, config, device, tag, batch, prompt_len, new,
                   quantize, max_len, timed_steps):
    gen = torch.Generator(device=device).manual_seed(SEED + prompt_len)
    prompt = torch.randint(0, config.vocab_size, (batch, prompt_len),
                           generator=gen, device=device)
    total = prompt_len + new
    T, flash = decode.planned_cache_len(total, quantize, max_len,
                                        device=device)
    L = config.n_layers

    # the main path: one generate call, counted
    fa.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    out = decode.generate(params, prompt, config, None, new,
                          temperature=0.0, max_len=max_len,
                          quantize_cache=quantize)
    _sync(device)
    generate_s = time.perf_counter() - t0
    counts = _launches()
    k4 = "flash_decode_int8" if quantize else "flash_decode_bf16"
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want["flash_fwd"] = L if prompt_len >= 256 else 0
    if flash:
        want[k4] = L * (new - 1)
    if counts != want:
        raise AssertionError(f"generate {tag}: launches {counts}, "
                             f"expected {want}")
    if (tuple(out.shape) != (batch, total)
            or not torch.equal(out[:, :prompt_len].long(), prompt)
            or int(out.min()) < 0 or int(out.max()) >= config.vocab_size):
        raise AssertionError(f"generate {tag}: malformed output")

    # TTFT and decode rate, and the kernel path against the dense path
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = decode.prefill(params, prompt, config, T, quantize)
    _sync(device)
    ttft_s = time.perf_counter() - t0
    dense_cfg = dataclasses.replace(config, use_flash_attention=False)
    os.environ["DLROVER_TPU_FLASH_DECODE"] = "0"
    try:
        ref_logits, ref_cache = decode.prefill(params, prompt, dense_cfg, T,
                                               quantize)
        tok = torch.argmax(logits, dim=-1)
        ref_step, _ = decode.decode_step(params, tok, ref_cache, dense_cfg)
    finally:
        del os.environ["DLROVER_TPU_FLASH_DECODE"]
    del ref_cache
    step_logits, cache = decode.decode_step(params, tok, cache, config,
                                            flash=flash)
    prefill_err = _rel_err(logits, ref_logits)
    step_err = _rel_err(step_logits, ref_step)
    if not (torch.isfinite(logits).all() and torch.isfinite(step_logits)
            .all()) or max(prefill_err, step_err) > LOGITS_REL_TOL:
        raise AssertionError(
            f"generate {tag}: kernel vs dense logits rel err prefill "
            f"{prefill_err:.4g}, step {step_err:.4g} > {LOGITS_REL_TOL}")
    state = {"tok": torch.argmax(step_logits, dim=-1), "cache": cache}

    def step():
        lg, state["cache"] = decode.decode_step(params, state["tok"],
                                                state["cache"], config,
                                                flash=flash)
        state["tok"] = torch.argmax(lg, dim=-1)

    _sync(device)
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        step()
    _sync(device)
    decode_s = time.perf_counter() - t0
    # where the time goes: device kernels vs the rest (host)
    profile = device_profile(step, 4, device, match="flash_decode")
    prefill_profile = device_profile(
        lambda: decode.prefill(params, prompt, config, T, quantize), 1,
        device)
    row = dict(
        phase="generate", run=tag, batch=batch, prompt_len=prompt_len,
        new_tokens=new, cache=("int8" if quantize else "bf16"),
        cache_len=T, decode_kernel=flash, generate_s=generate_s,
        ttft_s=ttft_s, decode_tok_per_s=batch * timed_steps / decode_s,
        decode_step_ms=decode_s * 1e3 / timed_steps, launches=counts,
        logits_rel_err_prefill=prefill_err, logits_rel_err_step=step_err,
        decode_step_profile=profile, prefill_profile=prefill_profile,
    )
    emit(row)
    return counts


# ---------------------------------------------------------------------------
# phase 3: the batched engine on ragged slots
# ---------------------------------------------------------------------------


def _bucket(n):
    b = 128
    while b < n:
        b *= 2
    return b


def engine_phase(params, config, device, slots, cache_len, n_requests,
                 len_range, new_range, n_teacher):
    rng = np.random.default_rng(SEED)
    reqs = []
    for _ in range(n_requests):
        n = int(rng.integers(len_range[0], len_range[1] + 1))
        reqs.append((rng.integers(1, config.vocab_size, n).tolist(),
                     int(rng.integers(new_range[0], new_range[1] + 1))))
    engine = BatchDecodeEngine(params, config, slots=slots,
                               cache_len=cache_len, quantize=True,
                               device=device)
    flash = decode.flash_decode_wanted(cache_len, True, device=device)
    L = config.n_layers

    fa.reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    active = [None] * slots  # slot -> [request index, position, tokens]
    done = {}
    pending = list(range(n_requests))
    steps = ragged_steps = 0
    while pending or any(a is not None for a in active):
        for s in range(slots):
            if active[s] is None and pending:
                r = pending.pop(0)
                prompt = reqs[r][0]
                res = engine.prefill_rows(prompt, _bucket(len(prompt)))
                active[s] = [r, len(prompt), [engine.insert(res, s)]]
        live = [a is not None for a in active]
        if len({a[1] for a in active if a is not None}) > 1:
            ragged_steps += 1
        nxt = engine.step([a[2][-1] if a else 0 for a in active], live)
        steps += 1
        for s, a in enumerate(active):
            if a is None:
                continue
            a[1] += 1
            a[2].append(nxt[s])
            if len(a[2]) == reqs[a[0]][1]:
                done[a[0]] = a[2]
                active[s] = None
    _sync(device)
    serve_s = time.perf_counter() - t0
    counts = _launches()
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want["flash_decode_int8"] = L * steps if flash else 0
    if counts != want or not flash or ragged_steps == 0:
        raise AssertionError(
            f"engine: launches {counts} (expected {want}), decode kernel "
            f"{flash}, ragged steps {ragged_steps}")
    if len(done) != n_requests or any(
            len(done[r]) != reqs[r][1]
            or min(done[r]) < 0 or max(done[r]) >= config.vocab_size
            for r in done):
        raise AssertionError("engine: a request was not served in full")

    # teacher-forced check: a dense forward over prompt + generated tokens
    # should predict the generated tokens (bf16; see TEACHER_AGREE_MIN)
    dense_cfg = dataclasses.replace(config, use_flash_attention=False)
    agree = total = 0
    for r in range(n_teacher):
        prompt, gen = reqs[r][0], done[r]
        seq = torch.tensor([prompt + gen[:-1]], device=device)
        with torch.no_grad():
            logits = llama.forward(params, seq, dense_cfg)[0]
        pred = torch.argmax(logits[len(prompt) - 1:], dim=-1).tolist()
        agree += sum(int(a == b) for a, b in zip(pred, gen))
        total += len(gen)
        del logits
    agreement = agree / total
    new_tokens = sum(len(t) for t in done.values())
    emit(dict(
        phase="engine", slots=slots, cache_len=cache_len, cache="int8",
        requests_served=len(done), new_tokens=new_tokens, steps=steps,
        ragged_steps=ragged_steps, serve_s=serve_s,
        tok_per_s=new_tokens / serve_s, launches=counts,
        kv_cache_bytes=engine.kv_cache_bytes(),
        teacher_forced_agreement=agreement, teacher_requests=n_teacher,
    ))
    if agreement < TEACHER_AGREE_MIN:
        raise AssertionError(f"engine: teacher-forced agreement "
                             f"{agreement:.3f} < {TEACHER_AGREE_MIN}")
    return counts


# ---------------------------------------------------------------------------
# phase 4: the training step at full width
# ---------------------------------------------------------------------------

# Kernel path vs dense path of one micro step of the 8-layer model, both
# bf16, relative to the dense value: the loss, and for every grad leaf
# (each stacked over the layers) its norm and ||g_kernel - g_dense|| /
# ||g_dense||. The paths round attention differently (the kernels round p
# and ds to bf16 before their products; the dense path rounds the f32
# softmax to bf16 before P V and runs its backward through autograd in
# bf16). The loss averages 8192 tokens and a leaf's norm sums its
# elements' squares, so both move far less than single elements; the
# difference of a leaf carries every element's rounding through 8 layers
# of backward. On an H100 (700 W) the gaps were 1.3e-5 (loss), at most
# 2.2e-4 (leaf norms) and 0.012-0.022 (leaf differences). A fault in K2 or
# K3 (say dk = 0) changes the wq, wk, wv leaves by the size of their
# gradient, far past these limits.
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_LEAF_NORM_REL_TOL = 1e-3
TRAIN_LEAF_DIFF_REL_TOL = 5e-2


def _matmul_params(c):
    q_dim, kv_dim = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    per_layer = (c.dim * q_dim + 2 * c.dim * kv_dim + q_dim * c.dim
                 + 3 * c.dim * c.ffn_dim)
    return c.n_layers * per_layer + c.dim * c.vocab_size


def _leaf_names(tree, prefix=""):
    """Dotted paths of a nested dict's leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [name for key in sorted(tree)
                for name in _leaf_names(tree[key], f"{prefix}{key}.")]
    return [prefix[:-1]]


def _loss_and_grads(params, tokens, config):
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = llama.next_token_loss(tree_unflatten(params, live), tokens,
                                     config)
        grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), grads


def kernel_vs_dense(params, tokens, config):
    """One micro step's loss and grads on the kernel path against the
    dense path (``use_flash_attention=False``), at the TRAIN_* limits."""
    loss_k, grads_k = _loss_and_grads(params, tokens, config)
    dense = dataclasses.replace(config, use_flash_attention=False)
    loss_d, grads_d = _loss_and_grads(params, tokens, dense)
    leaves = {}
    for name, gk, gd in zip(_leaf_names(params), grads_k, grads_d):
        gk, gd = gk.float(), gd.float()
        nd = float(torch.linalg.vector_norm(gd))
        leaves[name] = dict(
            norm_rel=abs(float(torch.linalg.vector_norm(gk)) - nd) / nd,
            diff_rel=float(torch.linalg.vector_norm(gk - gd)) / nd)
    out = dict(loss=[loss_k, loss_d],
               loss_rel=abs(loss_k - loss_d) / abs(loss_d),
               grad_norm=[float(global_norm(grads_k)),
                          float(global_norm(grads_d))],
               leaves=leaves)
    bad = [n for n, v in leaves.items()
           if not (v["norm_rel"] <= TRAIN_LEAF_NORM_REL_TOL
                   and v["diff_rel"] <= TRAIN_LEAF_DIFF_REL_TOL)]
    if bad or not out["loss_rel"] <= TRAIN_LOSS_REL_TOL:
        raise AssertionError(
            f"train: kernel vs dense outside loss {TRAIN_LOSS_REL_TOL}, "
            f"leaf norm {TRAIN_LEAF_NORM_REL_TOL}, leaf difference "
            f"{TRAIN_LEAF_DIFF_REL_TOL} (leaves {bad}): {out}")
    return out


def train_phase(config, device, global_batch, micro_batch, seq, steps, lr):
    """``ElasticTrainer.train_step`` fed as examples/llama_elastic_pretrain.py
    feeds it (sampler → loader → stack_microbatches, without worker.init and
    the checkpointer): ``steps`` counted steps on fresh batches, the kernel
    path against the dense path on one micro step, then one fixed batch for
    3 steps, the middle one profiled. Returns the counted launches."""
    c = config
    L = c.n_layers
    params = llama.init_params(
        c, torch.Generator(device=device).manual_seed(SEED + 1), device)
    opt = adamw(lr)
    trainer = ElasticTrainer(
        lambda p, t: llama.next_token_loss(p, t, c), opt, global_batch,
        micro_batch, device=device)
    accum = trainer.configure_for_world(plan_mesh(1))
    state = make_train_state(params, opt)
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, c.vocab_size, (global_batch * (steps + 2),
                                          seq + 1), dtype=np.int32)
    sampler = ElasticDistributedSampler(len(data), num_replicas=1, rank=0,
                                        shuffle=True, seed=SEED)
    loader = iter(ElasticDataLoader(data, trainer.micro_batch_global,
                                    sampler=sampler))

    def next_batch():
        batch = stack_microbatches([next(loader) for _ in range(accum)])
        sampler.record_batch(global_batch)
        return batch

    probe = [params["layers"]["wq"][0, :64, :64].clone(),
             params["lm_head"][:64, :64].clone()]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # the main path: `steps` train steps, counted
    fa.reset_launch_counts()
    losses, norms, step_s = [], [], []
    for _ in range(steps):
        batch = next_batch()
        _sync(device)
        t0 = time.perf_counter()
        state, res = trainer.train_step(state, batch)
        losses.append(float(res.loss))
        norms.append(float(res.grad_norm))
        step_s.append(time.perf_counter() - t0)
    counts = _launches()
    want = dict.fromkeys(fa.LAUNCHES, 0)
    want["flash_fwd"] = 2 * L * accum * steps  # forward + remat recompute
    want["flash_bwd_dq"] = want["flash_bwd_dkv"] = L * accum * steps
    if counts != want:
        raise AssertionError(f"train: launches {counts}, expected {want}")
    moved = [not torch.equal(a, b) for a, b in zip(
        probe, [params["layers"]["wq"][0, :64, :64],
                params["lm_head"][:64, :64]])]
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))
            and all(moved) and int(state["step"]) == steps):
        raise AssertionError(f"train: losses {losses}, grad norms {norms}, "
                             f"params moved {moved}")
    peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9
               if device.type == "cuda" else None)

    # kernel path vs dense path on one micro step
    fixed = next_batch()
    versus_dense = kernel_vs_dense(
        params, torch.as_tensor(fixed[0]).to(device), c)

    # one fixed batch, 3 steps: its loss must fall step over step
    fixed_losses = []

    def fixed_step():
        nonlocal state
        state, res = trainer.train_step(state, fixed)
        fixed_losses.append(float(res.loss))

    fixed_step()
    profile = device_profile(fixed_step, 1, device, top=12)
    fixed_step()
    if not all(b < a for a, b in zip(fixed_losses, fixed_losses[1:])):
        raise AssertionError(f"train: fixed-batch loss did not fall: "
                             f"{fixed_losses}")

    # the f32 lm_head product (TF32 off): 3 GEMMs a micro step
    x32 = torch.randn((micro_batch * seq, c.dim), device=device)
    w32 = torch.randn((c.dim, c.vocab_size), device=device)
    lm_head_ms = time_ms(lambda: torch.matmul(x32, w32), 5, device)
    del x32, w32

    tokens = global_batch * seq
    step_mean = float(np.mean(step_s[1:])) if steps > 1 else step_s[0]
    flops = (6 * _matmul_params(c) * tokens
             + 12 * c.head_dim * _visible_pairs(seq, seq, True)
             * global_batch * c.n_heads * L)
    emit(dict(
        phase="train", config=dict(dim=c.dim, n_layers=L, n_heads=c.n_heads,
                                   n_kv_heads=c.n_kv_heads,
                                   ffn_dim=c.ffn_dim, vocab=c.vocab_size,
                                   remat=c.remat,
                                   remat_policy=c.remat_policy),
        num_params=llama.num_params(c), global_batch=global_batch,
        micro_batch=micro_batch, grad_accum=accum, seq_len=seq,
        steps=steps, losses=losses, grad_norms=norms, step_s=step_s,
        step_s_mean_after_first=step_mean, tokens_per_s=tokens / step_mean,
        model_flops_per_step=flops,
        mfu=flops / step_mean / BF16_FLOP_PER_S, launches=counts,
        peak_memory_gb=peak_gb,
        kernel_vs_dense=versus_dense,
        fixed_batch_losses=fixed_losses, step_profile=profile,
        lm_head_f32_gemm_ms=lm_head_ms,
        lm_head_f32_share_of_step=3 * accum * lm_head_ms / 1e3 / step_mean,
    ))
    return counts


# ---------------------------------------------------------------------------


def _build_report(names=None):
    """Build the named kernels (default: all) and report, per library, what
    ``-Xptxas -v`` says (registers, shared memory, spills) and any compiler
    warning. A ``setmaxnreg`` that ptxas ignored (C7508) fails the run: the
    forward's consumer warpgroups would then run without the registers they
    take."""
    t0 = time.perf_counter()
    libs = _build.build(names)
    info, warnings = {}, {}
    for name, path in libs.items():
        log = path.with_suffix(".so.log")
        lines = log.read_text().splitlines() if log.exists() else []
        info[name] = [ln.replace("ptxas info    : ", "").strip()
                      for ln in lines if "Compiling entry" in ln
                      or "Used" in ln or "spill" in ln]
        warnings[name] = [ln.strip() for ln in lines
                          if "warning" in ln.lower() or "(C75" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": info, "warnings": warnings})
    ignored = [w for ws in warnings.values() for w in ws
               if "C7508" in w or "setmaxnreg ignored" in w]
    if ignored:
        raise AssertionError(f"ptxas ignored setmaxnreg: {ignored}")


def _print_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    config = llama.LlamaConfig()
    decode_shape = (8, config.n_kv_heads, config.n_heads // config.n_kv_heads,
                    config.head_dim, 4096)
    if argv[1:] == ["--decode"]:
        # K4 alone: its checks and times, no result line
        _build_report(["flash_decode"])
        gen = torch.Generator(device=device).manual_seed(SEED)
        emit({"phase": "kernels",
              **decode_kernel_rows(gen, device, decode_shape, 10)})
        _print_card()
        return 0
    _build_report()

    kernels = kernel_phase(device, fwd_shape=(8, 32, 2048, 128),
                           fwd_timed=((8, 32, 1024), (8, 32, 2048),
                                      (4, 32, 2048)),
                           bwd_shape=(4, 32, 2048, 128),
                           decode_shape=decode_shape)
    torch.cuda.empty_cache()

    params = llama.init_params(
        config, torch.Generator(device=device).manual_seed(SEED), device)
    emit({"phase": "params", "num_params": llama.num_params(config),
          "bytes": sum(t.numel() * t.element_size()
                       for t in [*params["layers"].values(),
                                 params["tok_embed"], params["lm_head"],
                                 params["final_norm"]])})
    main_path = []
    main_path.append(generate_phase(
        params, config, device, "a", batch=8, prompt_len=1024, new=64,
        quantize=False, max_len=4096, timed_steps=16))
    torch.cuda.empty_cache()
    main_path.append(generate_phase(
        params, config, device, "b", batch=8, prompt_len=2048, new=32,
        quantize=True, max_len=None, timed_steps=16))
    torch.cuda.empty_cache()
    main_path.append(engine_phase(
        params, config, device, slots=8, cache_len=4096, n_requests=16,
        len_range=(100, 1500), new_range=(16, 48), n_teacher=4))
    del params  # the serving weights make room for the training state
    torch.cuda.empty_cache()
    main_path.append(train_phase(
        dataclasses.replace(config, n_layers=8), device, global_batch=8,
        micro_batch=4, seq=2048, steps=3, lr=3e-4))

    replaces = {
        "flash_fwd": ("dlrover_tpu_torch/ops/csrc/flash_fwd.cu",
                      "dlrover_tpu/ops/flash_attention.py:98"),
        "flash_bwd_dq": ("dlrover_tpu_torch/ops/csrc/flash_bwd.cu",
                         "dlrover_tpu/ops/flash_attention.py:212"),
        "flash_bwd_dkv": ("dlrover_tpu_torch/ops/csrc/flash_bwd.cu",
                          "dlrover_tpu/ops/flash_attention.py:266"),
        "flash_decode_bf16": ("dlrover_tpu_torch/ops/csrc/flash_decode.cu",
                              "dlrover_tpu/ops/flash_attention.py:494"),
        "flash_decode_int8": ("dlrover_tpu_torch/ops/csrc/flash_decode.cu",
                              "dlrover_tpu/ops/flash_attention.py:494"),
    }
    rows = []
    for name, (source, tpu) in replaces.items():
        launches = sum(c[name] for c in main_path)
        if launches == 0:
            raise AssertionError(f"{name} never launched on the main path")
        k = kernels[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=tpu,
            launches=launches, max_abs_err=k["max_abs_err"], ms=k["ms"],
            plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            library=k["library"]))
        if "back_to_back_ms" in k:
            rows[-1]["back_to_back_ms"] = k["back_to_back_ms"]
    emit({"kernels": rows})
    _print_card()
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
