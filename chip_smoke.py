#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --decode   # the decode kernel (K4) alone
    python3 chip_smoke.py --serve    # the serving replica (phase 7) alone
    python3 chip_smoke.py --serve-elastic  # the elastic serving plane (9)
    python3 chip_smoke.py --elastic  # the agent's fault drill (phase 8)
    python3 chip_smoke.py --multi 4  # the elastic loop across 4 cards
    python3 chip_smoke.py --node-drill 4  # its node drill alone

Builds the port's CUDA kernels from ``dlrover_tpu_torch/ops/csrc`` and runs
nine phases, each printing one JSON line (the serving runs one each);
phase 7 runs after phase 3, on the same weights, phase 9 after phase 7
(its replica stopped and the weights freed), phase 8 after phase 6:

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

5. ``ckpt`` — Flash Checkpoint on the train phase's state (bf16 params,
   f32 moments: 16.8 GB at 8 layers), after ``worker.init`` (NCCL, one
   rank) and with the state as DTensors on a mesh of 1. The free bytes of
   ``/dev/shm`` and of the storage directory come first; when the state
   does not fit both, the phase keeps the most layers that do and says
   so. A ``save_to_memory`` is followed at once by a ``train_step``, which
   writes the state in place: the snapshot must hold the values from
   before the step. Then a ``save_to_storage``, a ``load`` from shm and
   one from storage, each bitwise equal to the saved state, leaf by leaf,
   on the card. Prints the save's training pause, the drain, storage and
   restore rates, and the step time with and without a save in flight;
6. ``resume`` — a kill drill across processes with
   ``examples/llama_elastic_pretrain_torch.py``'s ``train`` in child
   processes: ``LlamaConfig()`` widths, 2 layers, global batch 8,
   sequence 2048, memory saves every step, storage every 5. Two unkilled
   runs of 10 steps must agree bitwise; a third SIGKILLs itself once step
   7's memory frame is sealed, and a fourth must resume from shm at step
   7 (not from storage's step 5) and give the unkilled run's losses for
   steps 8-10.
8. ``elastic`` — the port's ``dlrover-run`` (``python -m
   dlrover_tpu_torch.agent.run --standalone --nproc-per-node=1
   --max-restarts=3 --save-at-breakpoint``, its master in the agent
   process; started as ``python -c`` around ``run.main``, which then
   checks the agent's modules) drives the twin at phase 6's sizes on the card, through three
   faults keyed on the agent's restart count: a SIGKILL once step 3's
   frame is sealed (the agent's breakpoint save, then a restore from shm
   at 3); a torn step-6 frame (``DLROVER_FAULT_SCHEDULE=
   "shm.write:torn@step=6"``) and a SIGKILL after it (the saver refuses
   the frame by its CRC, the restore comes from storage at 5 and replays
   6); a wedge after step 8 outside the training span (the master's hang
   rule, with ``hang_downtime_s`` 1.5 × phase 6's longest step-report gap
   + 10 s, queues a wedged ``RESTART_WORKER``; the restore comes from shm
   at 8). Held: the agent exits 0 after 3 restarts, each restore's medium
   and step, storage holding 3, 5 and 8 and never 6, every step's last
   loss equal to phase 6's unkilled loss within the unkilled runs'
   spread, K1-K3 launched in every incarnation, no JAX module in the
   agent or any worker. Prints each fault's detect (fault → the agent
   acts) and restart (fault → the next incarnation's first step) seconds
   and restore, the rendezvous rounds, each incarnation's start-up
   seconds, and ``wall_s`` and ``goodput_pct`` (``compute_goodput`` over
   the run's event files). The agent's saver waits 10 ms at every commit
   (``storage.commit:delay=10ms``, an agent-side fault) and its flight
   recorder, at cooldown 0, writes a chaos bundle at each; held: those
   bundles exist and one worker's ``ckpt.persist_request`` trace is the
   trace of the saver's ``ckpt.persist`` in them (the context rode the
   SAVE event over the agent's queue).
7. ``serve`` — the serving replica behind the port's master servicer and
   router: replica A in this process (``DecodeReplica`` around phase 2's
   weights: int8 cache, 8 slots, 4096 cache slots, buckets 512/1024/2048,
   prefix cache with a 2 GiB budget) and replica B, a subprocess through
   ``python -m dlrover_tpu_torch.serving.replica --config llama`` with
   seed + 1, which warm-starts from A over the fabric. 32 requests from 4
   clients through the router: 8 shared 512-token system prompts, seeded
   suffixes of 16-1024 tokens and 16-48 new tokens, every prompt sent
   twice. Held: no lost or failed request; every step on A one K4 launch a
   layer; A's and B's tokens reproduced by a teacher-forced dense forward
   (TEACHER_AGREE_MIN); one cold prompt gives the same tokens on A and B
   and other tokens on a fresh seed + 1 model; a prefix hit on A or B, and
   A's hits against their cold prefill, and no reuse dropped to a cold
   prefill on A or B; TTFT on a hit against a miss. Then
   ``decode_window`` (bf16 and int8 cache) against K sequential
   ``decode_step``s at full width over 16 rows x 8 windows, on the
   continuation the steps choose and on random tokens: logits within
   LOGITS_REL_TOL, argmax within TEACHER_AGREE_MIN, and no argmax miss
   where the steps' top-2 gap exceeds the largest logit error; and
   speculative decoding (prompt 512, 64 new tokens, k 4) with the target
   as its own draft (acceptance at least 0.9) and with a 2-layer draft of
   another seed, against stock ``decode.generate``. The observability
   spine, after the 32 routed requests: A's ``/metrics`` (its own
   registry: the TTFT count equals A's completed requests, every exemplar
   a trace in this process's ring), ``/events`` (its prefix hits) and
   ``/debug/bundle``, and B's bundle (the reference's eight files each);
   every request one trace of the six ``serve.*`` spans (B's from its
   bundle), queue + prefill + first step within 0.25 s of its TTFT; and
   a span's cost with tracing on and off.
9. ``serve_elastic`` — the elastic serving plane
   (``dlrover_tpu_torch/serving/drill.py``): the port's master with its
   journal, router, ``JobAutoScaler`` + ``ServingOptimizer`` and
   ``LocalReplicaManager``, replicas as subprocesses through
   ``python -m dlrover_tpu_torch.serving.replica --config llama``. (a)
   ``run_serving_drill``: two ``LlamaConfig()`` replicas at full width and
   depth (one seed, int8 cache, 8 slots, cache_len 2048, buckets
   256/512/1024), 48 requests from 8 clients (prompts 64/200/500/1000, 32
   new tokens), the ``serve.replica`` chaos site deciding a SIGKILL once a
   third have completed; the replacement is spawned with another seed, so
   only the survivor's weights give it the survivor's tokens. Held: no request lost or failed, all completed;
   the kill detected, at least one re-route, the fleet restored by the
   autoscaler; the journal's ``fault_injected``, ``serve_replica_lost``
   and one ``serve_scale``; no live replica declared dead; the restored
   replica warm-started from the survivor with the bytes of its blob, and
   a probe prompt giving it the survivor's tokens; on every replica, K4
   launches = 32 × its decode steps (each replica's beat carries both).
   Prints detect and restore seconds, the warm start's seconds and GB/s,
   tokens/s, TTFT p50/p99, serving goodput and re-routes. (b)
   ``run_traffic_drill``: one replica, at most two, under the reference
   drill's bursty ramp (30 rps over 4 s) with full-width prompts (64-1024
   tokens, shared-prefix fraction 0.6, 16-32 new). Held: a grow
   journaled, an SLO burn alert, no request lost, all completed, K4 one
   launch a layer a step. Prints ``slo_lead_s`` and TTFT p99. In both
   drills each live replica's ``/metrics`` is scraped over HTTP (a free
   ``--http-port`` from the manager; a timeout and retries): its decode
   steps and K4 launches equal its last beat's. (a) also holds the
   master's ``node_fault`` bundle of the kill (its manifest names the
   victim, its journal the loss) and prints the replicas' order of
   registration and the peer each warm-started from, on the journal's
   clock (ROADMAP C12).

Then one JSON line with every kernel's numbers, the card's name and power
limit from ``nvidia-smi``, and, last, ``{"ok": true, "device": ...}``.
``--decode`` builds K4 alone and runs only its rows, with no result line:
the quick loop for work on that kernel. ``--serve`` builds the kernels and
runs phase 7 alone, with no result line; ``--serve-elastic`` phase 9
alone. ``--elastic`` runs phase 8
alone, held against its own unkilled run, with no result line.
``--multi N`` runs the twin across N cards of one host (fsdp N, NCCL, each
rank saving its own shards): its losses and grad norms against one card's
(step 1 at the trainer tests' limits, later steps looser), two unkilled
runs against each other, phase 6's drill across the ranks, and the node
drill: a port master in this process and two port agents of N/2 workers,
agent 1's process group SIGKILLed once storage holds step 5, the
survivor at N/2 ranks
with twice the accumulation steps restored from storage, agent 1 back
and the world at N again, the losses against the unkilled run at the
later-step limits; no result line. ``--node-drill N`` runs the node
drill alone, held against its own unkilled run across N cards. Any
mismatch, refused launch or fault exits non-zero. Without CUDA the script
exits non-zero and prints no result.

TF32 is switched off for matmuls and cuDNN, so f32 reference products on
the card are full f32.
"""

import atexit
import dataclasses
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dlrover_tpu_torch import worker
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


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's row carries the script's seconds so far
    (``t_s``), from which the phases' times follow."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _T0)
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


def _teacher_agreement(params, config, device, pairs):
    """The share of generated tokens that a dense forward over prompt +
    generated tokens reproduces (bf16; see TEACHER_AGREE_MIN), over
    ``pairs`` of (prompt, generated tokens)."""
    dense_cfg = dataclasses.replace(config, use_flash_attention=False)
    agree = total = 0
    for prompt, gen in pairs:
        seq = torch.tensor([list(prompt) + list(gen[:-1])], device=device)
        with torch.no_grad():
            logits = llama.forward(params, seq, dense_cfg)[0]
        pred = torch.argmax(logits[len(prompt) - 1:], dim=-1).tolist()
        agree += sum(int(a == b) for a, b in zip(pred, gen))
        total += len(gen)
        del logits
    return agree / total


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

    agreement = _teacher_agreement(
        params, config, device, [(reqs[r][0], done[r])
                                 for r in range(n_teacher)])
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
# phase 7: the serving replica behind a master and a router
# ---------------------------------------------------------------------------

# the card run's prefix-cache budget: one full-width entry holds its
# bucket's rows of all 32 layers, 131 KB a token (67 MB at bucket 512,
# 268 MB at 2048), and the 64 MiB default would drop every one
SERVE_PREFIX_BYTES = 2 << 30
# the six spans of one routed request, router and replica side
SERVE_WATERFALL = ("serve.route", "serve.generate", "serve.queue_wait",
                   "serve.prefill_compute", "serve.first_step",
                   "serve.decode")
# queue + prefill + first step against the TTFT the batcher reports
# (the reference's tolerance)
SEGMENTS_TTFT_ABS_S = 0.25
# the eight files of a replica's flight-recorder bundle
BUNDLE_FILES = ["config.json", "incidents.json", "journal.json",
                "manifest.json", "metrics.prom", "stacks.txt", "traces.json",
                "worst_requests.json"]


def _http_get(addr, path, timeout_s=30.0, attempts=3):
    """GET ``http://addr/path``'s body, retried: a replica busy in Python
    copies answers late."""
    import urllib.request

    for attempt in range(attempts):
        try:
            with urllib.request.urlopen(f"http://{addr}{path}",
                                        timeout=timeout_s) as r:
                return r.read().decode()
        except OSError:
            if attempt + 1 == attempts:
                raise
            time.sleep(1.0 + attempt)


def _exemplar_ids(text, family):
    return {ln.split('trace_id="')[1].split('"')[0]
            for ln in text.splitlines()
            if ln.startswith(family + "_bucket") and "trace_id" in ln}


def _bundle_spans(bundle_path):
    """(trace_id, name, span_id, parent_id, seconds) of every span in a
    bundle's chrome trace."""
    with open(os.path.join(bundle_path, "traces.json")) as f:
        events = json.load(f)["traceEvents"]
    return [(e["args"]["trace_id"], e["name"], e["args"]["span_id"],
             e["args"]["parent_id"], e["dur"] / 1e6)
            for e in events if e.get("ph") == "X" and e.get("cat") == "span"]


def span_cost_us(n=20000):
    """Microseconds a ``with span(...)`` costs on this host, tracing on
    and off (a private tracer; the process's ring is left alone)."""
    from dlrover_tpu_torch.observability import tracing

    out = {}
    for label, on in (("on", True), ("off", False)):
        tr = tracing.Tracer(enabled=on, ring_size=2048)
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("serve.decode", source="bench", request_id="r"):
                pass
        out[label] = (time.perf_counter() - t0) / n * 1e6
    return out


def serve_observability(a, b_http_addr, resps):
    """Phase 7's checks of the observability spine after its 32 routed
    requests: replica A's /metrics (the TTFT count equals A's completed
    requests; every exemplar is a trace in this process's ring),
    /events and /debug/bundle (the reference's eight files); each
    request one trace of the six serve.* spans (replica B's from its own
    bundle), queue + prefill + first step within SEGMENTS_TTFT_ABS_S of
    its TTFT. Returns the row's fields."""
    from dlrover_tpu_torch.observability import tracing

    tracer = tracing.get_tracer()
    local = tracer.finished_spans() + tracer.live_spans()
    ring_ids = {sp.trace_id for sp in local}
    metrics = _http_get(a.http_addr, "/metrics")
    count = [ln for ln in metrics.splitlines()
             if ln.startswith("dlrover_serving_ttft_seconds_count ")]
    ttft_count = int(float(count[0].split()[1])) if count else -1
    exemplars = (_exemplar_ids(metrics, "dlrover_serving_ttft_seconds")
                 | _exemplar_ids(metrics, "dlrover_serving_tpot_seconds"))
    events = json.loads(_http_get(a.http_addr, "/events"))
    kinds = sorted({e["kind"] for e in events["events"]})
    a_bundle = json.loads(_http_get(a.http_addr, "/debug/bundle"))
    b_bundle = json.loads(_http_get(b_http_addr, "/debug/bundle"))
    spans = {}
    for sp in local:
        spans.setdefault(sp.trace_id, []).append(
            (sp.name, sp.span_id, sp.parent_id,
             (sp.end_t or time.monotonic()) - sp.start_t))
    for tid, name, sid, pid, dur in _bundle_spans(b_bundle["path"]):
        spans.setdefault(tid, []).append((name, sid, pid, dur))
    incomplete, worst_gap = [], 0.0
    for r in resps:
        got = spans.get(r.trace_id, [])
        names = sorted(n for n, *_ in got if n.startswith("serve."))
        if names != sorted(SERVE_WATERFALL):
            incomplete.append((r.request_id, r.trace_id, names))
            continue
        seg = sum(d for n, _, _, d in got if n in SERVE_WATERFALL[2:5])
        worst_gap = max(worst_gap, abs(seg - r.ttft_s))
    row = dict(
        traces=len({r.trace_id for r in resps}), requests=len(resps),
        traces_incomplete=incomplete,
        segments_vs_ttft_max_abs_s=worst_gap,
        a_ttft_count=ttft_count, a_completed=a.batcher.completed,
        a_exemplars=len(exemplars),
        a_exemplars_not_in_ring=sorted(exemplars - ring_ids),
        a_journal_kinds=kinds, a_bundle_files=sorted(a_bundle["files"]),
        b_bundle_files=sorted(b_bundle["files"]),
        ring=tracer.counts(), span_cost_us=span_cost_us())
    problems = []
    if row["traces"] != len(resps) or incomplete:
        problems.append(f"{row['traces']} traces for {len(resps)} "
                        f"requests, incomplete {incomplete[:4]}")
    if worst_gap > SEGMENTS_TTFT_ABS_S:
        problems.append(f"segments off TTFT by {worst_gap:.3f} s")
    if ttft_count != a.batcher.completed or not exemplars:
        problems.append(f"A's TTFT count {ttft_count}, completed "
                        f"{a.batcher.completed}, {len(exemplars)} exemplars")
    if row["a_exemplars_not_in_ring"]:
        problems.append("exemplars outside the ring "
                        f"{row['a_exemplars_not_in_ring']}")
    if a.engine.hits and "serve_prefix_hit" not in kinds:
        problems.append(f"A's journal lacks its prefix hits: {kinds}")
    if (row["a_bundle_files"] != BUNDLE_FILES
            or row["b_bundle_files"] != BUNDLE_FILES):
        problems.append(f"bundle files {row['a_bundle_files']} "
                        f"{row['b_bundle_files']}")
    if problems:
        raise AssertionError("serve observability: " + "; ".join(problems))
    return row


def _wait_for(cond, timeout_s, what, proc=None):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the process exited with "
                                 f"{proc.returncode}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout_s} s")
        time.sleep(0.1)


def _serve_traffic(router, reqs, clients):
    """Every request through the router from ``clients`` threads:
    [(response, client-side seconds)] in request order."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        t0 = time.perf_counter()
        resp = router.submit(reqs[i][0], reqs[i][1], request_id=f"q{i}")
        return resp, time.perf_counter() - t0

    with ThreadPoolExecutor(clients) as pool:
        return list(pool.map(one, range(len(reqs))))


def serve_phase(params, config, device, config_flag="llama", slots=8,
                cache_len=4096, buckets=(512, 1024, 2048), max_new_cap=64,
                n_prefixes=8, prefix_len=512, suffix_range=(16, 1024),
                new_range=(16, 48), clients=4, window_prompt=512,
                window_batch=16, window_runs=8, spec_prompt=512,
                spec_new=64, spec_k=4,
                start_timeout_s=600):
    """Replica A (in this process, around ``params``) and replica B (a
    subprocess through the replica's entry point, seed + 1, warm-started
    from A over the fabric) behind the port's master servicer and router;
    then ``decode_window`` and speculative decoding at full width.
    Returns the launch counts of the traffic and speculative runs."""
    from dlrover_tpu_torch.common import comm
    from dlrover_tpu_torch.common.rpc import RPCClient, find_free_port
    from dlrover_tpu_torch.master.servicer import start_master
    from dlrover_tpu_torch.observability.registry import MetricsRegistry
    from dlrover_tpu_torch.serving import replica as rep
    from dlrover_tpu_torch.serving.router import RequestRouter
    from dlrover_tpu_torch.serving.speculative import SpeculativeDecoder
    from dlrover_tpu_torch.serving.traffic import percentile

    L, V = config.n_layers, config.vocab_size
    saved_env = os.environ.get("DLROVER_TPU_SERVE_PREFIX_BYTES")
    os.environ["DLROVER_TPU_SERVE_PREFIX_BYTES"] = str(SERVE_PREFIX_BYTES)
    server, servicer = start_master()
    addr = f"127.0.0.1:{server.port}"
    flags = ["--backend", "torch", "--config", config_flag,
             "--device", str(device), "--slots", str(slots),
             "--cache-len", str(cache_len),
             "--buckets", ",".join(str(b) for b in buckets),
             "--max-new-cap", str(max_new_cap), "--quantize",
             "--prefix-cache", "--hb-interval-s", "0.5"]
    args = rep.parse_args(["--master", addr, "--node-id", "1",
                           "--seed", str(SEED), *flags])
    # A's own registry: its /metrics is A's alone, not the router's too
    a = rep.DecodeReplica(addr, 1, rep._build_engine(args, params),
                          buckets=buckets, max_new_cap=max_new_cap,
                          heartbeat_interval_s=0.5,
                          registry=MetricsRegistry())
    b_http_addr = f"127.0.0.1:{find_free_port('127.0.0.1')}"
    inner = a.engine._engine
    b = None
    row = dict(phase="serve", slots=slots, cache_len=cache_len, cache="int8",
               buckets=list(buckets), prefix_cache_bytes=SERVE_PREFIX_BYTES)
    try:
        a.start()
        if device.type == "cuda" and not inner._flash:
            raise AssertionError("serve: replica A's engine does not take "
                                 "the decode kernel")
        # A's blob, made before B asks for it
        t0 = time.perf_counter()
        blob_bytes = a._provide_weights("current")[1]
        row["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.serving.replica",
             "--master", addr, "--node-id", "2", "--seed", str(SEED + 1),
             "--http-port", b_http_addr.rsplit(":", 1)[1], *flags],
            cwd=REPO)
        live = servicer.serve_registry.live
        _wait_for(lambda: len(live()) == 2, start_timeout_s,
                  "serve: replica B registering", b)
        _wait_for(lambda: "serve_weight_load_bytes" in (
            servicer.last_beat(2) or {}).get("gauges", {}), 60,
            "serve: replica B reporting its warm start", b)
        gauges = servicer.last_beat(2)["gauges"]
        b_addr = next(r["addr"] for r in live() if r["node_id"] == 2)
        row.update(b_start_s=time.perf_counter() - t0,
                   warm_start_bytes=gauges["serve_weight_load_bytes"],
                   warm_start_s=gauges["serve_weight_load_s"],
                   warm_start_gb_per_s=gauges["serve_weight_load_bytes"]
                   / gauges["serve_weight_load_s"] / 1e9)
        if gauges["serve_weight_load_bytes"] != blob_bytes:
            raise AssertionError("serve: replica B loaded "
                                 f"{gauges['serve_weight_load_bytes']} "
                                 f"bytes of A's {blob_bytes}")

        # traffic: shared system prompts, every prompt once, then again
        rng = np.random.default_rng(SEED + 7)
        systems = [rng.integers(1, V, prefix_len).tolist()
                   for _ in range(n_prefixes)]
        prompts = [(systems[i % n_prefixes] + rng.integers(
            1, V, int(rng.integers(suffix_range[0], suffix_range[1] + 1)))
            .tolist(), int(rng.integers(new_range[0], new_range[1] + 1)))
            for i in range(2 * n_prefixes)]
        cold = rng.integers(1, V, prefix_len + suffix_range[1] // 2).tolist()
        router = RequestRouter(live, request_timeout_s=300.0)
        fa.reset_launch_counts()
        steps0 = a.batcher.steps
        _sync(device)
        t0 = time.perf_counter()
        first = _serve_traffic(router, prompts, clients)
        first_s = time.perf_counter() - t0
        # the second pass under the profiler: the share of its wall time
        # in which this process (replica A) kept the card busy (the rate
        # is read from the first pass: the trace's processing after the
        # window is not serving time)
        second = []
        a_profile = device_profile(
            lambda: second.extend(_serve_traffic(router, prompts, clients)),
            1, device, match="flash_decode")
        # the spine after the 32 routed requests: scrapes, traces, bundles
        row["observability"] = serve_observability(
            a, b_http_addr, [r for r, _ in first + second])
        # TTFT on a prefix hit against a miss, one request at a time on A:
        # a new suffix after a resident system prompt, or after a new one
        probe = {"hit": [], "miss": []}
        to_a = RPCClient(a.addr, timeout_s=300.0, retries=1)
        for i in range(4):
            for system in (systems[i], rng.integers(1, V, prefix_len)
                           .tolist()):
                hits0 = a.engine.hits
                resp = to_a.call("serve_generate", comm.ServeGenerateRequest(
                    request_id=f"ttft-{len(probe['hit'] + probe['miss'])}",
                    prompt=system + rng.integers(
                        1, V, suffix_range[1] // 2).tolist(),
                    max_new_tokens=2))
                if not resp.success:
                    raise AssertionError(f"serve: {resp.message}")
                probe["hit" if a.engine.hits > hits0 else "miss"].append(
                    resp.ttft_s)
        # one cold prompt to each replica: the same tokens show that B
        # serves A's weights
        direct = [RPCClient(x, timeout_s=300.0, retries=1).call(
            "serve_generate", comm.ServeGenerateRequest(
                request_id=f"cold-{x}", prompt=cold, max_new_tokens=32))
            for x in (a.addr, b_addr)]
        _sync(device)
        traffic_counts = _launches()
        steps = a.batcher.steps - steps0
        want = dict.fromkeys(fa.LAUNCHES, 0)
        want["flash_decode_int8"] = L * steps if inner._flash else 0
        if traffic_counts != want:
            raise AssertionError(f"serve: launches {traffic_counts}, "
                                 f"expected {want} ({steps} steps on A)")
        resps = [r for r, _ in first + second]
        failed = [r.message for r in resps + direct if not r.success]
        if failed or router.lost or a.batcher.failed:
            raise AssertionError(f"serve: failed {failed}, lost "
                                 f"{router.lost}, A's prefill failures "
                                 f"{a.batcher.failed}")
        if direct[0].tokens != direct[1].tokens:
            raise AssertionError("serve: A and B gave different tokens for "
                                 "one cold prompt after the warm start")
        a_stats = a.engine.stats()
        # B's gauges from a beat taken after the traffic ended
        t_done = time.monotonic()
        _wait_for(lambda: servicer.last_beat(2)["t"] > t_done, 30,
                  "serve: replica B's heartbeat after the traffic", b)
        b_gauges = servicer.last_beat(2)["gauges"]
        if a_stats["hits"] == 0 and b_gauges["serve_prefix_tokens_saved"] == 0:
            raise AssertionError("serve: no prefix-cache hit on A or B")
        # a reuse that raised would have fallen back to a cold prefill
        if a_stats["dropped"] or b_gauges["serve_prefix_dropped"]:
            raise AssertionError(
                f"serve: prefix reuses dropped: A {a_stats['dropped']}, "
                f"B {b_gauges['serve_prefix_dropped']}")
        agreement = _teacher_agreement(
            params, config, device,
            [(p, r.tokens) for (p, _), r in zip(prompts * 2, resps)])
        ttft = [r.ttft_s for r in resps]
        first_tokens = sum(len(r.tokens) for r, _ in first)
        second_tokens = sum(len(r.tokens) for r, _ in second)
        row.update(
            requests=len(resps), lost=router.lost, rerouted=router.rerouted,
            served_by_a=sum(r.replica_id == 1 for r in resps),
            first_pass_s=first_s, first_pass_new_tokens=first_tokens,
            tok_per_s=first_tokens / first_s,
            second_pass_tok_per_s_profiled=(
                second_tokens / a_profile["wall_ms"] * 1e3),
            a_steps=steps,
            a_tok_per_step=(sum(len(r.tokens) - 1 for r in resps
                                if r.replica_id == 1) / max(1, steps)),
            ttft_p50_s=percentile(ttft, 50), ttft_p99_s=percentile(ttft, 99),
            ttft_p50_first_pass_s=percentile([r.ttft_s for r, _ in first],
                                             50),
            ttft_p50_second_pass_s=percentile([r.ttft_s for r, _ in second],
                                              50),
            client_latency_p50_s=percentile([s for _, s in first + second],
                                            50),
            ttft_hit_s=probe["hit"], ttft_miss_s=probe["miss"],
            a_second_pass_profile=a_profile,
            launches=traffic_counts, a_prefix=a_stats,
            b_prefix_hit_rate=b_gauges["serve_prefix_hit_rate"],
            b_prefix_tokens_saved=b_gauges["serve_prefix_tokens_saved"],
            b_prefix_dropped=b_gauges["serve_prefix_dropped"],
            teacher_forced_agreement=agreement,
        )
        if agreement < TEACHER_AGREE_MIN:
            raise AssertionError(f"serve: teacher-forced agreement "
                                 f"{agreement:.3f} < {TEACHER_AGREE_MIN}")
        # B's tokens differ from a fresh seed + 1 model's: the weights it
        # serves came from A
        drained = RPCClient(b_addr, timeout_s=300.0, retries=1).call(
            "serve_drain", comm.ServeDrainRequest(reason="chip_smoke"))
        row["b_exit"] = b.wait(timeout=120)
        if not drained.success or row["b_exit"] != 0:
            raise AssertionError(f"serve: B drained {drained.success}, "
                                 f"exited {row['b_exit']}")
        fresh = llama.init_params(
            config, torch.Generator(device=device).manual_seed(SEED + 1),
            device)
        fresh_toks = decode.generate(
            fresh, torch.tensor([cold], device=device), config, None, 32,
            temperature=0.0)[0, len(cold):].tolist()
        del fresh
        if fresh_toks == direct[1].tokens:
            raise AssertionError("serve: B's tokens are a fresh seed + 1 "
                                 "model's: its warm start did not land")

        # prefix hits on A against their cold prefill, and their time
        hit_first = hit_rows = n_hits = 0
        hit_s = cold_s = 0.0
        rows_computed = []
        for prompt, _ in prompts:
            bucket = a.batcher.bucket_for(len(prompt))
            hits0, saved0 = a.engine.hits, a.engine.tokens_saved
            _sync(device)
            t0 = time.perf_counter()
            hit = a.engine.prefill_rows(prompt, bucket)
            _sync(device)
            t1 = time.perf_counter()
            ref = inner.prefill_rows(prompt, bucket)
            _sync(device)
            if a.engine.hits == hits0:
                continue
            n_hits += 1
            rows_computed.append(
                [bucket - (a.engine.tokens_saved - saved0), bucket])
            if n_hits == 1:
                # where a hit's and a cold prefill's time goes
                row["prefill_profile_hit"] = device_profile(
                    lambda: a.engine.prefill_rows(prompt, bucket), 1,
                    device)
                row["prefill_profile_cold"] = device_profile(
                    lambda: inner.prefill_rows(prompt, bucket), 1, device)
            hit_s += t1 - t0
            cold_s += time.perf_counter() - t1
            hit_first += hit.first_token == ref.first_token
            n = len(prompt)
            hit_rows = max(hit_rows, max(
                _rel_err(h[:, :, :n].float(), c[:, :, :n].float())
                for h, c in zip(hit.payload, ref.payload)))
            del hit, ref
        row.update(prefix_checks=n_hits,
                   prefix_rows_computed_of_bucket=rows_computed,
                   prefix_first_token_agreement=hit_first / max(1, n_hits),
                   prefix_rows_rel_err=hit_rows,
                   prefill_s_hit=hit_s / max(1, n_hits),
                   prefill_s_cold=cold_s / max(1, n_hits))
        if (not n_hits or hit_first / n_hits < TEACHER_AGREE_MIN
                or hit_rows > LOGITS_REL_TOL or a.engine.dropped):
            raise AssertionError(
                f"serve: {n_hits} prefix hits, first tokens as cold in "
                f"{hit_first}, rows rel err {hit_rows:.3g}, "
                f"{a.engine.dropped} reuses dropped on A")
    finally:
        if b is not None and b.poll() is None:
            b.kill()
            b.wait(timeout=60)
        a.stop()
        server.stop()
        if saved_env is None:
            os.environ.pop("DLROVER_TPU_SERVE_PREFIX_BYTES", None)
        else:
            os.environ["DLROVER_TPU_SERVE_PREFIX_BYTES"] = saved_env
    del a, inner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    emit(row)
    row = dict(phase="serve_decode")

    # decode_window against K sequential decode steps, both caches, over
    # `window_runs` windows a row: on the continuation the steps choose
    # themselves (a self-draft's window) and on random window tokens.
    # Rounding flips near-ties, so besides the agreement a miss is held
    # to none where the steps' top-2 gap exceeds the largest logit error
    # this comparison measured.
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    prompt = torch.randint(0, V, (window_batch, window_prompt),
                           generator=gen, device=device)
    n_toks = window_runs * (spec_k + 1)
    rand_toks = torch.randint(0, V, (window_batch, n_toks), generator=gen,
                              device=device)
    T = window_prompt + n_toks
    for quantize, greedy in ((False, True), (True, True), (False, False),
                             (True, False)):
        logits, cache_s = decode.prefill(params, prompt, config, T, quantize)
        toks, seq = [], []
        for i in range(n_toks):
            tok = logits.argmax(-1) if greedy else rand_toks[:, i]
            toks.append(tok)
            logits, cache_s = decode.decode_step(params, tok, cache_s,
                                                 config)
            seq.append(logits)
        del cache_s
        seq = torch.stack(seq, dim=1)
        toks = torch.stack(toks, dim=1)
        _, cache_w = decode.prefill(params, prompt, config, T, quantize)
        win = []
        for w in range(0, n_toks, spec_k + 1):
            out, cache_w = decode.decode_window(
                params, toks[:, w:w + spec_k + 1], cache_w, config)
            win.append(out)
        del cache_w
        win = torch.cat(win, dim=1)
        finite = bool(torch.isfinite(win).all())
        err = _rel_err(win, seq)
        max_err = float((win - seq).abs().max())
        top2 = seq.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        miss = win.argmax(-1) != seq.argmax(-1)
        n_pos = miss.numel()
        beyond = int((miss & (gap > max_err)).sum())
        name = ("window_" + ("int8" if quantize else "bf16")
                + ("" if greedy else "_random_tokens"))
        row[name] = dict(
            logits_rel_err=err, max_abs_logit_err=max_err, positions=n_pos,
            positions_gap_over_err=int((gap > max_err).sum()),
            argmax_agreement=1.0 - float(miss.float().mean()),
            misses=int(miss.sum()), misses_beyond_err=beyond,
            agreement_beyond_err=1.0 - beyond / n_pos)
        del seq, win
        if (not finite or err > LOGITS_REL_TOL or beyond
                or row[name]["argmax_agreement"] < TEACHER_AGREE_MIN):
            raise AssertionError(f"serve: {name} vs steps {row[name]}")

    # speculative decoding: the target as its own draft, and a 2-layer
    # draft of the same width from another seed
    prompt = torch.randint(0, V, (1, spec_prompt), generator=gen,
                           device=device)
    plist = prompt[0].tolist()
    _sync(device)
    t0 = time.perf_counter()
    stock = decode.generate(params, prompt, config, None, spec_new,
                            temperature=0.0)[0, spec_prompt:].tolist()
    _sync(device)
    stock_s = time.perf_counter() - t0
    dcfg = dataclasses.replace(config, n_layers=2)
    draft = llama.init_params(
        dcfg, torch.Generator(device=device).manual_seed(SEED + 2), device)
    fa.reset_launch_counts()
    runs = {}
    for name, dp, dc in (("self_draft", params, config),
                         ("2_layer_draft", draft, dcfg)):
        spec = SpeculativeDecoder(params, config, dp, dc, k=spec_k)
        _sync(device)
        t0 = time.perf_counter()
        toks_s, stats = spec.generate(plist, spec_new)
        _sync(device)
        seconds = time.perf_counter() - t0
        runs[name] = dict(stats, seconds=seconds,
                          tok_per_s=spec_new / seconds, tokens=toks_s)
    spec_counts = _launches()
    del draft
    want = dict.fromkeys(fa.LAUNCHES, 0)
    if device.type == "cuda" and spec_prompt >= 256:
        want["flash_fwd"] = 3 * L + dcfg.n_layers  # the four prefills
    if spec_counts != want:
        raise AssertionError(f"serve: speculative launches {spec_counts}, "
                             f"expected {want}")
    for name, r in runs.items():
        r["teacher_forced_agreement"] = _teacher_agreement(
            params, config, device, [(plist, r.pop("tokens"))])
    row["speculative"] = dict(
        runs, prompt=spec_prompt, new_tokens=spec_new, k=spec_k,
        stock_generate_s=stock_s, stock_tok_per_s=spec_new / stock_s,
        stock_teacher_forced_agreement=_teacher_agreement(
            params, config, device, [(plist, stock)]),
        launches=spec_counts)
    emit(row)
    if (min(r["teacher_forced_agreement"] for r in runs.values())
            < TEACHER_AGREE_MIN
            or runs["self_draft"]["acceptance_rate"] < 0.9):
        raise AssertionError(
            "serve: speculative teacher-forced agreement "
            f"{[r['teacher_forced_agreement'] for r in runs.values()]}, "
            f"self-draft acceptance {runs['self_draft']['acceptance_rate']}")
    return {k: traffic_counts[k] + spec_counts[k] for k in traffic_counts}


# ---------------------------------------------------------------------------
# phase 9: the elastic serving plane (kill, re-route, restore; burst, grow)
# ---------------------------------------------------------------------------

def _decode_launches(gauges, n_layers):
    """Each replica's decode steps and K4 launches from its last beat, and
    the replicas whose launches are not one a layer a step."""
    rows, bad = {}, []
    for nid, g in gauges.items():
        steps = int(g.get("serve_decode_steps", 0))
        launches = int(g.get("serve_decode_kernel_launches", 0))
        rows[nid] = {"steps": steps, "launches": launches}
        if launches != n_layers * steps:
            bad.append(nid)
    return rows, bad


def _scrape_problems(scrapes, n_layers):
    """Replicas whose /metrics did not answer, or whose decode steps and
    K4 launches read there differ from their beat's."""
    if not scrapes:
        return ["no replica scraped"]
    out = []
    for nid, r in scrapes.items():
        if (r["error"] is not None or r["steps"] != r["beat_steps"]
                or r["launches"] != r["beat_launches"]
                or r["launches"] != n_layers * r["steps"]):
            out.append(f"replica {nid} scraped {r}")
    return out


def _bundle_digest(bundle):
    if bundle is None:
        return None
    manifest = bundle["manifest"]
    return dict(path=os.path.basename(bundle["path"]),
                node_id=manifest.get("node_id"), role=manifest.get("role"),
                files=sorted(manifest.get("files", [])),
                spans=manifest.get("spans_finished"),
                journal_events=manifest.get("journal_events"),
                victim_lost=bundle["victim_lost"],
                incidents=bundle["incidents"])


def serve_elastic_phase(config, device, config_flag="llama"):
    """(a) the kill drill: two ``LlamaConfig()`` replicas as subprocesses
    (same seed, int8 cache, 8 slots, cache_len 2048, buckets
    256/512/1024), 48 requests from 8 clients (prompts 64/200/500/1000,
    32 new tokens), the ``serve.replica`` site deciding a SIGKILL once a
    third have completed, the replacement spawned with another seed; (b) the burst drill: 1 replica, at most 2, under
    the reference's bursty ramp scaled to full-width prompts. Returns the
    K4 launches the replicas counted. ``config_flag`` is the replicas'
    ``--config`` (``tiny`` with a tiny ``config`` rehearses it on the
    CPU)."""
    from dlrover_tpu_torch.serving.drill import (
        GRACE_S,
        HEARTBEAT_S,
        LLAMA_DRILL,
        LLAMA_KILL_TRAFFIC,
        run_serving_drill,
        run_traffic_drill,
    )
    from dlrover_tpu_torch.serving.traffic import TrafficProfile

    common = dict(LLAMA_DRILL, config=config_flag, device=str(device),
                  seed=SEED)
    t0 = time.perf_counter()
    res = run_serving_drill(replicas=2, **LLAMA_KILL_TRAFFIC, **common)
    seconds = time.perf_counter() - t0
    journal = res["journal"]
    warm = res["warm_start"] or {}
    probe = res["probe_tokens"]
    restored, victim = res["restored_node"], res["killed_node"]
    survivor = next((n for n in probe if n != restored), None)
    row = dict(
        phase="serve_elastic_kill", seconds=seconds, requests=res["requests"],
        completed=res["completed"], lost=res["lost"],
        failed_responses=res["failed_responses"], rerouted=res["rerouted"],
        killed_node=victim, restored_node=restored,
        kill_detected=res["kill_detected"],
        replicas_restored=res["replicas_restored"],
        detect_s=res["detect_s"], restore_s=res["restore_s"],
        restore_timeout_s=LLAMA_KILL_TRAFFIC["restore_timeout_s"],
        heartbeat_s=HEARTBEAT_S, grace_s=GRACE_S,
        false_deaths=res["false_deaths"],
        warm_start_s=warm.get("seconds"), warm_start_bytes=warm.get("bytes"),
        warm_start_gb_per_s=(warm["bytes"] / warm["seconds"] / 1e9
                             if warm.get("seconds") else None),
        blob_bytes=res["blob_bytes"], tokens_per_s=res["tokens_per_s"],
        traffic_s=res["elapsed_s"], ttft_p50_s=res["ttft_p50_s"],
        ttft_p99_s=res["ttft_p99_s"],
        serving_goodput=res["serving_goodput"], journal=journal,
        probe_agrees=(survivor is not None and probe[survivor] is not None
                      and probe[survivor] == probe.get(restored)),
        # C12: the replicas' registrations and warm starts on the
        # journal's clock (the goodput window opens at the first)
        start_order=res["start_order"],
        replica_scrapes=res["replica_scrapes"],
        node_fault_bundle=_bundle_digest(res["node_fault_bundle"]))
    kill_rows, bad = _decode_launches(res["replica_gauges"],
                                      config.n_layers)
    row["replicas"] = kill_rows
    emit(row)
    problems = []
    if bad:
        problems.append(f"K4 launches not {config.n_layers} a step on "
                        f"replicas {bad}")
    if (res["lost"] or res["failed_responses"]
            or res["completed"] != res["requests"]):
        problems.append("requests lost, failed or not completed")
    if not (res["kill_detected"] and res["replicas_restored"]
            and res["rerouted"] >= 1):
        problems.append("the kill was not detected, re-routed and restored")
    if (journal.get("fault_injected", 0) < 1
            or journal.get("serve_replica_lost", 0) < 1
            or journal.get("serve_scale", 0) != 1):
        problems.append(f"journal {journal}")
    if res["false_deaths"]:
        problems.append(f"live replicas declared dead: {res['false_deaths']}")
    if not warm or warm["bytes"] != res["blob_bytes"]:
        problems.append(f"warm start {warm} against the survivor's blob of "
                        f"{res['blob_bytes']} bytes")
    if not row["probe_agrees"]:
        problems.append(f"probe tokens {probe}")
    problems += _scrape_problems(res["replica_scrapes"], config.n_layers)
    bundle = res["node_fault_bundle"]
    if (bundle is None or bundle["manifest"].get("node_id") != victim
            or not bundle["victim_lost"]):
        problems.append("the master's node_fault bundle "
                        f"{row['node_fault_bundle']}")
    decoded = [n for n, r in kill_rows.items() if r["steps"]]
    if restored not in decoded or survivor not in decoded:
        problems.append(f"survivor or restored replica never decoded "
                        f"{row['replicas']}")
    if problems:
        raise AssertionError("serve_elastic (a): " + "; ".join(problems))

    profile = TrafficProfile(
        rps=30.0, duration_s=4.0, arrival="bursty", burst_factor=4.0,
        diurnal="ramp", length_mix=((0.7, 64, 512), (0.3, 512, 1024)),
        shared_prefix_frac=0.6, prefix_len=48, max_new_lo=16, max_new_hi=32,
        vocab=config.vocab_size, seed=SEED)
    t0 = time.perf_counter()
    res = run_traffic_drill(replicas=1, max_replicas=2, profile=profile,
                            request_timeout_s=600.0, **common)
    row = dict(phase="serve_elastic_burst", seconds=time.perf_counter() - t0,
               **{k: res[k] for k in (
                   "offered", "completed", "failed", "offered_rps",
                   "ttft_p50_s", "ttft_p99_s", "tokens_per_s", "lost",
                   "grow_events", "slo_alerts", "first_alert_t",
                   "first_grow_t", "slo_lead_s", "live_replicas_end",
                   "journal")})
    burst_rows, burst_bad = _decode_launches(res["replica_gauges"],
                                             config.n_layers)
    row["replicas"] = burst_rows
    row["replica_scrapes"] = res["replica_scrapes"]
    emit(row)
    scrape_bad = _scrape_problems(res["replica_scrapes"], config.n_layers)
    if scrape_bad:
        raise AssertionError(f"serve_elastic (b): {scrape_bad}")
    if (res["grow_events"] < 1 or res["lost"] or res["slo_alerts"] < 1
            or res["completed"] != res["offered"] or burst_bad):
        raise AssertionError(
            f"serve_elastic (b): {res['grow_events']} grows, {res['lost']} "
            f"lost, {res['slo_alerts']} SLO alerts, {res['completed']} of "
            f"{res['offered']} completed, K4 launches not "
            f"{config.n_layers} a step on replicas {burst_bad}")
    counts = dict.fromkeys(fa.LAUNCHES, 0)
    counts["flash_decode_int8"] = sum(
        r["launches"] for rows in (kill_rows, burst_rows)
        for r in rows.values())
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
    batch_shape = (accum, trainer.micro_batch_global, seq + 1)
    return counts, dict(config=c, state=state, trainer=trainer,
                        batch_shape=batch_shape, step_s=step_mean)


# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _state_tensors(state):
    from dlrover_tpu_torch.convert import named_leaves

    return [(name, _local(x)) for name, x in named_leaves(state)
            if isinstance(x, torch.Tensor)]


def _state_bytes(state):
    return sum(t.numel() * t.element_size() for _, t in _state_tensors(state))


def _unequal_leaves(state, saved):
    return [name for (name, t), s in zip(_state_tensors(state), saved)
            if not torch.equal(t, s)]


def _first_layers(state, n_layers):
    """The state cut to its first ``n_layers`` layers (copies)."""
    def cut(tree, path=()):
        if isinstance(tree, dict):
            return {k: cut(v, path + (k,)) for k, v in tree.items()}
        return tree[:n_layers].clone() if "layers" in path else tree
    return cut(state)


def ckpt_phase(trained, device, ckpt_root):
    """Flash Checkpoint on the train phase's state (see the module
    docstring, phase 5). Returns the launches of its two train steps."""
    from dlrover_tpu_torch.ckpt.engine import CheckpointEngine
    from dlrover_tpu_torch.parallel.mesh import build_mesh
    from dlrover_tpu_torch.parallel.sharding import shard_tree

    ctx = worker.init(device=device.type)  # NCCL (gloo on the CPU), 1 rank
    c, trainer = trained["config"], trained["trainer"]
    rng = np.random.default_rng(SEED + 5)
    batches = [rng.integers(0, c.vocab_size, trained["batch_shape"],
                            dtype=np.int32) for _ in range(2)]
    state = trained["state"]
    shm_free = shutil.disk_usage("/dev/shm").free
    disk_free = shutil.disk_usage(ckpt_root).free
    full_bytes = _state_bytes(state)
    per_layer = sum(t.numel() * t.element_size()
                    for name, t in _state_tensors(state)
                    if "['layers']" in name) // c.n_layers
    fixed = full_bytes - per_layer * c.n_layers
    room = min(shm_free, disk_free) * 0.9
    layers = c.n_layers
    while layers > 1 and fixed + per_layer * layers > room:
        layers -= 1
    if layers != c.n_layers:
        state = _first_layers(state, layers)
        c = dataclasses.replace(c, n_layers=layers)
        trainer._loss_fn = lambda p, t, c=c: llama.next_token_loss(p, t, c)
        torch.cuda.empty_cache()
    emit({"phase": "ckpt_space", "dev_shm_free_bytes": shm_free,
          "storage_free_bytes": disk_free, "storage_dir": ckpt_root,
          "state_bytes_8_layers": full_bytes, "layers": layers,
          "cut": layers != trained["config"].n_layers})
    # the state as DTensors on a mesh of 1 (same storage, no copy)
    mesh = build_mesh(plan_mesh(1), device.type)
    axes = llama.param_logical_axes(c)
    state = {**state,
             "params": shard_tree(mesh, state["params"], axes),
             "opt_state": {**state["opt_state"],
                           "mu": shard_tree(mesh, state["opt_state"]["mu"],
                                            axes),
                           "nu": shard_tree(mesh, state["opt_state"]["nu"],
                                            axes)}}
    nbytes = _state_bytes(state)
    engine = CheckpointEngine(
        os.path.join(ckpt_root, "ckpt"), job_name=f"chipsmoke{os.getpid()}",
        node_rank=0, local_rank=0, rank=0, world_size=1,
        local_world_size=1, ipc_socket="/nonexistent")
    try:
        return _ckpt_checks(engine, state, trainer, batches, device,
                            nbytes, trained["step_s"], ctx)
    finally:
        engine._shm.unlink()


def _ckpt_checks(engine, state, trainer, batches, device, nbytes,
                 step_s_train, ctx):
    gb = nbytes / 1e9
    # warm: the first save creates and populates the shm segment
    _sync(device)
    t0 = time.perf_counter()
    if not engine.save_to_memory(0, state) or not engine.wait_drained():
        raise AssertionError("ckpt: warm-up save failed")
    cold = dict(engine.last_save, wall_s=time.perf_counter() - t0)
    saved = [t.clone() for _, t in _state_tensors(state)]
    step0 = int(state["step"])
    _sync(device)

    fa.reset_launch_counts()
    # a memory save, then at once a step that writes the state in place
    t0 = time.perf_counter()
    if not engine.save_to_memory(step0, state):
        raise AssertionError("ckpt: save_to_memory skipped")
    pause_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, res = trainer.train_step(state, batches[0])
    loss_in_flight = float(res.loss)
    step_with_save_s = time.perf_counter() - t0
    if not engine.wait_drained():
        raise AssertionError("ckpt: drain failed")
    drain = dict(engine.last_save)
    moved = _unequal_leaves(state, saved)
    if "['params']['lm_head']" not in moved:
        raise AssertionError(f"ckpt: the step left lm_head as it was "
                             f"({moved})")
    # restore from shm over the stepped state: the pre-step values
    state, step = engine.load(state)
    shm_restore = dict(engine.last_restore)
    bad = _unequal_leaves(state, saved)
    if step != step0 or shm_restore["medium"] != "shm" or bad:
        raise AssertionError(f"ckpt: shm restore step {step} "
                             f"{shm_restore}, leaves differ: {bad}")
    if not engine.save_to_storage(step0, state):
        raise AssertionError("ckpt: save_to_storage skipped")
    storage = dict(engine.last_save)
    # a step with no save in flight, then restore from storage over it
    _sync(device)
    t0 = time.perf_counter()
    state, res = trainer.train_step(state, batches[1])
    float(res.loss)
    step_without_save_s = time.perf_counter() - t0
    counts = _launches()
    engine._shm.unlink()
    state, step = engine.load(state)
    storage_restore = dict(engine.last_restore)
    bad = _unequal_leaves(state, saved)
    if step != step0 or storage_restore["medium"] != "storage" or bad:
        raise AssertionError(f"ckpt: storage restore step {step} "
                             f"{storage_restore}, leaves differ: {bad}")
    persist_s = storage["storage_s"] - storage["drain_s"]
    emit(dict(
        phase="ckpt", state_bytes=nbytes, leaves=len(saved),
        world_size=ctx.world_size, launches=counts,
        save_pause_ms=pause_s * 1e3,
        drain_s=drain["drain_s"], drain_gb_per_s=gb / drain["drain_s"],
        cold_drain_s=cold["drain_s"],
        cold_drain_gb_per_s=gb / cold["drain_s"],
        storage_persist_s=persist_s, storage_gb_per_s=gb / persist_s,
        storage_save_s=storage["storage_s"],
        restore_shm_s=shm_restore["seconds"],
        restore_shm_gb_per_s=gb / shm_restore["seconds"],
        restore_storage_s=storage_restore["seconds"],
        restore_storage_gb_per_s=gb / storage_restore["seconds"],
        step_s_with_save_in_flight=step_with_save_s,
        step_s_without_save=step_without_save_s,
        step_s_train_phase=step_s_train,
        loss_with_save_in_flight=loss_in_flight,
        snapshot_holds_pre_step_values=True, restores_bitwise=True,
    ))
    del saved
    return counts


def resume_child(args) -> int:
    """One run of the twin's ``train`` (a child of :func:`resume_phase`)."""
    spec = importlib.util.spec_from_file_location(
        "llama_elastic_pretrain_torch",
        os.path.join(REPO, "examples", "llama_elastic_pretrain_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    device = torch.device(args["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = llama.LlamaConfig(**{
        k: (getattr(torch, v) if k == "dtype" else v)
        for k, v in args["config"].items()})
    ctx = worker.init(device=device.type)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    step_s = {}

    def on_step(step, loss):
        step_s[step] = time.perf_counter() - t0

    out = twin.train(config, args["steps"], args["global_batch"],
                     args["seq"], args["ckpt_dir"], ctx,
                     ckpt_every=args["storage_every"],
                     kill_at_step=args.get("kill_at"), on_step=on_step)
    engine = out["checkpointer"].engine
    print("RESUME " + json.dumps(dict(
        start_step=out["start_step"], restored_from=out["restored_from"],
        restore=engine.last_restore, losses=out["losses"],
        grad_norms=out["grad_norms"], step_s=step_s,
        launches=_launches(), seconds=time.perf_counter() - t0,
        last_save=engine.last_save)), flush=True)
    worker.shutdown()
    return 0


# phase 8: the faults of the drill, keyed on the incarnation (the agent's
# restart count), never on the step alone: the first incarnation is killed
# once step 3's memory frame is sealed; the second tears its step-6 frame
# (the injector) and is killed after it, waiting at its storage step until
# storage holds that step (so the step-6 frame is not skipped as busy);
# the third wedges after step 8, outside the training span
ELASTIC_PLAN = {0: ("kill", 3), 1: ("kill", 6), 2: ("hang", 8)}
ELASTIC_TORN_SCHEDULE = "shm.write:torn@step=6"
# an agent-side fault: every commit of the agent's saver waits 10 ms, and
# the agent's flight recorder (cooldown 0) captures a chaos bundle at each
ELASTIC_AGENT_FAULT = "storage.commit:delay=10ms"


def elastic_child(args) -> int:
    """One incarnation of the twin under the port's agent (phase 8): its
    steps, losses and launches as ``STEP`` lines, its restore as a
    ``START`` line, its fault as the twin's kill line or a ``WEDGE``
    line."""
    from dlrover_tpu_torch.ckpt.ckpt_saver import latest_step
    from dlrover_tpu_torch.common.constants import EnvKey, env_int

    restart = env_int(EnvKey.RESTART_COUNT, 0)
    if restart != 1:
        # the torn frame is the second incarnation's fault alone
        os.environ.pop("DLROVER_FAULT_SCHEDULE", None)
    spec = importlib.util.spec_from_file_location(
        "llama_elastic_pretrain_torch",
        os.path.join(REPO, "examples", "llama_elastic_pretrain_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    device = torch.device(args["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = llama.LlamaConfig(**{
        k: (getattr(torch, v) if k == "dtype" else v)
        for k, v in args["config"].items()})
    ctx = worker.init(device=device.type)
    fa.reset_launch_counts()
    kind, at = ELASTIC_PLAN.get(restart, (None, None))

    def emit_line(tag, **data):
        print(f"{tag} " + json.dumps(dict(restart=restart, t=time.time(),
                                          **data)), flush=True)

    engine = []
    from dlrover_tpu_torch.observability import tracing

    traced = set()

    def ckpt_traces():
        """The persist requests this incarnation traced since the last
        call: [step, trace_id] each."""
        out = []
        for sp in tracing.get_tracer().finished_spans():
            if (sp.name == "ckpt.persist_request"
                    and sp.span_id not in traced):
                traced.add(sp.span_id)
                out.append([sp.attrs.get("step"), sp.trace_id])
        return out

    def on_start(start_step, ckpt, trainer):
        engine.append(ckpt.engine)
        emit_line("START", start_step=start_step,
                  restore=ckpt.engine.last_restore,
                  grad_accum=trainer.grad_accum_steps)
        # the model is built and restored: everything is imported by now
        emit_line("MODULES", forbidden=sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu")))

    def on_step(step, loss):
        emit_line("STEP", step=step, loss=float(loss),
                  launches=_launches(), ckpt_traces=ckpt_traces())
        if kind == "hang" and step + 1 == at:
            # the hang restores the wedged step's frame: the drill waits
            # out this drain so that step's save is not skipped as busy
            engine[0].wait_drained()
        if (kind == "kill" and at > step
                and step % args["storage_every"] == 0):
            deadline = time.monotonic() + 300
            while (latest_step(args["ckpt_dir"]) < step
                   and time.monotonic() < deadline):
                time.sleep(0.05)

    steps = at if kind == "hang" else args["steps"]
    twin.train(config, steps, args["global_batch"], args["seq"],
               args["ckpt_dir"], ctx, ckpt_every=args["storage_every"],
               kill_at_step=at if kind == "kill" else None,
               on_step=on_step, on_start=on_start)
    if kind == "hang":
        emit_line("WEDGE", step=at)
        time.sleep(3600)  # until the hang rule's restart kills this worker
    worker.shutdown()
    return 0


def node_child(args) -> int:
    """One worker of the node drill (``--multi``): the twin at a fixed
    micro batch of 1 a replica, so a smaller world takes more
    accumulation steps; its restore as a ``START`` line and, on rank 0 of
    the world, its steps as ``STEP`` lines."""
    from dlrover_tpu_torch.common.constants import EnvKey, env_int

    spec = importlib.util.spec_from_file_location(
        "llama_elastic_pretrain_torch",
        os.path.join(REPO, "examples", "llama_elastic_pretrain_torch.py"))
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    device = torch.device(args["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = llama.LlamaConfig(**{
        k: (getattr(torch, v) if k == "dtype" else v)
        for k, v in args["config"].items()})
    ctx = worker.init(device=device.type)
    fa.reset_launch_counts()
    restart = env_int(EnvKey.RESTART_COUNT, 0)
    node = env_int(EnvKey.NODE_RANK, 0)

    def emit_line(tag, **data):
        print(f"{tag} " + json.dumps(dict(
            node=node, restart=restart, rank=ctx.rank,
            world=ctx.world_size, t=time.time(), **data)), flush=True)

    def on_start(start_step, ckpt, trainer):
        if ctx.rank == 0:
            emit_line("START", start_step=start_step,
                      restore=ckpt.engine.last_restore,
                      grad_accum=trainer.grad_accum_steps)

    def on_step(step, loss):
        if ctx.rank == 0:
            emit_line("STEP", step=step, loss=float(loss),
                      launches=_launches())
        # pace the drill: the kill lands while the full world trains, and
        # the returning node joins while the small world has steps left
        time.sleep(args["pace_s"])

    twin.train(config, args["steps"], args["global_batch"], args["seq"],
               args["ckpt_dir"], ctx, ckpt_every=args["storage_every"],
               on_step=on_step, on_start=on_start,
               micro_batch_per_replica=1)
    worker.shutdown()
    return 0


ELASTIC_AGENT = (
    "import sys\n"
    "from dlrover_tpu_torch.agent import run\n"
    "code = run.main(sys.argv[1:])\n"
    "bad = sorted(m for m in sys.modules\n"
    "             if m.split('.')[0] in ('jax', 'jaxlib', 'dlrover_tpu'))\n"
    "print('AGENT_MODULES ' + ','.join(bad), flush=True)\n"
    "sys.exit(code or (3 if bad else 0))\n"
)


def _lines(text, tag):
    """The JSON objects of a log's ``TAG {...}`` lines; a line another
    process wrote into is skipped."""
    out = []
    for ln in text.splitlines():
        if ln.startswith(tag + " "):
            try:
                out.append(json.JSONDecoder().raw_decode(
                    ln, len(tag) + 1)[0])
            except ValueError:
                continue
    return out


def _ckpt_arc(bundle_dir, step_lines):
    """The agent's chaos bundles (phase 8's ``storage.commit`` delay: the
    first one's digest and their count) and the checkpoint arcs they share
    with the workers: the persist requests the workers traced whose
    trace_id the saver's ``ckpt.persist`` or ``ckpt.commit`` spans in a
    bundle carry."""
    out = {"chaos_bundle": None, "shared": []}
    names = sorted((n for n in (os.listdir(bundle_dir)
                                if os.path.isdir(bundle_dir) else [])
                    if n.startswith("bundle_agent_0_chaos_fault_")),
                   key=lambda n: int(n.split("_")[-2]))
    if not names:
        return out
    with open(os.path.join(bundle_dir, names[0], "manifest.json")) as f:
        manifest = json.load(f)
    out["chaos_bundle"] = dict(name=names[0], bundles=len(names),
                               fault_site=manifest.get("fault_site"),
                               fault_kind=manifest.get("fault_kind"),
                               files=sorted(manifest.get("files", [])),
                               spans=manifest.get("spans_finished", 0)
                               + manifest.get("spans_live", 0))
    saver = {}
    for name in names:
        for tid, span, _, _, _ in _bundle_spans(
                os.path.join(bundle_dir, name)):
            if span in ("ckpt.persist", "ckpt.commit"):
                saver.setdefault(tid, set()).add(span)
    for r in step_lines:
        for step, tid in r.get("ckpt_traces", []):
            if tid in saver:
                out["shared"].append(dict(
                    trace_id=tid, step=step, restart=r["restart"],
                    worker="ckpt.persist_request",
                    saver=sorted(saver[tid])))
    return out


def _step_gaps(result):
    """Gaps between consecutive step reports of one run, the first from
    the run's start (model build and restore included)."""
    times = [0.0] + [result["step_s"][k]
                     for k in sorted(result["step_s"], key=int)]
    return [b - a for a, b in zip(times, times[1:])]


def elastic_phase(config, device, ckpt_root, global_batch, seq, steps,
                  storage_every, reference, hang_downtime_s, timeout=900):
    """The twin under the port's ``dlrover-run`` with three faults (module
    docstring, phase 8). ``reference``: the unkilled run's losses and the
    spread of two unkilled runs. Returns the launches of every
    incarnation."""
    from dlrover_tpu_torch.ckpt import manifest
    from dlrover_tpu_torch.common.event import (
        AgentEvent,
        compute_goodput,
        load_events,
    )
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    job = f"el{os.getpid()}"
    ckpt_dir = os.path.join(ckpt_root, job)
    event_dir = os.path.join(ckpt_root, f"{job}_events")
    bundle_dir = os.path.join(ckpt_root, f"{job}_bundles")
    os.makedirs(event_dir)
    args = dict(device=str(device), config=cfg, steps=steps,
                global_batch=global_batch, seq=seq,
                storage_every=storage_every, ckpt_dir=ckpt_dir)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_")}
    env.update({
        "PYTHONPATH": REPO,
        "DLROVER_TPU_EVENT_DIR": event_dir,
        "DLROVER_TPU_HEARTBEAT_INTERVAL_S": "1",
        "DLROVER_TPU_HANG_RESTART_WORKERS": "1",
        "DLROVER_TPU_HANG_DOWNTIME_S": str(hang_downtime_s),
        "DLROVER_TPU_DIAGNOSIS_INTERVAL_S": "1",
        "DLROVER_FAULT_SCHEDULE": (ELASTIC_TORN_SCHEDULE + ";"
                                   + ELASTIC_AGENT_FAULT),
        "DLROVER_TPU_TRACE_DIR": bundle_dir,
        "DLROVER_TPU_TRACE_BUNDLE_COOLDOWN_S": "0",
    })
    log_path = os.path.join(ckpt_root, f"{job}.log")
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", ELASTIC_AGENT, "--standalone",
             "--nproc-per-node=1", "--max-restarts=3",
             "--save-at-breakpoint", "--monitor-interval=0.1",
             f"--job_name={job}", f"--ckpt_dir={ckpt_dir}",
             os.path.abspath(__file__), "--elastic-child", json.dumps(args)],
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True,
            cwd=REPO, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    wall_s = time.time() - t0
    with open(log_path) as f:
        text = f.read()
    os.remove(log_path)
    for name in os.listdir("/dev/shm"):
        if name.startswith(f"dlrtpu_{job}_"):
            unlink_shared_memory(name)
    records = []
    for i, name in enumerate(sorted(os.listdir(event_dir))):
        for r in load_events(os.path.join(event_dir, name)):
            records.append(dict(r, event_id=(i, r.get("event_id"))))
    agent = [r for r in records if r["target"] == "agent_0"]
    stored = sorted(s for s in range(steps + 1)
                    if manifest.manifest_links(ckpt_dir, s))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shutil.rmtree(event_dir, ignore_errors=True)
    starts = {r["restart"]: r for r in _lines(text, "START")}
    step_lines = _lines(text, "STEP")
    arc = _ckpt_arc(bundle_dir, step_lines)
    shutil.rmtree(bundle_dir, ignore_errors=True)
    kills = {r["killed_at_step"]: r["ts"] for r in
             (json.loads(ln) for ln in text.splitlines()
              if ln.startswith('{"killed_at_step"'))}
    wedges = _lines(text, "WEDGE")
    modules = _lines(text, "MODULES")
    agent_modules = [ln for ln in text.splitlines()
                     if ln.startswith("AGENT_MODULES")]
    fails = [r for r in agent if r["name"] == AgentEvent.WORKER_FAIL]
    restarts = [r for r in agent if r["name"] == AgentEvent.RESTART]
    spawns = [r for r in agent if r["name"] == AgentEvent.WORKER_SPAWN]
    rounds = [r["content"]["round"] for r in agent
              if r["name"] == AgentEvent.RENDEZVOUS and r["phase"] == "END"]
    bp_saves = [r["content"] for r in agent
                if r["name"] == AgentEvent.CKPT_SAVE and r["phase"] == "END"]
    losses, launches, first_step = {}, {}, {}
    for r in step_lines:  # in order: a later incarnation's step wins
        losses[r["step"]] = r["loss"]
        launches[r["restart"]] = r["launches"]
        first_step.setdefault(r["restart"], r["t"])

    def fault(restart, t_fault, acted):
        nxt = starts.get(restart + 1, {})
        restore = nxt.get("restore", {})
        return dict(
            detect_s=(acted - t_fault) if acted else None,
            restart_s=(first_step[restart + 1] - t_fault
                       if restart + 1 in first_step else None),
            medium=restore.get("medium"), step=restore.get("step"),
            restore_s=restore.get("seconds"),
            restore_gb_per_s=(restore["bytes"] / restore["seconds"] / 1e9
                              if restore.get("seconds") else None))

    faults = {
        "kill_after_3": fault(0, kills.get(3), fails[0]["ts"]
                              if fails else None),
        "torn_6_kill_after_6": fault(1, kills.get(6), fails[1]["ts"]
                                     if len(fails) > 1 else None),
        "hang_after_8": fault(
            2, wedges[0]["t"] if wedges else None,
            next((r["ts"] for r in restarts
                  if "diagnosis action" in r["content"]["reason"]), None)),
    }
    startup_s = {sp["content"]["restart_count"]:
                 first_step.get(sp["content"]["restart_count"], 0) - sp["ts"]
                 for sp in spawns}
    goodput = compute_goodput(records)
    want = reference["losses"]
    worst = max(abs(losses.get(s, float("nan")) - want[s]) / abs(want[s])
                for s in want)
    per_run = [launches.get(r, {}) for r in range(4)]
    expect = {"kill_after_3": ("shm", 3), "torn_6_kill_after_6":
              ("storage", 5), "hang_after_8": ("shm", 8)}
    problems = []
    if rc != 0:
        problems.append(f"the agent exited {rc}")
    if len(spawns) != 4 or len(fails) != 2:
        problems.append(f"{len(spawns)} spawns, {len(fails)} failures")
    for name, (medium, step) in expect.items():
        if (faults[name]["medium"], faults[name]["step"]) != (medium, step):
            problems.append(f"{name} restored {faults[name]}")
    if "chaos: injected torn" not in text or (
            "refusing to persist" not in text):
        problems.append("the torn frame was not injected and refused")
    if 6 in stored or not {3, 5, 8} <= set(stored):
        problems.append(f"storage holds steps {stored}")
    if sorted(losses) != list(range(1, steps + 1)) or not (
            worst <= reference["spread"]):
        problems.append(f"losses {losses} vs {want}")
    if (len(modules) != 4 or any(m["forbidden"] for m in modules)
            or agent_modules != ["AGENT_MODULES "]):
        problems.append(f"modules {modules} {agent_modules}")
    for r, c in enumerate(per_run):
        if not all(c.get(k) for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")):
            problems.append(f"incarnation {r} launches {c}")
    if (arc["chaos_bundle"] is None
            or arc["chaos_bundle"]["fault_site"] != "storage.commit"
            or not arc["shared"]):
        problems.append(f"the agent's chaos bundle and checkpoint arc "
                        f"{arc}")
    emit(dict(
        phase="elastic", config=dict(dim=config.dim,
                                     n_layers=config.n_layers,
                                     dtype=cfg["dtype"]),
        global_batch=global_batch, seq_len=seq, steps=steps,
        storage_every=storage_every, hang_downtime_s=hang_downtime_s,
        agent_exit=rc, restarts=len(spawns) - 1, faults=faults,
        rendezvous_rounds=rounds, startup_s=startup_s,
        breakpoint_saves=bp_saves, storage_steps=stored,
        losses=[losses.get(s) for s in range(1, steps + 1)],
        max_rel_diff_vs_unkilled=worst,
        unkilled_spread=reference["spread"],
        launches_per_incarnation=per_run,
        wall_s=wall_s, goodput_pct=100.0 * goodput["goodput"],
        goodput_wall_s=goodput["wall_s"],
        jax_modules_agent=agent_modules,
        jax_modules_workers=[m["forbidden"] for m in modules],
        agent_chaos_bundle=arc["chaos_bundle"], ckpt_arc=arc["shared"]))
    if problems:
        raise AssertionError("elastic: " + "; ".join(problems)
                             + "\n" + text[-6000:])
    return per_run


def _run_children(args, job, ranks=1, timeout=900):
    """The twin's ``train`` in ``ranks`` child processes, one rank (and
    card) each, over ``torch.distributed`` when more than one. Returns
    ``[(exit code, output, RESUME result or None)]`` by rank."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env["DLROVER_TPU_JOB_NAME"] = job
    if ranks > 1:
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env.update(DLROVER_TPU_WORLD_SIZE=str(ranks),
                   DLROVER_TPU_LOCAL_WORLD_SIZE=str(ranks),
                   DLROVER_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}")
    logs, procs = [], []
    for r in range(ranks):
        env.update(DLROVER_TPU_RANK=str(r), DLROVER_TPU_LOCAL_RANK=str(r))
        logs.append(os.path.join(os.path.dirname(args["ckpt_dir"]),
                                 f"{job}_{r}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--resume-child",
                 json.dumps(args)], env=dict(env), stdout=log,
                stderr=subprocess.STDOUT, text=True, cwd=REPO))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, path in zip(procs, logs):
        with open(path) as f:
            text = f.read()
        os.remove(path)
        lines = [ln for ln in text.splitlines() if ln.startswith("RESUME ")]
        result = json.loads(lines[-1][len("RESUME "):]) if lines else None
        if result is not None:
            for key in ("losses", "grad_norms"):
                result[key] = {int(k): v for k, v in result[key].items()}
        out.append((p.returncode, text, result))
    return out


def resume_phase(config, device, ckpt_root, global_batch, seq, steps,
                 storage_every, kill_at):
    """The kill drill (see the module docstring, phase 6). Returns the
    launches of the children's runs and the reference phase 8 holds its
    run against: the unkilled losses, their spread and the longest gap
    between two step reports of any run."""
    from dlrover_tpu_torch.ckpt.shm_handler import shm_name
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")

    def args(name, kill=None):
        return dict(device=str(device), config=cfg, steps=steps,
                    global_batch=global_batch, seq=seq,
                    storage_every=storage_every, kill_at=kill,
                    ckpt_dir=os.path.join(ckpt_root, name))

    def run(name, job, kill=None):
        rc, out, res = _run_children(args(name, kill), job)[0]
        if kill is None and (rc != 0 or res is None):
            raise AssertionError(f"resume: run {name} failed ({rc}):\n"
                                 f"{out[-6000:]}")
        return rc, out, res

    def drop(name, job):
        unlink_shared_memory(shm_name(job, 0, 0))
        shutil.rmtree(os.path.join(ckpt_root, name), ignore_errors=True)

    tag = os.getpid()
    results, counts = {}, []
    for name in ("unkilled_a", "unkilled_b"):
        _, _, results[name] = run(name, f"resume_{name}_{tag}")
        drop(name, f"resume_{name}_{tag}")
        counts.append(results[name]["launches"])
    a, b = results["unkilled_a"]["losses"], results["unkilled_b"]["losses"]
    if sorted(a) != list(range(1, steps + 1)) or sorted(b) != sorted(a):
        raise AssertionError(f"resume: unkilled runs took steps {sorted(a)}"
                             f" and {sorted(b)}")
    spread = max(abs(a[s] - b[s]) / abs(a[s]) for s in a)
    job = f"resume_drill_{tag}"
    try:
        rc, out, killed = run("drill", job, kill=kill_at)
        if rc != -signal.SIGKILL or killed is not None:
            raise AssertionError(
                f"resume: the drill's first run ended {rc}, not by SIGKILL "
                f"after step {kill_at}:\n{out[-6000:]}")
        _, _, resumed = run("drill", job)
    finally:
        drop("drill", job)
    counts.append(resumed["launches"])
    got = resumed["losses"]
    tail = list(range(kill_at + 1, steps + 1))
    worst = max(abs(got.get(s, float("nan")) - a[s]) / abs(a[s])
                for s in tail)
    ok = (resumed["start_step"] == kill_at
          and resumed["restored_from"] == "shm"
          and sorted(got) == tail and worst <= spread)
    max_gap = max(max(_step_gaps(r))
                  for r in (*results.values(), resumed))
    emit(dict(
        phase="resume", config=dict(dim=config.dim, n_layers=config.n_layers,
                                    dtype=cfg["dtype"]),
        global_batch=global_batch, seq_len=seq, steps=steps,
        storage_every=storage_every, kill_at=kill_at,
        unkilled_losses=[a[s] for s in sorted(a)],
        unkilled_bitwise_equal=a == b, unkilled_max_rel_spread=spread,
        resumed_start_step=resumed["start_step"],
        resumed_from=resumed["restored_from"], restore=resumed["restore"],
        resumed_losses=[got.get(s) for s in tail],
        resumed_max_rel_diff=worst,
        run_seconds={k: v["seconds"] for k, v in results.items()},
        resumed_run_seconds=resumed["seconds"],
        max_step_gap_s=max_gap, launches_per_run=counts))
    if not ok:
        raise AssertionError(
            f"resume: resumed at {resumed['start_step']} from "
            f"{resumed['restored_from']}, losses {got} vs unkilled {a} "
            f"(spread {spread})")
    return counts, dict(losses=a, spread=spread, max_gap_s=max_gap)


def hang_downtime_for(max_gap_s: float) -> float:
    """The hang rule's downtime for phase 8: half again the longest gap
    between two step reports phase 6 saw, plus 10 s, so no healthy gap
    (a storage save, a restore and the first step) reads as a hang."""
    return float(np.ceil(1.5 * max_gap_s + 10.0))


# --multi: the ranks against one card. Step 1 starts from the same params,
# so only the order of the f32 sums differs (the trainer tests' limits);
# later steps also carry bf16 params rounded from updates that differ in
# their last bits, so they are held looser. A fault in the reduction (a
# grad not averaged over the ranks, a rank on the wrong rows) moves the
# step-1 grad norm by far more than its limit.
MULTI_FIRST_LOSS_TOL, MULTI_FIRST_NORM_TOL = 1e-5, 1e-4
MULTI_LATER_LOSS_TOL, MULTI_LATER_NORM_TOL = 1e-3, 1e-2


def multi_phase(config, device, ckpt_root, ranks, global_batch, seq, steps,
                storage_every, kill_at):
    """The twin across ``ranks`` cards of one host (``--multi``): the
    params as DTensors sharded over fsdp, NCCL collectives in the step,
    each rank saving its own shards. Its losses against one card's, the
    same drill as phase 6 across the ranks, then the node drill under the
    port's agents and master (:func:`node_drill`). Returns the ranks'
    launches and the node drill's."""
    from dlrover_tpu_torch.ckpt.shm_handler import shm_name
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    tag = os.getpid()

    def run(name, n, kill=None):
        job = f"multi_{name}_{tag}"
        args = dict(device=str(device), config=cfg, steps=steps,
                    global_batch=global_batch, seq=seq,
                    storage_every=storage_every, kill_at=kill,
                    ckpt_dir=os.path.join(ckpt_root, job))
        out = _run_children(args, job, ranks=n)
        bad = [(r, rc) for r, (rc, _, res) in enumerate(out)
               if (rc != -signal.SIGKILL if kill else rc != 0 or res is None)]
        if bad:
            raise AssertionError(f"multi: run {name} ranks {bad} failed:\n"
                                 + out[bad[0][0]][1][-6000:])
        return job, [res for _, _, res in out]

    def drop(job, n):
        for r in range(n):
            unlink_shared_memory(shm_name(job, 0, r))
        shutil.rmtree(os.path.join(ckpt_root, job), ignore_errors=True)

    jobs, runs = [], {}
    try:
        for name, n in (("one", 1), ("a", ranks), ("b", ranks)):
            job, runs[name] = run(name, n)
            drop(job, n)
        job, _ = run("drill", ranks, kill=kill_at)
        jobs.append(job)
        _, runs["resumed"] = run("drill", ranks)
    finally:
        for job in jobs:
            drop(job, ranks)
    one = runs["one"][0]["losses"]
    a, b = runs["a"][0]["losses"], runs["b"][0]["losses"]
    if any(res["losses"] != v[0]["losses"] for v in runs.values()
           for res in v):
        raise AssertionError("multi: the ranks of one run disagree on loss")
    # step 1 starts from the same params: the ranks only sum in another
    # order (the trainer tests' f32 limits); later steps also carry
    # bf16 params rounded from f32 updates that differ in their last bits
    norm_one = runs["one"][0]["grad_norms"]
    norm_a = runs["a"][0]["grad_norms"]

    def rel(x, y):
        return abs(x - y) / abs(y)

    first = dict(loss=rel(a[1], one[1]), grad_norm=rel(norm_a[1], norm_one[1]))
    later = dict(loss=max(rel(a[s], one[s]) for s in one if s > 1),
                 grad_norm=max(rel(norm_a[s], norm_one[s])
                               for s in one if s > 1))
    spread = max(abs(a[s] - b[s]) / abs(a[s]) for s in a)
    resumed = runs["resumed"]
    tail = list(range(kill_at + 1, steps + 1))
    got = resumed[0]["losses"]
    worst = max(abs(got.get(s, float("nan")) - a[s]) / abs(a[s])
                for s in tail)
    ok = (first["loss"] <= MULTI_FIRST_LOSS_TOL
          and first["grad_norm"] <= MULTI_FIRST_NORM_TOL
          and later["loss"] <= MULTI_LATER_LOSS_TOL
          and later["grad_norm"] <= MULTI_LATER_NORM_TOL
          and worst <= spread
          and all(r["start_step"] == kill_at and r["restored_from"] == "shm"
                  for r in resumed))
    counts = {k: sum(res["launches"][k] for res in runs["a"])
              for k in runs["a"][0]["launches"]}
    emit(dict(
        phase="multi", ranks=ranks, config=dict(
            dim=config.dim, n_layers=config.n_layers, dtype=cfg["dtype"]),
        global_batch=global_batch, seq_len=seq, steps=steps,
        kill_at=kill_at, one_card_losses=[one[s] for s in sorted(one)],
        losses=[a[s] for s in sorted(a)],
        one_card_grad_norms=[norm_one[s] for s in sorted(norm_one)],
        grad_norms=[norm_a[s] for s in sorted(norm_a)],
        rel_vs_one_card_step_1=first, rel_vs_one_card_later=later,
        unkilled_bitwise_equal=a == b, unkilled_max_rel_spread=spread,
        resumed_start_steps=[r["start_step"] for r in resumed],
        resumed_from=[r["restored_from"] for r in resumed],
        restore_s=[r["restore"].get("seconds") for r in resumed],
        resumed_losses=[got.get(s) for s in tail],
        resumed_max_rel_diff=worst,
        run_seconds={k: v[0]["seconds"] for k, v in runs.items()},
        launches_per_run_all_ranks=counts))
    if not ok:
        raise AssertionError(
            f"multi: vs one card, step 1 {first}, later {later}, "
            f"resumed {[(r['start_step'], r['restored_from'])
                        for r in resumed]} losses {got} vs {a} "
            f"(spread {spread})")
    drill = node_drill(config, device, ckpt_root, ranks, global_batch, seq,
                       steps, storage_every, rejoin_at=8, reference=a)
    return counts, drill


def node_drill(config, device, ckpt_root, ranks, global_batch, seq, steps,
               storage_every, rejoin_at, reference):
    """The kill-shrink-rejoin drill across cards (``--multi``): a port
    master in this process and two port agents of ``ranks // 2`` workers
    each (one card a worker, NCCL, fsdp over the world), their steps paced
    4 s apart. Agent 1's process group is SIGKILLed as soon as storage
    holds step ``storage_every``; the master's connection-drop grace
    declares its node dead and the survivor re-forms the world at half
    the ranks with twice the accumulation steps, restored from storage
    (the dead node's shards are in no survivor's shm); agent 1 comes back
    once the small world has done step ``rejoin_at``, and the world
    returns to ``ranks``. Each step's
    loss (its last incarnation's) is held against ``reference``, the
    unkilled run at ``ranks``, at the ``MULTI_LATER`` limits."""
    from dlrover_tpu_torch.ckpt.ckpt_saver import latest_step
    from dlrover_tpu_torch.common.config import get_context
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory
    from dlrover_tpu_torch.master.master import LocalJobMaster

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    job = f"nd{os.getpid()}"
    ckpt_dir = os.path.join(ckpt_root, job)
    args = dict(device=str(device), config=cfg, steps=steps,
                global_batch=global_batch, seq=seq,
                storage_every=storage_every, ckpt_dir=ckpt_dir,
                pace_s=4.0)
    per_node = ranks // 2
    ctx = get_context()
    ctx.heartbeat_interval_s = 1.0
    master = LocalJobMaster(job_name=job, node_num=2, min_nodes=1,
                            max_nodes=2)
    master.prepare()
    logs = []

    def start_agent(rank):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DLROVER_")}
        env.update({"PYTHONPATH": REPO,
                    "DLROVER_TPU_HEARTBEAT_INTERVAL_S": "1"})
        if device.type == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(rank * per_node + i) for i in range(per_node))
        logs.append(os.path.join(ckpt_root, f"{job}_agent{rank}_{len(logs)}"))
        with open(logs[-1], "w") as log:
            return subprocess.Popen(
                [sys.executable, "-c", ELASTIC_AGENT,
                 f"--master-addr={master.addr}", "--nnodes=1:2",
                 f"--node-rank={rank}", f"--nproc-per-node={per_node}",
                 f"--job_name={job}", "--monitor-interval=0.1",
                 "--max-restarts=3", f"--ckpt_dir={ckpt_dir}",
                 os.path.abspath(__file__), "--node-child",
                 json.dumps(args)],
                env=env, stdout=log, stderr=subprocess.STDOUT, text=True,
                cwd=REPO, start_new_session=True)

    def step_lines():
        out = []
        for path in logs:
            with open(path) as f:
                out.extend(_lines(f.read(), "STEP"))
        return out

    def logs_tail():
        keep = ("Error", "error", "commit", "persist", "skip", "restor",
                "rendezvous", "restart", "failure", "released")
        out = []
        for path in logs:
            with open(path) as f:
                out += [f"{os.path.basename(path)}: {ln[:300]}"
                        for ln in f.read().splitlines()
                        if any(k in ln for k in keep)]
        return "\n".join(out[-80:])

    def wait(cond, what, timeout=300):
        deadline = time.monotonic() + timeout
        while not cond():
            gone = [r for r, p in agents.items() if p.poll() is not None]
            if time.monotonic() > deadline or gone:
                raise AssertionError(
                    f"node drill: no {what} (agents exited: {gone}):\n"
                    + logs_tail())
            time.sleep(0.2)

    agents = {0: start_agent(0), 1: start_agent(1)}
    try:
        # the small world restores from storage: it must hold a step
        wait(lambda: latest_step(ckpt_dir) >= storage_every,
             f"storage commit of step {storage_every}")
        killed_after = max(r["step"] for r in step_lines())
        os.killpg(agents[1].pid, signal.SIGKILL)
        t_kill = time.time()
        agents.pop(1).wait()
        wait(lambda: master.job_manager.nodes[1].is_released,
             "the master declaring node 1 dead", 120)
        detect_s = time.time() - t_kill
        wait(lambda: any(r["world"] == per_node and r["step"] >= rejoin_at
                         for r in step_lines()), f"step {rejoin_at} at "
             f"world {per_node}")
        agents[1] = start_agent(1)
        codes = {r: p.wait(timeout=900) for r, p in agents.items()}
    finally:
        for p in agents.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        master.stop()
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrtpu_{job}_"):
                unlink_shared_memory(name)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    text = ""
    for path in logs:
        with open(path) as f:
            text += f.read()
        os.remove(path)
    starts = _lines(text, "START")
    steps_seen = sorted(_lines(text, "STEP"), key=lambda r: r["t"])
    losses, launches = {}, {}
    for r in steps_seen:
        losses[r["step"]] = r["loss"]
        launches[(r["node"], r["restart"])] = r["launches"]
    segments = []
    for r in sorted(starts, key=lambda r: r["t"]):
        segments.append(dict(world=r["world"], grad_accum=r["grad_accum"],
                             start_step=r["start_step"],
                             medium=r["restore"].get("medium"),
                             restore_s=r["restore"].get("seconds")))
    worst = max(abs(losses.get(s, float("nan")) - reference[s])
                / abs(reference[s]) for s in reference)
    shrink = [g for g in segments if g["world"] == per_node]
    back = [g for g in segments[segments.index(shrink[0]):]
            if g["world"] == ranks and g["start_step"] < steps] if shrink \
        else []
    worlds = [g["world"] for g in segments]
    emit(dict(
        phase="node_drill", ranks=ranks, per_node=per_node, steps=steps,
        killed_after_step=killed_after, rejoin_at=rejoin_at,
        agent_exit=codes,
        detect_s=detect_s, segments=segments,
        losses=[losses.get(s) for s in range(1, steps + 1)],
        max_rel_diff_vs_unkilled=worst,
        launches_rank0=[launches[k] for k in sorted(launches)]))
    ok = (codes == {0: 0, 1: 0} and sorted(losses) == list(
        range(1, steps + 1)) and worst <= MULTI_LATER_LOSS_TOL
        and worlds[:1] == [ranks] and bool(shrink) and bool(back)
        and shrink[0]["medium"] == "storage"
        and shrink[0]["grad_accum"] == 2 * segments[0]["grad_accum"]
        and back[0]["grad_accum"] == segments[0]["grad_accum"])
    if not ok:
        raise AssertionError(f"node drill: segments {segments}, losses "
                             f"{losses} vs {reference} (worst {worst}), "
                             f"exits {codes}:\n{text[-6000:]}")
    return list(launches.values())


def node_drill_alone(config, device, ranks):
    """``--node-drill N``: one unkilled run across N cards as the
    reference, then the node drill."""
    from dlrover_tpu_torch.ckpt.shm_handler import shm_name
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory

    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    root = os.path.join(REPO, ".chip_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    job = f"node_ref_{os.getpid()}"
    try:
        args = dict(device=str(device), config=cfg, steps=10,
                    global_batch=8, seq=2048, storage_every=5, kill_at=None,
                    ckpt_dir=os.path.join(root, "ref"))
        out = _run_children(args, job, ranks=ranks)
        for r in range(ranks):
            unlink_shared_memory(shm_name(job, 0, r))
        bad = [(r, rc) for r, (rc, _, res) in enumerate(out)
               if rc != 0 or res is None]
        if bad:
            raise AssertionError(f"node drill: reference ranks {bad} "
                                 f"failed:\n{out[bad[0][0]][1][-6000:]}")
        ref = out[0][2]["losses"]
        emit({"phase": "node_drill_reference", "ranks": ranks,
              "losses": [ref[s] for s in sorted(ref)],
              "seconds": out[0][2]["seconds"]})
        shutil.rmtree(args["ckpt_dir"], ignore_errors=True)
        return node_drill(config, device, root, ranks, global_batch=8,
                          seq=2048, steps=10, storage_every=5, rejoin_at=8,
                          reference=ref)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def elastic_alone(config, device):
    """``--elastic``: one unkilled run of phase 6's child as the
    reference, then phase 8."""
    cfg = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    cfg["dtype"] = str(config.dtype).removeprefix("torch.")
    root = os.path.join(REPO, ".chip_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    job = f"elastic_ref_{os.getpid()}"
    try:
        args = dict(device=str(device), config=cfg, steps=10,
                    global_batch=8, seq=2048, storage_every=5, kill_at=None,
                    ckpt_dir=os.path.join(root, "ref"))
        rc, out, ref = _run_children(args, job)[0]
        if rc != 0 or ref is None:
            raise AssertionError(f"elastic: reference run failed ({rc}):\n"
                                 f"{out[-6000:]}")
        from dlrover_tpu_torch.ckpt.shm_handler import shm_name
        from dlrover_tpu_torch.common.multi_process import (
            unlink_shared_memory,
        )

        unlink_shared_memory(shm_name(job, 0, 0))
        max_gap = max(_step_gaps(ref))
        emit({"phase": "elastic_reference", "losses": [
            ref["losses"][s] for s in sorted(ref["losses"])],
            "max_step_gap_s": max_gap, "seconds": ref["seconds"]})
        return elastic_phase(
            config, device, root, global_batch=8, seq=2048, steps=10,
            storage_every=5,
            reference=dict(losses=ref["losses"], spread=0.0),
            hang_downtime_s=hang_downtime_for(max_gap))
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    if argv[1:2] == ["--resume-child"]:
        return resume_child(json.loads(argv[2]))
    if argv[1:2] == ["--elastic-child"]:
        return elastic_child(json.loads(argv[2]))
    if argv[1:2] == ["--node-child"]:
        return node_child(json.loads(argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # flight-recorder bundles (this process's and its children's), removed
    # at exit
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_traces_")
    atexit.register(shutil.rmtree, trace_dir, True)
    os.environ["DLROVER_TPU_TRACE_DIR"] = trace_dir
    config = llama.LlamaConfig()
    decode_shape = (8, config.n_kv_heads, config.n_heads // config.n_kv_heads,
                    config.head_dim, 4096)
    if argv[1:2] == ["--multi"]:
        # the twin across the host's cards (see multi_phase); no result line
        ranks = int(argv[2]) if argv[2:] else torch.cuda.device_count()
        if ranks < 2 or torch.cuda.device_count() < ranks:
            print(f"chip_smoke --multi: needs {max(ranks, 2)} cards, has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        _build_report()
        root = os.path.join(REPO, ".chip_ckpt")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        try:
            multi_phase(dataclasses.replace(config, n_layers=2), device,
                        root, ranks, global_batch=8, seq=2048, steps=10,
                        storage_every=5, kill_at=4)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        _print_card()
        return 0
    if argv[1:2] == ["--node-drill"]:
        # the node drill alone across the host's cards; no result line
        ranks = int(argv[2]) if argv[2:] else torch.cuda.device_count()
        if ranks < 2 or ranks % 2 or torch.cuda.device_count() < ranks:
            print(f"chip_smoke --node-drill: needs an even number of cards "
                  f"(>= 2), has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        _build_report()
        node_drill_alone(dataclasses.replace(config, n_layers=2), device,
                         ranks)
        _print_card()
        return 0
    if argv[1:] == ["--elastic"]:
        # phase 8 alone, held against its own unkilled run; no result line
        _build_report()
        elastic_alone(dataclasses.replace(config, n_layers=2), device)
        _print_card()
        return 0
    if argv[1:] == ["--serve"]:
        # the serving replica alone: phase 7, no result line
        _build_report()
        params = llama.init_params(
            config, torch.Generator(device=device).manual_seed(SEED), device)
        serve_phase(params, config, device)
        _print_card()
        return 0
    if argv[1:] == ["--serve-elastic"]:
        # the elastic serving plane alone: phase 9, no result line
        _build_report()
        serve_elastic_phase(config, device)
        _print_card()
        return 0
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
    torch.cuda.empty_cache()
    main_path.append(serve_phase(params, config, device))
    del params  # the serving weights make room for the replicas and training
    torch.cuda.empty_cache()
    main_path.append(serve_elastic_phase(config, device))
    counts, trained = train_phase(
        dataclasses.replace(config, n_layers=8), device, global_batch=8,
        micro_batch=4, seq=2048, steps=3, lr=3e-4)
    main_path.append(counts)
    ckpt_root = os.path.join(REPO, ".chip_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    os.makedirs(ckpt_root)
    try:
        main_path.append(ckpt_phase(trained, device, ckpt_root))
        del trained
        torch.cuda.empty_cache()
        counts, reference = resume_phase(
            dataclasses.replace(config, n_layers=2), device, ckpt_root,
            global_batch=8, seq=2048, steps=10, storage_every=5, kill_at=7)
        main_path.extend(counts)
        main_path.extend(elastic_phase(
            dataclasses.replace(config, n_layers=2), device, ckpt_root,
            global_batch=8, seq=2048, steps=10, storage_every=5,
            reference=reference,
            hang_downtime_s=hang_downtime_for(reference["max_gap_s"])))
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
        worker.shutdown()

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
