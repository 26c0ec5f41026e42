"""Ring attention: causal attention over the mesh's sequence axis ``sp``.

Counterpart of ``dlrover_tpu/parallel/ring_attention.py``. Each rank holds
one contiguous chunk of the sequence, ``(B, H, S/sp, D)``, chunk ``r`` on
``sp`` rank ``r``. Q stays; K and V rotate one hop a step (send to
``(r + 1) % sp``, receive from ``(r - 1) % sp``), so after ``i`` hops rank
``r`` holds chunk ``(r - i) % sp``. A visiting chunk is either entirely
visible (it precedes ours), entirely masked (it follows ours) or our own
diagonal chunk, which takes the triangular mask.

Two bodies, as in the reference:

- :func:`_ring_flash_local`: the flash kernel per chunk (K1 causal on the
  diagonal, K1 non-causal with its lse on each preceding chunk), partials
  merged by logsumexp (:func:`_merge_partials`). Gradients reach each
  partial's lse, so the kernel's backward (K2, K3) runs with that
  cotangent;
- :func:`_ring_attention_local`: the dense online softmax in f32, the plain
  path when ``use_flash`` is off.

Every rank makes every hop, forward and backward, also where it skips the
work for a future chunk (the reference keeps that lockstep with
``lax.cond`` after its ``ppermute``); K and V travel in one hop
(``parallel/collectives.py``). The rotation takes ``sp - 1`` hops: the
reference's dense loop makes one more, which only brings K/V home.
"""

from typing import Optional

import torch

from dlrover_tpu_torch.models.llama import full_causal_attention
from dlrover_tpu_torch.ops.flash_attention import NEG_INF, flash_attention
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.collectives import shift, tie

__all__ = ["ring_attention", "sharded_flash_attention",
           "full_causal_attention"]


def _block_attend(q, k, v, mask, m, l, o, scale: float):
    """Fold one K/V block into the online-softmax accumulators.

    q: (B, H, Sq, D) f32; k/v: (B, H, Sk, D); mask: (Sq, Sk) bool
    (True = keep); m, l: (B, H, Sq) running max and denominator; o: (B, H,
    Sq, D) running numerator. Accumulators in f32."""
    scores = torch.matmul(q, k.float().transpose(-1, -2)) * scale
    scores = torch.where(mask, scores, float("-inf"))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # a fully masked row keeps m = -inf; exp(-inf - -inf) would be NaN
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    correction = torch.where(
        torch.isneginf(m), 0.0,
        torch.exp(torch.where(torch.isneginf(m), 0.0, m) - m_safe))
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction[..., None] + torch.matmul(p, v.float())
    return m_new, l_new, o_new


def _ring_attention_local(q, k, v, group, scale: float):
    """The dense ring body on this rank's chunks ``(B, H, S/sp, D)``."""
    n = torch.distributed.get_world_size(group)
    r = torch.distributed.get_rank(group)
    s = q.shape[2]
    qf = q.float()
    tri = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    full = torch.ones((s, s), dtype=torch.bool, device=q.device)
    m = torch.full(q.shape[:3], float("-inf"), device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    o = torch.zeros(q.shape, device=q.device)
    m, l, o = _block_attend(qf, k, v, tri, m, l, o, scale)
    for i in range(1, n):
        k, v = shift((k, v), group)
        # chunk (r - i) % n precedes ours for i <= r; later ones are
        # entirely masked and leave the accumulators as they are
        if i <= r:
            m, l, o = _block_attend(qf, k, v, full, m, l, o, scale)
    o = tie(o, k, v)
    l = torch.where(l == 0.0, 1.0, l)  # fully masked rows (none causal)
    return (o / l[..., None]).to(q.dtype)


def _merge_partials(o1, lse1, o2, lse2):
    """Numerically stable merge of two normalised attention partials.

    o: (B, H, S, D) f32; lse: (B, H, S) f32 (-1e30 for a row with no
    visible key). The logsumexp combine, differentiable, so gradients reach
    each partial's kernel through its lse cotangent."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(m <= -1e29, 0.0, m)
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    denom = w1 + w2
    safe = torch.where(denom == 0.0, 1.0, denom)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / safe[..., None]
    lse = torch.where(denom == 0.0, NEG_INF, m_safe + torch.log(safe))
    return o, lse


def _diagonal(q, k, v, scale: float):
    """Step 0 of the flash ring: the rank's own chunk, K1 causal; ``(o
    f32, lse)``."""
    o, lse = flash_attention(q, k, v, causal=True, scale=scale,
                             return_lse=True)
    return o.float(), lse


def _attend_past(o, lse, q, k, v, scale: float):
    """A step of the flash ring on a chunk that precedes ours: K1
    non-causal with its lse, merged into ``(o, lse)``."""
    o_b, lse_b = flash_attention(q, k, v, causal=False, scale=scale,
                                 return_lse=True)
    return _merge_partials(o, lse, o_b.float(), lse_b)


def _ring_flash_local(q, k, v, group, scale: float):
    """The flash ring body on this rank's chunks ``(B, H, S/sp, D)``: the
    ring schedule of :func:`_ring_attention_local` with the flash kernel
    per visiting chunk."""
    n = torch.distributed.get_world_size(group)
    r = torch.distributed.get_rank(group)
    o, lse = _diagonal(q, k, v, scale)
    for i in range(1, n):
        k, v = shift((k, v), group)
        if i <= r:
            o, lse = _attend_past(o, lse, q, k, v, scale)
    o = tie(o, k, v)
    return o.to(q.dtype)


def ring_attention(q, k, v, mesh, sp_axis: str = "sp",
                   scale: Optional[float] = None,
                   use_flash: Optional[bool] = None):
    """Causal attention over a sequence split along ``mesh``'s
    ``sp_axis``. q/k/v: this rank's chunk ``(B, H, S/sp, D)``, K/V heads
    already repeated to q's; returns this rank's chunk of the output.
    ``use_flash`` picks the flash kernel per chunk (default: on CUDA
    tensors) over the dense online softmax."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if use_flash is None:
        use_flash = q.is_cuda
    group = sharding.axis_group(mesh, [sp_axis])
    if group is None:
        if use_flash:
            return flash_attention(q, k, v, causal=True, scale=scale)
        return full_causal_attention(q, k, v, scale)
    if use_flash:
        return _ring_flash_local(q, k, v, group, scale)
    return _ring_attention_local(q, k, v, group, scale)


def sharded_flash_attention(q, k, v, mesh=None,
                            scale: Optional[float] = None):
    """Causal flash attention with the whole sequence on the rank. The
    reference pins the kernel's per-device block with ``shard_map``; the
    port's tensors are already this rank's, so it is the kernel call."""
    del mesh
    return flash_attention(q, k, v, causal=True, scale=scale)
