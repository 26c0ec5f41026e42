"""Ulysses sequence parallelism: all-to-all head-scatter attention.

Counterpart of ``dlrover_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses).
Where ring attention keeps Q resident and rotates K/V, Ulysses re-shards
once per attention call:

1. each rank holds its sequence chunk ``(B, H, S/sp, D)``;
2. one all-to-all per operand over ``sp`` splits the heads and gathers the
   sequence, ``(B, H/sp, S, D)``: every rank sees the whole sequence for
   ``1/sp`` of the heads, in global sequence order (chunk ``j`` from rank
   ``j``), so the causal mask needs no re-indexing;
3. plain causal attention per head group (K1, or the dense path);
4. the mirror all-to-all restores the sequence chunks.

GQA: K/V cross unrepeated (``1/rep`` the bytes of the q leg) and are
repeated after the scatter, so the per-rank q and KV head counts must both
divide by ``sp``. The all-to-alls are ``parallel/collectives.all_to_all``,
whose backward is the mirror all-to-all.
"""

from typing import Optional

import torch

from dlrover_tpu_torch.models.llama import full_causal_attention
from dlrover_tpu_torch.ops.flash_attention import flash_attention, repeat_kv
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.collectives import all_to_all


def _ulysses_local(q, k, v, group, scale: float, use_flash: bool):
    """The body on this rank's chunks: q ``(B, Hq, S/sp, D)``, k/v ``(B,
    Hkv, S/sp, D)`` with Hkv dividing Hq."""
    qg, kg, vg = (all_to_all(t, group, scatter_dim=1, gather_dim=2)
                  for t in (q, k, v))
    kg, vg = repeat_kv(kg, vg, qg.shape[1] // kg.shape[1])
    if use_flash:
        out = flash_attention(qg, kg, vg, causal=True, scale=scale)
    else:
        out = full_causal_attention(qg, kg, vg, scale)
    return all_to_all(out, group, scatter_dim=2, gather_dim=1)


def _local_heads(sizes, spec, n_heads: int) -> int:
    """Per-rank head count under ``spec``'s head entry (index 1), with
    ``sizes`` the mesh's axis sizes."""
    entry = spec[1] if len(spec) > 1 else None
    denom = 1
    for a in sharding.entry_axes(entry):
        denom *= sizes.get(a, 1)
    return n_heads // denom


def ulysses_attention(q, k, v, mesh, sp_axis: str = "sp",
                      scale: Optional[float] = None,
                      use_flash: Optional[bool] = None):
    """Causal attention over a sequence split along ``mesh``'s
    ``sp_axis``, by head-scatter / sequence-gather all-to-all. q: this
    rank's chunk ``(B, H, S/sp, D)``; k/v ``(B, H_kv, S/sp, D)`` with H_kv
    dividing H (repeated after the scatter). Returns q's shape.
    ``use_flash`` picks K1 (default: on CUDA tensors) over dense math."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if use_flash is None:
        use_flash = q.is_cuda
    sizes = sharding.mesh_sizes(mesh)
    sp = sizes.get(sp_axis, 1)
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"q heads ({q.shape[1]}) must be a multiple of kv heads "
            f"({k.shape[1]})"
        )
    # the chunks' layout: every head (the port computes on full tensors,
    # never tp shards of them), the sequence split over sp
    spec = (None, None, sp_axis, None)
    for name, t in (("q", q), ("kv", k)):
        h_local = _local_heads(sizes, spec, t.shape[1])
        if h_local % sp != 0:
            raise ValueError(
                f"Ulysses needs per-device {name} heads ({h_local}) "
                f"divisible by sp ({sp}); use ring_attention for "
                "head-poor long-context configs"
            )
    group = sharding.axis_group(mesh, [sp_axis])
    if group is None:
        k, v = repeat_kv(k, v, q.shape[1] // k.shape[1])
        if use_flash:
            return flash_attention(q, k, v, causal=True, scale=scale)
        return full_causal_attention(q, k, v, scale)
    return _ulysses_local(q, k, v, group, scale, use_flash)
