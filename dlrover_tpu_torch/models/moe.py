"""Mixtral-class sparse Mixture-of-Experts decoder in PyTorch.

Counterpart of ``dlrover_tpu/models/moe.py``: the same config, parameter
tree (experts stacked on a leading ``E`` axis inside each stacked layer,
an f32 ``(L, dim, E)`` router), routing, capacity and load-balancing aux
loss. The attention, norms, RoPE and remat are the Llama blocks of
``models/llama.py``, as the JAX file takes them from its own.

Routing is the reference's exactly:

- top-k of the f32 router softmax, the lower expert index first on ties
  (a stable descending sort; ``torch.topk`` promises no tie order), gates
  renormalised over the k choices;
- capacity per routing group (one sequence per group unless
  ``route_group_size``), claimed choice-major: every token's first
  choice before any token's second (GShard order), positions counted in
  integers; a choice past capacity is dropped and its token falls through
  the residual;
- the aux term over all k choices, E · Σ_e (choice fraction · mean
  router probability), averaged over groups;
- the router product in full f32 (never TF32).

The reference dispatches and combines through a (G, g, E, C) one-hot
tensor and three einsums, which XLA shards over ``ep``. Here the same
sums run by indices: each kept choice's token is gathered into its
expert's slot, the experts run as products batched over the expert axis
(``bmm``, so the "dots" remat policy recomputes them, as
``dots_with_no_batch_dims_saveable`` recomputes the reference's), and
each token sums its kept choices' outputs times its gates (cast to the
activation dtype first, as the reference casts ``combine``) in f32. The
kept and dropped tokens and every sum are the same; the one-hot tensor
(671 MB at batch 8 × 2048 on Mixtral widths) never exists.

Sharded over ``ep`` (``parallel/sharding.py``'s ``expert`` rule), a rank
holds its experts' block of each expert tensor; the trainer computes on
full tensors (``trainer/elastic.py``). Not ported: the token all-to-all
that GSPMD inserts for the JAX package, and sequence-parallel attention
for MoE configs (it raises: the routing groups would have to span the sp
chunks).
"""

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models import llama as _llama


@dataclass(frozen=True)
class MoEConfig(_llama.AttentionConfigMixin):
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336          # per-expert FFN width (Mixtral 8x7B)
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25  # expert slots = g/E · top_k · this
    # routing group size; None = one sequence per group (g = S)
    route_group_size: Optional[int] = None
    router_aux_weight: float = 0.01
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # same semantics as LlamaConfig: "dots" | None
    remat_policy: Optional[str] = "dots"
    # same semantics as LlamaConfig; any value but None raises
    sp_attention: Optional[str] = None
    use_ring_attention: bool = False
    use_flash_attention: Optional[bool] = None

    @staticmethod
    def mixtral8x7b() -> "MoEConfig":
        """Mixtral-8x7B shapes: 46.7B params, 12.9B active."""
        return MoEConfig()

    @staticmethod
    def tiny(vocab_size: int = 256) -> "MoEConfig":
        """CI-sized config: 4 experts, top-2 (the JAX ``tiny``)."""
        return MoEConfig(
            vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, ffn_dim=96, n_experts=4, top_k=2,
            max_seq_len=128, remat=False,
        )


def param_logical_axes(config: MoEConfig) -> Dict:
    """Logical sharding axes per param (``expert`` → the ep mesh axis)."""
    return {
        "tok_embed": ("vocab", "embed"),
        "layers": {
            **_llama.attention_param_axes(),
            "ffn_norm": ("layers", "norm"),
            "router": ("layers", "embed", None),
            "w1": ("layers", "expert", "embed", "mlp"),
            "w3": ("layers", "expert", "embed", "mlp"),
            "w2": ("layers", "expert", "mlp", "embed"),
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def _expert_init(shape, fan_in, dtype, generator, device):
    """An ``(L, E, in, out)`` expert tensor drawn one ``(in, out)`` block at
    a time, so the f32 draw never holds more than one block (a whole
    Mixtral ``w1`` drawn at once is 15 GB of f32 at 8 layers)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for li in range(shape[0]):
        for e in range(shape[1]):
            out[li, e] = _llama.dense_init(shape[2:], fan_in, dtype,
                                           generator, device)
    return out


def init_params(config: MoEConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """He-style init in ``config.dtype`` from ``generator`` (on
    ``device``); the router in f32. The JAX ``init_params``'s shapes and
    distributions; the values differ, since the generators do."""
    c = config
    dev = resolve_device(device)
    dt = c.dtype
    L, E = c.n_layers, c.n_experts

    def dense(shape, fan_in):
        return _llama.dense_init(shape, fan_in, dt, generator, dev)

    def expert(shape, fan_in):
        return _expert_init(shape, fan_in, dt, generator, dev)

    return {
        "tok_embed": dense((c.vocab_size, c.dim), c.dim),
        "layers": {
            **_llama.init_attention_params(c, generator, dev),
            "ffn_norm": torch.ones((L, c.dim), dtype=dt, device=dev),
            # the router stays f32: routing decisions are precision-
            # sensitive
            "router": torch.randn((L, c.dim, E), generator=generator,
                                  device=dev, dtype=torch.float32)
            * c.dim ** -0.5,
            "w1": expert((L, E, c.dim, c.ffn_dim), c.dim),
            "w3": expert((L, E, c.dim, c.ffn_dim), c.dim),
            "w2": expert((L, E, c.ffn_dim, c.dim), c.ffn_dim),
        },
        "final_norm": torch.ones((c.dim,), dtype=dt, device=dev),
        "lm_head": dense((c.dim, c.vocab_size), c.dim),
    }


def _group_size(config: MoEConfig, batch: int, seq: int) -> int:
    """Routing group size: the config's, or one sequence per group."""
    g = config.route_group_size or seq
    if (batch * seq) % g != 0:
        raise ValueError(
            f"route_group_size {g} must divide token count {batch * seq}")
    return g


def expert_capacity(config: MoEConfig, batch: int, seq: int) -> int:
    """Per-expert token slots per routing group."""
    c = config
    g = _group_size(c, batch, seq)
    cap = int(g * c.top_k * c.capacity_factor / c.n_experts)
    return max(c.top_k, cap)


@contextlib.contextmanager
def _full_f32():
    """Matmuls in full f32 while inside (no TF32), whatever the process
    asked for."""
    prec = torch.get_float32_matmul_precision()
    if prec == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)


def _route(x_grouped, router, config: MoEConfig, capacity: int):
    """Top-k routing with capacity. ``x_grouped`` ``(G, g, D)``: G groups of
    g tokens. Returns ``(expert, slot, kept, gates, aux)``: for each token
    and choice ``(G, g, k)`` its expert, its slot in that expert's
    capacity, whether it was kept, and its f32 gate; the f32 aux scalar."""
    c = config
    G, g = x_grouped.shape[0], x_grouped.shape[1]
    E, k = c.n_experts, c.top_k
    with _full_f32():
        logits = torch.matmul(x_grouped.float(), router)     # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k with the lower index first on ties, as lax.top_k
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]                # (G, g, k)
    gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    masks = F.one_hot(topi, E)                               # (G, g, k, E)
    # choice-major priority: position = running count over (k, g) order
    cm = masks.transpose(1, 2).reshape(G, k * g, E)
    positions = (torch.cumsum(cm, dim=1) - 1).reshape(G, k, g, E)
    slot = (positions * cm.reshape(G, k, g, E)).sum(-1)      # (G, k, g)
    slot = slot.transpose(1, 2)                              # (G, g, k)
    kept = slot < capacity

    # load balancing over ALL k choices
    frac = masks.float().mean(dim=(1, 2))                    # (G, E)
    aux = E * torch.mean(torch.sum(frac * probs.mean(dim=1), dim=-1))
    return topi, slot, kept, gates, aux


def _moe_ffn(x, layer, config: MoEConfig):
    """Sparse expert FFN. x ``(B, S, D)`` → ``(B, S, D)``, aux scalar."""
    c = config
    B, S, D = x.shape
    E, k = c.n_experts, c.top_k
    capacity = expert_capacity(c, B, S)
    g = _group_size(c, B, S)
    G = B * S // g
    xg = x.reshape(G, g, D)
    expert, slot, kept, gates, aux = _route(xg, layer["router"], c,
                                            capacity)
    # dispatch: the token of each kept (expert, slot), or the zero row g
    cell = torch.where(kept, expert * capacity + slot, E * capacity)
    src = torch.full((G, E * capacity + 1), g, dtype=torch.long,
                     device=x.device)
    tok = torch.arange(g, device=x.device)[None, :, None].expand(G, g, k)
    src.scatter_(1, cell.reshape(G, -1), tok.reshape(G, -1))
    src = src[:, :E * capacity]
    x_pad = torch.cat([xg, xg.new_zeros(G, 1, D)], dim=1)   # (G, g+1, D)
    expert_in = x_pad[torch.arange(G, device=x.device)[:, None], src]
    # (G, E·C, D) → (E, G·C, D): the experts as products batched over E
    expert_in = (expert_in.reshape(G, E, capacity, D).transpose(0, 1)
                 .reshape(E, G * capacity, D))
    gate = F.silu(torch.bmm(expert_in, layer["w1"]))
    up = torch.bmm(expert_in, layer["w3"])
    expert_out = torch.bmm(gate * up, layer["w2"])           # (E, G·C, D)
    expert_out = (expert_out.reshape(E, G, capacity, D).transpose(0, 1)
                  .reshape(G, E * capacity, D))
    # combine: each token's kept choices times their gates, summed in f32
    picked = expert_out[torch.arange(G, device=x.device)[:, None, None],
                        torch.where(kept, expert * capacity + slot, 0)]
    w = (gates * kept).to(x.dtype).float()                   # (G, g, k)
    out = (picked.float() * w[..., None]).sum(2).to(x.dtype)
    return out.reshape(B, S, D), aux


def _layer(x, layer, config: MoEConfig, positions):
    c = config
    x = x + _llama.attention_block(
        _llama.rms_norm(x, layer["attn_norm"], c.norm_eps), layer, c,
        positions)
    out, aux = _moe_ffn(_llama.rms_norm(x, layer["ffn_norm"], c.norm_eps),
                        layer, c)
    return x + out, aux


def forward(params: Dict, tokens, config: MoEConfig):
    """tokens ``(B, S)`` → (logits ``(B, S, vocab)`` f32, aux loss scalar,
    the mean of the layers' aux terms). Differentiable; with
    ``config.remat`` and grad enabled, each layer is rematerialised in
    backward under ``config.remat_policy``."""
    c = config
    _llama.check_supported(c)
    B, S = tokens.shape
    x = params["tok_embed"][tokens]
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    names = list(params["layers"])
    per_layer = zip(*(params["layers"][n].unbind(0) for n in names))
    remat = c.remat and torch.is_grad_enabled()
    context_fn = _llama.remat_context(c) if remat else None
    aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for weights in per_layer:
        layer = dict(zip(names, weights))
        if remat:
            x, aux = checkpoint(_layer, x, layer, c, positions,
                                use_reentrant=False, context_fn=context_fn,
                                preserve_rng_state=False)
        else:
            x, aux = _layer(x, layer, c, positions)
        aux_sum = aux_sum + aux
    x = _llama.rms_norm(x, params["final_norm"], c.norm_eps)
    logits = torch.matmul(x.float(), params["lm_head"].float())
    return logits, aux_sum / c.n_layers


def next_token_loss(params, tokens, config: MoEConfig):
    """Causal LM loss plus the router's load-balancing aux term."""
    logits, aux = forward(params, tokens[:, :-1], config)
    return (_llama.cross_entropy(logits, tokens[:, 1:])
            + config.router_aux_weight * aux)


def num_params(config: MoEConfig) -> Tuple[int, int]:
    """(total, active-per-token) parameter counts."""
    c = config
    q_dim, kv_dim = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    attn = 2 * c.dim + c.dim * q_dim + 2 * c.dim * kv_dim + q_dim * c.dim
    expert = 3 * c.dim * c.ffn_dim
    router = c.dim * c.n_experts
    shared = c.vocab_size * c.dim * 2 + c.dim
    total = shared + c.n_layers * (attn + router + c.n_experts * expert)
    active = shared + c.n_layers * (attn + router + c.top_k * expert)
    return total, active
