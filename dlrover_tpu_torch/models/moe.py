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

Sharded over ``ep`` (``parallel/sharding.py``'s ``expert`` rule), rank r
holds experts ``[r·E/ep, (r+1)·E/ep)``. Given the mesh, ``forward`` runs
only those: routing stays whole and replicated (every ``ep`` rank routes
the same tokens), the dispatch gathers the kept choices of the rank's
own experts into an ``(E/ep, G·C, D)`` batch, the combine sums those
choices in f32, and ``collectives.from_region`` sums the ranks' partials
before the cast. The normed tokens and the gates enter through
``collectives.to_region``, whose backward sums the ranks' shares of
their gradients. The expert weights may be the rank's block or the whole
stack (the rank takes its block). This is what the reference's sharded
einsums compute: its batch shards over the data axes only, so the ranks
of an ``ep`` group hold the same tokens and no token all-to-all is
needed.

Given blocks along ``fsdp`` (the trainer's ``local_axes``), each layer
gathers its blocks inside its checkpoint, as the Llama layer does
(``llama.gather_fsdp``); the experts stay the rank's ``ep`` block. Under
``tp`` the attention block and the vocab-split ends are the Llama ones,
and the experts' FFN is split as the Llama MLP is (``mlp`` over ``tp``,
the reference's rule): a rank runs the dispatch and combine on every
token routed to its experts with its columns of ``w1``/``w3`` and rows
of ``w2``, so its combine is a partial, and ``from_region`` sums the
partials over ``ep`` and ``tp`` at once (``to_region`` the inputs'
grads).
Experts given whole along ``tp`` run whole on every tp rank.

Under sequence parallelism (``sp_attention`` and a mesh whose ``sp`` axis
is > 1) each rank computes its contiguous chunk of the sequence: the
attention is the Llama block's ring or Ulysses, and a routing group is
still ``g`` consecutive tokens of the global ``(B, S)``, so it may span
the chunks. Capacity is claimed choice-major across the whole group, so
each rank gathers every rank's top-k experts (integers, no gradient), runs
the slot arithmetic on whole groups and keeps its chunk's slots. The aux
term's mean router probability is a differentiable sum over ``sp``
(``collectives.psum``), its choice fractions come from the gathered ids;
every rank's loss holds the same aux value.
"""

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models import llama as _llama
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.collectives import (
    from_region,
    gather,
    psum,
    to_region,
)


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
    # same semantics as LlamaConfig: None | "ring" | "ulysses"
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


def _choices(x, router, config: MoEConfig):
    """Each token's f32 router probabilities ``(..., E)``, its top-k
    experts ``(..., k)`` (the lower index first on ties, as lax.top_k) and
    their renormalised gates, over ``x``'s leading dims."""
    with _full_f32():
        logits = torch.matmul(x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :config.top_k], topi[..., :config.top_k]
    gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topi, gates


def _slots(expert, n_experts: int, capacity: int):
    """``expert`` ``(G, g, k)``: the choices of G whole groups → each
    choice's slot in its expert's capacity and whether it was kept
    ``(G, g, k)``, and each group's choice fraction per expert ``(G, E)``.
    Capacity is claimed choice-major, positions counted in integers."""
    G, g, k = expert.shape
    masks = F.one_hot(expert, n_experts)                     # (G, g, k, E)
    cm = masks.transpose(1, 2).reshape(G, k * g, n_experts)
    positions = (torch.cumsum(cm, dim=1) - 1).reshape(G, k, g, n_experts)
    slot = (positions * cm.reshape(G, k, g, n_experts)).sum(-1)  # (G, k, g)
    slot = slot.transpose(1, 2)                              # (G, g, k)
    # load balancing over ALL k choices
    return slot, slot < capacity, masks.float().mean(dim=(1, 2))


def _aux(frac, prob_mean, n_experts: int):
    """E · Σ_e (choice fraction · mean router probability), averaged over
    groups."""
    return n_experts * torch.mean(torch.sum(frac * prob_mean, dim=-1))


def _route(x_grouped, router, config: MoEConfig, capacity: int):
    """Top-k routing with capacity. ``x_grouped`` ``(G, g, D)``: G groups of
    g tokens. Returns ``(expert, slot, kept, gates, aux)``: for each token
    and choice ``(G, g, k)`` its expert, its slot in that expert's
    capacity, whether it was kept, and its f32 gate; the f32 aux scalar."""
    probs, expert, gates = _choices(x_grouped, router, config)
    slot, kept, frac = _slots(expert, config.n_experts, capacity)
    return (expert, slot, kept, gates,
            _aux(frac, probs.mean(dim=1), config.n_experts))


def _chunk_slots(chunks, r: int, g: int, n_experts: int, capacity: int):
    """``chunks`` ``(sp, B, s, k)``: every sp rank's top-k experts for its
    chunk of ``(B, S = sp·s)``. Runs the slot arithmetic on the whole
    groups of ``g`` consecutive tokens of the flattened ``(B, S)`` and
    returns chunk ``r``'s slots and kept flags ``(B, s, k)`` and every
    group's choice fractions ``(G, E)``."""
    sp, B, s, k = chunks.shape
    whole = chunks.permute(1, 0, 2, 3).reshape(B * sp * s // g, g, k)
    slot, kept, frac = _slots(whole, n_experts, capacity)
    return (slot.reshape(B, sp, s, k)[:, r], kept.reshape(B, sp, s, k)[:, r],
            frac)


def _chunk_groups(B: int, s: int, sp: int, r: int, g: int, device):
    """``(B, s)``: the routing group of each token of chunk ``r``."""
    pos = (torch.arange(B, device=device)[:, None] * (s * sp) + r * s
           + torch.arange(s, device=device)[None, :])
    return pos // g


def _chunk_prob_sums(probs, groups, n_groups: int):
    """The sum of chunk tokens' router probabilities ``(B, s, E)`` per
    routing group: ``(G, E)``, differentiable."""
    return probs.new_zeros(n_groups, probs.shape[-1]).index_add(
        0, groups.reshape(-1), probs.reshape(-1, probs.shape[-1]))


def _route_sp(x, router, config: MoEConfig, capacity: int, g: int,
              group, r: int):
    """:func:`_route` for this rank's chunk ``x`` ``(B, s, D)`` of the
    sequence, its groups spanning the ``sp`` ranks of ``group``: returns
    ``(expert, slot, kept, gates, aux)``, the first four ``(B, s, k)``, the
    aux term the whole groups' (the same on every rank)."""
    B, s, _ = x.shape
    sp = dist.get_world_size(group)
    probs, expert, gates = _choices(x, router, config)
    slot, kept, frac = _chunk_slots(gather(expert, group), r, g,
                                    config.n_experts, capacity)
    G = B * s * sp // g
    sums = psum(_chunk_prob_sums(
        probs, _chunk_groups(B, s, sp, r, g, x.device), G), group)
    return expert, slot, kept, gates, _aux(frac, sums / g, config.n_experts)


def fold_routes(choices, config: MoEConfig, capacity: int, g: int):
    """Mesh-free :func:`_route_sp`: ``choices`` each sp chunk's ``(probs,
    expert, gates)`` (:func:`_choices` of its ``(B, s, D)`` tokens) of one
    ``(B, S)`` batch, combined as the sp ranks combine them (the experts
    gathered, the probability sums added). Returns each chunk's
    ``(expert, slot, kept, gates, aux)``."""
    sp = len(choices)
    B, s, _ = choices[0][0].shape
    G = B * s * sp // g
    ids = torch.stack([expert for _, expert, _ in choices])
    sums = sum(_chunk_prob_sums(
        probs, _chunk_groups(B, s, sp, r, g, probs.device), G)
        for r, (probs, _, _) in enumerate(choices))
    out = []
    for r, (_, expert, gates) in enumerate(choices):
        slot, kept, frac = _chunk_slots(ids, r, g, config.n_experts,
                                        capacity)
        out.append((expert, slot, kept, gates,
                    _aux(frac, sums / g, config.n_experts)))
    return out


def _ep_block(mesh, n_experts: int):
    """``(group, first expert, experts)`` of this rank's ``ep`` block, or
    ``(None, 0, E)`` with no mesh or ``ep`` = 1."""
    group = None if mesh is None else sharding.axis_group(mesh, ["ep"])
    if group is None:
        return None, 0, n_experts
    n = sharding.mesh_sizes(mesh)["ep"]
    if n_experts % n:
        raise ValueError(f"{n_experts} experts do not split over ep {n}")
    local = n_experts // n
    return group, sharding.mesh_coords(mesh)["ep"] * local, local


def _ffn_region(mesh, config: MoEConfig, w1):
    """The group whose ranks each compute a share of the expert FFN's
    output on the same tokens: ``ep`` (each rank's experts) and, when
    ``w1``'s mlp dim is this rank's ``tp`` block (``sharding.held_block``;
    ``w3``'s columns and ``w2``'s rows split with it), ``tp`` (its
    columns of every expert's FFN). None when the rank computes the FFN
    whole."""
    if mesh is None:
        return None
    axes = ["ep"]
    _, n = sharding.held_block(mesh, "tp", w1.shape[-1], config.ffn_dim)
    if n != config.ffn_dim:
        axes.append("tp")
    return sharding.axis_group(mesh, axes)


def _moe_ffn(x, layer, config: MoEConfig, mesh=None):
    """Sparse expert FFN. x ``(B, s, D)`` → ``(B, s, D)``, aux scalar. With
    ``mesh``: under sequence parallelism ``x`` is this rank's chunk of the
    sequence, under ``ep`` the rank runs only its block of experts, and
    under ``tp`` (experts held as tp blocks) only its columns of them
    (module docstring)."""
    c = config
    B, s, D = x.shape
    E, k = c.n_experts, c.top_k
    sp, r = _llama._sp_chunk(c, mesh)
    S = s * sp
    capacity = expert_capacity(c, B, S)
    g = _group_size(c, B, S)
    G = B * S // g
    N = B * s
    if sp > 1:
        expert, slot, kept, gates, aux = _route_sp(
            x, layer["router"], c, capacity, g,
            sharding.axis_group(mesh, ["sp"]), r)
        groups = _chunk_groups(B, s, sp, r, g, x.device).reshape(N, 1)
    else:
        expert, slot, kept, gates, aux = _route(
            x.reshape(G, g, D), layer["router"], c, capacity)
        groups = torch.arange(N, device=x.device).reshape(N, 1) // g
    expert, slot, kept, gates = (t.reshape(N, k)
                                 for t in (expert, slot, kept, gates))
    ep_group, lo, El = _ep_block(mesh, E)
    w1, w3, w2 = (w if w.shape[0] == El else w[lo:lo + El]
                  for w in (layer["w1"], layer["w3"], layer["w2"]))
    region = _ffn_region(mesh, c, w1)
    xf = x.reshape(N, D)
    own = kept
    if ep_group is not None:
        own = kept & (expert >= lo) & (expert < lo + El)
    if region is not None:
        xf, gates = to_region((xf, gates), region)
    # dispatch: the token of each kept (group, expert, slot) of this rank,
    # or the zero row N
    n_cells = G * El * capacity
    cell = torch.where(own, (groups * El + expert - lo) * capacity + slot,
                       n_cells)
    src = torch.full((n_cells + 1,), N, dtype=torch.long, device=x.device)
    tok = torch.arange(N, device=x.device)[:, None].expand(N, k)
    src.scatter_(0, cell.reshape(-1), tok.reshape(-1))
    x_pad = torch.cat([xf, xf.new_zeros(1, D)])               # (N + 1, D)
    # (G·El·C, D) → (El, G·C, D): the experts as products batched over El
    expert_in = (x_pad[src[:n_cells]].reshape(G, El, capacity, D)
                 .transpose(0, 1).reshape(El, G * capacity, D))
    gate = F.silu(torch.bmm(expert_in, w1))
    up = torch.bmm(expert_in, w3)
    expert_out = torch.bmm(gate * up, w2)                    # (El, G·C, D)
    expert_out = (expert_out.reshape(El, G, capacity, D).transpose(0, 1)
                  .reshape(n_cells, D))
    # combine: each token's kept choices times their gates, summed in f32
    picked = expert_out[torch.where(own, cell, 0)]           # (N, k, D)
    w = (gates * own).to(x.dtype).float()                    # (N, k)
    out = (picked.float() * w[..., None]).sum(1)
    if region is not None:
        out = from_region(out, region)
    return out.to(x.dtype).reshape(B, s, D), aux


def _layer(x, layer, config: MoEConfig, positions, mesh=None):
    c = config
    # the layer's fsdp blocks, gathered inside the layer's checkpoint
    layer = _llama.gather_fsdp(
        layer, _llama.layer_axes(param_logical_axes(c)), c, mesh)
    x = x + _llama.attention_block(
        _llama.rms_norm(x, layer["attn_norm"], c.norm_eps), layer, c,
        positions, mesh)
    out, aux = _moe_ffn(_llama.rms_norm(x, layer["ffn_norm"], c.norm_eps),
                        layer, c, mesh)
    return x + out, aux


def forward(params: Dict, tokens, config: MoEConfig, mesh=None):
    """tokens ``(B, S)`` → (logits ``(B, S, vocab)`` f32, aux loss scalar,
    the mean of the layers' aux terms). Differentiable; with
    ``config.remat`` and grad enabled, each layer is rematerialised in
    backward under ``config.remat_policy`` (the whole layer: a recompute
    that stopped early could leave out a collective).

    With ``mesh`` (module docstring): under sequence parallelism S must
    divide by sp, and the rank returns its chunk ``(B, S/sp, vocab)`` of
    the logits; under ``ep`` the rank runs its block of experts, the
    weights given as that block or whole; under ``fsdp`` and ``tp`` the
    ends and the attention block are the Llama ones (module docstring)."""
    c = config
    B, S = tokens.shape
    sp, r = _llama._sp_chunk(c, mesh)
    if S % sp:
        raise ValueError(f"sequence length {S} does not divide by sp {sp}")
    s = S // sp
    tokens = tokens[:, r * s:(r + 1) * s]
    x = _llama.embed(params, tokens, c, mesh)
    positions = (r * s + torch.arange(s, device=tokens.device))[None, :]
    positions = positions.expand(B, s)
    names = list(params["layers"])
    per_layer = zip(*(params["layers"][n].unbind(0) for n in names))
    remat = c.remat and torch.is_grad_enabled()
    context_fn = _llama.remat_context(c) if remat else None
    aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for weights in per_layer:
        layer = dict(zip(names, weights))
        if remat:
            with set_checkpoint_early_stop(False):
                x, aux = checkpoint(_layer, x, layer, c, positions, mesh,
                                    use_reentrant=False,
                                    context_fn=context_fn,
                                    preserve_rng_state=False)
        else:
            x, aux = _layer(x, layer, c, positions, mesh)
        aux_sum = aux_sum + aux
    return _llama.logits(params, x, c, mesh), aux_sum / c.n_layers


def next_token_loss(params, tokens, config: MoEConfig, mesh=None):
    """Causal LM loss plus the router's load-balancing aux term. Under
    sequence parallelism, the cross entropy over this rank's chunk of the
    targets plus the whole batch's aux term (the trainer averages the
    ranks' losses and gradients over sp)."""
    logits, aux = forward(params, tokens[:, :-1], config, mesh)
    s = logits.shape[1]
    r = _llama._sp_chunk(config, mesh)[1]
    return (_llama.cross_entropy(logits, tokens[:, 1:][:, r * s:(r + 1) * s])
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
