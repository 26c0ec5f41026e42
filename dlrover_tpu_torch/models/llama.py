"""Llama-class decoder-only transformer in PyTorch.

Counterpart of ``dlrover_tpu/models/llama.py``: the same parameter tree
(a nested dict, layers stacked on a leading ``L`` axis, ``x @ W``
orientation), the same GQA / interleaved RoPE / RMSNorm / SwiGLU math,
and f32 logits. So params carried over from JAX by
:func:`dlrover_tpu_torch.convert.params_from_jax` run here as they are.

Training goes through autograd: the flash kernel is a
``torch.autograd.Function`` and each layer may be rematerialised through
``torch.utils.checkpoint`` (``remat`` / ``remat_policy``, the reference's
``jax.checkpoint`` per scanned layer). The attention block, ``rms_norm``,
the attention params and the remat context are public for the model
families that compose them (``models/moe.py``, as the JAX file's aliases).
MoE configs (``n_experts`` > 0) run through ``models/moe.py``; this
file's ``forward`` and ``init_params`` refuse them.

Sequence parallelism (``sp_attention`` "ring" or "ulysses" on a mesh whose
``sp`` axis is > 1): ``forward`` and ``next_token_loss`` take the mesh, as
the reference's do, and each rank computes its contiguous chunk of the
sequence, with RoPE at the chunk's global positions, through
``parallel/ring_attention.py`` or ``parallel/ulysses.py``. Without such a
mesh an sp config computes plain attention. Pipeline parallelism:
:func:`forward_pp` and :func:`next_token_loss_pp` run the layers as GPipe
stages over the mesh's ``pp`` axis (``parallel/pipeline.py``).
"""

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
    set_checkpoint_early_stop,
)

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.ops.flash_attention import flash_attention, repeat_kv
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.collectives import (
    from_region,
    gather_from_region,
    gather_shard,
    to_region,
)


class AttentionConfigMixin:
    """The attention-config surface shared by ``LlamaConfig`` and
    ``moe.MoEConfig``: the sp-strategy legacy-alias fold and head_dim."""

    @property
    def sp_strategy(self) -> Optional[str]:
        if self.sp_attention is not None:
            return self.sp_attention
        return "ring" if self.use_ring_attention else None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


@dataclass(frozen=True)
class LlamaConfig(AttentionConfigMixin):
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # remat policy: "dots" saves the outputs of the matmuls with no batch
    # dims (the x @ W projections) and recomputes the rest in backward,
    # attention included; None = save nothing but the layer input
    remat_policy: Optional[str] = "dots"
    # long-context strategy when the mesh's sp axis is > 1, as in the JAX
    # config: None, "ring" (K/V hops around the sp ring) or "ulysses"
    # (head-scatter all-to-all; K/V cross unrepeated)
    sp_attention: Optional[str] = None
    use_ring_attention: bool = False
    # None = auto: the flash kernel on CUDA, dense math elsewhere
    use_flash_attention: Optional[bool] = None

    @staticmethod
    def llama7b() -> "LlamaConfig":
        """Llama-2-7B shapes (MHA: 32 kv heads) — 6.74B params."""
        return LlamaConfig(n_kv_heads=32)

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        """CI-sized config (the JAX ``LlamaConfig.tiny`` shapes)."""
        return LlamaConfig(
            vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, ffn_dim=128, max_seq_len=128, remat=False,
        )


def _check_dense(config) -> None:
    """Raise for a MoE config in a dense-only entry point (``forward``,
    ``init_params``): its expert weights would broadcast through ``mlp``
    into logits of the wrong shape. MoE configs go through
    ``models/moe.py`` (and ``models/decode.py``'s ``ffn``)."""
    if getattr(config, "n_experts", 0):
        raise NotImplementedError(
            "a MoE config runs through models/moe.py, not the dense Llama "
            "forward")


def dense_init(shape, fan_in: int, dtype, generator, device):
    """He-style init: N(0, 1) / sqrt(fan_in), drawn in f32, then cast."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * fan_in ** -0.5).to(dtype)


def init_attention_params(config, generator: torch.Generator,
                          device) -> Dict:
    """Stacked ``(L, ...)`` attention-block params for any config with
    n_layers / dim / n_heads / n_kv_heads / head_dim / dtype."""
    c = config
    dev = resolve_device(device)
    L = c.n_layers
    q_dim = c.n_heads * c.head_dim
    kv_dim = c.n_kv_heads * c.head_dim

    def init(shape, fan_in):
        return dense_init(shape, fan_in, c.dtype, generator, dev)

    return {
        "attn_norm": torch.ones((L, c.dim), dtype=c.dtype, device=dev),
        "wq": init((L, c.dim, q_dim), c.dim),
        "wk": init((L, c.dim, kv_dim), c.dim),
        "wv": init((L, c.dim, kv_dim), c.dim),
        "wo": init((L, q_dim, c.dim), q_dim),
    }


def init_params(config: LlamaConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """He-style init in ``config.dtype``, drawn from ``generator`` (which
    must live on ``device``). Same shapes and distributions as the JAX
    ``init_params``; the values differ, since the generators do."""
    c = config
    _check_dense(c)
    dev = resolve_device(device)
    dt = c.dtype
    L = c.n_layers

    def init(shape, fan_in):
        return dense_init(shape, fan_in, dt, generator, dev)

    return {
        "tok_embed": init((c.vocab_size, c.dim), c.dim),
        "layers": {
            **init_attention_params(c, generator, dev),
            "ffn_norm": torch.ones((L, c.dim), dtype=dt, device=dev),
            "w1": init((L, c.dim, c.ffn_dim), c.dim),
            "w3": init((L, c.dim, c.ffn_dim), c.dim),
            "w2": init((L, c.ffn_dim, c.dim), c.ffn_dim),
        },
        "final_norm": torch.ones((c.dim,), dtype=dt, device=dev),
        "lm_head": init((c.dim, c.vocab_size), c.dim),
    }


def attention_param_axes() -> Dict:
    """Per-layer attention-block logical axes, shared by every model family
    that uses these blocks (``models/moe.py``)."""
    return {
        "attn_norm": ("layers", "norm"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
    }


def param_logical_axes(config: LlamaConfig) -> Dict:
    """Logical sharding axes per param (the reference's names; the rules
    in parallel/sharding.py map them to mesh axes)."""
    return {
        "tok_embed": ("vocab", "embed"),
        "layers": {
            **attention_param_axes(),
            "ffn_norm": ("layers", "norm"),
            "w1": ("layers", "embed", "mlp"),
            "w3": ("layers", "embed", "mlp"),
            "w2": ("layers", "mlp", "embed"),
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def layer_params(params: Dict, li: int) -> Dict:
    """Layer ``li``'s weights out of the stacked ``params['layers']``."""
    return {name: w[li] for name, w in params["layers"].items()}


def rms_norm(x, weight, eps: float):
    """Normalise in f32, cast back to x's dtype, THEN scale by the weight
    (the JAX order; scaling before the cast rounds differently in bf16)."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight


def rope(x, positions, theta: float):
    """Rotary embedding over INTERLEAVED pairs ``(x[..., 0::2],
    x[..., 1::2])`` — not the ``rotate_half`` split. x: ``(B, S, H, D)``;
    positions: ``(B, S)``."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _tp(mesh):
    """``(group, size, coordinate)`` of this rank along ``tp``, or ``(None,
    1, 0)`` with no mesh or ``tp`` = 1."""
    group = None if mesh is None else sharding.axis_group(mesh, ["tp"])
    if group is None:
        return None, 1, 0
    return (group, sharding.mesh_sizes(mesh)["tp"],
            sharding.mesh_coords(mesh)["tp"])


def logical_sizes(config) -> Dict[str, int]:
    """The whole size of each logical axis of the params."""
    c = config
    return {"embed": c.dim, "norm": c.dim, "heads": c.n_heads * c.head_dim,
            "kv_heads": c.n_kv_heads * c.head_dim, "mlp": c.ffn_dim,
            "vocab": c.vocab_size, "expert": getattr(c, "n_experts", 0)}


def gather_fsdp(leaves: Dict, logical: Dict, config, mesh) -> Dict:
    """``leaves`` with each one that this rank holds a block of along an
    ``fsdp`` dim (``logical`` names each leaf's dims; the rules put
    ``embed`` there) gathered whole through ``collectives.gather_shard``,
    whose backward reduce-scatters the grad into the block. Whether a dim
    is a block is read from the leaf's size (``sharding.held_block``): a
    whole leaf (no mesh, a dim fsdp does not divide, or ``fsdp`` not
    among the trainer's local axes) passes as it is."""
    group = None if mesh is None else sharding.axis_group(mesh, ["fsdp"])
    if group is None:
        return leaves
    sizes = logical_sizes(config)
    out = {}
    for name, w in leaves.items():
        for d, axis in enumerate(logical[name]):
            rule = sharding.DEFAULT_RULES.get(axis) if axis else None
            if "fsdp" not in sharding.entry_axes(rule):
                continue
            _, held = sharding.held_block(mesh, "fsdp", w.shape[d],
                                          sizes[axis])
            if held != sizes[axis]:
                w = gather_shard(w, group, d)
        out[name] = w
    return out


def _tp_take(w, dim: int, lo: int, n: int, total: int, mesh, group):
    """``[lo, lo + n)`` along ``dim`` of a weight of the ``tp`` region
    (``total`` whole), from what this rank holds of it. Its own block is
    taken as it is. A whole weight (the clamp of a dim ``tp`` does not
    divide, or ``tp`` not local) enters the region through *f*: the ranks
    read different slices of it, so their grads sum over ``tp``. A block
    that is not the slice the rank needs (KV heads split finer than
    whole heads) is gathered (``gather_shard``), and its backward sums
    the ranks' slices' grads into each block."""
    start, held = sharding.held_block(mesh, "tp", w.shape[dim], total)
    if (start, held) == (lo, n):
        return w
    if held == total:
        (w,) = to_region((w,), group)
    else:
        w = gather_shard(w, group, dim)
    return w.narrow(dim, lo, n)


def tp_slices(config, tp: int, t: int) -> Dict:
    """The slice of each leaf of a layer that the rank at ``tp``
    coordinate ``t`` computes with: ``name -> (dim, start, size)`` of the
    per-layer weight, for ``wq``/``wk``/``wv`` and ``w1``/``w3``
    (columns: column-parallel) and ``wo``/``w2`` (rows: row-parallel).
    ``w1``/``w3``/``w2`` are left out when ``tp`` does not divide the FFN
    width: that MLP runs whole on every rank."""
    c = config
    hd = c.head_dim
    h0, h1, kv0, kv1 = sharding.tp_heads(c.n_heads, c.n_kv_heads, tp, t)
    out = {"wq": (1, h0 * hd, (h1 - h0) * hd),
           "wk": (1, kv0 * hd, (kv1 - kv0) * hd),
           "wv": (1, kv0 * hd, (kv1 - kv0) * hd),
           "wo": (0, h0 * hd, (h1 - h0) * hd)}
    if c.ffn_dim % tp == 0:
        n = c.ffn_dim // tp
        out.update(w1=(1, t * n, n), w3=(1, t * n, n), w2=(0, t * n, n))
    return out


def _tp_layer(layer, names, config, mesh):
    """``(group, layer)``: the ``tp`` group and ``layer`` with the leaves
    ``names`` cut to this rank's slices (:func:`tp_slices`), or ``(None,
    layer)`` when the rank computes them whole."""
    group, T, t = _tp(mesh)
    slices = tp_slices(config, T, t) if group is not None else {}
    if not all(n in slices for n in names):
        return None, layer
    sizes = logical_sizes(config)
    totals = {"wq": sizes["heads"], "wk": sizes["kv_heads"],
              "wv": sizes["kv_heads"], "wo": sizes["heads"],
              "w1": sizes["mlp"], "w3": sizes["mlp"], "w2": sizes["mlp"]}
    taken = {n: _tp_take(layer[n], *slices[n], totals[n], mesh, group)
             for n in names}
    return group, {**layer, **taken}


def mlp(x, layer, config, mesh=None):
    """SwiGLU. Under ``tp`` (``mesh``), column-parallel ``w1``/``w3`` and
    row-parallel ``w2`` on the rank's columns, entered through *f* and
    left through *g* (one all-reduce each way)."""
    group, layer = _tp_layer(layer, ("w1", "w3", "w2"), config, mesh)
    if group is not None:
        (x,) = to_region((x,), group)
    gate = F.silu(x @ layer["w1"])
    out = (gate * (x @ layer["w3"])) @ layer["w2"]
    return out if group is None else from_region(out, group)


def full_causal_attention(q, k, v, scale: Optional[float] = None):
    """Dense causal attention ``(B, H, S, D)``: scores in f32, probabilities
    cast to v's dtype before the AV product (the JAX reference path)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = q.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(q.dtype)


def _sp_chunk(config, mesh):
    """``(sp, rank)`` when ``config`` attends sequence-parallel on
    ``mesh`` (a strategy and an sp axis > 1), else ``(1, 0)``."""
    if config.sp_strategy is None or mesh is None:
        return 1, 0
    sp = sharding.mesh_sizes(mesh).get("sp", 1)
    if sp <= 1:
        return 1, 0
    return sp, sharding.mesh_coords(mesh)["sp"]


def attention(x, layer, config: LlamaConfig, positions, mesh=None):
    """The attention block on ``x`` ``(B, S, dim)``; under sequence
    parallelism ``x`` is this rank's chunk and ``positions`` its global
    positions. Under ``tp`` the rank attends with its q heads and the KV
    heads they read (``sharding.tp_heads``): column-parallel
    ``wq``/``wk``/``wv`` after *f*, K1-K3 (or the sp paths) on those
    heads, and row-parallel ``wo`` before *g*."""
    c = config
    B, S, _ = x.shape
    group, layer = _tp_layer(layer, ("wq", "wk", "wv", "wo"), c, mesh)
    if group is not None:
        (x,) = to_region((x,), group)
    hd = c.head_dim
    n_q = layer["wq"].shape[1] // hd
    n_kv = layer["wk"].shape[1] // hd
    q = (x @ layer["wq"]).reshape(B, S, n_q, hd)
    k = (x @ layer["wk"]).reshape(B, S, n_kv, hd)
    v = (x @ layer["wv"]).reshape(B, S, n_kv, hd)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    strategy = c.sp_strategy
    if strategy not in (None, "ring", "ulysses"):
        raise ValueError(
            f"unknown sp_attention {strategy!r}; expected None, 'ring' or "
            "'ulysses'")
    use_flash = c.use_flash_attention
    if use_flash is None:
        use_flash = x.is_cuda
    use_sp = _sp_chunk(c, mesh)[0] > 1
    # GQA: repeat kv heads to match q heads, except on the Ulysses path,
    # which scatters unrepeated K/V and repeats them after
    if not (use_sp and strategy == "ulysses"):
        k, v = repeat_kv(k, v, n_q // n_kv)
    if use_sp and strategy == "ulysses":
        from dlrover_tpu_torch.parallel.ulysses import ulysses_attention

        out = ulysses_attention(q, k, v, mesh, use_flash=use_flash)
    elif use_sp:
        from dlrover_tpu_torch.parallel.ring_attention import ring_attention

        out = ring_attention(q, k, v, mesh, use_flash=use_flash)
    elif use_flash:
        out = flash_attention(q, k, v, causal=True)
    else:
        out = full_causal_attention(q, k, v)
    out = out.transpose(1, 2).reshape(B, S, n_q * hd) @ layer["wo"]
    return out if group is None else from_region(out, group)


def _dots_policy(ctx, func, *args, **kwargs):
    """Counterpart of ``dots_with_no_batch_dims_saveable``: keep what
    ``aten.mm``/``aten.addmm`` produce (``x @ W`` folds to them; attention's
    batched products go to ``bmm`` and are recomputed with the rest)."""
    if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(config):
    """The config's remat_policy name as a checkpoint ``context_fn``."""
    name = config.remat_policy
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    if name is None:
        return noop_context_fn
    raise ValueError(f"unknown remat_policy {name!r}")


# public names for the model families that compose these blocks
# (models/moe.py), as the JAX file's aliases
attention_block = attention
remat_context = _remat_context


def layer_axes(logical: Dict) -> Dict:
    """A family's per-layer logical axes: those of its stacked
    ``params["layers"]`` without the leading ``layers`` dim."""
    return {n: axes[1:] for n, axes in logical["layers"].items()}


def _layer(x, layer, config: LlamaConfig, positions, mesh=None):
    """One layer. Its fsdp blocks are gathered here, inside the
    checkpoint of :func:`_layers`: a recompute gathers them again, and no
    gathered layer outlives its use."""
    c = config
    layer = gather_fsdp(layer, layer_axes(param_logical_axes(c)), c, mesh)
    x = x + attention(rms_norm(x, layer["attn_norm"], c.norm_eps), layer, c,
                      positions, mesh)
    return x + mlp(rms_norm(x, layer["ffn_norm"], c.norm_eps), layer, c,
                   mesh)


def _layers(x, stacked: Dict, config: LlamaConfig, positions, mesh=None):
    """``x`` through the stacked layers ``stacked`` (``(L', ...)`` each),
    each rematerialised in backward under ``config.remat`` when grad is
    on. Under sequence parallelism a layer's recompute re-runs its
    collectives: every rank recomputes the same layers in the same order,
    and the recompute never stops early, so they stay paired."""
    c = config
    # one unbind per stacked weight: its backward stacks the L layer grads
    # once, where indexing w[li] would build an (L, ...) grad per layer
    names = list(stacked)
    per_layer = zip(*(stacked[n].unbind(0) for n in names))
    remat = c.remat and torch.is_grad_enabled()
    context_fn = _remat_context(c) if remat else None
    for weights in per_layer:
        layer = dict(zip(names, weights))
        if remat:
            with set_checkpoint_early_stop(False):
                x = checkpoint(_layer, x, layer, c, positions, mesh,
                               use_reentrant=False, context_fn=context_fn,
                               preserve_rng_state=False)
        else:
            x = _layer(x, layer, c, positions, mesh)
    return x


def embed(params: Dict, tokens, config, mesh=None):
    """The rows of ``tokens`` in ``params["tok_embed"]`` (its fsdp block
    gathered). Split over ``tp`` by vocab, each rank looks up the tokens
    of its rows (zeros for the others) and *g* sums the ranks' rows."""
    w = gather_fsdp({"tok_embed": params["tok_embed"]},
                    {"tok_embed": ("vocab", "embed")}, config,
                    mesh)["tok_embed"]
    group = _tp(mesh)[0]
    v0, n = sharding.held_block(mesh, "tp", w.shape[0], config.vocab_size)
    if n == config.vocab_size:
        return w[tokens]
    idx = tokens - v0
    mine = (idx >= 0) & (idx < n)
    rows = w[torch.where(mine, idx, 0)] * mine[..., None].to(w.dtype)
    return from_region(rows, group)


def logits(params: Dict, x, config, mesh=None):
    """f32 logits of the final-normed ``x`` (``lm_head``'s fsdp block
    gathered). Split over ``tp`` by vocab, each rank computes its
    columns after *f* and the columns are gathered whole on every rank
    (``gather_from_region``), as the reference gathers its vocab-sharded
    logits; the loss is the whole-vocab cross entropy."""
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    w = gather_fsdp({"lm_head": params["lm_head"]},
                    {"lm_head": ("embed", "vocab")}, config,
                    mesh)["lm_head"]
    group = _tp(mesh)[0]
    _, n = sharding.held_block(mesh, "tp", w.shape[1], config.vocab_size)
    x = x.float()
    if n == config.vocab_size:
        return torch.matmul(x, w.float())
    (x,) = to_region((x,), group)
    return gather_from_region(torch.matmul(x, w.float()), group, x.ndim - 1)


def forward(params: Dict, tokens, config: LlamaConfig, mesh=None):
    """tokens ``(B, S)`` int → logits ``(B, S, vocab)`` f32 (accumulated in
    f32, as the JAX forward's ``preferred_element_type``). Differentiable;
    with ``config.remat`` and grad enabled, each layer is rematerialised
    in backward under ``config.remat_policy``.

    Under sequence parallelism (an sp config and a mesh whose ``sp`` axis
    is > 1) S must divide by sp, and the rank computes and returns its
    contiguous chunk ``(B, S/sp, vocab)`` of the logits."""
    c = config
    _check_dense(c)
    B, S = tokens.shape
    sp, r = _sp_chunk(c, mesh)
    if S % sp:
        raise ValueError(f"sequence length {S} does not divide by sp {sp}")
    s = S // sp
    tokens = tokens[:, r * s:(r + 1) * s]
    positions = (r * s + torch.arange(s, device=tokens.device))[None, :]
    x = embed(params, tokens, c, mesh)
    x = _layers(x, params["layers"], c, positions.expand(B, s), mesh)
    return logits(params, x, c, mesh)


def cross_entropy(logits, targets):
    """Mean NLL as logsumexp minus the gathered logit, as the reference
    (never the full log-probability tensor)."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - tgt).mean()


def next_token_loss(params, tokens, config: LlamaConfig, mesh=None):
    """Causal LM loss: predict tokens[1:] from tokens[:-1]. Under sequence
    parallelism, the mean over this rank's chunk of the targets (the
    trainer averages the chunks' losses and gradients over sp)."""
    logits = forward(params, tokens[:, :-1], config, mesh)
    targets = tokens[:, 1:]
    s = logits.shape[1]
    r = _sp_chunk(config, mesh)[1]
    return cross_entropy(logits, targets[:, r * s:(r + 1) * s])


def forward_pp(params: Dict, tokens, config: LlamaConfig, mesh,
               n_microbatches: int = 0):
    """Pipeline-parallel forward over the mesh's ``pp`` axis
    (``parallel/pipeline.py``, the GPipe schedule). The embedding runs
    before the pipeline and the final norm and ``lm_head`` after it, on
    every pp rank, as in the reference; this rank's stage runs its
    contiguous range of the stacked layers. ``params["layers"]`` holds
    either that range alone (``L/pp`` layers: the stage's block, as the
    trainer hands it over with ``local_axes=("pp",)``) or the whole stack
    (``L`` layers, of which the stage takes its range). The last stage's
    activations reach every rank, and every rank returns the whole
    logits. The ends' gradients come out on every rank (the embedding's
    only on stage 0), and the trainer's mean over pp counts each once.
    Default M: the largest divisor of B not above 4·pp. With pp = 1 it is
    :func:`forward`."""
    from dlrover_tpu_torch.parallel.pipeline import (
        microbatch,
        pipeline_apply,
        stack_stages,
        unmicrobatch,
    )

    c = config
    S_pp = sharding.mesh_sizes(mesh).get("pp", 1)
    if S_pp <= 1:
        return forward(params, tokens, config, mesh)
    _check_dense(c)
    B, S = tokens.shape
    M = n_microbatches
    if not M:
        M = next(d for d in range(min(B, 4 * S_pp), 0, -1) if B % d == 0)
    x = embed(params, tokens, c, mesh)
    depth = next(iter(params["layers"].values())).shape[0]
    if depth * S_pp == c.n_layers:
        stages = stack_stages(params["layers"], 1)   # (1, L/pp, ...)
    elif depth == c.n_layers:
        stages = stack_stages(params["layers"], S_pp)
    else:
        raise ValueError(f"{depth} stacked layers are neither the model's "
                         f"{c.n_layers} nor a stage's {c.n_layers // S_pp}")

    # a stage attends over the whole sequence (no sp split inside it)
    stage_c = dataclasses.replace(c, sp_attention=None,
                                  use_ring_attention=False)

    def stage_fn(layer_group, h):
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        return _layers(h, layer_group, stage_c,
                       positions.expand(h.shape[:2]), mesh)

    ym = pipeline_apply(stage_fn, stages, microbatch(x, M), mesh, axis="pp",
                        checkpoint_ticks=not c.remat)
    return logits(params, unmicrobatch(ym), c, mesh)


def next_token_loss_pp(params, tokens, config: LlamaConfig, mesh,
                       n_microbatches: int = 0):
    """Causal LM loss through the pipeline-parallel forward."""
    logits = forward_pp(params, tokens[:, :-1], config, mesh,
                        n_microbatches)
    return cross_entropy(logits, tokens[:, 1:])


def num_params(config: LlamaConfig) -> int:
    c = config
    q_dim, kv_dim = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    per_layer = (
        2 * c.dim  # norms
        + c.dim * q_dim + 2 * c.dim * kv_dim + q_dim * c.dim  # attn
        + 3 * c.dim * c.ffn_dim  # w1, w3: (dim, ffn); w2: (ffn, dim)
    )
    return (
        c.vocab_size * c.dim
        + c.n_layers * per_layer
        + c.dim
        + c.dim * c.vocab_size
    )
