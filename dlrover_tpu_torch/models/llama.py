"""Llama-class decoder-only transformer in PyTorch.

Counterpart of ``dlrover_tpu/models/llama.py``: the same parameter tree
(a nested dict, layers stacked on a leading ``L`` axis, ``x @ W``
orientation), the same GQA / interleaved RoPE / RMSNorm / SwiGLU math,
and f32 logits. So params carried over from JAX by
:func:`dlrover_tpu_torch.convert.params_from_jax` run here as they are.

Training goes through autograd: the flash kernel is a
``torch.autograd.Function`` and each layer may be rematerialised through
``torch.utils.checkpoint`` (``remat`` / ``remat_policy``, the reference's
``jax.checkpoint`` per scanned layer). Sequence-parallel attention (ring /
Ulysses) is not ported yet and raises.
"""

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
)

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.ops.flash_attention import flash_attention, repeat_kv


@dataclass(frozen=True)
class LlamaConfig:
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
    # sequence-parallel attention strategy, as in the JAX config; any value
    # but None raises until ring/Ulysses are ported
    sp_attention: Optional[str] = None
    use_ring_attention: bool = False
    # None = auto: the flash kernel on CUDA, dense math elsewhere
    use_flash_attention: Optional[bool] = None

    @property
    def sp_strategy(self) -> Optional[str]:
        if self.sp_attention is not None:
            return self.sp_attention
        return "ring" if self.use_ring_attention else None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

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


def check_supported(config) -> None:
    """Raise for the model features the port does not carry yet."""
    if getattr(config, "n_experts", 0):
        raise NotImplementedError("MoE configs are not ported yet")
    if config.sp_strategy is not None:
        raise NotImplementedError(
            f"sequence-parallel attention {config.sp_strategy!r} is not "
            "ported yet")


def dense_init(shape, fan_in: int, dtype, generator, device):
    """He-style init: N(0, 1) / sqrt(fan_in), drawn in f32, then cast."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * fan_in ** -0.5).to(dtype)


def init_params(config: LlamaConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """He-style init in ``config.dtype``, drawn from ``generator`` (which
    must live on ``device``). Same shapes and distributions as the JAX
    ``init_params``; the values differ, since the generators do."""
    c = config
    dev = resolve_device(device)
    dt = c.dtype
    L = c.n_layers
    q_dim = c.n_heads * c.head_dim
    kv_dim = c.n_kv_heads * c.head_dim

    def init(shape, fan_in):
        return dense_init(shape, fan_in, dt, generator, dev)

    return {
        "tok_embed": init((c.vocab_size, c.dim), c.dim),
        "layers": {
            "attn_norm": torch.ones((L, c.dim), dtype=dt, device=dev),
            "wq": init((L, c.dim, q_dim), c.dim),
            "wk": init((L, c.dim, kv_dim), c.dim),
            "wv": init((L, c.dim, kv_dim), c.dim),
            "wo": init((L, q_dim, c.dim), q_dim),
            "ffn_norm": torch.ones((L, c.dim), dtype=dt, device=dev),
            "w1": init((L, c.dim, c.ffn_dim), c.dim),
            "w3": init((L, c.dim, c.ffn_dim), c.dim),
            "w2": init((L, c.ffn_dim, c.dim), c.ffn_dim),
        },
        "final_norm": torch.ones((c.dim,), dtype=dt, device=dev),
        "lm_head": init((c.dim, c.vocab_size), c.dim),
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


def mlp(x, layer):
    gate = F.silu(x @ layer["w1"])
    return (gate * (x @ layer["w3"])) @ layer["w2"]


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


def attention(x, layer, config: LlamaConfig, positions):
    c = config
    B, S, _ = x.shape
    q = (x @ layer["wq"]).reshape(B, S, c.n_heads, c.head_dim)
    k = (x @ layer["wk"]).reshape(B, S, c.n_kv_heads, c.head_dim)
    v = (x @ layer["wv"]).reshape(B, S, c.n_kv_heads, c.head_dim)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    use_flash = c.use_flash_attention
    if use_flash is None:
        use_flash = x.is_cuda
    k, v = repeat_kv(k, v, c.n_heads // c.n_kv_heads)
    if use_flash:
        out = flash_attention(q, k, v, causal=True)
    else:
        out = full_causal_attention(q, k, v)
    out = out.transpose(1, 2).reshape(B, S, c.n_heads * c.head_dim)
    return out @ layer["wo"]


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


def _layer(x, layer, config: LlamaConfig, positions):
    c = config
    x = x + attention(rms_norm(x, layer["attn_norm"], c.norm_eps), layer, c,
                      positions)
    return x + mlp(rms_norm(x, layer["ffn_norm"], c.norm_eps), layer)


def forward(params: Dict, tokens, config: LlamaConfig):
    """tokens ``(B, S)`` int → logits ``(B, S, vocab)`` f32 (accumulated in
    f32, as the JAX forward's ``preferred_element_type``). Differentiable;
    with ``config.remat`` and grad enabled, each layer is rematerialised
    in backward under ``config.remat_policy``."""
    c = config
    check_supported(c)
    B, S = tokens.shape
    x = params["tok_embed"][tokens]
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    # one unbind per stacked weight: its backward stacks the L layer grads
    # once, where indexing w[li] would build an (L, ...) grad per layer
    names = list(params["layers"])
    per_layer = zip(*(params["layers"][n].unbind(0) for n in names))
    remat = c.remat and torch.is_grad_enabled()
    context_fn = _remat_context(c) if remat else None
    for weights in per_layer:
        layer = dict(zip(names, weights))
        if remat:
            x = checkpoint(_layer, x, layer, c, positions,
                           use_reentrant=False, context_fn=context_fn,
                           preserve_rng_state=False)
        else:
            x = _layer(x, layer, c, positions)
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    return torch.matmul(x.float(), params["lm_head"].float())


def cross_entropy(logits, targets):
    """Mean NLL as logsumexp minus the gathered logit, as the reference
    (never the full log-probability tensor)."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return (lse - tgt).mean()


def next_token_loss(params, tokens, config: LlamaConfig):
    """Causal LM loss: predict tokens[1:] from tokens[:-1]."""
    logits = forward(params, tokens[:, :-1], config)
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
