"""KV-cache autoregressive decoding for the Llama models, in PyTorch.

Counterpart of ``dlrover_tpu/models/decode.py`` with the same cache layout
and routing decisions:

- the cache is one head-major ``(B, KV, T, Dh)`` buffer per layer (int8
  with per-vector f32 absmax scales when quantized), so a head's timeline
  is contiguous for the decode attend and for the decode kernel;
- prefill runs the prompt through the model in one batched pass; at
  ``P >= 256`` its attention takes the flash-forward kernel
  (``ops/csrc/flash_fwd.cu``) on the card;
- each decode step writes one cache row per layer and attends ``[0, pos]``:
  through the decode kernel (``ops/csrc/flash_decode.cu``) when
  :func:`flash_decode_wanted` says so, else through the dense grouped
  einsum, which is also what the JAX package computes outside any kernel.

PyTorch runs eagerly, so where the JAX code relies on ``jit`` to update the
cache in place, this module writes the buffers in place: :func:`decode_step`
writes the new row at ``pos`` into the caller's buffers and returns a cache
dict that shares them with ``pos + 1``.

Not ported yet: ``decode_window`` (the speculative verify leg) and MoE
configs, which raise.
"""

from typing import Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.common.constants import ConfigKey, env_str
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.llama import (
    check_supported,
    layer_params,
    mlp,
    rms_norm,
    rope,
)
from dlrover_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_decode_attention,
    repeat_kv,
)

# the JAX decode kernel's K block; caches sized in multiples of it take the
# kernel route (kept so routing and cache sizing match the JAX package)
_DECODE_BLOCK_K = 256


def flash_decode_wanted(T: int, quantized: bool,
                        live_len: Optional[int] = None,
                        device="cuda") -> bool:
    """Should the single-token attend use the fused decode kernel?

    The JAX package's policy (``dlrover_tpu/models/decode.py``), with "the
    backend is a TPU" read as "the device is CUDA":
    - int8 cache → yes, unless block padding dwarfs the live context;
    - bf16 cache → only when the cache is at least twice the live context
      and holds one whole skippable block (a preallocated serving cache);
    - ``DLROVER_TPU_FLASH_DECODE=1/0`` forces it on/off (on CUDA only, as
      the JAX policy forces it on a TPU only).
    ``live_len`` is the context the cache will hold when known; None means
    assume the cache is fully live.
    """
    env = env_str(ConfigKey.FLASH_DECODE, "auto")
    if env in ("0", "off"):
        return False
    if T % _DECODE_BLOCK_K != 0 or torch.device(device).type != "cuda":
        return False
    if env == "1":
        return True
    if quantized:
        return live_len is None or T <= live_len * 4
    return (
        live_len is not None
        and T >= live_len * 2
        and T - live_len >= _DECODE_BLOCK_K
    )


def init_kv_cache(config, batch: int, max_len: Optional[int] = None,
                  quantize: bool = False, device="cuda") -> Dict:
    """Zeroed per-layer head-major ``(B, KV, T, Dh)`` buffers and the write
    position ``pos`` (a Python int). Each cache field is a tuple of
    per-layer tensors; ``quantize`` stores int8 k/v with per-vector f32
    scales ``(B, KV, T)``."""
    c = config
    dev = resolve_device(device)
    T = max_len or c.max_seq_len
    shape = (batch, c.n_kv_heads, T, c.head_dim)
    L = c.n_layers

    def bufs(shp, dtype):
        return tuple(torch.zeros(shp, dtype=dtype, device=dev)
                     for _ in range(L))

    if quantize:
        return {
            "k": bufs(shape, torch.int8),
            "v": bufs(shape, torch.int8),
            "k_scale": bufs(shape[:-1], torch.float32),
            "v_scale": bufs(shape[:-1], torch.float32),
            "pos": 0,
        }
    return {"k": bufs(shape, c.dtype), "v": bufs(shape, c.dtype), "pos": 0}


def _quantize(x):
    """(…, D) → int8 values + f32 absmax/127 scales over the last axis. The
    stored scale is unclamped; the divisor is clamped at 1e-9; values round
    half to even, then clip to ±127 (bitwise the JAX ``_quantize``)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-9)
    q = torch.clamp(torch.round(x32 / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def _split_heads(x, n_heads, head_dim):
    B, S, _ = x.shape
    return x.reshape(B, S, n_heads, head_dim)


def _attend(q, k, v, mask, scale, pos=None, flash=False,
            k_scale=None, v_scale=None):
    """q ``(B, Q, H, Dh)`` against head-major k/v ``(B, KV, T, Dh)``,
    grouped-query; mask broadcastable to ``(B, 1, Q, T)``. f32 softmax.

    ``flash`` (from :func:`flash_decode_wanted`) sends the single-token
    case to :func:`flash_decode_attention` — the kernel on the card, which
    reads nothing past ``pos`` and, given ``k_scale``/``v_scale``, reads
    the int8 cache directly. Otherwise a grouped einsum (no K/V repeat),
    with the probabilities cast to v's dtype before the AV product."""
    B, Q, H, Dh = q.shape
    KV = k.shape[1]
    g = H // KV
    if flash and pos is not None and Q == 1:
        out = flash_decode_attention(
            q.reshape(B, KV, g, Dh), k, v, pos, scale=scale,
            block_k=_DECODE_BLOCK_K, k_scale=k_scale, v_scale=v_scale,
        )
        return out.reshape(B, Q, H * Dh)
    qg = q.reshape(B, Q, KV, g, Dh)
    scores = torch.einsum("bqkgd,bktd->bkgqt", qg.float(), k.float()) * scale
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,bktd->bqkgd", att.to(v.dtype), v)
    return out.reshape(B, Q, H * Dh)


def planned_cache_len(total: int, quantize_cache: bool,
                      max_len: Optional[int] = None,
                      device="cuda") -> Tuple[int, bool]:
    """(allocated cache length, will-the-decode-kernel-run) for a
    :func:`generate` call with these arguments: the one sizing and routing
    decision. Without ``max_len`` the cache is ``total`` long, rounded up
    to the 256 block only when the kernel will run."""
    if max_len is None:
        rounded = -(-total // _DECODE_BLOCK_K) * _DECODE_BLOCK_K
        flash = flash_decode_wanted(rounded, quantize_cache,
                                    live_len=total, device=device)
        return (rounded if flash else total), flash
    return max_len, flash_decode_wanted(max_len, quantize_cache,
                                        live_len=total, device=device)


def _qkv(xn, layer, c, positions):
    """Projected, rotated q ``(B, S, H, Dh)`` and head-major new k/v rows
    ``(B, KV, S, Dh)``."""
    q = rope(_split_heads(xn @ layer["wq"], c.n_heads, c.head_dim),
             positions, c.rope_theta)
    k = rope(_split_heads(xn @ layer["wk"], c.n_kv_heads, c.head_dim),
             positions, c.rope_theta)
    v = _split_heads(xn @ layer["wv"], c.n_kv_heads, c.head_dim)
    return q, k.transpose(1, 2), v.transpose(1, 2)


@torch.no_grad()
def prefill(params: Dict, tokens, config,
            max_len: int, quantize: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt ``tokens`` ``(B, P)`` through the model in one batched
    pass, building a ``max_len``-slot cache (int8 when ``quantize``) on the
    tokens' device. Returns (logits for the next token ``(B, V)`` f32,
    cache)."""
    c = config
    check_supported(c)
    B, P = tokens.shape
    T = max_len
    if P > T:
        raise ValueError(f"prompt length {P} exceeds cache length {T}")
    dev = tokens.device
    x = params["tok_embed"][tokens]
    positions = torch.arange(P, device=dev)[None, :].expand(B, P)
    ar = torch.arange(P, device=dev)
    causal = (ar[:, None] >= ar[None, :])[None, None]
    scale = c.head_dim ** -0.5
    # long prompts take the flash kernel: the dense attend materializes the
    # (B, H, P, P) score tensor; config.use_flash_attention overrides
    uf = c.use_flash_attention
    use_flash = (tokens.is_cuda if uf is None else uf) and P >= 256
    cache = init_kv_cache(c, B, T, quantize, device=dev)
    for li in range(c.n_layers):
        layer = layer_params(params, li)
        xn = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k, v = _qkv(xn, layer, c, positions)
        if use_flash:
            kr, vr = repeat_kv(k, v, c.n_heads // c.n_kv_heads)
            out = flash_attention(q.transpose(1, 2), kr, vr, causal=True,
                                  scale=scale)
            out = out.transpose(1, 2).reshape(B, P, c.n_heads * c.head_dim)
        else:
            out = _attend(q, k, v, causal, scale)
        x = x + out @ layer["wo"]
        x = x + mlp(rms_norm(x, layer["ffn_norm"], c.norm_eps), layer)
        if quantize:
            for name, rows in (("k", k), ("v", v)):
                vals, sc = _quantize(rows)
                cache[name][li][:, :, :P] = vals
                cache[name + "_scale"][li][:, :, :P] = sc
        else:
            cache["k"][li][:, :, :P] = k
            cache["v"][li][:, :, :P] = v
    cache["pos"] = P
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    logits = (x[:, -1] @ params["lm_head"]).float()
    return logits, cache


@torch.no_grad()
def decode_step(params: Dict, token, cache: Dict, config,
                flash: Optional[bool] = None) -> Tuple[torch.Tensor, Dict]:
    """One autoregressive step: ``token`` ``(B,)`` at position
    ``cache['pos']`` → (next-token logits ``(B, V)`` f32, cache at
    ``pos + 1``). Writes the new k/v row into the cache buffers IN PLACE;
    the returned dict shares the buffers.

    ``flash`` routes the attend through the decode kernel (None = the
    :func:`flash_decode_wanted` policy)."""
    c = config
    check_supported(c)
    B = token.shape[0]
    T = cache["k"][0].shape[2]
    pos = int(cache["pos"])
    if pos >= T:
        raise ValueError(f"cache of length {T} is full (pos {pos})")
    dev = token.device
    x = params["tok_embed"][token][:, None, :]           # (B, 1, D)
    positions = torch.full((B, 1), pos, device=dev)
    mask = (torch.arange(T, device=dev) <= pos)[None, None, None, :]
    scale = c.head_dim ** -0.5
    quantized = "k_scale" in cache
    if flash is None:
        flash = flash_decode_wanted(T, quantized, device=dev)
    # the kernel's per-row positions, made on the device once per step (a
    # host int would be copied over, blocking, in every layer)
    pos_rows = torch.full((B,), pos, dtype=torch.int32, device=dev)
    for li in range(c.n_layers):
        layer = layer_params(params, li)
        xn = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k_new, v_new = _qkv(xn, layer, c, positions)  # (B, KV, 1, Dh)
        kb, vb = cache["k"][li], cache["v"][li]
        if quantized:
            ksb, vsb = cache["k_scale"][li], cache["v_scale"][li]
            for buf, sbuf, rows in ((kb, ksb, k_new), (vb, vsb, v_new)):
                vals, sc = _quantize(rows)
                buf[:, :, pos] = vals[:, :, 0]
                sbuf[:, :, pos] = sc[:, :, 0]
            if flash:
                # the int8 cache goes straight into the kernel
                out = _attend(q, kb, vb, mask, scale, pos=pos_rows,
                              flash=True, k_scale=ksb, v_scale=vsb)
            else:
                out = _attend(q, _dequantize(kb, ksb, c.dtype),
                              _dequantize(vb, vsb, c.dtype), mask, scale)
        else:
            kb[:, :, pos] = k_new[:, :, 0]
            vb[:, :, pos] = v_new[:, :, 0]
            out = _attend(q, kb, vb, mask, scale, pos=pos_rows,
                          flash=flash)
        x = x + out @ layer["wo"]
        x = x + mlp(rms_norm(x, layer["ffn_norm"], c.norm_eps), layer)
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    return logits, {**cache, "pos": pos + 1}


def sample_token(logits, generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, top_k: int = 0):
    """f32 categorical sampling from ``generator``; temperature 0 →
    greedy (first maximum, as ``jnp.argmax``); top_k > 0 samples among
    the k best logits. Returns ``(B,)`` int32."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if top_k > 0:
        vals, idx = torch.topk(logits, top_k, dim=-1)
        choice = torch.multinomial(torch.softmax(vals / temperature, -1), 1,
                                   generator=generator)
        return idx.gather(-1, choice)[..., 0].to(torch.int32)
    return torch.multinomial(torch.softmax(logits / temperature, -1), 1,
                             generator=generator)[..., 0].to(torch.int32)


@torch.no_grad()
def generate(params: Dict, prompt, config,
             generator: Optional[torch.Generator],
             max_new_tokens: int, temperature: float = 1.0,
             top_k: int = 0, max_len: Optional[int] = None,
             quantize_cache: bool = False):
    """Sample ``max_new_tokens`` continuations of ``prompt`` ``(B, P)`` on
    the prompt's device. Returns ``(B, P + max_new_tokens)`` int32: one
    batched prefill, then one cached decode step per new token but the
    last. The cache size and the decode routing come from
    :func:`planned_cache_len`."""
    B, P = prompt.shape
    total = P + max_new_tokens
    max_len, flash = planned_cache_len(total, quantize_cache, max_len,
                                       device=prompt.device)
    if total > max_len:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"cache length {max_len}"
        )
    logits, cache = prefill(params, prompt, config, max_len,
                            quantize=quantize_cache)
    toks = []
    for _ in range(max_new_tokens - 1):
        nxt = sample_token(logits, generator, temperature, top_k)
        toks.append(nxt)
        logits, cache = decode_step(params, nxt, cache, config, flash=flash)
    toks.append(sample_token(logits, generator, temperature, top_k))
    return torch.cat([prompt.to(torch.int32), torch.stack(toks, dim=1)],
                     dim=1)
