"""Multi-slot batched decode engine for serving, in PyTorch.

Counterpart of ``BatchDecodeEngine`` in ``dlrover_tpu/serving/engine.py``:
continuous batching over per-slot positions, on the head-major per-layer
cache layout of ``models/decode.py`` (batch axis = slots), with prefill
split in two:

- :meth:`BatchDecodeEngine.prefill_rows` is a pure function of the prompt:
  it runs the bucket-padded prompt through a single-sequence forward (the
  dense attend, as the JAX engine does) and returns the per-layer k/v rows
  plus the first greedy token;
- :meth:`BatchDecodeEngine.insert` commits those rows to a slot and sets
  the slot's position to the prompt's real length.

Where the JAX engine gets its state updates from ``jit`` (new arrays each
call), this engine writes the slot caches and the position vector IN PLACE.

The decode step reads one position per slot. The JAX engine can hand its
decode kernel only a scalar position, so it takes the kernel only when all
active slots are in lockstep (a ``lax.cond``) and the einsum otherwise.
The port's decode kernel takes a ``(slots,)`` position vector, so whenever
:func:`flash_decode_wanted` says yes, every step is one kernel launch for
all slots, ragged or not; the tokens are the same as either JAX branch's.

Padding correctness: pad rows of a bucket write garbage k/v past
``real_len``, but a step attends ``[0, pos]`` and writes the row at ``pos``
before attending it, so garbage is overwritten before it is visible.
Inactive slots write garbage at their frozen position for the same reason.

Greedy only, as in the JAX engine (a served request must be a pure
function of its prompt, so a router can replay it elsewhere). Not ported
yet: the prefix-cache surface (``prefix_entry``, ``prefill_with_prefix``),
``export_params``/``import_params``, and the memory-accountant and
compile-watcher hooks.
"""

from dataclasses import dataclass
from typing import Any, List, Sequence

import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.decode import (
    _attend,
    _dequantize,
    _qkv,
    _quantize,
    flash_decode_wanted,
)
from dlrover_tpu_torch.models.llama import (
    check_supported,
    layer_params,
    mlp,
    rms_norm,
)


@dataclass
class PrefillResult:
    """Output of a pure prefill: what :meth:`insert` commits to a slot."""

    first_token: int
    real_len: int
    bucket_len: int
    # (L, KV, P, Dh) k and v row stacks in the model dtype
    payload: Any = None


class BatchDecodeEngine:
    """Per-layer head-major ``(slots, KV, T, Dh)`` cache buffers plus a
    ``(slots,)`` position vector, on ``device``. Greedy decode.

    ``quantize=True`` stores the cache as int8 with per-vector f32 absmax
    scales ``(slots, KV, T)``, with the ``_quantize`` math of
    ``models/decode.py``, so the engine stays token-exact against
    ``decode.generate(quantize_cache=True)``."""

    def __init__(self, params, config, slots: int = 4,
                 cache_len: int = 64, quantize: bool = False,
                 device="cuda"):
        c = config
        check_supported(c)
        dev = resolve_device(device)
        self.slots = slots
        self.cache_len = cache_len
        self.quantize = quantize
        self.device = dev
        self.params = params
        self.config = config
        shape = (slots, c.n_kv_heads, cache_len, c.head_dim)
        L = c.n_layers
        kv_dtype = torch.int8 if quantize else c.dtype
        self._k = [torch.zeros(shape, dtype=kv_dtype, device=dev)
                   for _ in range(L)]
        self._v = [torch.zeros(shape, dtype=kv_dtype, device=dev)
                   for _ in range(L)]
        n_scales = L if quantize else 0
        self._ks = [torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
                    for _ in range(n_scales)]
        self._vs = [torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
                    for _ in range(n_scales)]
        self._pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
        # the decode.py routing policy, decided once per engine
        self._flash = flash_decode_wanted(cache_len, quantize, device=dev)

    def kv_cache_bytes(self) -> int:
        """Resident bytes of the slot caches (k/v plus the int8 scales)."""
        return int(sum(
            b.numel() * b.element_size()
            for bufs in (self._k, self._v, self._ks, self._vs)
            for b in bufs
        ))

    @property
    def kv_bytes_per_slot(self) -> int:
        return self.kv_cache_bytes() // self.slots

    # -- pure prefill -------------------------------------------------------

    @torch.no_grad()
    def _prefill(self, tokens, real_len: int):
        """Single-sequence bucket-padded forward → (first greedy token,
        (L, KV, P, Dh) k stack, v stack). Touches no engine state."""
        c = self.config
        params = self.params
        P = tokens.shape[0]
        x = params["tok_embed"][tokens][None]           # (1, P, D)
        positions = torch.arange(P, device=self.device)[None]
        # causal over the padded length: the logits row at real_len-1
        # never attends a pad key (pads sit at indices >= real_len)
        ar = torch.arange(P, device=self.device)
        causal = (ar[:, None] >= ar[None, :])[None, None]
        scale = c.head_dim ** -0.5
        ks, vs = [], []
        for li in range(c.n_layers):
            layer = layer_params(params, li)
            xn = rms_norm(x, layer["attn_norm"], c.norm_eps)
            q, k, v = _qkv(xn, layer, c, positions)    # k/v (1, KV, P, Dh)
            out = _attend(q, k, v, causal, scale)
            x = x + out @ layer["wo"]
            x = x + mlp(rms_norm(x, layer["ffn_norm"], c.norm_eps), layer)
            ks.append(k[0].to(c.dtype))
            vs.append(v[0].to(c.dtype))
        x = rms_norm(x, params["final_norm"], c.norm_eps)
        # the next-token logits live at the LAST REAL position
        logits = (x[0, real_len - 1] @ params["lm_head"]).float()
        first = int(torch.argmax(logits))
        return first, torch.stack(ks), torch.stack(vs)

    def prefill_rows(self, prompt: Sequence[int],
                     bucket_len: int) -> PrefillResult:
        if len(prompt) > bucket_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds bucket {bucket_len}")
        if bucket_len > self.cache_len:
            raise ValueError(
                f"bucket {bucket_len} exceeds cache length {self.cache_len}")
        padded = list(prompt) + [0] * (bucket_len - len(prompt))
        tokens = torch.tensor(padded, dtype=torch.int64, device=self.device)
        first, ks, vs = self._prefill(tokens, len(prompt))
        return PrefillResult(
            first_token=first,
            real_len=len(prompt),
            bucket_len=bucket_len,
            payload=(ks, vs),
        )

    # -- decode-thread state commits ---------------------------------------

    @torch.no_grad()
    def insert(self, result: PrefillResult, slot: int) -> int:
        """Write the whole bucket's rows (the tail past ``real_len`` too)
        into ``slot`` and set its position to ``real_len``."""
        ks, vs = result.payload
        P = result.bucket_len
        for li in range(self.config.n_layers):
            rows_k, rows_v = ks[li], vs[li]
            if self.quantize:
                # decode.prefill's quantize-then-pad math: rows within
                # [0, real_len) come out bitwise identical
                rows_k, sc_k = _quantize(rows_k)
                rows_v, sc_v = _quantize(rows_v)
                self._ks[li][slot, :, :P] = sc_k
                self._vs[li][slot, :, :P] = sc_v
            self._k[li][slot, :, :P] = rows_k
            self._v[li][slot, :, :P] = rows_v
        self._pos[slot] = result.real_len
        return result.first_token

    @torch.no_grad()
    def step(self, tokens: Sequence[int],
             active: Sequence[bool]) -> List[int]:
        """One decode step for every slot; returns each slot's next greedy
        token (inactive slots' tokens are meaningless). Only active slots
        advance."""
        c = self.config
        params = self.params
        dev = self.device
        T = self.cache_len
        tok = torch.tensor(list(tokens), dtype=torch.int64, device=dev)
        act = torch.tensor(list(active), dtype=torch.bool, device=dev)
        pos = self._pos
        rows = torch.arange(self.slots, device=dev)
        # the write index stops at the last row, as the JAX engine's
        # dynamic_update_slice clamps its start: a slot that has run past
        # the cache overwrites its own row T - 1 and no other slot's
        wpos = pos.clamp(max=T - 1)
        x = params["tok_embed"][tok][:, None, :]        # (S, 1, D)
        positions = pos[:, None]
        mask = (torch.arange(T, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]      # (S, 1, 1, T)
        scale = c.head_dim ** -0.5
        for li in range(c.n_layers):
            layer = layer_params(params, li)
            xn = rms_norm(x, layer["attn_norm"], c.norm_eps)
            q, k_new, v_new = _qkv(xn, layer, c, positions)  # (S,KV,1,Dh)
            kb, vb = self._k[li], self._v[li]
            # each slot writes its row at its own position
            if self.quantize:
                ksb, vsb = self._ks[li], self._vs[li]
                for buf, sbuf, new in ((kb, ksb, k_new), (vb, vsb, v_new)):
                    vals, sc = _quantize(new)
                    buf[rows, :, wpos] = vals[:, :, 0]
                    sbuf[rows, :, wpos] = sc[:, :, 0]
            else:
                ksb = vsb = None
                kb[rows, :, wpos] = k_new[:, :, 0].to(c.dtype)
                vb[rows, :, wpos] = v_new[:, :, 0].to(c.dtype)
            if self._flash:
                out = _attend(q, kb, vb, mask, scale, pos=pos, flash=True,
                              k_scale=ksb, v_scale=vsb)
            elif self.quantize:
                out = _attend(q, _dequantize(kb, ksb, c.dtype),
                              _dequantize(vb, vsb, c.dtype), mask, scale)
            else:
                out = _attend(q, kb, vb, mask, scale)
            x = x + out @ layer["wo"]
            x = x + mlp(rms_norm(x, layer["ffn_norm"], c.norm_eps), layer)
        x = rms_norm(x, params["final_norm"], c.norm_eps)
        logits = (x[:, 0] @ params["lm_head"]).float()
        nxt = torch.argmax(logits, dim=-1)
        self._pos += act.to(torch.int32)
        return [int(t) for t in nxt.tolist()]

    def set_params(self, params) -> None:
        """Swap the weights in place (a peer warm-start); the slot caches
        are left as they are."""
        self.params = params
