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
function of its prompt, so a router can replay it elsewhere).

MoE params run here too (``models/decode.py``'s ``ffn``), routed as the
JAX engine routes them: the bucket-padded prompt is one routing group, so
its pads claim expert capacity like real tokens and the bucket sets the
capacity (a prompt's first token can depend on its bucket); the suffix
prefill routes the suffix alone; a step routes each slot's token alone,
where nothing drops.

The prefix-cache surface (``serving/prefix_cache.py``):
:meth:`BatchDecodeEngine.prefix_entry` hands the trie a prefill's k/v row
stacks, and :meth:`BatchDecodeEngine.prefill_with_prefix` computes only a
prompt's suffix against ``m`` cached rows. A trie payload is never written
after it enters the trie (the JAX engine gets that from immutable arrays):
:meth:`insert` copies the rows into the slot cache, and the suffix prefill
only slices and concatenates them.

:func:`export_params` / :func:`import_params` carry weights between
replicas in the JAX package's blob format, so a port replica and a JAX
replica warm-start from each other. :class:`ToyEngine` (pure host code)
backs the batcher and router tests.

The slot caches are the engine's ``kv_cache`` claim in the memory ledger
(``observability/memory.py``; their exact bytes, :meth:`kv_cache_bytes`).
Every call notes its shape key — ``("prefill", bucket)``,
``("prefill_sfx", bucket, m)``, ``("insert", bucket)``, ``("step",)`` —
in the compile watch (``observability/compile_watch.py``) as the function
``engine.<kind>`` with structured dims; the first call of a key is timed
as its miss (the eager engine compiles nothing, but that call pays the
new shapes' cuBLAS heuristics, lazy module loads and allocator growth).
:attr:`compile_count` is the number of distinct keys.
"""

import re
import threading
import time
from dataclasses import dataclass
from typing import Any, List, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.common import msgpack
from dlrover_tpu_torch.common.constants import MetricLabel
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.convert import named_leaves
from dlrover_tpu_torch.models.decode import (
    _attend,
    _dequantize,
    _qkv,
    _quantize,
    ffn,
    flash_decode_wanted,
    forward_window,
)
from dlrover_tpu_torch.models.llama import (
    LlamaConfig,
    init_params,
    layer_params,
    rms_norm,
)
from dlrover_tpu_torch.observability.compile_watch import get_watcher
from dlrover_tpu_torch.observability.memory import get_accountant


def _shape_sig(key):
    """An engine shape key as a compile-watch signature: (fn, structured
    dims), the dims what lets the watch attribute a storm (ragged buckets
    → seq_len)."""
    name = key[0]
    dims = {}
    if name in ("prefill", "insert") and len(key) > 1:
        dims["bucket"] = key[1]
    elif name == "prefill_sfx" and len(key) > 2:
        dims["bucket"], dims["prefix_len"] = key[1], key[2]
    return f"engine.{name}", dims


@dataclass
class PrefillResult:
    """Output of a pure prefill: what :meth:`insert` commits to a slot."""

    first_token: int
    real_len: int
    bucket_len: int
    # (L, KV, P, Dh) k and v row stacks in the model dtype
    payload: Any = None


class ToyEngine:
    """Deterministic stand-in engine (no model): token ``i`` of a sequence
    is a fixed integer function of (prompt, i), so two replicas given the
    same request produce the same tokens, while a batcher step costs
    microseconds. The JAX package's ``ToyEngine``, token for token."""

    def __init__(self, slots: int = 4, vocab: int = 97,
                 cache_len: int = 1024, prefill_delay_s: float = 0.0,
                 step_delay_s: float = 0.0):
        self.slots = slots
        self.cache_len = cache_len
        self._vocab = vocab
        self._prefill_delay_s = prefill_delay_s
        self._step_delay_s = step_delay_s
        self._seeds = [0] * slots
        self._counts = [0] * slots
        self._shapes_lock = threading.Lock()
        self._shapes = set()
        # nominal KV residency (16 bytes a token, the prefix_entry rate),
        # so toy-backed fleet tests exercise the same ledger
        get_accountant().register(
            MetricLabel.MEM_KV_CACHE, f"toy_engine/{id(self):x}/kv",
            16 * slots * cache_len)

    @property
    def compile_count(self) -> int:
        """Distinct (kind, bucket) shapes seen, the JAX engine's traced-
        shape count."""
        with self._shapes_lock:
            return len(self._shapes)

    def _note_shape(self, key) -> None:
        with self._shapes_lock:
            self._shapes.add(key)
        fn, dims = _shape_sig(key)
        get_watcher().note(fn, **dims)

    @staticmethod
    def _seed(prompt: Sequence[int]) -> int:
        return (sum(prompt) * 1000003 + len(prompt)) & 0x7FFFFFFF

    def _token(self, seed: int, i: int) -> int:
        return (seed * 31 + 7 + i * 17) % self._vocab

    def prefill_rows(self, prompt: Sequence[int],
                     bucket_len: int) -> PrefillResult:
        if self._prefill_delay_s:
            time.sleep(self._prefill_delay_s)
        self._note_shape(("prefill", bucket_len))
        seed = self._seed(prompt)
        return PrefillResult(first_token=self._token(seed, 0),
                             real_len=len(prompt), bucket_len=bucket_len,
                             payload=seed)

    def prefix_entry(self, result: PrefillResult):
        """(payload, nominal byte cost): the seed, and 16 bytes a token so
        the prefix cache's byte budget is exercised."""
        return result.payload, 16 * result.real_len

    def prefill_with_prefix(self, prompt: Sequence[int], bucket_len: int,
                            entry, m: int) -> PrefillResult:
        """The outputs of :meth:`prefill_rows` (the seed depends on the
        whole prompt), with the simulated cost scaled to the suffix."""
        del entry
        if not 1 <= m < len(prompt):
            raise ValueError(f"matched length {m} outside [1, prompt)")
        if self._prefill_delay_s:
            time.sleep(self._prefill_delay_s * (len(prompt) - m)
                       / len(prompt))
        self._note_shape(("prefill_sfx", bucket_len, m))
        seed = self._seed(prompt)
        return PrefillResult(first_token=self._token(seed, 0),
                             real_len=len(prompt), bucket_len=bucket_len,
                             payload=seed)

    def insert(self, result: PrefillResult, slot: int) -> int:
        self._seeds[slot] = result.payload
        self._counts[slot] = 1
        return result.first_token

    def step(self, tokens: Sequence[int],
             active: Sequence[bool]) -> List[int]:
        del tokens  # the recurrence carries its own state
        if self._step_delay_s:
            time.sleep(self._step_delay_s)
        self._note_shape(("step",))
        out = []
        for s in range(self.slots):
            if active[s]:
                i = self._counts[s]
                self._counts[s] += 1
                out.append(self._token(self._seeds[s], i))
            else:
                out.append(0)
        return out


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
        self._shapes_lock = threading.Lock()
        self._shapes = set()
        # the slot caches' exact bytes are the engine's kv_cache claim
        get_accountant().register(
            MetricLabel.MEM_KV_CACHE, f"engine/{id(self):x}/kv",
            self.kv_cache_bytes())

    @property
    def compile_count(self) -> int:
        """Distinct shape keys called so far."""
        with self._shapes_lock:
            return len(self._shapes)

    def _note_shape(self, key):
        """Note ``key`` and return the compile watch's timer: the first
        call of a key is timed as its miss."""
        with self._shapes_lock:
            if key not in self._shapes:
                self._shapes.add(key)
                logger.info("serving engine: first call of %s", key)
        fn, dims = _shape_sig(key)
        return get_watcher().time(fn, **dims)

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
            x = x + ffn(rms_norm(x, layer["ffn_norm"], c.norm_eps), layer, c)
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
        with self._note_shape(("prefill", bucket_len)):
            first, ks, vs = self._prefill(tokens, len(prompt))
        return PrefillResult(
            first_token=first,
            real_len=len(prompt),
            bucket_len=bucket_len,
            payload=(ks, vs),
        )

    # -- prefix-cache surface (serving/prefix_cache.py) ---------------------

    def prefix_entry(self, result: PrefillResult):
        """(trie payload, byte cost) of a finished prefill: its k/v row
        stacks, which nothing writes afterwards."""
        ks, vs = result.payload
        return result.payload, int(ks.numel() * ks.element_size()
                                   + vs.numel() * vs.element_size())

    @torch.no_grad()
    def _prefill_suffix(self, tokens, real_len: int, pre_k, pre_v):
        """Positions ``[m, P)`` forward against the cached rows ``pre_k``/
        ``pre_v`` ``(L, KV, m, Dh)``: the first token and the full ``(L, KV,
        P, Dh)`` stacks a cold prefill of the bucket gives (the suffix
        queries see the concatenated keys under the cold mask's rows)."""
        c = self.config
        S = tokens.shape[0]
        m = pre_k.shape[2]
        ks, vs = [], []

        def concat_rows(li, k_new, v_new):             # k/v (1, KV, S, Dh)
            k_full = torch.cat([pre_k[li][None], k_new], dim=2)
            v_full = torch.cat([pre_v[li][None], v_new], dim=2)
            ks.append(k_full[0].to(c.dtype))
            vs.append(v_full[0].to(c.dtype))
            return k_full, v_full

        qpos = m + torch.arange(S, device=self.device)
        x = forward_window(self.params, tokens[None], c, qpos, m + S,
                           concat_rows)
        logits = (x[0, real_len - 1 - m] @ self.params["lm_head"]).float()
        first = int(torch.argmax(logits))
        return first, torch.stack(ks), torch.stack(vs)

    def prefill_with_prefix(self, prompt: Sequence[int], bucket_len: int,
                            entry, m: int) -> PrefillResult:
        """Prefill reusing ``m`` cached rows (``entry``: the trie's (ks,
        vs) stacks of a prompt sharing our first ``m`` tokens); only
        positions ``[m, bucket_len)`` are computed. Needs
        ``1 <= m < len(prompt)``."""
        if not 1 <= m < len(prompt):
            raise ValueError(f"matched length {m} outside [1, prompt)")
        if len(prompt) > bucket_len or bucket_len > self.cache_len:
            raise ValueError(
                f"prompt {len(prompt)} / bucket {bucket_len} exceed "
                f"cache length {self.cache_len}")
        pre_ks, pre_vs = entry
        padded = list(prompt) + [0] * (bucket_len - len(prompt))
        tokens = torch.tensor(padded[m:], dtype=torch.int64,
                              device=self.device)
        with self._note_shape(("prefill_sfx", bucket_len, m)):
            first, ks, vs = self._prefill_suffix(
                tokens, len(prompt), pre_ks[:, :, :m], pre_vs[:, :, :m])
        return PrefillResult(first_token=first, real_len=len(prompt),
                             bucket_len=bucket_len, payload=(ks, vs))

    # -- decode-thread state commits ---------------------------------------

    def insert(self, result: PrefillResult, slot: int) -> int:
        """Write the whole bucket's rows (the tail past ``real_len`` too)
        into ``slot`` and set its position to ``real_len``."""
        with self._note_shape(("insert", result.bucket_len)):
            return self._insert(result, slot)

    @torch.no_grad()
    def _insert(self, result: PrefillResult, slot: int) -> int:
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

    def step(self, tokens: Sequence[int],
             active: Sequence[bool]) -> List[int]:
        """One decode step for every slot; returns each slot's next greedy
        token (inactive slots' tokens are meaningless). Only active slots
        advance."""
        with self._note_shape(("step",)):
            return self._step(tokens, active)

    @torch.no_grad()
    def _step(self, tokens: Sequence[int],
              active: Sequence[bool]) -> List[int]:
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
            x = x + ffn(rms_norm(x, layer["ffn_norm"], c.norm_eps), layer, c)
        x = rms_norm(x, params["final_norm"], c.norm_eps)
        logits = (x[:, 0] @ params["lm_head"]).float()
        nxt = torch.argmax(logits, dim=-1)
        self._pos += act.to(torch.int32)
        return [int(t) for t in nxt.tolist()]

    def set_params(self, params) -> None:
        """Swap the weights in place (a peer warm-start); the slot caches
        are left as they are."""
        self.params = params


# -- weights between replicas -------------------------------------------------
#
# The JAX package's blob: one msgpack map ``{keystr path: {"dtype": numpy
# dtype str, "shape": [...], "data": raw bytes}}`` in jax's flatten order
# (sorted keys). numpy names bfloat16 ``'<V2'`` (a 2-byte void), and the
# JAX ``import_params`` cannot read that back; the port writes the same
# bytes and reads ``V2`` as bf16, the only 2-byte void a params tree here
# holds.

_BF16_STRS = ("<V2", "|V2")


def _dtype_str(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "<V2"
    return np.dtype(str(t.dtype).removeprefix("torch.")).str


def export_params(params) -> bytearray:
    """The params tree as one blob in the JAX package's format (byte for
    byte what its ``export_params`` writes for the same values), laid out
    straight into one buffer: leaves are copied to the host one at a time,
    so the host holds the blob and one leaf."""
    leaves = named_leaves(params)
    heads, datas = [], []
    for name, leaf in leaves:
        nbytes = leaf.numel() * leaf.element_size()
        heads.append(
            msgpack.packb(name) + msgpack.map_header(3)
            + msgpack.packb("dtype") + msgpack.packb(_dtype_str(leaf))
            + msgpack.packb("shape") + msgpack.packb(list(leaf.shape))
            + msgpack.packb("data") + msgpack.bin_header(nbytes))
        datas.append(nbytes)
    top = msgpack.map_header(len(leaves))
    out = bytearray(len(top) + sum(map(len, heads)) + sum(datas))
    out[:len(top)] = top
    pos = len(top)
    for (_, leaf), head, nbytes in zip(leaves, heads, datas):
        out[pos:pos + len(head)] = head
        pos += len(head)
        host = leaf.detach().contiguous().cpu()
        if host.dtype == torch.bfloat16:
            host = host.view(torch.int16)
        np.frombuffer(out, np.uint8, nbytes, pos)[:] = (
            host.numpy().reshape(-1).view(np.uint8))
        pos += nbytes
    return out


def import_params(blob, device="cuda"):
    """Inverse of :func:`export_params` (and reader of the JAX package's
    blobs, bf16 included): the nested-dict params tree on ``device``."""
    dev = resolve_device(device)
    tree: dict = {}
    for path, spec in msgpack.unpackb(blob, copy_bin=False).items():
        keys = re.findall(r"\['([^']*)'\]", path)
        if not keys:
            raise ValueError(f"unsupported params path {path!r}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        bf16 = spec["dtype"] in _BF16_STRS
        arr = np.frombuffer(spec["data"], np.uint16 if bf16
                            else np.dtype(spec["dtype"]))
        arr = arr.reshape(spec["shape"])
        if dev.type == "cpu" or not arr.flags.writeable:
            arr = arr.copy()  # the tensor must own its memory
        t = torch.from_numpy(arr)
        node[keys[-1]] = (t.view(torch.bfloat16) if bf16 else t).to(dev)
    return tree


def tiny_config(cache_len: int = 48, vocab: int = 32, dim: int = 16,
                n_layers: int = 2, n_heads: int = 2, n_kv_heads: int = 1,
                dtype=None) -> LlamaConfig:
    """The JAX ``build_tiny_engine``'s model: f32 unless ``dtype``."""
    return LlamaConfig(
        vocab_size=vocab, dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv_heads, ffn_dim=4 * dim, max_seq_len=cache_len,
        dtype=dtype if dtype is not None else torch.float32, remat=False,
    )


def build_tiny_engine(slots: int = 4, cache_len: int = 48,
                      vocab: int = 32, dim: int = 16, n_layers: int = 2,
                      n_heads: int = 2, n_kv_heads: int = 1,
                      seed: int = 0, quantize: bool = False,
                      dtype=None, device="cuda") -> BatchDecodeEngine:
    """A small engine whose params are drawn from ``seed`` (a
    ``torch.Generator`` on ``device``): every engine built from the same
    seed on the same device holds the same weights. The JAX
    ``build_tiny_engine``'s shapes; the values differ, the generators do."""
    dev = resolve_device(device)
    config = tiny_config(cache_len, vocab, dim, n_layers, n_heads,
                         n_kv_heads, dtype)
    params = init_params(
        config, torch.Generator(device=dev).manual_seed(seed), dev)
    return BatchDecodeEngine(params, config, slots=slots,
                             cache_len=cache_len, quantize=quantize,
                             device=dev)
