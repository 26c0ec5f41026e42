"""Radix prefix cache: reuse KV rows across requests sharing a prompt prefix.

The port's copy of ``dlrover_tpu/serving/prefix_cache.py``. A token trie
over the prompts the engine has prefilled: a new request walks it, and on
a match the engine computes only the suffix rows against the cached
prefix stack (:meth:`BatchDecodeEngine.prefill_with_prefix`). Rows at
positions ``< m`` depend only on tokens ``< m`` under the causal mask, so
any donor prompt sharing the first ``m`` tokens holds the same rows there.

- **Exact token match only**: a hit can skip work, never change tokens.
- **Block-quantized match lengths**: reuse lengths are rounded down to
  ``DLROVER_TPU_SERVE_PREFIX_BLOCK`` (16), as in the reference.
- **LRU under a byte budget** (``DLROVER_TPU_SERVE_PREFIX_BYTES``, 64 MiB
  by default), with entries a prefill worker is reading pinned against
  eviction. An entry's payload is never written after it enters the trie
  (the engine copies it on insert and slices it on reuse), so an eviction
  cannot corrupt a reader; the pin is a hit-rate property.
- **Fallback is always the cold prefill**: the chaos site ``serve.prefix``
  fires on every reuse; an injected fault (or a real one) drops the
  entry and recomputes the whole prompt, so the failure mode is lost
  savings, never wrong tokens.

A reuse is journaled as ``serve_prefix_hit`` (with the tokens it saved)
and a dropped one as ``serve_prefix_dropped``, into the journal the
batcher attaches (the replica's own). The cache's resident bytes are its
claim in the memory ledger (``prefix_cache`` category,
``observability/memory.py``), synced after every insert, invalidation
and eviction.
"""

import threading
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common.constants import (
    ChaosSite,
    ConfigKey,
    MetricLabel,
    env_flag,
    env_int,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.journal import JournalEvent
from dlrover_tpu_torch.observability.memory import get_accountant
from dlrover_tpu_torch.observability.registry import get_registry

SERVE_PREFIX_SITE = ChaosSite.SERVE_PREFIX

_DEFAULT_BYTES = 64 * 1024 * 1024
_DEFAULT_BLOCK = 16


class _Node:
    """A trie node: children by next token, and the keys of every cached
    entry whose prompt passes through it."""

    __slots__ = ("children", "keys")

    def __init__(self):
        self.children: Dict[int, "_Node"] = {}
        self.keys: set = set()


class _Entry:
    __slots__ = ("payload", "real_len", "nbytes", "pins")

    def __init__(self, payload, real_len: int, nbytes: int):
        self.payload = payload
        self.real_len = real_len
        self.nbytes = nbytes
        self.pins = 0


class RadixPrefixCache:
    """Token trie + LRU over prefilled KV stacks. Thread-safe; the suffix
    prefill itself runs outside the lock, in the caller."""

    def __init__(self, max_bytes: Optional[int] = None,
                 block: Optional[int] = None):
        self.max_bytes = (max_bytes if max_bytes is not None
                          else env_int(ConfigKey.SERVE_PREFIX_BYTES,
                                       _DEFAULT_BYTES))
        self.block = max(1, block if block is not None
                         else env_int(ConfigKey.SERVE_PREFIX_BLOCK,
                                      _DEFAULT_BLOCK))
        self._lock = threading.Lock()
        self._root = _Node()
        # key (prompt tuple) -> _Entry; insertion order is recency order
        self._entries: Dict[Tuple[int, ...], _Entry] = {}
        self.bytes = 0
        self.evictions = 0
        self._ledger_name = f"prefix_cache/{id(self):x}"

    def _sync_ledger(self) -> None:
        get_accountant().adjust(
            MetricLabel.MEM_PREFIX_CACHE, self._ledger_name, self.bytes)

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: Sequence[int]):
        """Longest usable cached prefix of ``prompt`` → (m, key, payload)
        with the entry pinned (the caller must :meth:`unpin`), or (0,
        None, None). ``m`` is block-quantized and strictly inside the
        prompt (the last token's row must be computed for its logits)."""
        toks = tuple(prompt)
        with self._lock:
            node, depth, best = self._root, 0, 0
            best_keys: set = set()
            for t in toks:
                node = node.children.get(t)
                if node is None:
                    break
                depth += 1
                if node.keys:
                    best, best_keys = depth, node.keys
            m = (min(best, len(toks) - 1) // self.block) * self.block
            if m < self.block or not best_keys:
                return 0, None, None
            key = next(iter(best_keys))
            entry = self._entries.get(key)
            if entry is None:
                return 0, None, None
            entry.pins += 1
            del self._entries[key]  # LRU touch: move to the tail
            self._entries[key] = entry
            return m, key, entry.payload

    def unpin(self, key) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.pins > 0:
                entry.pins -= 1

    def insert(self, prompt: Sequence[int], payload, nbytes: int) -> None:
        toks = tuple(prompt)
        if len(toks) < self.block or nbytes > self.max_bytes:
            return  # too short to match a block, or larger than the budget
        with self._lock:
            if toks in self._entries:
                entry = self._entries.pop(toks)  # refresh payload and LRU
                self.bytes -= entry.nbytes
                self._remove_from_trie(toks)
            self._entries[toks] = _Entry(payload, len(toks), nbytes)
            self.bytes += nbytes
            node = self._root
            for t in toks:
                node = node.children.setdefault(t, _Node())
                node.keys.add(toks)
            self._evict_to_budget()
            self._sync_ledger()

    def invalidate(self, key) -> bool:
        """Drop one entry; True when it was resident."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self.bytes -= entry.nbytes
            self._remove_from_trie(key)
            self._sync_ledger()
            return True

    def _remove_from_trie(self, key) -> None:
        path = []
        node = self._root
        for t in key:
            child = node.children.get(t)
            if child is None:
                return
            path.append((node, t, child))
            node = child
        for parent, t, child in reversed(path):
            child.keys.discard(key)
            if not child.keys and not child.children:
                del parent.children[t]

    def _evict_to_budget(self) -> None:
        # oldest first, skipping pinned entries
        while self.bytes > self.max_bytes:
            victim = next(
                (k for k, e in self._entries.items() if e.pins == 0), None)
            if victim is None:
                return
            entry = self._entries.pop(victim)
            self.bytes -= entry.nbytes
            self._remove_from_trie(victim)
            self.evictions += 1


class PrefixCachingEngine:
    """The wrapped engine's interface, with ``prefill_rows`` routed through
    the radix cache; the batcher, router and replica take it unchanged."""

    def __init__(self, engine, cache: Optional[RadixPrefixCache] = None,
                 journal_fn: Optional[Callable] = None, registry=None):
        self._engine = engine
        # an empty cache is falsy (it has __len__): test against None
        self.cache = cache if cache is not None else RadixPrefixCache()
        self._journal_fn = journal_fn
        self.hits = 0
        self.misses = 0
        self.dropped = 0
        self.tokens_saved = 0
        reg = registry or get_registry()
        self._m_hits = reg.counter(
            "dlrover_serving_prefix_hits_total", "prefix-cache reuses")
        self._m_misses = reg.counter(
            "dlrover_serving_prefix_misses_total",
            "prefills with no usable cached prefix")
        self._m_evictions = reg.counter(
            "dlrover_serving_prefix_evictions_total",
            "entries evicted by the byte budget")
        self._m_saved = reg.counter(
            "dlrover_serving_prefix_tokens_saved_total",
            "prompt tokens whose prefill was skipped via reuse")
        self._m_dropped = reg.counter(
            "dlrover_serving_prefix_dropped_total",
            "reuse attempts abandoned (fault/corruption) → cold prefill")
        # the process's registry outlives the engine: the gauge reads it
        # through a weak reference, so that it does not hold the engine,
        # its weights and its cached prefixes after the engine's owner
        # lets go (ROADMAP C21)
        this = weakref.ref(self)
        reg.gauge(
            "dlrover_serving_prefix_bytes", "resident cached prefix bytes",
        ).set_function(lambda: float(this().cache.bytes)
                       if this() is not None else 0.0)
        self._evicted_seen = 0

    def __getattr__(self, name):
        # slots / cache_len / insert / step / set_params / params / device
        return getattr(self._engine, name)

    def attach_journal(self, journal_fn: Callable) -> None:
        """Journal hits and drops through ``journal_fn(kind, **data)``."""
        self._journal_fn = journal_fn

    def _record(self, kind: str, **data) -> None:
        if self._journal_fn is not None:
            self._journal_fn(kind, **data)

    def prefill_rows(self, prompt: Sequence[int], bucket_len: int):
        m, key, payload = self.cache.lookup(prompt)
        result = None
        if m:
            try:
                result = self._reuse(prompt, bucket_len, key, payload, m)
            finally:
                self.cache.unpin(key)
        if result is None:
            result = self._cold(prompt, bucket_len)
        entry_payload, nbytes = self._engine.prefix_entry(result)
        self.cache.insert(prompt, entry_payload, nbytes)
        new_ev = self.cache.evictions - self._evicted_seen
        if new_ev:
            self._evicted_seen = self.cache.evictions
            self._m_evictions.inc(new_ev)
        return result

    def _cold(self, prompt, bucket_len):
        self.misses += 1
        self._m_misses.inc()
        return self._engine.prefill_rows(prompt, bucket_len)

    def _reuse(self, prompt, bucket_len, key, payload, m):
        inj = get_injector()
        try:
            if inj is not None:
                # torn/bitflip return an action (simulated corruption of
                # the cached rows), error kinds raise: either way the entry
                # is dropped and the request pays the full prefill
                action = inj.fire(SERVE_PREFIX_SITE, matched=m,
                                  prompt_len=len(prompt))
                if action is not None:
                    raise RuntimeError(f"injected corruption: {action}")
            result = self._engine.prefill_with_prefix(
                prompt, bucket_len, payload, m)
        except Exception as e:  # noqa: BLE001 — any reuse failure falls
            # back to the cold prefill, never to a failed request
            self.cache.invalidate(key)
            self.dropped += 1
            self._m_dropped.inc()
            self._record(JournalEvent.SERVE_PREFIX_DROPPED,
                         matched=m, prompt_len=len(prompt), error=repr(e))
            logger.warning("prefix reuse dropped (m=%s): %r", m, e)
            return None
        self.hits += 1
        self.tokens_saved += m
        self._m_hits.inc()
        self._m_saved.inc(m)
        self._record(JournalEvent.SERVE_PREFIX_HIT, matched=m,
                     prompt_len=len(prompt), saved_tokens=m)
        return result

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "dropped": self.dropped,
            "hit_rate": self.hits / total if total else 0.0,
            "tokens_saved": self.tokens_saved,
            "entries": len(self.cache),
            "bytes": self.cache.bytes,
            "evictions": self.cache.evictions,
        }


def maybe_wrap_prefix_cache(engine, enabled: Optional[bool] = None,
                            **kwargs):
    """The engine wrapped when ``enabled`` (default
    ``DLROVER_TPU_SERVE_PREFIX``), else the engine itself."""
    if enabled is None:
        enabled = env_flag(ConfigKey.SERVE_PREFIX, False)
    return PrefixCachingEngine(engine, **kwargs) if enabled else engine
