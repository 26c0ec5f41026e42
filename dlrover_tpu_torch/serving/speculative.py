"""Draft-and-verify speculative decoding over the stock decode path.

The port's copy of ``dlrover_tpu/serving/speculative.py``. A draft model
proposes ``k`` greedy tokens one step at a time; the target verifies all
of them in one :func:`models.decode.decode_window` step over
``[last, d_1 … d_k]``, which gives the target's own greedy continuation
``g_1 … g_{k+1}``. The longest matching prefix of the draft is accepted,
plus one token of the target's: the correction at the first mismatch, or
the bonus ``g_{k+1}`` when every draft matched.

Every emitted token is the target's argmax given the tokens before it, so
the output equals stock greedy decoding of the target; the draft moves
only the speed (tokens per target window). Each round rewinds both caches
to the last accepted position by setting ``pos`` back: the rows past it,
written by rejected drafts, are hidden by the ``pos`` mask until the next
window overwrites them.

Each verify is a ``serve.spec_verify`` span carrying ``k`` and the
drafts it accepted; it closes after the target's tokens are read back,
so on the card it times the window's device work.
"""

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.common.constants import ConfigKey, SpanName, env_int
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models import decode
from dlrover_tpu_torch.models.llama import LlamaConfig, init_params
from dlrover_tpu_torch.observability import tracing

_DEFAULT_K = 4


class SpeculativeDecoder:
    """One target/draft pair on the device their params live on;
    :meth:`generate` runs greedy speculative decoding of one sequence.
    Concurrent calls are safe: each owns its caches."""

    def __init__(self, target_params, target_config, draft_params,
                 draft_config, k: Optional[int] = None,
                 quantize: bool = False):
        if target_config.vocab_size != draft_config.vocab_size:
            raise ValueError(
                "target and draft must share a vocabulary "
                f"({target_config.vocab_size} vs {draft_config.vocab_size})")
        self.k = max(1, k if k is not None
                     else env_int(ConfigKey.SERVE_SPEC_K, _DEFAULT_K))
        self._tp = target_params
        self._dp = draft_params
        self._tc = target_config
        self._dc = draft_config
        self._quantize = quantize
        self.device = target_params["tok_embed"].device
        self._lock = threading.Lock()
        # request_id -> that request's acceptance stats
        self.sessions: Dict[str, Dict] = {}

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 request_id: str = "") -> Tuple[List[int], Dict]:
        """Greedy speculative generation → (tokens, stats); the tokens
        equal ``decode.generate(..., temperature=0)`` of the target, and
        ``stats['mean_accepted']`` is the tokens emitted per window."""
        dev = self.device
        P = len(prompt)
        k = self.k
        # a window writes up to k + 1 rows past the current position
        max_len = P + max_new_tokens + k + 1
        prompt_arr = torch.tensor([list(prompt)], dtype=torch.int64,
                                  device=dev)
        t_logits, t_cache = decode.prefill(self._tp, prompt_arr, self._tc,
                                           max_len, quantize=self._quantize)
        _, d_cache = decode.prefill(self._dp, prompt_arr, self._dc,
                                    max_len, quantize=self._quantize)
        tokens = [int(torch.argmax(t_logits[0]))]
        rounds = drafted = accepted = 0
        while len(tokens) < max_new_tokens:
            last = tokens[-1]
            # k drafts; the (k+1)-th step only writes d_k's row, which the
            # next round attends when every draft is accepted
            drafts: List[int] = []
            cur = last
            for i in range(k + 1):
                lg, d_cache = decode.decode_step(
                    self._dp, torch.tensor([cur], device=dev), d_cache,
                    self._dc)
                if i < k:
                    cur = int(torch.argmax(lg[0]))
                    drafts.append(cur)
            t_pos = int(t_cache["pos"])
            window = torch.tensor([[last] + drafts], device=dev)
            with tracing.span(SpanName.SERVE_SPEC_VERIFY,
                              source="speculative",
                              request_id=request_id) as vspan:
                wl, t_cache = decode.decode_window(self._tp, window,
                                                   t_cache, self._tc)
                greedy = torch.argmax(wl[0], dim=-1).tolist()
                a = 0
                while a < k and drafts[a] == greedy[a]:
                    a += 1
                vspan.attrs.update(k=k, accepted=a)
            tokens.extend(drafts[:a] + [greedy[a]])
            rounds += 1
            drafted += k
            accepted += a
            # rewind: rows are valid through the last accepted token
            t_cache["pos"] = d_cache["pos"] = t_pos + 1 + a
        tokens = tokens[:max_new_tokens]
        stats = {
            "rounds": rounds,
            "drafted": drafted,
            "accepted": accepted,
            "acceptance_rate": accepted / drafted if drafted else 0.0,
            "mean_accepted": ((len(tokens) - 1) / rounds
                              if rounds else 0.0),
        }
        if request_id:
            with self._lock:
                self.sessions[request_id] = stats
        return tokens, stats


def build_tiny_spec_pair(vocab: int = 32, cache_len: int = 64,
                         seed: int = 0, k: Optional[int] = None,
                         quantize: bool = False,
                         device="cuda") -> SpeculativeDecoder:
    """A small target/draft pair sharing a vocabulary (the JAX
    ``build_tiny_spec_pair``'s shapes): the target is the tiny serving
    model, the draft a half-width one-layer sibling; weights from
    ``torch.Generator`` seeds ``seed`` and ``seed + 1`` on ``device``."""
    dev = resolve_device(device)
    target_config = LlamaConfig(
        vocab_size=vocab, dim=16, n_layers=2, n_heads=2, n_kv_heads=1,
        ffn_dim=64, max_seq_len=cache_len, dtype=torch.float32, remat=False,
    )
    draft_config = LlamaConfig(
        vocab_size=vocab, dim=8, n_layers=1, n_heads=1, n_kv_heads=1,
        ffn_dim=32, max_seq_len=cache_len, dtype=torch.float32, remat=False,
    )
    target_params = init_params(
        target_config, torch.Generator(device=dev).manual_seed(seed), dev)
    draft_params = init_params(
        draft_config, torch.Generator(device=dev).manual_seed(seed + 1), dev)
    return SpeculativeDecoder(target_params, target_config, draft_params,
                              draft_config, k=k, quantize=quantize)
