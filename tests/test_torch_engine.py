"""The port's batched decode engine against the JAX package's.

Both engines get the same JAX params (f32) and the same schedule of
requests, staggered so that slots sit at ragged positions and a finished
slot is reused. Every token of every active slot must be exactly equal,
for the f32 and the int8 cache, and so must ``kv_cache_bytes``. The port's
step is also driven through the decode kernel's route (its plain version on
the CPU, one position per slot), which the JAX engine takes only for slots
in lockstep: the tokens must not change.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.serving import engine as je  # noqa: E402
from dlrover_tpu_torch.convert import params_from_jax  # noqa: E402
from dlrover_tpu_torch.models import decode as td  # noqa: E402
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.serving import engine as te  # noqa: E402

SLOTS, CACHE_LEN = 3, 48


def _engines(quantize):
    jc = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=64),
                             dtype=jnp.float32, max_seq_len=CACHE_LEN)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=64),
                             dtype=torch.float32, max_seq_len=CACHE_LEN)
    params = jl.init_params(jc, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    jeng = je.BatchDecodeEngine(params, jc, slots=SLOTS,
                                cache_len=CACHE_LEN, quantize=quantize)
    teng = te.BatchDecodeEngine(tparams, tc, slots=SLOTS,
                                cache_len=CACHE_LEN, quantize=quantize,
                                device="cpu")
    return jeng, teng


# (admit at step, prompt length, bucket, new tokens)
_SCHEDULE = [(0, 6, 8, 9), (2, 11, 16, 7), (3, 3, 8, 12), (9, 13, 16, 6)]


def _serve(engine):
    """Run the schedule; returns each request's tokens and, per step, the
    slots' positions (to show they were ragged)."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 64, n).tolist() for _, n, _, _ in _SCHEDULE]
    active = [None] * SLOTS  # slot -> [request index, tokens]
    done = {}
    pending = list(range(len(_SCHEDULE)))
    step = 0
    while pending or any(a is not None for a in active):
        for s in range(SLOTS):
            if (active[s] is None and pending
                    and _SCHEDULE[pending[0]][0] <= step):
                r = pending.pop(0)
                res = engine.prefill_rows(prompts[r], _SCHEDULE[r][2])
                active[s] = [r, [engine.insert(res, s)]]
        live = [a is not None for a in active]
        if any(live):
            nxt = engine.step([a[1][-1] if a else 0 for a in active], live)
            for s, a in enumerate(active):
                if a is None:
                    continue
                a[1].append(nxt[s])
                if len(a[1]) == _SCHEDULE[a[0]][3]:
                    done[a[0]] = a[1]
                    active[s] = None
        step += 1
    return [done[r] for r in range(len(_SCHEDULE))], prompts


@pytest.mark.parametrize("quantize", [False, True])
def test_engine_tokens_match_jax_on_ragged_slots(quantize):
    jeng, teng = _engines(quantize)
    assert teng.kv_cache_bytes() == jeng.kv_cache_bytes()
    assert teng.kv_bytes_per_slot == jeng.kv_bytes_per_slot
    ref, _ = _serve(jeng)
    out, _ = _serve(teng)
    assert out == ref


@pytest.mark.parametrize("quantize", [False, True])
def test_engine_kernel_route_keeps_tokens(quantize, monkeypatch):
    """With the decode-kernel route forced (per-slot positions in one
    call), the port's tokens still equal the JAX engine's einsum path."""
    jeng, _ = _engines(quantize)
    monkeypatch.setattr(te, "flash_decode_wanted", lambda *a, **k: True)
    _, teng = _engines(quantize)
    assert teng._flash
    ref, _ = _serve(jeng)
    out, _ = _serve(teng)
    assert out == ref


@pytest.mark.parametrize("quantize", [False, True])
def test_engine_matches_port_generate(quantize):
    """One slot alone reproduces the port's own greedy generate."""
    _, teng = _engines(quantize)
    prompt = [5, 9, 2, 7, 11, 3]
    toks = [teng.insert(teng.prefill_rows(prompt, 8), 0)]
    for _ in range(9):
        toks.append(teng.step([toks[-1], 0, 0], [True, False, False])[0])
    ref = td.generate(teng.params, torch.tensor([prompt]), teng.config, None,
                      10, temperature=0.0, quantize_cache=quantize,
                      max_len=CACHE_LEN)
    assert toks == ref[0, len(prompt):].tolist()


def test_prefill_rows_validates_lengths():
    _, teng = _engines(False)
    with pytest.raises(ValueError, match="exceeds bucket"):
        teng.prefill_rows(list(range(1, 10)), 8)
    with pytest.raises(ValueError, match="exceeds cache length"):
        teng.prefill_rows([1, 2], 64)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kernel_route", [False, True])
def test_slot_past_cache_end_leaves_live_slots(quantize, kernel_route,
                                               monkeypatch):
    """A slot whose prompt fills all but the last cache row steps on past
    the end (pos == cache_len, then beyond) beside live slots. The JAX
    engine's write clamps to row T - 1 of that slot; the port's must do the
    same: the live slots' tokens equal the JAX engine's, and so do the
    overflowing slot's, on the dense and the kernel route."""
    jeng, _ = _engines(quantize)
    if kernel_route:
        monkeypatch.setattr(te, "flash_decode_wanted", lambda *a, **k: True)
    _, teng = _engines(quantize)
    assert teng._flash == kernel_route
    rng = np.random.default_rng(5)
    # (slot, prompt length, bucket): slot 0 fills CACHE_LEN - 1 rows
    admits = [(0, CACHE_LEN - 1, CACHE_LEN), (1, 5, 8), (2, 10, 16)]
    prompts = [rng.integers(1, 64, n).tolist() for _, n, _ in admits]

    def serve(engine):
        last = [0] * SLOTS
        for (slot, _, bucket), prompt in zip(admits, prompts):
            last[slot] = engine.insert(engine.prefill_rows(prompt, bucket),
                                       slot)
        steps = []
        for _ in range(4):  # slot 0 writes at 47, then 48, 49, 50
            last = engine.step(last, [True] * SLOTS)
            steps.append(last)
        return steps

    ref = serve(jeng)
    out = serve(teng)
    assert int(teng._pos[0]) == CACHE_LEN + 3
    assert [s[1:] for s in out] == [s[1:] for s in ref]  # live slots
    assert [s[0] for s in out] == [s[0] for s in ref]    # the overflowing one

