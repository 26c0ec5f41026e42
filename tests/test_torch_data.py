"""The port's sampler, loader and ``stack_microbatches`` against the JAX
package's: the same indices and the same numpy batches for the same seed,
resume offset and replica count (both are host-side numpy, so exactly)."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from dlrover_tpu.trainer import data as jd  # noqa: E402
from dlrover_tpu_torch.trainer import data as td  # noqa: E402


@pytest.mark.parametrize("replicas", [1, 3])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("completed", [0, 7])
def test_sampler_yields_jax_indices(replicas, drop_last, completed):
    for rank in range(replicas):
        samplers = []
        for mod in (jd, td):
            s = mod.ElasticDistributedSampler(
                50, num_replicas=replicas, rank=rank, shuffle=True, seed=3,
                drop_last=drop_last)
            s.load_state_dict({"epoch": 2, "completed": completed})
            samplers.append(s)
        ref, got = samplers
        assert list(got) == list(ref)
        assert len(got) == len(ref)
        ref.record_batch(16)
        got.record_batch(16)
        assert got.state_dict() == ref.state_dict()


def test_sampler_rejects_rank_past_replicas():
    with pytest.raises(ValueError, match="rank"):
        td.ElasticDistributedSampler(10, num_replicas=2, rank=2)


def _dataset(n=40, seq=9):
    return np.random.default_rng(0).integers(
        0, 100, (n, seq)).astype(np.int32)


def test_loader_batches_and_microbatch_stack_match_jax():
    data = _dataset()
    out = []
    for mod in (jd, td):
        sampler = mod.ElasticDistributedSampler(len(data), seed=1)
        sampler.load_state_dict({"epoch": 0, "completed": 4})
        batches = list(mod.ElasticDataLoader(data, batch_size=4,
                                             sampler=sampler))
        out.append((batches, mod.stack_microbatches(batches[:2])))
    (ref, ref_stack), (got, got_stack) = out
    assert len(got) == len(ref) == 9
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got_stack.shape == (2, 4, 9)
    np.testing.assert_array_equal(got_stack, np.asarray(ref_stack))


def test_collate_and_stack_keep_dict_and_tuple_samples():
    data = _dataset(8, 3)
    dicts = [{"x": r, "y": r * 2} for r in data]
    tuples = [(r, r + 1) for r in data]
    for samples in (dicts, tuples):
        ref = [jd._default_collate(samples[i:i + 2]) for i in (0, 2)]
        got = [td._default_collate(samples[i:i + 2]) for i in (0, 2)]
        ref_stack = jd.stack_microbatches(ref)
        got_stack = td.stack_microbatches(got)
        if isinstance(ref_stack, dict):
            assert set(got_stack) == set(ref_stack)
            for k in ref_stack:
                np.testing.assert_array_equal(got_stack[k], ref_stack[k])
        else:
            assert type(got_stack) is type(ref_stack)
            for a, b in zip(got_stack, ref_stack):
                np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("cfg,want", [
    ({"dataloader_batch_size": 3}, 3),
    ({"micro_batch_scale": 0.5}, 2),
    ({"dataloader_batch_size": 0}, 4),
])
def test_loader_reloads_batch_size_from_config_file(tmp_path, cfg, want):
    path = tmp_path / "paral.json"
    path.write_text(json.dumps(cfg))
    os.utime(path, (1e9, 1e9))
    data = _dataset(12)
    sizes = []
    for mod in (jd, td):
        loader = mod.ElasticDataLoader(data, batch_size=4,
                                       config_file=str(path))
        sizes.append([len(b) for b in loader])
    assert sizes[1] == sizes[0]
    assert sizes[1][0] == want


def test_loader_reads_config_file_from_env(tmp_path, monkeypatch):
    path = tmp_path / "paral.json"
    path.write_text(json.dumps({"dataloader_batch_size": 5}))
    monkeypatch.setenv("DLROVER_TPU_PARAL_CONFIG_FILE", str(path))
    loader = td.ElasticDataLoader(_dataset(10), batch_size=2)
    assert [len(b) for b in loader] == [5, 5]
