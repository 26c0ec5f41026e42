"""The port's mesh and sharding against the JAX package's.

For each leaf of ``param_logical_axes`` and each plan (fsdp 8, dp 2 ×
fsdp 4, tp 2 × fsdp 4), the region the port gives the rank at each mesh
coordinate (``parallel.sharding.region_for`` over ``valid_spec_for``)
equals the region the JAX package's device at the same coordinate holds
(``ckpt.reshard.needs_from_state`` on the 8-device virtual CPU mesh).
Then 4 gloo ranks (tp 2 × fsdp 2) hold those regions as DTensor locals and
take the same 3 train steps as one plain process.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.ckpt.reshard import needs_from_state  # noqa: E402
from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.parallel import mesh as jmesh  # noqa: E402
from dlrover_tpu.parallel import sharding as jsharding  # noqa: E402
from dlrover_tpu_torch.convert import (  # noqa: E402
    jax_leaf_name,
    named_leaves,
)
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as tsharding  # noqa: E402

PLANS = {"fsdp8": dict(n=8), "dp2_fsdp4": dict(n=8, dp=2),
         "tp2_fsdp4": dict(n=8, tp=2)}
# the tiny shapes, and odd ones some axes do not divide (replicated then)
CONFIGS = {
    "tiny": dict(),
    "odd": dict(vocab_size=250, dim=48, n_heads=4, n_kv_heads=2,
                ffn_dim=100, n_layers=3),
}


def _ranks_module():
    spec = importlib.util.spec_from_file_location(
        "torch_ranks", os.path.join(os.path.dirname(__file__), "data",
                                    "torch_ranks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_regions(plan, config, n):
    """{leaf name: {device id: (start, shape)}} on the virtual CPU mesh."""
    mesh = jmesh.build_mesh(plan, jax.devices()[:n])
    params = jl.init_params(config, jax.random.PRNGKey(0))
    state = jsharding.shard_tree(mesh, {"params": params},
                                 {"params": jl.param_logical_axes(config)})
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        per_dev = {}
        for dev, index in leaf.sharding.addressable_devices_indices_map(
                leaf.shape).items():
            start = tuple(int(sl.start or 0) for sl in index)
            shape = tuple(int((sl.stop if sl.stop is not None else g)
                              - (sl.start or 0))
                          for sl, g in zip(index, leaf.shape))
            per_dev[dev.id] = (start, shape)
        out[name] = per_dev
    return out, needs_from_state(state)


def _coords(plan, rank):
    shape = tuple(plan.size(a) for a in tmesh.AXIS_ORDER)
    return dict(zip(tmesh.AXIS_ORDER,
                    (int(i) for i in np.unravel_index(rank, shape))))


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_port_regions_equal_jax_regions(plan_name, cfg):
    kw = dict(PLANS[plan_name])
    n = kw.pop("n")
    jplan = jmesh.plan_mesh(n, **kw)
    tplan = tmesh.plan_mesh(n, **kw)
    assert tplan.axes == jplan.axes
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), **CONFIGS[cfg])
    tc = dataclasses.replace(tl.LlamaConfig.tiny(), **CONFIGS[cfg])
    per_device, needs = _jax_regions(jplan, jc, n)
    params = tl.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    logical = _axes_by_name(tc)
    sizes = dict(tplan.axes)
    assert set(logical) == set(per_device) == set(needs)
    for name, leaf in named_leaves({"params": params}):
        spec = tsharding.valid_spec_for(sizes, leaf.shape, logical[name])
        ours = {}
        for rank in range(n):
            region = tsharding.region_for(leaf.shape, spec, sizes,
                                          _coords(tplan, rank))
            assert region == per_device[name][rank], (name, rank)
            ours[rank] = region
        assert tuple(sorted(set(ours.values()))) == needs[name].regions


def _axes_by_name(config):
    """{leaf name: logical axes} of the port's param_logical_axes."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], path + (k,))
        else:
            out[jax_leaf_name(path)] = tree

    walk({"params": tl.param_logical_axes(config)}, ())
    return out


def test_param_logical_axes_are_the_references():
    tc, jc = tl.LlamaConfig.tiny(), jl.LlamaConfig.tiny()
    assert tl.param_logical_axes(tc) == jl.param_logical_axes(jc)
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


def test_spec_and_clamp_match_the_reference():
    jplan = jmesh.plan_mesh(8, tp=2)
    mesh = jmesh.build_mesh(jplan, jax.devices()[:8])
    sizes = dict(jplan.axes)
    for shape, axes in [((4, 64, 64), ("layers", "embed", "heads")),
                        ((250, 48), ("vocab", "embed")),
                        ((3, 100, 48), ("layers", "mlp", "embed")),
                        ((8,), ("norm",)), ((6, 6), ("batch", None))]:
        want = jsharding.valid_spec_for(mesh, shape, axes)
        got = tsharding.valid_spec_for(sizes, shape, axes)
        assert tuple(want) == got, (shape, axes)


def test_four_gloo_ranks_hold_the_jax_regions_and_step_as_one(tmp_path):
    ranks = _ranks_module().launch(4, "shard", {"tp": 2}, str(tmp_path),
                                   f"tshard{os.getpid()}")
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    per_device, _ = _jax_regions(jmesh.plan_mesh(4, tp=2), jc, 4)
    for rank, res in ranks.items():
        assert res["locals_match"]
        for name, regions in res["needs"].items():
            assert [tuple(map(tuple, r)) for r in regions] == [
                per_device[name][rank]], (rank, name)
        # losses and grad norms to the trainer tests' tolerances, params
        # and moments to theirs (the ranks sum in another order)
        np.testing.assert_allclose(np.array(res["losses"])[:, 0],
                                   np.array(res["ref_losses"])[:, 0],
                                   rtol=1e-5)
        np.testing.assert_allclose(np.array(res["losses"])[:, 1],
                                   np.array(res["ref_losses"])[:, 1],
                                   rtol=1e-4)
        assert res["param_err"] <= 1e-5 and res["mu_err"] <= 1e-7


@pytest.mark.parametrize("world", [1, 3, 4, 6, 8])
def test_elastic_mesh_manager_replans_as_jax(world):
    for kw in (dict(), dict(tp=2), dict(tp=2, dcn=2), dict(pp=2, tp=2)):
        jm, tm = jmesh.ElasticMeshManager(**kw), tmesh.ElasticMeshManager(**kw)
        try:
            want = jm.replan(world)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tm.replan(world)
            assert str(got.value) == str(e)
            continue
        assert tm.replan(world).axes == want.axes
        assert tm.min_unit == jm.min_unit
        plan = jmesh.plan_mesh(8, tp=4)
        jm.apply_plan(plan)
        tm.apply_plan(tmesh.plan_mesh(8, tp=4))
        assert tm.replan(world if world % 4 == 0 else 8).axes == jm.replan(
            world if world % 4 == 0 else 8).axes
