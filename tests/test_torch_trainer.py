"""The port's trainer, optimizer and mesh plan against the JAX package's.

The same JAX-initialised f32 params (carried over with ``params_from_jax``)
and the same seeded token batches go through the JAX ``ElasticTrainer`` with
``optax.adamw(3e-4)`` and through the port's ``ElasticTrainer`` with its
``adamw(3e-4)``, on the dense attention path (the Pallas interpret runs stay
in the llama and flash tests). f32 throughout; the two frameworks sum in
other orders, so losses and norms agree to ~1e-6 relative and params, which
Adam moves by about lr per step, to 1e-5.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.parallel import mesh as jmesh  # noqa: E402
from dlrover_tpu.trainer import elastic as je  # noqa: E402
from dlrover_tpu_torch.convert import (  # noqa: E402
    params_from_jax,
    train_state_from_jax,
)
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dlrover_tpu_torch.trainer import elastic as te  # noqa: E402
from dlrover_tpu_torch.trainer.optim import adamw, tree_leaves  # noqa: E402

GLOBAL_BATCH, SEQ = 4, 16
PARAM_ATOL = 1e-5


def _configs():
    kw = dict(max_seq_len=64, use_flash_attention=False)
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32, **kw)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32, **kw)
    return jc, tc


def _trainers(accum):
    jc, tc = _configs()
    micro = GLOBAL_BATCH // accum
    jt = je.ElasticTrainer(lambda p, t: jl.next_token_loss(p, t, jc),
                           optax.adamw(3e-4), GLOBAL_BATCH, micro)
    tt = te.ElasticTrainer(lambda p, t: tl.next_token_loss(p, t, tc),
                           adamw(3e-4), GLOBAL_BATCH, micro, device="cpu")
    assert jt.configure_for_world(jmesh.plan_mesh(1)) == accum
    assert tt.configure_for_world(tmesh.plan_mesh(1)) == accum
    assert tt.micro_batch_global == jt.micro_batch_global == micro
    return jc, jt, tt


def _batches(jc, accum, n, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (n, GLOBAL_BATCH, SEQ + 1))
    return [t.astype(np.int32).reshape(accum, GLOBAL_BATCH // accum, SEQ + 1)
            for t in toks]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _assert_params_close(tparams, jparams, atol=PARAM_ATOL):
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, ref in flat:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.detach().numpy(), ref, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("accum", [1, 2])
def test_three_steps_match_jax(accum):
    jc, jt, tt = _trainers(accum)
    params = jl.init_params(jc, jax.random.PRNGKey(0))
    tstate = te.make_train_state(
        params_from_jax(_np_tree(params), "cpu"), tt._optimizer)
    jstate = je.make_train_state(params, jt._optimizer)
    for batch in _batches(jc, accum, 3):
        jstate, jres = jt.train_step(jstate, jnp.asarray(batch))
        tstate, tres = tt.train_step(tstate, batch)
        np.testing.assert_allclose(float(tres.loss), float(jres.loss),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tres.grad_norm),
                                   float(jres.grad_norm), rtol=1e-4)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    _assert_params_close(tstate["params"], _np_tree(jstate["params"]))


def test_accum_one_and_two_take_the_same_step():
    """The same global batch split into 1 or 2 micro steps gives the same
    update (the reference's fixed-global-batch promise)."""
    states = []
    for accum in (1, 2):
        jc, _, tt = _trainers(accum)
        params = params_from_jax(
            _np_tree(jl.init_params(jc, jax.random.PRNGKey(0))), "cpu")
        state = te.make_train_state(params, tt._optimizer)
        state, res = tt.train_step(state, _batches(jc, accum, 1)[0])
        states.append((state, float(res.loss)))
    (s1, l1), (s2, l2) = states
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PARAM_ATOL)


def test_train_step_leaves_param_flags_and_moves_params():
    jc, _, tt = _trainers(1)
    params = params_from_jax(
        _np_tree(jl.init_params(jc, jax.random.PRNGKey(0))), "cpu")
    before = {k: v.clone() for k, v in params["layers"].items()}
    state = te.make_train_state(params, tt._optimizer)
    state, _ = tt.train_step(state, _batches(jc, 1, 1)[0])
    assert state["params"] is params
    assert not any(t.requires_grad for t in tree_leaves(params))
    assert all(not torch.equal(before[k], params["layers"][k])
               for k in before)


def test_train_step_rejects_wrong_accum_axis():
    jc, _, tt = _trainers(2)
    params = params_from_jax(
        _np_tree(jl.init_params(jc, jax.random.PRNGKey(0))), "cpu")
    state = te.make_train_state(params, tt._optimizer)
    with pytest.raises(ValueError, match="grad_accum"):
        tt.train_step(state, _batches(jc, 1, 1)[0])


def test_state_carried_from_jax_steps_on_to_the_same_state():
    jc, jt, tt = _trainers(2)
    batches = _batches(jc, 2, 2)
    jstate = je.make_train_state(jl.init_params(jc, jax.random.PRNGKey(0)),
                                 jt._optimizer)
    jstate, _ = jt.train_step(jstate, jnp.asarray(batches[0]))
    tstate = train_state_from_jax(_np_tree(jstate), "cpu")
    assert int(tstate["step"]) == 1 and int(tstate["opt_state"]["count"]) == 1
    jstate, jres = jt.train_step(jstate, jnp.asarray(batches[1]))
    tstate, tres = tt.train_step(tstate, batches[1])
    np.testing.assert_allclose(float(tres.loss), float(jres.loss), rtol=1e-5)
    _assert_params_close(tstate["params"], _np_tree(jstate["params"]))
    adam = jstate["opt_state"][0]
    _assert_params_close(tstate["opt_state"]["mu"], _np_tree(adam.mu),
                         atol=1e-7)
    _assert_params_close(tstate["opt_state"]["nu"], _np_tree(adam.nu),
                         atol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax_leaf_by_leaf(dtype):
    """Three updates on the same grads and params; in bf16 the decay term
    ``wd * p`` is rounded to bf16 before it joins the f32 update, as JAX
    rounds it."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": {"c": (7,), "d": (2, 2, 2)}}
    jdt = jnp.dtype(dtype)

    def tree(f):
        return jax.tree.map(f, shapes, is_leaf=lambda x: isinstance(x, tuple))

    params = tree(lambda s: jnp.asarray(rng.standard_normal(s), jdt))
    opt = optax.adamw(3e-4)
    jst = opt.init(params)
    topt = adamw(3e-4)
    tparams = params_from_jax(_np_tree(params), "cpu")
    tst = topt.init(tparams)
    for _ in range(3):
        grads = tree(lambda s: jnp.asarray(rng.standard_normal(s),
                                           jnp.float32))
        jup, jst = opt.update(grads, jst, params)
        tup, tst = topt.update(params_from_jax(_np_tree(grads), "cpu"), tst,
                               tparams)
        _assert_params_close(tup, _np_tree(jup), atol=1e-9)
    _assert_params_close(tst["mu"], _np_tree(jst[0].mu), atol=1e-9)
    _assert_params_close(tst["nu"], _np_tree(jst[0].nu), atol=1e-9)
    assert int(tst["count"]) == int(jst[0].count) == 3


def test_configure_for_world_raises_as_jax():
    jt = je.ElasticTrainer(None, None, 6, 4)
    tt = te.ElasticTrainer(None, None, 6, 4, device="cpu")
    with pytest.raises(ValueError) as jerr:
        jt.configure_for_world(jmesh.plan_mesh(1))
    with pytest.raises(ValueError) as terr:
        tt.configure_for_world(tmesh.plan_mesh(1))
    assert str(terr.value) == str(jerr.value)


def test_apply_parallel_config_versions_as_jax():
    class Manager:
        def __init__(self):
            self.plans = []

        def apply_plan(self, plan):
            self.plans.append(plan.axes)

    jt = je.ElasticTrainer(None, None, 16, 2)
    manager = Manager()
    tt = te.ElasticTrainer(None, None, 16, 2, mesh_manager=manager,
                           device="cpu")
    steps = [
        dict(mesh_version=1, mesh_data=2, mesh_fsdp=2, mesh_tp=1),
        dict(mesh_version=1, mesh_data=4, mesh_fsdp=1, mesh_tp=1),  # stale
        dict(mesh_version=2, mesh_data=1, mesh_fsdp=1, mesh_tp=1),  # trivial
        dict(mesh_version=3, mesh_data=4, mesh_fsdp=1, mesh_tp=2),
    ]
    for cfg in steps:
        jp = jt.apply_parallel_config(cfg)
        tp = tt.apply_parallel_config(cfg)
        assert (tp is None) == (jp is None), cfg
        if jp is not None:
            assert tp.axes == jp.axes
        assert tt.grad_accum_steps == jt.grad_accum_steps
    assert manager.plans == [jmesh.plan_mesh(4, tp=1, fsdp=2, dp=2).axes,
                             jmesh.plan_mesh(8, tp=2, fsdp=1, dp=4).axes]


@pytest.mark.parametrize("args", [
    dict(n_devices=8), dict(n_devices=8, tp=2), dict(n_devices=8, dp=2),
    dict(n_devices=8, fsdp=2), dict(n_devices=16, dcn=2, tp=2),
    dict(n_devices=6, tp=4), dict(n_devices=8, dp=3),
])
def test_plan_mesh_matches_jax(args):
    try:
        ref = jmesh.plan_mesh(**args)
    except ValueError as e:
        with pytest.raises(ValueError, match="not divisible"):
            tmesh.plan_mesh(**args)
        assert "not divisible" in str(e)
        return
    got = tmesh.plan_mesh(**args)
    assert got.axes == ref.axes
    assert got.dp_total == ref.dp_total and got.n_devices == ref.n_devices
    assert got.nontrivial_axes() == ref.nontrivial_axes()
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.MODEL_AXES == jmesh.MODEL_AXES


def test_global_norm_matches_optax():
    rng = np.random.default_rng(9)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 3, 2))]
    ref = je.optax_global_norm([jnp.asarray(x) for x in leaves])
    got = te.global_norm([torch.from_numpy(x) for x in leaves])
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
