"""The port's Flash Checkpoint against the JAX package's.

- the engine round trips of the JAX engine's own tests
  (``tests/test_ckpt.py``): no agent, bf16, an unsealed frame unreadable,
  loading nothing, plus a save followed at once by an in-place step;
- the frame is the reference's: a train state saved by the JAX engine
  restores bitwise in the port and the reverse, through shm and through a
  storage chain (the JAX saver's delta links included), at step 0 and
  after 2 steps;
- across 2 gloo ranks: a replicated leaf is saved once, a save is skipped
  on every rank when one is busy, every rank restores from shm (the
  replicated leaves from its local peer's frame), and the 2-rank storage
  save restores onto a world of 1 in the port and in the JAX engine alike.
"""

import dataclasses
import importlib.util
import os
import struct
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
msgpack = pytest.importorskip("msgpack")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.ckpt.engine import CheckpointEngine as JEngine  # noqa: E402
from dlrover_tpu.common.multi_process import (  # noqa: E402
    unlink_shared_memory,
)
from dlrover_tpu.models import llama as jl  # noqa: E402
from dlrover_tpu.trainer import elastic as je  # noqa: E402
from dlrover_tpu_torch.ckpt.engine import CheckpointEngine  # noqa: E402
from dlrover_tpu_torch.ckpt.shm_handler import (  # noqa: E402
    SharedMemoryHandler,
    shm_name,
)
from dlrover_tpu_torch.convert import (  # noqa: E402
    jax_leaf_name,
    named_leaves,
    port_leaf_path,
    train_state_from_jax,
)
from dlrover_tpu_torch.models import llama as tl  # noqa: E402
from dlrover_tpu_torch.trainer import elastic as te  # noqa: E402
from dlrover_tpu_torch.trainer.optim import adamw, tree_leaves  # noqa: E402

JOB = f"tckpt{os.getpid()}"


@pytest.fixture(autouse=True)
def _clean_shm():
    yield
    for lr in range(4):
        unlink_shared_memory(shm_name(JOB, 0, lr))


def _engine(path, cls=CheckpointEngine, **kw):
    return cls(str(path), job_name=JOB, node_rank=0, local_rank=0,
               ipc_socket="/nonexistent", world_size=1, rank=0, **kw)


def _plain_state(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 8, generator=g).to(dtype),
                   "b": torch.randn(8, generator=g).to(dtype)},
        "step": torch.tensor(3, dtype=torch.int32), "lr": 0.5,
    }


def _equal_trees(a, b):
    la, lb = named_leaves(a), named_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


def test_engine_roundtrip_no_agent(tmp_path):
    engine = _engine(tmp_path)
    state = _plain_state()
    assert engine.save_to_memory(7, state)
    target = _plain_state(seed=1)
    target["lr"] = 0.1
    restored, step = engine.load(target)
    assert step == 7 and engine.last_restore["medium"] == "shm"
    _equal_trees(restored, state)
    assert restored["params"]["w"] is target["params"]["w"]  # in place


@pytest.mark.parametrize("target_dtype", [torch.bfloat16, torch.float32])
def test_bfloat16_roundtrip(tmp_path, target_dtype):
    """bf16 travels as its 16-bit patterns; a restore casts into the
    target's dtype (exact from bf16 to f32)."""
    engine = _engine(tmp_path)
    x = torch.arange(32, dtype=torch.float32).reshape(4, 8).div(7).to(
        torch.bfloat16)
    assert engine.save_to_memory(1, {"x": x}) and engine.wait_drained(30)
    meta = SharedMemoryHandler(shm_name(JOB, 0, 0)).read_meta()
    assert meta["leaves"][0]["dtype"] == "bfloat16"
    restored, step = engine.load({"x": torch.zeros(4, 8, dtype=target_dtype)})
    assert step == 1 and restored["x"].dtype == target_dtype
    assert torch.equal(restored["x"], x.to(target_dtype))


def test_unsealed_frame_is_unreadable_not_torn(tmp_path):
    shm = SharedMemoryHandler(shm_name(JOB, 0, 3))
    arr = np.arange(16, dtype=np.float32)
    meta = {"step": 4, "ts": time.time(), "job": JOB, "node_rank": 0,
            "local_rank": 3,
            "leaves": [{"path": "['w']", "kind": "array", "dtype": "float32",
                        "gshape": [16],
                        "shards": [{"offset": 0, "nbytes": arr.nbytes,
                                    "lshape": [16], "start": [0]}]}]}
    shm.write_frame(meta, [arr])
    assert shm.read_meta()["step"] == 4
    shm._shm.buf[:8] = struct.pack("<Q", 0)  # died mid-write
    shm._shm.buf[64:80] = b"\xff" * 16
    assert shm.read_meta() is None and shm.read_frame_bytes() is None
    assert shm.step == -1
    engine = CheckpointEngine(str(tmp_path), job_name=JOB, node_rank=0,
                              local_rank=3, ipc_socket="/nonexistent",
                              world_size=1, rank=0)
    target = {"w": torch.zeros(16)}
    assert engine.load(target)[1] == -1
    meta["step"] = 5
    for s in meta["leaves"][0]["shards"]:
        s.pop("abs_offset", None)
    shm.write_frame(meta, [arr])
    restored, step = engine.load(target)
    assert step == 5 and torch.equal(restored["w"], torch.from_numpy(arr))
    shm.close()


def test_load_nothing_returns_minus_one(tmp_path):
    target = _plain_state()
    restored, step = _engine(tmp_path).load(target)
    assert step == -1 and restored is target


def test_storage_save_then_restore_without_shm(tmp_path):
    engine = _engine(tmp_path)
    state = _plain_state()
    assert engine.save_to_storage(9, state)
    engine._shm.unlink()
    restored, step = engine.load(_plain_state(seed=2))
    assert step == 9 and engine.last_restore["medium"] == "storage"
    _equal_trees(restored, state)


def _tiny_trainer():
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                             use_flash_attention=False)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32,
                             use_flash_attention=False)
    tt = te.ElasticTrainer(lambda p, t: tl.next_token_loss(p, t, tc),
                           adamw(3e-4), 4, 4, device="cpu")
    tt.configure_for_world(te.plan_mesh(1))
    return jc, tc, tt


def test_save_then_in_place_step_keeps_the_pre_step_values(tmp_path):
    """The trainer writes params and moments in place: the snapshot taken
    just before a step must still hold the values from before it."""
    from dlrover_tpu_torch.common import state_fence

    _, tc, tt = _tiny_trainer()
    state = te.make_train_state(
        tl.init_params(tc, torch.Generator().manual_seed(0), "cpu"),
        tt._optimizer)
    before = {n: x.clone() for n, x in named_leaves(state)}
    engine = _engine(tmp_path)
    seen = []
    # a reader of the state is waited for before the step writes it
    state_fence.add_reader(lambda: seen.append(torch.equal(
        state["params"]["lm_head"], before["['params']['lm_head']"])))
    assert engine.save_to_memory(1, state)
    tokens = np.random.default_rng(0).integers(0, tc.vocab_size, (1, 4, 9))
    state, _ = tt.train_step(state, tokens)
    assert seen == [True]
    assert not torch.equal(state["params"]["lm_head"],
                           before["['params']['lm_head']"])
    assert engine.wait_drained(30)
    target = te.make_train_state(
        tl.init_params(tc, torch.Generator().manual_seed(5), "cpu"),
        adamw(3e-4))
    restored, step = engine.load(target)
    assert step == 1
    for name, x in named_leaves(restored):
        assert torch.equal(x, before[name]), name


def test_leaf_names_are_the_jax_keystr_names():
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), use_flash_attention=False)
    jstate = je.make_train_state(jl.init_params(jc, jax.random.PRNGKey(0)),
                                 optax.adamw(3e-4))
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert [n for n, _ in named_leaves(tstate)] == want
    for name in want:
        assert jax_leaf_name(port_leaf_path(name)) == name


# -- cross-format: the JAX engine's frames and chains -----------------------


@pytest.fixture(scope="module")
def jax_states():
    """The JAX example's train state (bf16 tiny Llama, optax adamw) at steps
    0, 1 and 2, with the sampler position leaves the example carries."""
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), use_flash_attention=False)
    jt = je.ElasticTrainer(lambda p, t: jl.next_token_loss(p, t, jc),
                           optax.adamw(3e-4), 4, 4)
    jt.configure_for_world(je.plan_mesh(1))
    state = je.make_train_state(jl.init_params(jc, jax.random.PRNGKey(0)),
                                jt._optimizer)
    state["sampler_epoch"] = jnp.int32(0)
    state["sampler_completed"] = jnp.int32(0)
    rng = np.random.default_rng(1)
    states = [_np(state)]  # host copies: the step donates its input
    for i in range(2):
        tokens = rng.integers(0, jc.vocab_size, (1, 4, 17)).astype(np.int32)
        state, _ = jt.train_step(state, jnp.asarray(tokens))
        state["sampler_epoch"] = jnp.int32(0)
        state["sampler_completed"] = jnp.int32(4 * (i + 1))
        states.append(_np(state))
    return jc, states


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _port_target():
    tc = tl.LlamaConfig.tiny()
    state = te.make_train_state(
        tl.init_params(tc, torch.Generator().manual_seed(3), "cpu"),
        adamw(3e-4))
    state["sampler_epoch"] = torch.tensor(7, dtype=torch.int32)
    state["sampler_completed"] = torch.tensor(7, dtype=torch.int32)
    return state


def _port_from_jax(jstate):
    t = train_state_from_jax(_np(jstate), "cpu")
    for k in ("sampler_epoch", "sampler_completed"):
        t[k] = torch.tensor(int(jstate[k]), dtype=torch.int32)
    return t


@pytest.mark.parametrize("steps", [0, 2])
@pytest.mark.parametrize("medium", ["shm", "storage"])
def test_jax_saved_state_restores_bitwise_in_port(tmp_path, jax_states,
                                                  medium, steps):
    _, states = jax_states
    jengine = _engine(tmp_path, JEngine)
    if medium == "shm":
        assert jengine.save_to_memory(steps, _jax(states[steps]))
        assert jengine.wait_drained(60)
    else:
        # every step to storage: the JAX saver chains steps 1 and 2 (same
        # shard sizes) as a delta link onto step 1's base
        for s in range(steps + 1):
            assert jengine.save_to_storage(s, _jax(states[s]))
        jengine._shm.unlink()
        if steps:
            link = msgpack.unpackb(open(os.path.join(
                tmp_path, "step_00000002", "manifest_0_0.mf"), "rb").read(),
                raw=False)
            assert link["kind"] == "delta" and link["parent_step"] == 1
            assert any(e["s"] == 1 for e in link["shards"])
    engine = _engine(tmp_path)
    restored, step = engine.load(_port_target())
    assert step == steps and engine.last_restore["medium"] == medium
    # f32 moments in the port; at step 0 optax holds them in bf16 (zeros,
    # cast exactly)
    _equal_trees(restored, _port_from_jax(states[steps]))


@pytest.mark.parametrize("steps", [0, 2])
@pytest.mark.parametrize("medium", ["shm", "storage"])
def test_port_saved_state_restores_bitwise_in_jax(tmp_path, jax_states,
                                                  medium, steps):
    jc, states = jax_states
    engine = _engine(tmp_path)
    state = _port_from_jax(states[steps])
    if medium == "shm":
        assert engine.save_to_memory(steps, state) and engine.wait_drained(60)
    else:
        assert engine.save_to_storage(steps, state)
        engine._shm.unlink()
    target = je.make_train_state(jl.init_params(jc, jax.random.PRNGKey(4)),
                                 optax.adamw(3e-4))
    target["sampler_epoch"] = jnp.int32(9)
    target["sampler_completed"] = jnp.int32(9)
    jengine = _engine(tmp_path, JEngine)
    restored, step = jengine.load(target)
    assert step == steps
    want = jax.tree_util.tree_flatten_with_path(states[steps])[0]
    got = jax.tree.leaves(restored)
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        name = jax.tree_util.keystr(path)
        w, g = np.asarray(w), np.asarray(g)
        if steps == 0 and ".mu[" in name or steps == 0 and ".nu[" in name:
            # the port's f32 moments of optax's bf16 zeros: equal values
            assert g.dtype == np.float32 and not g.any() and not w.any()
            continue
        assert g.dtype == w.dtype, name
        assert g.tobytes() == w.tobytes(), name


# -- across ranks -------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "torch_ranks", os.path.join(os.path.dirname(__file__), "data",
                                    "torch_ranks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("two_ranks")
    job = f"tranks{os.getpid()}"
    try:
        yield mod.launch(2, "ckpt", {}, str(out), job), out, mod
    finally:
        for lr in range(2):
            unlink_shared_memory(shm_name(job, 0, lr))


def test_two_ranks_save_replicated_leaves_once(two_ranks):
    ranks, _, _ = two_ranks
    saved0, saved1 = ranks[0]["saved_shards"], ranks[1]["saved_shards"]
    for name in saved0:
        replicated = "norm" in name or name in (
            "['step']", "['opt_state'][0].count")
        assert saved0[name] == 1, name
        assert saved1[name] == (0 if replicated else 1), name


def test_two_ranks_skip_a_save_together_and_restore_from_shm(two_ranks):
    ranks, _, _ = two_ranks
    for res in ranks.values():
        assert res["busy_save"] is False and res["next_save"] is True
        assert res["shm_restore"] == [5, "shm", True]
        assert res["storage_save"] is True
        assert res["locals_match"]
        np.testing.assert_allclose(np.array(res["losses"])[:, 0],
                                   np.array(res["ref_losses"])[:, 0],
                                   rtol=1e-5)


def test_two_rank_storage_restores_onto_one_rank(two_ranks):
    """2 → 1: the port and the JAX engine restore the 2-rank save alike,
    and it is the state 3 plain steps give."""
    _, out, mod = two_ranks
    c = mod.config()
    target = te.make_train_state(
        tl.init_params(c, torch.Generator().manual_seed(11), "cpu"),
        adamw(3e-4))
    engine = CheckpointEngine(str(out), job_name=f"solo{os.getpid()}",
                              ipc_socket="/nonexistent", world_size=1, rank=0)
    restored, step = engine.load(target)
    assert step == 6 and engine.last_restore["medium"] == "storage"
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    jtarget = je.make_train_state(jl.init_params(jc, jax.random.PRNGKey(0)),
                                  optax.adamw(3e-4))
    jrestored, jstep = JEngine(str(out), job_name=f"solo{os.getpid()}",
                               ipc_socket="/nonexistent", world_size=1,
                               rank=0).load(jtarget)
    assert jstep == 6
    for (path, j) in jax.tree_util.tree_flatten_with_path(jrestored)[0]:
        name = jax.tree_util.keystr(path)
        t = dict(named_leaves(restored))[name]
        assert np.asarray(j).tobytes() == t.numpy().tobytes(), name
    tt = mod.trainer(c, te.plan_mesh(1))
    ref = te.make_train_state(
        tl.init_params(c, torch.Generator().manual_seed(0), "cpu"),
        tt._optimizer)
    for b in mod.batches(c):
        ref, _ = tt.train_step(ref, b.reshape(
            tt.grad_accum_steps, tt.micro_batch_global, mod.SEQ + 1))
    assert int(restored["step"]) == 3
    for a, b in zip(tree_leaves(restored["params"]),
                    tree_leaves(ref["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_frame_readers_and_crc_catch_a_flipped_byte(tmp_path):
    """The frame's readers agree with each other and with the JAX
    package's parser; a byte flipped after the seal fails the CRC in
    both packages' checks, and the port then restores nothing from shm."""
    from dlrover_tpu.ckpt.shm_handler import parse_frame as jparse
    from dlrover_tpu.ckpt.shm_handler import verify_frame_blob
    from dlrover_tpu_torch.ckpt.shm_handler import parse_frame

    engine = _engine(tmp_path)
    state = _plain_state()
    assert engine.save_to_memory(2, state) and engine.wait_drained(30)
    shm = SharedMemoryHandler(shm_name(JOB, 0, 0))
    meta = shm.read_meta()
    leaf = next(lf for lf in meta["leaves"] if lf["path"].endswith("['w']"))
    shard = leaf["shards"][0]
    out = np.empty(63, dtype=np.float32)
    assert not shm.read_shard_into(shard, out)  # wrong size
    out = np.empty(64, dtype=np.float32)
    assert shm.read_shard_into(shard, out)
    assert bytes(shm.read_shard_bytes(shard)) == out.tobytes()
    assert out.tobytes() == state["params"]["w"].numpy().tobytes()
    blob = bytes(shm.read_frame_bytes())
    mine = parse_frame(blob)
    theirs = jparse(blob)
    for m in (mine, theirs):
        m.pop("_blob")
    assert mine == theirs == meta
    assert shm.verify_frame() == [] and verify_frame_blob(blob) == []
    at = shard["abs_offset"] + 5
    shm._shm.buf[at] = shm._shm.buf[at] ^ 0xFF
    bad = [f"{leaf['path']}@{shard['offset']}"]
    assert shm.verify_frame() == bad
    assert verify_frame_blob(bytes(shm.read_frame_bytes())) == bad
    _, step = engine.load(_plain_state(seed=4))
    assert step == -1
    shm.close()
