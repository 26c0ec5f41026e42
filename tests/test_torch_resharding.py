"""The port's live-reshard plane (``dlrover_tpu_torch/ckpt/reshard.py``)
and its place in the checkpoint engine's ladder, against the JAX
package's (``tests/test_resharding.py``):

- ``layout_from_frames`` and ``plan_reshard`` give the JAX package's
  layouts and transfers on seeded random layouts (exact equality), and
  raise ``CoverageError`` with the same message on the same holes;
  ``execute_plan`` equals a brute-force gather (bitwise);
- the cut record the port's master publishes at a world cut of its
  rendezvous is the one a JAX restorer reads;
- scale-down on two gloo ranks: the survivors' reshard aborts on its
  coverage proof (journaled), the shm rung cannot cover the dead node's
  half, and the peer-frame rung restores every rank from a replica store
  with an empty checkpoint directory, bitwise equal to the JAX engine's
  restore of the same frames;
- scale-up: a new node's engine pulls every region from the old world's
  agent (all bytes remote, none from storage), bitwise;
- a ``fabric.stripe`` fault mid-reshard falls through to the shm rung,
  journaled ``reshard_aborted`` with ``fault_injected``;
- a survivor that sealed a newer frame refuses a stale-step fetch, to
  either package's fabric client; ``DLROVER_TPU_RESHARD=0`` skips the
  rung;
- the CPU node drill: the twin at ``LlamaConfig.tiny()`` under two port
  agents (2 gloo workers each), one agent SIGKILLed and brought back:
  with ``--ckpt-replica 2`` the shrunk world restores from the peer
  frames past storage's step and the rejoined one by live reshard on
  every rank; without replicas (the control) the shrink restores from
  storage. Losses against the JAX twin's unkilled run at rtol 1e-4 (f32;
  the worlds sum the batch in another order).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.agent.master_client import MasterClient as JaxClient  # noqa: E402,E501
from dlrover_tpu.ckpt import replica as jrep  # noqa: E402
from dlrover_tpu.ckpt import reshard as jrs  # noqa: E402
from dlrover_tpu.ckpt.engine import CheckpointEngine as JaxEngine  # noqa: E402
from dlrover_tpu.common import comm as jcomm  # noqa: E402
from dlrover_tpu.common import fabric as jfab  # noqa: E402

from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.chaos import configure, reset_injector  # noqa: E402
from dlrover_tpu_torch.ckpt import replica as trep  # noqa: E402
from dlrover_tpu_torch.ckpt import reshard as trs  # noqa: E402
from dlrover_tpu_torch.ckpt.engine import CheckpointEngine  # noqa: E402
from dlrover_tpu_torch.ckpt.shm_handler import (  # noqa: E402
    SharedMemoryHandler,
    shm_name,
)
from dlrover_tpu_torch.common import comm as tcomm  # noqa: E402
from dlrover_tpu_torch.common.constants import ConfigKey, EnvKey  # noqa: E402
from dlrover_tpu_torch.common.multi_process import (  # noqa: E402
    unlink_shared_memory,
)
from dlrover_tpu_torch.common.rpc import RPCClient  # noqa: E402
from dlrover_tpu_torch.convert import named_leaves  # noqa: E402
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402
from dlrover_tpu_torch.models import llama  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests", "data"))

import torch_ladder_rank  # noqa: E402

JOB = f"trsh{os.getpid()}"
HOST = "127.0.0.1"
W = "['w']"
LR = "['lr']"


@pytest.fixture()
def master(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_HOST_IP", HOST)
    m = LocalJobMaster(job_name=JOB, node_num=2)
    m.prepare()
    yield m
    m.stop()


@pytest.fixture(autouse=True)
def _clean_shm():
    yield
    reset_injector()
    for name in os.listdir("/dev/shm"):
        if name.startswith((f"dlrtpu_{JOB}", f"dlrtpu_j{JOB}")):
            unlink_shared_memory(name)


def _events(master, kind):
    return [e for e in master.event_journal.events() if e["kind"] == kind]


# -- the plan layer against the JAX package's -------------------------------------


def _cuts(rng, n):
    k = int(rng.integers(1, min(4, n) + 1))
    inner = sorted(rng.choice(np.arange(1, n), size=k - 1, replace=False)
                   ) if n > 1 and k > 1 else []
    return [0, *map(int, inner), n]


def _grid(rng, gshape):
    """Blocks covering ``gshape`` exactly: (start, shape) each."""
    cuts = [_cuts(rng, g) for g in gshape]
    blocks = [((), ())]
    for c in cuts:
        blocks = [(s + (a,), sh + (b - a,)) for s, sh in blocks
                  for a, b in zip(c, c[1:])]
    return blocks


def _random_frames(rng):
    """Frame metas of a random old world: 2-3 leaves, their blocks spread
    over 2 nodes × 2 local ranks, some blocks saved twice."""
    owners = [(n, lr) for n in range(2) for lr in range(2)]
    frames = {o: {"node_rank": o[0], "local_rank": o[1], "step": 3,
                  "leaves": []} for o in owners}
    leaves = {}
    for li in range(int(rng.integers(2, 4))):
        gshape = tuple(int(g) for g in rng.integers(1, 9, rng.integers(1, 4)))
        dtype = ["float32", "bfloat16", "int32"][li % 3]
        path = f"['leaf{li}']"
        leaves[path] = (dtype, gshape)
        per = {o: [] for o in owners}
        for start, shape in _grid(rng, gshape):
            picks = [owners[int(rng.integers(4))]]
            if rng.random() < 0.3:
                picks.append(owners[int(rng.integers(4))])
            for o in dict.fromkeys(picks):
                per[o].append({"start": list(start), "lshape": list(shape),
                               "nbytes": int(np.prod(shape)) * 4,
                               "offset": 0})
        for o in owners:
            frames[o]["leaves"].append({"path": path, "kind": "array",
                                        "dtype": dtype,
                                        "gshape": list(gshape),
                                        "shards": per[o]})
    frames[(0, 0)]["leaves"].append({"path": LR, "kind": "value",
                                     "value": 0.5})
    return list(frames.values()), leaves


def _spec_tuple(spec):
    return (spec.path, spec.dtype, tuple(spec.gshape),
            tuple((s.path, s.node_rank, s.local_rank, s.shard_index,
                   tuple(s.start), tuple(s.shape), s.nbytes, tuple(s.alt))
                  for s in spec.shards))


def _plan_tuple(plan):
    return (plan.step, plan.total_bytes, [
        (t.path, t.src.node_rank, t.src.local_rank, t.src.shard_index,
         t.region_index, tuple(t.lo), tuple(t.hi), t.nbytes)
        for t in plan.transfers])


@pytest.mark.parametrize("seed", range(6))
def test_plan_matches_jax_on_random_layouts(seed):
    rng = np.random.default_rng(seed)
    frames, leaves = _random_frames(rng)
    t_layout, t_values = trs.layout_from_frames(frames)
    j_layout, j_values = jrs.layout_from_frames(frames)
    assert {p: _spec_tuple(s) for p, s in t_layout.items()} == \
        {p: _spec_tuple(s) for p, s in j_layout.items()}
    assert t_values == j_values
    # needs: the blocks of another random grid, each a region
    t_needs, j_needs = {}, {}
    for path, (dtype, gshape) in leaves.items():
        regions = tuple(sorted(_grid(rng, gshape)))
        t_needs[path] = trs.NeedSpec(path, dtype, gshape, regions)
        j_needs[path] = jrs.NeedSpec(path, dtype, gshape, regions)
    t_plan = trs.plan_reshard(t_layout, t_needs, step=3)
    assert _plan_tuple(t_plan) == _plan_tuple(
        jrs.plan_reshard(j_layout, j_needs, step=3))
    # execute against a brute-force gather of a seeded global array
    full = {p: rng.integers(0, 1 << 15, g).astype(np.int32)
            for p, (_, g) in leaves.items()}

    def fetch(src):
        sl = tuple(slice(a, a + n) for a, n in zip(src.start, src.shape))
        return np.ascontiguousarray(full[src.path][sl]).tobytes()

    i32 = {p: trs.NeedSpec(p, "int32", n.gshape, n.regions)
           for p, n in t_needs.items()}
    out = trs.execute_plan(trs.plan_reshard(t_layout, i32), i32, fetch)
    for path, need in i32.items():
        for k, (start, shape) in enumerate(need.regions):
            sl = tuple(slice(a, a + n) for a, n in zip(start, shape))
            assert np.array_equal(out[path][k], full[path][sl])
    # a hole: drop one leaf's shards from every frame but their first
    path = sorted(leaves)[0]
    holed = json.loads(json.dumps(frames))
    for f in holed:
        for leaf in f["leaves"]:
            if leaf["path"] == path:
                leaf["shards"] = leaf["shards"][:1] if f is holed[0] else []
    t_hole, _ = trs.layout_from_frames(holed)
    j_hole, _ = jrs.layout_from_frames(holed)
    full_need = ((((0,) * len(leaves[path][1])), leaves[path][1]),)
    t_msg = j_msg = None
    try:
        trs.plan_reshard(t_hole, {path: trs.NeedSpec(
            path, leaves[path][0], leaves[path][1], full_need)})
    except trs.CoverageError as e:
        t_msg = str(e)
    try:
        jrs.plan_reshard(j_hole, {path: jrs.NeedSpec(
            path, leaves[path][0], leaves[path][1], full_need)})
    except jrs.CoverageError as e:
        j_msg = str(e)
    assert t_msg == j_msg
    whole = int(np.prod(leaves[path][1]))
    kept = sum(int(np.prod(s["lshape"])) for f in holed
               for leaf in f["leaves"] if leaf["path"] == path
               for s in leaf["shards"])
    assert (t_msg is None) == (kept >= whole)


def test_plan_errors_match_jax():
    frame = {"node_rank": 0, "local_rank": 0, "step": 3, "leaves": [
        {"path": W, "kind": "array", "dtype": "float32", "gshape": [8, 4],
         "shards": [{"start": [0, 0], "lshape": [4, 4], "nbytes": 64}]}]}
    for needs in ({W: ((8, 4), (((0, 0), (8, 4)),))},
                  {"['b']": ((2,), (((0,), (2,)),))},
                  {W: ((4, 4), (((0, 0), (4, 4)),))}):
        msgs = []
        for mod in (trs, jrs):
            layout, _ = mod.layout_from_frames([frame])
            with pytest.raises(mod.CoverageError) as e:
                mod.plan_reshard(layout, {p: mod.NeedSpec(p, "float32", g, r)
                                          for p, (g, r) in needs.items()})
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# -- the cut record -----------------------------------------------------------------


def test_port_cut_record_read_by_jax_restorer(master):
    """Two nodes form round 1; node 1 leaves and node 0 alone forms round
    2: the port's rendezvous publishes the cut, and the JAX restorer reads
    the same record the port's does."""
    from dlrover_tpu_torch.common.comm import NodeMeta
    from dlrover_tpu_torch.common.constants import RendezvousName

    rdzv = master.rdzv_managers[RendezvousName.TRAINING]
    rdzv.update_rdzv_params(1, 2, waiting_timeout=0.01)
    for r in (0, 1):
        rdzv.join_rendezvous(NodeMeta(node_rank=r, local_world_size=2))
    assert rdzv.get_comm_world(0)[0] == 1
    assert not master.kv_store.get(trs.cut_key(JOB, 1))
    rdzv.join_rendezvous(NodeMeta(node_rank=0, local_world_size=2))
    import time

    time.sleep(0.05)
    rnd, _, world = rdzv.get_comm_world(0)
    assert rnd == 2 and sorted(world) == [0]
    port_cut = trs.ReshardRestorer(JOB, MasterClient(master.addr, 0),
                                   0).read_cut(round_=2)
    jax_cut = jrs.ReshardRestorer(JOB, JaxClient(master.addr, 0),
                                  0).read_cut(round_=2)
    assert port_cut == jax_cut == {"round": 2, "old": [0, 1], "new": [0],
                                   "old_decomp": [1, 2, 1],
                                   "new_decomp": [1, 2, 1]}
    planned = _events(master, "reshard_planned")
    assert planned[-1]["data"]["old_world"] == [0, 1]
    assert trs.ReshardCoordinator(JOB, master.kv_store).on_world_cut(
        [0, 1], [1, 0], 3) is None


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 4, 1), (2, 2, 2),
                                   (3, 1, 2)])
def test_decomposition_matches_jax(shape):
    """The cut record's decomposition: the port's ``Decomposition`` and
    the JAX package's agree on the wire form, the coordinates of every
    rank and the ``ParallelConfig`` reading."""
    from types import SimpleNamespace

    from dlrover_tpu.parallel.replan import Decomposition as JaxD

    from dlrover_tpu_torch.parallel.replan import Decomposition as PortD

    data, fsdp, tp = shape
    port, ref = PortD(data, fsdp, tp), JaxD(data, fsdp, tp)
    assert port.to_wire() == ref.to_wire()
    assert PortD.from_wire(ref.to_wire()) == port
    assert (port.world, port.dp_total, port.sig(), port.axis_sizes()) == (
        ref.world, ref.dp_total, ref.sig(), ref.axis_sizes())
    assert [port.coords(r) for r in range(port.world)] == \
        [ref.coords(r) for r in range(ref.world)]
    cfg = SimpleNamespace(mesh_data=data, mesh_fsdp=fsdp, mesh_tp=0)
    assert PortD.from_config(cfg).to_wire() == \
        JaxD.from_config(cfg).to_wire()
    assert PortD.from_wire(None) == PortD()
    with pytest.raises(ValueError):
        PortD(fsdp=0)


def test_cut_record_keyed_on_the_last_world_that_trained(master):
    """C28: a world that formed and took no step is no reshard source.
    The survivor re-forms its world again before a step: its round keeps
    the cut's old world; after a step it does not. A returning node forms
    a world alone while the survivor saves, then both join: that round's
    record names the survivor's world, where the frames are. (The JAX
    coordinator names the previous world: nothing, then the empty one.)"""
    reports = []  # the rounds step reports came in

    def progress(since):
        return sum(r >= since for r in reports)

    coord = trs.ReshardCoordinator(JOB, master.kv_store, progress=progress)
    first = coord.on_world_cut([0, 1], [0], 2)
    carried = coord.on_world_cut([0], [0], 3)
    assert carried == dict(first, round=3, carried_from=2)
    assert jrs.ReshardRestorer(JOB, JaxClient(master.addr, 0),
                               0).read_cut(round_=3) == carried
    reports.append(1)  # a late report of the old world: no progress
    assert coord.on_world_cut([0], [0], 4) == dict(first, round=4,
                                                   carried_from=3)
    reports.append(4)  # round 4's world trained
    assert coord.on_world_cut([0], [0], 5) is None
    # the returning node 1 forms round 6 alone, then both join in round 7
    alone = coord.on_world_cut([0], [1], 6)
    assert (alone["old"], alone["new"]) == ([0], [1])
    reports.append(5)  # the survivor's progress, forwarded late
    back = coord.on_world_cut([1], [0, 1], 7)
    assert (back["old"], back["new"], back["carried_from"]) == (
        [0], [0, 1], 6)
    jax_coord = jrs.ReshardCoordinator(JOB, master.kv_store)
    assert jax_coord.on_world_cut([0], [0], 7) is None
    assert jax_coord.on_world_cut([1], [0, 1], 8)["old"] == [1]
    # without a progress source the record names the previous world
    plain = trs.ReshardCoordinator(JOB, master.kv_store)
    plain.on_world_cut([0, 1], [0], 9)
    assert plain.on_world_cut([0], [0], 10) is None
    assert plain.on_world_cut([1], [0, 1], 11)["old"] == [1]


# -- scale-down on gloo ranks: the peer-frame rung ---------------------------------


def _tiny_full():
    c = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    return dict(named_leaves({"params": llama.init_params(
        c, torch.Generator().manual_seed(0), "cpu")}))


def _split_dim(shape):
    return next((d for d, n in enumerate(shape) if n % 4 == 0), None)


def _old_world_blobs(full, step, job):
    """The 4 frames an fsdp-4 world of 2 nodes × 2 ranks sealed: each rank
    a quarter of every leaf that splits in 4 (along its first dim that
    does), rank 0 the leaves that do not."""
    blobs = {}
    for r in range(4):
        owner = (r // 2, r % 2)
        leaves, bufs, offset = [], [], 0
        for path, t in full.items():
            a = t.numpy()
            d = _split_dim(a.shape)
            shards = []
            if d is not None or r == 0:
                if d is None:
                    start, block = [0] * a.ndim, a
                else:
                    n = a.shape[d] // 4
                    start = [r * n if i == d else 0 for i in range(a.ndim)]
                    block = np.take(a, range(r * n, (r + 1) * n), axis=d)
                block = np.ascontiguousarray(block)
                shards.append({"offset": offset, "nbytes": block.nbytes,
                               "lshape": list(block.shape), "start": start})
                offset += block.nbytes
                bufs.append(block)
            leaves.append({"path": path, "kind": "array",
                           "dtype": "float32", "gshape": list(a.shape),
                           "shards": shards})
        shm = SharedMemoryHandler(shm_name(job, *owner, incarnation="old"))
        shm.write_frame({"step": step, "ts": 0.0, "job": job,
                         "node_rank": owner[0], "local_rank": owner[1],
                         "rank": r, "world_size": 4, "expected_frames": 4,
                         "leaves": leaves}, bufs)
        blobs[owner] = bytes(shm.read_frame_bytes())
        shm.unlink()
    return blobs


def _jax_restore(master, store_addr, job, target_names, full):
    """The JAX engine's restore of the frames the store holds, through its
    peer-frame rung (its own segment empty, no storage)."""
    JaxClient(master.addr, 0).kv_set(f"replica/{job}/addr/0",
                                     store_addr.encode())
    jm = jrep.ReplicaManager(job, 0, 1, JaxClient(master.addr, 0),
                             host=HOST)
    engine = JaxEngine("/nonexistent_ckpt", job_name=job, node_rank=0,
                       local_rank=3, ipc_socket="/nonexistent",
                       world_size=1, rank=0, replica_manager=jm)
    target = {}
    for name in target_names:
        keys = name[2:-2].split("']['")
        node = target
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.zeros(full[name].shape, jnp.float32)
    restored, step = engine.load(target)
    engine._shm.unlink()
    flat = jax.tree_util.tree_flatten_with_path(restored)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}, step


def test_scale_down_on_gloo_ranks_restores_from_peer_frames(master,
                                                            tmp_path):
    full = _tiny_full()
    blobs = _old_world_blobs(full, 7, JOB)
    store = trep.ReplicaService(host=HOST)
    store.start()
    reshard = trs.ReshardService(shm_provider=lambda: [
        SharedMemoryHandler(shm_name(JOB, 0, lr)) for lr in (0, 1)])
    reshard.start()
    try:
        c0 = MasterClient(master.addr, 0)
        store_addr = store.register(c0, JOB, 0, host=HOST)
        reshard.register(c0, JOB, 0, host=HOST)
        for (node, local), blob in blobs.items():
            store.put(node, local, 7, blob)
        # the survivors' segments still hold node 0's frames
        for local in (0, 1):
            SharedMemoryHandler(shm_name(JOB, 0, local)).write_raw(
                blobs[(0, local)])
        trs.ReshardCoordinator(JOB, master.kv_store).on_world_cut(
            [0, 1], [0], 4)
        results = torch_ladder_rank.launch(2, str(tmp_path), {
            "DLROVER_TPU_MASTER_ADDR": master.addr,
            "DLROVER_TPU_JOB_NAME": JOB, "DLROVER_TPU_RDZV_ROUND": "4",
            "DLROVER_TPU_REPLICA_GROUP": "2", "DLROVER_TPU_NODE_NUM": "1",
            "DLROVER_TPU_HOST_IP": HOST})
        want, step = _jax_restore(master, store_addr, f"j{JOB}",
                                  results[0]["names"], full)
    finally:
        reshard.stop()
        store.stop()
    assert step == 7
    for r, res in results.items():
        assert (res["step"], res["medium"]) == (7, "replica")
        got = np.load(tmp_path / f"rank{r}.npz")
        for i, name in enumerate(res["names"]):
            ((start, shape),) = res["regions"][name]
            sl = tuple(slice(a, a + n) for a, n in zip(start, shape))
            assert np.array_equal(got[f"a{i}"], want[name][sl]), name
            assert np.array_equal(want[name], full[name].numpy())
    # each rank journals its abort: the coverage proof failed (a rank it
    # did not fail for reports its peer's abort)
    reasons = [e["data"]["reason"] for e in _events(master,
                                                    "reshard_aborted")]
    assert len(reasons) == 2 and "coverage" in reasons
    assert set(reasons) <= {"coverage", "peer_aborted"}
    assert not os.path.exists(tmp_path / "empty_ckpt")


# -- in-process engines ---------------------------------------------------------------


def _global_w():
    return np.arange(32, dtype=np.float32).reshape(8, 4)


def _write_frame(node_rank, step, rows, local_rank=0, lr=0.25):
    shm = SharedMemoryHandler(shm_name(JOB, node_rank, local_rank))
    w, shards, offset = _global_w(), [], 0
    for r0, r1 in rows:
        shards.append({"offset": offset, "nbytes": (r1 - r0) * 16,
                       "lshape": [r1 - r0, 4], "start": [r0, 0]})
        offset += (r1 - r0) * 16
    shm.write_frame({
        "step": step, "ts": 0.0, "job": JOB, "node_rank": node_rank,
        "local_rank": local_rank, "rank": node_rank, "world_size": 2,
        "leaves": [{"path": W, "kind": "array", "dtype": "float32",
                    "gshape": [8, 4], "shards": shards},
                   {"path": LR, "kind": "value", "value": lr}]},
        [w[r0:r1] for r0, r1 in rows])
    return shm


def _serve(node_rank, locals_=(0,)):
    svc = trs.ReshardService(shm_provider=lambda: [
        SharedMemoryHandler(shm_name(JOB, node_rank, lr)) for lr in locals_])
    svc.start()
    return svc


def _engine(tmp_path, node_rank, client):
    return CheckpointEngine(str(tmp_path), job_name=JOB, node_rank=node_rank,
                            local_rank=0, ipc_socket="/nonexistent",
                            world_size=1, rank=node_rank,
                            master_client=client)


def _target():
    return {"w": torch.zeros(8, 4), "lr": 0.0}


def test_scale_up_new_node_pulls_everything_remote(master, tmp_path,
                                                   monkeypatch):
    """A node joining a larger world has an empty segment: its state
    comes whole from the old world's agent (node 0's two local frames),
    over the fabric."""
    _write_frame(0, 6, [(0, 3)], local_rank=0)
    _write_frame(0, 6, [(3, 8)], local_rank=1)
    svc0 = _serve(0, (0, 1))
    try:
        svc0.register(MasterClient(master.addr, 0), JOB, 0, host=HOST)
        trs.ReshardCoordinator(JOB, master.kv_store).on_world_cut(
            [0], [0, 1], 8)
        monkeypatch.setenv(EnvKey.RDZV_ROUND, "8")
        engine = _engine(tmp_path, 1, MasterClient(master.addr, 1))
        restored, step = engine.load(_target())
        assert step == 6 and engine.last_restore["medium"] == "reshard"
        assert np.array_equal(restored["w"].numpy(), _global_w())
        assert restored["lr"] == 0.25
        done = _events(master, "reshard_complete")[-1]["data"]
        assert done["bytes_local"] == 0
        assert done["bytes_remote"] == _global_w().nbytes
        assert engine.last_restore["reshard"]["bytes_remote"] == \
            _global_w().nbytes
        assert not os.listdir(tmp_path)
    finally:
        svc0.stop()


def test_injected_transfer_fault_falls_through(master, tmp_path,
                                               monkeypatch):
    """Every fabric stripe fails by injection: the rung aborts naming it,
    and the shm rung restores the older own frame."""
    _write_frame(0, 4, [(0, 8)])
    _write_frame(1, 6, [(0, 8)])
    svc0, svc1 = _serve(0), _serve(1)
    try:
        c0 = MasterClient(master.addr, 0)
        svc0.register(c0, JOB, 0, host=HOST)
        svc1.register(MasterClient(master.addr, 1), JOB, 1, host=HOST)
        trs.ReshardCoordinator(JOB, master.kv_store).on_world_cut(
            [0, 1], [0], 6)
        monkeypatch.setenv(EnvKey.RDZV_ROUND, "6")
        configure("fabric.stripe:error")
        engine = _engine(tmp_path, 0, c0)
        restored, step = engine.load(_target())
        assert step == 4 and engine.last_restore["medium"] == "shm"
        assert np.array_equal(restored["w"].numpy(), _global_w())
        aborted = _events(master, "reshard_aborted")[-1]["data"]
        assert aborted["reason"] == "fault_injected"
    finally:
        svc0.stop()
        svc1.stop()


def test_reshard_env_gate(master, tmp_path, monkeypatch):
    trs.ReshardCoordinator(JOB, master.kv_store).on_world_cut([0, 1], [0], 7)
    monkeypatch.setenv(EnvKey.RDZV_ROUND, "7")
    monkeypatch.setenv(ConfigKey.RESHARD, "0")
    engine = _engine(tmp_path, 0, MasterClient(master.addr, 0))
    assert engine._load_via_reshard(_target()) is None
    assert not _events(master, "reshard_start")


@pytest.mark.parametrize("client", ["port", "jax"])
def test_stale_step_fetch_refused(master, client):
    """A survivor that sealed a newer frame answers a fetch pinned to an
    older step "not found", to either package's client."""
    _write_frame(0, 21, [(0, 8)])
    svc0 = _serve(0)
    try:
        addr = svc0.register(MasterClient(master.addr, 0), JOB, 0, host=HOST)
        key = trs.shard_key(0, 0, W)
        assert key == jrs.shard_key(0, 0, W)
        if client == "port":
            rpc, comm = RPCClient(addr, timeout_s=5.0), tcomm
        else:
            from dlrover_tpu.common.rpc import RPCClient as JaxRPC

            rpc, comm = JaxRPC(addr, timeout_s=5.0), jcomm
        desc = rpc.call("fabric_describe", comm.FabricDescribeRequest(
            key=key, step=21))
        assert desc.found and desc.total_bytes == _global_w().nbytes
        ok = rpc.call("fabric_fetch", comm.FabricFetchRequest(
            key=key, step=21, offset=0, nbytes=0))
        assert ok.found and bytes(ok.data) == _global_w().tobytes()
        stale = rpc.call("fabric_describe", comm.FabricDescribeRequest(
            key=key, step=20))
        assert not stale.found and stale.step == 21
        stale = rpc.call("fabric_fetch", comm.FabricFetchRequest(
            key=key, step=20, offset=0, nbytes=0))
        assert not stale.found
        if client == "jax":
            # the JAX fetcher through the port's provider, pinned steps
            _, blob, _ = jfab.fetch([jfab.FabricSource(addr=addr)], key,
                                    expect_step=21)
            assert bytes(blob) == _global_w().tobytes()
            with pytest.raises(jfab.FabricAbort):
                jfab.fetch([jfab.FabricSource(addr=addr)], key,
                           expect_step=20)
        # the metas the JAX restorer gathers from the port's service
        frames = jrs.ReshardRestorer(JOB, JaxClient(master.addr, 1),
                                     1).gather_frames([0])
        ((local, step, meta),) = frames[0]
        assert (local, step, meta["step"]) == (0, 21, 21)
    finally:
        svc0.stop()


# -- the CPU node drill ------------------------------------------------------------

# storage every 2 steps, the rejoin after the small world's step 5
DRILL_STEPS, DRILL_BATCH, DRILL_SEQ = 7, 8, 32


@pytest.fixture(scope="module")
def jax_twin(tmp_path_factory):
    """The JAX twin's unkilled losses at ``LlamaConfig.tiny()`` (f32) on
    one process, and a checkpoint directory holding its step-0 state
    (saved by the JAX engine), which the drill's twin restores first: both
    start from the same weights."""
    from dlrover_tpu.ckpt.engine import CheckpointEngine as JEngine
    from dlrover_tpu.models import llama as jl
    from dlrover_tpu.parallel.mesh import build_mesh, plan_mesh
    from dlrover_tpu.parallel.sharding import global_batch_from_local
    from dlrover_tpu.parallel.sharding import shard_tree
    from dlrover_tpu.trainer.data import (
        ElasticDataLoader,
        ElasticDistributedSampler,
    )
    from dlrover_tpu.trainer.elastic import ElasticTrainer, make_train_state
    import optax

    seed_dir = str(tmp_path_factory.mktemp("drill_seed") / "ckpt")
    config = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    plan = plan_mesh(1, tp=1, sp=1)
    mesh = build_mesh(plan, jax.devices()[:1])
    params = shard_tree(mesh, jl.init_params(config, jax.random.PRNGKey(0)),
                        jl.param_logical_axes(config))
    trainer = ElasticTrainer(
        loss_fn=lambda p, t: jl.next_token_loss(p, t, config, mesh),
        optimizer=optax.adamw(3e-4), global_batch_size=DRILL_BATCH,
        micro_batch_per_replica=max(1, DRILL_BATCH // (2 * plan.dp_total)))
    trainer.configure_for_world(plan)
    state = make_train_state(params, trainer._optimizer)
    state["sampler_epoch"] = jnp.zeros((), jnp.int32)
    state["sampler_completed"] = jnp.zeros((), jnp.int32)
    engine = JEngine(seed_dir, job_name=f"dseed{os.getpid()}", node_rank=0,
                     local_rank=0, ipc_socket="/nonexistent", world_size=1,
                     rank=0)
    assert engine.save_to_storage(0, state)
    engine._shm.unlink()
    data = np.random.default_rng(0).integers(
        0, config.vocab_size, size=(4096, DRILL_SEQ + 1), dtype=np.int32)
    sampler = ElasticDistributedSampler(len(data), num_replicas=1, rank=0,
                                        shuffle=True)
    global_bs = trainer.micro_batch_global * trainer.grad_accum_steps
    losses = {}
    for batch in ElasticDataLoader(data, batch_size=global_bs,
                                   sampler=sampler):
        if len(losses) >= DRILL_STEPS:
            break
        sampler.record_batch(global_bs)
        tokens = global_batch_from_local(mesh, batch).reshape(
            trainer.grad_accum_steps, trainer.micro_batch_global,
            DRILL_SEQ + 1)
        state, result = trainer.train_step(state, tokens)
        losses[len(losses) + 1] = float(result.loss)
    return losses, seed_dir


@pytest.mark.parametrize("replica", [True, False],
                         ids=["replica", "storage_control"])
def test_cpu_node_drill(tmp_path, jax_twin, replica):
    """Two port agents of 2 gloo workers each; agent 1 SIGKILLed once the
    stores hold both nodes' frames past storage's step (or, the control,
    once storage holds step 2), then brought back after the small world's
    step 5. The drill's own checks
    (``chip_smoke.node_drill``) hold the restores: with replicas the
    shrink from ``replica`` past storage's step, the rejoin by
    ``reshard`` on every rank, nothing from storage after the kill; the
    control's shrink from ``storage``. Losses: the JAX twin's, rtol
    1e-4."""
    sys.path.insert(0, REPO)
    import chip_smoke

    losses, seed_dir = jax_twin
    config = dataclasses.replace(llama.LlamaConfig.tiny(),
                                 dtype=torch.float32)
    chip_smoke.node_drill(
        config, torch.device("cpu"), str(tmp_path), 4,
        global_batch=DRILL_BATCH, seq=DRILL_SEQ, steps=DRILL_STEPS,
        storage_every=2, rejoin_at=5, reference=losses, replica=replica,
        pace_s=0.5, seed_dir=seed_dir, loss_tol=1e-4, timer=False)
