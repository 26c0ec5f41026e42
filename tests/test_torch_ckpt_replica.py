"""The port's checkpoint replicas (``dlrover_tpu_torch/ckpt/replica.py``)
against the JAX package's (``tests/test_replica.py``), on real stores on
localhost and a port master's KV for their addresses:

- ``backup_peers`` equals the JAX function for 1-9 nodes and groups of
  1-4;
- a push and its fetch round-trip byte-identically, whole and in
  chunks; a store's frame older than the segment's is not written back;
- the wire both ways: a port agent's manager pushes to a JAX store and
  fetches back, and a JAX agent's manager pushes to a port store, blobs
  equal;
- the JAX engine restores, bitwise, a state the port's engine sealed and
  its agent's store forwarded to a JAX store, after the segment is gone;
- a port engine whose segment was unlinked writes its frame back from
  the agent's store and restores it (``written_back``), and a frame that
  fails its CRCs is refused both as a repair and as a peer frame;
- the port's same-host put: the own node's port store copies the frame
  out of the segment and forwards it to a JAX or port peer store; its
  write-back writes a new segment; both refuse a segment that is not of
  the store's job and node;
- the ladder's order at storage's tracked step: storage first, the
  stores' copy of that step when storage's frames are corrupt.

Every comparison is exact (bitwise): frames move as bytes.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.agent.master_client import MasterClient as JaxClient  # noqa: E402,E501
from dlrover_tpu.ckpt import replica as jrep  # noqa: E402
from dlrover_tpu.ckpt.engine import CheckpointEngine as JaxEngine  # noqa: E402

from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.ckpt import replica as trep  # noqa: E402
from dlrover_tpu_torch.ckpt.engine import CheckpointEngine  # noqa: E402
from dlrover_tpu_torch.ckpt.shm_handler import (  # noqa: E402
    SharedMemoryHandler,
    shm_name,
    verify_frame_blob,
)
from dlrover_tpu_torch.common.multi_process import (  # noqa: E402
    unlink_shared_memory,
)
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402

JOB = f"trepl{os.getpid()}"
HOST = "127.0.0.1"


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
    for name in os.listdir("/dev/shm"):
        if name.startswith(f"dlrtpu_{JOB}_"):
            unlink_shared_memory(name)


def _write_frame(node_rank, step, value, shape=(4, 4), name=None):
    shm = SharedMemoryHandler(name or shm_name(JOB, node_rank, 0))
    arr = np.full(shape, value, dtype=np.float32)
    meta = {"step": step, "ts": 0.0, "job": JOB, "node_rank": node_rank,
            "local_rank": 0, "rank": node_rank, "world_size": 2,
            "leaves": [{"path": "['w']", "kind": "array",
                        "dtype": "float32", "gshape": list(shape),
                        "shards": [{"offset": 0, "nbytes": arr.nbytes,
                                    "lshape": list(shape),
                                    "start": [0] * len(shape)}]}]}
    shm.write_frame(meta, [arr])
    return shm


def _services(n=2, jax_side=()):
    """``n`` started stores; those in ``jax_side`` are the JAX
    package's."""
    out = []
    for i in range(n):
        svc = (jrep.ReplicaService if i in jax_side
               else trep.ReplicaService)(host=HOST)
        svc.start()
        out.append(svc)
    return out


def test_backup_peers_match_jax():
    for node_num in range(1, 10):
        for group in range(1, 5):
            for rank in range(node_num):
                assert trep.backup_peers(rank, node_num, group) == \
                    jrep.backup_peers(rank, node_num, group)
    assert trep.frame_key(3, 1) == jrep.frame_key(3, 1) == "frame/3/1"


@pytest.mark.parametrize("chunk", [None, 64])
def test_push_and_fetch_roundtrip(master, monkeypatch, chunk):
    """Node 0 pushes to its store and node 1's; after its segment is gone a
    fresh manager (no store of its own) fetches the frame back over the
    fabric and writes it into a new segment."""
    if chunk is not None:
        monkeypatch.setattr(trep.ReplicaManager, "CHUNK_BYTES", chunk)
    svc0, svc1 = _services()
    try:
        c0, c1 = MasterClient(master.addr, 0), MasterClient(master.addr, 1)
        m0 = trep.ReplicaManager(JOB, 0, 2, c0, service=svc0, host=HOST)
        trep.ReplicaManager(JOB, 1, 2, c1, service=svc1, host=HOST)
        shm0 = _write_frame(0, 9, 3.25)
        blob = bytes(shm0.read_frame_bytes())
        if chunk is not None:
            assert len(blob) > 3 * chunk
        assert m0.backup(shm0, 0) == 2
        assert svc1.get(0, 0) == (9, blob)
        assert m0.last_push["step"] == 9 and m0.last_push["stores"] == 2
        shm0.unlink()
        m0b = trep.ReplicaManager(JOB, 0, 2, c0, service=None, host=HOST)
        step, fetched = m0b.fetch(0)
        assert step == 9 and bytes(fetched) == blob
        assert sorted(m0b.list_entries()) == [(0, 0, 9)]
        assert m0b.newest_step() == 9
        fresh = SharedMemoryHandler(shm_name(JOB, 0, 0))
        assert m0b.try_restore_shm(fresh, 0) == 9
        assert bytes(fresh.read_frame_bytes()) == blob
        assert verify_frame_blob(blob) == []
    finally:
        svc0.stop()
        svc1.stop()


def test_stale_replica_not_restored(master):
    svc0, svc1 = _services()
    try:
        c0 = MasterClient(master.addr, 0)
        m0 = trep.ReplicaManager(JOB, 0, 2, c0, service=svc0, host=HOST)
        trep.ReplicaManager(JOB, 1, 2, MasterClient(master.addr, 1),
                            service=svc1, host=HOST)
        shm0 = _write_frame(0, 3, 1.0)
        m0.backup(shm0, 0)
        _write_frame(0, 7, 2.0)  # the segment moves past the stores
        assert m0.try_restore_shm(shm0, 0) == 7
        assert shm0.step == 7
    finally:
        svc0.stop()
        svc1.stop()


@pytest.mark.parametrize("jax_store", [0, 1], ids=["jax_store_0",
                                                   "jax_store_1"])
def test_wire_both_ways(master, monkeypatch, jax_store):
    """One node's agent the JAX package's, the other's the port's: each
    agent's manager pushes its node's frame (chunked) to its own store and
    the peer's, and a worker-side manager of the other package fetches it
    back from both stores, byte-identical."""
    monkeypatch.setattr(trep.ReplicaManager, "CHUNK_BYTES", 96)
    monkeypatch.setattr(jrep.ReplicaManager, "CHUNK_BYTES", 96)
    stores = _services(jax_side=(jax_store,))
    port_node = 1 - jax_store
    try:
        port_m = trep.ReplicaManager(
            JOB, port_node, 2, MasterClient(master.addr, port_node),
            service=stores[port_node], host=HOST)
        jax_m = jrep.ReplicaManager(
            JOB, jax_store, 2, JaxClient(master.addr, jax_store),
            service=stores[jax_store], host=HOST)
        shm_p = _write_frame(port_node, 4, 1.5, shape=(8, 6))
        blob = bytes(shm_p.read_frame_bytes())
        assert port_m.backup(shm_p, 0) == 2
        for svc in stores:
            assert svc.get(port_node, 0) == (4, blob)
        # a JAX worker's manager fetches what the port pushed, from both
        jax_w = jrep.ReplicaManager(JOB, port_node, 2,
                                    JaxClient(master.addr, port_node),
                                    host=HOST)
        step, got = jax_w.fetch(0)
        assert step == 4 and bytes(got) == blob
        # the JAX agent pushes its node's frame; a port worker fetches it
        shm_j = _write_frame(jax_store, 5, 2.5, shape=(8, 6))
        blob_j = bytes(shm_j.read_frame_bytes())
        assert jax_m.backup(shm_j, 0) == 2
        port_w = trep.ReplicaManager(JOB, jax_store, 2,
                                     MasterClient(master.addr, jax_store),
                                     host=HOST)
        step, got = port_w.fetch(0)
        assert step == 5 and bytes(got) == blob_j
        assert stores[port_node].get(jax_store, 0) == (5, blob_j)
        # the port's store keeps an owner's last two steps, the JAX one
        # its newest
        shm_p6 = _write_frame(port_node, 6, 3.5, shape=(8, 6))
        blob6 = bytes(shm_p6.read_frame_bytes())
        assert port_m.backup(shm_p6, 0) == 2
        assert sorted(stores[port_node].entries()) == sorted(
            [[port_node, 0, 4], [port_node, 0, 6], [jax_store, 0, 5]])
        assert sorted(stores[jax_store].entries()) == sorted(
            [[port_node, 0, 6], [jax_store, 0, 5]])
        assert sorted(port_m.list_entries()) == sorted(
            [(port_node, 0, 4), (port_node, 0, 6), (jax_store, 0, 5)])
        assert port_m.fetch_frame(port_node, 0, step=4) == (4, blob)
        step, got = jax_w.fetch(0)
        assert step == 6 and bytes(got) == blob6
    finally:
        for svc in stores:
            svc.stop()


def _port_state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(8, 4, generator=g),
            "b": torch.randn(6, generator=g).to(torch.bfloat16),
            "count": torch.tensor(7, dtype=torch.int32), "lr": 0.25}


def test_jax_engine_restores_a_port_pushed_frame(master, tmp_path):
    """The port's engine seals the frame and the drain hands it to its
    agent's port store, whose forwarder pushes it to the peer node's JAX
    store; with the segment and the port store gone, the JAX engine
    writes it back from the JAX store and restores it bitwise."""
    svc0 = _services(1)[0]
    svc1 = _services(1, jax_side=(0,))[0]
    try:
        c0 = MasterClient(master.addr, 0)
        svc0.forwarder = trep.ReplicaManager(JOB, 0, 2, c0, service=svc0,
                                             host=HOST)
        svc1.register(MasterClient(master.addr, 1), JOB, 1, host=HOST)
        manager = trep.ReplicaManager(JOB, 0, 2, c0, host=HOST)
        engine = CheckpointEngine(
            str(tmp_path), job_name=JOB, node_rank=0, local_rank=0,
            ipc_socket="/nonexistent", world_size=1, rank=0,
            replica_manager=manager)
        state = _port_state()
        assert engine.save_to_memory(11, state)
        assert engine.wait_drained(60)
        assert manager.last_push["stores"] == 2
        assert svc1.get(0, 0)[0] == 11
        engine._shm.unlink()
        svc0.stop()
        jax_m = jrep.ReplicaManager(JOB, 0, 2, JaxClient(master.addr, 0),
                                    host=HOST)
        jax_engine = JaxEngine(
            str(tmp_path), job_name=JOB, node_rank=0, local_rank=0,
            ipc_socket="/nonexistent", world_size=1, rank=0,
            replica_manager=jax_m)
        target = {"w": jnp.zeros((8, 4), jnp.float32),
                  "b": jnp.zeros((6,), jnp.bfloat16),
                  "count": jnp.zeros((), jnp.int32), "lr": 0.0}
        restored, step = jax_engine.load(target)
        assert step == 11
        np.testing.assert_array_equal(np.asarray(restored["w"]),
                                      state["w"].numpy())
        assert (np.asarray(restored["b"]).view(np.uint16).tolist()
                == state["b"].view(torch.int16).numpy().view(
                    np.uint16).tolist())
        assert int(restored["count"]) == 7 and restored["lr"] == 0.25
    finally:
        svc0.stop()
        svc1.stop()


def test_port_engine_writes_back_its_frame(master, tmp_path):
    """A restarted worker whose segment was unlinked: the write-back rung
    puts the agent's copy into a new segment and the shm rung restores
    it; ``last_restore`` says so."""
    svc0 = _services(1)[0]
    try:
        c0 = MasterClient(master.addr, 0)
        svc0.register(c0, JOB, 0, host=HOST)

        def engine():
            return CheckpointEngine(
                str(tmp_path), job_name=JOB, node_rank=0, local_rank=0,
                ipc_socket="/nonexistent", world_size=1, rank=0,
                replica_manager=trep.ReplicaManager(JOB, 0, 1, c0,
                                                    host=HOST))

        first = engine()
        state = _port_state()
        assert first.save_to_memory(9, state)
        assert first.wait_drained(60)
        first._shm.unlink()
        target = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                      else 0.0) for k, v in state.items()}
        second = engine()
        restored, step = second.load(target)
        assert step == 9
        assert second.last_restore["medium"] == "shm"
        assert second.last_restore["written_back"] == "replica"
        for k in ("w", "b", "count"):
            assert torch.equal(restored[k], state[k])
        assert restored["lr"] == 0.25
    finally:
        svc0.stop()


def test_torn_store_copy_is_refused(master, tmp_path):
    """A frame torn after its seal is pushed as it is: the store's copy
    fails ``verify_frame_blob``, so neither the forced repair of the
    torn segment nor the peer-frame rung restores from it."""
    from dlrover_tpu_torch.chaos import configure, reset_injector

    svc0 = _services(1)[0]
    try:
        c0 = MasterClient(master.addr, 0)
        svc0.register(c0, JOB, 0, host=HOST)
        manager = trep.ReplicaManager(JOB, 0, 1, c0, host=HOST)
        engine = CheckpointEngine(
            str(tmp_path), job_name=JOB, node_rank=0, local_rank=0,
            ipc_socket="/nonexistent", world_size=1, rank=0,
            replica_manager=manager)
        configure("shm.write:torn@step=6")
        try:
            state = _port_state()
            state["w"] = torch.ones(64, 64)
            assert engine.save_to_memory(6, state)
            assert engine.wait_drained(60)
        finally:
            reset_injector()
        step, blob = svc0.get(0, 0)
        assert step == 6 and verify_frame_blob(blob)
        target = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                      else 0.0) for k, v in state.items()}
        restored, got = engine.load(target)
        assert got == -1 and engine.last_restore["medium"] is None
    finally:
        svc0.stop()


@pytest.mark.parametrize("peer", ["port", "jax"])
def test_local_put_copies_the_segment_and_forwards(master, peer):
    """A worker hands its sealed frame to its own agent's port store by
    name: the store copies it out of the segment and pushes it to the
    peer's store (the JAX package's or the port's) on the reference's
    wire before it answers; its write-back writes the frame into a new
    segment."""
    svc0 = _services(1)[0]
    svc1 = _services(1, jax_side=(0,) if peer == "jax" else ())[0]
    try:
        c0 = MasterClient(master.addr, 0)
        svc0.forwarder = trep.ReplicaManager(JOB, 0, 1, c0, service=svc0,
                                             host=HOST)
        svc1.register(MasterClient(master.addr, 1), JOB, 1, host=HOST)
        worker_side = trep.ReplicaManager(JOB, 0, 2, c0, host=HOST)
        shm0 = _write_frame(0, 12, 4.5, shape=(16, 8))
        blob = bytes(shm0.read_frame_bytes())
        assert worker_side.backup_async(shm0, 0) is True
        assert worker_side.last_push["copy_s"] >= 0
        assert worker_side.last_push["stores"] == 2
        assert worker_side.last_push["bytes"] == len(blob)
        assert svc0.get(0, 0) == (12, blob) and svc1.get(0, 0) == (12, blob)
        shm0.unlink()
        fresh = SharedMemoryHandler(shm_name(JOB, 0, 0))
        assert worker_side.write_local(fresh, 12, 0) == (True, [])
        assert bytes(fresh.read_frame_bytes()) == blob
        # a step the store does not hold: nothing written
        assert worker_side.write_local(fresh, 11, 0) is None
    finally:
        svc0.stop()
        svc1.stop()


@pytest.mark.parametrize("foreign", ["job", "node", "owner", "unregistered"])
def test_local_methods_refuse_foreign_segments(master, foreign):
    """``replica_put_local`` and ``replica_write_local`` open the segment
    a request names: a store takes only its own job's and node's worker
    segments, for its own node as owner, and none before it is
    registered; a refusal neither stores nor writes anything."""
    from dlrover_tpu_torch.common import comm

    svc0 = _services(1)[0]
    try:
        if foreign != "unregistered":
            svc0.register(MasterClient(master.addr, 0), JOB, 0, host=HOST)
        other = {"job": shm_name(JOB + "x", 0, 0),
                 "node": shm_name(JOB, 1, 0)}.get(foreign,
                                                  shm_name(JOB, 0, 0))
        victim = _write_frame(0, 3, 2.0, name=other)
        before = bytes(victim.read_frame_bytes())
        src = _write_frame(7, 3, 9.0)
        owner = 1 if foreign == "owner" else 0
        svc0.put(owner, 0, 3, bytes(src.read_frame_bytes()))
        src.unlink()
        req = comm.ReplicaLocalRequest(owner_rank=owner, local_rank=0,
                                       step=3, shm_name=other, peers=[])
        put = svc0._on_put_local(req)
        wrote = svc0._on_write_local(req)
        assert not put.success and put.message.startswith("refused")
        assert not wrote.success and wrote.message.startswith("refused")
        assert bytes(victim.read_frame_bytes()) == before
        assert svc0.entries() == [[owner, 0, 3]]
        # the store's own segment of its own node is taken
        if foreign == "unregistered":
            svc0.register(MasterClient(master.addr, 0), JOB, 0, host=HOST)
            assert svc0._on_put_local(req).success
    finally:
        svc0.stop()
        unlink_shared_memory(shm_name(JOB + "x", 0, 0))


@pytest.mark.parametrize("storage", ["intact", "corrupt"])
def test_storage_step_ties_and_falls_back_to_the_stores(master, tmp_path,
                                                        storage):
    """Storage and the stores both hold step 5 of node 0's frame; a
    restarted world on node 1 (no frame of its own, no newer step in the
    stores) restores it from storage, and from the stores' intact copy of
    that step when storage's frame fails its CRCs (the reference's peer
    rung serves any step the stores hold)."""
    svc0 = _services(1)[0]
    try:
        c0 = MasterClient(master.addr, 0)
        svc0.forwarder = trep.ReplicaManager(JOB, 0, 1, c0, service=svc0,
                                             host=HOST)
        ckpt_dir = str(tmp_path / "ckpt")
        first = CheckpointEngine(
            ckpt_dir, job_name=JOB, node_rank=0, local_rank=0,
            ipc_socket="/nonexistent", world_size=1, rank=0,
            replica_manager=trep.ReplicaManager(JOB, 0, 1, c0, host=HOST))
        state = _port_state()
        assert first.save_to_storage(5, state)
        assert first.wait_drained(60)
        assert svc0.get(0, 0)[0] == 5
        from dlrover_tpu_torch.ckpt.ckpt_saver import latest_step
        from dlrover_tpu_torch.ckpt.manifest import frame_file

        assert latest_step(ckpt_dir) == 5
        if storage == "corrupt":
            path = frame_file(ckpt_dir, 5, 0, 0)
            with open(path, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                last = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([last[0] ^ 0xFF]))
        first._shm.unlink()
        second = CheckpointEngine(
            ckpt_dir, job_name=JOB, node_rank=1, local_rank=0,
            ipc_socket="/nonexistent", world_size=1, rank=0,
            replica_manager=trep.ReplicaManager(
                JOB, 1, 2, MasterClient(master.addr, 1), host=HOST))
        target = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                      else 0.0) for k, v in state.items()}
        restored, step = second.load(target)
        assert step == 5
        assert second.last_restore["medium"] == (
            "storage" if storage == "intact" else "replica")
        for k in ("w", "b", "count"):
            assert torch.equal(restored[k], state[k])
    finally:
        svc0.stop()


def test_breakpoint_save_keeps_the_frames_world_quorum(tmp_path):
    """C29: after a shrink the agent's saver counts the smaller world, but
    a frame the old world sealed (its meta: 2 frames a step) does not
    commit its step with this host's frame alone: the tracker stays where
    the whole world left it (the parent commits the partial step)."""
    import time

    from dlrover_tpu_torch.ckpt import ckpt_saver
    from dlrover_tpu_torch.common.multi_process import LocalIPCServer

    ckpt_dir = str(tmp_path / "ckpt")
    server = LocalIPCServer(str(tmp_path / "ipc.sock"))
    server.start()
    saver = ckpt_saver.AsyncCheckpointSaver(
        ckpt_dir=ckpt_dir, node_rank=0, local_world_size=1,
        expected_frames=1)  # the shrunk world's
    saver.start(server)
    engine = CheckpointEngine(ckpt_dir, job_name=JOB, node_rank=0,
                              local_rank=0, ipc_socket=server.path,
                              world_size=2, rank=0)  # the old world's
    try:
        assert engine.save_to_memory(7, _port_state(), blocking=True)
        assert saver.save_shm_to_storage(reason="peer died",
                                         workers_dead=True,
                                         async_commit=True) == 1
        time.sleep(1.0)
        assert ckpt_saver.latest_step(ckpt_dir) == -1
    finally:
        saver.stop()
        server.stop()
