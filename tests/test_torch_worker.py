"""The port's worker bootstrap and control-plane clients against the JAX
package's.

- the msgpack codec (``dlrover_tpu_torch/common/msgpack.py``) gives the
  bytes of ``msgpack.packb(obj, use_bin_type=True)`` and reads them back as
  ``msgpack.unpackb(raw=False)`` does, over the subset the frames and the
  control plane use (hypothesis);
- ``worker.init`` builds the same ``WorkerContext`` as the JAX ``init``
  from the same agent environment;
- the port's ``MasterClient`` talks to the JAX package's master
  (``report_global_step`` and the KV calls), ``publish_step`` reaches the
  JAX agent's IPC server in the format its monitor reads, and
  ``training_span`` writes events the JAX goodput analysis reads.
"""

import math
import os

import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from dlrover_tpu_torch.common import msgpack as tmsgpack  # noqa: E402

ints = st.one_of(st.integers(-40, 300), st.integers(-(2 ** 63), 2 ** 64 - 1),
                 st.sampled_from([127, 128, 255, 256, 65535, 65536,
                                  2 ** 32 - 1, 2 ** 32, -32, -33, -128, -129,
                                  -32768, -32769, -(2 ** 31),
                                  -(2 ** 31) - 1]))
scalars = st.one_of(
    st.none(), st.booleans(), ints,
    st.floats(allow_nan=False),
    st.text(max_size=300), st.binary(max_size=300),
)
values = st.recursive(
    scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.dictionaries(st.one_of(st.text(max_size=40), ints), inner,
                        max_size=20),
    ),
    max_leaves=60,
)


@settings(max_examples=150, deadline=None)
@given(values)
def test_codec_bytes_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert tmsgpack.packb(obj) == want
    assert tmsgpack.unpackb(want) == msgpack.unpackb(
        want, raw=False, strict_map_key=False)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_codec_length_headers_at_their_edges(n):
    """str/bin/array/map lengths at each header's limit."""
    for obj in ("x" * n, b"x" * n, [None] * n,
                {f"{i:06d}": i for i in range(min(n, 70000))}):
        want = msgpack.packb(obj, use_bin_type=True)
        assert tmsgpack.packb(obj) == want
        assert tmsgpack.unpackb(want) == obj
    assert tmsgpack.packb(1.5) == msgpack.packb(1.5)
    assert math.isnan(tmsgpack.unpackb(msgpack.packb(float("nan"))))


def test_codec_rejects_truncated_and_trailing_bytes():
    data = msgpack.packb({"a": [1, 2, b"xyz"]}, use_bin_type=True)
    with pytest.raises(ValueError):
        tmsgpack.unpackb(data[:-1])
    with pytest.raises(ValueError):
        tmsgpack.unpackb(data + b"\x00")
    with pytest.raises(TypeError):
        tmsgpack.packb({"a": object()})


def _agent_env(monkeypatch, **extra):
    monkeypatch.delenv("TPU_TIMER_ENABLE", raising=False)
    monkeypatch.delenv("DLROVER_TPU_IPC_SOCKET", raising=False)
    env = {
        "DLROVER_TPU_RANK": "3", "DLROVER_TPU_WORLD_SIZE": "4",
        "DLROVER_TPU_LOCAL_RANK": "1", "DLROVER_TPU_LOCAL_WORLD_SIZE": "2",
        "DLROVER_TPU_NODE_RANK": "1", "DLROVER_TPU_NODE_NUM": "2",
        "DLROVER_TPU_NODE_ID": "5", "DLROVER_TPU_RESTART_COUNT": "2",
        "DLROVER_TPU_JOB_NAME": "portjob",
        "DLROVER_TPU_COMPILE_CACHE": "off",
        "DLROVER_TPU_PROFILE_LISTENER": "0",
        **extra,
    }
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("master", [False, True])
def test_init_gives_the_jax_worker_context(monkeypatch, master):
    import dataclasses

    from dlrover_tpu import worker as jworker
    from dlrover_tpu_torch import worker as tworker

    _agent_env(monkeypatch, **({"DLROVER_TPU_MASTER_ADDR": "127.0.0.1:9"}
                               if master else {}))
    jctx = jworker.init(initialize_jax_distributed=False)
    tctx = tworker.init(initialize_distributed=False, device="cpu")
    for f in dataclasses.fields(jctx):
        if f.name == "master":
            continue
        assert getattr(tctx, f.name) == getattr(jctx, f.name), f.name
    assert (tctx.master is None) == (jctx.master is None)
    if master:
        assert tctx.master.master_addr == jctx.master.master_addr
        assert tctx.master.node_id == jctx.master.node_id == 5
    assert tctx.is_leader == jctx.is_leader is False
    assert tctx.device == torch.device("cpu")


def test_master_client_reaches_the_jax_master(monkeypatch):
    from dlrover_tpu.master.master import LocalJobMaster
    from dlrover_tpu_torch.agent.master_client import MasterClient

    monkeypatch.delenv("DLROVER_TPU_HTTP_PORT", raising=False)
    master = LocalJobMaster(job_name=f"portmc{os.getpid()}", node_num=1)
    master.prepare()
    try:
        client = MasterClient(master.addr, node_id=0)
        client.report_global_step(7)
        assert master.perf_monitor.completed_global_step == 7
        client.kv_set("port/k", b"v1")
        assert client.kv_get("port/k") == b"v1"
        assert client.kv_get("port/missing") is None
        assert client.kv_wait("port/k", timeout_s=5.0) == b"v1"
        assert client.kv_multi_get(["port/k", "port/missing"]) == [b"v1",
                                                                  b""]
    finally:
        master.stop()


def test_publish_step_feeds_the_jax_agent_monitor(monkeypatch, tmp_path):
    from dlrover_tpu.agent.monitor import (
        TRAINING_METRICS_DICT,
        device_stats_from_ipc,
    )
    from dlrover_tpu.common.multi_process import LocalIPCServer
    from dlrover_tpu_torch import worker as tworker

    sock = str(tmp_path / "ipc.sock")
    server = LocalIPCServer(sock)
    server.start()
    try:
        _agent_env(monkeypatch, DLROVER_TPU_IPC_SOCKET=sock)
        ctx = tworker.init(initialize_distributed=False, device="cpu")
        ctx.publish_step(3)  # CPU: no card memory to publish
        metrics = server.local_dict(TRAINING_METRICS_DICT)
        assert metrics["step"] == 3 and "hbm/1" not in metrics
        # on a card the memory goes through the _cuda_memory seam
        fake = {1: {"hbm_used_mb": 512.0, "hbm_total_mb": 81559.0,
                    "hbm_peak_mb": 600.0}}
        monkeypatch.setattr(tworker, "_cuda_memory", lambda dev: fake)
        ctx.device = torch.device("cuda", 1)
        ctx._last_hbm_publish = 0.0
        ctx.publish_step(4)
        assert metrics["step"] == 4
        assert device_stats_from_ipc(server) == {
            1: {"hbm_used_mb": 512.0, "hbm_total_mb": 81559.0}}
    finally:
        server.stop()


def test_training_span_is_read_by_the_jax_goodput_analysis(monkeypatch,
                                                           tmp_path):
    from dlrover_tpu.common.event import compute_goodput, load_events
    from dlrover_tpu_torch import worker as tworker

    _agent_env(monkeypatch, DLROVER_TPU_EVENT_DIR=str(tmp_path))
    ctx = tworker.init(initialize_distributed=False, device="cpu")
    with ctx.training_span(steps=2):
        pass
    records = load_events(str(tmp_path / "events_worker_3.jsonl"))
    assert [r["phase"] for r in records] == ["BEGIN", "END"]
    assert records[1]["content"]["ok"] is True
    assert compute_goodput(records)["productive_s"] >= 0.0


def test_init_refuses_a_world_without_coordinator(monkeypatch):
    from dlrover_tpu_torch import worker as tworker

    _agent_env(monkeypatch)
    monkeypatch.delenv("DLROVER_TPU_COORDINATOR_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="COORDINATOR"):
        tworker.init(device="cpu")
