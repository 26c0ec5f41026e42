"""A live worker's ``torch.profiler`` capture runs on its main thread.

The profile listener (``dlrover_tpu_torch/observability/profiler.py``)
hands a request for the main thread to it, whose step boundaries start
the capture and, once its window has passed, stop it, write the trace and
post ``done``, however long a step takes; a request for the listener
thread (the hang path's, for a wedged worker) is captured there. The
straggler rule's ``STACK_DUMP`` requests a main-thread profile of the
rank it names (``agent/training.py``), as the reference's dump requests
one, and reports the trace beside the stack.
"""

import json
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from dlrover_tpu_torch.agent.config import ElasticLaunchConfig  # noqa: E402
from dlrover_tpu_torch.agent.training import (  # noqa: E402
    ElasticTrainingAgent,
    _Worker,
)
from dlrover_tpu_torch.common.multi_process import (  # noqa: E402
    LocalIPCServer,
)
from dlrover_tpu_torch.observability import profiler  # noqa: E402


@pytest.fixture
def ipc():
    sock = f"/tmp/dtpu_pc_{os.getpid()}_{threading.get_ident() % 997}.sock"
    server = LocalIPCServer(sock)
    server.start()
    yield sock, server.local_dict(profiler.PROFILE_DICT)
    server.stop()


class _Recorder:
    """Records on which step boundary the listener began and finished a
    capture."""

    def __init__(self, listener, monkeypatch):
        self.step = -1
        self.events = []
        begin, finish = listener._begin, listener._finish

        def _begin(req):
            self.events.append(("begin", self.step,
                                threading.current_thread().name))
            live = begin(req)
            self.end = live.end
            return live

        def _finish(live):
            self.events.append(("finish", self.step,
                                threading.current_thread().name))
            return finish(live)

        monkeypatch.setattr(listener, "_begin", _begin)
        monkeypatch.setattr(listener, "_finish", _finish)


def _trace_ops(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "cpu_op"]


def test_main_thread_capture_starts_and_stops_at_step_boundaries(
        ipc, tmp_path, monkeypatch):
    sock, pdict = ipc
    listener = profiler.ProfileListener(sock, 0, out_root=str(tmp_path),
                                        poll_s=0.02)
    rec = _Recorder(listener, monkeypatch)
    listener.start()
    try:
        req = profiler.request_profile(pdict, 0, duration_s=0.3,
                                       thread=profiler.THREAD_MAIN)
        a = torch.randn(64, 64)
        boundaries = []
        done = None
        deadline = time.monotonic() + 20
        while done is None and time.monotonic() < deadline:
            for _ in range(5):
                a = torch.tanh(a @ a)
            rec.step += 1
            boundaries.append(time.monotonic())
            profiler.step_boundary()  # the worker's step hook
            time.sleep(0.02)
            got = pdict.get(profiler.done_key(0))
            done = got if got and got.get("id") == req else None
    finally:
        listener.stop()
    assert done is not None and done["ok"] and done["thread"] == "main"
    (b, b_step, b_thread), (f, f_step, f_thread) = rec.events
    assert (b, f) == ("begin", "finish")
    assert b_thread == f_thread == threading.main_thread().name
    # started at one boundary, stopped at the first boundary 0.3 s after
    # the profile was up
    assert 0 <= b_step < f_step
    assert boundaries[f_step - 1] < rec.end <= boundaries[f_step]
    ops = _trace_ops(done["path"])
    assert any(e.get("name") == "aten::mm" for e in ops)
    assert profiler._active is None


def test_main_thread_request_waits_for_a_step_longer_than_its_window(
        ipc, tmp_path, monkeypatch):
    """A straggler's step outlasts the capture's window many times over:
    the capture still starts and stops on the main thread, at its step
    boundaries, and the listener thread never touches the profiler."""
    sock, pdict = ipc
    listener = profiler.ProfileListener(sock, 0, out_root=str(tmp_path),
                                        poll_s=0.02)
    rec = _Recorder(listener, monkeypatch)
    listener.start()
    step_s = 1.2  # 6x the window
    try:
        req = profiler.request_profile(pdict, 0, duration_s=0.2,
                                       thread=profiler.THREAD_MAIN)
        a = torch.randn(64, 64)
        done = None
        deadline = time.monotonic() + 20
        while done is None and time.monotonic() < deadline:
            t = time.monotonic()
            while time.monotonic() - t < step_s:  # one slow step
                a = torch.tanh(a @ a)
            rec.step += 1
            profiler.step_boundary()
            got = pdict.get(profiler.done_key(0))
            done = got if got and got.get("id") == req else None
    finally:
        listener.stop()
    assert done is not None and done["ok"] and done["thread"] == "main"
    main = threading.main_thread().name
    # taken at the first boundary after the request, stopped at the next
    assert rec.events == [("begin", 0, main), ("finish", 1, main)]
    assert any(e.get("name") == "aten::mm" for e in _trace_ops(done["path"]))


def test_listener_request_is_captured_on_the_listener_thread(
        ipc, tmp_path, monkeypatch):
    """The hang path's request (the default) is served by the listener
    thread, with or without step boundaries."""
    sock, pdict = ipc
    listener = profiler.ProfileListener(sock, 0, out_root=str(tmp_path),
                                        poll_s=0.02)
    rec = _Recorder(listener, monkeypatch)
    listener.start()
    try:
        req = profiler.request_profile(pdict, 0, duration_s=0.3)
        a = torch.randn(64, 64)
        done = None
        deadline = time.monotonic() + 20
        while done is None and time.monotonic() < deadline:
            a = torch.tanh(a @ a)  # busy; a boundary changes nothing
            profiler.step_boundary()
            done = profiler.await_profile(pdict, 0, req, timeout_s=0.05)
    finally:
        listener.stop()
    assert done is not None and done["ok"]
    assert done["thread"] == "listener"
    assert [(e[0], e[2]) for e in rec.events] == [
        ("begin", "profile-listener"), ("finish", "profile-listener")]
    with open(done["path"]) as f:
        assert json.load(f)["traceEvents"]


def test_stop_ends_a_main_thread_capture_and_answers_a_pending_request(
        ipc, tmp_path):
    sock, pdict = ipc
    listener = profiler.ProfileListener(sock, 0, out_root=str(tmp_path),
                                        poll_s=0.02)
    listener.start()
    req = profiler.request_profile(pdict, 0, duration_s=30.0,
                                   thread=profiler.THREAD_MAIN)
    deadline = time.monotonic() + 10
    while listener._live is None and time.monotonic() < deadline:
        profiler.step_boundary()
        time.sleep(0.02)
    assert listener._live is not None  # a capture far from its end
    listener.stop()  # the worker exits: its capture ends and is reported
    done = pdict.get(profiler.done_key(0))
    assert done["id"] == req and done["ok"] and done["thread"] == "main"
    # a request no boundary took before the worker stopped is answered
    other = profiler.ProfileListener(sock, 1, out_root=str(tmp_path),
                                     poll_s=0.02)
    other.start()
    req = profiler.request_profile(pdict, 1, duration_s=30.0,
                                   thread=profiler.THREAD_MAIN)
    deadline = time.monotonic() + 10
    while other._offer is None and time.monotonic() < deadline:
        time.sleep(0.02)
    other.stop()
    done = pdict.get(profiler.done_key(1))
    assert done["id"] == req and done["ok"] is False


class _Client:
    def __init__(self):
        self.events = []

    def report_event(self, kind, data):
        self.events.append((kind, data))


class _Proc:
    pid = os.getpid()

    def poll(self):
        return None


def test_straggler_stack_dump_requests_the_named_ranks_profile(tmp_path):
    job = f"pc{os.getpid() % 100000}"
    client = _Client()
    agent = ElasticTrainingAgent(
        ElasticLaunchConfig(min_nodes=1, max_nodes=1, nproc_per_node=2,
                            job_name=job, master_addr="127.0.0.1:1"),
        client)
    agent._ipc_server.start()
    listener = None
    try:
        agent._workers = [_Worker(0, 4, _Proc()), _Worker(1, 5, _Proc())]
        stacks = []
        agent._diagnosis.capture_worker_stacks = lambda pid=None, **k: (
            stacks.append(pid) or str(tmp_path / "stacks.json"))
        # local rank 1's worker: a listener on the agent's socket, this
        # thread its main thread
        listener = profiler.ProfileListener(
            agent._ipc_server.path, 1, out_root=str(tmp_path),
            poll_s=0.02)
        listener.start()
        agent._capture_stack_dump({"rank": 5, "cause": "compute"})
        a = torch.randn(32, 32)
        deadline = time.monotonic() + 60
        while agent._dump_thread.is_alive() and time.monotonic() < deadline:
            a = torch.tanh(a @ a)
            profiler.step_boundary()
            time.sleep(0.02)
        agent._dump_thread.join(1)
        pdict = agent._ipc_server.local_dict(profiler.PROFILE_DICT)
        assert pdict.get(profiler.request_key(1))["thread"] == "main"
        assert pdict.get(profiler.request_key(0)) is None  # not named
        assert stacks == [_Proc.pid]
        (kind, data), = client.events
        assert kind == "stack_dump_captured"
        assert data["rank"] == 5 and data["cause"] == "compute"
        assert data["path"] == str(tmp_path / "stacks.json")
        assert data["profile_ok"] and data["profile_thread"] == "main"
        assert os.path.exists(data["profile"])
    finally:
        if listener is not None:
            listener.stop()
        agent._ipc_server.stop()
        agent._flight_recorder.close()
