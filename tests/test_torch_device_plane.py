"""The port's device plane in Python against the JAX package's, and the
hang loop end to end on the CPU.

- ``TpuTimer`` spans, ``trace_function`` and ``install_tracepoints`` give
  the reference's metric families and counts (each package over its own
  native engine, the reference's built here from ``tpu_timer/src``);
- ``stack_viewer`` folds the same faulthandler dumps to the same counts;
- ``replay.select_matmuls`` picks the same events from one trace, and the
  port's replay runs a captured shape exactly (the reference's square of
  equal FLOPs without one);
- ``timeline.merge_timelines`` of one worker trace and one master journal
  writes the reference's events;
- ``TpuTimerCollector`` parses one daemon page into the reference's dict,
  and ``_maybe_capture_stacks`` keeps the reference's cooldown and retry
  against a fake daemon;
- ``ProfileListener`` answers a request over the port's ``SharedDict``
  with a ``torch.profiler`` trace, and a relaunched listener does not
  replay the old request;
- the native engine keeps the op-class telemetry over what it records: a
  span around N hooked GEMMs counts N + 1, a hooked copy has no class, a
  collective's entry is marked at the call and its duration taken once
  its end event completes, and the JAX skew monitor reads the wire;
- the hang loop: a port agent's beats carrying ``XPU_TIMER_COMMON_HANG`` =
  1 make both the port's master and the JAX master's
  ``TrainingHangDiagnostician`` resolve ``training_hang`` with a wedged
  restart, and at 0 ``step_stall``; and a real port agent run with
  ``tpu_timer`` on a worker that wedges: the beats carry the gauge, the
  master restarts the workers wedged, the daemon's stack dump holds the
  wedged frame, a profile is requested, and the next incarnation ends.

Subprocesses and servers bind free ports; each has a 30 s limit.
"""

import faulthandler
import http.server
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from dlrover_tpu.diagnosis import diagnosis_agent as jax_diag  # noqa: E402
from dlrover_tpu.diagnosis import diagnosis_master as jax_dm  # noqa: E402
from dlrover_tpu.master.master import LocalJobMaster as JaxMaster  # noqa: E402
from dlrover_tpu.observability import replay as jax_replay  # noqa: E402
from dlrover_tpu.observability import stack_viewer as jax_sv  # noqa: E402
from dlrover_tpu.observability import timeline as jax_timeline  # noqa: E402

from dlrover_tpu_torch.agent.config import ElasticLaunchConfig  # noqa: E402
from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.agent.training import (  # noqa: E402
    ElasticTrainingAgent,
)
from dlrover_tpu_torch.common.config import get_context  # noqa: E402
from dlrover_tpu_torch.common.constants import (  # noqa: E402
    DiagnosisActionType,
)
from dlrover_tpu_torch.common.multi_process import (  # noqa: E402
    LocalIPCServer,
)
from dlrover_tpu_torch.common.rpc import find_free_port  # noqa: E402
from dlrover_tpu_torch.diagnosis import diagnosis_agent  # noqa: E402
from dlrover_tpu_torch.diagnosis import diagnosis_master  # noqa: E402
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402
from dlrover_tpu_torch.observability import (  # noqa: E402
    profiler,
    replay,
    stack_viewer,
    timeline,
)
from dlrover_tpu_torch.observability.journal import (  # noqa: E402
    EventJournal,
)
from dlrover_tpu_torch.tpu_timer import build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests", "data"))

from torch_tpu_timer_ref import build_reference  # noqa: E402

WORKER = os.path.join(REPO, "tests", "data", "torch_timer_worker.py")


def _free_port() -> int:
    return find_free_port("127.0.0.1")


class _Server:
    """A local HTTP server whose GET routes answer from ``routes``:
    path → (status, body) or a callable returning one."""

    def __init__(self, routes):
        self.hits = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                outer.hits.append(self.path)
                route = routes.get(self.path.split("?")[0])
                status, body = (404, "") if route is None else (
                    route() if callable(route) else route)
                data = body.encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()


@pytest.fixture
def server():
    made = []

    def make(routes):
        made.append(_Server(routes))
        return made[-1]

    yield make
    for s in made:
        s.close()


# ---------------------------------------------------------------------------
# spans, trace_function, install_tracepoints
# ---------------------------------------------------------------------------

SPAN_CHILD = r'''
import importlib, json, sys, types
args = json.loads(sys.argv[1])
out = {}
for pkg, lib in (("dlrover_tpu", args["ref"]), ("dlrover_tpu_torch",
                                                args["port"])):
    tt = importlib.import_module(f"{pkg}.observability.tpu_timer")
    timer = tt.TpuTimer(lib)
    tt._global_timer = timer
    mod = types.ModuleType(f"ttmod_{pkg}")
    def work(x):
        return x + 1
    mod.work = work
    sys.modules[mod.__name__] = mod
    def step(x):
        return x * 2
    step.__module__ = "user"
    traced = tt.trace_function(step)
    named = tt.trace_function(name="data::tokenize", kind=tt.KIND_COLL)(step)
    for i in range(3):
        traced(i)
    named(1)
    with timer.span("train_step", payload=1.0e9):
        pass
    with timer.span("h2d_copy", kind=tt.KIND_MEMORY, payload=4096.0):
        pass
    n = tt.install_tracepoints([f"{mod.__name__}:work", "nosuch.mod:fn"])
    n_again = tt.install_tracepoints([f"{mod.__name__}:work"])
    for i in range(4):
        mod.work(i)
    timer.set_gauge("POOL_QUEUE_SIZE", 2.0)
    timer.count_dataloader_batch(3)
    out[pkg] = {"text": timer.prometheus_text().replace(mod.__name__,
                                                       "ttmod"),
                "installed": [n, n_again],
                "tracepoint": mod.work.__tracepoint__}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref_lib(tmp_path_factory):
    return build_reference(tmp_path_factory.mktemp("tt_ref"))["lib"]


def _families(text):
    out = {}
    for line in text.splitlines():
        key, _, value = line.rpartition(" ")
        name, _, labels = key.partition("{")
        out[(name, labels)] = float(value)
    return out


def test_spans_and_tracepoints_give_reference_metrics(ref_lib):
    r = subprocess.run(
        [sys.executable, "-c", SPAN_CHILD, json.dumps(
            {"ref": ref_lib, "port": str(build.build()["lib"])})],
        capture_output=True, text=True, timeout=30,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    ref = _families(got["dlrover_tpu"]["text"])
    port = _families(got["dlrover_tpu_torch"]["text"])
    assert sorted(ref) == sorted(port)
    for key, value in ref.items():
        if key[0].endswith("COUNT") or key[0].startswith(
                "XPU_TIMER_COMMON_") or key[0] == "XPU_TIMER_MEMORY_BYTES":
            assert port[key] == value, key
    counts = {k[1]: v for k, v in port.items()
              if k[0] in ("XPU_TIMER_MM_KERNEL_COUNT",
                          "XPU_TIMER_COLL_KERNEL_COUNT",
                          "XPU_TIMER_MEMORY_COUNTER")}
    assert counts == {'kernel="py::user.step",rank="0"}': 3,
                      'kernel="data::tokenize",rank="0"}': 1,
                      'kernel="train_step",rank="0"}': 1,
                      'kernel="py::ttmod:work",rank="0"}': 4,
                      'kernel="h2d_copy",rank="0"}': 1}
    assert got["dlrover_tpu"]["installed"] == \
        got["dlrover_tpu_torch"]["installed"] == [1, 0]
    assert got["dlrover_tpu_torch"]["tracepoint"] is True


# ---------------------------------------------------------------------------
# stack folding
# ---------------------------------------------------------------------------

DUMP = '''Thread 0x00007f1 (most recent call first):
  File "/usr/lib/python3.12/threading.py", line 355 in wait
  File "/repo/dlrover_tpu_torch/observability/profiler.py", line 90 in _run
  File "/usr/lib/python3.12/threading.py", line 1012 in run

Current thread 0x00007f0 (most recent call first):
  File "/repo/train.py", line 40 in wedged_collective
  File "/repo/train.py", line 52 in main
  File "/repo/train.py", line 60 in <module>
'''


def _real_dump(tmp_path):
    """A faulthandler dump of this process with a second thread parked."""
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, daemon=True)
    t.start()
    path = tmp_path / "real.txt"
    with open(path, "w") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
    stop.set()
    t.join()
    return path.read_text()


def test_stack_viewer_folds_like_reference(tmp_path):
    real = _real_dump(tmp_path)
    dumps = [DUMP, DUMP, real]
    for text in dumps:
        assert (stack_viewer.parse_faulthandler_dump(text)
                == jax_sv.parse_faulthandler_dump(text))
    counts = stack_viewer.fold_stacks(dumps)
    assert counts == jax_sv.fold_stacks(dumps)
    assert counts["train.py:<module>;train.py:main;"
                  "train.py:wedged_collective"] == 2
    stack_viewer.write_folded(counts, str(tmp_path / "port.folded"))
    jax_sv.write_folded(counts, str(tmp_path / "ref.folded"))
    assert ((tmp_path / "port.folded").read_text()
            == (tmp_path / "ref.folded").read_text())
    # dump files: only what was appended after the snapshot counts
    a, b = tmp_path / "tpu_timer_pystack_1.txt", tmp_path / "tpu_timer_pystack_2.txt"
    a.write_text(DUMP)
    pattern = str(tmp_path / "tpu_timer_pystack_*.txt")
    offsets = stack_viewer.snapshot_offsets(pattern)
    assert offsets == jax_sv.snapshot_offsets(pattern)
    with open(a, "a") as f:
        f.write(real)
    b.write_text(DUMP)
    got = stack_viewer.collapse_dump_files(
        pattern, str(tmp_path / "p.folded"), offsets)
    want = jax_sv.collapse_dump_files(
        pattern, str(tmp_path / "r.folded"), offsets)
    assert got == want == jax_sv.fold_stacks([real, DUMP])


def test_sample_drives_dump_stack_and_folds_only_new(tmp_path, server,
                                                     monkeypatch):
    path = tmp_path / "tpu_timer_pystack_7.txt"
    path.write_text(DUMP)

    def dump():
        with open(path, "a") as f:
            f.write(DUMP)
        return 200, '{"signalled":1}'

    daemon = server({"/dump_stack": dump})
    orig = stack_viewer.snapshot_offsets
    monkeypatch.setattr(stack_viewer, "snapshot_offsets",
                        lambda pattern=None: orig(str(tmp_path / "*.txt")))
    orig_collapse = stack_viewer.collapse_dump_files
    monkeypatch.setattr(
        stack_viewer, "collapse_dump_files",
        lambda out_path, offsets: orig_collapse(
            str(tmp_path / "*.txt"), out_path, offsets))
    counts = stack_viewer.sample(daemon_port=daemon.port, rounds=3,
                                 interval_s=0.01,
                                 out_path=str(tmp_path / "s.folded"))
    assert daemon.hits == ["/dump_stack"] * 3
    # three new dumps of two threads each, the original one not counted
    assert sum(counts.values()) == 6


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

TRACE = {"traceEvents": [
    {"name": "cublasGemmEx_64x96x32", "cat": "mm", "ph": "X", "ts": 1,
     "dur": 10, "pid": 0, "tid": 0,
     "args": {"flops": 2.0 * 64 * 96 * 32, "m": 64, "n": 96, "k": 32,
              "batch": 1}},
    {"name": "cublasGemmEx_64x96x32", "cat": "mm", "ph": "X", "ts": 20,
     "dur": 14, "pid": 0, "tid": 0,
     "args": {"flops": 2.0 * 64 * 96 * 32, "m": 64, "n": 96, "k": 32,
              "batch": 1}},
    {"name": "cublasGemmStridedBatchedEx_16x16x8_b4", "cat": "mm",
     "ph": "X", "ts": 40, "dur": 30, "pid": 0, "tid": 0,
     "args": {"flops": 2.0 * 16 * 16 * 8 * 4, "m": 16, "n": 16, "k": 8,
              "batch": 4}},
    {"name": "train_step", "cat": "mm", "ph": "X", "ts": 80, "dur": 500,
     "pid": 0, "tid": 0, "args": {"flops": 2.0 * 300 ** 3}},
    {"name": "py_gc", "cat": "mm", "ph": "X", "ts": 90, "dur": 900,
     "pid": 0, "tid": 0, "args": {"flops": 0}},
    {"name": "ncclAllReduce", "cat": "coll", "ph": "X", "ts": 99,
     "dur": 50, "pid": 0, "tid": 1, "args": {"payload": 4096}},
]}


def test_select_matmuls_matches_reference():
    events = TRACE["traceEvents"]
    for k in (1, 2, 5):
        got = replay.select_matmuls(events, k)
        want = jax_replay.select_matmuls(events, k)
        assert [{key: a[key] for key in want[0]} for a in got] == want
    picked = {a["name"]: a["shape"] for a in replay.select_matmuls(events)}
    assert picked == {"train_step": None,
                      "cublasGemmStridedBatchedEx_16x16x8_b4": [16, 16, 8, 4],
                      "cublasGemmEx_64x96x32": [64, 96, 32, 1]}


def test_replay_runs_captured_shapes_exactly(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    report = replay.replay(str(path), top_k=3, iters=2, device="cpu")
    got = {k["name"]: k for k in report["kernels"]}
    assert got["cublasGemmEx_64x96x32"]["replay_shape"] == [64, 96, 32, 1]
    assert got["cublasGemmStridedBatchedEx_16x16x8_b4"]["replay_shape"] == \
        [16, 16, 8, 4]
    # no shape: the reference's square of equal FLOPs, on a 128 tile
    assert got["train_step"]["replay_n"] == 384
    assert got["train_step"]["replay_shape"] == [384, 384, 384, 1]
    assert got["cublasGemmEx_64x96x32"]["recorded_tflops"] == \
        pytest.approx(2 * 2.0 * 64 * 96 * 32 / 24e-6 / 1e12)
    for k in report["kernels"]:
        assert k["replayed_tflops"] > 0 and k["ratio"] > 0
    # the CLI prints the same report
    cli = [sys.executable, "-m", "dlrover_tpu_torch.observability.replay",
           str(path), "--top-k", "1", "--iters", "1"]
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([*cli, "--device", "cpu"], capture_output=True,
                       text=True, timeout=30, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout)["kernels"][0]["name"] == "train_step"
    # by default the card, and no drift to the CPU without one
    r = subprocess.run(cli, capture_output=True, text=True, timeout=30,
                       env=env)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


# ---------------------------------------------------------------------------
# timeline merge
# ---------------------------------------------------------------------------


def test_merge_timelines_matches_reference(tmp_path, server):
    journal = EventJournal()
    journal.record("rendezvous_complete", round=1)
    journal.record("fault_detected", node_id=0, reason="hang")
    journal.record("rendezvous_complete", round=2)
    worker = server({"/trace": (200, json.dumps(TRACE))})
    master = server({"/events": (200, journal.to_json())})
    dead = _free_port()
    out_p, out_r = tmp_path / "port.json", tmp_path / "ref.json"
    n_p = timeline.merge_timelines(str(out_p), ports=[worker.port, dead],
                                   master_http_addr=f"127.0.0.1:{master.port}")
    n_r = jax_timeline.merge_timelines(
        str(out_r), ports=[worker.port, dead],
        master_http_addr=f"127.0.0.1:{master.port}")
    assert n_p == n_r == 1
    got, want = json.loads(out_p.read_text()), json.loads(out_r.read_text())
    assert got == want
    assert len(got["traceEvents"]) > len(TRACE["traceEvents"]) + 1


def test_start_daemon_serves_its_workers(server):
    page = 'XPU_TIMER_COMMON_HANG{rank="0"} 0\n'
    worker = server({"/metrics": (200, page),
                     "/healthz": (200, '{"pid":1,"rank":0,"world_size":1,'
                                       '"hang":0}')})
    listen = _free_port()
    proc = timeline.start_daemon(listen_port=listen, base_port=worker.port,
                                 n_workers=1)
    try:
        body = None
        for _ in range(100):
            try:
                with urllib_get(listen, "/metrics") as r:
                    body = r.read().decode()
                break
            except OSError:
                time.sleep(0.05)
        assert body == page
    finally:
        proc.kill()
        proc.wait()


def urllib_get(port, path):
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=5)


# ---------------------------------------------------------------------------
# the agent's collector and hang evidence
# ---------------------------------------------------------------------------

PAGE = "\n".join([
    "# a comment",
    'XPU_TIMER_MM_KERNEL_AVG_LATENCY{kernel="a",rank="0"} 120.5',
    'XPU_TIMER_MM_KERNEL_AVG_LATENCY{kernel="b",rank="0"} 80',
    'XPU_TIMER_MM_KERNEL_COUNT{kernel="a",rank="0"} 7',
    'XPU_TIMER_COLL_KERNEL_BANDWIDTH{kernel="ncclAllReduce",rank="1"} 2e+09',
    'XPU_TIMER_MEMORY_BYTES{kernel="memcpy_d2h",rank="0"} 1.07374e+09',
    'XPU_TIMER_COMMON_HANG{rank="0"} 0',
    'XPU_TIMER_COMMON_HANG{rank="1"} 1',
    'OTHER_FAMILY{rank="0"} 5',
    "garbage line",
    'XPU_TIMER_COMMON_PID{rank="0"} nan-ish',
])


def test_collector_parses_page_like_reference(server):
    daemon = server({"/metrics": (200, PAGE)})
    got = diagnosis_agent.TpuTimerCollector(port=daemon.port).collect()
    want = jax_diag.TpuTimerCollector(port=daemon.port).collect()
    assert got == want
    assert got["XPU_TIMER_COMMON_HANG"] == 1
    assert got["XPU_TIMER_MM_KERNEL_AVG_LATENCY"] == 120.5
    assert diagnosis_agent.TpuTimerCollector(
        port=_free_port()).collect() == {}


def test_stack_capture_keeps_reference_cooldown_and_retry(tmp_path, server,
                                                          monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    runs = {}
    for name, mod in (("port", diagnosis_agent), ("ref", jax_diag)):
        calls = []

        def stacktrace(calls=calls):
            calls.append(now[0])
            # the first capture fails: the daemon is restarting
            return (500, "busy") if len(calls) == 1 else (
                200, '[{"pid":1,"python":"Current thread 0x1"}]')

        daemon = server({"/stacktrace": stacktrace})
        out = tmp_path / name
        out.mkdir()
        agent = mod.DiagnosisAgent(collectors=[], timer_port=daemon.port,
                                   stack_dir=str(out))
        seen = []
        for t, hang in ((1000, 1), (1010, 1), (1016, 1), (1100, 1),
                        (1137, 1), (1300, 0)):
            now[0] = float(t)
            agent._maybe_capture_stacks({"XPU_TIMER_COMMON_HANG": hang})
            if agent._capture_thread is not None:
                agent._capture_thread.join(10)
            seen.append(len(calls))
        runs[name] = (seen, [c.split("?")[1] for c in daemon.hits],
                      len(list(out.iterdir())))
    assert runs["port"] == runs["ref"]
    assert runs["port"][0] == [1, 1, 2, 2, 3, 3]


# ---------------------------------------------------------------------------
# the stack-dump signal
# ---------------------------------------------------------------------------

STACK_CHILD = r'''
import json, signal, sys, threading, time
from dlrover_tpu_torch.observability.tpu_timer import arm_stack_dump
arm_stack_dump(signal.SIGUSR1, open(sys.argv[1], "w"))

def busy():
    def rec(d):
        return 0 if d == 0 else 1 + rec(d - 1)
    while True:
        rec(30)
        json.dumps(list(range(50)))
        time.sleep(0.0005)

for _ in range(4):
    threading.Thread(target=busy, daemon=True).start()

def main_loop(d):
    return 0 if d == 0 else 1 + main_loop(d - 1)

print("ready", flush=True)
t0 = time.time()
while time.time() - t0 < 60:
    main_loop(50)
'''


def test_stack_dump_signal_leaves_a_busy_worker_alive(tmp_path):
    """ROADMAP C22: a worker whose threads run Python survives thousands
    of stack-dump signals (``faulthandler``'s all-threads handler, which
    the reference registers, read the running threads' frames and
    crashed such a process within 300-1400 signals), and each dump holds
    the main thread's frames."""
    out = tmp_path / "pystack.txt"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", STACK_CHILD, str(out)],
                            stdout=subprocess.PIPE, text=True, env=env)
    try:
        assert proc.stdout.readline().strip() == "ready"
        sent = 0
        while sent < 3000 and proc.poll() is None:
            os.kill(proc.pid, signal.SIGUSR1)
            sent += 1
            time.sleep(0.002)
        alive = proc.poll() is None
    finally:
        proc.kill()
        proc.wait()
    assert alive, f"the worker died ({proc.returncode}) after {sent} dumps"
    text = out.read_text()
    assert text.count("main_loop") >= 1000 and "in busy" in text


# ---------------------------------------------------------------------------
# the profile listener
# ---------------------------------------------------------------------------


def test_profile_listener_answers_over_shared_dict(tmp_path):
    sock = f"/tmp/dtpu_prof_{os.getpid()}_{threading.get_ident() % 997}.sock"
    ipc = LocalIPCServer(sock)
    ipc.start()
    try:
        listener = profiler.ProfileListener(sock, 0, out_root=str(tmp_path),
                                            poll_s=0.05)
        listener.start()
        pdict = ipc.local_dict(profiler.PROFILE_DICT)
        req = profiler.request_profile(pdict, 0, duration_s=0.3)
        a = torch.randn(64, 64)
        deadline = time.monotonic() + 20
        done = None
        while done is None and time.monotonic() < deadline:
            a = torch.tanh(a @ a)
            done = profiler.await_profile(pdict, 0, req, timeout_s=0.05)
        listener.stop()
        assert done is not None and done["ok"], done
        with open(done["path"]) as f:
            trace = json.load(f)
        assert trace["traceEvents"]
        assert done["path"].startswith(str(tmp_path))
        # a relaunched listener does not replay the old request
        again = profiler.ProfileListener(sock, 0, out_root=str(tmp_path),
                                         poll_s=0.05)
        again.start()
        time.sleep(0.3)
        again.stop()
        assert pdict[profiler.done_key(0)]["id"] == req
        assert len(os.listdir(tmp_path)) == 1
    finally:
        ipc.stop()


# ---------------------------------------------------------------------------
# the hang loop
# ---------------------------------------------------------------------------


class _Stalled:
    def step_stalled(self, timeout_s):
        return True


@pytest.fixture
def restart_on_hang():
    from dlrover_tpu.common.config import get_context as jax_context

    saved = [(ctx, ctx.hang_restart_workers)
             for ctx in (get_context(), jax_context())]
    for ctx, _ in saved:
        ctx.set("hang_restart_workers", True)
    yield
    for ctx, value in saved:
        ctx.set("hang_restart_workers", value)


@pytest.mark.parametrize("hang", [1, 0])
def test_agent_beats_drive_both_masters_hang_rule(hang, server,
                                                  restart_on_hang):
    page = (f'XPU_TIMER_COMMON_HANG{{rank="0"}} {hang}\n'
            'XPU_TIMER_MM_KERNEL_AVG_LATENCY{kernel="g",rank="0"} 2100\n')
    daemon = server({"/metrics": (200, page)})
    agent = diagnosis_agent.DiagnosisAgent(
        collectors=[diagnosis_agent.TpuTimerCollector(port=daemon.port)],
        stack_dir="/nonexistent")
    agent._maybe_capture_stacks = lambda gauges: None
    gauges = agent.collect_gauges()
    assert gauges["XPU_TIMER_COMMON_HANG"] == hang
    verdicts = {}
    for name, master, dm in (
            ("port", LocalJobMaster(job_name=f"hp{os.getpid()}",
                                    node_num=1), diagnosis_master),
            ("jax", JaxMaster(job_name=f"hj{os.getpid()}", node_num=1),
             jax_dm)):
        master.prepare()
        try:
            MasterClient(master.addr, 0, 0).heartbeat(
                global_step=3, step_timestamp=time.time(), gauges=gauges)
            node_gauges = master.diagnosis_master._node_gauges
            assert node_gauges[0][0]["XPU_TIMER_COMMON_HANG"] == hang
            rule = dm.TrainingHangDiagnostician(_Stalled(), node_gauges)
            obs = rule.observe()
            verdicts[name] = (obs.problem, rule.resolve(obs))
        finally:
            master.stop()
    for problem, action in verdicts.values():
        if hang:
            assert problem == "training_hang"
            assert action.action_type == DiagnosisActionType.RESTART_WORKER
            assert action.data == {"wedged": True}
        else:
            assert problem == "step_stall"
            assert action.action_type == DiagnosisActionType.EVENT
    assert verdicts["port"][0] == verdicts["jax"][0]


@pytest.fixture
def fast_hang_rule():
    ctx = get_context()
    keys = {"hang_restart_workers": True, "hang_downtime_s": 2.5,
            "diagnosis_interval_s": 0.25, "heartbeat_interval_s": 0.25,
            "wedged_kill_grace_s": 0.2}
    saved = {k: getattr(ctx, k) for k in keys}
    for k, v in keys.items():
        ctx.set(k, v)
    yield
    for k, v in saved.items():
        ctx.set(k, v)


def test_agent_closes_the_hang_loop_on_the_cpu(tmp_path, monkeypatch,
                                               fast_hang_rule):
    job = f"th{os.getpid()}{threading.get_ident() % 1000}"
    daemon_port, base = _free_port(), _free_port()
    monkeypatch.setenv("TPU_TIMER_DAEMON_PORT", str(daemon_port))
    monkeypatch.setenv("TPU_TIMER_PORT", str(base))
    master = LocalJobMaster(job_name=job, node_num=1)
    master.prepare()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.update({"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
                "DLROVER_TPU_LOG_LEVEL": "WARNING",
                "TPU_TIMER_HANG_TIMEOUT": "0.5",
                "DLROVER_TPU_PROFILE_DIR": str(tmp_path / "prof")})
    out = str(tmp_path / "out")
    config = ElasticLaunchConfig(
        min_nodes=1, max_nodes=1, nproc_per_node=1, job_name=job,
        master_addr=master.addr, max_restarts=2, monitor_interval_s=0.1,
        entrypoint=WORKER, args=[out], save_at_breakpoint=False,
        tpu_timer=True, worker_env=env)
    agent = ElasticTrainingAgent(config, MasterClient(master.addr, 0, 0))
    beats = []
    collect = agent._diagnosis.collect_gauges
    agent._diagnosis.collect_gauges = lambda: beats.append(collect()) or \
        beats[-1]
    profiles = []
    request = agent._diagnosis._request_worker_profiles
    agent._diagnosis._request_worker_profiles = lambda *a: (
        profiles.append(time.time()), request(*a))
    result = {}
    runner = threading.Thread(target=lambda: result.update(
        code=agent.run()), daemon=True)
    runner.start()
    runner.join(30)
    try:
        assert not runner.is_alive(), "the agent did not finish in 30 s"
        assert result["code"] == 0
        assert agent._restart_count == 1
        first = json.loads(open(f"{out}.0").read())
        assert first["installed"] and first["enable"] == "1"
        assert first["ld_preload"].split()[0].endswith(".so")
        # the beats carried the device timer's gauges, the hang among them
        timer_beats = [b for b in beats if "XPU_TIMER_COMMON_HANG" in b]
        assert timer_beats and any(
            b["XPU_TIMER_COMMON_HANG"] == 1 for b in timer_beats)
        # the wedged span never ended, so it never made a record
        assert all("XPU_TIMER_COLL_KERNEL_COUNT" not in b
                   for b in timer_beats)
        # the evidence: the daemon's python stack of the wedged frame
        path = agent._diagnosis.last_stack_path
        assert path and os.path.exists(path)
        stacks = json.load(open(path))
        assert any("wedged_collective" in s.get("python", "")
                   for s in stacks)
        os.remove(path)
        assert profiles
    finally:
        if runner.is_alive():
            agent._stop_workers(grace_s=0.1)
        master.stop()
        for restart in (0, 1):
            if not os.path.exists(f"{out}.{restart}"):
                continue
            pid = json.loads(open(f"{out}.{restart}").read())["pid"]
            for name in (f"tpu_timer_pystack_{pid}.txt",
                         f"tpu_timer_hang_{pid}.txt"):
                if os.path.exists(os.path.join("/tmp", name)):
                    os.remove(os.path.join("/tmp", name))
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrtpu_{job}_"):
                os.unlink(os.path.join("/dev/shm", name))


# ---------------------------------------------------------------------------
# op-class telemetry from the native engine (the fake CUDA stack)
# ---------------------------------------------------------------------------

OPTEL_CHILD = r'''
import ctypes, json, os, sys
args = json.loads(sys.argv[1])
fake = ctypes.CDLL(args["fake"])
caller = ctypes.CDLL(args["caller"])
for fn in ("fake_blas_handle", "fake_nccl_comm"):
    getattr(fake, fn).restype = ctypes.c_void_p
fake.fake_set_kernel_ms.argtypes = [ctypes.c_double]
from dlrover_tpu_torch.observability.op_telemetry import get_accumulator
from dlrover_tpu_torch.observability.tpu_timer import KIND_COLL, TpuTimer
timer = TpuTimer()
timer.install(0, 1, 0, port=0, device="cuda")
S = ctypes.c_void_p(0x100)
S2 = ctypes.c_void_p(0x200)
blas = ctypes.c_void_p(fake.fake_blas_handle(S))
size = ctypes.c_size_t
out = {}
fake.fake_set_auto(1)
fake.fake_set_kernel_ms(2.0)
# one compute span around N hooked GEMMs: N + 1 observations
with timer.span("train_step"):
    for _ in range(args["n"]):
        caller.call_gemm_ex(blas, 0, 0, 64, 64, 64)
timer.wait_drained(5)
out["span_and_gemms"] = timer.op_telemetry()
# a hooked copy has no class; a checkpoint span is ckpt
caller.call_memcpy(size(1 << 20), 2, S)
with timer.span("ckpt_save"):
    pass
timer.wait_drained(5)
out["copy_and_ckpt"] = timer.op_telemetry()
# a collective whose kernel has not completed: its entry is marked at the
# call, its duration only once its end event completes
fake.fake_set_auto(0)
comm = ctypes.c_void_p(fake.fake_nccl_comm(2))
caller.call_collective(0, size(256), 7, comm, S2)
out["entered"] = timer.op_telemetry()
fake.fake_advance(S2, 1000)
timer.wait_drained(5)
out["completed"] = timer.op_telemetry()
with timer.span("psum", kind=KIND_COLL):
    out["in_python_coll"] = timer.op_telemetry()
out["python_accumulator_seq"] = get_accumulator().seq
timer.shutdown()
os.remove(f"/tmp/tpu_timer_pystack_{os.getpid()}.txt")
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def fake_cuda(tmp_path_factory):
    out = tmp_path_factory.mktemp("optel_fakes")
    fakes = build.build_fakes(out)
    return {"lib": str(build.build()["lib"]), "fake": str(fakes["fake"]),
            "caller": str(fakes["caller"]), "dir": str(out)}


def _optel_child(fake_cuda, n):
    env = dict(os.environ, PYTHONPATH=REPO, LD_PRELOAD=fake_cuda["lib"],
               TPU_TIMER_LIB=fake_cuda["lib"],
               LD_LIBRARY_PATH=fake_cuda["dir"])
    r = subprocess.run(
        [sys.executable, "-c", OPTEL_CHILD, json.dumps(dict(
            fake=fake_cuda["fake"], caller=fake_cuda["caller"], n=n))],
        capture_output=True, text=True, env=env, timeout=30)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_native_engine_feeds_op_telemetry_once(fake_cuda):
    from dlrover_tpu.master.skew_monitor import SkewMonitor as JaxSkew
    from dlrover_tpu.observability.op_telemetry import (
        OpClassHistogram as JaxHist,
    )
    from dlrover_tpu.observability.registry import (
        MetricsRegistry as JaxRegistry,
    )

    n = 6
    got = _optel_child(fake_cuda, n)
    first = got["span_and_gemms"]
    # the span counts once, in the engine, beside its N GEMMs
    compute = first["classes"]["compute"]
    assert compute["n"] == n + 1 and first["seq"] == n + 1
    # each GEMM's duration is the fake kernel's 2 ms between its events
    assert compute["b"][4] >= n  # (640, 2560] µs
    assert isinstance(compute["sum"], float)
    assert set(first["classes"]) == {"compute"}
    # the Python accumulator saw nothing: no double count
    assert got["python_accumulator_seq"] == 0
    second = got["copy_and_ckpt"]
    assert second["classes"]["compute"]["n"] == n + 1
    assert second["classes"]["ckpt"]["n"] == 1
    assert second["seq"] == n + 2
    # entry before completion
    entered = got["entered"]
    assert entered["last_collective"] == {"name": "ncclAllReduce", "seq": 1}
    assert "collective" not in entered["classes"]
    done = got["completed"]["classes"]["collective"]
    assert done["n"] == 1 and done["sum"] == pytest.approx(2000.0)
    # a Python collective span marks its entry at begin
    assert got["in_python_coll"]["last_collective"] == {"name": "psum",
                                                        "seq": 2}
    # the native wire is the JAX package's: its histogram reads it back,
    # and its skew monitor compares two such ranks
    assert JaxHist.from_wire(compute).to_wire() == compute
    clock = [100.0]
    mon = JaxSkew(registry=JaxRegistry(), monotonic=lambda: clock[0])
    slow = json.loads(json.dumps(done))
    slow["sum"] *= 5
    for snap_r0, snap_r1 in ((got["entered"], got["entered"]),
                             (got["completed"], dict(
                                 got["completed"], classes=dict(
                                     got["completed"]["classes"],
                                     collective=slow)))):
        clock[0] += 1.0
        mon.observe(0, {"0": snap_r0, "1": snap_r1})
    verdicts = mon.current_verdicts()["stragglers"]
    assert [(s["rank"], s["cause"]) for s in verdicts] == [(1, "collective")]


def test_read_text_rereads_a_text_that_grew():
    """The engine records between the sizing call and the copy: a text
    that outgrew the buffer is read again, never cut short (a cut op
    telemetry JSON failed a worker's publish on the card)."""
    from dlrover_tpu_torch.observability import tpu_timer as tt

    texts = ["x" * 10, "y" * 9000, "z" * 9000]
    caps = []

    def copy_out(buf, cap):
        text = texts[min(len(caps), len(texts) - 1)]
        caps.append(cap)
        if buf is not None:
            buf.value = text[:cap - 1].encode()
        return len(text)

    assert tt._read_text(copy_out) == "z" * 9000
    assert caps[0] == 0 and len(caps) == 3
