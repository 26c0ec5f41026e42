"""Two-agent kill-shrink-rejoin drill on the PyTorch port, with goodput.

The port's twin of ``examples/chaos_goodput.py``: every process is the
port's (its master, its agents, its workers), none imports JAX.

1. a port master (min_nodes=1, max_nodes=2) and two agents
   (``python -m dlrover_tpu_torch.agent.run``) train a toy job at world 2:
   every step all-reduces a gradient across the ranks (on the workers'
   gloo host group). Agent 1's worker carries an injected compute delay
   (the chaos site ``step.compute``, ``delay=0.25@times=30`` a process)
   inside its own compute span, and the master's skew monitor must
   attribute ``straggler(rank=1, cause=compute)`` with a ratio above 2
   from the op-telemetry uplink while rank 1 is alive, with the
   ``dlrover_skew_ratio`` gauge live on a mid-drill ``/metrics`` scrape;
   the straggler rule's ``STACK_DUMP`` reaches agent 1, whose evidence
   (a ``torch.profiler`` trace of the slow worker, taken by its main
   thread between steps, and with ``--tpu-timer`` its Python stack
   through the device timer's daemon) is journaled as
   ``stack_dump_captured``; the drill's line reports what the trace
   holds (``stack_dump.profile_*``);
2. agent 1's process group is SIGKILLed mid-training; the master sees its
   heartbeat connection drop, fails the node after the grace and tells the
   survivor to restart; the survivor re-forms the world at 1 with twice
   the rows per replica (the global batch is fixed) and resumes from a
   checkpoint;
3. agent 1 comes back, joins the rendezvous, and the world returns to 2;
4. optionally (``--hang-at-step``) rank 0 wedges outside any training
   span; the master's hang rule sees the global step stall and restarts
   the workers, which resume from the checkpoint;
5. training goodput (the union of the workers' training spans over the
   wall clock, ``compute_goodput`` over their event files) and the drill's
   timings are printed as one JSON line.

The worker's weight grows by exactly 1.0 a step through a real
cross-rank reduction, so its final value equals the step count only if no
step was lost or applied twice across the shrink and the rejoin; each
segment records an all-reduce of ones ("psum"), which equals its world
size.

``--straggler-only`` stops after the straggler half (no kill, rejoin or
hang): the run ends when training does. ``--matmuls N`` adds N bf16
``torch.matmul``s at ``--mm-shape M,K,N`` to every step's compute span, so
on a card (``--device cuda --tpu-timer``) the compute class holds the
hook's GEMMs. Two ranks on one card form their world over gloo
(``DLROVER_TPU_DIST_BACKEND=gloo``; NCCL refuses two ranks on one device).

Run: ``python examples/chaos_goodput_torch.py`` (CPU, gloo; orchestration
is the subject). Not ported: the reference drill's checkpoint-free live
reshard (restores here come from shm or storage), the flight recorder's
bundle checks, the incident records and ``/events``.
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WORKER_SRC = '''
"""Chaos worker: real distributed training on torch.distributed."""
import json, os, sys, time
import torch
import torch.distributed as dist
from dlrover_tpu_torch import worker
from dlrover_tpu_torch.ckpt.checkpointer import Checkpointer, StorageType
from dlrover_tpu_torch.common.event import TrainEvent, get_emitter

ctx = worker.init(device=os.environ.get("DEVICE", "cpu"))
ckpt_dir, log_path = sys.argv[1], sys.argv[2]
steps, step_time = int(sys.argv[3]), float(sys.argv[4])
global_batch = int(sys.argv[5])
world = ctx.world_size
# fixed global batch: fewer replicas -> each takes more of its rows
accum = max(1, global_batch // max(1, world))
device = ctx.device


def allreduce(t):
    # on the host group (gloo): ranks that share one card form a world
    if dist.is_initialized() and world > 1:
        host = t.cpu()
        dist.all_reduce(host, group=worker.host_group())
        t = host.to(t.device)
    return t


# the collective proof: the sum of one 1.0 per rank is the world size
world_check = float(allreduce(torch.ones(1, device=device)).item())
D = 8
# this rank's rows of the global batch; all ones make the global-batch
# mean gradient of mean(x @ w) exactly 1.0
x = torch.ones(accum, D, device=device)


def train_step(w):
    g = allreduce(x.sum(dim=0) / global_batch)
    return w + g  # "lr = -1": w grows by exactly 1 a global step


state = {"w": torch.zeros(D, device=device),
         "step": torch.zeros((), dtype=torch.int64, device=device)}
# single writer: rank 0 owns the replicated state and is the only saver
ckpt = Checkpointer(ckpt_dir, saving_ranks=[0])
state, last = ckpt.load_checkpoint(state)
start = last + 1 if last >= 0 else 0
w = state["w"].clone()
with open(log_path, "a") as f:
    f.write(json.dumps({"event": "segment_start", "rank": ctx.rank,
                        "world": world, "accum": accum, "start": start,
                        "psum": world_check,
                        "restored_from": ckpt.engine.last_restore.get(
                            "medium"),
                        "w_at_start": float(w[0]),
                        "t": time.time()}) + "\\n")
em = get_emitter(f"worker_{ctx.rank}")
# the op-telemetry uplink: the timer's spans (the native engine's
# histograms when its library is loaded, the Python accumulator's
# otherwise) ride publish_step to the agent and its beat to the master's
# skew monitor. Agent 1's worker sleeps inside its own compute span (the
# step.compute fault), and the all-reduce right after it sits in a
# collective span: the slow rank's time lands in ITS compute histogram,
# its peer's matching wait in the peer's collective histogram.
from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.observability.tpu_timer import KIND_COLL, get_timer
timer = get_timer()
inj = get_injector()
n_mm = int(os.environ.get("DTPU_CHAOS_MATMULS", "0"))
if n_mm:
    M, K, N = (int(v) for v in os.environ["DTPU_CHAOS_MM_SHAPE"].split(","))
    gen = torch.Generator(device=device).manual_seed(ctx.rank)
    mm_a = torch.randn(M, K, generator=gen, device=device,
                       dtype=torch.bfloat16)
    mm_b = torch.randn(K, N, generator=gen, device=device,
                       dtype=torch.bfloat16)
# the wedged worker (--hang-at-step): rank 0 stops stepping outside any
# span; the marker file makes the fault one-shot across restarts
hang_at = int(os.environ.get("DTPU_CHAOS_HANG_AT_STEP", "0"))
hang_marker = os.environ.get("DTPU_CHAOS_HANG_MARKER", "")
for s in range(start, steps):
    with em.span(TrainEvent.TRAINING, step=s, world=world):
        with timer.span("injected_compute"):
            if inj is not None:
                inj.fire("step.compute", step=s)
        with timer.span("step_psum", kind=KIND_COLL):
            allreduce(torch.ones(1, device=device))
        with timer.span("train_step"):
            w = train_step(w)
            for _ in range(n_mm):
                torch.matmul(mm_a, mm_b)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if step_time:
            time.sleep(step_time)  # pace the drill (kill timing)
    ctx.publish_step(s)
    if ctx.rank == 0:
        ckpt.save_checkpoint(
            s, {"w": w, "step": torch.tensor(s, device=device)},
            StorageType.DISK)
    ctx.report_step(s)
    if (hang_at and hang_marker and s >= hang_at and ctx.rank == 0
            and not os.path.exists(hang_marker)):
        with open(hang_marker, "w") as mf:
            mf.write(str(time.time()))
        with open(log_path, "a") as f:
            f.write(json.dumps({"event": "hang_start", "step": s,
                                "rank": ctx.rank}) + "\\n")
        time.sleep(3600)  # wedged until the hang rule's restart kills us
ckpt.engine.wait_drained()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu"))
# this incarnation's op telemetry, and the GEMMs the device timer's hook
# timed (0 without its library)
timer.wait_drained()
optel = timer.op_telemetry()
gemms = sum(int(float(ln.rsplit(" ", 1)[1]))
            for ln in timer.prometheus_text().splitlines()
            if ln.startswith("XPU_TIMER_MM_KERNEL_COUNT{")
            and 'kernel="cublas' in ln)
with open(log_path, "a") as f:
    f.write(json.dumps({"event": "done", "rank": ctx.rank, "world": world,
                        "w_final": float(w[0]), "psum": world_check,
                        "start": start, "steps": steps,
                        "compute_n": optel["classes"].get(
                            "compute", {}).get("n", 0),
                        "hooked_gemms": gemms,
                        "forbidden_modules": bad}) + "\\n")
worker.shutdown()
'''

AGENT_SRC = '''
import sys
from dlrover_tpu_torch.agent import run
code = run.main(sys.argv[1:])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu")]
print("AGENT_FORBIDDEN_MODULES " + ",".join(sorted(bad)), flush=True)
sys.exit(code or (3 if bad else 0))
'''


def _read_log(log_path):
    if not os.path.exists(log_path):
        return []
    out = []
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return out


def _wait(cond, timeout_s, what):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    raise TimeoutError(f"timed out waiting for {what}")


def _merged_goodput(event_dir):
    from dlrover_tpu_torch.common.event import compute_goodput, load_events

    records = []
    for i, name in enumerate(sorted(os.listdir(event_dir))):
        if not name.endswith(".jsonl"):
            continue
        for r in load_events(os.path.join(event_dir, name)):
            # event ids count per process: keep pairs within one file
            records.append(dict(r, event_id=(i, r.get("event_id"))))
    return compute_goodput(records)


def _scrape_skew_ratio(master):
    """The worst ``dlrover_skew_ratio`` on the master's ``/metrics``."""
    import urllib.request

    url = f"http://127.0.0.1:{master.http_port}/metrics"
    with urllib.request.urlopen(url, timeout=10) as resp:
        text = resp.read().decode()
    return max((float(line.rsplit(" ", 1)[1])
                for line in text.splitlines()
                if line.startswith("dlrover_skew_ratio{")), default=0.0)


def _journal(master, kind):
    return [e for e in master.event_journal.events() if e["kind"] == kind]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("chaos_goodput_torch")
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--step-time", type=float, default=0.15)
    parser.add_argument("--kill-at-step", type=int, default=10)
    parser.add_argument(
        "--hang-at-step", type=int, default=0,
        help="rank 0 wedges at this step; the master's hang rule must "
        "restart the workers (0 = off)")
    parser.add_argument("--hang-downtime", type=float, default=4.0)
    parser.add_argument("--global-batch", type=int, default=8)
    parser.add_argument("--device", default="cpu")
    parser.add_argument(
        "--straggler-only", action="store_true",
        help="stop after the straggler half: no kill, rejoin or hang")
    parser.add_argument(
        "--tpu-timer", action="store_true",
        help="run the agents with the device timer (the straggler's "
        "evidence then holds the workers' Python stacks)")
    parser.add_argument("--matmuls", type=int, default=0,
                        help="bf16 matmuls a step in the compute span")
    parser.add_argument("--mm-shape", default="16384,4096,11008")
    parser.add_argument("--keep-workdir", action="store_true")
    args = parser.parse_args(argv)

    from dlrover_tpu_torch.common.config import get_context
    from dlrover_tpu_torch.common.constants import NodeStatus
    from dlrover_tpu_torch.common.multi_process import unlink_shared_memory
    from dlrover_tpu_torch.common.rpc import find_free_port
    from dlrover_tpu_torch.master.master import LocalJobMaster
    from dlrover_tpu_torch.observability.journal import JournalEvent

    ctx = get_context()
    ctx.heartbeat_interval_s = 0.5
    # a fast backstop for the kill's detection; without a kill a beat may
    # wait out a scrape of a daemon busy with the straggler's stack dump
    # (up to 2 s), which must not read as a dead node
    heartbeat_timeout_s = 30.0 if args.straggler_only else 3.0
    ctx.heartbeat_timeout_s = heartbeat_timeout_s
    # the straggler rule runs every second: its dump lands mid-drill
    ctx.diagnosis_interval_s = 1.0
    if args.hang_at_step:
        # out-wait a normal step, beat the drill's timescale; a
        # re-rendezvous resets the perf monitor, so a recovery window with
        # no steps yet cannot trigger it
        ctx.hang_downtime_s = args.hang_downtime
        ctx.hang_restart_workers = True

    workdir = tempfile.mkdtemp(prefix="dtpu_chaos_torch_")
    event_dir = os.path.join(workdir, "events")
    ckpt_dir = os.path.join(workdir, "ckpt")
    log_path = os.path.join(workdir, "progress.jsonl")
    worker_py = os.path.join(workdir, "chaos_worker.py")
    os.makedirs(event_dir)
    with open(worker_py, "w") as f:
        f.write(WORKER_SRC)
    hang_marker = os.path.join(workdir, "hang.marker")

    job = f"ct{os.getpid()}"
    # the master's /metrics is scraped mid-drill (0: a free port)
    os.environ.setdefault("DLROVER_TPU_HTTP_PORT", "0")
    master = LocalJobMaster(job_name=job, node_num=2, min_nodes=1,
                            max_nodes=2)
    master.prepare()
    # each agent's device-timer daemon and its workers' metric ports
    timer_ports = {r: (find_free_port("127.0.0.1"),
                       find_free_port("127.0.0.1")) for r in (0, 1)}

    def start_agent(rank):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DLROVER_TPU_")}
        env.pop("DLROVER_FAULT_SCHEDULE", None)
        if rank == 1:
            # the straggler: agent 1's worker sleeps 0.25 s inside a
            # compute span for the first 30 steps of each incarnation
            env["DLROVER_FAULT_SCHEDULE"] = \
                "step.compute:delay=0.25@times=30"
        if args.hang_at_step:
            env["DTPU_CHAOS_HANG_AT_STEP"] = str(args.hang_at_step)
            env["DTPU_CHAOS_HANG_MARKER"] = hang_marker
        if args.matmuls:
            env["DTPU_CHAOS_MATMULS"] = str(args.matmuls)
            env["DTPU_CHAOS_MM_SHAPE"] = args.mm_shape
        env.update({
            "DEVICE": args.device,
            "PYTHONPATH": REPO,
            "OMP_NUM_THREADS": "1",
            "DLROVER_TPU_EVENT_DIR": event_dir,
            # the workers' torch.profiler traces (the straggler dump's)
            "DLROVER_TPU_PROFILE_DIR": os.path.join(workdir, "profiles"),
            "DLROVER_TPU_LOG_LEVEL": "WARNING",
            "DLROVER_TPU_HEARTBEAT_INTERVAL_S": "0.5",
            "DLROVER_TPU_HEARTBEAT_TIMEOUT_S": str(heartbeat_timeout_s),
            # a worker whose peer died has already failed its collective:
            # escalate to SIGKILL fast
            "DLROVER_TPU_WORKER_STOP_GRACE_S": "1",
            "DLROVER_TPU_DIST_SHUTDOWN_S": "5",
            "DLROVER_TPU_DIST_HEARTBEAT_S": "5",
            # ranks sharing one card form their world over gloo
            "DLROVER_TPU_DIST_BACKEND": "gloo",
            # the returning agent joins at once, its warm spares still
            # importing: the drill's rejoin lands while the survivor has
            # steps left (the default gate waits up to 10 s for them)
            "DLROVER_TPU_WARM_WAIT_S": "0",
            "TPU_TIMER_DAEMON_PORT": str(timer_ports[rank][0]),
            "TPU_TIMER_PORT": str(timer_ports[rank][1]),
        })
        return subprocess.Popen(
            [sys.executable, "-c", AGENT_SRC,
             "--nnodes", "1:2", "--node_rank", str(rank),
             "--master_addr", master.addr, "--job_name", job,
             "--nproc_per_node", "1", "--max_restarts", "9",
             "--monitor_interval", "0.1", "--ckpt_dir", ckpt_dir,
             *(["--tpu-timer"] if args.tpu_timer else []),
             worker_py, ckpt_dir, log_path, str(args.steps),
             str(args.step_time), str(args.global_batch)],
            env=env, cwd=REPO, start_new_session=True,
            stdout=open(os.path.join(
                workdir, f"agent_{rank}.{time.time_ns()}.log"), "w"),
            stderr=subprocess.STDOUT)

    def segments(world=None):
        return [r for r in _read_log(log_path)
                if r["event"] == "segment_start"
                and (world is None or r["world"] == world)]

    def compute_stragglers():
        return [e for e in _journal(master, JournalEvent.STRAGGLER_DETECTED)
                if e["data"].get("cause") == "compute"]

    t_start = time.time()
    agents = {0: start_agent(0), 1: start_agent(1)}
    try:
        # phase 1: both nodes at world 2
        _wait(lambda: len(segments(2)) >= 2, 120,
              "both agents training at world 2")
        # the delay starts with rank 1's first step
        delay_start = max(r["t"] for r in segments(2))
        verdicts_before_delay = [
            e for e in _journal(master, JournalEvent.STRAGGLER_DETECTED)]
        # the skew monitor must name rank 1 / compute from telemetry
        # alone while both nodes are alive
        _wait(lambda: bool(compute_stragglers()), 60,
              "the skew monitor attributes the injected straggler")
        straggler_detect_s = time.time() - delay_start
        straggler = compute_stragglers()[0]["data"]
        skew_ratio_mid = _scrape_skew_ratio(master)
        # the straggler rule's STACK_DUMP reached agent 1: its evidence
        _wait(lambda: any(e["data"].get("rank") == 1 for e in _journal(
            master, JournalEvent.STACK_DUMP_CAPTURED)), 60,
            "agent 1's stack-dump evidence")
        dump = next(e for e in _journal(
            master, JournalEvent.STACK_DUMP_CAPTURED)
            if e["data"].get("rank") == 1)
        dump_path = dump["data"].get("path", "")
        dump_text = ""
        if dump_path and os.path.exists(dump_path):
            with open(dump_path) as f:
                dump_text = f.read()
            if not args.keep_workdir:
                os.remove(dump_path)
        stack_dump = {"source": dump["source"], "path": dump_path,
                      "holds_worker_stack": "chaos_worker.py" in dump_text,
                      **_profile_evidence(dump["data"])}
        rank1_alive = agents[1].poll() is None

        detect_s = shrink_s = step_at_shrink = hang_recover_s = None
        if not args.straggler_only:
            _wait(lambda: master.perf_monitor.completed_global_step
                  >= args.kill_at_step, 120, f"step {args.kill_at_step}")
            # phase 2: kill agent 1 (its process group: agent and worker)
            os.killpg(os.getpgid(agents[1].pid), signal.SIGKILL)
            kill_ts = time.time()
            agents[1].wait()
            _wait(lambda: master.job_manager.nodes[1].status
                  == NodeStatus.FAILED
                  or master.job_manager.nodes[1].is_released,
                  30, "the master detects the dead agent")
            detect_s = time.time() - kill_ts
            _wait(lambda: bool(segments(1)), 90,
                  "the survivor re-forms the world at 1")
            shrink_s = time.time() - kill_ts
            step_at_shrink = segments(1)[0]["start"]

            # phase 3: the node comes back, the world returns to 2
            agents[1] = start_agent(1)
            _wait(lambda: len(segments(2)) >= 4, 120, "world back at 2")

            if args.hang_at_step:
                _wait(lambda: any(r["event"] == "hang_start"
                                  for r in _read_log(log_path)),
                      60 + args.steps * (args.step_time + 0.6),
                      "the wedged worker")
                with open(hang_marker) as mf:
                    hang_ts = float(mf.read().strip())
                _wait(lambda: master.perf_monitor.completed_global_step
                      > args.hang_at_step + 1, 120,
                      "the hang restart resumed training past the hang")
                hang_recover_s = time.time() - hang_ts

        # phase 4: run to the end
        _wait(lambda: any(r["event"] == "done"
                          for r in _read_log(log_path)),
              max(180, args.steps * (args.step_time + 0.6)),
              "training completion")
        codes = {}
        for r, p in agents.items():
            try:
                codes[r] = p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                codes[r] = None
        wall = time.time() - t_start
        records = _read_log(log_path)
        segs = [r for r in records if r["event"] == "segment_start"]
        dones = [r for r in records if r["event"] == "done"]
        goodput = _merged_goodput(event_dir)
        unproductive = max(0.0, goodput["wall_s"] - goodput["productive_s"])
        # what a failed worker left in its agent's log (their output goes
        # there): the lines of its traceback
        errors = []
        for name in sorted(os.listdir(workdir)):
            if name.startswith("agent_") and name.endswith(".log"):
                with open(os.path.join(workdir, name)) as f:
                    errors += [f"{name}: {ln.rstrip()[:300]}" for ln in f
                               if "Error" in ln or "Traceback" in ln
                               or ln.startswith("  File ")][-40:]
        print(json.dumps({
            "metric": "chaos_goodput_torch",
            "goodput_pct": 100.0 * goodput["goodput"],
            "goodput_1h_extrapolated_pct":
                100.0 * (3600.0 - unproductive) / 3600.0,
            "unproductive_s": unproductive,
            "wall_s": wall,
            "productive_s": goodput["productive_s"],
            "detect_s": detect_s,
            "shrink_detect_s": shrink_s,
            "faults_injected": (0 if args.straggler_only
                                else 2 if args.hang_at_step else 1),
            "hang_recover_s": hang_recover_s,
            "step_at_shrink": step_at_shrink,
            "final_step": master.perf_monitor.completed_global_step,
            "agent_exit_codes": codes,
            "segments": segs,
            "straggler": straggler,
            "straggler_detect_s": straggler_detect_s,
            "straggler_rank_alive": rank1_alive,
            "verdicts_before_delay": verdicts_before_delay,
            "skew_ratio_mid": skew_ratio_mid,
            "stack_dump": stack_dump,
            "w_final": max((d.get("w_final", -1.0) for d in dones),
                           default=-1.0),
            "psum_ok": bool(segs) and all(s.get("psum") == s["world"]
                                          for s in segs),
            "forbidden_modules": sorted({m for d in dones
                                         for m in d["forbidden_modules"]}),
            "worker_errors": errors,
            "done": [{k: d.get(k) for k in ("rank", "world", "start",
                                             "steps", "compute_n",
                                             "hooked_gemms")}
                     for d in dones],
        }))
        return 0
    finally:
        for p in agents.values():
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        master.stop()
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrtpu_{job}_"):
                unlink_shared_memory(name)
        if not args.keep_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


def _profile_evidence(data):
    """What the dump's ``torch.profiler`` trace holds: whether it was
    taken, on which of the worker's threads, its CUDA kernel events, the
    GEMMs among them (cuBLAS kernel names) and the ``aten::mm`` CPU ops."""
    path = data.get("profile", "")
    out = {"profile_ok": bool(data.get("profile_ok")) and bool(path)
           and os.path.exists(path),
           "profile_thread": data.get("profile_thread", ""),
           "profile_kernels": 0, "profile_gemm_kernels": 0,
           "profile_mm_ops": 0}
    if not out["profile_ok"]:
        return out
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    for e in events:
        name = str(e.get("name", "")).lower()
        if e.get("cat") == "kernel":
            out["profile_kernels"] += 1
            out["profile_gemm_kernels"] += any(
                s in name for s in ("gemm", "nvjet", "xmma", "cutlass"))
        elif e.get("cat") == "cpu_op" and name == "aten::mm":
            out["profile_mm_ops"] += 1
    return out


if __name__ == "__main__":
    raise SystemExit(main())
