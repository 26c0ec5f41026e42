"""The port's kill-shrink-rejoin drill end to end on the CPU:
``examples/chaos_goodput_torch.py`` as a subprocess, one port master, two
port agents and their gloo workers, held to the drill assertions of
``tests/test_chaos_e2e.py:22-171`` that its slice carries, the straggler
half's among them (the reshard, flight-recorder and journal halves wait
for their planes); and the straggler half alone with the device timer,
whose straggler rule's stack dump must reach agent 1 and hold the
worker's Python stack. Each drill is a subprocess with its own time
limit.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 40


def test_chaos_kill_shrink_resume_rejoin_on_the_port():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "examples", "chaos_goodput_torch.py"),
         "--steps", str(STEPS), "--step-time", "0.15",
         "--kill-at-step", "10"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])

    segments = result["segments"]
    worlds = [(s["world"], s["accum"]) for s in segments]
    # phase 1: both nodes at world 2, 4 rows each of the global batch 8
    assert worlds.count((2, 4)) >= 2
    # phase 2: the survivor shrank to world 1 and its share doubled ...
    shrink = [s for s in segments if s["world"] == 1]
    assert shrink and shrink[0]["accum"] == 8
    # ... resuming from a checkpoint, not from scratch
    assert shrink[0]["start"] > 0
    # phase 3: the agent came back, the world returned to 2 and training
    # went on past the shrink point
    rejoin = [s for s in segments[segments.index(shrink[0]):]
              if s["world"] == 2]
    assert len(rejoin) >= 2
    assert all(s["start"] >= shrink[0]["start"] for s in rejoin)
    assert result["final_step"] == STEPS - 1
    # every segment's all-reduce of ones equals its world: 2 -> 1 -> 2
    assert result["psum_ok"] is True
    assert {s["psum"] for s in segments} == {1.0, 2.0}
    # one exact increment a step: nothing lost or applied twice
    assert result["w_final"] == float(STEPS)
    # detection rides the connection drop and its grace, well inside the
    # 3 s heartbeat timeout
    assert result["detect_s"] < 3.0, result["detect_s"]
    assert 0 < result["goodput_pct"] <= 100
    assert result["agent_exit_codes"] == {"0": 0, "1": 0}
    # skew attribution: the injected 0.25 s/step compute delay on agent
    # 1's worker surfaced through the op-telemetry uplink as a
    # straggler_detected verdict naming the right rank AND cause, while
    # the rank was still alive, and the skew gauge was live on the same
    # mid-drill scrape
    assert result["straggler"]["rank"] == 1, result["straggler"]
    assert result["straggler"]["cause"] == "compute", result["straggler"]
    assert result["straggler"]["ratio"] > 2.0, result["straggler"]
    assert result["straggler_rank_alive"] is True
    assert result["skew_ratio_mid"] > 0.0, result["skew_ratio_mid"]
    # no process of the drill loaded JAX or the JAX package
    assert result["forbidden_modules"] == []


def test_straggler_drill_with_the_timer_dumps_the_slow_rank():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "examples", "chaos_goodput_torch.py"),
         "--steps", "16", "--step-time", "0", "--straggler-only",
         "--tpu-timer"],
        env=env, capture_output=True, text=True, timeout=180, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [(r["world"], r["start"]) for r in result["segments"]] == [
        (2, 0), (2, 0)]
    assert result["verdicts_before_delay"] == []
    assert (result["straggler"]["rank"], result["straggler"]["cause"]) == (
        1, "compute")
    assert result["straggler"]["ratio"] > 2.0
    assert result["straggler_rank_alive"] is True
    assert result["skew_ratio_mid"] > 2.0
    # the straggler rule's STACK_DUMP reached agent 1, whose evidence
    # holds the worker's Python stack (read through the timer's daemon)
    assert result["stack_dump"]["source"] == "agent_1"
    assert result["stack_dump"]["holds_worker_stack"] is True
    assert result["final_step"] == 15 and result["w_final"] == 16.0
    assert result["agent_exit_codes"] == {"0": 0, "1": 0}
    assert result["forbidden_modules"] == []
