"""Tiny elastic training script of the port, for the agent tests (the
counterpart of ``tests/data/elastic_train.py``).

Invariant: the checkpointed weight always equals step + 1, so after any
crash and resume the final value is 10, and ``start`` in the output file
shows whether a restarted run resumed from a checkpoint.
"""

import os
import sys
import time

import torch

from dlrover_tpu_torch import worker
from dlrover_tpu_torch.ckpt.checkpointer import Checkpointer, StorageType

ctx = worker.init(device="cpu")
ckpt_dir, out_file = sys.argv[1], sys.argv[2]
if ctx.world_size > 1:
    out_file = f"{out_file}.r{ctx.rank}"  # one output per rank
crash_step = int(os.getenv("CRASH_AT_STEP", "-1"))
step_time = float(os.getenv("STEP_TIME_S", "0"))
if os.getenv("CRASH_IMMEDIATELY") == "1":
    os._exit(7)
if os.getenv("ABORT_IMMEDIATELY") == "1":
    os.abort()  # SIGABRT, as an uncaught c10::Error ends a worker

state = {"w": torch.zeros(4, 4), "step": torch.zeros((), dtype=torch.int64)}
# single writer: rank 0 owns the replicated toy state
ckpt = Checkpointer(ckpt_dir, saving_ranks=[0])
state, step = ckpt.load_checkpoint(state)
start = step + 1 if step >= 0 else 0

for s in range(start, 10):
    state = {"w": state["w"] + 1.0, "step": torch.tensor(s)}
    if ctx.rank == 0:
        ckpt.save_checkpoint(s, state, StorageType.DISK)
        ckpt.engine.wait_drained()
    ctx.report_step(s)
    if step_time:
        time.sleep(step_time)
    if s == crash_step and (
            ctx.restart_count == 0 or os.getenv("ALWAYS_CRASH") == "1"):
        print(f"worker rank {ctx.rank} crashing at step {s}", flush=True)
        os._exit(7)

with open(out_file, "w") as f:
    f.write(f"done w={float(state['w'][0, 0])} start={start} "
            f"restarts={ctx.restart_count} world={ctx.world_size}")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dlrover_tpu"))
print(f"training complete, forbidden modules {bad}", flush=True)
worker.shutdown()
