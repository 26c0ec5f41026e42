"""One rank of a gloo world restoring through the port's checkpoint
ladder, for ``tests/test_torch_resharding.py``.

    python torch_ladder_rank.py <out dir>

with the worker environment of an agent's rank (rank, world, master,
job, rendezvous round, replica group). The rank builds the tiny Llama's
params sharded over fsdp (seeded 9: what it restores must overwrite
them), restores them with an empty checkpoint directory, writes its
local blocks to ``<out dir>/rank<r>.npz`` and prints one ``RESULT
<json>`` line: the step, the rung, the regions it holds.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu_torch import worker  # noqa: E402
from dlrover_tpu_torch.ckpt.engine import CheckpointEngine  # noqa: E402
from dlrover_tpu_torch.ckpt.reshard import needs_from_state  # noqa: E402
from dlrover_tpu_torch.convert import named_leaves  # noqa: E402
from dlrover_tpu_torch.models import llama  # noqa: E402
from dlrover_tpu_torch.parallel.mesh import build_mesh, plan_mesh  # noqa: E402
from dlrover_tpu_torch.parallel.sharding import shard_tree  # noqa: E402


def main(out_dir):
    ctx = worker.init(device="cpu")
    c = llama.LlamaConfig.tiny()
    c = dataclasses.replace(c, dtype=torch.float32)
    mesh = build_mesh(plan_mesh(ctx.world_size, tp=1, sp=1), "cpu")
    params = shard_tree(mesh, llama.init_params(
        c, torch.Generator().manual_seed(9), "cpu"),
        llama.param_logical_axes(c))
    engine = CheckpointEngine(
        os.path.join(out_dir, "empty_ckpt"), job_name=ctx.job_name,
        node_rank=ctx.node_rank, local_rank=ctx.local_rank, rank=ctx.rank,
        world_size=ctx.world_size, local_world_size=ctx.local_world_size,
        ipc_socket="/nonexistent", master_client=ctx.master)
    state = {"params": params}
    restored, step = engine.load(state)
    local = {name: (t.to_local() if hasattr(t, "to_local") else t).numpy()
             for name, t in named_leaves(restored)}
    np.savez(os.path.join(out_dir, f"rank{ctx.rank}.npz"),
             **{f"a{i}": local[n] for i, n in enumerate(sorted(local))})
    needs = needs_from_state(state)
    print("RESULT " + json.dumps(dict(
        rank=ctx.rank, step=step, medium=engine.last_restore.get("medium"),
        written_back=engine.last_restore.get("written_back"),
        names=sorted(local),
        regions={n: [list(map(list, r)) for r in needs[n].regions]
                 for n in sorted(local)})), flush=True)
    worker.shutdown()


def launch(n, out_dir, env_extra, timeout=120):
    """``n`` ranks of node 0; their RESULT dicts by rank."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT_"))}
        env.update({
            "DLROVER_TPU_RANK": str(r), "DLROVER_TPU_WORLD_SIZE": str(n),
            "DLROVER_TPU_LOCAL_RANK": str(r),
            "DLROVER_TPU_LOCAL_WORLD_SIZE": str(n),
            "DLROVER_TPU_NODE_RANK": "0",
            "DLROVER_TPU_COORDINATOR_ADDR": f"127.0.0.1:{port}",
            "DLROVER_TPU_LOG_LEVEL": "WARNING", "OMP_NUM_THREADS": "1",
            **env_extra})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out_dir], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = {}
    for p, out in zip(procs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"rank failed ({p.returncode}):\n{out}")
        res = json.loads(lines[-1][len("RESULT "):])
        results[res["rank"]] = res
    return results


if __name__ == "__main__":
    main(sys.argv[1])
