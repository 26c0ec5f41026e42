"""The port's warm worker spares (``dlrover_tpu_torch/agent/warm_spawn.py``)
against the JAX package's cases (``tests/test_warm_spawn.py``), and what
the port adds:

- the spares' pre-imports, the port's worker, engine, model, kernel and
  trainer modules among them, succeed with ``torch.cuda.is_available``
  and ``device_count`` made to raise: no module touches the device at
  import, so a spare holds no CUDA context before its release;
- the environment merged at release reaches the chaos injector and the
  worker's context (nothing read it at import);
- under the device timer a spare is spawned with the hook library in
  ``LD_PRELOAD``, and the loader mapped it before the script ran;
- the port's ``dlrover-run`` runs a restarted worker from a spare (the
  reference's end-to-end case).
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from dlrover_tpu_torch.agent.config import ElasticLaunchConfig  # noqa: E402
from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.agent.training import (  # noqa: E402
    ElasticTrainingAgent,
)
from dlrover_tpu_torch.agent.warm_spawn import (  # noqa: E402
    DEFAULT_PREIMPORTS,
    WarmWorkerPool,
)
from dlrover_tpu_torch.common.constants import ConfigKey  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DLROVER_TPU_", "DLROVER_FAULT_"))}
    env.update({"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    return env


def test_take_runs_script_with_env_and_argv(tmp_path):
    out = tmp_path / "out.json"
    script = tmp_path / "w.py"
    script.write_text(
        "import json, os, sys\n"
        f"json.dump({{'rank': os.environ.get('TRANK'),"
        f" 'argv': sys.argv[1:], 'name': __name__}},"
        f" open({str(out)!r}, 'w'))\n")
    pool = WarmWorkerPool(size=1, base_env=_env(), preimports="json")
    try:
        pool.prewarm()
        proc = pool.take({"TRANK": "7"}, str(script), ["--a", "b"])
        assert proc is not None
        assert proc.wait(timeout=30) == 0
        # as `python w.py --a b` with the incarnation's environment
        assert json.loads(out.read_text()) == {
            "rank": "7", "argv": ["--a", "b"], "name": "__main__"}
    finally:
        pool.stop()


def test_replacement_warmed_after_take(tmp_path):
    script = tmp_path / "w.py"
    script.write_text("pass\n")
    pool = WarmWorkerPool(size=1, base_env=_env(), preimports="")
    try:
        pool.prewarm()
        first = pool.take({}, str(script), [])
        assert first is not None and first.wait(timeout=30) == 0
        second = pool.take({}, str(script), [])
        assert second is not None and second.wait(timeout=30) == 0
        assert second.pid != first.pid
    finally:
        pool.stop()


def test_dead_spare_is_skipped(tmp_path):
    script = tmp_path / "w.py"
    script.write_text("pass\n")
    pool = WarmWorkerPool(size=1, base_env=_env(), preimports="")
    try:
        pool.prewarm()
        pool._spares[0].kill()
        pool._spares[0].wait()
        # the corpse is skipped: None (the agent spawns cold) or a fresh
        # spare if the re-warm won the race
        proc = pool.take({}, str(script), [])
        if proc is not None:
            assert proc.wait(timeout=30) == 0
    finally:
        pool.stop()


def test_spares_exit_on_pool_stop():
    pool = WarmWorkerPool(size=2, base_env=_env(), preimports="")
    pool.prewarm()
    spares = list(pool._spares)
    assert len(spares) == 2
    pool.stop()
    for p in spares:
        assert p.poll() is not None  # EOF on stdin retired them


def test_worker_sees_preimported_module(tmp_path):
    out = tmp_path / "mods.txt"
    script = tmp_path / "w.py"
    script.write_text(
        "import sys\n"
        f"open({str(out)!r}, 'w').write(str('numpy' in sys.modules))\n")
    pool = WarmWorkerPool(size=1, base_env=_env(), preimports="numpy")
    try:
        pool.prewarm()
        proc = pool.take({}, str(script), [])
        assert proc is not None and proc.wait(timeout=60) == 0
        assert out.read_text() == "True"
    finally:
        pool.stop()


def test_worker_can_import_sibling_module(tmp_path):
    out = tmp_path / "out.txt"
    (tmp_path / "sibmod.py").write_text("VALUE = 42\n")
    script = tmp_path / "w.py"
    script.write_text(
        "import sibmod\n"
        f"open({str(out)!r}, 'w').write(str(sibmod.VALUE))\n")
    pool = WarmWorkerPool(size=1, base_env=_env(), preimports="")
    try:
        pool.prewarm()
        proc = pool.take({}, str(script), [])
        assert proc is not None and proc.wait(timeout=30) == 0
        assert out.read_text() == "42"
    finally:
        pool.stop()


def test_agent_restart_uses_warm_spawn(tmp_path):
    """``python -m dlrover_tpu_torch.agent.run`` with warm spawn on (the
    default): a crashed first incarnation is restarted, and both came from
    spares (torch already imported at the script's first line; a cold
    ``python train.py`` starts without it)."""
    out = tmp_path / "steps.txt"
    script = tmp_path / "train.py"
    script.write_text(
        "import sys\n"
        "warm = 'torch' in sys.modules\n"
        "import os\n"
        "from dlrover_tpu_torch import worker\n"
        "ctx = worker.init(initialize_distributed=False, device='cpu')\n"
        f"path = {str(out)!r}\n"
        "n = sum(1 for _ in open(path)) if os.path.exists(path) else 0\n"
        "with open(path, 'a') as f:\n"
        "    f.write('run warm=%s restart=%s\\n' % (warm, "
        "ctx.restart_count))\n"
        "if n == 0:\n"
        "    sys.exit(3)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.agent.run",
         "--standalone", "--nproc_per_node", "1", "--max_restarts", "2",
         "--monitor_interval", "0.1", f"--job_name=ws{os.getpid()}",
         str(script)],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert out.read_text().splitlines() == [
        "run warm=True restart=0", "run warm=True restart=1"]


# -- what the port adds ----------------------------------------------------------

# made to raise in the spare before the port's modules import: any module
# that asks the device at import fails its pre-import
_CUDA_GUARD = '''
import torch
calls = []


def _refuse(name):
    def f(*a, **k):
        calls.append(name)
        raise RuntimeError("torch.cuda." + name + " called at import")
    return f


torch.cuda.is_available = _refuse("is_available")
torch.cuda.device_count = _refuse("device_count")
'''

_PORT_MODULES = ("dlrover_tpu_torch.worker,dlrover_tpu_torch.ckpt.engine,"
                 "dlrover_tpu_torch.ckpt.replica,"
                 "dlrover_tpu_torch.ckpt.reshard,"
                 "dlrover_tpu_torch.models.llama,"
                 "dlrover_tpu_torch.models.moe,"
                 "dlrover_tpu_torch.ops.flash_attention,"
                 "dlrover_tpu_torch.trainer.elastic")


def test_preimports_make_no_cuda_call(tmp_path):
    (tmp_path / "cuda_guard.py").write_text(_CUDA_GUARD)
    out = tmp_path / "out.json"
    script = tmp_path / "w.py"
    script.write_text(
        "import json, sys, torch, cuda_guard\n"
        f"json.dump({{'calls': cuda_guard.calls,"
        " 'loaded': sorted(m for m in sys.modules"
        "                  if m.startswith('dlrover_tpu_torch.')),"
        " 'cuda_initialized': torch.cuda.is_initialized()},"
        f" open({str(out)!r}, 'w'))\n")
    env = _env()
    env["PYTHONPATH"] = str(tmp_path) + os.pathsep + REPO
    pool = WarmWorkerPool(size=1, base_env=env,
                          preimports="numpy,torch,cuda_guard,"
                          + _PORT_MODULES)
    try:
        pool.prewarm()
        assert pool.wait_ready(1, timeout_s=120)
        marker = next(iter(pool._ready_files.values()))
        # the marker names the pre-imports that failed: none did
        assert open(marker).read() == ""
        proc = pool.take({}, str(script), [])
        assert proc is not None and proc.wait(timeout=60) == 0
    finally:
        pool.stop()
    got = json.loads(out.read_text())
    assert got["calls"] == [] and got["cuda_initialized"] is False
    assert set(_PORT_MODULES.split(",")) <= set(got["loaded"])
    assert DEFAULT_PREIMPORTS == "numpy,torch,dlrover_tpu_torch.worker"


def test_release_env_reaches_injector_and_context(tmp_path):
    """The incarnation's fault schedule, ranks, round and shm nonce reach
    a spare that imported the port's worker before they were set."""
    out = tmp_path / "out.json"
    script = tmp_path / "w.py"
    script.write_text(
        "import json, os\n"
        "from dlrover_tpu_torch import worker\n"
        "from dlrover_tpu_torch.chaos import get_injector\n"
        "from dlrover_tpu_torch.ckpt.shm_handler import shm_name\n"
        "ctx = worker.init(initialize_distributed=False, device='cpu')\n"
        "inj = get_injector()\n"
        f"json.dump({{'sites': [r.site for r in inj.rules] if inj else [],"
        " 'rank': ctx.rank, 'world': ctx.world_size,"
        " 'restart': ctx.restart_count, 'node': ctx.node_rank,"
        " 'shm': shm_name('j', 0, 0),"
        " 'spare': os.environ.get('DLROVER_TPU_WARM_SPARE')},"
        f" open({str(out)!r}, 'w'))\n")
    pool = WarmWorkerPool(size=1, base_env=_env())
    try:
        pool.prewarm()
        assert pool.wait_ready(1, timeout_s=120)
        proc = pool.take({
            "DLROVER_FAULT_SCHEDULE": "rpc.send:delay=1ms@times=1",
            "DLROVER_TPU_RANK": "3", "DLROVER_TPU_WORLD_SIZE": "4",
            "DLROVER_TPU_RESTART_COUNT": "2", "DLROVER_TPU_NODE_RANK": "1",
            "DLROVER_TPU_SHM_INCARNATION": "abc123",
        }, str(script), [])
        assert proc is not None and proc.wait(timeout=60) == 0
    finally:
        pool.stop()
    got = json.loads(out.read_text())
    assert got["sites"] == ["rpc.send"]
    assert (got["rank"], got["world"], got["restart"], got["node"]) == (
        3, 4, 2, 1)
    assert got["shm"] == "dlrtpu_j_0_0_iabc123"
    spawn, import_s, release = (float(x) for x in got["spare"].split(","))
    assert spawn <= release and 0 <= import_s <= release - spawn


def test_spare_under_the_timer_preloads_the_hook(tmp_path):
    """The agent's pool starts after the timer's build: its spare is
    spawned with the hook in ``LD_PRELOAD``, which the loader read at
    exec (the library is mapped before the script's first line)."""
    from dlrover_tpu_torch.tpu_timer import build

    lib = str(build.build()["lib"])
    out = tmp_path / "out.json"
    script = tmp_path / "w.py"
    script.write_text(
        "import json, os\n"
        f"json.dump({{'mapped': any({lib!r} in ln"
        " for ln in open('/proc/self/maps')),"
        " 'enable': os.environ.get('TPU_TIMER_ENABLE')},"
        f" open({str(out)!r}, 'w'))\n")
    config = ElasticLaunchConfig(
        nproc_per_node=1, job_name=f"wt{os.getpid()}",
        master_addr="127.0.0.1:1", entrypoint=str(script), tpu_timer=True,
        worker_env=_env())
    agent = ElasticTrainingAgent(config, MasterClient("127.0.0.1:1", 0, 0))
    try:
        agent._timer_lib = lib
        os.environ[ConfigKey.WARM_PREIMPORT] = "json"
        try:
            agent._start_warm_pool()
        finally:
            os.environ.pop(ConfigKey.WARM_PREIMPORT)
        spare = agent._warm_pool._spares[0]
        with open(f"/proc/{spare.pid}/environ", "rb") as f:
            environ = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                           if b"=" in kv)
        assert environ[b"LD_PRELOAD"].decode().split()[0] == lib
        proc = agent._warm_pool.take(agent._with_timer({}), str(script), [])
        assert proc is not None and proc.wait(timeout=60) == 0
    finally:
        if agent._warm_pool is not None:
            agent._warm_pool.stop()
        agent._ipc_server.stop()
    assert json.loads(out.read_text()) == {"mapped": True, "enable": "1"}
