"""``python -m dlrover_tpu_torch.agent.run``: the port's ``dlrover-run``.

The port's copy of ``dlrover_tpu/agent/run.py``, with the flags this slice
needs::

    python -m dlrover_tpu_torch.agent.run --standalone --nproc-per-node=2 \\
        --ckpt_dir /tmp/ckpt train.py --train-arg=1
    python -m dlrover_tpu_torch.agent.run --master-addr=HOST:PORT \\
        --nnodes=1:2 --node-rank=1 --job_name=job train.py

``--standalone`` starts a :class:`LocalJobMaster` in this process; else
the agent joins the master at ``--master-addr`` (the JAX package's or the
port's). The agent persists the newest shm frames when workers fail
(``--save-at-breakpoint``, the default; ``--no-save-at-breakpoint`` turns
it off) into ``--ckpt_dir``. ``--tpu-timer`` builds the device timer and
preloads its CUDA hook into the workers (``agent/training.py``).
``--ckpt-replica N`` (N > 1) starts the agent's checkpoint replica store,
and the workers push each sealed frame to it and to their backup group
(``ckpt/replica.py``). Workers come from pre-imported spares
(``agent/warm_spawn.py``) unless ``--no-warm-spawn``; the agent starts
its pool itself, after the device timer's build, since a spare's
``LD_PRELOAD`` must be set when it starts. Not ported: the network check,
auto-tuning and the actor host.
"""

import argparse
import sys
import time
from typing import List, Optional

from dlrover_tpu_torch.agent.config import ElasticLaunchConfig
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.training import ElasticTrainingAgent
from dlrover_tpu_torch.ckpt.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common.constants import EnvKey, env_str
from dlrover_tpu_torch.common.log import logger


def parse_nnodes(value: str):
    if ":" in value:
        lo, hi = value.split(":", 1)
        return int(lo), int(hi)
    n = int(value)
    return n, n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "dlrover_tpu_torch.agent.run",
        description="elastic training launcher of the PyTorch port")
    p.add_argument("--standalone", action="store_true",
                   help="run a local in-process master (single node)")
    p.add_argument("--nnodes", default="1",
                   help="number of nodes, or MIN:MAX for elastic jobs")
    p.add_argument("--nproc_per_node", "--nproc-per-node",
                   dest="nproc_per_node", type=int, default=1)
    p.add_argument("--node_rank", "--node-rank", dest="node_rank", type=int,
                   default=0)
    p.add_argument("--master_addr", "--master-addr", dest="master_addr",
                   default=env_str(EnvKey.MASTER_ADDR))
    p.add_argument("--job_name", "--job-name", dest="job_name",
                   default=env_str(EnvKey.JOB_NAME, "local"))
    p.add_argument("--max_restarts", "--max-restarts", dest="max_restarts",
                   type=int, default=3)
    p.add_argument("--monitor_interval", "--monitor-interval",
                   dest="monitor_interval", type=float, default=0.2)
    p.add_argument("--node_unit", "--node-unit", dest="node_unit", type=int,
                   default=1)
    p.add_argument("--ckpt_dir", "--ckpt-dir", dest="ckpt_dir", default="")
    p.add_argument("--save-at-breakpoint", dest="save_at_breakpoint",
                   action="store_true", default=True)
    p.add_argument("--no-save-at-breakpoint", dest="save_at_breakpoint",
                   action="store_false")
    p.add_argument("--ckpt_replica", "--ckpt-replica", dest="ckpt_replica",
                   type=int, default=0,
                   help="checkpoint replica backup-group size (0: off)")
    p.add_argument("--tpu-timer", dest="tpu_timer", action="store_true",
                   help="enable the device timer: workers preload its CUDA "
                        "hook, the agent aggregates on :18889")
    p.add_argument("--no-warm-spawn", dest="warm_spawn",
                   action="store_false",
                   help="no pre-imported spare interpreters: every worker "
                        "spawn pays the numpy/torch imports")
    p.add_argument("entrypoint", help="training script")
    p.add_argument("args", nargs=argparse.REMAINDER)
    return p


def config_from_args(args) -> ElasticLaunchConfig:
    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    config = ElasticLaunchConfig(
        min_nodes=min_nodes, max_nodes=max_nodes,
        nproc_per_node=args.nproc_per_node, node_rank=args.node_rank,
        job_name=args.job_name, master_addr=args.master_addr,
        max_restarts=args.max_restarts,
        monitor_interval_s=args.monitor_interval, node_unit=args.node_unit,
        save_at_breakpoint=args.save_at_breakpoint, ckpt_dir=args.ckpt_dir,
        ckpt_replica=args.ckpt_replica, tpu_timer=args.tpu_timer,
        warm_spawn=args.warm_spawn, entrypoint=args.entrypoint,
        args=args.args[1:] if args.args[:1] == ["--"] else list(args.args))
    config.auto_configure_params()
    return config


def _launch_local_master(config: ElasticLaunchConfig):
    """The in-process master of standalone mode."""
    from dlrover_tpu_torch.master.master import LocalJobMaster

    master = LocalJobMaster(job_name=config.job_name,
                            node_num=config.min_nodes,
                            min_nodes=config.min_nodes,
                            max_nodes=config.max_nodes,
                            node_unit=config.node_unit)
    master.prepare()
    config.master_addr = master.addr
    return master


def wait_pre_check(client: MasterClient, timeout_s: float = 600.0) -> None:
    """Poll the master's pre-check gate."""
    start = time.time()
    while time.time() - start < timeout_s:
        status, reason = client.get_pre_check_result()
        if status == "pass":
            return
        if status == "fail":
            raise RuntimeError(f"pre-check failed: {reason}")
        time.sleep(1.0)
    raise TimeoutError("pre-check did not finish in time")


def _apply_master_run_config(client: MasterClient,
                             config: ElasticLaunchConfig) -> None:
    """Merge the master's launcher overrides; unknown keys are ignored."""
    try:
        resp = client.get_run_config()
    except (ConnectionError, OSError, RuntimeError):
        return
    for key, value in (resp or {}).items():
        if hasattr(config, key):
            setattr(config, key, value)
            logger.info("master-pushed run config: %s=%r", key, value)
        else:
            logger.warning("master-pushed run config key %r unknown — "
                           "ignored", key)


def run(config: ElasticLaunchConfig) -> int:
    master = None
    if config.master_addr == "":
        master = _launch_local_master(config)
        logger.info("standalone master at %s", config.master_addr)
    client = MasterClient(config.master_addr, config.node_id,
                          config.node_rank)
    try:
        _apply_master_run_config(client, config)
        wait_pre_check(client)
        saver = None
        if config.ckpt_dir or config.save_at_breakpoint:
            saver = AsyncCheckpointSaver(
                ckpt_dir=config.ckpt_dir, node_rank=config.node_rank,
                local_world_size=config.nproc_per_node,
                expected_frames=config.min_nodes * config.nproc_per_node,
                is_commit_leader=(config.node_rank == 0))
        agent = ElasticTrainingAgent(config, client, ckpt_saver=saver)
        return agent.run()
    finally:
        if master is not None:
            master.stop()


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    if not args.standalone and not config.master_addr:
        print("error: --master-addr required unless --standalone",
              file=sys.stderr)
        return 2
    if args.standalone and config.master_addr:
        logger.info("--standalone ignored: master addr %s given",
                    config.master_addr)
    return run(config)


if __name__ == "__main__":
    raise SystemExit(main())
