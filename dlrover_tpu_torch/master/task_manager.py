"""The master's shard ledger: dataset shards dispatched under leases.

The port's copy of the part of ``dlrover_tpu/master/task_manager.py`` the
sharding clients use. A worker pulls a shard task under a lease; a
successful report retires it into the ``acked`` set (a repeated report is
a no-op), a failed report puts it back at the front of the queue. A dead
worker's leases go back at once (``recover_tasks``), and a lease older
than ``shard_lease_timeout_s`` on the master's monotonic clock goes back
at the next ``check_leases`` sweep. The position of a dataset, acked set
included, round-trips through the shard checkpoint JSON. ``monotonic`` is
injectable for deterministic lease tests; dispatch fires the
``data.dispatch`` chaos site after the lease is recorded.

Not ported (ROADMAP): the batched acks, cooperative shedding and stealing,
and the whole-ledger export behind the checkpoint's data-state sidecar.
"""

import json
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common.comm import (
    DatasetShardParams,
    Shard,
    TaskMessage,
)
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.constants import ChaosSite
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.dataset_splitter import DatasetSplitter


class _PendingTask:
    def __init__(self, task: TaskMessage, node_id: int, leased_at: float,
                 deadline: float):
        self.task = task
        self.node_id = node_id
        self.leased_at = leased_at
        self.deadline = deadline  # master-monotonic lease expiry


class _DatasetManager:
    """One dataset's ledger; mutated under the TaskManager's RLock."""

    def __init__(self, splitter: DatasetSplitter, lock: threading.RLock):
        self.splitter = splitter
        self._lock = lock
        self.todo: List[TaskMessage] = []
        self.doing: Dict[int, _PendingTask] = {}
        self.acked: set = set()
        self.next_task_id = 0
        self.completed = 0

    def refill(self) -> None:
        with self._lock:
            if self.todo or self.doing or self.splitter.epoch_finished():
                return
            for shard in self.splitter.create_shards():
                self.todo.append(TaskMessage(
                    task_id=self.next_task_id, task_type="train",
                    shard=shard, dataset_name=self.splitter.dataset_name))
                self.next_task_id += 1

    def finished(self) -> bool:
        with self._lock:
            return (self.splitter.epoch_finished() and not self.todo
                    and not self.doing)

    def requeue(self, pending: _PendingTask) -> None:
        with self._lock:
            self.todo.insert(0, pending.task)


class TaskManager:
    def __init__(self, monotonic: Callable[[], float] = time.monotonic):
        self._monotonic = monotonic
        self._lock = threading.RLock()
        self._datasets: Dict[str, _DatasetManager] = {}
        self._params: Dict[str, DatasetShardParams] = {}
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._check_hanged_tasks,
                                        name="task-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def new_dataset(self, params: DatasetShardParams) -> None:
        with self._lock:
            if params.dataset_name in self._datasets:
                return
            self._datasets[params.dataset_name] = _DatasetManager(
                DatasetSplitter.build(params), self._lock)
            self._params[params.dataset_name] = params
            logger.info("task manager: registered dataset %s (size=%s)",
                        params.dataset_name, params.dataset_size)

    def get_task(self, node_id: int, dataset_name: str
                 ) -> Optional[TaskMessage]:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return None
            ds.refill()
            if not ds.todo:
                return None
            task = ds.todo.pop(0)
            now = self._monotonic()
            ds.doing[task.task_id] = _PendingTask(
                task, node_id, now,
                now + get_context().shard_lease_timeout_s)
        # after the lease is recorded: a dropped dispatch loses only the
        # reply, and the lease requeues on expiry
        inj = get_injector()
        if inj is not None:
            inj.fire(ChaosSite.DATA_DISPATCH, dataset=dataset_name,
                     task_id=task.task_id, node_id=node_id)
        return task

    def report_task_result(self, dataset_name: str, task_id: int,
                           node_id: int, success: bool) -> str:
        """Retire or release one lease. Returns ``"accepted"`` (first
        success), ``"duplicate"`` (already acked), ``"released"`` (a
        failure: back to the queue) or ``"unknown"``."""
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return "unknown"
            if task_id in ds.acked:
                return "duplicate"
            pending = ds.doing.pop(task_id, None)
            if not success:
                if pending is None:
                    return "unknown"
                ds.requeue(pending)
                return "released"
            if pending is None:
                # its requeued copy may still wait in the queue: the report
                # proves the work is done, so nobody trains it again
                idx = next((i for i, t in enumerate(ds.todo)
                            if t.task_id == task_id), None)
                if idx is None:
                    return "unknown"
                ds.todo.pop(idx)
            ds.acked.add(task_id)
            ds.completed += 1
            return "accepted"

    def completed_count(self, dataset_name: str) -> int:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            return ds.completed if ds else 0

    def recover_tasks(self, node_id: int) -> None:
        """Requeue every lease of a dead worker."""
        with self._lock:
            for name, ds in self._datasets.items():
                stale = [tid for tid, p in ds.doing.items()
                         if p.node_id == node_id]
                for tid in stale:
                    ds.requeue(ds.doing.pop(tid))
                if stale:
                    logger.info("re-queued %s tasks of dead node %s on "
                                "dataset %s", len(stale), node_id, name)

    def finished(self, dataset_name: str) -> bool:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            return ds.finished() if ds else True

    def check_leases(self) -> int:
        """Requeue every lease past its deadline; returns how many."""
        expired = 0
        with self._lock:
            now = self._monotonic()
            for name, ds in self._datasets.items():
                for tid in [tid for tid, p in ds.doing.items()
                            if now > p.deadline]:
                    pending = ds.doing.pop(tid)
                    ds.requeue(pending)
                    expired += 1
                    logger.warning("lease %s:%s on node %s expired — "
                                   "re-queued", name, tid, pending.node_id)
        return expired

    def _check_hanged_tasks(self) -> None:
        poll = get_context().shard_lease_check_s
        while not self._stopped.wait(poll):
            self.check_leases()

    # -- shard checkpoint ----------------------------------------------------

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return ""
            todo = [t.task_id for t in ds.todo]
            doing = list(ds.doing.keys())
            shards = {
                t.task_id: [t.shard.start, t.shard.end,
                            list(t.shard.record_indices)
                            if t.shard.record_indices else None]
                for t in list(ds.todo) + [p.task for p in ds.doing.values()]
            }
            return json.dumps({
                "dataset": dataset_name,
                "epoch": ds.splitter.epoch,
                "splitter_offset": getattr(ds.splitter, "_offset", None),
                # in-flight shards count as not done and requeue first
                "todo": doing + todo,
                "shards": shards,
                "acked": sorted(ds.acked),
                "next_task_id": ds.next_task_id,
                "completed": ds.completed,
            })

    def restore_shard_checkpoint(self, content: str) -> None:
        if not content:
            return
        data = json.loads(content)
        with self._lock:
            ds = self._datasets.get(data["dataset"])
            if ds is None:
                return
            ds.splitter.epoch = data["epoch"]
            offset = data.get("splitter_offset")
            if offset is not None and hasattr(ds.splitter, "_offset"):
                ds.splitter._offset = offset
            ds.todo.clear()
            ds.doing.clear()
            ds.acked.clear()
            ds.acked.update(int(t) for t in data.get("acked", []))
            ds.completed = data.get("completed", 0)
            for tid in data["todo"]:
                start, end, *rest = data["shards"][str(tid)]
                indices = rest[0] if rest else None
                ds.todo.append(TaskMessage(
                    task_id=int(tid), task_type="train",
                    shard=Shard(name=f"{data['dataset']}:{start}:{end}",
                                start=start, end=end,
                                record_indices=indices),
                    dataset_name=data["dataset"]))
            ds.next_task_id = data["next_task_id"]
            logger.info("restored shard checkpoint for %s: %s pending "
                        "tasks", data["dataset"], len(ds.todo))
