"""Worker-side elastic data pipeline: sampler and dataloader.

The port's copy of the host-side parts of ``dlrover_tpu/trainer/data.py``.
Batches are numpy on the host, the same as the reference's for the same
seed, resume offset and replica count; the trainer moves them to the card.

- :class:`ElasticDistributedSampler` — deterministic epoch-shuffled
  partition over data-parallel replicas with a consumed-offset checkpoint,
  so a resumed job (possibly with another replica count) skips the data it
  already saw.
- :class:`ElasticDataLoader` — batches a map-style dataset; its batch size
  is re-read from the JSON config file the auto-tuner rewrites, so a
  running job can change its micro-batch without restarting.

Not ported yet: ``ShardingClient`` / ``IndexShardingClient`` (they pull
shards from the master over RPC), so the loader takes a sampler only.
"""

import json
import os
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np

from dlrover_tpu_torch.common.constants import ConfigKey
from dlrover_tpu_torch.common.log import logger


class ElasticDistributedSampler:
    """Deterministic epoch-shuffled partition over DP replicas with a
    consumed-offset checkpoint.

    ``state_dict``/``load_state_dict`` carry (epoch, completed samples); on
    resume every replica skips the globally-consumed prefix and
    re-partitions the rest."""

    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.completed = 0  # samples consumed across ALL replicas this epoch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.completed = 0

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(self.dataset_size)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        return order

    def __iter__(self) -> Iterator[int]:
        order = self._epoch_order()[self.completed:]
        remaining = len(order)
        if self.drop_last:
            remaining -= remaining % self.num_replicas
            order = order[:remaining]
        elif remaining % self.num_replicas:
            # pad by wrapping: every replica must yield the same count or a
            # data-parallel loop deadlocks on the ragged collective step
            pad = self.num_replicas - remaining % self.num_replicas
            order = np.concatenate([order, order[:pad]])
        for i in range(self.rank, len(order), self.num_replicas):
            yield int(order[i])

    def __len__(self) -> int:
        remaining = self.dataset_size - self.completed
        if self.drop_last:
            return remaining // self.num_replicas
        return -(-remaining // self.num_replicas)

    def record_batch(self, global_batch_size: int) -> None:
        """Advance the consumed offset by one *global* batch."""
        self.completed = min(
            self.dataset_size, self.completed + global_batch_size
        )

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "completed": self.completed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state.get("epoch", 0))
        self.completed = int(state.get("completed", 0))


class ElasticDataLoader:
    """Batches a map-style dataset with a hot-reloadable batch size.

    ``config_file`` (written by the auto-tuner; default: the file named by
    ``DLROVER_TPU_PARAL_CONFIG_FILE``) is re-checked between batches: if it
    names a new ``dataloader_batch_size``, or a ``micro_batch_scale`` of
    the original size, the next batch uses it.

    ``dataset`` is anything indexable returning a sample: a numpy array, a
    list/tuple of arrays, or a dict of arrays; samples are stacked leaf-wise
    into numpy batches. The ragged tail is dropped.
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        sampler: Optional[ElasticDistributedSampler] = None,
        config_file: Optional[str] = None,
        collate_fn: Optional[Callable[[List[Any]], Any]] = None,
    ):
        self._dataset = dataset
        self.batch_size = batch_size
        self._sampler = sampler
        self._config_file = config_file or os.getenv(
            ConfigKey.PARAL_CONFIG_FILE)
        self._config_mtime = 0.0
        self._base_batch_size = self.batch_size
        self._collate = collate_fn or _default_collate

    def _maybe_reload_config(self) -> None:
        if not self._config_file or not os.path.exists(self._config_file):
            return
        try:
            mtime = os.path.getmtime(self._config_file)
            if mtime <= self._config_mtime:
                return
            self._config_mtime = mtime
            with open(self._config_file, encoding="utf-8") as f:
                cfg = json.load(f)
            new_bs = int(cfg.get("dataloader_batch_size", 0))
            if new_bs <= 0 and "micro_batch_scale" in cfg:
                # a relative plan applies to the *original* batch size, so
                # reloads are idempotent and a factor of 1.0 restores it
                scale = float(cfg.get("micro_batch_scale", 1.0))
                new_bs = max(1, int(round(self._base_batch_size * scale)))
            if new_bs > 0 and new_bs != self.batch_size:
                logger.info(
                    "dataloader batch size %s → %s (auto-tuner)",
                    self.batch_size, new_bs,
                )
                self.batch_size = new_bs
        except (ValueError, OSError, json.JSONDecodeError) as e:
            logger.warning("bad dataloader config file: %r", e)

    def __iter__(self):
        it = iter(self._sampler) if self._sampler is not None else iter(
            range(len(self._dataset))
        )
        while True:
            self._maybe_reload_config()
            idxs = []
            for idx in it:
                idxs.append(idx)
                if len(idxs) >= self.batch_size:
                    break
            if len(idxs) < self.batch_size:
                return
            yield self._collate([self._dataset[i] for i in idxs])


def _default_collate(samples: List[Any]):
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            np.stack([s[i] for s in samples]) for i in range(len(first))
        )
    return np.stack(samples)


def stack_microbatches(batches: Sequence[Any]):
    """Stack ``accum`` collated batches into the ``(accum, micro, ...)``
    layout :meth:`ElasticTrainer.train_step` runs over, leaf by leaf."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: stack_microbatches([b[k] for b in batches]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_microbatches([b[i] for b in batches])
                           for i in range(len(first)))
    return np.stack(batches)
