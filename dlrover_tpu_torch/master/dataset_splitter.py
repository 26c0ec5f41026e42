"""Dataset splitters: a dataset cut into dispatchable shards.

The port's copy of ``dlrover_tpu/master/dataset_splitter.py``. A shard is
a ``[start, end)`` range, with explicit record indices for the text
splitter; each epoch re-creates the shards (shuffled through the global
``random`` when asked, as the reference does, so one seed gives one order
in both packages). Shard size is ``batch_size × num_minibatches_per_shard``.
"""

import random
from typing import List

from dlrover_tpu_torch.common.comm import DatasetShardParams, Shard
from dlrover_tpu_torch.common.log import logger


class DatasetSplitter:
    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = max(1, shard_size)
        self.num_epochs = max(1, num_epochs)
        self.epoch = 0

    def create_shards(self) -> List[Shard]:
        """The shards of the next epoch."""
        raise NotImplementedError

    def epoch_finished(self) -> bool:
        return self.epoch >= self.num_epochs

    @staticmethod
    def build(params: DatasetShardParams) -> "DatasetSplitter":
        shard_size = max(
            1, params.batch_size * max(1, params.num_minibatches_per_shard))
        if params.splitter == "text":
            return TextDatasetSplitter(
                params.dataset_name, params.dataset_size, shard_size,
                params.num_epochs, params.shuffle)
        if params.splitter == "streaming":
            return StreamingDatasetSplitter(
                params.dataset_name, params.dataset_size, shard_size,
                params.num_epochs)
        return TableDatasetSplitter(
            params.dataset_name, params.dataset_size, shard_size,
            params.num_epochs, params.shuffle)


class TableDatasetSplitter(DatasetSplitter):
    """Range shards over a row-addressable dataset."""

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int, shuffle: bool = False):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle

    def create_shards(self) -> List[Shard]:
        self.epoch += 1
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(Shard(name=f"{self.dataset_name}:{start}:{end}",
                                start=start, end=end))
        if self._shuffle:
            random.shuffle(shards)
        logger.info("dataset %s epoch %s: %s shards of %s rows",
                    self.dataset_name, self.epoch, len(shards),
                    self.shard_size)
        return shards


class TextDatasetSplitter(DatasetSplitter):
    """Shards carrying explicit, optionally shuffled, record indices."""

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int, shuffle: bool = False):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle

    def create_shards(self) -> List[Shard]:
        self.epoch += 1
        indices = list(range(self.dataset_size))
        if self._shuffle:
            random.shuffle(indices)
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(Shard(name=f"{self.dataset_name}:{start}:{end}",
                                start=start, end=end,
                                record_indices=indices[start:end]))
        return shards


class StreamingDatasetSplitter(DatasetSplitter):
    """An unbounded dataset: shards forward from an advancing offset;
    ``dataset_size`` < 0 means no end."""

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int, fetch_batch: int = 32):
        super().__init__(dataset_name, dataset_size, shard_size, 1)
        self._offset = 0
        self._fetch_batch = fetch_batch

    def epoch_finished(self) -> bool:
        return 0 <= self.dataset_size <= self._offset

    def create_shards(self) -> List[Shard]:
        shards = []
        for _ in range(self._fetch_batch):
            if 0 <= self.dataset_size <= self._offset:
                break
            end = self._offset + self.shard_size
            if self.dataset_size >= 0:
                end = min(end, self.dataset_size)
            shards.append(Shard(
                name=f"{self.dataset_name}:{self._offset}:{end}",
                start=self._offset, end=end))
            self._offset = end
        return shards
