"""Data pipeline: samplers and a threaded prefetching loader (counterpart
of ``gecco_tpu/data/loader.py``, which it copies: numpy batches, the same
batches for the same seed).

Point-cloud batches are small (B*N*3 floats) and datasets are npy/npz
reads, so a thread pool with double-buffered prefetch keeps the host side
ahead of the card; ``types.to_device`` moves a batch over. A sampler:

- ``ConcatenatedSampler``: infinite step-count-driven stream of shuffled
  epochs (length = batch_size * num_steps);
- ``FixedSampler``: deterministic fixed permutation for validation.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np

from gecco_tpu_torch.types import tree_map

__all__ = [
    "ConcatenatedSampler",
    "FixedSampler",
    "DataLoader",
    "dataloader",
    "ConcatDataset",
]


class ConcatDataset:
    """Concatenation of map-style datasets (replaces
    torch.utils.data.ConcatDataset used by the reference loaders)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, index: int):
        if index < 0:
            index += len(self)
        dataset_idx = int(np.searchsorted(self.cumulative_sizes, index, side="right"))
        prev = 0 if dataset_idx == 0 else self.cumulative_sizes[dataset_idx - 1]
        return self.datasets[dataset_idx][index - prev]


class ConcatenatedSampler:
    """Shuffled epochs concatenated up to ``length`` samples (util.py:10-36)."""

    def __init__(self, data_source, length: Optional[int], seed: int = 42):
        self.data_length = len(data_source)
        self.length = length  # None => infinite stream
        self.seed = seed

    def __len__(self):
        if self.length is None:
            raise TypeError("infinite sampler has no length")
        return self.length

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed)
        yielded = 0
        while self.length is None or yielded < self.length:
            permutation = rng.permutation(self.data_length)
            if self.length is not None:
                permutation = permutation[: self.length - yielded]
            yield from permutation.tolist()
            yielded += permutation.shape[0]


class FixedSampler:
    """Deterministic fixed subset (util.py:39-62)."""

    def __init__(self, dataset, length: Optional[int] = None, seed: int = 42):
        if length is None:
            length = len(dataset)
        if length > len(dataset):
            raise ValueError(f"{length=} is more than {len(dataset)=}.")
        rng = np.random.default_rng(seed)
        self.permutation = rng.permutation(len(dataset))[:length]

    def __len__(self):
        return self.permutation.shape[0]

    def __iter__(self) -> Iterator[int]:
        yield from self.permutation.tolist()


def _collate(items: Sequence):
    """Stack a list of Example pytrees into one batched pytree."""

    def stack(*leaves):
        if hasattr(leaves[0], "__array__"):
            return np.stack([np.asarray(l) for l in leaves])
        return leaves[0]

    return tree_map(stack, *items)


class DataLoader:
    """Threaded, prefetching batch loader over a map-style dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler,
        num_workers: int = 8,
        prefetch: int = 2,
        drop_last: bool = True,
        name: Optional[str] = None,
        shard_by_process: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.name = name
        if shard_by_process:
            raise NotImplementedError(
                "shard_by_process (each rank loading its slice of the global "
                "batch) comes with multi-device training, ROADMAP A10"
            )

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> Iterator[list]:
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __iter__(self):
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has gone; False then."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for indices in self._batch_indices():
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, indices))
                        if not put(_collate(items)):
                            return
                except Exception as e:  # surface loader errors to the consumer
                    put(e)
                finally:
                    put(StopIteration)

        thread = threading.Thread(target=produce, daemon=True, name=f"loader-{self.name}")
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is StopIteration:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # the producer sees the flag at its next batch or queue put and
            # ends; a batch being read finishes first
            stop.set()
            thread.join()


def dataloader(
    dataset,
    batch_size: int,
    num_steps: Optional[int] = None,
    num_workers: int = 8,
    fixed_sampler: bool = False,
    sequential_sampler: bool = False,
    drop_last: Optional[bool] = None,
    name: Optional[str] = None,
    shard_by_process: bool = False,
) -> DataLoader:
    """Factory with the reference's sampler selection logic (util.py:65-107)."""
    if sequential_sampler and not fixed_sampler:
        raise AssertionError("sequential_sampler requires fixed_sampler")

    length = None if num_steps is None else batch_size * num_steps
    if fixed_sampler:
        if sequential_sampler:
            sampler = FixedSampler(dataset, length=length, seed=0)
            sampler.permutation = np.arange(len(sampler.permutation))
        else:
            sampler = FixedSampler(dataset, length=length)
        drop = False if drop_last is None else drop_last
    else:
        sampler = ConcatenatedSampler(dataset, length=length)
        drop = True if drop_last is None else drop_last

    return DataLoader(
        dataset,
        batch_size=batch_size,
        sampler=sampler,
        num_workers=num_workers,
        drop_last=drop,
        name=name,
        shard_by_process=shard_by_process,
    )
