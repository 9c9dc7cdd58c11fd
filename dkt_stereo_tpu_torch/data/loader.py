"""Host-side batch loader in PyTorch's idiom: the port's
``dkt_stereo_tpu/data/loader.py``.

A ``torch.utils.data.DataLoader`` runs over a dataset of *batches*
(``batch_size=None``): its item ``(e, b)`` is batch ``b`` of epoch ``e``,
the dataset's indices shuffled by ``np.random.RandomState(seed + e)`` and
cut into ``batch_size`` pieces, each sample augmented with
``np.random.default_rng((seed, e, 0, b))``. That is the JAX loader's process
mode (``_proc_batch``, one host), so every batch is deterministic, equal to
the JAX one, and independent of which worker builds it. (The JAX threaded
mode seeds each worker instead, so its batches depend on scheduling; the
port does not follow it.)

``num_workers`` processes decode and augment; with 0 the batches are built
in the calling process. The workers are forked from a ``forkserver``
process that has imported this module once (a clean, single-threaded
parent, so starting 16 workers costs no 16 imports of torch), and they are
handed the items of one stream that runs epoch after epoch, so they work
ahead across an epoch's end instead of idling there (an epoch of 3 batches
would otherwise keep at most 3 in flight). Iterating the loader yields one
epoch of that stream. A batch is a dict of CPU tensors (``img1``, ``img2``,
``img1_clean``, ``img2_clean`` (B, H, W, 3), ``flow``, ``valid`` (B, H,
W), float32), pinned when a CUDA device exists, for the caller's
``.to(device, non_blocking=True)``. An exception in a
worker reaches the consumer (the DataLoader re-raises it there). One
process only: the JAX loader's ``num_hosts``/``host_id`` sharding and
``MixedStereoLoader`` (NeRF-Stereo) are not ported (ROADMAP.md Queue 1
items 11 and 10).
"""

from __future__ import annotations

import atexit
import multiprocessing
import os

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler


def _collate(samples: list[dict]) -> dict:
    """Stack the samples' arrays into CPU tensors, key by key."""
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]}


class _EpochBatches(Dataset):
    """Item ``(epoch, b)``: batch ``b`` of that epoch's shuffled indices."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int):
        self.dataset, self.batch_size = dataset, batch_size
        self.shuffle, self.seed = shuffle, seed
        self._epoch, self._indices = None, None

    def indices(self, epoch: int) -> np.ndarray:
        if epoch != self._epoch:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                np.random.RandomState(self.seed + epoch).shuffle(idx)
            self._epoch, self._indices = epoch, idx
        return self._indices

    def __getitem__(self, item):
        epoch, b = item
        chunk = self.indices(epoch)[b * self.batch_size:(b + 1) * self.batch_size]
        rng = np.random.default_rng((self.seed, epoch, 0, b))
        return _collate([self.dataset.get_sample(int(i), rng) for i in chunk])


class _EpochSampler(Sampler):
    """Yields ``(epoch, b)`` from the loader's current epoch on, epoch after
    epoch; it runs in the consumer's process when a stream starts."""

    def __init__(self, loader: "StereoLoader"):
        self.loader = loader

    def __iter__(self):
        epoch = self.loader.epoch
        while True:
            yield from ((epoch, b) for b in range(len(self.loader)))
            epoch += 1


def _worker_init(worker_id: int) -> None:
    """Make a worker process leave with ``os._exit`` once its loop has
    ended. A worker stopped while its queue's feeder thread is still inside
    torch's C++ (sharing a batch's storage) would otherwise abort at
    interpreter exit, when that daemon thread is unwound through a
    ``noexcept`` frame, and the DataLoader would raise in the consumer.
    Nothing is left to flush: the loop ends only when the consumer no
    longer wants its results."""
    atexit.register(os._exit, 0)


class StereoLoader:
    """Batches of ``dataset`` (see the module docstring); iterating it runs
    one epoch, after which ``epoch`` counts up. An epoch left before its
    end is run again from its first batch by the next iteration, as the JAX
    loader does."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 8,
                 drop_last: bool = True, seed: int = 1234):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        workers = max(0, num_workers)
        context = None
        if workers:
            context = multiprocessing.get_context("forkserver")
            context.set_forkserver_preload([__name__])
        self._loader = DataLoader(
            _EpochBatches(dataset, batch_size, shuffle, seed), batch_size=None,
            sampler=_EpochSampler(self), num_workers=workers,
            pin_memory=torch.cuda.is_available(), prefetch_factor=2 if workers else None,
            multiprocessing_context=context,
            worker_init_fn=_worker_init)
        self._stream, self._at = None, None

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        if len(self) == 0:  # the stream would never yield an item
            return
        if self._at != (self.epoch, 0):  # no stream, or one left mid-epoch
            self.close()
            self._stream, self._at = iter(self._loader), (self.epoch, 0)
        for b in range(len(self)):
            batch = next(self._stream)
            self._at = (self.epoch, b + 1)
            yield batch
        self.epoch += 1
        self._at = (self.epoch, 0)

    def close(self):
        """Stop the stream and its worker processes."""
        stream, self._stream, self._at = self._stream, None, None
        if stream is not None and hasattr(stream, "_shutdown_workers"):
            stream._shutdown_workers()
