"""Host-side batch loader in PyTorch's idiom: the port's
``dkt_stereo_tpu/data/loader.py``.

A ``torch.utils.data.DataLoader`` runs over a dataset of *batches*
(``batch_size=None``): its item ``(e, b)`` is batch ``b`` of epoch ``e``,
the dataset's indices shuffled by ``np.random.RandomState(seed + e)`` and
cut into ``batch_size`` pieces, each sample augmented with
``np.random.default_rng((seed, e, 0, b))``. That is the JAX loader's process
mode (``_proc_batch``), so every batch is deterministic, equal to
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
worker reaches the consumer (the DataLoader re-raises it there).

:class:`MixedStereoLoader` draws binocular and NeRF-Stereo triplet samples
into batches of a static split, ``nb`` binocular rows then ``nt``
trinocular ones, in ``data/triplet.py::collate_mixed``'s nested form.

With ``num_hosts`` > 1 (one loader a rank of multi-process training),
``batch_size`` is the global batch and host ``host_id`` gets rows
``[host_id * B / N, (host_id + 1) * B / N)`` of each batch, augmented with
``default_rng((seed, e, host_id, b))``: the JAX loader's process mode for
that host, the job key included. A mixed batch is then host blocks of
``nb / N`` binocular and ``nt / N`` trinocular rows, as in JAX.
"""

from __future__ import annotations

import atexit
import multiprocessing
import os

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from dkt_stereo_tpu_torch.data.triplet import collate_mixed


def _collate(samples: list[dict]) -> dict:
    """Stack the samples' arrays into CPU tensors, key by key."""
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]}


class _EpochBatches(Dataset):
    """Item ``(epoch, b)``: this host's rows of batch ``b`` of that epoch's
    shuffled indices (``batch_size`` is the global batch)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, seed: int, num_hosts: int = 1,
                 host_id: int = 0):
        self.dataset, self.batch_size = dataset, batch_size
        self.shuffle, self.seed = shuffle, seed
        self.num_hosts, self.host_id = num_hosts, host_id
        self._epoch, self._indices = None, None

    def epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def indices(self, epoch: int) -> np.ndarray:
        if epoch != self._epoch:
            self._epoch, self._indices = epoch, self.epoch_indices(epoch)
        return self._indices

    def collate(self, samples: list[dict]):
        return _collate(samples)

    def __getitem__(self, item):
        epoch, b = item
        chunk = self.indices(epoch)[b * self.batch_size:(b + 1) * self.batch_size]
        local = self.batch_size // self.num_hosts
        chunk = chunk[self.host_id * local:(self.host_id + 1) * local]
        rng = np.random.default_rng((self.seed, epoch, self.host_id, b))
        return self.collate([self.dataset.get_sample(int(i), rng) for i in chunk])


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
                 drop_last: bool = True, seed: int = 1234, num_hosts: int = 1, host_id: int = 0):
        if batch_size % num_hosts:
            raise ValueError(f"the global batch {batch_size} must divide across {num_hosts} "
                             "hosts")
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} outside [0, {num_hosts})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.seed = seed
        self.num_hosts, self.host_id = num_hosts, host_id
        self.epoch = 0
        workers = max(0, num_workers)
        context = None
        if workers:
            context = multiprocessing.get_context("forkserver")
            context.set_forkserver_preload([__name__])
        self._loader = DataLoader(
            self._epoch_batches(shuffle), batch_size=None,
            sampler=_EpochSampler(self), num_workers=workers,
            pin_memory=torch.cuda.is_available(), prefetch_factor=2 if workers else None,
            multiprocessing_context=context,
            worker_init_fn=_worker_init)
        self._stream, self._at = None, None

    def _epoch_batches(self, shuffle: bool) -> _EpochBatches:
        return _EpochBatches(self.dataset, self.batch_size, shuffle, self.seed, self.num_hosts,
                             self.host_id)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        # several hosts: a ragged tail cannot split into equal rows a host,
        # so it is dropped whatever drop_last says (the JAX loader's rule)
        if not self.drop_last and len(self.dataset) % self.batch_size and self.num_hosts == 1:
            n += 1
        return n

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """The dataset's indices in epoch ``epoch``'s order, cut into
        batches by position."""
        return self._loader.dataset.epoch_indices(epoch)

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


class _MixedView:
    """One index space over a binocular pool [0, n_bi) followed by a
    trinocular pool [n_bi, n_bi + n_tri)."""

    def __init__(self, bi_dataset, tri_dataset):
        self.bi, self.tri = bi_dataset, tri_dataset
        self.n_bi = len(bi_dataset) if bi_dataset is not None else 0
        self.n_tri = len(tri_dataset) if tri_dataset is not None else 0

    def get_sample(self, index, rng=None):
        if index < self.n_bi:
            return self.bi.get_sample(index, rng)
        return self.tri.get_sample(index - self.n_bi, rng)

    def __len__(self):
        return self.n_bi + self.n_tri


class _MixedEpochBatches(_EpochBatches):
    """Batch ``b`` holds ``nb`` binocular indices, then ``nt`` trinocular
    ones, each pool shuffled on its own."""

    def __init__(self, view: _MixedView, batch_size: int, shuffle: bool, seed: int, nb: int,
                 nt: int, nbatch: int, num_hosts: int = 1, host_id: int = 0):
        super().__init__(view, batch_size, shuffle, seed, num_hosts, host_id)
        self.nb, self.nt, self.nbatch = nb, nt, nbatch

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rs = np.random.RandomState(self.seed + epoch)
        bi = np.arange(self.dataset.n_bi)
        tri = self.dataset.n_bi + np.arange(self.dataset.n_tri)
        if self.shuffle:
            rs.shuffle(bi)
            rs.shuffle(tri)
        # a batch is host blocks [host 0: nb/N bi, nt/N tri | host 1: ...],
        # so that each host's rows have the static composition
        nb_l, nt_l = self.nb // self.num_hosts, self.nt // self.num_hosts
        out = np.empty((self.nbatch, self.num_hosts, nb_l + nt_l), np.int64)
        for b in range(self.nbatch):
            for h in range(self.num_hosts):
                bsrc, tsrc = b * self.nb + h * nb_l, b * self.nt + h * nt_l
                out[b, h, :nb_l] = bi[bsrc:bsrc + nb_l]
                out[b, h, nb_l:] = tri[tsrc:tsrc + nt_l]
        return out.reshape(-1)

    def collate(self, samples: list[dict]):
        return collate_mixed(samples)[0]


class MixedStereoLoader(StereoLoader):
    """Binocular and trinocular samples in batches of a static split
    (``dkt_stereo_tpu/data/loader.py::MixedStereoLoader``): every batch holds
    ``nb`` binocular samples and then ``nt`` trinocular ones, drawn from the
    two pools shuffled on their own (one ``RandomState(seed + epoch)``,
    binocular first). The reference's ``NerfStereo.collate_fn``
    (core/stereo_datasets.py:449-480) under torch's sampler gives a
    different split in every batch; a static one keeps the step's shapes.
    ``num_tri`` sets ``nt``; by default it is proportional to the pools'
    sizes, within [1, batch_size - 1] when both are non-empty. An epoch is
    as many batches as the scarcer pool fills. A batch is
    ``{im1_forward, im2_forward, bi: {flow, valid}, tri: {flow, conf, im0,
    im1, im2}}`` of CPU tensors (``data/triplet.py::collate_mixed``)."""

    def __init__(self, bi_dataset, tri_dataset, batch_size: int, num_tri: int | None = None,
                 **kw):
        view = _MixedView(bi_dataset, tri_dataset)
        if num_tri is None:
            if view.n_bi == 0:
                num_tri = batch_size
            elif view.n_tri == 0:
                num_tri = 0
            else:
                frac = view.n_tri / (view.n_bi + view.n_tri)
                num_tri = int(np.clip(round(batch_size * frac), 1, batch_size - 1))
        if not 0 <= num_tri <= batch_size:
            raise ValueError(f"num_tri {num_tri} outside [0, {batch_size}]")
        if (num_tri and view.n_tri == 0) or (batch_size - num_tri and view.n_bi == 0):
            raise ValueError(
                f"split nb={batch_size - num_tri}/nt={num_tri} draws from an "
                f"empty pool (n_bi={view.n_bi}, n_tri={view.n_tri})")
        self.nt = num_tri
        self.nb = batch_size - num_tri
        hosts = kw.get("num_hosts", 1)
        if self.nb % hosts or self.nt % hosts:
            raise ValueError(f"modality split nb={self.nb}/nt={self.nt} must divide across "
                             f"{hosts} hosts (each host's rows need the same static "
                             "composition)")
        super().__init__(view, batch_size, **kw)

    def _epoch_batches(self, shuffle: bool) -> _EpochBatches:
        return _MixedEpochBatches(self.dataset, self.batch_size, shuffle, self.seed, self.nb,
                                  self.nt, len(self), self.num_hosts, self.host_id)

    def __len__(self):
        n = []
        if self.nb:
            n.append(self.dataset.n_bi // self.nb)
        if self.nt:
            n.append(self.dataset.n_tri // self.nt)
        return min(n)
