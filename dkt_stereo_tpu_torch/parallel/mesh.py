"""Process groups and collectives (``dkt_stereo_tpu/parallel/mesh.py``), in
PyTorch's idiom: one process a device.

The JAX package runs one program over a mesh of devices, and XLA inserts the
collectives of a sharded step. The port runs one process a device (a *rank*)
in a ``torch.distributed`` process group and issues them itself:

  - :func:`initialize_multihost` joins the group (``init_process_group``
    with an explicit backend: NCCL on GPUs, gloo on the CPU); a no-op for
    one process, as in JAX.
  - :func:`make_mesh` names the devices of N local ranks and refuses fewer
    devices than N, as JAX's does.
  - :func:`replicate` broadcasts modules and an optimizer's state from
    rank 0 once.
  - :func:`all_sum` is what the losses' global denominators use;
    :func:`reduce_step` is a data-parallel step's collective part (the
    gradients, ``ok`` and the loss values).
  - :func:`cross_replica_batch_stats` combines batch statistics with
    JAX's E[x^2] rule.
  - :func:`run_ranks` starts N local ranks in new processes and collects
    their results.

Every collective is an ``all_reduce`` or a ``broadcast``, the only two that
gloo runs on CUDA tensors, so the same code runs under NCCL on several GPUs,
under gloo on the CPU, and under gloo with several ranks sharing one GPU
(NCCL refuses two ranks on one device). Without an initialized group each
function is its one-process form and issues no collective.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Iterable

import torch
import torch.distributed as dist
from torch import nn


def distributed() -> bool:
    """Whether this process is a rank of an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def rank_and_size(group=None) -> tuple[int, int]:
    """This process's rank and the group's size; (0, 1) without a group."""
    if not distributed():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None,
                         backend: str = "nccl") -> bool:
    """Join a process group of ``num_processes`` ranks as rank
    ``process_id`` (the JAX ``initialize_multihost``; the same command and a
    distinct ``--process_id`` on every process). ``coordinator_address`` is
    rank 0's ``host:port``, or any ``init_method`` URL (``file://...``).
    Returns whether a group was joined: one process (``num_processes`` None
    or 1) joins none."""
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("--num_processes > 1 needs --coordinator_address and --process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} outside [0, {num_processes})")
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    return True


def make_mesh(n_devices: int, device="cuda") -> list[torch.device]:
    """The devices of ``n_devices`` local ranks, rank k on ``cuda:k`` (every
    rank on the CPU for ``device="cpu"``). Fewer CUDA devices than
    ``n_devices`` raise: a silent shrink would change the band geometry."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * n_devices
    count = torch.cuda.device_count()
    if n_devices > count:
        raise ValueError(f"requested {n_devices} ranks, one a device, but only {count} CUDA "
                         "devices are available")
    return [torch.device("cuda", k) for k in range(n_devices)]


def _coalesced_(tensors: Iterable[torch.Tensor], collective) -> None:
    """Apply ``collective`` (in place on one flat tensor) to ``tensors``,
    one call for each dtype and device, and copy the result back."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the group's ranks (a new tensor; ``t`` itself
    without a group). For values that need no gradient."""
    if not distributed():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def replicate(*objs, group=None) -> None:
    """Broadcast from rank 0, in place, the parameters and buffers of every
    module and the tensors of every optimizer's state in ``objs``: all
    ranks then hold rank 0's state. (The JAX ``replicate``; every rank
    builds its state from the same seed or checkpoint, and this makes them
    equal bit for bit.) A tensor the backend cannot send (a CPU step count
    under NCCL) goes through a copy on the device of the first module."""
    if not distributed():
        return
    device = None
    tensors = []
    for obj in objs:
        if isinstance(obj, nn.Module):
            tensors += [t for t in obj.state_dict().values() if torch.is_tensor(t)]
            device = device or next(obj.parameters()).device
        elif isinstance(obj, torch.optim.Optimizer):
            tensors += [t for st in obj.state.values() for t in st.values() if torch.is_tensor(t)]
        else:
            raise TypeError(f"replicate: cannot broadcast a {type(obj).__name__}")
    src = dist.get_global_rank(group, 0) if group is not None else 0
    via_device = dist.get_backend(group) == "nccl"
    on_device = [t for t in tensors if not via_device or t.device.type == "cuda"]
    _coalesced_(on_device, lambda flat: dist.broadcast(flat, src, group=group))
    for t in tensors:
        if via_device and t.device.type != "cuda":
            buf = t.to(device)
            dist.broadcast(buf, src, group=group)
            t.copy_(buf)


def reduce_step(params: Iterable[nn.Parameter], ok: torch.Tensor, values: dict,
                group=None) -> tuple[bool, dict]:
    """The collective part of a data-parallel training step, after its
    backward. Each rank's loss is its own numerators over the global counts
    (``all_sum`` in the losses), so the global loss's gradient is the SUM
    of the ranks' gradients: every parameter's gradient (zeros where the
    forward did not reach it, as in JAX) is summed over the ranks, one
    all_reduce a dtype. ``ok`` is the MIN over the ranks (their sum of 0/1
    flags equals the size), so all ranks apply or skip the update together;
    ``values`` (0-dim loss terms and metrics, each a local numerator over a
    global count) are summed. Returns ``(ok, values)``; without a group,
    ``(bool(ok), values)``."""
    if not distributed():
        return bool(ok), values
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    _coalesced_(grads, lambda flat: dist.all_reduce(flat, group=group))
    scalars = torch.stack([ok.float()] + [v.detach().float() for v in values.values()])
    dist.all_reduce(scalars, group=group)
    agreed = bool(scalars[0] == dist.get_world_size(group))
    return agreed, dict(zip(values, scalars[1:]))


def cross_replica_batch_stats(mean: torch.Tensor, var: torch.Tensor, group=None):
    """Batch statistics over the ranks from each rank's ``mean`` and biased
    ``var`` (equal counts a rank): the mean of the means, and the mean of
    ``var + mean^2`` minus the global mean squared (the JAX
    ``cross_replica_batch_stats``). One all_reduce."""
    n = rank_and_size(group)[1]
    stacked = all_sum(torch.stack([mean, var + mean.square()]), group) / n
    g_mean = stacked[0]
    return g_mean, stacked[1] - g_mean.square()


def _rank_main(fn, rank, nprocs, backend, init_method, threads, results, args):
    """A rank's process: join the group, run ``fn(rank, *args)``, report
    its result (or its traceback), leave the group."""
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend is not None:
            dist.init_process_group(backend, init_method=init_method, world_size=nprocs,
                                    rank=rank)
        # pickled here, by value: a tensor put on the queue as it is would
        # travel as a file descriptor that dies with this process
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if distributed():
            dist.destroy_process_group()


def run_ranks(fn, nprocs: int, *args, backend: str | None = "gloo", timeout: float | None = None,
              threads: int | None = None) -> list:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes (``spawn``), each
    a rank of a process group of ``backend`` (initialized through a file in
    a new temporary directory, so concurrent groups cannot race for a
    port; ``backend=None``: no group, for an ``fn`` that joins its own),
    and return the results in rank order. ``fn``, ``args`` and the
    results must pickle; ``fn`` lives at a module's top level. ``threads``
    sets each rank's ``torch.set_num_threads``. A rank that raises, dies,
    or has not finished after ``timeout`` seconds raises RuntimeError here
    (with the rank's traceback) after every rank was stopped."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks-")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, backend, init_method, threads, results, args))
             for r in range(nprocs)]
    got: dict = {}
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else (timeout + time.monotonic())
        while len(got) < nprocs and failure is None:
            wait = 1.0 if deadline is None else min(1.0, max(0.0, deadline - time.monotonic()))
            try:
                rank, ok, value = results.get(timeout=wait)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and not p.is_alive()]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif deadline is not None and time.monotonic() >= deadline:
                    failure = f"ranks {sorted(set(range(nprocs)) - set(got))} did not finish " \
                              f"in {timeout} s"
                continue
            if ok:
                got[rank] = pickle.loads(value)
            else:
                failure = f"rank {rank} raised:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        results.join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}): {failure}")
    return [got[r] for r in range(nprocs)]

