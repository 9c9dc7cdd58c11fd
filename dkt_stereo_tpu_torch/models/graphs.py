"""A module section replayed from one CUDA graph a key
(``models/raft_stereo.py``'s test-mode refinement).

A :class:`GraphCache` belongs to one module and keeps up to
:data:`MAX_KEYS` keys, least recently used first out. A key's first call
runs eagerly: it is also the warm-up that a capture needs (the kernels
built and loaded, cuDNN's and cuBLAS's choices made). Its second call
captures the section into a CUDA graph and replays it, and every later
call replays it. A replay copies the call's inputs into the graph's input
buffers, replays the graph and returns clones of its outputs, so that a
caller never holds a tensor that the next replay overwrites. A key seen
once is dropped when newer keys push it out, so shapes that each come once
are never captured.

The graph reads the section's weights where they lie: an update in place
(an EMA's ``mul_``/``add_``, ``load_state_dict``) reaches the next replay.
The caller passes the weights' addresses with every call; where they
changed (``.to()``, a parameter replaced), every graph of the module is
dropped.

Memory: every graph on a device captures into one private pool, and the
graphs whose inputs have one signature (shapes, strides, dtypes) share
their input buffers (a DKT step's two teachers). Graphs replay one at a
time on the current stream, each with its inputs copied in just before
and its outputs cloned just after, so that none needs what another's
replay overwrites. The pool is reserved and not allocated between
replays; the input and output buffers are tensors that the graphs own,
allocated as long as one of them lives.

Kernel launch counters (the ``launches`` attribute of ``ops/cuda``'s
wrappers) count what the card runs: the capture adds nothing to them and
each replay adds the launches that the capture recorded.

Autocast regions inside the capture run with autocast's cast cache off, as
PyTorch asks of a capture.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import torch

MAX_KEYS = 4  # keys a module keeps, captured or seen once


class _Buffers(list):
    """Input buffers, shared by the graphs of one signature."""


class _Pool:
    """A device's private pool, kept by the graphs captured into it (a pool
    lives only as long as a graph holds it)."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()


_BUFFERS = weakref.WeakValueDictionary()  # (device, signature) -> _Buffers
_POOLS = weakref.WeakValueDictionary()  # device -> _Pool


def capture_cuda(body, inputs):
    """Capture ``body(*buffers)`` into a CUDA graph in the device's pool,
    ``buffers`` the input buffers of ``inputs``' signature (module
    docstring). Returns ``(replay, input buffers, output buffers)``."""
    dev = inputs[0].device
    sig = (dev, tuple((t.shape, t.stride(), t.dtype) for t in inputs))
    buffers = _BUFFERS.get(sig)
    if buffers is None:
        buffers = _BUFFERS[sig] = _Buffers(
            torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=dev) for t in inputs)
    graph = torch.cuda.CUDAGraph()
    cache = torch.is_autocast_cache_enabled()
    torch.set_autocast_cache_enabled(False)
    try:
        with torch.cuda.device(dev):
            pool = _POOLS.get(dev)
            if pool is None:
                pool = _POOLS[dev] = _Pool()
            graph.pool_kept = pool
            with torch.cuda.graph(graph, pool=pool.handle, capture_error_mode="thread_local"):
                outputs = body(*buffers)
    finally:
        torch.set_autocast_cache_enabled(cache)
    return graph.replay, buffers, list(outputs)


capture_cuda.device_type = "cuda"  # the inputs' device that it captures


class _Graph:
    """A captured section: its replay, its buffers, the counters it raises
    and the launches that a replay adds to each. Called with the section's
    inputs, it returns clones of its outputs."""

    def __init__(self, replay, inputs, outputs, counters, launches):
        self.replay, self.inputs, self.outputs = replay, inputs, outputs
        self.counters, self.launches = counters, launches

    def __call__(self, inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.replay()
        for c, n in zip(self.counters, self.launches):
            c.launches += n
        return tuple(o.clone() for o in self.outputs)


class GraphCache:
    """One module's graphs by key (module docstring), captured by
    ``capture`` (:func:`capture_cuda`) for inputs on its ``device_type``;
    a copy of the cache (a copied or pickled module) starts empty."""

    capture = staticmethod(capture_cuda)

    def __init__(self):
        self.entries: OrderedDict = OrderedDict()  # key -> _Graph, or None when seen once
        self.weights = None

    def __reduce__(self):
        return type(self), ()

    def get(self, key, weights, body, inputs, counters=()):
        """The key's graph of ``body(*inputs)``, captured on the key's
        second call; None on its first, where the caller runs ``body``
        eagerly, and for inputs that ``capture`` does not serve.
        ``weights``: the addresses of what ``body`` reads besides its
        inputs; ``counters``: the objects whose integer ``launches``
        ``body`` may raise."""
        if inputs[0].device.type != self.capture.device_type:
            return None
        if weights != self.weights:
            self.entries.clear()
            self.weights = weights
        if key not in self.entries:
            self.entries[key] = None
            if len(self.entries) > MAX_KEYS:
                self.entries.popitem(last=False)
            return None
        self.entries.move_to_end(key)
        graph = self.entries[key]
        if graph is None:
            before = [c.launches for c in counters]
            try:
                replay, bufs, outs = self.capture(body, inputs)
                launches = [c.launches - n for c, n in zip(counters, before)]
            finally:
                for c, n in zip(counters, before):
                    c.launches = n
            graph = self.entries[key] = _Graph(replay, bufs, outs, counters, launches)
        return graph
