"""What each rank of ``tests/test_torch_parallel.py``'s and
``tests/test_torch_profiling.py``'s process groups runs
(``parallel/mesh.py::run_ranks`` starts them with ``spawn``; every function
is ``job(rank, *args)`` and returns numpy arrays and floats).

Kept apart from the test files so that a rank imports the port alone, not
JAX and the test's fixtures.
"""

from __future__ import annotations

import torch

# the eval-protocol configs of the exact banded cases
RAFT_1GRU = {"model": "RAFTStereo", "mixed_precision": False, "corr_dtype": "float32",
             "context_norm": "instance", "n_gru_layers": 1, "slow_fast_gru": False}
RAFT_BASE = {"model": "RAFTStereo", "mixed_precision": False, "corr_dtype": "float32",
             "context_norm": "batch", "n_gru_layers": 3, "slow_fast_gru": False}
IGEV = {"model": "IGEVStereo", "max_disp": 32, "mixed_precision": False}


def _np(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def stats_job(rank, x):
    """``cross_replica_batch_stats`` of this rank's rows of ``x`` (rows x
    features): the mean and biased variance over everything."""
    from dkt_stereo_tpu_torch.parallel.mesh import cross_replica_batch_stats, rank_and_size

    _, size = rank_and_size()
    rows = torch.from_numpy(x).chunk(size)[rank]
    mean, var = cross_replica_batch_stats(rows.mean(), rows.var(unbiased=False))
    return float(mean), float(var)


def band_job(rank, bands, th, halo, band_h, fh):
    """This rank's band (NHWC, as JAX holds it) through ``InstanceNorm`` and
    ``band_refresh`` under ``cross_band_stats``: NCHW features (dim 2) and
    NHWC ones (dim 1, the coordinates' layout)."""
    from dkt_stereo_tpu_torch.nn.norms import InstanceNorm, band_refresh, cross_band_stats

    x = torch.from_numpy(bands[rank][None])  # (1, th, W, C)
    nchw = x.permute(0, 3, 1, 2).contiguous()
    with cross_band_stats(None, th, halo, band_h, fh, 2):
        normed = InstanceNorm()(nchw).permute(0, 2, 3, 1)
        refreshed = band_refresh(nchw).permute(0, 2, 3, 1)
        refreshed_nhwc = band_refresh(x, dim=1)
    return normed[0].numpy(), refreshed[0].numpy(), refreshed_nhwc[0].numpy()


def _banded_model(case):
    from dkt_stereo_tpu_torch.models.registry import create_model

    model = create_model(case["config"], iters=case["iters"], device="cpu", seed=case["seed"],
                         test_mode=True).eval()
    if case.get("damp"):
        # a head scaled down so that an iteration moves the disparity by a
        # few px, the trained regime (``damp``: (name part, factor))
        part, factor = case["damp"]
        with torch.no_grad():
            for name, p in model.named_parameters():
                if part in name:
                    p.mul_(factor)
    return model


def jobs(rank, calls):
    """Several jobs of this module in one process group, in order:
    ``calls`` is a list of ``(name, args)``; returns their results."""
    return [globals()[name](rank, *args) for name, args in calls]


def _rowlocal(a, b):
    """A forward whose receptive field is one pixel."""
    return -(a.mean(-1) * 0.01 + b.mean(-1) * 0.02)


def mesh_job(rank, img1, img2, halo):
    """``banded_forward_mesh`` of the row-local forward."""
    from dkt_stereo_tpu_torch.eval.tiled import banded_forward_mesh

    _rowlocal.device = torch.device("cpu")
    return banded_forward_mesh(_rowlocal, img1, img2, halo=halo)


def exact_job(rank, cases, img1, img2):
    """Every case of ``cases`` through ``banded_forward_exact`` on this
    rank's band; then the unbanded forward of the cases ``i % 2 == rank``
    (the frame padded as the eval pads it), so the two ranks share that
    work. Returns ``(banded, unbanded)`` lists, None where another rank
    ran the unbanded one."""
    from dkt_stereo_tpu_torch.eval.tiled import banded_forward_exact
    from dkt_stereo_tpu_torch.ops.pad import pad_input, unpad_input

    banded, unbanded = [], []
    for i, case in enumerate(cases):
        model = _banded_model(case)
        banded.append(banded_forward_exact(model, img1, img2, halo=case["halo"]))
        if i % 2 != rank:
            unbanded.append(None)
            continue
        x1, spec = pad_input(torch.from_numpy(img1)[None], 32, "sintel")
        x2, _ = pad_input(torch.from_numpy(img2)[None], 32, "sintel")
        with torch.inference_mode():
            _, disp = model(x1, x2)
        unbanded.append(unpad_input(disp[..., None], spec)[0, ..., 0].numpy())
    return banded, unbanded


def dkt_step_job(rank, config, hyper, batch, seed):
    """One DKT step on this rank's rows of ``batch`` (numpy, the global
    batch), from the state of ``seed``; F&E draws from a generator seeded
    with 11 (the global batch's, this rank's rows). Returns the metrics,
    the student's weights and its (summed, clipped) gradients."""
    from dkt_stereo_tpu_torch.parallel.mesh import rank_and_size
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    _, size = rank_and_size()
    hyper = DKTHyperParams(**hyper)
    state = create_dkt_state(config, hyper, seed=seed, device="cpu")
    local = {k: torch.from_numpy(v).chunk(size)[rank].contiguous() for k, v in batch.items()}
    state, metrics = make_dkt_train_step(config, hyper)(
        state, local, generator=torch.Generator().manual_seed(11))
    grads = {k: p.grad.numpy().copy() for k, p in state.student.named_parameters()}
    return metrics, _np(state.student.state_dict()), grads


def _rank_rows(batch, rank, size):
    if isinstance(batch, dict):
        return {k: _rank_rows(v, rank, size) for k, v in batch.items()}
    return torch.from_numpy(batch).chunk(size)[rank].contiguous()


def ns_step_job(rank, config, hyper, blocks, seed, nb, nt):
    """One NS step on this rank's block (``blocks[rank]``: nb/N binocular
    rows then nt/N trinocular ones, as the loader gives a host) from the
    state of ``seed``. Returns the metrics, the student's weights and
    gradients."""
    from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state
    from dkt_stereo_tpu_torch.train.ns_step import make_ns_train_step
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    hyper = DKTHyperParams(**hyper)
    state = create_dkt_state(config, hyper, seed=seed, device="cpu")
    local = _rank_rows(blocks[rank], 0, 1)
    state, metrics = make_ns_train_step(config, hyper, nb=nb, nt=nt)(state, local)
    grads = {k: p.grad.numpy().copy() for k, p in state.student.named_parameters()
             if p.grad is not None}
    return metrics, _np(state.student.state_dict()), grads


def loss_job(rank, seq, ns):
    """``sequence_loss_raft`` and ``ns_loss`` on this rank's rows (the
    second axis of the predictions, the first of the rest): each rank's
    share of the global masked means."""
    from dkt_stereo_tpu_torch.losses.nerf import ns_loss
    from dkt_stereo_tpu_torch.losses.sequence import sequence_loss_raft
    from dkt_stereo_tpu_torch.parallel.mesh import rank_and_size

    _, size = rank_and_size()

    def rows(a, axis=0):
        return torch.from_numpy(a).chunk(size, dim=axis)[rank]

    loss, metrics, _, ok = sequence_loss_raft(rows(seq["preds"], 1), rows(seq["flow"]),
                                              rows(seq["valid"]))
    ns_l, ns_m, _, ns_ok = ns_loss(rows(ns["preds"], 1), rows(ns["target"]), rows(ns["conf"]),
                                   rows(ns["im0"]), rows(ns["im1"]), rows(ns["im2"]))
    return ({"loss": float(loss), **{k: float(v) for k, v in metrics.items()}, "ok": bool(ok)},
            {"loss": float(ns_l), **{k: float(v) for k, v in ns_m.items()}, "ok": bool(ns_ok)})


def cli_train_job(rank, argv):
    """``cli.train.main(argv + --process_id rank, device="cpu")``, which
    joins its own process group; returns its result and the student's
    final weights."""
    from dkt_stereo_tpu_torch.cli import train as cli
    from dkt_stereo_tpu_torch.utils import logging as port_logging

    port_logging.make_writer = port_logging._JsonlWriter
    seen = {}
    make = cli.make_dkt_train_step

    def recording(config, hyper):
        step = make(config, hyper)

        def step_fn(state, batch, **kw):
            seen["state"] = state
            return step(state, batch, **kw)

        return step_fn

    cli.make_dkt_train_step = recording
    out = cli.main(argv + ["--process_id", str(rank)], device="cpu")
    return out["checkpoint"], _np(seen["state"].student.state_dict())
