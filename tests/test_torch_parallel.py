"""The port's multi-process layer against the JAX package, on the CPU, with
ranks over gloo (``parallel/mesh.py::run_ranks``; what each rank runs is in
``tests/torch_rank_jobs.py``): the cross-replica batch statistics, the
cross-band instance-norm statistics and halo exchange against JAX under
``shard_map`` on the virtual CPU mesh, the three banded evaluations
(``eval/tiled.py``), the loaders' host sharding, the global masked means of
the losses, the data-parallel DKT and NS steps against the one-process step
on the global batch, and ``cli.train`` as two processes.

Every group of ranks has its own timeout (``TIMEOUT``), so that a hung
collective fails its test rather than the suite.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from dkt_stereo_tpu.data import loader as jloader
from dkt_stereo_tpu.data import triplet as jtriplet
from dkt_stereo_tpu.eval.tiled import banded_forward as jbanded_forward
from dkt_stereo_tpu.losses.nerf import ns_loss as jns_loss
from dkt_stereo_tpu.losses.sequence import sequence_loss_raft as jsequence_loss
from dkt_stereo_tpu.nn.norms import InstanceNorm as JInstanceNorm
from dkt_stereo_tpu.nn.norms import band_refresh as jband_refresh
from dkt_stereo_tpu.nn.norms import cross_band_stats as jcross_band_stats
from dkt_stereo_tpu.parallel import make_mesh as jmake_mesh
from dkt_stereo_tpu.parallel.mesh import cross_replica_batch_stats as jstats
from dkt_stereo_tpu_torch.data.loader import MixedStereoLoader, StereoLoader
from dkt_stereo_tpu_torch.eval.tiled import banded_forward, banded_forward_exact
from dkt_stereo_tpu_torch.eval.validate import make_forward_fn
from dkt_stereo_tpu_torch.losses.nerf import ns_loss
from dkt_stereo_tpu_torch.losses.sequence import sequence_loss_raft
from dkt_stereo_tpu_torch.models.registry import create_model
from dkt_stereo_tpu_torch.parallel.mesh import make_mesh, run_ranks
from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
from dkt_stereo_tpu_torch.train.ns_step import make_ns_train_step
from dkt_stereo_tpu_torch.train.state import DKTHyperParams
from tests import torch_rank_jobs as jobs

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120  # seconds a group of ranks may take


def _ranks(job, *args, n=2, backend="gloo"):
    return run_ranks(job, n, *args, backend=backend, timeout=TIMEOUT, threads=1)


# --- collectives: batch statistics, band statistics, halo exchange -----------------------


BAND = dict(fh=384, W=16, C=8, halo=64, band_h=192)


@pytest.fixture(scope="module")
def collective_runs():
    """One group of two ranks: the batch statistics, the band statistics
    and halo exchange, and ``banded_forward_mesh``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    b = BAND
    th = b["band_h"] + 2 * b["halo"]
    frame = rng.standard_normal((b["fh"], b["W"], b["C"])).astype(np.float32)
    win0 = [int(np.clip(k * b["band_h"] - b["halo"], 0, b["fh"] - th)) for k in range(2)]
    clean = np.stack([frame[w:w + th] for w in win0])
    # the halo rows that the exchange replaces, as a band's own convolutions
    # would leave them: band 0's bottom, band 1's top
    bands = clean.copy()
    bands[0, th - b["halo"]:] += 100.0
    bands[1, :b["halo"]] += 100.0
    img1 = rng.uniform(0, 255, (100, 24, 3)).astype(np.float32)
    img2 = rng.uniform(0, 255, (100, 24, 3)).astype(np.float32)
    out = _ranks(jobs.jobs, [("stats_job", (x,)),
                             ("band_job", (bands, th, b["halo"], b["band_h"], b["fh"])),
                             ("mesh_job", (img1, img2, 8))])
    return dict(x=x, frame=frame, bands=bands, clean=clean, win0=win0, th=th, img1=img1,
                img2=img2,
                stats=[r[0] for r in out], band=[r[1] for r in out], mesh=[r[2] for r in out])


def test_cross_replica_batch_stats_matches_jax(collective_runs):
    """Two ranks of 4 rows each against the JAX function under
    ``shard_map`` on the 8-device mesh (a row a device): both give the
    mean and biased variance of all 8 x 64 values; every rank the same."""
    x = collective_runs["x"]

    def f(x_local):
        g_mean, g_var = jstats(x_local.mean(), x_local.var(), "data")
        return jnp.stack([g_mean, g_var])[None]

    want = np.asarray(shard_map(f, mesh=jmake_mesh(8), in_specs=P("data"),
                                out_specs=P("data"))(x))[0]
    ranks = collective_runs["stats"]
    assert ranks[0] == ranks[1]
    np.testing.assert_allclose(ranks[0], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ranks[0], [x.mean(), x.var()], rtol=0, atol=1e-5)


def test_band_stats_and_refresh_match_jax(collective_runs):
    """``InstanceNorm`` under ``cross_band_stats`` and ``band_refresh`` of
    NCHW features and of NHWC ones (the coordinates' layout), two bands of
    a 384-row frame (band 192 rows, halo 64) whose replaced halo rows hold
    garbage, against JAX's under ``shard_map``: the whole band windows
    within 5e-5 (normalized values; the interiors also against the whole
    frame's statistics) and bit for bit (the exchanged rows, which are the
    frame's own again)."""
    b, th, bands = BAND, collective_runs["th"], collective_runs["bands"]
    mesh = jmake_mesh(2)

    def run(fn):
        f = shard_map(lambda xb: fn(xb), mesh=mesh, in_specs=(P("data"),),
                      out_specs=P("data"), check_rep=False)
        with jcross_band_stats("data", th, b["halo"], b["band_h"], b["fh"], 2):
            return np.asarray(jax.jit(f)(jnp.asarray(bands)))

    want_norm = run(lambda xb: JInstanceNorm().apply({}, xb))
    want_refresh = run(jband_refresh)
    for k, (normed, refreshed, refreshed_nhwc) in enumerate(collective_runs["band"]):
        np.testing.assert_allclose(normed, want_norm[k], rtol=0, atol=5e-5)
        np.testing.assert_array_equal(refreshed, want_refresh[k])
        np.testing.assert_array_equal(refreshed_nhwc, want_refresh[k])
        np.testing.assert_array_equal(refreshed, collective_runs["clean"][k])
        frame = collective_runs["frame"]
        full = (frame - frame.mean((0, 1))) / np.sqrt(frame.var((0, 1)) + 1e-5)
        off = k * b["band_h"] - collective_runs["win0"][k]
        np.testing.assert_allclose(normed[off:off + b["band_h"]],
                                   full[k * b["band_h"]:(k + 1) * b["band_h"]], atol=5e-5)


def test_banded_forward_mesh_rowlocal(collective_runs):
    """``banded_forward_mesh`` over two ranks (100 rows: bands of 50, halo 8,
    the frame edge-padded to fit) of a forward whose receptive field is one
    pixel equals the whole frame's forward, on both ranks."""
    img1, img2 = collective_runs["img1"], collective_runs["img2"]
    full = jobs._rowlocal(torch.from_numpy(img1), torch.from_numpy(img2)).numpy()
    for got in collective_runs["mesh"]:
        assert got.shape == full.shape
        np.testing.assert_allclose(got, full, rtol=0, atol=1e-5)


# --- banded evaluation ------------------------------------------------------------------


def _torch_rowlocal(a, b):
    return jobs._rowlocal(a, b)


_torch_rowlocal.device = torch.device("cpu")


@pytest.mark.parametrize("model", ["rowlocal", "raft_1gru"])
def test_banded_forward_matches_jax(model, rng):
    """The sequential bands (``banded_forward``) against JAX's
    ``banded_forward`` (``tests/test_parallel.py:77-95``): on a forward
    whose receptive field is one pixel, written in each package (3 bands of
    a 96-row frame, halo 8; within 1e-5, and equal to the whole frame's),
    and on the port's 1-layer RAFT (2 iterations, seeded weights) driven by
    each package's band geometry (2 bands, halo 16; bit for bit: the same
    bands, padded alike, through the same forward)."""
    H, W = 96, 64
    img1 = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    img2 = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    if model == "rowlocal":
        got = banded_forward(_torch_rowlocal, img1, img2, n_bands=3, halo=8)
        want = jbanded_forward(lambda a, b: -(a.mean(-1) * 0.01 + b.mean(-1) * 0.02),
                               img1, img2, n_bands=3, halo=8)
        full = jobs._rowlocal(torch.from_numpy(img1), torch.from_numpy(img2)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, full, rtol=0, atol=1e-5)
        return
    fwd = make_forward_fn(create_model(jobs.RAFT_1GRU, iters=2, device="cpu", seed=0), "cpu")

    def jax_fwd(a, b):
        # JAX's padded band in the memory layout of the port's pad_input (an
        # NHWC view of NCHW storage), so that the convolutions take the same
        # path and the two results can be compared bit for bit
        def t(x):
            return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).contiguous(
                ).permute(0, 2, 3, 1)
        return fwd(t(a), t(b)).numpy()

    got = banded_forward(fwd, img1, img2, n_bands=2, halo=16)
    assert got.shape == (H, W)
    np.testing.assert_array_equal(got, jbanded_forward(jax_fwd, img1, img2, n_bands=2, halo=16))
    # one band is the unbanded eval's padded frame
    one = banded_forward(fwd, img1, img2, n_bands=1, halo=16)
    np.testing.assert_array_equal(one, jbanded_forward(jax_fwd, img1, img2, n_bands=1))


# the cases of tests/test_parallel.py:114-160, 236-330 at JAX's 640 x 64
# geometry, on the port's seeded weights
EXACT = {
    # 1 GRU layer, instance-norm context, halo 64: max 5e-3, mean 5e-4
    "raft_1gru": dict(config=jobs.RAFT_1GRU, iters=2, seed=0, halo=64),
    # the shipped base.json (3 GRU layers, batch-norm context), halo 128, the
    # flow head damped by 0.02 as in the JAX test: max 1e-3, mean 1e-4
    "raft_base_damped": dict(config=jobs.RAFT_BASE, iters=7, seed=0, halo=128,
                             damp=("flow_head", 0.02)),
    # the same undamped: max / scale 5e-5. At 2 iterations: the port's
    # random init is chaotic past 3 (a 1e-7 relative weight nudge moves the
    # 7-iteration output by 3.9 px of 318)
    "raft_base_raw": dict(config=jobs.RAFT_BASE, iters=2, seed=0, halo=128),
    # IGEV (max_disp 32), 2 iterations, halo 64, its disparity head's last
    # conv scaled by 0.05 as in the port's other IGEV checks: approximate
    # (the 3-D hourglass exchanges no halo), max < 0.02 scale + 1 px
    "igev": dict(config=jobs.IGEV, iters=2, seed=0, halo=64,
                 damp=("update_block.disp_head.conv2.weight", 0.05)),
}


@pytest.fixture(scope="module")
def exact_runs():
    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 255, (640, 64, 3)).astype(np.float32)
    img2 = rng.uniform(0, 255, (640, 64, 3)).astype(np.float32)
    out = _ranks(jobs.exact_job, list(EXACT.values()), img1, img2)
    return {name: ([r[0][i] for r in out], out[i % 2][1][i]) for i, name in enumerate(EXACT)}


@pytest.mark.parametrize("case", list(EXACT))
def test_banded_forward_exact_matches_unbanded(case, exact_runs):
    """``banded_forward_exact`` on two gloo ranks (one band each, the
    cross-band statistics and halo exchange) against the port's unbanded
    forward of the same padded frame, with JAX's bounds for each case
    (``EXACT``); both ranks assemble the same frame. IGEV's error is the
    band boundary's: at the frame's edges it has decayed (JAX's rule)."""
    (got0, got1), full = exact_runs[case]
    np.testing.assert_array_equal(got0, got1)
    assert got0.shape == full.shape == (640, 64)
    err, scale = np.abs(got0 - full), np.abs(full).max()
    if case == "raft_1gru":
        assert err.max() < 5e-3 and err.mean() < 5e-4, (err.max(), err.mean())
    elif case == "raft_base_damped":
        assert err.max() < 1e-3 and err.mean() < 1e-4, (err.max(), err.mean())
    elif case == "raft_base_raw":
        assert err.max() / max(scale, 1.0) < 5e-5, (err.max(), scale)
    else:
        assert err.max() < 0.02 * scale + 1.0, (err.max(), scale)
        mid = err[320 - 4:320 + 4].max()
        assert err[:32].max() < max(0.8, 0.3 * mid) and err[-32:].max() < max(0.8, 0.3 * mid)


@pytest.mark.parametrize("kw,match", [({"divide_factor": 16}, "divide_factor % 32"),
                                      ({"halo": 48}, "multiple of 32"),
                                      ({"pallas_encoder": True}, "pallas_encoder=False")])
def test_banded_forward_exact_refuses_misaligned_geometry(kw, match):
    """JAX's asserts, as errors raised before any collective: a
    16-divisible ``divide_factor`` or a halo off the 32-row grid would
    misalign the windows with the 1/32-scale statistics, and the fused
    encoder computes its instance norm inside its kernel."""
    config = {**jobs.RAFT_1GRU, "pallas_encoder": kw.pop("pallas_encoder", False)}
    model = create_model(config, iters=1, device="cpu", seed=0)
    img = np.zeros((64, 64, 3), np.float32)
    with pytest.raises(ValueError, match=match):
        banded_forward_exact(model, img, img, **kw)


def test_make_mesh_refuses_missing_devices():
    """Fewer CUDA devices than ranks raise (JAX's ``make_mesh``); the CPU
    gives every rank the CPU."""
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="CUDA devices are available"):
        make_mesh(torch.cuda.device_count() + 1, "cuda")


# --- the loaders' host sharding ------------------------------------------------------------


class _Bi:
    """A binocular pool whose samples draw from the generator they get."""

    def __init__(self, n, H=6, W=8):
        self.n, self.H, self.W = n, H, W

    def __len__(self):
        return self.n

    def get_sample(self, i, rng=None):
        u = rng.uniform(0, 1, (self.H, self.W)).astype(np.float32)
        z = np.full((self.H, self.W, 3), float(i), np.float32) + u[..., None]
        return {"img1": z, "img2": z + 1, "img1_clean": z, "img2_clean": z + 1,
                "flow": -u, "valid": (u > 0.5).astype(np.float32)}


class _Tri(_Bi):
    def get_sample(self, i, rng=None):
        u = rng.uniform(0, 1, (self.H, self.W)).astype(np.float32)
        z = np.full((self.H, self.W, 3), 100.0 + i, np.float32) + u[..., None]
        return {"im1_forward": z, "im2_forward": z + 1, "flow": -3 * u, "conf": u,
                "im0": z, "im1": z + 1, "im2": z + 2}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("host_id", [0, 1])
def test_loader_host_rows_and_draws_match_jax(host_id):
    """``num_hosts=2``: each host's rows of every batch and their
    augmentation draws (job key ``(seed, epoch, host_id, b)``) equal the
    JAX loader's process mode for that host, over two epochs; the ragged
    tail is dropped whatever ``drop_last`` says; the mixed loader's host
    blocks (nb/2 binocular, nt/2 trinocular rows) equal JAX's."""
    ds = _Bi(11)
    ours = StereoLoader(ds, batch_size=4, num_workers=0, seed=7, num_hosts=2, host_id=host_id)
    theirs = jloader.StereoLoader(ds, 4, num_workers=1, seed=7, num_hosts=2, host_id=host_id)
    assert len(ours) == len(theirs) == 2
    assert len(StereoLoader(ds, 4, num_workers=0, drop_last=False, num_hosts=2,
                            host_id=host_id)) == len(jloader.StereoLoader(
                                ds, 4, drop_last=False, num_hosts=2, host_id=host_id)) == 2
    jloader._proc_init(ds)
    for epoch in (0, 1):
        theirs.epoch = epoch
        idx = theirs._epoch_indices()
        for b, batch in enumerate(ours):
            chunk = idx[b * 4:(b + 1) * 4][host_id * 2:(host_id + 1) * 2]
            want = jloader._proc_batch((chunk, (7, epoch, host_id, b)))
            for k in want:
                assert np.array_equal(batch[k].numpy(), want[k]), (epoch, b, k)

    bi, tri = _Bi(10), _Tri(6)
    mixed = MixedStereoLoader(bi, tri, batch_size=4, num_tri=2, num_workers=0, seed=5,
                              num_hosts=2, host_id=host_id)
    jmixed = jloader.MixedStereoLoader(bi, tri, batch_size=4, num_tri=2, num_workers=1, seed=5,
                                       num_hosts=2, host_id=host_id)
    assert (mixed.nb, mixed.nt, len(mixed)) == (jmixed.nb, jmixed.nt, len(jmixed)) == (2, 2, 3)
    view = jloader._MixedView(bi, tri)
    for epoch in (0, 1):
        jmixed.epoch = epoch
        idx = jmixed._epoch_indices()
        assert np.array_equal(mixed.epoch_indices(epoch), idx)
        for b, batch in enumerate(mixed):
            chunk = idx[b * 4:(b + 1) * 4][host_id * 2:(host_id + 1) * 2]
            rng = np.random.default_rng((5, epoch, host_id, b))
            want = jtriplet.collate_mixed([view.get_sample(int(i), rng) for i in chunk])[0]
            got = _numpy(batch)
            assert got["bi"]["flow"].shape[0] == got["tri"]["flow"].shape[0] == 1
            for k in ("im1_forward", "im2_forward"):
                assert np.array_equal(got[k], want[k])
            for part in ("bi", "tri"):
                for k in want[part]:
                    assert np.array_equal(got[part][k], want[part][k]), (epoch, b, part, k)
    with pytest.raises(ValueError, match="must divide across 2 hosts"):
        MixedStereoLoader(bi, tri, batch_size=4, num_tri=1, num_workers=0, num_hosts=2)


# --- global masked means and the data-parallel steps ------------------------------------


def _seq_inputs(rng, B=2, N=3, H=24, W=32):
    """Predictions and GT of a global batch of B rows; row 1's valid mask
    is zero on its top half, so the rows' valid counts differ."""
    valid = (rng.uniform(size=(B, H, W)) < 0.7).astype(np.float32)
    valid[1, :H // 2] = 0
    return {"preds": -rng.uniform(0, 40, (N, B, H, W)).astype(np.float32),
            "flow": -rng.uniform(0, 40, (B, H, W)).astype(np.float32), "valid": valid}


def _ns_inputs(rng, B=2, N=3, H=24, W=32):
    conf = rng.uniform(size=(B, H, W)).astype(np.float32)
    conf[1, :H // 2] = 0.1  # fewer confident pixels in row 1
    ims = {k: rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32) for k in ("im0", "im1", "im2")}
    return {"preds": -rng.uniform(0, 8, (N, B, H, W)).astype(np.float32),
            "target": -rng.uniform(0.5, 8, (B, H, W)).astype(np.float32), "conf": conf, **ims}


def test_global_masked_means_match_jax_on_the_global_batch(rng):
    """Each of two ranks' ``sequence_loss_raft`` and ``ns_loss`` on its row
    divides by the global counts: their sums are JAX's losses and metrics
    on the concatenated batch (within 1e-5 relative), which the average of
    the ranks' own means misses by far more (unequal valid counts)."""
    seq, ns = _seq_inputs(rng), _ns_inputs(rng)
    ranks = _ranks(jobs.loss_job, seq, ns)
    jl, jm, _, _ = jsequence_loss(jnp.asarray(seq["preds"]), jnp.asarray(seq["flow"]),
                                  jnp.asarray(seq["valid"]))
    want = {"loss": float(jl), **{k: float(v) for k, v in jm.items()}}
    jnl, jnm, _, _ = jns_loss(*(jnp.asarray(ns[k]) for k in
                                ("preds", "target", "conf", "im0", "im1", "im2")))
    want_ns = {"loss": float(jnl), **{k: float(v) for k, v in jnm.items()}}
    for got, wanted in (({k: ranks[0][0][k] + ranks[1][0][k] for k in want}, want),
                        ({k: ranks[0][1][k] + ranks[1][1][k] for k in want_ns}, want_ns)):
        for k in wanted:
            np.testing.assert_allclose(got[k], wanted[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert all(r[0]["ok"] and r[1]["ok"] for r in ranks)

    def local(fn, arrays, axes):
        return [float(fn(*(torch.from_numpy(a).chunk(2, dim=ax)[r]
                           for a, ax in zip(arrays, axes)))[0]) for r in range(2)]

    naive = np.mean(local(sequence_loss_raft, [seq["preds"], seq["flow"], seq["valid"]],
                          [1, 0, 0]))
    naive_ns = np.mean(local(ns_loss, [ns[k] for k in ("preds", "target", "conf", "im0", "im1",
                                                      "im2")], [1, 0, 0, 0, 0, 0]))
    assert abs(naive - want["loss"]) > 1e-3 * abs(want["loss"])
    assert abs(naive_ns - want_ns["loss"]) > 1e-3 * abs(want_ns["loss"])


TRAIN = {**json.loads((ROOT / "configs/raft_stereo/train.json").read_text()),
         "mixed_precision": False, "corr_dtype": "float32"}
NS_TINY = {**json.loads((ROOT / "configs/raft_stereo/ns.json").read_text()),
           "mixed_precision": False, "corr_dtype": "float32", "corr_levels": 2,
           "corr_radius": 2, "n_gru_layers": 1, "hidden_dims": [16, 16, 16]}
HYPER = dict(train_iters=2, teacher_iters=2, lr=2e-4, num_steps=100)


def _dkt_batch(rng, B=2, H=64, W=128):
    b = {k: rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
         for k in ("img1_clean", "img2_clean")}
    for k in ("img1", "img2"):
        b[k] = np.clip(b[k + "_clean"] * rng.uniform(0.8, 1.2, (B, 1, 1, 1)), 0, 255
                       ).astype(np.float32)
    b["flow"] = -rng.uniform(0, 32, (B, H, W)).astype(np.float32)
    valid = (rng.uniform(size=(B, H, W)) < 0.7).astype(np.float32)
    valid[1, :H // 2] = 0  # rank 1's valid pixels: about half of rank 0's
    b["valid"] = valid
    return b


def _ns_blocks(rng, H=32, W=64):
    """The global NS batch of nb = nt = 2 as two host blocks (a binocular
    row, then a trinocular row), and the same rows in one process's
    layout (both binocular rows, then both trinocular ones)."""
    def img(*s):
        return rng.uniform(0, 255, (*s, H, W, 3)).astype(np.float32)

    fwd1, fwd2 = img(4), img(4)  # rows: bi0, bi1, tri0, tri1
    bi_valid = (rng.uniform(size=(2, H, W)) < 0.8).astype(np.float32)
    bi_valid[1, :H // 2] = 0
    conf = rng.uniform(size=(2, H, W)).astype(np.float32)
    conf[1, H // 2:] = 0.1
    bi = {"flow": -rng.uniform(0, 16, (2, H, W)).astype(np.float32), "valid": bi_valid}
    tri = {"flow": -rng.uniform(0.5, 16, (2, H, W)).astype(np.float32), "conf": conf,
           "im0": img(2), "im1": img(2), "im2": img(2)}
    blocks = [{"im1_forward": fwd1[[r, 2 + r]], "im2_forward": fwd2[[r, 2 + r]],
               "bi": {k: v[r:r + 1] for k, v in bi.items()},
               "tri": {k: v[r:r + 1] for k, v in tri.items()}} for r in range(2)]
    return blocks, {"im1_forward": fwd1, "im2_forward": fwd2, "bi": bi, "tri": tri}


@pytest.fixture(scope="module")
def step_runs():
    """The two-rank DKT step (train.json, fp32, 1 x 64 x 128 a rank, 2 + 2
    iterations) and NS step (a 1-layer 16-wide RAFT, nb = nt = 2), in one
    group; and the one-process steps on the global batches."""
    rng = np.random.default_rng(3)
    batch = _dkt_batch(rng)
    blocks, ns_global = _ns_blocks(rng)
    out = _ranks(jobs.jobs, [("dkt_step_job", (TRAIN, HYPER, batch, 0)),
                             ("ns_step_job", (NS_TINY, HYPER, blocks, 0, 2, 2))])
    hyper = DKTHyperParams(**HYPER)
    state = create_dkt_state(TRAIN, hyper, seed=0, device="cpu")
    state, metrics = make_dkt_train_step(TRAIN, hyper)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        generator=torch.Generator().manual_seed(11))
    one = (metrics, {k: p.grad.clone() for k, p in state.student.named_parameters()})
    ns_state = create_dkt_state(NS_TINY, hyper, seed=0, device="cpu")
    ns_state, ns_metrics = make_ns_train_step(NS_TINY, hyper, nb=2, nt=2)(
        ns_state, jobs._rank_rows(ns_global, 0, 1))
    ns_one = (ns_metrics, {k: p.grad.clone() for k, p in ns_state.student.named_parameters()
                           if p.grad is not None})
    return {"dkt": ([r[0] for r in out], one), "ns": ([r[1] for r in out], ns_one)}


def _grad_rel(got: dict, want: dict) -> dict:
    """Relative L2 error of the gradients by top-level module and over all."""
    err2, norm2 = {}, {}
    for k, w in want.items():
        g = k.split(".")[0]
        err2[g] = err2.get(g, 0.0) + float(((torch.from_numpy(got[k]) - w) ** 2).sum())
        norm2[g] = norm2.get(g, 0.0) + float((w ** 2).sum())
    rel = {g: (err2[g] / norm2[g]) ** 0.5 for g in err2 if norm2[g] > 0}
    rel["all"] = (sum(err2.values()) / sum(norm2.values())) ** 0.5
    return rel


@pytest.mark.parametrize("step", ["dkt", "ns"])
def test_two_rank_step_equals_the_global_batch_step(step, step_runs):
    """Two gloo ranks, each with its rows of the global batch (unequal valid
    counts), against one process's step on the whole batch from the same
    weights: the losses and metrics within 1e-5 relative, ok on both, and
    after the update both ranks' weights equal bit for bit. DKT: the F&E
    draws are the global batch's, each rank's its rows. The (summed,
    clipped) gradients within 5e-3 relative L2 a module and over all: the
    batch of one a rank convolves in another order than the batch of two,
    and RAFT at random weights amplifies that (measured 4.8e-4 over all,
    6.3e-4 for fnet); the ranks' own means averaged would be off by the
    valid counts' ratio (about a third here)."""
    ranks, (metrics, grads) = step_runs[step]
    (m0, w0, g0), (m1, w1, g1) = ranks
    assert m0 == m1 and m0["ok"] == metrics["ok"] == 1.0
    for k, v in metrics.items():
        np.testing.assert_allclose(m0[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert set(w0) == set(w1) and all(np.array_equal(w0[k], w1[k]) for k in w0)
    assert all(np.array_equal(g0[k], g1[k]) for k in g0)
    rel = _grad_rel(g0, grads)
    assert max(rel.values()) < 5e-3, rel


# --- cli.train as two processes ------------------------------------------------------------


def _make_booster(root, rng, scenes=2, H=80, W=144):
    from dkt_stereo_tpu_torch.data import png

    for s in range(scenes):
        d = root / "Booster_dataset" / "quarter" / "train" / "balanced" / f"scene{s}"
        for cam in ("camera_00", "camera_02"):
            (d / cam).mkdir(parents=True)
            png.write(d / cam / "0000.png", rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        np.save(d / "disp_00.npy", rng.uniform(2, 30, (H, W)).astype(np.float32))
    return root


def test_train_cli_two_processes(tmp_path):
    """``cli.train`` with ``--coordinator_address`` (a ``file://`` store),
    ``--num_processes 2`` and each ``--process_id``, on the CPU over gloo:
    2 steps of train.json at a global batch of 2 (one row a rank), a save
    and a validation after the first (rank 0's, between barriers). Both
    ranks end with equal weights that moved; only rank 0 writes the
    checkpoints and the log, and both return the same final checkpoint,
    which holds those weights."""
    data = _make_booster(tmp_path / "data", np.random.default_rng(3))
    save = tmp_path / "run"
    argv = ["--config", str(ROOT / "configs/raft_stereo/train.json"), "--train_datasets",
            "booster", "--data_root", str(data), "--batch_size", "2", "--num_steps", "1",
            "--image_size", "64", "128", "--train_iters", "2", "--valid_iters", "2",
            "--num_workers", "0", "--lr", "1e-5", "--validation_frequency", "2",
            "--save_dir", str(save), "--coordinator_address",
            f"file://{tmp_path / 'store'}", "--num_processes", "2"]
    (c0, w0), (c1, w1) = _ranks(jobs.cli_train_job, argv, backend=None)
    assert c0 == c1 == str(save / "step_2")
    assert all(np.array_equal(w0[k], w1[k]) for k in w0)
    saved = torch.load(save / "step_2" / "dkt_state.pt", map_location="cpu", weights_only=True)
    assert saved["step"] == 2
    assert all(np.array_equal(saved["student"][k].numpy(), w0[k]) for k in w0)
    start = create_model(json.loads((ROOT / "configs/raft_stereo/train.json").read_text()),
                         iters=2, device="cpu", seed=1234, test_mode=False).state_dict()
    assert any(not np.array_equal(start[k].numpy(), w0[k]) for k in w0)
    assert sorted(p.name for p in save.iterdir() if p.name.startswith("step_")) == ["step_2"]
    assert (save / "metrics.jsonl").exists()
