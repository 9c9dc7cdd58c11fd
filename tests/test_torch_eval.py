"""The port's evaluation side against the JAX package, on the CPU: the PNG
codec (``data/png.py``) against PIL and OpenCV, the readers, metrics and
the five benchmark validators against the JAX ones, the eval and demo CLIs
against the JAX CLIs on one ``.pth``, and the refusals of what is not
ported.

Fixtures are the JAX package's own eval-test trees (``tests/test_eval.py``)
plus a small Scene Flow TEST tree. The slice runs RAFT ``base.json`` at 2
iterations, fp32 (the eval protocol), through one JAX compile that the eval
and demo CLIs share.
"""

import functools
import io
import json
import os
import struct
import sys
import zlib
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dkt_stereo_tpu.data import readers as jreaders
from dkt_stereo_tpu.eval import metrics as jmetrics
from dkt_stereo_tpu.eval import validate as jvalidate
from dkt_stereo_tpu.utils.visualization import disp_to_color as jdisp_to_color
from dkt_stereo_tpu_torch.data import png, readers
from dkt_stereo_tpu_torch.data.datasets import KITTI, SceneFlowDatasets
from dkt_stereo_tpu_torch.eval import metrics
from dkt_stereo_tpu_torch.eval import validate as validate
from dkt_stereo_tpu_torch.utils.visualization import disp_to_color
from tests.test_eval import _make_booster, _make_eth3d, _make_kitti, _make_middlebury

ROOT = Path(__file__).resolve().parents[1]

# --- data/png.py --------------------------------------------------------------------


def _smooth(rng, H=37, W=53):
    """A gradient with noise in one channel, so that adaptive filtering picks
    every filter type."""
    yy, xx = np.mgrid[:H, :W]
    base = ((xx * 3 + yy * 5) % 256).astype(np.uint8)
    noise = rng.integers(0, 256, (H, W), dtype=np.uint8)
    rgb = np.stack([base, (base.astype(np.int32) * 2 % 256).astype(np.uint8), noise], -1)
    alpha = ((xx + 2 * yy) % 256).astype(np.uint8)
    return base, rgb, np.concatenate([rgb, alpha[..., None]], -1)


def _filter_types(data: bytes) -> set:
    raw = b"".join(body for kind, body in png._chunks(data) if kind == b"IDAT")
    ihdr = next(body for kind, body in png._chunks(data) if kind == b"IHDR")
    width, height, depth, ctype = struct.unpack(">IIBB", ihdr[:10])
    row = (width * png._CHANNELS[ctype] * depth + 7) // 8 + 1
    return set(np.frombuffer(zlib.decompress(raw), np.uint8)[::row][:height].tolist())


def _pil_png(arr, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG", **kw)
    return buf.getvalue()


def test_png_decodes_what_pil_and_cv2_decode(rng):
    """8-bit gray, gray + alpha, RGB and RGBA written by PIL (with and
    without ``optimize``), 16-bit gray and 8-bit RGB written by OpenCV at
    compression levels 0, 1 and 9, and palette images at 8 and 4 bits:
    decoded bit for bit as PIL (``convert("RGB")`` for palettes) and
    ``cv2.imdecode(IMREAD_UNCHANGED)`` decode them; every filter type 0-4
    occurs among these files."""
    base, rgb, rgba = _smooth(rng)
    seen = set()
    for mode, arr in (("L", base), ("LA", rgba[..., [0, 3]]), ("RGB", rgb), ("RGBA", rgba)):
        for optimize in (False, True):
            data = _pil_png(arr, mode, optimize=optimize)
            seen |= _filter_types(data)
            got = png.decode(data)
            want = np.array(Image.open(io.BytesIO(data)))
            assert got.dtype == want.dtype and np.array_equal(got, want), (mode, optimize)
    yy, xx = np.mgrid[:37, :53]
    d16 = ((xx * 977 + yy * 1031) % 65536).astype(np.uint16)
    for level in (0, 1, 9):
        for arr in (d16, rgb[..., ::-1].copy()):
            ok, enc = cv2.imencode(".png", arr, [cv2.IMWRITE_PNG_COMPRESSION, level])
            assert ok
            seen |= _filter_types(enc.tobytes())
            got, want = png.decode(enc.tobytes()), cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
            if want.ndim == 3:
                want = want[..., ::-1]
            assert got.dtype == want.dtype and np.array_equal(got, want), (arr.dtype, level)
    quant = Image.fromarray(rgb).quantize(colors=16)
    for bits in (8, 4):
        buf = io.BytesIO()
        quant.save(buf, "PNG", bits=bits)
        seen |= _filter_types(buf.getvalue())
        want = np.array(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        assert np.array_equal(png.decode(buf.getvalue()), want), bits
    assert seen == {0, 1, 2, 3, 4}


def test_png_round_trips_and_refuses(tmp_path, rng):
    """What :func:`png.encode` writes decodes to the same array, with PIL
    too; interlaced files and a 1-bit gray file raise, naming the cause."""
    base, rgb, rgba = _smooth(rng)
    d16 = rng.integers(0, 65536, (7, 9)).astype(np.uint16)
    for arr in (base, rgb, rgba, d16):
        png.write(tmp_path / "x.png", arr)
        got = png.read(tmp_path / "x.png")
        assert got.dtype == arr.dtype and np.array_equal(got, arr)
        pil = np.array(Image.open(tmp_path / "x.png"))
        assert np.array_equal(pil.astype(arr.dtype), arr)
    assert np.array_equal(cv2.imread(str(tmp_path / "x.png"), cv2.IMREAD_UNCHANGED), d16)
    data = bytearray(png.encode(rgb))
    data[28] = 1  # IHDR's interlace byte, then its CRC
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="interlaced"):
        png.decode(bytes(data))
    with pytest.raises(ValueError, match="bit depth 1"):
        png.decode(_pil_png(base > 128, "1"))
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data[:40]) + b"\0" + bytes(data[41:]))


# --- readers ------------------------------------------------------------------------


def test_readers_match_jax_readers(tmp_path, rng):
    """Every ported reader returns the JAX reader's arrays bit for bit on the
    same files: PFM (gray and colour), .flo, KITTI's 16-bit disparity,
    Middlebury's GT and estimate, Booster's .npy, ``read_gen`` on each
    extension (the JAX one's PIL image as an array) and ``read_image_rgb``
    on RGB, gray and RGBA files; :func:`readers.luma` equals PIL's
    ``convert("L")`` on an RGB mask."""
    d = rng.uniform(1, 300, (13, 17)).astype(np.float32)
    readers.writePFM(str(tmp_path / "disp0GT.pfm"), d)
    jreaders.writePFM(str(tmp_path / "j.pfm"), d)
    assert (tmp_path / "disp0GT.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    color = rng.uniform(-5, 5, (6, 7, 3)).astype(">f4")
    (tmp_path / "c.pfm").write_bytes(b"PF\n7 6\n1.0\n" + np.flipud(color).tobytes())
    flo = rng.standard_normal((5, 8, 2)).astype(np.float32)
    (tmp_path / "f.flo").write_bytes(np.float32(202021.25).tobytes() + np.int32(8).tobytes()
                                     + np.int32(5).tobytes() + flo.tobytes())
    kitti = _make_kitti(tmp_path, rng, n=1)
    disp_png = f"{kitti}/KITTI_2015/training/disp_occ_0/000000_10.png"
    nocc = (rng.uniform(0, 1, (13, 17)) > 0.3).astype(np.uint8) * 255
    Image.fromarray(nocc).save(tmp_path / "mask0nocc.png")
    d2 = d.copy()
    d2[0, 0] = np.inf
    readers.writePFM(str(tmp_path / "disp0.pfm"), d2)
    np.save(tmp_path / "disp_00.npy", rng.uniform(-10, 600, (9, 11)).astype(np.float32))
    _, rgb, rgba = _smooth(rng)
    Image.fromarray(rgb).save(tmp_path / "rgb.png")
    Image.fromarray(rgba).save(tmp_path / "rgba.png")
    Image.fromarray(rgb[..., 0]).save(tmp_path / "gray.png")

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)

    pairs = [
        (readers.readPFM, jreaders.readPFM, tmp_path / "disp0GT.pfm"),
        (readers.readPFM, jreaders.readPFM, tmp_path / "c.pfm"),
        (readers.readFlow, jreaders.readFlow, tmp_path / "f.flo"),
        (readers.readDispKITTI, jreaders.readDispKITTI, disp_png),
        (readers.readDispMiddlebury, jreaders.readDispMiddlebury, tmp_path / "disp0GT.pfm"),
        (readers.readDispMiddlebury, jreaders.readDispMiddlebury, tmp_path / "disp0.pfm"),
        (readers.readDispBooster, jreaders.readDispBooster, tmp_path / "disp_00.npy"),
    ] + [(readers.read_gen, jreaders.read_gen, tmp_path / f)
         for f in ("rgb.png", "rgba.png", "gray.png", "disp_00.npy", "f.flo", "c.pfm",
                   "disp0GT.pfm")] + [
        (readers.read_gen, jreaders.read_gen, disp_png),
    ] + [(readers.read_image_rgb, jreaders.read_image_rgb, tmp_path / f)
         for f in ("rgb.png", "rgba.png", "gray.png")]
    for ours, theirs, path in pairs:
        a, b = ours(str(path)), theirs(str(path))
        if isinstance(b, tuple):
            assert len(a) == len(b) and all(same(x, y) for x, y in zip(a, b)), (ours, path)
        else:
            assert same(a, b), (ours.__name__, path)
    assert readers.read_gen(str(tmp_path / "x.txt")) == []
    mask = rng.integers(0, 256, (11, 13, 3), dtype=np.uint8)
    mask[::3, ::2] = 255
    Image.fromarray(mask).save(tmp_path / "mask_rgb.png")
    want = np.array(Image.open(tmp_path / "mask_rgb.png").convert("L"))
    assert same(readers.luma(readers.read_gen(str(tmp_path / "mask_rgb.png"))), want)
    assert same(readers.luma(rgb[..., 0]), rgb[..., 0])


def test_jpeg_needs_pil_and_names_the_file(tmp_path, monkeypatch, rng):
    """JPEG no longer needs PIL: with PIL unimportable the port reads what
    the JAX reader reads through PIL, and a file it cannot decode raises a
    ValueError naming the file (the decoder itself:
    tests/test_torch_jpeg.py)."""
    path = tmp_path / "left.jpg"
    Image.fromarray(_smooth(rng)[1]).save(path)
    want = jreaders.read_image_rgb(str(path))
    (tmp_path / "cut.jpg").write_bytes(path.read_bytes()[:40])
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert np.array_equal(readers.read_image_rgb(str(path)), want)
    with pytest.raises(ValueError, match="cut.jpg"):
        readers.read_gen(str(tmp_path / "cut.jpg"))


# --- metrics ------------------------------------------------------------------------


def test_metrics_match_jax(rng):
    """D1, EPE and the threshold metric (with the <10 % coverage skip) on
    seeded arrays: the JAX package's values exactly."""
    gt = rng.uniform(0, 60, (3, 16, 20)).astype(np.float32)
    est = gt + rng.normal(0, 3, gt.shape).astype(np.float32)
    mask = rng.uniform(0, 1, gt.shape) > 0.3
    mask[1] = False
    mask[1, 0, :10] = True  # under 10 % covered: skipped
    for ours, theirs, extra in ((metrics.D1_metric, jmetrics.D1_metric, ()),
                                (metrics.EPE_metric, jmetrics.EPE_metric, ()),
                                (metrics.Thres_metric, jmetrics.Thres_metric, (2.0,))):
        assert ours(est, gt, mask, *extra) == theirs(est, gt, mask, *extra)


# --- the validators ------------------------------------------------------------------


def _port_forward(x1, x2):
    """A deterministic forward of the padded input, exact in fp32 in both
    frameworks: it depends on the padded column, so a wrong unpad shows."""
    col = torch.arange(x1.shape[2], dtype=torch.float32)
    return -(x1[..., 0] * 0.125 + x2[..., 1] * 0.0625 + col * 0.25 + 2.0)


_port_forward.device = torch.device("cpu")


def _jax_forward(x1, x2):
    col = jnp.arange(x1.shape[2], dtype=jnp.float32)
    return -(x1[..., 0] * 0.125 + x2[..., 1] * 0.0625 + col * 0.25 + 2.0)


def _make_things(tmp_path, rng, n=3):
    """A FlyingThings3D TEST tree of ``n`` frames; the last has disparity
    300 everywhere, so every pixel is masked (> maxdisp) and the frame is
    skipped as NaN."""
    root = tmp_path / "sceneflow" / "FlyingThings3D"
    H, W = 40, 72
    for i in range(n):
        scene = root / "frames_finalpass" / "TEST" / "A" / f"{i:04d}"
        gt = root / "disparity" / "TEST" / "A" / f"{i:04d}" / "left"
        for side in ("left", "right"):
            os.makedirs(scene / side)
            Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(
                scene / side / "0006.png")
        os.makedirs(gt)
        disp = rng.uniform(1, 120, (H, W)).astype(np.float32) if i < n - 1 else \
            np.full((H, W), 300.0, np.float32)
        jreaders.writePFM(str(gt / "0006.pfm"), disp)
    return str(tmp_path / "sceneflow")


def test_five_validators_match_jax(tmp_path, rng):
    """ETH3D, KITTI 2015 (52 frames, so the FPS key of the frames after the
    51st exists), Middlebury-H, Booster-Q and Things TEST (with a frame that
    the NaN skip drops): the same forward in both packages gives the same
    keys and values within 1e-6 relative; every dataset name resolves
    through ``run_validator`` and passes ``preflight``."""
    roots = {"eth3d": _make_eth3d(tmp_path, rng), "kitti-2015": _make_kitti(tmp_path, rng, n=52),
             "middlebury-H": _make_middlebury(tmp_path, rng),
             "booster-Q": _make_booster(tmp_path, rng), "things": _make_things(tmp_path, rng)}
    validate.preflight(list(roots), str(tmp_path))
    assert len(SceneFlowDatasets(None, root=roots["things"], dstype="frames_finalpass",
                                 things_test=True)) == 3
    for name in roots:
        ours = validate.run_validator(name, _port_forward, str(tmp_path))
        theirs = jvalidate.run_validator(name, _jax_forward, str(tmp_path))
        assert set(ours) == set(theirs), name
        for key, want in theirs.items():
            if key.endswith("-fps"):
                assert ours[key] > 0
                continue
            assert np.isfinite(want), (key, want)
            np.testing.assert_allclose(ours[key], want, rtol=1e-6, atol=0, err_msg=key)
    kitti = validate.validate_kitti(_port_forward, "2015", roots["kitti-2015"])
    assert "kitti-2015-fps" in kitti
    with pytest.raises(FileNotFoundError, match="no frames"):
        validate.preflight(["eth3d"], str(tmp_path / "empty"))


# --- the slice: the eval and demo CLIs ------------------------------------------------


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A 3-frame KITTI tree, RAFT base.json with ``mixed_precision`` off (the
    eval protocol, and one JAX compile for both CLIs), and the port's seeded
    random weights saved with ``torch.save``."""
    from dkt_stereo_tpu_torch.models.registry import create_model

    tmp = tmp_path_factory.mktemp("cli")
    _make_kitti(tmp, np.random.default_rng(7), n=3)
    config = {**json.loads((ROOT / "configs/raft_stereo/base.json").read_text()),
              "mixed_precision": False}
    cfg_path = tmp / "base_fp32.json"
    cfg_path.write_text(json.dumps(config))
    model = create_model(config, iters=2, device="cpu", seed=0)
    ckpt = tmp / "raft_seed0.pth"
    torch.save(model.state_dict(), ckpt)
    return tmp, cfg_path, ckpt


def _capture(monkeypatch, module):
    """Record the forward that ``module.run_validator`` is handed."""
    seen, original = [], module.run_validator

    def run_validator(name, forward, *args, **kw):
        seen.append(forward)
        return original(name, forward, *args, **kw)

    monkeypatch.setattr(module, "run_validator", run_validator)
    return seen


def test_eval_and_demo_cli_match_jax(cli_setup, monkeypatch):
    """``cli.eval.main(..., device="cpu")`` against ``dkt_stereo_tpu.cli.eval``
    on the KITTI tree, RAFT base.json, 2 iterations, the same ``.pth``: EPE
    within 2.5e-3 px (the unfused slice's bound, tests/test_torch_raft.py),
    D1 within the share of valid pixels whose JAX error lies within 2.5e-3
    px of the 3 px threshold. Then ``cli.demo`` on two pairs of the tree in
    both packages: the ``.npy`` files within the same bound, the PNG the
    port's ``disp_to_color`` of its ``.npy``, bit-equal to JAX's
    ``disp_to_color`` of the same array, and the PLY's vertices the pixels
    with a nonzero disparity."""
    from dkt_stereo_tpu.cli.demo import main as jdemo
    from dkt_stereo_tpu.cli.eval import main as jeval
    from dkt_stereo_tpu_torch.cli.demo import main as demo
    from dkt_stereo_tpu_torch.cli.eval import main as port_eval

    tmp, cfg, ckpt = cli_setup
    args = ["--config", str(cfg), "--restore_ckpt", str(ckpt), "--valid_iters", "2",
            "--datasets", "kitti-2015", "--data_root", str(tmp)]
    port_fwd, jax_fwd = _capture(monkeypatch, validate), _capture(monkeypatch, jvalidate)
    ours = port_eval(args, device="cpu")
    theirs = jeval(args)
    assert set(ours) == set(theirs) == {"kitti-2015-epe", "kitti-2015-d1"}
    assert abs(ours["kitti-2015-epe"] - theirs["kitti-2015-epe"]) <= 2.5e-3
    # the D1 bound: pixels whose JAX error is within 2.5e-3 of 3 px
    ds = KITTI(None, root=str(tmp / "KITTI"), split="2015")
    near = total = 0
    for i in range(len(ds)):
        img1, img2, flow_gt, valid_gt = ds.get_sample(i)
        pred, _ = jvalidate._run_one(jax_fwd[0], img1, img2, 32)
        val = (valid_gt >= 0.5) & (flow_gt > -192) & (flow_gt < 0)
        err = np.abs(pred - flow_gt)[val]
        near += int((np.abs(err - 3.0) <= 2.5e-3).sum())
        total += err.size
    assert abs(ours["kitti-2015-d1"] - theirs["kitti-2015-d1"]) <= 100 * near / total + 1e-9
    assert len(port_fwd) == 1

    left = str(tmp / "KITTI/KITTI_2015/training/image_2/00000[01]_10.png")
    right = left.replace("image_2", "image_3")
    demo_args = ["--config", str(cfg), "--restore_ckpt", str(ckpt), "--valid_iters", "2",
                 "-l", left, "-r", right, "--save_numpy"]
    written = demo(demo_args + ["-o", str(tmp / "port"), "--save_ply"], device="cpu")
    jdemo(demo_args + ["-o", str(tmp / "jax")])
    assert [p.name for p in written] == ["000000_10.png", "000001_10.png"]
    for p in written:
        ours_d = np.load(p.with_suffix(".npy"))
        theirs_d = np.load(tmp / "jax" / (p.stem + ".npy"))
        assert ours_d.shape == theirs_d.shape == (60, 100)
        assert float(np.abs(ours_d - theirs_d).max()) <= 2.5e-3
        rgb, _ = disp_to_color(ours_d)
        jrgb, _ = jdisp_to_color(ours_d)
        assert np.array_equal(rgb, jrgb)
        assert np.array_equal(png.read(p), rgb[0].transpose(1, 2, 0).astype(np.uint8))
        header = p.with_suffix(".ply").read_text().split("end_header")[0]
        assert f"element vertex {int((np.abs(ours_d) > 0).sum())}" in header


def test_cli_refusals(cli_setup, tmp_path, monkeypatch):
    """What the slice does not port raises and names where it comes: a
    checkpoint path that is neither a ``.pth`` nor a port checkpoint,
    NeRF-Stereo's dataset without its file list (as the JAX package's);
    ``--spatial_bands 2`` runs (two ranks, EPE within 1e-4 px of the
    unbanded eval's). The
    training datasets the training side ported build: augmented samples
    and Scene Flow's training splits."""
    from dkt_stereo_tpu_torch.cli.eval import main as port_eval
    from dkt_stereo_tpu_torch.data.datasets import fetch_dataset
    from dkt_stereo_tpu_torch.parallel import mesh

    tmp, cfg, ckpt = cli_setup
    base = ["--config", str(cfg), "--valid_iters", "2", "--datasets", "kitti-2015",
            "--data_root", str(tmp)]
    with pytest.raises(FileNotFoundError, match="neither a port checkpoint"):
        port_eval(base + ["--restore_ckpt", str(tmp / "step_3")], device="cpu")
    # --spatial_bands 2: two ranks over gloo on the CPU (this 60 x 100 frame
    # is too small to band at the default halo, so each rank runs it whole
    # under the cross-band statistics), against the unbanded eval
    monkeypatch.setattr(mesh, "run_ranks", functools.partial(mesh.run_ranks, timeout=120))
    banded = port_eval(base + ["--restore_ckpt", str(ckpt), "--spatial_bands", "2"],
                       device="cpu")
    unbanded = port_eval(base + ["--restore_ckpt", str(ckpt)], device="cpu")
    assert set(banded) == set(unbanded) == {"kitti-2015-epe", "kitti-2015-d1"}
    assert abs(banded["kitti-2015-epe"] - unbanded["kitti-2015-epe"]) <= 1e-4
    with pytest.raises(FileNotFoundError, match="trainingQ.txt"):
        fetch_dataset(["nerf_stereo"], (32, 64), data_root=str(tmp))
    kitti = KITTI({"crop_size": (32, 64)}, root=str(tmp / "KITTI"), split="2015")
    assert kitti.get_sample(0, np.random.default_rng(0))["img1"].shape == (32, 64, 3)
    assert len(SceneFlowDatasets(None, root=str(tmp_path))) == 0


def test_entry_points_want_the_gpu(cli_setup):
    """Without ``device="cpu"`` the eval and demo CLIs and the bench want a
    CUDA device and raise when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from dkt_stereo_tpu_torch import bench
    from dkt_stereo_tpu_torch.cli.demo import main as demo
    from dkt_stereo_tpu_torch.cli.eval import main as port_eval

    tmp, cfg, ckpt = cli_setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval(["--config", str(cfg), "--restore_ckpt", str(ckpt), "--datasets",
                   "kitti-2015", "--data_root", str(tmp)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo(["--config", str(cfg), "--restore_ckpt", str(ckpt), "-l", "x", "-r", "y"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
