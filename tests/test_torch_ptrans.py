"""GWCNet's ``ptrans`` head and its patch data on the CPU: ``data/ptrans.py``
(numpy, no PIL) bit for bit against the JAX package's PIL ``PTrans`` over
several seeds with every branch taken, each of its image operations bit
for bit against Pillow over random boxes and radii, and the head's
``z_ps`` against the JAX model's from the same weights.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter, ImageOps

from dkt_stereo_tpu.data.ptrans import PTrans as JPTrans
from dkt_stereo_tpu.models import GWCNet as JGWCNet
from dkt_stereo_tpu.models import GWCNetConfig as JConfig
from dkt_stereo_tpu_torch.data import ptrans
from dkt_stereo_tpu_torch.models.gwcnet import GWCNet, GWCNetConfig
from dkt_stereo_tpu_torch.weights import load_reference_pth, state_dict_from_flax
from tests.test_torch_gwcnet import draw_variables

ROOT = Path(__file__).resolve().parents[1]
BASE_GC = json.loads((ROOT / "configs/gwcnet/base_gc.json").read_text())


def _image(rng, H, W):
    return rng.integers(0, 256, (H, W, 3), dtype=np.uint8)


def test_resize_matches_pillow():
    """``resize_bilinear`` is ``Image.resize(size, BILINEAR, box)``: random
    boxes inside images of 5-80 px, up- and downscales (the filter widens
    by the scale), the whole image without a box, an identity."""
    rng = np.random.default_rng(0)
    for t in range(150):
        H, W = (int(v) for v in rng.integers(5, 80, 2))
        img = _image(rng, H, W)
        w, h = int(rng.integers(1, W + 1)), int(rng.integers(1, H + 1))
        x0, y0 = int(rng.integers(0, W - w + 1)), int(rng.integers(0, H - h + 1))
        box = (x0, y0, x0 + w, y0 + h) if t % 5 else None
        size = tuple(int(v) for v in rng.integers(1, 100, 2))
        want = np.array(Image.fromarray(img).resize(size, Image.BILINEAR, box=box))
        assert np.array_equal(ptrans.resize_bilinear(img, size, box), want), (H, W, box, size)
    img = _image(rng, 9, 7)
    assert np.array_equal(ptrans.resize_bilinear(img, (7, 9)), img)


def test_blur_solarize_grayscale_match_pillow():
    """``gaussian_blur`` is ``ImageFilter.GaussianBlur(r)`` (three extended
    box blurs a direction, edges replicated) at PTrans's radii (0.1-2) and
    at radii up to 30 that pass whole images; ``solarize`` and
    ``grayscale_rgb`` are ``ImageOps.solarize`` and ``convert("L")
    .convert("RGB")``."""
    rng = np.random.default_rng(1)
    for t in range(120):
        H, W = (int(v) for v in rng.integers(2, 70, 2))
        img = _image(rng, H, W)
        r = float(rng.random() * 1.9 + 0.1) if t % 3 else float(rng.random() * 30)
        want = np.array(Image.fromarray(img).filter(ImageFilter.GaussianBlur(r)))
        assert np.array_equal(ptrans.gaussian_blur(img, r), want), (H, W, r)
        assert np.array_equal(ptrans.solarize(img), np.array(ImageOps.solarize(Image.fromarray(img))))
        gray = np.array(Image.fromarray(img).convert("L").convert("RGB"))
        assert np.array_equal(ptrans.grayscale_rgb(img), gray)


def test_ptrans_matches_jax_bit_for_bit(monkeypatch):
    """The port's ``PTrans`` and the JAX package's from the same generator
    seed give the same four arrays, bit for bit, over 6 seeds of 6 patches x
    3 views a side; every branch of the view pipeline is taken (blur and
    solarize have p 0.1, the crop's whole-image fallback needs ten refused
    boxes, so it is forced once through ``scale``)."""
    taken = dict.fromkeys(("flip", "jitter", "gray", "blur", "solarize"), 0)
    for name, key in (("hflip", "flip"), ("grayscale_rgb", "gray"), ("gaussian_blur", "blur"),
                      ("solarize", "solarize")):
        def counted(*args, _f=getattr(ptrans, name), _k=key):
            taken[_k] += 1
            return _f(*args)
        monkeypatch.setattr(ptrans, name, counted)
    jitter = ptrans.ColorJitter.__call__

    def jitter_counted(self, img, rng):
        taken["jitter"] += 1
        return jitter(self, img, rng)

    monkeypatch.setattr(ptrans.ColorJitter, "__call__", jitter_counted)
    for seed in range(6):
        r = np.random.default_rng(100 + seed)
        H, W = 96, 160
        img1, img2 = _image(r, H, W), _image(r, H, W)
        disp = r.uniform(0, 40, (H, W)).astype(np.float32)
        kw = dict(num_patch=6, patch_r=16, num_view=3, cropscale=24)
        want = JPTrans(**kw, rng=np.random.default_rng(seed))(img1, img2, disp)
        got = ptrans.PTrans(**kw, rng=np.random.default_rng(seed))(img1, img2, disp)
        assert [g.shape for g in got] == [(6, 33, 33, 3)] * 2 + [(6, 3, 24, 24, 3)] * 2
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and np.array_equal(g, w)
    assert all(n > 0 for n in taken.values()), taken
    # the crop's fallback: no box of the sampled area fits
    img = _image(np.random.default_rng(7), 20, 30)
    got = ptrans._random_resized_crop(img, 16, np.random.default_rng(3), scale=(1.5, 2.0))
    want = np.array(Image.fromarray(img).resize((16, 16), Image.BILINEAR))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("train_bn", [False, True])
def test_ptrans_head_matches_jax(train_bn, tmp_path):
    """GWCNet (base_gc.json at maxdisp 32, fp32) with ``ptrans`` in train
    mode at 1x32x32 with 2 patches x 2 views of 32x32 a side: ``z_ps`` (B,
    NP, 2 NV, 256) within 1e-5 of JAX's, every row of unit norm within 1e-5,
    the disparities within 5e-2 px (tests/test_gwcnet.py:165's bound); with
    ``train_bn`` the batch statistics the trunk (left, right, patches) and
    the projection update match the JAX model's mutated ``batch_stats``
    within 1e-4. The weights load strictly, also through a reference
    ``.pth`` (the head under ``projection.0/1/3``)."""
    cfg = {**BASE_GC, "maxdisp": 32, "mixed_precision": False, "ptrans": True,
           "train_bn": train_bn}
    rng = np.random.default_rng(2)
    img1, img2 = (rng.uniform(0, 255, (1, 32, 32, 3)).astype(np.float32) for _ in range(2))
    a1, a2 = (rng.uniform(0, 255, (1, 2, 2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    jmodel = JGWCNet(JConfig.from_dict(cfg), test_mode=False)
    v = draw_variables(jmodel, rng, img1, img2, None, a1, a2)
    out, updated = jax.jit(lambda v, *x: jmodel.apply(v, *x, mutable=["batch_stats"]))(
        v, img1, img2, None, a1, a2)
    sd = state_dict_from_flax(v)
    assert {k for k in sd if k.startswith("projection.")} == {
        "projection.0.weight", "projection.0.bias", "projection.1.weight", "projection.1.bias",
        "projection.1.running_mean", "projection.1.running_var",
        "projection.1.num_batches_tracked", "projection.3.weight", "projection.3.bias"}
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": {f"module.{k}": t for k, t in sd.items()}}, path)
    model = load_reference_pth(GWCNet(GWCNetConfig.from_dict(cfg), test_mode=False), path).train()
    got = model(*(torch.tensor(a) for a in (img1, img2)), None, torch.tensor(a1),
                torch.tensor(a2))
    z = got["z_ps"].detach()
    assert set(got) == {"disp_preds", "z_ps"} and z.shape == (1, 2, 4, 256)
    assert float((z - torch.tensor(np.asarray(out["z_ps"]))).abs().max()) <= 1e-5
    assert float((z.norm(dim=-1) - 1).abs().max()) <= 1e-5
    disp = torch.tensor(np.asarray(out["disp_preds"]))
    assert float((got["disp_preds"].detach() - disp).abs().max()) <= 5e-2
    if train_bn:
        want = state_dict_from_flax({"params": v["params"], **updated})
        stats = {k: t for k, t in model.state_dict().items() if "running" in k}
        assert any(k.startswith("projection.1.") for k in stats)
        for k, t in stats.items():
            assert float((t - want[k]).abs().max()) <= 1e-4, k
    # test mode, and train mode without patches, return the disparities only
    assert "z_ps" not in model(torch.tensor(img1), torch.tensor(img2))
