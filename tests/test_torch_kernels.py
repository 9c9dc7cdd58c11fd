"""Plain versions of the port's two kernels vs the JAX Pallas kernels they
replace (run in interpret mode, as the JAX package's own tests do), and the
fused encoder chain built on K2.

K1 (corr lookup) and K2 (encoder stage) run their CUDA kernels only on the
card (``chip_smoke.py`` holds them against these plain versions there); on
CPU tensors the wrappers take the plain path and launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.nn.blocks import fused_fullres_layer1 as jfused
from dkt_stereo_tpu.ops.pallas import encoder_conv as jenc
from dkt_stereo_tpu.ops.pallas.corr_lookup import corr_lookup_pallas
from dkt_stereo_tpu_torch.nn.blocks import _res_pair, fused_fullres_layer1
from dkt_stereo_tpu_torch.nn.norms import Norm
from dkt_stereo_tpu_torch.ops.cuda import _build
from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup
from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import encoder_stage


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _lookup_inputs(rng, B=1, H=8, W=32, levels=4):
    pyr = [rng.standard_normal((B, H, W, W >> i)).astype(np.float32) for i in range(levels)]
    coords = rng.uniform(-3, W + 3, (B, H, W, 1)).astype(np.float32)
    flat = coords.reshape(-1)
    # far out of range, (-1, 0], exact integers, the last index, past it
    flat[:12] = [-1e9, 1e9, -1.0, -0.75, -1e-6, 0.0, 5.0, 17.0, W - 1.0, W - 0.5, W, W + 0.25]
    return pyr, coords


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_lookup_plain_matches_pallas(rng, dtype):
    """Same arithmetic on the same (possibly bf16) volume values: 1e-5."""
    pyr, coords = _lookup_inputs(rng)
    jdt = jnp.dtype(dtype)
    want = np.asarray(
        corr_lookup_pallas(tuple(jnp.asarray(v, jdt) for v in pyr), jnp.asarray(coords), 4, True)
    )
    tdt = getattr(torch, dtype)
    # the wrapper returns the motion encoder's NCHW view of a dense NHWC
    # tensor, fp32 by default
    got = corr_lookup([_t(v).to(tdt) for v in pyr], _t(coords), 4)
    assert got.dtype == torch.float32 and got.shape == (1, 36, 8, 32)
    assert want.shape == (1, 8, 32, 36) and got.permute(0, 2, 3, 1).is_contiguous()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def _jax_stage(u, a, b, w_hwio, v=None, a2=None, b2=None, emit_h=False, rb=8):
    """The JAX kernel on logical inputs: pack to the w2d frame at shift 0,
    run, slice the output frame (shift 1) and combine the phase statistics."""
    H, C = u.shape[1], u.shape[-1]

    def frame(t):
        return jenc.w2d_pad(jenc.w2d_pack(jnp.asarray(t)), rb)

    def dup(t):
        return jnp.asarray(np.concatenate([t, t], -1))

    kw = {}
    if v is not None:
        kw = dict(v=frame(v), a2=dup(a2), b2=dup(b2))
    outs = jenc.encoder_stage(
        frame(u), dup(a), dup(b), jenc.w2d_conv3x3_weights(jnp.asarray(w_hwio)),
        H=H, shift_in=0, emit_h=emit_h, interpret=True, rb=rb, **kw,
    )
    y = np.asarray(jenc.w2d_unpack(jenc.w2d_slice(outs[0], 1, H)))
    s = np.asarray(outs[1][:, :C] + outs[1][:, C:])
    ss = np.asarray(outs[2][:, :C] + outs[2][:, C:])
    res = [y, s, ss]
    if emit_h:
        res.append(np.asarray(jenc.w2d_unpack(jenc.w2d_slice(outs[3], 0, H))))
    return res


def _close(got, want, rel):
    """max-abs difference relative to the scale of the values compared."""
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= rel * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("residual", [False, True])
def test_encoder_stage_plain_matches_pallas(rng, residual):
    """fp32 on both sides; the conv sums 9*C products in another order:
    1e-5 relative to the activation (statistics: sum) scale."""
    B, H, W, C = 2, 8, 16, 16
    u = rng.standard_normal((B, H, W, C)).astype(np.float32)
    a, b = (rng.standard_normal((B, C)).astype(np.float32) for _ in range(2))
    w = (rng.standard_normal((3, 3, C, C)) * 0.2).astype(np.float32)
    kw, tkw = {}, {}
    if residual:
        v = rng.standard_normal((B, H, W, C)).astype(np.float32)
        a2, b2 = (rng.standard_normal((B, C)).astype(np.float32) for _ in range(2))
        kw = dict(v=v, a2=a2, b2=b2, emit_h=True)
        tkw = dict(v=_t(v), a2=_t(a2), b2=_t(b2), emit_h=True)
    want = _jax_stage(u, a, b, w, **kw)
    got = encoder_stage(_t(u), _t(a), _t(b), _t(w.transpose(3, 2, 0, 1)), **tkw)
    assert len(got) == len(want) == (4 if residual else 3)
    for g, x in zip(got, want):
        assert g.shape == x.shape and g.dtype == torch.float32
        _close(g.numpy(), x, 1e-5)


def _layer1(weights, norm_fn="instance"):
    m = _res_pair(64, 64, norm_fn, 1)
    for blk, (w1, w2) in zip(m, (weights[:2], weights[2:])):
        blk.conv1.weight.data = _t(w1.transpose(3, 2, 0, 1))
        blk.conv2.weight.data = _t(w2.transpose(3, 2, 0, 1))
    return m


def test_fused_fullres_layer1_matches_jax(rng):
    """The four-stage chain vs the JAX fused chain (Pallas interpret) at
    2x16x32, fp32: 1e-4 relative to the activation scale (instance-norm
    statistics over 512 pixels, four stages deep)."""
    B, H, W = 2, 16, 32
    x = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    stem = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    ws = [(rng.standard_normal((3, 3, 64, 64)) * 0.06).astype(np.float32) for _ in range(4)]
    triples = [(jnp.asarray(w), jnp.zeros(64), None) for w in ws]
    want = np.asarray(jfused(jnp.asarray(x), jnp.asarray(stem), triples, "instance", jnp.float32))
    with torch.no_grad():
        got = fused_fullres_layer1(_t(x).permute(0, 3, 1, 2), _t(stem.transpose(3, 2, 0, 1)),
                                   _layer1(ws))
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4)


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_fused_fullres_layer1_matches_unfused(rng, norm_fn):
    """Fused chain vs the module path it replaces (stem conv -> norm1 ->
    relu -> layer1), with random conv biases and, for eval-mode BatchNorm,
    random running statistics so the folds matter."""
    torch.manual_seed(0)
    stem = torch.nn.Conv2d(3, 64, 7, padding=3)
    norm1 = Norm(norm_fn, 64)
    layer1 = _res_pair(64, 64, norm_fn, 1)
    with torch.no_grad():
        for m in [norm1, *layer1.modules()]:
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_()
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 2.0)
    for m in (stem, norm1, layer1):
        m.eval()
    x = _t(rng.standard_normal((2, 3, 12, 20)).astype(np.float32))
    with torch.no_grad():
        want = layer1(torch.relu(norm1(stem(x))))
        kw = dict(stem_bn=norm1, stem_bias=stem.bias) if norm_fn == "batch" else {}
        got = fused_fullres_layer1(x, stem.weight, layer1, norm_fn, **kw)
    _close(got.numpy(), want.numpy(), 1e-5)


def _fake_nvcc(tmp_path, monkeypatch, script):
    """Point the kernel build at a stand-in ``nvcc`` and a scratch source
    and build directory."""
    bin_dir, csrc = tmp_path / "bin", tmp_path / "csrc"
    bin_dir.mkdir()
    csrc.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (csrc / "k.cu").write_text("// v1\n")
    return csrc / "k.cu"


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    """A library is built once per source text: an edited source gets a new
    library, an unchanged one is not rebuilt. ptxas's report (nvcc's stderr)
    is kept beside it."""
    src = _fake_nvcc(tmp_path, monkeypatch,
                     'while [ "$1" != "-o" ]; do shift; done; echo built >> "$2"\n'
                     'echo "ptxas info    : Used 7 registers" >&2\n')
    (first,) = _build.build(["k"])
    assert first.read_text() == "built\n"
    assert _build.ptxas_path(first).read_text() == "ptxas info    : Used 7 registers\n"
    assert _build.build(["k"]) == [first] and first.read_text() == "built\n"
    src.write_text("// v2\n")
    (second,) = _build.build(["k"])
    assert second != first and second.exists()


def test_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 'echo "k.cu(3): error: no such intrinsic" >&2; exit 2\n')
    with pytest.raises(RuntimeError, match=r"k\.cu \(nvcc exit 2\):\nk\.cu\(3\): error: no such"):
        _build.build(["k"])
    assert not list((tmp_path / "build").iterdir())  # no partial library left behind


def test_wrappers_on_cpu_take_the_plain_path(rng):
    """CPU tensors never reach the kernels: the launch counters stay 0.
    Devices that are neither CPU nor CUDA are refused."""
    k1, k2 = corr_lookup.launches, encoder_stage.launches
    pyr, coords = _lookup_inputs(rng, H=2, W=8, levels=2)
    corr_lookup([_t(v) for v in pyr], _t(coords), 2)
    u = _t(rng.standard_normal((1, 4, 6, 64)).astype(np.float32))
    ab = torch.ones(1, 64)
    encoder_stage(u, ab, ab, torch.zeros(64, 64, 3, 3))
    assert (corr_lookup.launches, encoder_stage.launches) == (k1, k2)
    with pytest.raises(ValueError, match="unsupported device"):
        corr_lookup([torch.zeros(1, 2, 8, 8, device="meta")], torch.zeros(1, 2, 8, 1, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        encoder_stage(u.to("meta"), ab, ab, torch.zeros(64, 64, 3, 3))
