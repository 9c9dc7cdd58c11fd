"""Plain RAFT-Stereo (Lipson et al., 3DV 2021; github.com/princeton-vl/RAFT-Stereo),
the benchmark's reference for the configurations that run it.

Plain PyTorch operations only: no kernel of the program, no fused encoder,
no correlation kernel. The volume pyramid is built in full and looked up by
gathers (the upstream ``reg`` path with its plain lookup). Conventions are
the program's: NHWC images in [0, 255] in, disparity as negative flow-x out,
batch norm frozen (running statistics in train and test mode), instance
norm without affine, the correlation taps at ``x / 2^i + (-r..r)`` with zero
padding, the vertical flow fixed at zero. Parameter names are upstream's,
so one state dict loads into this model and into the program with a strict
``load_state_dict``.

Precision is a choice of the caller (:meth:`RAFTStereo.set_precision`):
``"fp32"`` is the reference (TF32 must be off: ``precision.exact_fp32``);
``"fp8"`` rounds the operands of every convolution and of the correlation
products to float8 e4m3 with a per-tensor scale, the control one step below
the configurations' bfloat16.

Departures from upstream, all shared with the program: only the x component
of each update is kept (upstream zeroes y too), and the coordinates of each
iteration are detached.

The module is a model reference as :mod:`stereo_bench.harness` describes it
(``build``, ``disparity``, ``train_forward``, ``train_loss``,
``launch_bytes``): a configuration names it by its file's name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from stereo_bench import bounds
from stereo_bench.reference.precision import identity as _identity
from stereo_bench.reference.precision import round_fp8

class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose operands pass through ``self.quant`` first."""

    quant = staticmethod(_identity)

    def forward(self, x):
        return self._conv_forward(self.quant(x), self.quant(self.weight), self.bias)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """Batch norm with its running statistics, never updated."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over H and W, eps 1e-5, no
    affine."""

    def forward(self, x):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5)


def norm(kind: str, channels: int) -> nn.Module:
    if kind == "batch":
        return FrozenBatchNorm2d(channels)
    if kind == "instance":
        return InstanceNorm()
    raise ValueError(f"the reference has no norm {kind!r}")


class ResidualBlock(nn.Module):
    """Two 3x3 convolutions and a 1x1 shortcut where the shape changes;
    ``norm3`` is also ``downsample.1``, as upstream registers it."""

    def __init__(self, cin: int, cout: int, kind: str, stride: int):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.norm1, self.norm2 = norm(kind, cout), norm(kind, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.norm3 = norm(kind, cout)
            self.downsample = nn.Sequential(Conv2d(cin, cout, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def _stage(cin, cout, kind, stride):
    return nn.Sequential(ResidualBlock(cin, cout, kind, stride), ResidualBlock(cout, cout, kind, 1))


class FeatureEncoder(nn.Module):
    """Upstream's ``BasicEncoder`` at ``n_downsample`` 2: 7x7 stem, stages
    of 64, 96 and 128 channels (the last two strided), a 1x1 head."""

    def __init__(self, out_dim: int, kind: str):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, padding=3)
        self.norm1 = norm(kind, 64)
        self.layer1 = _stage(64, 64, kind, 1)
        self.layer2 = _stage(64, 96, kind, 2)
        self.layer3 = _stage(96, 128, kind, 2)
        self.conv2 = Conv2d(128, out_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class ContextEncoder(nn.Module):
    """Upstream's ``MultiBasicEncoder`` at ``n_downsample`` 2 and 3 GRU
    levels: the feature trunk, two more strided stages and, at 1/4, 1/8 and
    1/16, a list of heads (one per entry of ``dims``)."""

    def __init__(self, dims, kind: str):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, padding=3)
        self.norm1 = norm(kind, 64)
        self.layer1 = _stage(64, 64, kind, 1)
        self.layer2 = _stage(64, 96, kind, 2)
        self.layer3 = _stage(96, 128, kind, 2)
        self.layer4 = _stage(128, 128, kind, 2)
        self.layer5 = _stage(128, 128, kind, 2)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, kind, 1), Conv2d(128, d[2], 3, padding=1))
            for d in dims)
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, kind, 1), Conv2d(128, d[1], 3, padding=1))
            for d in dims)
        self.outputs32 = nn.ModuleList(Conv2d(128, d[0], 3, padding=1) for d in dims)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        out = [[f(x) for f in self.outputs08]]
        x = self.layer4(x)
        out.append([f(x) for f in self.outputs16])
        x = self.layer5(x)
        out.append([f(x) for f in self.outputs32])
        return out


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, inp: int):
        super().__init__()
        self.convz = Conv2d(hidden + inp, hidden, 3, padding=1)
        self.convr = Conv2d(hidden + inp, hidden, 3, padding=1)
        self.convq = Conv2d(hidden + inp, hidden, 3, padding=1)

    def forward(self, h, ctx, *xs):
        cz, cr, cq = ctx
        x = torch.cat(xs, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class MotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 64, 1)
        self.convc2 = Conv2d(64, 64, 3, padding=1)
        self.convf1 = Conv2d(2, 64, 7, padding=3)
        self.convf2 = Conv2d(64, 64, 3, padding=1)
        self.conv = Conv2d(128, 126, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], dim=1))), flow], dim=1)


class FlowHead(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.conv1 = Conv2d(cin, 256, 3, padding=1)
        self.conv2 = Conv2d(256, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


def pool2x(x):
    return F.avg_pool2d(x, 3, 2, 1)


def resize_to(x, like):
    return F.interpolate(x, size=like.shape[2:], mode="bilinear", align_corners=True)


class UpdateBlock(nn.Module):
    """Upstream's ``BasicMultiUpdateBlock`` with 3 GRU levels."""

    def __init__(self, hd, corr_planes: int, factor: int):
        super().__init__()
        self.encoder = MotionEncoder(corr_planes)
        self.gru08 = ConvGRU(hd[2], 128 + hd[1])
        self.gru16 = ConvGRU(hd[1], hd[0] + hd[2])
        self.gru32 = ConvGRU(hd[0], hd[1])
        self.flow_head = FlowHead(hd[2])
        self.mask = nn.Sequential(Conv2d(hd[2], 256, 3, padding=1), nn.ReLU(inplace=True),
                                  Conv2d(256, factor * factor * 9, 1))

    def forward(self, net, inp, corr, flow, with_mask):
        net = list(net)
        net[2] = self.gru32(net[2], inp[2], pool2x(net[1]))
        net[1] = self.gru16(net[1], inp[1], pool2x(net[0]), resize_to(net[2], net[1]))
        motion = self.encoder(flow, corr)
        net[0] = self.gru08(net[0], inp[0], motion, resize_to(net[1], net[0]))
        delta = self.flow_head(net[0])
        mask = 0.25 * self.mask(net[0]) if with_mask else None
        return net, mask, delta


def convex_upsample(disp, mask, f: int):
    """(B, 1, H, W) disparity, (B, 9*f*f, H, W) mask logits -> (B, f*H, f*W):
    each fine pixel a softmax-weighted mix of the coarse 3x3 neighbourhood,
    scaled by f."""
    B, _, H, W = disp.shape
    m = mask.view(B, 1, 9, f, f, H, W).softmax(dim=2)
    nb = F.unfold(f * disp, [3, 3], padding=1).view(B, 1, 9, 1, 1, H, W)
    up = (m * nb).sum(dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, f * H, f * W)


def sample_rows(vol, x):
    """Linear samples of (..., S) rows at (..., K) positions, zero outside
    [0, S-1], fp32."""
    S = vol.shape[-1]
    x0 = torch.floor(x)
    w = x - x0

    def tap(ix):
        inside = (ix >= 0) & (ix <= S - 1)
        return torch.gather(vol, -1, ix.clamp(0, S - 1).long()) * inside

    return tap(x0) * (1 - w) + tap(x0 + 1) * w


class RAFTStereo(nn.Module):
    """Test mode returns ``(coarse disparity (B, H/4, W/4, 1), disparity
    (B, H, W))``; train mode ``(iters, B, H, W)``, one upsampled disparity
    an iteration."""

    def __init__(self, config: dict):
        super().__init__()
        if (config.get("n_downsample", 2), config.get("n_gru_layers", 3)) != (2, 3):
            raise ValueError("the reference runs n_downsample 2 with 3 GRU levels")
        if config.get("shared_backbone") or config.get("backbone_type", "default") != "default":
            raise ValueError("the reference runs separate feature and context encoders")
        hd = tuple(config.get("hidden_dims", (128, 128, 128)))
        self.levels = config.get("corr_levels", 4)
        self.radius = config.get("corr_radius", 4)
        self.hd, self.factor = hd, 4
        self.cnet = ContextEncoder((hd, hd), config.get("context_norm", "batch"))
        self.fnet = FeatureEncoder(256, "instance")
        self.update_block = UpdateBlock(hd, self.levels * (2 * self.radius + 1), self.factor)
        self.context_zqr_convs = nn.ModuleList(Conv2d(h, 3 * h, 3, padding=1) for h in hd)
        self.quant = _identity
        self.lookups = None  # while recording, (coordinates, widths, grad mode) a lookup

    def set_precision(self, precision: str) -> "RAFTStereo":
        """``"fp32"`` or ``"fp8"`` (see the module's docstring)."""
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {precision!r}")
        self.quant = round_fp8 if precision == "fp8" else _identity
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.quant = self.quant
        return self

    def pyramid(self, f1, f2):
        """The volume pyramid of (B, D, H, W) features: level i is
        ``f1 . pool_i(f2) / sqrt(D)``, f2 averaged in pairs along the width
        i times."""
        D = f1.shape[1]
        a = self.quant(f1.permute(0, 2, 3, 1))  # (B, H, W1, D)
        b = f2.permute(0, 2, 3, 1)
        levels = []
        for _ in range(self.levels):
            levels.append(torch.matmul(a, self.quant(b).transpose(-1, -2)) / math.sqrt(D))
            B, H, w, _ = b.shape
            b = b[:, :, :w // 2 * 2].reshape(B, H, w // 2, 2, D).mean(3)
        return levels

    def lookup(self, levels, x):
        """(B, H, W, 1) positions -> (B, L*(2r+1), H, W) taps."""
        if self.lookups is not None:
            self.lookups.append((x.detach(), [v.shape[-1] for v in levels],
                                 torch.is_grad_enabled()))
        dx = torch.arange(-self.radius, self.radius + 1, dtype=x.dtype, device=x.device)
        taps = [sample_rows(v, x / 2**i + dx) for i, v in enumerate(levels)]
        return torch.cat(taps, dim=-1).permute(0, 3, 1, 2)

    def iteration(self, net, inp, levels, coords0, coords1, with_mask: bool):
        coords1 = coords1.detach()
        corr = self.lookup(levels, coords1)
        fx = (coords1 - coords0).permute(0, 3, 1, 2)
        flow = torch.cat([fx, torch.zeros_like(fx)], dim=1)
        net, mask, delta = self.update_block(net, inp, corr, flow, with_mask)
        return net, coords1 + delta[:, :1].permute(0, 2, 3, 1), mask

    def forward(self, image1, image2, iters: int, test_mode: bool = True,
                remat: bool = False):
        """``remat`` recomputes each train-mode iteration in the backward
        pass (``torch.utils.checkpoint``) instead of keeping it; the
        arithmetic is the same."""
        x1 = (2.0 * (image1 / 255.0) - 1.0).permute(0, 3, 1, 2)
        x2 = (2.0 * (image2 / 255.0) - 1.0).permute(0, 3, 1, 2)
        heads = self.cnet(x1)
        net = [torch.tanh(h[0]) for h in heads]
        inp = [conv(F.relu(h[1])).split(d, dim=1)
               for conv, h, d in zip(self.context_zqr_convs, heads, self.hd)]
        f1, f2 = self.fnet(torch.cat([x1, x2], dim=0)).chunk(2, dim=0)
        levels = self.pyramid(f1, f2)
        B, _, H, W = f1.shape
        coords0 = torch.arange(W, dtype=torch.float32, device=f1.device).view(1, 1, W, 1)
        coords0 = coords0.expand(B, H, W, 1)
        coords1 = coords0
        if test_mode:
            for i in range(iters):
                net, coords1, mask = self.iteration(net, inp, levels, coords0, coords1,
                                                    i == iters - 1)
            disp = coords1 - coords0
            return disp, convex_upsample(disp.permute(0, 3, 1, 2), mask, self.factor)

        def step(net, coords1):
            net, coords1, mask = self.iteration(net, inp, levels, coords0, coords1, True)
            up = convex_upsample((coords1 - coords0).permute(0, 3, 1, 2), mask, self.factor)
            return net, coords1, up

        preds = []
        for _ in range(iters):
            if remat:
                net, coords1, up = checkpoint(step, net, coords1, use_reentrant=False)
            else:
                net, coords1, up = step(net, coords1)
            preds.append(up)
        return torch.stack(preds)


def build(config: dict) -> RAFTStereo:
    return RAFTStereo(config)


def disparity(model: RAFTStereo, image1, image2, iters: int) -> torch.Tensor:
    """The test-mode disparity at full resolution, (B, H, W)."""
    return model(image1, image2, iters)[1]


def train_forward(model: RAFTStereo, image1, image2, iters: int, remat: bool = False):
    """The train-mode predictions, (iters, B, H, W)."""
    return model(image1, image2, iters, test_mode=False, remat=remat)


def train_loss(preds, gt, valid, gamma=0.9, max_flow=700.0):
    """RAFT-Stereo's sequence loss: (loss, ok) of (N, B, H, W) predictions
    against (B, H, W) negative disparity, the gamma-weighted L1 over the
    valid pixels under ``max_flow``; ``ok`` where the ground truth and the
    predictions are finite."""
    n = preds.shape[0]
    mask = (valid >= 0.5) & (gt.abs() < max_flow)
    ok = bool(torch.isfinite(gt[mask]).all()) and bool(torch.isfinite(preds).all())
    g = gamma ** (15.0 / (n - 1)) if n > 1 else 1.0
    count = mask.sum().clamp_min(1)
    loss = sum(g ** (n - 1 - i) * ((preds[i] - gt).abs() * mask).sum() / count
               for i in range(n))
    return loss, ok


def record(models, on: bool):
    """Start (``on``) or stop recording the lookups of ``models``."""
    for m in models:
        m.lookups = [] if on else None


def launch_bytes(models, itemsize: int) -> dict:
    """Bytes a batch row that the program's correlation kernels must move
    for the coordinates recorded in ``models``' lookups, a launch on
    average, by the program's counter: K1's forward (``corr_lookup``, every
    lookup) and its backward (``corr_lookup_bwd``, the lookups made with
    gradients), volumes, taps and gradients of ``itemsize`` bytes
    (:func:`stereo_bench.bounds.k1_fwd_bytes`, :func:`~stereo_bench.bounds.k1_bwd_bytes`)."""
    calls = [(c, w, g, m.radius) for m in models for c, w, g in (m.lookups or [])]
    fwd = [bounds.k1_fwd_bytes(c, w, r, itemsize, itemsize) / c.shape[0] for c, w, _, r in calls]
    bwd = [bounds.k1_bwd_bytes(c, w, r, itemsize, itemsize) / c.shape[0]
           for c, w, g, r in calls if g]
    out = {}
    if fwd:
        out["corr_lookup"] = sum(fwd) / len(fwd)
    if bwd:
        out["corr_lookup_bwd"] = sum(bwd) / len(bwd)
    return out
