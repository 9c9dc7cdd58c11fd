"""DKT fine-tuning: one ``make_dkt_train_step`` call after another on one
training state, each on a batch made on the card from the seed (a clean
pair, its photometrically augmented copy, negative disparity and a valid
mask, by the cell's ``labels`` and ``augment`` parameters;
:func:`make_batch`) with the F&E draws of a seeded generator.

Set-up builds the state (``create_dkt_state`` with the seeded weights) and
drives it through its first steps (the cell's ``checked_steps``, two or
three), which are also the warm-up; the window then goes on with the same
object. The step's ``mark`` hook records
CUDA events, from which the teachers' and the student's device ms a step
are read.

Correctness: once the window has closed and the program is freed, the
plain reference (the DKT step of :mod:`stereo_bench.reference.dkt` over
the model reference that the configuration names; fp32, TF32 off) repeats
the first steps from the same weights, batches and draws; its first
step's recorded lookups give the bytes a launch of the program's
correlation kernels (``launch_bytes``). Compared: each step's loss (the
largest gap); the first step's gradient as AdamW got it (its first moment
over 1 - beta1) and the parameters' change over those steps, each by the
median leaf. A worst leaf is the noise of one leaf: the mask head's first
convolution, whose gradient through the convex upsampling's softmax is a
difference of near-equal terms, reads 12 % off in bf16 on some seeds on
an H100 (0.3 % with the program in fp32), and a small leaf's gradient
rounded in bf16 makes Adam's later steps move it differently. A leaf's
gap is the gap between the two norms over the larger of the reference's
norm and the median leaf's. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of both: their gradient is
nought but for rounding (the biases ahead of the feature encoder's
instance norms) and Adam moves them by round-off alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from stereo_bench import flops, trace
from stereo_bench.harness import reference_weights, stream_seed
from stereo_bench.reference.dkt import DKTReference, Hyper
from stereo_bench.reference.precision import exact_fp32

BETA1 = 0.9


def unit_flops(cell: dict, config: dict, ref) -> int:
    H, W = cell["crop"]
    return flops.dkt_step_flops(ref, config["model"], cell["batch"], H, W,
                                config["train_iters"], config["teacher_iters"])


def make_batch(gen, B, H, W, dev, labels: dict, augment: dict) -> dict:
    """A clean pair, its augmented copy (``augment``: a gain, a shift and
    noise), negative disparity and a valid mask (``labels["valid"]`` of the
    pixels). The disparity lies in ``labels["near_px"]`` (near the
    teachers', whose random weights with the configuration's small flow
    head predict within a pixel) except on smooth blobs where a smoothed
    uniform field exceeds ``labels["far_above"]``, which lie in
    ``labels["far_px"]``: F&E keeps the first and drops the second unless
    an image is re-admitted, as fine-tuning data that a teacher mostly
    agrees with; no pixel lies near F&E's 3 px threshold."""
    def smooth(lo, hi, cells):
        coarse = torch.rand((B, 1, max(H // cells, 1), max(W // cells, 1)), generator=gen,
                            device=dev)
        up = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)[:, 0]
        return lo + (hi - lo) * up

    clean = 255 * torch.rand((2, B, H, W, 3), generator=gen, device=dev)
    lo, hi = augment["gain"]
    gain = lo + (hi - lo) * torch.rand((2, B, 1, 1, 1), generator=gen, device=dev)
    shift = augment["shift"] * (2 * torch.rand((2, B, 1, 1, 1), generator=gen, device=dev) - 1)
    noise = augment["noise"] * torch.randn(clean.shape, generator=gen, device=dev)
    aug = (clean * gain + shift + noise).clamp(0, 255)
    far = smooth(0, 1, 32) > labels["far_above"]
    disp = torch.where(far, smooth(*labels["far_px"], 16), smooth(*labels["near_px"], 16))
    valid = (torch.rand((B, H, W), generator=gen, device=dev) < labels["valid"]).float()
    return {"img1": aug[0], "img2": aug[1], "img1_clean": clean[0], "img2_clean": clean[1],
            "flow": -disp, "valid": valid}


def make_draws(gen, B, dev) -> dict:
    u = torch.rand(B + 4, generator=gen, device=dev)
    return {"filter_gt": u[:B], "ensemble_gt": u[B], "ensemble_pl": u[B + 1], "mix": u[B + 2],
            "mix_h": u[B + 3]}


class Program:
    """The port's DKT state and step."""

    def __init__(self, config, weights, dev):
        from dkt_stereo_tpu_torch.train import dkt_step
        from dkt_stereo_tpu_torch.train.state import DKTHyperParams

        hyper = DKTHyperParams(train_iters=config["train_iters"],
                               teacher_iters=config["teacher_iters"])
        with torch.device(dev):
            self.state = dkt_step.create_dkt_state(config["model"], hyper, params=weights,
                                                   device=dev)
        self.step_fn = dkt_step.make_dkt_train_step(config["model"], hyper)

    def step(self, batch, draws, mark=None):
        self.state, m = self.step_fn(self.state, batch, draws=draws, mark=mark)
        return m["loss"], m["ok"] == 1.0

    def first_moments(self):
        opt = self.state.optimizer
        return {k: opt.state[p]["exp_avg"] for k, p in self.state.student.named_parameters()
                if p in opt.state}

    def params(self):
        return dict(self.state.student.named_parameters())


class Reference:
    """The reference's step over model reference ``model_ref`` (the
    control: one precision below, in the program's place). With
    ``record``, the first step's lookups give ``launch_bytes``."""

    def __init__(self, model_ref, config, weights, dev, precision, record=False):
        hyper = Hyper(train_iters=config["train_iters"], teacher_iters=config["teacher_iters"])
        self.ref = DKTReference(model_ref, config["model"], weights, hyper, dev, precision)
        self.model_ref, self.record, self.launch_bytes = model_ref, record, {}
        self.itemsize = 2 if config["precision"] == "bfloat16" else 4

    def step(self, batch, draws, mark=None):
        models = [self.ref.student, self.ref.ema, self.ref.teacher]
        recording = self.record and hasattr(self.model_ref, "record")
        if recording:
            self.model_ref.record(models, True)
        with exact_fp32():
            out = self.ref.step(batch, draws)
        if recording:
            self.launch_bytes = self.model_ref.launch_bytes(models, self.itemsize)
            self.model_ref.record(models, False)
            self.record = False
        self.teacher_px, self.loss_parts = out["teacher_px"], out["loss_parts"]
        for part in ("ema", "teachers", "fande", "student", "optimizer"):
            if mark:
                mark(part)
        return out["loss"], out["ok"]

    def first_moments(self):
        return dict(self.ref.m)

    def params(self):
        return self.ref.params


def leaf_norms(tensors: dict) -> dict:
    return {k: float(t.float().norm()) for k, t in tensors.items()}


def leaf_gaps(got: dict, want: dict, keys) -> list:
    """|norm got - norm want| / max(norm want, median norm want), a leaf."""
    med = float(np.median([want[k] for k in keys]))
    return [abs(got.get(k, 0.0) - want[k]) / max(want[k], med, 1e-30) for k in keys]


def readings(trainer, weights, losses) -> dict:
    """What the checks compare, from a trainer after its first steps."""
    return {"losses": losses, "grad": leaf_norms(trainer.grad1),
            "change": leaf_norms({k: p.detach() - weights[k]
                                  for k, p in trainer.params().items()})}


def checks(got: dict, want: dict, limits: dict) -> dict:
    """The largest step's loss gap; the median leaf's gap of the first
    gradient and of the change. Over the leaves whose reference gradient is
    at least a thousandth of the median leaf's."""
    med = float(np.median(list(want["grad"].values())))
    keep = [k for k, g in want["grad"].items() if g >= 1e-3 * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    return {"loss_gap": (loss_gap, limits["loss_gap"]),
            "grad_gap": (float(np.median(leaf_gaps(got["grad"], want["grad"], keep))),
                         limits["grad_gap"]),
            "change_gap": (float(np.median(leaf_gaps(got["change"], want["change"], keep))),
                           limits["change_gap"])}


def first_steps(trainer, weights, batches, draws):
    """The first ``len(draws)`` steps; the first gradient is read from
    AdamW's first moment after the first."""
    losses, ok, teacher_px, parts = [], True, [], []
    for i in range(len(draws)):
        loss, good = trainer.step(batches[i], draws[i])
        teacher_px.append(getattr(trainer, "teacher_px", None))
        parts.append(getattr(trainer, "loss_parts", None))
        losses.append(float(loss))
        ok &= bool(good)
        if i == 0:
            trainer.grad1 = {k: m.detach() / (1 - BETA1)
                             for k, m in trainer.first_moments().items()}
    return {**readings(trainer, weights, losses), "teacher_px": teacher_px,
            "loss_parts": parts}, ok


def run(ctx) -> dict:
    cell, config, dev = ctx.cell, ctx.config, ctx.device
    B, (H, W) = cell["batch"], cell["crop"]
    cuda = dev.type == "cuda"
    weights = reference_weights(ctx.reference, config["model"], stream_seed(ctx.seed, 0), dev,
                                config["init_scale"])
    gen = torch.Generator(device=dev).manual_seed(stream_seed(ctx.seed, 1))
    batches = [make_batch(gen, B, H, W, dev, cell["labels"], cell["augment"])
               for _ in range(cell["pool"])]
    dgen = torch.Generator(device=dev).manual_seed(stream_seed(ctx.seed, 2))
    checked = cell["checked_steps"]
    first_draws = [make_draws(dgen, B, dev) for _ in range(checked)]

    if ctx.control:
        trainer = Reference(ctx.reference, config, weights, dev, config["control"])
    else:
        trainer = Program(config, weights, dev)
    got, first_ok = first_steps(trainer, weights, batches, first_draws)  # each ends synced

    parts = {"teachers": [], "student": []}

    def step(i):
        events = {}

        def mark(name):
            if cuda:
                events[name] = torch.cuda.Event(enable_timing=True)
                events[name].record()

        mark("start")
        _, ok = trainer.step(batches[i % len(batches)], make_draws(dgen, B, dev), mark)
        if cuda:
            parts["teachers"].append(events["ema"].elapsed_time(events["teachers"]))
            parts["student"].append(events["fande"].elapsed_time(events["student"]))
        return ok

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    oks, ends = [], []
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while len(oks) < 2 or time.perf_counter() < deadline:
        oks.append(step(checked + len(oks)))
        ends.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n = len(oks)
    rec = {
        "setup_s": t_start - ctx.t0, "window_s": ends[-1] - t_start, "units": n,
        "samples": n * B, "parts_ms": parts,
        "latencies_s": list(np.diff([t_start] + ends)), "peak_bytes": peak,
        "rows": B, "flops_per_step": cell["flops_per_unit"],
        "attempted": n, "failed": sum(not ok for ok in oks) + (0 if first_ok else 1),
    }
    if ctx.trace:
        rec["trace"] = trace.traced(
            lambda k: [step(checked + n + j) for j in range(k)], cell["trace_units"], dev)
    del trainer
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    reference = Reference(ctx.reference, config, weights, dev, "fp32", record=True)
    want, _ = first_steps(reference, weights, batches, first_draws)
    rec["reference_s"] = time.perf_counter() - t_ref
    rec["launch_bytes"] = reference.launch_bytes
    rec["readings"] = {"program": got, "reference": want}
    rec["reference_losses"] = want["losses"]
    rec["reference_teacher_px"] = want["teacher_px"]
    rec["reference_loss_parts"] = want["loss_parts"]
    rec["checks"] = checks(got, want, cell["limits"])
    return rec
