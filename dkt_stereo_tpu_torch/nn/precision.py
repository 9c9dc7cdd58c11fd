"""Mixed precision of the models' networks: bf16 ``torch.autocast``, and the
same policy applied op by op inside a ``torch.func.vmap``.

Autocast cannot be relied on inside ``vmap``: on the CPU an autocast region
entered around the ``vmap`` call or inside the mapped function leaves a
mapped convolution in fp32; on CUDA it casts a mapped convolution alone,
yet RAFT's batched teachers under it stop at a convolution whose bf16
input meets an fp32 bias (``chip_smoke.py`` phase 44 shows both). The DKT
step's batched teachers (``train/dkt_step.py``) run the models under
``vmap``; they enter :func:`vmapped`, and inside it :func:`autocast`
returns :class:`_AutocastPolicy`, a ``TorchFunctionMode`` that casts the
arguments of each op as the device's autocast would: the lower-precision ops'
floating tensors to bf16, the fp32 ops' bf16 tensors to fp32, and the
promoting ops' tensors to the widest of their dtypes. The lists are CUDA's
and the CPU's autocast lists, by the names under which
``torch.nn.functional`` and the tensor methods reach a ``TorchFunctionMode``
(``interpolate`` for the upsampling ops, ``grid_sample`` for
``grid_sampler``, ``normalize`` for the norm it takes); the two differ (CUDA
runs the upsampling, the reductions and the transcendental ops in fp32, the
CPU in the input's dtype), and :func:`policy_mismatches` holds each list
against the device's autocast. A frozen batch norm of bf16 activations with fp32 statistics, which
autocast leaves to the mixed-dtype kernel (fp32 arithmetic, output in the
input's dtype), runs as :func:`batch_norm_fp32`, the same affine map in
fp32 written out: functorch's batching rule refuses the mixed dtypes on the
CPU, on CUDA it asks a channels-last activation for a memory format that a
mapped tensor cannot report, and where it runs it decomposes the norm, so
its rounding is not the kernel's either. The written-out map rounds an
output at most a bf16 step away from the kernel's.
"""

from __future__ import annotations

import contextlib
import inspect

import torch
from torch.overrides import TorchFunctionMode

_VMAPPED = False

_LOWER = frozenset((
    "conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d", "conv_transpose3d",
    "conv_tbc", "convolution", "prelu", "linear", "matmul", "__matmul__", "__rmatmul__", "mm",
    "mv", "bmm", "baddbmm", "addmm", "addmv", "addr", "addbmm", "einsum", "chain_matmul",
    "linalg_multi_dot", "linalg_vecdot", "lstm_cell", "gru_cell", "rnn_tanh_cell",
    "rnn_relu_cell", "scaled_dot_product_attention"))
_FP32 = frozenset((
    "acos", "asin", "cosh", "erfinv", "exp", "expm1", "log", "log10", "log2", "log1p",
    "reciprocal", "rsqrt", "sinh", "tan", "pow", "__pow__", "__rpow__", "softplus",
    "layer_norm", "group_norm", "norm", "normalize", "linalg_vector_norm",
    "linalg_matrix_norm", "cosine_similarity", "dist", "pdist", "cdist", "renorm",
    "logsumexp", "softmax", "log_softmax", "prod", "cumprod", "cumsum", "sum",
    "interpolate", "upsample", "upsample_bilinear", "upsample_nearest",
    "poisson_nll_loss", "cosine_embedding_loss", "nll_loss", "hinge_embedding_loss", "kl_div",
    "l1_loss", "smooth_l1_loss", "huber_loss", "mse_loss", "margin_ranking_loss",
    "multilabel_margin_loss", "soft_margin_loss", "triplet_margin_loss", "multi_margin_loss",
    "binary_cross_entropy_with_logits"))
_PROMOTE = frozenset((
    "addcdiv", "addcmul", "atan2", "bilinear", "cross", "dot", "vdot", "grid_sample",
    "index_put", "tensordot", "scatter_add", "index_copy", "cat", "stack"))
_LOSSES = frozenset(n for n in _FP32 if n.endswith("_loss") or n in (
    "kl_div", "binary_cross_entropy_with_logits"))
# the device type's (lower precision, fp32, promote) lists
_LISTS = {
    "cuda": (_LOWER, _FP32, _PROMOTE),
    "cpu": (_LOWER, _LOSSES | {"prod", "cdist", "grid_sample"}, frozenset(("cat", "stack",
                                                                           "index_copy"))),
}


def _floats(x):
    """The floating tensors in ``x`` (a tensor, a list or tuple of them, or
    anything else)."""
    if isinstance(x, torch.Tensor):
        return [x] if x.is_floating_point() else []
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _floats(v)]
    return []


def _cast(x, dtype, only=None):
    """``x`` with its floating tensors (those of dtype ``only``, if given)
    cast to ``dtype``."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point() and x.dtype != dtype and only in (None, x.dtype):
            return x.to(dtype)
        return x
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(v, dtype, only) for v in x)
    if isinstance(x, dict):
        return {k: _cast(v, dtype, only) for k, v in x.items()}
    return x


def batch_norm_fp32(x, running_mean, running_var, weight, bias, eps):
    """A frozen batch norm of ``x`` (B, C, ...) with its running statistics:
    ``x * a + (bias - mean * a)``, ``a = weight / sqrt(var + eps)``, in fp32,
    cast back to ``x``'s dtype."""
    shape = (-1,) + (1,) * (x.dim() - 2)
    a = weight * torch.rsqrt(running_var + eps)
    return (x.float() * a.view(shape) + (bias - running_mean * a).view(shape)).to(x.dtype)


_BATCH_NORM = inspect.signature(torch.nn.functional.batch_norm)


class _AutocastPolicy(TorchFunctionMode):
    """The bf16 autocast policy of ``device_type`` ("cuda" or "cpu"),
    applied to each op's arguments."""

    def __init__(self, device_type: str):
        super().__init__()
        if device_type not in _LISTS:
            raise ValueError(f"no autocast policy for device type {device_type!r}")
        self.lower, self.fp32, self.promote = _LISTS[device_type]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in self.lower:
            args, kwargs = _cast(args, torch.bfloat16), _cast(kwargs, torch.bfloat16)
        elif name in self.fp32:
            args = _cast(args, torch.float32, only=torch.bfloat16)
            kwargs = _cast(kwargs, torch.float32, only=torch.bfloat16)
        elif name == "batch_norm" and args[0].dtype == torch.bfloat16:
            a = _BATCH_NORM.bind(*args, **kwargs)
            a.apply_defaults()
            a = a.arguments
            if not a["training"] and a["weight"] is not None and a["bias"] is not None:
                return batch_norm_fp32(a["input"], a["running_mean"], a["running_var"],
                                       a["weight"], a["bias"], a["eps"])
        elif name in self.promote:
            dtypes = {t.dtype for t in _floats(args) + _floats(list(kwargs.values()))}
            if len(dtypes) > 1:
                wide = dtypes.pop()
                for d in dtypes:
                    wide = torch.promote_types(wide, d)
                args, kwargs = _cast(args, wide), _cast(kwargs, wide)
        return func(*args, **kwargs)


@contextlib.contextmanager
def vmapped():
    """Mark the code inside as running under ``torch.func.vmap``."""
    global _VMAPPED
    prev, _VMAPPED = _VMAPPED, True
    try:
        yield
    finally:
        _VMAPPED = prev


def autocast(device: torch.device, enabled: bool):
    """A bf16 autocast region on ``device`` (none unless ``enabled``);
    inside :func:`vmapped`, the same policy op by op."""
    if not enabled:
        return contextlib.nullcontext()
    if _VMAPPED:
        return _AutocastPolicy(device.type)
    return torch.autocast(device.type, dtype=torch.bfloat16)


def _cases(device: torch.device) -> dict:
    """One call of each listed op (and of batch norm) on small inputs that
    a generator ``g`` makes on ``device``: ``name -> fn(g)``. The
    lower-precision ops get fp32 operands, the fp32 ops bf16 ones, the
    promoting ops both."""
    F = torch.nn.functional
    bf, f32 = torch.bfloat16, torch.float32

    def t(g, *shape, dtype=bf):
        return (0.1 + 0.8 * torch.rand(shape, generator=g, device=device)).to(dtype)

    def unary(op):
        return lambda g: op(t(g, 4, 8))

    def pair(op):
        return lambda g: op(t(g, 4, 8), t(g, 4, 8))

    return {
        "conv1d": lambda g: F.conv1d(t(g, 1, 4, 8, dtype=f32), t(g, 3, 4, 3, dtype=f32)),
        "conv2d": lambda g: F.conv2d(t(g, 1, 4, 8, 8), t(g, 3, 4, 3, 3, dtype=f32),
                                     t(g, 3, dtype=f32)),
        "conv3d": lambda g: F.conv3d(t(g, 1, 4, 4, 8, 8, dtype=f32),
                                     t(g, 3, 4, 3, 3, 3, dtype=f32)),
        "conv_transpose2d": lambda g: F.conv_transpose2d(t(g, 1, 4, 8, 8, dtype=f32),
                                                         t(g, 4, 3, 3, 3, dtype=f32)),
        "linear": lambda g: F.linear(t(g, 2, 8), t(g, 4, 8, dtype=f32), t(g, 4, dtype=f32)),
        "matmul": lambda g: torch.matmul(t(g, 2, 8, dtype=f32), t(g, 8, 4, dtype=f32)),
        "__matmul__": lambda g: t(g, 2, 8, dtype=f32) @ t(g, 8, 4, dtype=f32),
        "bmm": lambda g: torch.bmm(t(g, 2, 3, 8, dtype=f32), t(g, 2, 8, 4, dtype=f32)),
        "einsum": lambda g: torch.einsum("bij,bjk->bik", t(g, 2, 3, 8, dtype=f32),
                                         t(g, 2, 8, 4, dtype=f32)),
        "exp": unary(torch.exp), "log": unary(torch.log), "rsqrt": unary(torch.rsqrt),
        "reciprocal": unary(torch.reciprocal), "pow": unary(lambda x: torch.pow(x, 2)),
        "__pow__": unary(lambda x: x ** 2), "softplus": unary(F.softplus),
        "layer_norm": unary(lambda x: F.layer_norm(x, (8,))),
        "group_norm": lambda g: F.group_norm(t(g, 1, 4, 8, 8), 2),
        "norm": unary(lambda x: x.norm(dim=1)), "normalize": unary(lambda x: F.normalize(x)),
        "linalg_vector_norm": unary(lambda x: torch.linalg.vector_norm(x, dim=1)),
        "cosine_similarity": pair(F.cosine_similarity),
        "cdist": lambda g: torch.cdist(t(g, 1, 4, 8), t(g, 1, 5, 8)),
        "logsumexp": unary(lambda x: torch.logsumexp(x, 1)),
        "softmax": unary(lambda x: F.softmax(x, 1)),
        "log_softmax": unary(lambda x: F.log_softmax(x, 1)),
        "prod": unary(lambda x: torch.prod(x, 1)), "cumsum": unary(lambda x: x.cumsum(1)),
        "sum": unary(lambda x: x.sum(1)),
        "interpolate": lambda g: F.interpolate(t(g, 1, 4, 8, 8), scale_factor=2,
                                               mode="bilinear", align_corners=True),
        "l1_loss": pair(F.l1_loss), "smooth_l1_loss": pair(F.smooth_l1_loss),
        "mse_loss": pair(F.mse_loss),
        "cat": lambda g: torch.cat([t(g, 4, 8), t(g, 4, 8, dtype=f32)]),
        "stack": lambda g: torch.stack([t(g, 4, 8), t(g, 4, 8, dtype=f32)]),
        "grid_sample": lambda g: F.grid_sample(t(g, 1, 4, 8, 8),
                                               2 * t(g, 1, 5, 5, 2, dtype=f32) - 1,
                                               align_corners=True),
        "addcmul": lambda g: torch.addcmul(t(g, 4, 8), t(g, 4, 8, dtype=f32), t(g, 4, 8)),
        "atan2": lambda g: torch.atan2(t(g, 4, 8), t(g, 4, 8, dtype=f32)),
        "batch_norm": lambda g: F.batch_norm(t(g, 2, 4, 8, 8), t(g, 4, dtype=f32),
                                             t(g, 4, dtype=f32) + 0.5, t(g, 4, dtype=f32),
                                             t(g, 4, dtype=f32)),
    }


def policy_mismatches(device) -> dict:
    """Each case of :func:`_cases` under ``torch.autocast`` and under the
    policy, both unmapped, on ``device``: ``{name: (autocast's dtype, the
    policy's dtype, max |difference|)}`` for those that differ in dtype or
    value (an error is reported as the dtype). Empty when the policy's lists
    are the device's autocast lists for these ops."""
    device = torch.device(device)
    out = {}
    for name, fn in _cases(device).items():
        got = []
        for ctx in (torch.autocast(device.type, dtype=torch.bfloat16),
                    _AutocastPolicy(device.type)):
            try:
                with torch.no_grad(), ctx:
                    got.append(fn(torch.Generator(device=device).manual_seed(0)))
            except RuntimeError as e:
                got.append(f"error: {e}"[:80])
        a, b = got
        if isinstance(a, str) or isinstance(b, str) or a.dtype != b.dtype:
            out[name] = (getattr(a, "dtype", a), getattr(b, "dtype", b), None)
        elif not torch.equal(a, b):
            out[name] = (a.dtype, b.dtype, float((a.float() - b.float()).abs().max()))
    return out
