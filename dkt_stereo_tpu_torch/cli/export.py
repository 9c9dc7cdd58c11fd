"""Export a port checkpoint to the reference's torch ``.pth`` format
(``dkt_stereo_tpu/cli/export.py``), so a model fine-tuned with the port
loads strictly into the reference's own tools
(tools/evaluate_stereo.py:366-371) and into the JAX package
(``import_reference_pth``):

  python -m dkt_stereo_tpu_torch.cli.export --restore_ckpt runs/booster/step_2000 \\
      --template ref_sceneflow.pth --out dkt_ft_booster.pth --which ema

``--restore_ckpt`` is a ``step_N`` directory of ``cli.train``; ``--which``
picks its student, EMA or teacher weights. ``--template`` is the reference
``.pth`` whose key set defines the output (normally the checkpoint the
fine-tune started from): the checkpoint's key set must equal it and every
shape and dtype must match. The template's ``state_dict`` nesting, its other
entries and its ``module.`` prefixes are kept. Its tensors pass through
verbatim where the port holds no state of its own, as the JAX package's
``export_reference_pth`` passes them (train/checkpoint.py:382-415): the
``num_batches_tracked`` counters (the port's batch norms are frozen), the
batch norms the reference creates and never runs (``conv1_up.bn``) and
CGI-Stereo's never-run ``feature.deconv32_16`` (a CGI state is told apart
by its ``feature_up``; IGEV's ``feature.deconv32_16`` runs).
"""

from __future__ import annotations

import argparse
import re

import torch

from dkt_stereo_tpu_torch.train.checkpoint import restore_variables

_PASS_THROUGH = re.compile(r"num_batches_tracked$|(^|\.)conv1_up\.bn\.")
_CGI_UNUSED = re.compile(r"^feature\.deconv32_16\.")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--restore_ckpt", required=True, help="a port checkpoint (step_N directory)")
    p.add_argument("--template", required=True, help="reference-format .pth supplying the key set")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--which", choices=["student", "ema", "teacher"], default="student",
                   help="which weights of the checkpoint to export")
    return p.parse_args(argv)


def export_reference_pth(state: dict, template, path) -> dict:
    """Save ``state`` (a port state dict) to ``path`` in the key set and
    layout of the reference ``.pth`` at ``template``; returns what it
    saved."""
    tmpl = torch.load(template, map_location="cpu", weights_only=True)
    inner = tmpl["state_dict"] if "state_dict" in tmpl else tmpl
    bare = {k.removeprefix("module."): k for k in inner}
    if set(bare) != set(state):
        raise ValueError(
            f"the checkpoint's keys differ from the template's: only in the checkpoint "
            f"{sorted(set(state) - set(bare))[:10]}, only in the template "
            f"{sorted(set(bare) - set(state))[:10]}")
    cgi = any(k.startswith("feature_up.") for k in state)
    out = {}
    for name, key in bare.items():
        want, value = inner[key], state[name]
        if value.shape != want.shape or value.dtype != want.dtype:
            raise ValueError(f"{key}: checkpoint {tuple(value.shape)} {value.dtype} != template "
                             f"{tuple(want.shape)} {want.dtype}")
        keep = _PASS_THROUGH.search(name) or (cgi and _CGI_UNUSED.search(name))
        out[key] = want if keep else value.detach().cpu().clone()
    full = {**tmpl, "state_dict": out} if "state_dict" in tmpl else out
    torch.save(full, path)
    return full


def main(argv=None):
    args = parse_args(argv)
    if args.restore_ckpt.endswith(".pth"):
        raise SystemExit("--restore_ckpt must be a port checkpoint (a .pth is already in the "
                         "reference format)")
    full = export_reference_pth(restore_variables(args.restore_ckpt, args.which),
                                args.template, args.out)
    print(f"wrote {args.out}: {len(full.get('state_dict', full))} tensors ({args.which})")
    return args.out


if __name__ == "__main__":
    main()
