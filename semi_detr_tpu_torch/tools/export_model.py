"""Export the detector's serving program with `torch.export`.

Counterpart of `tools/misc/export_model.py` (the JAX package exports the
jitted predict function to StableHLO). Here `models.inference.
ServingProgram` (the teacher's forward and decode, top-k or NMS) is
traced by `torch.export.export` at a fixed batch and bucket, with the
weights inside the program, and written with `torch.export.save` to a
`.pt2` file. The inputs are (images (B, H, W, 3) uint8, as
`api.Predictor.preprocess` packs them; img_hw (B, 2) int32). MSDA is in
the program as the operator `semi_detr::ms_deform_attn`, and the NMS
fixpoint as a `while_loop`.

Unlike a StableHLO file, the `.pt2` file needs torch and this package's
operator registry to run: importing `semi_detr_tpu_torch.ops.
ms_deform_attn_cuda` registers the operators (this tool does), and
`torch.export.load` then runs the program on the device it was exported
for.

Usage:
  python -m semi_detr_tpu_torch.tools.export_model CONFIG \\
      [--checkpoint CKPT] --out model.pt2 [--batch 1] [--bucket 800,1344] \\
      [--with-nms] [--device cuda] [--selftest]
  python -m semi_detr_tpu_torch.tools.export_model CONFIG --load model.pt2 \\
      --selftest           # load and run on zero images, print shapes

CKPT is a checkpoint file or directory of this package, or a reference
`.pth`; without one the detector takes the seeded init. The teacher is
exported: serving runs the teacher (reference `tools/test.py:195-200`).
"""
from __future__ import annotations

import os
import time

import torch

from ..models.inference import ServingProgram
from ..ops import ms_deform_attn_cuda  # noqa: F401  registers the MSDA ops
from ..utils.config import parse_cfg_options
from .common import base_parser, load_cfg


def example_inputs(batch: int, bucket, device):
    """Zero images (batch, H, W, 3) uint8 and their full extent."""
    h, w = bucket
    return (torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=device),
            torch.tensor([[h, w]] * batch, dtype=torch.int32, device=device))


def build_teacher(args):
    """The detector of the CLI's config with the teacher's weights of
    --checkpoint (or the seeded init), in eval mode on --device."""
    from ..api import init_detector
    cfg = load_cfg(args)
    return init_detector(args.config, args.checkpoint, args.device,
                         seed=cfg.get("seed", 0),
                         cfg_options=parse_cfg_options(
                             args.cfg_options)).detector


def export_program(detector, batch: int, bucket, use_nms: bool = False):
    """`ServingProgram(detector)` traced by `torch.export` at (batch,
    bucket) on the detector's device."""
    device = next(detector.parameters()).device
    with torch.no_grad():
        return torch.export.export(
            ServingProgram(detector, use_nms).eval(),
            example_inputs(batch, bucket, device))


def load_program(path: str):
    """The saved program as a callable module: (images, img_hw) ->
    (boxes, scores, labels). Call it under `torch.inference_mode()`."""
    return torch.export.load(path).module()


def selftest(program, batch: int, bucket, device):
    with torch.inference_mode():
        boxes, scores, labels = program(*example_inputs(batch, bucket,
                                                        device))
    print("selftest ok:", tuple(boxes.shape), tuple(scores.shape),
          tuple(labels.shape), flush=True)
    return boxes, scores, labels


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file or directory of this package, or "
                        "a reference .pth; omitted = the seeded init")
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--load", default=None,
                   help="load an existing artifact instead of exporting")
    p.add_argument("--selftest", action="store_true",
                   help="run the program on zero images")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--bucket", default="800,1344")
    p.add_argument("--with-nms", action="store_true",
                   help="the NMS decode (warm-up-stage semantics); default "
                        "is the main-stage top-k decode")
    args = p.parse_args(argv)
    bucket = tuple(int(v) for v in args.bucket.split(","))

    if args.load:
        t0 = time.perf_counter()
        program = load_program(args.load)
        print(f"loaded {args.load} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        if args.selftest:
            selftest(program, args.batch, bucket, args.device)
        return program

    det = build_teacher(args)
    t0 = time.perf_counter()
    exported = export_program(det, args.batch, bucket, args.with_nms)
    torch.export.save(exported, args.out)
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB in "
          f"{time.perf_counter() - t0:.1f} s, batch {args.batch}, bucket "
          f"{bucket}, {'NMS' if args.with_nms else 'top-k'} decode, "
          f"device {args.device}", flush=True)
    if args.selftest:
        selftest(exported.module(), args.batch, bucket, args.device)
    return exported


if __name__ == "__main__":
    main()
