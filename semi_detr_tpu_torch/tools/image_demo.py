"""Image inference and rendering over a glob of image files (the twin of
demo/image_demo.py, the reference's demo/image_demo.py).

Rides the high-level API (`init_detector` -> `inference_detector` ->
`save_result`): every file is read by the host library (JPEG, PNG, BMP,
PNM, PAM, TIFF, WebP, GIF, Sun raster, PFM, HDR, JPEG 2000:
`data.image_io.read_image`), served by the `Predictor` on the card (or
`--device cpu`), and written under its own name into `--output-dir` with
the JAX demo's render (green box outlines and `class:score` labels, to
cv2's pixels), encoded by its extension as cv2.imwrite encodes it
(`data.image_io.write_image`): a BMP, PNM, TIFF, WebP, PFM, Sun raster,
PAM, HDR, GIF or JPEG 2000 (.jp2) input gives a file of its own format
(cv2's bytes for all but WebP; a .jp2 below 32 pixels on a side is cv2's
77-byte file, as cv2 refuses it), and a .pgm or .pbm one gives none, as
cv2 refuses to write a colour image there.

    python -m semi_detr_tpu_torch.tools.image_demo "images/*.jpg" CONFIG \
        --checkpoint CKPT.pth --output-dir viz/
"""
from __future__ import annotations

import argparse
import glob
import os

from ..api import inference_detector, init_detector, save_result
from ..data.image_io import read_image
from ..utils.config import parse_cfg_options


def output_path(path: str, output_dir: str) -> str:
    """Where the render of `path` goes: its own name under `output_dir`,
    as the JAX demo writes it (`os.path.basename`)."""
    return os.path.join(output_dir, os.path.basename(path))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("images", help="image path or glob")
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True,
                   help="reference-layout .pth (detector or SSOD wrapper)")
    p.add_argument("--output-dir", default="demo_out")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    args = p.parse_args(argv)

    predictor = init_detector(args.config, args.checkpoint,
                              device=args.device,
                              cfg_options=parse_cfg_options(args.cfg_options))
    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for path in sorted(glob.glob(args.images)):
        img = read_image(path)
        result = inference_detector(predictor, img, score_thr=args.score_thr)
        dst = output_path(path, args.output_dir)
        save_result(img, result, predictor.class_names, dst,
                    score_thr=args.score_thr)
        print(f"{path} -> {dst} ({len(result[1])} dets)")
        written.append(dst)
    return written


if __name__ == "__main__":
    main()
