"""High-level user API: init_detector / Predictor / inference_detector.

Counterpart of `semi_detr_tpu/api.py` (reference
`detr_ssod/apis/inference.py:11-82`): `init_detector` builds the detector
from a config file of the repo's `configs/` and loads a checkpoint;
`Predictor` runs the test pipeline on one image on the teacher's weights.
Everything runs on `device`, which defaults to the card.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

WARM_UP_STEP = 60000      # SSOD default (semi_detr_tpu SsodConfig)


def init_detector(config: str, checkpoint: Optional[str] = None,
                  device="cuda", use_nms: Optional[bool] = None,
                  seed: int = 0, cfg_options: Optional[dict] = None
                  ) -> "Predictor":
    """Build the detector and load its weights. Returns a `Predictor`.

    checkpoint: a reference-layout `.pth` (plain detector or SSOD wrapper;
      the teacher is loaded), a checkpoint file or directory of this
      package (its teacher), or None for a seeded init with the JAX
      package's initializers.
    use_nms: decode mode; None picks NMS while a checkpoint's step (this
      package's saved step, or parsed from an "iter_XXXX" file name) is
      below the SSOD warm-up step, as the reference's tools/test.py does,
      and top-k otherwise.
    """
    from .data.coco import COCO_CLASSES, VOC_CLASSES
    from .models.dino_head import DinoConfig, DINODetector
    from .train.checkpoint import load_warm_start
    from .utils.config import load_config

    cfg = load_config(config, cfg_options)
    m = dict(cfg["model"])
    m.pop("type", None)
    dcfg = DinoConfig(**m)
    warm_up = int(cfg.get("ssod", {}).get("warm_up_step", WARM_UP_STEP))

    detector = DINODetector(dcfg)
    step = warm_up
    if checkpoint is None:
        detector.init_weights(seed)
    elif checkpoint.endswith((".pth", ".pt")) or os.path.isdir(checkpoint):
        loaded = load_warm_start(checkpoint)
        # keys the port has no module for (wrapper aliases) are ignored,
        # as the JAX package's converter ignores them; a missing one raises
        missing, _ = detector.load_state_dict(
            loaded["teacher"] or loaded["student"], strict=False)
        if missing:
            raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. "
                           f"{missing[:3]}")
        it = re.search(r"iter_(\d+)", os.path.basename(checkpoint))
        step = (int(loaded["step"]) if "step" in loaded
                else int(it.group(1)) if it else warm_up)
    else:
        raise ValueError(f"unsupported checkpoint {checkpoint!r}: the port "
                         "reads reference-layout .pth files and its own "
                         "checkpoints")
    detector.to(device).eval()
    if use_nms is None:
        use_nms = step < warm_up
    names = (VOC_CLASSES if cfg.get("data", {}).get("classes") == "voc"
             else COCO_CLASSES)
    return Predictor(detector, names, use_nms)


class Predictor:
    """Single-image inference, top-k or NMS decode."""

    def __init__(self, detector, class_names, use_nms: bool = False):
        from .models.inference import make_predict_fn
        self.detector = detector
        self.class_names = class_names
        self.use_nms = use_nms
        # forward and decode on the device: (boxes, scores, labels)
        self.predict = make_predict_fn(detector, use_nms=use_nms)

    @property
    def device(self):
        return next(self.detector.parameters()).device

    def __call__(self, image: np.ndarray, score_thr: float = 0.3,
                 bucket: Tuple[int, int] = (800, 1344),
                 test_scale: Optional[Tuple[int, int]] = None):
        """image: (H, W, 3) uint8 RGB. Returns numpy (boxes xyxy in
        original image coords, scores, labels) above score_thr."""
        images, img_hw, scale_factor = self.preprocess(image, bucket,
                                                       test_scale)
        return self.postprocess(self.predict(images, img_hw), scale_factor,
                                score_thr)

    def preprocess(self, image: np.ndarray,
                   bucket: Tuple[int, int] = (800, 1344),
                   test_scale: Optional[Tuple[int, int]] = None):
        """Test resize and pack on the host, then copy to the device.
        Returns (images (1, H, W, 3) uint8, img_hw (1, 2), scale_factor)."""
        from .data.augment import TEST_SCALE, make_sample, test_resize
        from .data.pipeline import pack

        s = test_resize(make_sample(image), test_scale or TEST_SCALE)
        # orient the bucket like the image: a portrait image resizes taller
        # than the landscape bucket
        h, w = s.img.shape[:2]
        bh, bw = bucket
        land = (bh, bw) if bw >= bh else (bw, bh)
        bucket = land if w >= h else (land[1], land[0])
        p = pack(s, bucket, 1)
        dev = self.device
        return (torch.from_numpy(p.image[None]).to(dev),
                torch.from_numpy(p.hw[None]).to(dev), p.scale_factor)

    @staticmethod
    def postprocess(dets, scale_factor, score_thr: float = 0.3):
        """Copy one image's detections to the host, keep scores above
        score_thr and map the boxes back to original image coords."""
        boxes, scores, labels = (t[0].cpu().numpy() for t in dets)
        keep = scores > score_thr
        return (boxes[keep] / np.tile(scale_factor, 2), scores[keep],
                labels[keep])


def inference_detector(predictor: Predictor, image, **kw):
    return predictor(image, **kw)


def save_result(image: np.ndarray, result, class_names, out_file: str,
                score_thr: float = 0.3):
    """Render detections onto the image and save it (reference
    save_result), to the JAX `save_result`'s pixels: box by box, each box
    at or above score_thr outlined in green 2 pixels thick
    (`utils.logging.draw_rect`, cv2.rectangle's pixels), then
    `f"{class_names[label]}:{score:.2f}"` at (x0, max(y0 - 4, 0)) as
    cv2.putText draws it (`utils.text`). The file is encoded by its
    extension as cv2.imwrite encodes it (`data.image_io.write_image`; an
    .avif at cv2's defaults, which write what its AVIF quality 50 writes);
    where cv2 writes nothing (.pgm and .pbm take no colour image) nothing
    is written and the path is still returned, as the JAX function's
    is."""
    from .data.image_io import write_image
    from .utils.logging import draw_detection
    boxes, scores, labels = result
    img = np.array(image, np.uint8)
    for b, s, l in zip(boxes, scores, labels):
        if s < score_thr:
            continue
        draw_detection(img, b, f"{class_names[int(l)]}:{s:.2f}")
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    write_image(out_file, img)
    return out_file
