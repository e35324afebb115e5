"""Files of the uncompressed formats the JAX loader hands to cv2 (Sun
raster, PAM, PFM), written from an RGB picture so that `cv2.imread(path,
IMREAD_COLOR)` reads them back to that picture exactly: `chip_smoke.py`
phase 7a times the host decoders on them at 480x640 without committing
files of their raw size, and holds each decode to the picture it was
written from (a committed cv2 reference). `tests/test_torch_raster_pam.py`
holds each to cv2.imread on the CPU.

* Sun raster, standard type, 24 bits: B, G, R per pixel, rows padded to
  16 bits.
* PAM, TUPLTYPE RGB, maxval 255: cv2 copies the samples into its BGR
  picture unswapped, so they are written B, G, R for the picture to read
  back as R, G, B.
* PFM, little-endian (scale -1): the picture's values as float32, rows
  bottom-up; cv2 rounds them back to the same bytes.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np


def raw_format_files(rgb: np.ndarray) -> Dict[str, Tuple[bytes, str, str]]:
    """{file name: (bytes, format, variant)} of the picture (h, w, 3)
    uint8, each read by cv2 to exactly `rgb`."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    bgr = rgb[..., ::-1]
    rows = bgr.reshape(h, 3 * w)
    if (3 * w) % 2:
        rows = np.concatenate([rows, np.zeros((h, 1), np.uint8)], 1)
    ras = struct.pack(">8I", 0x59A66A95, w, h, 24, rows.size, 1, 0, 0) + \
        rows.tobytes()
    pam = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\n"
           f"TUPLTYPE RGB\nENDHDR\n").encode() + bgr.tobytes()
    pfm = f"PF\n{w} {h}\n-1.0\n".encode() + \
        rgb[::-1].astype("<f4").tobytes()
    return {f"ras_{h}x{w}.ras": (ras, "Sun raster", f"24-bit at {h}x{w}"),
            f"pam_{h}x{w}.pam": (pam, "PAM", f"RGB at {h}x{w}"),
            f"pfm_{h}x{w}.pfm": (pfm, "PFM", f"float RGB at {h}x{w}")}
