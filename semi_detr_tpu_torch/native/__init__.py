"""The port's host library: image decode and encode, resize, affine warp,
the colour ops' pixel loops and a threaded prefetch loader, in C++.

Counterpart of `semi_detr_tpu/native/` (`dataloader.cpp`), plus the pixel
work the JAX package leaves to cv2 and Pillow. The sources beside this
file are compiled by g++ at first use (`-O3 -shared -fPIC -std=c++17
-ffp-contract=off`, no `-march`, no `-ffast-math`) into
`semi_detr_tpu_torch/_build/<hash of sources and flags>/` and bound with
`ctypes.CDLL`, which releases the GIL for every call: a prefetch thread
decoding and augmenting no longer holds up the thread that launches the
step.

* Decode, by signature: PNG at every bit depth and colour type,
  non-interlaced or Adam7, as libpng gives it to the JAX package's loader
  (`host.cpp`, by zlib's inflate and the row filters in C++). The files
  the JAX loader hands to cv2, to `cv2.imread(path, IMREAD_COLOR)`'s
  pixels (BGR turned to RGB) bit for bit, by decoders of the library's own
  (g++ and zlib; no libtiff, libwebp, giflib or second libjpeg): BMP, PNM
  and PAM (`bmp_pnm_host.cpp`: OpenCV's BmpDecoder, PxMDecoder and
  PAMDecoder, quirks included), TIFF (`tiff_host.cpp` with
  `ccitt_host.cpp` and `sgilog_host.cpp`: libtiff's RGBA reader over
  strips and tiles, classic and BigTIFF, none / PackBits / LZW / Deflate /
  CCITT modified Huffman, Group 3 and Group 4 / JPEG / ThunderScan /
  SGILog (LogL, LogLuv 32 and 24, the uv grid of `sgilog_tables.h`),
  predictor 2 (on YCbCr data units too), 1-16 bits, signed samples, CMYK
  (inside JPEG too), YCbCr, CIELab, orientation 1-8 (5-8 on a square
  picture), StripByteCounts estimated anew where libtiff estimates them:
  every TIFF cv2 reads), WebP (`webp_host.cpp` and the RFC 6386
  tables of `webp_tables.h`: VP8L, VP8 key frames with libwebp's loop
  filters and fancy upsampling, an animation's first frame, EXIF
  orientation), GIF (`gif_host.cpp`: the first frame on the logical
  screen), Sun raster (`raster_host.cpp`), PFM and Radiance HDR
  (`float_host.cpp`: float pixels rounded to 8 bits as Mat::convertTo
  rounds them), JPEG 2000 (`j2k_host.cpp`: JP2, JPH and raw codestreams
  as OpenJPEG 2.5 decodes them for cv2, the 9/7 wavelet in its float32
  order; high-throughput code-blocks in `j2k_ht_host.cpp` with the VLC
  tables of `j2k_ht_tables.h`), lossless JPEG of at most 8 bits in RGB
  or CMYK (`jpeg_host.cpp`) and AVIF (`avif_host.cpp`: the ISOBMFF boxes
  libavif reads for a still image, grids; the primary item's AV1 key frame
  by the decoder of `av1_obu.cpp`, `av1_entropy.cpp`, `av1_intra.cpp`,
  `av1_recon.cpp`, `av1_transform.cpp`, `av1_loopfilter.cpp`,
  `av1_cdef.cpp` and `av1_restoration.cpp` with the tables of
  `av1_tables.h`: lossless and lossy frames at 8, 10 and 12 bits, 4:4:4,
  4:2:2, 4:2:0 or monochrome, of one tile or several, as cv2.imwrite
  writes them at any quality, speed, depth and size and as other writers
  such as Pillow write them, turned to RGB as cv2's libavif turns YUV with
  libyuv: BT.601, BT.709, BT.2020 and the matrices libavif maps to them,
  full or limited range; `avif_tools()` counts the coding tools it
  decoded, `avif_planes()` gives the planes of each in-loop filter
  stage). What cv2 reads and the port does not (AV1 segmentation, film
  grain, superres, delta loop filter levels, the matrices libavif
  converts without libyuv) raises naming it and "not ported";
  what cv2 refuses too (12-bit JPEG, 16-bit or gray lossless JPEG, TIFF
  orientation 5-8 on a picture that is not square, the TIFF compressions
  cv2's libtiff is built without: LZMA, ZSTD, WebP, old-style JPEG; float
  samples, predictor 3 on integer samples, photometric 4, 9, 10, 32803 and
  34892, LogL or LogLuv without SGILog; RLE Sun raster, a one-channel PFM;
  signed, sub-sampled or offset JPEG 2000 components) raises saying so. JPEG by the library's own
  decoders (`jpeg_host.cpp`), on either build: every stream of 8 bits
  that libjpeg-turbo 2.1 decodes, sequential or progressive, Huffman or
  arithmetic, with libjpeg's block smoothing of an incomplete progressive
  script, every integer sampling layout, gray, YCbCr and RGB, to the
  pixels of `semi_detr_tpu.native.decode_image` bit for bit; CMYK and
  YCCK (which libjpeg gives no RGB for) to the pixels of the JAX loader's
  fallback, `cv2.imread` (libjpeg-turbo 3.1's smoothing included). `jpeg_host_kind`, `jpeg_colour` and
  `decoders()` name each kind's route. The back end decodes only the rest
  (streams neither the host decoders nor cv2 read; it refuses them too):
  libjpeg where the machine
  has it (`jpeg_libjpeg.cpp`), else the CUDA toolkit's nvJPEG
  (`jpeg_nvjpeg.cpp`), after `jpeg_check` has walked the stream (nvJPEG
  decodes damaged data without complaint). A damaged stream (truncated, a
  bad Huffman or arithmetic code, a restart marker out of order, a bogus
  progression, a bad PNG CRC or filter) raises `ImageDecodeError` naming
  the fault on both builds; it never comes back blank and a failed host
  decode never goes on to the back end. (JPEG has no checksum: damage
  that still decodes to valid codes is not seen.)
* Encode: JPEG through the same back end (4:2:0 at quality 95, cv2's
  default); on the nvJPEG route libjpeg's colour conversion and
  downsampling run here (`rgb_to_ycc420`) and the card does the rest.
  TIFF (cv2.imwrite's tags: LZW, predictor 2) and lossless WebP (VP8L) by
  the library's own encoders (`encode_host.cpp`), which read back to the
  same pixels by cv2 and by the decoders here; GIF (cv2's 3-3-2 table and
  Floyd-Steinberg dithering) and Radiance HDR (RGBE, run-length
  scanlines) there too, cv2's bytes. AVIF as cv2.imwrite writes it with
  no parameters (what its quality 50 writes: 4:2:0 at base_q_idx 148 with
  cv2's chroma delta q, quantizer matrices, deblocking and CDEF;
  `av1_encode.cpp`, `avif_encode_host.cpp`): cv2's boxes, sequence
  header and tile layout (several tiles above 4096 wide or 2304
  superblocks), tiles of the library's own (modes by SATD, partitions by
  rate and distortion) written through the AV1 decoder's own syntax, which
  cv2 reads to the decoder's pixels.
* Pixels: `resize_bilinear` (half-pixel centres, the formula of the JAX
  package's `sdt_resize_bilinear`), `warp_affine`, and the colour ops'
  `histogram`, `apply_lut`, `gray`, `blend`, `smooth`, `solarize`,
  `posterize`. Each equals its numpy plain version
  (`data.augment.NumpyPixels`) bit for bit: the same float32 operations in
  the same order, none fused.
* `PrefetchLoader`: read, decode and resize in a pool of C++ threads.

The JAX library's `sdt_normalize_pad` is left out: the port's `pack`
ships uint8 and the model normalizes on the device, as the JAX package's
default `_DEVICE_NORMALIZE` path does.

Nothing falls back: a build or link failure raises with the compiler's
log. The random draws of the augmentations stay in Python; this library
does only pixels.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from collections import namedtuple
from typing import Dict, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_DIR)
FIXTURES = os.path.join(_DIR, "fixtures")
SOURCES = ("host.cpp", "jpeg_host.cpp", "bmp_pnm_host.cpp", "tiff_host.cpp",
           "ccitt_host.cpp", "sgilog_host.cpp", "webp_host.cpp",
           "gif_host.cpp", "raster_host.cpp", "float_host.cpp", "j2k_host.cpp",
           "j2k_ht_host.cpp", "encode_host.cpp", "j2k_encode_host.cpp",
           "avif_host.cpp", "av1_obu.cpp", "av1_entropy.cpp", "av1_intra.cpp",
           "av1_recon.cpp", "av1_transform.cpp", "av1_loopfilter.cpp",
           "av1_cdef.cpp", "av1_restoration.cpp", "av1_encode.cpp",
           "avif_encode_host.cpp")
HEADERS = ("host.h", "webp_tables.h", "j2k_tables.h", "sgilog_tables.h",
           "j2k_ht_tables.h", "av1.h", "av1_state.h", "av1_tables.h")
JPEG_SOURCES = {"libjpeg": "jpeg_libjpeg.cpp", "nvjpeg": "jpeg_nvjpeg.cpp"}
# the host decoders' routes, by jpeg_host_kind's answer, on either build
HOST_KINDS = {0: None, 1: "sequential", 2: "progressive",
              3: "sequential arithmetic", 4: "progressive arithmetic",
              5: "lossless"}
ROUTES = {"sequential": "host sequential Huffman (libjpeg jdhuff + islow)",
          "progressive": "host progressive Huffman (libjpeg jdphuff + "
                         "smoothing + islow)",
          "sequential arithmetic": "host sequential arithmetic (libjpeg "
                                   "jdarith + islow)",
          "progressive arithmetic": "host progressive arithmetic (libjpeg "
                                    "jdarith + smoothing + islow)",
          "lossless": "host lossless (libjpeg-turbo 3 jdlhuff + jddiffct; "
                      "RGB of 2-8 bits, as cv2 5.0 reads it)"}
# the other formats cv2 reads for the JAX loader, each decoded by the
# library itself to cv2's pixels
FORMAT_ROUTES = {
    "bmp": "host BMP (1-32 bits, RLE4 / RLE8 / bit fields; OpenCV's "
           "BmpDecoder)",
    "pnm": "host PNM (P1-P6, maxval 1-65535; OpenCV's PxMDecoder)",
    "pam": "host PAM (P7, depth 1-4, maxval 1-65535; OpenCV's PAMDecoder, "
           "its quirks included)",
    "tiff": "host TIFF (classic and BigTIFF, strips and tiles, planar 1 and "
            "2, none / PackBits / LZW / Deflate / CCITT modified Huffman, "
            "Group 3 and Group 4 / JPEG / ThunderScan / SGILog, predictor 2, "
            "1-16 bits, signed samples, CMYK, YCbCr, CIELab, orientation "
            "1-8; libtiff's RGBA reader; Pixar, NeXT and JPEG 2000 "
            "compression as the picture of zero samples)",
    "gif": "host GIF (the first frame on the logical screen, LZW; OpenCV's "
           "GifDecoder)",
    "sun_raster": "host Sun raster (types 0 and 1, 1-32 bits, colour maps; "
                  "OpenCV's SunRasterDecoder)",
    "pfm": "host PFM (float samples scaled by 1 / |scale|, rounded as "
           "Mat::convertTo; OpenCV's PFMDecoder)",
    "hdr": "host Radiance HDR (run-length and flat RGBE scanlines, times "
           "255 and rounded as Mat::convertTo; OpenCV's rgbe.cpp)",
    "jpeg2000": "host JPEG 2000 (JP2 and JPH boxes and raw codestreams; "
                "tier-2 with every progression and POC, PPM / PPT, SOP / "
                "EPH; tier-1 under every code-block style, and the high-"
                "throughput block coder of Part 15 (cleanup, SigProp, "
                "MagRef); 5/3 and 9/7 wavelets, RCT / ICT; palettes and "
                "channel definitions; OpenJPEG 2.5's decode as cv2 reads "
                "it)",
    "webp": "host WebP (VP8L lossless, VP8 lossy key frames with libwebp's "
            "fancy upsampling, the first frame of an animation, EXIF "
            "orientation)",
    "avif": "host AVIF (ISOBMFF items in mdat or idat, grids; AV1 key "
            "frames at 8, 10 and 12 bits, 4:4:4, 4:2:2, 4:2:0 or "
            "monochrome, of one tile or several: lossless (every intra "
            "predictor, palette, intra block copy, the 4x4 Walsh-Hadamard "
            "transform) and lossy (the quantizer with its matrices and "
            "delta q, every transform size and intra type, deblocking, "
            "CDEF, loop restoration); libavif's RGB as cv2 reads it, "
            "BT.601, BT.709 and BT.2020 at full or limited range through "
            "libyuv's constants and chroma filters)"}
# the colour handling of the host decoders
COLOURS = ("gray, YCbCr (libjpeg jdcolor), RGB (none), CMYK and YCCK "
           "(cv2.imread's conversion and EXIF orientation); every sampling "
           "layout of integer ratios (libjpeg jdsample)")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off",
             "-pthread")
# larger images are refused before any pixel buffer is allocated
MAX_PIXELS = 8192 * 8192
_STATUS = {1: "unknown format", 2: "damaged data", 3: "unsupported kind",
           4: "too large", 6: "size mismatch", 7: "device error",
           10: "cannot open", 11: "cannot read"}


class ImageDecodeError(ValueError):
    """An image file or stream that the library cannot decode."""


class EncodeRefused(ValueError):
    """A picture an encoder refuses as cv2.imwrite refuses it (returning
    False): `reason` is cv2's message, `partial` the bytes cv2 leaves in
    the file all the same."""

    def __init__(self, reason: str, partial: bytes):
        super().__init__(reason)
        self.reason, self.partial = reason, partial


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def _compiles(header: str, *flags: str) -> bool:
    src = f"#include <cstddef>\n#include <cstdio>\n#include <{header}>\n"
    try:
        return subprocess.run(
            ["g++", "-std=c++17", "-fsyntax-only", "-x", "c++", "-", *flags],
            input=src, capture_output=True, text=True,
            timeout=120).returncode == 0
    except FileNotFoundError:
        raise RuntimeError("g++ not found: the host library is compiled "
                           "with g++ at first use") from None


@functools.lru_cache(maxsize=None)
def probe() -> Dict[str, object]:
    """What the machine offers the library: the compiler, the CPU
    architecture, and which headers compile (zlib; libjpeg; the CUDA
    toolkit's nvJPEG). `route` is the JPEG back end the build takes:
    libjpeg where it compiles, else nvJPEG, else None (no build)."""
    out = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout if shutil.which("g++") else ""
    cuda_inc = os.path.join(_cuda_home(), "include")
    found = {
        "gxx": out.splitlines()[0] if out else None,
        "machine": platform.machine(),
        "zlib": bool(out) and _compiles("zlib.h"),
        "libjpeg": bool(out) and _compiles("jpeglib.h"),
        "nvjpeg": bool(out) and os.path.isfile(
            os.path.join(cuda_inc, "nvjpeg.h")) and _compiles(
                "nvjpeg.h", f"-I{cuda_inc}"),
    }
    found["route"] = ("libjpeg" if found["libjpeg"] else
                      "nvjpeg" if found["nvjpeg"] else None)
    return found


def _build_plan() -> Tuple[list, list, str]:
    """(sources, compiler and linker flags, library path) of this
    machine's build."""
    found = probe()
    if not found["gxx"]:
        raise RuntimeError("g++ not found: the host library is compiled "
                           "with g++ at first use")
    if not found["zlib"]:
        raise RuntimeError("zlib.h does not compile: the host library needs "
                           "zlib to decode PNG")
    route = found["route"]
    if route is None:
        raise RuntimeError("neither libjpeg (jpeglib.h) nor the CUDA "
                           "toolkit's nvJPEG (nvjpeg.h) found: the host "
                           "library needs one to read and write JPEG")
    sources = [os.path.join(_DIR, s)
               for s in SOURCES + (JPEG_SOURCES[route],)]
    flags, libs = list(CXX_FLAGS), ["-lz"]
    if route == "libjpeg":
        libs.append("-ljpeg")
    elif route == "nvjpeg":
        cuda = _cuda_home()
        lib_dir = os.path.join(cuda, "lib64")
        flags.append(f"-I{os.path.join(cuda, 'include')}")
        libs += [f"-L{lib_dir}", f"-Wl,-rpath,{lib_dir}", "-lnvjpeg",
                 "-lcudart_static", "-ldl", "-lrt"]
    h = hashlib.sha256(" ".join(flags + libs).encode())
    for path in sources + [os.path.join(_DIR, s) for s in HEADERS]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    out = os.path.join(_PKG, "_build", h.hexdigest()[:16], "libsdt_host.so")
    return sources, flags + libs, out


def build() -> Tuple[str, str]:
    """Compile the library if it is missing. Returns (library path, g++'s
    log; empty when the library existed). Builders in other processes wait
    on a file lock; the library is written under a temporary name and
    renamed into place."""
    sources, flags, out = _build_plan()
    if os.path.exists(out):
        return out, ""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out, ""
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
        os.close(fd)
        cmd = ["g++", *sources, "-o", tmp, *flags]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed to build the host library:\n{log}")
        os.replace(tmp, out)
    return out, log


_P = ctypes.c_void_p
_I, _L, _F = ctypes.c_int, ctypes.c_long, ctypes.c_float
_SIGNATURES = {
    "sdt_last_error": ([], ctypes.c_char_p),
    "sdt_jpeg_backend": ([], ctypes.c_char_p),
    "sdt_image_info": ([_P, _L, _P, _P], _I),
    "sdt_decode": ([_P, _L, _P, _I, _I], _I),
    "sdt_png_unfilter": ([_P, _I, _L, _I, _P], _I),
    "sdt_encode_jpeg": ([_P, _I, _I, _P, _P], _I),
    "sdt_encode_tiff": ([_P, _I, _I, _P, _P], _I),
    "sdt_encode_webp": ([_P, _I, _I, _P, _P], _I),
    "sdt_encode_gif": ([_P, _I, _I, _P, _P], _I),
    "sdt_encode_hdr": ([_P, _I, _I, _P, _P], _I),
    "sdt_encode_jp2": ([_P, _I, _I, _P, _P], _I),
    "sdt_encode_avif": ([_P, _I, _I, _P, _P, _P], _I),
    "sdt_av1_symbols": ([_P, _P, _P, _I, _P, _L, _P, _P], _I),
    "sdt_free": ([_P], None),
    "sdt_jpeg_check": ([_P, _L], _I),
    "sdt_jpeg_host_kind": ([_P, _L], _I),
    "sdt_jpeg_host_colour": ([_P, _L], ctypes.c_char_p),
    "sdt_decode_jpeg_sequential": ([_P, _L, _P, _I, _I], _I),
    "sdt_decode_jpeg_progressive": ([_P, _L, _P, _I, _I], _I),
    "sdt_decode_jpeg_arithmetic": ([_P, _L, _P, _I, _I], _I),
    "sdt_decode_jpeg_backend": ([_P, _L, _P, _I, _I], _I),
    "sdt_rgb_to_ycc420": ([_P, _I, _I, _P, _P, _P], None),
    "sdt_ycc_to_rgb": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], None),
    "sdt_resize_bilinear": ([_P, _I, _I, _I, _P, _I, _I], None),
    "sdt_warp_affine": ([_P, _I, _I, _I, _P, _I, _P], None),
    "sdt_histogram": ([_P, _L, _I, _P], None),
    "sdt_apply_lut": ([_P, _L, _I, _P, _P], None),
    "sdt_gray": ([_P, _L, _P], None),
    "sdt_blend": ([_P, _L, _L, _P, _L, _I, _F, _P], None),
    "sdt_smooth": ([_P, _I, _I, _I, _P], None),
    "sdt_solarize": ([_P, _L, _I, _P], None),
    "sdt_posterize": ([_P, _L, _I, _P], None),
    "sdt_loader_create": ([_I, _L], _P),
    "sdt_loader_submit": ([_P, _L, ctypes.c_char_p, _I, _I], None),
    "sdt_loader_next": ([_P, _P, _P, _P, _P, _P, ctypes.c_char_p, _I], _I),
    "sdt_loader_copy": ([_P, _P], None),
    "sdt_loader_destroy": ([_P], None),
    "sdt_avif_tally": ([_P, _I], _I),
    "sdt_avif_tool_name": ([_I], ctypes.c_char_p),
    "sdt_avif_planes": ([_P, _L, _I, _P, _L, _P], _I),
}
_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    with _lock:
        lib = ctypes.CDLL(build()[0])
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def decoders() -> Dict[str, str]:
    """The decoders the library was built with: by format, `jpeg` the back
    end, and the route each kind of JPEG stream takes in `decode_image`
    (`jpeg_sequential`, `jpeg_progressive`, `jpeg_sequential_arithmetic`,
    `jpeg_progressive_arithmetic`, `jpeg_lossless`: the streams
    `jpeg_host_kind` names so, decoded by the library itself on either
    build; `jpeg_colour`: their colour handling; `jpeg_other`: the back
    end, for the rest: streams neither the host decoders nor cv2 read, such
    as hierarchical ones, which it refuses too; 12-bit and the lossless
    streams cv2 refuses are refused before it). `bmp`, `pnm`, `pam`,
    `tiff`, `webp`, `gif`, `sun_raster`, `pfm`, `hdr`: the library's own
    decoders of those formats, `jpeg2000` the JPEG 2000 one (its high-
    throughput block decoder of Part 15 too: the only route of an HTJ2K
    file, on either machine), `avif` the AVIF one (lossless and lossy
    AV1)."""
    backend = _library().sdt_jpeg_backend().decode()
    out = {"png": "zlib inflate + C++ row filters (every bit depth and "
                  "colour type, Adam7)", "jpeg": backend}
    for kind, route in ROUTES.items():
        out["jpeg_" + kind.replace(" ", "_")] = route
    out["jpeg_colour"] = COLOURS
    out["jpeg_other"] = backend
    out.update(FORMAT_ROUTES)
    return out


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _image(img: np.ndarray, what: str = "image") -> np.ndarray:
    """A C-contiguous (H, W, C) uint8 array (a copy only where needed)."""
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8 \
            or img.ndim != 3 or min(img.shape) < 1:
        raise ValueError(f"{what}: expected a non-empty (H, W, C) uint8 "
                         f"array, got {getattr(img, 'shape', None)} "
                         f"{getattr(img, 'dtype', type(img))}")
    return np.ascontiguousarray(img)


def _error(status: int, name: str, detail: str) -> ImageDecodeError:
    return ImageDecodeError(f"{name}: {detail or _STATUS.get(status, status)}")


# ---------------------------------------------------------------- decode

def image_size(buf: bytes, name: str = "<bytes>") -> Tuple[int, int]:
    """(H, W) of a stream of any format `decode_image` reads, as decoded
    (a CMYK, YCCK or lossless JPEG stream and a WebP one turned by their
    EXIF orientation, as cv2 turns them), read from its headers before any
    pixel buffer is allocated; raises ImageDecodeError naming `name` (and
    beyond MAX_PIXELS)."""
    lib = _library()
    buf = bytes(buf)
    h, w = ctypes.c_int(), ctypes.c_int()
    st = lib.sdt_image_info(buf, len(buf), ctypes.byref(h), ctypes.byref(w))
    if st:
        raise _error(st, name, lib.sdt_last_error().decode())
    if h.value * w.value > MAX_PIXELS:
        raise ImageDecodeError(f"{name}: {h.value}x{w.value} pixels, more "
                               f"than {MAX_PIXELS}")
    return h.value, w.value


def decode_image(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8 RGB, the format found by its
    signature: JPEG and PNG as the JAX package's native loader decodes
    them; BMP, PNM, PAM, TIFF, WebP, GIF, Sun raster, PFM, Radiance HDR,
    JPEG 2000, lossless JPEG and AVIF as `cv2.imread(path,
    IMREAD_COLOR)` does (`decoders()` names each route). Raises
    ImageDecodeError naming `name` (the file) on anything it cannot
    decode: damage with the fault, what cv2 refuses with "cv2 refuses it
    too", what cv2 reads and the port does not with its name and "not
    ported"."""
    buf = bytes(buf)
    h, w = image_size(buf, name)
    out = np.empty((h, w, 3), np.uint8)
    lib = _library()
    st = lib.sdt_decode(buf, len(buf), _ptr(out), h, w)
    if st:
        raise _error(st, name, lib.sdt_last_error().decode())
    return out


def avif_tools() -> Dict[str, int]:
    """The AV1 coding tools the AVIF decoder has decoded in this process,
    by name: how many blocks (or pictures, for the headers, depths and
    container features) used each."""
    lib = _library()
    n = lib.sdt_avif_tally(None, 0)
    counts = (ctypes.c_long * n)()
    lib.sdt_avif_tally(counts, n)
    return {lib.sdt_avif_tool_name(i).decode(): counts[i] for i in range(n)}


# the in-loop filter stages `avif_planes` may apply (av1.h's kFilter*)
AV1_FILTERS = {"none": 0, "deblock": 1, "deblock_cdef": 3, "all": 7}


def avif_planes(buf: bytes, filters: str = "all",
                name: str = "<bytes>") -> list:
    """The decoded planes of an AVIF's primary AV1 item, before any YUV to
    RGB: [Y] or [Y, U, V] (G, B, R for the identity matrix) as uint16
    arrays, the chroma subsampled as coded, with the in-loop filters of
    AV1_FILTERS[filters] applied (deblocking, then CDEF, then loop
    restoration), so that each stage can be held to a conformant AV1
    decoder's planes. Raises ImageDecodeError as `decode_image` does."""
    lib = _library()
    buf = bytes(buf)
    info = (ctypes.c_int * 6)()
    mask = AV1_FILTERS[filters]
    st = lib.sdt_avif_planes(buf, len(buf), mask, None, 0, info)
    if st:
        raise _error(st, name, lib.sdt_last_error().decode())
    w, h, count, ssx, ssy, _ = list(info)
    shapes = [(h, w)] + [((h + ssy) >> ssy, (w + ssx) >> ssx)] * (count - 1)
    out = np.empty(sum(a * b for a, b in shapes), np.uint16)
    st = lib.sdt_avif_planes(buf, len(buf), mask, _ptr(out), out.size, info)
    if st:
        raise _error(st, name, lib.sdt_last_error().decode())
    planes, at = [], 0
    for a, b in shapes:
        planes.append(out[at:at + a * b].reshape(a, b))
        at += a * b
    return planes


def png_unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The row filters of an inflated PNG stream undone: (h, row_bytes)
    uint8, as `data.image_io._unfilter`."""
    raw = bytes(raw)
    if len(raw) != h * (row_bytes + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{h * (row_bytes + 1)}")
    out = np.empty((h, row_bytes), np.uint8)
    lib = _library()
    if lib.sdt_png_unfilter(raw, h, row_bytes, bpp, _ptr(out)):
        raise ValueError(lib.sdt_last_error().decode())
    return out


def jpeg_check(buf: bytes) -> Optional[str]:
    """None for a JPEG stream that runs whole from SOI to EOI, else its
    fault: the check `decode_image` makes before the back end decodes a
    stream the host decoders refuse (the markers walked, and a sequential
    Huffman stream's entropy-coded data decoded as libjpeg decodes it)."""
    buf = bytes(buf)
    lib = _library()
    return lib.sdt_last_error().decode() if lib.sdt_jpeg_check(
        buf, len(buf)) else None


def jpeg_host_kind(buf: bytes) -> Optional[str]:
    """The library's own decoder that takes the stream, from its headers:
    "sequential", "progressive" (Huffman), "sequential arithmetic",
    "progressive arithmetic", "lossless", or None (refused, or the back
    end's)."""
    buf = bytes(buf)
    return HOST_KINDS[_library().sdt_jpeg_host_kind(buf, len(buf))]


def jpeg_colour(buf: bytes) -> Optional[str]:
    """libjpeg's colour space guess for a stream the host decoders take:
    "gray", "YCbCr", "RGB", "CMYK" or "YCCK"; None for another stream."""
    buf = bytes(buf)
    return _library().sdt_jpeg_host_colour(buf, len(buf)).decode() or None


def _decode_jpeg(fn: str, buf: bytes, name: str) -> np.ndarray:
    buf = bytes(buf)
    h, w = image_size(buf, name)
    out = np.empty((h, w, 3), np.uint8)
    lib = _library()
    st = getattr(lib, fn)(buf, len(buf), _ptr(out), h, w)
    if st:
        raise _error(st, name, lib.sdt_last_error().decode())
    return out


def decode_jpeg_sequential(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """The library's own decode of a stream `jpeg_host_kind` names
    "sequential" (Huffman), on either build: libjpeg's default decode
    (integer IDCT, fancy upsampling) to the bit; raises ImageDecodeError
    for damaged data and for another kind of stream."""
    return _decode_jpeg("sdt_decode_jpeg_sequential", buf, name)


def decode_jpeg_progressive(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """The same for a progressive Huffman stream, block smoothing included
    where its scan script leaves a coefficient short of its last bit."""
    return _decode_jpeg("sdt_decode_jpeg_progressive", buf, name)


def decode_jpeg_arithmetic(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """The same for an arithmetic-coded stream, sequential or
    progressive."""
    return _decode_jpeg("sdt_decode_jpeg_arithmetic", buf, name)


def decode_jpeg_backend(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """The back end's decode (`decoders()["jpeg"]`) of any JPEG stream,
    after `jpeg_check`: what `decode_image` does with the streams
    `jpeg_host_kind` refuses, here for every stream (on the nvJPEG route
    it times and measures the card's decode beside the host decoders')."""
    return _decode_jpeg("sdt_decode_jpeg_backend", buf, name)


def _encode(fn: str, what: str, img: np.ndarray) -> bytes:
    img = _image(img)
    if img.shape[2] != 3:
        raise ValueError(f"{what} encode takes RGB, got {img.shape}")
    lib = _library()
    buf, size = ctypes.c_void_p(), ctypes.c_long()
    st = getattr(lib, fn)(_ptr(img), img.shape[0], img.shape[1],
                          ctypes.byref(buf), ctypes.byref(size))
    if st:
        raise RuntimeError(f"{what} encode: {lib.sdt_last_error().decode()}")
    try:
        return ctypes.string_at(buf.value, size.value)
    finally:
        lib.sdt_free(buf)


def encode_jpeg(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> JPEG bytes (4:2:0, quality 95)."""
    return _encode("sdt_encode_jpeg", "JPEG", img)


def encode_tiff(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> a TIFF file with cv2.imwrite's tags: LZW,
    horizontal predictor, strips of about 8 KiB (`encode_host.cpp`)."""
    return _encode("sdt_encode_tiff", "TIFF", img)


def encode_webp(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> a lossless WebP file (VP8L: subtract green,
    Huffman-coded literals), which cv2.imwrite's default also is
    (`encode_host.cpp`)."""
    return _encode("sdt_encode_webp", "WebP", img)


def encode_gif(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the GIF cv2.imwrite writes at its default
    quality: the fixed 3-3-2 colour table, Floyd-Steinberg dithering onto
    it, one LZW-coded frame (`encode_host.cpp`)."""
    return _encode("sdt_encode_gif", "GIF", img)


def encode_hdr(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the Radiance HDR cv2.imwrite writes: the
    pixels over 255 as RGBE, run-length scanlines (`encode_host.cpp`)."""
    return _encode("sdt_encode_hdr", "HDR", img)


def encode_jp2(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the .jp2 file cv2.imwrite writes, byte for
    byte (OpenJPEG 2.5.3's reversible 5/3 encoder, one layer cut to rate 4
    by its rate allocation; `j2k_encode_host.cpp`). Below 32 pixels on a
    side cv2 refuses: EncodeRefused, holding the 77-byte file cv2
    leaves."""
    img = _image(img)
    if img.shape[2] != 3:
        raise ValueError(f"JPEG 2000 encode takes RGB, got {img.shape}")
    lib = _library()
    buf, size = ctypes.c_void_p(), ctypes.c_long()
    st = lib.sdt_encode_jp2(_ptr(img), img.shape[0], img.shape[1],
                            ctypes.byref(buf), ctypes.byref(size))
    if st not in (0, 3):
        raise RuntimeError(f"JPEG 2000 encode: "
                           f"{lib.sdt_last_error().decode()}")
    try:
        out = ctypes.string_at(buf.value, size.value)
    finally:
        lib.sdt_free(buf)
    if st:
        raise EncodeRefused(f"OpenJPEG2000: {lib.sdt_last_error().decode()}",
                            out)
    return out


def encode_avif(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the .avif cv2.imwrite writes at its defaults
    (libavif over libaom: 4:2:0, BT.601 full range, base_q_idx 148 with
    cv2's chroma delta q, quantizer matrices, deblocking and CDEF); the
    boxes and the sequence header are cv2's, the tile the library's own
    (`av1_encode.cpp`, `avif_encode_host.cpp`)."""
    return _encode_avif(img, False)[0]


def avif_encode_planes(img: np.ndarray) -> Tuple[bytes, list]:
    """encode_avif, and the encoder's reconstruction of the picture: its
    Y (H, W), U and V ((H + 1) // 2, (W + 1) // 2) planes, uint16."""
    return _encode_avif(img, True)


def _encode_avif(img: np.ndarray, planes: bool) -> Tuple[bytes, list]:
    img = _image(img)
    if img.shape[2] != 3:
        raise ValueError(f"AVIF encode takes RGB, got {img.shape}")
    h, w = img.shape[:2]
    ch, cw = (h + 1) // 2, (w + 1) // 2
    recon = np.empty(h * w + 2 * ch * cw if planes else 0, np.uint16)
    lib = _library()
    buf, size = ctypes.c_void_p(), ctypes.c_long()
    st = lib.sdt_encode_avif(_ptr(img), h, w, ctypes.byref(buf),
                             ctypes.byref(size),
                             _ptr(recon) if planes else None)
    if st:
        raise RuntimeError(f"AVIF encode: {lib.sdt_last_error().decode()}")
    try:
        data = ctypes.string_at(buf.value, size.value)
    finally:
        lib.sdt_free(buf)
    if not planes:
        return data, []
    return data, [recon[:h * w].reshape(h, w),
                  recon[h * w:h * w + ch * cw].reshape(ch, cw),
                  recon[h * w + ch * cw:].reshape(ch, cw)]


def av1_symbol_round_trip(kinds, ns, values) -> Tuple[bytes, np.ndarray,
                                                     bool]:
    """The AVIF encoder's symbol writer against the decoder's reader
    (`sdt_av1_symbols`): items of kinds (0 a symbol of an adaptive CDF of
    ns symbols, 1 a boolean, 2 a literal of ns bits, 3 ns(ns)) and values
    written, then read back. Returns (the tile's bytes, the values read,
    whether the reader ran past the tile's end)."""
    kinds, ns, values = (np.ascontiguousarray(a, np.int32)
                         for a in (kinds, ns, values))
    count = len(kinds)
    out = np.empty(8 * count + 64, np.uint8)
    decoded = np.empty(count, np.int32)
    size = ctypes.c_long()
    over = _library().sdt_av1_symbols(_ptr(kinds), _ptr(ns), _ptr(values),
                                      count, _ptr(out), out.size,
                                      ctypes.byref(size), _ptr(decoded))
    return out[:size.value].tobytes(), decoded, bool(over)


def rgb_to_ycc420(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """libjpeg's input stage for a 4:2:0 stream, which the nvJPEG route
    encodes: (H, W, 3) RGB -> y (H, W), cb and cr ((H + 1) // 2,
    (W + 1) // 2)."""
    img = _image(img)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"rgb_to_ycc420 takes RGB, got {img.shape}")
    y = np.empty((h, w), np.uint8)
    cb = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    cr = np.empty_like(cb)
    _library().sdt_rgb_to_ycc420(_ptr(img), h, w, _ptr(y), _ptr(cb), _ptr(cr))
    return y, cb, cr


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int,
               vs: int) -> np.ndarray:
    """libjpeg's output stage on decoded planes: y (H, W), cb and cr
    subsampled by hs x vs (1 or 2 each) -> (H, W, 3) RGB, by fancy
    upsampling and the fixed-point YCbCr -> RGB tables (the nvJPEG route
    finishes its planes so)."""
    y, cb, cr = (np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr))
    h, w = y.shape
    ch, cw = cb.shape
    if hs not in (1, 2) or vs not in (1, 2) or cr.shape != cb.shape \
            or (ch, cw) != (-(-h // vs), -(-w // hs)):
        raise ValueError(f"planes {y.shape}, {cb.shape}, {cr.shape} for "
                         f"factors {hs}x{vs}")
    out = np.empty((h, w, 3), np.uint8)
    _library().sdt_ycc_to_rgb(_ptr(y), _ptr(cb), _ptr(cr), h, w, ch, cw, hs,
                              vs, _ptr(out))
    return out


# ---------------------------------------------------------------- pixels

def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Bilinear resize (half-pixel centres) of an (H, W, C) uint8 image."""
    img = _image(img)
    if dh < 1 or dw < 1:
        raise ValueError(f"resize to {dh}x{dw}")
    out = np.empty((dh, dw, img.shape[2]), np.uint8)
    _library().sdt_resize_bilinear(_ptr(img), img.shape[0], img.shape[1],
                                   img.shape[2], _ptr(out), dh, dw)
    return out


def warp_affine(img: np.ndarray, inv: np.ndarray, fill: int) -> np.ndarray:
    """Bilinear warp into the same size: destination (x, y) samples the
    source at inv @ (x, y, 1) (inv: the (2, 3) destination -> source map,
    taken in float32); taps outside the image read `fill`."""
    img = _image(img)
    m = np.ascontiguousarray(inv, np.float32).reshape(6)
    out = np.empty_like(img)
    h, w, c = img.shape
    _library().sdt_warp_affine(_ptr(img), h, w, c, _ptr(m), int(fill),
                               _ptr(out))
    return out


def histogram(img: np.ndarray) -> np.ndarray:
    """(C, 256) int64 counts of each value in each channel."""
    img = _image(img)
    c = img.shape[2]
    out = np.empty((c, 256), np.int64)
    _library().sdt_histogram(_ptr(img), img.shape[0] * img.shape[1], c,
                             _ptr(out))
    return out


def apply_lut(img: np.ndarray, luts: np.ndarray) -> np.ndarray:
    """out[..., k] = luts[k][img[..., k]], luts (C, 256) uint8."""
    img = _image(img)
    luts = np.ascontiguousarray(luts, np.uint8)
    if luts.shape != (img.shape[2], 256):
        raise ValueError(f"luts {luts.shape} for {img.shape[2]} channels")
    out = np.empty_like(img)
    _library().sdt_apply_lut(_ptr(img), img.shape[0] * img.shape[1],
                             img.shape[2], _ptr(luts), _ptr(out))
    return out


def gray(img: np.ndarray) -> np.ndarray:
    """RGB -> (H, W) luma as Pillow's convert("L")."""
    img = _image(img)
    if img.shape[2] != 3:
        raise ValueError(f"gray takes RGB, got {img.shape}")
    out = np.empty(img.shape[:2], np.uint8)
    _library().sdt_gray(_ptr(img), img.shape[0] * img.shape[1], _ptr(out))
    return out


def blend(degenerate: np.ndarray, img: np.ndarray, factor: float
          ) -> np.ndarray:
    """Pillow's Image.blend(degenerate, img, factor), degenerate of shape
    (H, W, C), (H, W, 1) or (1, 1, 1) (broadcast over img)."""
    img = _image(img)
    deg = _image(degenerate, "degenerate")
    h, w, c = img.shape
    if deg.shape[2] not in (1, c) or deg.shape[:2] not in ((1, 1), (h, w)):
        raise ValueError(f"degenerate {deg.shape} does not broadcast over "
                         f"{img.shape}")
    px = 0 if deg.shape[:2] == (1, 1) else deg.shape[2]
    ch = 0 if deg.shape[2] == 1 else 1
    out = np.empty_like(img)
    _library().sdt_blend(_ptr(deg), px, ch, _ptr(img), h * w, c,
                         float(np.float32(factor)), _ptr(out))
    return out


def smooth(img: np.ndarray) -> np.ndarray:
    """Pillow's ImageFilter.SMOOTH, border pixels kept."""
    img = _image(img)
    out = np.empty_like(img)
    _library().sdt_smooth(_ptr(img), *img.shape, _ptr(out))
    return out


def solarize(img: np.ndarray, thr: int) -> np.ndarray:
    """Values below thr kept, the others inverted."""
    img = _image(img)
    out = np.empty_like(img)
    _library().sdt_solarize(_ptr(img), img.size, int(thr), _ptr(out))
    return out


def posterize(img: np.ndarray, mask: int) -> np.ndarray:
    """Each value AND mask."""
    img = _image(img)
    out = np.empty_like(img)
    _library().sdt_posterize(_ptr(img), img.size, int(mask), _ptr(out))
    return out


# ---------------------------------------------------------------- loader

Loaded = namedtuple("Loaded", "index image src_hw")


class PrefetchLoader:
    """Read, decode and resize image files in a pool of C++ threads.

    `submit(index, path, target_hw)` queues a file; `next()` returns the
    next finished one as `Loaded(index, image, src_hw)`, in completion
    order: `image` (H, W, 3) uint8 RGB at `target_hw` (bilinear, as
    `resize_bilinear`) or at its own size, `src_hw` the file's own size.
    A file that cannot be read or decoded raises ImageDecodeError naming
    it, from the `next()` that reaches it; the other results stay queued.
    `next()` with nothing outstanding raises instead of blocking forever.
    Not for concurrent use from several threads."""

    def __init__(self, n_threads: int = 4):
        self._lib = _library()
        self._handle = self._lib.sdt_loader_create(n_threads, MAX_PIXELS)
        self._paths: Dict[int, str] = {}

    def submit(self, index: int, path: str,
               target_hw: Optional[Tuple[int, int]] = None):
        if self._handle is None:
            raise RuntimeError("PrefetchLoader is closed")
        if index in self._paths:
            raise ValueError(f"index {index} is already outstanding")
        th, tw = target_hw if target_hw else (0, 0)
        self._paths[index] = path
        self._lib.sdt_loader_submit(self._handle, index,
                                    os.fsencode(path), th, tw)

    @property
    def outstanding(self) -> int:
        return len(self._paths)

    def next(self) -> Loaded:
        if self._handle is None:
            raise RuntimeError("PrefetchLoader is closed")
        if not self._paths:
            raise RuntimeError("PrefetchLoader.next: no task outstanding")
        idx, h, w, sh, sw = (ctypes.c_long(), ctypes.c_int(), ctypes.c_int(),
                             ctypes.c_int(), ctypes.c_int())
        msg = ctypes.create_string_buffer(512)
        st = self._lib.sdt_loader_next(
            self._handle, ctypes.byref(idx), ctypes.byref(h),
            ctypes.byref(w), ctypes.byref(sh), ctypes.byref(sw), msg,
            len(msg))
        path = self._paths.pop(idx.value)
        if st:
            raise _error(st, path, msg.value.decode(errors="replace"))
        img = np.empty((h.value, w.value, 3), np.uint8)
        self._lib.sdt_loader_copy(self._handle, _ptr(img))
        return Loaded(idx.value, img, (sh.value, sw.value))

    def close(self):
        if self._handle is not None:
            self._lib.sdt_loader_destroy(self._handle)
            self._handle = None
            self._paths.clear()

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
