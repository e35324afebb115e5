"""A conformant AV1 decoder as the witness of the port's planes: dav1d
(`libdav1d.so.6`, 1.x), driven through ctypes, with its in-loop filters
(deblocking, CDEF, loop restoration) turned off one at a time
(`Dav1dSettings.inloop_filters`). AV1 decoding is normative, so its planes
are the planes every conformant decoder gives, to the bit.

    planes(avif_bytes, filters="all")  # [Y, U, V] (or [Y]) as uint16
"""
import ctypes
import ctypes.util
import struct

import numpy as np

import format_writers as fw

DEBLOCK, CDEF, RESTORATION = 1, 2, 4
FILTERS = {"none": 0, "deblock": DEBLOCK, "deblock_cdef": DEBLOCK | CDEF,
           "all": DEBLOCK | CDEF | RESTORATION}
# Dav1dSettings of dav1d 1.x: n_threads, max_frame_delay, apply_grain,
# operating_point, all_layers, frame_size_limit (6 x 4 bytes), the picture
# allocator (3 pointers) and the logger (2 pointers), then
# strict_std_compliance, output_invisible_frames, inloop_filters
_INLOOP_OFFSET = 24 + 24 + 16 + 8
_lib = None


def lib():
    global _lib
    if _lib is None:
        path = ctypes.util.find_library("dav1d") or "libdav1d.so.6"
        _lib = ctypes.CDLL(path)
        _lib.dav1d_version.restype = ctypes.c_char_p
        _lib.dav1d_data_create.restype = ctypes.c_void_p
    return _lib


def av1_stream(data: bytes) -> bytes:
    """The primary item's AV1 OBUs, its av1C config OBUs first."""
    a = fw.avif_items(data)
    item = a["items"][a["primary"]]
    av1c = next(p for p in item["props"] if p[4:8] == b"av1C")
    return av1c[12:] + item["data"]


def planes(data: bytes, filters: str = "all", avif: bool = True):
    """dav1d's planes of an AVIF's primary item (or of raw OBUs) with the
    in-loop filters of FILTERS[filters] on: a list of uint16 arrays."""
    d = lib()
    obus = av1_stream(data) if avif else data
    settings = ctypes.create_string_buffer(256)
    d.dav1d_default_settings(settings)
    on = struct.unpack_from("<i", settings.raw, _INLOOP_OFFSET)[0]
    assert on == 7, f"dav1d's settings layout is not 1.x's ({on})"
    struct.pack_into("<i", settings, _INLOOP_OFFSET, FILTERS[filters])
    struct.pack_into("<i", settings, 0, 1)  # one thread
    ctx = ctypes.c_void_p()
    assert d.dav1d_open(ctypes.byref(ctx), settings) == 0
    try:
        buf = ctypes.create_string_buffer(256)
        ptr = d.dav1d_data_create(buf, ctypes.c_size_t(len(obus)))
        ctypes.memmove(ptr, obus, len(obus))
        rc = d.dav1d_send_data(ctx, buf)
        assert rc == 0, f"dav1d_send_data: {rc}"
        pic = ctypes.create_string_buffer(1024)
        rc = d.dav1d_get_picture(ctx, pic)
        if rc != 0:
            raise ValueError(f"dav1d_get_picture: {rc}")
        raw = pic.raw
        data_p = struct.unpack_from("<3Q", raw, 16)
        stride = struct.unpack_from("<2q", raw, 40)
        w, h, layout, bpc = struct.unpack_from("<4i", raw, 56)
        size = 2 if bpc > 8 else 1
        out = []
        for p in range(1 if layout == 0 else 3):
            ssx = 1 if p and layout in (1, 2) else 0
            ssy = 1 if p and layout == 1 else 0
            pw, ph = (w + ssx) >> ssx, (h + ssy) >> ssy
            st = stride[min(p, 1)]
            mem = ctypes.string_at(data_p[p], st * (ph - 1) + pw * size)
            a = np.frombuffer(mem + bytes(st * ph - len(mem)),
                              np.uint16 if size == 2 else np.uint8)
            a = a.reshape(ph, st // size)[:, :pw].astype(np.uint16)
            out.append(a)
        d.dav1d_picture_unref(pic)
        return out
    finally:
        d.dav1d_close(ctypes.byref(ctx))
