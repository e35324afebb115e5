"""BMP and PNM: the host library's decoders (`native/bmp_pnm_host.cpp`)
against the JAX package's loader, which hands these files to
`cv2.imread(path, IMREAD_COLOR)`.

The committed fixtures under `semi_detr_tpu_torch/native/fixtures/`
(`bmp_*`, `pnm_*`, listed with their variants in `formats.json`; written by
`tests/format_writers.py`) decode to their stored cv2 pixels and to the
JAX loader's at max abs 0. Seeded files of every header, bit depth and
compression, random RLE streams (runs, absolute runs, ends of line, deltas,
ends of bitmap, some cut short) and every PNM kind at maxvals from 1 to
65535 are held to cv2.imread here the same way, or raise where it refuses
them. Damaged copies raise naming the file.
"""
import numpy as np
import pytest

from _format_checks import (check_against_cv2, check_damaged, check_fixture,
                            fixture_params, read)
from format_writers import picture, write_bmp

H, W = 37, 53


@pytest.mark.parametrize("name,entry", fixture_params(("bmp_", "pnm_")))
def test_fixture(name, entry):
    check_fixture(name, entry)


def _bmp_cases():
    rs = np.random.RandomState(0)
    img = picture(H, W, 3)
    rgba = np.concatenate([img, rs.randint(0, 256, (H, W, 1))], 2)
    pal = rs.randint(0, 256, (256, 3))
    idx = rs.randint(0, 256, (H, W))
    cases = {}
    for bits in (1, 4, 8):
        for header in (12, 40, 108, 124):
            cases[f"pal{bits}_h{header}"] = write_bmp(
                idx >> (8 - bits), bits, pal[:1 << bits], header=header)
        cases[f"pal{bits}_topdown"] = write_bmp(
            idx >> (8 - bits), bits, pal[:1 << bits], top_down=True)
        used = max(1, (1 << bits) // 2)  # indices past the palette: black
        cases[f"pal{bits}_short"] = write_bmp(
            idx >> (8 - bits), bits, pal[:used], colours_used=used)
    cases["rgb24"] = write_bmp(img, 24)
    cases["rgb24_os2"] = write_bmp(img, 24, header=12)
    cases["rgb32"] = write_bmp(rgba, 32)
    cases["rgb32_swapped_masks"] = write_bmp(rgba, 32, compression=3,
                                             masks=(0xFF, 0xFF00, 0xFF0000))
    cases["rgb555"] = write_bmp(img, 16)
    cases["rgb555_bitfields"] = write_bmp(img, 16, compression=3,
                                          masks=(0x7C00, 0x3E0, 0x1F))
    cases["rgb565_bitfields"] = write_bmp(img, 16, compression=3,
                                          masks=(0xF800, 0x7E0, 0x1F))
    # OpenCV reads 16-bit masks after the whole header: a V4 header's own
    # masks are not the ones it checks, and it refuses this file
    cases["rgb565_v4_refused"] = write_bmp(img, 16, compression=3,
                                           masks=(0xF800, 0x7E0, 0x1F),
                                           header=108)
    runs = np.repeat(idx[:, ::3], 3, 1)[:, :W]
    cases["rle8"] = write_bmp(runs, 8, pal, compression=1)
    cases["rle4"] = write_bmp(runs >> 4, 4, pal[:16], compression=2)
    return cases


BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_seeded_bmp(case, tmp_path):
    read_by_cv2 = check_against_cv2(BMP_CASES[case], tmp_path, case + ".bmp")
    assert read_by_cv2 != case.endswith("_refused")


@pytest.mark.parametrize("bits", [8, 4])
def test_random_rle_streams_follow_cv2(bits, tmp_path):
    """Random RLE op streams over a 6 x 10 picture: each decodes to cv2's
    pixels or raises where cv2 refuses it (RLE4's end of bitmap fills only
    its row, and OpenCV then reads on past the data)."""
    rs = np.random.RandomState(bits)
    pal = rs.randint(0, 256, (1 << bits, 3))
    read = 0
    for t in range(40):
        ops = []
        for _ in range(rs.randint(1, 30)):
            r = rs.randint(0, 6)
            if r < 3:
                ops += [rs.randint(1, 12), rs.randint(0, 256)]
            elif r == 3:
                n = rs.randint(3, 10)
                body = list(rs.randint(0, 256, (n + 1) // 2 if bits == 4
                                       else n))
                ops += [0, n] + body + [0] * (len(body) % 2)
            elif r == 4:
                ops += [0, 0]
            else:
                ops += [0, 2, rs.randint(0, 5), rs.randint(0, 3)]
        if rs.rand() < 0.9:
            ops += [0, 1]
        data = write_bmp(np.zeros((6, 10), int), bits, pal,
                         compression=1 if bits == 8 else 2,
                         rle_data=bytes(ops))
        read += check_against_cv2(data, tmp_path, f"rle{bits}_{t}.bmp")
    # both outcomes for RLE8; cv2 refuses nearly every random RLE4 stream
    # (an end of bitmap before the last row reads on past the data)
    assert read < 40 and (read > 0 or bits == 4)


def _pnm(kind, maxval, a):
    head = f"{kind}\n# a comment\n{a.shape[1]} {a.shape[0]}\n".encode()
    if kind in ("P1", "P4"):
        bits = a[..., 0]
        return head + (np.packbits(bits.astype(np.uint8), axis=1).tobytes()
                       if kind == "P4" else " ".join(
                           map(str, bits.ravel())).encode() + b"\n")
    head += f"{maxval}\n".encode()
    if kind in ("P5", "P6"):
        return head + (a.astype(">u2") if maxval > 255
                       else a.astype(np.uint8)).tobytes()
    return head + " ".join(map(str, a.ravel())).encode() + b"\n"


PNM_CASES = [(k, m) for k in ("P2", "P3", "P5", "P6")
             for m in (1, 2, 100, 255, 256, 1000, 4095, 65535)] + \
    [("P1", 1), ("P4", 1)]


@pytest.mark.parametrize("kind,maxval", PNM_CASES)
def test_seeded_pnm(kind, maxval, tmp_path):
    rs = np.random.RandomState(maxval)
    ch = 3 if kind in ("P3", "P6") else 1
    a = rs.randint(0, maxval + 1, (H, W, ch))
    if kind in ("P2", "P3"):
        a[0, 0, 0] = maxval + 7  # ASCII samples above maxval are clamped
    assert check_against_cv2(_pnm(kind, maxval, a), tmp_path, kind + ".pnm")


def test_damaged_copies_raise_naming_the_file():
    bmp = read("bmp_24.bmp")
    check_damaged(bmp[:len(bmp) - 40], "bmp_24_truncated.bmp", "last row")
    rle = read("bmp_rle8.bmp")
    check_damaged(rle[:len(rle) // 2], "bmp_rle8_truncated.bmp", "RLE")
    check_damaged(bmp[:30], "bmp_header_only.bmp", "BMP")
    ppm = read("pnm_p6_100.ppm")
    check_damaged(ppm[:len(ppm) - 1], "pnm_p6_truncated.ppm", "PNM")
    check_damaged(b"P2\n3 2\n255\n1 2 x 4 5 6\n", "pnm_p2_garbage.pgm",
                  "PNM")


def test_every_reading_path_takes_the_formats(tmp_path):
    """read_image, the port's CocoDataset.load_image, the C++ prefetch
    loader (eval's path) and the image demo's output naming, on one
    fixture of each format."""
    import os
    import shutil
    from semi_detr_tpu_torch import native
    from semi_detr_tpu_torch.data import image_io
    from semi_detr_tpu_torch.data.coco import CocoDataset
    from semi_detr_tpu_torch.tools.image_demo import output_path
    names = ["bmp_rle8.bmp", "pnm_p6_100.ppm", "tiff_jpeg_tiles.tif",
             "webp_lossy.webp", "jpeg_lossless_p8.jpg"]
    refs = {}
    for n in names:
        shutil.copy(os.path.join(native.FIXTURES, n), tmp_path)
        refs[n] = image_io.read_image(os.path.join(
            native.FIXTURES, n.rsplit(".", 1)[0] + ".ref.png"))
    ann = {"images": [{"id": i + 1, "file_name": n,
                       "width": int(refs[n].shape[1]),
                       "height": int(refs[n].shape[0])}
                      for i, n in enumerate(names)],
           "annotations": [], "categories": [{"id": 1, "name": "person"}]}
    ds = CocoDataset(ann, str(tmp_path), classes=("person",),
                     filter_empty_gt=False, test_mode=True)
    loader = native.PrefetchLoader(2)
    for i, n in enumerate(names):
        np.testing.assert_array_equal(ds.load_image(i), refs[n])
        loader.submit(i, str(tmp_path / n))
    got = {}
    while loader.outstanding:
        r = loader.next()
        got[names[r.index]] = r.image
    loader.close()
    for n in names:
        np.testing.assert_array_equal(got[n], refs[n])
    assert output_path("a/b.tif", "out") == os.path.join("out", "b.tif")
    assert output_path("a/b.JPG", "out") == os.path.join("out", "b.JPG")
