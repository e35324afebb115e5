"""GIF: the host library's decoder (`native/gif_host.cpp`) against the JAX
package's loader, which hands GIF files to `cv2.imread(path,
IMREAD_COLOR)` (OpenCV 5.0's GifDecoder).

The committed fixtures (`gif_*`, `other_gif.gif`, with `formats.json`)
decode to their stored cv2 pixels and to the JAX loader's at max abs 0
(`other_jp2.jp2` and `other_avif.avif`, which the JAX loader reads
through cv2, to their cv2 pixels too).
Seeded files of `format_writers.write_gif` cover LZW at every minimum code
size cv2 reads (2-11), clear codes, a full table with no clear (a deferred
clear), an end code inside the stream, interlaced rows, local and global
colour tables and the default one, a frame at an offset on a larger
logical screen, transparency against each background index, extension
blocks and a second frame; Pillow's GIF writer is a second witness. Each is
held to cv2.imread and to the JAX loader at max abs 0. What cv2 refuses (a
background index past the table, a disposal method above 3, a frame
outside the screen, an index past every table, a minimum code size of 12)
raises as the JAX loader does, and damaged copies raise naming the file.
"""
import io

import numpy as np
import pytest

from _format_checks import (check_against_loaders, check_damaged,
                            check_fixture, fixture_params)
from format_writers import picture, write_gif

H, W = 23, 37


@pytest.mark.parametrize("name,entry", fixture_params(
    ("gif_", "other_gif", "other_jp2", "other_avif")))
def test_fixture(name, entry):
    check_fixture(name, entry)


def _cases():
    rs = np.random.RandomState(14)
    pal = rs.randint(0, 256, (256, 3))
    idx = rs.randint(0, 16, (H, W))
    big = rs.randint(0, 256, (90, 120))
    runs = np.repeat(rs.randint(0, 256, (90, 12)), 10, 1)
    cases = {}
    for size in range(2, 12):
        a = rs.randint(0, min(1 << size, 256), (H, W))
        cases[f"min_size_{size}"] = write_gif(a, pal[:min(1 << size, 256)],
                                              min_size=size)
    cases["interlaced"] = write_gif(idx, pal[:16], interlace=True)
    cases["interlaced_5_rows"] = write_gif(idx[:5], pal[:16], interlace=True)
    cases["full_table_cleared"] = write_gif(big, pal)
    cases["deferred_clear"] = write_gif(big, pal, deferred=True)
    cases["runs_deferred"] = write_gif(runs, pal, deferred=True)
    cases["clear_every_37"] = write_gif(big, pal, clear_every=37)
    cases["local_palette"] = write_gif(idx, pal[:16],
                                       local_palette=pal[16:32])
    cases["local_palette_no_global"] = write_gif(idx, None,
                                                 local_palette=pal[:16])
    cases["no_palette"] = write_gif(rs.randint(0, 256, (H, W)), None)
    for bg in (0, 5, 15):
        cases[f"offset_bg{bg}"] = write_gif(
            idx[:9, :13], pal[:16], screen=(H, W), offset=(7, 11),
            background=bg)
        cases[f"transparent_bg{bg}"] = write_gif(
            idx, pal[:16], transparent=int(idx[0, 0]), background=bg)
    cases["offset_local_transparent"] = write_gif(
        idx[:9, :13], pal[:16], screen=(H, W), offset=(3, 20),
        local_palette=pal[40:56], transparent=3, background=2)
    cases["offset_no_palette"] = write_gif(idx[:9, :13], None,
                                           screen=(H, W), offset=(2, 2))
    small_local = idx.copy()
    small_local[0, :4] = 9  # past the local table, inside the global one
    cases["index_past_local"] = write_gif(small_local, pal[:16],
                                          local_palette=pal[100:104],
                                          min_size=4)
    cases["gif87a"] = write_gif(idx, pal[:16], version=b"87a",
                                extensions=False)
    cases["two_frames"] = write_gif(idx, pal[:16],
                                    frames=[rs.randint(0, 16, (H, W))])
    for disposal in range(4):
        cases[f"disposal{disposal}"] = write_gif(
            idx[:9, :13], pal[:16], screen=(H, W), offset=(1, 1),
            disposal=disposal, transparent=4, background=1)
    from PIL import Image
    img = picture(H, W, 7)
    for name, kw in (("pillow", {}), ("pillow_interlace", {"interlace": 1}),
                     ("pillow_optimize", {"optimize": True})):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "GIF", **kw)
        cases[name] = buf.getvalue()
    frames = [Image.fromarray(picture(H, W, k)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:],
                   duration=50, loop=0)
    cases["pillow_animation"] = buf.getvalue()
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_seeded_gif(name, tmp_path):
    assert check_against_loaders(CASES[name], tmp_path, name + ".gif")


def _refused():
    rs = np.random.RandomState(15)
    pal = rs.randint(0, 256, (16, 3))
    idx = rs.randint(0, 16, (H, W))
    past = idx.copy()
    past[3, 3] = 12
    return {
        "bg_past_table": write_gif(idx[:4, :4] % 4, pal[:4], screen=(H, W),
                                   background=9),
        "disposal4": write_gif(idx, pal, disposal=4),
        "frame_outside_screen": write_gif(idx, pal, screen=(H - 1, W)),
        "index_past_tables": write_gif(past, pal[:8], min_size=4),
        "min_size_12": write_gif(idx, pal, min_size=12),
    }


@pytest.mark.parametrize("name,data", sorted(_refused().items()))
def test_what_cv2_refuses_raises(name, data, tmp_path):
    assert not check_against_loaders(data, tmp_path, name + ".gif")


def test_damaged_copies_raise_naming_the_file(tmp_path):
    rs = np.random.RandomState(16)
    pal = rs.randint(0, 256, (256, 3))
    big = write_gif(rs.randint(0, 256, (60, 90)), pal)
    check_damaged(big[:len(big) // 2], "gif_cut.gif", "GIF")
    check_damaged(big[:-1], "gif_no_trailer.gif", "trailer")
    garbled = bytearray(big)
    garbled[-200:-180] = b"\xff" * 20
    check_damaged(bytes(garbled), "gif_bad_codes.gif", "GIF")
    idx = rs.randint(0, 16, (8, 9))
    short = write_gif(idx, pal[:16], frames=())
    body = short[:short.rindex(b"\0;")]
    # a frame whose codes end before its pixels: the last sub-block cut
    cut = bytearray(body[:-3]) + b"\0;"
    check_damaged(bytes(cut), "gif_short_frame.gif", "GIF")
    check_damaged(b"GIF89a\x05\0\x05\0\0\0\0\x21", "gif_header_only.gif",
                  "GIF")
    for name, data in (("gif_cut.gif", big[:len(big) // 2]),
                       ("gif_bad_codes.gif", bytes(garbled))):
        assert not check_against_loaders(data, tmp_path, name)
