"""Lossy AVIF (what cv2.imwrite writes below quality 100) read by the port's
host library against a conformant AV1 decoder, cv2 and the JAX loader.

cv2 5.0 writes lossy AVIF as one AV1 key frame, 4:2:0 with the BT.601
matrix at full range (or monochrome), through libaom 3.14.1; it reads it
back through libavif, whose YUV to RGB is libyuv's. The port decodes the
frame with `native/av1_*.cpp` and converts it as cv2 does:

* Each stage's planes (`native.avif_planes`: reconstruction alone, then
  with deblocking, with CDEF, with loop restoration) equal those of dav1d
  (`tests/av1_witness.py`, its in-loop filters turned off one at a time)
  at max abs 0. AV1 decoding is normative: a conformant decoder's planes
  are every decoder's.
* Every committed `avif_lossy_*` fixture (intra block copy in a lossy
  frame among them), `other_avif.avif` and fresh writes at other sizes,
  qualities, speeds and depths decode to
  cv2.imread's pixels and to the JAX loader's (`CocoDataset.load_image`:
  its cv2 fallback) at max abs 0.
* What cv2 reads and the port still does not (segmentation, film grain,
  superres: header edits of a committed fixture) raises "not ported"
  naming the tool. (Several tiles, other matrices and limited range now
  read to cv2's pixels: test_torch_avif_tiles.py and
  test_torch_avif_layouts.py.)
"""
import numpy as np
import pytest

import av1_witness
import format_writers as fw
from _format_checks import check_against_loaders, read
from semi_detr_tpu_torch import native

# the streams held stage by stage, and what each reaches
STAGED = ("avif_lossy_480x640.avif",   # deblocking, CDEF, quantizer matrices
          "avif_lossy_speed0.avif",    # loop restoration (switchable)
          "avif_lossy_speed4.avif",    # self-guided restoration
          "avif_lossy_q30.avif",
          "avif_lossy_12bit.avif",
          "avif_lossy_mono.avif",
          "avif_lossy_screen.avif",    # palette, identity transforms
          "avif_lossy_intrabc.avif")   # intra block copy, transform trees
STAGES = ("none", "deblock", "deblock_cdef", "all")
LOSSY = sorted(n for n in fw.committed(("avif_lossy_",))) + ["other_avif.avif"]


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", STAGED)
def test_stage_planes_equal_a_conformant_decoder(name, stage):
    data = read(name)
    got = native.avif_planes(data, stage, name)
    ref = av1_witness.planes(data, stage)
    assert len(got) == len(ref)
    for p, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, (name, p, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{name} plane {p}")


def test_each_filter_stage_changes_the_planes():
    """The staged streams exercise every filter: each stage moves some
    sample of some stream (so holding it to the witness holds something)."""
    moved = set()
    for name in STAGED:
        planes = [av1_witness.planes(read(name), s) for s in STAGES]
        for k in range(1, len(STAGES)):
            if any((a != b).any() for a, b in zip(planes[k - 1], planes[k])):
                moved.add(STAGES[k])
    assert moved == set(STAGES[1:]), moved


@pytest.mark.parametrize("name", LOSSY)
def test_fixture_against_cv2_and_jax_loader(name, tmp_path):
    """The committed lossy files, and `other_avif.avif` (cv2.imencode's
    defaults): cv2's pixels and the JAX loader's at max abs 0."""
    assert fw.committed((name,))[name]["expect"] == "pixels"
    assert check_against_loaders(read(name), tmp_path, name)


pic = fw._avif_picture
CASES = {
    "q95_77x91": lambda: fw.avif_cv2(pic(77, 91, 21), quality=95),
    "q50_speed1": lambda: fw.avif_cv2(pic(70, 130, 22), quality=50, speed=1),
    "q20_speed3": lambda: fw.avif_cv2(pic(66, 66, 23), quality=20, speed=3),
    "q85_speed7": lambda: fw.avif_cv2(pic(33, 140, 24), quality=85, speed=7),
    "q70_10bit_odd": lambda: fw.avif_cv2(
        pic(35, 29, 25).astype(np.uint16) * 4 + 3, quality=70, depth=10),
    "q40_12bit_speed2": lambda: fw.avif_cv2(
        pic(40, 56, 26).astype(np.uint16) * 16 + 9, quality=40, depth=12,
        speed=2),
    "mono_q50": lambda: fw.avif_cv2(pic(41, 43, 27)[..., 1].copy(),
                                    quality=50),
    "screen_q70_speed4": lambda: fw.avif_cv2(fw._avif_screen(80, 144, 28),
                                             quality=70, speed=4),
    "noise_q90": lambda: fw.avif_cv2(np.random.RandomState(29).randint(
        0, 256, (24, 40, 3)).astype(np.uint8), quality=90),
    "intrabc_q60_speed6": lambda: fw.avif_cv2(fw._avif_mixed(5), quality=60,
                                              speed=6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fresh_writes_against_cv2_and_jax_loader(case, tmp_path):
    """Fresh cv2 writes (other sizes, seeds, qualities, speeds and depths
    than the fixtures): cv2's pixels and the JAX loader's, max abs 0."""
    assert check_against_loaders(CASES[case](), tmp_path, case + ".avif")


# ------------------------------------------------------------ refusals

def _seq_positions(body: bytes) -> dict:
    """The fields of a reduced still picture sequence header the edits need,
    with the bit positions of enable_superres and film_grain_params_present
    and the end of its fields."""
    r = fw._Bits(body)
    profile = r.f(3)
    r.f(2)  # still_picture, reduced_still_picture_header
    r.f(5)  # seq_level_idx
    wb, hb = r.f(4) + 1, r.f(4) + 1
    out = {"width": r.f(wb) + 1, "height": r.f(hb) + 1, "sb128": r.f(1)}
    r.f(2)  # filter intra, intra edge filter
    out["superres_at"] = r.p
    r.f(1)
    out["cdef"], out["restoration"] = r.f(1), r.f(1)
    hbd = r.f(1)
    depth = (12 if r.f(1) else 10) if profile == 2 and hbd else (10 if hbd else 8)
    out["mono"] = r.f(1) if profile != 1 else 0
    cp = tc = mc = 2
    if r.f(1):
        cp, tc, mc = r.f(8), r.f(8), r.f(8)
    out["separate"] = 0
    if out["mono"]:
        r.f(1)
    else:
        if not (cp == 1 and tc == 13 and mc == 0):
            r.f(1)
            if profile == 2 and depth == 12 and r.f(1):
                r.f(1)
            if profile == 0:
                r.f(2)  # chroma_sample_position (4:2:0)
        out["separate"] = r.f(1)
    out["film_grain_at"] = r.p
    assert r.f(1) == 0
    out["end"] = r.p
    out["bits"] = r.bits
    return out


def _frame_positions(seq: dict, frame: bytes) -> dict:
    """Bit positions in a reduced-header lossy key frame's header: where
    use_superres would be read, segmentation_enabled, and the header's end
    (after reduced_tx_set)."""
    r = fw._Bits(frame)
    out = {}
    r.f(1)  # disable_cdf_update
    sc = r.f(1)
    if sc:
        r.f(1)  # force_integer_mv
    out["superres"] = r.p
    if r.f(1):  # render_and_frame_size_different
        r.f(32)
    ibc = r.f(1) if sc else 0
    sb = 32 if seq["sb128"] else 16
    mi_cols, mi_rows = 2 * ((seq["width"] + 7) >> 3), 2 * ((seq["height"] + 7) >> 3)

    def log2(target):
        k = 0
        while (1 << k) < target:
            k += 1
        return k
    assert r.f(1) == 1  # uniform tile spacing, one tile
    for n in ((mi_cols + sb - 1) // sb, (mi_rows + sb - 1) // sb):
        if log2(min(n, 64)):
            assert r.f(1) == 0
    assert r.f(8) > 0  # base_q_idx: lossy
    planes = 1 if seq["mono"] else 3
    deltas = 1
    if planes > 1:
        deltas += 4 if seq["separate"] and r.f(1) else 2
    for _ in range(deltas):
        if r.f(1):
            r.f(7)
    if r.f(1):  # using_qmatrix
        r.f(8 + (4 if seq["separate"] else 0))
    out["segmentation"] = r.p
    assert r.f(1) == 0
    if r.f(1):  # delta_q_present
        r.f(2)
        if not ibc:
            assert r.f(1) == 0  # delta_lf_present
    lf = [r.f(6), r.f(6)]
    if planes > 1 and any(lf):
        r.f(12)
    r.f(3)  # sharpness
    if r.f(1) and r.f(1):  # loop_filter_delta_enabled, _update
        for _ in range(10):
            if r.f(1):
                r.f(7)
    if seq["cdef"]:
        r.f(2)
        bits = r.f(2)
        r.f((1 << bits) * (6 if planes == 1 else 12))
    if seq["restoration"]:
        types = [r.f(2) for _ in range(planes)]
        if any(types):
            if seq["sb128"]:
                r.f(1)
            elif r.f(1):
                r.f(1)
            if planes > 1 and any(types[1:]):
                r.f(1)
    r.f(1)  # tx_mode_select
    r.f(1)  # reduced_tx_set
    out["end"] = r.p
    out["bits"] = r.bits
    return out


def _edit(data: bytes, what: str) -> bytes:
    """A committed lossy file with one header edited to use `what`; the
    tile data stays (the refusal comes before it is read)."""
    def av1(item):
        obus = fw.av1_obus(item)
        seq = _seq_positions(next(b for t, _, b in obus if t == 1))
        seq_bits = seq["bits"][:seq["end"]]
        frame = next(b for t, _, b in obus if t == 6)
        fr = _frame_positions(seq, frame)
        bits = fr["bits"][:fr["end"]]
        if what == "segmentation":
            p = fr["segmentation"]
            bits = bits[:p] + "1" + "0" * 64 + bits[p + 1:]
        elif what == "superres":
            p = seq["superres_at"]
            seq_bits = seq_bits[:p] + "1" + seq_bits[p + 1:]
            p = fr["superres"]
            bits = bits[:p] + "1" + bits[p:]
        elif what == "film_grain":
            p = seq["film_grain_at"]
            seq_bits = seq_bits[:p] + "1" + seq_bits[p + 1:]
            bits = bits + "1"  # apply_grain
        bits += "0" * (-len(bits) % 8)
        head = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
        data_at = (fr["end"] + 7) // 8
        out = []
        for t, h, body in obus:
            if t == 1:
                body = fw._pack(seq_bits)
            elif t == 6:
                body = head + frame[data_at:]
            out.append((t, h, body))
        return fw.av1_join(out)
    return fw._avif_edit(data, av1=av1)


REFUSALS = {"segmentation": "segmentation", "film_grain": "film grain",
            "superres": "superres"}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_refusals_that_stay(what):
    """Each tool cv2's lossy files do not use raises "not ported" naming
    itself, at decode and at `image_size` for the container's."""
    data = _edit(read("avif_lossy_480x640.avif"), what)
    name = f"lossy_{what}.avif"
    with pytest.raises(native.ImageDecodeError) as err:
        native.decode_image(data, name)
    msg = str(err.value)
    assert name in msg and "AVIF" in msg and "not ported" in msg, msg
    assert REFUSALS[what] in msg, msg


def test_lossy_tools_all_reached():
    """Decoding the committed lossy fixtures reaches every tool the lossy
    decoder counts: a tool no fixture reaches would be decoded untested."""
    lossy_tools = [t for t in native.avif_tools()
                   if t == "lossy" or t.startswith(("tx_", "deblock", "cdef", "lr_"))
                   or t in ("chroma_420", "quantizer_matrix", "delta_q", "dct",
                            "adst", "identity", "eob_long", "bt601",
                            "chroma_upsample", "var_tx", "intrabc_subpel")]
    assert len(lossy_tools) == 34, lossy_tools
    before = native.avif_tools()
    for name in LOSSY:
        native.decode_image(read(name), name)
    after = native.avif_tools()
    missed = [t for t in lossy_tools if after[t] == before[t]]
    assert not missed, missed
