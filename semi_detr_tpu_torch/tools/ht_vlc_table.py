"""Write `native/j2k_ht_tables.h`, the VLC decode tables and MEL exponents
of the high-throughput JPEG 2000 block coder (ITU-T T.814 / ISO/IEC
15444-15), from the OpenJPEG that cv2 carries.

The cleanup pass codes each quad's significance pattern (rho), its u_off
flag and its EMB pattern (e_k, e_1) with a variable-length code chosen by
the quad's context: one code for the first row of quads, another for the
rest. OpenJPEG's decoder keeps each as a table of 1,024 little-endian
uint16 entries, indexed by (context << 7) | the next 7 bits of the VLC
stream (least significant first); an entry holds the codeword's length in
bits 0-2, u_off in bit 3, rho in bits 4-7, e_1 in bits 8-11 and e_k in bits
12-15. No header that is installed carries them, so this tool finds them in
cv2's binary by their structure alone: within each block of 128 entries
(one context) every entry repeats with the period 2^(its length), and
distinct codewords hold distinct entries. It scans the binary at even
offsets for such blocks and keeps the single run of 16 consecutive ones
(the two tables, back to back); it fails if it finds no such run or more
than one. Its checks of the layout: every entry's e_1 lies within its e_k,
and e_k within rho; a quad of context 0 is never insignificant (the MEL
codes that). Which table is the first row's it learns by decoding: it
encodes a picture with the writer's HT block coder (`tools.raw_formats`),
whose encode tables are these inverted, once with each assignment, and
keeps the one cv2 decodes back to the picture (in cv2 5.0's binary the
non-initial table comes first); it fails unless exactly one does. The MEL
exponents are the standard's 13 (T.814), found once as int32 in the same
binary.

It runs only where cv2 is; like `tools.font_table` it is a maintenance
tool that no module of the port imports (the port's import guard names
both):

    python -m semi_detr_tpu_torch.tools.ht_vlc_table [--so PATH] [--out PATH]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)
# where cv2 5.0.0.93 (opencv-python, OpenJPEG 2.5.3) keeps the tables; a
# cross-check of the scan, never used to find them
KNOWN_OFFSET = 67063168

_HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(os.path.dirname(_HERE), "native", "j2k_ht_tables.h")


def cv2_binary() -> str:
    import cv2
    return os.path.join(os.path.dirname(cv2.__file__), "cv2.abi3.so")


def _blocks_ok(a: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Which 128-entry blocks at `starts` are a VLC context: every entry of
    length >= 1, each repeating with the period 2^length."""
    k = np.arange(128)
    blk = a[starts[:, None] + k].astype(np.int64)
    length = blk & 7
    idx = k & ((1 << length) - 1)
    return (length >= 1).all(1) & (np.take_along_axis(blk, idx, 1)
                                   == blk).all(1)


def _distinct(blk: np.ndarray) -> bool:
    """Distinct codewords hold distinct entries (a constant fill does not)."""
    codes = {(int(e) & 7, k & ((1 << (int(e) & 7)) - 1))
             for k, e in enumerate(blk)}
    return len(set(blk.tolist())) == len(codes)


def find_tables(data: bytes):
    """(offset, first table, second table) found in `data` by their
    structure."""
    a = np.frombuffer(data[:len(data) // 2 * 2], "<u2")
    n = len(a)
    length = a & 7
    # a cheap necessary test first: in the second half of a block an entry
    # of length <= 6 equals the one 64 before it
    good = np.zeros(n, bool)
    good[64:] = (length[64:] >= 1) & ((length[64:] == 7) |
                                      (a[64:] == a[:-64]))
    bad = np.zeros(n + 1, np.int32)
    np.cumsum(~good, out=bad[1:])
    cand = np.flatnonzero(bad[128:] == bad[64:-64])
    ok = cand[_blocks_ok(a, cand)]
    ok = [int(c) for c in ok if _distinct(a[c:c + 128])]
    found = set(ok)
    runs = []
    for c in ok:
        if c - 128 in found:
            continue
        m = 0
        while c + 128 * m in found:
            m += 1
        if m >= 16:
            runs.append((c, m))
    if len(runs) != 1 or runs[0][1] != 16:
        raise RuntimeError(f"expected one run of 16 VLC blocks (two tables "
                           f"of 1,024 entries), found runs {runs}")
    start = runs[0][0]
    tbl = a[start:start + 2048].astype(np.uint16)
    return 2 * start, tbl[:1024].copy(), tbl[1024:].copy()


def check_layout(t0: np.ndarray, t1: np.ndarray):
    """The fields' rules, entry by entry."""
    for name, t in (("initial", t0), ("non-initial", t1)):
        for i, e in enumerate(t.tolist()):
            rho, e1, ek = (e >> 4) & 15, (e >> 8) & 15, (e >> 12) & 15
            if e1 & ~ek or ek & ~rho:
                raise RuntimeError(f"{name}[{i}] = {e:#06x}: e_1 {e1} not "
                                   f"within e_k {ek}, or e_k not within "
                                   f"rho {rho}")
            if i >> 7 == 0 and rho == 0:
                raise RuntimeError(f"{name}[{i}]: an insignificant quad of "
                                   f"context 0")


def find_mel(data: bytes) -> int:
    pat = np.asarray(MEL_EXP, "<i4").tobytes()
    at = data.find(pat)
    if at < 0 or data.find(pat, at + 1) >= 0:
        raise RuntimeError("the MEL exponents are not in the binary exactly "
                           "once")
    return at


def header(t0: np.ndarray, t1: np.ndarray, src: str) -> str:
    def rows(t):
        return "\n".join("    " + ", ".join(f"0x{v:04x}" for v in
                                           t[i:i + 8].tolist()) + ","
                         for i in range(0, 1024, 8))
    return f"""\
// The VLC decode tables and MEL exponents of the high-throughput JPEG 2000
// block coder (ITU-T T.814 / ISO/IEC 15444-15), as OpenJPEG 2.5's decoder
// keeps them. A table is indexed by (the quad's context << 7) | the next 7
// bits of the VLC stream, least significant first; an entry holds the
// codeword's length in bits 0-2, u_off in bit 3, rho in bits 4-7, e_1 in
// bits 8-11 and e_k in bits 12-15. Written by
// semi_detr_tpu_torch/tools/ht_vlc_table.py from
// {src}.
#pragma once

#include <cstdint>

namespace sdt {{
namespace j2k_ht {{

// the first row of quads
inline constexpr uint16_t kVlcInitial[1024] = {{
{rows(t0)}
}};

// the other rows
inline constexpr uint16_t kVlcNonInitial[1024] = {{
{rows(t1)}
}};

// the MEL coder's exponent by state
inline constexpr int kMelExp[13] = {{{", ".join(map(str, MEL_EXP))}}};

}}  // namespace j2k_ht
}}  // namespace sdt
"""


def parse_header(text: str):
    """(initial table, non-initial table, MEL exponents) from the header's
    text: the writer's encode tables are inverted from these."""
    import re
    out = []
    for name in ("kVlcInitial", "kVlcNonInitial"):
        body = re.search(name + r"\[1024\] = \{([^}]*)\}", text).group(1)
        out.append(np.array([int(v, 16) for v in re.findall(
            r"0x[0-9a-f]{4}", body)], np.uint16))
    mel = re.search(r"kMelExp\[13\] = \{([^}]*)\}", text).group(1)
    return out[0], out[1], tuple(int(v) for v in mel.split(","))


def round_trip(t0, t1) -> bool:
    """Whether cv2 decodes a lossless HT codestream (cleanup, SigProp and
    MagRef), written with encode tables inverted from t0 (the first row's)
    and t1, back to its picture."""
    import cv2
    from semi_detr_tpu_torch.tools import raw_formats
    rgb = raw_formats._picture(21, 27, 31, 60)
    ok = True
    for passes in (1, 3):
        data = raw_formats.j2k_codestream(
            [rgb[..., c] for c in range(3)], ht=True, cblk=(4, 3),
            ht_passes=passes, ht_tables=(t0, t1, MEL_EXP))
        got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        ok &= got is not None and np.array_equal(got[..., ::-1], rgb)
    return ok


def assign(first: np.ndarray, second: np.ndarray):
    """(initial-row table, non-initial-row table): the order cv2 decodes."""
    fits = [order for order in ((first, second), (second, first))
            if round_trip(*order)]
    if len(fits) != 1:
        raise RuntimeError(f"{len(fits)} assignments of the two tables "
                           f"decode in cv2, not one")
    return fits[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--so", default=None, help="cv2's binary (default: the "
                    "installed cv2's cv2.abi3.so)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    so = args.so or cv2_binary()
    with open(so, "rb") as f:
        data = f.read()
    at, first, second = find_tables(data)
    check_layout(first, second)
    mel_at = find_mel(data)
    t0, t1 = assign(first, second)
    print(f"VLC tables at byte {at} of {so} (the known offset of cv2 "
          f"5.0.0.93 is {KNOWN_OFFSET}: "
          f"{'same' if at == KNOWN_OFFSET else 'another build'}), the "
          f"{'first' if t0 is first else 'second'} the first row's; MEL "
          f"exponents at byte {mel_at}")
    text = header(t0, t1, "cv2 5.0's OpenJPEG 2.5.3 (cv2.abi3.so)")
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    return at, mel_at


if __name__ == "__main__":
    main()
