"""What the colour kernels' tiles assume of swscale's chroma taps.

``csrc/yuv420p10_to_bgr.cu`` converts a tile of TILE_ROWS source rows x
TILE_COLS columns (TILE_COLS x TILE_ROWS at a quarter turn).  It filters
the chroma rows ``[vpos[r0], vpos[r_last] + vsize)`` of the tile's
TILE_COLS / 2 (or TILE_ROWS / 2) chroma columns into P10_CHROMA_WORDS
samples of shared memory a plane, and keeps each column's taps ``[hpos[c],
hpos[c] + hsize)`` and each row's in registers, at most P10_MAX_TAPS.
``csrc/yuv420_full_chroma_to_bgr.cu`` (odd widths) filters the same rows
to every source column of its tile, FC_CHROMA_WORDS words a plane, from
the chroma samples it stages (FC_SPAN a row, FC_SPAN_TURNED turned).
These tests hold the tables ``kernels.general_filters`` makes at every
chroma location and many heights and widths to those sizes, read from the
sources, and a model of the full-chroma tile's order of work to the
plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rtpose_tpu_torch.ops import kernels

CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
HEIGHTS = [*range(9, 200), 239, 240, 241, 359, 360, 479, 480, 481, 575,
           576, 719, 720, 1079, 1080, 1081, 1088, 1439, 1440, 2159, 2160,
           4319, 4320]


def _define(name: str) -> int:
    for src in CSRC.glob("*.cu*"):
        found = re.search(rf"^#define {name} (\d+)$", src.read_text(), re.M)
        if found:
            return int(found.group(1))
    raise AssertionError(f"#define {name} not found in {CSRC}")


@pytest.mark.parametrize("location", sorted(kernels.CHROMA_LOCATIONS))
def test_p10_tile_chroma_rows_fit_shared_memory(location):
    rows, cols = _define("TILE_ROWS"), _define("TILE_COLS")
    words, max_taps = _define("P10_CHROMA_WORDS"), _define("P10_MAX_TAPS")
    # (source rows of a tile, chroma rows its shared memory holds), straight
    # and turned
    tiles = ((rows, words // (cols // 2)), (cols, words // (rows // 2)))
    widest = dict.fromkeys(tiles, 0)
    for h in HEIGHTS:
        _, _, vpos, vtaps = kernels.general_filters(h, 8, location)
        ch, vsize = (h + 1) // 2, vtaps.shape[1]
        assert vsize <= max_taps
        assert np.all(np.diff(vpos) >= 0) and vpos[0] >= 0
        assert vpos[-1] + vsize <= ch
        for tile in tiles:
            for r0 in range(0, h, tile[0]):
                last = min(h, r0 + tile[0]) - 1
                widest[tile] = max(widest[tile], int(vpos[last]) + vsize
                                   - int(vpos[r0]))
    assert all(widest[tile] <= tile[1] for tile in tiles), widest


@pytest.mark.parametrize("location", sorted(kernels.CHROMA_LOCATIONS))
@pytest.mark.parametrize("width", [8, 10, 18, 64, 66, 130, 640, 1920, 3840])
def test_p10_horizontal_taps_stay_in_the_row(location, width):
    max_taps = _define("P10_MAX_TAPS")
    hpos, htaps, _, _ = kernels.general_filters(16, width, location)
    assert htaps.shape == (width // 2, htaps.shape[1])
    assert htaps.shape[1] <= max_taps
    assert hpos.min() >= 0 and (hpos + htaps.shape[1]).max() <= width // 2


@pytest.mark.parametrize("location", sorted(kernels.CHROMA_LOCATIONS))
@pytest.mark.parametrize("width", [9, 11, 15, 47, 65, 129, 639, 1919, 3839])
def test_full_chroma_taps_stay_in_the_row(location, width):
    """``csrc/yuv420_full_chroma_to_bgr.cu`` keeps at most FC_MAX_TAPS
    taps a column and a row; the horizontal ones scale the (width + 1) //
    2 chroma columns up to every pixel and read inside them."""
    max_taps = _define("FC_MAX_TAPS")
    for h in (9, 10, 31, 479, 480, 1079):
        hpos, htaps, vpos, vtaps = kernels.general_filters(
            h, width, location, full_chroma=True)
        assert htaps.shape[0] == width and vtaps.shape[0] == h
        assert max(htaps.shape[1], vtaps.shape[1]) <= max_taps
        assert hpos.min() >= 0
        assert (hpos + htaps.shape[1]).max() <= (width + 1) // 2
        assert vpos.min() >= 0 and vpos[-1] + vtaps.shape[1] <= (h + 1) // 2


ODD_WIDTHS = [*range(9, 200, 2), 239, 241, 359, 479, 639, 641, 719, 1279,
              1919, 1921, 2559, 3839, 3841]


@pytest.mark.parametrize("location", sorted(kernels.CHROMA_LOCATIONS))
def test_full_chroma_tile_chroma_fits_shared_memory(location):
    """``csrc/yuv420_full_chroma_to_bgr.cu`` filters the chroma rows
    ``[vpos[r0], vpos[r_last] + vsize)`` of a tile to each of its source
    columns, FC_CHROMA_WORDS words a plane (FC_CHROMA_WORDS / TILE_COLS
    rows straight, FC_CHROMA_WORDS / TILE_ROWS turned), from the samples
    ``[hpos[c0], hpos[c_last] + hsize)`` it stages: FC_SPAN of TILE_COLS
    columns, FC_SPAN_TURNED of TILE_ROWS.  The kernel traps past them."""
    rows, cols = _define("TILE_ROWS"), _define("TILE_COLS")
    words = _define("FC_CHROMA_WORDS")
    spans = {cols: _define("FC_SPAN"), rows: _define("FC_SPAN_TURNED")}
    # (source rows of a tile, chroma rows held), straight and turned
    tiles = ((rows, words // cols), (cols, words // rows))
    widest = dict.fromkeys(tiles, 0)
    for h in HEIGHTS:
        _, _, vpos, vtaps = kernels.general_filters(h, 9, location,
                                                    full_chroma=True)
        vsize = vtaps.shape[1]
        assert np.all(np.diff(vpos) >= 0)
        for tile in tiles:
            for r0 in range(0, h, tile[0]):
                last = min(h, r0 + tile[0]) - 1
                widest[tile] = max(widest[tile], int(vpos[last]) + vsize
                                   - int(vpos[r0]))
    assert all(widest[tile] <= tile[1] for tile in tiles), widest
    reach = dict.fromkeys(spans, 0)
    for w in ODD_WIDTHS:
        hpos, htaps, _, _ = kernels.general_filters(16, w, location,
                                                    full_chroma=True)
        hsize = htaps.shape[1]
        assert np.all(np.diff(hpos) >= 0)
        for n in spans:
            for c0 in range(0, w, n):
                last = min(w, c0 + n) - 1
                reach[n] = max(reach[n], int(hpos[last]) + hsize
                               - int(hpos[c0]))
    assert all(reach[n] <= spans[n] for n in spans), (reach, spans)


def _full_chroma_by_tiles(y, u, v, *, width, depth, rotation, rule,
                          location):
    """A model of the full-chroma kernel's order of work (not of its
    code): tile by tile, the chroma rows the tile's vertical taps reach
    filtered horizontally once to each of its source columns into an
    int32 buffer of FC_CHROMA_WORDS words a plane, clamped at 32767 there;
    then each pixel's vertical sums from that buffer, in int32, and
    ``yuv2rgb_write_full``'s 32-bit sums.  -> (BGR, how many filtered
    samples the clamp cut)."""
    h = y.shape[0]
    hpos, htaps, vpos, vtaps = (torch.from_numpy(a.astype(np.int64)) for a
                                in kernels.general_filters(
                                    h, width, location, full_chroma=True))
    hsize, vsize = htaps.shape[1], vtaps.shape[1]
    quarter = rotation in (90, 270)
    t_rows, t_cols = _define("TILE_ROWS"), _define("TILE_COLS")
    tile_h, tile_w = (t_cols, t_rows) if quarter else (t_rows, t_cols)
    held = _define("FC_CHROMA_WORDS") // tile_w
    cw = (width + 1) // 2
    planes = [c[:, :cw].to(torch.int32) for c in (u, v)]
    y15 = y[:, :width].to(torch.int64) << (15 - depth)
    sums = torch.zeros(2, h, width, dtype=torch.int32)
    clamped = 0
    for r0 in range(0, h, tile_h):
        rs = torch.arange(r0, min(h, r0 + tile_h))
        first = int(vpos[r0])
        rows = int(vpos[rs[-1]]) + vsize - first
        assert rows <= held
        for c0 in range(0, width, tile_w):
            xs = torch.arange(c0, min(width, c0 + tile_w))
            buf = torch.zeros(2, held, tile_w, dtype=torch.int32)
            for p, c in enumerate(planes):
                part = c[first:first + rows]
                hsum = sum(part[:, hpos[xs] + k] * htaps[xs, k].to(
                    torch.int32) for k in range(hsize))
                hsum = hsum >> (depth - 1)
                clamped += int((hsum > 32767).sum())
                buf[p, :rows, :len(xs)] = hsum.clamp(max=32767)
            for p in range(2):
                acc = torch.full((len(rs), len(xs)), (1 << 9) - (128 << 19),
                                 dtype=torch.int32)
                for t in range(vsize):
                    acc += (buf[p, vpos[rs] - first + t, :len(xs)]
                            * vtaps[rs, t, None].to(torch.int32))
                sums[p, r0:r0 + len(rs), c0:c0 + len(xs)] = acc >> 10
    cu, cv = sums.to(torch.int64)
    luma = (((((1 << 9) + (y15 << 12)) >> 10) - (rule.y_offset << 6))
            * rule.luma + (1 << 21))
    bgr = torch.stack([luma + cu * rule.ub, luma + cv * rule.vg
                       + cu * rule.ug, luma + cv * rule.vr], dim=-1)
    bgr = kernels._wrap32(bgr).clamp(0, (1 << 30) - 1) >> 22
    return kernels._turn(bgr.to(torch.uint8), rotation), clamped


def _field(depth, h, w, saturated, seed):
    """4:2:0 planes of a height x width picture: random samples, or 8x8
    blocks of flat 0 / top samples, the top-left one at the top (the
    bicubic's overshoot at their edges reaches the clamp; Y and U at the
    top wrap BT.709's blue)."""
    rng = np.random.RandomState(seed)
    dtype = np.uint8 if depth == 8 else np.uint16
    top = (1 << depth) - 1
    out = []
    for rows, cols, block in ((h, w, 8), ((h + 1) // 2, (w + 1) // 2, 4)):
        for _ in range(1 if rows == h else 2):
            if saturated:
                coarse = rng.randint(0, 2, (rows // block + 1,
                                            cols // block + 1)) * top
                coarse[0, 0] = top
                vals = np.kron(coarse, np.ones((block, block), np.int64))
                vals = vals[:rows, :cols]
            else:
                vals = rng.randint(0, top + 1, (rows, cols))
            out.append(torch.from_numpy(vals.astype(dtype)))
    return out


@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("saturated", [False, True],
                         ids=["random", "saturated"])
@pytest.mark.parametrize("depth,h,w", [(8, 9, 9), (10, 9, 9), (8, 31, 47),
                                       (10, 31, 47), (8, 479, 639),
                                       (10, 480, 639)])
def test_full_chroma_tile_order_equals_the_plain_version(depth, h, w,
                                                         saturated,
                                                         rotation):
    """Filtering each chroma row once a tile into the int32 buffer, with
    the clamp there, then vertically a pixel, gives the plain version's
    frame bit for bit: at both depths, ragged tiles on both edges, each
    turn's tiling, random fields and saturated ones (clamped sums, and the
    32-bit wrap of a bright pixel of strong chroma)."""
    planes = _field(depth, h, w, saturated, seed=h * w + depth)
    clamped = 0
    for i, (matrix, full) in enumerate(((1, False), (2, False), (9, False),
                                        (1, True))):
        rule = kernels.yuv_rule(matrix, full)
        location = (0, 1, 3, 1)[i]
        got, cut = _full_chroma_by_tiles(*planes, width=w, depth=depth,
                                         rotation=rotation, rule=rule,
                                         location=location)
        want = kernels.full_chroma_to_bgr_plain(
            *planes, width=w, depth=depth, rotation=rotation, rule=rule,
            chroma_location=location)
        assert torch.equal(got, want), (matrix, full)
        clamped += cut
    if saturated:
        assert clamped > 0
        y, u, _ = (p.numpy().astype(np.int64) for p in planes)
        top = (1 << depth) - 1
        wraps = kernels.full_chroma_to_bgr_plain(
            *planes, width=w, depth=depth, rule=kernels.yuv_rule(1, False),
            chroma_location=1)[..., 0].numpy()
        flat = (y[::2, ::2][:u.shape[0], :u.shape[1]] == top) & (u == top)
        assert flat.any() and (wraps[::2, ::2][flat] == 0).any()
