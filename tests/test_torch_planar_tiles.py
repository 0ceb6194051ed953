"""What the tiles of ``csrc/yuv_planar_to_bgr.cu`` assume of swscale's
chroma taps, and a model of their order of work.

The general and full-chroma entries convert a tile of TILE_ROWS source
rows x TILE_COLS columns (TILE_COLS x TILE_ROWS at a quarter turn), each
instantiated for the least tap class (most horizontal taps, most vertical
taps) that holds the frame's filters.  A class stages the chroma rows its
tile's taps reach (its source rows at one vertical tap, at most
PLANAR_VROWS / PLANAR_VROWS_TURNED at more) and the samples of a row its
columns reach (PLANAR_SPAN_H<taps>, _TURNED) into the shared BGR tile,
whose bytes must hold them at every depth.  These tests hold the tables
``kernels.general_filters`` makes, at every chroma format each entry
converts, every depth, chroma location and many heights and widths that
``kernels.frame_route`` sends to the entry, to those sizes read from the
source, the wrapper's tap check to the source's limits, and a model of
the tiles' order of work to the plain versions bit for bit.
"""

import functools
import itertools
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
EVEN_WIDTHS = [*range(8, 200, 2), 240, 360, 480, 640, 720, 1280, 1920, 2560,
               3840, 4096]
ODD_WIDTHS = [*range(9, 200, 2), 239, 241, 359, 479, 639, 641, 719, 1279,
              1919, 1921, 2559, 3839, 3841]
C420, C422, C440, C444 = (kernels.CHROMA_420, kernels.CHROMA_422,
                          kernels.CHROMA_440, kernels.CHROMA_444)
NAMES = {C420: "420", C422: "422", C440: "440", C444: "444"}
# (route, chroma format, depths that take the entry on that route)
FORMATS = [("general", C422, (8, 10, 12)), ("general", C440, (8, 10, 12)),
           ("general", C420, (12,)), ("full_chroma", C444, (8, 10, 12)),
           ("full_chroma", C422, (8, 10, 12)),
           ("full_chroma", C440, (8, 10, 12)), ("full_chroma", C420, (12,))]
# the widest reach of each (route, format) over HEIGHTS, the widths and
# the chroma locations: chroma rows of a 32- / 64-row tile, and chroma
# samples of a row that a tile's 64 / 32 columns (32 / 16 pairs) reach
REACH = {("general", C422): ((32, 64), (35, 19)),
         ("general", C440): ((20, 36), (70, 38)),
         ("general", C420): ((20, 36), (35, 19)),
         ("full_chroma", C444): ((32, 64), (64, 32)),
         ("full_chroma", C422): ((32, 64), (36, 20)),
         ("full_chroma", C440): ((20, 36), (64, 32)),
         ("full_chroma", C420): ((20, 36), (36, 20))}


@functools.lru_cache(maxsize=None)
def _define(name: str) -> int:
    text = "".join(p.read_text() for p in CSRC.glob("*.cu*"))
    found = re.search(rf"^#define {name} (\d+)$", text, re.M)
    assert found, f"#define {name} not found in {CSRC}"
    return int(found.group(1))


def _tile():
    return _define("TILE_ROWS"), _define("TILE_COLS")


def _tap_class(full: bool, hsize: int, vsize: int):
    """The source's choice (``planar_kernel``): the least (MAXH, MAXV)
    that holds the taps."""
    most_v = _define("PLANAR_MAX_VTAPS")
    assert 1 <= vsize <= most_v
    if full:
        assert hsize <= _define("PLANAR_FULL_MAX_HTAPS")
        return (1 if hsize == 1 else 4), (1 if vsize == 1 else most_v)
    if vsize == 1:
        assert hsize <= _define("PLANAR_ONE_ROW_MAX_HTAPS")
        return 4, 1
    assert hsize <= _define("PLANAR_GENERAL_MAX_HTAPS")
    return (4 if hsize <= 4 else 8), most_v


def _pixels() -> int:
    """A thread's pixels, of one source row (PLANAR_PIXELS)."""
    return (_define("TILE_ROWS") * _define("TILE_COLS")
            // _define("PLANAR_THREADS"))


def _direct(full: bool, maxh: int, maxv: int) -> bool:
    """The class whose threads read their own samples from the plane
    (``DIRECT``): one tap each way, 4:4:4's."""
    return maxv == 1 and maxh == 1


def _held_rows(maxv: int, quarter: bool) -> int:
    rows, cols = _tile()
    if maxv == 1:
        return cols if quarter else rows
    return _define("PLANAR_VROWS_TURNED" if quarter else "PLANAR_VROWS")


def _span(maxh: int, quarter: bool) -> int:
    return _define(f"PLANAR_SPAN_H{maxh}" + ("_TURNED" if quarter else ""))


def _reach(pos, size: int, n: int) -> int:
    """The most that n consecutive outputs' taps reach past the first's."""
    out = 0
    for c0 in range(0, len(pos), n):
        last = min(len(pos), c0 + n) - 1
        out = max(out, int(pos[last]) + size - int(pos[c0]))
    return out


@functools.lru_cache(maxsize=None)
def _vertical(chroma, location: int, depth: int, route: str):
    """(widest reach of a straight and a turned tile's rows, the vertical
    tap counts seen) over the HEIGHTS that `route` takes at `depth`."""
    rows, cols = _tile()
    full = route == "full_chroma"
    width = 9 if full and chroma != C444 else 8
    widest, sizes = [0, 0], set()
    for h in HEIGHTS:
        if kernels.frame_route(chroma, depth, h, width) != route:
            continue
        _, _, vpos, vtaps = kernels.general_filters(h, width, location,
                                                    full, chroma)
        vsize = vtaps.shape[1]
        sizes.add(vsize)
        ch = kernels.chroma_shape(chroma, h, width)[0]
        assert np.all(np.diff(vpos) >= 0) and vpos[0] >= 0
        assert vpos[-1] + vsize <= ch
        for i, n in enumerate((rows, cols)):
            widest[i] = max(widest[i], _reach(vpos, vsize, n))
    return tuple(widest), frozenset(sizes)


@functools.lru_cache(maxsize=None)
def _horizontal(chroma, location: int, depth: int, route: str):
    """(widest reach of a straight and a turned tile's columns, the
    horizontal tap counts seen) over the widths `route` takes."""
    rows, cols = _tile()
    full = route == "full_chroma"
    widths = (EVEN_WIDTHS + ODD_WIDTHS if full and chroma == C444 else
              ODD_WIDTHS if full else EVEN_WIDTHS)
    h = 17 if depth == 8 and chroma == C422 else 16
    widest, sizes = [0, 0], set()
    for w in widths:
        if kernels.frame_route(chroma, depth, h, w) != route:
            continue
        hpos, htaps, _, _ = kernels.general_filters(h, w, location, full,
                                                    chroma)
        hsize = htaps.shape[1]
        sizes.add(hsize)
        assert htaps.shape[0] == (w if full else w // 2)
        assert np.all(np.diff(hpos) >= 0) and hpos.min() >= 0
        assert (hpos + hsize).max() <= kernels.chroma_shape(chroma, h, w)[1]
        # outputs a tile holds: its columns, or its pairs
        for i, n in enumerate((cols, rows) if full else (cols // 2,
                                                         rows // 2)):
            widest[i] = max(widest[i], _reach(hpos, hsize, n))
    return tuple(widest), frozenset(sizes)


@pytest.mark.parametrize("location", sorted(kernels.CHROMA_LOCATIONS))
@pytest.mark.parametrize("route,chroma,depth", [
    (route, chroma, depth) for route, chroma, depths in FORMATS
    for depth in depths], ids=lambda v: NAMES.get(v, str(v)))
def test_planar_tile_reach_fits_its_tap_class(route, chroma, depth,
                                              location):
    """Every frame the entry takes at this format, depth and chroma
    location: its taps in one tap class, the chroma rows and the samples
    a tile's taps reach within that class's staged rows and span (the
    kernel traps past them) and within the table above, and at this
    depth the staged windows inside the BGR tile's bytes, or, where each
    thread reads its own samples (one tap each way), a thread's samples
    in one 16-byte load."""
    full = route == "full_chroma"
    (vr, vr_turned), vsizes = _vertical(chroma, location, depth, route)
    (hr, hr_turned), hsizes = _horizontal(chroma, location, depth, route)
    assert vsizes and hsizes
    want_rows, want_span = REACH[(route, chroma)]
    assert vr <= want_rows[0] and vr_turned <= want_rows[1]
    assert hr <= want_span[0] and hr_turned <= want_span[1]
    sample = 1 if depth == 8 else 2
    bgr_bytes = 4 * _define("TILE_ROWS") * (_define("TILE_COLS") + 1)
    for hsize, vsize in itertools.product(hsizes, vsizes):
        maxh, maxv = _tap_class(full, hsize, vsize)
        for quarter, rows, span in ((False, vr, hr), (True, vr_turned,
                                                      hr_turned)):
            held, most = _held_rows(maxv, quarter), _span(maxh, quarter)
            assert rows <= held and span <= most, (hsize, vsize, quarter)
            windows = (15 + most * sample + 15) // 16
            if _direct(full, maxh, maxv):
                outputs = _pixels() // (1 if full else 2)
                assert (outputs - 1 + hsize) * sample <= 16
            else:
                assert 2 * held * windows * 16 <= bgr_bytes, (maxh, maxv,
                                                              quarter)


@pytest.mark.parametrize("route,chroma", list(REACH),
                         ids=[f"{r}-{NAMES[c]}" for r, c in REACH])
def test_planar_tile_reach_is_the_table(route, chroma):
    """The widest reach over every chroma location and depth is the
    table's: the buffers are sized to what swscale's taps need."""
    depths = dict(((r, c), d) for r, c, d in FORMATS)[(route, chroma)]
    got = [[0, 0], [0, 0]]
    for location, depth in itertools.product(sorted(kernels.CHROMA_LOCATIONS),
                                             depths):
        for i, part in enumerate((_vertical, _horizontal)):
            reach = part(chroma, location, depth, route)[0]
            got[i] = [max(a, b) for a, b in zip(got[i], reach)]
    assert tuple(map(tuple, got)) == REACH[(route, chroma)]


@pytest.mark.parametrize("location", sorted(kernels.CHROMA_LOCATIONS))
def test_direct_tables_read_in_a_line(location):
    """The class that reads a thread's samples straight from the plane
    (4:4:4) takes one load a plane where the thread's columns' samples
    lie in a line (each one on from the last), else a load a sample:
    swscale's 4:4:4 tables give the line to every thread."""
    n = _pixels()
    for w in EVEN_WIDTHS + ODD_WIDTHS:
        hpos, htaps, _, _ = kernels.general_filters(16, w, location, True,
                                                    C444)
        assert htaps.shape[1] == 1
        for x0 in range(0, len(hpos), n):
            first = hpos[x0:x0 + n]
            assert np.array_equal(first - first[0],
                                  np.arange(len(first))), (w, x0)


def test_planar_wrapper_tap_limits_are_the_sources():
    """``kernels.PLANAR_MAX_TAPS`` states the source's classes' limits."""
    assert kernels.PLANAR_MAX_TAPS == {
        "rtpose_yuv_planar_general_to_bgr": (
            _define("PLANAR_ONE_ROW_MAX_HTAPS"),
            _define("PLANAR_GENERAL_MAX_HTAPS"), _define("PLANAR_MAX_VTAPS")),
        "rtpose_yuv_planar_full_chroma_to_bgr": (
            _define("PLANAR_FULL_MAX_HTAPS"), _define("PLANAR_FULL_MAX_HTAPS"),
            _define("PLANAR_MAX_VTAPS"))}


@pytest.mark.parametrize("entry,hsize,vsize,ok", [
    ("rtpose_yuv_planar_general_to_bgr", 4, 1, True),
    ("rtpose_yuv_planar_general_to_bgr", 8, 1, False),
    ("rtpose_yuv_planar_general_to_bgr", 8, 4, True),
    ("rtpose_yuv_planar_general_to_bgr", 12, 4, False),
    ("rtpose_yuv_planar_general_to_bgr", 4, 6, False),
    ("rtpose_yuv_planar_full_chroma_to_bgr", 1, 1, True),
    ("rtpose_yuv_planar_full_chroma_to_bgr", 4, 4, True),
    ("rtpose_yuv_planar_full_chroma_to_bgr", 8, 1, False),
    ("rtpose_yuv_planar_full_chroma_to_bgr", 4, 6, False)])
def test_planar_tap_check_names_the_count(entry, hsize, vsize, ok):
    if ok:
        kernels.check_planar_taps(entry, hsize, vsize)
        return
    with pytest.raises(ValueError, match=rf"{entry}: "
                       rf"{vsize if vsize > 4 else hsize} "):
        kernels.check_planar_taps(entry, hsize, vsize)


@pytest.mark.parametrize("name,full", [("yuv_planar_general_to_bgr", False),
                                       ("yuv_planar_full_chroma_to_bgr",
                                        True)])
def test_planar_wrapper_raises_before_a_launch_of_too_many_taps(
        monkeypatch, name, full):
    """A table of more taps than the entry's classes hold raises in the
    wrapper, naming the count, before any launch (on a card's tensor the
    wrapper launches; here `_route` is made to say so)."""
    h, w = 33, 66
    planes = [torch.zeros(s, dtype=torch.uint16)
              for s in [(h, w)] + [kernels.chroma_shape(C422, h, w)] * 2]
    hpos, htaps, vpos, vtaps = kernels.general_filters(h, w, 1, full, C422)
    wide = np.concatenate([htaps] + [np.zeros_like(htaps)] * 2, axis=1)
    tables = tuple(torch.from_numpy(np.ascontiguousarray(a))
                   for a in (hpos, wide, vpos, vtaps))
    launched = []
    monkeypatch.setattr(kernels, "_route", lambda t: "cuda")
    monkeypatch.setattr(kernels, "_tables_on", lambda *a, **k: tables)
    monkeypatch.setattr(kernels, "_launch", lambda *a: launched.append(a))
    with pytest.raises(ValueError, match=f"{wide.shape[1]} horizontal"):
        getattr(kernels, name)(*planes, width=w, depth=10, chroma=C422)
    assert not launched


def _planar_by_tiles(y, u, v, *, width, depth, rotation, rule, location,
                     chroma, full):
    """A model of the tiled kernels' order of work (not of their code):
    tile by tile, in the tap class the taps take, each chroma row the
    tile reaches filtered horizontally once to each of its outputs
    (columns, or pixel pairs) into an int32 buffer, clamped at 32767 there
    (at one vertical tap each source row's own row, no row shared); then
    the vertical sums of each output from that buffer in int32, and the
    route's output rule.  -> (BGR, how many filtered samples the clamp
    cut)."""
    h = y.shape[0]
    hpos, htaps, vpos, vtaps = (torch.from_numpy(a.astype(np.int64)) for a
                                in kernels.general_filters(
                                    h, width, location, full, chroma))
    hsize, vsize = htaps.shape[1], vtaps.shape[1]
    maxh, maxv = _tap_class(full, hsize, vsize)
    quarter = rotation in (90, 270)
    t_rows, t_cols = _tile()
    tile_h, tile_w = (t_cols, t_rows) if quarter else (t_rows, t_cols)
    held, most = _held_rows(maxv, quarter), _span(maxh, quarter)
    cw = kernels.chroma_shape(chroma, h, width)[1]
    planes = [c[:, :cw].to(torch.int32) for c in (u, v)]
    n_out = width if full else width // 2
    # each output's vertical sums: full chroma's, or the MMX row's and the
    # C tables' of each pair
    simd = torch.zeros(2, h, n_out, dtype=torch.int32)
    table = torch.zeros(2, h, n_out, dtype=torch.int32)
    clamped = 0
    for r0 in range(0, h, tile_h):
        rs = torch.arange(r0, min(h, r0 + tile_h))
        first = int(vpos[r0])
        rows = int(vpos[rs[-1]]) + vsize - first
        assert rows <= held
        for c0 in range(0, width, tile_w):
            tw = min(width, c0 + tile_w) - c0
            xs = (torch.arange(c0, c0 + tw) if full else
                  torch.arange(c0 // 2, (c0 + tw) // 2))
            assert int(hpos[xs[-1]]) + hsize - int(hpos[xs[0]]) <= most
            buf = torch.zeros(2, held, len(xs), dtype=torch.int32)
            for p, c in enumerate(planes):
                part = c[first:first + rows]
                hsum = sum(part[:, hpos[xs] + k] * htaps[xs, k].to(
                    torch.int32) for k in range(hsize))
                hsum = hsum >> (depth - 1)
                clamped += int((hsum > 32767).sum())
                buf[p, :rows] = hsum.clamp(max=32767)
            for p in range(2):
                s_acc = torch.zeros(len(rs), len(xs), dtype=torch.int32)
                c_acc = torch.zeros(len(rs), len(xs), dtype=torch.int32)
                for t in range(vsize):
                    c15 = buf[p, vpos[rs] - first + t]
                    tap = vtaps[rs, t, None].to(torch.int32)
                    s_acc += (c15 >> 4) if vsize == 1 else (c15 * tap) >> 16
                    c_acc += c15 * tap
                rows_at = slice(r0, r0 + len(rs))
                simd[p, rows_at, xs] = s_acc + (0 if vsize == 1 else 4)
                table[p, rows_at, xs] = c_acc
    y15 = y[:, :width].to(torch.int64) << (15 - depth)
    if full:
        cu, cv = ((table.to(torch.int64) + (1 << 9) - (128 << 19)) >> 10)
        luma = (y15 << 2) - (rule.y_offset << 6)
        luma = luma * rule.luma + (1 << 21)
        bgr = torch.stack([luma + cu * rule.ub, luma + cv * rule.vg
                           + cu * rule.ug, luma + cv * rule.vr], dim=-1)
        bgr = kernels._wrap32(bgr).clamp(0, (1 << 30) - 1) >> 22
        return kernels._turn(bgr.to(torch.uint8), rotation), clamped

    def pairs(c):
        return c.to(torch.int64).repeat_interleave(2, 1)[:, :width]

    su, sv = pairs(simd[0]) - 1024, pairs(simd[1]) - 1024
    lift = 0 if vsize == 1 else 4
    luma = ((lift + (y15 >> 4) - rule.y_offset) * rule.luma) >> 16
    bgr = torch.stack([luma + ((su * rule.ub) >> 16),
                       luma + ((su * rule.ug) >> 16) + ((sv * rule.vg) >> 16),
                       luma + ((sv * rule.vr) >> 16)], dim=-1).clamp(0, 255)
    last = slice(max(h - 2, 0), h)
    bgr[last] = kernels._table_bgr(
        ((y15[last] << 12) + (1 << 18)) >> 19,
        pairs((table[0, last] + (1 << 18)) >> 19),
        pairs((table[1, last] + (1 << 18)) >> 19), rule)
    return kernels._turn(bgr.to(torch.uint8), rotation), clamped


def _field(chroma, depth, h, w, saturated, seed):
    """Planes of a height x width picture: random samples, or 8x8 blocks
    (4x4 in chroma) of flat 0 / top samples, the top-left one at the top
    (the bicubic's overshoot at their edges reaches the clamp; Y and U at
    the top wrap BT.709's blue at full chroma)."""
    rng = np.random.RandomState(seed)
    dtype = np.uint8 if depth == 8 else np.uint16
    top = (1 << depth) - 1
    out = []
    shapes = ((h, w, 8),) + ((*kernels.chroma_shape(chroma, h, w), 4),) * 2
    for rows, cols, block in shapes:
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


# (route, chroma, depth, (h, w)): each tap class of each route, tiles
# ragged on both edges at every turn
MODEL_CASES = [
    ("general", C422, 10, (33, 66)), ("general", C422, 8, (65, 130)),
    ("general", C422, 12, (97, 194)), ("general", C440, 8, (33, 66)),
    ("general", C440, 10, (65, 130)), ("general", C420, 12, (65, 66)),
    ("full_chroma", C444, 8, (33, 65)), ("full_chroma", C444, 10, (65, 66)),
    ("full_chroma", C422, 10, (33, 65)), ("full_chroma", C422, 8, (65, 129)),
    ("full_chroma", C440, 8, (33, 65)), ("full_chroma", C440, 12, (65, 129)),
    ("full_chroma", C420, 12, (31, 47))]


@pytest.mark.parametrize("rotation", [0, 90, 180, 270])
@pytest.mark.parametrize("saturated", [False, True],
                         ids=["random", "saturated"])
@pytest.mark.parametrize(
    "route,chroma,depth,size", MODEL_CASES,
    ids=[f"{r}-{NAMES[c]}-{d}bit-{h}x{w}" for r, c, d, (h, w)
         in MODEL_CASES])
def test_planar_tile_order_equals_the_plain_version(route, chroma, depth,
                                                    size, saturated,
                                                    rotation):
    """Filtering each chroma row once a tile into the int32 buffer, with
    the clamp there, then vertically an output, gives the plain version's
    frame bit for bit: every tap class of both routes, ragged tiles on
    both edges, each turn's tiling, random fields and saturated ones
    (clamped sums where the taps overshoot, and at full chroma the 32-bit
    wrap of a bright pixel of strong chroma)."""
    h, w = size
    full = route == "full_chroma"
    assert kernels.frame_route(chroma, depth, h, w) == route
    planes = _field(chroma, depth, h, w, saturated, seed=h * w + depth)
    plain = (kernels.full_chroma_to_bgr_plain if full else
             kernels.general_to_bgr_plain)
    clamped = 0
    for (matrix, full_range), location in zip(((1, False), (2, False),
                                               (9, False), (1, True)),
                                              (0, 1, 3, 1)):
        rule = kernels.yuv_rule(matrix, full_range)
        got, cut = _planar_by_tiles(*planes, width=w, depth=depth,
                                    rotation=rotation, rule=rule,
                                    location=location, chroma=chroma,
                                    full=full)
        want = plain(*planes, width=w, depth=depth, rotation=rotation,
                     rule=rule, chroma_location=location, chroma=chroma)
        assert torch.equal(got, want), (matrix, full_range, location)
        clamped += cut
    hsize = kernels.general_filters(h, w, 1, full, chroma)[1].shape[1]
    if saturated and hsize > 1:
        assert clamped > 0           # the bicubic's overshoot
    if saturated and full:
        y, u, _ = (p.numpy().astype(np.int64) for p in planes)
        top = (1 << depth) - 1
        blue = plain(*planes, width=w, depth=depth,
                     rule=kernels.yuv_rule(1, False), chroma_location=1,
                     chroma=chroma)[..., 0].numpy()
        sx, sy = chroma
        luma = y[::1 << sy, ::1 << sx][:u.shape[0], :u.shape[1]]
        flat = (luma == top) & (u == top)
        assert flat.any() and (blue[::1 << sy, ::1 << sx][
            :u.shape[0], :u.shape[1]][flat] == 0).any()
