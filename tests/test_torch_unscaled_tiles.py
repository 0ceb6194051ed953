"""A model of the unscaled colour tiles' order of work, and the kernels'
names.

``csrc/yuv_unscaled.cuh`` converts 8-bit 4:2:0 (``yuv420_to_bgr``) and
4:2:2 (``yuv422_to_bgr``) in the tiles of ``csrc/yuv_tile.cuh``, and
``csrc/yuv_planar_to_bgr.cu``'s ``gray_to_bgr_kernel`` streams 4:0:0
through the same tiles: a block owns TILE_ROWS x TILE_COLS output pixels,
each thread eight pixels of one source row, their words put into a shared
tile in the output's orientation, the tile written out a row at a time in
16-byte windows with ragged heads and tails.  The model here follows that
order (the block's ``TileMap``, each thread's pixels and the chroma row
and samples they read, the word's slot in the turned tile, the windows
that write each output row) on the CPU, with the chroma row shift read
from each kernel's ``UNSCALED_KERNEL`` line, and holds it to the plain
versions bit for bit.  A profiler finds a kernel's launches by the
wrapper's name inside the kernel's, so each colour ``__global__`` holds
the name of exactly one wrapper of ``ops/kernels.py``.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rtpose_tpu_torch.ops import kernels

CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
ROTATIONS = (0, 90, 180, 270)


@functools.lru_cache(maxsize=None)
def _sources() -> str:
    return "".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))


@functools.lru_cache(maxsize=None)
def _define(name: str) -> int:
    found = re.search(rf"^#define {name} (\d+)$", _sources(), re.M)
    assert found, f"#define {name} not found in {CSRC}"
    return int(found.group(1))


def _chroma_shift(kernel: str) -> int:
    """The chroma row shift the source instantiates `kernel` with."""
    found = re.findall(rf"^UNSCALED_KERNEL\({kernel}, (\d+)\)$", _sources(),
                       re.M)
    assert len(found) == 1, (kernel, found)
    return int(found[0])


class TileMap:
    """``tile_map`` of csrc/yuv_tile.cuh for block (by, bx)."""

    def __init__(self, height, width, rotation, by, bx):
        t_rows, t_cols = _define("TILE_ROWS"), _define("TILE_COLS")
        pitch = t_cols + 1
        quarter = rotation in (90, 270)
        rows, cols = (t_cols, t_rows) if quarter else (t_rows, t_cols)
        self.r0, self.c0 = by * rows, bx * cols
        self.th, self.tw = min(rows, height - self.r0), min(cols,
                                                            width - self.c0)
        self.rotation = rotation
        if rotation == 90:
            self.i0, self.j0 = self.c0, height - self.r0 - self.th
        elif rotation == 180:
            self.i0 = height - self.r0 - self.th
            self.j0 = width - self.c0 - self.tw
        elif rotation == 270:
            self.i0, self.j0 = width - self.c0 - self.tw, self.r0
        else:
            self.i0, self.j0 = self.r0, self.c0
        self.rows, self.cols = ((self.tw, self.th) if quarter
                                else (self.th, self.tw))
        self.out_w = height if quarter else width
        self.pitch = pitch

    def slot(self, sr, sc):
        """``tile_slot``: the tile word of source pixel (r0 + sr, c0 +
        sc)."""
        p = self.pitch
        if self.rotation == 90:
            return sc * p + self.th - 1 - sr
        if self.rotation == 180:
            return (self.th - 1 - sr) * p + self.tw - 1 - sc
        if self.rotation == 270:
            return (self.tw - 1 - sc) * p + sr
        return sr * p + sc


def _grid(height, width, rotation):
    """``tile_grid``: (blocks down, blocks across)."""
    t_rows, t_cols = _define("TILE_ROWS"), _define("TILE_COLS")
    quarter = rotation in (90, 270)
    rows, cols = (t_cols, t_rows) if quarter else (t_rows, t_cols)
    return -(-height // rows), -(-width // cols)


@functools.lru_cache(maxsize=None)
def _row_windows(n: int, head: int):
    """``store_tile``'s writes to an output row of the tile, n bytes whose
    first byte lies `head` bytes before a 16-byte boundary ((-address) &
    15): (first byte, lo, hi) of each, every byte of the row written by
    exactly one."""
    windows = 3 * _define("TILE_COLS") // 16
    writes = [(head + 16 * k, 0, 16) for k in range(windows)
              if head + 16 * k + 16 <= n]
    s = head - 16
    writes.append((s, 16 - head, min(16, n - s)))
    s = head + (n - head) // 16 * 16 if n > head else n
    writes.append((s, 0, n - s))
    hits = np.zeros(n, np.int64)
    for s, lo, hi in writes:
        if lo < hi:
            assert 0 <= s + lo and s + hi <= n
            hits[s + lo:s + hi] += 1
    assert (hits == 1).all(), (n, head, hits)
    return writes


def _by_tiles(height, width, rotation, pixel_words, threads):
    """The output of the tiled kernels' order of work: block by block,
    each thread's eight pixels of one source row (``pixel_words(sy, xs)``
    gives the words of the threads' source rows sy at their columns xs,
    from what each thread loads) into the tile slot of the turn, then
    each output row of the tile through ``store_tile``'s windows.
    Asserts that no word is read from the tile that no thread put there,
    and that each output byte is written once."""
    n_px = _define("TILE_ROWS") * _define("TILE_COLS") // threads
    quarter = rotation in (90, 270)
    out_h, out_w = (width, height) if quarter else (height, width)
    out = np.zeros(out_h * out_w * 3, np.uint8)
    written = np.zeros(out_h * out_w * 3, np.int64)
    by_n, bx_n = _grid(height, width, rotation)
    tid = np.arange(threads)
    k = np.arange(n_px)
    for by in range(by_n):
        for bx in range(bx_n):
            m = TileMap(height, width, rotation, by, bx)
            tile = np.full(_define("TILE_ROWS") * m.pitch, -1, np.int64)
            row_threads = (_define("TILE_ROWS") if quarter
                           else _define("TILE_COLS")) // n_px
            # the threads with pixels inside the picture, each its first
            # n of n_px
            sr, col = tid // row_threads, n_px * (tid % row_threads)
            mine = (sr < m.th) & (col < m.tw)
            sr, col = sr[mine], col[mine]
            inside = k < np.minimum(n_px, m.tw - col)[:, None]
            xs = np.minimum(m.c0 + col[:, None] + k, width - 1)
            words = pixel_words(m.r0 + sr, xs)
            slots = m.slot(sr[:, None], col[:, None] + k)
            tile[slots[inside]] = words[inside]
            for li in range(m.rows):
                at = 3 * ((m.i0 + li) * m.out_w + m.j0)
                n = 3 * m.cols
                words = tile[li * m.pitch:li * m.pitch + m.cols]
                assert (words >= 0).all(), (by, bx, li)
                stream = ((words[:, None] >> np.array([0, 8, 16]))
                          & 255).reshape(-1)
                for s, lo, hi in _row_windows(n, -at & 15):
                    out[at + s + lo:at + s + hi] = stream[s + lo:s + hi]
                    written[at + s + lo:at + s + hi] += 1
    assert (written == 1).all()
    return torch.from_numpy(out.reshape(out_h, out_w, 3))


def _unscaled_words(y, u, v, rule, shift):
    """A thread's pixel words of ``unscaled_tile``: luma of its eight
    pixels, each plane's samples of their pairs from chroma row sy >>
    shift, the chroma terms once a pair, int32 arithmetic."""
    y, u, v = (t.numpy().astype(np.int32) for t in (y, u, v))

    def words(sy, xs):
        """sy: threads' source rows; xs: (threads, pixels) columns."""
        # (past a ragged edge the thread reads fewer: those pixels are
        # never put)
        pairs = np.minimum(xs[:, :1] // 2 + np.arange(xs.shape[1] // 2),
                           u.shape[1] - 1)
        crow = (sy >> shift)[:, None]
        u8 = 8 * (u[crow, pairs] - 128)
        v8 = 8 * (v[crow, pairs] - 128)
        b = (u8 * rule.ub) >> 16
        g = ((u8 * rule.ug) >> 16) + ((v8 * rule.vg) >> 16)
        r = (v8 * rule.vr) >> 16
        at = np.arange(xs.shape[1]) // 2   # each pixel's pair
        yy = ((8 * y[sy[:, None], xs] - rule.y_offset) * rule.luma) >> 16
        return (np.clip(yy + b[:, at], 0, 255)
                | np.clip(yy + g[:, at], 0, 255) << 8
                | np.clip(yy + r[:, at], 0, 255) << 16).astype(np.int64)
    return words


def _gray_words(y, depth):
    """A thread's pixel words of ``gray_to_bgr_kernel``: B = G = R."""
    y = y.numpy().astype(np.int64)

    def words(sy, xs):
        g = y[sy[:, None], xs]
        if depth > 8:
            g = np.minimum(((g << (15 - depth)) + 64) >> 7, 255)
        return g * 0x010101
    return words


def _planes(chroma, depth, h, w, seed):
    rng = np.random.RandomState(seed)
    dtype = np.uint8 if depth == 8 else np.uint16
    shapes = [(h, w)] + ([] if chroma is None else
                         [kernels.chroma_shape(chroma, h, w)] * 2)
    return [torch.from_numpy(rng.randint(0, 1 << depth, s).astype(dtype))
            for s in shapes]


RULES = {"bt601-limited": (2, False), "bt709-full": (1, True)}
UNSCALED_CASES = [("yuv422_to_bgr", (2, 8)), ("yuv422_to_bgr", (34, 66)),
                  ("yuv422_to_bgr", (66, 65)), ("yuv422_to_bgr", (480, 640)),
                  ("yuv420_to_bgr", (48, 64)), ("yuv420_to_bgr", (66, 65))]


@pytest.mark.parametrize("rotation", ROTATIONS)
@pytest.mark.parametrize("rule_name", sorted(RULES))
@pytest.mark.parametrize("kernel,size", UNSCALED_CASES,
                         ids=[f"{k}-{h}x{w}" for k, (h, w) in UNSCALED_CASES])
def test_unscaled_tile_order_equals_the_plain_version(kernel, size,
                                                      rule_name, rotation):
    """The 4:2:2 and 4:2:0 unscaled kernels' tile order gives the plain
    version's frame bit for bit: 4:2:2 reads chroma row sy (4:2:0 sy >>
    1), tiles ragged on both edges and odd widths (each pixel's chroma by
    its own index) at every turn."""
    h, w = size
    chroma = kernels.CHROMA_422 if kernel == "yuv422_to_bgr" \
        else kernels.CHROMA_420
    assert kernels.frame_route(chroma, 8, h, w) == "unscaled"
    y, u, v = _planes(chroma, 8, h, w, seed=h * w + rotation)
    rule = kernels.yuv_rule(*RULES[rule_name])
    got = _by_tiles(h, w, rotation,
                    _unscaled_words(y, u, v, rule,
                                    _chroma_shift(f"{kernel}_kernel")),
                    _define("YUV_THREADS"))
    want = kernels.yuv420_to_bgr_plain(y, u, v, width=w, rotation=rotation,
                                       rule=rule, chroma=chroma)
    assert torch.equal(got, want)


GRAY_SIZES = [(9, 9), (33, 65), (65, 66)]


@pytest.mark.parametrize("rotation", ROTATIONS)
@pytest.mark.parametrize("size", GRAY_SIZES,
                         ids=[f"{h}x{w}" for h, w in GRAY_SIZES])
@pytest.mark.parametrize("depth", kernels.DEPTHS)
def test_gray_tile_order_equals_the_plain_version(depth, size, rotation):
    """The gray kernel's stream through the tile gives the plain version's
    frame bit for bit at 8, 10 and 12 bits, tiles ragged on both edges at
    every turn."""
    h, w = size
    assert kernels.frame_route(None, depth, h, w) == "gray"
    (y,) = _planes(None, depth, h, w, seed=h * w + depth + rotation)
    got = _by_tiles(h, w, rotation, _gray_words(y, depth),
                    _define("PLANAR_THREADS"))
    want = kernels.gray_to_bgr_plain(y, width=w, depth=depth,
                                     rotation=rotation)
    assert torch.equal(got, want)


@pytest.mark.parametrize("head", range(16))
def test_store_tile_writes_each_byte_of_a_row_once(head):
    """``store_tile``'s windows, ragged head and tail cover every byte of
    an output row exactly once, at each alignment of the row and every
    width a tile row has."""
    for cols in range(1, _define("TILE_COLS") + 1):
        _row_windows(3 * cols, head)


def _colour_globals() -> dict:
    """{kernel name: source file} of every ``__global__`` of the colour
    sources (``csrc/yuv*``, ``csrc/packed_to_bgr.cu``), those a macro
    defines by the names it is given."""
    texts = {p.name: p.read_text() for p in sorted(
        [*CSRC.glob("yuv*.cu*"), CSRC / "packed_to_bgr.cu"])}
    kernel = (r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
              r"(\w+)\s*\(")
    # a macro that defines a kernel: its parameters and the kernel's
    macros = {}
    for text in texts.values():
        for name, params, body in re.findall(
                r"^#define (\w+)\(([^)]*)\)((?:[^\n]*\\\n)+[^\n]*)$",
                text, re.M):
            idents = re.findall(kernel, body)
            if idents:
                macros[name] = ([p.strip() for p in params.split(",")],
                                idents[0])
    found = {}
    for where, text in texts.items():
        for ident in re.findall(kernel, text):
            if not any(ident == k for _, k in macros.values()):
                found[ident] = where
        for name, (params, ident) in macros.items():
            for args in re.findall(rf"^{name}\(([^)]*)\)$", text, re.M):
                found[args.split(",")[params.index(ident)].strip()] = where
    return found


def _colour_wrappers():
    return [fn.__name__ for fn in kernels._COUNTED
            if fn.__name__.endswith("_to_bgr")]


def test_every_colour_kernel_holds_one_wrapper_name():
    """Each colour ``__global__`` holds the name of exactly one wrapper,
    the one whose launches the profiler credits to it."""
    found = _colour_globals()
    assert {"yuv420_to_bgr_kernel", "yuv422_to_bgr_kernel",
            "gray_to_bgr_kernel"} <= set(found), found
    wrappers = _colour_wrappers()
    for kernel, where in found.items():
        holds = [w for w in wrappers if w in kernel]
        assert len(holds) == 1, (kernel, where, holds)


@pytest.mark.parametrize("wrapper", _colour_wrappers())
def test_each_colour_wrapper_names_its_own_kernels(wrapper):
    """A wrapper's name is found in its entry's kernels and in no other
    colour kernel's: the source file that defines them holds its C entry
    ``rtpose_<wrapper>``."""
    found = _colour_globals()
    mine = [k for k in found if wrapper in k]
    assert mine, (wrapper, found)
    for kernel in mine:
        text = (CSRC / found[kernel]).read_text()
        assert f"int rtpose_{wrapper}(" in text, (wrapper, kernel,
                                                  found[kernel])
