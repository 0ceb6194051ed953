"""What the 10-bit colour kernel's tiles assume of swscale's chroma taps.

``csrc/yuv420p10_to_bgr.cu`` converts a tile of TILE_ROWS source rows x
TILE_COLS columns (TILE_COLS x TILE_ROWS at a quarter turn).  It filters
the chroma rows ``[vpos[r0], vpos[r_last] + vsize)`` of the tile's
TILE_COLS / 2 (or TILE_ROWS / 2) chroma columns into P10_CHROMA_WORDS
samples of shared memory a plane, and keeps each column's taps ``[hpos[c],
hpos[c] + hsize)`` and each row's in registers, at most P10_MAX_TAPS.
These tests hold the tables ``kernels.general_filters`` makes at every chroma
location and many heights and widths to those sizes, read from the
sources.
"""

import re
from pathlib import Path

import numpy as np
import pytest

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
