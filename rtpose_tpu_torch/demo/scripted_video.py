"""H.264 video of known pixels, for the tests and ``chip_smoke.py``: the
role ``demo/scripted_camera.py`` has for the webcam.

:func:`encode_ipcm` encodes 4:2:0 frames losslessly as H.264 whose
macroblocks are all I_PCM (``mb_type`` 25 of an I slice: the samples
themselves, byte-aligned, after the macroblock type), so any conforming
decoder gives back exactly the written Y, U and V:

- one SPS (Baseline, ``pic_order_cnt_type`` 2, one reference frame,
  frame cropping for sizes that are not whole macroblocks, VUI with
  ``max_num_reorder_frames`` 0, so that decoding order is display order)
  and one PPS (CAVLC, deblocking off in every slice: I_PCM samples are
  not filtered anyway);
- per frame one slice: an IDR I slice for a key frame, a non-IDR I slice
  for a new picture, or a P slice that is one ``mb_skip_run`` over the
  whole picture for a repeat (P_Skip with a zero vector copies the
  reference picture, the previous frame);
- emulation-prevention bytes in every NAL unit.

:func:`mux_mp4` puts the access units into an MP4 (ISO-BMFF: ``avc1``
with ``avcC``, one track, any ``tkhd`` rotation, optionally ``co64``
chunk offsets, several chunks, a composition offset shifted back by an
edit list, or any edit list); :func:`mux_fmp4` into a fragmented MP4;
:func:`mux_ts` into an MPEG transport stream (188- or 192-byte packets,
PES split and joined); :func:`annexb` gives the same stream as an
Annex-B byte stream.  The OpenCV wheels (cv2 4.13 and 5.0) have no H.264
encoder and write neither fragmented MP4 nor edit lists, so these
writers make the fixtures.

Colour: :class:`Colour` is what a stream states of its colour (the H.273
matrix, the range, primaries and transfer).  The H.264 and HEVC SPS
carry it in their VUI (``video_signal_type``), an MP4 sample entry in a
``colr`` box (:func:`colr_box`, ``nclx`` or QuickTime's ``nclc``), a
Matroska track in ``Video/Colour``.  High 10 H.264 and Main 10 HEVC
carry 10-bit PCM samples (``uint16`` planes of values below 1024);
:func:`encode_vp9` encodes VP9 (profile 2 for 10-bit planes) with the
wheel's libvpx, :func:`encode_lavc` with any of its encoders (MPEG-2's
colour in its sequence display extension).
"""

from __future__ import annotations

import os
import re
import struct
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .mp4 import (TFHD_BASE_IS_MOOF, TFHD_BASE_OFFSET, TFHD_DURATION,
                  TFHD_FLAGS, TRUN_CTS, TRUN_DATA_OFFSET, TRUN_DURATION,
                  TRUN_FIRST_FLAGS, TRUN_FLAGS, TRUN_SIZE, intra_picture)

PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_HIGH422, PROFILE_HIGH444 = 122, 244
# chroma_format_idc (H.264, HEVC) -> the chroma subsampling as log2
# (horizontal, vertical), as ops.kernels and FFmpeg's pixel formats state
# it; 0 (4:0:0) has no chroma planes
CHROMA_SUBSAMPLING = {0: None, 1: (1, 1), 2: (1, 0), 3: (0, 0)}
PROFILE_HIGH10 = 110
LOG2_MAX_POC_LSB = 8        # Main-profile streams: pic_order_cnt_type 0
LEVEL = 40                  # 4.0: 8192 macroblocks a frame, up to 2048x1024
LOG2_MAX_FRAME_NUM = 4
I_PCM = 25                  # mb_type of I_PCM in an I slice
NAL_SLICE, NAL_IDR, NAL_SPS, NAL_PPS = 1, 5, 7, 8
SLICE_P, SLICE_B, SLICE_I = 5, 6, 7   # slice_type + 5: every slice
MATRICES = {                # tkhd matrix (a, b, c, d) per cv2 rotation
    0: (1, 0, 0, 1), 90: (0, 1, -1, 0), 180: (-1, 0, 0, -1),
    270: (0, -1, 1, 0)}


class Colour(NamedTuple):
    """A stream's colour signalling (ITU-T H.273): `matrix`
    (``matrix_coefficients``; None: no colour description, the range
    alone), `full` (``video_full_range_flag``), `primaries` and
    `transfer` (2: unspecified)."""
    matrix: Optional[int] = None
    full: bool = False
    primaries: int = 2
    transfer: int = 2


def video_signal_type(b: "BitWriter", colour: Optional[Colour]) -> None:
    """The VUI's ``video_signal_type`` of H.264 and HEVC (the same
    syntax): video format 5 (unspecified), the range and, where
    `colour` has a matrix, its colour description."""
    b.u(1, int(colour is not None))
    if colour is None:
        return
    b.u(3, 5).u(1, int(colour.full)).u(1, int(colour.matrix is not None))
    if colour.matrix is not None:
        b.u(8, colour.primaries).u(8, colour.transfer).u(8, colour.matrix)


def pack_samples(samples: np.ndarray, depth: int) -> np.ndarray:
    """(n, k) samples of `depth` bits -> (n, k * depth / 8) bytes, each
    sample MSB first (PCM samples of more than 8 bits)."""
    if depth == 8:
        return samples.astype(np.uint8)
    if samples.max(initial=0) >> depth:
        raise ValueError(f"PCM samples above {depth} bits")
    shifts = np.arange(depth - 1, -1, -1, dtype=np.uint16)
    bits = ((samples[..., None].astype(np.uint16) >> shifts) & 1).astype(
        np.uint8)
    return np.packbits(bits.reshape(len(samples), -1), axis=1)


class BitWriter:
    """MSB-first bits, with H.264's Exp-Golomb codes."""

    def __init__(self):
        self.bits: List[int] = []

    def u(self, n: int, value: int) -> "BitWriter":
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def ue(self, value: int) -> "BitWriter":
        code = value + 1
        n = code.bit_length()
        return self.u(n - 1, 0).u(n, code)

    def se(self, value: int) -> "BitWriter":
        return self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align_zero(self) -> "BitWriter":
        return self.u(-len(self.bits) % 8, 0)

    def trailing(self) -> "BitWriter":
        """rbsp_trailing_bits: a stop bit, then zeros to a byte."""
        return self.u(1, 1).align_zero()

    def bytes(self) -> bytes:
        if len(self.bits) % 8:
            raise ValueError("bits not byte-aligned")
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


_EMULATION = re.compile(b"\x00\x00(?=[\x00-\x03])")


def nal(nal_type: int, ref_idc: int, rbsp: bytes) -> bytes:
    """A NAL unit (header byte + payload with emulation prevention), no
    start code or length."""
    return bytes([(ref_idc << 5) | nal_type]) + _EMULATION.sub(
        b"\x00\x00\x03", rbsp)


def _mbs(h: int, w: int) -> Tuple[int, int]:
    return (h + 15) // 16, (w + 15) // 16


def chroma_format(planes: Sequence[np.ndarray]) -> int:
    """``chroma_format_idc`` of a picture's planes (y alone: 4:0:0; else
    by the chroma planes' shape against the luma's)."""
    if len(planes) == 1:
        return 0
    (h, w), c = planes[0].shape, planes[1].shape
    for idc, (sx, sy) in ((1, (1, 1)), (2, (1, 0)), (3, (0, 0))):
        if c == (-(-h >> sy), -(-w >> sx)):
            return idc
    raise ValueError(f"chroma planes {c} of a {h}x{w} picture: 4:2:0, "
                     f"4:2:2 or 4:4:4 are written")


def _check_size(h: int, w: int, chroma: int) -> None:
    """A picture's size against the crop units of `chroma`
    (``SubWidthC`` x ``SubHeightC``: a 4:2:0 picture is of even height
    and width, a 4:2:2 one of even width)."""
    sx, sy = CHROMA_SUBSAMPLING[chroma] or (0, 0)
    if h <= 0 or w <= 0 or h % (1 << sy) or w % (1 << sx):
        raise ValueError(f"{['4:0:0', '4:2:0', '4:2:2', '4:4:4'][chroma]} "
                         f"frames have an even "
                         f"{'size' if sy else 'width'}, got {h}x{w}")


def sps(h: int, w: int, main: bool = False,
        reorder: Optional[int] = 0, colour: Optional[Colour] = None,
        depth: int = 8, chroma: int = 1) -> bytes:
    """The SPS: Baseline, ``pic_order_cnt_type`` 2, one reference; or
    `main`: Main profile, ``pic_order_cnt_type`` 0 (each slice carries its
    ``pic_order_cnt_lsb``), two references, for B pictures; `depth` 10:
    High 10 (``bit_depth_*_minus8`` 2, 10-bit I_PCM samples); `chroma`
    (``chroma_format_idc``) 2: High 4:2:2, 3: High 4:4:4 (the cameras'
    intra formats), at 8 or 10 bits.  `reorder` is the VUI's
    ``max_num_reorder_frames``, `colour` its ``video_signal_type``; with
    neither, no VUI is written, as many phone encoders do, and the
    decoder guesses the delay."""
    if chroma not in (1, 2, 3):
        raise ValueError(f"H.264 of chroma_format_idc {chroma}: 1-3 are "
                         f"written")
    _check_size(h, w, chroma)
    if depth not in (8, 10):
        raise ValueError(f"H.264 of {depth} bits: 8 or 10 are written")
    mbh, mbw = _mbs(h, w)
    high = depth == 10 or chroma != 1
    profile = ({2: PROFILE_HIGH422, 3: PROFILE_HIGH444}.get(chroma)
               or (PROFILE_HIGH10 if depth == 10 else
                   PROFILE_MAIN if main else PROFILE_BASELINE))
    b = BitWriter().u(8, profile)
    b.u(8, 0 if high else 0x40 if main else 0xC0).u(8, LEVEL)
    b.ue(0)                                   # seq_parameter_set_id
    if high:                                  # no scaling matrices
        b.ue(chroma)
        if chroma == 3:
            b.u(1, 0)                         # separate_colour_plane_flag
        b.ue(depth - 8).ue(depth - 8).u(1, 0).u(1, 0)
    b.ue(LOG2_MAX_FRAME_NUM - 4)
    if main:
        b.ue(0).ue(LOG2_MAX_POC_LSB - 4)      # pic_order_cnt_type 0
    else:
        b.ue(2)                               # pic_order_cnt_type
    b.ue(2 if main else 1)                    # max_num_ref_frames
    b.u(1, 0)                                 # gaps_in_frame_num_allowed
    b.ue(mbw - 1).ue(mbh - 1)
    b.u(1, 1).u(1, 1)                         # frame_mbs_only, direct_8x8
    sx, sy = CHROMA_SUBSAMPLING[chroma]       # crop units: SubWidthC, ...
    crop_x, crop_y = (16 * mbw - w) >> sx, (16 * mbh - h) >> sy
    b.u(1, int(bool(crop_x or crop_y)))
    if crop_x or crop_y:
        b.ue(0).ue(crop_x).ue(0).ue(crop_y)
    vui = reorder is not None or colour is not None
    b.u(1, int(vui))                          # vui_parameters_present
    if vui:
        b.u(1, 0).u(1, 0)                     # aspect, overscan
        video_signal_type(b, colour)
        b.u(1, 0)                             # chroma_loc_info
        b.u(1, 0).u(1, 0).u(1, 0).u(1, 0)     # timing, nal/vcl hrd, pic_struct
        b.u(1, int(reorder is not None))      # bitstream_restriction
        if reorder is not None:
            b.u(1, 1).ue(0).ue(0).ue(16).ue(16)   # mv bounds, bytes, mv
            b.ue(reorder).ue(reorder + 1)     # reorder, dec buffering
    return nal(NAL_SPS, 3, b.trailing().bytes())


def pps() -> bytes:
    b = BitWriter().ue(0).ue(0)               # pps id, sps id
    b.u(1, 0).u(1, 0).ue(0)                   # CAVLC, no field POC, 1 group
    b.ue(0).ue(0).u(1, 0).u(2, 0)             # refs l0/l1, no weighting
    b.se(0).se(0).se(0)                       # QP, QS, chroma offset
    b.u(1, 1).u(1, 0).u(1, 0)                 # deblocking control present
    return nal(NAL_PPS, 3, b.trailing().bytes())


def _header(kind: str, frame_num: int, idr_id: int,
            poc: Optional[int] = None) -> BitWriter:
    """A slice header of `kind` ("IDR", "I", "P" or "B", the last a
    non-reference picture); `poc` is its picture order count where the
    SPS has ``pic_order_cnt_type`` 0."""
    slice_type = {"P": SLICE_P, "B": SLICE_B}.get(kind, SLICE_I)
    b = BitWriter().ue(0).ue(slice_type).ue(0)
    b.u(LOG2_MAX_FRAME_NUM, frame_num % (1 << LOG2_MAX_FRAME_NUM))
    if kind == "IDR":
        b.ue(idr_id)
    if poc is not None:
        b.u(LOG2_MAX_POC_LSB, poc % (1 << LOG2_MAX_POC_LSB))
    if kind == "B":
        b.u(1, 1)                             # direct_spatial_mv_pred
    if kind in ("P", "B"):
        b.u(1, 0).u(1, 0)                     # no ref override, no reorder
    if kind == "B":
        b.u(1, 0)                             # no list 1 reorder
    elif kind == "IDR":
        b.u(1, 0).u(1, 0)                     # dec_ref_pic_marking
    else:
        b.u(1, 0)                             # sliding window
    return b.se(0).ue(1)                      # slice_qp_delta, no deblock


def pcm_macroblocks(y: np.ndarray, *chroma: np.ndarray, depth: int = 8
                    ) -> np.ndarray:
    """(n_mb, samples * depth / 8) uint8: each 16x16 macroblock's (or
    coding unit's) 256 luma samples, then its Cb and its Cr samples (8x8
    each at 4:2:0, 8 wide and 16 high at 4:2:2, 16x16 at 4:4:4), each in
    raster order (`depth` bits each, packed MSB first; no chroma planes:
    the luma alone), the planes padded to whole macroblocks by repeating
    their last row and column."""
    h, w = y.shape
    mbh, mbw = _mbs(h, w)
    sx, sy = CHROMA_SUBSAMPLING[chroma_format((y, *chroma))] or (0, 0)
    bh, bw = 16 >> sy, 16 >> sx

    def blocks(p, bh, bw):
        p = np.pad(p, ((0, bh * mbh - p.shape[0]), (0, bw * mbw - p.shape[1])),
                   mode="edge")
        return p.reshape(mbh, bh, mbw, bw).transpose(0, 2, 1, 3).reshape(
            -1, bh * bw)

    parts = [blocks(y, 16, 16)] + [blocks(c, bh, bw) for c in chroma]
    return pack_samples(np.concatenate(parts, axis=1), depth)


def ipcm_slice(kind: str, frame_num: int, idr_id: int,
               planes: Optional[Tuple[np.ndarray, ...]], n_mb: int,
               poc: Optional[int] = None, depth: int = 8) -> bytes:
    """One slice NAL unit of a picture: `kind` "IDR" or "I" with `planes`
    (y, u, v) as I_PCM macroblocks of `depth`-bit samples, or "P"
    skipping all `n_mb`, or "B"
    (a non-reference picture) skipping all `n_mb`: B_Skip with spatial
    direct prediction from the two anchors around it, each sample their
    rounded mean."""
    b = _header(kind, frame_num, idr_id, poc)
    if kind in ("P", "B"):
        b.ue(n_mb)                            # mb_skip_run: all of them
        return nal(NAL_SLICE, 2 if kind == "P" else 0,
                   b.trailing().bytes())
    # the first macroblock's type follows the header bits; every later one
    # starts byte-aligned after the previous samples: ue(25) = 0000 1101 0
    # and seven alignment zeros, the bytes 0x0d 0x00
    head = b.ue(I_PCM).align_zero().bytes()
    mbs = pcm_macroblocks(*planes, depth=depth)
    body = np.empty((len(mbs), 2 + mbs.shape[1]), np.uint8)
    body[:, :2] = (0x0D, 0x00)
    body[:, 2:] = mbs
    rbsp = head + body.reshape(-1)[2:].tobytes() + b"\x80"
    return nal(NAL_IDR if kind == "IDR" else NAL_SLICE, 3, rbsp)


def encode_ipcm(frames: Sequence[Optional[Tuple[np.ndarray, ...]]],
                key_every: int = 0, colour: Optional[Colour] = None,
                depth: int = 8) -> Tuple[bytes, bytes, List[bytes],
                                         List[bool]]:
    """(sps, pps, access units, key flags) of `frames`: each a (y, u, v)
    tuple of planes ((h, w), (h/2, w/2) twice at 4:2:0; (h, w/2) at
    4:2:2 (High 4:2:2), (h, w) at 4:4:4 (High 4:4:4); uint8, or uint16 of
    `depth` 10 bits: High 10 at 4:2:0) or None to repeat the previous
    picture (a P slice of skips).  The first frame and every
    `key_every`-th (0: only the first) are IDR pictures; `colour` goes to
    the SPS's VUI."""
    if frames[0] is None:
        raise ValueError("the first frame has to be a picture")
    h, w = frames[0][0].shape
    chroma = chroma_format(frames[0])
    _check_size(h, w, chroma)
    mbh, mbw = _mbs(h, w)
    n_mb = mbh * mbw
    units, keys = [], []
    frame_num = idr_id = 0
    for i, planes in enumerate(frames):
        idr = i == 0 or (key_every and i % key_every == 0)
        if idr:
            if planes is None:
                raise ValueError(f"frame {i} is a key frame and has no "
                                 f"picture")
            frame_num = 0
        kind = "IDR" if idr else ("P" if planes is None else "I")
        if planes is not None and (planes[0].shape != (h, w) or any(
                c.shape != frames[0][1].shape for c in planes[1:])):
            raise ValueError(f"frame {i}: planes {[c.shape for c in planes]}"
                             f" are not those of frame 0")
        units.append(ipcm_slice(kind, frame_num, idr_id, planes, n_mb,
                                depth=depth))
        keys.append(bool(idr))
        idr_id ^= int(bool(idr))
        frame_num += 1
    return (sps(h, w, colour=colour, depth=depth, chroma=chroma), pps(),
            units, keys)


def encode_ipcm_bframes(anchors: Sequence[Tuple[np.ndarray, ...]],
                        reorder: Optional[int] = 1, poc_step: int = 2
                        ) -> Tuple[bytes, bytes, List[bytes], List[bool],
                                   List[int], List[Tuple[np.ndarray, ...]]]:
    """A Main-profile stream of I_PCM anchors with one B picture between
    each two, as cameras and phones encode (IBP... in display order):
    (sps, pps, access units in decode order, key flags, each unit's
    display index, the frames in display order).  The anchors are
    reference I pictures (the first an IDR); each B picture is wholly
    B_Skip, so each of its samples is ``(a + b + 1) >> 1`` of the anchors
    before and after it: known pixels.  Decode order is A0 A1 B A2 B ...;
    the picture order count is `poc_step` times the display index (2, as
    x264 and most encoders write it).  `reorder` goes to the SPS (None:
    no VUI, the decoder guesses the delay)."""
    h, w = anchors[0][0].shape
    mbh, mbw = _mbs(h, w)
    n_mb = mbh * mbw
    units = [ipcm_slice("IDR", 0, 0, anchors[0], n_mb, poc=0)]
    shown, order = [anchors[0]], [0]
    for k in range(1, len(anchors)):
        a, b = anchors[k - 1], anchors[k]
        units.append(ipcm_slice("I", k, 0, b, n_mb,
                                poc=poc_step * 2 * k))
        units.append(ipcm_slice("B", k + 1, 0, None, n_mb,
                                poc=poc_step * (2 * k - 1)))
        order += [2 * k, 2 * k - 1]
        shown += [tuple(((x.astype(np.uint16) + y + 1) >> 1).astype(np.uint8)
                        for x, y in zip(a, b)), b]
    keys = [True] + [False] * (len(units) - 1)
    return (sps(h, w, main=True, reorder=reorder), pps(), units, keys,
            order, shown)


def annexb(sps_nal: bytes, pps_nal: bytes, units: Sequence[bytes]) -> bytes:
    """The stream as Annex-B: start codes, parameter sets first."""
    return b"".join(b"\x00\x00\x00\x01" + n for n in (sps_nal, pps_nal,
                                                      *units))


# ---------------------------------------------------------------------------
# HEVC of known pixels: PCM coding units under a minimal CABAC encoder
# ---------------------------------------------------------------------------

HEVC_TRAIL_R, HEVC_IDR_W_RADL = 1, 19
HEVC_VPS, HEVC_SPS, HEVC_PPS = 32, 33, 34
HEVC_SLICE_P, HEVC_SLICE_I = 1, 2
HEVC_CTB = 16               # CTB = minimum CB = PCM block: 16x16
HEVC_LEVEL = 120            # 4.0
HEVC_LOG2_MAX_POC_LSB = 8
HEVC_QP = 26                # SliceQpY: init_qp 26, no delta
# initValue of the contexts used (H.265 Tables 9-11 and 9-9): part_mode's
# first bin in an I slice; cu_skip_flag's three in a P slice (initType 1)
HEVC_PART_MODE_I = 184
HEVC_CU_SKIP_P = (197, 185, 201)
# H.265 Table 9-52 (rangeTabLps[pStateIdx][qRangeIdx]) and Table 9-53
# (transIdxLps), the tables H.264 has too
RANGE_TAB_LPS = (
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216),
    (123, 150, 178, 205), (116, 142, 169, 195), (111, 135, 160, 185),
    (105, 128, 152, 175), (100, 122, 144, 166), (95, 116, 137, 158),
    (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116),
    (66, 80, 95, 110), (62, 76, 90, 104), (59, 72, 86, 99),
    (56, 69, 81, 94), (53, 65, 77, 89), (51, 62, 73, 85),
    (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72),
    (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62),
    (35, 43, 51, 59), (33, 41, 48, 56), (32, 39, 46, 53),
    (30, 37, 43, 50), (29, 35, 41, 48), (27, 33, 39, 45),
    (26, 31, 37, 43), (24, 30, 35, 41), (23, 28, 33, 39),
    (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33),
    (19, 23, 27, 31), (18, 22, 26, 30), (17, 21, 25, 28),
    (16, 20, 23, 27), (15, 19, 22, 25), (14, 18, 21, 24),
    (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21),
    (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18),
    (10, 12, 15, 17), (10, 12, 14, 16), (9, 11, 13, 15),
    (9, 11, 12, 14), (8, 10, 12, 14), (8, 9, 11, 13),
    (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9), (2, 2, 2, 2))
TRANS_IDX_LPS = (
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15,
    16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27, 27,
    28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35, 35, 36,
    36, 36, 37, 37, 37, 38, 38, 63)


def cabac_context(init_value: int, qp: int = HEVC_QP) -> List[int]:
    """[pStateIdx, valMps] of a context from its initValue (H.265
    9.3.2.2)."""
    m = (init_value >> 4) * 5 - 45
    n = ((init_value & 15) << 3) - 16
    pre = min(126, max(1, ((m * min(51, max(0, qp))) >> 4) + n))
    return [pre - 64, 1] if pre > 63 else [63 - pre, 0]


class CabacEncoder:
    """The arithmetic encoder of H.265 9.3.4.3 (H.264 9.3.4.2):
    ``EncodeDecision``, ``EncodeTerminate`` with ``EncodeFlush``, and the
    bits it has written.  :meth:`start` is ``InitEncoder``, also what a
    PCM coding unit's samples are followed by (9.3.2.5)."""

    def __init__(self):
        self.bits: List[int] = []
        self.start()

    def start(self) -> None:
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def _put(self, bit: int) -> None:
        if self.first:
            self.first = False
        else:
            self.bits.append(bit)
        if self.outstanding:
            self.bits += [1 - bit] * self.outstanding
            self.outstanding = 0

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: List[int], bin_val: int) -> None:
        """Encode `bin_val` in context `ctx` ([pStateIdx, valMps],
        updated in place)."""
        state, mps = ctx
        lps = RANGE_TAB_LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        if bin_val != mps:
            self.low += self.range
            self.range = lps
            if state == 0:
                ctx[1] = 1 - mps
            ctx[0] = TRANS_IDX_LPS[state]
        else:
            ctx[0] = min(state + 1, 62)
        self._renorm()

    def terminate(self, bin_val: int) -> None:
        """A terminating bin (pcm_flag, end_of_slice_segment_flag); 1
        flushes, the last bit written a 1 (the slice's stop bit, or the
        one before a PCM unit's alignment bits)."""
        self.range -= 2
        if not bin_val:
            self._renorm()
            return
        self.low += self.range
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.bits += [(self.low >> 8) & 1, 1]

    def take(self) -> bytes:
        """The bits written, zero-padded to a byte; cleared."""
        out = self.bits + [0] * (-len(self.bits) % 8)
        self.bits = []
        return np.packbits(np.array(out, np.uint8)).tobytes()


def hevc_nal(nal_type: int, rbsp: bytes) -> bytes:
    """An HEVC NAL unit: the two-byte header (layer 0, temporal id 0) and
    the payload with emulation prevention."""
    return bytes([nal_type << 1, 1]) + _EMULATION.sub(b"\x00\x00\x03", rbsp)


def profile_tier_level(profile: int) -> BitWriter:
    """profile_tier_level(1, 0), 12 bytes (also the ``hvcC`` record's):
    `profile` (1 Main, 2 Main 10), Main tier, progressive frames, level
    4."""
    b = BitWriter().u(2, 0).u(1, 0).u(5, profile)
    b.u(32, (1 << (31 - profile)) | (1 << 29 if profile == 1 else 0))
    b.u(1, 1).u(1, 0).u(1, 0).u(1, 1)         # progressive, frame only
    b.u(43, 0).u(1, 0)                        # constraint flags, inbld
    return b.u(8, HEVC_LEVEL)


def hevc_vps(reorder: int = 0, profile: int = 1) -> bytes:
    b = BitWriter().u(4, 0).u(1, 1).u(1, 1)   # id, base layer internal,
    b.u(6, 0).u(3, 0).u(1, 1).u(16, 0xFFFF)   # available; one layer
    b.bits += profile_tier_level(profile).bits
    b.u(1, 1).ue(reorder + 1).ue(reorder).ue(0)   # sub-layer ordering
    b.u(6, 0).ue(0).u(1, 0).u(1, 0)           # layer id, sets, no timing
    return hevc_nal(HEVC_VPS, b.trailing().bytes())


def hevc_profile(depth: int, chroma: int = 1) -> int:
    """general_profile_idc: 1 Main, 2 Main 10, 4 format range extensions
    (12-bit, 4:0:0, 4:2:2, 4:4:4)."""
    return 1 if (depth, chroma) == (8, 1) else 2 if (depth, chroma) == (
        10, 1) else 4


def hevc_sps(h: int, w: int, reorder: int = 0, depth: int = 8,
             colour: Optional[Colour] = None, chroma: int = 1) -> bytes:
    """The SPS: `chroma` (``chroma_format_idc``: 1 4:2:0, 0 4:0:0, 2
    4:2:2, 3 4:4:4) of `depth` bits (8: Main; 10: Main 10; 12 and the
    other chroma formats: RExt) with PCM samples of `depth` bits,
    pictures of whole 16x16 CTBs with a conformance window down to h x w
    (in units of the chroma subsampling: odd heights at 4:2:2, odd sizes
    at 4:4:4 and 4:0:0), CTB = minimum CB = PCM size 16, no loop filter
    on PCM samples, no SAO, AMP, scaling lists or temporal MVP; `reorder`
    as ``sps_max_num_reorder_pics``; two short-term reference picture
    sets: 0 empty, 1 the picture one POC before; `colour` in a VUI (None:
    no VUI)."""
    _check_size(h, w, chroma)
    ch, cw = -(-h // HEVC_CTB) * HEVC_CTB, -(-w // HEVC_CTB) * HEVC_CTB
    sx, sy = CHROMA_SUBSAMPLING[chroma] or (0, 0)
    b = BitWriter().u(4, 0).u(3, 0).u(1, 1)   # vps id, sub layers, nesting
    b.bits += profile_tier_level(hevc_profile(depth, chroma)).bits
    b.ue(0).ue(chroma)                        # sps id, chroma format
    if chroma == 3:
        b.u(1, 0)                             # separate_colour_plane_flag
    b.ue(cw).ue(ch)
    b.u(1, int(ch != h or cw != w))           # conformance window
    if ch != h or cw != w:                    # in SubWidthC x SubHeightC
        b.ue(0).ue((cw - w) >> sx).ue(0).ue((ch - h) >> sy)
    b.ue(depth - 8).ue(depth - 8)
    b.ue(HEVC_LOG2_MAX_POC_LSB - 4)
    b.u(1, 1).ue(reorder + 1).ue(reorder).ue(0)   # sub-layer ordering
    b.ue(1).ue(0)                             # min CB 16, CTB 16
    b.ue(0).ue(2).ue(0).ue(0)                 # TB 4..16, depths 0
    b.u(1, 0).u(1, 0).u(1, 0)                 # scaling list, AMP, SAO
    b.u(1, 1).u(4, depth - 1).u(4, depth - 1)   # PCM samples of `depth`
    b.ue(1).ue(0).u(1, 1)                     # PCM 16x16, no loop filter
    b.ue(2)                                   # num_short_term_ref_pic_sets
    b.ue(0).ue(0)                             # 0: no pictures
    b.u(1, 0).ue(1).ue(0).ue(0).u(1, 1)       # 1: POC - 1, used
    b.u(1, 0).u(1, 0).u(1, 0)                 # long-term, TMVP, smoothing
    b.u(1, int(colour is not None))           # vui_parameters_present
    if colour is not None:
        b.u(1, 0).u(1, 0)                     # aspect, overscan
        video_signal_type(b, colour)
        b.u(1, 0).u(1, 0).u(1, 0).u(1, 0)     # chroma loc, neutral, field,
        b.u(1, 0).u(1, 0).u(1, 0)             # frame field; window, timing,
                                              # bitstream restriction
    b.u(1, 0)                                 # no extensions
    return hevc_nal(HEVC_SPS, b.trailing().bytes())


def hevc_pps() -> bytes:
    b = BitWriter().ue(0).ue(0)               # pps id, sps id
    b.u(1, 0).u(1, 0).u(3, 0)                 # dependent, output, extra
    b.u(1, 0).u(1, 0).ue(0).ue(0)             # sign hiding, cabac init,
    b.se(0).u(1, 0).u(1, 0).u(1, 0)           # refs; QP 26, no cu_qp_delta
    b.se(0).se(0).u(1, 0)                     # chroma QP offsets
    b.u(1, 0).u(1, 0).u(1, 0)                 # weighting, bypass
    b.u(1, 0).u(1, 0).u(1, 0)                 # tiles, WPP, across slices
    b.u(1, 1).u(1, 0).u(1, 1)                 # deblocking off, no override
    b.u(1, 0).u(1, 0).ue(0).u(1, 0).u(1, 0)   # lists, merge level, ext
    return hevc_nal(HEVC_PPS, b.trailing().bytes())


def hevc_slice(kind: str, poc: int, planes: Optional[Tuple[np.ndarray, ...]],
               h: int, w: int, depth: int = 8) -> bytes:
    """One picture as one slice NAL unit: `kind` "IDR" (IDR_W_RADL) or "I"
    (TRAIL_R, no references) with `planes` (y, u, v) as PCM coding units
    (``part_mode`` 2Nx2N, ``pcm_flag``, the samples); or "P" (TRAIL_R
    referring to POC - 1) whose every CU is skipped: one merge candidate,
    the zero vector, a copy of the picture before.  `poc` is the
    picture order count (IDR: 0); the PCM samples have `depth` bits (the
    luma alone where `planes` is (y,): 4:0:0)."""
    nal_type = HEVC_IDR_W_RADL if kind == "IDR" else HEVC_TRAIL_R
    slice_type = HEVC_SLICE_P if kind == "P" else HEVC_SLICE_I
    b = BitWriter().u(1, 1)                   # first slice segment
    if kind == "IDR":
        b.u(1, 0)                             # no_output_of_prior_pics
    b.ue(0).ue(slice_type)
    if kind != "IDR":
        b.u(HEVC_LOG2_MAX_POC_LSB, poc % (1 << HEVC_LOG2_MAX_POC_LSB))
        b.u(1, 1).u(1, int(kind == "P"))      # the SPS's RPS 0 or 1
    if kind == "P":
        b.u(1, 0).ue(4)                       # no override, one merge cand
    b.se(0)                                   # slice_qp_delta
    head = b.u(1, 1).align_zero().bytes()     # byte_alignment()
    rows, cols = -(-h // HEVC_CTB), -(-w // HEVC_CTB)
    n = rows * cols
    cabac = CabacEncoder()
    parts = [head]
    if kind == "P":
        skip = [cabac_context(v) for v in HEVC_CU_SKIP_P]
        for i in range(n):
            r, c = divmod(i, cols)
            cabac.decision(skip[int(r > 0) + int(c > 0)], 1)
            cabac.terminate(int(i == n - 1))  # end_of_slice_segment_flag
        parts.append(cabac.take())
    else:
        part_mode = cabac_context(HEVC_PART_MODE_I)
        cus = pcm_macroblocks(*planes, depth=depth)
        for i in range(n):
            if i:
                cabac.terminate(0)            # end_of_slice_segment_flag
            cabac.decision(part_mode, 1)      # PART_2Nx2N
            cabac.terminate(1)                # pcm_flag
            parts.append(cabac.take())        # pcm_alignment_zero_bits
            parts.append(cus[i].tobytes())
            cabac.start()
        cabac.terminate(1)
        parts.append(cabac.take())
    return hevc_nal(nal_type, b"".join(parts))


class HevcStream(NamedTuple):
    vps: bytes
    sps: bytes
    pps: bytes
    units: List[bytes]       # one slice NAL unit a picture, decode order
    keys: List[bool]         # IDR pictures
    order: List[int]         # each unit's display index
    shown: List[Tuple[np.ndarray, ...]]     # the pictures in display order
    size: Tuple[int, int]    # (w, h)
    depth: int               # 8 (Main), 10 (Main 10) or 12
    chroma: int = 1          # chroma_format_idc: 1 4:2:0, 0 4:0:0

    @property
    def params(self) -> List[bytes]:
        return [self.vps, self.sps, self.pps]


def encode_hevc_pcm(frames: Sequence[Optional[Tuple[np.ndarray, ...]]],
                    key_every: int = 0, reorder: bool = False,
                    depth: int = 8, colour: Optional[Colour] = None,
                    chroma: int = 1) -> HevcStream:
    """HEVC of `frames` (see :func:`encode_ipcm`: (y, u, v) planes, or None
    to repeat the picture before), every sample PCM so that a decoder
    gives back exactly the written Y, U and V: the first frame and every
    `key_every`-th (0: only the first) an IDR picture, the other pictures
    intra TRAIL_R pictures, the repeats P pictures of skipped CUs.
    `reorder` writes the pictures after the IDR in pairs swapped in
    decode order (POC 0, 2, 1, 4, 3, ...; ``sps_max_num_reorder_pics`` 1):
    the decoder puts them back by POC.  `depth` 10 writes Main 10 and 12
    a 12-bit RExt stream, their planes uint16 of that many bits (PCM
    samples of `depth` bits); `colour` goes to the SPS's VUI; `chroma` 0
    writes 4:0:0 (the luma of each frame alone); 4:2:2 and 4:4:4 frames
    (their chroma planes (h, w/2) and (h, w)) write RExt 4:2:2 and 4:4:4
    (``chroma`` is then taken from the planes)."""
    if frames[0] is None:
        raise ValueError("the first frame has to be a picture")
    h, w = frames[0][0].shape
    if chroma:
        chroma = chroma_format(frames[0])
    for i, planes in enumerate(frames):
        if planes is not None and (planes[0].shape != (h, w) or any(
                c.shape != frames[0][1].shape for c in planes[1:])):
            raise ValueError(f"frame {i}: planes {[c.shape for c in planes]}"
                             f" are not those of frame 0")
    shown: List[Tuple[np.ndarray, ...]] = []
    for planes in frames:
        shown.append(shown[-1] if planes is None else planes)
    decode = list(range(len(frames)))
    if reorder:
        if any(p is None for p in frames):
            raise ValueError("a reordered stream holds no repeats")
        for k in range(1, len(frames) - 1, 2):
            decode[k], decode[k + 1] = decode[k + 1], decode[k]
    units, keys = [], []
    idr = 0
    for i in decode:
        key = i == 0 or bool(key_every and i % key_every == 0)
        if key:
            if frames[i] is None:
                raise ValueError(f"frame {i} is a key frame and has no "
                                 f"picture")
            idr = i
        kind = "IDR" if key else ("P" if frames[i] is None else "I")
        planes = frames[i] if chroma or frames[i] is None else frames[i][:1]
        units.append(hevc_slice(kind, i - idr, planes, h, w, depth))
        keys.append(key)
    r = int(reorder)
    return HevcStream(hevc_vps(r, hevc_profile(depth, chroma)),
                      hevc_sps(h, w, r, depth, colour, chroma), hevc_pps(),
                      units, keys, decode, shown, (w, h), depth, chroma)


def hevc_annexb(stream: HevcStream) -> bytes:
    """The stream as Annex-B: start codes, parameter sets first."""
    return b"".join(b"\x00\x00\x00\x01" + n
                    for n in (*stream.params, *stream.units))


# ---------------------------------------------------------------------------
# MP4 (ISO-BMFF) muxing
# ---------------------------------------------------------------------------

def box(kind: bytes, *payload: bytes) -> bytes:
    data = b"".join(payload)
    return struct.pack(">I4s", 8 + len(data), kind) + data


def full_box(kind: bytes, version: int, flags: int, *payload: bytes
             ) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def _matrix(rotation: int) -> bytes:
    a, b, c, d = MATRICES[rotation]
    return struct.pack(">9i", a << 16, b << 16, 0, c << 16, d << 16, 0,
                       0, 0, 1 << 30)


def visual_entry(kind: bytes, size: Tuple[int, int], *config: bytes
                 ) -> bytes:
    """An ``stsd`` VisualSampleEntry of `kind` for (w, h) frames."""
    w, h = size
    return box(kind, b"\0" * 6, struct.pack(">H", 1), b"\0" * 16,
               struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1),
               b"\0" * 32, struct.pack(">Hh", 0x18, -1), *config)


def vp09_entry(size: Tuple[int, int], profile: int = 0, depth: int = 8,
               chroma: int = 1, kind: bytes = b"vp09") -> bytes:
    """A ``vp09`` (or, `kind`, ``vp08``) sample entry with its ``vpcC``
    (VP Codec ISO Media File Format Binding 1.0: profile, level 3.1, bit
    depth, `chroma` subsampling (1: 4:2:0 colocated, 2: 4:2:2, 3: 4:4:4),
    BT.709)."""
    return visual_entry(kind, size, full_box(
        b"vpcC", 1, 0, bytes([profile, 31, (depth << 4) | (chroma << 1), 1,
                              1, 1]), b"\0\0"))


def colr_box(colour: Colour, kind: bytes = b"nclx") -> bytes:
    """A sample entry's ``colr`` box: ISO's ``nclx`` (primaries, transfer,
    matrix, the full-range bit) or QuickTime's ``nclc`` (no range bit);
    a `colour` with no matrix states 2, unspecified."""
    matrix = 2 if colour.matrix is None else colour.matrix
    tail = bytes([0x80 if colour.full else 0]) if kind == b"nclx" else b""
    return box(b"colr", kind, struct.pack(">HHH", colour.primaries,
                                          colour.transfer, matrix), tail)


def avcc(sps_nal: bytes, pps_nal: bytes) -> bytes:
    return box(b"avcC", bytes([1, sps_nal[1], sps_nal[2], sps_nal[3], 0xFF,
                               0xE1]),
               struct.pack(">H", len(sps_nal)), sps_nal, b"\x01",
               struct.pack(">H", len(pps_nal)), pps_nal)


def _stbl(entry: bytes, samples: Sequence[bytes], keys: Sequence[bool],
          delta: int, offsets: Sequence[int], per: int, co64: bool,
          ctts: Optional[Sequence[int]]) -> bytes:
    """An ``stbl`` of `samples` (in chunks of `per` at `offsets`), each
    `delta` long, with their composition offsets `ctts` (None: no
    ``ctts``) and sync samples."""
    n = len(samples)
    stbl = [full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
            full_box(b"stts", 0, 0, struct.pack(">I", 1 if n else 0),
                     struct.pack(">II", n, delta) if n else b"")]
    if ctts is not None:
        signed = any(off < 0 for off in ctts)
        stbl.append(full_box(b"ctts", int(signed), 0, struct.pack(
            f">I{2 * n}{'i' if signed else 'I'}", n,
            *(v for off in ctts for v in (1, off)))))
    sync = [i + 1 for i, k in enumerate(keys) if k]
    stbl.append(full_box(b"stss", 0, 0, struct.pack(
        f">I{len(sync)}I", len(sync), *sync)))
    stsc = [(1, per, 1)] if n else []
    if n and n % per and len(offsets) > 1:
        stsc.append((len(offsets), n % per, 1))
    stbl.append(full_box(b"stsc", 0, 0, struct.pack(">I", len(stsc)),
                         *(struct.pack(">III", *e) for e in stsc)))
    stbl.append(full_box(b"stsz", 0, 0, struct.pack(
        f">II{n}I", 0, n, *map(len, samples))))
    kind, fmt = (b"co64", "Q") if co64 else (b"stco", "I")
    stbl.append(full_box(kind, 0, 0, struct.pack(
        f">I{len(offsets)}{fmt}", len(offsets), *offsets)))
    return box(b"stbl", *stbl)


def _moov(stbl: bytes, size: Tuple[int, int], rotation: int, timescale: int,
          duration: int, edits: Optional[Sequence[Tuple[int, int, float]]],
          mvex: bytes = b"") -> bytes:
    """The ``moov`` of one video track: ``mvhd`` (timescale 1000),
    ``trak`` with ``tkhd``, an ``edts/elst`` of `edits` ((segment
    duration in ms, media time or -1, media rate) each) where given, and
    `stbl` under ``mdia/minf``; `mvex` after the track."""
    w, h = size
    movie_duration = duration * 1000 // timescale
    minf = box(b"minf", full_box(b"vmhd", 0, 1, b"\0" * 8),
               box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                     full_box(b"url ", 0, 1))),
               stbl)
    mdia = box(b"mdia",
               full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0,
                                                   timescale, duration,
                                                   0x55C4, 0)),
               full_box(b"hdlr", 0, 0, b"\0" * 4, b"vide", b"\0" * 12,
                        b"VideoHandler\0"),
               minf)
    trak = [full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0,
                                                movie_duration),
                     b"\0" * 8, struct.pack(">hhhH", 0, 0, 0, 0),
                     _matrix(rotation), struct.pack(">II", w << 16,
                                                    h << 16))]
    if edits is not None:
        trak.append(box(b"edts", full_box(b"elst", 0, 0, struct.pack(
            ">I", len(edits)), *(struct.pack(">IiI", d, t, round(r * 65536))
                                 for d, t, r in edits))))
    return box(b"moov",
               full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000,
                                                   movie_duration),
                        struct.pack(">IH", 1 << 16, 1 << 8), b"\0" * 10,
                        _matrix(0), b"\0" * 24, struct.pack(">I", 2)),
               box(b"trak", *trak, mdia), mvex)


FTYP = box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2avc1mp41")


def mux_mp4(sps_nal: bytes, pps_nal: bytes, units: Sequence[bytes],
            keys: Sequence[bool], size: Tuple[int, int], *,
            timescale: int = 12800, delta: int = 512, rotation: int = 0,
            samples_per_chunk: int = 0, co64: bool = False,
            composition_shift: int = 0,
            composition_offsets: Optional[Sequence[int]] = None,
            edit_start: Optional[int] = None,
            edits: Optional[Sequence[Tuple[int, int, float]]] = None,
            entry: Optional[bytes] = None, colr: bytes = b"") -> bytes:
    """An MP4 of one H.264 track: samples of 4-byte-length-prefixed NAL
    units, `delta` / `timescale` seconds each.  `size` is (w, h) before
    rotation; `rotation` (0/90/180/270) is the clockwise turn cv2 applies
    (the ``tkhd`` matrix).  `samples_per_chunk` > 0 splits the samples
    into chunks of that many; `co64` writes 64-bit chunk offsets;
    `composition_shift` > 0 writes every sample's composition time that
    much late (``ctts``) and an edit list that starts the presentation
    there, as muxers do for streams with B-frames, or at `edit_start`
    (media units) where given; `composition_offsets` gives each sample's
    own offset (B-frames: display time minus decode time, shifted to be
    positive) with an edit list at `edit_start`.  `edits` writes any
    edit list: (segment duration in ms, media time in `timescale` units
    or -1 for an empty edit, media rate) each.  `entry` replaces the
    ``avc1`` sample entry (another codec's, e.g. :func:`vp09_entry`); the
    `units` are then the samples as they are.  `colr` (a
    :func:`colr_box`) goes into the ``avc1`` entry after its ``avcC``."""
    if rotation not in MATRICES:
        raise ValueError(f"rotation {rotation} is not one of 0/90/180/270")
    w, h = size
    samples = (list(units) if entry is not None else
               [struct.pack(">I", len(u)) + u for u in units])
    n = len(samples)
    per = samples_per_chunk or n
    chunks = [samples[i:i + per] for i in range(0, n, per)]
    mdat_payload = b"".join(b"".join(c) for c in chunks)
    mdat_head = struct.pack(">I4s", 8 + len(mdat_payload), b"mdat")
    offsets, at = [], len(FTYP) + len(mdat_head)
    for c in chunks:
        offsets.append(at)
        at += sum(map(len, c))
    duration = n * delta
    if entry is None:
        entry = visual_entry(b"avc1", (w, h), avcc(sps_nal, pps_nal), colr)
    ctts = (list(composition_offsets) if composition_offsets is not None
            else [composition_shift] * n if composition_shift else None)
    if edits is None and (composition_shift or edit_start is not None):
        start = composition_shift if edit_start is None else edit_start
        edits = [(duration * 1000 // timescale, start, 1.0)]
    stbl = _stbl(entry, samples, keys, delta, offsets, per, co64, ctts)
    return FTYP + mdat_head + mdat_payload + _moov(
        stbl, (w, h), rotation, timescale, duration, edits)


SAMPLE_KEY, SAMPLE_NON_KEY = 0x02000000, 0x01010000   # depends_on, non-sync


def mux_fmp4(sps_nal: bytes, pps_nal: bytes, units: Sequence[bytes],
             keys: Sequence[bool], size: Tuple[int, int], *,
             timescale: int = 12800, delta: int = 512,
             fragment: str = "sample", base: str = "moof",
             tfdt: bool = True, trun_version: int = 0,
             composition_offsets: Optional[Sequence[int]] = None,
             moov_samples: int = 0, styp: bool = False, sidx: bool = False,
             mfra: bool = False, durations: str = "trex",
             edits: Optional[Sequence[Tuple[int, int, float]]] = None
             ) -> bytes:
    """A fragmented MP4 of one H.264 track, as ``MediaRecorder``, OBS and
    CMAF segmenters write it: a ``moov`` with ``mvex/trex`` (default
    duration `delta`, non-sync flags) whose sample table holds the first
    `moov_samples` samples (0: ``empty_moov``), then one ``moof`` +
    ``mdat`` per sample (`fragment` "sample") or per GOP ("gop").  Each
    ``traf`` has ``tfhd`` (`base` "moof": default-base-is-moof; "explicit":
    a base data offset, the ``moof``'s place; "implicit": neither, the
    ``moof`` start by the format's rule), ``tfdt`` where `tfdt`, and a
    ``trun`` (`trun_version` 1: signed composition offsets) with its data
    offset; a GOP's fragment gives its key in ``first_sample_flags`` and
    takes the rest from ``trex``, a sample's fragment carries the sample
    flags.  `durations` says where the sample durations stand: "trex";
    "tfhd" (its default duration and flags, over a ``trex`` of a 1-tick
    duration and key flags that they override); "trun" (each sample's,
    over the same ``trex``).  `composition_offsets` writes each sample's
    offset.  `styp` starts each fragment with a segment type box, `sidx`
    puts a segment index ahead of the first, `mfra` ends the file with a
    fragment random access box (``tfra`` of the key samples, and
    ``mfro``)."""
    w, h = size
    samples = [struct.pack(">I", len(u)) + u for u in units]
    n = len(samples)
    entry = visual_entry(b"avc1", (w, h), avcc(sps_nal, pps_nal))
    cts = list(composition_offsets) if composition_offsets is not None \
        else None
    trex = full_box(b"trex", 0, 0, struct.pack(
        ">IIIII", 1, 1, delta if durations == "trex" else 1, 0,
        SAMPLE_KEY if durations == "tfhd" else SAMPLE_NON_KEY))
    mvex = box(b"mvex", trex)
    head = samples[:moov_samples]

    def moov_for(offset: int) -> bytes:
        stbl = _stbl(entry, head, keys[:moov_samples], delta,
                     [offset] if head else [], max(1, len(head)), False,
                     cts[:moov_samples] if cts is not None and head
                     else None)
        return _moov(stbl, (w, h), 0, timescale, moov_samples * delta,
                     edits, mvex)

    moov = moov_for(0)
    out = [FTYP]
    at = len(FTYP) + len(moov)
    out.append(moov_for(at + 8) if head else moov)
    if head:
        payload = b"".join(head)
        out.append(struct.pack(">I4s", 8 + len(payload), b"mdat") + payload)
    groups: List[List[int]] = []
    for i in range(moov_samples, n):
        if not groups or fragment == "sample" or keys[i]:
            groups.append([])
        groups[-1].append(i)
    first_flags = fragment == "gop"
    flags = TRUN_DATA_OFFSET | TRUN_SIZE | (
        TRUN_FIRST_FLAGS if first_flags else TRUN_FLAGS)
    if cts is not None:
        flags |= TRUN_CTS
    if durations == "trun":
        flags |= TRUN_DURATION
    tf_flags = {"moof": TFHD_BASE_IS_MOOF, "explicit": TFHD_BASE_OFFSET,
                "implicit": 0}[base]
    if durations == "tfhd":
        tf_flags |= TFHD_DURATION | TFHD_FLAGS

    def moof(seq: int, group: List[int], moof_at: int, data_offset: int
             ) -> bytes:
        rows = []
        for i in group:
            row = [delta] if durations == "trun" else []
            row.append(len(samples[i]))
            if not first_flags:
                row.append(SAMPLE_KEY if keys[i] else SAMPLE_NON_KEY)
            fmt = ">" + "I" * len(row)
            if cts is not None:
                row.append(cts[i])
                fmt += "i" if trun_version else "I"
            rows.append(struct.pack(fmt, *row))
        trun = full_box(b"trun", trun_version, flags, struct.pack(
            ">Ii", len(group), data_offset),
            struct.pack(">I", SAMPLE_KEY if keys[group[0]]
                        else SAMPLE_NON_KEY) if first_flags else b"",
            *rows)
        traf = [full_box(b"tfhd", 0, tf_flags, struct.pack(">I", 1),
                         struct.pack(">Q", moof_at)
                         if tf_flags & TFHD_BASE_OFFSET else b"",
                         struct.pack(">II", delta, SAMPLE_NON_KEY)
                         if durations == "tfhd" else b"")]
        if tfdt:
            traf.append(full_box(b"tfdt", 1, 0, struct.pack(
                ">Q", group[0] * delta)))
        traf.append(trun)
        return box(b"moof", full_box(b"mfhd", 0, 0, struct.pack(">I", seq)),
                   box(b"traf", *traf))

    def fragments(at: int):
        """The fragments from file offset `at`: (their bytes, (time, moof
        offset) of each key fragment, (size, duration, key) of each)."""
        parts, randoms, segments = [], [], []
        for seq, group in enumerate(groups, 1):
            begin = at
            if styp:
                parts.append(box(b"styp", b"msdh", struct.pack(">I", 0),
                                 b"msdhmsix"))
                at += len(parts[-1])
            size0 = len(moof(seq, group, at, 0))
            parts.append(moof(seq, group, at, size0 + 8))
            payload = b"".join(samples[i] for i in group)
            parts.append(struct.pack(">I4s", 8 + len(payload), b"mdat")
                         + payload)
            if keys[group[0]]:
                randoms.append((group[0] * delta, at))
            at += len(parts[-2]) + len(parts[-1])
            segments.append((at - begin, len(group) * delta,
                             keys[group[0]]))
        return parts, randoms, segments

    at = sum(map(len, out))
    if sidx:        # one reference a fragment, ahead of them all
        index_size = 12 + 20 + 12 * len(groups)
        parts, randoms, segments = fragments(at + index_size)
        out.append(full_box(b"sidx", 0, 0, struct.pack(
            ">IIIIHH", 1, timescale, moov_samples * delta, 0, 0,
            len(segments)), *(struct.pack(
                ">III", size, duration, 0x90000000 if key else 0)
                for size, duration, key in segments)))
    else:
        parts, randoms, segments = fragments(at)
    out += parts
    if mfra:
        tfra = full_box(b"tfra", 1, 0, struct.pack(">III", 1, 0,
                                                   len(randoms)),
                        *(struct.pack(">QQBBB", t, at, 1, 1, 1)
                          for t, at in randoms))
        out.append(box(b"mfra", tfra, full_box(b"mfro", 0, 0, struct.pack(
            ">I", 8 + len(tfra) + 16))))
    return b"".join(out)


def _plane_shapes(h: int, w: int, chroma) -> List[Tuple[int, int]]:
    if chroma is None:
        return [(h, w)]
    sx, sy = chroma
    return [(h, w)] + [(-(-h >> sy), -(-w >> sx))] * 2


def yuv_frames(n: int, h: int, w: int, seed: int = 0,
               chroma=(1, 1)) -> List[Tuple[np.ndarray, ...]]:
    """`n` pictures of random 4:2:0 planes from `seed`, each unlike the
    others (a decoder that shows a stale picture fails an exact check);
    `chroma` another subsampling as log2 (horizontal, vertical), (1, 0)
    4:2:2, (0, 0) 4:4:4, ..., or None: the luma alone (4:0:0)."""
    rng = np.random.RandomState(seed)
    return [tuple(rng.randint(0, 256, s, dtype=np.uint8)
                  for s in _plane_shapes(h, w, chroma))
            for _ in range(n)]


def yuv_frames10(n: int, h: int, w: int, seed: int = 0, depth: int = 10,
                 chroma=(1, 1)) -> List[Tuple[np.ndarray, ...]]:
    """As :func:`yuv_frames`, planes of `depth`-bit samples (uint16)."""
    rng = np.random.RandomState(seed)
    return [tuple(rng.randint(0, 1 << depth, s).astype(np.uint16)
                  for s in _plane_shapes(h, w, chroma))
            for _ in range(n)]


def bgr_to_yuv420(frame: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(H, W, 3) uint8 BGR, H and W even -> BT.601 studio-range planes
    (y, u, v), the chroma of each 2x2 block averaged."""
    f = frame.astype(np.float64)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128 + 0.439 * r - 0.368 * g - 0.071 * b
    h, w = y.shape

    def pool(c):
        return c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    return tuple(np.clip(np.rint(c), 0, 255).astype(np.uint8)
                 for c in (y, pool(u), pool(v)))


def write_ipcm_mp4(path: str, frames, *, fps_timescale: Tuple[int, int] = (
        12800, 512), key_every: int = 0, colour: Optional[Colour] = None,
        depth: int = 8, **mux) -> Tuple[bytes, bytes, List[bytes]]:
    """Write `frames` (see :func:`encode_ipcm`: `colour` in the SPS,
    `depth` 10 High 10) as an I_PCM H.264 MP4; returns (sps, pps, access
    units)."""
    s, p, units, keys = encode_ipcm(frames, key_every, colour, depth)
    h, w = frames[0][0].shape
    timescale, delta = fps_timescale
    with open(path, "wb") as f:
        f.write(mux_mp4(s, p, units, keys, (w, h), timescale=timescale,
                        delta=delta, **mux))
    return s, p, units


# ---------------------------------------------------------------------------
# Matroska (EBML) muxing
# ---------------------------------------------------------------------------

UNKNOWN_SIZE = b"\x01\xff\xff\xff\xff\xff\xff\xff"
CLUSTER_BLOCKS = 8


def ebml(eid: int, *payload: bytes, unknown: bool = False) -> bytes:
    """An EBML element: its ID, its size (the shortest form; all ones
    for `unknown`), its payload."""
    data = b"".join(payload)
    head = eid.to_bytes((eid.bit_length() + 7) // 8, "big")
    if unknown:
        return head + UNKNOWN_SIZE + data
    n = 1
    while len(data) >= (1 << (7 * n)) - 1:
        n += 1
    return head + ((1 << (7 * n)) | len(data)).to_bytes(n, "big") + data


def ebml_uint(eid: int, value: int) -> bytes:
    return ebml(eid, value.to_bytes(max(1, (value.bit_length() + 7) // 8),
                                    "big"))


def ebml_float(eid: int, value: float) -> bytes:
    return ebml(eid, struct.pack(">d", value))


def mux_mkv(codec_id: str, packets: Sequence[Tuple[bytes, bool]],
            size: Tuple[int, int], *, fps: float = 20.0,
            codec_private: bytes = b"", timecodes: Optional[Sequence[int]]
            = None, unknown_sizes: bool = False, duration: bool = True,
            default_duration: bool = True, block_groups: bool = False,
            roll: Optional[float] = None,
            yaw: float = 0.0,
            doc_type: str = "matroska",
            colour: Optional[Colour] = None,
            chroma_siting: Optional[Tuple[int, int]] = None,
            colour_space: bytes = b"") -> bytes:
    """A Matroska / WebM file of one video track: `packets` (bytes, key)
    in decode order as blocks, ``Timecode`` units of 1 ms (`timecodes`
    in ms, by default frame i at round(1000 i / fps)), 8 blocks a
    Cluster.  `size` is (w, h); `codec_private` the track's
    ``CodecPrivate``.  `unknown_sizes` writes the ``Segment`` and every
    ``Cluster`` with an unknown size, as live muxers do; `duration` and
    `default_duration` write ``Info/Duration`` and the track's
    ``DefaultDuration``; `block_groups` writes ``BlockGroup`` / ``Block``
    with a ``ReferenceBlock`` for each non-key block in place of
    ``SimpleBlock``; `roll` a ``Projection`` with ``ProjectionPoseRoll``
    (and `yaw`, ``ProjectionPoseYaw``); `colour` a ``Colour`` with its
    ``MatrixCoefficients`` (where it has one), ``Range`` (1 broadcast, 2
    full), ``Primaries`` and ``TransferCharacteristics``, and
    `chroma_siting` its ``ChromaSitingHorz`` / ``ChromaSitingVert`` (1
    co-sited, 2 half); `colour_space` a ``ColourSpace`` (the fourcc of a
    ``V_UNCOMPRESSED`` track's pixel format).
    A ``Tags`` element follows the Clusters."""
    from . import mkv

    n = len(packets)
    if timecodes is None:
        timecodes = [round(1000 * i / fps) for i in range(n)]
    info = [ebml_uint(mkv.TIMECODE_SCALE, 1000000),
            ebml(0x4D80, b"scripted_video"), ebml(0x5741, b"scripted_video")]
    if duration:
        info.append(ebml_float(mkv.DURATION, max(timecodes) + 1000 / fps))
    w, h = size
    video = [ebml_uint(mkv.PIXEL_WIDTH, w), ebml_uint(mkv.PIXEL_HEIGHT, h)]
    if colour_space:
        video.append(ebml(mkv.COLOUR_SPACE, colour_space))
    if colour is not None or chroma_siting is not None:
        fields = []
        if colour is not None:
            if colour.matrix is not None:
                fields.append(ebml_uint(mkv.MATRIX_COEFFICIENTS,
                                        colour.matrix))
            fields += [ebml_uint(mkv.RANGE, 2 if colour.full else 1),
                       ebml_uint(0x55BA, colour.transfer),
                       ebml_uint(0x55BB, colour.primaries)]
        if chroma_siting is not None:
            fields += [ebml_uint(mkv.CHROMA_SITING_HORZ, chroma_siting[0]),
                       ebml_uint(mkv.CHROMA_SITING_VERT, chroma_siting[1])]
        video.append(ebml(mkv.COLOUR, *fields))
    if roll is not None:
        video.append(ebml(mkv.PROJECTION, ebml_uint(mkv.PROJECTION_TYPE, 0),
                          ebml_float(mkv.POSE_YAW, yaw),
                          ebml_float(mkv.POSE_ROLL, roll)))
    entry = [ebml_uint(mkv.TRACK_NUMBER, 1), ebml_uint(0x73C5, 1),
             ebml_uint(mkv.TRACK_TYPE, mkv.TRACK_VIDEO),
             ebml(mkv.CODEC_ID, codec_id.encode())]
    if codec_private:
        entry.append(ebml(mkv.CODEC_PRIVATE, codec_private))
    if default_duration:
        entry.append(ebml_uint(mkv.DEFAULT_DURATION, round(1e9 / fps)))
    entry.append(ebml(mkv.VIDEO, *video))
    body = [ebml(mkv.INFO, *info),
            ebml(mkv.TRACKS, ebml(mkv.TRACK_ENTRY, *entry))]
    for c in range(0, n, CLUSTER_BLOCKS):
        base = timecodes[c]
        blocks = [ebml_uint(mkv.TIMECODE, base)]
        for i in range(c, min(c + CLUSTER_BLOCKS, n)):
            data, key = packets[i]
            head = b"\x81" + struct.pack(">h", timecodes[i] - base)
            if block_groups:
                group = [ebml(mkv.BLOCK, head, b"\x00", data)]
                if not key:
                    group.append(ebml(mkv.REFERENCE_BLOCK, struct.pack(
                        ">h", round(-1000 / fps))))
                blocks.append(ebml(mkv.BLOCK_GROUP, *group))
            else:
                blocks.append(ebml(mkv.SIMPLE_BLOCK, head,
                                   b"\x80" if key else b"\x00", data))
        body.append(ebml(mkv.CLUSTER, *blocks, unknown=unknown_sizes))
    body.append(ebml(0x1254C367, ebml(0x7373, ebml(0x63C0), ebml(
        0x67C8, ebml(0x45A3, b"ENCODER"), ebml(0x4487, b"scripted_video")))))
    header = ebml(mkv.EBML, ebml_uint(0x4286, 1), ebml_uint(0x42F7, 1),
                  ebml_uint(0x42F2, 4), ebml_uint(0x42F3, 8),
                  ebml(mkv.DOC_TYPE, doc_type.encode()),
                  ebml_uint(0x4287, 4), ebml_uint(0x4285, 2))
    return header + ebml(mkv.SEGMENT, *body, unknown=unknown_sizes)


def avcc_record(sps_nal: bytes, pps_nal: bytes) -> bytes:
    """The ``avcC`` record (an MP4 box's payload; Matroska's
    ``CodecPrivate`` of ``V_MPEG4/ISO/AVC``)."""
    return avcc(sps_nal, pps_nal)[8:]


def write_ipcm_mkv(path: str, frames, *, key_every: int = 0,
                   sps_colour: Optional[Colour] = None, depth: int = 8,
                   **mux) -> Tuple[bytes, bytes, List[bytes]]:
    """Write `frames` (see :func:`encode_ipcm`: `sps_colour` in the SPS,
    `depth` 10 High 10) as I_PCM H.264 in Matroska (``V_MPEG4/ISO/AVC``,
    4-byte NAL lengths; `colour` in `mux` is the track's); returns (sps,
    pps, access units)."""
    s, p, units, keys = encode_ipcm(frames, key_every, sps_colour, depth)
    h, w = frames[0][0].shape
    packets = [(struct.pack(">I", len(u)) + u, k) for u, k in zip(units,
                                                                   keys)]
    with open(path, "wb") as f:
        f.write(mux_mkv("V_MPEG4/ISO/AVC", packets, (w, h),
                        codec_private=avcc_record(s, p), **mux))
    return s, p, units


def write_bframes(path: str, anchors, *, reorder: Optional[int] = 1,
                  container: str = "mp4", fps: float = 20.0,
                  poc_step: int = 2) -> List[Tuple[np.ndarray, ...]]:
    """Write :func:`encode_ipcm_bframes`' stream of `anchors` to `path` as
    an MP4 (``ctts`` offsets and an edit list one frame in, as muxers write
    B-frames) or a Matroska file (``container="mkv"``: blocks in decode
    order carrying their display times); returns the frames in display
    order."""
    s, p, units, keys, order, shown = encode_ipcm_bframes(anchors, reorder,
                                                          poc_step)
    h, w = anchors[0][0].shape
    if container == "mp4":
        timescale, delta = 12800, round(12800 / fps)
        data = mux_mp4(s, p, units, keys, (w, h), timescale=timescale,
                       delta=delta, composition_offsets=[
                           (d + 1 - i) * delta for i, d in enumerate(order)],
                       edit_start=delta)
    else:
        packets = [(struct.pack(">I", len(u)) + u, k)
                   for u, k in zip(units, keys)]
        data = mux_mkv("V_MPEG4/ISO/AVC", packets, (w, h), fps=fps,
                       codec_private=avcc_record(s, p),
                       timecodes=[round(1000 * d / fps) for d in order])
    with open(path, "wb") as f:
        f.write(data)
    return shown


# ---------------------------------------------------------------------------
# MPEG transport stream muxing
# ---------------------------------------------------------------------------

TS_STREAM_TYPES = {"mpeg1video": 0x01, "mpeg2video": 0x02, "mpeg4": 0x10,
                   "h264": 0x1B, "hevc": 0x24, "private": 0x06}
TS_PMT_PID, TS_VIDEO_PID, TS_OTHER_PID = 0x1000, 0x100, 0x101
TS_START = 126000           # the first DTS (1.4 s), as FFmpeg's muxer starts
TS_PCR_DELAY = 63000        # PCR this far ahead of the DTS (0.7 s)


class TsUnit(NamedTuple):
    data: bytes             # an access unit as the decoder takes it
    pts: int                # 90 kHz
    dts: Optional[int]      # None: the same as the PTS (only PTS written)


def ts_timestamp(marker: int, ts: int) -> bytes:
    """A PES header's 33-bit PTS / DTS field with its 4-bit marker."""
    ts %= 1 << 33
    return bytes([(marker << 4) | ((ts >> 29) & 0x0E) | 1,
                  (ts >> 22) & 0xFF, ((ts >> 14) & 0xFE) | 1,
                  (ts >> 7) & 0xFF, ((ts << 1) & 0xFE) | 1])


def pes_packet(payload: bytes, pts: Optional[int], dts: Optional[int],
               unbounded: bool, stream_id: int = 0xE0) -> bytes:
    """A PES packet: its header (PTS, and DTS where it differs) and the
    payload; `unbounded` writes PES_packet_length 0, as video muxers
    write it."""
    fields = b""
    flags = 0
    if pts is not None:
        if dts is not None and dts != pts:
            flags, fields = 0xC0, ts_timestamp(3, pts) + ts_timestamp(1, dts)
        else:
            flags, fields = 0x80, ts_timestamp(2, pts)
    header = bytes([0x80, flags, len(fields)]) + fields
    length = 0 if unbounded else len(header) + len(payload)
    if length > 0xFFFF:
        raise ValueError(f"a bounded PES of {length} bytes (at most 65535)")
    return (b"\x00\x00\x01" + bytes([stream_id]) + struct.pack(">H", length)
            + header + payload)


def psi_section(table_id: int, extension: int, body: bytes) -> bytes:
    """A long-form PSI section (version 0, current, section 0 of 0) with
    its CRC-32/MPEG-2."""
    from .mpegts import crc32_mpeg2

    head = bytes([table_id]) + struct.pack(
        ">HHBBB", 0xB000 | (len(body) + 9), extension, 0xC1, 0, 0)
    section = head + body
    return section + struct.pack(">I", crc32_mpeg2(section))


class _TsWriter:
    def __init__(self, packet_size: int):
        if packet_size not in (188, 192):
            raise ValueError(f"TS packets are 188 or 192 bytes, not "
                             f"{packet_size}")
        self.packet_size = packet_size
        self.cc: dict = {}
        self.out: List[bytes] = []

    def packet(self, pid: int, payload: bytes, start: bool,
               adaptation: Optional[bytes] = None) -> int:
        """One packet: as much of `payload` as fits after `adaptation`
        (the adaptation field's flags byte and fields); the rest of the
        184 bytes is adaptation-field stuffing.  Returns the payload bytes
        taken."""
        if adaptation is None and len(payload) >= 184:
            field, take = b"", 184
        else:
            fixed = adaptation or b""
            take = min(len(payload), 183 - len(fixed))
            length = 183 - take                 # adaptation_field_length
            body = fixed or (b"\x00" if length else b"")
            field = bytes([length]) + body + b"\xff" * (length - len(body))
        cc = self.cc.get(pid, 0)
        self.cc[pid] = (cc + 1) & 15
        head = bytes([0x47, (0x40 if start else 0) | (pid >> 8), pid & 0xFF,
                      (0x30 if field else 0x10) | cc])
        packet = head + field + bytes(payload[:take])
        if self.packet_size == 192:      # TP_extra_header: arrival time
            packet = struct.pack(">I", (len(self.out) * 1000) & 0x3FFFFFFF) \
                + packet
        self.out.append(packet)
        return take

    def payload(self, pid: int, data: bytes,
                adaptation: Optional[bytes] = None) -> None:
        """`data` (a PES packet, or a pointer field and sections) over as
        many packets as it needs; `adaptation` goes in the first."""
        view, start = memoryview(data), True
        while view or start:
            taken = self.packet(pid, view[:184], start, adaptation)
            view, start, adaptation = view[taken:], False, None


def _adaptation(pcr: Optional[int], random_access: bool) -> bytes:
    flags = (0x40 if random_access else 0) | (0x10 if pcr is not None
                                               else 0)
    out = bytes([flags])
    if pcr is not None:
        base = pcr % (1 << 33)
        out += struct.pack(">IH", base >> 1, ((base & 1) << 15) | 0x7E00)
    return out


def mux_ts(codec: str, units: Sequence[TsUnit], keys: Sequence[bool], *,
           packet_size: int = 188, pes_per_frame: int = 1,
           split: Sequence[int] = (), unbounded: bool = True,
           psi_every: int = 40, private_first: bool = False) -> bytes:
    """An MPEG transport stream of one program (PAT, PMT, and the PCR in
    the video PID) and one video stream of `codec` (a key of
    :data:`TS_STREAM_TYPES`): `units` in decode order, each PES holding
    `pes_per_frame` of them (its timestamps the first's), a unit whose
    index is in `split` spread over two PES (the second without
    timestamps), with PES_packet_length 0 where `unbounded`.  Each PES
    whose first unit is a key has ``random_access_indicator`` set; the
    last packet of a PES is filled with adaptation-field stuffing.  PAT
    and PMT repeat every `psi_every` packets; `private_first` lists a
    private data stream (0x06) ahead of the video in the PMT.
    `packet_size` 192 writes M2TS (a 4-byte arrival time first)."""
    w = _TsWriter(packet_size)
    pat = psi_section(0x00, 1, struct.pack(">HH", 1, 0xE000 | TS_PMT_PID))
    streams = b""
    if private_first:
        streams += struct.pack(">BHH", TS_STREAM_TYPES["private"],
                               0xE000 | TS_OTHER_PID, 0xF000)
    streams += struct.pack(">BHH", TS_STREAM_TYPES[codec],
                           0xE000 | TS_VIDEO_PID, 0xF000)
    pmt = psi_section(0x02, 1, struct.pack(">HH", 0xE000 | TS_VIDEO_PID,
                                           0xF000) + streams)
    tables_at = [None]

    def tables():
        if tables_at[0] is None or len(w.out) - tables_at[0] >= psi_every:
            tables_at[0] = len(w.out)
            w.payload(0, b"\x00" + pat)
            w.payload(TS_PMT_PID, b"\x00" + pmt)

    groups: List[List[Tuple[bytes, Optional[int], Optional[int], bool]]] = []
    for i in range(0, len(units), pes_per_frame):
        group = units[i:i + pes_per_frame]
        data = b"".join(u.data for u in group)
        first = group[0]
        if any(i + k in split for k in range(len(group))):
            half = len(data) // 2
            groups.append([(data[:half], first.pts, first.dts, keys[i])])
            groups.append([(data[half:], None, None, False)])
        else:
            groups.append([(data, first.pts, first.dts, keys[i])])
    for (data, pts, dts, key), in groups:
        tables()
        pcr = None
        if pts is not None:
            pcr = (pts if dts is None else dts) - TS_PCR_DELAY
        w.payload(TS_VIDEO_PID, pes_packet(data, pts, dts, unbounded),
                  _adaptation(pcr, key))
    return b"".join(w.out)


def h264_access_units(sps_nal: bytes, pps_nal: bytes, units: Sequence[bytes]
                      ) -> List[bytes]:
    """Annex-B access units as broadcast encoders put them in a transport
    stream: an access unit delimiter (NAL 9) first, the parameter sets
    ahead of the first picture."""
    aud = b"\x00\x00\x00\x01\x09\xf0"
    return [aud + (annexb(sps_nal, pps_nal, [u]) if i == 0
                   else b"\x00\x00\x00\x01" + u)
            for i, u in enumerate(units)]


def write_ipcm_ts(path: str, frames, *, key_every: int = 0,
                  fps: Tuple[int, int] = (25, 1), start: int = TS_START,
                  colour: Optional[Colour] = None, depth: int = 8,
                  **mux) -> None:
    """Write `frames` (see :func:`encode_ipcm`: `colour` in the SPS,
    `depth` 10 High 10) as I_PCM H.264 in an MPEG transport stream
    (:func:`mux_ts`), frame i at `start` + i frames of `fps` (num, den) on
    the 90 kHz clock (wrapping past 2^33)."""
    s, p, units, keys = encode_ipcm(frames, key_every, colour, depth)
    data = h264_access_units(s, p, units)
    ticks = 90000 * fps[1] // fps[0]
    ts_units = [TsUnit(d, start + i * ticks, None) for i, d in enumerate(data)]
    with open(path, "wb") as f:
        f.write(mux_ts("h264", ts_units, keys, **mux))


def write_bframes_ts(path: str, anchors, *, reorder: Optional[int] = 1,
                     fps: int = 25, poc_step: int = 2, **mux
                     ) -> List[Tuple[np.ndarray, ...]]:
    """:func:`encode_ipcm_bframes`' stream of `anchors` in an MPEG
    transport stream: PTS one frame after the DTS, B pictures with their
    display times; returns the frames in display order."""
    s, p, units, keys, order, shown = encode_ipcm_bframes(anchors, reorder,
                                                          poc_step)
    ticks = 90000 // fps
    data = h264_access_units(s, p, units)
    ts_units = [TsUnit(d, TS_START + (order[i] + 1) * ticks,
                       TS_START + i * ticks) for i, d in enumerate(data)]
    with open(path, "wb") as f:
        f.write(mux_ts("h264", ts_units, keys, **mux))
    return shown


def remux_ts(src: str, dst: str, **mux) -> int:
    """Re-mux the first video stream of the transport stream `src` (cv2's
    MPEG-2, say) with :func:`mux_ts`: its PES payloads, timestamps and
    codec as they are, the packing as `mux` says.  Returns the PES
    count."""
    from . import mpegts

    with open(src, "rb") as f:
        track = mpegts.read_track(src, f)
        pes = [p for p in track.pes(f)]
    units = [TsUnit(p.payload, p.pts, p.dts) for p in pes]
    codec = {0x01: "mpeg1video", 0x02: "mpeg2video"}.get(track.stream_type,
                                                         track.codec)
    keys = [intra_picture(track.codec, p.payload) for p in pes]
    with open(dst, "wb") as f:
        f.write(mux_ts(codec, units, keys, **mux))
    return len(units)


# ---------------------------------------------------------------------------
# MPEG program stream muxing
# ---------------------------------------------------------------------------

PS_MUX_RATE = 25200         # 50-byte units a second: 10.08 Mbit/s, DVD's
PS_PES_BYTES = 2024         # payload a PES at most, as a DVD pack holds
PS_SCR_LEAD = 9000          # the SCR this far ahead of the DTS (0.1 s)
DVD_PCI, DVD_DSI = 980, 1018    # DVD navigation packets' lengths


def _scr(scr: int, mpeg2: bool) -> bytes:
    """A pack header: its SCR (27 MHz extension 0) and the mux rate, in
    MPEG-2's syntax (no stuffing) or MPEG-1's."""
    scr %= 1 << 33
    if not mpeg2:
        rate = PS_MUX_RATE
        return (b"\x00\x00\x01\xba" + ts_timestamp(2, scr)
                + bytes([0x80 | (rate >> 15), (rate >> 7) & 0xFF,
                         ((rate << 1) & 0xFE) | 1]))
    b = BitWriter().u(2, 1).u(3, scr >> 30).u(1, 1).u(15, scr >> 15)
    b.u(1, 1).u(15, scr).u(1, 1).u(9, 0).u(1, 1)
    b.u(22, PS_MUX_RATE).u(2, 3).u(5, 0x1F).u(3, 0)
    return b"\x00\x00\x01\xba" + b.bytes()


def _system_header(stream_id: int) -> bytes:
    """A system header of one video stream (video bound 1)."""
    rate = PS_MUX_RATE
    body = bytes([0x80 | (rate >> 15), (rate >> 7) & 0xFF,
                  ((rate << 1) & 0xFE) | 1, 0x00, 0x21, 0xFF,
                  stream_id, 0xE0, 0xE6])
    return b"\x00\x00\x01\xbb" + struct.pack(">H", len(body)) + body


def program_stream_map(entries: Sequence[Tuple[int, int]]) -> bytes:
    """A program stream map (0xBC) of (stream type, stream id) entries,
    with its CRC-32/MPEG-2."""
    from .mpegts import crc32_mpeg2

    es_map = b"".join(struct.pack(">BBH", kind, es_id, 0)
                      for kind, es_id in entries)
    body = bytes([0xE0, 0xFF]) + struct.pack(">HH", 0, len(es_map)) + es_map
    head = b"\x00\x00\x01\xbc" + struct.pack(">H", len(body) + 4)
    return head + body + struct.pack(">I", crc32_mpeg2(head + body))


def mpeg1_pes(payload: bytes, pts: Optional[int], dts: Optional[int],
              stream_id: int = 0xE0, std: bool = False) -> bytes:
    """A PES packet in MPEG-1's syntax: the STD buffer field where `std`,
    then ``0010`` and the PTS, ``0011`` and the PTS and DTS, or 0x0F."""
    fields = b"\x60\xe6" if std else b""
    if pts is None:
        fields += b"\x0f"
    elif dts is not None and dts != pts:
        fields += ts_timestamp(3, pts) + ts_timestamp(1, dts)
    else:
        fields += ts_timestamp(2, pts)
    return (b"\x00\x00\x01" + bytes([stream_id])
            + struct.pack(">H", len(fields) + len(payload)) + fields + payload)


def mux_ps(codec: str, units: Sequence[TsUnit], keys: Sequence[bool], *,
           mpeg2: bool = True, psm: bool = False, dvd: bool = False,
           pes_bytes: int = PS_PES_BYTES, end_code: bool = True) -> bytes:
    """An MPEG program stream of one video stream (0xE0) of `codec` (a
    key of :data:`TS_STREAM_TYPES`): each of `units` (decode order) in
    PES packets of at most `pes_bytes` payload, its timestamps in the
    first (a unit of no PTS: none), a pack header (MPEG-2's, or MPEG-1's
    where not `mpeg2`, with PES of MPEG-1's syntax) ahead of each PES.
    The first pack holds the system header and, where `psm`, a program
    stream map naming the codec (cv2's muxer writes none: then a reader
    probes the codec).
    `dvd` puts a navigation pack (private stream 2: PCI and DSI), an
    AC-3 audio PES (private stream 1) and an MPEG audio PES, none of them
    timed, and a padding PES ahead of each key picture, as a DVD's
    ``.vob`` holds them.  The stream ends with an end code where
    `end_code`."""
    out: List[bytes] = []
    first = True
    scr = 0
    for unit, key in zip(units, keys):
        start = unit.pts if unit.dts is None else unit.dts
        if start is not None:           # an untimed unit: the SCR before
            scr = max(0, start - PS_SCR_LEAD)
        if dvd and key:
            nav = (b"\x00\x00\x01\xbf" + struct.pack(">H", DVD_PCI)
                   + b"\x00" * DVD_PCI + b"\x00\x00\x01\xbf"
                   + struct.pack(">H", DVD_DSI) + b"\x01"
                   + b"\x00" * (DVD_DSI - 1))
            out.append(_scr(scr, mpeg2) + _system_header(0xE0) + nav)
            out.append(_scr(scr, mpeg2) + pes_packet(
                b"\x80\x01\x00\x01" + b"\x0b\x77" + b"\x00" * 58, None,
                None, False, stream_id=0xBD))
            out.append(_scr(scr, mpeg2) + pes_packet(
                b"\xff\xfd" + b"\x00" * 62, None, None, False,
                stream_id=0xC0))
            out.append(b"\x00\x00\x01\xbe" + struct.pack(">H", 40)
                       + b"\xff" * 40)
        data = unit.data
        for at in range(0, len(data), pes_bytes):
            chunk = data[at:at + pes_bytes]
            pts, dts = (unit.pts, unit.dts) if at == 0 else (None, None)
            pack = _scr(scr, mpeg2)
            if first:
                pack += _system_header(0xE0)
                if psm:
                    pack += program_stream_map([(TS_STREAM_TYPES[codec],
                                                 0xE0)])
            pes = (pes_packet(chunk, pts, dts, False) if mpeg2 else
                   mpeg1_pes(chunk, pts, dts, std=first))
            out.append(pack + pes)
            first = False
    if end_code:
        out.append(b"\x00\x00\x01\xb9")
    return b"".join(out)


def write_ipcm_ps(path: str, frames, *, key_every: int = 0,
                  fps: Tuple[int, int] = (25, 1), **mux) -> None:
    """Write `frames` (see :func:`encode_ipcm`) as I_PCM H.264 in an MPEG
    program stream (:func:`mux_ps`), frame i at ``TS_START`` + i frames
    of `fps` (num, den)."""
    s, p, units, keys = encode_ipcm(frames, key_every)
    ticks = 90000 * fps[1] // fps[0]
    ps_units = [TsUnit(d, TS_START + i * ticks, None)
                for i, d in enumerate(h264_access_units(s, p, units))]
    with open(path, "wb") as f:
        f.write(mux_ps("h264", ps_units, keys, **mux))


# ---------------------------------------------------------------------------
# HEVC in MP4, Matroska, MPEG-TS and MPEG program streams
# ---------------------------------------------------------------------------

def hvcc_record(stream: HevcStream) -> bytes:
    """The ``hvcC`` record (ISO 14496-15 8.3.3: an MP4 box's payload,
    Matroska's ``CodecPrivate`` of ``V_MPEGH/ISO/HEVC``): the SPS's
    profile, tier and level, chroma format, the bit depth, 4-byte NAL
    lengths, and arrays of the VPS, SPS and PPS."""
    d, chroma = stream.depth - 8, stream.chroma
    head = (b"\x01" + profile_tier_level(hevc_profile(stream.depth,
                                                      chroma)).bytes()
            + struct.pack(">HBBBBHBB", 0xF000, 0xFC, 0xFC | chroma,
                          0xF8 | d, 0xF8 | d, 0, 0x0F, 3))
    return head + b"".join(
        struct.pack(">BHH", 0x80 | kind, 1, len(unit)) + unit
        for kind, unit in zip((HEVC_VPS, HEVC_SPS, HEVC_PPS), stream.params))


def hevc_samples(stream: HevcStream, in_band: bool = False) -> List[bytes]:
    """Each picture as an MP4 / Matroska sample: 4-byte-length-prefixed
    NAL units; `in_band` puts the parameter sets ahead of each IDR
    picture too (``hev1``)."""
    out = []
    for unit, key in zip(stream.units, stream.keys):
        nals = [*stream.params, unit] if in_band and key else [unit]
        out.append(b"".join(struct.pack(">I", len(n)) + n for n in nals))
    return out


def write_hevc_mp4(path: str, stream: HevcStream, *, kind: str = "hvc1",
                   fps_timescale: Tuple[int, int] = (12800, 512),
                   colr: bytes = b"", **mux) -> None:
    """Write `stream` as an MP4 of one HEVC track: an ``hvc1`` sample entry
    (parameter sets only in its ``hvcC``) or ``hev1`` (in the samples
    too); a reordered stream gets each sample's composition offset and an
    edit list one frame in, as muxers write them.  `colr` (a
    :func:`colr_box`) follows the ``hvcC``."""
    if kind not in ("hvc1", "hev1"):
        raise ValueError(f"an HEVC sample entry is hvc1 or hev1, not {kind}")
    timescale, delta = fps_timescale
    if stream.order != sorted(stream.order):
        mux = dict(composition_offsets=[
            (d + 1 - i) * delta for i, d in enumerate(stream.order)],
            edit_start=delta, **mux)
    entry = visual_entry(kind.encode(), stream.size,
                         box(b"hvcC", hvcc_record(stream)), colr)
    with open(path, "wb") as f:
        f.write(mux_mp4(b"", b"", hevc_samples(stream, kind == "hev1"),
                        stream.keys, stream.size, timescale=timescale,
                        delta=delta, entry=entry, **mux))


def write_hevc_mkv(path: str, stream: HevcStream, **mux) -> None:
    """Write `stream` as Matroska (``V_MPEGH/ISO/HEVC`` with its ``hvcC``
    ``CodecPrivate``; a reordered stream's blocks carry their display
    times)."""
    fps = mux.pop("fps", 20.0)
    if stream.order != sorted(stream.order):
        mux["timecodes"] = [round(1000 * d / fps) for d in stream.order]
    with open(path, "wb") as f:
        f.write(mux_mkv("V_MPEGH/ISO/HEVC", list(zip(
            hevc_samples(stream), stream.keys)), stream.size, fps=fps,
            codec_private=hvcc_record(stream), **mux))


HEVC_AUD = b"\x00\x00\x00\x01\x46\x01\x50"    # access unit delimiter


def hevc_access_units(stream: HevcStream) -> List[bytes]:
    """Annex-B access units as broadcast encoders put them in a transport
    or program stream: an access unit delimiter first, the parameter sets
    ahead of each IDR picture."""
    return [HEVC_AUD + b"".join(b"\x00\x00\x00\x01" + n for n in (
        [*stream.params, unit] if key else [unit]))
        for unit, key in zip(stream.units, stream.keys)]


def hevc_ts_units(stream: HevcStream, fps: Tuple[int, int] = (25, 1),
                  start: int = TS_START) -> List["TsUnit"]:
    """The access units with their 90 kHz times: the PTS the display
    order's, one frame after the DTS where the stream is reordered."""
    ticks = 90000 * fps[1] // fps[0]
    late = int(stream.order != sorted(stream.order))
    return [TsUnit(d, start + (o + late) * ticks,
                   start + i * ticks if late else None)
            for i, (d, o) in enumerate(zip(hevc_access_units(stream),
                                           stream.order))]


def write_hevc_ts(path: str, stream: HevcStream, *,
                  fps: Tuple[int, int] = (25, 1), **mux) -> None:
    """Write `stream` as an MPEG transport stream (stream type 0x24)."""
    with open(path, "wb") as f:
        f.write(mux_ts("hevc", hevc_ts_units(stream, fps), stream.keys,
                       **mux))


def write_hevc_ps(path: str, stream: HevcStream, *,
                  fps: Tuple[int, int] = (25, 1), **mux) -> None:
    """Write `stream` as an MPEG program stream (:func:`mux_ps`)."""
    with open(path, "wb") as f:
        f.write(mux_ps("hevc", hevc_ts_units(stream, fps), stream.keys,
                       **mux))


# ---------------------------------------------------------------------------
# AV1: a still picture's headers, for probing what reads AV1
# ---------------------------------------------------------------------------

AV1_OBU_SEQUENCE_HEADER, AV1_OBU_TEMPORAL_DELIMITER, AV1_OBU_FRAME = 1, 2, 6


def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def av1_obu(kind: int, payload: bytes) -> bytes:
    """An AV1 OBU with its size field."""
    return bytes([kind << 3 | 0x02]) + _leb128(len(payload)) + payload


def av1_sequence_header(w: int, h: int) -> bytes:
    """A sequence header OBU (AV1 5.5) of profile 0 (8-bit 4:2:0) with
    ``reduced_still_picture_header``: one key frame of w x h, no CDEF,
    loop restoration or superres, level 2.0."""
    bits = max(w - 1, h - 1, 1).bit_length()
    b = BitWriter().u(3, 0).u(1, 1).u(1, 1).u(5, 0)   # profile, still,
    b.u(4, bits - 1).u(4, bits - 1)                   # reduced, level
    b.u(bits, w - 1).u(bits, h - 1)
    b.u(1, 0).u(1, 0).u(1, 0)                 # 64x64 SB, filter intra, edge
    b.u(1, 0).u(1, 0).u(1, 0)                 # superres, CDEF, restoration
    b.u(1, 0).u(1, 0).u(1, 0).u(1, 0)         # 8-bit, colour, description,
    b.u(2, 0).u(1, 0)                         # range; sample position, uv q
    b.u(1, 0)                                 # no film grain
    return av1_obu(AV1_OBU_SEQUENCE_HEADER, b.trailing().bytes())


def av1_still_frame() -> bytes:
    """A frame OBU of the reduced still picture header's key frame: its
    uncompressed header (no screen content tools, one tile, base_q_idx 0:
    lossless) and a tile of zero bytes.  The tile is no coded picture: the
    OBU serves to show whether a decoder gets as far as a frame."""
    b = BitWriter().u(1, 0).u(1, 0)           # cdf update, screen content
    b.u(1, 0)                                 # render size = frame size
    b.u(1, 1)                                 # uniform tile spacing
    b.u(8, 0).u(1, 0).u(1, 0).u(1, 0)         # base_q_idx 0, no deltas,
    b.u(1, 0).u(1, 0)                         # no qmatrix, segmentation
    b.u(1, 0)                                 # reduced_tx_set
    return av1_obu(AV1_OBU_FRAME, b.align_zero().bytes() + b"\x00" * 8)


def av1_still(w: int = 64, h: int = 48) -> Tuple[bytes, bytes]:
    """(a temporal unit: temporal delimiter, sequence header, frame; the
    ``av1C`` record carrying the sequence header: Matroska's
    ``CodecPrivate`` of ``V_AV1``)."""
    seq = av1_sequence_header(w, h)
    unit = av1_obu(AV1_OBU_TEMPORAL_DELIMITER, b"") + seq + av1_still_frame()
    return unit, bytes([0x81, 0x00, 0x0C, 0x00]) + seq


def write_av1_mkv(path: str, w: int = 64, h: int = 48) -> bytes:
    """Write the AV1 still as Matroska (``V_AV1``, one block, its
    temporal delimiter dropped as the format wants); returns the temporal
    unit."""
    unit, av1c = av1_still(w, h)
    with open(path, "wb") as f:
        f.write(mux_mkv("V_AV1", [(unit[2:], True)], (w, h),
                        codec_private=av1c))
    return unit


# ---------------------------------------------------------------------------
# VP9 fixtures: cv2's WebM, and a superframe made of it
# ---------------------------------------------------------------------------

VP9_WEBM = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "vp9_64x48.webm")
VP9_WEBM_FRAMES, VP9_WEBM_FPS = 16, 20.0


def write_cv2_video(path: str, fourcc: str, n: int, h: int, w: int,
                    fps: float = 20.0) -> None:
    """`n` rendered scenes (``data.imread_fixtures.render_scene``) written
    by the installed cv2's ``VideoWriter`` with `fourcc`.  Needs cv2 (the
    port never imports it; tests and ``chip_smoke.py`` do)."""
    import cv2

    from ..data.imread_fixtures import render_scene
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2 {cv2.__version__} writes no {fourcc} "
                           f"{os.path.splitext(path)[1]} file")
    for i in range(n):
        writer.write(np.ascontiguousarray(render_scene(i, h, w)))
    writer.release()


def encode_lavc(encoder: str, frames: Sequence[Tuple[np.ndarray, ...]],
                colour: Optional[Colour] = None, fps: int = 20,
                pix_fmt: Optional[str] = None,
                **options: int) -> List[Tuple[bytes, bool]]:
    """Packets (bytes, key) of `frames` ((y, u, v) planes of the pixel
    format `pix_fmt`, by default ``yuv420p`` for uint8 and
    ``yuv420p10le`` for uint16) from the OpenCV wheel's
    libavcodec `encoder` (``libvpx-vp9``, ``mpeg2video``, ...) with the
    integer `options` (its own or the context's); `colour` goes to the
    context (``colorspace``, ``color_range``, primaries, transfer), which
    the encoder writes where its syntax has a place (VP9's frame header,
    MPEG-2's sequence display extension).  Raises where the library has
    no such encoder."""
    import ctypes

    from ..native import avcodec
    from ..native.avencode import _Rational, encoder_libraries
    libs = encoder_libraries()
    av, au = libs.avcodec, libs.avutil
    h, w = frames[0][0].shape
    fmt = (pix_fmt or ("yuv420p10le" if frames[0][0].dtype == np.uint16
                       else "yuv420p")).encode()
    codec = av.avcodec_find_encoder_by_name(encoder.encode())
    if not codec:
        raise RuntimeError(f"{libs.path} has no {encoder} encoder")
    ctx = ctypes.c_void_p(av.avcodec_alloc_context3(codec))
    packet = ctypes.c_void_p(av.av_packet_alloc())
    frame = ctypes.c_void_p(au.av_frame_alloc())
    out: List[Tuple[bytes, bool]] = []
    try:
        au.av_opt_set_q(ctx, b"time_base", _Rational(1, fps), 0)
        au.av_opt_set(ctx, b"video_size", f"{w}x{h}".encode(), 0)
        au.av_opt_set(ctx, b"pixel_format", fmt, 0)
        if colour is not None:
            if colour.matrix is not None:
                options["colorspace"] = colour.matrix
            options.update(color_range=2 if colour.full else 1,
                           color_primaries=colour.primaries,
                           color_trc=colour.transfer)
        for name, value in options.items():   # 1: the encoder's own too
            au.av_opt_set_int(ctx, name.encode(), value, 1)
        err = av.avcodec_open2(ctx, codec, None)
        if err < 0:
            raise RuntimeError(f"avcodec_open2({encoder}): "
                               f"{libs.error(err)}")
        f = avcodec._Frame.from_address(frame.value)
        f.width, f.height, f.format = w, h, au.av_get_pix_fmt(fmt)
        for i, planes in enumerate([*frames, None]):
            if planes is not None:
                held = [np.ascontiguousarray(p) for p in planes]
                for k, p in enumerate(held):
                    f.data[k], f.linesize[k] = p.ctypes.data, p.strides[0]
            err = av.avcodec_send_frame(ctx, frame if planes is not None
                                        else None)
            if err < 0:
                raise RuntimeError(f"{encoder} refused frame {i}: "
                                   f"{libs.error(err)}")
            while av.avcodec_receive_packet(ctx, packet) >= 0:
                pk = avcodec._Packet.from_address(packet.value)
                out.append((ctypes.string_at(pk.data, pk.size),
                            bool(pk.flags & avcodec.AV_PKT_FLAG_KEY)))
                av.av_packet_unref(packet)
    finally:
        au.av_frame_free(ctypes.byref(frame))
        av.av_packet_free(ctypes.byref(packet))
        av.avcodec_free_context(ctypes.byref(ctx))
    return out


# ProRes profiles of the wheel's ``prores`` encoder and the sample entry
# (MOV) or CodecPrivate (Matroska) each is stored under: 422 proxy, LT,
# standard, HQ (10-bit 4:2:2 in), 4444 and 4444 XQ (10-bit 4:4:4 in, with
# an alpha plane or without; the decoder gives 12 bits)
PRORES_TAGS = {0: b"apco", 1: b"apcs", 2: b"apcn", 3: b"apch", 4: b"ap4h",
               5: b"ap4x"}


def write_prores(path: str, frames: Sequence[Tuple[np.ndarray, ...]], *,
                 profile: int = 2, container: str = "mov", fps: int = 25,
                 colour: Optional[Colour] = None) -> List[Tuple[bytes, bool]]:
    """ProRes of `frames` (10-bit planes, uint16: (y, u, v) of 4:2:2 for
    profiles 0-3, of 4:4:4 for 4 and 5, a fourth alpha plane making it
    ``yuva444p10le``) from the wheel's ``prores`` encoder, as a MOV (a
    ``visual_entry`` of the profile's tag) or a Matroska file
    (``V_PRORES``, the tag as its ``CodecPrivate``, each frame without
    the 8 bytes of its size and ``icpf``, as FFmpeg's muxer stores it);
    `colour` goes into the frame headers.  -> the encoder's packets."""
    pix_fmt = pixel_format(frames[0][:3], 10)
    if len(frames[0]) == 4:
        pix_fmt = pix_fmt.replace("yuv", "yuva")
    packets = encode_lavc("prores", frames, colour, fps=fps, pix_fmt=pix_fmt,
                          profile=profile)
    h, w = frames[0][0].shape
    tag = PRORES_TAGS[profile]
    if container == "mkv":
        data = mux_mkv("V_PRORES", [(p[8:], k) for p, k in packets], (w, h),
                       fps=fps, codec_private=tag)
    else:
        data = mux_mp4(b"", b"", [p for p, _ in packets],
                       [k for _, k in packets], (w, h), timescale=fps * 100,
                       delta=100, entry=visual_entry(tag, (w, h)))
    with open(path, "wb") as f:
        f.write(data)
    return packets


def pixel_format(planes: Sequence[np.ndarray], depth: int = 0) -> str:
    """FFmpeg's name of the planar format of `planes` (y, u, v or y
    alone) at `depth` bits (0: 8 for uint8 planes, 10 for uint16)."""
    depth = depth or (8 if planes[0].dtype == np.uint8 else 10)
    (h, w), c = planes[0].shape, planes[-1].shape
    if len(planes) == 3 and c == (-(-h // 2), w):
        name = "yuv440p"
    else:
        name = {0: "gray", 1: "yuv420p", 2: "yuv422p", 3: "yuv444p"}[
            chroma_format(planes)]
    return name if depth == 8 else f"{name}{depth}le"


def vp9_profile(pix_fmt: str) -> int:
    """The VP9 profile of a pixel format: 0 8-bit 4:2:0, 1 8-bit 4:2:2,
    4:4:0, 4:4:4; 2 and 3 the same of 10 or 12 bits."""
    return (0 if pix_fmt.startswith("yuv420p") else 1) + (
        2 if pix_fmt.endswith("le") else 0)


def encode_vp9(frames: Sequence[Tuple[np.ndarray, ...]],
               colour: Optional[Colour] = None, lossless: bool = True,
               depth: int = 0) -> List[Tuple[bytes, bool]]:
    """VP9 of `frames` from the wheel's ``libvpx-vp9`` in the profile of
    their format (:func:`pixel_format` at `depth` bits: uint16 planes of
    10 bits by default), lossless by default (the decoder then gives back
    the planes); `colour` is its frame header's colour space and range."""
    return encode_lavc("libvpx-vp9", frames, colour,
                       pix_fmt=pixel_format(frames[0], depth),
                       lossless=int(lossless), g=1 << 20)


def write_vp9(path: str, frames, *, colour: Optional[Colour] = None,
              container: str = "webm", depth: int = 0,
              **mux) -> List[Tuple[bytes, bool]]:
    """Write :func:`encode_vp9` of `frames` as WebM (``V_VP9``) or as an
    MP4 (``vp09`` with its ``vpcC`` of the stream's profile, depth and
    chroma subsampling); returns the packets."""
    packets = encode_vp9(frames, colour, depth=depth)
    h, w = frames[0][0].shape
    with open(path, "wb") as f:
        if container == "mp4":
            fmt = pixel_format(frames[0], depth)
            bits = int(fmt[-4:-2]) if fmt.endswith("le") else 8
            subsampling = {"yuv420p": 1, "yuv422p": 2, "yuv444p": 3,
                           "yuv440p": 3}[fmt[:7]]
            f.write(mux_mp4(b"", b"", [d for d, _ in packets],
                            [k for _, k in packets], (w, h),
                            entry=vp09_entry((w, h), vp9_profile(fmt), bits,
                                             subsampling), **mux))
        else:
            f.write(mux_mkv("V_VP9", packets, (w, h), doc_type="webm",
                            **mux))
    return packets


def superframe(frames: Sequence[bytes]) -> bytes:
    """VP9 frames in one superframe: the frames, then the index (a marker
    byte, each frame's size in 4 little-endian bytes, the marker again)."""
    marker = 0xC0 | (3 << 3) | (len(frames) - 1)
    index = bytes([marker]) + b"".join(struct.pack("<I", len(f))
                                       for f in frames) + bytes([marker])
    return b"".join(frames) + index


def write_vp9_superframe(src: str, dst: str) -> int:
    """Rewrite the VP9 WebM `src` (profile 0, a key frame first) to `dst`
    with a superframe in its first block, as libvpx's alt-ref frames
    come: the key frame hidden (its show_frame bit cleared) and the second
    frame, shown, in one block; the other blocks as they were.  The key
    frame still refreshes every reference, so the rest decodes as before;
    the picture of the key frame is not shown.  Returns the blocks
    written (the frames shown)."""
    from . import mkv

    with open(src, "rb") as f:
        track = mkv.read_track(src, f)
        data = []
        for b in track.blocks:
            f.seek(b.offset)
            data.append(f.read(b.size))
    key = data[0]
    if key[0] & 0xF6 != 0x82:
        raise ValueError(f"{src}: the first VP9 frame is not a shown "
                         f"profile-0 key frame")
    hidden = bytes([key[0] & ~0x02]) + key[1:]
    packets = [(superframe([hidden, data[1]]), True)] + [
        (d, b.key) for d, b in zip(data[2:], track.blocks[2:])]
    with open(dst, "wb") as f:
        f.write(mux_mkv("V_VP9", packets, track.coded_size, fps=track.fps,
                        doc_type="webm"))
    return len(packets)


# ---------------------------------------------------------------------------
# odd-size fixtures: lossless VP9 of the sizes swscale scales (8-bit of an
# odd height, odd widths), which the card's machine reads but may not write
# ---------------------------------------------------------------------------

class OddSizeFixture(NamedTuple):
    name: str                      # the file, beside VP9_WEBM
    height: int
    width: int
    depth: int
    frames: int
    colour: Optional[Colour] = None
    siting: Optional[Tuple[int, int]] = None   # Matroska's chroma siting
    scene: bool = False            # rendered scenes, else random planes


ODD_SIZE_FIXTURES = (
    OddSizeFixture("vp9_31x48.webm", 31, 48, 8, 3, siting=(1, 1)),
    OddSizeFixture("vp9_33x64.webm", 33, 64, 8, 3),
    OddSizeFixture("vp9_31x47.webm", 31, 47, 8, 3),
    OddSizeFixture("vp9_479x640.webm", 479, 640, 8, 2, scene=True),
    OddSizeFixture("vp9p2_32x47.webm", 32, 47, 10, 3),
    OddSizeFixture("vp9p2_31x65.webm", 31, 65, 10, 3, Colour(1, True),
                   (1, 2)),
)


def odd_size_path(fixture: OddSizeFixture) -> str:
    return os.path.join(os.path.dirname(VP9_WEBM), fixture.name)


def scene_frames(seeds: Sequence[int], h: int, w: int, chroma=(1, 1),
                 depth: int = 8) -> List[Tuple[np.ndarray, ...]]:
    """Planes of rendered scenes (``data.imread_fixtures.render_scene`` of
    each seed) of any size, chroma subsampling `chroma` (log2 (horizontal,
    vertical); None: the luma alone) and `depth` (samples << (depth - 8),
    uint16 above 8 bits): BT.601 studio range, each chroma sample the
    mean of the pixels it covers, rendered at the even size above and cut
    to h x w."""
    from ..data.imread_fixtures import render_scene
    H, W = h + h % 2, w + w % 2
    frames = []
    for seed in seeds:
        f = render_scene(seed, H, W).astype(np.float64)
        b, g, r = f[..., 0], f[..., 1], f[..., 2]
        y = 16 + 0.257 * r + 0.504 * g + 0.098 * b
        planes = [y[:h, :w]]
        if chroma is not None:
            sx, sy = chroma
            for c in (128 - 0.148 * r - 0.291 * g + 0.439 * b,
                      128 + 0.439 * r - 0.368 * g - 0.071 * b):
                c = c.reshape(H >> sy, 1 << sy, W >> sx, 1 << sx).mean(
                    axis=(1, 3))
                planes.append(c[:-(-h >> sy), :-(-w >> sx)])
        frames.append(tuple(
            (np.clip(np.rint(p * (1 << (depth - 8))), 0, (1 << depth) - 1)
             .astype(np.uint8 if depth == 8 else np.uint16))
            for p in planes))
    return frames


def odd_size_frames(fixture: OddSizeFixture):
    """The planes :func:`write_odd_size_fixtures` encodes for `fixture`
    (the decoder gives them back: lossless)."""
    h, w = fixture.height, fixture.width
    if fixture.scene:
        return scene_frames(range(fixture.frames), h, w)
    make = yuv_frames if fixture.depth == 8 else yuv_frames10
    return make(fixture.frames, h, w, seed=h * w)


def write_mpeg4_mkv(path: str, frames, fps: float = 20.0) -> None:
    """MPEG-4 Part 2 of 8-bit `frames` (any size: its VOL states it) from
    the wheel's ``mpeg4`` encoder (the one the XVID writer uses, so the
    card's machine has it too) in Matroska (``V_MPEG4/ISO/ASP``)."""
    h, w = frames[0][0].shape
    with open(path, "wb") as f:
        f.write(mux_mkv("V_MPEG4/ISO/ASP",
                        encode_lavc("mpeg4", frames, fps=round(fps)),
                        (w, h), fps=fps))


# ---------------------------------------------------------------------------
# chroma-format fixtures: lossless VP9 of profiles 1-3 (4:2:2, 4:4:0, 4:4:4;
# 12-bit 4:2:0) of rendered scenes, which the card's machine reads but
# cannot write (its wheel has no libvpx-vp9 encoder)
# ---------------------------------------------------------------------------

class ChromaFixture(NamedTuple):
    name: str                      # the file, beside VP9_WEBM
    height: int
    width: int
    chroma: Tuple[int, int]        # log2 subsampling (horizontal, vertical)
    depth: int
    frames: int
    colour: Optional[Colour] = None
    siting: Optional[Tuple[int, int]] = None   # Matroska's chroma siting


CHROMA_FIXTURES = (
    ChromaFixture("vp9p1_422_48x64.webm", 48, 64, (1, 0), 8, 3),
    ChromaFixture("vp9p1_422_47x64.webm", 47, 64, (1, 0), 8, 2,
                  Colour(1, True), (1, 1)),
    ChromaFixture("vp9p1_440_33x64.webm", 33, 64, (0, 1), 8, 2,
                  siting=(2, 2)),
    ChromaFixture("vp9p1_444_31x47.webm", 31, 47, (0, 0), 8, 2,
                  Colour(1, False), (1, 2)),
    ChromaFixture("vp9p3_422_48x63.webm", 48, 63, (1, 0), 10, 2,
                  siting=(1, 1)),
    ChromaFixture("vp9p3_440_31x34.webm", 31, 34, (0, 1), 10, 2,
                  Colour(9, False)),
    ChromaFixture("vp9p3_444_32x48.webm", 32, 48, (0, 0), 12, 2),
    ChromaFixture("vp9p2_31x48_12bit.webm", 31, 48, (1, 1), 12, 2,
                  siting=(2, 1)),
)


def chroma_fixture_path(fixture: ChromaFixture) -> str:
    return os.path.join(os.path.dirname(VP9_WEBM), fixture.name)


def write_chroma_fixtures() -> List[str]:
    """Write the committed :data:`CHROMA_FIXTURES` (needs the wheel's
    libvpx-vp9 encoder); returns their paths."""
    paths = []
    for fx in CHROMA_FIXTURES:
        mux = {"chroma_siting": fx.siting} if fx.siting else {}
        write_vp9(chroma_fixture_path(fx),
                  scene_frames(range(fx.frames), fx.height, fx.width,
                               fx.chroma, fx.depth),
                  colour=fx.colour, depth=fx.depth, **mux)
        paths.append(chroma_fixture_path(fx))
    return paths


def write_odd_size_fixtures() -> List[str]:
    """Write the committed :data:`ODD_SIZE_FIXTURES` (needs the wheel's
    libvpx-vp9 encoder); returns their paths."""
    paths = []
    for fx in ODD_SIZE_FIXTURES:
        mux = {"chroma_siting": fx.siting} if fx.siting else {}
        write_vp9(odd_size_path(fx), odd_size_frames(fx), colour=fx.colour,
                  **mux)
        paths.append(odd_size_path(fx))
    return paths


# ---------------------------------------------------------------------------
# Motion-JPEG: Pillow's JPEG images (the ones ``demo.video_io.VideoWriter``
# writes, of any chroma subsampling) in AVI, MOV / MP4 and Matroska
# ---------------------------------------------------------------------------

# Pillow's ``subsampling`` of each JPEG chroma format: 4:2:0, 4:2:2, 4:4:4;
# "gray" writes one component
JPEG_SUBSAMPLING = {"420": 2, "422": 1, "444": 0, "gray": None}
MJPEG_CONTAINERS = ("avi", "mov", "mjpa", "mp4", "mkv", "vfw")
MOV_FTYP = box(b"ftyp", b"qt  ", struct.pack(">I", 0x200), b"qt  ",
               b"\0" * 12)


def jpeg_images(frames: Sequence[np.ndarray], sampling: str = "420",
                huffman: bool = True) -> List[bytes]:
    """Baseline JPEGs of BGR `frames` at quality 95 in the chroma format
    `sampling` (a key of :data:`JPEG_SUBSAMPLING`), with Pillow's standard
    Huffman tables; `huffman` False drops the DHT segments and marks each
    image ``AVI1`` (an APP0 after SOI), as cameras' Motion-JPEG comes: the
    decoder then takes the standard tables (ITU-T T.81 K.3)."""
    import io

    from PIL import Image
    out = []
    for frame in frames:
        image = (Image.fromarray(np.ascontiguousarray(frame[..., ::-1]))
                 if sampling != "gray" else Image.fromarray(
                     np.ascontiguousarray(frame[..., 1])))
        buf = io.BytesIO()
        options = dict(quality=95, optimize=False, progressive=False)
        if sampling != "gray":
            options["subsampling"] = JPEG_SUBSAMPLING[sampling]
        image.save(buf, "JPEG", **options)
        data = buf.getvalue()
        if not huffman:
            data = b"\xff\xd8" + _jpeg_segment(0xE0, b"AVI1" + b"\0" * 8) + (
                b"".join(seg for seg in _jpeg_segments(data[2:])
                         if seg[:2] != b"\xff\xc4"))
        out.append(data)
    return out


def _jpeg_segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _jpeg_segments(data: bytes) -> Iterator[bytes]:
    """The marker segments of a JPEG after its SOI, the last (SOS) with
    the entropy-coded data and EOI."""
    at = 0
    while at < len(data):
        if data[at + 1] == 0xDA:             # SOS: the rest of the image
            yield data[at:]
            return
        size = struct.unpack_from(">H", data, at + 2)[0]
        yield data[at:at + 2 + size]
        at += 2 + size


def esds_box(object_type: int, info: bytes = b"") -> bytes:
    """An ``esds`` box: an ES_Descriptor whose DecoderConfigDescriptor
    states `object_type` (objectTypeIndication; 0x20 MPEG-4 Part 2, 0x6C
    JPEG) and carries `info` as its DecoderSpecificInfo."""
    def descriptor(tag: int, payload: bytes) -> bytes:
        return bytes([tag, 0x80, 0x80, 0x80, len(payload)]) + payload
    config = (bytes([object_type, 0x11]) + b"\0" * 11
              + (descriptor(5, info) if info else b""))
    return full_box(b"esds", 0, 0, descriptor(
        3, struct.pack(">HB", 1, 0) + descriptor(4, config)
        + descriptor(6, b"\x02")))


def write_mjpeg(path: str, images: Sequence[bytes], size: Tuple[int, int],
                container: str = "avi", fps: float = 20.0,
                fourcc: bytes = b"MJPG") -> None:
    """JPEG `images` of (w, h) frames at `fps` as Motion-JPEG in
    `container`: ``avi`` (``demo.video_io.VideoWriter``'s ``MJPG`` AVI),
    ``mov`` (QuickTime, a ``jpeg`` sample entry), ``mjpa``
    (the same with an ``mjpa`` entry), ``mp4`` (``mp4v`` of
    objectTypeIndication 0x6C, as cv2 writes ``MJPG`` in ``.mp4``),
    ``mkv`` (``V_MJPEG``) or ``vfw`` (Matroska ``V_MS/VFW/FOURCC`` with a
    BITMAPINFOHEADER of `fourcc`)."""
    from fractions import Fraction

    from .video_io import VideoWriter, bitmap_info
    packets = [(data, True) for data in images]
    if container == "avi":
        writer = VideoWriter(path, fps, size, fourcc="MJPG")
        writer.write_packets(packets)
        writer.release()
        return
    if container in ("mov", "mjpa", "mp4"):
        entry = (visual_entry(b"mp4v", size, esds_box(0x6C))
                 if container == "mp4" else
                 visual_entry(b"jpeg" if container == "mov" else b"mjpa",
                              size))
        rate = Fraction(fps).limit_denominator(1001)
        data = mux_mp4(b"", b"", images, [True] * len(images), size,
                       timescale=rate.numerator * 100,
                       delta=rate.denominator * 100, entry=entry)
        if container != "mp4":
            data = MOV_FTYP + data[len(FTYP):]
    elif container in ("mkv", "vfw"):
        data = (mux_mkv("V_MJPEG", packets, size, fps=fps)
                if container == "mkv" else
                mux_mkv("V_MS/VFW/FOURCC", packets, size, fps=fps,
                        codec_private=bitmap_info(size, fourcc)))
    else:
        raise ValueError(f"Motion-JPEG is written in "
                         f"{', '.join(MJPEG_CONTAINERS)}, not {container!r}")
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# VP8 fixtures: the wheel's libvpx (VP8) of rendered scenes in WebM,
# Matroska and MP4, which the card's machine reads but may not write
# ---------------------------------------------------------------------------

class Vp8Fixture(NamedTuple):
    name: str                      # the file, beside VP9_WEBM
    height: int
    width: int
    frames: int
    container: str = "webm"        # "webm", "mkv", "mp4" or "recorder"
    bit_rate: int = 0              # the encoder's (0: its default)


# "recorder": WebM as a browser's MediaRecorder writes it: a Segment and
# Clusters of unknown size, no Duration, no DefaultDuration, no Cues,
# millisecond timecodes 33 and 34 ms apart in turn (30 frames a second)
VP8_FIXTURES = (
    Vp8Fixture("vp8_48x64.webm", 48, 64, 6),
    Vp8Fixture("vp8_47x63.webm", 47, 63, 3),
    Vp8Fixture("vp8_31x47.webm", 31, 47, 3),
    Vp8Fixture("vp8_48x64.mkv", 48, 64, 4, "mkv"),
    Vp8Fixture("vp8_48x64.mp4", 48, 64, 4, "mp4"),
    Vp8Fixture("vp8_recorder_48x64.webm", 48, 64, 24, "recorder"),
    Vp8Fixture("vp8_480x640.webm", 480, 640, 16, bit_rate=1000000),
)
VP8_DEMO = VP8_FIXTURES[-1]


def vp8_path(fixture: Vp8Fixture) -> str:
    return os.path.join(os.path.dirname(VP9_WEBM), fixture.name)


def write_vp8_fixtures() -> List[str]:
    """Write the committed :data:`VP8_FIXTURES` (needs the wheel's libvpx
    encoder): rendered scenes, one key frame and then inter frames;
    returns their paths."""
    paths = []
    for fx in VP8_FIXTURES:
        options = {"b": fx.bit_rate} if fx.bit_rate else {}
        packets = encode_lavc(
            "libvpx", scene_frames(range(900, 900 + fx.frames), fx.height,
                                   fx.width), g=1 << 20, **options)
        size = (fx.width, fx.height)
        if fx.container == "mp4":
            data = mux_mp4(b"", b"", [d for d, _ in packets],
                           [k for _, k in packets], size,
                           entry=vp09_entry(size, kind=b"vp08"))
        elif fx.container == "recorder":
            data = mux_mkv("V_VP8", packets, size, doc_type="webm",
                           timecodes=[i * 33 + i // 2
                                      for i in range(fx.frames)],
                           unknown_sizes=True, duration=False,
                           default_duration=False)
        else:
            data = mux_mkv("V_VP8", packets, size,
                           block_groups=fx.container == "mkv",
                           doc_type="webm" if fx.container == "webm"
                           else "matroska")
        with open(vp8_path(fx), "wb") as f:
            f.write(data)
        paths.append(vp8_path(fx))
    return paths


if __name__ == "__main__":
    # remake the committed VP9 WebM (needs cv2 with libvpx), the odd-size,
    # chroma-format and VP8 fixtures (the wheel's libvpx-vp9 and libvpx)
    write_cv2_video(VP9_WEBM, "VP90", VP9_WEBM_FRAMES, 48, 64, VP9_WEBM_FPS)
    for path in [VP9_WEBM, *write_odd_size_fixtures(),
                 *write_chroma_fixtures(), *write_vp8_fixtures()]:
        print(path, os.path.getsize(path))
