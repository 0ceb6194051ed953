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
chunk offsets, several chunks, and a composition offset shifted back by
an edit list); :func:`annexb` gives the same stream as an Annex-B byte
stream.  The OpenCV wheels (cv2 4.13 and 5.0) have no H.264 encoder, so
this writer makes the fixtures.
"""

from __future__ import annotations

import os
import re
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

PROFILE_BASELINE = 66
PROFILE_MAIN = 77
LOG2_MAX_POC_LSB = 8        # Main-profile streams: pic_order_cnt_type 0
LEVEL = 40                  # 4.0: 8192 macroblocks a frame, up to 2048x1024
LOG2_MAX_FRAME_NUM = 4
I_PCM = 25                  # mb_type of I_PCM in an I slice
NAL_SLICE, NAL_IDR, NAL_SPS, NAL_PPS = 1, 5, 7, 8
SLICE_P, SLICE_B, SLICE_I = 5, 6, 7   # slice_type + 5: every slice
MATRICES = {                # tkhd matrix (a, b, c, d) per cv2 rotation
    0: (1, 0, 0, 1), 90: (0, 1, -1, 0), 180: (-1, 0, 0, -1),
    270: (0, -1, 1, 0)}


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


def sps(h: int, w: int, main: bool = False,
        reorder: Optional[int] = 0) -> bytes:
    """The SPS: Baseline, ``pic_order_cnt_type`` 2, one reference; or
    `main`: Main profile, ``pic_order_cnt_type`` 0 (each slice carries its
    ``pic_order_cnt_lsb``), two references, for B pictures.  `reorder` is
    the VUI's ``max_num_reorder_frames``; None writes no VUI, as many
    phone encoders do, and leaves the decoder to guess the delay."""
    if h % 2 or w % 2 or h <= 0 or w <= 0:
        raise ValueError(f"4:2:0 frames have an even size, got {h}x{w}")
    mbh, mbw = _mbs(h, w)
    b = BitWriter().u(8, PROFILE_MAIN if main else PROFILE_BASELINE)
    b.u(8, 0x40 if main else 0xC0).u(8, LEVEL)
    b.ue(0)                                   # seq_parameter_set_id
    b.ue(LOG2_MAX_FRAME_NUM - 4)
    if main:
        b.ue(0).ue(LOG2_MAX_POC_LSB - 4)      # pic_order_cnt_type 0
    else:
        b.ue(2)                               # pic_order_cnt_type
    b.ue(2 if main else 1)                    # max_num_ref_frames
    b.u(1, 0)                                 # gaps_in_frame_num_allowed
    b.ue(mbw - 1).ue(mbh - 1)
    b.u(1, 1).u(1, 1)                         # frame_mbs_only, direct_8x8
    crop_x, crop_y = (16 * mbw - w) // 2, (16 * mbh - h) // 2
    b.u(1, int(bool(crop_x or crop_y)))
    if crop_x or crop_y:                      # in 2-sample units (4:2:0)
        b.ue(0).ue(crop_x).ue(0).ue(crop_y)
    b.u(1, int(reorder is not None))          # vui_parameters_present
    if reorder is not None:
        b.u(1, 0).u(1, 0).u(1, 0).u(1, 0)     # aspect, overscan, signal, loc
        b.u(1, 0).u(1, 0).u(1, 0).u(1, 0)     # timing, nal/vcl hrd, pic_struct
        b.u(1, 1)                             # bitstream_restriction
        b.u(1, 1).ue(0).ue(0).ue(16).ue(16)   # mv bounds, bytes, mv lengths
        b.ue(reorder).ue(reorder + 1)         # reorder, dec buffering
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


def pcm_macroblocks(y: np.ndarray, u: np.ndarray, v: np.ndarray
                    ) -> np.ndarray:
    """(n_mb, 384) uint8: each macroblock's 256 luma, 64 Cb and 64 Cr
    samples in raster order, the planes padded to whole macroblocks by
    repeating their last row and column."""
    h, w = y.shape
    mbh, mbw = _mbs(h, w)
    y = np.pad(y, ((0, 16 * mbh - h), (0, 16 * mbw - w)), mode="edge")
    u, v = (np.pad(c, ((0, 8 * mbh - c.shape[0]), (0, 8 * mbw - c.shape[1])),
                   mode="edge") for c in (u, v))
    parts = [y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3).reshape(
        -1, 256)]
    parts += [c.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
              for c in (u, v)]
    return np.concatenate(parts, axis=1)


def ipcm_slice(kind: str, frame_num: int, idr_id: int,
               planes: Optional[Tuple[np.ndarray, ...]], n_mb: int,
               poc: Optional[int] = None) -> bytes:
    """One slice NAL unit of a picture: `kind` "IDR" or "I" with `planes`
    (y, u, v) as I_PCM macroblocks, or "P" skipping all `n_mb`, or "B"
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
    mbs = pcm_macroblocks(*planes)
    body = np.empty((len(mbs), 386), np.uint8)
    body[:, :2] = (0x0D, 0x00)
    body[:, 2:] = mbs
    rbsp = head + body.reshape(-1)[2:].tobytes() + b"\x80"
    return nal(NAL_IDR if kind == "IDR" else NAL_SLICE, 3, rbsp)


def encode_ipcm(frames: Sequence[Optional[Tuple[np.ndarray, ...]]],
                key_every: int = 0) -> Tuple[bytes, bytes, List[bytes],
                                             List[bool]]:
    """(sps, pps, access units, key flags) of `frames`: each a (y, u, v)
    tuple of uint8 planes ((h, w), (h/2, w/2) twice) or None to repeat the
    previous picture (a P slice of skips).  The first frame and every
    `key_every`-th (0: only the first) are IDR pictures."""
    if frames[0] is None:
        raise ValueError("the first frame has to be a picture")
    h, w = frames[0][0].shape
    if h % 2 or w % 2:
        raise ValueError(f"4:2:0 frames have an even size, got {h}x{w}")
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
                c.shape != (h // 2, w // 2) for c in planes[1:])):
            raise ValueError(f"frame {i}: planes {[c.shape for c in planes]}"
                             f" are not those of a {h}x{w} 4:2:0 frame")
        units.append(ipcm_slice(kind, frame_num, idr_id, planes, n_mb))
        keys.append(bool(idr))
        idr_id ^= int(bool(idr))
        frame_num += 1
    return sps(h, w), pps(), units, keys


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


def vp09_entry(size: Tuple[int, int], profile: int = 0, depth: int = 8
               ) -> bytes:
    """A ``vp09`` sample entry with its ``vpcC`` (VP Codec ISO Media File
    Format Binding 1.0: profile, level 3.1, bit depth, 4:2:0, BT.709)."""
    return visual_entry(b"vp09", size, full_box(
        b"vpcC", 1, 0, bytes([profile, 31, (depth << 4) | (1 << 1), 1, 1,
                              1]), b"\0\0"))


def avcc(sps_nal: bytes, pps_nal: bytes) -> bytes:
    return box(b"avcC", bytes([1, sps_nal[1], sps_nal[2], sps_nal[3], 0xFF,
                               0xE1]),
               struct.pack(">H", len(sps_nal)), sps_nal, b"\x01",
               struct.pack(">H", len(pps_nal)), pps_nal)


def mux_mp4(sps_nal: bytes, pps_nal: bytes, units: Sequence[bytes],
            keys: Sequence[bool], size: Tuple[int, int], *,
            timescale: int = 12800, delta: int = 512, rotation: int = 0,
            samples_per_chunk: int = 0, co64: bool = False,
            composition_shift: int = 0,
            composition_offsets: Optional[Sequence[int]] = None,
            edit_start: Optional[int] = None,
            entry: Optional[bytes] = None) -> bytes:
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
    positive) with an edit list at `edit_start`.  `entry` replaces the
    ``avc1`` sample entry (another codec's, e.g. :func:`vp09_entry`); the
    `units` are then the samples as they are."""
    if rotation not in MATRICES:
        raise ValueError(f"rotation {rotation} is not one of 0/90/180/270")
    w, h = size
    samples = (list(units) if entry is not None else
               [struct.pack(">I", len(u)) + u for u in units])
    n = len(samples)
    per = samples_per_chunk or n
    chunks = [samples[i:i + per] for i in range(0, n, per)]
    ftyp = box(b"ftyp", b"isom", struct.pack(">I", 512),
               b"isomiso2avc1mp41")
    mdat_payload = b"".join(b"".join(c) for c in chunks)
    mdat_head = struct.pack(">I4s", 8 + len(mdat_payload), b"mdat")
    offsets, at = [], len(ftyp) + len(mdat_head)
    for c in chunks:
        offsets.append(at)
        at += sum(map(len, c))
    duration = n * delta
    movie_duration = duration * 1000 // timescale
    if entry is None:
        entry = visual_entry(b"avc1", (w, h), avcc(sps_nal, pps_nal))
    stbl = [full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
            full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))]
    if composition_offsets is not None:
        stbl.append(full_box(b"ctts", 0, 0, struct.pack(
            f">I{2 * n}I", n, *(v for off in composition_offsets
                                for v in (1, off)))))
    elif composition_shift:
        stbl.append(full_box(b"ctts", 0, 0, struct.pack(
            ">III", 1, n, composition_shift)))
    sync = [i + 1 for i, k in enumerate(keys) if k]
    stbl.append(full_box(b"stss", 0, 0, struct.pack(
        f">I{len(sync)}I", len(sync), *sync)))
    stsc = [(1, per, 1)]
    if n % per and len(chunks) > 1:
        stsc.append((len(chunks), n % per, 1))
    stbl.append(full_box(b"stsc", 0, 0, struct.pack(">I", len(stsc)),
                         *(struct.pack(">III", *e) for e in stsc)))
    stbl.append(full_box(b"stsz", 0, 0, struct.pack(
        f">II{n}I", 0, n, *map(len, samples))))
    if co64:
        stbl.append(full_box(b"co64", 0, 0, struct.pack(
            f">I{len(offsets)}Q", len(offsets), *offsets)))
    else:
        stbl.append(full_box(b"stco", 0, 0, struct.pack(
            f">I{len(offsets)}I", len(offsets), *offsets)))
    minf = box(b"minf", full_box(b"vmhd", 0, 1, b"\0" * 8),
               box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                     full_box(b"url ", 0, 1))),
               box(b"stbl", *stbl))
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
    if composition_shift or edit_start is not None:
        start = composition_shift if edit_start is None else edit_start
        trak.append(box(b"edts", full_box(b"elst", 0, 0, struct.pack(
            ">IIiI", 1, movie_duration, start, 1 << 16))))
    moov = box(b"moov",
               full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000,
                                                   movie_duration),
                        struct.pack(">IH", 1 << 16, 1 << 8), b"\0" * 10,
                        _matrix(0), b"\0" * 24, struct.pack(">I", 2)),
               box(b"trak", *trak, mdia))
    return ftyp + mdat_head + mdat_payload + moov


def yuv_frames(n: int, h: int, w: int, seed: int = 0
               ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """`n` pictures of random 4:2:0 planes from `seed`, each unlike the
    others (a decoder that shows a stale picture fails an exact check)."""
    rng = np.random.RandomState(seed)
    return [tuple(rng.randint(0, 256, s, dtype=np.uint8)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
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
        12800, 512), key_every: int = 0, **mux) -> Tuple[bytes, bytes,
                                                         List[bytes]]:
    """Write `frames` (see :func:`encode_ipcm`) as an I_PCM H.264 MP4;
    returns (sps, pps, access units)."""
    s, p, units, keys = encode_ipcm(frames, key_every)
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
            doc_type: str = "matroska") -> bytes:
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
    (and `yaw`, ``ProjectionPoseYaw``).
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


def write_ipcm_mkv(path: str, frames, *, key_every: int = 0, **mux
                   ) -> Tuple[bytes, bytes, List[bytes]]:
    """Write `frames` (see :func:`encode_ipcm`) as I_PCM H.264 in
    Matroska (``V_MPEG4/ISO/AVC``, 4-byte NAL lengths); returns (sps, pps,
    access units)."""
    s, p, units, keys = encode_ipcm(frames, key_every)
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


if __name__ == "__main__":
    # remake the committed VP9 WebM (needs cv2 with libvpx)
    write_cv2_video(VP9_WEBM, "VP90", VP9_WEBM_FRAMES, 48, 64, VP9_WEBM_FPS)
    print(VP9_WEBM, os.path.getsize(VP9_WEBM))
