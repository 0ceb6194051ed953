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

import re
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

PROFILE_BASELINE = 66
LEVEL = 40                  # 4.0: 8192 macroblocks a frame, up to 2048x1024
LOG2_MAX_FRAME_NUM = 4
I_PCM = 25                  # mb_type of I_PCM in an I slice
NAL_SLICE, NAL_IDR, NAL_SPS, NAL_PPS = 1, 5, 7, 8
SLICE_P, SLICE_I = 5, 7     # slice_type + 5: every slice of the picture
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


def sps(h: int, w: int) -> bytes:
    if h % 2 or w % 2 or h <= 0 or w <= 0:
        raise ValueError(f"4:2:0 frames have an even size, got {h}x{w}")
    mbh, mbw = _mbs(h, w)
    b = BitWriter().u(8, PROFILE_BASELINE).u(8, 0xC0).u(8, LEVEL)
    b.ue(0)                                   # seq_parameter_set_id
    b.ue(LOG2_MAX_FRAME_NUM - 4)
    b.ue(2)                                   # pic_order_cnt_type
    b.ue(1)                                   # max_num_ref_frames
    b.u(1, 0)                                 # gaps_in_frame_num_allowed
    b.ue(mbw - 1).ue(mbh - 1)
    b.u(1, 1).u(1, 1)                         # frame_mbs_only, direct_8x8
    crop_x, crop_y = (16 * mbw - w) // 2, (16 * mbh - h) // 2
    b.u(1, int(bool(crop_x or crop_y)))
    if crop_x or crop_y:                      # in 2-sample units (4:2:0)
        b.ue(0).ue(crop_x).ue(0).ue(crop_y)
    b.u(1, 1)                                 # vui_parameters_present
    b.u(1, 0).u(1, 0).u(1, 0).u(1, 0)         # aspect, overscan, signal, loc
    b.u(1, 0).u(1, 0).u(1, 0).u(1, 0)         # timing, nal/vcl hrd, pic_struct
    b.u(1, 1)                                 # bitstream_restriction
    b.u(1, 1).ue(0).ue(0).ue(16).ue(16)       # mv bounds, bytes, mv lengths
    b.ue(0).ue(1)                             # reorder 0, dec buffering 1
    return nal(NAL_SPS, 3, b.trailing().bytes())


def pps() -> bytes:
    b = BitWriter().ue(0).ue(0)               # pps id, sps id
    b.u(1, 0).u(1, 0).ue(0)                   # CAVLC, no field POC, 1 group
    b.ue(0).ue(0).u(1, 0).u(2, 0)             # refs l0/l1, no weighting
    b.se(0).se(0).se(0)                       # QP, QS, chroma offset
    b.u(1, 1).u(1, 0).u(1, 0)                 # deblocking control present
    return nal(NAL_PPS, 3, b.trailing().bytes())


def _header(kind: str, frame_num: int, idr_id: int) -> BitWriter:
    b = BitWriter().ue(0).ue(SLICE_P if kind == "P" else SLICE_I).ue(0)
    b.u(LOG2_MAX_FRAME_NUM, frame_num % (1 << LOG2_MAX_FRAME_NUM))
    if kind == "IDR":
        b.ue(idr_id)
    if kind == "P":
        b.u(1, 0).u(1, 0)                     # no ref override, no reorder
    if kind == "IDR":
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
               planes: Optional[Tuple[np.ndarray, ...]], n_mb: int) -> bytes:
    """One slice NAL unit of a picture: `kind` "IDR" or "I" with `planes`
    (y, u, v) as I_PCM macroblocks, or "P" skipping all `n_mb`."""
    b = _header(kind, frame_num, idr_id)
    if kind == "P":
        b.ue(n_mb)                            # mb_skip_run: all of them
        return nal(NAL_SLICE, 2, b.trailing().bytes())
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
            edit_start: Optional[int] = None) -> bytes:
    """An MP4 of one H.264 track: samples of 4-byte-length-prefixed NAL
    units, `delta` / `timescale` seconds each.  `size` is (w, h) before
    rotation; `rotation` (0/90/180/270) is the clockwise turn cv2 applies
    (the ``tkhd`` matrix).  `samples_per_chunk` > 0 splits the samples
    into chunks of that many; `co64` writes 64-bit chunk offsets;
    `composition_shift` > 0 writes every sample's composition time that
    much late (``ctts``) and an edit list that starts the presentation
    there, as muxers do for streams with B-frames, or at `edit_start`
    (media units) where given."""
    if rotation not in MATRICES:
        raise ValueError(f"rotation {rotation} is not one of 0/90/180/270")
    w, h = size
    samples = [struct.pack(">I", len(u)) + u for u in units]
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
    entry = box(b"avc1", b"\0" * 6, struct.pack(">H", 1), b"\0" * 16,
                struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1),
                b"\0" * 32, struct.pack(">Hh", 0x18, -1),
                avcc(sps_nal, pps_nal))
    stbl = [full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
            full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))]
    if composition_shift:
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
