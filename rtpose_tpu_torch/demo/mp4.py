"""MP4 / MOV (ISO-BMFF, ISO 14496-12) demuxing in pure Python: the first
video track's samples and what ``cv2.VideoCapture`` reports of it.

Read boxes: ``ftyp``, ``moov/mvhd``, ``moov/trak/{tkhd, edts/elst,
mdia/{mdhd, hdlr, minf/stbl}}``; of the sample table ``stsd`` (``avc1`` /
``avc3`` with ``avcC``; ``hvc1`` / ``hev1`` with ``hvcC``; ``mp4v`` with
``esds`` and its
DecoderSpecificInfo, or of objectTypeIndication 0x6C, JPEG; ``vp09`` and
``vp08`` with ``vpcC``; QuickTime's Motion-JPEG ``jpeg`` and ``mjpa``;
ProRes ``apco``, ``apcs``, ``apcn``, ``apch``, ``ap4h``, ``ap4x``, whose
decoder takes the entry as its tag; the entry's ``colr``),
``stts``, ``ctts``,
``stsc``, ``stsz`` / ``stz2``, ``stco`` / ``co64`` and ``stss``; of a
fragmented file ``moov/mvex/trex`` and each ``moof/traf`` (``tfhd``,
``tfdt``, ``trun``), its samples after the sample table's.  ``styp``,
``sidx``, ``mfra`` and every other box are skipped by their size.

- :attr:`Track.samples` are in decode order, ``(offset, size, dts, cts,
  key)``; ``key`` marks the sync samples of ``stss`` (every sample
  without one): the points a decoder can start from.
- :meth:`Track.packets` gives each sample as the decoder takes it: H.264
  as Annex-B, its length prefixes replaced by start codes and the
  ``avcC`` SPS and PPS put ahead of each IDR picture that carries none
  (FFmpeg's ``h264_mp4toannexb``, which cv2's raw packets go through,
  start codes and all); HEVC likewise, the ``hvcC`` parameter sets put
  ahead of the first IRAP picture of every sample that holds one, in-band
  sets or not (``hevc_mp4toannexb``); MPEG-4 Part 2 as stored, the
  DecoderSpecificInfo (VOS / VOL headers) ahead of the first sample; VP8
  and VP9 frames, JPEG images and ProRes frames as stored.  Its key flag is the one cv2
  reports (``CAP_PROP_LRF_HAS_KEY_FRAME``): :func:`intra_picture`'s, the
  flag FFmpeg's parsers set, for H.264, MPEG-4, VP8, VP9 and Motion-JPEG
  (every intra-coded picture, non-IDR I pictures of H.264 too); the
  sample table's sync flag for HEVC, which libavformat does not parse in
  MP4.
- ``rotation`` is the clockwise turn cv2 reports as
  ``CAP_PROP_ORIENTATION_META`` and applies under
  ``CAP_PROP_ORIENTATION_AUTO`` (0/90/180/270), from the ``tkhd`` matrix
  times the ``mvhd`` one as FFmpeg composes them; ``fps`` (the samples
  over their duration, fragments' too, FFmpeg's ``avg_frame_rate``),
  ``size`` (``(w, h)`` of the sample entry, swapped by a quarter turn)
  and ``frame_count`` (the sample table's samples, ``nb_frames``; for a
  file whose samples are all in fragments, ``floor(duration x fps +
  0.5)``) are cv2's.
- ``colour`` is what the sample entry's ``colr`` box states (``nclx``:
  primaries, transfer, matrix and the full-range bit; QuickTime's
  ``nclc``: no range), as libavformat hands it to the decoder, which
  keeps it where the bitstream states none (:class:`StreamColour`).
- An edit list, of any number of entries, is followed as FFmpeg's
  ``mov_fix_index`` follows it (:meth:`Track.schedule`): each edit
  decodes from a key sample and shows its span; the pictures decoded
  outside it are dropped, as FFmpeg drops them, and a picture two edits
  show is shown twice.

Refused, with an error naming the box or codec and ROADMAP.md queue 1
item 4: an edit of a media rate other than 1 (cv2 plays it at rate 1),
VP9 of a profile and depth VP9 does not pair (``vpcC``), HEVC of other
than 8, 10 or 12 bits or of another chroma than luma depth (``hvcC``;
item 4i), and every codec but H.264, HEVC, MPEG-4 Part 2, VP8, VP9,
Motion-JPEG and ProRes (AV1, Motion-JPEG format B ``mjpb``, H.263
``s263``: item 4j (e), ...).  A frame format
the reader does not convert is refused by the decoder's first picture
(``native/avcodec.py``).
"""

from __future__ import annotations

import math
import struct
from typing import BinaryIO, Dict, Iterator, List, NamedTuple, Optional, \
    Tuple

from ..native.avcodec import CodecParams, StreamColour

CONTAINERS = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide",
              b"uuid", b"pdin", b"meta", b"moof", b"mfra", b"styp")
HEVC_ENTRIES = (b"hvc1", b"hev1")
# QuickTime's Motion-JPEG sample entries (libavformat's movvideo tags)
MJPEG_ENTRIES = (b"jpeg", b"mjpa")
OTHER_CODECS = {b"dvhe": "Dolby Vision", b"mjpb": "Motion-JPEG format B",
                b"av01": "AV1", b"mp4a": "AAC audio",
                b"mjp2": "Motion JPEG 2000", b"dvh1": "Dolby Vision",
                b"s263": "H.263 (ROADMAP.md queue 1 item 4j (e))"}
# ProRes sample entries (libavformat's movvideo tags): 422 proxy, LT,
# standard and HQ (10-bit 4:2:2), 4444 and 4444 XQ (12-bit 4:4:4)
PRORES_ENTRIES = (b"apco", b"apcs", b"apcn", b"apch", b"ap4h", b"ap4x")
# the codecs whose every frame is a key, and those whose key
# intra_picture reads from a picture header
INTRA_ONLY = frozenset(["mjpeg", "rawvideo", "huffyuv", "ffvhuff",
                        "prores"])
PICTURE_HEADERS = frozenset(["msmpeg4v2", "msmpeg4", "wmv1", "wmv2", "flv",
                             "ffv1"])
# esds objectTypeIndication -> the decoder (libavformat's ff_mp4_obj_type)
OBJECT_TYPES = {0x20: "mpeg4", 0x6C: "mjpeg"}
# (profile, bits) that a VP9 stream pairs: 0 and 1 (4:2:2, 4:4:0, 4:4:4)
# of 8 bits, 2 and 3 of 10 or 12
VP9_DEPTHS = frozenset([(0, 8), (1, 8), (2, 10), (2, 12), (3, 10), (3, 12)])


def refusal(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what}; the video reader takes H.264, HEVC "
                      f"(8, 10 and 12 bits), MPEG-4 Part 2 and Motion-JPEG "
                      f"in MP4/MOV (fragmented too), AVI or Matroska, VP8 "
                      f"and VP9 in WebM, Matroska or MP4, ProRes in MOV or "
                      f"Matroska, what cv2's VideoWriter writes (raw video,"
                      f" MPEG-1/2, MS-MPEG4, WMV1/2, Sorenson H.263, "
                      f"HuffYUV, FFV1) in AVI or Matroska, and MPEG-1/2, "
                      f"MPEG-4 Part 2, H.264 and HEVC in MPEG-TS / M2TS and "
                      f"MPEG program streams (other containers and codecs: "
                      f"ROADMAP.md queue 1 item 4)")


class Sample(NamedTuple):
    offset: int
    size: int
    dts: int
    cts: int
    key: bool
    duration: int


def boxes(data: bytes, start: int = 0, end: Optional[int] = None
          ) -> Iterator[Tuple[bytes, int, int]]:
    """(type, payload start, payload end) of the boxes in data[start:end]."""
    end = len(data) if end is None else end
    at = start
    while at + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, at)
        head = 8
        if size == 1:
            size = struct.unpack_from(">Q", data, at + 8)[0]
            head = 16
        elif size == 0:
            size = end - at
        if size < head or at + size > end:
            raise ValueError(f"box {kind!r} at {at} overruns its parent")
        yield kind, at + head, at + size
        at += size


def _children(data: bytes, start: int, end: int) -> Dict[bytes, Tuple[int,
                                                                     int]]:
    out: Dict[bytes, Tuple[int, int]] = {}
    for kind, s, e in boxes(data, start, end):
        out.setdefault(kind, (s, e))
    return out


def _full(data: bytes, s: int) -> Tuple[int, int]:
    """A full box's version and the payload start past its flags."""
    return data[s], s + 4


def _table(data: bytes, s: int, fmt: str) -> List[tuple]:
    """The entries of a full box that holds a count and fixed records."""
    _, s = _full(data, s)
    n = struct.unpack_from(">I", data, s)[0]
    rec = struct.calcsize(fmt)
    return [struct.unpack_from(fmt, data, s + 4 + i * rec) for i in range(n)]


def _descriptor(data: bytes, at: int) -> Tuple[int, int, int]:
    """An MPEG-4 descriptor's (tag, payload start, payload end)."""
    tag, at = data[at], at + 1
    size = 0
    for _ in range(4):
        b = data[at]
        at += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, at, at + size


def esds_config(data: bytes, s: int, e: int) -> Tuple[int, bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an ``esds`` box."""
    _, at = _full(data, s)
    tag, at, end = _descriptor(data, at)
    if tag != 3:
        raise ValueError("esds holds no ES_Descriptor")
    flags = data[at + 2]
    at += 3 + (2 if flags & 0x80 else 0)
    if flags & 0x40:
        at += 1 + data[at]
    at += 2 if flags & 0x20 else 0
    while at < end:
        tag, ps, pe = _descriptor(data, at)
        if tag == 4:                       # DecoderConfigDescriptor
            oti = data[ps]
            at = ps + 13
            while at < pe:
                tag, ds, de = _descriptor(data, at)
                if tag == 5:
                    return oti, bytes(data[ds:de])
                at = de
            return oti, b""
        at = pe
    raise ValueError("esds holds no DecoderConfigDescriptor")


def avcc_config(data: bytes, s: int, e: int
                ) -> Tuple[int, List[bytes], List[bytes]]:
    """(NAL length size, SPS list, PPS list) of an ``avcC`` box."""
    length = (data[s + 4] & 3) + 1
    at = s + 5
    sets = []
    for mask in (0x1F, 0xFF):
        n, at = data[at] & mask, at + 1
        units = []
        for _ in range(n):
            size = struct.unpack_from(">H", data, at)[0]
            units.append(bytes(data[at + 2:at + 2 + size]))
            at += 2 + size
        sets.append(units)
    return length, sets[0], sets[1]


HEVC_IRAP = range(16, 24)          # BLA, IDR, CRA and reserved IRAP types
CHROMA_FORMATS = {0: "4:0:0", 1: "4:2:0", 2: "4:2:2", 3: "4:4:4"}


class HevcConfig(NamedTuple):
    nal_length: int
    params: List[bytes]        # the arrays' NAL units (VPS, SPS, PPS, SEI)
    chroma: int                # chroma_format_idc
    depth: Tuple[int, int]     # luma, chroma bits


def hvcc_config(data: bytes, s: int, e: int) -> HevcConfig:
    """An ``hvcC`` record's (ISO 14496-15 8.3.3) NAL length size,
    parameter sets, chroma format and bit depths."""
    if e - s < 23:
        raise ValueError("an hvcC record shorter than its 23-byte header")
    at, params = s + 23, []
    for _ in range(data[s + 22]):
        count = struct.unpack_from(">H", data, at + 1)[0]
        at += 3
        for _ in range(count):
            size = struct.unpack_from(">H", data, at)[0]
            params.append(bytes(data[at + 2:at + 2 + size]))
            at += 2 + size
    return HevcConfig((data[s + 21] & 3) + 1, params, data[s + 16] & 3,
                      (8 + (data[s + 17] & 7), 8 + (data[s + 18] & 7)))


def hevc_refusal(chroma: int, depth: Tuple[int, int]) -> Optional[str]:
    """What names HEVC the reader does not convert (ROADMAP.md queue 1 item
    4i): of other than 8, 10 or 12 bits, or with chroma of another depth
    than the luma; None for the rest (Main, Main 10, Main 12 and the
    range extensions' 4:2:2, 4:4:4 and 4:0:0)."""
    if depth[0] in (8, 10, 12) and (chroma == 0 or depth[1] == depth[0]):
        return None
    bits = f"{depth[0]}" if depth[0] == depth[1] else "%d/%d" % depth
    return (f"HEVC of {bits} bits, {CHROMA_FORMATS.get(chroma, chroma)} "
            f"(only 8, 10 and 12 bits, luma and chroma alike, are read; "
            f"item 4i)")


# what libavformat keeps of a colr box's numbers (av_color_*_name): others
# become 2, unspecified
VALID_PRIMARIES = frozenset([*range(1, 13), 22])
VALID_TRANSFERS = frozenset(range(1, 19))
VALID_MATRICES = frozenset(range(0, 18))


def colr_colour(data: bytes, s: int, e: int) -> Optional[StreamColour]:
    """A ``colr`` box's colour as libavformat's mov_read_colr hands it to
    the decoder: ``nclx`` (ISO) and ``nclc`` (QuickTime, no range bit);
    None for an ICC profile or another type."""
    kind = bytes(data[s:s + 4])
    if kind not in (b"nclx", b"nclc") or e - s < 10:
        return None
    primaries, transfer, matrix = struct.unpack_from(">HHH", data, s + 4)
    full = bool(data[s + 10] >> 7) if kind == b"nclx" and e - s > 10 \
        else None
    return StreamColour(
        matrix if matrix in VALID_MATRICES else 2, full,
        primaries=primaries if primaries in VALID_PRIMARIES else 2,
        transfer=transfer if transfer in VALID_TRANSFERS else 2)


def annexb_hevc(sample: bytes, nal_length: int, extradata: bytes) -> bytes:
    """One HEVC sample of `nal_length`-byte length-prefixed NAL units as
    Annex-B, as hevc_mp4toannexb writes it: a 4-byte start code each,
    `extradata` (the ``hvcC`` sets as Annex-B) ahead of the sample's
    first IRAP NAL unit."""
    out: List[bytes] = []
    n, at = nal_length, 0
    irap = False
    while at + n <= len(sample):
        size = int.from_bytes(sample[at:at + n], "big")
        unit = sample[at + n:at + n + size]
        if size < 2 or len(unit) != size:
            raise ValueError(f"an HEVC NAL unit of {size} bytes runs past "
                             f"its sample")
        if (unit[0] >> 1) & 0x3F in HEVC_IRAP and not irap:
            out.append(extradata)
            irap = True
        out.append(b"\x00\x00\x00\x01" + unit)
        at += n + size
    return b"".join(out)


def _matrix(data: bytes, at: int) -> List[List[int]]:
    m = struct.unpack_from(">9i", data, at)
    return [list(m[0:3]), list(m[3:6]), list(m[6:9])]


def display_rotation(tkhd: List[List[int]], mvhd: List[List[int]]
                     ) -> int:
    """cv2's CAP_PROP_ORIENTATION_META of a track: FFmpeg's display
    matrix (tkhd x mvhd, 16.16 and 2.30 fixed point) read by
    ``av_display_rotation_get``, negated, rounded, in [0, 360)."""
    sh = (16, 16, 30)
    m = [[sum((tkhd[i][e] * mvhd[e][j]) >> sh[e] for e in range(3))
          for j in range(3)] for i in range(3)]
    a, b, c, d = (v / 65536.0 for v in (m[0][0], m[0][1], m[1][0], m[1][1]))
    s0, s1 = math.hypot(a, c), math.hypot(b, d)
    if s0 == 0 or s1 == 0:
        return 0
    angle = math.atan2(b / s1, a / s0) * 180 / math.pi
    # cv2: -cvRound(av_display_rotation_get(m)), av_display_rotation_get
    # being -angle; cvRound rounds half to even
    rot = -int(round(-angle))
    return rot + 360 if rot < 0 else rot


class Edit(NamedTuple):
    duration: float         # media units (inf: to the end of the media)
    media_time: int         # -1: an empty edit


class Track:
    """The first video track of an MP4/MOV file."""

    codec: str                     # "h264", "hevc", "mpeg4", "vp8", "vp9"
    #                                or "mjpeg"
    samples: List[Sample]          # the sample table's, then the fragments'
    table_samples: int             # how many the moov's sample table holds
    timescale: int
    coded_size: Tuple[int, int]    # (w, h) of the sample entry
    rotation_meta: int             # cv2's CAP_PROP_ORIENTATION_META
    fps: float
    edits: List[Edit]              # the elst's, in media units
    has_ctts: bool = False         # the sample table has a ctts box
    nal_length: int = 0            # H.264, HEVC: NAL length prefix bytes
    sps: List[bytes]
    pps: List[bytes]
    param_sets: bytes = b""        # HEVC: the hvcC sets as Annex-B
    decoder_info: bytes = b""      # MPEG-4: DecoderSpecificInfo
    colour: Optional[StreamColour] = None   # the sample entry's colr
    tag: bytes = b""               # ProRes: the sample entry, its decoder's
    params: Optional[CodecParams] = None    # ProRes: the entry's size

    @property
    def rotation(self) -> int:
        """The turn applied to frames (cv2 applies only quarter turns)."""
        return self.rotation_meta if self.rotation_meta in (
            90, 180, 270) else 0

    @property
    def size(self) -> Tuple[int, int]:
        w, h = self.coded_size
        return (h, w) if self.rotation in (90, 270) else (w, h)

    @property
    def frame_count(self) -> int:
        """cv2's: the sample table's count (``nb_frames``); for a file
        whose samples are all in fragments, ``floor(duration x fps +
        0.5)`` over the fragments' span."""
        if self.table_samples or not self.samples:
            return self.table_samples
        first = min(s.dts for s in self.samples)
        end = max(s.dts + s.duration for s in self.samples)
        micros = ((end - first) * 1000000 + self.timescale // 2) \
            // self.timescale
        return int(math.floor(micros / 1e6 * self.fps + 0.5))

    def schedule(self) -> Tuple[List[int], List[bool]]:
        """(the samples fed to the decoder, in order; whether each picture
        the decoder gives, in its order, is shown), as FFmpeg's
        ``mov_fix_index`` rebuilds the index for an edit list: a leading
        empty edit only delays; each other edit decodes from the last key
        sample whose decode and composition times are at or before its
        media time (the first sample if none), through the first key
        sample that ends at or past its end (with ``ctts``, the second),
        and shows the pictures whose composition time lies in [media
        time, media time + duration).  Pictures come out of the decoder
        in composition order within each edit.  A sample two edits cover
        is decoded and shown twice.  Fragments' samples follow, all shown
        (FFmpeg applies edits to the sample table's index only)."""
        table = self.samples[:self.table_samples]
        order: List[int] = []
        shown: List[bool] = []
        edits = list(self.edits)
        while edits and edits[0].media_time == -1:
            edits.pop(0)
        if not edits:
            edits = [Edit(math.inf, min((s.cts for s in table), default=0))]
        for edit in edits:
            start, end = edit.media_time, edit.media_time + edit.duration
            first = 0
            for i, smp in enumerate(table):
                if smp.dts > start:
                    break
                if smp.key and smp.cts <= start:
                    first = i
            picked: List[Tuple[int, int, bool]] = []
            keys_after = 0
            for i in range(first, len(table)):
                smp = table[i]
                picked.append((smp.cts, i, start <= smp.cts < end))
                length = (table[i + 1].dts - smp.dts if i + 1 < len(table)
                          else edit.duration)
                if smp.cts + length >= end and smp.key:
                    keys_after += 1
                    if keys_after > int(self.has_ctts):
                        break
            order += [i for _, i, _ in picked]
            shown += [show for _, _, show in sorted(picked)]
        rest = range(self.table_samples, len(self.samples))
        return order + list(rest), shown + [True] * len(rest)

    @property
    def shown(self) -> List[bool]:
        """Whether each picture the decoder gives, in its order, is shown
        (:meth:`schedule`)."""
        return self.schedule()[1]

    def packets(self, f: BinaryIO) -> Iterator[Tuple[bytes, bool]]:
        """(bytes for the decoder, key) of each sample :meth:`schedule`
        feeds the decoder."""
        for n, i in enumerate(self.schedule()[0]):
            s = self.samples[i]
            f.seek(s.offset)
            data = f.read(s.size)
            if len(data) != s.size:
                raise ValueError(f"sample {i} runs past the end of the file")
            if self.codec == "h264":
                data = annexb(data, self.nal_length, self.sps, self.pps)
            elif self.codec == "hevc":
                data = annexb_hevc(data, self.nal_length, self.param_sets)
            elif self.codec == "mpeg4" and n == 0:
                data = self.decoder_info + data
            # libavformat parses no HEVC in MP4: cv2's key is the sync flag
            yield data, (s.key if self.codec == "hevc"
                         else intra_picture(self.codec, data))


def annexb(sample: bytes, nal_length: int, sps: List[bytes],
           pps: List[bytes]) -> bytes:
    """One H.264 sample of `nal_length`-byte length-prefixed NAL units as
    Annex-B, as h264_mp4toannexb writes it: the parameter sets `sps` and
    `pps` (``avcC``'s) go ahead of an IDR picture that carries none."""
    out: List[bytes] = []
    n, at = nal_length, 0
    sets_seen = False
    while at + n <= len(sample):
        size = int.from_bytes(sample[at:at + n], "big")
        unit = sample[at + n:at + n + size]
        if size == 0 or len(unit) != size:
            raise ValueError(f"an H.264 NAL unit of {size} bytes runs "
                             f"past its sample")
        kind = unit[0] & 0x1F
        if kind in (7, 8):
            sets_seen = True
        elif kind == 5 and not sets_seen and unit[1] & 0x80:
            # an IDR picture's first slice, no parameter sets before it
            for ps in (*sps, *pps):
                out.append(b"\x00\x00\x00\x01" + ps)
            sets_seen = True
        code = (b"\x00\x00\x00\x01" if not out or kind in (7, 8)
                else b"\x00\x00\x01")
        out.append(code + unit)
        at += n + size
    return b"".join(out)


def _ue(bits: str, at: int) -> Tuple[int, int]:
    """An Exp-Golomb code of a bit string: (value, next position)."""
    zeros = 0
    while bits[at + zeros] == "0":
        zeros += 1
    end = at + 2 * zeros + 1
    return int(bits[at + zeros:end], 2) - 1, end


def intra_picture(codec: str, packet: bytes) -> bool:
    """Whether a packet (H.264 or HEVC Annex-B, MPEG-1/2 video, MPEG-4
    Part 2, VP8, VP9, a JPEG image, or a frame of cv2's writer's codecs or
    ProRes) is a key, as FFmpeg's parsers and decoders flag it: an IDR
    slice or an I / SI slice first (H.264); an IRAP picture, NAL types
    16-23, and no other intra picture (HEVC); an I picture
    (``picture_coding_type`` 1); an I-VOP; a VP8 key frame (its frame
    tag's bit 0 clear); a VP9 key frame (its uncompressed header's
    frame_type 0, not a shown existing frame); every JPEG image, raw,
    HuffYUV and ProRes frame; an I picture of MS-MPEG4 / WMV1 (2 bits of
    picture type 0), WMV2 (1 bit) or Sorenson H.263 (2 bits after the
    17-bit start, version, number and size); an FFV1 key frame (its first
    range-coded bit, state 128: the first 16 bits at least 0x7F80)."""
    if codec in INTRA_ONLY:
        return True
    if not packet and codec in PICTURE_HEADERS:
        return False
    if codec in ("msmpeg4v2", "msmpeg4", "wmv1"):
        return packet[0] >> 6 == 0
    if codec == "wmv2":
        return not packet[0] & 0x80
    if codec == "flv":
        bits = "".join(f"{b:08b}" for b in packet[:12])
        size_bits = {"000": 16, "001": 32}.get(bits[30:33], 0)
        return bits[33 + size_bits:35 + size_bits] == "00"
    if codec == "ffv1":
        return int.from_bytes(packet[:2], "big") >= 0x7F80
    if codec == "vp8":
        return bool(packet) and not packet[0] & 1
    if codec == "hevc":
        at = packet.find(b"\x00\x00\x01")
        while 0 <= at < len(packet) - 3:
            kind = (packet[at + 3] >> 1) & 0x3F
            if kind in HEVC_IRAP:
                return True
            if kind < 32:                     # a VCL unit of no IRAP
                return False
            at = packet.find(b"\x00\x00\x01", at + 3)
        return False
    if codec in ("mpeg1video", "mpeg2video"):
        at = packet.find(b"\x00\x00\x01\x00")
        return 0 <= at < len(packet) - 5 and (packet[at + 5] >> 3) & 7 == 1
    if codec == "vp9":
        if not packet or packet[0] >> 6 != 2:
            return False
        bits = f"{packet[0]:08b}"
        at = 5 if bits[2:4] == "11" else 4       # profile 3: a reserved bit
        return bits[at] == "0" and bits[at + 1] == "0"
    if codec == "mpeg4":
        at = packet.find(b"\x00\x00\x01\xb6")
        return 0 <= at < len(packet) - 4 and packet[at + 4] >> 6 == 0
    at = packet.find(b"\x00\x00\x01")
    while at >= 0:
        kind = packet[at + 3] & 0x1F if at + 3 < len(packet) else 0
        if kind == 5:
            return True
        if kind == 1:
            head = packet[at + 4:at + 12].replace(b"\x00\x00\x03",
                                                  b"\x00\x00")
            bits = "".join(f"{b:08b}" for b in head)
            try:
                _, pos = _ue(bits, 0)             # first_mb_in_slice
                return _ue(bits, pos)[0] % 5 in (2, 4)
            except (IndexError, ValueError):
                return False
        at = packet.find(b"\x00\x00\x01", at + 3)
    return False


def _visual_entry(path: str, data: bytes, s: int, e: int) -> Tuple[
        bytes, int, int, int, int]:
    """(sample entry type, width, height, child start, entry end) of the
    first entry of an stsd box."""
    _, at = _full(data, s)
    if struct.unpack_from(">I", data, at)[0] < 1:
        raise refusal(path, "the video track's stsd box holds no entry")
    size, kind = struct.unpack_from(">I4s", data, at + 4)
    start = at + 4
    w, h = struct.unpack_from(">HH", data, start + 8 + 24)
    return kind, w, h, start + 8 + 78, start + size


def _sample_table(path: str, data: bytes, s: int, e: int, track: Track
                  ) -> None:
    stbl = _children(data, s, e)
    for need in (b"stsd", b"stts", b"stsc"):
        if need not in stbl:
            raise refusal(path, f"the video track has no {need.decode()} "
                                f"box")
    kind, w, h, cs, ce = _visual_entry(path, data, *stbl[b"stsd"])
    track.coded_size = (w, h)
    config = _children(data, cs, ce)
    if kind in (b"avc1", b"avc3"):
        if b"avcC" not in config:
            raise refusal(path, f"the {kind.decode()} entry has no avcC "
                                f"box")
        track.codec = "h264"
        track.nal_length, track.sps, track.pps = avcc_config(
            data, *config[b"avcC"])
    elif kind in HEVC_ENTRIES:
        if b"hvcC" not in config:
            raise refusal(path, f"the {kind.decode()} entry has no hvcC "
                                f"box")
        hevc = hvcc_config(data, *config[b"hvcC"])
        refused = hevc_refusal(hevc.chroma, hevc.depth)
        if refused:
            raise refusal(path, f"{refused} ({kind.decode()} sample entry)")
        track.codec = "hevc"
        track.nal_length = hevc.nal_length
        track.param_sets = b"".join(b"\x00\x00\x00\x01" + p
                                    for p in hevc.params)
    elif kind == b"mp4v":
        if b"esds" not in config:
            raise refusal(path, "the mp4v entry has no esds box")
        oti, info = esds_config(data, *config[b"esds"])
        if oti not in OBJECT_TYPES:
            raise refusal(path, f"mp4v with objectTypeIndication 0x{oti:02x}"
                                f" (not MPEG-4 Part 2 or JPEG)")
        track.codec = OBJECT_TYPES[oti]
        if track.codec == "mpeg4":
            track.decoder_info = info
    elif kind in MJPEG_ENTRIES:
        track.codec = "mjpeg"
    elif kind in PRORES_ENTRIES:
        # the decoder's depth is its tag's: 12 bits for 4444, 10 for 422
        track.codec, track.tag = "prores", kind
        track.params = CodecParams(size=(w, h))
    elif kind in (b"vp09", b"vp08"):
        if b"vpcC" not in config:
            raise refusal(path, f"the {kind.decode()} entry has no vpcC box")
        _, at = _full(data, config[b"vpcC"][0])
        profile, depth = data[at], data[at + 2] >> 4
        if kind == b"vp09" and (profile, depth) not in VP9_DEPTHS:
            raise refusal(path, f"VP9 profile {profile} video of {depth} "
                                f"bits (vpcC: profiles 0 and 1 are of 8 "
                                f"bits, 2 and 3 of 10 or 12; item 4i)")
        track.codec = "vp9" if kind == b"vp09" else "vp8"
    else:
        name = OTHER_CODECS.get(kind, "codec")
        raise refusal(path, f"{name} video ({kind.decode('latin-1')!r} "
                            f"sample entry)")
    if b"colr" in config:
        track.colour = colr_colour(data, *config[b"colr"])

    dts: List[int] = []
    durations: List[int] = []
    t = 0
    for count, delta in _table(data, stbl[b"stts"][0], ">II"):
        for _ in range(count):
            dts.append(t)
            durations.append(delta)
            t += delta
    n = len(dts)

    if b"stsz" in stbl:
        s0 = _full(data, stbl[b"stsz"][0])[1]
        uniform, count = struct.unpack_from(">II", data, s0)
        sizes = ([uniform] * count if uniform else
                 list(struct.unpack_from(f">{count}I", data, s0 + 8)))
    elif b"stz2" in stbl:
        s0 = _full(data, stbl[b"stz2"][0])[1]
        field, count = data[s0 + 3], struct.unpack_from(">I", data,
                                                         s0 + 4)[0]
        raw = data[s0 + 8:]
        if field == 4:
            sizes = [(raw[i // 2] >> (4 if i % 2 == 0 else 0)) & 15
                     for i in range(count)]
        else:
            fmt = {8: "B", 16: "H"}[field]
            sizes = list(struct.unpack_from(f">{count}{fmt}", raw, 0))
    else:
        raise refusal(path, "the video track has no stsz or stz2 box")
    if b"stco" in stbl:
        chunks = [c[0] for c in _table(data, stbl[b"stco"][0], ">I")]
    elif b"co64" in stbl:
        chunks = [c[0] for c in _table(data, stbl[b"co64"][0], ">Q")]
    else:
        raise refusal(path, "the video track has no stco or co64 box")
    offsets = []
    runs = _table(data, stbl[b"stsc"][0], ">III")
    for i, (first, per, _) in enumerate(runs):
        last = runs[i + 1][0] - 1 if i + 1 < len(runs) else len(chunks)
        for chunk in range(first - 1, last):
            at = chunks[chunk]
            for _ in range(per):
                if len(offsets) < len(sizes):
                    offsets.append(at)
                    at += sizes[len(offsets) - 1]
    if not (len(sizes) == len(offsets) == n):
        raise refusal(path, f"the sample table disagrees with itself "
                            f"({n} times, {len(sizes)} sizes, "
                            f"{len(offsets)} placed in chunks)")
    cts = list(dts)
    if b"ctts" in stbl:
        version = data[stbl[b"ctts"][0]]
        i = 0
        for count, off in _table(data, stbl[b"ctts"][0],
                                 ">Ii" if version else ">II"):
            for _ in range(count):
                if i < n:
                    cts[i] += off
                i += 1
    keys = [True] * n
    if b"stss" in stbl:
        keys = [False] * n
        for (k,) in _table(data, stbl[b"stss"][0], ">I"):
            if 1 <= k <= n:
                keys[k - 1] = True
    track.has_ctts = b"ctts" in stbl
    track.samples = [Sample(*v) for v in zip(offsets, sizes, dts, cts, keys,
                                              durations)]
    track.table_samples = n


def _edits(path: str, moov: bytes, s: int, timescale: int,
           movie_timescale: int) -> List[Edit]:
    """An ``elst``'s entries in media units (FFmpeg's
    ``get_edit_list_entry``: the segment duration rescaled from the
    movie's timescale, rounded; 0 or no movie timescale: to the end);
    a media rate other than 1 is refused."""
    v = moov[s]
    out = []
    for duration, media_time, rate, fraction in _table(
            moov, s, ">Qqhh" if v else ">Iihh"):
        if (rate, fraction) != (1, 0):
            raise refusal(path, f"an edit of media rate "
                                f"{rate + fraction / 65536:g} (elst box: "
                                f"only rate 1 is read)")
        length = ((duration * timescale + movie_timescale // 2)
                  // movie_timescale if duration and movie_timescale
                  else math.inf)
        out.append(Edit(length, media_time))
    return out


# tfhd / trun flags (ISO 14496-12 8.8.7, 8.8.8) and sample flags
TFHD_BASE_OFFSET, TFHD_DESCRIPTION, TFHD_DURATION = 0x01, 0x02, 0x08
TFHD_SIZE, TFHD_FLAGS, TFHD_BASE_IS_MOOF = 0x10, 0x20, 0x020000
TRUN_DATA_OFFSET, TRUN_FIRST_FLAGS = 0x01, 0x04
TRUN_DURATION, TRUN_SIZE, TRUN_FLAGS, TRUN_CTS = 0x100, 0x200, 0x400, 0x800
SAMPLE_NON_SYNC, SAMPLE_DEPENDS_YES = 0x10000, 0x1000000


def _fragments(path: str, moofs: List[Tuple[int, bytes]], track_id: int,
               defaults: Tuple[int, int, int], track: Track) -> None:
    """Append the samples of each ``moof/traf`` of `track_id` to the
    track, as FFmpeg's ``mov_read_tfhd`` / ``mov_read_tfdt`` /
    ``mov_read_trun`` read them: the data base is ``tfhd``'s base data
    offset, else the ``moof``'s start (default-base-is-moof, or the first
    ``traf`` of a ``moof``), else where the previous ``traf``'s data
    ended; the first sample's decode time is ``tfdt``'s, else the end of
    the samples before; durations, sizes and flags come from the
    ``trun``, else ``tfhd``, else ``trex`` (`defaults`); a sample is a
    key unless its flags say non-sync or depends-on-others; ``trun``
    version 1 composition offsets are signed."""
    end_time = max((s.dts + s.duration for s in track.samples), default=0)
    for at, moof in moofs:
        implicit = at
        for kind, s, e in boxes(moof, 8):
            if kind != b"traf":
                continue
            traf = list(boxes(moof, s, e))
            found = {k: (bs, be) for k, bs, be in traf if k == b"tfhd"}
            if b"tfhd" not in found:
                continue
            flags = int.from_bytes(moof[found[b"tfhd"][0] + 1:
                                        found[b"tfhd"][0] + 4], "big")
            q = found[b"tfhd"][0] + 4
            if struct.unpack_from(">I", moof, q)[0] != track_id:
                continue
            q += 4
            base = implicit
            if flags & TFHD_BASE_OFFSET:
                base = struct.unpack_from(">Q", moof, q)[0]
                q += 8
            elif flags & TFHD_BASE_IS_MOOF:
                base = at
            q += 4 if flags & TFHD_DESCRIPTION else 0
            duration, size, sample_flags = defaults
            for bit, field in ((TFHD_DURATION, 0), (TFHD_SIZE, 1),
                               (TFHD_FLAGS, 2)):
                if flags & bit:
                    value = struct.unpack_from(">I", moof, q)[0]
                    q += 4
                    if field == 0:
                        duration = value
                    elif field == 1:
                        size = value
                    else:
                        sample_flags = value
            dts = end_time
            for k, bs, be in traf:
                if k == b"tfdt":
                    dts = (struct.unpack_from(">Q", moof, bs + 4)[0]
                           if moof[bs] else
                           struct.unpack_from(">I", moof, bs + 4)[0])
                elif k == b"trun":
                    dts, implicit = _trun(moof, bs, base, dts,
                                          (duration, size, sample_flags),
                                          track)
                    end_time = max(end_time, dts)
                    if implicit < 0:
                        raise refusal(path, "a trun box whose data lies "
                                            "before the file")


def _trun(moof: bytes, s: int, base: int, dts: int,
          defaults: Tuple[int, int, int], track: Track) -> Tuple[int, int]:
    """Append a ``trun``'s samples; (the decode time after them, the
    file offset where their data ends)."""
    version = moof[s]
    flags = int.from_bytes(moof[s + 1:s + 4], "big")
    count = struct.unpack_from(">I", moof, s + 4)[0]
    q = s + 8
    offset = base
    if flags & TRUN_DATA_OFFSET:
        offset += struct.unpack_from(">i", moof, q)[0]
        q += 4
    duration, size, sample_flags = defaults
    first_flags = sample_flags
    if flags & TRUN_FIRST_FLAGS:
        first_flags = struct.unpack_from(">I", moof, q)[0]
        q += 4
    for i in range(count):
        d, n, fl, cts = duration, size, first_flags if i == 0 \
            else sample_flags, 0
        if flags & TRUN_DURATION:
            d = struct.unpack_from(">I", moof, q)[0]
            q += 4
        if flags & TRUN_SIZE:
            n = struct.unpack_from(">I", moof, q)[0]
            q += 4
        if flags & TRUN_FLAGS:
            fl = struct.unpack_from(">I", moof, q)[0]
            q += 4
        if flags & TRUN_CTS:
            cts = struct.unpack_from(">i" if version else ">I", moof, q)[0]
            q += 4
        key = not fl & (SAMPLE_NON_SYNC | SAMPLE_DEPENDS_YES)
        track.samples.append(Sample(offset, n, dts, dts + cts, key, d))
        offset += n
        dts += d
    return dts, offset


def read_track(path: str, f: BinaryIO) -> Track:
    """Parse the file's boxes and its first video track."""
    f.seek(0, 2)
    file_end = f.tell()
    f.seek(0)
    moov = None
    moofs: List[Tuple[int, bytes]] = []      # (file offset, the box)
    at = 0
    while at + 8 <= file_end:
        f.seek(at)
        head = f.read(16)
        size, kind = struct.unpack_from(">I4s", head)
        if size == 1:
            size = struct.unpack_from(">Q", head, 8)[0]
        elif size == 0:
            size = file_end - at
        if kind == b"moof":
            f.seek(at)
            moofs.append((at, f.read(size)))
        if kind == b"moov":
            f.seek(at)
            moov = f.read(size)
        if size < 8:
            raise refusal(path, f"a broken box {kind!r} at {at}")
        at += size
    if moov is None:
        raise refusal(path, "an MP4 with no moov box")
    top = _children(moov, 8, len(moov))
    mvhd = [[1 << 16, 0, 0], [0, 1 << 16, 0], [0, 0, 1 << 30]]
    movie_timescale = 0
    if b"mvhd" in top:
        v, s = _full(moov, top[b"mvhd"][0])
        movie_timescale = struct.unpack_from(">I", moov,
                                             s + (16 if v else 8))[0]
        mvhd = _matrix(moov, s + (28 if v else 16) + 16)
    for kind, s, e in boxes(moov, 8):
        if kind != b"trak":
            continue
        trak = _children(moov, s, e)
        mdia = _children(moov, *trak[b"mdia"]) if b"mdia" in trak else {}
        if b"hdlr" not in mdia or moov[mdia[b"hdlr"][0] + 8:
                                       mdia[b"hdlr"][0] + 12] != b"vide":
            continue
        track = Track()
        v, ms = _full(moov, mdia[b"mdhd"][0])
        track.timescale = struct.unpack_from(">I", moov,
                                             ms + (16 if v else 8))[0]
        v, ts = _full(moov, trak[b"tkhd"][0])
        tkhd = _matrix(moov, ts + (32 if v else 20) + 16)
        track.rotation_meta = display_rotation(tkhd, mvhd)
        track_id = struct.unpack_from(">I", moov, ts + (16 if v else 8))[0]
        track.edits = []
        if b"edts" in trak:
            edts = _children(moov, *trak[b"edts"])
            if b"elst" in edts:
                track.edits = _edits(path, moov, edts[b"elst"][0],
                                     track.timescale, movie_timescale)
        minf = _children(moov, *mdia[b"minf"])
        if b"stbl" not in minf:
            raise refusal(path, "the video track has no stbl box")
        _sample_table(path, moov, *minf[b"stbl"], track)
        if moofs:
            defaults = (0, 0, 0)
            if b"mvex" in top:
                for kind_, ms, me in boxes(moov, *top[b"mvex"]):
                    if kind_ == b"trex" and struct.unpack_from(
                            ">I", moov, ms + 4)[0] == track_id:
                        defaults = struct.unpack_from(">III", moov, ms + 12)
            _fragments(path, moofs, track_id, defaults, track)
        n = len(track.samples)
        total = sum(smp.duration for smp in track.samples)
        track.fps = track.timescale * n / total if total and n else 0.0
        return track
    raise refusal(path, "an MP4 with no video track")


def is_isobmff(head: bytes) -> bool:
    """Whether a file's first bytes are an ISO-BMFF box of a known type."""
    return len(head) >= 8 and head[4:8] in CONTAINERS
