"""MP4 / MOV (ISO-BMFF, ISO 14496-12) demuxing in pure Python: the first
video track's samples and what ``cv2.VideoCapture`` reports of it.

Read boxes: ``ftyp``, ``moov/mvhd``, ``moov/trak/{tkhd, edts/elst,
mdia/{mdhd, hdlr, minf/stbl}}``; of the sample table ``stsd`` (``avc1`` /
``avc3`` with ``avcC``; ``mp4v`` with ``esds`` and its
DecoderSpecificInfo; ``vp09`` with ``vpcC``), ``stts``, ``ctts``,
``stsc``, ``stsz`` / ``stz2``, ``stco`` / ``co64`` and ``stss``.

- :attr:`Track.samples` are in decode order, ``(offset, size, dts, cts,
  key)``; ``key`` marks the sync samples of ``stss`` (every sample
  without one): the points a decoder can start from.
- :meth:`Track.packets` gives each sample as the decoder takes it: H.264
  as Annex-B, its length prefixes replaced by start codes and the
  ``avcC`` SPS and PPS put ahead of each IDR picture that carries none
  (FFmpeg's ``h264_mp4toannexb``, which cv2's raw packets go through,
  start codes and all); MPEG-4 Part 2 as stored, the DecoderSpecificInfo
  (VOS / VOL headers) ahead of the first sample; VP9 frames as stored.
  Its key flag is :func:`intra_picture`'s, the flag FFmpeg's parsers set
  and cv2 reports (``CAP_PROP_LRF_HAS_KEY_FRAME``): every intra-coded
  picture, non-IDR I pictures of H.264 too.
- ``rotation`` is the clockwise turn cv2 reports as
  ``CAP_PROP_ORIENTATION_META`` and applies under
  ``CAP_PROP_ORIENTATION_AUTO`` (0/90/180/270), from the ``tkhd`` matrix
  times the ``mvhd`` one as FFmpeg composes them; ``fps`` (the samples
  over the ``stts`` duration, FFmpeg's ``avg_frame_rate``), ``size``
  (``(w, h)`` of the sample entry, swapped by a quarter turn) and
  ``frame_count`` (the samples) are cv2's.
- A single-entry edit list shows the media from its media time for its
  duration: samples that would be shown before or after it are decoded
  and dropped (:attr:`Track.shown`), as FFmpeg drops them.

Refused, with an error naming the box or codec and ROADMAP.md queue 1
item 4: fragmented files (``moof`` / ``mvex``), edit lists of more than
one entry, VP9 of a profile other than 0 (``vpcC``), and every codec but
H.264, MPEG-4 Part 2 and VP9 (HEVC, AV1, ...).
"""

from __future__ import annotations

import math
import struct
from typing import BinaryIO, Dict, Iterator, List, NamedTuple, Optional, \
    Tuple

CONTAINERS = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide",
              b"uuid", b"pdin", b"meta", b"moof", b"mfra", b"styp")
OTHER_CODECS = {b"hvc1": "HEVC", b"hev1": "HEVC", b"vp08": "VP8",
                b"av01": "AV1", b"mp4a": "AAC audio",
                b"jpeg": "Motion-JPEG", b"mjp2": "Motion JPEG 2000",
                b"apch": "ProRes", b"apcn": "ProRes", b"dvh1": "Dolby Vision",
                b"s263": "H.263"}
MPEG4_VISUAL = 0x20    # esds objectTypeIndication of MPEG-4 Part 2


def refusal(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what}; the video reader takes H.264 and "
                      f"MPEG-4 Part 2 in MP4/MOV, AVI or Matroska, VP9 "
                      f"(profile 0) in WebM, Matroska or MP4, and "
                      f"Motion-JPEG AVI (other containers and codecs: "
                      f"ROADMAP.md queue 1 item 4)")


class Sample(NamedTuple):
    offset: int
    size: int
    dts: int
    cts: int
    key: bool


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


class Track:
    """The first video track of an MP4/MOV file."""

    codec: str                     # "h264", "mpeg4" or "vp9"
    samples: List[Sample]
    timescale: int
    coded_size: Tuple[int, int]    # (w, h) of the sample entry
    rotation_meta: int             # cv2's CAP_PROP_ORIENTATION_META
    fps: float
    edit: Tuple[int, float]        # shown media times [start, end)
    nal_length: int = 0            # H.264: NAL length prefix bytes
    sps: List[bytes]
    pps: List[bytes]
    decoder_info: bytes = b""      # MPEG-4: DecoderSpecificInfo

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
        return len(self.samples)

    @property
    def shown(self) -> Tuple[int, int]:
        """(pictures dropped before the edit, pictures shown), in display
        order."""
        start, end = self.edit
        return (sum(s.cts < start for s in self.samples),
                sum(start <= s.cts < end for s in self.samples))

    def packets(self, f: BinaryIO) -> Iterator[Tuple[bytes, bool]]:
        """(bytes for the decoder, key) of each sample in decode order."""
        for i, s in enumerate(self.samples):
            f.seek(s.offset)
            data = f.read(s.size)
            if len(data) != s.size:
                raise ValueError(f"sample {i} runs past the end of the file")
            if self.codec == "h264":
                data = annexb(data, self.nal_length, self.sps, self.pps)
            elif self.codec == "mpeg4" and i == 0:
                data = self.decoder_info + data
            yield data, intra_picture(self.codec, data)


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
    """Whether a packet (H.264 Annex-B, MPEG-4 Part 2 or VP9) holds an
    intra-coded picture: an IDR slice or an I / SI slice first; an I-VOP;
    a VP9 key frame (its uncompressed header's frame_type 0, not a
    shown existing frame)."""
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
    elif kind == b"mp4v":
        if b"esds" not in config:
            raise refusal(path, "the mp4v entry has no esds box")
        oti, track.decoder_info = esds_config(data, *config[b"esds"])
        if oti != MPEG4_VISUAL:
            raise refusal(path, f"mp4v with objectTypeIndication 0x{oti:02x}"
                                f" (not MPEG-4 Part 2)")
        track.codec = "mpeg4"
    elif kind == b"vp09":
        if b"vpcC" not in config:
            raise refusal(path, "the vp09 entry has no vpcC box")
        _, at = _full(data, config[b"vpcC"][0])
        profile, depth = data[at], data[at + 2] >> 4
        if profile or depth != 8:
            raise refusal(path, f"VP9 profile {profile} video of {depth} "
                                f"bits (vpcC: only profile 0, 8-bit 4:2:0, "
                                f"is read)")
        track.codec = "vp9"
    else:
        name = OTHER_CODECS.get(kind, "codec")
        raise refusal(path, f"{name} video ({kind.decode('latin-1')!r} "
                            f"sample entry)")

    dts: List[int] = []
    t = 0
    for count, delta in _table(data, stbl[b"stts"][0], ">II"):
        for _ in range(count):
            dts.append(t)
            t += delta
    n = len(dts)
    track.fps = track.timescale * n / t if t and n else 0.0

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
    track.samples = [Sample(*v) for v in zip(offsets, sizes, dts, cts, keys)]


def read_track(path: str, f: BinaryIO) -> Track:
    """Parse the file's boxes and its first video track."""
    f.seek(0, 2)
    file_end = f.tell()
    f.seek(0)
    moov = None
    at = 0
    while at + 8 <= file_end:
        f.seek(at)
        head = f.read(16)
        size, kind = struct.unpack_from(">I4s", head)
        if size == 1:
            size = struct.unpack_from(">Q", head, 8)[0]
        elif size == 0:
            size = file_end - at
        if kind in (b"moof", b"mfra", b"styp"):
            raise refusal(path, f"a fragmented MP4 ({kind.decode()} box)")
        if kind == b"moov":
            f.seek(at)
            moov = f.read(size)
        if size < 8:
            raise refusal(path, f"a broken box {kind!r} at {at}")
        at += size
    if moov is None:
        raise refusal(path, "an MP4 with no moov box")
    top = _children(moov, 8, len(moov))
    if b"mvex" in top:
        raise refusal(path, "a fragmented MP4 (mvex box)")
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
        track.edit = (0, math.inf)
        if b"edts" in trak:
            edts = _children(moov, *trak[b"edts"])
            if b"elst" in edts:
                v = moov[edts[b"elst"][0]]
                entries = _table(moov, edts[b"elst"][0],
                                 ">Qqhh" if v else ">Iihh")
                if len(entries) > 1:
                    raise refusal(path, f"an edit list of {len(entries)} "
                                        f"entries (elst box)")
                if entries and entries[0][1] >= 0:
                    duration, start = entries[0][:2]
                    track.edit = (start, start + duration * track.timescale
                                  / movie_timescale
                                  if duration and movie_timescale
                                  else math.inf)
        minf = _children(moov, *mdia[b"minf"])
        if b"stbl" not in minf:
            raise refusal(path, "the video track has no stbl box")
        _sample_table(path, moov, *minf[b"stbl"], track)
        return track
    raise refusal(path, "an MP4 with no video track")


def is_isobmff(head: bytes) -> bool:
    """Whether a file's first bytes are an ISO-BMFF box of a known type."""
    return len(head) >= 8 and head[4:8] in CONTAINERS
