"""Matroska / WebM (EBML) demuxing in pure Python: the first video track's
blocks and what ``cv2.VideoCapture`` reports of it, as ``demo/mp4.py``
gives them for MP4.

Read elements: the EBML header (DocType ``matroska`` or ``webm``);
``Segment``; ``Info`` (``TimecodeScale``, ``Duration``); ``Tracks`` /
``TrackEntry`` (``TrackNumber``, ``TrackType``, ``CodecID``,
``CodecPrivate``, ``DefaultDuration``, ``Video`` with ``PixelWidth``,
``PixelHeight``, ``Projection`` and ``Colour``); ``Cluster`` (``Timecode``,
``SimpleBlock``, ``BlockGroup`` / ``Block`` / ``ReferenceBlock``).
Elements of unknown size (every size bit set: what ``MediaRecorder`` and
live muxers write for the ``Segment`` and each ``Cluster``) end where an
element that cannot be their child begins.  ``SeekHead``, ``Void``,
``CRC-32``, ``Cues``, ``Tags``, ``Chapters``, ``Attachments`` and
everything else are skipped by their size.

- :attr:`MkvTrack.blocks` are the track's blocks in file order with
  their key flags (a ``SimpleBlock``'s key bit; a ``Block`` with no
  ``ReferenceBlock``).
- :meth:`MkvTrack.packets` gives each block as the decoder takes it, with
  :func:`mp4.intra_picture`'s key flag: VP9 frames as stored (a
  superframe, libvpx's hidden alt-ref frame and the shown frame in one
  block, is split by FFmpeg's ``vp9`` decoder itself); MPEG-4 Part 2 with
  the ``CodecPrivate`` (VOS / VOL headers) ahead of the first block, as
  the AVI path does; H.264 with its ``avcC`` ``CodecPrivate``, each block
  turned into Annex-B by ``demo/mp4.py``'s :func:`mp4.annexb`; HEVC with
  its ``hvcC`` ``CodecPrivate`` by :func:`mp4.annexb_hevc`, keyed by the
  block's flag as cv2 keys it (libavformat parses no HEVC here).
- ``fps``, ``frame_count`` and ``rotation`` are cv2's: FFmpeg's
  ``avg_frame_rate`` from ``DefaultDuration`` (``av_reduce(1e9,
  DefaultDuration, 30000)``), else its ``r_frame_rate`` guess from the
  blocks' times (:func:`rfps`; an MPEG-4 Part 2 stream's VOL time base,
  which FFmpeg prefers there, is not read); the frame count
  ``floor(duration x fps + 0.5)`` with the duration of ``Info`` (cv2's
  ``get_total_frames``; a file without one, a live recording, gets
  cv2's large negative count);
  the turn from ``ProjectionPoseRoll`` as FFmpeg's display matrix gives
  it (``mkv_create_display_matrix``).
- ``colour`` is ``Video/Colour`` as libavformat hands it to the decoder
  (:func:`colour`), which keeps it where the bitstream states none.

Refused, naming the codec or feature and ROADMAP.md queue 1 item 4: every
codec but VP9, MPEG-4 Part 2, H.264 and HEVC (``V_AV1``, ``V_VP8``, ...),
VP9 of profiles 1 and 3 (4:2:2, 4:4:0, 4:4:4; item 4i), HEVC of another
format than 4:2:0 of 8 or 10 bits (RExt: item 4i), laced video blocks, and compressed or encrypted tracks (``ContentEncodings``).
"""

from __future__ import annotations

import math
import struct
from typing import BinaryIO, Dict, Iterator, List, NamedTuple, Optional, \
    Tuple

from ..native.avcodec import StreamColour
from . import mp4

EBML = 0x1A45DFA3
DOC_TYPE = 0x4282
SEGMENT = 0x18538067
INFO, TIMECODE_SCALE, DURATION = 0x1549A966, 0x2AD7B1, 0x4489
TRACKS, TRACK_ENTRY = 0x1654AE6B, 0xAE
TRACK_NUMBER, TRACK_TYPE, CODEC_ID, CODEC_PRIVATE = 0xD7, 0x83, 0x86, 0x63A2
DEFAULT_DURATION, CONTENT_ENCODINGS = 0x23E383, 0x6D80
VIDEO, PIXEL_WIDTH, PIXEL_HEIGHT = 0xE0, 0xB0, 0xBA
PROJECTION, PROJECTION_TYPE = 0x7670, 0x7671
POSE_YAW, POSE_PITCH, POSE_ROLL = 0x7673, 0x7674, 0x7675
COLOUR, MATRIX_COEFFICIENTS, RANGE = 0x55B0, 0x55B1, 0x55B9
CHROMA_SITING_HORZ, CHROMA_SITING_VERT = 0x55B7, 0x55B8
TRANSFER, PRIMARIES = 0x55BA, 0x55BB
CLUSTER, TIMECODE = 0x1F43B675, 0xE7
SIMPLE_BLOCK, BLOCK_GROUP, BLOCK, REFERENCE_BLOCK = 0xA3, 0xA0, 0xA1, 0xFB
VOID, CRC32 = 0xEC, 0xBF
# what may sit inside a Cluster: any other element ends one of unknown size
CLUSTER_CHILDREN = {TIMECODE, SIMPLE_BLOCK, BLOCK_GROUP, VOID, CRC32,
                    0x5854, 0xA7, 0xAB, 0xAF}        # SilentTracks, Position,
#                                                      PrevSize, EncryptedBlock
TRACK_VIDEO = 1
CODECS = {"V_VP9": "vp9", "V_MPEG4/ISO/ASP": "mpeg4",
          "V_MPEG4/ISO/SP": "mpeg4", "V_MPEG4/ISO/AP": "mpeg4",
          "V_MPEG4/ISO/AVC": "h264", "V_MPEGH/ISO/HEVC": "hevc"}
OTHER_CODECS = {"V_AV1": "AV1", "V_VP8": "VP8",
                "V_MPEGI/ISO/VVC": "VVC", "V_THEORA": "Theora",
                "V_MJPEG": "Motion-JPEG", "V_PRORES": "ProRes",
                "V_FFV1": "FFV1", "V_UNCOMPRESSED": "uncompressed"}
IDENTITY = [[1 << 16, 0, 0], [0, 1 << 16, 0], [0, 0, 1 << 30]]
INT_MAX = 2 ** 31 - 1
RFPS_PACKETS = 40       # what avformat_find_stream_info reads of a stream
RFPS_H264_SKIP = 7      # ... whose first H.264 packets carry no time
# FFmpeg's get_std_framerate(): rates x 12 x 1001
STD_FRAME_RATES = ([(i + 1) * 1001 for i in range(30 * 12)]
                   + [(i + 31) * 1001 * 12 for i in range(30)]
                   + [r * 1001 * 12 for r in (80, 120, 240)]
                   + [r * 1000 * 12 for r in (24, 30, 60, 12, 15, 48)])


class Block(NamedTuple):
    offset: int         # the frame data's place in the file
    size: int
    timecode: int       # TimecodeScale units
    key: bool


def _vint(data: bytes, at: int, marker: bool) -> Tuple[Optional[int], int]:
    """An EBML variable-size integer at `at`: (value, next position).  An
    ID keeps its length marker; a size of all ones is unknown (None)."""
    first = data[at]
    n = 1
    while n <= 8 and not first & (0x80 >> (n - 1)):
        n += 1
    if n > 8 or at + n > len(data):
        raise ValueError(f"a broken EBML number at {at}")
    value = first if marker else first & (0xFF >> n)
    for b in data[at + 1:at + n]:
        value = (value << 8) | b
    if not marker and value == (1 << (7 * n)) - 1:
        return None, at + n
    return value, at + n


def elements(data: bytes, start: int = 0, end: Optional[int] = None
             ) -> Iterator[Tuple[int, int, int]]:
    """(id, payload start, payload end) of the elements in data[start:end];
    an element of unknown size runs to `end`."""
    end = len(data) if end is None else end
    at = start
    while at < end:
        eid, at = _vint(data, at, True)
        size, at = _vint(data, at, False)
        stop = end if size is None else at + size
        if stop > end:
            raise ValueError(f"element 0x{eid:X} overruns its parent")
        yield eid, at, stop
        at = stop


def _uint(data: bytes, s: int, e: int) -> int:
    return int.from_bytes(data[s:e], "big")


def _float(data: bytes, s: int, e: int) -> float:
    if e - s == 4:
        return struct.unpack(">f", data[s:e])[0]
    if e - s == 8:
        return struct.unpack(">d", data[s:e])[0]
    return 0.0


def av_reduce(num: int, den: int, limit: int) -> Tuple[int, int]:
    """FFmpeg's ``av_reduce``: the closest fraction to num/den whose terms
    are at most `limit` (continued fractions, libavutil/rational.c)."""
    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    a0, a1 = (0, 1), (1, 0)
    if num <= limit and den <= limit:
        a1, den = (num, den), 0
    while den:
        x = num // den
        next_den = num - den * x
        a2 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
        if a2[0] > limit or a2[1] > limit:
            if a1[0]:
                x = (limit - a0[0]) // a1[0]
            if a1[1]:
                x = min(x, (limit - a0[1]) // a1[1])
            if den * (2 * x * a1[1] + a0[1]) > num * a1[1]:
                a1 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
            break
        a0, a1 = a1, a2
        num, den = den, next_den
    return a1


def rfps(times: List[int], time_base: float) -> float:
    """FFmpeg's ``r_frame_rate`` guess from a stream's packet times
    (libavformat's ``ff_rfps_add_frame`` / ``ff_rfps_calculate`` for a
    stream whose time base is unreliable): the standard rate whose frame
    grid the times fit best, within a variance of 0.01 frames squared,
    else the time base inverted."""
    rate = rfps_std(times, time_base)
    if rate:
        num, den = av_reduce(rate, 12 * 1001, INT_MAX)
        return num / den
    return 1 / time_base


def rfps_std(times: List[int], time_base: float) -> int:
    """:func:`rfps`' standard rate, times 12 x 1001 (0: none fits)."""
    n_std = len(STD_FRAME_RATES)
    err = [[[0.0] * n_std, [0.0] * n_std] for _ in range(2)]
    last = None
    count = total = 0
    for ts in times:
        if last is not None and ts > last:
            t = ts * time_base
            for i, std in enumerate(STD_FRAME_RATES):
                if err[0][1][i] < 1e10:
                    sdts = t * std / (1001 * 12)
                    for j in range(2):
                        e = sdts - round(sdts + j * 0.5) + j * 0.5
                        err[j][0][i] += e
                        err[j][1][i] += e * e
            count += 1
            total += ts - last
            if count % 10 == 0:
                for i in range(n_std):
                    if err[0][1][i] < 1e10 and all(
                            err[j][1][i] / count - (err[j][0][i] / count) ** 2
                            > 0.04 for j in range(2)):
                        err[0][1][i] = err[1][1][i] = 2e10
        last = ts
    best, rate = 0.01, 0
    if count > 1:
        for i, std in enumerate(STD_FRAME_RATES):
            if std < 1001 * 12 or (time_base * total / count
                                   < 1001 * 12.0 * 0.8 / std):
                continue
            for j in range(2):
                a = err[j][0][i] / count
                e = err[j][1][i] / count - a * a
                if e < best and best > 1e-9:
                    best, rate = e, std
    return rate if rate and rate / (12 * 1001) < 1.01 / time_base else 0


def projection_rotation(yaw: float, pitch: float, roll: float) -> int:
    """cv2's CAP_PROP_ORIENTATION_META of a Matroska ``Projection``: the
    display matrix FFmpeg's ``mkv_create_display_matrix`` makes of it
    (none for a pose with pitch, a yaw other than 0 / 180, or no turn),
    read as :func:`mp4.display_rotation` reads an MP4's."""
    if (pitch != 0.0 or yaw not in (0.0, 180.0, -180.0) or math.isnan(roll)
            or (yaw == 0.0 and roll == 0.0)):
        return 0
    hflip = yaw != 0.0
    radians = -(roll * (2 * hflip - 1)) * math.pi / 180.0
    c, s = math.cos(radians), math.sin(radians)

    def fixed(v):                   # CONV_DP: truncated 16.16
        return int(v * (1 << 16))

    m = [[fixed(c), fixed(-s), 0], [fixed(s), fixed(c), 0], [0, 0, 1 << 30]]
    if hflip:
        for row in m:
            row[0] = -row[0]
    return mp4.display_rotation(m, IDENTITY)


def colour(data: bytes, s: int, e: int) -> StreamColour:
    """A ``Video/Colour`` element as libavformat's matroska demuxer hands
    it to the decoder: ``MatrixCoefficients`` (by default 2,
    unspecified), ``Range`` where 1 (broadcast) or 2 (full), primaries
    and transfer where libavformat knows them, and a chroma location
    where both ``ChromaSitingHorz`` and ``ChromaSitingVert`` are stated
    (1 co-sited, 2 half)."""
    fields = {MATRIX_COEFFICIENTS: 2, RANGE: 0, PRIMARIES: 2, TRANSFER: 2,
              CHROMA_SITING_HORZ: 0, CHROMA_SITING_VERT: 0}
    for cid, cs, ce in elements(data, s, e):
        if cid in fields:
            fields[cid] = _uint(data, cs, ce)
    horz, vert = fields[CHROMA_SITING_HORZ], fields[CHROMA_SITING_VERT]
    location = None
    if horz in (1, 2) and vert in (1, 2):
        # av_chroma_location_pos_to_enum((horz - 1) << 7, (vert - 1) << 7)
        location = {(1, 2): 1, (2, 2): 2, (1, 1): 3, (2, 1): 4}[horz, vert]
    matrix, primaries, transfer = (fields[MATRIX_COEFFICIENTS],
                                   fields[PRIMARIES], fields[TRANSFER])
    return StreamColour(
        matrix if matrix in mp4.VALID_MATRICES and matrix != 3 else None,
        {1: False, 2: True}.get(fields[RANGE]), location,
        primaries if primaries in mp4.VALID_PRIMARIES else None,
        transfer if transfer in mp4.VALID_TRANSFERS else None)


def vp9_profile(frame: bytes) -> int:
    """The profile in a VP9 frame's uncompressed header (its first byte:
    frame marker, profile low bit, profile high bit)."""
    b = frame[0]
    if b >> 6 != 2:
        raise ValueError("not a VP9 frame (no frame marker)")
    return ((b >> 5) & 1) | (((b >> 4) & 1) << 1)


class MkvTrack:
    """The first video track of a Matroska / WebM file."""

    codec: str                       # "vp9", "mpeg4", "h264" or "hevc"
    codec_id: str
    coded_size: Tuple[int, int]      # (w, h): PixelWidth, PixelHeight
    rotation_meta: int = 0
    timecode_scale: int = 1000000    # ns per Timecode unit
    duration: Optional[float] = None  # Info's, in Timecode units
    default_duration: int = 0        # ns
    extradata: bytes = b""           # MPEG-4: the VOS / VOL headers
    nal_length: int = 0              # H.264: avcC; HEVC: hvcC
    sps: List[bytes]
    pps: List[bytes]
    param_sets: bytes = b""          # HEVC: the hvcC sets as Annex-B
    blocks: List[Block]
    colour: Optional[StreamColour] = None   # Video/Colour

    @property
    def rotation(self) -> int:
        return self.rotation_meta if self.rotation_meta in (
            90, 180, 270) else 0

    @property
    def size(self) -> Tuple[int, int]:
        w, h = self.coded_size
        return (h, w) if self.rotation in (90, 270) else (w, h)

    @property
    def fps(self) -> float:
        if self.default_duration:
            num, den = av_reduce(10 ** 9, self.default_duration, 30000)
            return num / den
        # FFmpeg's r_frame_rate from the packets' times; its H.264 packets
        # carry no time until 7 pictures have been decoded
        skip = RFPS_H264_SKIP if self.codec == "h264" else 0
        num, den = self.time_base
        times = [b.timecode for b in self.blocks[skip:RFPS_PACKETS]]
        return rfps(times, num / den)

    @property
    def time_base(self) -> Tuple[int, int]:
        """The stream's time base: TimecodeScale ns, reduced."""
        return av_reduce(self.timecode_scale, 10 ** 9, INT_MAX)

    @property
    def frame_count(self) -> int:
        """cv2's ``floor(duration x fps + 0.5)``.  Without ``Duration`` (a
        live recording) the container's and the stream's durations are
        unset (INT64_MIN) and cv2 reports that times the time base and fps:
        a large negative number, which this count repeats."""
        if self.duration is None:
            num, den = self.time_base
            seconds = float(-2 ** 63) * (num / den)
        else:
            # FFmpeg: Duration x TimecodeScale ns in microseconds, truncated
            seconds = int(self.duration * self.timecode_scale * 1000
                          / 1000000) / 1e6
        return int(math.floor(seconds * self.fps + 0.5))

    @property
    def shown(self) -> Tuple[int, int]:
        return 0, len(self.blocks)

    def packets(self, f: BinaryIO) -> Iterator[Tuple[bytes, bool]]:
        """(bytes for the decoder, key) of each block in file order."""
        for i, b in enumerate(self.blocks):
            f.seek(b.offset)
            data = f.read(b.size)
            if len(data) != b.size:
                raise ValueError(f"block {i} runs past the end of the file")
            if self.codec == "h264":
                data = mp4.annexb(data, self.nal_length, self.sps, self.pps)
            elif self.codec == "hevc":
                data = mp4.annexb_hevc(data, self.nal_length, self.param_sets)
            elif self.codec == "mpeg4" and i == 0:
                data = self.extradata + data
            # libavformat parses no HEVC here: cv2's key is the block's
            yield data, (b.key if self.codec == "hevc"
                         else mp4.intra_picture(self.codec, data))


def _header(f: BinaryIO, at: int) -> Tuple[int, Optional[int], int]:
    """(id, size or None, payload start) of the element at `at`."""
    f.seek(at)
    head = f.read(12)
    if not head:
        raise EOFError
    eid, n = _vint(head, 0, True)
    size, n = _vint(head, n, False)
    return eid, size, at + n


class _Reader:
    def __init__(self, path: str, f: BinaryIO):
        self.path, self.f = path, f
        f.seek(0, 2)
        self.file_end = f.tell()
        self.track: Optional[MkvTrack] = None
        self.number = 0
        self.info: Dict[int, object] = {}
        self.blocks: List[Block] = []

    def refuse(self, what: str) -> ValueError:
        return mp4.refusal(self.path, what)

    def read(self) -> MkvTrack:
        eid, size, at = _header(self.f, 0)
        if eid != EBML or size is None:
            raise self.refuse("a file with no EBML header")
        self.f.seek(at)
        head = self.f.read(size)
        doc = b"matroska"
        for hid, s, e in elements(head):
            if hid == DOC_TYPE:
                doc = head[s:e].rstrip(b"\0")
        if doc not in (b"matroska", b"webm"):
            raise self.refuse(f"an EBML file of DocType {doc!r}, not "
                              f"Matroska/WebM")
        at += size
        while at < self.file_end:
            eid, size, start = _header(self.f, at)
            if eid == SEGMENT:
                self._segment(start, self.file_end if size is None
                              else min(start + size, self.file_end))
                break
            if size is None:
                raise self.refuse(f"a top-level element 0x{eid:X} of "
                                  f"unknown size")
            at = start + size
        if self.track is None:
            raise self.refuse("a Matroska/WebM file with no video track")
        track = self.track
        track.blocks = self.blocks
        track.timecode_scale = int(self.info.get(TIMECODE_SCALE, 1000000))
        duration = self.info.get(DURATION)
        track.duration = float(duration) if duration is not None else None
        if track.codec == "vp9" and self.blocks:
            self.f.seek(self.blocks[0].offset)
            profile = vp9_profile(self.f.read(1))
            if profile not in (0, 2):
                raise self.refuse(f"VP9 profile {profile} video (4:2:2, "
                                  f"4:4:0 or 4:4:4: only 4:2:0, profiles 0 "
                                  f"and 2, is read; item 4i)")
        return track

    def _segment(self, at: int, end: int) -> None:
        while at < end:
            try:
                eid, size, start = _header(self.f, at)
            except EOFError:
                return
            if eid == CLUSTER:
                at = self._cluster(start, end if size is None
                                   else min(start + size, end))
                continue
            if size is None:
                raise self.refuse(f"a Segment child 0x{eid:X} of unknown "
                                  f"size")
            stop = start + size
            if eid in (INFO, TRACKS):
                self.f.seek(start)
                data = self.f.read(size)
                if eid == INFO:
                    self._info(data)
                else:
                    self._tracks(data)
            at = stop

    def _info(self, data: bytes) -> None:
        for eid, s, e in elements(data):
            if eid == TIMECODE_SCALE:
                self.info[eid] = _uint(data, s, e)
            elif eid == DURATION:
                self.info[eid] = _float(data, s, e)

    def _tracks(self, data: bytes) -> None:
        for eid, s, e in elements(data):
            if eid != TRACK_ENTRY or self.track is not None:
                continue
            fields: Dict[int, Tuple[int, int]] = {}
            for cid, cs, ce in elements(data, s, e):
                fields.setdefault(cid, (cs, ce))
            if TRACK_TYPE not in fields or _uint(
                    data, *fields[TRACK_TYPE]) != TRACK_VIDEO:
                continue
            self.track = self._video_track(data, fields)
            self.number = _uint(data, *fields[TRACK_NUMBER])

    def _video_track(self, data: bytes, fields) -> MkvTrack:
        track = MkvTrack()
        codec_id = data[slice(*fields[CODEC_ID])].rstrip(b"\0").decode(
            "latin-1") if CODEC_ID in fields else ""
        private = bytes(data[slice(*fields[CODEC_PRIVATE])]) \
            if CODEC_PRIVATE in fields else b""
        if CONTENT_ENCODINGS in fields:
            raise self.refuse(f"a compressed or encrypted {codec_id} track "
                              f"(ContentEncodings)")
        track.codec_id = codec_id
        if codec_id == "V_MS/VFW/FOURCC":
            from .video_io import AVI_CODECS
            fourcc = private[16:20].upper()
            if AVI_CODECS.get(fourcc) != "mpeg4":
                raise self.refuse(f"V_MS/VFW/FOURCC video {fourcc!r}")
            track.codec = "mpeg4"
            size = struct.unpack_from("<I", private)[0]
            track.extradata = private[40:size] if size > 40 else b""
        elif codec_id in CODECS:
            track.codec = CODECS[codec_id]
            if track.codec == "mpeg4":
                track.extradata = private
            elif track.codec == "h264":
                if not private:
                    raise self.refuse("V_MPEG4/ISO/AVC video with no avcC "
                                      "CodecPrivate")
                track.nal_length, track.sps, track.pps = mp4.avcc_config(
                    private, 0, len(private))
            elif track.codec == "hevc":
                if len(private) < 23:
                    raise self.refuse("V_MPEGH/ISO/HEVC video with no hvcC "
                                      "CodecPrivate")
                hevc = mp4.hvcc_config(private, 0, len(private))
                refused = mp4.hevc_refusal(hevc.chroma, hevc.depth)
                if refused:
                    raise self.refuse(f"{refused} (V_MPEGH/ISO/HEVC "
                                      f"CodecPrivate)")
                track.nal_length = hevc.nal_length
                track.param_sets = b"".join(b"\x00\x00\x00\x01" + p
                                            for p in hevc.params)
        else:
            name = OTHER_CODECS.get(codec_id, "codec")
            raise self.refuse(f"{name} video ({codec_id!r} CodecID)")
        if DEFAULT_DURATION in fields:
            track.default_duration = _uint(data, *fields[DEFAULT_DURATION])
        w = h = 0
        yaw = pitch = roll = 0.0
        if VIDEO in fields:
            for vid, vs, ve in elements(data, *fields[VIDEO]):
                if vid == PIXEL_WIDTH:
                    w = _uint(data, vs, ve)
                elif vid == PIXEL_HEIGHT:
                    h = _uint(data, vs, ve)
                elif vid == PROJECTION:
                    kind = 0
                    for pid, ps, pe in elements(data, vs, ve):
                        if pid == PROJECTION_TYPE:
                            kind = _uint(data, ps, pe)
                        elif pid == POSE_YAW:
                            yaw = _float(data, ps, pe)
                        elif pid == POSE_PITCH:
                            pitch = _float(data, ps, pe)
                        elif pid == POSE_ROLL:
                            roll = _float(data, ps, pe)
                    if kind != 0:               # not rectangular
                        yaw = pitch = roll = 0.0
                elif vid == COLOUR:
                    track.colour = colour(data, vs, ve)
        track.coded_size = (w, h)
        track.rotation_meta = projection_rotation(yaw, pitch, roll)
        return track

    def _cluster(self, at: int, end: int) -> int:
        """Read a Cluster's blocks from `at`; where the next element
        starts (`end` or, for a Cluster of unknown size, the first element
        that is not its child)."""
        base = 0
        while at < end:
            try:
                eid, size, start = _header(self.f, at)
            except EOFError:
                return self.file_end
            if eid not in CLUSTER_CHILDREN:
                return at
            if size is None:
                raise self.refuse(f"a Cluster child 0x{eid:X} of unknown "
                                  f"size")
            stop = min(start + size, end)
            if eid == TIMECODE:
                self.f.seek(start)
                base = _uint(self.f.read(size), 0, size)
            elif eid == SIMPLE_BLOCK:
                self._block(start, stop, base, None)
            elif eid == BLOCK_GROUP:
                block, referenced = None, False
                inner = start
                while inner < stop:
                    cid, csize, cstart = _header(self.f, inner)
                    if csize is None:
                        raise self.refuse("a BlockGroup child of unknown "
                                          "size")
                    if cid == BLOCK:
                        block = (cstart, cstart + csize)
                    elif cid == REFERENCE_BLOCK:
                        referenced = True
                    inner = cstart + csize
                if block is not None:
                    self._block(*block, base, not referenced)
            at = stop
        return end

    def _block(self, start: int, stop: int, base: int,
               key: Optional[bool]) -> None:
        """One (Simple)Block: a key flag of None takes the SimpleBlock's."""
        self.f.seek(start)
        head = self.f.read(12)
        number, n = _vint(head, 0, False)
        if number != self.number or self.track is None:
            return
        timecode = struct.unpack_from(">h", head, n)[0]
        flags = head[n + 2]
        if flags & 0x06:
            raise self.refuse("a laced video block (several frames in one "
                              "block)")
        if key is None:
            key = bool(flags & 0x80)
        offset = start + n + 3
        self.blocks.append(Block(offset, stop - offset, base + timecode, key))


def read_track(path: str, f: BinaryIO) -> MkvTrack:
    """Parse a Matroska / WebM file's first video track and its blocks."""
    return _Reader(path, f).read()


def is_matroska(head: bytes) -> bool:
    return head[:4] == b"\x1a\x45\xdf\xa3"
