"""MPEG transport streams (ISO/IEC 13818-1: ``.ts``; ``.m2ts`` / ``.mts``
of AVCHD camcorders and Blu-ray, whose packets carry a 4-byte
``TP_extra_header`` first) demuxed in pure Python: the first video
stream's frames and what ``cv2.VideoCapture`` reports of it, as
``demo/mp4.py`` and ``demo/mkv.py`` give them for MP4 and Matroska.

- Packets: 188 or 192 bytes, the size FFmpeg's ``get_packet_size``
  would find (the stride at which the sync byte 0x47 repeats most); a
  lost sync is found again at the next byte that starts two packets.
  Adaptation fields are skipped by their length (stuffing, PCR); their
  discontinuity indicator excuses a jump of the continuity counter.
- Tables: the PAT's first program, its PMT (each section's CRC checked),
  and of the PMT's streams the first video stream of a type that is
  read: 0x01 and 0x02 (MPEG-1 / MPEG-2 video; which of the two is
  decided by the stream itself, a sequence extension making it MPEG-2,
  as libavcodec's ``mpegvideo`` parser decides), 0x10 (MPEG-4 Part 2),
  0x1B (H.264) and 0x24 (HEVC).
- PES: reassembled as FFmpeg's ``mpegts_push_data`` does: a packet
  with ``payload_unit_start_indicator`` ends the PES before it; a PES
  of stated length ends when it is full, one of length 0 (video, as
  broadcast muxers write it) at the next start or the end of the file.
  PTS and DTS are the 33-bit fields, unwrapped as libavformat's
  ``update_wrap_reference`` / ``wrap_timestamp`` unwrap them.  A
  continuity counter that skips is logged and its PES kept as it came
  (FFmpeg marks it corrupt and passes it on); packets that follow a
  lost PES start with nothing to join are dropped, as FFmpeg drops
  them.
- Frames: the PES payloads go through libavcodec's parser
  (``native/avcodec.py`` :class:`~rtpose_tpu_torch.native.avcodec.Parser`:
  ``mpegvideo``, ``mpeg4video``, ``h264`` or ``hevc``), which libavformat
  runs over
  every TS video stream (``need_parsing``): a PES may hold two pictures,
  and a picture may span two PES.  Key flags are
  :func:`mp4.intra_picture`'s.
- ``fps`` is cv2's ``CAP_PROP_FPS``: the stream's ``avg_frame_rate``,
  else its ``r_frame_rate`` (libavformat's ``avformat_find_stream_info``).
  The frames it reads stop at 5,000,000 bytes (``probesize``).
  ``avg_frame_rate`` comes from the frame durations the parser's codec
  rate gives (``ff_compute_frame_duration``; a rate above 1000 fps is
  ignored there): MPEG-2's sequence header and extension; MPEG-1's
  sequence header, which libavformat 62 reports at twice its rate for
  frame rate codes 1-6 (:data:`MPEG1_FPS`, measured against cv2 5.0's
  libavformat 62.12 at every code); MPEG-4 Part 2's VOL time increment
  resolution (and fixed VOP increment).  ``r_frame_rate`` is guessed
  from the first 20 frame durations (:func:`r_frame_rate`:
  ``ff_rfps_add_frame`` / ``ff_rfps_calculate``); H.264's and HEVC's VUI
  timing is not read: the timestamps stand for it.
- ``frame_count`` is cv2's ``floor(duration x fps + 0.5)``: TS stores no
  count, and libavformat's ``estimate_timings_from_pts`` takes the
  duration from the last 250,000 bytes of the file (twice as many, up to
  six times, while no PES starts there): the greatest PTS of the PES
  that start there, plus one frame at ``r_frame_rate``, less the first
  PES's PTS.
- ``size`` is the first decoded picture's (``DecodedVideo`` reads it:
  the parser's and the decoder's size agree), ``rotation`` is 0.

Refused, naming the stream and ROADMAP.md queue 1 item 4: the other
video types (VVC, JPEG 2000, ...), a program whose only candidate is a
private stream (0x06, or 0x80-0xFF), a PMT with no video, a stream with
no PAT or PMT; HEVC RExt (4:2:2, 4:4:4, 4:0:0, 12-bit) by the
decoder's first picture (item 4i).  The container states no colour: the
frame's is the bitstream's (``native/avcodec.py``).
"""

from __future__ import annotations

import logging
import math
import time
from fractions import Fraction
from typing import BinaryIO, Dict, Iterator, List, NamedTuple, Optional, \
    Tuple

from . import mkv, mp4

log = logging.getLogger(__name__)

SYNC = 0x47
PACKET_SIZES = (188, 192)
PAT_PID, NULL_PID = 0, 0x1FFF
TABLE_PAT, TABLE_PMT = 0x00, 0x02
STREAM_TYPES = {0x01: "mpeg1video", 0x02: "mpeg2video", 0x10: "mpeg4",
                0x1B: "h264", 0x24: "hevc"}
OTHER_VIDEO = {0x20: "H.264 MVC", 0x21: "JPEG 2000",
               0x33: "VVC", 0x42: "AVS", 0xD1: "Dirac", 0xD2: "AVS2",
               0xD4: "AVS3", 0xEA: "VC-1"}
PRIVATE = {0x05: "private sections", 0x06: "private data"}
TIME_BASE = 90000
WRAP_BITS = 33
TAIL_BYTES = 250000        # libavformat's DURATION_MAX_READ_SIZE, and
TAIL_RETRIES = 6           # DURATION_MAX_RETRY doublings of it
RFPS_FRAMES = 21           # 20 durations: avformat_find_stream_info's
#                            fps_analyze_framecount for a 1/90000 stream
PROBE_BYTES = 5000000      # avformat_find_stream_info's probesize
CHUNK = 188 * 192 * 16
# ISO 13172-2 frame_rate_code -> rate; libavformat 62 reports an MPEG-1
# stream (stream type 0x01 or 0x02, no sequence extension) at MPEG1_FPS
MPEG12_RATES = {1: Fraction(24000, 1001), 2: Fraction(24), 3: Fraction(25),
                4: Fraction(30000, 1001), 5: Fraction(30), 6: Fraction(50),
                7: Fraction(60000, 1001), 8: Fraction(60)}
MPEG1_FPS = {code: rate * (2 if code <= 6 else 1)
             for code, rate in MPEG12_RATES.items()}


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 else c << 1
        table.append(c & 0xFFFFFFFF)
    return table


_CRC = _crc_table()


def crc32_mpeg2(data: bytes) -> int:
    """CRC-32/MPEG-2 of a PSI section (0 over a section with its CRC)."""
    c = 0xFFFFFFFF
    for b in data:
        c = ((c << 8) & 0xFFFFFFFF) ^ _CRC[(c >> 24) ^ b]
    return c


def packet_layout(head: bytes) -> Optional[Tuple[int, int]]:
    """(packet size, offset of the first sync byte) of a transport
    stream's first bytes, or None: the size at whose stride the sync byte
    repeats most (FFmpeg's ``get_packet_size`` / ``analyze``), at least
    three times in a row."""
    best = None
    for size in PACKET_SIZES:
        for start in range(size):
            run = 0
            while start + run * size < len(head) and \
                    head[start + run * size] == SYNC:
                run += 1
            if run >= 3 and (best is None or run > best[0]):
                best = (run, size, start)
    if best is None:
        return None
    _, size, start = best
    return size, start


def is_mpegts(head: bytes) -> bool:
    """Whether a file's first bytes are 188- or 192-byte TS packets."""
    return any(len(head) > 2 * size + lead and all(
        head[lead + k * size] == SYNC for k in range(3))
        for size, lead in ((188, 0), (192, 4)))


def _timestamp(b: bytes) -> int:
    return (((b[0] >> 1) & 7) << 30 | b[1] << 22 | (b[2] >> 1) << 15
            | b[3] << 7 | b[4] >> 1)


class Pes(NamedTuple):
    pts: Optional[int]      # 90 kHz, as in the stream (33 bits)
    dts: Optional[int]
    payload: bytes


class _Demuxer:
    """TS packets -> PSI sections and the PES packets of one PID, with
    FFmpeg's ``mpegts_push_data`` states (skip, header, payload)."""

    def __init__(self, path: str, size: int, lead: int):
        self.path, self.size, self.lead = path, size, lead
        self.last_cc: Dict[int, int] = {}
        self.sections: Dict[int, Optional[bytearray]] = {}
        self.pid: Optional[int] = None
        self._pes: Optional[bytearray] = None    # header + payload so far
        self._total: Optional[int] = None        # 0: unbounded; None: unread

    def packets(self, f: BinaryIO, start: int
                ) -> Iterator[Tuple[int, bytes]]:
        """(pid, 188 bytes) of each packet from file offset `start` on
        (the first packet's sync byte there), sync regained if lost."""
        size, lead = self.size, self.lead
        at = start - lead if start >= lead else start - lead + size
        buf, i = b"", 0                     # `at`: the file offset of buf's end
        while True:
            if len(buf) - i < 2 * size:
                f.seek(at)
                more = f.read(CHUNK)
                at += len(more)
                buf, i = buf[i:] + more, 0
                if len(buf) < size:
                    return
            if buf[i + lead] == SYNC:
                p = buf[i + lead:i + size]
                yield ((p[1] & 0x1F) << 8) | p[2], p
                i += size
                continue
            j = i + 1
            while j + size + lead < len(buf) and not (
                    buf[j + lead] == SYNC and buf[j + lead + size] == SYNC):
                j += 1
            log.warning("%s: TS sync lost; regained %d bytes on", self.path,
                        j - i)
            i = j

    def payload(self, pid: int, p: bytes) -> Optional[bytes]:
        """A packet's payload past its adaptation field (None: none);
        checks the continuity counter of a packet with payload."""
        control = (p[3] >> 4) & 3
        at, discontinuity = 4, False
        if control & 2:
            length = p[4]
            discontinuity = length > 0 and bool(p[5] & 0x80)
            at = 5 + length
        if not control & 1 or at >= 188:
            return None
        cc, last = p[3] & 0x0F, self.last_cc.get(pid)
        self.last_cc[pid] = cc
        if last is not None and not discontinuity and cc != (last + 1) & 15 \
                and pid != NULL_PID:
            log.warning("%s: continuity check failed for PID %d (expected "
                        "%d, got %d): a packet was lost", self.path, pid,
                        (last + 1) & 15, cc)
        return p[at:]

    def section(self, pid: int, data: bytes, start: bool) -> List[bytes]:
        """The complete PSI sections (CRC checked) this payload ends."""
        buf = self.sections.get(pid)
        if start:
            pointer = data[0]
            if buf is not None:
                buf += data[1:1 + pointer]
            done = self._sections(buf)
            buf = bytearray(data[1 + pointer:])
        elif buf is None:
            return []
        else:
            buf += data
            done = []
        done += self._sections(buf)
        self.sections[pid] = buf if buf and buf[0] != 0xFF else None
        return done

    @staticmethod
    def _sections(buf: Optional[bytearray]) -> List[bytes]:
        out = []
        while buf is not None and len(buf) >= 3 and buf[0] != 0xFF:
            n = 3 + (((buf[1] & 0x0F) << 8) | buf[2])
            if len(buf) < n:
                break
            if crc32_mpeg2(bytes(buf[:n])) == 0:
                out.append(bytes(buf[:n]))
            del buf[:n]
        return out

    def pes(self, data: bytes, start: bool) -> List[Pes]:
        """The PES packets of the chosen PID this payload completes."""
        out = []
        if start:
            if self._pes is not None:
                out += self._finish()
            self._pes, self._total = bytearray(data), None
        elif self._pes is None:
            return out                      # no PES start to join: skip
        else:
            self._pes += data
        if self._total is None and len(self._pes) >= 6:
            self._total = (self._pes[4] << 8) | self._pes[5]
        if self._total and len(self._pes) >= 6 + self._total:
            del self._pes[6 + self._total:]
            out += self._finish()
        return out

    def flush(self) -> List[Pes]:
        return self._finish() if self._pes is not None else []

    def _finish(self) -> List[Pes]:
        data, self._pes = bytes(self._pes), None
        if data[:3] != b"\x00\x00\x01":
            log.warning("%s: a PES of PID %s with no start code, dropped",
                        self.path, self.pid)
            return []
        if self._total and len(data) != 6 + self._total:
            log.warning("%s: PES packet size mismatch (%d of %d bytes)",
                        self.path, len(data) - 6, self._total)
        pts = dts = None
        at = 6
        if len(data) >= 9 and data[6] & 0xC0 == 0x80:
            flags, at = data[7] >> 6, 9 + data[8]
            if flags & 2 and len(data) >= 14:
                pts = dts = _timestamp(data[9:14])
            if flags == 3 and len(data) >= 19:
                dts = _timestamp(data[14:19])
        return [Pes(pts, dts, data[at:])]


class Wrap:
    """libavformat's unwrapping of 33-bit timestamps
    (``update_wrap_reference`` / ``wrap_timestamp``): the reference is 60
    s before the stream's first timestamp; later ones below it get 2^33
    added, unless that first timestamp lies within 60 s of the wrap, when
    those at or above it get 2^33 taken off."""

    def __init__(self, first: int):
        span, minute = 1 << WRAP_BITS, 60 * TIME_BASE
        self.reference = first - minute
        self.add = (first < span - (span >> 3)) or (first < span - minute)

    def __call__(self, ts: Optional[int]) -> Optional[int]:
        if ts is None:
            return None
        if self.add and ts < self.reference:
            return ts + (1 << WRAP_BITS)
        if not self.add and ts >= self.reference:
            return ts - (1 << WRAP_BITS)
        return ts


def r_frame_rate(times: List[int]) -> Fraction:
    """libavformat's ``r_frame_rate`` of a 1/90000 stream from its first
    frames' DTS (``ff_rfps_add_frame`` / ``ff_rfps_calculate``): 90000
    over the greatest common divisor of the durations (past the first
    three) when there are more than 15 and it exceeds 180 ticks; else the
    standard rate the times fit best (:func:`mkv.rfps`)."""
    durations = [b - a for a, b in zip(times, times[1:]) if b > a]
    gcd = 0
    for d in durations[3:]:
        gcd = math.gcd(gcd, d)
    if len(durations) > 15 and gcd > TIME_BASE // 500:
        return Fraction(TIME_BASE, gcd)
    std = mkv.rfps_std(times, 1 / TIME_BASE)
    return _std_rate(std) if std else Fraction(TIME_BASE)


def _start_code(data: bytes, code: int, at: int = 0) -> int:
    return data.find(b"\x00\x00\x01" + bytes([code]), at)


class _Bits:
    def __init__(self, data: bytes):
        self.value, self.n, self.at = int.from_bytes(data, "big"), \
            8 * len(data), 0

    def u(self, n: int) -> int:
        if self.at + n > self.n:
            raise ValueError("a header runs past its data")
        self.at += n
        return (self.value >> (self.n - self.at)) & ((1 << n) - 1)


def mpeg12_rate(es: bytes, mpeg1_doubled: bool = True
                ) -> Tuple[str, Optional[Fraction]]:
    """(decoder, the rate libavformat reports) of an MPEG-1/2 video
    stream's first bytes: its sequence header's frame rate code, times a
    sequence extension's (n + 1) / (d + 1) (MPEG-2); MPEG-1 at
    :data:`MPEG1_FPS` where `mpeg1_doubled` (libavformat's codec id is
    MPEG-2's, as in MPEG-TS), else at its own rate."""
    at = _start_code(es, 0xB3)
    if at < 0 or at + 12 > len(es):
        return "mpeg2video", None
    code = es[at + 7] & 0x0F
    ext = _start_code(es, 0xB5, at)
    while ext >= 0 and ext + 10 <= len(es) and es[ext + 4] >> 4 != 1:
        ext = _start_code(es, 0xB5, ext + 4)
    if ext < 0 or ext + 10 > len(es):
        return "mpeg1video", (MPEG1_FPS if mpeg1_doubled
                              else MPEG12_RATES).get(code)
    n, d = (es[ext + 9] >> 5) & 3, es[ext + 9] & 0x1F
    rate = MPEG12_RATES.get(code)
    return "mpeg2video", rate * (n + 1) / (d + 1) if rate else None


def mpeg4_rate(es: bytes) -> Optional[Fraction]:
    """The codec rate of an MPEG-4 Part 2 stream's first VOL header
    (``vop_time_increment_resolution`` over the fixed VOP increment, or
    over 1), as the ``mpeg4video`` parser sets it; None where libavformat
    ignores it (1000 fps or more) or there is no VOL."""
    at = -1
    for code in range(0x20, 0x30):
        found = _start_code(es, code)
        if found >= 0 and (at < 0 or found < at):
            at = found
    if at < 0:
        return None
    try:
        b = _Bits(es[at + 4:at + 64])
        b.u(1)                                # random_accessible_vol
        b.u(8)                                # video_object_type
        verid = 1
        if b.u(1):                            # is_object_layer_identifier
            verid = b.u(4)
            b.u(3)
        if b.u(4) == 15:                      # aspect_ratio_info: extended
            b.u(16)
        if b.u(1):                            # vol_control_parameters
            b.u(3)                            # chroma, low_delay
            if b.u(1):                        # vbv_parameters
                b.u(15), b.u(1), b.u(15), b.u(1), b.u(15), b.u(1)
                b.u(3), b.u(11), b.u(1), b.u(15), b.u(1)
        shape = b.u(2)
        if shape == 3 and verid != 1:
            b.u(4)
        b.u(1)                                # marker
        resolution = b.u(16)
        b.u(1)                                # marker
        increment = 1
        if b.u(1):                            # fixed_vop_rate
            increment = b.u(max(1, (resolution - 1).bit_length()))
    except ValueError:
        return None
    if not resolution or not increment or increment * 1000 <= resolution:
        return None
    return Fraction(resolution, increment)


def avg_frame_rate(rate: Fraction) -> Fraction:
    """``avformat_find_stream_info``'s ``avg_frame_rate`` of a stream
    whose every frame lasts 1 / `rate` s in 90 kHz ticks (rounded down,
    ``ff_compute_frame_duration``), snapped to a standard rate within 1 %
    as it snaps it."""
    ticks = TIME_BASE * rate.denominator // rate.numerator
    avg = Fraction(*mkv.av_reduce(TIME_BASE, ticks, 60000))
    best, best_err = None, 0.01
    for std in mkv.STD_FRAME_RATES:
        err = abs(float(avg) / (std / (12 * 1001)) - 1)
        if err < best_err:
            best, best_err = std, err
    return _std_rate(best) if best else avg


def _std_rate(std: int) -> Fraction:
    """A standard rate of ``get_std_framerate`` (times 12 x 1001)."""
    return Fraction(*mkv.av_reduce(std, 12 * 1001, mkv.INT_MAX))


class TsTrack:
    """The first video stream of an MPEG transport stream."""

    codec: str                       # a key of native.avcodec.PARSERS
    pid: int
    stream_type: int
    packet_size: int                 # 188, or 192 for M2TS
    first_sync: int                  # file offset of the first sync byte
    start_pts: int                   # unwrapped, 90 kHz
    end_pts: Optional[int]           # the greatest PTS of the file's tail
    avg_rate: Optional[Fraction]     # from the codec's headers
    r_rate: Fraction                 # from the timestamps
    size = None                      # the first decoded picture's
    rotation = rotation_meta = 0

    def __init__(self):
        self.seconds = {"parse": 0.0}

    @property
    def fps(self) -> float:
        return float(self.avg_rate or self.r_rate)

    @property
    def frame_count(self) -> int:
        """cv2's ``floor(duration x fps + 0.5)``; with no PTS found at the
        end the duration is unset (INT64_MIN) and so is this count, a large
        negative number, as cv2 reports it."""
        if self.end_pts is None:
            return int(math.floor(-2.0 ** 63 / TIME_BASE * self.fps + 0.5))
        last = TIME_BASE * self.r_rate.denominator // self.r_rate.numerator
        ticks = self.end_pts + last - self.start_pts
        micros = (ticks * 1000000 + TIME_BASE // 2) // TIME_BASE
        return int(math.floor(micros / 1e6 * self.fps + 0.5))

    @property
    def shown(self) -> Tuple[int, float]:
        return 0, math.inf              # every picture the decoder gives

    def pes(self, f: BinaryIO, start: Optional[int] = None
            ) -> Iterator[Pes]:
        """The stream's PES packets from file offset `start` (a packet
        boundary; default the first) to the end of the file."""
        demux = _Demuxer(getattr(f, "name", "?"), self.packet_size,
                         self.packet_size - 188)
        demux.pid = self.pid
        for pid, p in demux.packets(f, self.first_sync if start is None
                                    else start):
            if pid != self.pid:
                continue
            data = demux.payload(pid, p)
            if data is not None:
                yield from demux.pes(data, bool(p[1] & 0x40))
        yield from demux.flush()

    def packets(self, f: BinaryIO) -> Iterator[Tuple[bytes, bool]]:
        """(frame bytes for the decoder, key) of each frame the parser
        splits the stream into, in decode order."""
        from ..native.avcodec import Parser

        parser = Parser(self.codec)
        try:
            for pes in self.pes(f):
                t0 = time.perf_counter()
                frames = parser.parse(pes.payload)
                self.seconds["parse"] += time.perf_counter() - t0
                for frame in frames:
                    yield frame, mp4.intra_picture(self.codec, frame)
            t0 = time.perf_counter()
            frames = parser.flush()
            self.seconds["parse"] += time.perf_counter() - t0
            for frame in frames:
                yield frame, mp4.intra_picture(self.codec, frame)
        finally:
            parser.close()


def _choose(path: str, pmt: bytes) -> Tuple[int, int]:
    """(PID, stream type) of a PMT section's first video stream read."""
    info = ((pmt[10] & 0x0F) << 8) | pmt[11]
    at, end = 12 + info, len(pmt) - 4
    private = None
    while at + 5 <= end:
        kind, pid = pmt[at], ((pmt[at + 1] & 0x1F) << 8) | pmt[at + 2]
        at += 5 + (((pmt[at + 3] & 0x0F) << 8) | pmt[at + 4])
        if kind in STREAM_TYPES:
            return pid, kind
        if kind in OTHER_VIDEO:
            raise mp4.refusal(path, f"{OTHER_VIDEO[kind]} video in MPEG-TS "
                                    f"(stream type 0x{kind:02X})")
        if private is None and (kind in PRIVATE or kind >= 0x80):
            private = kind
    if private is not None:
        name = PRIVATE.get(private, "user private")
        raise mp4.refusal(path, f"an MPEG-TS program whose only candidate "
                                f"for video is a {name} stream (stream "
                                f"type 0x{private:02X})")
    raise mp4.refusal(path, "an MPEG-TS program with no video stream (PMT)")


PICTURE_START = {"mpeg1video": b"\x00\x00\x01\x00",
                 "mpeg2video": b"\x00\x00\x01\x00",
                 "mpeg4": b"\x00\x00\x01\xb6"}


def frame_times(track: TsTrack, head: List[Pes], wrap: Wrap) -> List[int]:
    """The DTS libavformat gives the first frames (unwrapped): a frame
    that starts in a timestamped PES takes its DTS; the others (a PES's
    second picture) are interpolated one codec frame on, as
    ``compute_pkt_fields`` does where it knows the frame duration, and
    get none for H.264 and HEVC, which it skips there."""
    if track.codec not in PICTURE_START or not track.avg_rate:
        return [wrap(p.dts) for p in head if p.dts is not None]
    ticks = TIME_BASE * track.avg_rate.denominator // track.avg_rate.numerator
    es = b"".join(p.payload for p in head)
    code = PICTURE_START[track.codec]
    starts, at = [], es.find(code)
    while at >= 0:
        starts.append(at)
        at = es.find(code, at + 4)
    times: List[int] = []
    begin = 0
    for p in head:
        end = begin + len(p.payload)
        n = sum(begin <= at < end for at in starts)
        begin = end
        for k in range(n):
            if k == 0 and p.dts is not None:
                times.append(wrap(p.dts))
            elif times:
                times.append(times[-1] + ticks)
    return times


def read_track(path: str, f: BinaryIO) -> TsTrack:
    """Parse a transport stream's tables, its first video stream's first
    frames and the timestamps of its last 250,000 bytes."""
    f.seek(0, 2)
    file_end = f.tell()
    f.seek(0)
    layout = packet_layout(f.read(192 * 8))
    if layout is None:
        raise mp4.refusal(path, "a file that is no MPEG-TS (no sync bytes)")
    track = TsTrack()
    track.packet_size, track.first_sync = layout
    demux = _Demuxer(path, track.packet_size, track.packet_size - 188)
    pmt_pid = None
    head: List[Pes] = []
    for pid, p in demux.packets(f, track.first_sync):
        if pid not in (PAT_PID, pmt_pid, demux.pid):
            continue
        data = demux.payload(pid, p)
        if data is None:
            continue
        start = bool(p[1] & 0x40)
        if pid == demux.pid:
            head += [pes for pes in demux.pes(data, start)
                     if pes.pts is not None]
            if len(head) >= RFPS_FRAMES:
                break
        elif pid == PAT_PID and pmt_pid is None:
            for sec in demux.section(pid, data, start):
                if sec[0] != TABLE_PAT:
                    continue
                for at in range(8, len(sec) - 4, 4):
                    number = (sec[at] << 8) | sec[at + 1]
                    if number:
                        pmt_pid = ((sec[at + 2] & 0x1F) << 8) | sec[at + 3]
                        break
        elif pid == pmt_pid and demux.pid is None:
            for sec in demux.section(pid, data, start):
                if sec[0] == TABLE_PMT:
                    demux.pid, track.stream_type = _choose(path, sec)
                    break
    head += [pes for pes in demux.flush() if pes.pts is not None]
    if pmt_pid is None:
        raise mp4.refusal(path, "an MPEG-TS stream with no PAT")
    if demux.pid is None:
        raise mp4.refusal(path, "an MPEG-TS stream with no PMT")
    if not head:
        raise mp4.refusal(path, "an MPEG-TS video stream with no "
                                "timestamped PES packet")
    track.pid = demux.pid
    track.codec = STREAM_TYPES[track.stream_type]

    def tail_start(window: int) -> int:
        """The first packet boundary in the file's last `window` bytes."""
        return max(0, (file_end - window - track.first_sync)
                   // track.packet_size) * track.packet_size \
            + track.first_sync

    set_timing(track, head, f, tail_start, track.first_sync)
    return track


def set_timing(track: TsTrack, head: List[Pes], f: BinaryIO, tail_start,
               first: int, mpeg1_doubled: bool = True) -> None:
    """What libavformat's ``avformat_find_stream_info`` and
    ``estimate_timings_from_pts`` make of a stream of MPEG-TS or an MPEG
    program stream, from its first PES packets `head` (at least
    :data:`RFPS_FRAMES` timestamped ones where the stream has them) and
    its PES from ``tail_start(window)`` (a file offset) on, for windows of
    :data:`TAIL_BYTES` doubled up to :data:`TAIL_RETRIES` times while no
    PES there has a PTS; `first` is the stream's first offset.  Sets the
    decoder (MPEG-1 or MPEG-2 by the stream), ``avg_rate``,
    ``start_pts``, ``r_rate`` and ``end_pts``.  An MPEG-1 stream's frames
    last a frame of :data:`MPEG1_FPS` in the duration whatever its codec
    id; its ``avg_rate`` is that too where `mpeg1_doubled`, else its own
    rate."""
    es = b"".join(pes.payload for pes in head[:4])
    track.avg_rate = frame_rate = None
    if track.codec in ("mpeg1video", "mpeg2video"):
        track.codec, rate = mpeg12_rate(es)
        track.avg_rate = avg_frame_rate(rate) if rate else None
        if track.codec == "mpeg1video":
            frame_rate = track.avg_rate
            if not mpeg1_doubled:
                rate = mpeg12_rate(es, False)[1]
                track.avg_rate = avg_frame_rate(rate) if rate else None
    elif track.codec == "mpeg4":
        rate = mpeg4_rate(es)
        track.avg_rate = avg_frame_rate(rate) if rate else None
    stamped = [pes for pes in head if pes.pts is not None]
    wrap = Wrap(stamped[0].dts)
    track.start_pts = wrap(stamped[0].pts)
    probed, size = [], 0            # what fits avformat_find_stream_info's
    for pes in head:                # probesize
        if size >= PROBE_BYTES:
            break
        probed.append(pes)
        size += len(pes.payload)
    track.r_rate = r_frame_rate(frame_times(track, probed, wrap)[:RFPS_FRAMES])
    if frame_rate:
        track.r_rate = frame_rate       # the frame length is MPEG1_FPS's
    track.end_pts = None
    for retry in range(TAIL_RETRIES + 1):
        tail = tail_start(TAIL_BYTES << retry)
        track.end_pts = max((wrap(p.pts) for p in track.pes(f, tail)
                             if p.pts is not None), default=None)
        if track.end_pts is not None or tail == first:
            break
