"""MPEG program streams (ISO/IEC 11172-1 "MPEG-1 Systems" and 13818-1:
``.mpg`` files, DVD ``.vob``) demuxed in pure Python: the first video
stream's frames and what ``cv2.VideoCapture`` reports of it, as
``demo/mpegts.py`` gives them for transport streams, whose PES timing
and libavcodec parsers this reader shares.

- Units: the file is read as libavformat's ``mpeg`` demuxer reads it
  (``mpegps_read_pes_header``): from one start code to the next; a pack
  header (0xBA, MPEG-1's 12 bytes or MPEG-2's 14 and its stuffing), a
  system header (0xBB), an end code (0xB9) or any other code is passed
  over; the program stream map (0xBC), padding (0xBE), private stream 2
  (0xBF: DVD navigation packs) and every PES (private stream 1, 0xBD:
  DVD audio and subtitles; audio, 0xC0-0xDF; video, 0xE0-0xEF) are
  skipped or read by their stated length.
- PES headers of both syntaxes: MPEG-1's (0xFF stuffing, the STD buffer
  field, a PTS after ``0010`` or a PTS and DTS after ``0011``, or
  ``0x0F``) and MPEG-2's (the ``10`` marker, its flags and header
  length).
- The stream: the first video stream (0xE0-0xEF).  Its codec is the
  program stream map's stream type where a map came before it (0x01 /
  0x02 MPEG-1/2 video, 0x10 MPEG-4 Part 2, 0x1B H.264, 0x24 HEVC; which
  of MPEG-1 and MPEG-2 the sequence extension decides); else what its
  first bytes hold, as libavformat probes them (:func:`probe_codec`): a
  VOP start code, MPEG-4 Part 2; a sequence header, MPEG-1/2; an HEVC
  or an H.264 SPS.  cv2's own ``.mpg`` and ``.vob`` files carry no map.
- Frames: the PES payloads through libavcodec's parser, as for TS
  (``mpegts.TsTrack.packets``); fps, frame count and the first
  picture's size as libavformat estimates them for TS
  (``mpegts.set_timing``: the codec's rate, else the timestamps', and
  the duration from the file's last 250,000 bytes), save that
  libavformat reports an MPEG-1 stream here at its own rate, map or no
  map, and not at twice it as in TS (its frames still count at twice
  the rate for the duration's last frame, as in TS).

Refused, naming it and ROADMAP.md queue 1 item 4: a file with no video
stream, a map's stream type that is not read, a video stream whose codec
is none of these.
"""

from __future__ import annotations

import mmap
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple

from . import mp4, mpegts

PSM, PRIVATE_1, PADDING, PRIVATE_2 = 0xBC, 0xBD, 0xBE, 0xBF
VIDEO_IDS = range(0xE0, 0xF0)
# start codes followed by a 16-bit length; libavformat passes over the rest
LENGTH_CODED = {PSM, PRIVATE_1, PADDING, PRIVATE_2, *range(0xC0, 0xF0)}
PROBE_PES = 8               # PES payloads the codec is told from


def is_program_stream(head: bytes) -> bool:
    """Whether a file starts with a pack header (MPEG-1 or MPEG-2)."""
    return len(head) >= 5 and head[:4] == b"\x00\x00\x01\xba" and (
        head[4] & 0xF0 == 0x20 or head[4] & 0xC0 == 0x40)


def units(data, start: int = 0) -> Iterator[Tuple[int, int, int]]:
    """(offset, code, end) of each length-coded unit (PSM, padding,
    private streams, PES) from `start` on, as libavformat's ``mpeg``
    demuxer finds them: at the next start code, every other code passed
    over; a unit cut short by the end of the file ends there."""
    n = len(data)
    at = start
    while True:
        at = data.find(b"\x00\x00\x01", at)
        if at < 0 or at + 4 > n:
            return
        code = data[at + 3]
        if code not in LENGTH_CODED:
            at += 4
            continue
        if at + 6 > n:
            return
        end = at + 6 + ((data[at + 4] << 8) | data[at + 5])
        yield at, code, min(end, n)
        at = end


def pes_packet(data, at: int, end: int) -> Optional[mpegts.Pes]:
    """The PES packet data[at:end], with either syntax of header, as
    ``mpegps_read_pes_header`` reads it; None for a header that is
    neither (libavformat drops the packet)."""
    q = at + 6
    while q < end and data[q] == 0xFF:        # MPEG-1 stuffing
        q += 1
    if q >= end:
        return None
    c = data[q]
    if c & 0xC0 == 0x40:                      # MPEG-1 STD buffer size
        q += 2
        c = data[q] if q < end else 0
    pts = dts = None
    if c & 0xE0 == 0x20:                      # MPEG-1 PTS (and DTS)
        pts = dts = mpegts._timestamp(data[q:q + 5])
        q += 5
        if c & 0x10:
            dts = mpegts._timestamp(data[q:q + 5])
            q += 5
    elif c & 0xC0 == 0x80:                    # MPEG-2
        flags, length = data[q + 1], data[q + 2]
        if flags & 0x80:
            pts = dts = mpegts._timestamp(data[q + 3:q + 8])
            if flags & 0x40:
                dts = mpegts._timestamp(data[q + 8:q + 13])
        q += 3 + length
    elif c == 0x0F:                           # MPEG-1, no time
        q += 1
    else:
        return None
    return mpegts.Pes(pts, dts, bytes(data[q:end])) if q <= end else None


def program_stream_map(data, at: int, end: int) -> Dict[int, int]:
    """{elementary stream id: stream type} of a program stream map (its
    ``es_map`` bounded by the map's length, as libavformat bounds it)."""
    info = (data[at + 8] << 8) | data[at + 9]
    q = at + 12 + info
    left = ((data[at + 4] << 8) | data[at + 5]) - info - 10
    types = {}
    while left >= 4 and q + 4 <= end:
        kind, es_id = data[q], data[q + 1]
        es_info = (data[q + 2] << 8) | data[q + 3]
        types[es_id] = kind
        q += 4 + es_info
        left -= 4 + es_info
    return types


def probe_codec(es: bytes) -> Optional[str]:
    """The codec of a video stream's first bytes, as libavformat's probes
    tell it (a key of ``native.avcodec.PARSERS``, MPEG-1/2 as
    "mpeg2video" until its sequence extension is read; None: none of
    them): a VOP start code (0xB6, reserved in MPEG-1/2 video) makes
    MPEG-4 Part 2; else a sequence header (0xB3) MPEG-1/2; else an HEVC
    VPS or SPS (NAL types 32, 33 with layer 0) HEVC; else an H.264 SPS
    (NAL type 7) H.264."""
    codes = []
    at = es.find(b"\x00\x00\x01")
    while 0 <= at < len(es) - 4:
        codes.append((es[at + 3], es[at + 4]))
        at = es.find(b"\x00\x00\x01", at + 3)
    first = {c for c, _ in codes}
    if 0xB6 in first:
        return "mpeg4"
    if 0xB3 in first:
        return "mpeg2video"
    if any(c & 0x81 == 0 and (c >> 1) in (32, 33) and d & 0xF8 == 0
           and d & 7 for c, d in codes):
        return "hevc"
    if any(c & 0x80 == 0 and c & 0x60 and c & 0x1F == 7 for c, _ in codes):
        return "h264"
    return None


class PsTrack(mpegts.TsTrack):
    """The first video stream of an MPEG program stream (the fps, frame
    count and packets of :class:`mpegts.TsTrack`)."""

    stream_id: int                      # 0xE0-0xEF
    stream_type: Optional[int]          # the map's, None without one

    def pes(self, f: BinaryIO, start: Optional[int] = None
            ) -> Iterator[mpegts.Pes]:
        """The stream's PES packets from file offset `start` (default the
        file's start; any offset: the next start code is found)."""
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as data:
            for at, code, end in units(data, start or 0):
                if code == self.stream_id:
                    pes = pes_packet(data, at, end)
                    if pes is not None:
                        yield pes


def read_track(path: str, f: BinaryIO) -> PsTrack:
    """Parse a program stream's first video stream: its codec, its first
    frames' times and the timestamps of its last 250,000 bytes."""
    f.seek(0, 2)
    file_end = f.tell()
    f.seek(0)
    if not is_program_stream(f.read(5)):
        raise mp4.refusal(path, "a file that is no MPEG program stream (no "
                                "pack header)")
    track = PsTrack()
    track.stream_id, track.stream_type = None, None
    types: Dict[int, int] = {}
    head: List[mpegts.Pes] = []
    stamped = 0
    with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as data:
        for at, code, end in units(data):
            if code == PSM:
                types.update(program_stream_map(data, at, end))
            elif code in VIDEO_IDS and track.stream_id in (None, code):
                if track.stream_id is None:
                    track.stream_id = code
                    track.stream_type = types.get(code)
                pes = pes_packet(data, at, end)
                if pes is not None:
                    head.append(pes)
                    stamped += pes.pts is not None
                if stamped >= mpegts.RFPS_FRAMES:
                    break
    if track.stream_id is None:
        raise mp4.refusal(path, "an MPEG program stream with no video "
                                "stream (0xE0-0xEF)")
    kind = track.stream_type
    if kind is not None:
        if kind not in mpegts.STREAM_TYPES:
            name = mpegts.OTHER_VIDEO.get(kind, "video of another type")
            raise mp4.refusal(path, f"{name} in an MPEG program stream "
                                    f"(stream type 0x{kind:02X} in its "
                                    f"map)")
        track.codec = mpegts.STREAM_TYPES[kind]
    else:
        track.codec = probe_codec(b"".join(p.payload
                                           for p in head[:PROBE_PES]))
        if track.codec is None:
            raise mp4.refusal(path, f"an MPEG program stream whose video "
                                    f"(stream 0x{track.stream_id:02X}) is "
                                    f"none of MPEG-1/2, MPEG-4 Part 2, "
                                    f"H.264 or HEVC")
    if not stamped:
        raise mp4.refusal(path, "an MPEG program stream video stream with "
                                "no timestamped PES packet")
    mpegts.set_timing(track, head, f, lambda window: max(
        0, file_end - window), 0, mpeg1_doubled=False)
    return track
