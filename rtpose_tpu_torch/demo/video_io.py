"""Video files read and written in pure Python, in place of
``cv2.VideoCapture`` / ``cv2.VideoWriter`` (the JAX package's
rtpose_tpu/demo/video_demo.py:19-42, :78-80).

:func:`open_video` reads what the JAX demo's ``cv2.VideoCapture`` reads
of its users' files, frame for frame as cv2 gives them:

- Motion-JPEG (cameras, capture boxes, cv2's own ``MJPG`` writer) in
  AVI (``MJPG`` and the other Motion-JPEG tags of libavformat's RIFF
  table, :data:`AVI_CODECS`; OpenDML ``AVIX`` extensions included), in
  MOV / MP4 (``jpeg``, ``mjpa``; ``mp4v`` of objectTypeIndication 0x6C,
  what cv2 writes for ``MJPG`` in ``.mp4``) and in Matroska
  (``V_MJPEG``, or ``V_MS/VFW/FOURCC`` with such a tag): each chunk a
  JPEG image, decoded by libavcodec's ``mjpeg`` decoder as cv2's FFMPEG
  backend decodes it (4:2:0, 4:2:2, 4:4:4 and gray JPEGs; frames without
  Huffman tables too);
- H.264 and MPEG-4 Part 2 (XVID, DivX, ``mp4v``: what the JAX demo and
  cv2's wheels write) in AVI (``XVID``, ``DIVX``, ``DX50``, ``FMP4``,
  ``MP4V``, ``H264``, ``AVC1``, ``X264`` chunks), in MP4 / MOV
  (``demo/mp4.py``; fragmented files, and edit lists of several entries)
  or in Matroska (``demo/mkv.py``), H.264 High 10, High 4:2:2 and High
  4:4:4 too (camera intra formats); VP8 and VP9 (profiles 0-3: 4:2:0,
  4:2:2, 4:4:0 and 4:4:4 of 8, 10 and 12 bits) in WebM, Matroska or MP4
  (``vp08``, ``vp09``): browser ``MediaRecorder``, OBS, screen recorders
  and most downloaded web video;
- HEVC (Main, Main 10 and the range extensions: 4:2:0, 4:2:2, 4:4:4 and
  4:0:0 of 8, 10 or 12 bits) in MP4 / MOV (``hvc1``, ``hev1``: what
  phones and cameras record), Matroska and MPEG-TS;
- MPEG-1 / MPEG-2 video, MPEG-4 Part 2, H.264 and HEVC in MPEG transport
  streams, ``.ts`` and M2TS / AVCHD ``.mts`` (``demo/mpegts.py``, its
  frames split by libavcodec's parsers): IP and surveillance cameras,
  HLS segments, broadcast captures, camcorders; and in MPEG program
  streams, ``.mpg`` and DVD ``.vob`` (``demo/mpegps.py``, the same
  parsers);
- what cv2's own ``VideoWriter`` writes (:data:`WRITER_TAGS`: raw
  ``I420`` / ``IYUV`` / ``Y800`` video, MPEG-1/2, MS-MPEG4 v2 / v3,
  WMV1 / WMV2, Sorenson H.263, HuffYUV, FFVH, FFV1) in AVI and
  Matroska, its decoder handed the container's extradata, size and
  biBitCount (:func:`bitmap_params`), and ProRes in MOV and Matroska:
  lab and dataset archives, editors' and recorders' files.  The
  rotation of the track is honoured
  as ``CAP_PROP_ORIENTATION_AUTO`` does; H.264 and HEVC pictures come in
  cv2's order.  The packets are decoded on the host by FFmpeg's libavcodec
  from the OpenCV wheel (``native/avcodec.py``), the planes converted to
  BGR and turned on the card by the kernel of the path cv2's swscale takes
  at the frame's chroma format, depth and size
  (``ops.kernels.yuv420_frame_to_bgr``: for 4:2:0 ``yuv420_to_bgr`` at
  8 bits and an even height, ``yuv420_general_to_bgr`` at an odd one,
  ``yuv420p10_to_bgr`` at 10 bits, ``yuv420_full_chroma_to_bgr`` at an
  odd width where swscale takes its full-chroma output; for 8-bit 4:2:2
  of an even height ``yuv422_to_bgr``, for the other chroma formats and
  12 bits ``yuv_planar_general_to_bgr`` and
  ``yuv_planar_full_chroma_to_bgr``, for 4:0:0 ``gray_to_bgr``, for
  packed RGB (HuffYUV, FFV1, raw RGB) ``packed_to_bgr``: cv2's
  arithmetic to the bit).
  ``device="cpu"`` converts with the kernels' plain versions, for tests;
  without a card, and without the library, opening such a file raises.

Colour is converted as cv2 5.0 converts it (:func:`conversion`): with
the matrix and range the frame carries, which the decoder takes from
the bitstream (H.264 / HEVC VUI, MPEG-2's sequence display extension,
VP9's frame header, ...) and, where that is silent, keeps from the
container (an MP4 ``colr`` box, Matroska's ``Colour``; HEVC's decoder
resets them when its VUI states none); where swscale filters the chroma
(deeper frames, odd sizes, chroma formats but 4:2:0 and 4:2:2 at 8
bits) it is placed by the frame's chroma location along each
subsampled axis; gray is full range, as cv2 5.0 takes it.
Frames under 9 rows or 8 columns that swscale scales are refused
(item 4i (a)).

Everything else is refused with an error that names the container or
codec and ROADMAP.md queue 1 item 4: AV1, Motion-JPEG format B
(``mjpb``), WMV3 / VC-1, Theora, H.263 and BI_RGB DIBs (item 4j (e),
:data:`STILL_REFUSED_TAGS`), 4:1:1 (``yuvj411p`` JPEG too), 16-bit and RGB
(``gbrp``) video (item 4i), colour cv2
5.0 does not convert by swscale's matrix alone (other primaries than
BT.601 / BT.709 / 240M, PQ and HLG transfers, matrices without a
swscale table: item 4i), laced Matroska blocks, edits of another media
rate.

:class:`VideoWriter` writes AVI: a ``hdrl`` list (the ``avih`` main
header, one ``strl`` with the ``vids`` stream header and its
BITMAPINFOHEADER), a ``movi`` list of ``00dc`` chunks and an ``idx1``
index whose key flags are the packets'; the frame counts in both headers
are written when the file is closed.  cv2 reads these files (its AVI
reader needs ``idx1`` to open one).  Its ``fourcc`` is ``"XVID"``, what
the JAX demo writes: MPEG-4 Part 2 packets of cv2's own encoder and
settings (``native/avencode.py``), byte for byte cv2's; or ``"MJPG"``,
one baseline JPEG a frame.
"""

from __future__ import annotations

import functools
import io
import itertools
import math
import struct
import time
from fractions import Fraction
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from ..data.imwrite import JPEG_OPTIONS
from . import mkv, mp4, mpegps, mpegts

WRITER_FOURCCS = ("XVID", "MJPG")
AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10
# AVI stream handlers / compressions (upper case) -> the decoder: the
# Motion-JPEG tags of libavformat's RIFF table (``ff_codec_bmp_tags``;
# ``AVRn``, Avid's, too: its images are JPEGs), MPEG-4 Part 2 and H.264
MJPEG_TAGS = (b"MJPG", b"LJPG", b"DMB1", b"MJPA", b"JR24", b"JPGL", b"MJLS",
              b"JPEG", b"IJPG", b"AVRN", b"ACDV", b"QIVG", b"SLMJ", b"CJPG",
              b"IJLV", b"MVJP", b"AVI1", b"AVI2", b"MTSJ", b"ZJPG")
# what cv2's own VideoWriter writes (its fourccs ``0``, ``I420``, ``IYUV``,
# ``Y800``, ``PIM1``, ``mpg2`` / ``MPEG``, ``MP42``, ``DIV3``, ``WMV1``,
# ``WMV2``, ``FLV1``, ``FFVH``, ``HFYU``, ``FFV1``), by the tag its AVI
# carries: raw video (its pixel format from the tag: I420 / IYUV 4:2:0,
# Y800 gray), MPEG-1/2, MS-MPEG4 v2 / v3, WMV1 / WMV2, Sorenson H.263,
# HuffYUV and FFV1
WRITER_TAGS = {b"I420": "rawvideo", b"IYUV": "rawvideo", b"Y800": "rawvideo",
               b"PIM1": "mpeg1video", b"MPG1": "mpeg1video",
               b"MPG2": "mpeg2video", b"MPEG": "mpeg2video",
               b"MP42": "msmpeg4v2", b"DIV3": "msmpeg4", b"MP43": "msmpeg4",
               b"WMV1": "wmv1", b"WMV2": "wmv2", b"FLV1": "flv",
               b"HFYU": "huffyuv", b"FFVH": "ffvhuff", b"FFV1": "ffv1"}
AVI_CODECS = {**dict.fromkeys(MJPEG_TAGS, "mjpeg"),
              b"XVID": "mpeg4", b"DIVX": "mpeg4",
              b"DX50": "mpeg4", b"FMP4": "mpeg4", b"MP4V": "mpeg4",
              b"H264": "h264", b"AVC1": "h264", b"X264": "h264",
              **WRITER_TAGS}
# what stays refused by name (ROADMAP.md queue 1 item 4j (e)): no encoder
# of either machine writes a fixture of them, or cv2 does not write them
STILL_REFUSED_TAGS = {b"WMV3": "WMV3 / VC-1", b"WVC1": "VC-1",
                      b"THEO": "Theora", b"S263": "H.263",
                      b"H263": "H.263", b"\0\0\0\0": "BI_RGB DIB"}


def avi_codec(fourcc: bytes) -> Tuple[Optional[str], bytes]:
    """(the decoder, the tag to hand it) of an AVI or Matroska VFW stream's
    fourcc, as libavformat maps it (case aside): a Motion-JPEG stream's
    decoder takes its tag (``MTSJ`` decodes otherwise), and so do those of
    cv2's writer (:data:`WRITER_TAGS`; raw video's pixel format is its
    tag's).  Avid's ``AVRn`` holds JPEG images, which the ``mjpeg``
    decoder decodes as cv2 does when not handed the tag (with it, it would
    want the container's frame size); under any other case the tag is
    libavcodec's raw 4:2:2 ``avrn``, not read."""
    if fourcc.upper() == b"AVRN":
        return ("mjpeg" if fourcc == b"AVRn" else None), b""
    codec = AVI_CODECS.get(fourcc.upper())
    takes_tag = codec == "mjpeg" or fourcc.upper() in WRITER_TAGS
    return codec, fourcc if takes_tag else b""


def refused_tag(*fourccs: bytes) -> str:
    """Why an AVI or VFW stream of these fourccs (compression, handler),
    which no decoder of :data:`AVI_CODECS` reads, is refused: those of
    item 4j (e) by name."""
    what = next((STILL_REFUSED_TAGS[t.upper()] for t in fourccs
                 if t.upper() in STILL_REFUSED_TAGS), None)
    return f" ({what}: ROADMAP.md queue 1 item 4j (e))" if what else ""


def bitmap_params(codec: str, strf: bytes):
    """A BITMAPINFOHEADER's (an AVI ``strf``, a VFW ``CodecPrivate``)
    ``native.avcodec.CodecParams`` for a decoder of
    ``avcodec.CONTAINER_PARAMS`` (None for another): the bytes past its
    biSize, (biWidth, |biHeight|) and biBitCount, as libavformat's
    ``ff_get_bmp_header`` hands them."""
    from ..native.avcodec import CONTAINER_PARAMS, CodecParams
    if codec not in CONTAINER_PARAMS:
        return None
    size, w, h, _, bits = struct.unpack_from("<IiiHH", strf)
    return CodecParams(strf[40:size] if size > 40 else b"", (w, abs(h)),
                       bits)


def _chunks(f: BinaryIO, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(fourcc, data offset, size) of the RIFF chunks from here to `end`;
    a LIST chunk's size counts its list type."""
    while f.tell() + 8 <= end:
        head = f.read(8)
        fourcc, size = head[:4], struct.unpack("<I", head[4:])[0]
        start = f.tell()
        yield fourcc, start, size
        f.seek(start + size + (size & 1))


class AviStream:
    """The first video stream of a RIFF AVI file: its codec (a key of
    :data:`AVI_CODECS`' values), fps, (w, h), the codec's extra data
    (BITMAPINFOHEADER past its 40 bytes) and each frame chunk's (offset,
    size) in file order, empty chunks (dropped frames) skipped."""

    def __init__(self, path: str, f: BinaryIO):
        self.path = path
        self.codec: Optional[str] = None
        self.fps: Optional[float] = None
        self.size: Tuple[int, int] = (0, 0)
        self.extradata = b""
        self.tag = b""         # a Motion-JPEG stream's, for its decoder
        self.params = None     # native.avcodec.CodecParams, where taken
        self.frames: List[Tuple[int, int]] = []
        f.seek(0, io.SEEK_END)
        file_end = f.tell()
        stream = None          # the video stream's chunk id prefix, b"00"
        f.seek(0)
        for riff, start, riff_size in _chunks(f, file_end):
            if riff != b"RIFF":
                continue
            riff_end = min(start + riff_size, file_end)
            f.seek(start + 4)                    # past "AVI " / "AVIX"
            for fourcc, off, n in _chunks(f, riff_end):
                if fourcc != b"LIST":
                    continue
                f.seek(off)
                kind = f.read(4)
                if kind == b"hdrl":
                    stream = self._header(f, off + 4, off + n)
                elif kind == b"movi":
                    if stream is None:
                        raise mp4.refusal(path, "an AVI with no video "
                                                "stream")
                    f.seek(off + 4)
                    self.frames += [
                        (o, size) for fourcc, o, size in _chunks(f, off + n)
                        if fourcc[:2] == stream
                        and fourcc[2:] in (b"dc", b"db") and size]
                f.seek(off + n + (n & 1))
        if stream is None:
            raise mp4.refusal(path, "an AVI with no video stream")

    rotation = rotation_meta = 0

    @property
    def frame_count(self) -> int:
        return len(self.frames)

    @property
    def shown(self) -> Tuple[int, int]:
        return 0, len(self.frames)

    def packets(self, f: BinaryIO) -> Iterator[Tuple[bytes, bool]]:
        """(bytes for the decoder, key) of each frame chunk, the codec's
        extra data ahead of the first."""
        for i, (off, n) in enumerate(self.frames):
            f.seek(off)
            data = f.read(n)
            if i == 0 and self.params is None:
                data = self.extradata + data
            yield data, mp4.intra_picture(self.codec, data)

    def _header(self, f: BinaryIO, start: int, end: int) -> bytes:
        """Read the first video stream's header; its chunk id prefix."""
        f.seek(start)
        index = 0
        for fourcc, off, n in _chunks(f, end):
            if fourcc != b"LIST":
                continue
            f.seek(off)
            if f.read(4) != b"strl":
                continue
            strh = strf = None
            for sub, soff, sn in _chunks(f, off + n):
                if sub in (b"strh", b"strf"):
                    f.seek(soff)
                    data = f.read(sn)
                    if sub == b"strh":
                        strh = data
                    else:
                        strf = data
            if strh is not None and strh[:4] == b"vids":
                handler = strh[4:8]
                compression = strf[16:20] if strf and len(strf) >= 20 \
                    else b""
                codec, tag = avi_codec(
                    compression if compression.upper() in AVI_CODECS
                    else handler)
                if codec is None:
                    raise mp4.refusal(self.path, f"AVI video codec "
                                                 f"{handler!r}/"
                                                 f"{compression!r}"
                                                 + refused_tag(compression,
                                                               handler))
                scale, rate = struct.unpack("<II", strh[20:28])
                w, h = struct.unpack("<ii", strf[4:12])
                size = struct.unpack("<I", strf[:4])[0]
                self.codec, self.size = codec, (w, abs(h))
                self.fps = rate / scale if scale else None
                self.tag = tag
                self.extradata = strf[40:size] if size > 40 else b""
                self.params = bitmap_params(codec, strf)
                return b"%02d" % index
            index += 1
            f.seek(off + n + (n & 1))
        raise mp4.refusal(self.path, "an AVI with no video stream")


class DecodedVideo:
    """A video stream (H.264, HEVC, MPEG-1/2, MPEG-4 Part 2, VP8, VP9,
    Motion-JPEG, a codec of cv2's writer or ProRes) of an MP4/MOV, AVI,
    Matroska / WebM, MPEG-TS or MPEG program stream file,
    read as ``cv2.VideoCapture`` with
    ``CAP_PROP_ORIENTATION_AUTO`` reads it: ``read()`` gives each frame
    in display order as ``(H, W, 3)`` uint8 BGR, turned by ``rotation``;
    ``fps``, ``size`` (w, h after the turn) and ``frame_count`` are
    cv2's.

    `read_track(path, file)` parses the container into a track (an
    :class:`AviStream`, ``mkv.MkvTrack``, ``mpegts.TsTrack``,
    ``mpegps.PsTrack`` or ``mp4.Track``: codec, fps, size (None: the
    first picture's),
    rotation, frame count, the pictures shown and ``packets``); without
    one the file is read as MP4/MOV.  The packets are demuxed on the
    host (a transport or program stream's split into frames by
    libavcodec's parser),
    decoded there by libavcodec (an H.264 stream probed first, as
    libavformat probes it for cv2), and each picture's planes are
    copied to `device` and converted by ``ops.kernels.yuv420_frame_to_bgr``
    (the kernel of swscale's path at the picture's depth and size; the
    plain versions for ``"cpu"``), with the picture's colour
    (:func:`conversion`).  The copy
    returns once the decoder's buffers have been read, before the next
    picture reuses them.  ``seconds`` sums the time of each step: ``demux`` (reading a
    packet and, for H.264 and HEVC, its Annex-B form), ``parse`` (a
    transport or program stream's parser), ``decode`` (libavcodec) and
    ``convert`` (copy up, kernel, copy back)."""

    def __init__(self, path: str, device="cuda", read_track=None):
        import torch

        from ..native.avcodec import Decoder
        self.path = path
        self.device = torch.device(device)
        self._f = open(path, "rb")
        self._decoder = None
        try:
            self.seconds = {"demux": 0.0, "decode": 0.0, "convert": 0.0}
            t0 = time.perf_counter()
            track = (read_track or mp4.read_track)(path, self._f)
            self.codec, self.fps = track.codec, track.fps
            self.rotation, self.rotation_meta = (track.rotation,
                                                 track.rotation_meta)
            self.frame_count = track.frame_count
            # pictures outside an MP4 edit list's spans are dropped:
            # whether to show each picture the decoder gives, in order
            self._show = _shown_flags(track.shown)
            self._packets = track.packets(self._f)
            # a parsing demuxer (MPEG-TS, program streams) times its
            # parser apart
            self._parsed = getattr(track, "seconds", None)
            if self._parsed is not None:
                self.seconds["parse"] = 0.0
            self.seconds["demux"] += time.perf_counter() - t0
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"{path}: no CUDA card: decoded frames are converted to "
                    f"BGR on the card (device='cpu' converts on the host, "
                    f"for tests)")
            t0 = time.perf_counter()
            self._decoder = Decoder(self.codec,
                                    getattr(track, "colour", None),
                                    getattr(track, "tag", b""),
                                    getattr(track, "params", None))
            # as libavformat does for cv2 (in MPEG-TS too); MPEG-1/2 and
            # HEVC decoders reorder from the first picture: no probe
            if self.codec == "h264":
                probe = track.packets(self._f)
                try:
                    self._decoder.probe(probe)
                finally:
                    probe.close()
            self.seconds["decode"] += time.perf_counter() - t0
            self._pictures = self._decode()
            self.size = track.size
            if self.size is None:       # the stream's: the first picture's
                first = next(self._pictures, None)
                if first is None:
                    raise ValueError(f"{path}: the video stream decodes to "
                                     f"no picture")
                self.size = (first[3], first[0].shape[0])
                self._pictures = itertools.chain([first], self._pictures)
        except BaseException:
            self.release()
            raise

    def _decode(self):
        """The decoder's pictures in display order, as it completes them."""
        while True:
            t0 = time.perf_counter()
            parsed = self._parsed["parse"] if self._parsed else 0.0
            packet = next(self._packets, None)
            t1 = time.perf_counter()
            if self._parsed:
                parsed = self._parsed["parse"] - parsed
                self.seconds["parse"] += parsed
                t0 += parsed
            self.seconds["demux"] += t1 - t0
            # libavcodec decodes a packet as it is sent
            t1 = time.perf_counter()
            pictures = (self._decoder.flush() if packet is None else
                        self._decoder.decode(*packet))
            self.seconds["decode"] += time.perf_counter() - t1
            while True:
                t0 = time.perf_counter()
                picture = next(pictures, None)
                self.seconds["decode"] += time.perf_counter() - t0
                if picture is None:
                    break
                yield (*picture, self._decoder.colour)
            if packet is None:
                return

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        """(True, next frame) or (False, None) after the last one."""
        import torch

        from ..ops.kernels import yuv420_frame_to_bgr
        if self._decoder is None:
            return False, None
        while True:
            show = next(self._show, None)
            if show is None:
                return False, None
            picture = next(self._pictures, None)
            if picture is None:
                return False, None
            if show:
                break
        t0 = time.perf_counter()
        *planes, width, colour = picture
        try:
            rule, location = conversion(colour)
        except ValueError as e:
            raise ValueError(f"{self.path}: {e}") from None
        planes = [None if p is None else torch.from_numpy(p).to(self.device)
                  for p in planes]
        try:
            frame = yuv420_frame_to_bgr(*planes, depth=colour.depth,
                                        width=width, rotation=self.rotation,
                                        rule=rule, chroma_location=location,
                                        chroma=colour.chroma,
                                        packed=colour.packed)
        except ValueError as e:
            raise ValueError(f"{self.path}: {e}") from None
        frame = frame.cpu().numpy()
        self.seconds["convert"] += time.perf_counter() - t0
        return True, frame

    def release(self) -> None:
        if self._decoder is not None:
            self._decoder.close()
            self._decoder = None
        self._f.close()


# what cv2 5.0 (FFmpeg 8's swscale graph) leaves to swscale's YUV -> RGB
# matrix alone; other primaries (BT.2020, DCI-P3, film, XYZ, ...) and the
# PQ and HLG transfers it converts in gamut or tone, which the port does not
PLAIN_PRIMARIES = frozenset([1, 2, 4, 5, 6, 7])
PLAIN_TRANSFERS = frozenset([1, 2, 4, 5, 6, 7, 8, 11, 12, 13, 14, 15, 17])


@functools.lru_cache(maxsize=None)
def conversion(colour) -> Tuple[object, int]:
    """(``ops.kernels.YuvRule``, chroma location) of a decoded picture's
    ``native.avcodec.FrameColour``: the matrix and range the frame
    carries, as cv2 5.0 converts it; raises ValueError naming what it
    converts otherwise (ROADMAP.md queue 1 item 4i)."""
    from ..ops.kernels import yuv_rule
    if colour.primaries not in PLAIN_PRIMARIES:
        raise ValueError(f"a video stream of colour primaries "
                         f"{colour.primaries} (cv2 5.0 converts their gamut; "
                         f"ROADMAP.md queue 1 item 4i)")
    if colour.transfer not in PLAIN_TRANSFERS:
        raise ValueError(f"a video stream of transfer characteristics "
                         f"{colour.transfer} (cv2 5.0 converts its tone: "
                         f"PQ, HLG; ROADMAP.md queue 1 item 4i)")
    if colour.chroma is None:      # gray: no matrix, and full range
        return yuv_rule(2, True), colour.chroma_location
    return yuv_rule(colour.matrix, colour.full), colour.chroma_location


def _shown_flags(shown) -> Iterator[bool]:
    """A track's pictures to show: (dropped first, shown) counts, or a
    flag for each picture the decoder gives."""
    if isinstance(shown, tuple):
        skip, count = shown
        return itertools.chain(
            itertools.repeat(False, skip),
            itertools.repeat(True) if count == math.inf
            else itertools.repeat(True, count))
    return iter(shown)


def open_video(path: str, device="cuda"):
    """Open a video file for reading (``cv2.VideoCapture``'s place in the
    JAX demo): a :class:`DecodedVideo` of its first video stream (MP4/MOV,
    AVI, Matroska / WebM, MPEG-TS, MPEG program streams), which converts
    its frames on `device`.  Raises FileNotFoundError for a missing file
    and ValueError, naming the container or codec and ROADMAP.md queue 1
    item 4, for anything else."""
    with open(path, "rb") as f:
        head = f.read(4096)
        if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
            stream = AviStream(path, f)
            return DecodedVideo(path, device, lambda path, f: stream)
    if mp4.is_isobmff(head):
        return DecodedVideo(path, device)
    if mkv.is_matroska(head):
        return DecodedVideo(path, device, mkv.read_track)
    if mpegts.is_mpegts(head):
        return DecodedVideo(path, device, mpegts.read_track)
    if mpegps.is_program_stream(head):
        return DecodedVideo(path, device, mpegps.read_track)
    if head[:4] == b"RIFF":
        what = f"a RIFF {head[8:12]!r} file, not AVI"
    else:
        what = f"an unknown container (starts with {head[:12]!r})"
    raise mp4.refusal(path, what)


class VideoWriter:
    """Write ``(H, W, 3)`` uint8 BGR frames of one size as an AVI at `fps`
    (``cv2.VideoWriter(path, fourcc, fps, (w, h))``'s place), `fourcc`
    one of:

    - ``"XVID"`` (the JAX demo's): MPEG-4 Part 2 packets of
      ``native.avencode.Encoder``, cv2's encoder and settings, byte for
      byte; the first write raises if the wheel's libavcodec or
      libswscale is missing;
    - ``"MJPG"``: each frame a baseline JPEG at cv2's settings (quality
      95, 4:2:0, ``data.imwrite.JPEG_OPTIONS``).

    :meth:`release` writes the index and the frame counts.  ``seconds``
    sums the time of ``convert`` (XVID: swscale), ``encode`` (the codec)
    and ``write`` (the file)."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int],
                 fourcc: str = "MJPG"):
        self.path = path
        self.width, self.height = (int(v) for v in frame_size)
        if self.width <= 0 or self.height <= 0 or fps <= 0:
            raise ValueError(f"frame size {frame_size} and fps {fps} must "
                             f"be positive")
        if fourcc not in WRITER_FOURCCS:
            raise ValueError(f"the writer writes {' or '.join(WRITER_FOURCCS)}"
                             f" AVI, not {fourcc!r}")
        self.fourcc, self.fps = fourcc.encode(), fps
        rate = Fraction(fps).limit_denominator(1001)
        self._rate, self._scale = rate.numerator, rate.denominator
        self._index: List[Tuple[int, int]] = []    # (offset, size)
        self._inter: set = set()                    # chunks that are not key
        self._max_chunk = 0
        self._encoder = None
        self.seconds = {"convert": 0.0, "encode": 0.0, "write": 0.0}
        self._f = open(path, "wb")
        self._write_headers()
        self._movi = self._f.tell() - 4            # the "movi" fourcc

    def _headers(self) -> bytes:
        n, w, h = len(self._index), self.width, self.height
        us_per_frame = round(1e6 * self._scale / self._rate)
        bufsize = self._max_chunk + 8
        max_bytes = int(bufsize * self._rate / self._scale)
        avih = struct.pack("<10I4I", us_per_frame, max_bytes, 0,
                           AVIF_HASINDEX, n, 0, 1, bufsize, w, h, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", self.fourcc, 0,
                           0, 0, 0, self._scale, self._rate, 0, n, bufsize,
                           0xFFFFFFFF, 0, 0, 0, w, h)
        strl = (b"strl" + _chunk(b"strh", strh)
                + _chunk(b"strf", bitmap_info((w, h), self.fourcc)))
        hdrl = b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
        return _chunk(b"LIST", hdrl)

    def _write_headers(self) -> None:
        self._f.write(b"RIFF" + struct.pack("<I", 0) + b"AVI ")
        self._f.write(self._headers())
        self._f.write(b"LIST" + struct.pack("<I", 0) + b"movi")

    def write(self, frame: np.ndarray) -> None:
        if frame.dtype != np.uint8 or frame.shape != (self.height,
                                                      self.width, 3):
            raise ValueError(f"frames of this video are ({self.height}, "
                             f"{self.width}, 3) uint8, got {frame.dtype} "
                             f"{frame.shape}")
        if self.fourcc == b"XVID":
            if self._encoder is None:
                from ..native.avencode import Encoder
                self._encoder = Encoder(self.width, self.height, self.fps)
                self._encoder.seconds = self.seconds    # its two steps
            packets = self._encoder.encode(frame)
        else:
            from PIL import Image
            t0 = time.perf_counter()
            buf = io.BytesIO()
            Image.fromarray(np.ascontiguousarray(frame[..., ::-1])).save(
                buf, "JPEG", **JPEG_OPTIONS)
            packets = [(buf.getvalue(), True)]
            self.seconds["encode"] += time.perf_counter() - t0
        self.write_packets(packets)

    def write_packets(self, packets) -> None:
        """Write encoded packets (bytes, key) of the writer's codec as
        they are, one chunk each."""
        t0 = time.perf_counter()
        for data, key in packets:
            if not key:
                self._inter.add(len(self._index))
            self._index.append((self._f.tell() - self._movi, len(data)))
            self._max_chunk = max(self._max_chunk, len(data))
            self._f.write(_chunk(b"00dc", data))
        self.seconds["write"] += time.perf_counter() - t0

    def release(self) -> None:
        """Write the encoder's last packets, the index, the sizes and the
        frame counts, and close."""
        if self._f.closed:
            return
        f = self._f
        try:
            if self._encoder is not None:
                self.write_packets(self._encoder.flush())
                self._encoder.close()
                self._encoder = None
            movi_end = f.tell()
            f.write(_chunk(b"idx1", b"".join(
                struct.pack("<4sIII", b"00dc",
                            0 if i in self._inter else AVIIF_KEYFRAME, off, n)
                for i, (off, n) in enumerate(self._index))))
            end = f.tell()
            f.seek(4)
            f.write(struct.pack("<I", end - 8))
            f.write(b"AVI ")
            f.write(self._headers())
            f.write(struct.pack("<4sI", b"LIST", movi_end - self._movi))
        finally:
            f.close()


def bitmap_info(size: Tuple[int, int], fourcc: bytes) -> bytes:
    """A BITMAPINFOHEADER (40 bytes) of (w, h) frames of `fourcc`: an AVI
    stream's ``strf``, a Matroska ``V_MS/VFW/FOURCC`` track's
    ``CodecPrivate``."""
    w, h = size
    return struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3,
                       0, 0, 0, 0)


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    """A RIFF chunk: fourcc, little-endian size, data, pad to even."""
    return fourcc + struct.pack("<I", len(data)) + data + b"\0" * (
        len(data) & 1)
