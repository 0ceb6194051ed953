"""Video-file demo (port of rtpose_tpu/demo/video_demo.py; reference
video_demo.py).

Frames are streamed and processed in batches: batch k+1 is submitted to
the card before batch k is collected, drawn and written.

    python -m rtpose_tpu_torch.demo.video_demo --video in.mp4 \\
        --output out.avi --batch 8

Reads what the JAX demo reads through cv2 (``demo/video_io.py``):
H.264 and MPEG-4 Part 2 (XVID, ``mp4v``) in MP4/MOV, AVI or Matroska,
VP9 in WebM, Matroska or MP4, turned by the file's rotation tag as cv2's
``CAP_PROP_ORIENTATION_AUTO`` turns them, and Motion-JPEG AVI.  Writes
XVID AVI, as the JAX demo does through cv2, with cv2's encoder and
settings (``native/avencode.py``: its packets are cv2's, byte for byte).
Runs on the card (``--device cuda``, the default: the decoded frames are
converted to BGR there); ``--device cpu`` for tests.
Frames smaller than ``--input-size`` are scaled on the card and larger
ones on the host (the pipeline's ``"auto"``), as in the JAX demo;
``--no-device-resize`` scales every frame on the host.
"""

from __future__ import annotations

import argparse
import time

from .picture_demo import add_common_args, build_pipeline
from .video_io import VideoWriter, open_video


def iter_batches(cap, batch_size):
    done = False
    while not done:
        frames = []
        for _ in range(batch_size):
            ok, frame = cap.read()
            if not ok:
                done = True
                break
            frames.append(frame)
        if frames:
            yield frames


def main():
    from ..utils.draw import draw_people

    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--video", required=True)
    parser.add_argument("--output", default="output.avi")
    parser.add_argument("--fps", type=float, default=20.0)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--no-device-resize", dest="device_resize",
                        action="store_false",
                        help="resize frames on host instead of on the card")
    parser.set_defaults(device_resize=True)
    args = parser.parse_args()

    pipe = build_pipeline(args)
    cap = open_video(args.video, device=args.device)

    writer = None
    n = 0
    t0 = time.time()

    def emit(frames, people_lists, metas):
        nonlocal writer, n
        for frame, people, meta in zip(frames, people_lists, metas):
            out = draw_people(frame, people, meta)
            if writer is None:
                writer = VideoWriter(args.output, args.fps,
                                     (out.shape[1], out.shape[0]),
                                     fourcc="XVID")
            writer.write(out)
            n += 1

    try:
        # depth-2 pipeline: batch k+1's transfer and compute run while
        # batch k's results are read back and rendered
        pending = None
        for frames in iter_batches(cap, args.batch):
            ticket = pipe.run_batch_submit(frames)
            if pending is not None:
                emit(pending[0], *pipe.run_batch_collect(pending[1]))
            pending = (frames, ticket)
        if pending is not None:
            emit(pending[0], *pipe.run_batch_collect(pending[1]))
    finally:
        if writer is not None:
            writer.release()
        cap.release()
    dt = time.time() - t0
    print(f"processed {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} FPS)"
          f" -> {args.output}")
    return n, dt


if __name__ == "__main__":
    main()
