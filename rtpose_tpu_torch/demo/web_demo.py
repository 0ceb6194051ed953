"""Webcam demo (port of rtpose_tpu/demo/web_demo.py; reference
demo/web_demo.py): a live capture loop with an FPS overlay, quit on q.

    python -m rtpose_tpu_torch.demo.web_demo --camera 0 --weight pose_model.pth

then open the printed address (default http://127.0.0.1:8090/) and press
q on the page to stop.  From another machine, tunnel the port first:
``ssh -L 8090:127.0.0.1:8090 <card's host>`` and open
http://localhost:8090/ there.

Each frame of ``/dev/video<camera>`` (``demo.camera``, cv2's
``VideoCapture`` without cv2) goes through ``PosePipeline.run`` (one frame,
one readback), ``utils.draw.draw_people`` and the FPS text
(``utils.draw.put_text``, ``cv2.putText``'s pixels) to the browser view
(``demo.frame_view``, in place of ``cv2.imshow``).  Runs on the card
(``--device cuda``, the default); ``--device cpu`` for tests.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

from .camera import open_camera
from .frame_view import FrameView
from .picture_demo import add_common_args, build_pipeline


def run_webcam(pipe, cap, view, clock: Optional[Callable[[], float]] = None
               ) -> Tuple[int, List[float]]:
    """The JAX demo's loop: read a frame (stop when there is none), run
    it, draw its people and ``f"{fps:.1f} FPS"`` at (10, 30) in green,
    show it, stop once the view asks.  `clock` (default
    ``time.perf_counter``) is read before the first frame and after each
    drawing; fps is one over the time since the last reading.  Releases
    `cap` and closes `view` however the loop ends.  -> (frames shown,
    each frame's seconds)."""
    from ..utils.draw import draw_people, put_text

    clock = clock or time.perf_counter
    times: List[float] = []
    try:
        last = clock()
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            people, _heat, _paf, meta = pipe.run(frame)
            out = draw_people(frame, people, meta)
            now = clock()
            fps = 1.0 / max(now - last, 1e-9)
            times.append(now - last)
            last = now
            put_text(out, f"{fps:.1f} FPS", (10, 30), (0, 255, 0), 2)
            if view.show(out):
                break
    finally:
        try:
            cap.release()
        finally:
            view.close()
    return len(times), times


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--camera", type=int, default=0,
                        help="read /dev/video<camera>")
    parser.add_argument("--view-host", default="127.0.0.1",
                        help="address of the browser view")
    parser.add_argument("--view-port", type=int, default=8090,
                        help="port of the browser view (0: any free one)")
    args = parser.parse_args()

    pipe = build_pipeline(args)
    cap = open_camera(args.camera)
    try:
        view = FrameView(args.view_host, args.view_port)
    except BaseException:
        cap.release()
        raise
    print(f"camera {args.camera}: {cap.fourcc} {cap.width}x{cap.height}; "
          f"view at {view.url} (q on the page quits)", flush=True)
    n, times = run_webcam(pipe, cap, view)
    print(f"showed {n} frames")
    return n, times


if __name__ == "__main__":
    main()
