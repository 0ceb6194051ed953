"""HTTP pose-estimation service with request micro-batching (port of
rtpose_tpu/demo/serve_http.py).

POST an image (jpeg/png bytes) to /pose and get keypoints JSON back:

    python -m rtpose_tpu_torch.demo.serve_http --port 8080 --weight ckpt.pth
    curl --data-binary @ski.jpg localhost:8080/pose

Response: {"people": [{"score": s, "parts": {"nose": [x, y, score], ...}}],
"size": [h, w], "truncated": bool} with pixel coordinates in the original
image frame; 400 for bytes that are not an image, 404 for another path,
500 with the exception's name when the pipeline raises.

Concurrent requests are micro-batched: a dispatcher thread drains the
request queue (waiting up to --batch-window ms for stragglers) and runs
the whole group through ``PosePipeline.run_batch``, one batch per frame
shape, all enqueued on the card before any readback.  --batch-window 0
degenerates to strict one-request-per-dispatch.

Every call on the card is made by the one dispatcher thread; the
handler threads only decode the posted bytes (Pillow releases the GIL
while it decodes) and format the answer.  Runs on the card (``--device
cuda``, the default); ``--device cpu`` for tests.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..data.imread import decode_bgr
from ..skeleton import PART_NAMES


class _Batcher:
    """Queue + dispatcher thread turning concurrent requests into
    ``run_batch`` groups (per-shape sub-batches handled inside the
    pipeline's mixed-shape path).

    A group whose ``run_batch`` raises answers every request of the group
    with that error.  Should the dispatcher itself stop, every request
    still queued, and every later one, is answered with an error: no
    request waits for a thread that is gone."""

    def __init__(self, pipeline, max_batch: int = 16,
                 window_s: float = 0.005):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.window_s = window_s
        self.q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._stopped: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def infer(self, img):
        """Blocking call from a handler thread; returns (people, meta)."""
        done = threading.Event()
        slot = {}
        with self._lock:
            if self._stopped is not None:
                raise RuntimeError("the dispatcher thread has stopped") \
                    from self._stopped
            self.q.put((img, slot, done))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["people"], slot["meta"]

    def _drain(self):
        first = self.q.get()
        group = [first]
        if self.window_s > 0:
            t_end = time.monotonic() + self.window_s
            while len(group) < self.max_batch:
                try:
                    group.append(self.q.get(
                        timeout=max(0.0, t_end - time.monotonic())))
                except queue.Empty:
                    break
        else:
            while len(group) < self.max_batch:
                try:
                    group.append(self.q.get_nowait())
                except queue.Empty:
                    break
        return group

    @staticmethod
    def _fail(group, error: BaseException) -> None:
        for _, slot, done in group:
            if not done.is_set():
                slot["error"] = error
                done.set()

    def _run(self, group) -> None:
        try:
            people_lists, metas = self.pipeline.run_batch(
                [img for img, _, _ in group])
        except Exception as e:  # noqa: BLE001 - answered per request
            self._fail(group, e)
            return
        except BaseException as e:
            self._fail(group, e)
            raise
        for (_, slot, done), people, meta in zip(group, people_lists, metas):
            slot["people"] = people
            slot["meta"] = meta
            done.set()

    def _loop(self):
        stopped: BaseException = RuntimeError("dispatcher stopped")
        try:
            while True:
                self._run(self._drain())
        except BaseException as e:
            stopped = e
            raise
        finally:
            with self._lock:
                self._stopped = stopped
                pending = []
                while True:
                    try:
                        pending.append(self.q.get_nowait())
                    except queue.Empty:
                        break
            self._fail(pending, RuntimeError(
                f"the dispatcher thread stopped: {stopped!r}"))


def make_handler(pipeline, batcher):

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            else:
                self._reply(404, {"error": "POST an image to /pose"})

        def do_POST(self):
            if self.path != "/pose":
                self._reply(404, {"error": "unknown endpoint"})
                return
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            img = decode_bgr(data)
            if img is None:
                self._reply(400, {"error": "could not decode image"})
                return
            try:
                people, meta = batcher.infer(img)
            except Exception as e:  # noqa: BLE001 - surface to the client
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            pix = pipeline.keypoints_pixels(people, meta)
            out = [{
                "score": person["score"],
                "parts": {PART_NAMES[part]: [x, y, s]
                          for part, (x, y, s) in person["parts"].items()},
            } for person in pix]
            self._reply(200, {"people": out,
                              "size": [img.shape[0], img.shape[1]],
                              "truncated": bool(meta.get("truncated"))})

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: the connections of a
    # larger burst are dropped and their clients retry a second later
    request_queue_size = 128


def serve(pipeline, host: str = "0.0.0.0", port: int = 8080,
          max_batch: int = 16, batch_window_ms: float = 5.0):
    batcher = _Batcher(pipeline, max_batch=max_batch,
                       window_s=batch_window_ms / 1000.0)
    server = _Server((host, port), make_handler(pipeline, batcher))
    print(f"serving pose estimation on {host}:{port} (POST /pose; "
          f"micro-batch up to {max_batch} per {batch_window_ms:.0f} ms "
          f"window)")
    return server


def main():
    from .picture_demo import add_common_args, build_pipeline

    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max-batch", type=int, default=16,
                        help="micro-batch cap per dispatch")
    parser.add_argument("--batch-window", type=float, default=5.0,
                        help="ms to wait for straggler requests before "
                             "dispatching (0 = no batching wait)")
    args = parser.parse_args()
    pipeline = build_pipeline(args)
    serve(pipeline, args.host, args.port, max_batch=args.max_batch,
          batch_window_ms=args.batch_window).serve_forever()


if __name__ == "__main__":
    main()
