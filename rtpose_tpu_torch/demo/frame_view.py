"""The webcam demo's window, ``cv2.imshow`` with ``cv2.waitKey(1)``, as a
page in a browser: a headless machine with a card has no display, and a
browser reaches this one over an SSH tunnel.

    GET /        a page that shows /stream; the q key there fetches /quit
    GET /stream  the frames as multipart/x-mixed-replace JPEGs
                 (``data.imwrite.encode_bgr``, cv2's quality 95), each
                 new frame once
    GET /quit    asks the demo's loop to stop (``waitKey`` seeing q)

:meth:`FrameView.show` keeps a copy of the newest frame and returns
whether quit was asked; it never waits on a client.  Each stream encodes
the newest frame when it is ready for one, so a slow browser skips frames
as a slow window does, and one encoding serves every stream.
"""

from __future__ import annotations

import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from ..data.imwrite import encode_bgr

BOUNDARY = "frame"
PAGE = b"""<!doctype html>
<title>rtpose webcam</title>
<body style="margin:0;background:#000">
<img src="/stream" alt="webcam">
<script>
document.addEventListener("keydown", function (e) {
  if (e.key === "q") fetch("/quit");
});
</script>
</body>
"""


class FrameView:
    """An HTTP server in a thread on (`host`, `port`; 0 picks a free
    port).  Raises RuntimeError when the port cannot be bound."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8090):
        self._cond = threading.Condition()
        self._frame: Optional[np.ndarray] = None
        self._seq = 0
        self._encoded: Tuple[int, bytes] = (0, b"")
        self._closed = False
        self._quit = threading.Event()
        self._streams: set = set()
        view = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):     # no line per request
                pass

            def do_GET(self):
                if self.path == "/":
                    self._answer(PAGE, "text/html; charset=utf-8")
                elif self.path == "/stream":
                    view._stream(self)
                elif self.path == "/quit":
                    view._quit.set()
                    self._answer(b"quit\n", "text/plain")
                else:
                    self.send_error(404)

            def _answer(self, body: bytes, kind: str):
                self.send_response(200)
                self.send_header("Content-Type", kind)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        try:
            self.server = ThreadingHTTPServer((host, port), Handler)
        except OSError as e:
            raise RuntimeError(f"cannot serve the view on {host}:{port}: "
                               f"{e.strerror or e}") from None
        self.server.daemon_threads = True
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}/"

    @property
    def quit_requested(self) -> bool:
        return self._quit.is_set()

    def show(self, frame: np.ndarray) -> bool:
        """Offer `frame` ((H, W, 3) uint8 BGR) to the streams; True once
        /quit was asked."""
        frame = frame.copy()
        with self._cond:
            self._frame = frame
            self._seq += 1
            self._cond.notify_all()
        return self._quit.is_set()

    def _next(self, seen: int) -> Optional[Tuple[int, bytes]]:
        """The newest frame after `seen`, encoded once for every stream;
        None once the view is closed."""
        with self._cond:
            self._cond.wait_for(lambda: self._closed or self._seq > seen)
            if self._closed:
                return None
            seq, frame = self._seq, self._frame
            if self._encoded[0] == seq:
                return self._encoded
        jpeg = encode_bgr(frame, ".jpg")
        with self._cond:
            if self._encoded[0] < seq:
                self._encoded = (seq, jpeg)
        return seq, jpeg

    def _stream(self, handler: BaseHTTPRequestHandler) -> None:
        conn = handler.connection
        with self._cond:
            if self._closed:
                return
            self._streams.add(conn)
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "multipart/x-mixed-replace; "
                                f"boundary={BOUNDARY}")
            handler.send_header("Cache-Control", "no-cache")
            handler.end_headers()
            seen = 0
            while True:
                item = self._next(seen)
                if item is None:
                    return
                seen, jpeg = item
                handler.wfile.write(
                    f"--{BOUNDARY}\r\nContent-Type: image/jpeg\r\n"
                    f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                    + jpeg + b"\r\n")
                handler.wfile.flush()
        except OSError:
            return          # the client went away, or close() cut it off
        finally:
            with self._cond:
                self._streams.discard(conn)
            handler.close_connection = True

    def close(self) -> None:
        """Stop the server and end every stream, also one blocked on a
        client that stopped reading; a second call does nothing."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
            streams = list(self._streams)
        for conn in streams:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass        # already closed by its client
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=10)
