"""The port's front-ends against the JAX package's, on the CPU:

- ``data.imread.decode_bgr`` against ``cv2.imdecode(..., IMREAD_COLOR)``
  on the committed fixture JPEGs (EXIF orientations 3, 6, 8, gray,
  progressive, 4:2:0, 4:4:4) and a PNG: pixel for pixel (cv2 applies the
  EXIF orientation in ``imdecode`` as in ``imread``); None for bytes that
  are not an image;
- ``data.imwrite.write_bgr`` against ``cv2.imwrite``, decoded: PNG, BMP
  and JPEG (quality 95, 4:2:0) pixel for pixel (bound 0);
- ``utils.draw`` against cv2 and the JAX ``draw_people``: every pixel
  equal (bound 0) on seeded random skeletons with parts on the frame's
  edge and outside it, with and without ``meta``, and on random thick
  lines and circles far outside the frame;
- the HTTP service over oracle-map stubs against the JAX service on the
  same JPEG bytes: people count, part names, ``size`` and ``truncated``
  equal, pixel coordinates within 1e-4 px, scores within 1e-5, one
  request at a time and 4 concurrent mixed-shape requests (the port's
  largest ``run_batch`` group above 1); a tiny VGG19 with the same
  weights on both sides; 400, 404, ``/healthz``; an error answers every
  request of its group and hangs none;
- the picture demo's ``main()`` writes the JAX drawing of its people and
  prints "found";
- ``utils.profiling``.

Everything runs in-process at ``--device cpu --stages 1 --input-size 56
--fp32`` (no subprocess), torch on two threads.
"""

import http.client
import json
import os
import sys
import threading

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu.demo import serve_http as jserve_http
from rtpose_tpu.infer import pipeline as jpipeline
from rtpose_tpu.models import get_model as jax_get_model
from rtpose_tpu.utils.draw import draw_people as jdraw_people
from rtpose_tpu_torch.data import imread_fixtures as fx
from rtpose_tpu_torch.data.imread import decode_bgr
from rtpose_tpu_torch.data.imwrite import write_bgr
from rtpose_tpu_torch.demo import picture_demo, serve_http
from rtpose_tpu_torch.infer.pipeline import PosePipeline, load_pipeline
from rtpose_tpu_torch.skeleton import PART_NAMES
from rtpose_tpu_torch.utils import profiling
from rtpose_tpu_torch.utils.draw import cv_circle, cv_line, draw_people
from rtpose_tpu_torch.utils.synth_coco import (OracleMaps, oracle_maps,
                                               spread_people)

from test_torch_evalx import JaxOracle
from test_torch_zoo import seeded_variables

KP_TOL = 1e-4              # pixel coordinates in the JSON, px
SCORE_TOL = 1e-5           # part and person scores in the JSON
SIZE = 128                 # oracle pipelines' input size
CLI = ["--device", "cpu", "--stages", "1", "--input-size", "56", "--fp32"]


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _jpeg(rgb: np.ndarray) -> bytes:
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=90)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# bytes decoding and image writing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(fx.FIXTURES) + ["png"])
def test_decode_bgr_equals_cv2_imdecode(tmp_path, name):
    if name == "png":
        path = str(tmp_path / "frame.png")
        cv2.imwrite(path, fx.render_scene(7))
    else:
        path = os.path.join(fx.FIXTURE_DIR, f"{name}.jpg")
    data = open(path, "rb").read()
    got = decode_bgr(data)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # imdecode turns the frame as imread does
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("data", [b"not an image", b"\xff\xd8\xff",
                                  b"\x89PNG\r\n\x1a\n"])
def test_decode_bgr_refuses_what_cv2_refuses(data):
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is None
    assert decode_bgr(data) is None
    assert decode_bgr(b"") is None


@pytest.mark.parametrize("ext", [".png", ".bmp", ".jpg", ".jpeg"])
@pytest.mark.parametrize("kind", ["scene", "noise", "gray"])
def test_write_bgr_equals_cv2_imwrite(tmp_path, ext, kind):
    rng = np.random.RandomState(0)
    img = {"scene": np.ascontiguousarray(fx.render_scene(3, 97, 131)),
           "noise": rng.randint(0, 256, (45, 61, 3), np.uint8),
           "gray": rng.randint(0, 256, (33, 17), np.uint8)}[kind]
    ours, theirs = str(tmp_path / f"port{ext}"), str(tmp_path / f"cv2{ext}")
    write_bgr(ours, img)
    assert cv2.imwrite(theirs, img)
    got = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    want = cv2.imread(theirs, cv2.IMREAD_UNCHANGED)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if ext in (".png", ".bmp"):
        np.testing.assert_array_equal(got, img)


def test_write_bgr_rejects_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="no image writer"):
        write_bgr(str(tmp_path / "a.gif"), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        write_bgr(str(tmp_path / "a.png"), np.zeros((4, 4, 3), np.float32))


# ---------------------------------------------------------------------------
# drawing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_cv_primitives_equal_cv2(seed):
    """Thick lines and circles of every kind the two calls can take, ends
    inside, on the edge and far outside the frame: equal to cv2."""
    rng = np.random.RandomState(seed)
    for trial in range(300):
        h, w = rng.randint(1, 90, 2)
        want = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        got = want.copy()
        span = int(rng.choice([10, 100, 1000, 40000]))
        p1 = tuple(int(v) for v in rng.randint(-span, span, 2))
        p2 = tuple(int(v) for v in rng.randint(-span, span, 2))
        th, r = int(rng.randint(2, 9)), int(rng.randint(0, 30))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        if trial % 2:
            cv2.line(want, p1, p2, color, th)
            cv_line(got, p1, p2, color, th)
        else:
            cv2.circle(want, p1, r, color, thickness=th, lineType=8)
            cv_circle(got, p1, r, color, th)
        np.testing.assert_array_equal(got, want, err_msg=str(
            (trial, (h, w), p1, p2, th, r)))


def _random_people(rng, n):
    """n people of random parts in normalised coordinates, some on the
    frame's edges (0 and 1) and some outside it."""
    people = []
    for _ in range(n):
        parts = {}
        for part in rng.choice(18, rng.randint(1, 19), replace=False):
            x, y = rng.uniform(-0.2, 1.2, 2)
            if rng.rand() < 0.2:
                x = float(rng.choice([0.0, 1.0]))
            parts[int(part)] = (float(x), float(y), float(rng.rand()))
        people.append({"parts": parts, "score": float(rng.rand())})
    return people


@pytest.mark.parametrize("seed", range(6))
def test_draw_people_equals_jax(seed):
    rng = np.random.RandomState(seed)
    for trial in range(8):
        h, w = rng.randint(20, 160, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        people = _random_people(rng, rng.randint(0, 5))
        meta = None if trial % 2 else {
            "upsampled": (int(h * 1.3), int(w * 1.3)), "scale": 1.3}
        got = draw_people(img, people, meta)
        want = jdraw_people(img, people, meta)
        np.testing.assert_array_equal(got, want)


def test_draw_people_returns_a_copy():
    img = np.zeros((40, 40, 3), np.uint8)
    people = [{"parts": {1: (0.5, 0.5, 1.0), 2: (0.2, 0.7, 1.0)},
               "score": 1.0}]
    out = draw_people(img, people)
    assert not img.any() and out.any()
    with pytest.raises(ValueError, match="thick"):
        cv_line(out, (0, 0), (5, 5), (1, 2, 3), 1)


# ---------------------------------------------------------------------------
# the HTTP service
# ---------------------------------------------------------------------------

SHAPES = ((128, 160), (128, 170))


@pytest.fixture(scope="module")
def oracle():
    """Oracle maps of one person at 128x160 and two at 128x170, JPEG bytes
    of rendered frames of both shapes, and the two pipelines over the
    maps."""
    rng = np.random.RandomState(0)
    scenes = {SHAPES[0]: spread_people(rng, 1, *SHAPES[0]),
              SHAPES[1]: spread_people(rng, 2, *SHAPES[1])}
    maps = oracle_maps(scenes, SIZE)
    bodies = {shape: _jpeg(fx.render_scene(i, *shape))
              for i, shape in enumerate(SHAPES)}
    jpipe = jpipeline.PosePipeline(JaxOracle(maps), {}, input_size=SIZE,
                                   flip=False, device_resize=True)
    tpipe = PosePipeline(OracleMaps(maps), device="cpu", input_size=SIZE,
                         flip=False)
    return bodies, jpipe, tpipe


class Server:
    """A service in a thread: ``serve`` of one module over a pipeline."""

    def __init__(self, module, pipe, **kwargs):
        self.server = module.serve(pipe, host="127.0.0.1", port=0, **kwargs)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=120)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def concurrent(self, bodies):
        out = [None] * len(bodies)

        def post(i):
            out[i] = self.request("POST", "/pose", bodies[i])

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a request hung"
        return out

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def _answers_equal(got, want):
    """Two services' JSON answers: the same people with the same part
    names, size and truncation; coordinates within KP_TOL px, scores
    within SCORE_TOL."""
    assert got["size"] == want["size"]
    assert got["truncated"] == want["truncated"]
    assert len(got["people"]) == len(want["people"])
    for a, b in zip(got["people"], want["people"]):
        assert abs(a["score"] - b["score"]) <= SCORE_TOL
        assert sorted(a["parts"]) == sorted(b["parts"])
        for name, (x, y, s) in a["parts"].items():
            bx, by, bs = b["parts"][name]
            assert abs(x - bx) <= KP_TOL and abs(y - by) <= KP_TOL, name
            assert abs(s - bs) <= SCORE_TOL, name
    return len(got["people"])


def test_http_answers_equal_the_jax_service(oracle):
    bodies, jpipe, tpipe = oracle
    ours, theirs = Server(serve_http, tpipe), Server(jserve_http, jpipe)
    try:
        for shape, n in zip(SHAPES, (1, 2)):
            got = ours.request("POST", "/pose", bodies[shape])
            want = theirs.request("POST", "/pose", bodies[shape])
            assert got[0] == want[0] == 200
            assert got[1]["size"] == list(shape)
            assert _answers_equal(got[1], want[1]) == n
            for person in got[1]["people"]:
                assert set(person["parts"]) <= set(PART_NAMES)
                assert len(person["parts"]) == 18
    finally:
        ours.close()
        theirs.close()


def test_http_micro_batch_equals_the_jax_service(oracle):
    """Four concurrent mixed-shape requests: one port ``run_batch`` group
    holds more than one of them, and every answer equals the JAX
    service's to the same bytes."""
    bodies, jpipe, tpipe = oracle
    order = [SHAPES[0], SHAPES[1], SHAPES[0], SHAPES[1]]
    posts = [bodies[s] for s in order]
    groups = []
    orig = tpipe.run_batch
    tpipe.run_batch = lambda frames: (groups.append(len(frames)),
                                      orig(frames))[1]
    ours = Server(serve_http, tpipe, max_batch=4, batch_window_ms=3000.0)
    theirs = Server(jserve_http, jpipe, max_batch=4, batch_window_ms=3000.0)
    try:
        got, want = ours.concurrent(posts), theirs.concurrent(posts)
    finally:
        del tpipe.run_batch
        ours.close()
        theirs.close()
    assert max(groups) > 1, groups
    for (gs, g), (ws, w), shape in zip(got, want, order):
        assert gs == ws == 200
        assert g["size"] == list(shape)
        assert _answers_equal(g, w) == (1 if shape == SHAPES[0] else 2)


def test_http_status_codes(oracle):
    _, _, tpipe = oracle
    ours = Server(serve_http, tpipe)
    try:
        assert ours.request("GET", "/healthz") == (200, {"ok": True})
        assert ours.request("GET", "/pose")[0] == 404
        assert ours.request("POST", "/other", b"x")[0] == 404
        assert ours.request("POST", "/pose", b"not an image") == (
            400, {"error": "could not decode image"})
    finally:
        ours.close()


class _Raises:
    """A pipeline whose ``run_batch`` raises; ``keypoints_pixels`` is never
    reached."""

    def run_batch(self, frames):
        raise RuntimeError(f"card fell over on {len(frames)} frames")


def test_http_error_answers_every_request_of_its_group(oracle):
    bodies, _, _ = oracle
    ours = Server(serve_http, _Raises(), max_batch=3,
                  batch_window_ms=3000.0)
    try:
        answers = ours.concurrent([bodies[SHAPES[0]]] * 3)
        assert answers == [(500, {"error": "RuntimeError: card fell over "
                                           "on 3 frames"})] * 3
        # the dispatcher lives on: the next request is answered too
        assert ours.request("POST", "/pose", bodies[SHAPES[1]])[0] == 500
    finally:
        ours.close()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_batcher_fails_pending_requests_when_its_thread_stops():
    """Should the dispatcher thread end, queued and later requests raise
    instead of waiting for it."""
    gate = threading.Event()

    class Stops:
        def run_batch(self, frames):
            gate.wait(10)
            raise SystemExit("stopped")

    batcher = serve_http._Batcher(Stops(), max_batch=1, window_s=0.0)
    results = []

    def call():
        try:
            batcher.infer(np.zeros((4, 4, 3), np.uint8))
        except BaseException as e:  # noqa: BLE001 - recorded for the test
            results.append(type(e).__name__)

    threads = [threading.Thread(target=call) for _ in range(3)]
    for t in threads:
        t.start()
    while batcher.q.qsize() < 2:
        threading.Event().wait(0.01)
    gate.set()
    for t in threads + [batcher._thread]:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads + [batcher._thread])
    assert sorted(results) == ["RuntimeError", "RuntimeError", "SystemExit"]
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.infer(np.zeros((4, 4, 3), np.uint8))


def test_http_same_weights_equal_json():
    """A tiny VGG19 with the same weights on both sides, through
    ``state_dict_from_flax``, answers the same frames with the same
    JSON."""
    jmodel = jax_get_model("vgg19", num_stages=1, dtype=jnp.float32)
    variables = seeded_variables(jmodel, "vgg19", (56, 56), seed=1)
    jpipe = jpipeline.PosePipeline(jmodel, jax.tree_util.tree_map(
        jnp.asarray, variables), input_size=56, flip=True,
        device_resize=True)
    tpipe = load_pipeline(device="cpu", num_stages=1, input_size=56,
                          dtype=torch.float32, flax_params=variables,
                          device_resize=True)
    rng = np.random.RandomState(3)
    frames = [_jpeg(rng.randint(0, 256, (48, 64, 3), np.uint8)),
              _jpeg(fx.render_scene(5, 56, 40))]
    ours, theirs = Server(serve_http, tpipe), Server(jserve_http, jpipe)
    try:
        for body in frames:
            got = ours.request("POST", "/pose", body)
            want = theirs.request("POST", "/pose", body)
            assert got[0] == want[0] == 200
            _answers_equal(got[1], want[1])
    finally:
        ours.close()
        theirs.close()


# ---------------------------------------------------------------------------
# the picture demo
# ---------------------------------------------------------------------------

def test_picture_demo_main(tmp_path, monkeypatch, capsys):
    """``main()`` on a tiny seeded VGG19: it writes the frame and prints
    'found' and 'wrote'."""
    frame = np.ascontiguousarray(fx.render_scene(2, 60, 80))
    image, out = str(tmp_path / "in.jpg"), str(tmp_path / "out.png")
    write_bgr(image, frame)
    monkeypatch.setattr(sys, "argv", ["picture_demo", "--image", image,
                                      "--output", out] + CLI)
    picture_demo.main()
    printed = capsys.readouterr().out
    assert "found" in printed and f"wrote {out}" in printed
    assert cv2.imread(out).shape == (60, 80, 3)


def test_picture_demo_draws_the_jax_drawing(oracle, tmp_path, monkeypatch,
                                            capsys):
    """On oracle maps the demo finds the two people, prints each one's
    score and parts, and writes the JAX package's drawing of them."""
    _, _, tpipe = oracle
    image, out = str(tmp_path / "in.jpg"), str(tmp_path / "out.png")
    frame = np.ascontiguousarray(fx.render_scene(1, *SHAPES[1]))
    write_bgr(image, frame)
    monkeypatch.setattr(picture_demo, "build_pipeline", lambda args: tpipe)
    monkeypatch.setattr(sys, "argv", ["picture_demo", "--image", image,
                                      "--output", out] + CLI)
    picture_demo.main()
    printed = capsys.readouterr().out
    assert "found 2 people" in printed and printed.count("score=") == 2
    people, _, _, meta = tpipe.run(cv2.imread(image))
    want = jdraw_people(cv2.imread(image), people, meta)
    np.testing.assert_array_equal(cv2.imread(out), want)


def test_demos_need_the_card_by_default(tmp_path, monkeypatch):
    """Without ``--device`` the demos run on the card, and raise where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    image = str(tmp_path / "in.png")
    write_bgr(image, np.zeros((20, 20, 3), np.uint8))
    monkeypatch.setattr(sys, "argv", ["picture_demo", "--image", image,
                                      "--stages", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        picture_demo.main()


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_profiling_trace_annotate_and_sections(tmp_path):
    timer = profiling.SectionTimer(device="cpu")
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("port_section"), timer.section("matmul"):
            torch.ones(32, 32) @ torch.ones(32, 32)
        with timer.section("matmul"):
            torch.ones(8, 8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "port_section" in names
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert any(e.get("name") == "port_section"
               for e in trace["traceEvents"])
    summary = timer.summary()
    assert summary["matmul"]["count"] == 2
    assert summary["matmul"]["total_s"] > 0
