"""COCO validation harness: model -> results JSON -> OKS stats (port of
rtpose_tpu/evalx/harness.py).

The analogue of reference evaluate/coco_eval.py:245-283 (run_eval) with
flip TTA fused into the forward on the card (see infer/pipeline.py) and
the native OKS evaluator (evalx/cocoeval.py) instead of pycocotools.
Frames are read by :func:`..data.imread.read_bgr`, which gives
``cv2.imread``'s frame without cv2.  With ``vis_dir``, each frame's
people are drawn (:func:`..utils.draw.draw_people`) and the drawing is
written under the frame's ``file_name`` (:func:`..data.imwrite.write_bgr`),
cv2's pixels without cv2.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..data.coco_json import CocoJson
from ..data.imread import read_bgr
from ..data.imwrite import write_bgr
from ..infer.pipeline import PosePipeline
from ..skeleton import NUM_PARTS, ORDER_COCO
from ..utils.draw import draw_people
from .cocoeval import evaluate_keypoints


def person_to_coco_keypoints(person: Dict[str, Any],
                             upsample_keypoints) -> np.ndarray:
    """Map one decoded person to the 17-keypoint COCO layout.

    Pixel convention x = x_norm * (W_up / scale) + 0.5 and the 18->17
    reorder (reference evaluate/coco_eval.py:117-154).
    upsample_keypoints: (H_up/scale, W_up/scale).
    """
    kps = np.zeros((NUM_PARTS, 3))
    for part, (xn, yn, _score) in person["parts"].items():
        kps[part, 0] = xn * upsample_keypoints[1] + 0.5
        kps[part, 1] = yn * upsample_keypoints[0] + 0.5
        kps[part, 2] = 1
    return kps[list(ORDER_COCO), :]


def append_result(image_id: int, people: List[Dict[str, Any]],
                  upsample_keypoints, outputs: List[dict],
                  score_mode: str = "parity") -> None:
    """Append COCO result dicts (reference coco_eval.py:117-154).

    score_mode "parity" fixes score=1.0 like the reference
    (coco_eval.py:151) — COCOeval then has no ranking, so any phantom
    partial person costs precision at every threshold.  score_mode
    "person" emits the assembled person's accumulated connection score,
    letting COCOeval rank real people above phantoms — strictly better
    mAP, off by default only to keep results-JSON parity.
    """
    for person in people:
        kps = person_to_coco_keypoints(person, upsample_keypoints)
        outputs.append({
            "image_id": image_id,
            "category_id": 1,
            "keypoints": [float(v) for v in kps.reshape(51)],
            "score": (float(person["score"]) if score_mode == "person"
                      else 1.0),
        })


def _image_ids(coco: CocoJson, img_ids, limit):
    if img_ids is None:
        img_ids = coco.img_ids(coco.cat_ids("person"))
    return list(img_ids)[:limit] if limit else list(img_ids)


def run_eval(image_dir: str, ann_file: str, pipeline: PosePipeline, *,
             vis_dir: Optional[str] = None,
             img_ids: Optional[Sequence[int]] = None,
             limit: Optional[int] = None,
             results_path: Optional[str] = None,
             score_mode: str = "parity",
             scales: Optional[Sequence[float]] = None) -> Dict[str, float]:
    """Evaluate on COCO val images, one frame at a time; returns the stats
    dict (stats['AP'] is the headline mAP).

    ``scales``: multi-scale TTA factors (e.g. ``(0.5, 1.0, 1.5, 2.0)``) —
    routes each image through :meth:`PosePipeline.run_multiscale`.  None =
    single scale (flip TTA still applies per the pipeline's flip
    setting)."""
    coco = CocoJson(ann_file)
    img_ids = _image_ids(coco, img_ids, limit)
    if vis_dir:
        os.makedirs(vis_dir, exist_ok=True)

    outputs: List[dict] = []
    n_retried = n_truncated = 0
    for i, img_id in enumerate(img_ids):
        info = coco.image_info(img_id)
        img = read_bgr(os.path.join(image_dir, info["file_name"]))
        if scales:
            people, _heat, _paf, meta = pipeline.run_multiscale(
                img, tuple(scales))
        else:
            people, _heat, _paf, meta = pipeline.run(img)
        n_retried += bool(meta.get("retried"))
        n_truncated += bool(meta["truncated"])
        h_up, w_up = meta["upsampled"]
        scale = meta["scale"]
        upsample_keypoints = (h_up / scale, w_up / scale)
        append_result(img_id, people, upsample_keypoints, outputs,
                      score_mode=score_mode)
        if vis_dir:
            write_bgr(os.path.join(vis_dir, info["file_name"]),
                      draw_people(img, people, meta))
        if i % 50 == 0 and i:
            print(f"processed {i}/{len(img_ids)} images")

    if results_path:
        with open(results_path, "w") as f:
            json.dump(outputs, f)
    stats = eval_results(outputs, coco, img_ids)
    return _attach_truncation_stats(stats, n_retried, n_truncated)


def _attach_truncation_stats(stats, n_retried, n_truncated):
    """Surface the crowded-frame retry outcome (frames decoded again at the
    raised caps; frames STILL truncated afterwards — those may drop people
    vs the reference's unbounded lists, pafprocess.cpp:24-43)."""
    stats["frames_retried"] = n_retried
    stats["frames_truncated"] = n_truncated
    if n_truncated:
        print(f"WARNING: {n_truncated} frame(s) still overflow the raised "
              f"decode caps; results may drop people on those frames "
              f"(raise PosePipeline retry_caps)")
    return stats


def run_eval_batched(image_dir: str, ann_file: str, pipeline: PosePipeline,
                     *, batch_size: int = 16,
                     vis_dir: Optional[str] = None,
                     img_ids: Optional[Sequence[int]] = None,
                     limit: Optional[int] = None,
                     results_path: Optional[str] = None,
                     score_mode: str = "parity",
                     pad_partial: bool = True,
                     scales: Optional[Sequence[float]] = None
                     ) -> Dict[str, float]:
    """Throughput-oriented eval: bucket images by padded shape, run the
    pipeline on batches within each bucket, decode on the card in batch.

    Inside a bucket, :meth:`PosePipeline.run_batch_submit` runs one
    sub-batch per raw frame shape (the frames are resized on the card), as
    the JAX harness does over ``PosePipeline(..., device_resize=True)``.

    `scales`: optional multi-scale TTA factors — batches then run
    :meth:`PosePipeline.run_multiscale_batch_submit` and images are
    bucketed by the TUPLE of their per-scale padded shapes (the JAX
    harness's key).
    """
    coco = CocoJson(ann_file)
    img_ids = _image_ids(coco, img_ids, limit)
    if vis_dir:
        os.makedirs(vis_dir, exist_ok=True)

    # group by the padded shape the pipeline will produce — the SAME
    # arithmetic the pipeline uses (shared helper)
    from collections import defaultdict

    from ..infer.preprocess import scale_pad_geometry

    def bucket_key(h, w):
        _, _, _, ph, pw = scale_pad_geometry(
            h, w, pipeline.input_size, pipeline.pad_factor)
        if not scales:
            return (ph, pw)
        # multi-scale: one key per distinct tuple of per-scale padded
        # shapes (mirrors PosePipeline._scale_sizes size arithmetic)
        per_scale = tuple(
            scale_pad_geometry(
                h, w,
                max(pipeline.pad_factor,
                    int(round(pipeline.input_size * s))),
                pipeline.pad_factor)[3:5]
            for s in scales)
        return ((ph, pw),) + per_scale

    buckets = defaultdict(list)
    for img_id in img_ids:
        info = coco.image_info(img_id)
        buckets[bucket_key(info["height"], info["width"])].append(img_id)

    outputs: List[dict] = []
    done = 0
    n_retried = n_truncated = 0
    t_start = time.perf_counter()
    bucket_rows = []

    def drain(chunk, frames, ticket):
        nonlocal done, n_retried, n_truncated
        people_lists, metas = pipeline.run_batch_collect(ticket)
        for img_id, img, people, meta in zip(chunk, frames, people_lists,
                                             metas):
            n_retried += bool(meta.get("retried"))
            n_truncated += bool(meta["truncated"])
            h_up, w_up = meta["upsampled"]
            upk = (h_up / meta["scale"], w_up / meta["scale"])
            append_result(img_id, people, upk, outputs,
                          score_mode=score_mode)
            if vis_dir:
                write_bgr(os.path.join(
                    vis_dir, coco.image_info(img_id)["file_name"]),
                    draw_people(img, people, meta))
        done += len(chunk)

    import queue
    import threading

    def read_chunks(ids, q, stop, bs):
        """Decode-ahead producer: Pillow's decoder releases the GIL, so the
        next chunk decodes while the main thread waits on the previous
        chunk's readback.  `stop` lets a failing consumer unblock us —
        otherwise an exception on the card's side would leave this thread
        (and its decoded frames) parked forever on a full queue."""
        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=1.0)
                    return
                except queue.Full:
                    pass

        try:
            for i in range(0, len(ids), bs):
                if stop.is_set():
                    return
                chunk = ids[i:i + bs]
                frames = [
                    read_bgr(os.path.join(
                        image_dir, coco.image_info(img_id)["file_name"]))
                    for img_id in chunk]
                put((chunk, frames))
        except BaseException as e:  # noqa: BLE001 - re-raised by consumer
            put(e)
        finally:
            put(None)

    for shape, ids in sorted(buckets.items(),
                             key=lambda kv: -len(kv[1])):
        t_bucket = time.perf_counter()
        eff_bs = batch_size
        if scales:
            # device memory guard (pipeline.ms_chunk_cap): cap this
            # bucket's batch by its largest scaled shape BEFORE padding, so
            # an extreme-aspect tail bucket is never padded up to a chunk
            # the stacked multi-scale forward can't fit on the card
            max_px = max(h * w for h, w in shape[1:])
            eff_bs = max(1, min(batch_size, pipeline.ms_chunk_cap(max_px)))
        # depth-2 pipeline within a bucket: chunk k+1's read + upload +
        # forward overlap chunk k's readback + result conversion
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        t = threading.Thread(target=read_chunks, args=(ids, q, stop, eff_bs),
                             daemon=True)
        t.start()
        try:
            pending = None
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                chunk, frames = item
                if pad_partial and len(frames) < eff_bs:
                    # pad the remainder chunk to the full batch size by
                    # repeating the last frame, so every bucket runs one
                    # batch shape (the JAX harness's one compiled program);
                    # drain() zips results against the real `chunk` ids,
                    # so the pad frames' outputs fall off the end
                    frames = frames + [frames[-1]] * (eff_bs - len(frames))
                ticket = (pipeline.run_multiscale_batch_submit(
                              frames, tuple(scales)) if scales
                          else pipeline.run_batch_submit(frames))
                if pending is not None:
                    drain(*pending)
                pending = (chunk, frames, ticket)
            if pending is not None:
                drain(*pending)
        finally:
            stop.set()
        dt_bucket = time.perf_counter() - t_bucket
        bucket_rows.append((shape, len(ids), dt_bucket))
        print(f"bucket {shape}: {len(ids)} images in {dt_bucket:.1f}s "
              f"({done}/{len(img_ids)})")

    pipeline_s = time.perf_counter() - t_start
    if results_path:
        with open(results_path, "w") as f:
            json.dump(outputs, f)
    t_eval = time.perf_counter()
    stats = eval_results(outputs, coco, img_ids)
    # pipeline vs evaluator-tail split: pipeline_s covers read + upload +
    # forward + decode + readback over all buckets, evaluator_s the
    # host-side OKS scoring
    stats["pipeline_s"] = round(pipeline_s, 2)
    stats["evaluator_s"] = round(time.perf_counter() - t_eval, 2)
    stats["n_buckets"] = len(bucket_rows)
    # tail fragmentation signal: images in buckets smaller than one batch
    stats["images_in_sub_batch_buckets"] = sum(
        n for _, n, _ in bucket_rows if n < batch_size)
    return _attach_truncation_stats(stats, n_retried, n_truncated)


def eval_results(outputs: List[dict], coco: CocoJson,
                 img_ids: Sequence[int]) -> Dict[str, float]:
    """Score a results list against annotations (reference
    coco_eval.py:55-75)."""
    person_cats = coco.cat_ids("person")
    gt_by_image = {i: coco.annotations(i, person_cats) for i in img_ids}
    dt_by_image: Dict[int, List[dict]] = {}
    for r in outputs:
        dt_by_image.setdefault(r["image_id"], []).append(r)
    return evaluate_keypoints(gt_by_image, dt_by_image, img_ids)
