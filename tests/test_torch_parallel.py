"""The port's parallel paths (``rtpose_tpu_torch/parallel/``) against the
JAX package's, on the CPU, at the JAX tests' scale (1-2 stages, 56-64 px,
batch 8).

Ranks are real processes joined in a gloo process group
(``parallel.distributed.spawn``); each set of ranks runs a list of jobs
(``tests/util_parallel.py``), once per module.  Held:

- ``param_spec``, ``host_shard`` and ``merge_result_files`` equal the JAX
  package's on a table of shapes and splits;
- data-parallel training at world 2 and 4 equals the port's one process
  on the whole batch: losses within atol 1e-6, parameters within 1e-5;
  at world 2 it is within rel 1e-4 (loss) and atol 1e-5 / rtol 1e-3
  (parameters) of the JAX ``Trainer`` on its 8-device mesh through the
  freeze and release, the clip and gradient accumulation (the tolerances
  of tests/test_torch_train.py);
- a BatchNorm family (atrous_cpm) under DP2 keeps the JAX mesh trainer's
  global-batch statistics, and per-rank statistics would not;
- DP2 x TP2 equals DP4 (tests/test_tensor_parallel.py's DP4 x TP2 ==
  DP8 at a size four processes run) with convs sharded by ``param_spec``;
  a gather whose backward sums is caught; a gathered checkpoint loads
  into an unsharded pipeline and a sharded trainer;
- ``PosePipeline(mesh=)`` on ``["cpu", "cpu"]`` gives the unsharded
  pipeline's people and JAX's mesh pipeline's, for 8 frames, a ragged 5
  and multi-scale on 6 (tests/test_pipeline_sharded.py's cases);
- the multi-process eval merge equals one process; the eval CLI's
  ``--data-parallel``; the loaders' rank slices concatenate to the single
  loader's batches element for element.
"""

import concurrent.futures
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu import config as jconfig
from rtpose_tpu.infer.pipeline import PosePipeline as JPosePipeline
from rtpose_tpu.models import get_model as jax_get_model
from rtpose_tpu.parallel import distributed as jdist
from rtpose_tpu.parallel import mesh as jmesh
from rtpose_tpu.parallel.sharding import param_spec as jparam_spec
from rtpose_tpu.train.trainer import Trainer as JTrainer
from rtpose_tpu_torch.data.dataset import CocoKeypoints, Loader
from rtpose_tpu_torch.evalx.cocoeval import evaluate_keypoints
from rtpose_tpu_torch.evalx.harness import run_eval_batched
from rtpose_tpu_torch.infer.pipeline import PosePipeline
from rtpose_tpu_torch.models import get_model
from rtpose_tpu_torch.models.convert import load_strict, state_dict_from_flax
from rtpose_tpu_torch.parallel import distributed as tdist
from rtpose_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
from rtpose_tpu_torch.parallel.sharding import param_spec
from rtpose_tpu_torch.train.trainer import Trainer
from rtpose_tpu_torch.utils.synth_coco import (OracleMaps, oracle_maps,
                                               spread_people,
                                               write_synth_coco)

import util_parallel as up
from test_torch_data import write_coco
from test_torch_evalx import STAT_KEYS, JaxOracle
from test_torch_zoo import seeded_variables
from test_train_variants import _batch as variant_batch

mh = up.mh
LOSS_ATOL, PARAM_ATOL = 1e-6, 1e-5          # port DP / TP vs port
LOSS_RTOL, JPARAM_ATOL, JPARAM_RTOL = 1e-4, 1e-5, 1e-3   # port vs JAX
OUT_ATOL, OUT_RTOL = 2e-4, 1e-3     # fp32 forwards (test_vgg19_model.py)
SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _jcfg(name="vgg19", stages=1, **train):
    """The JAX twin of ``torch_multihost_check.make_cfg``."""
    cfg = jconfig.Config()
    cfg.model.name, cfg.model.num_stages = name, stages
    cfg.model.dtype = "float32"
    cfg.dataset.image_size = SIZE
    cfg.train.lr, cfg.train.freeze_base_epochs = 0.05, 0
    cfg.train.print_freq = 1000
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _jax_run(jt, batches, release_at=None):
    losses = []
    for i, b in enumerate(batches):
        if release_at is not None and i == release_at:
            jt.epoch = 1
            jt.maybe_release_backbone()
        jt.state, logs = jt.train_step(
            jt.state, *(jnp.asarray(b[k])
                        for k in ("image", "keypoints", "mask")))
        losses.append(float(logs["loss"]))
    return losses


def _jax_state(jt, name="vgg19"):
    variables = {"params": jax.device_get(jt.state.params),
                 **jax.device_get(jt.state.model_state)}
    return state_dict_from_flax(variables if len(variables) > 1
                                else variables["params"], model_name=name)


def _assert_state_close(got, want, atol, rtol=0.0):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w),
                                   atol=atol, rtol=rtol, err_msg=k)


def _within(got, want, atol, rtol):
    """Whether every tensor of `got` is within atol + rtol * |want|."""
    return all(np.all(np.abs(np.asarray(got[k], np.float64)
                             - np.asarray(w, np.float64))
                      <= atol + rtol * np.abs(np.asarray(w, np.float64)))
               for k, w in want.items() if k in got)


def _max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64)
                                   - np.asarray(b[k], np.float64))))
               for k in b)


# ---- the rules and the work split ------------------------------------------

@pytest.mark.parametrize("hwio", [
    (3, 3, 128, 256), (3, 3, 16, 64), (3, 3, 128, 129), (1, 1, 512, 38),
    (7, 7, 128, 128), (3, 3, 1, 256), (3, 3, 64, 126), (256,), (64,),
    (130,), (512, 512), ()])
@pytest.mark.parametrize("num_model", [1, 2, 4])
def test_param_spec_matches_jax(hwio, num_model):
    """The port's rule on torch's OIHW shape shards what JAX's shards on
    the HWIO kernel: the output channels, or a bias's features."""
    want = tuple(jparam_spec(np.zeros(hwio), num_model))
    oihw = (hwio[3], hwio[2], hwio[0], hwio[1]) if len(hwio) == 4 else hwio
    got = param_spec(oihw, num_model)
    if len(hwio) == 4:
        want = tuple(reversed(want[-1:])) + (None,) * 3 if want else ()
    assert got == want, (hwio, num_model, got, want)


@pytest.mark.parametrize("n,pc", [(23, 4), (13, 4), (8, 8), (3, 4),
                                  (0, 2), (100, 7), (5, 1), (16, 3)])
def test_host_shard_matches_jax(n, pc):
    items = list(range(n))
    shards = [tdist.host_shard(items, pi, pc) for pi in range(pc)]
    assert shards == [jdist.host_shard(items, pi, pc) for pi in range(pc)]
    assert [x for s in shards for x in s] == items


def test_merge_result_files_matches_jax(tmp_path):
    paths = []
    for r, rows in enumerate(([{"image_id": 1}], [], [{"image_id": 2},
                                                      {"image_id": 3}])):
        p = tmp_path / f"results.rank{r}.json"
        p.write_text(json.dumps(rows))
        paths.append(str(p))
    assert tdist.merge_result_files(paths) == \
        jdist.merge_result_files(paths)


def test_rank_rows_and_refusals():
    mesh = make_mesh(devices=["cpu", "cpu"])
    x = np.arange(8)
    # a serving mesh has data index 0: rows [0, 4)
    np.testing.assert_array_equal(tdist.rank_rows(x, mesh), x[:4])
    with pytest.raises(ValueError, match="does not split"):
        tdist.rank_rows(np.arange(5), mesh)
    with pytest.raises(ValueError, match="one process per position"):
        Trainer(mh.make_cfg(), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="tensor parallelism"):
        make_mesh(1, 2)
    assert tdist.rank_and_world() == (0, 1)
    tdist.sync_hosts()                     # a no-op in one process


# ---- ranks: world 2 ---------------------------------------------------------

_PHASES = {"freeze_release": dict(freeze_base_epochs=1, lr=0.01),
           "clip": dict(clip_grad_norm=0.05, lr=0.01),
           "accum": dict(grad_accum_steps=2, lr=0.01)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Two ranks: DP2 against one process; DP2 against the JAX trainer in
    three phases; atrous_cpm under DP2 (and with per-rank statistics); the
    eval split over the ranks.  The ranks run while the JAX trainers
    compile and step here."""
    jobs, ref, jax_runs = [], {}, []
    batches = mh.make_batches(2)
    jobs.append(dict(kind="train", cfg={}, batches=batches))
    ref["dp"] = batches
    for phase, train in _PHASES.items():
        jt = JTrainer(_jcfg(stages=1, **train))
        pb = mh.make_batches(4, seed=1 + list(_PHASES).index(phase))
        release = 2 if phase == "freeze_release" else None
        jax_runs.append((phase, jt, pb, release, "vgg19"))
        jobs.append(dict(kind="train", cfg=dict(**train), batches=pb,
                         state_dict=up.as_numpy_state(_jax_state(jt)),
                         release_at=release))
    # atrous_cpm: tests/test_train_variants.py's variant configuration
    bn_train = dict(lr=1e-3, clip_grad_norm=1.0)
    variables = seeded_variables(jax_get_model(
        "atrous_cpm", num_stages=2, dtype=jnp.float32), "atrous_cpm",
        (SIZE, SIZE))
    jt = JTrainer(_jcfg("atrous_cpm", 2, **bn_train),
                  params=jax.tree_util.tree_map(jnp.asarray, variables))
    rng = np.random.RandomState(0)
    bb = [variant_batch(rng, stride=8) for _ in range(2)]
    jax_runs.append(("bn", jt, bb, None, "atrous_cpm"))
    ref["bn_jt"], ref["bn_batches"] = jt, bb
    sd = up.as_numpy_state(state_dict_from_flax(variables,
                                                model_name="atrous_cpm"))
    for mutant in (None, "per_rank_bn"):
        jobs.append(dict(kind="train", cfg=dict(name="atrous_cpm", stages=2,
                                                **bn_train),
                         batches=bb, state_dict=sd, mutant=mutant,
                         outputs=True))
    # the eval split: an oracle pipeline over 7 frames of 2 shapes
    rng = np.random.RandomState(3)
    one, two = spread_people(rng, 1, 128, 160), spread_people(rng, 2, 128,
                                                               170)
    scenes = {(128, 160): one, (128, 170): two}
    frames = [(h, w, scenes[(h, w)])
              for h, w in [(128, 160), (128, 170)] * 3 + [(128, 160)]]
    root = str(tmp_path_factory.mktemp("parallel_eval"))
    img_dir, ann = write_synth_coco(root, frames)
    ev = dict(kind="eval_sharded", scenes=scenes, size=128, img_dir=img_dir,
              ann=ann, results_dir=os.path.join(root, "results"),
              batch_size=2)
    jobs.append(ev)
    ref["eval"] = ev
    jobs.append(dict(kind="unequal_rows", rows=[4, 3]))
    # the train CLI on a COCO fixture: 4 val images, 2 per rank
    root = str(tmp_path_factory.mktemp("parallel_cli"))
    img_dir, ann = write_coco(os.path.join(root, "coco"))
    with open(ann) as f:
        coco = json.load(f)
    keep = {1, 2, 4, 5}           # image 3 holds only a crowd region
    val = dict(coco, images=[i for i in coco["images"] if i["id"] in keep],
               annotations=[a for a in coco["annotations"]
                            if a["image_id"] in keep])
    val_ann = os.path.join(root, "val.json")
    with open(val_ann, "w") as f:
        json.dump(val, f)
    ref["cli_argv"] = lambda ckpt: [
        "--device", "cpu", "--epochs", "1", "--set",
        f'dataset.train_image_dir="{img_dir}"',
        f'dataset.train_annotations=["{ann}"]',
        f'dataset.val_image_dir="{img_dir}"',
        f'dataset.val_annotations="{val_ann}"', "dataset.image_size=64",
        "model.num_stages=1", 'model.dtype="float32"',
        "train.batch_size=2", "train.data_workers=0",
        "train.print_freq=1", f'train.checkpoint_dir="{ckpt}"']
    ref["cli_ckpt"] = os.path.join(root, "ckpt_dp2")
    jobs.append(dict(kind="train_cli",
                     argv=ref["cli_argv"](ref["cli_ckpt"])))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tdist.spawn, up.runs_worker, 2, (jobs,),
                            timeout=600)
        for key, jt, bs, release, name in jax_runs:
            ref[key] = (_jax_run(jt, bs, release), _jax_state(jt, name))
        return ranks.result(), ref


def test_dp2_matches_one_process(world2):
    ranks, ref = world2
    single = mh.train_run(mh.make_cfg(), ref["dp"])
    got = ranks[0][0]
    assert max(abs(a["loss"] - b["loss"])
               for a, b in zip(got["logs"], single["logs"])) <= LOSS_ATOL
    assert _max_diff(got["state"], single["state"]) <= PARAM_ATOL
    # the logs are global: every rank reads the same numbers
    assert ranks[1][0]["logs"] == got["logs"]
    assert got["logs"][0]["max_ht"] >= got["logs"][0]["min_ht"]


@pytest.mark.parametrize("phase", list(_PHASES))
def test_dp2_matches_the_jax_mesh_trainer(world2, phase):
    """DP2 against the JAX Trainer on its 8-device virtual mesh
    (make_mesh(8, 1)), from its initial weights."""
    ranks, ref = world2
    want_losses, want_state = ref[phase]
    got = ranks[0][1 + list(_PHASES).index(phase)]
    for lg, want in zip(got["logs"], want_losses):
        assert lg["skipped_nonfinite"] == 0.0
        assert math.isclose(lg["loss"], want, rel_tol=LOSS_RTOL), \
            (lg["loss"], want)
    _assert_state_close(got["state"], want_state, JPARAM_ATOL, JPARAM_RTOL)


def test_batchnorm_dp2_keeps_the_global_batch_statistics(world2):
    ranks, ref = world2
    want_losses, want_state = ref["bn"]
    got = ranks[0][4]
    for lg, want in zip(got["logs"], want_losses):
        assert math.isclose(lg["loss"], want, rel_tol=LOSS_RTOL)
    assert got["buffers"]
    _assert_state_close(got["state"], want_state, JPARAM_ATOL, JPARAM_RTOL)
    # every rank holds the same statistics (of the global batch)
    for k, v in got["buffers"].items():
        np.testing.assert_array_equal(ranks[1][4]["buffers"][k], v)
    # and each rank's train-mode outputs are the JAX mesh trainer's
    # rows: normalised by the global batch's statistics
    want = _jax_train_outputs(ref)
    for r in range(2):
        for key in ("pafs", "heatmaps"):
            np.testing.assert_allclose(
                ranks[r][4]["outputs"][key], want[key][:, 4 * r:4 * r + 4],
                atol=OUT_ATOL, rtol=OUT_RTOL, err_msg=(r, key))


def _jax_train_outputs(ref):
    """The JAX trainer's train-mode forward of the last BatchNorm batch
    after its steps."""
    jt = ref["bn_jt"]
    out, _ = jt.model.apply(
        {"params": jt.state.params, **jt.state.model_state},
        jnp.asarray(ref["bn_batches"][-1]["image"]), train=True,
        mutable=["batch_stats"])
    return {"pafs": np.asarray(out.pafs),
            "heatmaps": np.asarray(out.heatmaps)}


def test_batchnorm_per_rank_statistics_would_differ(world2):
    """The check above catches a port that normalises each rank's rows by
    their own statistics (a plain per-process BatchNorm)."""
    ranks, ref = world2
    _, want_state = ref["bn"]
    naive = ranks[0][5]["buffers"]
    assert not _within(naive, want_state, JPARAM_ATOL, JPARAM_RTOL)
    want = _jax_train_outputs(ref)
    assert not _within(ranks[0][5]["outputs"],
                       {k: v[:, :4] for k, v in want.items()},
                       OUT_ATOL, OUT_RTOL)
    assert any(not np.array_equal(ranks[0][5]["buffers"][k],
                                  ranks[1][5]["buffers"][k]) for k in naive)


def test_run_eval_sharded_matches_one_process(world2):
    ranks, ref = world2
    ev = ref["eval"]
    stats = ranks[0][6]
    assert ranks[1][6] is None
    pipe = PosePipeline(OracleMaps(oracle_maps(ev["scenes"], 128)),
                        device="cpu", input_size=128, flip=False)
    single_path = os.path.join(os.path.dirname(ev["results_dir"]),
                               "single.json")
    want = run_eval_batched(ev["img_dir"], ev["ann"], pipe, batch_size=2,
                            results_path=single_path)
    for k in STAT_KEYS + ["frames_retried", "frames_truncated"]:
        assert stats[k] == want[k], k
    assert want["AP"] == 1.0
    merged = tdist.merge_result_files([
        os.path.join(ev["results_dir"], f"results.rank{r}.json")
        for r in range(2)])
    with open(single_path) as f:
        single = json.load(f)
    key = lambda r: (r["image_id"], r["keypoints"])  # noqa: E731
    assert sorted(merged, key=key) == sorted(single, key=key)
    assert len(single) == 10


def test_unequal_rows_are_refused_on_every_rank(world2):
    """Ranks with 4 and 3 rows: the mean of their gradients would not be
    the global batch's; every rank refuses the step (the row counts ride
    on the logs' all-reduces)."""
    ranks, _ = world2
    for r in ranks:
        assert r[7] is not None and "unequal rows" in r[7], r[7]


def test_train_cli_over_two_ranks_equals_one_process(world2, tmp_path):
    """``python -m rtpose_tpu_torch.train`` in two ranks (each its rows of
    the Loader's global batches, a 2 x 1 mesh, rank 0 writing the
    checkpoint) against the CLI in one process: the same per-step-mean
    losses, the same checkpoint step."""
    from rtpose_tpu_torch.train.checkpoint import CheckpointManager
    ranks, ref = world2
    got = [r[8] for r in ranks]
    assert got[0] == got[1] and got[0]["mesh"] == [2, 1]
    one = up.train_cli(ref["cli_argv"](str(tmp_path / "ckpt")))
    assert one["mesh"] is None and one["step"] == got[0]["step"] == 2
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[0][key], one[key], rtol=0,
                                   atol=LOSS_ATOL)
    state, meta = CheckpointManager(ref["cli_ckpt"]).restore_latest()
    assert state["step"] == 2 and meta["epoch"] == 1
    assert meta["val_loss"] == got[0]["val_loss"][0]


# ---- ranks: world 4 ---------------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Four ranks: DP4, DP2 x TP2 (with a checkpoint round trip), TP with
    a summing gather, and the eval merge of tests/test_tensor_parallel.py."""
    batches = mh.make_batches(2)
    out_dir = str(tmp_path_factory.mktemp("merge"))
    jobs = [dict(kind="train", cfg={}, batches=batches),
            dict(kind="train", cfg={}, batches=batches, num_model=2,
                 roundtrip=True),
            dict(kind="train", cfg={}, batches=batches, num_model=2,
                 mutant="summing_gather"),
            dict(kind="eval_merge", out_dir=out_dir)]
    return tdist.spawn(up.runs_worker, 4, (jobs,), timeout=600), batches


def test_dp4_matches_one_process(world4):
    ranks, batches = world4
    single = mh.train_run(mh.make_cfg(), batches)
    loss, param = mh.max_diffs(ranks[0][0], single)
    assert loss <= LOSS_ATOL and param <= PARAM_ATOL
    assert all(r[0]["logs"] == ranks[0][0]["logs"] for r in ranks)


def test_tp2_matches_dp(world4):
    """DP2 x TP2 == DP4: losses atol 1e-6, parameters atol 1e-5, and the
    convs param_spec shards are sharded (conv and bias)."""
    ranks, _ = world4
    dp, tp = ranks[0][0], ranks[0][1]
    loss, param = mh.max_diffs(tp, dp)
    assert loss <= LOSS_ATOL and param <= PARAM_ATOL
    sharded = tp["sharded"]
    assert sum(k.endswith(".weight") for k in sharded) >= 10
    want = [k for k, v in dp["state"].items()
            if param_spec(v.shape, 2) and ".bn" not in k]
    assert sorted(sharded) == sorted(want)
    assert all(param_spec(dp["state"][k].shape, 2)[0] == MODEL_AXIS
               for k in sharded)
    # the gathered checkpoint reloads into a sharded trainer: the same
    # next step, parameters and momentum
    rt = tp["roundtrip"]
    assert rt["losses"][0] == rt["losses"][1]
    assert rt["max_param_diff"] == 0.0


def test_tp_gather_backward_that_sums_is_caught(world4):
    """A gather whose backward sums the model ranks' gradients (that of
    torch.distributed.nn.functional.all_gather) doubles the sharded
    convs' gradients: the parameters leave the DP run's tolerance."""
    ranks, _ = world4
    dp, bad = ranks[0][0], ranks[0][2]
    assert bad["logs"][0]["loss"] == dp["logs"][0]["loss"]
    assert mh.max_diffs(bad, dp)[1] > PARAM_ATOL


def test_tp_checkpoint_loads_into_an_unsharded_pipeline(world4):
    ranks, _ = world4
    state = {k: torch.as_tensor(v) for k, v in ranks[0][1]["state"].items()}
    model = get_model("vgg19", num_stages=1, dtype=torch.float32)
    load_strict(model, state)
    pipe = PosePipeline(model, device="cpu", input_size=56)
    people, heat, paf, meta = pipe.run(np.zeros((60, 80, 3), np.uint8))
    assert heat.shape == (7, 10, 19) and np.isfinite(heat).all()


def test_multiprocess_eval_merge_matches_single_process(world4):
    """tests/test_tensor_parallel.py's merge, over four real processes."""
    ranks, _ = world4
    merges = [r[3] for r in ranks]
    assert merges[0]["stats"] == mh.single_eval_stats()
    assert all(m["stats"] is None for m in merges[1:])
    assert [m["ids"] for m in merges] == [
        jdist.host_shard(list(range(1, 14)), pi, 4) for pi in range(4)]


# ---- sharded serving ---------------------------------------------------------

def _people_key(p):
    return sorted((part, round(x, 4), round(y, 4))
                  for part, (x, y, _s) in p["parts"].items())


def _same_people(got, want):
    assert len(got) == len(want)
    for ps, pr in zip(got, want):
        assert [_people_key(a) for a in sorted(ps, key=_people_key)] == \
            [_people_key(b) for b in sorted(pr, key=_people_key)]


def _same_metas(got, want):
    for a, b in zip(got, want):
        assert a["upsampled"] == b["upsampled"]
        assert a["scale"] == b["scale"]


@pytest.fixture(scope="module")
def pipes():
    """JAX's mesh pipeline and the port's unsharded and ["cpu", "cpu"]
    ones, on the same seeded flax weights (test_pipeline_sharded.py)."""
    jmodel = jax_get_model("vgg19", num_stages=1, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    kw = dict(input_size=56, flip=True)
    jpipe = JPosePipeline(jmodel, params, mesh=jmesh.make_mesh(8, 1), **kw)
    model = get_model("vgg19", num_stages=1, dtype=torch.float32)
    load_strict(model, state_dict_from_flax(jax.device_get(params)))
    return (jpipe, PosePipeline(model, device="cpu", **kw),
            PosePipeline(model, mesh=make_mesh(devices=["cpu", "cpu"]),
                         **kw))


@pytest.mark.parametrize("case", ["batch8", "ragged5", "multiscale6"])
def test_sharded_pipeline_matches_unsharded_and_jax(pipes, case):
    jpipe, pipe, pipe_sh = pipes
    n, seed = {"batch8": (8, 0), "ragged5": (5, 1),
               "multiscale6": (6, 5)}[case]
    rng = np.random.RandomState(seed)
    frames = [(rng.rand(80, 60, 3) * 255).astype(np.uint8)
              for _ in range(n)]
    if case == "multiscale6":
        scales = (0.75, 1.0)
        ticket = pipe_sh.run_multiscale_batch_submit(frames, scales)
        want = pipe.run_multiscale_batch(frames, scales)
        jwant = jpipe.run_multiscale_batch(frames, scales)
    else:
        ticket = pipe_sh.run_batch_submit(frames)
        want = pipe.run_batch(frames)
        jwant = jpipe.run_batch(frames)
    # one sub-batch a shard, the pad frames at the end of the last
    assert ticket[0] == "multi" and len(ticket[2]) == 2
    assert [idxs for idxs, _ in ticket[2]] == \
        [list(range(0, -(-n // 2))), list(range(-(-n // 2), n))]
    got = pipe_sh.run_batch_collect(ticket)
    assert len(got[0]) == len(got[1]) == n
    _same_people(got[0], want[0])
    _same_people(got[0], jwant[0])
    _same_metas(got[1], want[1])
    assert pipe_sh.ms_chunk_cap(10_000) == 2 * pipe.ms_chunk_cap(10_000)


@pytest.mark.parametrize("n", [8, 5])
def test_sharded_pipeline_finds_the_oracles_people(n):
    """On maps with people (an oracle in place of the network) the shards
    return the unsharded pipeline's people in frame order; JAX's mesh
    pipeline finds them too."""
    rng = np.random.RandomState(4)
    shapes = [(128, 160), (128, 170)]
    scenes = {s: spread_people(rng, 1 + i, *s) for i, s in enumerate(shapes)}
    maps = oracle_maps(scenes, 128)
    frames = [np.full(shapes[i % 2] + (3,), 100 + i, np.uint8)
              for i in range(n)]
    pipe = PosePipeline(OracleMaps(maps), device="cpu", input_size=128,
                        flip=False)
    pipe_sh = PosePipeline(OracleMaps(maps), input_size=128, flip=False,
                           mesh=make_mesh(devices=["cpu", "cpu"]))
    jpipe = JPosePipeline(JaxOracle(maps), {}, input_size=128, flip=False,
                          mesh=jmesh.make_mesh(8, 1))
    got, want = pipe_sh.run_batch(frames), pipe.run_batch(frames)
    _same_people(got[0], want[0])
    _same_people(got[0], jpipe.run_batch(frames)[0])
    assert [len(p) for p in got[0]] == [1 + i % 2 for i in range(n)]


# ---- the eval CLI and the loaders -------------------------------------------

def test_evalx_cli_data_parallel_equals_batch4(tmp_path, monkeypatch,
                                               capsys):
    """``--data-parallel`` on the CPU: a mesh of the one device, batch
    4 x 1; the results JSON equals ``--batch 4``'s."""
    from rtpose_tpu_torch.evalx.__main__ import main
    rng = np.random.RandomState(0)
    img_dir, ann = write_synth_coco(str(tmp_path / "coco"), [
        (64, 48, spread_people(rng, 1, 64, 48)) for _ in range(3)])
    out = {}
    for name, extra in (("dp", ["--data-parallel"]),
                        ("b4", ["--batch", "4"])):
        monkeypatch.setattr(sys, "argv", [
            "evalx", "--image-dir", img_dir, "--ann", ann, "--stages", "1",
            "--input-size", "56", "--fp32", "--device", "cpu", "--results",
            str(tmp_path / f"{name}.json")] + extra)
        stats = main()
        assert "pipeline_s" in stats            # the batched harness
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
    assert out["dp"] == out["b4"]
    capsys.readouterr()


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_rank_slices_concatenate_to_the_single_batch(tmp_path,
                                                            workers):
    img_dir, ann = write_coco(str(tmp_path / "coco"))
    ds = CocoKeypoints(img_dir, ann, input_size=SIZE)
    kw = dict(batch_size=2, num_workers=workers, seed=3)
    single = list(Loader(ds, **kw))
    ranks = [list(Loader(ds, rank=r, world=2, **kw)) for r in range(2)]
    assert [len(b["image"]) for b in single] == [2, 2]
    for bi, want in enumerate(single):
        for k, v in want.items():
            got = torch.cat([ranks[r][bi][k] for r in range(2)])
            assert torch.equal(got, v), (bi, k)
    with pytest.raises(ValueError, match="does not split"):
        next(iter(Loader(ds, rank=0, world=3, **kw)))


def test_native_loader_rank_slices_concatenate_to_the_single_batch(
        tmp_path):
    from rtpose_tpu_torch.data.native_loader import NativeLoader
    img_dir, ann = write_coco(str(tmp_path / "coco"))
    ds = CocoKeypoints(img_dir, ann, input_size=SIZE)
    kw = dict(batch_size=2, threads=2, seed=5, uint8_output=True)
    single = list(NativeLoader(ds, **kw))
    ranks = [list(NativeLoader(ds, rank=r, world=2, **kw))
             for r in range(2)]
    assert [len(b["image"]) for b in single] == [2, 2]
    for bi, want in enumerate(single):
        for k, v in want.items():
            got = torch.cat([ranks[r][bi][k] for r in range(2)])
            assert torch.equal(got, v), (bi, k)
    with pytest.raises(ValueError, match="does not split"):
        next(iter(NativeLoader(ds, rank=1, world=3, **kw)))
