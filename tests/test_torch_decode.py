"""The port's decode (NMS + refine, scoring, greedy matching, assembly) vs
the JAX package's, on rendered scenes (tests/util_synth.py).

The JAX side runs its Pallas kernels in interpret mode (refine through
``nms(use_pallas=True)``, sampling ``'pallas_fused'``).  Held equal:
``Peaks.x/y/valid/truncated`` and ``People.coords/valid/truncated``;
float fields within atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rtpose_tpu.ops import decode as jdecode
from rtpose_tpu.ops import peaks as jpeaks
from rtpose_tpu_torch.ops import decode, peaks

from util_synth import grid_people, render_maps, synth_example

ATOL = 1e-5
# caps from tests/test_truncation_retry.py: a crowded scene overflows
# TIGHT and fits RAISED
TIGHT = dict(max_peaks=16, max_candidates=64, max_total_conns=32,
             max_people=64)
RAISED = dict(max_peaks=16, max_candidates=512, max_total_conns=304,
              max_people=64)


def _assert_people_equal(got, want):
    for f in ("coords", "valid", "truncated"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("score", "part_score"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=ATOL,
                                   err_msg=f)


def _jax_decode(heat, paf, sampling="pallas_fused", **caps):
    return jax.device_get(jdecode.decode_poses(
        jnp.asarray(heat), jnp.asarray(paf), sampling=sampling, **caps))


def _assert_lists_equal(got, want):
    """people_to_numpy lists: same people and parts, same coordinates,
    scores within ATOL."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["parts"].keys() == b["parts"].keys()
        assert abs(a["score"] - b["score"]) <= ATOL
        for part, (x, y, sc) in a["parts"].items():
            assert (x, y) == b["parts"][part][:2]
            assert abs(sc - b["parts"][part][2]) <= ATOL


@pytest.mark.parametrize("seed,n_people", [(0, 1), (1, 3), (2, 5), (7, 4)])
def test_nms_matches_jax(seed, n_people):
    _, heat, _ = synth_example(seed=seed, n_people=n_people)
    want = jpeaks.nms(jnp.asarray(heat), use_pallas=True,
                      pallas_interpret=True)
    got = peaks.nms(torch.from_numpy(heat)[None])
    assert int(got.valid.sum()) > 10
    for f in ("x", "y", "valid", "truncated"):
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("xf", "yf", "score"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   np.asarray(getattr(want, f)), atol=ATOL,
                                   err_msg=f)


def test_nms_truncates_like_jax():
    rng = np.random.RandomState(3)
    heat, _ = render_maps(grid_people(3, 4, 46, 46, rng), 46, 46)
    for k in (8, 16):
        want = jpeaks.nms(jnp.asarray(heat), max_peaks=k)
        got = peaks.nms(torch.from_numpy(heat)[None], max_peaks=k)
        assert bool(got.truncated[0]) == bool(want.truncated) == (k == 8)
        np.testing.assert_array_equal(got.x[0].numpy(), np.asarray(want.x))


def test_gaussian_filt_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        peaks.nms(torch.zeros((1, 8, 8, 19)), gaussian_filt=True)


@pytest.mark.parametrize("seed,n_people", [(0, 1), (1, 3), (3, 5), (4, 6)])
def test_decode_poses_matches_jax(seed, n_people):
    _, heat, paf = synth_example(seed=seed, n_people=n_people)
    want = _jax_decode(heat, paf)
    got = decode.people_to_host(decode.decode_poses(
        torch.from_numpy(heat), torch.from_numpy(paf)))
    assert int(got.valid.sum()) == n_people
    _assert_people_equal(got, want)
    _assert_lists_equal(decode.people_to_numpy(got, 368, 368),
                        jdecode.people_to_numpy(want, 368, 368))


def test_decode_batch_matches_per_image_jax():
    scenes = [synth_example(seed=10 + i, n_people=1 + i)[1:]
              for i in range(3)]
    heat = torch.from_numpy(np.stack([h for h, _ in scenes]))
    paf = torch.from_numpy(np.stack([p for _, p in scenes]))
    got = decode.people_to_host(decode.decode_poses_batch(heat, paf))
    for i, (h, p) in enumerate(scenes):
        _assert_people_equal(decode.people_row(got, i), _jax_decode(h, p))


def test_crowded_scene_truncates_then_matches_at_raised_caps():
    """JAX decodes with 'gather' sampling here: it selects the same PAF
    cells as the Pallas kernels (held against them in
    tests/test_torch_kernels.py) and compiles in a tenth of the time."""
    rng = np.random.RandomState(0)
    people = grid_people(3, 4, 46, 46, rng)
    heat, paf = render_maps(people, 46, 46)
    paf = paf + rng.normal(0, 1e-4, paf.shape).astype(np.float32)
    h, p = torch.from_numpy(heat), torch.from_numpy(paf)
    tight = decode.people_to_host(decode.decode_poses(h, p, **TIGHT))
    want_tight = _jax_decode(heat, paf, "gather", **TIGHT)
    assert bool(tight.truncated) and bool(want_tight.truncated)
    _assert_people_equal(tight, want_tight)
    raised = decode.people_to_host(decode.decode_poses(h, p, **RAISED))
    assert not bool(raised.truncated)
    assert int(raised.valid.sum()) == len(people)
    _assert_people_equal(raised, _jax_decode(heat, paf, "gather", **RAISED))


def test_people_to_host_keeps_types():
    _, heat, paf = synth_example(seed=2, n_people=2)
    dev = decode.decode_poses_batch(torch.from_numpy(heat)[None],
                                    torch.from_numpy(paf)[None])
    host = decode.people_to_host(dev)
    assert host.coords.dtype == np.int32 and host.valid.dtype == bool
    assert host.truncated.shape == (1,)
    np.testing.assert_array_equal(host.coords, dev.coords.numpy())
    np.testing.assert_array_equal(host.score, dev.score.numpy())
