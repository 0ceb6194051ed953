"""rtpose_tpu_torch stands alone: it imports no jax, flax, cv2 or anything
of the JAX package, and its copies of the JAX package's tables and numpy
helpers are equal to the originals."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from rtpose_tpu import skeleton as jskeleton
from rtpose_tpu.models import import_torch
from rtpose_tpu.ops import peaks as jpeaks
from rtpose_tpu.ops import resize as jresize
from rtpose_tpu_torch import skeleton
from rtpose_tpu_torch.models.convert import torch_layout_map
from rtpose_tpu_torch.ops.kernels import interp_matrices
from rtpose_tpu_torch.ops.resize import resize_matrix_linear

from util_synth import synth_example

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "cv2", "rtpose_tpu"):
    sys.modules[name] = None          # any import of these now fails
import numpy as np, torch
import rtpose_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(rtpose_tpu_torch.__path__,
                                              "rtpose_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from rtpose_tpu_torch.infer.pipeline import load_pipeline
from rtpose_tpu_torch.ops.decode import decode_poses, people_to_numpy
maps = np.load(sys.argv[1])
people = people_to_numpy(decode_poses(torch.from_numpy(maps["heat"]),
                                      torch.from_numpy(maps["paf"])),
                         368, 368)
pipe = load_pipeline(device="cpu", num_stages=1, input_size=56, seed=0)
found, heat, paf, meta = pipe.run(np.zeros((60, 80, 3), np.uint8))
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "flax", "cv2", "rtpose_tpu")
                and sys.modules[k] is not None)
print(json.dumps({"modules": mods, "people": len(people),
                  "heat": list(heat.shape), "loaded": loaded}))
"""


def test_port_runs_without_jax_flax_cv2_or_the_jax_package(tmp_path):
    _, heat, paf = synth_example(seed=1, n_people=3)
    maps = tmp_path / "maps.npz"
    np.savez(maps, heat=heat, paf=paf)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _CHILD, str(maps)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "rtpose_tpu_torch.infer.pipeline" in res["modules"]
    assert "rtpose_tpu_torch.ops.kernels" in res["modules"]
    assert res["people"] == 3
    assert res["heat"] == [7, 10, 19]
    assert res["loaded"] == []


def test_skeleton_copy_equals_the_jax_package():
    names = [n for n in dir(skeleton) if n.isupper()]
    assert len(names) >= 14
    for name in names:
        assert getattr(skeleton, name) == getattr(jskeleton, name), name


def test_copied_numpy_helpers_equal_the_jax_package():
    np.testing.assert_array_equal(interp_matrices(8),
                                  jpeaks._interp_matrices(8))
    for src, dst in ((480, 368), (240, 368), (368, 368), (7, 3)):
        np.testing.assert_array_equal(resize_matrix_linear(src, dst),
                                      jresize.resize_matrix_linear(src, dst))
    assert torch_layout_map(6) == import_torch.torch_layout_map()
    assert torch_layout_map(2) == torch_layout_map(6)[:12 + 2 * (5 + 7)]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without CUDA (here) or without the repository beside it, the smoke
    script exits non-zero and prints no result line."""
    import torch
    if torch.cuda.is_available() and not alone:
        pytest.skip("this host has a CUDA card")
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
