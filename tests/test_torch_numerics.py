"""The CPU numerics the port's parity tests stand on.

torch's CPU sqrt and exp run through MKL's vector math library, whose
lazy initialisation races when its first call comes from several OpenMP
threads at once: in about one fresh process of ten, the first
multi-threaded ``torch.sqrt`` returned values ~1e-4 off in the chunks of
the worker threads (a limb length of 280.9217 came back as 280.87448).
That moved a person score of ``test_decode_poses_matches_jax[0-1]`` past
its 1e-5 bound in about one run of forty.  ``import rtpose_tpu_torch``
initialises the library on one thread first; these tests hold that, in
fresh processes, since the race exists only on a process's first call.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCESSES = 8     # started together, at the default thread count

_CHILD = r"""
import json, sys, numpy as np, torch
import rtpose_tpu_torch  # noqa: F401
d = np.random.RandomState(0).randint(0, 400, (2, 19456)).astype(np.float32)
x = torch.from_numpy(d[0] ** 2 + d[1] ** 2 if sys.argv[1] == "sqrt"
                     else -d[0] / 100.0)
op = getattr(torch, sys.argv[1])
first, again = op(x), op(x)
print(json.dumps(int((first != again).sum())))
"""


@pytest.mark.parametrize("op", ["sqrt", "exp"])
def test_first_parallel_vml_call_equals_the_second(op):
    """The op's first call in each of N_PROCESSES fresh processes equals
    its second.  Without the initialisation the race showed in 11 of 100
    such processes, so a wave of 8 catches it about half the time."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, op], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(N_PROCESSES)]
    mismatches = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        mismatches.append(json.loads(out.strip().splitlines()[-1]))
    assert mismatches == [0] * N_PROCESSES
