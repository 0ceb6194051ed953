#!/usr/bin/env python3
"""Export a JAX package training checkpoint (orbax) to a PyTorch ``.pth``
that the PyTorch port loads strictly.

    python scripts/export_jax_checkpoint.py CKPT_DIR pose_model.pth \
        [--step N] [--model FAMILY]

Runs where JAX and orbax are installed (it imports rtpose_tpu): restores
the parameters of the best step (or `--step`) with
``CheckpointManager.restore_params`` and writes them through
``export_rtpose_state_dict``, the reference ``rtpose_model`` key scheme
(``model0.*``, ``model{T}_{B}.*``, OIHW).  The file then serves where the
port runs, for example on the card:

    python -m rtpose_tpu_torch.evalx --weight pose_model.pth ...

This is the bridge from a model trained with the JAX package to its
evaluation with the port.  The reference layout has six stages, so a
VGG19 checkpoint must have six.  Any other family (``--model``, e.g.
``hourglass``) is written in the port's own keys through
``rtpose_tpu_torch.models.convert.state_dict_from_flax``: its parameters
and its BatchNorm statistics (``batch_stats``); serve it with the same
``--model`` (and ``--stages``).
"""

from __future__ import annotations

import argparse
import os
import sys


def export(checkpoint_dir: str, out_path: str, step=None,
           model: str = "vgg19") -> dict:
    """Write the checkpoint's parameters (and BatchNorm statistics) of
    family `model` to `out_path` as a torch state_dict of fp32 tensors ->
    that state_dict."""
    import numpy as np
    import torch

    from rtpose_tpu.models.import_torch import export_rtpose_state_dict
    from rtpose_tpu.train.checkpoint import CheckpointManager

    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(f"no checkpoint directory {checkpoint_dir}")
    params, model_state, _meta = CheckpointManager(
        checkpoint_dir).restore_params(step)
    if model == "vgg19":
        stages = sorted(k for k in params["stages"] if k.endswith("_L1"))
        if len(stages) != 6:
            raise ValueError(f"{checkpoint_dir}: {len(stages)} stages; the "
                             f"reference layout has 6")
        state = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                 for k, v in export_rtpose_state_dict(params).items()}
    else:
        import jax

        from rtpose_tpu_torch.models.convert import state_dict_from_flax
        variables = jax.tree_util.tree_map(
            np.asarray, {"params": params, **(model_state or {})})
        state = dict(state_dict_from_flax(variables, model_name=model))
    tmp = f"{out_path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, out_path)
    return state


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("checkpoint_dir")
    parser.add_argument("out", help="the .pth to write")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (default: the best, else the "
                             "latest)")
    parser.add_argument("--model", default="vgg19",
                        help="the checkpoint's model family (default vgg19, "
                             "written in the reference layout)")
    args = parser.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    state = export(args.checkpoint_dir, args.out, args.step, args.model)
    print(f"wrote {len(state)} tensors to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
