"""Multi-stage MSE supervision (port of rtpose_tpu/train/loss.py).

Reference train/train_VGG19.py:143-174 (get_loss): every refinement
stage's PAF and heatmap output gets a mean-reduced MSE against the same
targets; the total is the sum of all 2*num_stages terms.  Per-stage values
are returned for logging under the reference's names (build_names
:134-140).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.common import ModelOutput


def stagewise_mse(out: ModelOutput, heat_gt: torch.Tensor,
                  paf_gt: torch.Tensor,
                  heat_mask: Optional[torch.Tensor] = None,
                  paf_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """out.pafs/heatmaps: (S, B, h, w, C); *_gt: (B, h, w, C).

    Optional masks (B, h, w, 1) give the masked loss of the alternate
    trainers (reference train/train_SH.py:80-126).  Returns (total, logs):
    ``loss_stage{s}_L1`` (PAF) and ``_L2`` (heat) per stage, and the range
    of the last stage's maps (``max_ht``, ``min_ht``, ``max_paf``,
    ``min_paf``), all 0-d tensors; the log values carry no gradient.
    """
    logs: Dict[str, torch.Tensor] = {}
    total = out.pafs.new_zeros(())
    for s in range(out.pafs.shape[0]):
        dp = out.pafs[s] - paf_gt
        dh = out.heatmaps[s] - heat_gt
        if paf_mask is not None:
            dp = dp * paf_mask
        if heat_mask is not None:
            dh = dh * heat_mask
        lp = (dp * dp).mean()
        lh = (dh * dh).mean()
        logs[f"loss_stage{s + 1}_L1"] = lp.detach()
        logs[f"loss_stage{s + 1}_L2"] = lh.detach()
        total = total + lp + lh
    with torch.no_grad():
        logs["max_ht"] = out.heatmaps[-1].max()
        logs["min_ht"] = out.heatmaps[-1].min()
        logs["max_paf"] = out.pafs[-1].max()
        logs["min_paf"] = out.pafs[-1].min()
    return total, logs
