"""Single-card training (port of rtpose_tpu/train/trainer.py).

One train step: ground truth synthesised on the device from padded
keypoints (K4, ``csrc/gt_maps.cu``, on a CUDA batch) -> forward ->
2 * num_stages MSE terms -> gradients -> the masked, guarded update.  The
update is the JAX package's optax chain written out:

- ``torch.optim.SGD`` with nesterov momentum, dampening 0 and no weight
  decay equals ``optax.sgd(learning_rate=1)`` with the lr multiplied in
  afterwards; the plateau schedule sets ``param_group["lr"]``;
- the freeze phase zeroes the gradients of the pretrained convs before
  anything else sees them (trainer.py:147-148), so momentum and the clip
  norm see what JAX sees;
- ``clip_grad_norm > 0`` clips in optax's form, ``g`` if ``|g| < max``
  else ``(g / |g|) * max`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6
  and gives other numbers);
- ``grad_accum_steps = k`` keeps optax.MultiSteps' running mean of the
  micro-batch gradients and steps on every k-th;
- a non-finite loss skips the whole update: parameters, momentum, the
  accumulator and any module buffers keep their values (trainer.py:149-165).

The step reads all its log scalars back to the host at once, before the
update, and that one readback also decides the guard.  The device is
explicit and the initial weights come from a ``torch.Generator`` seeded
from ``cfg.train.seed``.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import torch

from ..config import Config
from ..data.gt import ground_truth_maps_batch
from ..device import resolve_device
from ..infer.preprocess import IMAGENET_MEAN, IMAGENET_STD, constants_on
from ..models import get_model
from ..models.common import he_reinit
from ..models.convert import load_strict
from ..utils.meters import AverageMeter, MetricLogger
from .checkpoint import CheckpointManager
from .loss import stagewise_mse
from .schedule import ReduceLROnPlateau, freeze_mask

Batch = Mapping[str, Any]


def normalize_window(u8: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB canvas + (B, 4) int32 content window
    [x, y, w, h] -> the fp32 network input: (v/255 - mean)/std inside the
    window and exactly 0 outside (trainer.py:115-132).  The divisors are
    tensors on the batch's device, copied there once: CUDA turns a
    division by a Python number into a product with its reciprocal, which
    rounds some values an ulp away from the CPU's."""
    dev = u8.device
    x = ((u8.float() / constants_on(dev, 255.0)
          - constants_on(dev, IMAGENET_MEAN))
         / constants_on(dev, IMAGENET_STD))
    ys = torch.arange(x.shape[1], device=dev)[None, :, None]
    xs = torch.arange(x.shape[2], device=dev)[None, None, :]
    x0, y0, ww, wh = (window[:, i][:, None, None] for i in range(4))
    inside = (ys >= y0) & (ys < y0 + wh) & (xs >= x0) & (xs < x0 + ww)
    return x * inside[..., None]


class Trainer:
    """The JAX ``Trainer`` on one card: ``train_step``, ``eval_step``,
    ``run_epoch``, ``maybe_release_backbone`` and ``fit``.

    Any family of ``models.get_model``.  BatchNorm runs in train mode in
    :meth:`train_step` (the running statistics move, as the JAX trainer's
    mutable ``batch_stats`` do) and in eval mode in :meth:`eval_step`; a
    skipped non-finite step leaves them as they were.  `state_dict`
    replaces the seeded initial weights (the tests carry the JAX
    trainer's parameters and statistics across through
    ``models.convert``).
    """

    def __init__(self, cfg: Config, *,
                 device: Union[str, torch.device] = "cuda",
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 log_dir: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.metrics = MetricLogger(log_dir, tensorboard=bool(log_dir))
        dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" \
            else torch.float32
        gen = torch.Generator().manual_seed(cfg.train.seed)
        model = get_model(cfg.model.name, num_stages=cfg.model.num_stages,
                          dtype=dtype, generator=gen)
        if state_dict is not None:
            load_strict(model, state_dict)
        elif cfg.model.init_scheme == "scratch":
            he_reinit(model, gen)
        self.model = model.to(self.device)
        self.params = dict(self.model.named_parameters())
        self.optimizer = torch.optim.SGD(
            self.params.values(), lr=cfg.train.lr,
            momentum=cfg.train.momentum, dampening=0.0, weight_decay=0.0,
            nesterov=cfg.train.nesterov)
        self.frozen = freeze_mask(self.params, self._frozen_modules(),
                                  frozen=cfg.train.freeze_base_epochs > 0)
        self.accum: Optional[List[torch.Tensor]] = None   # MultiSteps mean
        self.mini_step = 0
        self.step = 0
        self.plateau = ReduceLROnPlateau(
            lr=cfg.train.lr, factor=cfg.train.lr_factor,
            patience=cfg.train.lr_patience, cooldown=cfg.train.lr_cooldown)
        self.epoch = 0
        self.best_val = float("inf")

    def _frozen_modules(self) -> List[str]:
        if self.cfg.model.name == "vgg19":
            return self.model.pretrained_conv_names()
        return []

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = float(value)

    # ---- the step --------------------------------------------------------

    def _to_device(self, images, keypoints, mask, window=None):
        """The batch on the trainer's device.  A batch in page-locked
        memory (the ``Loader``'s with ``pin_memory``) is copied
        asynchronously: the step's one readback stays its only wait."""
        dev = self.device

        def move(x, dtype=None):
            x = torch.as_tensor(x)
            return x.to(dev, dtype, non_blocking=x.is_pinned())

        images = move(images)
        if window is not None:
            images = normalize_window(images, move(window))
        keypoints = move(keypoints, torch.float32)
        if mask is not None:
            mask = move(mask, torch.float32)
        return images.float(), keypoints, mask

    def _loss(self, images, keypoints, mask):
        size = self.cfg.dataset.image_size
        with torch.no_grad():
            heat_gt, paf_gt = ground_truth_maps_batch(
                keypoints, input_y=size, input_x=size,
                stride=self.cfg.model.downsample, sigma=self.cfg.dataset.sigma,
                limb_width=self.cfg.dataset.limb_width)
        m = mask if self.cfg.train.masked_loss else None
        return stagewise_mse(self.model(images), heat_gt, paf_gt,
                             heat_mask=m, paf_mask=m)

    @staticmethod
    def _readback(loss: torch.Tensor, logs: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
        """ONE host readback for every log scalar (trainer.py:314-319)."""
        logs = dict(logs, loss=loss.detach())
        keys = sorted(logs)
        vals = torch.stack([logs[k].float() for k in keys]).tolist()
        return dict(zip(keys, vals))

    def train_step(self, images, keypoints, mask=None, window=None
                   ) -> Dict[str, float]:
        """One guarded optimizer step on a batch: images (B, H, W, 3) fp32
        (or uint8 with `window`), keypoints (B, N, 18, 3), optional mask
        (B, h, w, 1).  Returns the logs as floats, with ``loss`` and
        ``skipped_nonfinite``."""
        self.model.train()
        images, keypoints, mask = self._to_device(images, keypoints, mask,
                                                  window)
        buffers = [b.detach().clone() for b in self.model.buffers()]
        loss, logs = self._loss(images, keypoints, mask)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        logs = self._readback(loss, logs)
        self.step += 1
        finite = math.isfinite(logs["loss"])
        logs["skipped_nonfinite"] = 0.0 if finite else 1.0
        if not finite:
            with torch.no_grad():
                for b, saved in zip(self.model.buffers(), buffers):
                    b.copy_(saved)
            return logs
        self._update(list(grads))
        return logs

    @torch.no_grad()
    def _update(self, grads: List[torch.Tensor]) -> None:
        for name, g in zip(self.params, grads):
            if name in self.frozen:
                g.zero_()
        k = self.cfg.train.grad_accum_steps
        if k > 1:
            if self.accum is None:
                self.accum = [torch.zeros_like(g) for g in grads]
            n = float(self.mini_step + 1)
            for acc, g in zip(self.accum, grads):
                acc.add_((g - acc) / n)          # optax's Welford mean
            self.mini_step += 1
            if self.mini_step < k:
                return
            grads, self.accum, self.mini_step = self.accum, None, 0
        max_norm = self.cfg.train.clip_grad_norm
        if max_norm > 0:
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            keep = norm < max_norm
            grads = [torch.where(keep, g, (g / norm) * max_norm)
                     for g in grads]
        for p, g in zip(self.params.values(), grads):
            p.grad = g
        self.optimizer.step()
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def eval_step(self, images, keypoints, mask=None, window=None
                  ) -> Dict[str, float]:
        self.model.eval()
        images, keypoints, mask = self._to_device(images, keypoints, mask,
                                                  window)
        loss, logs = self._loss(images, keypoints, mask)
        return self._readback(loss, logs)

    # ---- phase control ----------------------------------------------------

    def maybe_release_backbone(self) -> None:
        """End of the freeze phase (reference train_VGG19.py:323-330)."""
        if self.epoch == self.cfg.train.freeze_base_epochs:
            self.frozen = set()

    # ---- state ------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """Everything the next step depends on (the JAX TrainState)."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "lr": self.lr,
                "frozen": sorted(self.frozen), "accum": self.accum,
                "mini_step": self.mini_step}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.lr = state["lr"]
        self.frozen = set(state["frozen"])
        self.accum = None if state["accum"] is None else \
            [a.to(self.device) for a in state["accum"]]
        self.mini_step = int(state["mini_step"])

    def restore(self, restored) -> None:
        """Load a ``CheckpointManager.restore*`` result (state, meta)."""
        state, meta = restored
        self.load_state_dict(state)
        self.epoch = meta.get("epoch", 0)
        self.best_val = meta.get("best_val", float("inf"))
        self.plateau.load_state_dict(meta.get("plateau",
                                              self.plateau.state_dict()))

    # ---- epoch loops ------------------------------------------------------

    def run_epoch(self, loader: Iterable[Batch], train: bool = True,
                  log_every: Optional[int] = None,
                  ckpt: Optional[CheckpointManager] = None) -> Dict:
        """One epoch over batches of ``image``, ``keypoints`` and optional
        ``mask`` / ``valid_xywh`` (uint8 images with their content
        window); with `ckpt` and cfg.train.checkpoint_every_steps > 0, also
        writes mid-epoch checkpoints.  Returns the per-image mean of each
        log, and per step, ``data_s``, the seconds it waited for its batch
        (from the end of the step before), and ``step_s``, those seconds
        and the step's own."""
        log_every = log_every or self.cfg.train.print_freq
        every = self.cfg.train.checkpoint_every_steps
        meters: Dict[str, AverageMeter] = {}
        data_s: List[float] = []
        step_s: List[float] = []
        tic = time.perf_counter()
        step_fn = self.train_step if train else self.eval_step
        for i, batch in enumerate(loader):
            n_img = len(batch["image"])
            data_s.append(time.perf_counter() - tic)
            logs = step_fn(batch["image"], batch["keypoints"],
                           batch.get("mask"), batch.get("valid_xywh"))
            for k, v in logs.items():
                meters.setdefault(k, AverageMeter()).update(v, n=n_img)
            step_s.append(time.perf_counter() - tic)
            tic = time.perf_counter()
            if i % log_every == 0:
                phase = "train" if train else "val"
                print(f"[{phase}] epoch {self.epoch} it {i} "
                      f"loss {logs['loss']:.5f} "
                      f"data {sum(data_s) / len(data_s):.3f}s "
                      f"step {sum(step_s) / len(step_s):.3f}s")
                if train:
                    self.metrics.log(self.step, logs, prefix="train/")
            if train and ckpt is not None and every and (i + 1) % every == 0:
                ckpt.save(self.state_dict(), step=self.step,
                          meta={"epoch": self.epoch, "mid_epoch": True,
                                "best_val": self.best_val,
                                "plateau": self.plateau.state_dict()})
        return {**{k: m.avg for k, m in meters.items()},
                "data_s": data_s, "step_s": step_s}

    def fit(self, train_loader: Iterable[Batch], val_loader: Iterable[Batch],
            *, epochs: Optional[int] = None,
            checkpoint_dir: Optional[str] = None) -> List[Dict]:
        """Train `epochs` epochs (cfg.train.epochs by default), each with
        a val epoch, the plateau schedule and a checkpoint.  Returns each
        epoch's ``{"train": logs, "val": logs}`` (``run_epoch``'s)."""
        history = []
        ckpt = CheckpointManager(
            checkpoint_dir or self.cfg.train.checkpoint_dir,
            keep=self.cfg.train.keep_checkpoints)
        if self.cfg.train.resume:
            restored = ckpt.restore_latest(self.device)
            if restored is not None:
                self.restore(restored)
        for _ in range(epochs or self.cfg.train.epochs):
            self.maybe_release_backbone()
            train_logs = self.run_epoch(train_loader, train=True, ckpt=ckpt)
            val_logs = self.run_epoch(val_loader, train=False)
            history.append({"train": train_logs, "val": val_logs})
            if "loss" not in val_logs:
                raise RuntimeError(
                    "validation epoch produced no batches: build the val "
                    "loader with drop_last=False")
            val_loss = val_logs["loss"]
            self.lr = self.plateau.step(val_loss)
            is_best = val_loss < self.best_val
            self.best_val = min(val_loss, self.best_val)
            self.epoch += 1
            # the global optimizer step, the namespace of the mid-epoch
            # saves (trainer.py:373-377)
            ckpt.save(self.state_dict(), step=self.step, is_best=is_best,
                      meta={"epoch": self.epoch, "best_val": self.best_val,
                            "plateau": self.plateau.state_dict(),
                            "val_loss": val_loss,
                            "train_loss": train_logs["loss"]})
            print(f"epoch {self.epoch}: train {train_logs['loss']:.5f} "
                  f"val {val_loss:.5f} lr {self.lr:.4f} best={is_best}")
        return history
