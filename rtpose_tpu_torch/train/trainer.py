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

With a ``mesh`` over a process group (``parallel/mesh.py``) the trainer
is one rank of the JAX package's mesh trainer (trainer.py:185-252,300):

- each rank of the ``data`` axis gets its rows of the global batch
  (``cfg.train.batch_size``; the loaders' ``rank`` / ``world``, or
  ``parallel.distributed.rank_rows``), and the gradients are all-reduced
  as one flat bucket over the data group and divided by its size before
  the freeze mask, the accumulation and the clip see them: the mean of
  equal shards, the global batch's gradient (``torch.autograd.grad``
  bypasses ``DistributedDataParallel``'s reducer);
- the logs are global: the losses all-reduce as means, ``max_*`` /
  ``min_*`` as the maximum / minimum, and the non-finite guard, the
  plateau schedule and ``best_val`` read the global values, so every rank
  takes the same decisions and keeps the same learning rate;
- BatchNorm takes its statistics over the global batch
  (``models.common.set_data_group``);
- with ``num_model > 1`` the convs ``param_spec`` shards are
  column-parallel over the model group (``parallel/sharding.py``); the
  clip sums a sharded parameter's squares over the model group, a
  replicated one's once; ``state_dict`` gathers the full model and
  momentum (every rank calls it), so a checkpoint loads unsharded, and
  ``load_state_dict`` cuts a full one to the rank's rows.  K4 runs on
  every rank (the JAX trainer falls back to XLA's GT on a TP mesh,
  trainer.py:74-78; the maps are the same);
- rank 0 alone writes checkpoints and logs; every rank restores.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import torch
import torch.distributed as dist

from ..config import Config
from ..data.gt import ground_truth_maps_batch
from ..device import resolve_device
from ..infer.preprocess import IMAGENET_MEAN, IMAGENET_STD, constants_on
from ..models import get_model
from ..models.common import he_reinit, set_data_group
from ..models.convert import load_strict
from ..parallel.distributed import rank_and_world, sync_hosts
from ..parallel.mesh import replicate
from ..parallel.sharding import (full_state_dict, gather_rows, own_rows,
                                 shard_module, shard_state_dict)
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
                 log_dir: Optional[str] = None, mesh=None,
                 init_fn=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is not None and mesh.size > 1 and not mesh.distributed:
            raise ValueError("a training mesh of several positions needs "
                             "one process per position: start the ranks "
                             "(torchrun) and build the mesh over their "
                             "process group")
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        self.is_writer = rank_and_world()[0] == 0
        self.metrics = MetricLogger(log_dir if self.is_writer else None,
                                    tensorboard=bool(log_dir)
                                    and self.is_writer)
        dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" \
            else torch.float32
        gen = torch.Generator().manual_seed(cfg.train.seed)
        model = get_model(cfg.model.name, num_stages=cfg.model.num_stages,
                          dtype=dtype, generator=gen)
        if state_dict is not None:
            load_strict(model, state_dict)
        elif cfg.model.init_scheme == "scratch":
            he_reinit(model, gen)
        if init_fn is not None:
            init_fn(model)        # on the full model, before any sharding
        self.model = model.to(self.device)
        self.sharded: List[str] = []
        if self.mesh is not None:
            replicate(self.mesh, self.model)
            set_data_group(self.model, self.mesh.data_group)
            self.sharded = shard_module(self.model, self.mesh)
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

    def _readback(self, loss: torch.Tensor, logs: Dict[str, torch.Tensor],
                  n_img: int) -> Dict[str, float]:
        """ONE host readback for every log scalar (trainer.py:314-319);
        with a mesh, of the global values (trainer.py:247)."""
        logs = dict(logs, loss=loss.detach())
        keys = sorted(logs)
        vals = torch.stack([logs[k].float() for k in keys])
        if self.mesh is None:
            return dict(zip(keys, vals.tolist()))
        *vals, total, most = self._global_logs(keys, vals, n_img).tolist()
        if total != self.mesh.num_data * most:
            raise ValueError(f"the data-parallel ranks got unequal rows "
                             f"({total:g} in all, at most {most:g} a rank):"
                             f" the mean of their gradients is the global "
                             f"batch's only for equal shards")
        return dict(zip(keys, vals))

    def _global_logs(self, keys: List[str], vals: torch.Tensor,
                     n_img: int) -> torch.Tensor:
        """Losses as means over the data group, ``max_*`` / ``min_*`` as
        the maximum / minimum: one SUM and one MAX all-reduce, each with
        the rank's row count -> the global values, the rows in all and
        the most rows a rank had."""
        group, dev = self.mesh.data_group, vals.device
        is_max = torch.tensor([k.startswith("max_") for k in keys],
                              device=dev)
        is_min = torch.tensor([k.startswith("min_") for k in keys],
                              device=dev)
        is_mean = ~(is_max | is_min)
        count = vals.new_full((1,), float(n_img))
        sums = torch.cat([torch.where(is_mean, vals, 0.0), count])
        peaks = torch.cat([torch.where(is_max, vals, torch.where(
            is_min, -vals, float("-inf"))), count])
        dist.all_reduce(sums, group=group)
        dist.all_reduce(peaks, op=dist.ReduceOp.MAX, group=group)
        means = sums[:-1] / sums.new_full((), float(self.mesh.num_data))
        return torch.cat([torch.where(is_mean, means, torch.where(
            is_max, peaks[:-1], -peaks[:-1])), sums[-1:], peaks[-1:]])

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
        logs = self._readback(loss, logs, len(images))
        self.step += 1
        finite = math.isfinite(logs["loss"])
        logs["skipped_nonfinite"] = 0.0 if finite else 1.0
        if not finite:
            with torch.no_grad():
                for b, saved in zip(self.model.buffers(), buffers):
                    b.copy_(saved)
            return logs
        grads = list(grads)
        if self.mesh is not None:
            grads = self._all_reduce_mean(grads)
        self._update(grads)
        return logs

    @torch.no_grad()
    def _all_reduce_mean(self, grads: List[torch.Tensor]
                         ) -> List[torch.Tensor]:
        """The mean of the data group's gradients, all-reduced as one flat
        bucket."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.data_group)
        flat /= flat.new_full((), float(self.mesh.num_data))
        return [part.view_as(g) for part, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

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
            norm = torch.sqrt(self._square_norm(grads))
            keep = norm < max_norm
            grads = [torch.where(keep, g, (g / norm) * max_norm)
                     for g in grads]
        for p, g in zip(self.params.values(), grads):
            p.grad = g
        self.optimizer.step()
        for p in self.params.values():
            p.grad = None

    def _square_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global squared norm: a sharded parameter's squares summed
        over the model group, a replicated one's counted once."""
        if not self.sharded:
            return sum(g.square().sum() for g in grads)
        sharded = set(self.sharded)
        parts = [g.square().sum() for g in grads]
        local = sum(q for name, q in zip(self.params, parts)
                    if name in sharded)
        dist.all_reduce(local, group=self.mesh.model_group)
        return sum(q for name, q in zip(self.params, parts)
                   if name not in sharded) + local

    @torch.no_grad()
    def eval_step(self, images, keypoints, mask=None, window=None
                  ) -> Dict[str, float]:
        self.model.eval()
        images, keypoints, mask = self._to_device(images, keypoints, mask,
                                                  window)
        loss, logs = self._loss(images, keypoints, mask)
        return self._readback(loss, logs, len(images))

    # ---- phase control ----------------------------------------------------

    def maybe_release_backbone(self) -> None:
        """End of the freeze phase (reference train_VGG19.py:323-330)."""
        if self.epoch == self.cfg.train.freeze_base_epochs:
            self.frozen = set()

    # ---- state ------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """Everything the next step depends on (the JAX TrainState), for
        the unsharded model: under tensor parallelism a collective that
        gathers the sharded parameters, momenta and accumulators."""
        optimizer = self.optimizer.state_dict()
        accum = self.accum
        if self.sharded:
            rows = self._sharded_rows()
            # (the packed state holds the optimizer's own per-parameter
            # dicts: replace them, never write into them)
            optimizer["state"] = {
                i: ({**st, "momentum_buffer": gather_rows(
                    st["momentum_buffer"], self.mesh)}
                    if i in rows and "momentum_buffer" in st else st)
                for i, st in optimizer["state"].items()}
            if accum is not None:
                accum = [gather_rows(a, self.mesh) if i in rows else a
                         for i, a in enumerate(accum)]
        return {"step": self.step, "model": self.model_state_dict(),
                "optimizer": optimizer, "lr": self.lr,
                "frozen": sorted(self.frozen), "accum": accum,
                "mini_step": self.mini_step}

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict, sharded parameters gathered (every rank
        of the model group calls it)."""
        if self.sharded:
            return full_state_dict(self.model, self.sharded, self.mesh)
        return self.model.state_dict()

    def _sharded_rows(self):
        """Indices (optimizer order) of the sharded parameters."""
        sharded = set(self.sharded)
        return {i for i, name in enumerate(self.params) if name in sharded}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        model, optimizer, accum = (state["model"], state["optimizer"],
                                   state["accum"])
        if self.sharded:
            rows = self._sharded_rows()
            model = shard_state_dict(model, self.sharded, self.mesh)
            optimizer = {**optimizer, "state": {
                i: ({**st, "momentum_buffer": own_rows(
                    st["momentum_buffer"], self.mesh)}
                    if i in rows and "momentum_buffer" in st else st)
                for i, st in optimizer["state"].items()}}
            if accum is not None:
                accum = [own_rows(a, self.mesh) if i in rows else a
                         for i, a in enumerate(accum)]
        self.model.load_state_dict(model)
        self.optimizer.load_state_dict(optimizer)
        self.step = int(state["step"])
        self.lr = state["lr"]
        self.frozen = set(state["frozen"])
        self.accum = None if accum is None else \
            [a.to(self.device) for a in accum]
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
            if i % log_every == 0 and self.is_writer:
                phase = "train" if train else "val"
                print(f"[{phase}] epoch {self.epoch} it {i} "
                      f"loss {logs['loss']:.5f} "
                      f"data {sum(data_s) / len(data_s):.3f}s "
                      f"step {sum(step_s) / len(step_s):.3f}s")
                if train:
                    self.metrics.log(self.step, logs, prefix="train/")
            if train and ckpt is not None and every and (i + 1) % every == 0:
                self._save(ckpt, meta={"epoch": self.epoch,
                                       "mid_epoch": True,
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
            self._save(ckpt, is_best=is_best,
                       meta={"epoch": self.epoch, "best_val": self.best_val,
                             "plateau": self.plateau.state_dict(),
                             "val_loss": val_loss,
                             "train_loss": train_logs["loss"]})
            if self.is_writer:
                print(f"epoch {self.epoch}: train {train_logs['loss']:.5f} "
                      f"val {val_loss:.5f} lr {self.lr:.4f} "
                      f"best={is_best}")
        return history

    def _save(self, ckpt: CheckpointManager, **kwargs) -> None:
        """Every rank gathers the state; rank 0 writes it; the others wait
        for the file."""
        state = self.state_dict()
        if self.is_writer:
            ckpt.save(state, step=self.step, **kwargs)
        if self.mesh is not None:
            sync_hosts("checkpoint")
