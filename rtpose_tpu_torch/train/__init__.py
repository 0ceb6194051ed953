"""Training of the port: loss, LR schedule, checkpoints and the trainer
(port of rtpose_tpu/train; the CLI and COCO loaders are not ported yet)."""
