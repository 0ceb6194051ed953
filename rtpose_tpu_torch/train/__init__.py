"""Training of the port: loss, LR schedule, checkpoints, the trainer and
the training CLI (port of rtpose_tpu/train)."""
