"""Training data of the port: ground-truth synthesis (the COCO loaders of
rtpose_tpu/data are not ported yet, see ROADMAP.md)."""
