"""COCO evaluation of the port: the harness (``harness.py``), the native
OKS evaluator (``cocoeval.py``) and the CLI (``python -m
rtpose_tpu_torch.evalx``)."""
