"""Data of the port: ground-truth synthesis (``gt.py``), the COCO
annotation reader (``coco_json.py``) and the image reader (``imread.py``,
``cv2.imread``'s frame without cv2).  The COCO training loaders of
rtpose_tpu/data are not ported yet, see ROADMAP.md."""
