"""Data of the port: ground-truth synthesis (``gt.py``), the COCO
annotation reader (``coco_json.py``), the image reader and writer
(``imread.py``, ``imwrite.py``: cv2's frames without cv2), the training
transforms and datasets with the worker-process loader (``transforms.py``,
``dataset.py``), the native loader over the C++ pool
(``native_loader.py``) and cv2's resize and warp without cv2
(``cv2exact.py``)."""
