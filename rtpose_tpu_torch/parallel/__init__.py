"""Data- and tensor-parallel runs over ``torch.distributed`` (port of
rtpose_tpu/parallel/): the ``data`` x ``model`` mesh (``mesh.py``), the
tensor-parallel rule and its column-parallel convolution
(``sharding.py``), and the work split across processes with its
collectives (``distributed.py``)."""
