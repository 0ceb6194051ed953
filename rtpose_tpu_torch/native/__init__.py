"""Native host code of the port: the C++ image pipeline of the training
loader (``imgpipe.cpp``, a copy of the JAX package's) and its ctypes
binding."""
