"""PyTorch / CUDA port of the taskgraph package (``repro``).

The JAX package under ``src/repro`` is the reference; this package mirrors
its module paths (``configs``, ``kernels``, ``models``, ``training``,
``optim``, ``data``, ``checkpoint``, ``runtime``, ``core``, ``serving``,
``launch``) so each counterpart is easy to find; the entry points are
``launch.serve`` and ``launch.train``. It imports ``torch`` and never
``jax`` or anything of ``repro``.

Kernels that the reference writes in Pallas for the TPU are CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` at first use and bound through
``ctypes``; each has a plain PyTorch version beside it (``kernels/ref.py``)
that CPU tensors take.
"""
