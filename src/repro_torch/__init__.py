"""PyTorch + CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``core``, ``layers``, ``models``, ``kernels``,
``kvcache``, ``inference``, ``launch``, ``telemetry``) and imports only
``torch``, numpy and the standard library.  Every Pallas kernel on the ported path is a hand-written
CUDA C++ kernel for ``sm_90a`` (``csrc/``), built at first use by
``kernels.build`` and launched through ``ctypes``.  Entry points take an
explicit ``device``: ``"cuda"`` by default, ``"cpu"`` only when asked, and a
wrapper given a CPU tensor runs its kernel's plain PyTorch version.
"""
