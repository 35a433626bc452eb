"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object
of its own, all sources at once in parallel, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
library lives in ``build/torch_kernels/`` at the root of the checkout and is
named by a hash of the sources, so it is built at first use and again
whenever a source changes.  Nothing here runs at import: the CPU tests
import every module on machines without ``nvcc`` or a GPU.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception,
so a launch the device refused never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

P = ctypes.c_void_p
I = ctypes.c_int          # noqa: E741
F = ctypes.c_float
L = ctypes.c_longlong

_lock = threading.Lock()
_lib = None
_functions: dict = {}
build_seconds = None     # wall time of the build this process ran, if any


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the port's CUDA kernels cannot be built here")


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{source_hash()}.so"


def build() -> Path:
    """Compile and link the kernels unless the current library exists.
    The compiler's register and spill report goes to ``build.log``."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    t0 = time.perf_counter()
    nvcc = _nvcc()
    work = BUILD_DIR / f"obj_{source_hash()}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = work / lib.name
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)          # atomic: a concurrent loader sees all or none
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def function(name: str, argtypes: list):
    """The C entry ``name`` with its argument types declared (every pointer
    and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(code: int, name: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if code != 0:
        msg = library().rt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def null_launch(stream: int) -> None:
    """Launch the library's empty kernel on ``stream`` (launch-cost probe)."""
    check(function("rt_null_launch", [P])(stream), "rt_null_launch")


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}") \
            from None


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is on one CUDA device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: CUDA kernel needs all tensors on one CUDA "
                         f"device, got {sorted(map(str, devs))}")


def nbytes(*tensors) -> int:
    """Bytes of the given tensors' elements (None counts nothing): what a
    kernel moves reading each once, for its cost (``core/costs.py``)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def require_placed(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on the CPU (the plain version) or a CUDA
    device (the kernel): a wrapper has no third route."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: runs the plain version on the CPU or the "
                         f"CUDA kernel, got a tensor on {t.device}")
