"""Build the port's hand-written CUDA kernels and bind them with ctypes.

At first use on a CUDA tensor, every ``csrc/*.cu`` source is compiled by
its own ``nvcc`` process, all started together, and the objects are linked
into one shared library with a plain C interface, in
``r3dfsseg_tpu_torch/_build/`` and named by a hash of the sources and
flags, so an unchanged tree reuses its library.  Nothing here runs at
import time: a machine without nvcc imports the package and uses the
plain PyTorch versions on CPU tensors.

Every entry point takes its pointers and the CUDA stream as ``void*``
(``ctypes.c_void_p``) and returns ``cudaGetLastError()``; `check` raises
on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_fns: dict = {}
build_log = ""          # nvcc's output of the build this process ran, if any


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> pathlib.Path:
    """Build the kernel library if this tree's sources have none yet."""
    global build_log
    srcs = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libr3d_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    obj_dir = pathlib.Path(tempfile.mkdtemp(prefix="obj_", dir=BUILD_DIR))
    try:
        nvcc = _nvcc()
        objs = [obj_dir / f"{p.stem}.o" for p in srcs if p.suffix == ".cu"]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / f"{o.stem}.cu"),
                                   "-o", str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for o in objs]
        logs = [p.communicate()[0] for p in procs]
        for o, p, log in zip(objs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {o.stem}.cu with code {p.returncode}:\n{log}")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {link.returncode}:\n{link.stderr}")
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    build_log = "".join(logs)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(library_path()))
            _lib.r3d_error_string.argtypes = [ctypes.c_int]
            _lib.r3d_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes, restype=ctypes.c_int):
    """The library's entry point ``name`` with its C signature declared."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[name] = fn
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().r3d_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
F = ctypes.c_float
