"""Native (C) episode assembly, built with the C compiler at first use and
loaded through ctypes (counterpart of `r3dfsseg_tpu/native/`).

`assemble_scan()` returns the C function, or None where the build fails
(no compiler) or ``R3D_DISABLE_NATIVE`` is set; callers then take the numpy
path.  The two paths draw the same RNG stream and give the same episodes
(tests/test_torch_data.py).  Nothing is built when the module is imported:
the first call compiles `episode_ops.c` into `_build/` beside it.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "episode_ops.c")

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_long, ctypes.c_long,   # data, n_rows, n_cols
    ctypes.c_void_p, ctypes.c_long,                  # idx, num_point
    ctypes.c_void_p,                                 # aug_m | NULL
    ctypes.c_void_p,                                 # jitter | NULL
    ctypes.c_int, ctypes.c_int, ctypes.c_int,        # use_xyz/rgb/XYZ
    ctypes.c_long, ctypes.c_void_p, ctypes.c_long,   # class, classes, n
    ctypes.c_int,                                    # support
    ctypes.c_long,                                   # cluster_col
    ctypes.c_void_p, ctypes.c_void_p,                # out_pt, out_label
    ctypes.c_void_p, ctypes.c_void_p,                # out_gt, out_cluster
]


def _build() -> str:
    """Compile episode_ops.c into a cached shared object; returns its path."""
    build_dir = os.path.join(_HERE, "_build")
    os.makedirs(build_dir, exist_ok=True)
    so = os.path.join(build_dir, "libepisode_ops.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    # build under a temporary name, then rename: concurrent processes may
    # race the build
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


@functools.lru_cache(maxsize=1)
def _load():
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.CalledProcessError):
        return None
    fn = lib.assemble_scan
    fn.restype = ctypes.c_long
    fn.argtypes = _ARGTYPES
    return fn


def assemble_scan():
    """The C `assemble_scan`, or None: ``R3D_DISABLE_NATIVE`` set, or the
    build failed."""
    if os.environ.get("R3D_DISABLE_NATIVE"):
        return None
    return _load()
