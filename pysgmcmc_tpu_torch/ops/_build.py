"""Build and bind the port's CUDA kernels.

``csrc/fused_step.cu`` is compiled with ``nvcc`` at first use into a shared
library with a plain C interface, under ``pysgmcmc_tpu_torch/_build/``,
named by a hash of the source and the flags (so an edited source rebuilds),
and loaded with ``ctypes``.  The compiler's report (``ptxas -v``: registers,
shared memory and spills of every kernel) is kept beside the library as a
``.log`` file.  Nothing here runs at import time: the CPU test suite imports
every module on a machine without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_step.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# largest dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_ulonglong
_U32 = ctypes.c_uint
# every launch entry takes the same arguments (csrc/fused_step.cu,
# FUSED_STEP_ENTRY): 6 state inputs, x, y, tab, noise, widx, 6 state outputs
# and the cost; 8 ints, the seed, the step, 5 floats and the stream
_LAUNCH = (_I, [_P] * 18 + [_I] * 8 + [_U64, _U32] + [_F] * 5 + [_P])
_SIGNATURES = {
    "fused_step_smem_bytes": (_U64, [_I, _I, _I, _I, _I, _I]),
    "fused_step_error_string": (ctypes.c_char_p, [_I]),
    **{name + "_launch": _LAUNCH for name in (
        "fused_bnn_multistep",                # B1
        "fused_bnn_multistep_burnin",         # B2
        "fused_bnn_step",                     # B3
        "fused_bnn_step_sgld",                # B4-sgld
        "fused_bnn_multistep_sgld",           # B5-sgld
        "fused_bnn_multistep_burnin_sgld",    # B6
    )},
}

_lib = None


def _nvcc():
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin, default "
        "/usr/local/cuda): the port's CUDA kernels cannot be built")


def library_path():
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(
        BUILD_DIR, "fused_step_{}.so".format(digest.hexdigest()[:16]))


def log_path():
    """The ``ptxas -v`` report of :func:`library_path`'s build."""
    return os.path.splitext(library_path())[0] + ".log"


def build():
    """Compile the kernels if this source has no library yet; returns
    ``(path, seconds_spent_compiling)``."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    start = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed on {}:\n{}{}".format(
                    SOURCE, proc.stdout, proc.stderr))
        with open(log_path(), "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, path)  # atomic: a concurrent build never loads half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, time.perf_counter() - start


def load():
    """The bound kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def check(code):
    """Raise on a non-zero ``cudaError_t`` returned by a launch entry."""
    if code != 0:
        raise RuntimeError("CUDA kernel launch failed: {} ({})".format(
            load().fused_step_error_string(code).decode(), code))
