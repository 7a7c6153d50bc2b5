"""Build and bind the port's CUDA kernels.

Each source of ``csrc/`` (``fused_step.cu``, ``fused_step_clt.cu``,
``fused_step_paired.cu``, ``slim_update.cu``, ``svgd_streaming.cu``; the
three fused sources share ``fused_body.cuh``, and it and
``svgd_streaming.cu`` the tensor-core helpers of ``tf32.cuh``) is compiled
with ``nvcc`` at first use into a shared
library with a plain C interface, under ``pysgmcmc_tpu_torch/_build/``, and
loaded with ``ctypes``.  A library's name carries a hash of every source and
header of ``csrc/`` and of the flags, so an edited header rebuilds them
all.  The sources compile in
parallel, one ``nvcc`` each, but for the three fused sources: each of
those compiles as ``PARTS`` objects at once (``-DFUSED_PART=i``, each with
its share of the entries), which one more ``nvcc`` links into the
library.  The compiler's report (``ptxas -v``:
registers, shared memory and spills of every kernel) is kept beside each
library as a ``.log`` file.  Nothing here runs at import time: the CPU test
suite imports every module on a machine without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
# csrc/<name>.cu -> one library each
SOURCES = ("fused_step", "fused_step_clt", "fused_step_paired",
           "slim_update", "svgd_streaming")
# the fused sources' parts (csrc/fused_body.cuh, FUSED_PART): ptxas on the
# tensor-core body takes most of a build
PARTS = {"fused_step": 3, "fused_step_clt": 3, "fused_step_paired": 3}
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# largest dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_ulonglong
_U32 = ctypes.c_uint
# every launch entry of csrc/fused_step*.cu takes the same arguments
# (FUSED_STEP_ENTRY): 7 state inputs, x, y, tab, noise, widx, 7 state
# outputs and the cost; 8 ints, the seed, the step, 7 floats, the two bf16
# flags, the workspace and the stream
_FUSED_LAUNCH = (_I, [_P] * 20 + [_I] * 8 + [_U64, _U32] + [_F] * 7
                 + [_I, _I, _P, _P])
# and every one of csrc/slim_update.cu (SLIM_ENTRY): 10 inputs, 6 outputs,
# 2 ints, the seed, the step, 7 floats, the three bf16 flags, the mask and
# noise-index rows, the burning_in flag and the stream
_SLIM_LAUNCH = (_I, [_P] * 16 + [_I] * 2 + [_U64, _U32] + [_F] * 7
                + [_I] * 3 + [_P, _P, _I] + [_P])
# the twelve fused kernels, by their wrappers' names; each has a Box-Muller
# and a CLT entry, and the first eight a paired one
_FUSED_KERNELS = (
    "fused_bnn_multistep",                # B1
    "fused_bnn_multistep_burnin",         # B2
    "fused_bnn_step",                     # B3
    "fused_bnn_multistep_sgld",           # B5-sgld
    "fused_bnn_multistep_burnin_sgld",    # B6
    "fused_bnn_multistep_psgld",          # B5-psgld
    "fused_bnn_multistep_sgnht",          # B5-sgnht
    "fused_bnn_multistep_rsghmc",         # B5-rsghmc
    "fused_bnn_step_sgld",                # B4-sgld
    "fused_bnn_step_psgld",               # B4-psgld
    "fused_bnn_step_sgnht",               # B4-sgnht
    "fused_bnn_step_rsghmc",              # B4-rsghmc
)
_SIGNATURES = {
    "fused_step_clt": {
        "fused_step_clt_error_string": (ctypes.c_char_p, [_I]),
        **{name + "_clt_launch": _FUSED_LAUNCH for name in _FUSED_KERNELS},
    },
    "fused_step_paired": {
        "fused_step_paired_error_string": (ctypes.c_char_p, [_I]),
        **{name + "_paired_launch": _FUSED_LAUNCH
           for name in _FUSED_KERNELS[:8]},
    },
    "fused_step": {
        "fused_step_smem_bytes": (_U64, [_I, _I, _I, _I, _I, _I]),
        "fused_step_workspace_floats": (_U64, [_I, _I]),
        "fused_step_error_string": (ctypes.c_char_p, [_I]),
        **{name + "_launch": _FUSED_LAUNCH for name in _FUSED_KERNELS},
    },
    "slim_update": {
        "slim_update_error_string": (ctypes.c_char_p, [_I]),
        **{name + "_launch": _SLIM_LAUNCH for name in (
            "slim_sghmc_update",                  # B7
            "slim_sgld_update",                   # B8-sgld
            "slim_psgld_update",                  # B8-psgld
            "slim_rsghmc_update",                 # B8-rsghmc
            "slim_sgnht_update",                  # B8-sgnht
            "slim_sghmc_burnin_update",           # B9-sghmc
            "slim_sgld_burnin_update",            # B9-sgld
            "fused_sghmc_update",                 # B10
        )},
        # B7': the leaf table and its length, n_chains, n_params, the seed,
        # the step, eps, sqrt(scale_grad), mdecay, prior_scale, the bf16
        # gradient flag and the stream
        "slim_sghmc_update_tree_launch": (
            _I, [_P, _I, _I, _I, _U64, _U32] + [_F] * 4 + [_I, _P]),
    },
    "svgd_streaming": {
        "svgd_streaming_error_string": (ctypes.c_char_p, [_I]),
        "svgd_streaming_smem_bytes": (_U64, []),
        "svgd_streaming_active_clusters": (_I, []),
        # B11: x, g, h, phi, 2 scratch buffers; n, d; the stream
        "svgd_phi_streaming_launch": (_I, [_P] * 6 + [_I, _I, _P]),
    },
}

_libs = {}


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


def _source(name):
    return os.path.join(CSRC, name + ".cu")


def _digest():
    """Hash of every source and header of ``csrc/`` and of the flags."""
    digest = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC)):
        if fname.endswith((".cu", ".cuh")):
            digest.update(fname.encode())
            with open(os.path.join(CSRC, fname), "rb") as f:
                digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def library_path(name):
    """The shared library of source ``name`` (``csrc/<name>.cu``)."""
    return os.path.join(BUILD_DIR, "{}_{}.so".format(name, _digest()))


def log_path(name):
    """The ``ptxas -v`` report of :func:`library_path`'s build."""
    return os.path.splitext(library_path(name))[0] + ".log"


def _compile(name, tmp):
    """Starts the compiles of source ``name`` into the library ``tmp``:
    ``(processes, their object files)``; no objects where one ``nvcc``
    makes the library."""
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC]
    if name not in PARTS:
        return [subprocess.Popen(
            [*cmd, "-shared", "-o", tmp, _source(name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)], []
    objects = ["{}.{}.o".format(tmp, i) for i in range(PARTS[name])]
    return [subprocess.Popen(
        [*cmd, "-DFUSED_PART={}".format(i), "-c", "-o", obj, _source(name)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, obj in enumerate(objects)], objects


def build():
    """Compile every source that has no library yet, all at once; returns
    ``(paths by source name, seconds spent compiling)``."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = [name for name, path in paths.items() if not os.path.exists(path)]
    if not todo:
        return paths, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    start = time.perf_counter()
    jobs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs[name] = (tmp, *_compile(name, tmp))
        failed = []
        for name, (tmp, procs, objects) in jobs.items():
            outs = [proc.communicate() for proc in procs]
            report = "".join(out + err for out, err in outs)
            if any(proc.returncode != 0 for proc in procs):
                failed.append("nvcc failed on {}:\n{}".format(
                    _source(name), report))
                continue
            if objects:  # one library of the parts
                link = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                     *objects], capture_output=True, text=True)
                if link.returncode != 0:
                    failed.append("nvcc failed to link {}:\n{}{}".format(
                        _source(name), link.stdout, link.stderr))
                    continue
            with open(log_path(name), "w") as f:
                f.write(report)
            # atomic: a concurrent build never loads half a file
            os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for tmp, procs, objects in jobs.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for path in (tmp, *objects):
                if os.path.exists(path):
                    os.remove(path)
    return paths, time.perf_counter() - start


def load(name):
    """The bound kernel library of source ``name`` (built on first use)."""
    if name not in _libs:
        paths, _ = build()
        lib = ctypes.CDLL(paths[name])
        for fn_name, (restype, argtypes) in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[name] = lib
    return _libs[name]


def check(code, name):
    """Raise on a non-zero ``cudaError_t`` returned by a launch entry of
    source ``name``."""
    if code != 0:
        lib = load(name)
        raise RuntimeError("CUDA kernel launch failed: {} ({})".format(
            getattr(lib, name + "_error_string")(code).decode(), code))
