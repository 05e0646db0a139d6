"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc, one process per source, all started
together, and linked into one shared library with a plain C interface,
loaded with ctypes. The build runs at first use, into the checkout's
git-ignored `build/` directory, under a name keyed by a hash of the sources
and flags: an edited source is rebuilt, a built one is reused.

`-fmad=false` and IEEE `sqrtf`/division (no `--use_fast_math`) keep every
multiply and add rounded on its own, as the plain PyTorch twins compute
them, so a kernel and its twin agree to the last few ulps of the
transcendental functions.

`LAUNCHES` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a caller can show which kernels a
run went through.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

LAUNCHES: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_LIB = None
BUILD_LOG = ""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points (csrc/*.cu): name -> argtypes. Each returns cudaError_t.
_SIGNATURES = {
    # rows, n_rows, sph, n_sph, pln, n_pln, o, d, t_init, side, n,
    # t_out, key_out, stream
    "bhrt_stream_closest": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I,
                            _P, _P, _P],
    # rows, n_rows, sph, n_sph, pln, n_pln, o, d, t_max, t_min, ana_bias,
    # plane_world_bug, n, occ_out, stream
    "bhrt_stream_anyhit": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _F, _F, _I,
                           _I, _P, _P],
    # planes, hits, u, resolve_rows, n_faces, inst_tab, n_sph, n_pln, n_msh,
    # mtl_tab, n_mtl, light_tab, n_lights, bias, n, out, stream
    "bhrt_shade_setup": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _I, _P, _I,
                         _F, _I, _P, _P],
    # nodes, faces, sph, n_sph, pln, n_pln, o, d, t_init, side, n, t_out,
    # key_out, counts (or NULL), stream
    "bhrt_bvh_closest": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _P, _P,
                         _P, _P],
    # nodes, faces, sph, n_sph, pln, n_pln, o, d, t_max, t_min, ana_bias,
    # plane_world_bug, n, occ_out, counts (or NULL), stream
    "bhrt_bvh_anyhit": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _F, _F, _I, _I,
                        _P, _P, _P],
    # rows, boxes, n_groups, group, sph, n_sph, pln, n_pln, o, d, t_init,
    # side, n, t_out, key_out, stream
    "bhrt_stream_closest_hbm": [_P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P,
                                _I, _I, _P, _P, _P],
    # rows, boxes, n_groups, group, sph, n_sph, pln, n_pln, o, d, t_max,
    # t_min, ana_bias, plane_world_bug, n, occ_out, stream
    "bhrt_stream_anyhit_hbm": [_P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P,
                               _F, _F, _I, _I, _P, _P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"bhrt_kernels_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> str:
    """Compile the kernels if the hashed library is missing; returns its
    path. One nvcc per source, all at once, then one link. nvcc's output
    (with -Xptxas -v: registers, shared memory and spills per kernel) is
    kept in BUILD_LOG and written beside the library as `<library>.log`."""
    global BUILD_LOG
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(cu) + ".o") for cu in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, cu],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cu, obj in zip(cus, objs)]
        logs = [f"== {os.path.basename(cu)} ==\n{p.communicate()[0]}"
                for cu, p in zip(cus, procs)]
        ok = all(p.returncode == 0 for p in procs)
        if ok:
            r = subprocess.run([nvcc, "-shared", "-o", f"{tmp}/lib.so", *objs],
                               capture_output=True, text=True)
            logs.append(f"== link ==\n{r.stdout}{r.stderr}")
            ok = r.returncode == 0
        BUILD_LOG = "\n".join(logs)
        if not ok:
            raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
        with open(f"{so}.log", "w") as f:
            f.write(BUILD_LOG)
        os.replace(f"{tmp}/lib.so", so)
    return so


def lib():
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB


def launch(name: str, *args) -> None:
    """Launch `name` on the current CUDA stream and count it. Pointer
    arguments are tensors (passed by data_ptr), ints, or None (NULL)."""
    fn = getattr(lib(), name)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*conv, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    LAUNCHES[name] += 1


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_counts(counts, o, shape: tuple) -> None:
    """A kernel's optional work-count output: None, or a contiguous int32
    tensor of `shape` on the rays' CUDA device (the twins count nothing)."""
    if counts is not None:
        require(o.device.type == "cuda", "counts: kernels only")
        require(counts.dtype == torch.int32 and counts.is_contiguous()
                and tuple(counts.shape) == shape and counts.device == o.device,
                f"counts: {shape} int32 on the rays' device expected")
