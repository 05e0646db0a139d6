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
_FNS: dict = {}  # name -> the loaded entry point, argument types set
BUILD_LOG = ""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points (csrc/*.cu): name -> argtypes. Each returns cudaError_t.
_SIGNATURES = {
    # rows, n_rows, super_boxes, cluster_boxes, n_super, cluster, sph,
    # n_sph, pln, n_pln, o, d, t_init, side, n, t_out, key_out, counts (or
    # NULL), work, stream
    "bhrt_stream_closest": [_P, _I, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P,
                            _P, _I, _I, _P, _P, _P, _P, _P],
    # rows, n_rows, super_boxes, cluster_boxes, n_super, cluster, sph,
    # n_sph, pln, n_pln, o, d, t_max, t_min, ana_bias, plane_world_bug, n,
    # occ_out, counts (or NULL), work, stream
    "bhrt_stream_anyhit": [_P, _I, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P,
                           _P, _F, _F, _I, _I, _P, _P, _P, _P],
    # o, d, kind, inst, face, front, shade, u, resolve_rows, n_faces,
    # inst_tab, n_sph, n_pln, n_msh, mtl_tab, n_mtl, light_tab, n_lights,
    # bias, n, vec_out, sca_out, mtl_out, flag_out, stream
    "bhrt_shade_setup": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I,
                         _I, _P, _I, _P, _I, _F, _I, _P, _P, _P, _P, _P],
    # pairs, faces, sph, n_sph, pln, n_pln, o, d, t_init, side, n, t_out,
    # key_out, counts (or NULL), stream
    "bhrt_bvh_closest": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _P, _P,
                         _P, _P],
    # pairs, faces, sph, n_sph, pln, n_pln, o, d, t_max, t_min, ana_bias,
    # plane_world_bug, n, occ_out, counts (or NULL), stream
    "bhrt_bvh_anyhit": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _F, _F, _I, _I,
                        _P, _P, _P],
    # rows, super_boxes, cluster_boxes, n_super, cluster, sph, n_sph, pln,
    # n_pln, o, d, t_init, side, n, t_out, key_out, counts (or NULL), work,
    # stream
    "bhrt_stream_closest_hbm": [_P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P,
                                _P, _I, _I, _P, _P, _P, _P, _P],
    # rows, super_boxes, cluster_boxes, n_super, cluster, sph, n_sph, pln,
    # n_pln, o, d, t_max, t_min, ana_bias, plane_world_bug, n, occ_out,
    # counts (or NULL), work, stream
    "bhrt_stream_anyhit_hbm": [_P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P,
                               _P, _F, _F, _I, _I, _P, _P, _P, _P],
    # sph, n_sph, pln, n_pln, o, d, side, n, t_out, key_out, stream
    "bhrt_analytic_closest": [_P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P],
    # sph, n_sph, pln, n_pln, o, d, t_max, ana_bias, plane_world_bug, n,
    # occ_out, stream
    "bhrt_analytic_anyhit": [_P, _I, _P, _I, _P, _P, _P, _F, _I, _I, _P, _P],
    # rows, boxes, supers, n_super, tile, pos, nrm, lo, hi, r2, inv_w0,
    # mode, active (or NULL), n, irr_out, ds_out, cnt_out, hist_out (NULL
    # where the mode writes none), counts (or NULL), work, stream
    "bhrt_photon_sweep": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _F, _F, _I, _P,
                          _I, _P, _P, _P, _P, _P, _P, _P],
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
    arguments are tensors (passed by data_ptr), ints, or None (NULL). The
    entry point is looked up once and the stream read with one call, so a
    launch costs little more than ctypes' own conversion."""
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(lib(), name)
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args],
             torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    LAUNCHES[name] += 1


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_table(name: str, x, cols: int) -> None:
    """Raise ValueError unless x is a contiguous (K, cols) float32 table on
    the CPU or a CUDA device. Made on every call: a few attribute reads."""
    require(isinstance(x, torch.Tensor) and x.dtype == torch.float32
            and x.dim() == 2 and x.shape[1] == cols and x.is_contiguous()
            and x.device.type in ("cpu", "cuda"),
            f"{name}: a contiguous (K, {cols}) float32 table on the CPU or "
            "a CUDA device expected")


def work_counter(o):
    """The one-int32 counter from which a persistent launch's warps take
    their ray tiles; the kernel's C entry zeroes it on the stream before
    the launch (csrc/cull.cuh:launch_persistent)."""
    return torch.empty(1, dtype=torch.int32, device=o.device)


def check_rays(o, d, aux=None, *tables) -> None:
    """Raise ValueError unless o and d are contiguous (N, 3) float32 rays,
    aux (if given) a contiguous (N,) float32, all on the device of the
    tables. The hot path's check, made on every call: a few attribute
    reads, no more."""
    n, dev = o.shape[0], o.device
    ok = (o.dtype == torch.float32 and d.dtype == torch.float32
          and o.shape == (n, 3) and d.shape == (n, 3)
          and o.is_contiguous() and d.is_contiguous() and d.device == dev)
    for x in tables:
        ok = ok and x.device == dev
    if aux is not None:
        ok = (ok and aux.dtype == torch.float32 and aux.shape == (n,)
              and aux.is_contiguous() and aux.device == dev)
    require(ok, "rays: contiguous (N, 3) float32 o and d (and an (N,) "
            f"float32 t) on the tables' device expected; got o {o.dtype} "
            f"{tuple(o.shape)} on {dev}, d {d.dtype} {tuple(d.shape)}")


def check_counts(counts, o, shape: tuple) -> None:
    """A kernel's optional work-count output: None, or a contiguous int32
    tensor of `shape` on the rays' CUDA device (the twins count nothing)."""
    if counts is not None:
        require(o.device.type == "cuda", "counts: kernels only")
        require(counts.dtype == torch.int32 and counts.is_contiguous()
                and tuple(counts.shape) == shape and counts.device == o.device,
                f"counts: {shape} int32 on the rays' device expected")
