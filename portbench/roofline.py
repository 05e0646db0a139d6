"""Published peaks of one NVIDIA H100 and the work of a pass counted from
what it must do, whatever implements it.

The peaks are chip_smoke.py's FP32_PEAK and HBM_RATE (NVIDIA's H100 SXM
data sheet: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM
at the full 700 W power limit), copied so that later per-kernel shares
(the shade kernel, the analytic and photon kernels) divide by the same
numbers.

The trace work of a pass is bytes alone: the tests a ray makes depend on
the acceleration structure, and every trace kernel the port has measured is
bound by bytes, so operations are left out. The program's own tables (BVH
node pairs, cluster rows) are its implementation's bytes and are not
counted.
"""

from __future__ import annotations

FP32_PEAK = 67e12  # float32 operations per second
HBM_RATE = 3.35e12  # bytes per second

RAY_BYTES = 32  # origin (3 x f32), direction (3 x f32), t range (2 x f32)
HIT_BYTES = 8  # t (f32) and primitive id (i32)
TRIANGLE_BYTES = 36  # three vertices, 3 x f32 each
ANALYTIC_BYTES = 48  # a sphere's or plane's transform: 3x3 and 3 (f32)


def bound(n_bytes: float, ops: float) -> dict:
    """The least time the card could take, in ms: bytes at HBM_RATE or
    operations at FP32_PEAK, whichever is larger (chip_smoke.py:bound):
    max(n_bytes / HBM_RATE, ops / FP32_PEAK) * 1e3."""
    t_bytes, t_ops = n_bytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(n_bytes), bound_ops=int(ops))


def scene_bytes(n_triangles: int, n_spheres: int, n_planes: int) -> int:
    """The scene read once: 36 * triangles + 48 * (spheres + planes)."""
    return TRIANGLE_BYTES * n_triangles + ANALYTIC_BYTES * (n_spheres + n_planes)


def trace_bytes(segments: int, n_triangles: int, n_spheres: int,
                n_planes: int, passes: int = 1) -> int:
    """The bytes a trace must move for `segments` traced segments over
    `passes` passes: each segment's ray read once and its hit written once,
    (32 + 8) * segments, and the scene once a pass."""
    return ((RAY_BYTES + HIT_BYTES) * segments
            + passes * scene_bytes(n_triangles, n_spheres, n_planes))


def least_seconds(n_bytes: float) -> float:
    """n_bytes / HBM_RATE."""
    return n_bytes / HBM_RATE
