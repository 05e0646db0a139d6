// Device pieces shared by the trace kernels (stream.cu, stream_hbm.cu,
// bvh.cu, analytic.cu): the ray, the analytic sphere/plane fold of
// bhraytracer_tpu/ops/pallas_analytic.py, the affine-barycentric face-row
// test of pallas_stream.py and the widened slab test of a bounding box.
#pragma once

#include "common.cuh"

namespace {

constexpr float kBoxEps = 1.52587890625e-05f;  // 2^-16: box widening

// Clamp-below that propagates NaN like torch.clamp_min / jnp.maximum.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return (x != x || x >= lo) ? x : lo;
}

// Minimum and maximum that propagate NaN like torch.minimum / maximum.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Closest analytic hit seeded by t0 (pallas_analytic.py:39-93): writes the
// best t and the face code -(2 + inst*4 + kind*2 + front) (-1 if none).
template <int SIDE>
__device__ void analytic_closest(const float* sph, int n_sph, const float* pln,
                                 int n_pln, const Ray& r, float& bt,
                                 int& bcode, int& bfront) {
  float l[6];
  for (int k = 0; k < n_sph; ++k) {
    bhrt_local_ray(sph + 12 * k, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, l);
    const float a = l[3] * l[3] + l[4] * l[4] + l[5] * l[5];
    const float b = 2.0f * (l[3] * l[0] + l[4] * l[1] + l[5] * l[2]);
    const float c = l[0] * l[0] + l[1] * l[1] + l[2] * l[2] - 1.0f;
    const float disc = b * b - 4.0f * a * c;
    const bool ok = disc > 0.0f;
    const float sq = sqrtf(clamp_min(disc, 0.0f));
    const float inv2a = 1.0f / clamp_min(2.0f * a, 1e-30f);
    const float t1 = (-b + sq) * inv2a;
    const float t2 = (-b - sq) * inv2a;
    const bool both_pos = t2 > 0.0f;
    const bool inside = t1 * t2 <= 0.0f;
    float t;
    int front;
    if (SIDE == 0) {
      t = both_pos ? t2 : BHRT_BIG;
      front = 1;
    } else if (SIDE == 1) {
      t = (both_pos || inside) ? t1 : BHRT_BIG;
      front = 0;
    } else {
      t = both_pos ? t2 : (inside ? t1 : BHRT_BIG);
      front = both_pos ? 1 : 0;
    }
    t = (ok && t > 0.0f) ? t : BHRT_BIG;
    if (t < bt) {
      bt = t;
      bcode = -(2 + k * 4 + front);
      bfront = front;
    }
  }
  for (int k = 0; k < n_pln; ++k) {
    bhrt_local_ray(pln + 12 * k, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, l);
    float t = -l[2] / (l[5] == 0.0f ? 1e-30f : l[5]);
    const float x = l[0] + t * l[3];
    const float y = l[1] + t * l[4];
    const bool in_ext = fabsf(x) <= 1.0f && fabsf(y) <= 1.0f;
    const int front = l[5] < 0.0f ? 1 : 0;
    bool ok = l[5] != 0.0f && t > 0.0f && in_ext;
    if (SIDE == 0) ok = ok && front;
    if (SIDE == 1) ok = ok && !front;
    t = ok ? t : BHRT_BIG;
    if (t < bt) {
      bt = t;
      bcode = -(2 + k * 4 + 2 + front);
      bfront = front;
    }
  }
}

// Occlusion by the analytic instances within (ana_bias, tm)
// (pallas_analytic.py:96-127).
__device__ bool analytic_anyhit(const float* sph, int n_sph, const float* pln,
                                int n_pln, const Ray& r, float tm,
                                float ana_bias, int plane_world_bug) {
  float l[6];
  for (int k = 0; k < n_sph; ++k) {
    bhrt_local_ray(sph + 12 * k, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, l);
    const float a = l[3] * l[3] + l[4] * l[4] + l[5] * l[5];
    const float b = 2.0f * (l[3] * l[0] + l[4] * l[1] + l[5] * l[2]);
    const float c = l[0] * l[0] + l[1] * l[1] + l[2] * l[2] - 1.0f;
    const float disc = b * b - 4.0f * a * c;
    const float sq = sqrtf(clamp_min(disc, 0.0f));
    const float tmin = (-b - sq) / clamp_min(2.0f * a, 1e-30f);
    if (disc > 0.0f && tmin > ana_bias && tmin < tm) return true;
  }
  for (int k = 0; k < n_pln; ++k) {
    bhrt_local_ray(pln + 12 * k, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, l);
    const float t = -l[2] / (l[5] == 0.0f ? 1e-30f : l[5]);
    float x, y;
    if (plane_world_bug) {
      x = r.ox + t * r.dx;
      y = r.oy + t * r.dy;
    } else {
      x = l[0] + t * l[3];
      y = l[1] + t * l[4];
    }
    const bool in_ext = fabsf(x) <= 1.0f && fabsf(y) <= 1.0f;
    if (l[5] != 0.0f && t >= 0.0f && in_ext && t > ana_bias && t < tm)
      return true;
  }
  return false;
}

// One stream face row against one ray (_slab_test, pallas_stream.py:174-199).
// Returns true on a hit; t and front are set whenever the plane test ran.
template <int SIDE>
__device__ __forceinline__ bool face_test(const float4* row, const Ray& r,
                                          float inv_dlen, float& t,
                                          int& front) {
  const float4 a = row[0], g0 = row[1], g1 = row[2];
  const float tdiv = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  const float pd = tdiv * inv_dlen;
  const float ndoto = a.x * r.ox + a.y * r.oy + a.z * r.oz;
  t = (a.w - ndoto) / (tdiv == 0.0f ? 1e-30f : tdiv);
  front = tdiv < 0.0f ? 1 : 0;
  bool ok = fabsf(pd) >= BHRT_PERP_EPS && t > 0.0f;
  if (SIDE == 0) ok = ok && front;
  if (SIDE == 1) ok = ok && !front;
  if (!ok) return false;
  const float hx = r.ox + t * r.dx;
  const float hy = r.oy + t * r.dy;
  const float hz = r.oz + t * r.dz;
  const float b0 = g0.x * hx + g0.y * hy + g0.z * hz + g0.w;
  const float b1 = g1.x * hx + g1.y * hy + g1.z * hz + g1.w;
  const float b2 = 1.0f - b0 - b1;
  return b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f;
}

__device__ __forceinline__ void load_ray(const float* o, const float* d,
                                         int i, Ray& r) {
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
}

__device__ __forceinline__ float inv_length(const Ray& r) {
  return 1.0f / sqrtf(clamp_min(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz,
                                1e-30f));
}

// A ray with the constants of its slab test.
struct BoxRay {
  Ray r;
  float ix, iy, iz;  // 1 / where(d == 0, 1e-30, d) (pallas_bvh.py:179-181)
  float inv_dlen;
  float omag;  // max |origin coordinate|
};

__device__ __forceinline__ void setup_box_ray(const float* o, const float* d,
                                              int i, BoxRay& b) {
  load_ray(o, d, i, b.r);
  b.ix = 1.0f / (b.r.dx == 0.0f ? 1e-30f : b.r.dx);
  b.iy = 1.0f / (b.r.dy == 0.0f ? 1e-30f : b.r.dy);
  b.iz = 1.0f / (b.r.dz == 0.0f ? 1e-30f : b.r.dz);
  b.inv_dlen = inv_length(b.r);
  b.omag = fmaxf(fabsf(b.r.ox), fmaxf(fabsf(b.r.oy), fabsf(b.r.oz)));
}

// Widened slab test of the box p = (bmin.xyz, bmax.x), q = (bmax.yz, ..):
// true when the ray's line crosses the box, each side moved out by 2^-16
// of the magnitude of the box's and the ray origin's coordinates, at some
// t >= 0; t_lo is its entry t. The widening covers the rounding of a face
// test's hit point and of this arithmetic, so a box that holds a face hit
// at t is entered at t_lo <= t. Near and far planes are chosen by the
// direction's sign, so an empty box (bmin > bmax) is never crossed.
// ops/cull.py:slab_entry is the twin. slab_test takes the box's coordinate
// magnitude `mag`, box_mag(p, q); box_test computes it, the BVH kernels read
// it from their table.
__device__ __forceinline__ bool slab_test(const float4 p, const float4 q,
                                          float mag, const BoxRay& b,
                                          float& t_lo) {
  const float pad = kBoxEps * (mag + b.omag);
  const float lx = p.x - pad, hx = p.w + pad;
  const float ly = p.y - pad, hy = q.x + pad;
  const float lz = p.z - pad, hz = q.y + pad;
  const bool px = b.ix >= 0.0f, py = b.iy >= 0.0f, pz = b.iz >= 0.0f;
  const float nx = ((px ? lx : hx) - b.r.ox) * b.ix;
  const float fx = ((px ? hx : lx) - b.r.ox) * b.ix;
  const float ny = ((py ? ly : hy) - b.r.oy) * b.iy;
  const float fy = ((py ? hy : ly) - b.r.oy) * b.iy;
  const float nz = ((pz ? lz : hz) - b.r.oz) * b.iz;
  const float fz = ((pz ? hz : lz) - b.r.oz) * b.iz;
  const float lo = fmaxf(fmaxf(nx, ny), nz);
  const float hi = fminf(fminf(fx, fy), fz);
  t_lo = lo;
  return lo <= hi && hi >= 0.0f;
}

__device__ __forceinline__ float box_mag(const float4 p, const float4 q) {
  return fmaxf(fmaxf(fmaxf(fabsf(p.x), fabsf(p.y)),
                     fmaxf(fabsf(p.z), fabsf(p.w))),
               fmaxf(fabsf(q.x), fabsf(q.y)));
}

__device__ __forceinline__ bool box_test(const float4 p, const float4 q,
                                         const BoxRay& b, float& t_lo) {
  return slab_test(p, q, box_mag(p, q), b, t_lo);
}

}  // namespace
