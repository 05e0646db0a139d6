// Kernels 4 and 5: BVH closest hit and occlusion, with the analytic
// sphere/plane fold.
//
// Replaces the packet kernels `_closest_call` / `bvh_closest_pallas`
// (pallas_bvh.py:335) and `_anyhit_call` / `bvh_anyhit_pallas`
// (pallas_bvh.py:519), and the per-row-stack kernels `bvh_closest_divergent`
// (pallas_bvh_divergent.py:449) and `bvh_anyhit_divergent` (:511), of
// bhraytracer_tpu/ops/. The TPU shares one stack across a tile of rays (or
// one per sublane row) because its vector unit cannot diverge; a CUDA thread
// can, so both forms become one ray per thread with its own stack.
//
// What bounds it on the H100: per ray, the box tests of the visited nodes
// (~40 flops each, two 32-byte child rows read per internal node) and the
// triangle tests of the visited leaves (~50 flops, one 64-byte face row
// each). The node and face tables (1.1 MB + 7.1 MB at 112K faces) stay in
// L2; a warp's rays diverge in their paths, so the loads are gathers, not
// broadcasts. The design keeps the per-ray state in registers, the stack in
// local memory (L1), reads rows with 16-byte loads, and prunes with the
// entry t kept beside each stacked node, so a node whose box lies beyond
// the best hit found since it was pushed is dropped without a load.
//
// Semantics: the analytic fold runs first and seeds t (pallas_bvh.py:
// 193-199, 429-436). Faces use the dominant-axis projected-area test with
// per-face plane constants (_tri_test, pallas_bvh.py:104-156): face rows
// [v0 v1 v2 | n | n.v0 | 1/|n| | pad 2]. Node rows [bmin bmax | left count
// | code | pad 7]; code = axis + 3 when the left child sits on the high
// side (scene/pack.py). Descent is ordered by the ray's own direction sign
// along the code axis. Ties are order-free: among mesh faces the lowest
// face wins at equal t, and a mesh face replaces the analytic seed only
// when strictly closer, so the result is the brute-force minimum of
// (t, face) over all faces. For that, pruning must never drop a box that
// holds a face at t <= best: a box is entered when t_lo <= t_best, and
// each box is widened by 2^-16 of the magnitude of its and the ray
// origin's coordinates, which covers the rounding of the triangle test's
// hit point and of the slab arithmetic.
//
// Output is the port's (t, key) contract of ops/stream.py: key = face*2 +
// front for a mesh winner, analytic_code*2 + front otherwise. With a
// non-null `counts`, each ray also writes its box and triangle test counts
// (the work its traversal needed, for the bound of chip_smoke.py).

#include "trace.cuh"

namespace {

constexpr int kBvhThreads = 128;
constexpr int kStackDepth = 64;  // STACK_DEPTH, pallas_bvh.py:39
constexpr float kBoxEps = 1.52587890625e-05f;  // 2^-16

struct BvhRay {
  Ray r;
  float ix, iy, iz;  // 1 / where(d == 0, 1e-30, d) (pallas_bvh.py:179-181)
  float inv_dlen;
  float omag;  // max |origin coordinate|
};

__device__ __forceinline__ void setup_ray(const float* o, const float* d,
                                          int i, BvhRay& b) {
  load_ray(o, d, i, b.r);
  b.ix = 1.0f / (b.r.dx == 0.0f ? 1e-30f : b.r.dx);
  b.iy = 1.0f / (b.r.dy == 0.0f ? 1e-30f : b.r.dy);
  b.iz = 1.0f / (b.r.dz == 0.0f ? 1e-30f : b.r.dz);
  b.inv_dlen = inv_length(b.r);
  b.omag = fmaxf(fabsf(b.r.ox), fmaxf(fabsf(b.r.oy), fabsf(b.r.oz)));
}

// Widened slab test of node row `node` (its first two float4: bmin.xyz,
// bmax.x | bmax.yz, left, count). True when the ray crosses the box at
// t >= 0 and enters it no later than t_best; t_lo is its entry t.
__device__ __forceinline__ bool box_test(const float4* __restrict__ nodes,
                                         int node, const BvhRay& b,
                                         float t_best, float& t_lo) {
  const float4 p = __ldg(nodes + 4 * node);
  const float4 q = __ldg(nodes + 4 * node + 1);
  const float mag = fmaxf(fmaxf(fmaxf(fabsf(p.x), fabsf(p.y)),
                                fmaxf(fabsf(p.z), fabsf(p.w))),
                          fmaxf(fabsf(q.x), fabsf(q.y)));
  const float pad = kBoxEps * (mag + b.omag);
  const float ax = (p.x - pad - b.r.ox) * b.ix;
  const float bx = (p.w + pad - b.r.ox) * b.ix;
  const float ay = (p.y - pad - b.r.oy) * b.iy;
  const float by = (q.x + pad - b.r.oy) * b.iy;
  const float az = (p.z - pad - b.r.oz) * b.iz;
  const float bz = (q.y + pad - b.r.oz) * b.iz;
  const float lo = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float hi = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  t_lo = lo;
  return lo <= hi && hi >= 0.0f && lo <= t_best;
}

// Dominant-axis triangle test of face row `f` (_tri_test, pallas_bvh.py:
// 104-156; IntersectTriangle, TriObj.cpp:68-189). The operand order is the
// twin's (ops/bvh.py:_tri_test).
template <int SIDE>
__device__ __forceinline__ bool tri_test(const float4* __restrict__ faces,
                                         int f, const BvhRay& b, float& t,
                                         int& front) {
  const Ray& r = b.r;
  const float4 f2 = __ldg(faces + 4 * f + 2);
  const float4 f3 = __ldg(faces + 4 * f + 3);
  const float nx = f2.y, ny = f2.z, nz = f2.w;
  const float tdiv = nx * r.dx + ny * r.dy + nz * r.dz;
  const float pd = tdiv * (f3.y * b.inv_dlen);
  const float ndoto = nx * r.ox + ny * r.oy + nz * r.oz;
  t = (f3.x - ndoto) / (tdiv == 0.0f ? 1e-30f : tdiv);
  front = tdiv < 0.0f ? 1 : 0;
  bool ok = fabsf(pd) >= BHRT_PERP_EPS && t > 0.0f;
  if (SIDE == 0) ok = ok && front;
  if (SIDE == 1) ok = ok && !front;
  if (!ok) return false;
  const float4 f0 = __ldg(faces + 4 * f);
  const float4 f1 = __ldg(faces + 4 * f + 1);
  const float v0x = f0.x, v0y = f0.y, v0z = f0.z;
  const float v1x = f0.w, v1y = f1.x, v1z = f1.y;
  const float v2x = f1.z, v2y = f1.w, v2z = f2.x;
  const float hx = r.ox + t * r.dx;
  const float hy = r.oy + t * r.dy;
  const float hz = r.oz + t * r.dz;
  const float anx = fabsf(nx), any_ = fabsf(ny), anz = fabsf(nz);
  const bool use_x = anx >= any_ && anx >= anz;
  const bool use_y = !use_x && any_ >= anx && any_ >= anz;
  // Project along the dominant axis: x -> (y, z), y -> (x, z), z -> (x, y).
  const float p0u = use_x ? v0y : v0x, p0v = (use_x || use_y) ? v0z : v0y;
  const float p1u = use_x ? v1y : v1x, p1v = (use_x || use_y) ? v1z : v1y;
  const float p2u = use_x ? v2y : v2x, p2v = (use_x || use_y) ? v2z : v2y;
  const float pxu = use_x ? hy : hx, pxv = (use_x || use_y) ? hz : hy;
  const float a0 = (p1u - pxu) * (p2v - pxv) - (p1v - pxv) * (p2u - pxu);
  const float a1 = (p2u - pxu) * (p0v - pxv) - (p2v - pxv) * (p0u - pxu);
  const float a2 = (p0u - pxu) * (p1v - pxv) - (p0v - pxv) * (p1u - pxu);
  return (a0 >= 0.0f && a1 >= 0.0f && a2 >= 0.0f) ||
         (a0 < 0.0f && a1 < 0.0f && a2 < 0.0f);
}

// Near child first: the ray heads to the low side of the code axis when
// its direction is negative there, and the left child is on the high side
// when code >= 3 (pallas_bvh.py:237-249).
__device__ __forceinline__ bool near_is_left(const float4* __restrict__ nodes,
                                             int node, const Ray& r) {
  const int code = static_cast<int>(__ldg(nodes + 4 * node + 2).x);
  const bool flip = code >= 3;
  const int ax = code - (flip ? 3 : 0);
  const float dax = ax == 0 ? r.dx : (ax == 1 ? r.dy : r.dz);
  return (dax < 0.0f) == flip;
}

template <int SIDE>
__global__ void __launch_bounds__(kBvhThreads)
bvh_closest_kernel(const float4* __restrict__ nodes,
                   const float4* __restrict__ faces,
                   const float* __restrict__ sph, int n_sph,
                   const float* __restrict__ pln, int n_pln,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_init, int n,
                   float* __restrict__ t_out, int* __restrict__ key_out,
                   int* __restrict__ counts) {
  __shared__ float s_sph[BHRT_MAX_ANALYTIC * 12];
  __shared__ float s_pln[BHRT_MAX_ANALYTIC * 12];
  bhrt_stage(s_sph, sph, n_sph * 12);
  bhrt_stage(s_pln, pln, n_pln * 12);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  BvhRay b;
  setup_ray(o, d, i, b);
  float ana_t = t_init[i];
  int ana_code = -1, ana_front = 0;
  analytic_closest<SIDE>(s_sph, n_sph, s_pln, n_pln, b.r, ana_t, ana_code,
                         ana_front);
  float best_t = ana_t;
  int best_face = -1, best_front = 0;

  int stack[kStackDepth];
  float stack_t[kStackDepth];
  int sp = 0, n_box = 1, n_tri = 0;
  float t_lo;
  if (box_test(nodes, 0, b, best_t, t_lo)) {
    stack[0] = 0;
    stack_t[0] = t_lo;
    sp = 1;
  }
  while (sp > 0) {
    --sp;
    if (stack_t[sp] > best_t) continue;
    const int node = stack[sp];
    const float4 q = __ldg(nodes + 4 * node + 1);
    const int left = static_cast<int>(q.z);
    const int count = static_cast<int>(q.w);
    if (count > 0) {
      n_tri += count;
      for (int f = left; f < left + count; ++f) {
        float t;
        int front;
        if (tri_test<SIDE>(faces, f, b, t, front) &&
            (t < best_t || (t == best_t && best_face >= 0 && f < best_face))) {
          best_t = t;
          best_face = f;
          best_front = front;
        }
      }
      continue;
    }
    float t1, t2;
    n_box += 2;
    const bool h1 = box_test(nodes, left, b, best_t, t1);
    const bool h2 = box_test(nodes, left + 1, b, best_t, t2);
    const bool nl = near_is_left(nodes, node, b.r);
    // Far child below, near child on top.
    if (nl ? h2 : h1) {
      stack[sp] = nl ? left + 1 : left;
      stack_t[sp++] = nl ? t2 : t1;
    }
    if (nl ? h1 : h2) {
      stack[sp] = nl ? left : left + 1;
      stack_t[sp++] = nl ? t1 : t2;
    }
  }
  const bool mesh = best_face >= 0;
  t_out[i] = mesh ? best_t : ana_t;
  key_out[i] = mesh ? best_face * 2 + best_front : ana_code * 2 + ana_front;
  if (counts != nullptr) {
    counts[2 * i] = n_box;
    counts[2 * i + 1] = n_tri;
  }
}

__global__ void __launch_bounds__(kBvhThreads)
bvh_anyhit_kernel(const float4* __restrict__ nodes,
                  const float4* __restrict__ faces,
                  const float* __restrict__ sph, int n_sph,
                  const float* __restrict__ pln, int n_pln,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max, float t_min,
                  float ana_bias, int plane_world_bug, int n,
                  bool* __restrict__ occ_out, int* __restrict__ counts) {
  __shared__ float s_sph[BHRT_MAX_ANALYTIC * 12];
  __shared__ float s_pln[BHRT_MAX_ANALYTIC * 12];
  bhrt_stage(s_sph, sph, n_sph * 12);
  bhrt_stage(s_pln, pln, n_pln * 12);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  BvhRay b;
  setup_ray(o, d, i, b);
  const float tm = t_max[i];
  bool occ = analytic_anyhit(s_sph, n_sph, s_pln, n_pln, b.r, tm, ana_bias,
                             plane_world_bug);
  int stack[kStackDepth];
  int sp = 0, n_box = occ ? 0 : 1, n_tri = 0;
  float t_lo;
  if (!occ && box_test(nodes, 0, b, tm, t_lo)) stack[sp++] = 0;
  while (sp > 0 && !occ) {
    const int node = stack[--sp];
    const float4 q = __ldg(nodes + 4 * node + 1);
    const int left = static_cast<int>(q.z);
    const int count = static_cast<int>(q.w);
    if (count > 0) {
      for (int f = left; f < left + count; ++f) {
        float t;
        int front;
        ++n_tri;
        // Front faces only (TraceBVHShadow, TriObj.cpp:272-307).
        if (tri_test<0>(faces, f, b, t, front) && t > t_min && t < tm) {
          occ = true;
          break;
        }
      }
      continue;
    }
    float t1, t2;
    n_box += 2;
    const bool h1 = box_test(nodes, left, b, tm, t1);
    const bool h2 = box_test(nodes, left + 1, b, tm, t2);
    const bool nl = near_is_left(nodes, node, b.r);
    if (nl ? h2 : h1) stack[sp++] = nl ? left + 1 : left;
    if (nl ? h1 : h2) stack[sp++] = nl ? left : left + 1;
  }
  occ_out[i] = occ;
  if (counts != nullptr) {
    counts[2 * i] = n_box;
    counts[2 * i + 1] = n_tri;
  }
}

}  // namespace

extern "C" {

int bhrt_bvh_closest(const float* nodes, const float* faces, const float* sph,
                     int n_sph, const float* pln, int n_pln, const float* o,
                     const float* d, const float* t_init, int side, int n,
                     float* t_out, int* key_out, int* counts, void* stream) {
  const dim3 grid((n + kBvhThreads - 1) / kBvhThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  const float4* fc = reinterpret_cast<const float4*>(faces);
  switch (side) {
    case 0:
      bvh_closest_kernel<0><<<grid, kBvhThreads, 0, s>>>(
          nd, fc, sph, n_sph, pln, n_pln, o, d, t_init, n, t_out, key_out,
          counts);
      break;
    case 1:
      bvh_closest_kernel<1><<<grid, kBvhThreads, 0, s>>>(
          nd, fc, sph, n_sph, pln, n_pln, o, d, t_init, n, t_out, key_out,
          counts);
      break;
    default:
      bvh_closest_kernel<2><<<grid, kBvhThreads, 0, s>>>(
          nd, fc, sph, n_sph, pln, n_pln, o, d, t_init, n, t_out, key_out,
          counts);
  }
  return static_cast<int>(cudaGetLastError());
}

int bhrt_bvh_anyhit(const float* nodes, const float* faces, const float* sph,
                    int n_sph, const float* pln, int n_pln, const float* o,
                    const float* d, const float* t_max, float t_min,
                    float ana_bias, int plane_world_bug, int n, bool* occ_out,
                    int* counts, void* stream) {
  const dim3 grid((n + kBvhThreads - 1) / kBvhThreads);
  bvh_anyhit_kernel<<<grid, kBvhThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(faces), sph, n_sph, pln, n_pln, o, d,
      t_max, t_min, ana_bias, plane_world_bug, n, occ_out, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
