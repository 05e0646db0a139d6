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
// What bounds it on the H100: not bytes or flops (their bound is a small
// part of the time, PERF.md) but the latency of each ray's chain of
// dependent steps, one a visited node: fetch a node's two children, test
// their boxes (~30 flops each), pick where to go, fetch again; a leaf's
// triangle tests (~60 flops, one 64-byte face row each). The tables stay
// in L1 and L2 (at 111,616 faces: 70,137 nodes, 2.24 MB of pair rows and
// 7.1 MB of face rows; the JAX package's packet table, 64 bytes a node,
// would be 4.49 MB), a warp's rays diverge in their paths, and a warp
// lasts as long as its longest chain. The design shortens each step:
//   - The sibling-pair table (scene/pack.py:pair_table): a node's row is
//     [bmin.xyz, bmax.x | bmax.yz, code, mag] (32 bytes: two float4) and,
//     after one pad row, the children of every node fill one aligned
//     64-byte line. A step issues that line's four 16-byte loads at once
//     and learns from them both children's boxes and where each leads (the
//     entry code, int bits: a child's `left`, or a leaf's face range), so it
//     needs no load of the parent, no conversion before the next address,
//     and no pass over the box for its widening scale (`mag`). The nearer
//     entered child (by its entry t) is taken next, the farther one pushed.
//   - Stack entries are (entry code, entry t), so a pop needs no load of
//     the node either. The stack's arrays live in local memory (L1), apart
//     from its depth, which stays in a register. A popped entry whose box
//     lies beyond the best hit found since it was pushed is dropped there.
//     (A shared-memory short stack measured slower and is not kept,
//     PERF.md.)
//   - While-while traversal (Aila & Laine 2009): each lane descends until
//     it holds a leaf, then tests leaves until it pops an inner node, so a
//     warp's leaf tests run together. A leaf's face rows come in four
//     16-byte loads at once.
//
// Semantics: the analytic fold runs first and seeds t (pallas_bvh.py:
// 193-199, 429-436). Faces use the dominant-axis projected-area test with
// per-face plane constants (_tri_test, pallas_bvh.py:104-156): face rows
// [v0 v1 v2 | n | n.v0 | 1/|n| | pad 2]. Ties are order-free: among mesh
// faces the lowest face wins at equal t, and a mesh face replaces the
// analytic seed only when strictly closer, so the result is the
// brute-force minimum of (t, face) over all faces whatever the visit
// order. For that, pruning must never drop a box that holds a face at t <=
// best: a box is entered when t_lo <= t_best, and each box is widened by
// 2^-16 of the magnitude of its and the ray origin's coordinates
// (trace.cuh:slab_test), which covers the rounding of the triangle test's
// hit point and of the slab arithmetic. ops/bvh.py:bvh_walk_ref walks the
// same way, ray by ray, with the same pruning and counts.
//
// Output is the port's (t, key) contract of ops/stream.py: key = face*2 +
// front for a mesh winner, analytic_code*2 + front otherwise. With a
// non-null `counts`, each ray also writes its box and triangle test counts
// (the work its traversal needed, for the bound of chip_smoke.py).

#include "trace.cuh"

namespace {

constexpr int kBvhThreads = 128;
constexpr int kStackDepth = 64;  // STACK_DEPTH (ops/bvh.py)
// A leaf's entry code is ~(first face | count << kCountShift) (negative);
// an inner node's is its `left` (odd, positive); 0 ends the walk.
constexpr int kCountShift = 24;  // MAX_INDEX = 1 << 24, LEAF_FACES = 128
constexpr int kDone = 0;

// The slab test of the pair-table row (p, q) = [bmin, bmax.x | bmax.yz,
// code, mag], entered at t_lo <= cap.
__device__ __forceinline__ bool enters(const float4 p, const float4 q,
                                       const BoxRay& b, float cap,
                                       float& t_lo) {
  return slab_test(p, q, q.w, b, t_lo) && t_lo <= cap;
}

// The local-memory arrays of a ray's stack: an object of arrays alone, so
// that the depth and the reference of RayStack stay in registers.
template <bool kT>
struct LocalSlots {
  int code[kStackDepth];
  float t[kT ? kStackDepth : 1];
};

// A ray's stack of entry codes and, with kT, entry t.
template <bool kT>
struct RayStack {
  LocalSlots<kT>& local;
  int sp;

  __device__ __forceinline__ void push(int code, float t) {
    local.code[sp] = code;
    if (kT) local.t[sp] = t;
    ++sp;
  }

  // The next entry (with kT: the next whose t is within `cap`; the others
  // are dropped), or kDone.
  __device__ __forceinline__ int pop(float cap) {
    while (sp > 0) {
      --sp;
      if (!kT || local.t[sp] <= cap) return local.code[sp];
    }
    return kDone;
  }
};

// The root (pair row 1), if the ray enters it within cap: its entry code,
// or kDone.
__device__ __forceinline__ int root_entry(const float4* __restrict__ pairs,
                                          const BoxRay& b, float cap) {
  const float4 q = __ldg(pairs + 3);
  float t_lo;
  return enters(__ldg(pairs + 2), q, b, cap, t_lo) ? __float_as_int(q.z)
                                                   : kDone;
}

// The children of an inner node (`left`, `left` + 1: pair rows left + 1
// and left + 2, one 64-byte line) tested in one fetch, each entered at
// t_lo <= cap. Returns the entry to take next: the nearer child entered
// (the left one at equal t), the farther pushed; or the next stacked one.
template <bool kT>
__device__ __forceinline__ int expand(const float4* __restrict__ pairs,
                                      int left, const BoxRay& b, float cap,
                                      RayStack<kT>& st) {
  const float4* line = pairs + 2 * (left + 1);
  const float4 p1 = __ldg(line), q1 = __ldg(line + 1);
  const float4 p2 = __ldg(line + 2), q2 = __ldg(line + 3);
  float t1, t2;
  const bool h1 = enters(p1, q1, b, cap, t1);
  const bool h2 = enters(p2, q2, b, cap, t2);
  const int c1 = __float_as_int(q1.z), c2 = __float_as_int(q2.z);
  if (h1 && h2) {
    const bool first = t1 <= t2;
    st.push(first ? c2 : c1, first ? t2 : t1);
    return first ? c1 : c2;
  }
  if (h1) return c1;
  if (h2) return c2;
  return st.pop(cap);
}

// Dominant-axis triangle test of the face row at `row` (_tri_test,
// pallas_bvh.py:104-156; IntersectTriangle, TriObj.cpp:68-189), its four
// 16-byte loads issued at once. The operand order is the twin's
// (ops/bvh.py:_tri_cols).
template <int SIDE>
__device__ __forceinline__ bool tri_test(const float4* __restrict__ row,
                                         const BoxRay& b, float& t,
                                         int& front) {
  const Ray& r = b.r;
  const float4 f0 = __ldg(row), f1 = __ldg(row + 1);
  const float4 f2 = __ldg(row + 2), f3 = __ldg(row + 3);
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

// The faces of the leaf with entry code `code`: [first, first + count).
__device__ __forceinline__ int leaf_first(int code) {
  return ~code & ((1 << kCountShift) - 1);
}
__device__ __forceinline__ int leaf_end(int code) {
  return leaf_first(code) + (~code >> kCountShift);
}

// A ray's walk from the entry `cur` to its end: descend until a leaf, test
// leaves until an inner node (while-while), again; `inner()` expands the
// pair at cur, `leaf()` tests the leaf at cur and pops.
template <typename Inner, typename Leaf>
__device__ __forceinline__ void walk(int& cur, Inner inner, Leaf leaf) {
  while (cur != kDone) {
    while (cur > 0) inner();
    while (cur < 0) leaf();
  }
}

template <int SIDE>
__global__ void __launch_bounds__(kBvhThreads)
bvh_closest_kernel(const float4* __restrict__ pairs,
                   const float4* __restrict__ faces,
                   const float* __restrict__ sph, int n_sph,
                   const float* __restrict__ pln, int n_pln,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_init, int n,
                   float* __restrict__ t_out, int* __restrict__ key_out,
                   int* __restrict__ counts) {
  __shared__ float s_sph[BHRT_MAX_ANALYTIC * 12];
  __shared__ float s_pln[BHRT_MAX_ANALYTIC * 12];
  const float* tsph = bhrt_table(s_sph, sph, n_sph);
  const float* tpln = bhrt_table(s_pln, pln, n_pln);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  BoxRay b;
  setup_box_ray(o, d, i, b);
  float ana_t = t_init[i];
  int ana_code = -1, ana_front = 0;
  analytic_closest<SIDE>(tsph, n_sph, tpln, n_pln, b.r, ana_t, ana_code,
                         ana_front);
  float best_t = ana_t;
  int best_face = -1, best_front = 0;

  LocalSlots<true> slots;
  RayStack<true> st{slots, 0};
  int n_box = 1, n_tri = 0;
  int cur = root_entry(pairs, b, best_t);
  walk(
      cur,
      [&] {
        n_box += 2;
        cur = expand(pairs, cur, b, best_t, st);
      },
      [&] {
        const int end = leaf_end(cur);
        n_tri += end - leaf_first(cur);
        for (int f = leaf_first(cur); f < end; ++f) {
          float t;
          int front;
          if (tri_test<SIDE>(faces + 4 * f, b, t, front) &&
              (t < best_t ||
               (t == best_t && best_face >= 0 && f < best_face))) {
            best_t = t;
            best_face = f;
            best_front = front;
          }
        }
        cur = st.pop(best_t);
      });
  const bool mesh = best_face >= 0;
  t_out[i] = mesh ? best_t : ana_t;
  key_out[i] = mesh ? best_face * 2 + best_front : ana_code * 2 + ana_front;
  if (counts != nullptr) {
    counts[2 * i] = n_box;
    counts[2 * i + 1] = n_tri;
  }
}

__global__ void __launch_bounds__(kBvhThreads)
bvh_anyhit_kernel(const float4* __restrict__ pairs,
                  const float4* __restrict__ faces,
                  const float* __restrict__ sph, int n_sph,
                  const float* __restrict__ pln, int n_pln,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max, float t_min,
                  float ana_bias, int plane_world_bug, int n,
                  bool* __restrict__ occ_out, int* __restrict__ counts) {
  __shared__ float s_sph[BHRT_MAX_ANALYTIC * 12];
  __shared__ float s_pln[BHRT_MAX_ANALYTIC * 12];
  const float* tsph = bhrt_table(s_sph, sph, n_sph);
  const float* tpln = bhrt_table(s_pln, pln, n_pln);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  BoxRay b;
  setup_box_ray(o, d, i, b);
  const float tm = t_max[i];
  bool occ = analytic_anyhit(tsph, n_sph, tpln, n_pln, b.r, tm, ana_bias,
                             plane_world_bug);
  LocalSlots<false> slots;
  RayStack<false> st{slots, 0};
  int n_box = occ ? 0 : 1, n_tri = 0;
  int cur = occ ? kDone : root_entry(pairs, b, tm);
  walk(
      cur,
      [&] {
        n_box += 2;
        cur = expand(pairs, cur, b, tm, st);
      },
      [&] {
        const int end = leaf_end(cur);
        for (int f = leaf_first(cur); f < end; ++f) {
          float t;
          int front;
          ++n_tri;
          // Front faces only (TraceBVHShadow, TriObj.cpp:272-307).
          if (tri_test<0>(faces + 4 * f, b, t, front) && t > t_min &&
              t < tm) {
            occ = true;
            cur = kDone;
            return;
          }
        }
        cur = st.pop(tm);
      });
  occ_out[i] = occ;
  if (counts != nullptr) {
    counts[2 * i] = n_box;
    counts[2 * i + 1] = n_tri;
  }
}

}  // namespace

extern "C" {

int bhrt_bvh_closest(const float* pairs, const float* faces, const float* sph,
                     int n_sph, const float* pln, int n_pln, const float* o,
                     const float* d, const float* t_init, int side, int n,
                     float* t_out, int* key_out, int* counts, void* stream) {
  const dim3 grid((n + kBvhThreads - 1) / kBvhThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* pr = reinterpret_cast<const float4*>(pairs);
  const float4* fc = reinterpret_cast<const float4*>(faces);
  switch (side) {
    case 0:
      bvh_closest_kernel<0><<<grid, kBvhThreads, 0, s>>>(
          pr, fc, sph, n_sph, pln, n_pln, o, d, t_init, n, t_out, key_out,
          counts);
      break;
    case 1:
      bvh_closest_kernel<1><<<grid, kBvhThreads, 0, s>>>(
          pr, fc, sph, n_sph, pln, n_pln, o, d, t_init, n, t_out, key_out,
          counts);
      break;
    default:
      bvh_closest_kernel<2><<<grid, kBvhThreads, 0, s>>>(
          pr, fc, sph, n_sph, pln, n_pln, o, d, t_init, n, t_out, key_out,
          counts);
  }
  return static_cast<int>(cudaGetLastError());
}

int bhrt_bvh_anyhit(const float* pairs, const float* faces, const float* sph,
                    int n_sph, const float* pln, int n_pln, const float* o,
                    const float* d, const float* t_max, float t_min,
                    float ana_bias, int plane_world_bug, int n, bool* occ_out,
                    int* counts, void* stream) {
  const dim3 grid((n + kBvhThreads - 1) / kBvhThreads);
  bvh_anyhit_kernel<<<grid, kBvhThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(pairs),
      reinterpret_cast<const float4*>(faces), sph, n_sph, pln, n_pln, o, d,
      t_max, t_min, ana_bias, plane_world_bug, n, occ_out, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
