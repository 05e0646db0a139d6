// Kernels 6 and 7: grouped face-stream closest hit and occlusion for big
// meshes, with the analytic sphere/plane fold.
//
// Replaces `stream_closest_hbm` (pallas_stream_hbm.py:295) and
// `stream_anyhit_hbm` (pallas_stream_hbm.py:342) of bhraytracer_tpu/ops/.
// The face table is the flat stream kernels' (affine-barycentric rows in
// BVH leaf order, ops/stream.py), cut into groups of consecutive faces with
// one bounding box each (ops/stream_hbm.py); leaf order makes the groups
// spatially tight.
//
// What bounds it on the H100: brute force would be N x F face tests (5.4e10
// at 480K rays x 112K faces, ~30 flops each: ~24 ms at the fp32 peak). The
// rays arrive coherence-sorted (ops/trace.py), so one CUDA block of 128
// neighbouring rays reduces its origin and direction boxes (12 scalars,
// _store_boxes, pallas_stream_hbm.py:155-167) and walks the groups in
// order; a group whose conservative interval window (_window, :127-152)
// cannot be crossed before the block's cap (the largest best t among its
// rays) is skipped whole, without reading its rows. A surviving group is
// staged through shared memory 128 rows at a time, as stream.cu stages its
// tiles, and each thread tests its own ray against every row. So the work
// is the surviving (block, group) pairs' face tests, bound by the fp32
// arithmetic and the shared-memory broadcast loads; the cap shrinks after
// each surviving group as hits are found.
//
// Each group box is widened by 2^-16 of the magnitude of its and the ray
// block's origin coordinates, which keeps the cull conservative under
// rounding; a cull that drops nothing a ray could hit gives the flat
// kernel's result key for key. Padding lanes of the last block repeat the
// last real ray, so they widen neither box (the JAX kernel pads with zeros,
// which turns culling off on that block). Seed and merge are the flat
// kernel's (_init / _finalize, :188-233): the mesh search starts at the
// analytic winner's t and replaces it only when strictly closer; within
// the search, ascending faces with a strict `<` keep the lowest face at
// equal t.

#include "trace.cuh"

namespace {

constexpr int kRays = 128;  // rays per block = per culling box
constexpr float kGroupEps = 1.52587890625e-05f;  // 2^-16

// Block-wide reduction (every thread gets the result). The trailing
// barrier lets the caller reduce again at once.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* s_red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? nan_max(v, w) : nan_min(v, w);
  }
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = s_red[0];
  for (int w = 1; w < kRays / 32; ++w)
    r = MAX ? nan_max(r, s_red[w]) : nan_min(r, s_red[w]);
  __syncthreads();
  return r;
}

// The block's origin and direction boxes: [lo (3), hi (3), dlo (3),
// dhi (3)] into s_box, plus max |origin coordinate| into s_box[12].
__device__ __forceinline__ void block_boxes(const Ray& r, float* s_box,
                                            float* s_red) {
  const float v[6] = {r.ox, r.oy, r.oz, r.dx, r.dy, r.dz};
  for (int k = 0; k < 6; ++k) {
    const float lo = block_reduce<false>(v[k], s_red);
    const float hi = block_reduce<true>(v[k], s_red);
    if (threadIdx.x == 0) {
      s_box[(k / 3) * 6 + k % 3] = lo;
      s_box[(k / 3) * 6 + 3 + k % 3] = hi;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.0f;
    for (int k = 0; k < 6; ++k) m = nan_max(m, fabsf(s_box[k]));
    s_box[12] = m;
  }
  __syncthreads();
}

// Whether the block may cross group box `box` ([bmin (3), bmax (3), 0, 0])
// in (0, cap): the widened interval slab window of _window
// (pallas_stream_hbm.py:127-152). ops/stream_hbm.py:_window is the twin.
__device__ __forceinline__ bool group_live(const float* __restrict__ box,
                                           const float* s_box, float cap) {
  float mag = 0.0f;
  for (int k = 0; k < 6; ++k) mag = nan_max(mag, fabsf(box[k]));
  const float pad = kGroupEps * (mag + s_box[12]);
  float t_lo = -BHRT_BIG, t_hi = BHRT_BIG;
  for (int ax = 0; ax < 3; ++ax) {
    const float blo = box[ax] - pad, bhi = box[3 + ax] + pad;
    const float lo_a = s_box[ax], hi_a = s_box[3 + ax];
    const float dl = s_box[6 + ax], dh = s_box[9 + ax];
    const bool mixed = dl <= 0.0f && dh >= 0.0f;
    const float rl = 1.0f / (dl == 0.0f ? 1e-30f : dl);
    const float rh = 1.0f / (dh == 0.0f ? 1e-30f : dh);
    const float a1 = blo - lo_a, a2 = blo - hi_a;
    const float b1 = bhi - lo_a, b2 = bhi - hi_a;
    const float qs[8] = {a1 * rl, a1 * rh, a2 * rl, a2 * rh,
                         b1 * rl, b1 * rh, b2 * rl, b2 * rh};
    float q_lo = qs[0], q_hi = qs[0];
    for (int k = 1; k < 8; ++k) {
      q_lo = nan_min(q_lo, qs[k]);
      q_hi = nan_max(q_hi, qs[k]);
    }
    t_lo = nan_max(t_lo, mixed ? -BHRT_BIG : q_lo);
    t_hi = nan_min(t_hi, mixed ? BHRT_BIG : q_hi);
  }
  return t_lo <= t_hi && t_hi > 0.0f && t_lo < cap;
}

template <int SIDE>
__global__ void __launch_bounds__(kRays)
hbm_closest_kernel(const float* __restrict__ rows,
                   const float* __restrict__ boxes, int n_groups, int group,
                   const float* __restrict__ sph, int n_sph,
                   const float* __restrict__ pln, int n_pln,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_init, int n,
                   float* __restrict__ t_out, int* __restrict__ key_out) {
  __shared__ float s_sph[BHRT_MAX_ANALYTIC * 12];
  __shared__ float s_pln[BHRT_MAX_ANALYTIC * 12];
  __shared__ float4 tile[kTile * 3];
  __shared__ float s_box[13];
  __shared__ float s_red[kRays / 32];
  bhrt_stage(s_sph, sph, n_sph * 12);
  bhrt_stage(s_pln, pln, n_pln * 12);
  __syncthreads();

  const int i = blockIdx.x * kRays + threadIdx.x;
  const int src = i < n ? i : n - 1;  // padding lanes repeat the last ray
  Ray r;
  load_ray(o, d, src, r);
  float ana_t = t_init[src];
  int ana_code = -1, ana_front = 0;
  analytic_closest<SIDE>(s_sph, n_sph, s_pln, n_pln, r, ana_t, ana_code,
                         ana_front);
  float best_t = ana_t;
  int best_key = BHRT_BIGI;
  const float inv_dlen = inv_length(r);
  block_boxes(r, s_box, s_red);
  float cap = block_reduce<true>(best_t, s_red);
  const int n_rows = n_groups * group;

  for (int g = 0; g < n_groups; ++g) {
    if (!group_live(boxes + 8 * g, s_box, cap)) continue;  // block-uniform
    for (int f0 = g * group; f0 < (g + 1) * group; f0 += kTile) {
      __syncthreads();  // the previous tile is no longer read
      stage_tile(tile, rows, n_rows, f0);
      __syncthreads();
      for (int j = 0; j < kTile; ++j) {
        float t;
        int front;
        if (face_test<SIDE>(tile + 3 * j, r, inv_dlen, t, front) &&
            t < best_t) {
          best_t = t;
          best_key = (f0 + j) * 2 + front;
        }
      }
    }
    cap = block_reduce<true>(best_t, s_red);
  }
  if (i < n) {
    const bool mesh = best_key < BHRT_BIGI;
    t_out[i] = mesh ? best_t : ana_t;
    key_out[i] = mesh ? best_key : ana_code * 2 + ana_front;
  }
}

__global__ void __launch_bounds__(kRays)
hbm_anyhit_kernel(const float* __restrict__ rows,
                  const float* __restrict__ boxes, int n_groups, int group,
                  const float* __restrict__ sph, int n_sph,
                  const float* __restrict__ pln, int n_pln,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max, float t_min,
                  float ana_bias, int plane_world_bug, int n,
                  bool* __restrict__ occ_out) {
  __shared__ float s_sph[BHRT_MAX_ANALYTIC * 12];
  __shared__ float s_pln[BHRT_MAX_ANALYTIC * 12];
  __shared__ float4 tile[kTile * 3];
  __shared__ float s_box[13];
  __shared__ float s_red[kRays / 32];
  bhrt_stage(s_sph, sph, n_sph * 12);
  bhrt_stage(s_pln, pln, n_pln * 12);
  __syncthreads();

  const int i = blockIdx.x * kRays + threadIdx.x;
  const int src = i < n ? i : n - 1;
  Ray r;
  load_ray(o, d, src, r);
  const float tm = t_max[src];
  bool occ = analytic_anyhit(s_sph, n_sph, s_pln, n_pln, r, tm, ana_bias,
                             plane_world_bug);
  const float inv_dlen = inv_length(r);
  block_boxes(r, s_box, s_red);
  // Occluded rays carry cap 0 (pallas_stream_hbm.py:255, 273).
  float cap = block_reduce<true>(occ ? 0.0f : tm, s_red);
  const int n_rows = n_groups * group;

  for (int g = 0; g < n_groups; ++g) {
    if (!group_live(boxes + 8 * g, s_box, cap)) continue;
    for (int f0 = g * group; f0 < (g + 1) * group; f0 += kTile) {
      // Barrier, and the block's early exit once every ray is occluded.
      if (__syncthreads_and(occ)) break;
      stage_tile(tile, rows, n_rows, f0);
      __syncthreads();
      if (occ) continue;
      for (int j = 0; j < kTile; ++j) {
        float t;
        int front;
        // Front faces only (TraceBVHShadow, TriObj.cpp:272-307).
        if (face_test<0>(tile + 3 * j, r, inv_dlen, t, front) && t > t_min &&
            t < tm) {
          occ = true;
          break;
        }
      }
    }
    cap = block_reduce<true>(occ ? 0.0f : tm, s_red);
  }
  if (i < n) occ_out[i] = occ;
}

}  // namespace

extern "C" {

int bhrt_stream_closest_hbm(const float* rows, const float* boxes,
                            int n_groups, int group, const float* sph,
                            int n_sph, const float* pln, int n_pln,
                            const float* o, const float* d,
                            const float* t_init, int side, int n,
                            float* t_out, int* key_out, void* stream) {
  const dim3 grid((n + kRays - 1) / kRays);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (side) {
    case 0:
      hbm_closest_kernel<0><<<grid, kRays, 0, s>>>(
          rows, boxes, n_groups, group, sph, n_sph, pln, n_pln, o, d, t_init,
          n, t_out, key_out);
      break;
    case 1:
      hbm_closest_kernel<1><<<grid, kRays, 0, s>>>(
          rows, boxes, n_groups, group, sph, n_sph, pln, n_pln, o, d, t_init,
          n, t_out, key_out);
      break;
    default:
      hbm_closest_kernel<2><<<grid, kRays, 0, s>>>(
          rows, boxes, n_groups, group, sph, n_sph, pln, n_pln, o, d, t_init,
          n, t_out, key_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int bhrt_stream_anyhit_hbm(const float* rows, const float* boxes,
                           int n_groups, int group, const float* sph,
                           int n_sph, const float* pln, int n_pln,
                           const float* o, const float* d, const float* t_max,
                           float t_min, float ana_bias, int plane_world_bug,
                           int n, bool* occ_out, void* stream) {
  const dim3 grid((n + kRays - 1) / kRays);
  hbm_anyhit_kernel<<<grid, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, boxes, n_groups, group, sph, n_sph, pln, n_pln, o, d, t_max,
      t_min, ana_bias, plane_world_bug, n, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
