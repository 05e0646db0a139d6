// Kernels 1 and 2: brute-force face-stream closest hit and occlusion, with
// the analytic sphere/plane fold.
//
// Replaces `stream_closest` (`_closest_kernel`) and `stream_anyhit`
// (`_anyhit_kernel`) of bhraytracer_tpu/ops/pallas_stream.py, with the
// `analytic_closest` / `analytic_anyhit` fold of pallas_analytic.py inlined.
//
// What bounds it on the H100: every ray tests every face, so the work is
// N x F face tests of ~30 flops each, and each test reads one 48-byte face
// row (n_hat, n_hat.v0, two barycentric planes). Read from device memory
// per ray, that would be 48 * F bytes a ray (68 KB at the 1408-face
// teapot). The design stages the rows instead: one thread per ray, and a
// block of 128 rays loads a tile of 128 face rows into shared memory once
// (6 KB, 16-byte loads), then every thread reads each row as a broadcast.
// Device/L2 traffic drops to 48 * F / 128 bytes a ray, and the loop is
// bound by the shared-memory broadcast loads and the fp32 arithmetic. The
// analytic tables (<= 32 rows of 12 floats per category) sit in shared
// memory too. The any-hit kernel lets a ray stop testing once occluded and
// the block stop loading tiles once all its rays are done.
//
// Semantics (pallas_stream.py:174-199, 238-371): rows are [n_hat (3),
// n_hat.v0 | g0 (3), c0 | g1 (3), c1 | pad (4)]; a face hits when
// |n_hat.d| / |d| >= PERP_EPS, t > 0, the side test passes and the affine
// barycentrics b0 = g0.P + c0, b1 = g1.P + c1, b2 = 1 - b0 - b1 are all
// >= 0. Zero padding rows are culled everywhere. Faces are visited in
// ascending order with a strict `<`, so equal t keeps the lowest face id
// (the lowest key face*2 + front); a mesh hit replaces the analytic winner
// only when strictly closer.

#include "trace.cuh"

namespace {

constexpr int kThreads = 128;

template <int SIDE>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ rows, int n_rows,
               const float* __restrict__ sph, int n_sph,
               const float* __restrict__ pln, int n_pln,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_init, int n,
               float* __restrict__ t_out, int* __restrict__ key_out) {
  __shared__ float s_sph[BHRT_MAX_ANALYTIC * 12];
  __shared__ float s_pln[BHRT_MAX_ANALYTIC * 12];
  __shared__ float4 tile[kTile * 3];
  bhrt_stage(s_sph, sph, n_sph * 12);
  bhrt_stage(s_pln, pln, n_pln * 12);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ana_t = 0.0f;
  int ana_code = -1, ana_front = 0;
  if (live) {
    load_ray(o, d, i, r);
    ana_t = t_init[i];
    analytic_closest<SIDE>(s_sph, n_sph, s_pln, n_pln, r, ana_t, ana_code,
                           ana_front);
  }
  // Seeding the mesh search with the analytic winner keeps exactly the
  // faces that could replace it (strictly closer).
  float best_t = ana_t;
  int best_key = BHRT_BIGI;
  const float inv_dlen = inv_length(r);

  for (int f0 = 0; f0 < n_rows; f0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    stage_tile(tile, rows, n_rows, f0);
    __syncthreads();
    if (!live) continue;
    const int m = min(kTile, n_rows - f0);
    for (int j = 0; j < m; ++j) {
      float t;
      int front;
      if (face_test<SIDE>(tile + 3 * j, r, inv_dlen, t, front) &&
          t < best_t) {
        best_t = t;
        best_key = (f0 + j) * 2 + front;
      }
    }
  }
  if (live) {
    const bool mesh = best_key < BHRT_BIGI;
    t_out[i] = mesh ? best_t : ana_t;
    key_out[i] = mesh ? best_key : ana_code * 2 + ana_front;
  }
}

__global__ void __launch_bounds__(kThreads)
anyhit_kernel(const float* __restrict__ rows, int n_rows,
              const float* __restrict__ sph, int n_sph,
              const float* __restrict__ pln, int n_pln,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_max, float t_min, float ana_bias,
              int plane_world_bug, int n, bool* __restrict__ occ_out) {
  __shared__ float s_sph[BHRT_MAX_ANALYTIC * 12];
  __shared__ float s_pln[BHRT_MAX_ANALYTIC * 12];
  __shared__ float4 tile[kTile * 3];
  bhrt_stage(s_sph, sph, n_sph * 12);
  bhrt_stage(s_pln, pln, n_pln * 12);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float tm = 0.0f;
  bool occ = false;
  if (i < n) {
    load_ray(o, d, i, r);
    tm = t_max[i];
    occ = analytic_anyhit(s_sph, n_sph, s_pln, n_pln, r, tm, ana_bias,
                          plane_world_bug);
  }
  bool done = occ || i >= n;
  const float inv_dlen = inv_length(r);

  for (int f0 = 0; f0 < n_rows; f0 += kTile) {
    // Barrier, and the block's early exit once every ray is settled.
    if (__syncthreads_and(done)) break;
    stage_tile(tile, rows, n_rows, f0);
    __syncthreads();
    if (done) continue;
    const int m = min(kTile, n_rows - f0);
    for (int j = 0; j < m; ++j) {
      float t;
      int front;
      // Front faces only (TraceBVHShadow, TriObj.cpp:272-307).
      if (face_test<0>(tile + 3 * j, r, inv_dlen, t, front) && t > t_min &&
          t < tm) {
        occ = true;
        break;
      }
    }
    done = occ;
  }
  if (i < n) occ_out[i] = occ;
}

}  // namespace

extern "C" {

int bhrt_stream_closest(const float* rows, int n_rows, const float* sph,
                        int n_sph, const float* pln, int n_pln, const float* o,
                        const float* d, const float* t_init, int side, int n,
                        float* t_out, int* key_out, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (side) {
    case 0:
      closest_kernel<0><<<grid, kThreads, 0, s>>>(
          rows, n_rows, sph, n_sph, pln, n_pln, o, d, t_init, n, t_out, key_out);
      break;
    case 1:
      closest_kernel<1><<<grid, kThreads, 0, s>>>(
          rows, n_rows, sph, n_sph, pln, n_pln, o, d, t_init, n, t_out, key_out);
      break;
    default:
      closest_kernel<2><<<grid, kThreads, 0, s>>>(
          rows, n_rows, sph, n_sph, pln, n_pln, o, d, t_init, n, t_out, key_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int bhrt_stream_anyhit(const float* rows, int n_rows, const float* sph,
                       int n_sph, const float* pln, int n_pln, const float* o,
                       const float* d, const float* t_max, float t_min,
                       float ana_bias, int plane_world_bug, int n,
                       bool* occ_out, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  anyhit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, sph, n_sph, pln, n_pln, o, d, t_max, t_min, ana_bias,
      plane_world_bug, n, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
