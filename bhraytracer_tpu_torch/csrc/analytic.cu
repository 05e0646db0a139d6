// Kernels 8 and 9: closest hit and occlusion over the analytic instances
// alone (spheres and planes), the route of mesh-free scenes.
//
// Replaces `analytic_closest_pallas` (`_closest_kernel`) and
// `analytic_shadow_pallas` (`_shadow_kernel`) of
// bhraytracer_tpu/ops/pallas_trace.py.
//
// What bounds it on the H100: each ray reads 24 bytes and writes 8 (closest)
// or 1 (occlusion), and tests every instance at ~45-67 flops; with a few
// instances a call is bound by those bytes. The design is one thread per
// ray over the instance tables; the arithmetic is the `analytic_closest`
// / `analytic_anyhit` device functions that kernels 1, 2 and 4-7 fold in
// (trace.cuh), so every route computes a sphere or plane hit the same way.
// The closest kernel stages tables of at most 32 rows once per block in
// shared memory (common.cuh: bhrt_table) and reads bigger ones in place.
// The occlusion kernel reads its tables in place, as broadcast loads that
// L1 serves, with no barrier: at 480K shadow rays 0.0080 ms against 0.0086
// with the staged tables, over a photon frame's 6 shadow calls 0.0693
// against 0.0747 (medians of 5 profiles each, A B B A in one call; H100
// 80GB HBM3, 700 W; PERF.md). Two or four rays a thread, with 8- or
// 16-byte loads and one 2- or 4-byte store, ran slower (0.0090, 0.0100
// ms), as fewer threads hid less of each ray's latency. The occlusion
// test stops at the first occluder.
//
// The closest kernel runs on every trace of a mesh-free scene: 5,280 times
// in a photon map's build, on batches of <= 32,768 photons, and 91 times a
// frame. There the host's time per call, not the device's, bounds it, so
// its caller passes the tables cached per pack (ops/trace.py:
// analytic_tables) and its wrapper (ops/analytic.py) checks its inputs
// with a few attribute reads. A persistent grid whose blocks loaded tiles
// of 256 rays with coalesced 16-byte loads through shared memory took
// longer on the device than this design: 0.0103 against 0.0081 ms at 480K
// rays, 0.0026 against 0.0023 ms at 32,768 (H100 80GB HBM3, 700 W;
// PERF.md), as the tiles' loads and tests then wait on each other at the
// block's barriers.
//
// Output: the port's (t, key) contract (ops/stream.py): key = code*2 +
// front, code = -(2 + inst*4 + kind*2 + front), -2 on a miss (code -1).
// Instances are visited spheres first, then planes, each in ascending
// order with a strict `<`, so equal t keeps the first (pallas_trace.py).

#include "trace.cuh"

namespace {

constexpr int kThreads = 256;

template <int SIDE>
__global__ void __launch_bounds__(kThreads)
analytic_closest_kernel(const float* __restrict__ sph, int n_sph,
                        const float* __restrict__ pln, int n_pln,
                        const float* __restrict__ o,
                        const float* __restrict__ d, int n,
                        float* __restrict__ t_out, int* __restrict__ key_out) {
  __shared__ float s_sph[BHRT_MAX_ANALYTIC * 12];
  __shared__ float s_pln[BHRT_MAX_ANALYTIC * 12];
  const float* tsph = bhrt_table(s_sph, sph, n_sph);
  const float* tpln = bhrt_table(s_pln, pln, n_pln);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  load_ray(o, d, i, r);
  float bt = BHRT_BIG;
  int code = -1, front = 0;
  analytic_closest<SIDE>(tsph, n_sph, tpln, n_pln, r, bt, code, front);
  t_out[i] = bt;
  key_out[i] = code * 2 + front;
}

__global__ void __launch_bounds__(kThreads)
analytic_anyhit_kernel(const float* __restrict__ sph, int n_sph,
                       const float* __restrict__ pln, int n_pln,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ t_max, float ana_bias,
                       int plane_world_bug, int n, bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  load_ray(o, d, i, r);
  occ_out[i] = analytic_anyhit(sph, n_sph, pln, n_pln, r, t_max[i],
                               ana_bias, plane_world_bug);
}

}  // namespace

extern "C" {

int bhrt_analytic_closest(const float* sph, int n_sph, const float* pln,
                          int n_pln, const float* o, const float* d, int side,
                          int n, float* t_out, int* key_out, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (side) {
    case 0:
      analytic_closest_kernel<0><<<grid, kThreads, 0, s>>>(
          sph, n_sph, pln, n_pln, o, d, n, t_out, key_out);
      break;
    case 1:
      analytic_closest_kernel<1><<<grid, kThreads, 0, s>>>(
          sph, n_sph, pln, n_pln, o, d, n, t_out, key_out);
      break;
    default:
      analytic_closest_kernel<2><<<grid, kThreads, 0, s>>>(
          sph, n_sph, pln, n_pln, o, d, n, t_out, key_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int bhrt_analytic_anyhit(const float* sph, int n_sph, const float* pln,
                         int n_pln, const float* o, const float* d,
                         const float* t_max, float ana_bias,
                         int plane_world_bug, int n, bool* occ_out,
                         void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  analytic_anyhit_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      sph, n_sph, pln, n_pln, o, d, t_max, ana_bias, plane_world_bug, n,
      occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
