// Kernel 3: fused shade setup, one thread per lane.
//
// Replaces `shade_setup` (`_shade_kernel`, `shade_tables`) of
// bhraytracer_tpu/ops/pallas_shade.py: hit resolve, material fetch,
// Schlick Fresnel, one-light selection, soft-shadow disc sample,
// pre-visibility irradiance, BRDF*cos, GI lobe and the refraction-chain
// inputs, formula for formula (pallas_shade.py:208-448), guards included.
//
// What bounds it on the H100: per-lane arithmetic and register pressure.
// A lane reads 23 input floats plus one 32-float resolve row and writes 37
// outputs (~370 bytes, coalesced: planes are structure-of-arrays, so
// neighbouring threads touch neighbouring addresses), but runs ~600 flops
// including a dozen sqrt/div, three pow, six sin/cos and four frame
// constructions, with ~100 values live across the sampler blocks. The design
// keeps every intermediate in registers, stages the tiny instance / material
// / light tables in shared memory (<= 32x22, 32x11 and 8x9 floats) and
// indexes them directly instead of the TPU kernel's unrolled where-chains,
// and gathers the lane's resolve row by face id itself (the TPU kernel
// needed it pre-gathered into planes). Blocks of 128 threads keep enough
// warps in flight to hide the latency of the gathers.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxInst = 32, kMaxMtl = 32, kMaxLights = 8;
constexpr float kTwoPi = 6.283185307179586f;  // 2 * pi, as float32

// NaN-propagating min/max, as torch.clamp / torch.maximum and jnp.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return (x != x || x >= lo) ? x : lo;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return (x != x || x <= hi) ? x : hi;
}
__device__ __forceinline__ float maximum(float a, float b) {
  return (a != a || a >= b) ? a : b;
}

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add3(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scale3(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 where3(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ V3 normalize3(V3 a) {
  const float n = clamp_min(sqrtf(clamp_min(dot3(a, a), 1e-24f)), 1e-30f);
  return {a.x / n, a.y / n, a.z / n};
}
__device__ __forceinline__ float safe_pow(float x, float p) {
  return x > 0.0f ? powf(x, p) : 0.0f;
}
__device__ __forceinline__ float safe_div(float a, float b) {
  return a / (fabsf(b) < 1e-30f ? (b < 0.0f ? -1e-30f : 1e-30f) : b);
}

// GetRandomCrossingVector (MtlBlinn.cpp:591-600): z unless v ~ +-z.
__device__ __forceinline__ V3 crossing_vector(V3 v) {
  const V3 cz = v3(v.y, -v.x, 0.0f);
  const bool degen = dot3(cz, cz) < 1e-12f;
  return v3(degen ? 1.0f : 0.0f, 0.0f, degen ? 0.0f : 1.0f);
}

__device__ __forceinline__ void frame_axes(V3 n, V3& a1, V3& a2) {
  a1 = normalize3(cross3(crossing_vector(n), n));
  a2 = normalize3(cross3(a1, n));
}

__device__ V3 sample_along_normal(V3 n, float radius, float u1, float u2) {
  const float r = sqrtf(u1) * radius;
  const float th = u2 * kTwoPi;
  V3 a1, a2;
  frame_axes(n, a1, a2);
  return add3(n, add3(scale3(a1, r * cosf(th)), scale3(a2, r * sinf(th))));
}

// MtlBlinn.cpp:619-635, polar angle kept algebraic (c = cos theta).
__device__ V3 sample_along_light_direction(V3 n, float gloss, float u1,
                                           float u2, float& c) {
  c = powf(clamp_min(u1, 1e-12f), 1.0f / (gloss + 1.0f));
  c = clamp_max(c, 1.0f);
  const float r = sqrtf(clamp_min(1.0f - c * c, 0.0f)) / c;
  const float phi = u2 * kTwoPi;
  V3 a1, a2;
  frame_axes(n, a1, a2);
  return add3(n, add3(scale3(a1, r * cosf(phi)), scale3(a2, r * sinf(phi))));
}

// MtlBlinn.cpp:697-716, half-angle form. Returns the direction and
// sin(2 theta).
__device__ V3 sample_in_semisphere(V3 n, float u1, float u2, float& sin2t) {
  const V3 a_y = normalize3(cross3(n, crossing_vector(n)));
  const V3 a_x = cross3(n, a_y);
  const float phi = u1 * kTwoPi;
  const float x = clamp_min(clamp_max(1.0f - 2.0f * u2, 1.0f), -1.0f);
  const float ct = sqrtf(clamp_min((1.0f + x) * 0.5f, 0.0f));
  const float st = sqrtf(clamp_min((1.0f - x) * 0.5f, 0.0f));
  sin2t = sqrtf(clamp_min(1.0f - x * x, 0.0f));
  return add3(add3(scale3(a_x, st * cosf(phi)), scale3(a_y, st * sinf(phi))),
              scale3(n, ct));
}

__global__ void __launch_bounds__(kThreads)
shade_kernel(const float* __restrict__ planes, const int* __restrict__ hits,
             const float* __restrict__ u_in,
             const float* __restrict__ resolve_rows, int n_faces,
             const float* __restrict__ inst_tab, int n_sph, int n_pln,
             int n_msh, const float* __restrict__ mtl_tab, int n_mtl,
             const float* __restrict__ light_tab, int n_lights, float bias,
             int n, float* __restrict__ out) {
  __shared__ float s_inst[kMaxInst * 22];
  __shared__ float s_mtl[kMaxMtl * 11];
  __shared__ float s_light[kMaxLights * 9];
  const int n_inst = max(1, n_sph + n_pln + n_msh);
  bhrt_stage(s_inst, inst_tab, n_inst * 22);
  bhrt_stage(s_mtl, mtl_tab, n_mtl * 11);
  bhrt_stage(s_light, light_tab, n_lights * 9);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 o = v3(planes[i], planes[n + i], planes[2 * n + i]);
  const V3 d = v3(planes[3 * n + i], planes[4 * n + i], planes[5 * n + i]);
  const int kind = hits[i];
  const int inst = hits[n + i];
  const int face = hits[2 * n + i];
  const int flags = hits[3 * n + i];
  const bool front = (flags & 1) != 0;
  const bool shade = (flags & 2) != 0;
  float u[13];
#pragma unroll
  for (int k = 0; k < 13; ++k) u[k] = u_in[k * n + i];

  // ---- instance row: [itm 9, tm 9, pos 3, mtl] over [sph | pln | msh] ----
  int flat = inst + (kind == 0 ? 0 : (kind == 1 ? n_sph : n_sph + n_pln));
  flat = min(max(flat, 0), n_inst - 1);
  const float* irow = s_inst + 22 * flat;
  const float* itm = irow;
  const float* tm = irow + 9;
  const V3 pos = v3(irow[18], irow[19], irow[20]);
  const float imtl = irow[21];

  const V3 s = sub3(o, pos);
  const V3 ol = v3(itm[0] * s.x + itm[1] * s.y + itm[2] * s.z,
                   itm[3] * s.x + itm[4] * s.y + itm[5] * s.z,
                   itm[6] * s.x + itm[7] * s.y + itm[8] * s.z);
  const V3 dl = v3(itm[0] * d.x + itm[1] * d.y + itm[2] * d.z,
                   itm[3] * d.x + itm[4] * d.y + itm[5] * d.z,
                   itm[6] * d.x + itm[7] * d.y + itm[8] * d.z);

  float t_l = 0.0f;
  V3 p_l = v3(0.0f, 0.0f, 0.0f), n_l = v3(0.0f, 0.0f, 1.0f);
  float mtl_id = imtl;

  if (n_sph && kind == 0) {  // Sphere.cpp:8-75
    const float a = dot3(dl, dl);
    const float b = 2.0f * dot3(dl, ol);
    const float c = dot3(ol, ol) - 1.0f;
    const float sq = sqrtf(clamp_min(b * b - 4.0f * a * c, 1e-24f));
    const float inv2a = 1.0f / clamp_min(2.0f * a, 1e-30f);
    t_l = front ? (-b - sq) * inv2a : (-b + sq) * inv2a;
    p_l = add3(ol, scale3(dl, t_l));
    n_l = p_l;  // N = local hit point (Sphere.cpp:57)
  }
  if (n_pln && kind == 1) {  // Plane.cpp:8-77
    const bool para = fabsf(dl.z) < 1e-12f;
    t_l = (para ? 0.0f : -ol.z) / (para ? 1.0f : dl.z);
    p_l = add3(ol, scale3(dl, t_l));
    n_l = v3(0.0f, 0.0f, 1.0f);
  }
  if (n_msh && kind == 2) {  // TriObj.cpp:105-178 via the resolve row
    const float* row =
        resolve_rows + 32 * min(max(face, 0), n_faces - 1);
    const V3 v0 = v3(row[0], row[1], row[2]);
    const V3 v1 = v3(row[3], row[4], row[5]);
    const V3 v2 = v3(row[6], row[7], row[8]);
    const V3 vn = cross3(sub3(v1, v0), sub3(v2, v0));
    const float tdiv = dot3(vn, dl);
    const bool graze = fabsf(tdiv) < 1e-12f;
    const float t_m =
        (graze ? 0.0f : dot3(vn, v0) - dot3(vn, ol)) / (graze ? 1.0f : tdiv);
    const V3 p_m = add3(ol, scale3(dl, t_m));
    // triangle_areas: dominant-axis projection.
    const float avx = fabsf(vn.x), avy = fabsf(vn.y), avz = fabsf(vn.z);
    const bool use_x = avx >= avy && avx >= avz;
    const bool use_y = !use_x && avy >= avx && avy >= avz;
    auto px = [&](V3 p) { return use_x ? p.y : p.x; };
    auto py = [&](V3 p) { return use_x ? p.z : (use_y ? p.z : p.y); };
    const float p0x = px(v0), p0y = py(v0), p1x = px(v1), p1y = py(v1);
    const float p2x = px(v2), p2y = py(v2), qx = px(p_m), qy = py(p_m);
    const float a0 = ((p1x - qx) * (p2y - qy) - (p1y - qy) * (p2x - qx)) * 0.5f;
    const float a1 = ((p2x - qx) * (p0y - qy) - (p2y - qy) * (p0x - qx)) * 0.5f;
    const float a2 = ((p0x - qx) * (p1y - qy) - (p0y - qy) * (p1x - qx)) * 0.5f;
    const float asum = a0 + a1 + a2;
    const float inv_asum = 1.0f / (fabsf(asum) < 1e-30f ? 1e-30f : asum);
    const float b0 = a0 * inv_asum, b1 = a1 * inv_asum, b2 = a2 * inv_asum;
    const V3 vn0 = v3(row[9], row[10], row[11]);
    const V3 vn1 = v3(row[12], row[13], row[14]);
    const V3 vn2 = v3(row[15], row[16], row[17]);
    t_l = t_m;
    p_l = p_m;
    n_l = add3(add3(scale3(vn0, b0), scale3(vn1, b1)), scale3(vn2, b2));
    mtl_id = imtl >= 0.0f ? imtl : row[27];
  }

  // FromNodeCoords (scene.h:497-501): p -> tm p + pos, N -> itm^T N.
  const V3 p_w = v3(tm[0] * p_l.x + tm[1] * p_l.y + tm[2] * p_l.z + pos.x,
                    tm[3] * p_l.x + tm[4] * p_l.y + tm[5] * p_l.z + pos.y,
                    tm[6] * p_l.x + tm[7] * p_l.y + tm[8] * p_l.z + pos.z);
  const V3 n_w = normalize3(
      v3(itm[0] * n_l.x + itm[3] * n_l.y + itm[6] * n_l.z,
         itm[1] * n_l.x + itm[4] * n_l.y + itm[7] * n_l.z,
         itm[2] * n_l.x + itm[5] * n_l.y + itm[8] * n_l.z));
  const float z = t_l;

  // ---- material row + Schlick Fresnel (MtlBlinn.cpp:107-114) ----
  const int midx =
      static_cast<int>(clamp_min(clamp_max(mtl_id, float(n_mtl - 1)), 0.0f));
  const float* mrow = s_mtl + 11 * midx;
  const V3 diffuse = v3(mrow[0], mrow[1], mrow[2]);
  const V3 specular = v3(mrow[3], mrow[4], mrow[5]);
  const float gloss = mrow[6];
  const V3 refraction = v3(mrow[7], mrow[8], mrow[9]);
  const float ior = mrow[10];

  const V3 vv = normalize3(sub3(o, p_w));
  const float cos_phi1 = clamp_min(clamp_max(dot3(n_w, vv), 1.0f), 0.0f);
  const float r0b = (1.0f - ior) / (1.0f + ior);
  const float r0 = r0b * r0b;
  const float fres = r0 + (1.0f - r0) * safe_pow(1.0f - cos_phi1, 5.0f);
  const V3 new_spec = v3(clamp_max(specular.x + fres * refraction.x, 1.0f),
                         clamp_max(specular.y + fres * refraction.y, 1.0f),
                         clamp_max(specular.z + fres * refraction.z, 1.0f));
  const V3 refr_eff = scale3(refraction, 1.0f - fres);

  // ---- one-light selection (MtlBlinn.cpp:309-315): the first light whose
  // share is >= u7, else the last ----
  int lsel = n_lights - 1;
  for (int k = 0; k < n_lights; ++k) {
    if (u[7] <= s_light[9 * k + 8]) {
      lsel = k;
      break;
    }
  }
  const float* lrow = s_light + 9 * lsel;
  const float lkind = lrow[0];
  const V3 intensity = v3(lrow[1], lrow[2], lrow[3]);
  const V3 lvec = v3(lrow[4], lrow[5], lrow[6]);
  const float lsize = lrow[7];
  const bool is_point = lkind == 2.0f;
  const bool is_direct = lkind == 1.0f;

  // ---- GetSampleInLight (MtlBlinn.cpp:637-695) ----
  const float kd = maximum(diffuse.x, maximum(diffuse.y, diffuse.z));
  const float ks = maximum(new_spec.x, maximum(new_spec.y, new_spec.z));
  const V3 vl_c = sub3(lvec, p_w);
  float d_cos;
  const V3 d_vl =
      sample_along_light_direction(normalize3(vl_c), gloss, u[0], u[1], d_cos);
  const float p_diffuse = safe_pow(d_cos, gloss);
  const float big_r = sqrtf(u[2]) * lsize;
  const float th = u[3] * kTwoPi;
  const V3 a1 = normalize3(cross3(crossing_vector(vl_c), vl_c));
  const V3 a2 = normalize3(cross3(a1, vl_c));
  const V3 s_vl = add3(vl_c, add3(scale3(a1, big_r * cosf(th)),
                                  scale3(a2, big_r * sinf(th))));
  const float p_specular = 2.0f * u[2] / clamp_min(big_r * big_r, 1e-30f);
  const float pd = kd * p_diffuse;
  const float ps = ks * p_specular;
  const float pd_norm = safe_div(pd, pd + ps);
  bool use_spec = u[4] >= pd_norm;
  const bool only_diffuse = ks == 0.0f && kd != 0.0f;
  const bool only_spec = ks != 0.0f && kd == 0.0f;
  use_spec = (use_spec && !only_diffuse) || only_spec;
  const V3 vl_point = use_spec ? normalize3(s_vl) : normalize3(d_vl);
  const V3 nlvec = normalize3(lvec);
  const V3 vl_other =
      is_direct ? v3(-nlvec.x, -nlvec.y, -nlvec.z) : v3(0.0f, 0.0f, 0.0f);
  const V3 vl = where3(is_point, vl_point, vl_other);
  const float cos_theta = dot3(vl, n_w);

  // ---- Illuminate, pre-visibility half (PointLight.cpp:7-18) ----
  const V3 center = sub3(lvec, p_w);
  const float rr = dot3(center, center);
  V3 sdir = sample_along_normal(center, lsize, u[5], u[6]);
  sdir = where3(lsize > 0.0f, sdir, center);
  V3 sh_d = where3(is_point, sdir, v3(-lvec.x, -lvec.y, -lvec.z));
  const bool cand = shade && cos_theta > 0.0f && (is_point || is_direct);
  const V3 sh_o = cand ? p_w : v3(1.0e8f, 1.0e8f, 1.0e8f);
  sh_d = cand ? sh_d : v3(0.0f, 0.0f, 1.0f);
  const float tmax = cand ? (is_point ? 1.0f : BHRT_BIG) : 0.0f;
  const bool rr0 = is_point && rr == 0.0f;
  const float inv_rr = 1.0f / clamp_min(rr, 1e-30f);
  const V3 irr = is_point ? (rr0 ? v3(BHRT_BIG, BHRT_BIG, BHRT_BIG)
                                 : scale3(intensity, inv_rr))
                          : intensity;

  // ---- BRDF * cos (MtlBlinn.cpp:317-327) ----
  const V3 vh = normalize3(add3(vl, vv));
  const float hn = clamp_min(dot3(vh, n_w), 0.0f);
  const float spec_pow = safe_pow(hn, gloss);
  const V3 brdf_cos = add3(scale3(diffuse, cos_theta), scale3(new_spec, spec_pow));

  // ---- GI lobe (MtlBlinn.cpp:354-433) ----
  float p_dt;
  const V3 d_dir = normalize3(sample_in_semisphere(n_w, u[8], u[9], p_dt));
  const V3 vr = sub3(scale3(n_w, 2.0f * dot3(n_w, vv)), vv);
  float gi_scos;
  const V3 s_dir =
      sample_along_light_direction(vr, gloss, u[10], u[11], gi_scos);
  const float p_st = safe_pow(gi_scos, gloss);
  const float gi_pd = safe_div(kd * p_dt, kd * p_dt + ks * p_st);
  const bool gi_spec = u[12] >= gi_pd;
  const V3 gi_d = where3(gi_spec, s_dir, d_dir);
  const V3 gi_o = add3(p_w, scale3(n_w, bias));
  const V3 albedo = where3(gi_spec, new_spec, diffuse);

  const float vals[37] = {
      p_w.x, p_w.y, p_w.z, n_w.x, n_w.y, n_w.z, z, mtl_id,
      sh_o.x, sh_o.y, sh_o.z, sh_d.x, sh_d.y, sh_d.z, tmax,
      cand ? 1.0f : 0.0f, rr0 ? 1.0f : 0.0f,
      cos_theta, irr.x, irr.y, irr.z, brdf_cos.x, brdf_cos.y, brdf_cos.z,
      gi_o.x, gi_o.y, gi_o.z, gi_d.x, gi_d.y, gi_d.z,
      albedo.x, albedo.y, albedo.z,
      refr_eff.x, refr_eff.y, refr_eff.z, cos_phi1};
#pragma unroll
  for (int k = 0; k < 37; ++k) out[k * n + i] = vals[k];
}

}  // namespace

extern "C" int bhrt_shade_setup(const float* planes, const int* hits,
                                const float* u, const float* resolve_rows,
                                int n_faces, const float* inst_tab, int n_sph,
                                int n_pln, int n_msh, const float* mtl_tab,
                                int n_mtl, const float* light_tab,
                                int n_lights, float bias, int n, float* out,
                                void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  shade_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, hits, u, resolve_rows, n_faces, inst_tab, n_sph, n_pln, n_msh,
      mtl_tab, n_mtl, light_tab, n_lights, bias, n, out);
  return static_cast<int>(cudaGetLastError());
}
