// bhrt_native: the host-side native runtime for bhraytracer_tpu_torch.
//
// A copy of bhraytracer_tpu/native/bhrt_native.cpp: both packages must build
// the same BVH, because the BVH leaf order fixes the face order of the pack.
//
// TPU-native counterpart of the reference's host-side native subsystems:
//   - PNG scanline unfiltering (hot loop of LodePNG decode; textures are
//     decoded at scene-compile time, BHRayTracer/Textures/Texture.cpp:70)
//   - BVH mid-split build over triangle bounds (cyBVH.h:122-328)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// Each entry point has a pure-Python/numpy fallback; results are
// bit-identical so either path may serve any call.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <vector>
#include <string>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// PNG unfilter: raw = (h, 1+stride) rows with leading filter byte.
// out = (h, stride). Returns 0 on success.
// ---------------------------------------------------------------------------
int bhrt_png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h,
                      int64_t stride, int64_t bpp) {
  std::vector<uint8_t> zero(stride, 0);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t ft = raw[y * (stride + 1)];
    const uint8_t* line = raw + y * (stride + 1) + 1;
    const uint8_t* prev = y > 0 ? out + (y - 1) * stride : zero.data();
    uint8_t* cur = out + y * stride;
    switch (ft) {
      case 0:
        std::memcpy(cur, line, stride);
        break;
      case 1:  // Sub
        for (int64_t x = 0; x < stride; ++x) {
          const uint8_t a = x >= bpp ? cur[x - bpp] : 0;
          cur[x] = (uint8_t)(line[x] + a);
        }
        break;
      case 2:  // Up
        for (int64_t x = 0; x < stride; ++x) cur[x] = (uint8_t)(line[x] + prev[x]);
        break;
      case 3:  // Average
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          cur[x] = (uint8_t)(line[x] + ((a + prev[x]) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev[x];
          const int c = x >= bpp ? prev[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = (uint8_t)(line[x] + pred);
        }
        break;
      default:
        return 1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// BVH mid-split build (same algorithm/layout as accel/bvh.py):
// widest-axis centroid mid split with axis fallbacks and forced halving;
// flat nodes, siblings adjacent, leaves reference a contiguous face range.
//
// Outputs are written into caller-allocated arrays sized for the worst case
// (2*nf nodes). Returns the node count, or -1 on error; *out_depth gets the
// tree depth.
// ---------------------------------------------------------------------------
struct BuildCtx {
  const float* tmin;       // (nf,3)
  const float* tmax;       // (nf,3)
  const float* cen;        // (nf,3)
  float* bmin;             // (cap,3)
  float* bmax;             // (cap,3)
  int32_t* left;           // (cap)
  int32_t* count;          // (cap)
  int32_t* order;          // (nf)
  int64_t n_nodes;
  int64_t n_order;
  int64_t cap;
  int32_t leaf_size;
  int32_t depth;
};

static int64_t bvh_reserve(BuildCtx* c) {
  if (c->n_nodes >= c->cap) return -1;
  return c->n_nodes++;
}

static int bvh_build_rec(BuildCtx* c, int64_t node, int32_t* elem, int64_t n,
                         int32_t depth) {
  if (depth > c->depth) c->depth = depth;
  float bmin[3] = {1e30f, 1e30f, 1e30f}, bmax[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i) {
    const float* lo = c->tmin + 3 * elem[i];
    const float* hi = c->tmax + 3 * elem[i];
    for (int k = 0; k < 3; ++k) {
      bmin[k] = std::min(bmin[k], lo[k]);
      bmax[k] = std::max(bmax[k], hi[k]);
    }
  }
  std::memcpy(c->bmin + 3 * node, bmin, 12);
  std::memcpy(c->bmax + 3 * node, bmax, 12);

  if (n <= c->leaf_size) {
    c->left[node] = (int32_t)c->n_order;
    c->count[node] = (int32_t)n;
    std::memcpy(c->order + c->n_order, elem, n * sizeof(int32_t));
    c->n_order += n;
    return 0;
  }

  float cmin[3] = {1e30f, 1e30f, 1e30f}, cmax[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i) {
    const float* cc = c->cen + 3 * elem[i];
    for (int k = 0; k < 3; ++k) {
      cmin[k] = std::min(cmin[k], cc[k]);
      cmax[k] = std::max(cmax[k], cc[k]);
    }
  }
  int axes[3] = {0, 1, 2};
  float ext[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1], cmax[2] - cmin[2]};
  std::sort(axes, axes + 3, [&](int a, int b) { return ext[a] > ext[b]; });

  int64_t mid_n = -1;
  for (int t = 0; t < 3; ++t) {
    const int ax = axes[t];
    const float mid = 0.5f * (cmin[ax] + cmax[ax]);
    int64_t lo = 0;
    for (int64_t i = 0; i < n; ++i)
      if (c->cen[3 * elem[i] + ax] < mid) std::swap(elem[lo++], elem[i]);
    if (lo > 0 && lo < n) {
      mid_n = lo;
      break;
    }
  }
  if (mid_n < 0) mid_n = n / 2;  // forced halving

  const int64_t l = bvh_reserve(c);
  const int64_t r = bvh_reserve(c);
  if (l < 0 || r < 0) return -1;
  c->left[node] = (int32_t)l;
  c->count[node] = 0;
  if (bvh_build_rec(c, l, elem, mid_n, depth + 1)) return -1;
  if (bvh_build_rec(c, r, elem + mid_n, n - mid_n, depth + 1)) return -1;
  return 0;
}

int64_t bhrt_bvh_build(const float* verts, const int32_t* faces, int64_t nf,
                       int32_t leaf_size, float* bmin, float* bmax,
                       int32_t* left, int32_t* count, int32_t* order,
                       int32_t* out_depth) {
  std::vector<float> tmin(nf * 3), tmax(nf * 3), cen(nf * 3);
  for (int64_t f = 0; f < nf; ++f) {
    for (int k = 0; k < 3; ++k) {
      float lo = 1e30f, hi = -1e30f;
      for (int j = 0; j < 3; ++j) {
        const float v = verts[3 * faces[3 * f + j] + k];
        lo = std::min(lo, v);
        hi = std::max(hi, v);
      }
      tmin[3 * f + k] = lo;
      tmax[3 * f + k] = hi;
      cen[3 * f + k] = 0.5f * (lo + hi);
    }
  }
  std::vector<int32_t> elem(nf);
  for (int64_t i = 0; i < nf; ++i) elem[i] = (int32_t)i;

  BuildCtx c;
  c.tmin = tmin.data();
  c.tmax = tmax.data();
  c.cen = cen.data();
  c.bmin = bmin;
  c.bmax = bmax;
  c.left = left;
  c.count = count;
  c.order = order;
  c.n_nodes = 0;
  c.n_order = 0;
  c.cap = 2 * nf + 2;
  c.leaf_size = leaf_size;
  c.depth = 1;

  const int64_t root = bvh_reserve(&c);
  if (bvh_build_rec(&c, root, elem.data(), nf, 1)) return -1;
  *out_depth = c.depth;
  return c.n_nodes;
}

// ---------------------------------------------------------------------------
// OBJ geometry parser (the hot loop of cyTriMesh::LoadFromFileObj,
// cyTriMesh.h:263+, rebuilt): v/vn/vt/f with fan triangulation and
// v | v/t | v//n | v/t/n and negative-index forms, usemtl slot assignment by
// first-use order. MTL files themselves are parsed by the Python layer (cold
// path); mtllib names are returned as a '\n'-joined buffer. Semantics match
// scene/obj_loader.py line for line (floats via strtod then cast to f32,
// exactly Python's float() -> np.float32).
// ---------------------------------------------------------------------------

struct BhrtObj {
  std::vector<float> v, vn, vt;
  std::vector<int32_t> fv, fn, ft, fm;
  std::string names;    // usemtl names, '\n'-joined, first-use order
  std::string mtllibs;  // mtllib arguments, '\n'-joined, file order
};

}  // extern "C"

namespace {

inline bool obj_resolve(const char* tok, int64_t count, int32_t* out) {
  char* end;
  long i = strtol(tok, &end, 10);
  if (end == tok) return false;
  *out = (int32_t)(i > 0 ? i - 1 : count + i);
  return true;
}

}  // namespace

extern "C" {

BhrtObj* bhrt_obj_load(const char* path, int64_t counts[8]) {
  FILE* f = fopen(path, "rb");
  counts[6] = 0;  // parse-error flag (Python falls back + raises on error)
  if (!f) return nullptr;
  auto* o = new BhrtObj();
  std::vector<std::string> mtl_names;
  int32_t cur_mtl = -1;

  // getline: arbitrary line lengths (giant polygon fans occur in CAD
  // exports; a fixed buffer would silently split them — bit-identical to
  // the Python parser requires handling them whole).
  char* line = nullptr;
  size_t line_cap = 0;
  bool bad = false;
  // Corner scratch for one face.
  std::vector<int32_t> cv, ct, cn;
  while (!bad && getline(&line, &line_cap, f) != -1) {
    // Tokenize on whitespace (matches Python str.split()).
    char* save = nullptr;
    char* key = strtok_r(line, " \t\r\n", &save);
    if (!key || key[0] == '#') continue;
    if (!strcmp(key, "v") || !strcmp(key, "vn")) {
      std::vector<float>& dst = key[1] ? o->vn : o->v;
      for (int k = 0; k < 3; ++k) {
        char* t = strtok_r(nullptr, " \t\r\n", &save);
        dst.push_back(t ? (float)strtod(t, nullptr) : 0.0f);
      }
    } else if (!strcmp(key, "vt")) {
      for (int k = 0; k < 3; ++k) {
        char* t = strtok_r(nullptr, " \t\r\n", &save);
        o->vt.push_back(t ? (float)strtod(t, nullptr) : 0.0f);
      }
    } else if (!strcmp(key, "usemtl")) {
      char* t = strtok_r(nullptr, " \t\r\n", &save);
      std::string name = t ? t : "";
      cur_mtl = -1;
      for (size_t i = 0; i < mtl_names.size(); ++i)
        if (mtl_names[i] == name) { cur_mtl = (int32_t)i; break; }
      if (cur_mtl < 0) {
        mtl_names.push_back(name);
        cur_mtl = (int32_t)mtl_names.size() - 1;
        if (!o->names.empty()) o->names += '\n';
        o->names += name;
      }
    } else if (!strcmp(key, "mtllib")) {
      // Python joins the remaining tokens with single spaces.
      std::string arg;
      for (char* t = strtok_r(nullptr, " \t\r\n", &save); t;
           t = strtok_r(nullptr, " \t\r\n", &save)) {
        if (!arg.empty()) arg += ' ';
        arg += t;
      }
      if (!o->mtllibs.empty()) o->mtllibs += '\n';
      o->mtllibs += arg;
    } else if (!strcmp(key, "f")) {
      cv.clear(); ct.clear(); cn.clear();
      for (char* t = strtok_r(nullptr, " \t\r\n", &save); t;
           t = strtok_r(nullptr, " \t\r\n", &save)) {
        // Split on '/': v[/t[/n]] with empty slots allowed.
        char* p1 = strchr(t, '/');
        char* p2 = p1 ? strchr(p1 + 1, '/') : nullptr;
        if (p1) *p1 = 0;
        if (p2) *p2 = 0;
        int32_t vi, ti = -1, ni = -1;
        if (!obj_resolve(t, (int64_t)(o->v.size() / 3), &vi)) {
          // Malformed vertex index: the Python parser raises here; flag the
          // error so the wrapper falls back to it instead of silently
          // dropping the corner.
          bad = true;
          break;
        }
        if (p1 && p1[1] && (!p2 || p1 + 1 != p2))
          obj_resolve(p1 + 1, (int64_t)(o->vt.size() / 3), &ti);
        if (p2 && p2[1])
          obj_resolve(p2 + 1, (int64_t)(o->vn.size() / 3), &ni);
        cv.push_back(vi); ct.push_back(ti); cn.push_back(ni);
      }
      // Fan triangulation (cyTriMesh's reader; obj_loader.py:129-134).
      for (size_t k = 1; k + 1 < cv.size(); ++k) {
        const size_t idx[3] = {0, k, k + 1};
        for (int j = 0; j < 3; ++j) {
          o->fv.push_back(cv[idx[j]]);
          o->ft.push_back(ct[idx[j]]);
          o->fn.push_back(cn[idx[j]]);
        }
        o->fm.push_back(cur_mtl);
      }
    }
  }
  free(line);
  fclose(f);
  if (bad) counts[6] = 1;
  counts[0] = (int64_t)(o->v.size() / 3);
  counts[1] = (int64_t)(o->vn.size() / 3);
  counts[2] = (int64_t)(o->vt.size() / 3);
  counts[3] = (int64_t)(o->fm.size());
  counts[4] = (int64_t)o->names.size();
  counts[5] = (int64_t)o->mtllibs.size();
  return o;
}

int bhrt_obj_fill(BhrtObj* o, float* v, float* vn, float* vt,
                  int32_t* fv, int32_t* fn, int32_t* ft, int32_t* fm,
                  char* names, char* mtllibs) {
  if (!o) return -1;
  memcpy(v, o->v.data(), o->v.size() * sizeof(float));
  memcpy(vn, o->vn.data(), o->vn.size() * sizeof(float));
  memcpy(vt, o->vt.data(), o->vt.size() * sizeof(float));
  memcpy(fv, o->fv.data(), o->fv.size() * sizeof(int32_t));
  memcpy(fn, o->fn.data(), o->fn.size() * sizeof(int32_t));
  memcpy(ft, o->ft.data(), o->ft.size() * sizeof(int32_t));
  memcpy(fm, o->fm.data(), o->fm.size() * sizeof(int32_t));
  memcpy(names, o->names.data(), o->names.size());
  memcpy(mtllibs, o->mtllibs.data(), o->mtllibs.size());
  return 0;
}

void bhrt_obj_free(BhrtObj* o) { delete o; }

}  // extern "C"
