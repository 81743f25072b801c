// rtow_native — host-side runtime for the path tracer.
//
// The reference implements its whole runtime in C++ (loader: tinyobjloader
// via src/main.cpp:109-131; output: PPM P3 writer render.cpp:11-20,182-186;
// acceleration build: BVHNode render.cpp:73-110).  This framework keeps
// the *compute* path in JAX/XLA but gives these host-side components native
// implementations with a plain C ABI consumed through ctypes:
//
//   * rtow_load_obj     — fast triangles-only OBJ ingestion (double precision)
//   * rtow_write_ppm    — tone-map + P3 serialisation of the framebuffer
//   * rtow_build_bvh    — flattened stackless-BVH construction (preorder,
//                         left-child = node+1, skip index)
//
// All functions are thread-safe and allocation is caller-visible: buffers
// returned by the library are freed with rtow_free.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

void rtow_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// OBJ loader
// ---------------------------------------------------------------------------
// Parses 'v' and 'f' records; triangles only (the reference throws on
// non-triangular faces, src/main.cpp:130).  Negative indices supported.
// Returns 0 on success; fills *out_tris (malloc'd, n_tris*9 doubles, layout
// (tri, corner, xyz)) and *out_n. On failure returns nonzero and sets
// *err_line to the offending line (0 = file-level error).
int rtow_load_obj(const char* path, double** out_tris, int64_t* out_n,
                  int64_t* err_line) {
  *out_tris = nullptr;
  *out_n = 0;
  *err_line = 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  std::vector<double> verts;  // xyz triples
  std::vector<int64_t> faces; // vertex-index triples
  char line[8192];
  int64_t lineno = 0;
  while (std::fgets(line, sizeof line, f)) {
    ++lineno;
    char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (s[0] == 'v' && (s[1] == ' ' || s[1] == '\t')) {
      char* end = s + 1;
      double x = std::strtod(end, &end);
      double y = std::strtod(end, &end);
      double z = std::strtod(end, &end);
      verts.push_back(x);
      verts.push_back(y);
      verts.push_back(z);
    } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      int64_t idx[4];
      int n = 0;
      char* p = s + 1;
      while (*p && *p != '\n' && *p != '\r') {
        while (*p == ' ' || *p == '\t') ++p;
        if (!*p || *p == '\n' || *p == '\r') break;
        if (n >= 4) { std::fclose(f); *err_line = lineno; return 2; }
        char* end;
        long long v = std::strtoll(p, &end, 10);
        if (end == p) { std::fclose(f); *err_line = lineno; return 3; }
        int64_t nverts = (int64_t)(verts.size() / 3);
        idx[n++] = v > 0 ? v - 1 : nverts + v;
        p = end;
        // Skip the /vt/vn part of this corner.
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
      }
      if (n != 3) { std::fclose(f); *err_line = lineno; return 2; }
      faces.push_back(idx[0]);
      faces.push_back(idx[1]);
      faces.push_back(idx[2]);
    }
    // vn/vt/o/g/s/usemtl/mtllib/#: ignored, like the reference loader use.
  }
  std::fclose(f);

  int64_t n_tris = (int64_t)(faces.size() / 3);
  int64_t n_verts = (int64_t)(verts.size() / 3);
  if (n_tris == 0) return 4;
  double* tris = (double*)std::malloc(sizeof(double) * 9 * n_tris);
  if (!tris) return 5;
  for (int64_t t = 0; t < n_tris; ++t) {
    for (int c = 0; c < 3; ++c) {
      int64_t vi = faces[t * 3 + c];
      if (vi < 0 || vi >= n_verts) { std::free(tris); *err_line = 0; return 6; }
      std::memcpy(tris + (t * 3 + c) * 3, verts.data() + vi * 3,
                  3 * sizeof(double));
    }
  }
  *out_tris = tris;
  *out_n = n_tris;
  return 0;
}

// ---------------------------------------------------------------------------
// PPM P3 writer
// ---------------------------------------------------------------------------
// Tone-maps mean radiance exactly like the reference write_color
// (render.cpp:11-20): per channel sqrt (gamma 2), clamp [0, 0.999], x256,
// truncate.  Serialises the whole P3 body into one malloc'd string.
int rtow_write_ppm(const double* mean, int64_t width, int64_t height,
                   char** out_str, int64_t* out_len) {
  *out_str = nullptr;
  *out_len = 0;
  // Worst case "255 255 255\n" = 12 chars/pixel + header.
  size_t cap = (size_t)width * height * 13 + 64;
  char* buf = (char*)std::malloc(cap);
  if (!buf) return 1;
  char* p = buf;
  p += std::snprintf(p, 64, "P3\n%lld %lld\n255\n", (long long)width,
                     (long long)height);
  int64_t n = width * height;
  for (int64_t i = 0; i < n; ++i) {
    int v[3];
    for (int c = 0; c < 3; ++c) {
      double x = mean[i * 3 + c];
      x = x > 0.0 ? std::sqrt(x) : 0.0;       // gamma-2
      x = x < 0.0 ? 0.0 : (x > 0.999 ? 0.999 : x);
      v[c] = (int)(256.0 * x);
    }
    p += std::snprintf(p, 16, "%d %d %d\n", v[0], v[1], v[2]);
  }
  *out_str = buf;
  *out_len = (int64_t)(p - buf);
  return 0;
}

// ---------------------------------------------------------------------------
// Flattened stackless BVH builder
// ---------------------------------------------------------------------------
// Builds the same preorder/skip layout as ops/bvh.py (left child = node+1,
// skip = preorder index of the subtree's escape), iteratively (explicit
// stack — no recursion limits on million-primitive meshes).  Split rule:
// largest centroid extent, median split (reference render.cpp:80-106 uses a
// first-vs-last-bbox heuristic; SURVEY.md quirks ledger frees this).
int rtow_build_bvh(const double* pmin, const double* pmax, int64_t n_prims,
                   int64_t leaf_size,
                   // outputs (malloc'd):
                   double** out_bbox_min, double** out_bbox_max,
                   int32_t** out_first, int32_t** out_count,
                   int32_t** out_skip, int32_t** out_prim_ids,
                   int64_t* out_n_nodes, int64_t* out_n_ids) {
  if (n_prims <= 0 || leaf_size <= 0) return 1;
  std::vector<double> cx(n_prims), cy(n_prims), cz(n_prims);
  for (int64_t i = 0; i < n_prims; ++i) {
    cx[i] = 0.5 * (pmin[i * 3 + 0] + pmax[i * 3 + 0]);
    cy[i] = 0.5 * (pmin[i * 3 + 1] + pmax[i * 3 + 1]);
    cz[i] = 0.5 * (pmin[i * 3 + 2] + pmax[i * 3 + 2]);
  }
  const double* cents[3] = {cx.data(), cy.data(), cz.data()};

  std::vector<int64_t> perm(n_prims);
  std::iota(perm.begin(), perm.end(), 0);

  std::vector<double> bmin, bmax;
  std::vector<int32_t> first, count, skip;
  std::vector<int32_t> order;
  bmin.reserve(n_prims * 6);
  bmax.reserve(n_prims * 6);

  // Iterative preorder build: a phase-machine stack emulates the
  // recursion exactly (left subtree emitted before right), so node
  // layout matches ops/bvh.py (left child = node+1; a second pass
  // derives skip indices from the children links).
  std::vector<int64_t> left_child, right_child;  // -1 for leaves
  struct Rec { int64_t lo, hi; int64_t me; int phase; };
  std::vector<Rec> rec;
  rec.push_back({0, n_prims, -1, 0});
  while (!rec.empty()) {
    Rec& r = rec.back();
    if (r.phase == 0) {
      // allocate node, compute bbox over range
      int64_t me = (int64_t)count.size();
      r.me = me;
      double mn[3] = {1e300, 1e300, 1e300}, mx[3] = {-1e300, -1e300, -1e300};
      for (int64_t i = r.lo; i < r.hi; ++i) {
        int64_t p = perm[i];
        for (int c = 0; c < 3; ++c) {
          mn[c] = std::min(mn[c], pmin[p * 3 + c]);
          mx[c] = std::max(mx[c], pmax[p * 3 + c]);
        }
      }
      bmin.insert(bmin.end(), mn, mn + 3);
      bmax.insert(bmax.end(), mx, mx + 3);
      left_child.push_back(-1);
      right_child.push_back(-1);
      if (r.hi - r.lo <= leaf_size) {
        first.push_back((int32_t)order.size());
        count.push_back((int32_t)(r.hi - r.lo));
        skip.push_back(-1);
        for (int64_t i = r.lo; i < r.hi; ++i)
          order.push_back((int32_t)perm[i]);
        rec.pop_back();
        // Patch parent linkage on unwind below (phase machine).
        if (!rec.empty()) {
          Rec& par = rec.back();
          if (par.phase == 1) left_child[par.me] = me;
          else if (par.phase == 2) right_child[par.me] = me;
        }
        continue;
      }
      first.push_back(0);
      count.push_back(0);
      skip.push_back(-1);
      // choose axis by centroid extent over [lo, hi)
      double cmn[3] = {1e300, 1e300, 1e300}, cmx[3] = {-1e300, -1e300, -1e300};
      for (int64_t i = r.lo; i < r.hi; ++i) {
        int64_t p = perm[i];
        for (int c = 0; c < 3; ++c) {
          double v = cents[c][p];
          cmn[c] = std::min(cmn[c], v);
          cmx[c] = std::max(cmx[c], v);
        }
      }
      int axis = 0;
      double best = cmx[0] - cmn[0];
      for (int c = 1; c < 3; ++c)
        if (cmx[c] - cmn[c] > best) { best = cmx[c] - cmn[c]; axis = c; }
      const double* cen = cents[axis];
      int64_t mid = r.lo + (r.hi - r.lo) / 2;
      // stable_sort (not nth_element) so tied centroids keep their order —
      // bit-identical trees to the Python builder (ops/bvh.py argsort
      // kind="stable"), which the parity tests rely on.
      std::stable_sort(perm.begin() + r.lo, perm.begin() + r.hi,
                       [cen](int64_t a, int64_t b) { return cen[a] < cen[b]; });
      r.phase = 1;
      rec.push_back({r.lo, mid, -1, 0});
      continue;
    } else if (r.phase == 1) {
      // left done; descend right
      int64_t mid = r.lo + (r.hi - r.lo) / 2;
      r.phase = 2;
      rec.push_back({mid, r.hi, -1, 0});
      continue;
    } else {
      // both children done
      int64_t me = r.me;
      rec.pop_back();
      if (!rec.empty()) {
        Rec& par = rec.back();
        if (par.phase == 1) left_child[par.me] = me;
        else if (par.phase == 2) right_child[par.me] = me;
      }
      continue;
    }
  }

  int64_t n_nodes = (int64_t)count.size();
  // Second pass: skip[node] = escape index (preorder).
  std::vector<int32_t> fixed_skip(n_nodes, (int32_t)n_nodes);
  struct SF { int64_t node; int64_t esc; };
  std::vector<SF> sstack;
  sstack.push_back({0, n_nodes});
  while (!sstack.empty()) {
    SF s = sstack.back();
    sstack.pop_back();
    fixed_skip[s.node] = (int32_t)s.esc;
    if (count[s.node] == 0) {
      int64_t l = left_child[s.node], rgt = right_child[s.node];
      // preorder: left = node+1, right's escape = node's escape
      sstack.push_back({l, rgt});
      sstack.push_back({rgt, s.esc});
    }
  }

  int64_t n_ids = (int64_t)order.size() + leaf_size;  // pad like ops/bvh.py
  auto alloc = [](size_t bytes) { return std::malloc(bytes); };
  *out_bbox_min = (double*)alloc(sizeof(double) * 3 * n_nodes);
  *out_bbox_max = (double*)alloc(sizeof(double) * 3 * n_nodes);
  *out_first = (int32_t*)alloc(sizeof(int32_t) * n_nodes);
  *out_count = (int32_t*)alloc(sizeof(int32_t) * n_nodes);
  *out_skip = (int32_t*)alloc(sizeof(int32_t) * n_nodes);
  *out_prim_ids = (int32_t*)alloc(sizeof(int32_t) * n_ids);
  if (!*out_bbox_min || !*out_bbox_max || !*out_first || !*out_count ||
      !*out_skip || !*out_prim_ids)
    return 2;
  std::memcpy(*out_bbox_min, bmin.data(), sizeof(double) * 3 * n_nodes);
  std::memcpy(*out_bbox_max, bmax.data(), sizeof(double) * 3 * n_nodes);
  std::memcpy(*out_first, first.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(*out_count, count.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(*out_skip, fixed_skip.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(*out_prim_ids, order.data(), sizeof(int32_t) * order.size());
  for (int64_t i = (int64_t)order.size(); i < n_ids; ++i)
    (*out_prim_ids)[i] = 0;
  *out_n_nodes = n_nodes;
  *out_n_ids = n_ids;
  return 0;
}

}  // extern "C"
