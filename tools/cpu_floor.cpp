// cpu_floor — independent CPU baseline harness.
//
// The reference (joaotavora/raytracing-one-weekend) publishes no benchmark
// numbers and its conan dependencies (glm/cli11/fmt) are not installable in
// this environment, so the "measure the reference build on this machine"
// step is satisfied by this stand-alone re-implementation of the
// same algorithm: double-precision recursive path tracing, median-split BVH,
// lambertian/metal/dielectric materials, thin-lens camera with motion-blur
// shutter, std::async sample-sharding across all hardware threads — the
// reference's architecture (src/render.cpp) written independently, used ONLY
// to anchor the CPU Mrays/s floor for bench.py's vs_baseline.
//
// Usage: cpu_floor [width] [spp] [depth] [nthreads] [scene.txt] [out.ppm]
// Output: one line "mrays <value>" on stdout (primary rays/s in millions).
// scene.txt (optional): one sphere per line,
//   "cx cy cz dcx dcy dcz r kind aR aG aB fuzz ir"  (kind 0/1/2)
// written by tools/dump_scene.py — renders OUR generated scene so images
// can be compared pixel-region-wise against the JAX renderer.
// out.ppm (optional): write the tone-mapped P3 image (reference
// write_color semantics: mean, sqrt, clamp .999, x256).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <future>
#include <memory>
#include <random>
#include <thread>
#include <vector>

struct V3 {
  double x = 0, y = 0, z = 0;
};
static V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static V3 operator*(V3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
static V3 operator*(double s, V3 a) { return a * s; }
static V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
static double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static double len(V3 a) { return std::sqrt(dot(a, a)); }
static V3 unit(V3 a) { return a * (1.0 / len(a)); }

static thread_local std::mt19937 g_rng{std::random_device{}()};
static double rnd() {
  return std::uniform_real_distribution<double>(0.0, 1.0)(g_rng);
}
static double rnd(double a, double b) { return a + (b - a) * rnd(); }
static V3 rnd_unit_vec() {
  while (true) {
    V3 p{rnd(-1, 1), rnd(-1, 1), rnd(-1, 1)};
    double l2 = dot(p, p);
    if (l2 > 1e-12 && l2 <= 1.0) return p * (1.0 / std::sqrt(l2));
  }
}
static V3 rnd_in_disk() {
  while (true) {
    V3 p{rnd(-1, 1), rnd(-1, 1), 0};
    if (dot(p, p) <= 1.0) return p;
  }
}

enum Kind { LAMB, METAL, DIEL };
struct Mat {
  Kind kind;
  V3 albedo;
  double fuzz = 0, ir = 1;
};

struct Sphere {
  V3 c0, dc;  // center(t) = c0 + t*dc
  double r;
  int mat;
};

// Triangle in v0/e1/e2 form, Moller-Trumbore determinant intersection
// with the reference's backface cull (src/common-model.cpp:104-125) —
// the same semantics the JAX renderer implements, so mesh floors are
// measured on the identical algorithm.
struct Tri {
  V3 a, e1, e2;
  int mat;
};

struct Ray {
  V3 o, d;
  double t;
};

struct Hit {
  double t;
  V3 p, n;
  bool front;
  int mat;
};

static bool hit_sphere(const Sphere& s, const Ray& ray, double tmin,
                       double tmax, Hit& h) {
  V3 c = s.c0 + s.dc * ray.t;
  V3 oc = ray.o - c;
  double a = dot(ray.d, ray.d);
  double hb = dot(oc, ray.d);
  double cc = dot(oc, oc) - s.r * s.r;
  double disc = hb * hb - a * cc;
  if (disc < 0) return false;
  double sq = std::sqrt(disc);
  double root = (-hb - sq) / a;
  if (root <= tmin || root > tmax) {
    root = (-hb + sq) / a;
    if (root <= tmin || root > tmax) return false;
  }
  h.t = root;
  h.p = ray.o + ray.d * root;
  V3 out_n = (h.p - c) * (1.0 / s.r);
  h.front = dot(ray.d, out_n) < 0;
  h.n = h.front ? out_n : out_n * -1.0;
  h.mat = s.mat;
  return true;
}

static bool hit_tri(const Tri& t, const Ray& ray, double tmin, double tmax,
                    Hit& h) {
  V3 n = cross(t.e1, t.e2);
  double det = -dot(ray.d, n);
  if (det < 1e-6) return false;  // backface cull (reference semantics)
  double invdet = 1.0 / det;
  V3 ao = ray.o - t.a;
  V3 dao = cross(ao, ray.d);
  double u = dot(t.e2, dao) * invdet;
  double v = -dot(t.e1, dao) * invdet;
  double tt = dot(ao, n) * invdet;
  if (tt <= tmin || tt > tmax || u < 0 || v < 0 || u + v > 1) return false;
  h.t = tt;
  h.p = ray.o + ray.d * tt;
  h.n = unit(n);
  h.front = true;
  h.mat = t.mat;
  return true;
}

// Median-split BVH over primitive indices (flattened, skip-index
// layout).  Ids < nsph are spheres; id - nsph indexes triangles.
struct BVHNode {
  V3 bmin, bmax;
  int first = 0, count = 0, skip = 0;
};

struct BVH {
  std::vector<BVHNode> nodes;
  std::vector<int> ids;
};

static void prim_bounds(const std::vector<Sphere>& sph,
                        const std::vector<Tri>& tri, int id, V3& lo, V3& hi) {
  if (id < (int)sph.size()) {
    const Sphere& s = sph[id];
    double r = std::fabs(s.r);
    V3 lo0 = s.c0 - V3{r, r, r}, hi0 = s.c0 + V3{r, r, r};
    V3 lo1 = s.c0 + s.dc - V3{r, r, r}, hi1 = s.c0 + s.dc + V3{r, r, r};
    lo = {std::min(lo0.x, lo1.x), std::min(lo0.y, lo1.y), std::min(lo0.z, lo1.z)};
    hi = {std::max(hi0.x, hi1.x), std::max(hi0.y, hi1.y), std::max(hi0.z, hi1.z)};
  } else {
    const Tri& t = tri[id - (int)sph.size()];
    V3 b = t.a + t.e1, c = t.a + t.e2;
    lo = {std::min({t.a.x, b.x, c.x}), std::min({t.a.y, b.y, c.y}),
          std::min({t.a.z, b.z, c.z})};
    hi = {std::max({t.a.x, b.x, c.x}), std::max({t.a.y, b.y, c.y}),
          std::max({t.a.z, b.z, c.z})};
  }
}

static void build_bvh_rec(const std::vector<Sphere>& sph,
                          const std::vector<Tri>& tri, std::vector<int>& perm,
                          int lo, int hi, BVH& out) {
  BVHNode n;
  n.bmin = {1e300, 1e300, 1e300};
  n.bmax = {-1e300, -1e300, -1e300};
  for (int i = lo; i < hi; ++i) {
    V3 plo, phi;
    prim_bounds(sph, tri, perm[i], plo, phi);
    n.bmin = {std::min(n.bmin.x, plo.x), std::min(n.bmin.y, plo.y),
              std::min(n.bmin.z, plo.z)};
    n.bmax = {std::max(n.bmax.x, phi.x), std::max(n.bmax.y, phi.y),
              std::max(n.bmax.z, phi.z)};
  }
  int me = (int)out.nodes.size();
  out.nodes.push_back(n);
  if (hi - lo <= 4) {
    out.nodes[me].first = (int)out.ids.size();
    out.nodes[me].count = hi - lo;
    for (int i = lo; i < hi; ++i) out.ids.push_back(perm[i]);
    return;
  }
  V3 ext = n.bmax - n.bmin;
  int axis = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2) : (ext.y > ext.z ? 1 : 2);
  auto cen = [&](int id) {
    V3 plo, phi;
    prim_bounds(sph, tri, id, plo, phi);
    V3 c = (plo + phi) * 0.5;
    return axis == 0 ? c.x : axis == 1 ? c.y : c.z;
  };
  std::sort(perm.begin() + lo, perm.begin() + hi,
            [&](int a, int b) { return cen(a) < cen(b); });
  int mid = (lo + hi) / 2;
  build_bvh_rec(sph, tri, perm, lo, mid, out);
  build_bvh_rec(sph, tri, perm, mid, hi, out);
}

// Rebuild skip indices by a second recursive pass mirroring the build.
static int subtree_end(const BVH& b, int node) {
  if (b.nodes[node].count > 0) return node + 1;
  int left_end = subtree_end(b, node + 1);
  return subtree_end(b, left_end);
}
static void assign_skips(BVH& b, int node, int esc) {
  b.nodes[node].skip = esc;
  if (b.nodes[node].count == 0) {
    int left = node + 1;
    int right = subtree_end(b, left);
    assign_skips(b, left, right);
    assign_skips(b, right, esc);
  }
}

static bool hit_bvh(const BVH& b, const std::vector<Sphere>& sph,
                    const std::vector<Tri>& tri, const Ray& ray, double tmin,
                    Hit& best) {
  double tmax = 1e300;
  bool found = false;
  V3 inv{1.0 / ray.d.x, 1.0 / ray.d.y, 1.0 / ray.d.z};
  int node = 0;
  int n_nodes = (int)b.nodes.size();
  while (node < n_nodes) {
    const BVHNode& nd = b.nodes[node];
    double t0x = (nd.bmin.x - ray.o.x) * inv.x, t1x = (nd.bmax.x - ray.o.x) * inv.x;
    double t0y = (nd.bmin.y - ray.o.y) * inv.y, t1y = (nd.bmax.y - ray.o.y) * inv.y;
    double t0z = (nd.bmin.z - ray.o.z) * inv.z, t1z = (nd.bmax.z - ray.o.z) * inv.z;
    double enter = std::max({std::min(t0x, t1x), std::min(t0y, t1y),
                             std::min(t0z, t1z), tmin});
    double exit_ = std::min({std::max(t0x, t1x), std::max(t0y, t1y),
                             std::max(t0z, t1z), tmax});
    if (exit_ <= enter) {
      node = nd.skip;
      continue;
    }
    if (nd.count > 0) {
      for (int k = 0; k < nd.count; ++k) {
        Hit h;
        int id = b.ids[nd.first + k];
        bool got = id < (int)sph.size()
                       ? hit_sphere(sph[id], ray, tmin, tmax, h)
                       : hit_tri(tri[id - (int)sph.size()], ray, tmin, tmax, h);
        if (got) {
          best = h;
          tmax = h.t;
          found = true;
        }
      }
      node = nd.skip;
    } else {
      node = node + 1;
    }
  }
  return found;
}

static double schlick(double cosine, double ref) {
  double r0 = (1 - ref) / (1 + ref);
  r0 *= r0;
  return r0 + (1 - r0) * std::pow(1 - cosine, 5);
}

static V3 ray_color(const Ray& r, const BVH& bvh, const std::vector<Sphere>& sph,
                    const std::vector<Tri>& tris, const std::vector<Mat>& mats,
                    int depth) {
  Hit h;
  if (!hit_bvh(bvh, sph, tris, r, 1e-3, h)) {
    V3 u = unit(r.d);
    double t = 0.5 * (u.y + 1.0);
    return (1.0 - t) * V3{1, 1, 1} + t * V3{0.5, 0.7, 1.0};
  }
  if (depth <= 0) return {0, 0, 0};
  const Mat& m = mats[h.mat];
  Ray sc{h.p, {}, r.t};
  V3 atten = m.albedo;
  if (m.kind == LAMB) {
    sc.d = h.n + rnd_unit_vec();
    if (dot(sc.d, sc.d) < 1e-12) sc.d = h.n;
  } else if (m.kind == METAL) {
    V3 refl = r.d - 2.0 * dot(r.d, h.n) * h.n;
    sc.d = refl + m.fuzz * rnd_unit_vec();
  } else {
    atten = {1, 1, 1};
    double ratio = h.front ? 1.0 / m.ir : m.ir;
    V3 u = unit(r.d);
    double ct = std::min(dot(u * -1.0, h.n), 1.0);
    double st = std::sqrt(std::max(0.0, 1 - ct * ct));
    if (ratio * st > 1.0 || schlick(ct, ratio) > rnd()) {
      sc.d = u - 2.0 * dot(u, h.n) * h.n;
    } else {
      V3 perp = ratio * (u + ct * h.n);
      V3 par = h.n * -std::sqrt(std::fabs(1.0 - dot(perp, perp)));
      sc.d = perp + par;
    }
  }
  return atten * ray_color(sc, bvh, sph, tris, mats, depth - 1);
}

// Minimal OBJ loader: v/f lines, triangles only, 1-based indices,
// "f a b c" or "f a/… b/… c/…" (reference loader semantics,
// src/main.cpp:115-131, one shared gray lambertian).
static bool load_obj(const char* path, std::vector<Tri>& tris,
                     std::vector<Mat>& mats) {
  FILE* f = std::fopen(path, "r");
  if (!f) return false;
  std::vector<V3> vs;
  mats.push_back({LAMB, {0.6, 0.5, 0.4}});
  char line[512];
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      V3 p;
      if (std::sscanf(line + 2, "%lf %lf %lf", &p.x, &p.y, &p.z) == 3)
        vs.push_back(p);
    } else if (line[0] == 'f' && line[1] == ' ') {
      long a = 0, b = 0, c = 0;
      char* p = line + 2;
      long* tgt[3] = {&a, &b, &c};
      for (int k = 0; k < 3; ++k) {
        while (*p == ' ') ++p;
        *tgt[k] = std::strtol(p, &p, 10);
        while (*p && *p != ' ' && *p != '\n') ++p;  // skip /vt/vn
      }
      if (a < 1 || b < 1 || c < 1 || a > (long)vs.size() ||
          b > (long)vs.size() || c > (long)vs.size())
        continue;
      V3 va = vs[a - 1], vb = vs[b - 1], vc = vs[c - 1];
      tris.push_back({va, vb - va, vc - va, 0});
    }
  }
  std::fclose(f);
  return !tris.empty();
}

int main(int argc, char** argv) {
  int width = argc > 1 ? std::atoi(argv[1]) : 1200;
  int spp = argc > 2 ? std::atoi(argv[2]) : 4;
  int depth = argc > 3 ? std::atoi(argv[3]) : 50;
  int nthreads = argc > 4 ? std::atoi(argv[4])
                          : (int)std::thread::hardware_concurrency();
  const char* scene_path = argc > 5 ? argv[5] : nullptr;
  const char* out_ppm = argc > 6 ? argv[6] : nullptr;
  std::vector<Sphere> sph;
  std::vector<Tri> tris;
  std::vector<Mat> mats;
  bool is_obj = scene_path && std::strstr(scene_path, ".obj");
  if (is_obj) {
    if (!load_obj(scene_path, tris, mats)) {
      std::fprintf(stderr, "cannot load %s\n", scene_path);
      return 1;
    }
    std::fprintf(stderr, "loaded %zu triangles from %s\n", tris.size(),
                 scene_path);
  } else if (scene_path) {
    FILE* sf = std::fopen(scene_path, "r");
    if (!sf) { std::fprintf(stderr, "cannot open %s\n", scene_path); return 1; }
    double cx, cy, cz, dx_, dy_, dz_, r, aR, aG, aB, fz, ir;
    int kind;
    while (std::fscanf(sf, "%lf %lf %lf %lf %lf %lf %lf %d %lf %lf %lf %lf %lf",
                       &cx, &cy, &cz, &dx_, &dy_, &dz_, &r, &kind, &aR, &aG,
                       &aB, &fz, &ir) == 13) {
      mats.push_back({(Kind)kind, {aR, aG, aB}, fz, ir});
      sph.push_back({{cx, cy, cz}, {dx_, dy_, dz_}, r, (int)mats.size() - 1});
    }
    std::fclose(sf);
    std::fprintf(stderr, "loaded %zu spheres from %s\n", sph.size(), scene_path);
  } else {
  // Cover scene (reference src/main.cpp:23-83 distribution).
  std::mt19937 gen(1234);
  auto u01 = [&]() { return std::uniform_real_distribution<double>(0, 1)(gen); };
  mats.push_back({LAMB, {0.5, 0.5, 0.5}});
  sph.push_back({{0, -1000, 0}, {}, 1000, 0});
  for (int a = -11; a < 11; ++a)
    for (int b = -11; b < 11; ++b) {
      double cm = u01();
      V3 c{a + 0.9 * u01(), 0.2, b + 0.9 * u01()};
      if (len(c - V3{4, 0.2, 0}) <= 0.9) continue;
      if (cm < 0.8) {
        mats.push_back({LAMB, {u01() * u01(), u01() * u01(), u01() * u01()}});
        sph.push_back({c, {0, 0.5 * u01(), 0}, 0.2, (int)mats.size() - 1});
      } else if (cm < 0.95) {
        mats.push_back({METAL,
                        {0.5 + 0.5 * u01(), 0.5 + 0.5 * u01(), 0.5 + 0.5 * u01()},
                        0.5 * u01()});
        sph.push_back({c, {}, 0.2, (int)mats.size() - 1});
      } else {
        mats.push_back({DIEL, {}, 0, 1.5});
        sph.push_back({c, {}, 0.2, (int)mats.size() - 1});
      }
    }
  mats.push_back({DIEL, {}, 0, 1.5});
  sph.push_back({{0, 1, 0}, {}, 1.0, (int)mats.size() - 1});
  mats.push_back({LAMB, {0.4, 0.2, 0.1}});
  sph.push_back({{-4, 1, 0}, {}, 1.0, (int)mats.size() - 1});
  mats.push_back({METAL, {0.7, 0.6, 0.5}, 0.0});
  sph.push_back({{4, 1, 0}, {}, 1.0, (int)mats.size() - 1});
  }

  BVH bvh;
  std::vector<int> perm(sph.size() + tris.size());
  for (size_t i = 0; i < perm.size(); ++i) perm[i] = (int)i;
  build_bvh_rec(sph, tris, perm, 0, (int)perm.size(), bvh);
  assign_skips(bvh, 0, (int)bvh.nodes.size());

  // Camera: cover scene (reference main.cpp:25-33), or the mesh-bench
  // camera used by bench.py's mesh_mrays / the knot README numbers.
  V3 lookfrom{13, 2, 3}, lookat{0, 0, 0}, vup{0, 1, 0};
  double fov = 20, aspect = 16.0 / 9.0, aperture = 0.1, fd = 10.0;
  if (is_obj) {
    lookfrom = {0, 0, 3};
    fov = 45;
    aspect = 1.0;
    aperture = 0.0;
    fd = 3.0;
  }
  int height = (int)(width / aspect);
  V3 w = unit(lookfrom - lookat);
  V3 uu = unit(cross(vup, w));
  V3 vv = cross(w, uu);
  double vh = 2.0 * std::tan(fov * M_PI / 360.0);
  double vw = aspect * vh;
  V3 horiz = fd * vw * uu, vert = fd * vh * vv;
  V3 llc = lookfrom - horiz * 0.5 - vert * 0.5 - fd * w;
  double lens_r = aperture / 2;

  std::vector<V3> frame((size_t)width * height);
  auto t_start = std::chrono::high_resolution_clock::now();
  auto work = [&](int rows_lo, int rows_hi) {
    double acc = 0;  // prevent DCE
    for (int i = rows_lo; i < rows_hi; ++i)
      for (int j = 0; j < width; ++j) {
        V3 col{0, 0, 0};
        for (int s = 0; s < spp; ++s) {
          double su = (j + rnd()) / (width - 1);
          double sv = (i + rnd()) / (height - 1);
          V3 rd = lens_r * rnd_in_disk();
          V3 off = uu * rd.x + vv * rd.y;
          Ray r{lookfrom + off,
                llc + su * horiz + sv * vert - lookfrom - off, rnd()};
          col = col + ray_color(r, bvh, sph, tris, mats, depth);
        }
        // image row 0 = top (reference from_top_i, render.cpp:153)
        frame[(size_t)(height - 1 - i) * width + j] = col * (1.0 / spp);
        acc += col.x + col.y + col.z;
      }
    return acc;
  };
  std::vector<std::future<double>> futs;
  int rows_per = (height + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int lo = t * rows_per, hi = std::min(height, lo + rows_per);
    if (lo >= hi) break;
    futs.push_back(std::async(std::launch::async, work, lo, hi));
  }
  double sum = 0;
  for (auto& f : futs) sum += f.get();
  auto t_end = std::chrono::high_resolution_clock::now();
  double secs = std::chrono::duration<double>(t_end - t_start).count();
  double mrays = (double)width * height * spp / secs / 1e6;
  std::fprintf(stderr, "checksum %.3f, %.2fs, %d threads\n", sum, secs, nthreads);
  std::printf("mrays %.4f\n", mrays);
  if (out_ppm) {
    FILE* f = std::fopen(out_ppm, "w");
    std::fprintf(f, "P3\n%d %d\n255\n", width, height);
    for (auto& c : frame) {
      auto tone = [](double x) {
        x = x > 0 ? std::sqrt(x) : 0;
        x = x < 0 ? 0 : (x > 0.999 ? 0.999 : x);
        return (int)(256 * x);
      };
      std::fprintf(f, "%d %d %d\n", tone(c.x), tone(c.y), tone(c.z));
    }
    std::fclose(f);
  }
  return 0;
}
