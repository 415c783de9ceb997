// tpupt_torch host library: scene set-up in C++ (OBJ parsing, BVH builds).
//
// The port's own copy of the reference package's tpupt/native/src/native.cpp,
// unchanged below this header. The reference's runtime is native Rust: tobj parses
// OBJ meshes (mesh.rs:149-197) and BVH::build runs a full-sweep SAH
// (bvh.rs:24-120) at scene setup, both on the host. This library does the same
// work for the port, loaded from Python via ctypes (tpupt_torch/native.py).
// Its output is bit-identical to the numpy builders (io/obj.py, ops/bvh.py).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 native_host.cpp -o libnative_host_<hash>.so
// (done at first use by tpupt_torch/build.py into tpupt_torch/_build/).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <algorithm>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing (tobj single_index semantics: unified v/vt/vn re-indexing,
// fan triangulation of polygons)
// ---------------------------------------------------------------------------

struct ObjMesh {
  std::vector<float> positions;  // V*3
  std::vector<float> normals;    // V*3 (zeros if absent)
  std::vector<float> uvs;        // V*2 (zeros if absent)
  std::vector<int32_t> indices;  // F*3
  int has_normals = 0;
  int has_uvs = 0;
};

static int resolve_idx(long idx, size_t n) {
  return idx > 0 ? (int)(idx - 1) : (int)((long)n + idx);
}

void* obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  std::vector<float> vpos, vnrm, vuv;
  auto* mesh = new ObjMesh();
  // key = (vi, ti, ni) packed
  std::unordered_map<uint64_t, int32_t> remap;
  remap.reserve(1 << 16);
  std::vector<int32_t> face;

  const char* p = buf.c_str();
  const char* end = p + buf.size();
  while (p < end) {
    const char* eol = (const char*)memchr(p, '\n', end - p);
    if (!eol) eol = end;
    if (p[0] == 'v' && p[1] == ' ') {
      char* q = (char*)p + 2;
      float x = strtof(q, &q), y = strtof(q, &q), z = strtof(q, &q);
      vpos.push_back(x); vpos.push_back(y); vpos.push_back(z);
    } else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ') {
      char* q = (char*)p + 3;
      float x = strtof(q, &q), y = strtof(q, &q), z = strtof(q, &q);
      vnrm.push_back(x); vnrm.push_back(y); vnrm.push_back(z);
    } else if (p[0] == 'v' && p[1] == 't' && p[2] == ' ') {
      char* q = (char*)p + 3;
      float u = strtof(q, &q), v = strtof(q, &q);
      vuv.push_back(u); vuv.push_back(v);
    } else if (p[0] == 'f' && p[1] == ' ') {
      face.clear();
      const char* q = p + 2;
      while (q < eol) {
        while (q < eol && *q == ' ') q++;
        if (q >= eol) break;
        char* qq = (char*)q;
        long vi = strtol(qq, &qq, 10);
        long ti = 0, ni = 0;
        bool has_t = false, has_n = false;
        if (*qq == '/') {
          qq++;
          if (*qq != '/') { ti = strtol(qq, &qq, 10); has_t = true; }
          if (*qq == '/') { qq++; ni = strtol(qq, &qq, 10); has_n = true; }
        }
        int v_i = resolve_idx(vi, vpos.size() / 3);
        int t_i = has_t ? resolve_idx(ti, vuv.size() / 2) : -1;
        int n_i = has_n ? resolve_idx(ni, vnrm.size() / 3) : -1;
        uint64_t key = ((uint64_t)(uint32_t)v_i << 42) ^
                       ((uint64_t)(uint32_t)(t_i + 1) << 21) ^
                       (uint64_t)(uint32_t)(n_i + 1);
        auto it = remap.find(key);
        int32_t out;
        if (it == remap.end()) {
          out = (int32_t)(mesh->positions.size() / 3);
          remap.emplace(key, out);
          mesh->positions.push_back(vpos[v_i * 3 + 0]);
          mesh->positions.push_back(vpos[v_i * 3 + 1]);
          mesh->positions.push_back(vpos[v_i * 3 + 2]);
          if (t_i >= 0) {
            mesh->uvs.push_back(vuv[t_i * 2 + 0]);
            mesh->uvs.push_back(vuv[t_i * 2 + 1]);
            mesh->has_uvs = 1;
          } else {
            mesh->uvs.push_back(0.f); mesh->uvs.push_back(0.f);
          }
          if (n_i >= 0) {
            mesh->normals.push_back(vnrm[n_i * 3 + 0]);
            mesh->normals.push_back(vnrm[n_i * 3 + 1]);
            mesh->normals.push_back(vnrm[n_i * 3 + 2]);
            mesh->has_normals = 1;
          } else {
            mesh->normals.push_back(0.f); mesh->normals.push_back(0.f);
            mesh->normals.push_back(0.f);
          }
        } else {
          out = it->second;
        }
        face.push_back(out);
        q = qq;
      }
      for (size_t k = 1; k + 1 < face.size(); k++) {  // fan triangulation
        mesh->indices.push_back(face[0]);
        mesh->indices.push_back(face[k]);
        mesh->indices.push_back(face[k + 1]);
      }
    }
    p = eol + 1;
  }
  return mesh;
}

int64_t obj_num_vertices(void* m) { return ((ObjMesh*)m)->positions.size() / 3; }
int64_t obj_num_faces(void* m) { return ((ObjMesh*)m)->indices.size() / 3; }
int obj_has_normals(void* m) { return ((ObjMesh*)m)->has_normals; }
int obj_has_uvs(void* m) { return ((ObjMesh*)m)->has_uvs; }

void obj_copy(void* m, float* pos, float* nrm, float* uv, int32_t* idx) {
  auto* mesh = (ObjMesh*)m;
  memcpy(pos, mesh->positions.data(), mesh->positions.size() * sizeof(float));
  memcpy(nrm, mesh->normals.data(), mesh->normals.size() * sizeof(float));
  memcpy(uv, mesh->uvs.data(), mesh->uvs.size() * sizeof(float));
  memcpy(idx, mesh->indices.data(), mesh->indices.size() * sizeof(int32_t));
}

void obj_free(void* m) { delete (ObjMesh*)m; }

// ---------------------------------------------------------------------------
// triangle BVH build: Morton sort + balanced pre-order emission with escape
// indices. Bit-identical output to the Python fallback (ops/bvh.py) so either
// can serve scene compilation; this one is the production path for big meshes.
// ---------------------------------------------------------------------------

static uint64_t spread10(uint64_t v) {
  v = (v | (v << 16)) & 0x030000FFull;
  v = (v | (v << 8)) & 0x0300F00Full;
  v = (v | (v << 4)) & 0x030C30C3ull;
  v = (v | (v << 2)) & 0x09249249ull;
  return v;
}

// leaf size must match ops/bvh.py LEAF_SIZE (and bvh.rs:22)
static const int LEAF_SIZE = 4;

struct BvhOut {
  std::vector<int32_t> order;
  std::vector<float> bmin, bmax;  // M*3
  std::vector<int32_t> skip, start, count;
};

static int64_t subtree_nodes(int64_t t) {
  if (t <= LEAF_SIZE) return 1;
  int64_t m = t / 2;
  return 1 + subtree_nodes(m) + subtree_nodes(t - m);
}

void* bvh_build(const float* v0, const float* e1, const float* e2, int64_t n) {
  auto* out = new BvhOut();
  const float pad = 1e-3f;  // aabb.rs:16-21

  std::vector<float> lo(n * 3), hi(n * 3);
  std::vector<double> cen(n * 3);
  double cmin[3] = {1e300, 1e300, 1e300}, cmax[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; i++) {
    for (int c = 0; c < 3; c++) {
      float a = v0[i * 3 + c];
      float b = a + e1[i * 3 + c];
      float d = a + e2[i * 3 + c];
      float l = std::min(a, std::min(b, d)) - pad;
      float h = std::max(a, std::max(b, d)) + pad;
      lo[i * 3 + c] = l;
      hi[i * 3 + c] = h;
      double ce = 0.5 * ((double)l + (double)h);
      cen[i * 3 + c] = ce;
      cmin[c] = std::min(cmin[c], ce);
      cmax[c] = std::max(cmax[c], ce);
    }
  }
  double span[3];
  for (int c = 0; c < 3; c++) span[c] = std::max(cmax[c] - cmin[c], 1e-12);

  std::vector<uint64_t> codes(n);
  for (int64_t i = 0; i < n; i++) {
    uint64_t q[3];
    for (int c = 0; c < 3; c++) {
      double x = (cen[i * 3 + c] - cmin[c]) / span[c];
      long long qi = (long long)(x * 1024.0);
      q[c] = (uint64_t)std::min(std::max(qi, 0ll), 1023ll);
    }
    codes[i] = (spread10(q[0]) << 2) | (spread10(q[1]) << 1) | spread10(q[2]);
  }
  out->order.resize(n);
  for (int64_t i = 0; i < n; i++) out->order[i] = (int32_t)i;
  std::stable_sort(out->order.begin(), out->order.end(),
                   [&](int32_t a, int32_t b) { return codes[a] < codes[b]; });

  std::vector<float> slo(n * 3), shi(n * 3);
  for (int64_t i = 0; i < n; i++) {
    memcpy(&slo[i * 3], &lo[out->order[i] * 3], 3 * sizeof(float));
    memcpy(&shi[i * 3], &hi[out->order[i] * 3], 3 * sizeof(float));
  }

  // pre-order emission with explicit stack (mirrors ops/bvh.py exactly)
  std::vector<std::pair<int64_t, int64_t>> work;
  work.emplace_back(0, n);
  while (!work.empty()) {
    auto [a, b] = work.back();
    work.pop_back();
    float bl[3] = {1e30f, 1e30f, 1e30f}, bh[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = a; i < b; i++)
      for (int c = 0; c < 3; c++) {
        bl[c] = std::min(bl[c], slo[i * 3 + c]);
        bh[c] = std::max(bh[c], shi[i * 3 + c]);
      }
    out->bmin.insert(out->bmin.end(), bl, bl + 3);
    out->bmax.insert(out->bmax.end(), bh, bh + 3);
    if (b - a <= LEAF_SIZE) {
      out->start.push_back((int32_t)a);
      out->count.push_back((int32_t)(b - a));
    } else {
      out->start.push_back(0);
      out->count.push_back(0);
      int64_t mid = (a + b) / 2;
      work.emplace_back(mid, b);
      work.emplace_back(a, mid);
    }
  }

  // skip patch via the same splits
  int64_t m_total = (int64_t)out->count.size();
  out->skip.assign(m_total, 0);
  std::vector<std::pair<int64_t, int64_t>> st;
  st.emplace_back(0, n);
  int64_t cursor = 0;
  while (!st.empty()) {
    auto [a, b] = st.back();
    st.pop_back();
    int64_t t = b - a;
    out->skip[cursor] = (int32_t)(cursor + subtree_nodes(t));
    cursor++;
    if (t > LEAF_SIZE) {
      int64_t mid = (a + b) / 2;
      st.emplace_back(mid, b);
      st.emplace_back(a, mid);
    }
  }
  (void)m_total;
  return out;
}

// ---------------------------------------------------------------------------
// binned-SAH build + cluster cut (mirrors ops/bvh.py build_tri_bvh_sah exactly:
// same f64 bin/cost math, same emission order, same greedy cluster merge).
// The production path for scene compilation; the numpy twin is the test oracle.
// ---------------------------------------------------------------------------

static const int SAH_BINS = 16;
static const int CLUSTER_MAX = 64;

struct SahOut {
  std::vector<int32_t> order;
  std::vector<float> bmin, bmax;  // M*3
  std::vector<int32_t> skip, start, count;
  std::vector<int32_t> cl_start, cl_count;
  std::vector<float> cl_min, cl_max;  // C*3
};

static double half_area(const double lo[3], const double hi[3]) {
  double d[3];
  for (int c = 0; c < 3; c++) d[c] = std::max(hi[c] - lo[c], 0.0);
  return d[0] * d[1] + d[1] * d[2] + d[2] * d[0];
}

void* bvh_build_sah(const float* v0, const float* e1, const float* e2, int64_t n) {
  auto* out = new SahOut();
  const double pad = 1e-3;

  std::vector<double> lo(n * 3), hi(n * 3), cen(n * 3);
  for (int64_t i = 0; i < n; i++)
    for (int c = 0; c < 3; c++) {
      // f32 min/max AND f32 pad subtraction (numpy: f32 arrays - python float
      // stays f32, then .astype(f64)) — bit-parity with ops/bvh.py
      float a = v0[i * 3 + c];
      float b = a + e1[i * 3 + c];
      float d = a + e2[i * 3 + c];
      double l = (double)(std::min(a, std::min(b, d)) - (float)pad);
      double h = (double)(std::max(a, std::max(b, d)) + (float)pad);
      lo[i * 3 + c] = l;
      hi[i * 3 + c] = h;
      cen[i * 3 + c] = 0.5 * (l + h);
    }

  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; i++) idx[i] = i;

  struct Frame { int64_t a, b; bool close; bool in_cluster; };
  std::vector<Frame> work;
  work.push_back({0, n, false, false});

  while (!work.empty()) {
    Frame fr = work.back();
    work.pop_back();
    if (fr.close) {  // fr.a = node id
      out->skip[fr.a] = (int32_t)out->count.size();
      continue;
    }
    int64_t a = fr.a, b = fr.b;
    int64_t node_id = (int64_t)out->count.size();
    double nlo[3] = {1e300, 1e300, 1e300}, nhi[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = a; i < b; i++)
      for (int c = 0; c < 3; c++) {
        nlo[c] = std::min(nlo[c], lo[idx[i] * 3 + c]);
        nhi[c] = std::max(nhi[c], hi[idx[i] * 3 + c]);
      }
    for (int c = 0; c < 3; c++) {
      out->bmin.push_back((float)nlo[c]);
      out->bmax.push_back((float)nhi[c]);
    }
    out->skip.push_back(0);
    work.push_back({node_id, 0, true, false});
    bool in_cluster = fr.in_cluster;
    if (!in_cluster && (b - a) <= CLUSTER_MAX) {
      out->cl_start.push_back((int32_t)a);
      out->cl_count.push_back((int32_t)(b - a));
      for (int c = 0; c < 3; c++) out->cl_min.push_back((float)nlo[c]);
      for (int c = 0; c < 3; c++) out->cl_max.push_back((float)nhi[c]);
      in_cluster = true;
    }
    if (b - a <= LEAF_SIZE) {
      out->start.push_back((int32_t)a);
      out->count.push_back((int32_t)(b - a));
      continue;
    }
    out->start.push_back(0);
    out->count.push_back(0);

    // ---- binned SAH split over idx[a:b] ----
    int64_t m = b - a;
    double cmin[3] = {1e300, 1e300, 1e300}, cmax[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = a; i < b; i++)
      for (int c = 0; c < 3; c++) {
        double v = cen[idx[i] * 3 + c];
        cmin[c] = std::min(cmin[c], v);
        cmax[c] = std::max(cmax[c], v);
      }
    double best_cost = 1e300;
    int best_axis = -1, best_s = -1;
    std::vector<int> bins(m);
    std::vector<int> best_bins(m);
    for (int axis = 0; axis < 3; axis++) {
      double ext = cmax[axis] - cmin[axis];
      if (ext < 1e-12) continue;
      double scale = SAH_BINS / ext;
      int64_t counts[SAH_BINS] = {0};
      double blo[SAH_BINS][3], bhi[SAH_BINS][3];
      for (int k = 0; k < SAH_BINS; k++)
        for (int c = 0; c < 3; c++) { blo[k][c] = 1e300; bhi[k][c] = -1e300; }
      for (int64_t i = 0; i < m; i++) {
        int64_t t = idx[a + i];
        int k = (int)std::min((int64_t)((cen[t * 3 + axis] - cmin[axis]) * scale),
                              (int64_t)(SAH_BINS - 1));
        bins[i] = k;
        counts[k]++;
        for (int c = 0; c < 3; c++) {
          blo[k][c] = std::min(blo[k][c], lo[t * 3 + c]);
          bhi[k][c] = std::max(bhi[k][c], hi[t * 3 + c]);
        }
      }
      double plo[SAH_BINS][3], phi[SAH_BINS][3], qlo[SAH_BINS][3], qhi[SAH_BINS][3];
      int64_t pc[SAH_BINS];
      for (int c = 0; c < 3; c++) { plo[0][c] = blo[0][c]; phi[0][c] = bhi[0][c]; }
      pc[0] = counts[0];
      for (int k = 1; k < SAH_BINS; k++) {
        pc[k] = pc[k - 1] + counts[k];
        for (int c = 0; c < 3; c++) {
          plo[k][c] = std::min(plo[k - 1][c], blo[k][c]);
          phi[k][c] = std::max(phi[k - 1][c], bhi[k][c]);
        }
      }
      for (int c = 0; c < 3; c++) {
        qlo[SAH_BINS - 1][c] = blo[SAH_BINS - 1][c];
        qhi[SAH_BINS - 1][c] = bhi[SAH_BINS - 1][c];
      }
      for (int k = SAH_BINS - 2; k >= 0; k--)
        for (int c = 0; c < 3; c++) {
          qlo[k][c] = std::min(qlo[k + 1][c], blo[k][c]);
          qhi[k][c] = std::max(qhi[k + 1][c], bhi[k][c]);
        }
      for (int s = 0; s < SAH_BINS - 1; s++) {
        int64_t nl = pc[s], nr = m - nl;
        if (nl == 0 || nr == 0) continue;
        double cost = half_area(plo[s], phi[s]) * nl + half_area(qlo[s + 1], qhi[s + 1]) * nr;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_s = s;
          best_bins = bins;
        }
      }
    }
    std::vector<int64_t> left, right;
    left.reserve(m);
    right.reserve(m);
    if (best_axis >= 0) {
      for (int64_t i = 0; i < m; i++)
        (best_bins[i] <= best_s ? left : right).push_back(idx[a + i]);
    } else {
      // degenerate: median split on the largest axis (stable by centroid)
      int axis = 0;
      double ebest = cmax[0] - cmin[0];
      for (int c = 1; c < 3; c++)
        if (cmax[c] - cmin[c] > ebest) { ebest = cmax[c] - cmin[c]; axis = c; }
      std::vector<int64_t> ord(m);
      for (int64_t i = 0; i < m; i++) ord[i] = i;
      std::stable_sort(ord.begin(), ord.end(), [&](int64_t x, int64_t y) {
        return cen[idx[a + x] * 3 + axis] < cen[idx[a + y] * 3 + axis];
      });
      std::vector<char> mask(m, 0);
      for (int64_t i = 0; i < m / 2; i++) mask[ord[i]] = 1;
      for (int64_t i = 0; i < m; i++)
        (mask[i] ? left : right).push_back(idx[a + i]);
    }
    for (size_t i = 0; i < left.size(); i++) idx[a + i] = left[i];
    for (size_t i = 0; i < right.size(); i++) idx[a + left.size() + i] = right[i];
    int64_t mid = a + (int64_t)left.size();
    work.push_back({mid, b, false, in_cluster});  // right below left
    work.push_back({a, mid, false, in_cluster});
  }

  out->order.resize(n);
  for (int64_t i = 0; i < n; i++) out->order[i] = (int32_t)idx[i];

  // greedy merge of adjacent clusters (ops/bvh.py _merge_clusters)
  {
    std::vector<int32_t> ms, mc;
    std::vector<float> mlo, mhi;
    size_t nc = out->cl_start.size();
    for (size_t i = 0; i < nc; i++) {
      if (!ms.empty() && mc.back() + out->cl_count[i] <= CLUSTER_MAX) {
        mc.back() += out->cl_count[i];
        for (int c = 0; c < 3; c++) {
          size_t j = (ms.size() - 1) * 3 + c;
          mlo[j] = std::min(mlo[j], out->cl_min[i * 3 + c]);
          mhi[j] = std::max(mhi[j], out->cl_max[i * 3 + c]);
        }
      } else {
        ms.push_back(out->cl_start[i]);
        mc.push_back(out->cl_count[i]);
        for (int c = 0; c < 3; c++) mlo.push_back(out->cl_min[i * 3 + c]);
        for (int c = 0; c < 3; c++) mhi.push_back(out->cl_max[i * 3 + c]);
      }
    }
    out->cl_start = ms;
    out->cl_count = mc;
    out->cl_min = mlo;
    out->cl_max = mhi;
  }
  return out;
}

int64_t bvh_num_clusters(void* h) { return (int64_t)((SahOut*)h)->cl_start.size(); }
int64_t bvh_num_nodes_sah(void* h) { return (int64_t)((SahOut*)h)->count.size(); }

void bvh_copy_sah(void* h, int32_t* order, float* bmin, float* bmax, int32_t* skip,
                  int32_t* start, int32_t* count, int32_t* cl_start, int32_t* cl_count,
                  float* cl_min, float* cl_max) {
  auto* o = (SahOut*)h;
  memcpy(order, o->order.data(), o->order.size() * sizeof(int32_t));
  memcpy(bmin, o->bmin.data(), o->bmin.size() * sizeof(float));
  memcpy(bmax, o->bmax.data(), o->bmax.size() * sizeof(float));
  memcpy(skip, o->skip.data(), o->skip.size() * sizeof(int32_t));
  memcpy(start, o->start.data(), o->start.size() * sizeof(int32_t));
  memcpy(count, o->count.data(), o->count.size() * sizeof(int32_t));
  memcpy(cl_start, o->cl_start.data(), o->cl_start.size() * sizeof(int32_t));
  memcpy(cl_count, o->cl_count.data(), o->cl_count.size() * sizeof(int32_t));
  memcpy(cl_min, o->cl_min.data(), o->cl_min.size() * sizeof(float));
  memcpy(cl_max, o->cl_max.data(), o->cl_max.size() * sizeof(float));
}

void bvh_free_sah(void* h) { delete (SahOut*)h; }

int64_t bvh_num_nodes(void* h) { return (int64_t)((BvhOut*)h)->count.size(); }

void bvh_copy(void* h, int32_t* order, float* bmin, float* bmax, int32_t* skip,
              int32_t* start, int32_t* count) {
  auto* o = (BvhOut*)h;
  memcpy(order, o->order.data(), o->order.size() * sizeof(int32_t));
  memcpy(bmin, o->bmin.data(), o->bmin.size() * sizeof(float));
  memcpy(bmax, o->bmax.data(), o->bmax.size() * sizeof(float));
  memcpy(skip, o->skip.data(), o->skip.size() * sizeof(int32_t));
  memcpy(start, o->start.data(), o->start.size() * sizeof(int32_t));
  memcpy(count, o->count.data(), o->count.size() * sizeof(int32_t));
}

void bvh_free(void* h) { delete (BvhOut*)h; }

}  // extern "C"
