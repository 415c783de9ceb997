// Closest triangle of every ray over SAH clusters of up to 64 triangles, with the
// winner's interpolated shading attributes.
//
// Replaces the TPU kernels of tpupt/ops/pallas_tri.py (wrapper pallas_closest_tri):
//   closest_tri_flat_kernel       <- _tri_cluster_kernel      (tables of <= 768 clusters)
//   closest_tri_two_level_kernel  <- _tri_cluster_kernel_hbm  (larger tables)
// The contract is those kernels', not their tiling:
//   inputs  o [B,3], d [B,3], t_in [B] (f32, contiguous), tmin; the packed tables
//           of ops/tri_kernel.py: cl [C,8] cluster AABBs, scl [S,8] supercluster
//           AABBs (two-level only), geo [C,10,64] (v0, e1, e2, id per slot) and
//           attr [C,16,64] (n0, n1, n2, uv0, uv1, uv2, mat + HAS_UV_FLAG).
//   outputs t [B] f32, id [B] i32, ns [B,3] f32 (unnormalised interpolated
//           normal), u, v [B] f32 (UVs, or barycentrics without UVs), mat [B] i32.
//           A ray with no triangle in (tmin, t_in) gets t = BIG, id 0 and zeros.
//   rules   box test: 1/d after the sign-preserving flush |d| < 1e-20 -> +-1e-20;
//           tn = max(slabs, tmin) <= tf = min(slabs, t_in), min/max propagating
//           NaN like torch.minimum. Möller–Trumbore: f = 1/(|a| < 1e-8 ? 1 : a),
//           hit iff |a| >= 1e-8, u >= 0, u <= 1, v >= 0, u + v <= 1, t > tmin and
//           t strictly below the best so far (seeded with t_in). Clusters and
//           slots are visited in index order, so a tie in t goes to the lower
//           triangle id. Boxes are culled against the seed t_in, as on the TPU.
//
// Bound. A box test is 24 float operations and a triangle test 46 (adds,
// multiplies, one divide; compares not counted) per ray, against 60 B of ray
// input and output; a ray tests tens to hundreds of boxes and thousands of
// triangles, so the work is bound by arithmetic, and by the divergence of a
// warp's rays over clusters, not by memory.
//
// Design. One thread per ray; a warp is the packet. The cull is a warp ballot:
// a cluster is visited when any of the warp's 32 rays passes its box, and each
// ray then tests its triangles only if its own box test passed. The flat kernel
// stages every cluster box of the table (<= 768) in shared memory once per block
// and walks them all; a visited cluster's 64 triangles are copied by the warp
// into its shared-memory buffer with 16-byte loads, and every thread reads them
// as broadcasts. The two-level kernel first culls superclusters (sc_size
// consecutive clusters), then the clusters of the hit superclusters; the hit
// clusters and their lane masks go into a per-warp queue in shared memory, which
// is drained through a 2-slot ring filled by cp.async: the next cluster's copy is
// in flight while the current one is tested. The winner's attributes are read
// and interpolated once per ray, after the loop. Build with --fmad=false so each
// operation rounds on its own, like the plain version in ops/tri_kernel.py,
// which makes the two bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr int SLOTS = 64;
constexpr int GEO_ROWS = 10;
constexpr int ATTR_ROWS = 16;
constexpr int GEO_FLOATS = GEO_ROWS * SLOTS;  // 640 floats = 2560 B per cluster
constexpr int GEO_CHUNKS = GEO_FLOATS / 4;    // 160 16-byte chunks
constexpr float BIG = 3.0e38f;
constexpr float HAS_UV_FLAG = 1048576.0f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int FLAT_THREADS = 256;
constexpr int FLAT_WARPS = FLAT_THREADS / 32;
constexpr int FLAT_MAX_CLUSTERS = 768;

constexpr int TL_THREADS = 128;
constexpr int TL_WARPS = TL_THREADS / 32;
constexpr int QUEUE = 64;        // per-warp queue entries before a drain
constexpr int MAX_SC_SIZE = 32;  // clusters per supercluster

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, seed;
};

struct Best {
  float t, u, v;
  int slot;  // cluster * 64 + local slot, -1 while no triangle has won
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.f ? -1e-20f : 1e-20f) : d);
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, const float* t_in, int ray,
                                        bool active) {
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f};
  if (active) {
    r.ox = o[3 * ray + 0];
    r.oy = o[3 * ray + 1];
    r.oz = o[3 * ray + 2];
    r.dx = d[3 * ray + 0];
    r.dy = d[3 * ray + 1];
    r.dz = d[3 * ray + 2];
    r.seed = t_in[ray];
  }
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// box = min xyz, max xyz (any address space); the test of ops/tri_kernel.py _slab
__device__ __forceinline__ bool slab_hit(const Ray& r, float lx, float ly, float lz, float hx,
                                         float hy, float hz, float tmin) {
  const float t1x = (lx - r.ox) * r.ix;
  const float t2x = (hx - r.ox) * r.ix;
  const float t1y = (ly - r.oy) * r.iy;
  const float t2y = (hy - r.oy) * r.iy;
  const float t1z = (lz - r.oz) * r.iz;
  const float t2z = (hz - r.oz) * r.iz;
  const float tn = nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)),
                           nan_max(nan_min(t1z, t2z), tmin));
  const float tf = nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)),
                           nan_min(nan_max(t1z, t2z), r.seed));
  return tn <= tf;
}

__device__ __forceinline__ bool box_hit_global(const Ray& r, const float* __restrict__ box,
                                               float tmin) {
  return slab_hit(r, __ldg(box + 0), __ldg(box + 1), __ldg(box + 2), __ldg(box + 3),
                  __ldg(box + 4), __ldg(box + 5), tmin);
}

// Möller–Trumbore (mesh.rs:50-82) over one staged cluster s[10][64]
__device__ __forceinline__ void test_cluster(const Ray& r, const float* s, int cluster, float tmin,
                                             Best& best) {
#pragma unroll 4
  for (int j = 0; j < SLOTS; ++j) {
    const float v0x = s[0 * SLOTS + j], v0y = s[1 * SLOTS + j], v0z = s[2 * SLOTS + j];
    const float e1x = s[3 * SLOTS + j], e1y = s[4 * SLOTS + j], e1z = s[5 * SLOTS + j];
    const float e2x = s[6 * SLOTS + j], e2y = s[7 * SLOTS + j], e2z = s[8 * SLOTS + j];
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    const float f = 1.0f / (fabsf(a) < 1e-8f ? 1.0f : a);
    const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
    const float t = f * (e2x * qx + e2y * qy + e2z * qz);
    if (fabsf(a) >= 1e-8f && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t > tmin &&
        t < best.t) {
      best.t = t;
      best.u = u;
      best.v = v;
      best.slot = cluster * SLOTS + j;
    }
  }
}

// the winner's id and interpolated attributes (pallas_tri.py phase B, mesh.rs:84-101)
__device__ __forceinline__ void write_result(int ray, const Best& best,
                                             const float* __restrict__ geo,
                                             const float* __restrict__ attr, float* t_out,
                                             int* id_out, float* ns_out, float* u_out,
                                             float* v_out, int* mat_out) {
  if (best.slot < 0) {
    t_out[ray] = BIG;
    id_out[ray] = 0;
    ns_out[3 * ray + 0] = 0.f;
    ns_out[3 * ray + 1] = 0.f;
    ns_out[3 * ray + 2] = 0.f;
    u_out[ray] = 0.f;
    v_out[ray] = 0.f;
    mat_out[ray] = 0;
    return;
  }
  const int c = best.slot / SLOTS, j = best.slot % SLOTS;
  const float* a = attr + (size_t)c * ATTR_ROWS * SLOTS + j;
  const float u = best.u, v = best.v;
  const float w = 1.0f - u - v;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ns_out[3 * ray + k] = a[k * SLOTS] * w + a[(3 + k) * SLOTS] * u + a[(6 + k) * SLOTS] * v;
  }
  const float matf = a[15 * SLOTS];
  const bool has_uv = matf >= HAS_UV_FLAG;
  u_out[ray] = has_uv ? a[9 * SLOTS] * w + a[11 * SLOTS] * u + a[13 * SLOTS] * v : u;
  v_out[ray] = has_uv ? a[10 * SLOTS] * w + a[12 * SLOTS] * u + a[14 * SLOTS] * v : v;
  mat_out[ray] = (int)(has_uv ? matf - HAS_UV_FLAG : matf);
  t_out[ray] = best.t;
  id_out[ray] = (int)geo[(size_t)c * GEO_FLOATS + 9 * SLOTS + j];
}

__global__ void __launch_bounds__(FLAT_THREADS)
closest_tri_flat_kernel(const float* __restrict__ o, const float* __restrict__ d,
                        const float* __restrict__ t_in, float tmin, const float* __restrict__ cl,
                        int n_cl, const float* __restrict__ geo, const float* __restrict__ attr,
                        float* t_out, int* id_out, float* ns_out, float* u_out, float* v_out,
                        int* mat_out, int n_rays) {
  __shared__ float s_box[6][FLAT_MAX_CLUSTERS];
  __shared__ __align__(16) float s_tri[FLAT_WARPS][GEO_FLOATS];

  for (int k = threadIdx.x; k < 6 * n_cl; k += FLAT_THREADS) {
    s_box[k % 6][k / 6] = cl[(k / 6) * 8 + k % 6];
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  float* tri = s_tri[threadIdx.x / 32];
  const int ray = blockIdx.x * FLAT_THREADS + threadIdx.x;
  const bool active = ray < n_rays;
  const Ray r = load_ray(o, d, t_in, ray, active);
  Best best{r.seed, 0.f, 0.f, -1};

  for (int c = 0; c < n_cl; ++c) {
    const bool hit = active && slab_hit(r, s_box[0][c], s_box[1][c], s_box[2][c], s_box[3][c],
                                         s_box[4][c], s_box[5][c], tmin);
    if (__ballot_sync(FULL, hit) == 0) continue;  // warp-uniform
    const float4* src = reinterpret_cast<const float4*>(geo + (size_t)c * GEO_FLOATS);
    float4* dst = reinterpret_cast<float4*>(tri);
    for (int k = lane; k < GEO_CHUNKS; k += 32) dst[k] = __ldg(src + k);
    __syncwarp();
    if (hit) test_cluster(r, tri, c, tmin, best);
    __syncwarp();  // the buffer is rewritten for the next visited cluster
  }
  if (active) write_result(ray, best, geo, attr, t_out, id_out, ns_out, u_out, v_out, mat_out);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the warp copies cluster c's geometry block into one ring slot (5 chunks a lane)
__device__ __forceinline__ void stage_async(float* slot, const float* __restrict__ geo, int c,
                                            int lane) {
  const float* src = geo + (size_t)c * GEO_FLOATS;
  for (int k = lane; k < GEO_CHUNKS; k += 32) cp_async16(slot + 4 * k, src + 4 * k);
  cp_async_commit();
}

// test the warp's queued clusters, streaming their blocks through the 2-slot ring
__device__ void drain(int qn, const int* qc, const unsigned* qm, float* ring,
                      const float* __restrict__ geo, int lane, const Ray& r, float tmin,
                      Best& best) {
  if (qn == 0) return;
  __syncwarp();  // the queue entries written by lane 0 are visible
  stage_async(ring, geo, qc[0], lane);
  for (int i = 0; i < qn; ++i) {
    if (i + 1 < qn) {
      stage_async(ring + ((i + 1) & 1) * GEO_FLOATS, geo, qc[i + 1], lane);
      cp_async_wait<1>();  // all but the newest copy have landed
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's chunks of slot i are visible to the warp
    if ((qm[i] >> lane) & 1u) test_cluster(r, ring + (i & 1) * GEO_FLOATS, qc[i], tmin, best);
    __syncwarp();  // slot i is refilled two iterations on
  }
}

__global__ void __launch_bounds__(TL_THREADS)
closest_tri_two_level_kernel(const float* __restrict__ o, const float* __restrict__ d,
                             const float* __restrict__ t_in, float tmin,
                             const float* __restrict__ scl, int n_sc, int sc_size,
                             const float* __restrict__ cl, const float* __restrict__ geo,
                             const float* __restrict__ attr, float* t_out, int* id_out,
                             float* ns_out, float* u_out, float* v_out, int* mat_out, int n_rays) {
  __shared__ __align__(16) float s_ring[TL_WARPS][2 * GEO_FLOATS];
  __shared__ int s_qc[TL_WARPS][QUEUE];
  __shared__ unsigned s_qm[TL_WARPS][QUEUE];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ray = blockIdx.x * TL_THREADS + threadIdx.x;
  const bool active = ray < n_rays;
  const Ray r = load_ray(o, d, t_in, ray, active);
  Best best{r.seed, 0.f, 0.f, -1};
  int* qc = s_qc[warp];
  unsigned* qm = s_qm[warp];
  int qn = 0;  // warp-uniform

  for (int s = 0; s < n_sc; ++s) {
    const bool sc_hit = active && box_hit_global(r, scl + 8 * s, tmin);
    if (__ballot_sync(FULL, sc_hit) == 0) continue;
    for (int k = 0; k < sc_size; ++k) {
      const int c = s * sc_size + k;
      const unsigned m = __ballot_sync(FULL, sc_hit && box_hit_global(r, cl + 8 * c, tmin));
      if (m == 0) continue;
      if (lane == 0) {
        qc[qn] = c;
        qm[qn] = m;
      }
      if (++qn == QUEUE) {
        drain(qn, qc, qm, s_ring[warp], geo, lane, r, tmin, best);
        qn = 0;
      }
    }
  }
  drain(qn, qc, qm, s_ring[warp], geo, lane, r, tmin, best);
  if (active) write_result(ray, best, geo, attr, t_out, id_out, ns_out, u_out, v_out, mat_out);
}

}  // namespace

extern "C" int tpupt_closest_tri_flat(const float* o, const float* d, const float* t_in,
                                      float tmin, const float* cl, int n_cl, const float* geo,
                                      const float* attr, float* t_out, int* id_out,
                                      float* ns_out, float* u_out, float* v_out, int* mat_out,
                                      int n_rays, void* stream) {
  if (n_cl < 0 || n_cl > FLAT_MAX_CLUSTERS) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    const int blocks = (n_rays + FLAT_THREADS - 1) / FLAT_THREADS;
    closest_tri_flat_kernel<<<blocks, FLAT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t_in, tmin, cl, n_cl, geo, attr, t_out, id_out, ns_out, u_out, v_out, mat_out,
        n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_closest_tri_two_level(const float* o, const float* d, const float* t_in,
                                           float tmin, const float* scl, int n_sc, int sc_size,
                                           const float* cl, int n_cl, const float* geo,
                                           const float* attr, float* t_out, int* id_out,
                                           float* ns_out, float* u_out, float* v_out,
                                           int* mat_out, int n_rays, void* stream) {
  if (sc_size < 1 || sc_size > MAX_SC_SIZE || n_sc < 0 || n_sc * sc_size != n_cl) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays > 0) {
    const int blocks = (n_rays + TL_THREADS - 1) / TL_THREADS;
    closest_tri_two_level_kernel<<<blocks, TL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, t_in, tmin, scl, n_sc, sc_size, cl, geo, attr, t_out, id_out, ns_out, u_out,
        v_out, mat_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}
