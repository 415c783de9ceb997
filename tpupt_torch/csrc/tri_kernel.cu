// Closest triangle of every ray over SAH clusters of up to 64 triangles, with the
// winner's interpolated shading attributes.
//
// Replaces the TPU kernels of tpupt/ops/pallas_tri.py (wrapper pallas_closest_tri):
//   closest_tri_flat_kernel       <- _tri_cluster_kernel      (tables of <= 768 clusters,
//                                                              superclusters of 64)
//   closest_tri_two_level_kernel  <- _tri_cluster_kernel_hbm  (larger tables,
//                                                              superclusters of <= 32)
// The contract is those kernels', not their tiling:
//   inputs  o [B,3], d [B,3], t_in [B] (f32, contiguous), tmin; the packed tables
//           of ops/tri_kernel.py: scl [S,8] supercluster AABBs, cl [C,8] cluster
//           AABBs, geo [C,10,64] (v0, e1, e2, id per slot) and attr [C,16,64]
//           (n0, n1, n2, uv0, uv1, uv2, mat + HAS_UV_FLAG).
//   outputs t [B] f32, id [B] i32, ns [B,3] f32 (unnormalised interpolated
//           normal), u, v [B] f32 (UVs, or barycentrics without UVs), mat [B] i32.
//           A ray with no triangle in (tmin, t_in) gets t = BIG, id 0 and zeros.
//   rules   box test: 1/d after the sign-preserving flush |d| < 1e-20 -> +-1e-20;
//           tn = max(slabs, tmin) <= tf = min(slabs, t_in), min/max propagating
//           NaN like torch.minimum; boxes are finite. A ray tests a cluster's
//           triangles when its top box (the union of TOP_GROUP consecutive
//           superclusters, pad rows left out), its supercluster box and its
//           cluster box all pass, each against the seed t_in. Möller–Trumbore:
//           f = 1/(|a| < 1e-8 ? 1 : a), hit iff |a| >= 1e-8, u >= 0, u <= 1,
//           v >= 0, u + v <= 1, t > tmin and t strictly below the best so far
//           (seeded with t_in). Clusters and slots are visited in index order, so
//           a tie in t goes to the lower triangle id.
//
// Bound. A box test is 24 float operations and a triangle test 46 (adds,
// multiplies, one divide; compares not counted) per ray, against 60 B of ray
// input and output; a ray tests tens of boxes and hundreds of triangles, so the
// work is bound by arithmetic, and in practice by how few of a warp's 32 rays
// share a cluster: camera rays put 8 lanes of 32 into a visited cluster on
// average, the rays of the next bounce 1 to 3 (PERF.md).
//
// Design. Both kernels run the same device code; they differ in how many cluster
// boxes a lane holds (two for superclusters of 64, one for up to 32).
// - Persistent blocks (as many as stay resident on the card) take packets of 32
//   consecutive rays from an atomic counter, one warp a packet: a warp that is
//   done early takes the next packet instead of idling until its block's slowest
//   warp ends, and no wave is left part full. The box tables are staged once per
//   block: the supercluster boxes in shared memory, component-major, and the top
//   boxes computed from them there.
// - Cull, three levels. Top and supercluster boxes are tested ray-parallel (one
//   ray a lane, a ballot a box, the ballots of a group gathered without a branch
//   between them): these boxes are large and most of a warp shares them. The
//   clusters of a hit supercluster are tested box-parallel: each lane holds one
//   cluster box (or two), the rays that hit the supercluster are broadcast by
//   shuffles one at a time (two at a time for superclusters of at most 16), and
//   the lane gathers its cluster's lane mask.
// - A NaN in a slab test can only come from the ray (boxes are finite), so it is
//   looked for once per ray and the box tests use the plain fminf and fmaxf.
// - Leaf. Hit clusters and their lane masks go into a per-warp queue in shared
//   memory, drained through a 2-slot ring filled by cp.async (the next cluster's
//   2560 B block is in flight while the current one is tested). A cluster is
//   tested triangle-parallel: lane k holds triangles k and k + 32 in registers
//   (conflict-free reads, lane = slot), each ray of the mask is broadcast in
//   turn, and the winner is the warp minimum of the ordered bits of t, ties to
//   the lowest slot: the plain version's (t, slot) key. Nearly every visited
//   cluster has few of the warp's lanes in its mask, and then a ray costs two
//   triangle tests a lane where a ray-parallel loop costs the whole warp 64.
// The winner's attributes are read and interpolated once per ray, after the
// loop. Build with --fmad=false so each operation rounds on its own, like the
// plain version in ops/tri_kernel.py, which makes the two bit-equal.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int SLOTS = 64;
constexpr int GEO_ROWS = 10;
constexpr int ATTR_ROWS = 16;
constexpr int GEO_FLOATS = GEO_ROWS * SLOTS;  // 640 floats = 2560 B per cluster
constexpr int GEO_CHUNKS = GEO_FLOATS / 4;    // 160 16-byte chunks
constexpr float BIG = 3.0e38f;
constexpr float BIG_IDF = 16777216.0f;  // id of pad slots
constexpr float PAD_BOX = 1.0e30f;      // every coordinate of a pad box
constexpr float HAS_UV_FLAG = 1048576.0f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_KEY = 0x7fffffff;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 2;   // blocks per SM the register budget is set for
constexpr int TOP_GROUP = 8;    // superclusters per top box
constexpr int QUEUE = 128;      // per-warp queue entries before a drain
constexpr int RING = 2;         // ring slots per warp: one tested, the others in flight
constexpr int FLAT_SC_SIZE = 64;
constexpr int FLAT_MAX_CLUSTERS = 768;
constexpr int MAX_SC_SIZE = 32;  // two-level: a supercluster's clusters fit one lane each

struct Params {
  const float* o;
  const float* d;
  const float* t_in;
  float tmin;
  const float* scl;
  int n_sc;
  int sc_size;
  const float* cl;
  const float* geo;
  const float* attr;
  float* t_out;
  int* id_out;
  float* ns_out;
  float* u_out;
  float* v_out;
  int* mat_out;
  int n_rays;
  int* counter;  // next packet, zero at launch
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, seed;
  bool clean;  // no slab test of this ray produces a NaN
};

struct Best {
  float t, u, v;
  int slot;  // cluster * 64 + local slot, -1 while no triangle has won
};

struct Box {
  float lx, ly, lz, hx, hy, hz;
};

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

struct TriHit {
  float a, t, u, v;
};

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.f ? -1e-20f : 1e-20f) : d);
}

__device__ __forceinline__ Ray load_ray(const Params& p, int ray, bool active) {
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f, false};
  if (active) {
    r.ox = p.o[3 * ray + 0];
    r.oy = p.o[3 * ray + 1];
    r.oz = p.o[3 * ray + 2];
    r.dx = p.d[3 * ray + 0];
    r.dy = p.d[3 * ray + 1];
    r.dz = p.d[3 * ray + 2];
    r.seed = p.t_in[ray];
  }
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  // The plain version's min and max propagate NaN, so a NaN anywhere in a slab test fails it.
  // Boxes are finite and |1/d| <= 1e20, so (box - o) * (1/d) is NaN only through the ray (a
  // NaN in o or d, or an infinite o against 1/d = 0), the same for every box: test it once,
  // on the box coordinate 0, and let the slab tests use the plain fminf and fmaxf.
  const float px = (0.f - r.ox) * r.ix, py = (0.f - r.oy) * r.iy, pz = (0.f - r.oz) * r.iz;
  r.clean = active && px == px && py == py && pz == pz && r.seed == r.seed && p.tmin == p.tmin;
  return r;
}

// the test of ops/tri_kernel.py _slab for a clean ray (see load_ray): origin, 1/d and seed
// against a finite box
__device__ __forceinline__ bool slab_hit(float ox, float oy, float oz, float ix, float iy, float iz,
                                         float seed, const Box& b, float tmin) {
  const float t1x = (b.lx - ox) * ix;
  const float t2x = (b.hx - ox) * ix;
  const float t1y = (b.ly - oy) * iy;
  const float t2y = (b.hy - oy) * iy;
  const float t1z = (b.lz - oz) * iz;
  const float t2z = (b.hz - oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fmaxf(fminf(t1z, t2z), tmin));
  const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fminf(fmaxf(t1z, t2z), seed));
  return tn <= tf;
}

__device__ __forceinline__ bool slab_hit(const Ray& r, const Box& b, float tmin) {
  return slab_hit(r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, r.seed, b, tmin);
}

// box k of a component-major table s[6][n] in shared memory
__device__ __forceinline__ Box smem_box(const float* s, int n, int k) {
  return Box{s[k], s[n + k], s[2 * n + k], s[3 * n + k], s[4 * n + k], s[5 * n + k]};
}

// row c of cl [C,8] in global memory: min xyz, max xyz, 0, 0
__device__ __forceinline__ Box global_box(const float* __restrict__ cl, int c) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(cl + 8 * (size_t)c));
  const float2 b = __ldg(reinterpret_cast<const float2*>(cl + 8 * (size_t)c + 4));
  return Box{a.x, a.y, a.z, a.w, b.x, b.y};
}

// Möller–Trumbore (mesh.rs:50-82), the operations of ops/tri_kernel.py _mt in their order
__device__ __forceinline__ TriHit moller_trumbore(float ox, float oy, float oz, float dx, float dy,
                                                  float dz, const Tri& g) {
  const float hx = dy * g.e2z - dz * g.e2y;
  const float hy = dz * g.e2x - dx * g.e2z;
  const float hz = dx * g.e2y - dy * g.e2x;
  const float a = g.e1x * hx + g.e1y * hy + g.e1z * hz;
  const float f = 1.0f / (fabsf(a) < 1e-8f ? 1.0f : a);
  const float sx = ox - g.v0x, sy = oy - g.v0y, sz = oz - g.v0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * g.e1z - sz * g.e1y;
  const float qy = sz * g.e1x - sx * g.e1z;
  const float qz = sx * g.e1y - sy * g.e1x;
  const float v = f * (dx * qx + dy * qy + dz * qz);
  const float t = f * (g.e2x * qx + g.e2y * qy + g.e2z * qz);
  return TriHit{a, t, u, v};
}

__device__ __forceinline__ bool accepts(const TriHit& h, float tmin, float limit) {
  return fabsf(h.a) >= 1e-8f && h.u >= 0.f && h.u <= 1.f && h.v >= 0.f && h.u + h.v <= 1.f &&
         h.t > tmin && h.t < limit;
}

// slot j of a staged cluster s[10][64]
__device__ __forceinline__ Tri smem_tri(const float* s, int j) {
  return Tri{s[0 * SLOTS + j], s[1 * SLOTS + j], s[2 * SLOTS + j], s[3 * SLOTS + j],
             s[4 * SLOTS + j], s[5 * SLOTS + j], s[6 * SLOTS + j], s[7 * SLOTS + j],
             s[8 * SLOTS + j]};
}

// float bits whose signed order is the float's order (the plain version's _sort_key)
__device__ __forceinline__ int ordered_bits(float t) {
  const int b = __float_as_int(t);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// the leaf: lane k holds slots k and k + 32 (the upper ones only where the cluster has
// more than 32 triangles); the rays of `mask` are broadcast one at a time and each takes
// the warp's least (t, slot) below its best
__device__ __forceinline__ void test_cluster(const Ray& r, const float* s, int cluster,
                                             unsigned mask, bool upper_half, int lane, float tmin,
                                             Best& best) {
  const Tri g0 = smem_tri(s, lane);
  const Tri g1 = smem_tri(s, lane + 32);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float ox = __shfl_sync(FULL, r.ox, src), oy = __shfl_sync(FULL, r.oy, src);
    const float oz = __shfl_sync(FULL, r.oz, src), dx = __shfl_sync(FULL, r.dx, src);
    const float dy = __shfl_sync(FULL, r.dy, src), dz = __shfl_sync(FULL, r.dz, src);
    const float limit = __shfl_sync(FULL, best.t, src);
    TriHit h = moller_trumbore(ox, oy, oz, dx, dy, dz, g0);
    int key = accepts(h, tmin, limit) ? ordered_bits(h.t) : NO_KEY;
    bool lower = true;  // this lane's candidate is slot `lane`, not `lane + 32`
    if (upper_half) {   // warp-uniform
      const TriHit h1 = moller_trumbore(ox, oy, oz, dx, dy, dz, g1);
      const int key1 = accepts(h1, tmin, limit) ? ordered_bits(h1.t) : NO_KEY;
      if (key1 < key) {
        key = key1;
        h = h1;
        lower = false;
      }
    }
    const int least = __reduce_min_sync(FULL, key);
    if (least == NO_KEY) continue;  // warp-uniform
    const unsigned lo = __ballot_sync(FULL, key == least && lower);
    const unsigned hi = __ballot_sync(FULL, key == least && !lower);
    const int winner = __ffs(lo ? lo : hi) - 1;
    const float t = __shfl_sync(FULL, h.t, winner);
    const float u = __shfl_sync(FULL, h.u, winner);
    const float v = __shfl_sync(FULL, h.v, winner);
    if (lane == src) {
      best.t = t;
      best.u = u;
      best.v = v;
      best.slot = cluster * SLOTS + winner + (lo ? 0 : 32);
    }
  }
}

// the winner's id and interpolated attributes (pallas_tri.py phase B, mesh.rs:84-101)
__device__ __forceinline__ void write_result(const Params& p, int ray, const Best& best) {
  if (best.slot < 0) {
    p.t_out[ray] = BIG;
    p.id_out[ray] = 0;
    p.ns_out[3 * ray + 0] = 0.f;
    p.ns_out[3 * ray + 1] = 0.f;
    p.ns_out[3 * ray + 2] = 0.f;
    p.u_out[ray] = 0.f;
    p.v_out[ray] = 0.f;
    p.mat_out[ray] = 0;
    return;
  }
  const int c = best.slot / SLOTS, j = best.slot % SLOTS;
  const float* a = p.attr + (size_t)c * ATTR_ROWS * SLOTS + j;
  const float u = best.u, v = best.v;
  const float w = 1.0f - u - v;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.ns_out[3 * ray + k] = a[k * SLOTS] * w + a[(3 + k) * SLOTS] * u + a[(6 + k) * SLOTS] * v;
  }
  const float matf = a[15 * SLOTS];
  const bool has_uv = matf >= HAS_UV_FLAG;
  p.u_out[ray] = has_uv ? a[9 * SLOTS] * w + a[11 * SLOTS] * u + a[13 * SLOTS] * v : u;
  p.v_out[ray] = has_uv ? a[10 * SLOTS] * w + a[12 * SLOTS] * u + a[14 * SLOTS] * v : v;
  p.mat_out[ray] = (int)(has_uv ? matf - HAS_UV_FLAG : matf);
  p.t_out[ray] = best.t;
  p.id_out[ray] = (int)p.geo[(size_t)c * GEO_FLOATS + 9 * SLOTS + j];
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
}

// test the warp's queued clusters, streaming their blocks through the ring: the copies
// of the next RING - 1 clusters are in flight while one is tested
__device__ __forceinline__ void drain(int qn, const int* qc, const unsigned* qm, float* ring,
                                      const float* __restrict__ geo, int lane, const Ray& r,
                                      float tmin, Best& best) {
  if (qn == 0) return;
  __syncwarp();  // the queue entries written by other lanes are visible
  for (int i = 0; i < RING - 1; ++i) {
    if (i < qn) stage_async(ring + i * GEO_FLOATS, geo, qc[i], lane);
    cp_async_commit();
  }
  for (int i = 0; i < qn; ++i) {
    const int ahead = i + RING - 1;  // its slot was tested in iteration i - 1
    if (ahead < qn) stage_async(ring + (ahead % RING) * GEO_FLOATS, geo, qc[ahead], lane);
    cp_async_commit();            // one group an iteration, empty at the tail
    cp_async_wait<RING - 1>();    // all but the newest RING - 1 groups: cluster i has landed
    __syncwarp();                 // every lane's chunks of it are visible to the warp
    const float* s = ring + (i % RING) * GEO_FLOATS;
    // real triangles fill a cluster's slots from 0; pad slots carry the id BIG_IDF
    const bool upper_half = s[9 * SLOTS + 32] < BIG_IDF;
    test_cluster(r, s, qc[i], qm[i], upper_half, lane, tmin, best);
    __syncwarp();  // the slot is refilled in the next iteration
  }
}

// lanes with `hit` append (cluster, mask) in lane order -> the new queue length
__device__ __forceinline__ int enqueue(bool hit, int cluster, unsigned mask, int* qc, unsigned* qm,
                                       int qn, int lane) {
  const unsigned who = __ballot_sync(FULL, hit);
  if (hit) {
    const int pos = qn + __popc(who & ((1u << lane) - 1u));
    qc[pos] = cluster;
    qm[pos] = mask;
  }
  return qn + __popc(who);
}

// Cull the sc_size clusters of supercluster s, hit by the lanes of `m`, box-parallel -> new
// queue length. Lane k holds the boxes of clusters k (and k + 32: BOXES is the boxes a lane
// holds, sc_size <= 32 * BOXES) and gathers their lane masks. Superclusters of at most 16
// clusters are held twice, once by each half-warp, which then take two rays a step.
template <int BOXES>
__device__ __forceinline__ int cull_clusters(const Params& p, const Ray& r, int s, unsigned m,
                                             int* qc, unsigned* qm, int qn, int lane) {
  const int c0 = s * p.sc_size;
  const bool pairs = BOXES == 1 && p.sc_size <= 16;
  const int k = pairs ? lane % 16 : lane;
  Box box[BOXES];
  bool valid[BOXES];
  unsigned acc[BOXES];
#pragma unroll
  for (int b = 0; b < BOXES; ++b) {
    valid[b] = k + 32 * b < p.sc_size;
    box[b] = global_box(p.cl, c0 + (valid[b] ? k + 32 * b : 0));
    acc[b] = 0u;
  }
  while (m) {  // the rays of m broadcast in turn
    int src = __ffs(m) - 1;
    m &= m - 1;
    if (pairs && m) {
      const int second = __ffs(m) - 1;
      m &= m - 1;
      if (lane >= 16) src = second;
    }
    const float ox = __shfl_sync(FULL, r.ox, src), oy = __shfl_sync(FULL, r.oy, src);
    const float oz = __shfl_sync(FULL, r.oz, src), ix = __shfl_sync(FULL, r.ix, src);
    const float iy = __shfl_sync(FULL, r.iy, src), iz = __shfl_sync(FULL, r.iz, src);
    const float seed = __shfl_sync(FULL, r.seed, src);
#pragma unroll
    for (int b = 0; b < BOXES; ++b) {
      if (valid[b] && slab_hit(ox, oy, oz, ix, iy, iz, seed, box[b], p.tmin)) {
        acc[b] |= 1u << src;
      }
    }
  }
  if (pairs) acc[0] |= __shfl_xor_sync(FULL, acc[0], 16);
#pragma unroll
  for (int b = 0; b < BOXES; ++b) {
    const bool owner = valid[b] && (!pairs || lane < 16);
    qn = enqueue(owner && acc[b] != 0u, c0 + k + 32 * b, acc[b], qc, qm, qn, lane);
  }
  return qn;
}

template <int BOXES>
__device__ __forceinline__ void traverse(const Params& p) {
  extern __shared__ __align__(16) float smem[];
  float* s_ring = smem;                                                   // [WARPS][RING][640]
  int* s_qc = reinterpret_cast<int*>(s_ring + WARPS * RING * GEO_FLOATS);  // [WARPS][QUEUE]
  unsigned* s_qm = reinterpret_cast<unsigned*>(s_qc + WARPS * QUEUE);      // [WARPS][QUEUE]
  float* s_sc = reinterpret_cast<float*>(s_qm + WARPS * QUEUE);            // [6][n_sc]
  const int n_sc = p.n_sc;
  const int n_top = (n_sc + TOP_GROUP - 1) / TOP_GROUP;
  float* s_top = s_sc + 6 * n_sc;  // [6][n_top]

  for (int k = threadIdx.x; k < 6 * n_sc; k += THREADS) {
    s_sc[(k % 6) * n_sc + k / 6] = p.scl[(k / 6) * 8 + k % 6];
  }
  __syncthreads();
  // top box = union of its superclusters, pad rows (min x at PAD_BOX) left out
  for (int tp = threadIdx.x; tp < n_top; tp += THREADS) {
    float lo[3] = {PAD_BOX, PAD_BOX, PAD_BOX}, hi[3] = {-PAD_BOX, -PAD_BOX, -PAD_BOX};
    for (int s = tp * TOP_GROUP; s < min((tp + 1) * TOP_GROUP, n_sc); ++s) {
      if (s_sc[s] < PAD_BOX) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = fminf(lo[a], s_sc[a * n_sc + s]);
          hi[a] = fmaxf(hi[a], s_sc[(3 + a) * n_sc + s]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_top[a * n_top + tp] = lo[a];
      s_top[(3 + a) * n_top + tp] = hi[0] < lo[0] ? PAD_BOX : hi[a];  // all pad: a pad box
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ring = s_ring + warp * RING * GEO_FLOATS;
  int* qc = s_qc + warp * QUEUE;
  unsigned* qm = s_qm + warp * QUEUE;
  const int n_packets = (p.n_rays + 31) / 32;

  for (;;) {
    int packet = 0;
    if (lane == 0) packet = atomicAdd(p.counter, 1);
    packet = __shfl_sync(FULL, packet, 0);
    if (packet >= n_packets) break;
    const int ray = packet * 32 + lane;
    const bool active = ray < p.n_rays;
    const Ray r = load_ray(p, ray, active);
    Best best{r.seed, 0.f, 0.f, -1};
    int qn = 0;  // warp-uniform

    for (int t0 = 0; t0 < n_top; t0 += 32) {
      unsigned top_mask = 0;  // lane k: the lanes that hit top box t0 + k
      const int tops_here = min(32, n_top - t0);
#pragma unroll 4
      for (int k = 0; k < tops_here; ++k) {
        const bool hit = r.clean && slab_hit(r, smem_box(s_top, n_top, t0 + k), p.tmin);
        const unsigned b = __ballot_sync(FULL, hit);
        if (lane == k) top_mask = b;
      }
      unsigned tops = __ballot_sync(FULL, top_mask != 0u);
      while (tops) {
        const int tp = t0 + __ffs(tops) - 1;
        tops &= tops - 1;
        const bool top_hit = (__shfl_sync(FULL, top_mask, tp - t0) >> lane) & 1u;
        const int s0 = tp * TOP_GROUP;
        unsigned sc_mask = 0;  // lane k: the lanes that hit supercluster s0 + k
#pragma unroll
        for (int k = 0; k < TOP_GROUP; ++k) {
          const int s = min(s0 + k, n_sc - 1);
          const bool hit =
              top_hit && s0 + k < n_sc && slab_hit(r, smem_box(s_sc, n_sc, s), p.tmin);
          const unsigned b = __ballot_sync(FULL, hit);
          if (lane == k) sc_mask = b;
        }
        unsigned todo = __ballot_sync(FULL, sc_mask != 0u);
        while (todo) {
          const int k = __ffs(todo) - 1;
          todo &= todo - 1;
          const unsigned m = __shfl_sync(FULL, sc_mask, k);
          if (qn + p.sc_size > QUEUE) {
            drain(qn, qc, qm, ring, p.geo, lane, r, p.tmin, best);
            qn = 0;
          }
          qn = cull_clusters<BOXES>(p, r, s0 + k, m, qc, qm, qn, lane);
        }
      }
    }
    drain(qn, qc, qm, ring, p.geo, lane, r, p.tmin, best);
    if (active) write_result(p, ray, best);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) closest_tri_flat_kernel(const Params p) {
  traverse<FLAT_SC_SIZE / 32>(p);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
closest_tri_two_level_kernel(const Params p) {
  traverse<1>(p);
}

// Zero the packet counter and launch KERNEL on as many blocks as stay resident.
template <void (*KERNEL)(const Params)>
int launch(const Params& p, cudaStream_t stream) {
  if (p.n_rays <= 0) return static_cast<int>(cudaSuccess);
  const int n_top = (p.n_sc + TOP_GROUP - 1) / TOP_GROUP;
  const size_t smem = sizeof(float) * (WARPS * RING * GEO_FLOATS + 6 * (p.n_sc + n_top)) +
                      (sizeof(int) + sizeof(unsigned)) * WARPS * QUEUE;
  cudaError_t err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  // Done once for a device: the kernel's shared-memory limit raised to all a block may
  // have there (the same value whoever sets it, so host threads cannot undo each other).
  // Done once for a shared-memory size: the count of resident blocks. A host thread has
  // its own record of what it has done.
  thread_local int known_device = -1, sms = 0, resident = 0;
  thread_local size_t known_smem = 0;
  if (device != known_device) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    known_device = device;
    known_smem = 0;
  }
  if (smem != known_smem) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);  // tables too large
    known_smem = smem;
    resident = sms * per_sm;
  }
  const int n_packets = (p.n_rays + 31) / 32;
  const int blocks = std::min(resident, (n_packets + WARPS - 1) / WARPS);
  if ((err = cudaMemsetAsync(p.counter, 0, sizeof(int), stream)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  KERNEL<<<blocks, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpupt_closest_tri_flat(const float* o, const float* d, const float* t_in,
                                      float tmin, const float* scl, const float* cl, int n_cl,
                                      const float* geo, const float* attr, float* t_out,
                                      int* id_out, float* ns_out, float* u_out, float* v_out,
                                      int* mat_out, int n_rays, int* counter, void* stream) {
  if (n_cl < FLAT_SC_SIZE || n_cl > FLAT_MAX_CLUSTERS || n_cl % FLAT_SC_SIZE != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{o,     d,      t_in,   tmin,  scl,   n_cl / FLAT_SC_SIZE, FLAT_SC_SIZE, cl,     geo,
                 attr,  t_out,  id_out, ns_out, u_out, v_out,               mat_out,      n_rays, counter};
  return launch<closest_tri_flat_kernel>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int tpupt_closest_tri_two_level(const float* o, const float* d, const float* t_in,
                                           float tmin, const float* scl, int n_sc, int sc_size,
                                           const float* cl, int n_cl, const float* geo,
                                           const float* attr, float* t_out, int* id_out,
                                           float* ns_out, float* u_out, float* v_out,
                                           int* mat_out, int n_rays, int* counter, void* stream) {
  if (sc_size < 1 || sc_size > MAX_SC_SIZE || n_sc < 1 || n_sc * sc_size != n_cl) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{o,     d,      t_in,   tmin,  scl,   n_sc,  sc_size, cl,     geo,
                 attr,  t_out,  id_out, ns_out, u_out, v_out, mat_out, n_rays, counter};
  return launch<closest_tri_two_level_kernel>(p, static_cast<cudaStream_t>(stream));
}
