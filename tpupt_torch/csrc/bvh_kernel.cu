// Closest triangle of every ray by a walk of the triangle BVH, with the winner's
// interpolated shading attributes.
//
// Replaces tpupt/ops/bvh.py::bvh_closest_tri, which is not a Pallas kernel but a
// lax.while_loop that XLA compiles whole (the reference's stackless walk of its binary
// tree). The contract is that walk's, as its plain version runs it
// (ops/bvh.py::bvh_closest_tri_plain), with the outputs and the seed of the cluster
// kernels (csrc/tri_kernel.cu):
//   inputs  o [B,3], d [B,3], t_in [B] (f32, contiguous; t_in is the ray's tmax), tmin;
//           the tables packed by ops/bvh_kernel.py: wide [W,32] (the 4-wide collapse
//           of the binary tree, one 128-byte line a node: the children's boxes as
//           SoA, min x, max x, min y, max y, min z, max z, four floats each, then
//           four child references as int bits: a wide node's index, or ~(start * 8 +
//           count) for a leaf; an empty slot has NaN bounds), rows [T,12] (v0, e1, e2
//           in three float4) and attr [T,16] (n0, n1, n2, uv0, uv1, uv2, mat +
//           HAS_UV_FLAG), both in the tree's triangle order.
//   outputs t [B] f32, idx [B] i32, ns [B,3] f32 (unnormalised interpolated normal),
//           u, v [B] f32 (UVs, or barycentrics without UVs), mat [B] i32. A ray with
//           no triangle in (tmin, t_in) gets t = BIG, idx 0 and zeros; so does a
//           NaN ray, and a dead lane (t_in = 0).
//   rules   slab test of a box: 1/d after the sign-preserving flush |d| < 1e-20 ->
//           +-1e-20; tn = max(slabs, tmin), min and max propagating NaN like
//           torch.minimum. The binary walk takes a node when tn <= min(slabs, best,
//           t_in). A leaf tests its triangles in order by Möller–Trumbore (f = 1/(|a|
//           < 1e-8 ? 1 : a); a hit needs |a| >= 1e-8, u >= 0, u <= 1, v >= 0, u + v <=
//           1, t > tmin, t < t_in and t strictly below the best so far), so a tie goes
//           to the first triangle the walk meets.
//
// Why a wide walk gives the binary walk's bits. Every node's box is the min/max union
// of the triangle boxes below it, and (b - o) * inv is monotone in b, so a child's
// slab interval lies inside its parent's and a parent passes wherever a child passes
// (with a best no smaller). A subtree the binary walk prunes therefore holds only
// leaves that would fail their own test. The answer depends on the walk only through
// which leaves are tested, in which order, against which best; so any walk that
// reaches every leaf whose exact box passes, in the binary tree's DFS order, and tests
// that box against the running best before its triangles, gives the same t and idx.
// Here: fetch a wide node, test its children's exact boxes against the slabs, tmin
// and t_in (none of which depend on best), push those that pass with their tn, last
// child first, onto a per-thread stack; pop, and go on only if tn <= best (the same
// floats compared, so the same decision as the binary walk's single compare).
//
// Bound. A binary node visit is 24 float operations and a triangle test 46; rays read
// 28 B and write 32 B; the tables are a few MB and stay in the 50 MB L2. A camera ray of
// bigmesh visits some 64 binary nodes and tests some 10 triangles, so against the card's
// peaks the kernel would take 0.01 ms. What bounds it is the traffic between L2 and the
// SMs and the latency of its chain of dependent reads. Each lane stands at its own node,
// so a fetch is a 128-byte line a lane: bigmesh's camera rays make 16 fetches, 10
// triangle tests and 20 steps a ray, some 0.9 GB through L2 a launch (2.4 TB/s at the
// measured 0.38 ms). The scene-6 stand-in is bound by its longest walks: its 16k live
// bounce rays alone take 0.048 ms for a longest walk of 63 steps, 0.76 us a step, one
// round trip to L2 for the node and one for the leaf (PERF.md, PR 8).
//
// Design. (a) A 4-wide tree: a fetch is one 128-byte line of 7 float4 loads that tests
// four children at once, which cuts the chain of dependent fetches by three quarters
// (bigmesh camera rays: 64 binary visits, 16 fetches). (b) Triangle rows in one
// leaf-ordered table, three float4 a triangle; a leaf's up to four rows are all requested
// before its first test, so a leaf costs one trip to L2, not one a triangle. The
// winner's attribute row is read once, at the end. (c) Persistent warps: as many blocks
// as stay resident take packets of 32 consecutive rays from an atomic counter, one warp
// a packet, so a warp whose rays end early takes the next packet and no wave is left
// part full. One thread walks one ray from start to end; its stack lives in local
// memory (L1). Measured and not taken (PERF.md): a refill per lane, the first child held
// in registers, the stack in shared memory (whole or its first entries), the top
// levels in shared memory, 6 blocks an SM, an 8-wide tree. Built with --fmad=false so
// each operation rounds on its own, like the plain version, which makes the two
// bit-equal.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr float BIG = 3.0e38f;
constexpr float HAS_UV_FLAG = 1048576.0f;  // 2^20, added to mat where the triangle has UVs
constexpr int WIDTH = 4;  // children a wide node (ops/bvh_kernel.py WIDTH); a node is 2 * WIDTH float4
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STACK = 64;  // ops/bvh_kernel.py STACK: the wrapper refuses deeper trees
constexpr int LEAF = 4;    // triangles a leaf holds at most (ops/bvh.py LEAF_SIZE)
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* o;
  const float* d;
  const float* t_in;
  float tmin;
  const float4* wide;
  const float4* rows;
  const float4* attr;
  float* t_out;
  int* idx_out;
  float* ns_out;
  float* u_out;
  float* v_out;
  int* mat_out;
  int n_rays;
  int* counter;  // next packet, zero at launch
  int* counts;   // [B,4] wide-node fetches, triangle tests, deepest stack, steps (counting build)
};

// min and max that return NaN when either operand is NaN (torch.minimum, torch.maximum)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.f ? -1e-20f : 1e-20f) : d);
}

__device__ __forceinline__ float lane_of(const float4& a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}

__device__ __forceinline__ int lane_of(const int4& a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}

// One ray's walk: its ray, its best hit so far, its stack and the node to fetch next.
struct Walk {
  int ray;
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmax;
  float best, best_u, best_v;
  int best_i, sp, node;
  int fetches, tests, deepest, steps;
};

__device__ __forceinline__ void start(Walk& w, const Params& p, const int ray) {
  w.ray = ray;
  w.ox = p.o[3 * ray + 0];
  w.oy = p.o[3 * ray + 1];
  w.oz = p.o[3 * ray + 2];
  w.dx = p.d[3 * ray + 0];
  w.dy = p.d[3 * ray + 1];
  w.dz = p.d[3 * ray + 2];
  w.ix = safe_inv(w.dx);
  w.iy = safe_inv(w.dy);
  w.iz = safe_inv(w.dz);
  w.tmax = p.t_in[ray];
  w.best = BIG;
  w.best_u = w.best_v = 0.f;
  w.best_i = 0;
  w.sp = 0;
  w.node = 0;  // the root
  w.fetches = w.tests = w.deepest = w.steps = 0;
}

// One step of the walk: fetch the due wide node and push its children that pass, then
// pop one entry and take it (a node to fetch next, or a leaf's triangles) if it still
// passes against best. Returns false once the stack is empty.
template <bool COUNT>
__device__ __forceinline__ bool step(Walk& w, int2* stack, const Params& p) {
  if (COUNT) ++w.steps;
  if (w.node >= 0) {
    const float4* n = p.wide + 2 * WIDTH * (size_t)w.node;
    float4 box[6][WIDTH / 4];  // min x, max x, min y, max y, min z, max z; child k in lane k
    int4 ref[WIDTH / 4];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int c = 0; c < WIDTH / 4; ++c) box[a][c] = __ldg(n + a * (WIDTH / 4) + c);
    }
#pragma unroll
    for (int c = 0; c < WIDTH / 4; ++c) ref[c] = __ldg(reinterpret_cast<const int4*>(n + 6 * (WIDTH / 4) + c));
#pragma unroll
    for (int k = WIDTH - 1; k >= 0; --k) {  // last child first, so the first pops first
      const float t1x = (lane_of(box[0][k / 4], k % 4) - w.ox) * w.ix;
      const float t2x = (lane_of(box[1][k / 4], k % 4) - w.ox) * w.ix;
      const float t1y = (lane_of(box[2][k / 4], k % 4) - w.oy) * w.iy;
      const float t2y = (lane_of(box[3][k / 4], k % 4) - w.oy) * w.iy;
      const float t1z = (lane_of(box[4][k / 4], k % 4) - w.oz) * w.iz;
      const float t2z = (lane_of(box[5][k / 4], k % 4) - w.oz) * w.iz;
      const float tn = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                               max_nan(min_nan(t1z, t2z), p.tmin));
      const float tf = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)), max_nan(t1z, t2z));
      if (tn <= tf && tn <= w.tmax) stack[w.sp++] = make_int2(lane_of(ref[k / 4], k % 4), __float_as_int(tn));
    }
    w.node = -1;
    if (COUNT) {
      ++w.fetches;
      w.deepest = max(w.deepest, w.sp);
    }
  }
  if (w.sp == 0) return false;
  const int2 e = stack[--w.sp];
  if (!(__int_as_float(e.y) <= w.best)) return true;
  if (e.x >= 0) {
    w.node = e.x;
    return true;
  }
  const int leaf = ~e.x;
  const int first = leaf >> 3, count = leaf & 7;
  // the leaf's rows, all requested before the first test: one trip to L2, not one a triangle
  float4 rows[LEAF][3];
#pragma unroll
  for (int j = 0; j < LEAF; ++j) {
    if (j < count) {
#pragma unroll
      for (int q = 0; q < 3; ++q) rows[j][q] = __ldg(p.rows + 3 * (size_t)(first + j) + q);
    }
  }
#pragma unroll
  for (int j = 0; j < LEAF; ++j) {
    if (j >= count) break;
    const int k = first + j;
    const float v0x = rows[j][0].x, v0y = rows[j][0].y, v0z = rows[j][0].z;
    const float e1x = rows[j][1].x, e1y = rows[j][1].y, e1z = rows[j][1].z;
    const float e2x = rows[j][2].x, e2y = rows[j][2].y, e2z = rows[j][2].z;
    const float dx = w.dx, dy = w.dy, dz = w.dz;
    // Möller–Trumbore (mesh.rs:50-82), the operations of ops/tri_kernel.py _mt in their order
    const float hx = dy * e2z - dz * e2y;
    const float hy = dz * e2x - dx * e2z;
    const float hz = dx * e2y - dy * e2x;
    const float det = e1x * hx + e1y * hy + e1z * hz;
    const float f = 1.0f / (fabsf(det) < 1e-8f ? 1.0f : det);
    const float sx = w.ox - v0x, sy = w.oy - v0y, sz = w.oz - v0z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = f * (dx * qx + dy * qy + dz * qz);
    const float t = f * (e2x * qx + e2y * qy + e2z * qz);
    if (fabsf(det) >= 1e-8f && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t > p.tmin &&
        t < w.best && t < w.tmax) {
      w.best = t;
      w.best_i = k;
      w.best_u = u;
      w.best_v = v;
    }
  }
  if (COUNT) w.tests += count;
  return true;
}

// Write a finished walk's outputs: t, idx and the winner's attributes (ops/bvh.py
// winner_attributes), read from its attribute row.
template <bool COUNT>
__device__ __forceinline__ void finish(const Walk& w, const Params& p) {
  float nsx = 0.f, nsy = 0.f, nsz = 0.f, uu = 0.f, vv = 0.f;
  int mat = 0;
  if (w.best < BIG) {
    const float4* r = p.attr + 4 * (size_t)w.best_i;
    const float4 a0 = __ldg(r), a1 = __ldg(r + 1), a2 = __ldg(r + 2), a3 = __ldg(r + 3);
    // n0 = a0.xyz, n1 = (a0.w, a1.xy), n2 = (a1.zw, a2.x), uv0 = a2.yz, uv1 = (a2.w, a3.x),
    // uv2 = a3.yz, mat + flag = a3.w
    const float bu = w.best_u, bv = w.best_v;
    const float c = 1.0f - bu - bv;
    nsx = a0.x * c + a0.w * bu + a1.z * bv;
    nsy = a0.y * c + a1.x * bu + a1.w * bv;
    nsz = a0.z * c + a1.y * bu + a2.x * bv;
    const bool has_uv = a3.w >= HAS_UV_FLAG;
    uu = has_uv ? a2.y * c + a2.w * bu + a3.y * bv : bu;
    vv = has_uv ? a2.z * c + a3.x * bu + a3.z * bv : bv;
    mat = static_cast<int>(has_uv ? a3.w - HAS_UV_FLAG : a3.w);
  }
  const int ray = w.ray;
  p.t_out[ray] = w.best;
  p.idx_out[ray] = w.best_i;
  p.ns_out[3 * ray + 0] = nsx;
  p.ns_out[3 * ray + 1] = nsy;
  p.ns_out[3 * ray + 2] = nsz;
  p.u_out[ray] = uu;
  p.v_out[ray] = vv;
  p.mat_out[ray] = mat;
  if (COUNT) {
    p.counts[4 * ray + 0] = w.fetches;
    p.counts[4 * ray + 1] = w.tests;
    p.counts[4 * ray + 2] = w.deepest;
    p.counts[4 * ray + 3] = w.steps;
  }
}

// Persistent warps: each takes a packet of 32 consecutive rays from the atomic counter,
// one ray a lane, walks them to the end and takes the next packet.
template <bool COUNT>
__global__ void __launch_bounds__(THREADS) closest_tri_bvh_kernel(const Params p) {
  const int lane = threadIdx.x % 32;
  const int n_packets = (p.n_rays + 31) / 32;
  int2 stack[STACK];
  Walk w;
  for (;;) {
    int packet = 0;
    if (lane == 0) packet = atomicAdd(p.counter, 1);
    packet = __shfl_sync(FULL, packet, 0);
    if (packet >= n_packets) return;
    const int ray = packet * 32 + lane;
    if (ray < p.n_rays) {
      start(w, p, ray);
      while (step<COUNT>(w, stack, p)) {
      }
      finish<COUNT>(w, p);
    }
  }
}

// Zero the packet counter and launch the kernel on as many blocks as stay resident.
template <bool COUNT>
int launch(const Params& p, cudaStream_t stream) {
  if (p.n_rays <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  // Done once for a device: the count of resident blocks. A host thread has its own
  // record of what it has done.
  thread_local int known_device = -1, resident = 0;
  if (device != known_device) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, closest_tri_bvh_kernel<COUNT>, THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    known_device = device;
    resident = sms * per_sm;
  }
  const int n_packets = (p.n_rays + 31) / 32;
  const int blocks = std::min(resident, (n_packets + WARPS - 1) / WARPS);
  if ((err = cudaMemsetAsync(p.counter, 0, sizeof(int), stream)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  closest_tri_bvh_kernel<COUNT><<<blocks, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpupt_closest_tri_bvh(const float* o, const float* d, const float* t_in, float tmin,
                                     const float* wide, int n_wide, const float* rows,
                                     const float* attr, float* t_out, int* idx_out, float* ns_out,
                                     float* u_out, float* v_out, int* mat_out, int n_rays,
                                     int* counter, void* stream) {
  if (n_wide < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{o, d, t_in, tmin, reinterpret_cast<const float4*>(wide),
                 reinterpret_cast<const float4*>(rows), reinterpret_cast<const float4*>(attr),
                 t_out, idx_out, ns_out, u_out, v_out, mat_out, n_rays, counter, nullptr};
  return launch<false>(p, static_cast<cudaStream_t>(stream));
}

// The same walk, writing each ray's wide-node fetches, triangle tests, deepest stack and
// steps (loop turns) to counts [B,4] (chip_smoke.py's explanation of the time; not on
// the render's path).
extern "C" int tpupt_closest_tri_bvh_counts(const float* o, const float* d, const float* t_in,
                                            float tmin, const float* wide, int n_wide,
                                            const float* rows, const float* attr, float* t_out,
                                            int* idx_out, float* ns_out, float* u_out,
                                            float* v_out, int* mat_out, int n_rays, int* counter,
                                            int* counts, void* stream) {
  if (n_wide < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{o, d, t_in, tmin, reinterpret_cast<const float4*>(wide),
                 reinterpret_cast<const float4*>(rows), reinterpret_cast<const float4*>(attr),
                 t_out, idx_out, ns_out, u_out, v_out, mat_out, n_rays, counter, counts};
  return launch<true>(p, static_cast<cudaStream_t>(stream));
}
