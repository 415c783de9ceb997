// Closest hit of every ray against every sphere and every quad of a scene.
//
// Replaces the TPU kernel tpupt/ops/pallas_hit.py::_hit_kernel (wrapper
// pallas_closest_sphere_quad). The contract is that kernel's, not its tiling:
//   inputs  o [B,3], d [B,3], time [B] (f32, contiguous); tmin; the tables packed
//           primitive-major by ops/hit_kernel.py::pack_tables from the reference's
//           _tables layout (sph [7,S], quad [16,Q]), cut after the last real row:
//             sphere, 8 floats:  c1 xyz, r | c2-c1 xyz, r*r
//             quad, 16 floats:   n xyz, d | q xyz, u.x | u.yz, v.xy | v.z, w xyz
//           c2-c1 and r*r are the float32 operations the sweep would do, done once.
//           boxes [ceil(n_sph / CULL_TILE), 12] (sphere_tile_boxes): for each tile of
//           CULL_TILE consecutive spheres lo xyz, 0 | hi xyz, 0 | centre xyz, half
//           diagonal of a box that holds the tile's spheres at every time in [0,1].
//   outputs t [B] f32 (BIG = 3e38 on a miss), kind [B] and idx [B] int32
//           (kind 0 sphere, 1 quad; kind 0 / idx 0 on a miss). idx counts rows of
//           the reference's tables: packing moves no row.
//   rules   a sphere with r < 0 never hits (pad rows); its root is s-q outside
//           and s+q inside; a quad is parallel when |n.d| < 1e-8 (zero-normal
//           pad rows always are) and needs alpha, beta in [0,1]. A hit needs
//           t > tmin and t strictly below the best so far, so ties go to the
//           lower index and spheres beat quads. The t tests are written as
//           positive comparisons, so a NaN t is a miss.
//   cull    in a sphere table of more than one tile, a ray tests a tile's spheres
//           unless it may cull (time in [0,1], |d|^2 within CULL_DIR of 1, |o|_1 <
//           CULL_ORIGIN) and its half-line misses the tile's box widened by
//           CULL_MARGIN times the distance (1-norm) of its origin to the box; see
//           ops/hit_kernel.py for why that drops no hit. The plain version skips the
//           same (ray, tile) pairs, so the two stay bit-equal whatever the boxes are.
//   counts  optional (null: nothing counted), and only in the culled variant: four int64
//           sums that a launch adds to, in the order of ops/hit_kernel.py's K1_COUNTS:
//           lanes (rays below n_rays), lanes x the table's tiles, the tiles each lane
//           enters (every tile for a lane that may not cull) and, over warps, the tiles
//           the warp swept x its lanes: what the warps paid for the rays' own entries.
//
// Bound. Per ray, a sphere costs 28 float operations, a quad 49 and a tile's box 25
// (adds, multiplies, one divide or sqrt; compares, minima and maxima not counted),
// against 40 B of ray input and output: Cornell's 1 sphere + 18 quads are 910 flop per 40 B, the
// balls scene's 486 spheres 13.6 kflop, far above the H100's ~20 flop/B float32
// balance point, so the kernel is bound by arithmetic, and within that by
// instruction issue: it is built with --fmad=false, so that each operation rounds
// on its own like the plain PyTorch version in ops/hit_kernel.py (which makes the
// two bit-equal), and a multiply-add is then two instructions: the card's float32
// peak counts fused ones, so half of it is this kernel's ceiling.
//
// Design.
// - The wrapper passes only the rows up to the last real one, so no pad slot at the
//   tables' tails is visited; a pad row between real ones still misses by the rules.
// - A block stages the tables into shared memory with 16-byte copies, then every
//   thread of a warp reads the same slot: a sphere is 2 and a quad 4 broadcast
//   16-byte loads. Tables of at most SPH_TILE spheres and QUAD_TILE quads (all the
//   scenes of the repository) take one staging and one barrier; larger ones go
//   through the same buffers a tile at a time.
// - One ray a thread. Two or four rays a thread share the table reads and the loop, and
//   measured within 2% on quads; with the cull they lose 10-28%, since a warp then
//   sweeps every tile that any of its 64 or 128 rays enters.
// - A block takes THREADS consecutive rays and ends; the card's block scheduler hands a
//   free SM the next block, which balances rays of unequal cost (the cull) by itself. A
//   grid sized to the resident blocks, each looping over its share of the rays, measured
//   10-20% slower: its warps load, sweep and end in step.
// - The best hit is updated by selects, not branches.
// - Large sphere tables (the balls scene: 486 spheres) are culled tile by tile: a warp
//   sweeps a tile only if one of its rays enters the tile's box, so rays that run
//   together skip most of the table. Tiles keep the table's order, so indices and
//   ties do not move. The kernel is compiled with and without the cull and the launch
//   picks by the table's size: the code's mere presence cost one-tile tables 3-6%.
// - The culled variant counts its cull: in a tile its warp sweeps, each lane adds to its
//   entered and swept tiles in registers (a skipped tile adds nothing, so the skip path,
//   most of the tiles, costs nothing more: counted on every tile it cost 3-5% on balls
//   rays). Where a counts buffer is given (the render graphs), a warp sums them at its end
//   (a ballot, __popc, __reduce_add_sync), a block in shared memory, and two threads a
//   block add the block's two sums to the buffer with 64-bit atomics; the lanes and tile
//   slots follow from n_rays, added once by block 0 (on balls camera rays four atomics a
//   block cost 2.0%, two 1.6%). With no buffer the launch skips all that. The hits do not
//   depend on it.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;             // one ray a thread
constexpr int SPH_F4 = 2, QUAD_F4 = 4;   // 16-byte words a packed sphere, a packed quad
constexpr int SPH_TILE = 512, QUAD_TILE = 256;  // slots staged at once: 16 KB each
constexpr int CULL_TILE = 8;             // spheres under one box (ops/hit_kernel.py: CULL_TILE)
constexpr int BOX_F4 = 3;                // 16-byte words of a box
constexpr float CULL_MARGIN = 4.0e-3f, CULL_DIR = 1.0e-5f, CULL_ORIGIN = 1.0e30f;
constexpr float BIG = 3.0e38f;
static_assert(SPH_TILE % CULL_TILE == 0, "a staged tile holds whole cull tiles");

__device__ __forceinline__ void stage(float4* dst, const float4* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += THREADS) dst[k] = src[k];
}

template <bool CULL>  // whether the sphere table has more than one tile: else it is swept whole
__global__ void __launch_bounds__(THREADS)
closest_sphere_quad_kernel(const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ time, const float4* __restrict__ sph,
                           const float4* __restrict__ boxes, int n_sph,
                           const float4* __restrict__ quad, int n_quad, float tmin,
                           float* __restrict__ t_out, int* __restrict__ kind_out,
                           int* __restrict__ idx_out, int n_rays,
                           unsigned long long* __restrict__ counts) {
  __shared__ float4 s_sph[SPH_TILE * SPH_F4];
  __shared__ float4 s_quad[QUAD_TILE * QUAD_F4];
  __shared__ float4 s_box[SPH_TILE / CULL_TILE * BOX_F4];

  // the first tile of each table; a table's further tiles are staged where it is swept
  stage(s_sph, sph, min(n_sph, SPH_TILE) * SPH_F4);
  stage(s_box, boxes, (min(n_sph, SPH_TILE) + CULL_TILE - 1) / CULL_TILE * BOX_F4);
  stage(s_quad, quad, min(n_quad, QUAD_TILE) * QUAD_F4);
  __syncthreads();

  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool live = ray < n_rays;
  const bool warp_on = ray - (threadIdx.x & 31) < n_rays;  // else the warp only joins barriers
  const size_t r3 = 3 * static_cast<size_t>(ray);
  const float ox = live ? o[r3 + 0] : 0.f;
  const float oy = live ? o[r3 + 1] : 0.f;
  const float oz = live ? o[r3 + 2] : 0.f;
  const float dx = live ? d[r3 + 0] : 0.f;
  const float dy = live ? d[r3 + 1] : 0.f;
  const float dz = live ? d[r3 + 2] : 0.f;
  const float tm = live ? time[ray] : 0.f;
  float ix = 0.f, iy = 0.f, iz = 0.f;  // 1/d, |d| below 1e-20 flushed to +-1e-20
  bool may_cull = false;
  if (CULL) {
    ix = 1.0f / (fabsf(dx) < 1e-20f ? (dx < 0.f ? -1e-20f : 1e-20f) : dx);
    iy = 1.0f / (fabsf(dy) < 1e-20f ? (dy < 0.f ? -1e-20f : 1e-20f) : dy);
    iz = 1.0f / (fabsf(dz) < 1e-20f ? (dz < 0.f ? -1e-20f : 1e-20f) : dz);
    may_cull = (tm >= 0.f) && (tm <= 1.f) &&
               (fabsf(dx * dx + dy * dy + dz * dz - 1.0f) <= CULL_DIR) &&
               (fabsf(ox) + fabsf(oy) + fabsf(oz) < CULL_ORIGIN);
  }
  float best_t = BIG;
  int best_kind = 0;
  int best_idx = 0;
  unsigned entered = 0, swept = 0;  // CULL: tiles this lane entered, tiles its warp swept

  // ---- spheres (sphere.rs:64-100) ----
  for (int base = 0; base < n_sph; base += SPH_TILE) {
    const int n = min(SPH_TILE, n_sph - base);
    if (base > 0) {
      __syncthreads();  // the previous tile is no longer read
      stage(s_sph, sph + base * SPH_F4, n * SPH_F4);
      stage(s_box, boxes + base / CULL_TILE * BOX_F4, (n + CULL_TILE - 1) / CULL_TILE * BOX_F4);
      __syncthreads();
    }
    if (!warp_on) continue;
    for (int k = 0; k * CULL_TILE < n; ++k) {
      bool enters = live;
      if (CULL) {
        const float4 lo = s_box[BOX_F4 * k];      // lo xyz
        const float4 hi = s_box[BOX_F4 * k + 1];  // hi xyz
        const float4 ce = s_box[BOX_F4 * k + 2];  // centre xyz, half diagonal
        const float m =
            CULL_MARGIN * (fabsf(ox - ce.x) + fabsf(oy - ce.y) + fabsf(oz - ce.z) + ce.w);
        const float t1x = (lo.x - m - ox) * ix, t2x = (hi.x + m - ox) * ix;
        const float t1y = (lo.y - m - oy) * iy, t2y = (hi.y + m - oy) * iy;
        const float t1z = (lo.z - m - oz) * iz, t2z = (hi.z + m - oz) * iz;
        const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        enters = live && (!may_cull || ((tn <= tf) && (tf >= 0.f)));
      }
      if (!__any_sync(0xffffffffu, enters)) continue;  // no ray of the warp enters the tile
      if constexpr (CULL) {  // a tile that the warp skips adds to neither: none of its rays enters
        entered += enters;
        ++swept;
      }
      const int j_end = min(n, (k + 1) * CULL_TILE);
      for (int j = k * CULL_TILE; j < j_end; ++j) {
        const float4 c = s_sph[SPH_F4 * j];      // c1 xyz, r
        const float4 e = s_sph[SPH_F4 * j + 1];  // c2-c1 xyz, r*r
        const bool pad = c.w < 0.f;
        const float cx = c.x + e.x * tm;
        const float cy = c.y + e.y * tm;
        const float cz = c.z + e.z * tm;
        const float lx = cx - ox, ly = cy - oy, lz = cz - oz;
        const float s = lx * dx + ly * dy + lz * dz;
        const float l2 = lx * lx + ly * ly + lz * lz;
        const float d2 = l2 - s * s;
        const float h = e.w - d2;
        const float q = sqrtf(h < 1e-20f ? 1e-20f : h);  // floor that keeps NaN, like clamp
        const bool outside = l2 > e.w;
        const float t = outside ? s - q : s + q;
        const bool miss = ((s < 0.f) && outside) || (d2 > e.w) || pad;
        const bool hit = enters && !miss && (t > tmin) && (t < best_t);
        best_t = hit ? t : best_t;
        best_idx = hit ? base + j : best_idx;
      }
    }
  }

  // ---- quads (quad.rs:40-70) ----
  for (int base = 0; base < n_quad; base += QUAD_TILE) {
    const int n = min(QUAD_TILE, n_quad - base);
    if (base > 0) {
      __syncthreads();
      stage(s_quad, quad + base * QUAD_F4, n * QUAD_F4);
      __syncthreads();
    }
    if (!warp_on) continue;
    for (int j = 0; j < n; ++j) {
      const float4 a = s_quad[QUAD_F4 * j];      // n xyz, d
      const float4 b = s_quad[QUAD_F4 * j + 1];  // q xyz, u.x
      const float4 c = s_quad[QUAD_F4 * j + 2];  // u.yz, v.xy
      const float4 e = s_quad[QUAD_F4 * j + 3];  // v.z, w xyz
      const float ux = b.w, uy = c.x, uz = c.y, vx = c.z, vy = c.w, vz = e.x;
      const float wx = e.y, wy = e.z, wz = e.w;
      const float nd = a.x * dx + a.y * dy + a.z * dz;
      const float no = a.x * ox + a.y * oy + a.z * oz;
      const bool parallel = fabsf(nd) < 1e-8f;
      const float t = (a.w - no) / (parallel ? 1.0f : nd);
      const float px = ox + t * dx - b.x;
      const float py = oy + t * dy - b.y;
      const float pz = oz + t * dz - b.z;
      const float alpha =
          wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz) + wz * (px * vy - py * vx);
      const float beta =
          wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz) + wz * (ux * py - uy * px);
      const bool miss = parallel || (alpha < 0.f) || (alpha > 1.f) || (beta < 0.f) || (beta > 1.f);
      const bool hit = !miss && (t > tmin) && (t < best_t);
      best_t = hit ? t : best_t;
      best_kind = hit ? 1 : best_kind;
      best_idx = hit ? base + j : best_idx;
    }
  }

  if (live) {
    t_out[ray] = best_t;
    kind_out[ray] = best_kind;
    idx_out[ray] = best_idx;
  }

  if constexpr (CULL) {
    // every thread of the block gets here (no thread has returned), or none: counts is the launch's
    if (counts != nullptr) {
      __shared__ unsigned long long s_counts[2];  // the block's tiles entered, tiles swept
      if (threadIdx.x < 2) s_counts[threadIdx.x] = 0;
      __syncthreads();
      const unsigned lanes = __popc(__ballot_sync(0xffffffffu, live));
      const unsigned warp_entered = __reduce_add_sync(0xffffffffu, entered);
      if ((threadIdx.x & 31) == 0 && lanes > 0) {
        atomicAdd(&s_counts[0], static_cast<unsigned long long>(warp_entered));
        atomicAdd(&s_counts[1], static_cast<unsigned long long>(swept) * lanes);
      }
      __syncthreads();
      if (threadIdx.x < 2 && s_counts[threadIdx.x] != 0) atomicAdd(&counts[2 + threadIdx.x], s_counts[threadIdx.x]);
      if (blockIdx.x == 0 && threadIdx.x == 0) {  // the launch's lanes and tile slots, once
        atomicAdd(&counts[0], static_cast<unsigned long long>(n_rays));
        atomicAdd(&counts[1], static_cast<unsigned long long>(n_rays) * ((n_sph + CULL_TILE - 1) / CULL_TILE));
      }
    }
  }
}

}  // namespace

// sph and quad are the packed tables (n_sph x 8 and n_quad x 16 floats), boxes the boxes
// of sph's tiles (ceil(n_sph / CULL_TILE) x 12 floats); all 16-byte aligned. counts: null,
// or 4 int64 that a culled launch adds its counts to (a table of one tile counts nothing).
extern "C" int tpupt_closest_sphere_quad(const float* o, const float* d, const float* time,
                                         const float* sph, const float* boxes, int n_sph,
                                         const float* quad, int n_quad, float tmin,
                                         float* t_out, int* kind_out,
                                         int* idx_out, int n_rays, long long* counts, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  const auto kernel = n_sph > CULL_TILE ? closest_sphere_quad_kernel<true> : closest_sphere_quad_kernel<false>;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, time, reinterpret_cast<const float4*>(sph), reinterpret_cast<const float4*>(boxes),
      n_sph, reinterpret_cast<const float4*>(quad), n_quad, tmin, t_out, kind_out, idx_out, n_rays,
      reinterpret_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// info[0..3] = registers a thread, static shared memory a block (bytes), resident blocks an
// SM of the kernel with the tile cull (cull != 0) or without it; info[3] = SMs of the device.
extern "C" int tpupt_hit_kernel_info(int cull, int* info) {
  const auto kernel = cull ? closest_sphere_quad_kernel<true> : closest_sphere_quad_kernel<false>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(&info[3], cudaDevAttrMultiProcessorCount, device));
}
