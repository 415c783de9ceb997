// Closest hit of every ray against every sphere and every quad of a scene.
//
// Replaces the TPU kernel tpupt/ops/pallas_hit.py::_hit_kernel (wrapper
// pallas_closest_sphere_quad). The contract is that kernel's, not its tiling:
//   inputs  o [B,3], d [B,3], time [B] (f32, contiguous); tables in the
//           reference's _tables layout, sph [7,S] (c1 xyz, c2 xyz, r) and
//           quad [16,Q] (n xyz, q xyz, u xyz, v xyz, w xyz, d); tmin.
//   outputs t [B] f32 (BIG = 3e38 on a miss), kind [B] and idx [B] int32
//           (kind 0 sphere, 1 quad; kind 0 / idx 0 on a miss).
//   rules   a sphere with r < 0 never hits (pad rows); its root is s-q outside
//           and s+q inside; a quad is parallel when |n.d| < 1e-8 (zero-normal
//           pad rows always are) and needs alpha, beta in [0,1]. A hit needs
//           t > tmin and t strictly below the best so far, so ties go to the
//           lower index and spheres beat quads. The t tests are written as
//           positive comparisons, so a NaN t is a miss.
//
// Bound. Per ray, a sphere slot costs 28 float operations and a quad slot 49
// (adds, multiplies, one divide or sqrt; compares not counted), against 40 B of
// ray input and output. Cornell's 8 sphere + 24 quad slots are ~1.4 kflop per
// 40 B, far above the H100's ~20 flop/B float32 balance point, so the kernel is
// bound by arithmetic, not memory.
//
// Design. One thread per ray; the ray lives in registers for the whole sweep.
// The block stages the tables into shared memory one tile of TILE primitives at
// a time, stored component-major ([row][prim]); every thread of a warp then
// reads the same address, which shared memory serves as a broadcast, so the
// primitive loop issues no global loads at all. Any table size works: larger
// tables take more tiles. The ragged end of the ray batch is masked, not padded.
// Build with --fmad=false so each operation rounds on its own, like the plain
// PyTorch version in ops/hit_kernel.py, which makes the two bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 256;
constexpr int SPH_ROWS = 7;
constexpr int QUAD_ROWS = 16;
constexpr float BIG = 3.0e38f;

__global__ void __launch_bounds__(THREADS)
closest_sphere_quad_kernel(const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ time, const float* __restrict__ sph,
                           int n_sph, const float* __restrict__ quad, int n_quad, float tmin,
                           float* __restrict__ t_out, int* __restrict__ kind_out,
                           int* __restrict__ idx_out, int n_rays) {
  __shared__ float s_sph[SPH_ROWS][TILE];
  __shared__ float s_quad[QUAD_ROWS][TILE];

  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool active = ray < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tm = 0.f;
  if (active) {
    ox = o[3 * ray + 0];
    oy = o[3 * ray + 1];
    oz = o[3 * ray + 2];
    dx = d[3 * ray + 0];
    dy = d[3 * ray + 1];
    dz = d[3 * ray + 2];
    tm = time[ray];
  }
  float best_t = BIG;
  int best_kind = 0;
  int best_idx = 0;

  // ---- spheres (sphere.rs:64-100) ----
  for (int base = 0; base < n_sph; base += TILE) {
    const int n = min(TILE, n_sph - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < SPH_ROWS * TILE; k += THREADS) {
      const int row = k / TILE, col = k % TILE;
      if (col < n) s_sph[row][col] = sph[row * n_sph + base + col];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float c1x = s_sph[0][j], c1y = s_sph[1][j], c1z = s_sph[2][j];
      const float cx = c1x + (s_sph[3][j] - c1x) * tm;
      const float cy = c1y + (s_sph[4][j] - c1y) * tm;
      const float cz = c1z + (s_sph[5][j] - c1z) * tm;
      const float r = s_sph[6][j];
      const float lx = cx - ox, ly = cy - oy, lz = cz - oz;
      const float s = lx * dx + ly * dy + lz * dz;
      const float l2 = lx * lx + ly * ly + lz * lz;
      const float r2 = r * r;
      const float d2 = l2 - s * s;
      const float h = r2 - d2;
      const float q = sqrtf(h < 1e-20f ? 1e-20f : h);  // floor that keeps NaN, like clamp
      const float t = (l2 > r2) ? s - q : s + q;
      const bool miss = ((s < 0.f) && (l2 > r2)) || (d2 > r2) || (r < 0.f);
      if (!miss && t > tmin && t < best_t) {
        best_t = t;
        best_kind = 0;
        best_idx = base + j;
      }
    }
  }

  // ---- quads (quad.rs:40-70) ----
  for (int base = 0; base < n_quad; base += TILE) {
    const int n = min(TILE, n_quad - base);
    __syncthreads();
    for (int k = threadIdx.x; k < QUAD_ROWS * TILE; k += THREADS) {
      const int row = k / TILE, col = k % TILE;
      if (col < n) s_quad[row][col] = quad[row * n_quad + base + col];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float nx = s_quad[0][j], ny = s_quad[1][j], nz = s_quad[2][j];
      const float nd = nx * dx + ny * dy + nz * dz;
      const float no = nx * ox + ny * oy + nz * oz;
      const bool parallel = fabsf(nd) < 1e-8f;
      const float t = (s_quad[15][j] - no) / (parallel ? 1.0f : nd);
      const float px = ox + t * dx - s_quad[3][j];
      const float py = oy + t * dy - s_quad[4][j];
      const float pz = oz + t * dz - s_quad[5][j];
      const float ux = s_quad[6][j], uy = s_quad[7][j], uz = s_quad[8][j];
      const float vx = s_quad[9][j], vy = s_quad[10][j], vz = s_quad[11][j];
      const float wx = s_quad[12][j], wy = s_quad[13][j], wz = s_quad[14][j];
      const float alpha =
          wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz) + wz * (px * vy - py * vx);
      const float beta =
          wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz) + wz * (ux * py - uy * px);
      const bool miss = parallel || (alpha < 0.f) || (alpha > 1.f) || (beta < 0.f) || (beta > 1.f);
      if (!miss && t > tmin && t < best_t) {
        best_t = t;
        best_kind = 1;
        best_idx = base + j;
      }
    }
  }

  if (active) {
    t_out[ray] = best_t;
    kind_out[ray] = best_kind;
    idx_out[ray] = best_idx;
  }
}

}  // namespace

extern "C" int tpupt_closest_sphere_quad(const float* o, const float* d, const float* time,
                                         const float* sph, int n_sph, const float* quad,
                                         int n_quad, float tmin, float* t_out, int* kind_out,
                                         int* idx_out, int n_rays, void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + THREADS - 1) / THREADS;
    closest_sphere_quad_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, time, sph, n_sph, quad, n_quad, tmin, t_out, kind_out, idx_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}
