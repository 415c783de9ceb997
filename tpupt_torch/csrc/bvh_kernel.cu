// Closest triangle of every ray by the stackless walk of a triangle BVH.
//
// Replaces tpupt/ops/bvh.py::bvh_closest_tri, which is not a Pallas kernel but a
// lax.while_loop that XLA compiles whole; in eager PyTorch on the card each of its
// iterations would be some 80 launches and a host read. The contract is that
// function's, and its plain version's (ops/bvh.py::bvh_closest_tri_plain):
//   inputs  o [B,3], d [B,3] (f32, contiguous); tmin, tmax; the nodes packed by
//           ops/bvh_kernel.py::pack_nodes, two float4 a node in DFS pre-order:
//             bmin xyz, skip (int bits) | bmax xyz, start * 8 + count (int bits)
//           (count == 0: internal node; skip: the first node after the subtree);
//           the triangle rows v0, e1, e2 [T,3] (f32) in the tree's order.
//   outputs t [B] f32 (BIG = 3e38 on a miss) and idx [B] i32 (0 on a miss).
//   rules   one cursor a ray from node 0. Slab test: 1/d after the sign-preserving
//           flush |d| < 1e-20 -> +-1e-20; it passes when tn = max(slabs, tmin) <=
//           tf = min(slabs, min(best, tmax)), min and max propagating NaN like
//           torch.minimum, so a NaN ray fails every test and misses. A passed leaf
//           tests its triangles in order by Möller–Trumbore (f = 1/(|a| < 1e-8 ? 1 :
//           a); a hit needs |a| >= 1e-8, u >= 0, u <= 1, v >= 0, u + v <= 1, t > tmin,
//           t < tmax and t strictly below the best so far), so a tie goes to the first
//           triangle the walk meets. The cursor moves to i + 1 from a passed internal
//           node and to skip[i] otherwise; the ray is done when it reaches M.
//
// Bound. A node visit is 24 float operations and a triangle test 46 (adds,
// multiplies, one divide; compares not counted), against 32 B of node and 36 B of
// triangle rows; a camera ray of bigmesh visits some 64 nodes and tests some 10
// triangles, one of the scene-6 stand-in, which mostly misses its meshes, 7 and 0.7
// (chip_smoke.py's counts). The nodes and the rows are a few MB (bigmesh: 6 MB of
// nodes, 11 MB of rows) and stay in the 50 MB L2 cache, so the kernel is bound
// neither by device memory nor by arithmetic but by the latency of each dependent
// node read and by divergence: the rays of a warp walk different paths and take
// different numbers of steps, and the warp runs until its longest walk ends.
//
// Design, the first one, simple and right: one thread a ray, 128 threads a block, the
// nodes read with __ldg as two 16-byte loads, the triangle rows read as they are. A
// later design may walk with a short stack, a wider tree, or sort rays so that a warp
// walks together. Build with --fmad=false so each operation rounds on its own, like
// the plain version, which makes the two bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 3.0e38f;
constexpr int THREADS = 128;

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

__global__ void __launch_bounds__(THREADS)
closest_tri_bvh_kernel(const float* __restrict__ o, const float* __restrict__ d, float tmin, float tmax,
                       const float4* __restrict__ nodes, int n_nodes, const float* __restrict__ v0,
                       const float* __restrict__ e1, const float* __restrict__ e2,
                       float* __restrict__ t_out, int* __restrict__ idx_out, int n_rays) {
  const int ray = blockIdx.x * THREADS + threadIdx.x;
  if (ray >= n_rays) return;
  const float ox = o[3 * ray + 0], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray + 0], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float best = BIG;
  int best_i = 0;
  int i = 0;
  while (i < n_nodes) {
    const float4 a = __ldg(nodes + 2 * (size_t)i);
    const float4 b = __ldg(nodes + 2 * (size_t)i + 1);
    const float t1x = (a.x - ox) * ix;
    const float t2x = (b.x - ox) * ix;
    const float t1y = (a.y - oy) * iy;
    const float t2y = (b.y - oy) * iy;
    const float t1z = (a.z - oz) * iz;
    const float t2z = (b.z - oz) * iz;
    const float tn = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)), max_nan(min_nan(t1z, t2z), tmin));
    const float tf = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                             min_nan(max_nan(t1z, t2z), min_nan(best, tmax)));
    const bool hit = tn <= tf;
    const int leaf = __float_as_int(b.w);
    const int count = leaf & 7;
    if (hit && count > 0) {
      const int start = leaf >> 3;
      for (int k = start; k < start + count; ++k) {
        const float v0x = __ldg(v0 + 3 * (size_t)k), v0y = __ldg(v0 + 3 * (size_t)k + 1);
        const float v0z = __ldg(v0 + 3 * (size_t)k + 2);
        const float e1x = __ldg(e1 + 3 * (size_t)k), e1y = __ldg(e1 + 3 * (size_t)k + 1);
        const float e1z = __ldg(e1 + 3 * (size_t)k + 2);
        const float e2x = __ldg(e2 + 3 * (size_t)k), e2y = __ldg(e2 + 3 * (size_t)k + 1);
        const float e2z = __ldg(e2 + 3 * (size_t)k + 2);
        // Möller–Trumbore (mesh.rs:50-82), the operations of ops/tri_kernel.py _mt in their order
        const float hx = dy * e2z - dz * e2y;
        const float hy = dz * e2x - dx * e2z;
        const float hz = dx * e2y - dy * e2x;
        const float det = e1x * hx + e1y * hy + e1z * hz;
        const float f = 1.0f / (fabsf(det) < 1e-8f ? 1.0f : det);
        const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
        const float u = f * (sx * hx + sy * hy + sz * hz);
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = f * (dx * qx + dy * qy + dz * qz);
        const float t = f * (e2x * qx + e2y * qy + e2z * qz);
        if (fabsf(det) >= 1e-8f && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t > tmin &&
            t < best && t < tmax) {
          best = t;
          best_i = k;
        }
      }
    }
    i = (hit && count == 0) ? i + 1 : __float_as_int(a.w);
  }
  t_out[ray] = best;
  idx_out[ray] = best_i;
}

}  // namespace

extern "C" int tpupt_closest_tri_bvh(const float* o, const float* d, float tmin, float tmax,
                                     const float* nodes, int n_nodes, const float* v0,
                                     const float* e1, const float* e2, float* t_out, int* idx_out,
                                     int n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  closest_tri_bvh_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, reinterpret_cast<const float4*>(nodes), n_nodes, v0, e1, e2, t_out, idx_out,
      n_rays);
  return static_cast<int>(cudaGetLastError());
}
