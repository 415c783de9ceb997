// The render's film on the card: a launch's film added into the float64 film, and the film
// resolved into the mean radiance and the quantized image (render/renderer.py).
//
// add      (film_add_kernel) film[ids[i]][c] += (double)out[i][c] for the n_valid first lanes
//          of a launch's film out [pb, 3] f32, ids [pb] i32 its pixel ids. Lanes past n_valid
//          (the padding of a last pixel block, id 0) add nothing. The ids of a launch are
//          distinct, so each element has one add a launch, in launch order, with no atomic:
//          the bits of numpy's film[ids] += out.astype(np.float64).
// resolve  (film_resolve_kernel) over the film's n elements, x = film / spp in IEEE double:
//          mean = (float)x; img = u8(trunc(min(g, 0.999) * 256)) with g = sqrt(max(x, 0))
//          and NaN -> 0, +inf -> 0.999, the rule of render/film.py's tonemap_quantize
//          (camera.rs:95-97, 128-130). Division, sqrt and one multiply, each rounded on its
//          own: numpy's bits.
//
// Bound. add reads 16 B a lane and 24 B of film a pixel and writes 24 B (Cornell's 360000
// lanes: 23 MB, ~7 us at 3.35 TB/s); resolve reads 24 B a pixel and writes 15 B (Cornell:
// 14 MB, ~4 us). One thread an element, a grid-stride loop.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;

int blocks_for(long long n) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    sms = 132;
  }
  return static_cast<int>(std::max(1LL, std::min(16LL * sms, (n + THREADS - 1) / THREADS)));
}

__global__ void film_add_kernel(const float* __restrict__ out, const int* __restrict__ ids,
                                double* __restrict__ film, long long n) {
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; j < n;
       j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long lane = j / 3;
    const long long c = j - 3 * lane;
    double* f = film + 3LL * ids[lane] + c;
    *f = *f + static_cast<double>(out[j]);
  }
}

__global__ void film_resolve_kernel(const double* __restrict__ film, long long n, double spp,
                                    float* __restrict__ mean, unsigned char* __restrict__ img) {
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; j < n;
       j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const double x = film[j] / spp;
    mean[j] = __double2float_rn(x);
    double g;
    if (x != x) {
      g = 0.0;  // NaN: max and sqrt keep it, nan_to_num makes it 0
    } else if (x > 0.0) {
      g = sqrt(x);  // +inf stays inf, then 0.999 below
    } else {
      g = 0.0;  // max(x, 0) of x <= 0 (-0.0 and -inf too): sqrt gives +-0, which quantizes to 0
    }
    g = g < 0.999 ? g : 0.999;
    img[j] = static_cast<unsigned char>(static_cast<int>(g * 256.0));
  }
}

}  // namespace

extern "C" int tpupt_film_add(const float* out, const int* ids, double* film, int n_valid, void* stream) {
  if (n_valid < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = 3LL * n_valid;
  if (n == 0) return 0;
  film_add_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(out, ids, film, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_film_resolve(const double* film, long long n, int spp, float* mean, unsigned char* img,
                                  void* stream) {
  if (n < 0 || spp < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  film_resolve_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      film, n, static_cast<double>(spp), mean, img);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpupt_film_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
