// RMSNorm forward for Hopper (sm_90a), plain C interface (loaded with ctypes).
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm / _rmsnorm_kernel (the
// Pallas TPU kernel): out = x * rsqrt(mean(x^2) + eps) * (1 + scale), f32
// statistics, output in x's dtype.
//
// What bounds it on this card: memory.  Each row is read and written once
// (2*N*d*bytes); at (4096, 1024) bf16 that is 16.8 MB, 5.0 us at 3.35 TB/s.
// The arithmetic (a few flops per element) is nothing next to that.
//
// What the design does about it: one warp per row, 16-byte vectorised loads
// and stores (8 bf16 or 4 f32 per lane per step), neighbouring lanes on
// neighbouring addresses; the f32 sum of squares is reduced inside the warp
// with shuffles, so no shared memory and no second kernel.  The second pass
// over the row re-reads it from L1/L2, not device memory.  The TPU kernel's
// row blocks (and its block-size halving for ragged N) are gone: a block of
// 8 warps takes 8 rows and the last block masks the rows past N itself.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bf16)
}

// One 16-byte vector of T.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, typename S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, long long n_rows, int d, float eps) {
  constexpr int VN = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // ragged edge: rows past N do nothing
  const Vec<T>* xr = reinterpret_cast<const Vec<T>*>(x + row * d);
  Vec<T>* orow = reinterpret_cast<Vec<T>*>(out + row * d);
  const int nvec = d / VN;

  float ss = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    Vec<T> xv = xr[i];
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      float f = to_f32(xv.v[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / (float)d + eps);

  for (int i = lane; i < nvec; i += 32) {
    Vec<T> xv = xr[i];
    Vec<T> ov;
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      const float s = to_f32(scale[i * VN + j]);
      ov.v[j] = from_f32<T>((to_f32(xv.v[j]) * inv) * (1.0f + s));
    }
    orow[i] = ov;
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, long long n_rows,
                   int d, float eps, cudaStream_t stream) {
  const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T, S><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out),
      n_rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.
// x and out: (n_rows, d) contiguous and 16-byte aligned; d a multiple of 8.
// Returns a cudaError_t (0 = launched).  Launches on `stream`, allocates
// nothing and does not synchronise.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           long long n_rows, int d, float eps, int x_dtype,
                           int s_dtype, void* stream) {
  if (n_rows <= 0 || d <= 0 || d % 8 != 0 || n_rows > 2147483647LL * kWarpsPerBlock)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && s_dtype == 0) return (int)launch<float, float>(x, scale, out, n_rows, d, eps, s);
  if (x_dtype == 0 && s_dtype == 1) return (int)launch<float, __nv_bfloat16>(x, scale, out, n_rows, d, eps, s);
  if (x_dtype == 1 && s_dtype == 0) return (int)launch<__nv_bfloat16, float>(x, scale, out, n_rows, d, eps, s);
  if (x_dtype == 1 && s_dtype == 1) return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, n_rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
