// RMSNorm forward for Hopper (sm_90a), plain C interface (loaded with ctypes).
//
// Replaces: src/repro/kernels/rmsnorm.py:23, rmsnorm / _rmsnorm_kernel (the
// Pallas TPU kernel): out = x * rsqrt(mean(x^2) + eps) * (1 + scale), f32
// statistics, output in x's dtype.
//
// What bounds it on this card: memory.  Each row is read and written once
// (2*N*d*bytes); at (4096, 1024) bf16 that is 16.8 MB, 5.0 us at 3.35 TB/s.
// The arithmetic (a few flops per element) is nothing next to that.
//
// What the design does about it.  The TPU kernel takes a block of rows into
// VMEM, reduces each and writes it back.  Here a warp takes a group of rows
// and holds them in registers from load to store, so each row is read from
// device memory once and there is no second pass:
//   - lanes a row = min(32, vectors a row), a power of two; a 16-byte vector
//     is 8 bf16 or 4 f32.  So at d = 128 bf16 a warp takes two rows of 16
//     lanes, and all 32 lanes load; the f32 sum of squares is reduced with
//     shuffles inside each row's lanes (no shared memory, no second kernel);
//   - instances for the widths the model paths use (d = 128, 1024, 2560):
//     the vectors a lane holds are a compile-time count, neighbouring lanes
//     on neighbouring 16-byte vectors;
//   - `scale` is loaded once a lane, as the vectors that lane needs, and
//     kept in registers for every row group it takes;
//   - each warp walks several row groups over a grid-stride loop sized to
//     the SMs (blocks a SM by the occupancy calculator), with the next
//     group's loads issued before the current group is reduced: two row
//     groups' loads in flight (where the row fits twice in registers: up to
//     10 vectors a lane).
// Any other d that is a multiple of 8 takes the generic loop: the same lanes
// a row, but two passes over the row (the second from L1/L2).  The caller
// picks the variant (repro_torch.kernels.rmsnorm.select_variant); the C
// entry refuses one the inputs do not fit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPrefetchVectors = 10;   // vectors a lane that still fit twice

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

// The N scale values that match one vector of x (8, 16 or 32 bytes).
template <typename S, int N>
struct alignas(N * sizeof(S) >= 16 ? 16 : N * sizeof(S)) ScaleVec {
  S v[N];
};

template <typename T>
__device__ __forceinline__ void zero(Vec<T>& v) {
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) v.v[j] = from_f32<T>(0.f);
}

// Sum over the `lanes` lanes of each row (lanes a power of two <= 32): xor
// offsets below `lanes` stay inside the row's aligned group of lanes.
__device__ __forceinline__ float row_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The instance for width D: every row held in registers from load to store.
template <typename T, typename S, int D>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
                    long long n_rows, float eps) {
  constexpr int VN = Vec<T>::N;
  constexpr int L = D / VN >= 32 ? 32 : D / VN;  // lanes a row
  constexpr int NV = D / VN / L;                 // vectors a lane
  constexpr int R = 32 / L;                      // rows a group
  constexpr bool kPrefetch = NV <= kMaxPrefetchVectors;
  static_assert(L * NV * VN == D && (L & (L - 1)) == 0, "width not an instance");
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const int r = lane / L;
  const long long n_groups = (n_rows + R - 1) / R;
  const long long stride = (long long)gridDim.x * kWarps;
  long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);

  ScaleVec<S, VN> w[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    w[i] = reinterpret_cast<const ScaleVec<S, VN>*>(scale)[i * L + sub];

  auto load = [&](Vec<T> (&v)[NV], long long grp) {
    const long long row = grp * R + r;
    if (grp < n_groups && row < n_rows) {
      const Vec<T>* xr = reinterpret_cast<const Vec<T>*>(x + row * D);
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = xr[i * L + sub];
    } else {
#pragma unroll
      for (int i = 0; i < NV; ++i) zero(v[i]);
    }
  };

  Vec<T> cur[NV], nxt[NV];
  load(cur, g);
  for (; g < n_groups; g += stride) {
    if constexpr (kPrefetch) load(nxt, g + stride);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        const float f = to_f32(cur[i].v[j]);
        ss += f * f;
      }
    ss = row_sum(ss, L);
    const float inv = rsqrtf(ss / (float)D + eps);
    const long long row = g * R + r;
    if (row < n_rows) {
      Vec<T>* orow = reinterpret_cast<Vec<T>*>(out + row * D);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        Vec<T> ov;
#pragma unroll
        for (int j = 0; j < VN; ++j)
          ov.v[j] = from_f32<T>((to_f32(cur[i].v[j]) * inv) * (1.0f + to_f32(w[i].v[j])));
        orow[i * L + sub] = ov;
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
    } else {
      load(cur, g + stride);
    }
  }
}

// Any d that is a multiple of 8: `lanes` lanes a row, two passes.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_generic_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                       T* __restrict__ out, long long n_rows, int d, int lanes, float eps) {
  constexpr int VN = Vec<T>::N;
  const int nvec = d / VN;
  const int rows = 32 / lanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int r = lane / lanes;
  const long long n_groups = (n_rows + rows - 1) / rows;
  const long long stride = (long long)gridDim.x * kWarps;
  const ScaleVec<S, VN>* sv = reinterpret_cast<const ScaleVec<S, VN>*>(scale);
  for (long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); g < n_groups;
       g += stride) {
    const long long row = g * rows + r;
    const bool valid = row < n_rows;
    const Vec<T>* xr = reinterpret_cast<const Vec<T>*>(x + row * d);
    float ss = 0.f;
    if (valid)
      for (int i = sub; i < nvec; i += lanes) {
        const Vec<T> xv = xr[i];
#pragma unroll
        for (int j = 0; j < VN; ++j) {
          const float f = to_f32(xv.v[j]);
          ss += f * f;
        }
      }
    ss = row_sum(ss, lanes);
    const float inv = rsqrtf(ss / (float)d + eps);
    if (!valid) continue;
    Vec<T>* orow = reinterpret_cast<Vec<T>*>(out + row * d);
    for (int i = sub; i < nvec; i += lanes) {
      const Vec<T> xv = xr[i];
      const ScaleVec<S, VN> wv = sv[i];
      Vec<T> ov;
#pragma unroll
      for (int j = 0; j < VN; ++j)
        ov.v[j] = from_f32<T>((to_f32(xv.v[j]) * inv) * (1.0f + to_f32(wv.v[j])));
      orow[i] = ov;
    }
  }
}

// Blocks for `groups` row groups: enough for one group a warp, at most what
// the SMs hold at once (the grid-stride loop takes the rest).  `per_sm`
// caches the kernel's blocks a SM (0 until the occupancy calculator ran).
template <typename K>
long long grid_blocks(K kernel, int& per_sm, long long groups, cudaError_t* err) {
  if (per_sm == 0) {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (*err != cudaSuccess) return 0;
  }
  int dev = 0, sms = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return 0;
  const long long need = (groups + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return need < cap ? need : cap;
}

template <typename T, typename S, int D>
cudaError_t launch_rows(const void* x, const void* scale, void* out, long long n_rows,
                        float eps, cudaStream_t stream) {
  constexpr int VN = Vec<T>::N;
  constexpr int L = D / VN >= 32 ? 32 : D / VN;
  static int per_sm = 0;  // a property of this kernel: computed once
  cudaError_t err = cudaSuccess;
  const long long blocks = grid_blocks(rmsnorm_rows_kernel<T, S, D>, per_sm,
                                       (n_rows + 32 / L - 1) / (32 / L), &err);
  if (err != cudaSuccess) return err;
  rmsnorm_rows_kernel<T, S, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), n_rows, eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_generic(const void* x, const void* scale, void* out, long long n_rows, int d,
                           int lanes, float eps, cudaStream_t stream) {
  static int per_sm = 0;  // a property of this kernel: computed once
  cudaError_t err = cudaSuccess;
  const int rows = 32 / lanes;
  const long long blocks = grid_blocks(rmsnorm_generic_kernel<T, S>, per_sm,
                                       (n_rows + rows - 1) / rows, &err);
  if (err != cudaSuccess) return err;
  rmsnorm_generic_kernel<T, S><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), n_rows, d,
      lanes, eps);
  return cudaGetLastError();
}

// Lanes a row for width d: the largest power of two <= min(32, vectors a row).
int lanes_for(int d, int vn) {
  const int nvec = d / vn;
  int lanes = 1;
  while (lanes * 2 <= nvec && lanes < 32) lanes *= 2;
  return lanes;
}

template <typename T, typename S>
cudaError_t dispatch(const void* x, const void* scale, void* out, long long n_rows, int d,
                     float eps, int lanes, int instance, cudaStream_t stream) {
  constexpr int VN = Vec<T>::N;
  if (instance != 0) {
    if (d != instance || lanes != lanes_for(d, VN)) return cudaErrorInvalidValue;
    if (instance == 128) return launch_rows<T, S, 128>(x, scale, out, n_rows, eps, stream);
    if (instance == 1024) return launch_rows<T, S, 1024>(x, scale, out, n_rows, eps, stream);
    if (instance == 2560) return launch_rows<T, S, 2560>(x, scale, out, n_rows, eps, stream);
    return cudaErrorInvalidValue;
  }
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || lanes > d / VN)
    return cudaErrorInvalidValue;
  return launch_generic<T, S>(x, scale, out, n_rows, d, lanes, eps, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x and out: (n_rows, d)
// contiguous; x, out and scale 16-byte aligned; d a multiple of 8.
// instance: 128, 1024 or 2560 (the row-in-registers instance for that d,
// at lanes = min(32, d / vector)), or 0 (the generic loop, at `lanes` lanes
// a row: a power of two no larger than 32 or the vectors in a row).
// Returns a cudaError_t (0 = launched).  Launches on `stream`, allocates
// nothing and does not synchronise.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, long long n_rows, int d,
                           float eps, int x_dtype, int s_dtype, int lanes, int instance,
                           void* stream) {
  if (n_rows <= 0 || d <= 0 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(scale)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && s_dtype == 0)
    return (int)dispatch<float, float>(x, scale, out, n_rows, d, eps, lanes, instance, s);
  if (x_dtype == 0 && s_dtype == 1)
    return (int)dispatch<float, bf16>(x, scale, out, n_rows, d, eps, lanes, instance, s);
  if (x_dtype == 1 && s_dtype == 0)
    return (int)dispatch<bf16, float>(x, scale, out, n_rows, d, eps, lanes, instance, s);
  if (x_dtype == 1 && s_dtype == 1)
    return (int)dispatch<bf16, bf16>(x, scale, out, n_rows, d, eps, lanes, instance, s);
  return (int)cudaErrorInvalidValue;
}
