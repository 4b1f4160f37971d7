// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface
// (loaded with ctypes).
//
// Replaces: src/repro/kernels/rglru_scan.py:55, rglru_scan / _rglru_kernel /
// _chunk_scan (the Pallas TPU kernel): h_t = exp(log_a_t) * h_{t-1} + b_t
// with h_0 = 0 over (B, S, D), f32 state and output.  (A nonzero initial
// state is folded into b[:, 0] by the wrapper, as in the reference.)
//
// What bounds it on this card: memory.  log_a and b are read once and h is
// written once, 12 bytes per element; at (2, 2048, 2560) f32 that is
// 125.8 MB, 37.6 us at an H100 SXM's published 3.35 TB/s (700 W).  The
// arithmetic (an exp and an FMA per element) is nothing next to that, but
// the FMAs of one channel form a chain of S dependent steps.
//
// What the design does about it.  The TPU kernel carries the state in VMEM
// scratch across its sequential ("arbitrary") grid steps over time.  Here
// a loop inside the block takes that place: one block per (batch row,
// 32 channels) walks all of S in order, each channel's state in a register
// (one lane per channel), so no block ever waits on another (no look-back,
// flags or scratch).  At path R's shape that is 2 x 80 = 160 blocks on 132
// SMs, each moving 768 KB.  Two things must keep up with the bytes:
//   - the loads: a producer warp fills a ring of kStages stages in shared
//     memory, each holding log_a and b for (kSteps steps x 32 channels),
//     16 KB a stage and 64 KB in flight a block (an SM needs about 25 KB in
//     flight at 3.35 TB/s).  Two routes fill the ring, picked by the caller:
//       - tma: one thread issues two 3-D TMA copies a stage
//         (cp.async.bulk.tensor with an mbarrier) over the view's byte
//         strides; needs strides that are multiples of 16 bytes and 16-byte
//         aligned bases (path R's (B, S, D) views of time-major (S, B, D)
//         storage, or contiguous (B, S, D) with D a multiple of 4).  TMA
//         zero-fills past S and D;
//       - cp_async: the producer warp's 32 lanes copy 4 bytes each with
//         cp.async (zero-filling past S and D themselves) and signal the
//         stage's mbarrier when their copies land; any strides (D = 130,
//         D = 5).
//   - the instructions: one warp walking 2048 steps issues about 15
//     instructions a step (two shared loads, an exp, the FMA, a store and
//     their addresses), and its time a block came out above the bytes'.
//     So four consumer warps split each 64-step stage into 16-step slices:
//     each scans its slice from zero (exp off the chain, 16 dependent FMAs),
//     the four slice maps (decay product, state from zero) are folded in
//     order onto the carried state after one barrier of the consumers, and
//     each slice writes h = (decay product) * (its carry-in) + (its state
//     from zero), 128 bytes a warp a step.
// Steps past S and channels past D act as (log_a = 0, b = 0), which leaves
// the state as it is, and are not stored.  Every exponent is <= 0 (log_a
// <= 0 in RG-LRU) and every decay product <= 1, so nothing overflows.
#include <cuda.h>  // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;                     // channels per block: one consumer lane each
constexpr int kSteps = 64;                  // time steps per stage
constexpr int kStages = 4;                  // stages of the ring
constexpr int kConsumers = 4;               // consumer warps, one slice of a stage each
constexpr int kSlice = kSteps / kConsumers; // steps a slice: 16
constexpr int kThreads = 32 * (kConsumers + 1);     // warps 0-3 consume, warp 4 produces
constexpr int kTileBytes = kSteps * kCh * 4;        // one of log_a / b in a stage: 8 KB
constexpr int kStageBytes = 2 * kTileBytes;         // 16 KB
constexpr int kAggOffset = kStages * kStageBytes;   // slice maps [2][kConsumers][2][kCh]
constexpr int kBarOffset = kAggOffset + 2 * kConsumers * 2 * kCh * 4;  // full, empty
constexpr int kSmemBytes = kBarOffset + 16 * kStages;
constexpr int kSmemAlloc = kSmemBytes + 128;        // slack to align the base to 128 B
constexpr long long kSpinLimit = 1LL << 22;         // a real wait is microseconds

constexpr int kRouteCpAsync = 0;
constexpr int kRouteTma = 1;

struct Args {
  const float* log_a;                 // used by the cp_async route
  const float* b;
  float* h;                           // (B, S, D) contiguous
  long long sa_b, sa_s, sb_b, sb_s;   // element strides of log_a and b (d: 1)
  int batch, seq, dim, n_dblk;
  int a_time_outer, b_time_outer;     // tma: the map's dims are (D, B, S), not (D, S, B)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed; traps (a
// launch error, not a hang) if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && ++polls > kSpinLimit) __trap();
  } while (!done);
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// 4-byte global -> shared copy; with `valid` false it writes a zero and
// reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
// Arrive on `bar` once this thread's earlier cp.asyncs have landed (the
// barrier's count includes this arrival).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

template <int kRoute>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b, Args p) {
  extern __shared__ uint8_t smem_raw[];
  // the ring at a 128-byte boundary; pointer arithmetic on the __shared__
  // array (not an integer round trip) keeps its loads shared-memory loads
  uint8_t* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const uint32_t base = smem_u32(smem);
  auto full = [&](int s) { return base + kBarOffset + 8u * s; };
  auto empty = [&](int s) { return base + kBarOffset + 8u * (kStages + s); };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bb = blockIdx.x / p.n_dblk;
  const int d0 = (blockIdx.x - bb * p.n_dblk) * kCh;
  const int d = d0 + lane;
  const bool live = d < p.dim;
  const int n_chunks = (p.seq + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), kRoute == kRouteTma ? 1 : 32);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- producer: keep the ring full ----
    const float* pa = p.log_a + bb * p.sa_b + d;
    const float* pb = p.b + bb * p.sb_b + d;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % kStages;
      const uint32_t ph = (c / kStages) & 1;
      const int t0 = c * kSteps;
      const uint32_t dst = base + s * kStageBytes;
      if constexpr (kRoute == kRouteTma) {
        if (lane == 0) {
          mbar_wait(empty(s), ph ^ 1);   // first pass: the stage starts empty
          mbar_expect_tx(full(s), kStageBytes);
          tma_load_3d(dst, &tm_a, full(s), d0, p.a_time_outer ? bb : t0,
                      p.a_time_outer ? t0 : bb);
          tma_load_3d(dst + kTileBytes, &tm_b, full(s), d0, p.b_time_outer ? bb : t0,
                      p.b_time_outer ? t0 : bb);
        }
      } else {
        mbar_wait(empty(s), ph ^ 1);
        const uint32_t da = dst + 4u * lane;
#pragma unroll 8
        for (int t = 0; t < kSteps; ++t) {
          const bool valid = live && t0 + t < p.seq;
          const long long tt = valid ? t0 + t : 0;
          cp_async4(da + t * kCh * 4, valid ? pa + tt * p.sa_s : p.log_a, valid);
          cp_async4(da + kTileBytes + t * kCh * 4, valid ? pb + tt * p.sb_s : p.b, valid);
        }
        cp_async_arrive(full(s));
      }
    }
    return;
  }

  // ---- consumers: warp w takes steps [16w, 16w + 16) of every stage ----
  // Each lane keeps its channel's state at stage boundaries (`carry`, the
  // same in all four warps).  A warp loads its slice into registers and
  // frees its part of the stage at once; scans the slice from zero,
  // keeping each step's state `loc` and decay product `cum`; publishes the
  // slice's map (A = its decay product, H = its state from zero); after one
  // barrier of the consumer warps, folds the earlier slices' maps onto the
  // carry to get its carry-in, and writes h = cum * carry_in + loc.  Every
  // warp folds all four maps in the same order, so all carry the same
  // state into the next stage.  The maps are double-buffered by stage, so
  // the one barrier a stage is all the consumers need.
  float carry = 0.f;
  float* agg = reinterpret_cast<float*>(smem + kAggOffset);
  float* out = p.h + ((long long)bb * p.seq + warp * kSlice) * p.dim + d;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    const int steps = min(kSlice, p.seq - c * kSteps - warp * kSlice);  // may be <= 0
    mbar_wait(full(s), (c / kStages) & 1);
    const float* sa = reinterpret_cast<const float*>(smem + s * kStageBytes) +
                      warp * kSlice * kCh + lane;
    const float* sb = sa + kTileBytes / 4;
    float cum[kSlice], loc[kSlice];
#pragma unroll
    for (int t = 0; t < kSlice; ++t) {
      cum[t] = sa[t * kCh];
      loc[t] = sb[t * kCh];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // release: orders the loads above before it
    float pa = 1.f, ph = 0.f;
#pragma unroll
    for (int t = 0; t < kSlice; ++t) {
      const float a = expf(cum[t]);
      pa *= a;
      ph = fmaf(a, ph, loc[t]);
      cum[t] = pa;
      loc[t] = ph;
    }
    float* maps = agg + (c & 1) * (kConsumers * 2 * kCh);   // [kConsumers][A, H][kCh]
    maps[(warp * 2) * kCh + lane] = pa;
    maps[(warp * 2 + 1) * kCh + lane] = ph;
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers * 32) : "memory");
    float carry_in = carry;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      if (w == warp) carry_in = carry;
      carry = fmaf(maps[(w * 2) * kCh + lane], carry, maps[(w * 2 + 1) * kCh + lane]);
    }
#pragma unroll
    for (int t = 0; t < kSlice; ++t)
      if (live && t < steps) out[(long long)t * p.dim] = fmaf(cum[t], carry_in, loc[t]);
    out += (long long)kSteps * p.dim;
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A 3-D map of an f32 (B, S, D) view with element strides (sb, ss, 1):
// dims (D, S, B), or (D, B, S) when the batch stride is the smaller
// (*time_outer = 1), so that the strides rise with the dims.  Boxes of
// (32 channels, 64 steps, 1 row) either way, which land in shared memory as
// [64][32]; zeros out of bounds.
bool encode_bsd(CUtensorMap* map, int* time_outer, const void* ptr, int B, int S, int D,
                long long sb, long long ss) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  *time_outer = sb < ss ? 1 : 0;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)(*time_outer ? B : S),
                              (cuuint64_t)(*time_outer ? S : B)};
  const cuuint64_t strides[2] = {(cuuint64_t)(*time_outer ? sb : ss) * 4,
                                 (cuuint64_t)(*time_outer ? ss : sb) * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kCh, (cuuint32_t)(*time_outer ? 1 : kSteps),
                             (cuuint32_t)(*time_outer ? kSteps : 1)};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// What TMA needs: (batch, seq) strides that are multiples of 16 bytes and
// 16-byte aligned bases.
bool tma_eligible(const void* log_a, const void* b, long long sa_b, long long sa_s,
                  long long sb_b, long long sb_s) {
  if (sa_b <= 0 || sa_s <= 0 || sb_b <= 0 || sb_s <= 0) return false;
  if (sa_b % 4 != 0 || sa_s % 4 != 0 || sb_b % 4 != 0 || sb_s % 4 != 0) return false;
  return (reinterpret_cast<uintptr_t>(log_a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

template <int kRoute>
cudaError_t launch(const CUtensorMap& tm_a, const CUtensorMap& tm_b, const Args& p,
                   cudaStream_t stream) {
  // set on every call: the attribute belongs to the current device
  const cudaError_t attr = cudaFuncSetAttribute(
      rglru_scan_kernel<kRoute>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemAlloc);
  if (attr != cudaSuccess) return attr;
  rglru_scan_kernel<kRoute><<<(unsigned)(p.batch * p.n_dblk), kThreads, kSmemAlloc, stream>>>(
      tm_a, tm_b, p);
  return cudaGetLastError();
}

}  // namespace

// Route codes: 0 = cp_async (any strides), 1 = tma ((batch, seq) strides
// multiples of 4 elements, 16-byte aligned bases).  The caller picks the
// route (repro_torch.kernels.rglru_scan.select_route); a route asked for on
// inputs it cannot take is an error, never a quiet switch.
// log_a, b: f32 (batch, seq, dim) with unit stride along dim and the given
// element strides for batch and seq; h: f32 (batch, seq, dim) contiguous.
// Returns a cudaError_t (0 = launched).  One launch on `stream`; allocates
// nothing and does not synchronise.
extern "C" int rglru_scan_fwd(const void* log_a, const void* b, void* h, int batch, int seq,
                              int dim, long long sa_b, long long sa_s, long long sb_b,
                              long long sb_s, int route, void* stream) {
  if (batch <= 0 || seq <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const long long n_dblk = (dim + kCh - 1) / kCh;
  if ((long long)batch * n_dblk > 2147483647LL) return (int)cudaErrorInvalidValue;
  Args p;
  p.log_a = static_cast<const float*>(log_a);
  p.b = static_cast<const float*>(b);
  p.h = static_cast<float*>(h);
  p.sa_b = sa_b; p.sa_s = sa_s; p.sb_b = sb_b; p.sb_s = sb_s;
  p.batch = batch; p.seq = seq; p.dim = dim;
  p.n_dblk = (int)n_dblk;
  p.a_time_outer = p.b_time_outer = 0;
  CUtensorMap tm_a{}, tm_b{};  // unused by the cp_async route
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteTma) {
    if (!tma_eligible(log_a, b, sa_b, sa_s, sb_b, sb_s) ||
        !encode_bsd(&tm_a, &p.a_time_outer, log_a, batch, seq, dim, sa_b, sa_s) ||
        !encode_bsd(&tm_b, &p.b_time_outer, b, batch, seq, dim, sb_b, sb_s))
      return (int)cudaErrorInvalidValue;
    return (int)launch<kRouteTma>(tm_a, tm_b, p, s);
  }
  if (route != kRouteCpAsync) return (int)cudaErrorInvalidValue;
  return (int)launch<kRouteCpAsync>(tm_a, tm_b, p, s);
}
