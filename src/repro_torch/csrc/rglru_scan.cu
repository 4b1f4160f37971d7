// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface
// (loaded with ctypes).
//
// Replaces: src/repro/kernels/rglru_scan.py, rglru_scan / _rglru_kernel /
// _chunk_scan (the Pallas TPU kernel): h_t = exp(log_a_t) * h_{t-1} + b_t
// with h_0 = 0 over (B, S, D), f32 state and output.  (A nonzero initial
// state is folded into b[:, 0] by the wrapper, as in the reference.)
//
// What bounds it on this card: memory.  log_a and b are read once and h is
// written once, 12 bytes per element; at (2, 2048, 2560) f32 that is
// 125.8 MB, 37.6 us at an H100 SXM's published 3.35 TB/s (700 W).  The
// arithmetic (an exp and an FMA per element) is nothing next to that.
//
// What the design does about it.  The TPU kernel walks time chunks in
// order, one grid step after another, with the state in VMEM scratch.
// Hopper's blocks run in no order, and one thread per (b, d) channel
// walking all of S gives only B*D threads (5120 at the path shape, 40
// blocks of 128 on 132 SMs) with too few loads in flight.  So each block
// takes one (batch, 128-channel, 32-step) tile and runs a single-pass
// chunked scan with decoupled look-back:
//   1. it loads its 32 steps of log_a and b into registers (all loads
//      independent: 64 in flight per thread), and computes its chunk's
//      aggregate, the affine map h_out = exp(A) h_in + H (A = sum log_a,
//      H = the chunk's scan from h_in = 0);
//   2. it publishes the aggregate, then walks back over the preceding
//      chunks of its channels, composing their aggregates until it meets
//      one whose inclusive prefix (the true state at its end) is out;
//   3. it publishes its own inclusive prefix and rescans its 32 steps from
//      the carried-in state, out of registers, writing h.
// So log_a and b are read once and h written once: the bound's traffic.
// Tiles take tickets from an atomic counter in chunk-major order, so a
// block only ever waits on blocks that are already running (no deadlock
// whatever the scheduling order).  Loads and stores run along D, so a
// warp's 32 lanes touch 128 contiguous bytes.  Ragged S and D are masked:
// steps past S act as (log_a = 0, b = 0), which leaves the state as it is.
// Every exponent is <= 0 (log_a <= 0 in RG-LRU), so nothing overflows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // channels per tile
constexpr int kChunk = 32;             // time steps per tile
constexpr long long kSpinLimit = 1LL << 24;  // ~5 s of polling: a real wait is microseconds

// tile status flags
constexpr int kNone = 0;               // nothing published yet
constexpr int kAggregate = 1;          // the chunk's own map (A, H) is out
constexpr int kPrefix = 2;             // the true state at the chunk's end is out

struct Args {
  const float* log_a;
  const float* b;
  float* h;                            // (B, S, D) contiguous
  long long sa_b, sa_s, sb_b, sb_s;    // element strides of log_a and b (d: 1)
  int batch, seq, dim, n_dblk;
  float* agg_a;                        // (n_tiles, kThreads) each
  float* agg_h;
  float* prefix;
  int* flags;                          // (n_tiles,), zero at launch
  int* ticket;                         // one counter, zero at launch
};

// Block-wide publish: every thread's stores are made visible device-wide
// before thread 0 raises the tile's flag.
__device__ __forceinline__ void publish(int* flag, int value) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(flag, value);
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(Args p) {
  __shared__ int s_tile;
  __shared__ int s_flag;
  if (threadIdx.x == 0) s_tile = atomicAdd(p.ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int per_chunk = p.batch * p.n_dblk;
  const int chunk = tile / per_chunk;
  const int bd = tile - chunk * per_chunk;
  const int bb = bd / p.n_dblk;
  const int d = (bd - bb * p.n_dblk) * kThreads + threadIdx.x;
  const bool live = d < p.dim;
  const int t0 = chunk * kChunk;
  const int steps = min(kChunk, p.seq - t0);

  // 1. load the chunk; its aggregate map
  float a[kChunk], x[kChunk];
  float sum_la = 0.f, agg = 0.f;
  const float* pa = p.log_a + bb * p.sa_b + (long long)t0 * p.sa_s + d;
  const float* pb = p.b + bb * p.sb_b + (long long)t0 * p.sb_s + d;
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    float la = 0.f, bv = 0.f;
    if (live && t < steps) {
      la = __ldg(pa + t * p.sa_s);
      bv = __ldg(pb + t * p.sb_s);
    }
    a[t] = expf(la);
    x[t] = bv;
    sum_la += la;
  }
#pragma unroll
  for (int t = 0; t < kChunk; ++t) agg = fmaf(a[t], agg, x[t]);

  // 2. carry-in: the true state just before this chunk
  const int slot = tile * kThreads + threadIdx.x;
  float carry = 0.f;
  if (chunk > 0) {
    p.agg_a[slot] = sum_la;
    p.agg_h[slot] = agg;
    publish(&p.flags[tile], kAggregate);
    // (acc_a, acc_h): the composed map of chunks j+1 .. chunk-1
    float acc_a = 0.f, acc_h = 0.f;
    for (int j = chunk - 1; j >= 0; --j) {
      const int jt = j * per_chunk + bd;
      if (threadIdx.x == 0) {
        const volatile int* f = &p.flags[jt];
        int seen;
        long long spins = 0;
        while ((seen = *f) == kNone) {
          if (++spins > kSpinLimit) __trap();   // never hang the card
        }
        __threadfence();
        s_flag = seen;
      }
      __syncthreads();
      const int seen = s_flag;
      const int js = jt * kThreads + threadIdx.x;
      if (seen == kPrefix) {
        carry = fmaf(expf(acc_a), __ldcg(&p.prefix[js]), acc_h);
        break;
      }
      acc_h = fmaf(expf(acc_a), __ldcg(&p.agg_h[js]), acc_h);
      acc_a += __ldcg(&p.agg_a[js]);
      __syncthreads();                 // all have read s_flag before reuse
    }
  }
  // 3. this chunk's inclusive prefix, then its states from the carry-in
  p.prefix[slot] = fmaf(expf(sum_la), carry, agg);
  publish(&p.flags[tile], kPrefix);

  float* ph = p.h + ((long long)bb * p.seq + t0) * p.dim + d;
  float hc = carry;
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    hc = fmaf(a[t], hc, x[t]);
    if (live && t < steps) ph[(long long)t * p.dim] = hc;
  }
}

}  // namespace

// Tiles of one launch: the caller sizes the scratch with it.
extern "C" long long rglru_scan_tiles(int batch, int seq, int dim) {
  const long long n_dblk = (dim + kThreads - 1) / kThreads;
  const long long n_chunks = (seq + kChunk - 1) / kChunk;
  return (long long)batch * n_dblk * n_chunks;
}

// log_a, b: f32 (batch, seq, dim) with unit stride along dim and the given
// element strides for batch and seq; h: f32 (batch, seq, dim) contiguous.
// scratch: f32, 3 * tiles * 128 values; flags: int32, tiles + 1 values, all
// zero.  Returns a cudaError_t (0 = launched).  Launches on `stream`,
// allocates nothing and does not synchronise.
extern "C" int rglru_scan_fwd(const void* log_a, const void* b, void* h,
                              void* scratch, void* flags, int batch, int seq,
                              int dim, long long sa_b, long long sa_s,
                              long long sb_b, long long sb_s, void* stream) {
  if (batch <= 0 || seq <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = rglru_scan_tiles(batch, seq, dim);
  if (tiles > 2147483647LL / kThreads) return (int)cudaErrorInvalidValue;
  Args p;
  p.log_a = static_cast<const float*>(log_a);
  p.b = static_cast<const float*>(b);
  p.h = static_cast<float*>(h);
  p.sa_b = sa_b; p.sa_s = sa_s; p.sb_b = sb_b; p.sb_s = sb_s;
  p.batch = batch; p.seq = seq; p.dim = dim;
  p.n_dblk = (dim + kThreads - 1) / kThreads;
  float* s = static_cast<float*>(scratch);
  p.agg_a = s;
  p.agg_h = s + tiles * kThreads;
  p.prefix = s + 2 * tiles * kThreads;
  p.flags = static_cast<int*>(flags);
  p.ticket = p.flags + tiles;
  rglru_scan_kernel<<<(unsigned)tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
