// RWKV-6 WKV recurrence for Hopper (sm_90a), plain C interface (loaded with
// ctypes).
//
// Replaces: src/repro/kernels/wkv6.py, wkv6 / _wkv6_kernel (the Pallas TPU
// kernel).  Per (batch, head), with a D x D state S that starts at zero:
//     y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- exp(log_w_t[i]) * S[i][j] + k_t[i] * v_t[j]
// Inputs (B, S, H, D) f32, indexed through strides; u (H, D); y (B, S, H, D)
// f32.  No final state is returned.
//
// What bounds it on this card.  Bytes: r, k, v, log_w read once and y
// written once, 20 bytes per element; at RWKV-6-3B's full width (2, 2048,
// 40, 64) that is 41.9 MB x 5, 62.6 us at an H100 SXM's published
// 3.35 TB/s (700 W).  Operations: the step form does about 4 f32
// operations per state entry per step (2.7 GFLOP there), 40 us at the
// published 67 TFLOP/s of f32 outside the tensor cores.  So on paper the bytes
// bound it; in practice this kernel is bound by the sequential chain over
// S inside one block per (batch, head): 80 blocks at full width leave 52
// SMs idle, and the single head of a scan site (path W) is one block,
// latency-bound.
//
// What the design does about it.  The TPU kernel evaluates each 64-step
// chunk in closed form with k * exp(-cs) (cs = the chunk's cumulated log
// decay).  That overflows f32 once cs falls below about -88: the model
// clamps log_w at -e^2 = -7.39 a step, so a chunk can reach -473.  This
// kernel takes the sequential form of RWKV's own CUDA kernels instead:
// every exponent is one step's log_w <= 0, so nothing overflows.  A block
// of 4*D threads owns one (batch, head): thread (j, part) keeps the state
// entries S[i][j] for i = part, part+4, ... in registers (D/4 of them), so
// the per-step dot products split four ways and end in two shuffles.  r, k,
// exp(log_w) and v of 32 steps at a time are staged in shared memory with
// loads that run along D; the bonus sum_i r u k of each step is reduced
// once there per step, not once per column.  Ragged S is masked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParts = 4;              // threads sharing one value column
constexpr int kSteps = 32;             // time steps staged at once

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;                      // (H, D) contiguous
  float* y;                            // (B, S, H, D) contiguous
  long long st[4][3];                  // (batch, seq, head) element strides of r, k, v, lw
  int seq, heads;
};

__device__ __forceinline__ const float* at(const float* base,
                                           const long long* st, int b, int t,
                                           int h) {
  return base + b * st[0] + (long long)t * st[1] + h * st[2];
}

template <int D>
__global__ void __launch_bounds__(D * kParts)
wkv6_kernel(Args p) {
  constexpr int kThreadsT = D * kParts;
  constexpr int kRows = D / kParts;    // state entries per thread
  constexpr int kWarps = kThreadsT / 32;
  __shared__ float r_s[kSteps][D], k_s[kSteps][D], w_s[kSteps][D],
      v_s[kSteps][D];
  __shared__ float bonus_s[kSteps];
  __shared__ float u_s[D];

  const int tid = threadIdx.x;
  const int j = tid / kParts;          // value column
  const int part = tid % kParts;       // rows i = ii * kParts + part
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;

  if (tid < D) u_s[tid] = p.u[h * D + tid];
  float state[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) state[ii] = 0.f;

  for (int t0 = 0; t0 < p.seq; t0 += kSteps) {
    const int steps = min(kSteps, p.seq - t0);
    __syncthreads();                   // the previous tile is consumed
    for (int idx = tid; idx < kSteps * D; idx += kThreadsT) {
      const int t = idx / D, i = idx - (idx / D) * D;
      float rv = 0.f, kv = 0.f, vv = 0.f, lwv = 0.f;
      if (t < steps) {
        rv = __ldg(at(p.r, p.st[0], b, t0 + t, h) + i);
        kv = __ldg(at(p.k, p.st[1], b, t0 + t, h) + i);
        vv = __ldg(at(p.v, p.st[2], b, t0 + t, h) + i);
        lwv = __ldg(at(p.lw, p.st[3], b, t0 + t, h) + i);
      }
      r_s[t][i] = rv;
      k_s[t][i] = kv;
      v_s[t][i] = vv;
      w_s[t][i] = expf(lwv);
    }
    __syncthreads();
    // bonus_t = sum_i r_t[i] u[i] k_t[i], one warp per step
    for (int t = warp; t < kSteps; t += kWarps) {
      float s = 0.f;
      for (int i = lane; i < D; i += 32) s = fmaf(r_s[t][i] * u_s[i], k_s[t][i], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) bonus_s[t] = s;
    }
    __syncthreads();

    float* py = p.y + (((long long)b * p.seq + t0) * p.heads + h) * D + j;
    for (int t = 0; t < steps; ++t) {
      const float vj = v_s[t][j];
      float acc = 0.f;
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const int i = ii * kParts + part;
        const float s = state[ii];
        acc = fmaf(r_s[t][i], s, acc);
        state[ii] = fmaf(s, w_s[t][i], k_s[t][i] * vj);
      }
#pragma unroll
      for (int off = 1; off < kParts; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (part == 0) py[(long long)t * p.heads * D] = fmaf(bonus_s[t], vj, acc);
    }
  }
}

template <int D>
cudaError_t launch(const Args& p, int batch, cudaStream_t stream) {
  wkv6_kernel<D><<<dim3((unsigned)p.heads, (unsigned)batch), D * kParts, 0,
                   stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, log_w: f32 (batch, seq, heads, dim) with unit stride along dim
// and the given element strides (batch, seq, head) for each, in that order;
// u: f32 (heads, dim) contiguous; y: f32 (batch, seq, heads, dim)
// contiguous.  dim is 16, 32 or 64.  Returns a cudaError_t (0 = launched).
// Launches on `stream`, allocates nothing and does not synchronise.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* log_w, const void* u, void* y, int batch,
                        int seq, int heads, int dim,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.lw = static_cast<const float*>(log_w);
  p.u = static_cast<const float*>(u);
  p.y = static_cast<float*>(y);
  const long long st[4][3] = {{r_sb, r_ss, r_sh}, {k_sb, k_ss, k_sh},
                              {v_sb, v_ss, v_sh}, {w_sb, w_ss, w_sh}};
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < 3; ++c) p.st[a][c] = st[a][c];
  p.seq = seq;
  p.heads = heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 16: return (int)launch<16>(p, batch, s);
    case 32: return (int)launch<32>(p, batch, s);
    case 64: return (int)launch<64>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
