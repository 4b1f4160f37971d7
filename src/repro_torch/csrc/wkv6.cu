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
// published 67 TFLOP/s of f32 outside the tensor cores.  The chunked form
// below does about 3x the step form's multiply-adds, still on the FMA pipes.
//
// What the design does about it.  A step loop over S in one block per
// (batch, head) leaves the card idle: one head is one block.  So time is
// cut into chunks of kChunk = 64 steps, each a block, and the recurrence is
// split in three launches from the one C call:
//   (a) wkv6_chunk_kernel<D, false>, one block per (batch, head, chunk)
//       except the last: the chunk's state increment A_c (its scan from a
//       zero state) and its decay g_c = exp(sum of its log_w);
//   (b) wkv6_state_pass_kernel: S_{c+1} = g_c (.)rows S_c + A_c over the
//       chunks in order, one thread per (batch, head, state entry) -- the
//       D^2 entries' recurrences are independent;
//   (c) wkv6_chunk_kernel<D, true>, one block per (batch, head, chunk): the
//       same scan from the state entering the chunk, writing y.
// Three launches rather than one with decoupled look-back (as
// rglru_scan.cu does): the pass (b) is D^2 independent chains of at most
// S/64 multiply-adds, a few microseconds, and it needs no flags, no spin
// loops and no ordering of blocks.  The chunk states cost D^2 * 4 bytes
// written and read once each (16 KB a chunk at D = 64, a fifth of the
// inputs' and output's bytes); the wrapper allocates them.
//
// Inside a chunk, sub-chunks of kSub = 16 steps are walked in order with
// the state held in registers, a (D/16) x 4 tile a thread.
// With c the cumulated log decay local to the sub-chunk (inclusive), c' =
// c - log_w (exclusive) and c_L its last value:
//     y_t   = (r_t (.) e^{c'_t}) S  +  sum_{s<t} [sum_i r_t k_s e^{c'_t - c_s}] v_s
//             + (r_t . u (.) k_t) v_t
//     S_new = e^{c_L} (.)rows S  +  sum_s (k_s (.) e^{c_L - c_s}) v_s^T
// The first term is the off-diagonal part of the chunk factored through
// the sub-chunk's boundary; the second is the diagonal block, pairwise.
// Every exponent evaluated is <= 0 (later minus earlier cumulated decay,
// log_w <= 0), so nothing overflows whatever the decay: there is no
// exp(-cs) factor as in the TPU kernel's closed form, which overflows f32
// once a chunk's decay passes about -88 (the model's clamp allows -473 in
// 64 steps).  Ragged S is masked: steps past S read as zeros (log_w = 0
// keeps the state, k = 0 adds nothing) and write nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;             // steps per chunk (one block)
constexpr int kSub = 16;               // steps per sub-chunk
constexpr int kPassThreads = 256;

struct Args {
  const float* x[4];                   // r, k, v, log_w
  const float* u;                      // (H, D) contiguous
  float* y;                            // (B, S, H, D) contiguous
  float* states;                       // (B*H, n_chunks - 1, D, D)
  float* decay;                        // (B*H, n_chunks - 1, D)
  long long st[4][3];                  // (batch, seq, head) element strides of r, k, v, lw
  int seq, heads, n_chunks;
};

// Thread map of a chunk block, 4*D threads: thread (ri, cj) with
// cj = tid % (D/4) owning value columns 4cj..4cj+3 and ri = tid / (D/4) in
// 0..15 owning state rows ri*D/16 .. +D/16-1 (a (D/16) x 4 tile of S in
// registers) and, in the output phase, step ri of the sub-chunk.
template <int D, bool kOut>
__global__ void __launch_bounds__(4 * D, 3)  // three blocks an SM at D = 64
wkv6_chunk_kernel(Args p) {
  constexpr int NT = 4 * D;
  constexpr int CG = D / 4;            // column groups
  constexpr int RPT = D / 16;          // state rows per thread
  constexpr int P = D + 4;             // row pitch: rows start on distinct banks
  constexpr int LD = kSub * D / NT;    // elements of each input a thread loads
  __shared__ __align__(16) float rs[kSub][P], ks[kSub][P], vs[kSub][P], cl[kSub][P];
  __shared__ __align__(16) float rt[kSub][P], kh[kSub][P];
  __shared__ __align__(16) float Ss[kOut ? D : 1][D];
  __shared__ float a_s[kSub][kSub + 1];
  __shared__ float g_s[D], us[D];

  const int tid = threadIdx.x;
  const int cj = tid % CG, ri = tid / CG;
  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * p.heads + h;
  const int slots = p.n_chunks - 1;
  const int tc0 = chunk * kChunk;

  float st[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[r][c] = 0.f;
  if (kOut && chunk > 0) {
    const float* src = p.states + (bh * slots + chunk - 1) * D * D;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float4 s4 = *reinterpret_cast<const float4*>(src + (ri * RPT + r) * D + 4 * cj);
      st[r][0] = s4.x; st[r][1] = s4.y; st[r][2] = s4.z; st[r][3] = s4.w;
    }
  }
  if (kOut && tid < D) us[tid] = p.u[h * D + tid];
  float lsum = 0.f;                    // thread tid < D: the chunk's summed log_w of channel tid

  // next sub-chunk's inputs, prefetched into registers
  float pre[4][LD];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int e = 0; e < LD; ++e) {
      const int idx = tid + e * NT;
      const int t = idx / D, i = idx % D;
      const bool live = t0 + t < p.seq;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (!kOut && a == 0) { pre[a][e] = 0.f; continue; }  // r is unused without y
        pre[a][e] = live ? __ldg(p.x[a] + b * p.st[a][0] + (long long)(t0 + t) * p.st[a][1] +
                                 h * p.st[a][2] + i)
                         : 0.f;
      }
    }
  };
  fetch(tc0);

  for (int sub = 0; sub < kChunk / kSub; ++sub) {
    const int t0 = tc0 + sub * kSub;
    if (t0 >= p.seq) break;            // uniform over the block
    __syncthreads();                   // the previous sub-chunk's shared reads are done
#pragma unroll
    for (int e = 0; e < LD; ++e) {
      const int idx = tid + e * NT;
      const int t = idx / D, i = idx % D;
      rs[t][i] = pre[0][e];
      ks[t][i] = pre[1][e];
      vs[t][i] = pre[2][e];
      cl[t][i] = pre[3][e];
    }
    if (kOut) {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        *reinterpret_cast<float4*>(&Ss[ri * RPT + r][4 * cj]) =
            make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
    }
    if (sub + 1 < kChunk / kSub && t0 + kSub < p.seq) fetch(t0 + kSub);
    __syncthreads();
    if (tid < D) {                     // local inclusive cumsum of log_w, channel tid
      float c = 0.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        c += cl[t][tid];
        cl[t][tid] = c;
      }
      g_s[tid] = expf(c);              // c <= 0
      lsum += c;
    }
    __syncthreads();
    // decayed keys (and queries), all exponents <= 0
#pragma unroll
    for (int e = 0; e < LD; ++e) {
      const int idx = tid + e * NT;
      const int t = idx / D, i = idx % D;
      const float c = cl[t][i];
      kh[t][i] = ks[t][i] * expf(cl[kSub - 1][i] - c);
      if (kOut) rt[t][i] = rs[t][i] * expf(t > 0 ? cl[t - 1][i] : 0.f);
    }
    if (kOut) {                        // the diagonal block, pairwise, and the bonus
      // a pair s < t is split over two threads: (t, s) sums channels
      // [0, D/2) of its rotated order and the mirrored slot (15-t, 15-s),
      // above the diagonal, sums [D/2, D), so every thread has work
      for (int pr = tid; pr < kSub * kSub; pr += NT) {
        const int t = pr / kSub, s = pr % kSub;
        float acc = 0.f;
        if (s == t) {
#pragma unroll 8
          for (int i = 0; i < D; ++i) acc = fmaf(rs[t][i] * us[i], ks[t][i], acc);
        } else {
          const bool lo = s < t;
          const int tt = lo ? t : kSub - 1 - t, ss = lo ? s : kSub - 1 - s;
          const int i0 = (lo ? 0 : D / 2) + ss;  // rotated: a warp's 16 ss hit distinct banks
#pragma unroll 8
          for (int ii = 0; ii < D / 2; ++ii) {
            const int i = (i0 + ii) & (D - 1);
            acc = fmaf(rs[tt][i] * ks[ss][i], __expf(cl[tt - 1][i] - cl[ss][i]), acc);
          }
        }
        a_s[t][s] = acc;
      }
    }
    __syncthreads();
    if (kOut) {                        // y for step ri, columns 4cj..4cj+3
      const int t = ri;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int i = 0; i < D; i += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(&rt[t][i]);
        const float q[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 s4 = *reinterpret_cast<const float4*>(&Ss[i + e][4 * cj]);
          acc[0] = fmaf(q[e], s4.x, acc[0]);
          acc[1] = fmaf(q[e], s4.y, acc[1]);
          acc[2] = fmaf(q[e], s4.z, acc[2]);
          acc[3] = fmaf(q[e], s4.w, acc[3]);
        }
      }
      for (int s = 0; s <= t; ++s) {
        const float a = s < t ? a_s[t][s] + a_s[kSub - 1 - t][kSub - 1 - s] : a_s[t][t];
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[s][4 * cj]);
        acc[0] = fmaf(a, v4.x, acc[0]);
        acc[1] = fmaf(a, v4.y, acc[1]);
        acc[2] = fmaf(a, v4.z, acc[2]);
        acc[3] = fmaf(a, v4.w, acc[3]);
      }
      if (t0 + t < p.seq)
        *reinterpret_cast<float4*>(p.y + (((long long)b * p.seq + t0 + t) * p.heads + h) * D +
                                   4 * cj) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    // the state through the sub-chunk, in registers
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float g = g_s[ri * RPT + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) st[r][c] *= g;
    }
#pragma unroll 4
    for (int s = 0; s < kSub; ++s) {
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[s][4 * cj]);
      float kk[RPT];
      if constexpr (RPT == 4) {        // one 16-byte load of the thread's four rows
        const float4 k4 = *reinterpret_cast<const float4*>(&kh[s][ri * 4]);
        kk[0] = k4.x; kk[1] = k4.y; kk[2] = k4.z; kk[3] = k4.w;
      } else {
#pragma unroll
        for (int r = 0; r < RPT; ++r) kk[r] = kh[s][ri * RPT + r];
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        st[r][0] = fmaf(kk[r], v4.x, st[r][0]);
        st[r][1] = fmaf(kk[r], v4.y, st[r][1]);
        st[r][2] = fmaf(kk[r], v4.z, st[r][2]);
        st[r][3] = fmaf(kk[r], v4.w, st[r][3]);
      }
    }
  }

  if (!kOut) {                         // publish A_c and g_c (chunks before the last are full)
    float* dst = p.states + (bh * slots + chunk) * D * D;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      *reinterpret_cast<float4*>(dst + (ri * RPT + r) * D + 4 * cj) =
          make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
    if (tid < D) p.decay[(bh * slots + chunk) * D + tid] = expf(lsum);  // lsum <= 0
  }
}

// (b): in place, slot c goes from A_c to the state after chunk c.  One
// thread per (batch*head, state entry); loads of a batch of chunks are
// issued together, ahead of the dependent multiply-adds.
template <int D>
__global__ void __launch_bounds__(kPassThreads)
wkv6_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay, int slots,
                       int heads) {
  constexpr int kBatch = 8;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= D * D) return;
  const long long bh = (long long)blockIdx.z * heads + blockIdx.y;
  float* s = states + bh * slots * D * D + e;
  const float* g = decay + bh * slots * D + e / D;
  float acc = 0.f;
  for (int c0 = 0; c0 < slots; c0 += kBatch) {
    float a[kBatch], w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool live = c0 + j < slots;
      a[j] = live ? s[(long long)(c0 + j) * D * D] : 0.f;
      w[j] = live ? g[(long long)(c0 + j) * D] : 1.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      acc = fmaf(w[j], acc, a[j]);
      if (c0 + j < slots) s[(long long)(c0 + j) * D * D] = acc;
    }
  }
}

template <int D>
cudaError_t launch(const Args& p, int batch, cudaStream_t stream) {
  const dim3 per_chunk_rest((unsigned)(p.n_chunks - 1), (unsigned)p.heads, (unsigned)batch);
  if (p.n_chunks > 1) {
    wkv6_chunk_kernel<D, false><<<per_chunk_rest, 4 * D, 0, stream>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const dim3 pass((D * D + kPassThreads - 1) / kPassThreads, (unsigned)p.heads,
                    (unsigned)batch);
    wkv6_state_pass_kernel<D><<<pass, kPassThreads, 0, stream>>>(p.states, p.decay,
                                                                 p.n_chunks - 1, p.heads);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const dim3 per_chunk((unsigned)p.n_chunks, (unsigned)p.heads, (unsigned)batch);
  wkv6_chunk_kernel<D, true><<<per_chunk, 4 * D, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, log_w: f32 (batch, seq, heads, dim) with unit stride along dim
// and the given element strides (batch, seq, head) for each, in that order;
// u: f32 (heads, dim) contiguous; y: f32 (batch, seq, heads, dim)
// contiguous, 16-byte aligned.  states: f32 scratch of
// batch*heads*(n_chunks-1)*dim*dim and decay of batch*heads*(n_chunks-1)*dim
// elements (n_chunks = ceil(seq / 64); unused when it is 1), 16-byte
// aligned.  dim is 16, 32 or 64.  Returns a cudaError_t (0 = launched).
// Launches on `stream`, allocates nothing and does not synchronise.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* log_w, const void* u, void* y, void* states,
                        void* decay, int batch, int seq, int heads, int dim,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(states) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.x[0] = static_cast<const float*>(r);
  p.x[1] = static_cast<const float*>(k);
  p.x[2] = static_cast<const float*>(v);
  p.x[3] = static_cast<const float*>(log_w);
  p.u = static_cast<const float*>(u);
  p.y = static_cast<float*>(y);
  p.states = static_cast<float*>(states);
  p.decay = static_cast<float*>(decay);
  const long long st[4][3] = {{r_sb, r_ss, r_sh}, {k_sb, k_ss, k_sh},
                              {v_sb, v_ss, v_sh}, {w_sb, w_ss, w_sh}};
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < 3; ++c) p.st[a][c] = st[a][c];
  p.seq = seq;
  p.heads = heads;
  p.n_chunks = (seq + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 16: return (int)launch<16>(p, batch, s);
    case 32: return (int)launch<32>(p, batch, s);
    case 64: return (int)launch<64>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
