// Flash-attention forward for Hopper (sm_90a), plain C interface (ctypes).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bh /
// _flash_kernel (the Pallas TPU kernel, reached through
// src/repro/kernels/ops.py flash_attention): softmax(q k^T * scale) v with an
// online softmax over KV blocks, f32 running max / sum / accumulator, causal
// blocks above the diagonal skipped, GQA by reading KV head h // group.
// Semantics copied from the reference, not fixed: the causal mask is
// top-left aligned (key col <= query row) even when Sq != Sk.
//
// What bounds it on this card: operations.  At the main path's shape (2 x 16
// heads, S 2048, D 128, causal) the work is 34.4 GFLOP against 50.3 MB of
// q/k/v/o, far above the H100's ~295 flop/byte ridge; the bound is 34.7 us
// at the 989 TFLOP/s bf16 tensor-core peak.
//
// What the design does about it: it never writes the (S x S) score matrix
// to device memory and skips the causal upper triangle tile by tile.  Three
// paths, chosen by the caller (see flash_attention_fwd):
//   - wgmma (bf16, head dims 64/128; the main path: 128): the Hopper path
//     below, FlashAttention-3 style -- TMA loads of Q, K and V,
//     a producer warpgroup and two consumer warpgroups, both products on
//     wgmma, 128 query rows and 128 keys a tile, K/V in a 3-stage ring;
//   - mma (bf16, head dim 32): mma.sync m16n8k16, FlashAttention-2
//     style, K/V double-buffered by 16-byte cp.async, 64 query rows a block;
//   - scalar (f32, other head dims, unaligned rows): the f32 FMA pipes, kept
//     simple and far from the bound.
//
// Layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) with arbitrary batch / seq /
// head strides and a contiguous last dim; o (B, Sq, Hq, D) contiguous.  The
// reference's head flattening to (B*H, S, D) is replaced by strided indexing,
// so the wrapper copies nothing.  Ragged Sq / Sk edges are masked in the
// kernel, not padded.
//
// Blocks of the mma and scalar paths: one per (64-row query tile, b*Hq + h);
// 4 warps, each owning 16 query rows; KV tiles of 64 keys in shared memory.
// Scalar path: lane l scores keys l and l+32 for the warp's 16 rows (q read
// as a shared-memory broadcast); online softmax per row with warp shuffles;
// P goes through a per-warp shared buffer; lane l accumulates output
// columns l, l+32, ... (NC = ceil(D/32) of them) for all 16 rows.
#include <cuda.h>  // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kWarps = 4;
constexpr int kRW = kBQ / kWarps;  // query rows per warp
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Row padding of the K tile so that lanes reading the same column of
// different rows hit different banks (rows of D+pad elements).
template <typename T> __host__ __device__ constexpr int k_pad() { return sizeof(T) == 4 ? 1 : 2; }

template <typename T>
size_t smem_bytes(int d) {
  const size_t elems = (size_t)kBK * (d + k_pad<T>()) + (size_t)kBK * d + (size_t)kBQ * d;
  return elems * sizeof(T) + sizeof(float) * kWarps * kRW * kBK;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Hq, int Hkv, int Sq, int Sk, int D,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 float scale, int causal) {
  extern __shared__ float4 smem_f4[];
  const int KS = D + k_pad<T>();
  T* Ks = reinterpret_cast<T*>(smem_f4);   // [kBK][KS]
  T* Vs = Ks + kBK * KS;                   // [kBK][D]
  T* Qs = Vs + kBK * D;                    // [kBQ][D]
  float* Ps = reinterpret_cast<float*>(Qs + kBQ * D);  // [kWarps][kRW][kBK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);           // GQA: KV head of query head h
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const T zero = from_f32<T>(0.f);

  for (int idx = tid; idx < kBQ * D; idx += kWarps * 32) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = q0 + r;
    Qs[idx] = row < Sq ? qb[(long long)row * q_ss + c] : zero;
  }

  float m[kRW], l[kRW], acc[kRW][NC];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);  // skip tiles above the diagonal
  const int rbase = warp * kRW;
  float* Pw = Ps + warp * kRW * kBK;
  const T* qrows = Qs + rbase * D;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = tid; idx < kBK * D; idx += kWarps * 32) {
      const int j = idx / D;
      const int c = idx - j * D;
      const int key = k0 + j;
      const bool live = key < Sk;
      Ks[j * KS + c] = live ? kb[(long long)key * k_ss + c] : zero;
      Vs[j * D + c] = live ? vb[(long long)key * v_ss + c] : zero;
    }
    __syncthreads();

    // scores: lane owns keys k0+lane and k0+lane+32 for the warp's rows
    float sa[kRW], sb[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) { sa[r] = 0.f; sb[r] = 0.f; }
    const T* ka_row = Ks + lane * KS;
    const T* kb_row = Ks + (lane + 32) * KS;
    for (int c = 0; c < D; ++c) {
      const float ka = to_f32(ka_row[c]);
      const float kbv = to_f32(kb_row[c]);
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float qv = to_f32(qrows[r * D + c]);
        sa[r] = fmaf(qv, ka, sa[r]);
        sb[r] = fmaf(qv, kbv, sb[r]);
      }
    }

    // online softmax, one row at a time across the warp
    const int ca = k0 + lane;
    const int cb = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int row = q0 + rbase + r;
      float xa = sa[r] * scale;
      float xb = sb[r] * scale;
      if (ca >= Sk || (causal && ca > row)) xa = kNegInf;
      if (cb >= Sk || (causal && cb > row)) xb = kNegInf;
      float mx = fmaxf(xa, xb);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float pa = expf(xa - m_new);
      const float pb = expf(xb - m_new);
      const float corr = expf(m[r] - m_new);
      float sum = pa + pb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] *= corr;
      Pw[r * kBK + lane] = pa;
      Pw[r * kBK + lane + 32] = pb;
    }
    __syncwarp();

    // acc += P @ V: lane owns output columns lane, lane+32, ...
    const int jmax = min(kBK, Sk - k0);
    for (int j = 0; j < jmax; ++j) {
      float vv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        vv[i] = c < D ? to_f32(Vs[j * D + c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float p = Pw[r * kBK + j];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int row = q0 + rbase + r;
    if (row >= Sq) continue;  // ragged Sq edge
    const float den = fmaxf(l[r], 1e-37f);
    T* orow = o + (((long long)b * Sq + row) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < D) orow[c] = from_f32<T>(acc[r][i] / den);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* o, int B,
                      int Hq, int Hkv, int Sq, int Sk, int D, const long long* st,
                      float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  flash_fwd_kernel<T, NC><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Sk, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                   int Hkv, int Sq, int Sk, int D, const long long* st, float scale,
                   int causal, cudaStream_t s) {
  switch ((D + 31) / 32) {
    case 1: return launch_nc<T, 1>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
    case 2: return launch_nc<T, 2>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
    case 3: return launch_nc<T, 3>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
    case 4: return launch_nc<T, 4>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
    case 5: return launch_nc<T, 5>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
    case 6: return launch_nc<T, 6>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
    case 7: return launch_nc<T, 7>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
    case 8: return launch_nc<T, 8>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// Tensor-core path: bf16, head dims 32 / 64 / 128, 16-byte aligned rows.
// mma.sync m16n8k16 (bf16 in, f32 accumulate), FlashAttention-2 style: each
// warp keeps its 16 query rows' Q fragments and f32 output accumulator in
// registers; S = Q K^T and O += P V run on the tensor cores, with K and V
// fragments read from shared memory by ldmatrix (V transposed on the way).
// The softmax runs in the log2 domain on the S accumulator fragments, and P
// goes back into the tensor cores as bf16 without passing through memory.
// ---------------------------------------------------------------------------

constexpr int kPadM = 8;  // smem row padding (16 bytes): ldmatrix rows hit distinct banks

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 16-byte global -> shared copy that bypasses registers (cp.async); with
// `valid` false it writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start copying rows [row0, row0+64) of a (rows, HD) bf16 matrix with row
// stride `stride` into shared memory (row pitch HD + kPadM); rows >= n_valid
// become zeros.
template <int HD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long stride, int row0, int n_valid,
                                                int tid) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < 64 * kChunks; idx += kWarps * 32) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const bool valid = row0 + r < n_valid;
    cp_async16(dst + r * (HD + kPadM) + c,
               valid ? src + (long long)(row0 + r) * stride + c : src, valid);
  }
}

// Q tile plus two stages of K and V tiles
template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kBQ + 4 * kBK) * (HD + kPadM);
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int Hq, int Hkv, int Sq, int Sk,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     float scale_log2, int causal) {
  extern __shared__ float4 smem_f4[];
  constexpr int LD = HD + kPadM;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_f4);  // [kBQ][LD]
  __nv_bfloat16* Kst = Qs + kBQ * LD;                              // [2][kBK][LD]
  __nv_bfloat16* Vst = Kst + 2 * kBK * LD;                         // [2][kBK][LD]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  // heaviest causal query tiles first, so the short ones fill the tail
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBQ;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  // stage 0: Q and the first K/V tile in flight together
  load_tile_async<HD>(Qs, qb, q_ss, q0, Sq, tid);
  load_tile_async<HD>(Kst, kb, k_ss, 0, Sk, tid);
  load_tile_async<HD>(Vst, vb, v_ss, 0, Sk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);

  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's two rows
  const int row1 = row0 + 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const __nv_bfloat16* Ks = Kst + (t & 1) * kBK * LD;
    const __nv_bfloat16* Vs = Vst + (t & 1) * kBK * LD;
    if (t + 1 < n_tiles) {  // next tile into the other stage while this one computes
      load_tile_async<HD>(Kst + ((t + 1) & 1) * kBK * LD, kb, k_ss, k0 + kBK, Sk, tid);
      load_tile_async<HD>(Vst + ((t + 1) & 1) * kBK * LD, vb, v_ss, k0 + kBK, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread

    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 32; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        unsigned bf[4];
        ldmatrix_x4(bf, Ks + (nt * 8 + (lane & 7)) * LD + kk * 32 + (lane >> 3) * 8);
        mma_bf16(s[nt], qf[2 * kk], bf[0], bf[1]);
        mma_bf16(s[nt], qf[2 * kk + 1], bf[2], bf[3]);
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + nt * 8 + 2 * t4 + e;
        float x0 = s[nt][e] * scale_log2;
        float x1 = s[nt][2 + e] * scale_log2;
        if (col >= Sk || (causal && col > row0)) x0 = kNegInf;
        if (col >= Sk || (causal && col > row1)) x1 = kNegInf;
        s[nt][e] = x0;
        s[nt][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0);
    const float c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mn0);
        s[nt][2 + e] = exp2f(s[nt][2 + e] - mn1);
        sum0 += s[nt][e];
        sum1 += s[nt][2 + e];
      }
    }
    l0 = l0 * c0 + sum0;  // per-thread partial sums; the row's 4 lanes
    l1 = l1 * c1 + sum1;  // share m, so they are added up at the end
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= c0;
      acc[dt][1] *= c0;
      acc[dt][2] *= c1;
      acc[dt][3] *= c1;
    }

#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {  // 16 keys per step: S fragments -> P (A operand)
      const unsigned pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned bf[4];
        ldmatrix_x4_trans(bf, Vs + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-37f);
  const float den1 = fmaxf(l1, 1e-37f);
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int col = dt * 8 + 2 * t4;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (((long long)b * Sq + row0) * Hq + h) * HD + col) =
          __floats2bfloat162_rn(acc[dt][0] / den0, acc[dt][1] / den0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (((long long)b * Sq + row1) * Hq + h) * HD + col) =
          __floats2bfloat162_rn(acc[dt][2] / den1, acc[dt][3] / den1);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                       int Hkv, int Sq, int Sk, const long long* st, float scale, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  flash_fwd_mma_kernel<HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

// bf16 with every (batch, seq, head) stride a multiple of 8 elements (16
// bytes) and every base pointer 16-byte aligned: what 16-byte cp.async and
// TMA need.
bool bf16_aligned16(int dtype, const void* q, const void* k, const void* v, const void* o,
                    const long long* st) {
  if (dtype != 1) return false;
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8 != 0) return false;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  return any % 16 == 0;
}

// The mma.sync path takes what the Hopper path does not among aligned bf16
// inputs: head dim 32.
bool mma_eligible(int dtype, int D, const void* q, const void* k, const void* v,
                  const void* o, const long long* st) {
  return D == 32 && bf16_aligned16(dtype, q, k, v, o, st);
}



// ---------------------------------------------------------------------------
// Hopper path: bf16, head dims 64 / 128, 16-byte strides and alignment.
// FlashAttention-3 style: warp-specialised blocks of three warpgroups and
// 128 query rows.  Warpgroup 0 is the producer: one thread issues TMA loads
// of the Q tile and of K/V tiles of 128 keys into a ring of 3 stages (4 at
// head dim 64), each
// stage with "full" mbarriers (K and V apart, so S = Q K^T starts before V
// lands) and an "empty" one.  Warpgroups 1 and 2 are consumers, 64 query
// rows each: S = Q K^T on wgmma m64n128k16 with both operands in shared
// memory, the online softmax (log2 domain) on the accumulator fragments,
// then O += P V on wgmma with P kept in registers as the A operand (the
// m64nNk16 accumulator layout is the A-register layout) and V read from
// shared memory through B's transpose bit (V is MN-major for this product).
// A consumer waits for each of its products; the two consumers' products
// and softmaxes interleave on the SM.  (Overlapping a consumer's softmax
// with its own next S = Q K^T, FlashAttention-3's intra-warpgroup
// pipelining, needs the S, P and O fragments live at once: built so, ptxas
// reported 168 registers a thread, spills and wgmmas serialised for want
// of registers (C7512), and it measured slower.)
// setmaxnreg gives the producer 24 registers and the consumers 240.
//
// Tiles arrive by 4-D TMA over (D, H, S, B) with the tensors' own byte
// strides, so strided heads of a fused projection load in place; rows past
// Sq / Sk are zero-filled by TMA and the score mask still applies.  The
// 128-byte swizzle caps a box's inner extent at 64 bf16, so a row of head
// dim 128 arrives as two boxes of (rows x 128 B); the wgmma descriptors walk
// them as two K blocks (S = Q K^T) or two 64-wide N blocks (O += P V, the
// descriptor's leading byte offset).  Each box is 1024-byte aligned, so the
// swizzle's 8-row atoms line up with the descriptors' (base offset 0).
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;            // query rows per block (64 per consumer)
constexpr int kWgBN = 128;            // keys per K/V tile
constexpr int kWgThreads = 384;       // producer + two consumer warpgroups
constexpr int kBox = 64;              // bf16 per box row (128 bytes: the swizzle's width)
constexpr int kTileBoxBytes = 128 * kBox * 2;  // 128 rows x 128 B
constexpr long long kSpinLimit = 1LL << 22;    // a real wait is microseconds

template <int HD>
struct WgSmem {
  static constexpr int kNB = HD / kBox;                   // boxes per row
  static constexpr int kTile = kNB * kTileBoxBytes;       // Q, K or V tile
  // K/V stages: as many as fit beside Q (3 at head dim 128: 224 KB)
  static constexpr int kStages = HD == 128 ? 3 : 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;                   // [stage]
  static constexpr int kV = kK + kStages * kTile;         // [stage]
  static constexpr int kBar = kV + kStages * kTile;       // mbarriers
  // q_full, k_full[kStages], v_full[kStages], kv_empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;            // slack to align the base
};

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
// Wait until the barrier's phase differs from `parity`; traps (a launch
// error, not a hang) if it never does.
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (+)= a (64 x 16, shared, K-major) * b (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += a (64 x 16, registers) * b (16 x 128, shared, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a (64 x 16, registers) * b (16 x 64, shared, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq, int Sk,
                       float scale_log2, int causal) {
  using L = WgSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar = base + L::kBar;
  const uint32_t q_full = bar;
  constexpr int kStages = L::kStages;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + kStages + s); };
  auto kv_empty = [&](int s) { return bar + 8u * (1 + 2 * kStages + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  // heaviest causal query tiles first: blocks start in order of blockIdx.y
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kWgBM;
  int n_tiles = (Sk + kWgBN - 1) / kWgBN;
  if (causal) n_tiles = min(n_tiles, (q0 + kWgBM - 1) / kWgBN + 1);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(kv_empty(s), 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int nb = 0; nb < L::kNB; ++nb)
        tma_load_4d(base + L::kQ + nb * kTileBoxBytes, &tm_q, q_full, nb * kBox, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        mbar_wait(kv_empty(s), ph ^ 1);  // first pass: the stage starts empty
        mbar_expect_tx(k_full(s), L::kTile);
        for (int nb = 0; nb < L::kNB; ++nb)
          tma_load_4d(base + L::kK + s * L::kTile + nb * kTileBoxBytes, &tm_k, k_full(s),
                      nb * kBox, hk, j * kWgBN, b);
        mbar_expect_tx(v_full(s), L::kTile);
        for (int nb = 0; nb < L::kNB; ++nb)
          tma_load_4d(base + L::kV + s * L::kTile + nb * kTileBoxBytes, &tm_v, v_full(s),
                      nb * kBox, hk, j * kWgBN, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                 // consumer index
    const int ltid = tid - 128 * wg;       // thread in the warpgroup
    const int warp = ltid / 32, lane = ltid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread's two rows
    const int row1 = row0 + 8;
    const int rmin = q0 + cw * 64;                  // the warpgroup's first row

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    const uint32_t q_addr = base + L::kQ + cw * 64 * 128;
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const int k0 = j * kWgBN;
      const uint32_t k_addr = base + L::kK + s * L::kTile;
      const uint32_t v_addr = base + L::kV + s * L::kTile;

      float sc[64];                        // S: 64 rows x 128 keys over the warpgroup
      mbar_wait(k_full(s), ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t koff = (kk / 4) * kTileBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, wg_desc(q_addr + koff, 16, 1024), wg_desc(k_addr + koff, 16, 1024),
                      kk > 0);
      }
      wg_commit();
      wg_wait<0>();

      // scale into the log2 domain; mask only where the tile crosses the
      // diagonal or the ragged key edge (uniform over the warpgroup)
      const bool edge = k0 + kWgBN > Sk || (causal && k0 + kWgBN - 1 > rmin);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = sc[4 * nt + e] * scale_log2;
          float x1 = sc[4 * nt + 2 + e] * scale_log2;
          if (edge) {
            const int col = k0 + nt * 8 + 2 * t4 + e;
            if (col >= Sk || (causal && col > row0)) x0 = kNegInf;
            if (col >= Sk || (causal && col > row1)) x1 = kNegInf;
          }
          sc[4 * nt + e] = x0;
          sc[4 * nt + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - mn0);
      const float c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pa[32];                     // P as bf16 pairs: the A fragments of 8 k16 steps
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const float p00 = exp2f(sc[4 * nt] - mn0), p01 = exp2f(sc[4 * nt + 1] - mn0);
        const float p10 = exp2f(sc[4 * nt + 2] - mn1), p11 = exp2f(sc[4 * nt + 3] - mn1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        pa[2 * nt] = pack_bf16(p00, p01);      // row g,   keys 8nt + 2t4 ..
        pa[2 * nt + 1] = pack_bf16(p10, p11);  // row g+8
      }
      l0 = l0 * c0 + sum0;  // per-thread partial sums; the row's 4 lanes
      l1 = l1 * c1 + sum1;  // share m, so they are added up at the end
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        acc[4 * dt] *= c0;
        acc[4 * dt + 1] *= c0;
        acc[4 * dt + 2] *= c1;
        acc[4 * dt + 3] *= c1;
      }

      mbar_wait(v_full(s), ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBN / 16; ++kk) {
        // keys 16kk..16kk+15: n8 blocks 2kk (a0, a1) and 2kk+1 (a2, a3)
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_pv<HD>(acc, a, wg_desc(v_addr + kk * 16 * 128, kTileBoxBytes, 1024));
      }
      wg_commit();
      wg_wait<0>();
      mbar_arrive(kv_empty(s));            // this stage may be refilled
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-37f);
    const float inv1 = 1.f / fmaxf(l1, 1e-37f);
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int col = dt * 8 + 2 * t4;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o + (((long long)b * Sq + row0) * Hq + h) * HD + col) =
            __floats2bfloat162_rn(acc[4 * dt] * inv0, acc[4 * dt + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o + (((long long)b * Sq + row1) * Hq + h) * HD + col) =
            __floats2bfloat162_rn(acc[4 * dt + 2] * inv1, acc[4 * dt + 3] * inv1);
    }
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
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 4-D map over (D, H, S, B) of a bf16 (B, S, H, D) tensor with element
// strides (sb, ss, sh, 1); boxes of (64, 1, 128, 1), 128-byte swizzle,
// zeros out of bounds.
bool encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, long long sb,
                 long long ss, long long sh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, 128, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                         int Hkv, int Sq, int Sk, const long long* st, float scale, int causal,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(&tq, q, B, Sq, Hq, HD, st[0], st[1], st[2]) ||
      !encode_bshd(&tk, k, B, Sk, Hkv, HD, st[3], st[4], st[5]) ||
      !encode_bshd(&tv, v, B, Sk, Hkv, HD, st[6], st[7], st[8]))
    return cudaErrorInvalidValue;
  constexpr int smem = WgSmem<HD>::kAlloc;
  // set on every call: the attribute belongs to the current device
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(B * Hq, (Sq + kWgBM - 1) / kWgBM);
  flash_fwd_wgmma_kernel<HD><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Sk,
      scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

// The Hopper path takes aligned bf16 with head dim 64/128.
bool wgmma_eligible(int dtype, int D, const void* q, const void* k, const void* v,
                    const void* o, const long long* st) {
  return (D == 64 || D == 128) && bf16_aligned16(dtype, q, k, v, o, st);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// path codes: 0 = scalar (f32 FMA pipes; any head dim that is a multiple of
// 8 up to 256), 1 = mma (mma.sync; bf16, head dim 32), 2 = wgmma
// (TMA + wgmma, warp-specialised; bf16, head dim 64/128).  The caller picks
// the path (repro_torch.kernels.flash_attention.select_path); a path asked
// for on inputs it cannot take is an error, never a quiet switch.
// strides (elements): q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
// the last dim of q/k/v is contiguous, o is (B, Sq, Hq, D) contiguous.
// Returns a cudaError_t (0 = launched).  Launches on `stream`, allocates
// nothing and does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   float scale, int causal, int dtype, int path,
                                   void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 8 || D > 256 || D % 8 != 0 || (long long)B * Hq > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    if (!wgmma_eligible(dtype, D, q, k, v, o, st)) return (int)cudaErrorInvalidValue;
    if (D == 64) return (int)launch_wgmma<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, scale, causal, s);
    return (int)launch_wgmma<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, scale, causal, s);
  }
  if (path == 1) {
    if (!mma_eligible(dtype, D, q, k, v, o, st)) return (int)cudaErrorInvalidValue;
    return (int)launch_mma<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, scale, causal, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
  return (int)launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
}

// Encodes the wgmma path's three tensor maps (q, k, v) `reps` times and
// launches nothing: the host cost of the encoding alone, for measurement.
// Arguments as flash_attention_fwd's.  Returns 0, or cudaErrorInvalidValue
// if an encoding fails.
extern "C" int flash_attention_encode_maps(const void* q, const void* k, const void* v,
                                           int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                           long long q_sb, long long q_ss, long long q_sh,
                                           long long k_sb, long long k_ss, long long k_sh,
                                           long long v_sb, long long v_ss, long long v_sh,
                                           int reps) {
  CUtensorMap tq, tk, tv;
  for (int i = 0; i < reps; ++i)
    if (!encode_bshd(&tq, q, B, Sq, Hq, D, q_sb, q_ss, q_sh) ||
        !encode_bshd(&tk, k, B, Sk, Hkv, D, k_sb, k_ss, k_sh) ||
        !encode_bshd(&tv, v, B, Sk, Hkv, D, v_sb, v_ss, v_sh))
      return (int)cudaErrorInvalidValue;
  return 0;
}
