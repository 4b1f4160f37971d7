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
// What this design does about it: it never writes the (S x S) score matrix
// to device memory, skips the causal upper triangle tile by tile, and reads
// each K/V tile once per 64-row query tile.  For bf16 with head dims
// 32/64/128 (the main path: 128) both products run on the tensor cores with
// mma.sync m16n8k16 (f32 accumulate), FlashAttention-2 style: Q fragments
// and the output accumulator stay in registers, P goes from the score
// accumulator straight back into the tensor cores as bf16.  K/V tiles are
// double-buffered in shared memory with 16-byte cp.async copies, so the next
// tile loads while this one computes.  There is no TMA, wgmma or warp
// specialisation yet: that is later work.  Other shapes (f32, other head dims, unaligned rows) take a scalar
// path on the f32 FMA pipes, kept simple and far from the bound.
//
// Layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) with arbitrary batch / seq /
// head strides and a contiguous last dim; o (B, Sq, Hq, D) contiguous.  The
// reference's head flattening to (B*H, S, D) is replaced by strided indexing,
// so the wrapper copies nothing.  Ragged Sq / Sk edges are masked in the
// kernel, not padded.
//
// Blocks (both paths): one per (64-row query tile, b*Hq + h); 4 warps, each
// owning 16 query rows; KV tiles of 64 keys staged in shared memory.
// Scalar path: lane l scores keys l and l+32 for the warp's 16 rows (q read
// as a shared-memory broadcast); online softmax per row with warp shuffles;
// P goes through a per-warp shared buffer; lane l accumulates output
// columns l, l+32, ... (NC = ceil(D/32) of them) for all 16 rows.
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

// The tensor-core path takes bf16 with head dim 32/64/128 and every row of
// q/k/v/o starting on a 16-byte boundary.
bool mma_eligible(int dtype, int D, const void* q, const void* k, const void* v,
                  const void* o, const long long* st) {
  if (dtype != 1 || (D != 32 && D != 64 && D != 128)) return false;
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8 != 0) return false;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  return any % 16 == 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// strides (elements): q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
// the last dim of q/k/v is contiguous, o is (B, Sq, Hq, D) contiguous.
// Returns a cudaError_t (0 = launched).  Launches on `stream`, allocates
// nothing and does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   float scale, int causal, int dtype, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 8 || D > 256 || D % 8 != 0 || (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma_eligible(dtype, D, q, k, v, o, st)) {
    if (D == 32) return (int)launch_mma<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, scale, causal, s);
    if (D == 64) return (int)launch_mma<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, scale, causal, s);
    return (int)launch_mma<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, scale, causal, s);
  }
  if (dtype == 0) return (int)launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
