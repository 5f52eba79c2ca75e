// Flash attention forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _fa_kernel): online-softmax attention of q (B, Sq, Hq, D) against
// k, v (B, Sk, Hkv, D), with causal, sliding-window and chunked-local
// masks, a query position offset, GQA (query head h reads kv head
// h / (Hq / Hkv) in place, no repeat in memory), f32 accumulation and the
// reference's rules: masked scores are -1e30, whole tiles that no (q, k)
// pair can reach are skipped, keys past Sk are masked, and a row whose sum
// stayed 0 (every tile skipped) outputs 0.
//
// What bounds it on the H100: at the slice's prefill shape (4 x 512 tokens,
// 16 query heads, 2 kv heads, D = 128, causal) the work is about 4.3 GFLOP
// and the bytes about 18 MiB, so the tensor-core bound is ~4.3 us and the
// memory bound ~5.6 us. This first kernel does the products on the f32
// CUDA cores (67 TFLOP/s peak), so it is compute bound at ~64 us or more;
// wgmma with TMA-fed tiles is the later step that reaches the real bound.
//
// Design: one block of 4 warps per (batch x query head, 64-row query tile).
// A loop over 32-key tiles inside the block takes the place of the TPU
// grid's sequential "arbitrary" kv axis; the running max m, sum l and
// accumulator acc stay in registers in f32. Q, K and V tiles sit in shared
// memory as f32 (K rows padded so that each lane's 16-byte reads of its own
// key hit distinct banks). Each warp owns 16 query rows; for the scores a
// lane owns one key of the tile, so the row max and sum are warp shuffles,
// and for P.V a lane owns D/32 output columns and takes each p by shuffle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int RPW = BQ / NWARPS;    // query rows per warp
constexpr float MASKED = -1e30f;    // the reference's NEG_INF
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void load16(float* f, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load16(float* f, const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Copy `rows` rows of one head (row stride `stride` elements) into shared
// memory as f32 with row pitch `pitch`; rows at or past `limit` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src,
                                          size_t stride, int first, int rows,
                                          int limit) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int VPR = D / EPV;         // vectors per row
  for (int idx = threadIdx.x; idx < rows * VPR; idx += NWARPS * 32) {
    const int r = idx / VPR, c = (idx % VPR) * EPV;
    float f[EPV];
    if (first + r < limit) {
      load16(f, src + (size_t)(first + r) * stride + c);
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPV; ++e) dst[r * pitch + c + e] = f[e];
  }
}

// window < 0: no window; chunk <= 0: no chunk.
template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
              int Hq, int Hkv, float scale, int causal, int window, int chunk,
              int q_offset) {
  constexpr int KP = D + 4;                 // padded K row pitch (floats)
  constexpr int CPL = D >= 32 ? D / 32 : 1;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BQ x D
  float* ks = qs + BQ * D;                       // BK x KP
  float* vs = ks + BK * KP;                      // BK x D

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_tile0 = blockIdx.y * BQ;      // first query row of the tile
  const int q_start = q_tile0 + q_offset;   // its absolute position
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * RPW;

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * kv_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * Sk * kv_stride + (size_t)hk * D;

  load_tile<T, D>(qs, D, qb, q_stride, q_tile0, BQ, Sq);

  float m[RPW], l[RPW], acc[RPW][CPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k_start = j * BK;
    // Tile-level reachability, the reference's rule at this kernel's tiles;
    // it depends on block indices only, so the whole block agrees.
    bool needed = true;
    if (causal) needed = needed && k_start <= q_start + BQ - 1;
    if (window >= 0) needed = needed && (k_start + BK - 1) > (q_start - window);
    if (chunk > 0) {
      const int qc0 = q_start / chunk, qc1 = (q_start + BQ - 1) / chunk;
      const int kc0 = k_start / chunk, kc1 = (k_start + BK - 1) / chunk;
      needed = needed && max(qc0, kc0) <= min(qc1, kc1);
    }
    if (!needed) continue;

    __syncthreads();  // the previous tile is no longer read
    load_tile<T, D>(ks, KP, kb, kv_stride, k_start, BK, Sk);
    load_tile<T, D>(vs, D, vb, kv_stride, k_start, BK, Sk);
    __syncthreads();

    // Scores: this lane's key against the warp's 16 query rows.
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * KP);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = kr[d4];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(qs + (row0 + r) * D)[d4];
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    // Mask, then the online-softmax update, row by row.
    const int kpos = k_start + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q_start + row0 + r;
      bool ok = kpos < Sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window >= 0) ok = ok && (qpos - kpos) < window;
      if (chunk > 0) ok = ok && (qpos / chunk) == (kpos / chunk);
      const float sv = ok ? s[r] * scale : MASKED;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sv - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      s[r] = p;
    }

    // acc += P . V: lane owns columns (lane + 32 c) % D.
    for (int jj = 0; jj < BK; ++jj) {
      float vv[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) vv[c] = vs[jj * D + (lane + 32 * c) % D];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(FULL, s[r], jj);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[r][c] += pj * vv[c];
      }
    }
  }

  if (D < 32 && lane >= D) return;  // lanes that duplicate a column
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q_tile0 + row0 + r;
    if (qi >= Sq) continue;
    const float lr = l[r] == 0.f ? 1.f : l[r];  // fully skipped rows -> 0
    T* orow = o + ((size_t)b * Sq + qi) * q_stride + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) orow[(lane + 32 * c) % D] = from_f<T>(acc[r][c] / lr);
  }
}

template <typename T, int D>
int launch_t(const void* q, const void* k, const void* v, void* o, int B, int Sq,
             int Sk, int Hq, int Hkv, float scale, int causal, int window,
             int chunk, int q_offset, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * D + BK * (D + 4) + BK * D) * sizeof(float);
  auto kern = fa_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  kern<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int Sq,
             int Sk, int Hq, int Hkv, int D, float scale, int causal, int window,
             int chunk, int q_offset, cudaStream_t s) {
  switch (D) {
    case 16: return launch_t<T, 16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset, s);
    case 32: return launch_t<T, 32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset, s);
    case 64: return launch_t<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset, s);
    case 128: return launch_t<T, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); all contiguous, 16-byte
// aligned. dtype codes: 0 = float32, 1 = bfloat16. window < 0 and
// chunk <= 0 switch those masks off. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int Sq, int Sk, int Hq,
                                      int Hkv, int D, float scale, int causal,
                                      int window, int chunk, int q_offset,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, scale, causal, window, chunk, q_offset, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, scale, causal, window, chunk, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
