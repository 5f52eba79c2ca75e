// Flash attention forward for Hopper (sm_90a): bf16, head dim 64 or 128,
// wgmma products on TMA-loaded tiles.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _fa_kernel) for bf16 inputs with head dim 64 or 128; f32 inputs and
// the other head dims take the SIMT kernel of flash_attention.cu. It
// computes what that kernel computes, with the same rules: q (B, Sq, Hq, D)
// against k, v (B, Sk, Hkv, D); causal, sliding-window and chunked-local
// masks and a query position offset; keys past Sk masked; masked scores are
// -1e30 (the running max starts at -inf, so a tile whose scores are all
// masked adds weight only while no real score has been seen); a whole KV
// tile is skipped when no (q, k) pair of the block's query rows and the
// tile's keys can be reached; a row whose sum stayed 0 outputs 0; query
// head h reads kv head h / (Hq / Hkv) in place.
//
// What bounds it on the H100: at the dense prefill shape (4 x 512 tokens,
// 16 query heads, 2 kv heads, D = 128, causal) the causal products are
// 4.3 GFLOP, 4.4 us at 989 TFLOP/s of bf16 tensor-core rate, and the bytes
// (q, k, v read once, o written once) 17.8 MB, 5.3 us at 3.35 TB/s: the
// bound is ~5.3 us, bytes by a little. The first kernel did its products
// on the f32 CUDA cores (~13 TFLOP/s reached, 0.32 ms). This one puts both
// products on the tensor cores and keeps every byte it reads in shared
// memory for the whole query tile, so what is left is latency: too few
// blocks (4 x 16 heads x 4 query tiles = 256 for 132 SMs) and the causal
// imbalance between query tiles.
//
// Design: one block per (batch x query head, 128-row query tile): two
// consumer warpgroups of 64 query rows each and one producer warp. The
// producer loads the block's Q tile once and then each needed KV tile of
// 128 keys by TMA (a K box and a V box of 64 head-dim values x 128 keys per
// 64 columns of D, 128-byte swizzled) into a ring of 2 stages, each stage
// with a K and a V "full" mbarrier (the transaction bytes) and an "empty"
// mbarrier the 256 consumer threads arrive on. A consumer warpgroup:
//   S = Q K^T   wgmma m64n128k16, Q and K from shared memory, both K-major
//               (D contiguous), D / 16 steps;
//   softmax     mask, then the online update in f32 registers on the
//               accumulator fragments, in base 2 with the scale folded in
//               (one multiply a score); row max and sum over the 4 lanes
//               that share a row;
//   O += P V    wgmma m64nDk16 with P from registers: the f32 score
//               fragment, rounded to bf16 pairs, is already the A-operand
//               layout of a 64 x 16 slice. V (keys, D) is D-contiguous, so
//               B is MN-major: transpose mode, with the stride between the
//               two 64-wide D boxes as the descriptor's leading offset.
// Epilogue: 1 / l (l == 0 -> 1), bf16, stored as pairs, rows past Sq not
// stored. TMA fills rows past Sq and keys past Sk with zeros. Query tiles
// run heaviest first (causal tiles near the end of the sequence have the
// most KV tiles).
#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128;              // query rows per block: two warpgroups of 64
constexpr int BK = 128;              // keys per KV tile
constexpr int STAGES = 2;            // KV tiles in flight
constexpr int BOX = 64;              // bf16 in one 128-byte swizzled box row
constexpr float MASKED = -1e30f;     // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// A block: two consumer warpgroups of 64 query rows and one producer warp;
// head dim D.
template <int D_>
struct Cfg {
  static constexpr int D = D_;
  static constexpr int NCONSUMER = 256;
  static constexpr int NTHREADS = NCONSUMER + 32;
  static constexpr int NDC = D / BOX;                // 64-wide boxes across a row
  static constexpr int Q_BYTES = NDC * BQ * 128;     // the block's Q tile
  static constexpr int KV_BYTES = NDC * BK * 128;    // one K (or V) tile
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Can any query position in [q_lo, q_hi] reach any key of the tile
// [k_lo, k_lo + BK)? The reference's rule, at this kernel's tile sizes; it
// depends on block indices only, so the producer and the consumers agree.
__device__ __forceinline__ bool tile_needed(int k_lo, int q_lo, int q_hi, int causal, int window,
                                            int chunk) {
  const int k_hi = k_lo + BK - 1;
  bool need = true;
  if (causal) need = need && k_lo <= q_hi;
  if (window >= 0) need = need && k_hi > q_lo - window;
  if (chunk > 0) need = need && max(q_lo / chunk, k_lo / chunk) <= min(q_hi / chunk, k_hi / chunk);
  return need;
}

// O += P V for one 16-key step (N = D, V MN-major).
template <int N>
__device__ __forceinline__ void rs_step(float (&d)[N / 2], const uint32_t (&p)[4], uint64_t b);
template <>
__device__ __forceinline__ void rs_step<64>(float (&d)[32], const uint32_t (&p)[4], uint64_t b) {
  wgmma_m64n64k16_rs<1>(d, p, b, 1);
}
template <>
__device__ __forceinline__ void rs_step<128>(float (&d)[64], const uint32_t (&p)[4], uint64_t b) {
  wgmma_m64n128k16_rs<1>(d, p, b, 1);
}

// window < 0: no window; chunk <= 0: no chunk. scale_log2 = scale * log2(e).
template <class C>
__global__ void __launch_bounds__(C::NTHREADS, 1)
fa_sm90_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int Sq,
               int Sk, int Hq, int Hkv, float scale_log2, int causal, int window, int chunk,
               int q_offset) {
  constexpr int D = C::D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ks = qs + C::Q_BYTES;
  uint8_t* vs = ks + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_tile0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int q_lo = q_offset + q_tile0;
  const int q_hi = q_offset + min(q_tile0 + BQ, Sq) - 1;
  const int nk = (Sk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], C::NCONSUMER);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::NCONSUMER) {
    // ---- producer warp: one thread issues every TMA load
    if (threadIdx.x == C::NCONSUMER) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NDC; ++c)
        tma_load_4d(qs + c * BQ * 128, &qmap, q_full, c * BOX, h, q_tile0, b);
      int it = 0;
      for (int j = 0; j < nk; ++j) {
        if (!tile_needed(j * BK, q_lo, q_hi, causal, window, chunk)) continue;
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NDC; ++c)
          tma_load_4d(ks + s * C::KV_BYTES + c * BK * 128, &kmap, &k_full[s], c * BOX, hk,
                      j * BK, b);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NDC; ++c)
          tma_load_4d(vs + s * C::KV_BYTES + c * BK * 128, &vmap, &v_full[s], c * BOX, hk,
                      j * BK, b);
        ++it;
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows 64 wg .. 64 wg + 63 of the query tile
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = 64 * wg + 16 * warp + lane / 4;   // tile row of values 4j, 4j+1 (+8: 4j+2, 4j+3)
  const int col0 = 2 * (lane % 4);                    // tile column of value 0
  const uint8_t* q_wg = qs + wg * 64 * 128;

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  int it = 0;
  for (int j = 0; j < nk; ++j) {
    const int k_lo = j * BK;
    if (!tile_needed(k_lo, q_lo, q_hi, causal, window, chunk)) continue;
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const uint8_t* kt = ks + s * C::KV_BYTES;
    const uint8_t* vt = vs + s * C::KV_BYTES;

    // S = Q K^T
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    mbar_wait(&k_full[s], phase);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int qoff = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      const int koff = (kk / 4) * BK * 128 + (kk % 4) * 32;
      wgmma_m64n128k16_ss<0>(sc, desc_sw128(q_wg + qoff, 16, 1024),
                             desc_sw128(kt + koff, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Mask (only tiles where some pair can be masked), then the online
    // softmax in base 2.
    const bool whole = k_lo + BK <= Sk && (!causal || k_lo + BK - 1 <= q_lo) && window < 0 &&
                       chunk <= 0;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (!whole) {
        const int kpos = k_lo + 8 * (i / 4) + col0 + (i % 2);
        const int qpos = q_lo + row0 + 8 * ((i / 2) % 2);
        bool ok = kpos < Sk;
        if (causal) ok = ok && qpos >= kpos;
        if (window >= 0) ok = ok && (qpos - kpos) < window;
        if (chunk > 0) ok = ok && (qpos / chunk) == (kpos / chunk);
        if (!ok) x = MASKED;
      }
      sc[i] = x;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = ex2(sc[i] - m[(i / 2) % 2]);
      sc[i] = p;
      rsum[(i / 2) % 2] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];   // this thread's columns
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i / 2) % 2];

    // P as bf16 A fragments: 16-key step kk is values 8 kk .. 8 kk + 7.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) pa[kk][q] = pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
    }

    // O += P V
    mbar_wait(&v_full[s], phase);
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      rs_step<D>(o_acc, pa[kk], desc_sw128(vt + kk * 2048, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    mbar_arrive(&empty[s]);
    ++it;
  }

  // Epilogue: the row sums over the 4 lanes of a row, 1 / l, bf16 pairs.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);   // fully skipped rows -> 0
  }
  const size_t row_stride = (size_t)Hq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q_tile0 + row0 + 8 * r;
    if (qi < Sq) {
      __nv_bfloat16* orow = o + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int i = 4 * jb + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jb + col0) =
            __floats2bfloat162_rn(o_acc[i] * inv[r], o_acc[i + 1] * inv[r]);
      }
    }
  }
}

template <class C>
int launch_cfg(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
               int Hq, int Hkv, float scale, int causal, int window, int chunk, int q_offset,
               cudaStream_t stream) {
  constexpr int D = C::D;
  CUtensorMap qm, km, vm;
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t qdims[4] = {(uint64_t)D, (uint64_t)Hq, (uint64_t)Sq, (uint64_t)B};
  const uint64_t qstr[3] = {D * e, (uint64_t)Hq * D * e, (uint64_t)Sq * Hq * D * e};
  const uint32_t qbox[4] = {BOX, 1, BQ, 1};
  const uint64_t kdims[4] = {(uint64_t)D, (uint64_t)Hkv, (uint64_t)Sk, (uint64_t)B};
  const uint64_t kstr[3] = {D * e, (uint64_t)Hkv * D * e, (uint64_t)Sk * Hkv * D * e};
  const uint32_t kbox[4] = {BOX, 1, BK, 1};
  int err = encode_bf16(&qm, q, 4, qdims, qstr, qbox);
  if (!err) err = encode_bf16(&km, k, 4, kdims, kstr, kbox);
  if (!err) err = encode_bf16(&vm, v, 4, kdims, kstr, kbox);
  if (err) return err;
  auto kern = fa_sm90_kernel<C>;
  const cudaError_t a =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  kern<<<grid, C::NTHREADS, C::SMEM, stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(o), Sq,
                                               Sk, Hq, Hkv, scale * LOG2E, causal, window, chunk,
                                               q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// The same interface as flash_attention_launch (flash_attention.cu): q, o
// (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); contiguous, 16-byte aligned. Takes
// dtype 1 (bfloat16) and D 64 or 128 only. window < 0 and chunk <= 0
// switch those masks off. Returns cudaGetLastError() after the launch (0 on
// success), or sm90::ERR_* if the driver cannot encode the tensor maps.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o,
                                           int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                           float scale, int causal, int window, int chunk,
                                           int q_offset, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_cfg<Cfg<64>>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset, s);
  if (D == 128)
    return launch_cfg<Cfg<128>>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
