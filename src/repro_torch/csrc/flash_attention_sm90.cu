// Flash attention forward for Hopper (sm_90a), head dim 64 or 128: bf16 on
// wgmma products of TMA-loaded tiles, and f32 on 3xTF32 wgmma products.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body _fa_kernel) for bf16 and f32 inputs with head dim 64 or 128; the
// other head dims take the SIMT kernel of flash_attention.cu. Both kernels
// here compute what that kernel computes, with the same rules: q (B, Sq, Hq,
// D) against k, v (B, Sk, Hkv, D); causal, sliding-window and chunked-local
// masks and a query position offset; keys past Sk masked; masked scores are
// -1e30 (the running max starts at -inf, so a tile whose scores are all
// masked adds weight only while no real score has been seen); a whole KV
// tile is skipped when no (q, k) pair of the block's query rows and the
// tile's keys can be reached; a row whose sum stayed 0 outputs 0; query
// head h reads kv head h / (Hq / Hkv) in place.
//
// ---- bf16 (fa_sm90_kernel)
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
//
// ---- f32 (fa_sm90_tf32_kernel)
//
// The reference's f32 tolerance (2e-5) is beyond single-pass TF32 (10
// mantissa bits), so every product runs as three TF32 wgmma products,
// lo*hi' + hi*lo' + hi*hi' accumulated in f32 (the split of sm90.cuh, as in
// ssd_chunk_sm90.cu). What bounds it on the H100: at the dense prefill
// shape in f32 (4 x 512, 16/2 heads, D = 128, causal) the bytes are 37.7 MB,
// 11.3 us at 3.35 TB/s, and the causal products 4.3 GFLOP, three TF32
// products each, 26 us at 495 TFLOP/s: operations bound it (~26 us). At the
// taskgraph's f32 shape (16 x 128, 4/4 heads, D = 64) the bytes bound it,
// ~2.5 us, and a launch of 128 blocks is mostly latency.
//
// Design: one block per (batch x query head, 64-row query tile): one
// consumer warpgroup and one producer warp; KV tiles of 64 keys, one tile
// in flight (at D = 128 the planes below take 224 KB of the 227 KB a block
// may hold). A TF32 wgmma reads its shared-memory operands only K-major, so:
//   Q, K    land by TMA (f32, 32-value boxes, 128-byte swizzled), which is
//           the K-major layout of S = Q K^T (D contiguous). The consumers
//           split each in place: the landed plane becomes the hi part, a
//           second plane of the same layout takes the lo part (Q once a
//           block, K once a tile).
//   S       wgmma m64n64k8 with Q and K from shared memory, 3 x D / 8 steps.
//   softmax as the bf16 kernel's, on the f32 accumulator.
//   P       goes to registers as the A operand without a shuffle: a TF32 A
//           fragment holds columns (t, t + 4) of an 8-wide step, the
//           accumulator columns (2t, 2t + 1), so the step's keys are taken
//           in the order 0 2 4 6 1 3 5 7, and V's rows in the same order;
//           each value splits into hi and lo in registers.
//   V       lands by TMA unswizzled (keys x D); the consumers write it once
//           as V^T hi and lo planes (D rows of 64 keys, K-major, 128-byte
//           swizzled, the keys of each step in the order above), then
//           O += P V is wgmma m64nDk8 with P from registers, 3 x 8 steps.
// K's landing plane is released to the producer as soon as S is formed and
// V's as soon as V^T is written (an "empty" mbarrier each), so the next
// tile's loads overlap this tile's softmax and P V. Named barriers order
// the consumers' plane writes before the wgmma that read them.
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
// [k_lo, k_lo + TILE)? The reference's rule, at this kernel's tile sizes; it
// depends on block indices only, so the producer and the consumers agree.
template <int TILE = BK>
__device__ __forceinline__ bool tile_needed(int k_lo, int q_lo, int q_hi, int causal, int window,
                                            int chunk) {
  const int k_hi = k_lo + TILE - 1;
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

// ---------------------------------------------------------------- f32: 3xTF32

constexpr int TBQ = 64;    // query rows per block: one consumer warpgroup
constexpr int TBK = 64;    // keys per KV tile
constexpr int TBOX = 32;   // f32 in one 128-byte swizzled box row

template <int D_>
struct Tf32Cfg {
  static constexpr int D = D_;
  static constexpr int NCONSUMER = 128;
  static constexpr int NTHREADS = NCONSUMER + 32;
  static constexpr int NDC = D / TBOX;           // 32-wide boxes across a row
  static constexpr int Q_FLOATS = TBQ * D;       // one plane of the Q tile
  static constexpr int KV_FLOATS = TBK * D;      // one plane of a K or V tile
  // Q hi, Q lo, K hi (TMA lands K there), K lo, V as landed, V^T hi, V^T lo
  static constexpr int BAR_BYTES = 8 * 5;
  static constexpr int SMEM = 1024 + 4 * (2 * Q_FLOATS + 5 * KV_FLOATS) + BAR_BYTES;
};

// The n floats at p (16-byte chunks, over the consumer warpgroup's 128
// threads) split in place: p keeps the TF32 hi parts, lo gets the lo parts
// at the same offsets (so any layout, swizzled or not, carries over).
__device__ __forceinline__ void split_in_place(float* p, float* lo, int n, int tid) {
  for (int i = 4 * tid; i < n; i += 4 * 128) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    uint4 h, l;
    split(f.x, h.x, l.x);
    split(f.y, h.y, l.y);
    split(f.z, h.z, l.z);
    split(f.w, h.w, l.w);
    *reinterpret_cast<uint4*>(p + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// V as TMA lands it (TBK keys x D, row-major) -> V^T hi and lo planes (D
// rows of TBK keys, K-major), the keys of each 8-wide step j in the order
// 8j + {0, 2, 4, 6, 1, 3, 5, 7}: the order in which the P fragments hold
// them. A warp takes 32 consecutive d: its reads of a key row hit 32 banks,
// its 16-byte writes to 8 consecutive swizzled rows fill 128 bytes.
template <int D>
__device__ __forceinline__ void split_vt(const float* v, float* vh, float* vl, int tid) {
  for (int item = tid; item < D * (TBK / 8); item += 128) {
    const int d = item % D, j = item / D;
    const float* col = v + 8 * j * D + d;
    uint4 h0, l0, h1, l1;
    split(col[0 * D], h0.x, l0.x);
    split(col[2 * D], h0.y, l0.y);
    split(col[4 * D], h0.z, l0.z);
    split(col[6 * D], h0.w, l0.w);
    split(col[1 * D], h1.x, l1.x);
    split(col[3 * D], h1.y, l1.y);
    split(col[5 * D], h1.z, l1.z);
    split(col[7 * D], h1.w, l1.w);
    const int o0 = plane_at(d, 8 * j, D), o1 = plane_at(d, 8 * j + 4, D);
    *reinterpret_cast<uint4*>(vh + o0) = h0;
    *reinterpret_cast<uint4*>(vl + o0) = l0;
    *reinterpret_cast<uint4*>(vh + o1) = h1;
    *reinterpret_cast<uint4*>(vl + o1) = l1;
  }
}

// O += P V for one 8-key step (N = D, V^T K-major).
template <int N>
__device__ __forceinline__ void pv_step(float (&d)[N / 2], const uint32_t (&p)[4], uint64_t b);
template <>
__device__ __forceinline__ void pv_step<64>(float (&d)[32], const uint32_t (&p)[4], uint64_t b) {
  wgmma_tf32(d, p, b);
}
template <>
__device__ __forceinline__ void pv_step<128>(float (&d)[64], const uint32_t (&p)[4], uint64_t b) {
  wgmma_tf32_n128(d, p, b);
}

// window < 0: no window; chunk <= 0: no chunk. scale_log2 = scale * log2(e).
template <class C>
__global__ void __launch_bounds__(C::NTHREADS, 1)
fa_sm90_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, float* __restrict__ o, int Sq,
                    int Sk, int Hq, int Hkv, float scale_log2, int causal, int window, int chunk,
                    int q_offset) {
  constexpr int D = C::D;
  extern __shared__ uint8_t smem_raw[];
  float* qh = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  float* ql = qh + C::Q_FLOATS;
  float* kh = ql + C::Q_FLOATS;
  float* kl = kh + C::KV_FLOATS;
  float* vr = kl + C::KV_FLOATS;
  float* vh = vr + C::KV_FLOATS;
  float* vl = vh + C::KV_FLOATS;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vl + C::KV_FLOATS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = q_full + 2;
  uint64_t* k_empty = q_full + 3;
  uint64_t* v_empty = q_full + 4;

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_tile0 = (gridDim.y - 1 - blockIdx.y) * TBQ;   // heaviest tiles first
  const int q_lo = q_offset + q_tile0;
  const int q_hi = q_offset + min(q_tile0 + TBQ, Sq) - 1;
  const int nk = (Sk + TBK - 1) / TBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, C::NCONSUMER);
    mbar_init(v_empty, C::NCONSUMER);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::NCONSUMER) {
    // ---- producer warp: one thread issues every TMA load
    if (threadIdx.x == C::NCONSUMER) {
      mbar_expect_tx(q_full, 4 * C::Q_FLOATS);
#pragma unroll
      for (int c = 0; c < C::NDC; ++c)
        tma_load_4d(qh + c * TBQ * TBOX, &qmap, q_full, c * TBOX, h, q_tile0, b);
      int it = 0;
      for (int j = 0; j < nk; ++j) {
        if (!tile_needed<TBK>(j * TBK, q_lo, q_hi, causal, window, chunk)) continue;
        if (it > 0) mbar_wait(k_empty, (it - 1) & 1);
        mbar_expect_tx(k_full, 4 * C::KV_FLOATS);
#pragma unroll
        for (int c = 0; c < C::NDC; ++c)
          tma_load_4d(kh + c * TBK * TBOX, &kmap, k_full, c * TBOX, hk, j * TBK, b);
        if (it > 0) mbar_wait(v_empty, (it - 1) & 1);
        mbar_expect_tx(v_full, 4 * C::KV_FLOATS);
        tma_load_4d(vr, &vmap, v_full, 0, hk, j * TBK, b);
        ++it;
      }
    }
    return;
  }

  // ---- consumer warpgroup: the 64 rows of the query tile
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;   // tile row of values 4j, 4j+1 (+8: 4j+2, 4j+3)
  const int col0 = 2 * (lane % 4);          // tile column of value 0
  const uint8_t* qhb = reinterpret_cast<const uint8_t*>(qh);
  const uint8_t* qlb = reinterpret_cast<const uint8_t*>(ql);
  const uint8_t* khb = reinterpret_cast<const uint8_t*>(kh);
  const uint8_t* klb = reinterpret_cast<const uint8_t*>(kl);
  const uint8_t* vhb = reinterpret_cast<const uint8_t*>(vh);
  const uint8_t* vlb = reinterpret_cast<const uint8_t*>(vl);

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  split_in_place(qh, ql, C::Q_FLOATS, tid);   // ordered before the wgmma by the first tile's barrier
  int it = 0;
  for (int j = 0; j < nk; ++j) {
    const int k_lo = j * TBK;
    if (!tile_needed<TBK>(k_lo, q_lo, q_hi, causal, window, chunk)) continue;
    const uint32_t phase = it & 1;

    // K's hi and lo planes, then S = Q K^T (3xTF32)
    mbar_wait(k_full, phase);
    split_in_place(kh, kl, C::KV_FLOATS, tid);
    fence_proxy_async();
    bar_sync(1, C::NCONSUMER);
    float sc[TBK / 2];
#pragma unroll
    for (int i = 0; i < TBK / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int qoff = (kk / 4) * TBQ * 128 + (kk % 4) * 32;
      const int koff = (kk / 4) * TBK * 128 + (kk % 4) * 32;
      wgmma_tf32_ss(sc, desc_sw128(qlb + qoff, 16, 1024), desc_sw128(khb + koff, 16, 1024));
      wgmma_tf32_ss(sc, desc_sw128(qhb + qoff, 16, 1024), desc_sw128(klb + koff, 16, 1024));
      wgmma_tf32_ss(sc, desc_sw128(qhb + qoff, 16, 1024), desc_sw128(khb + koff, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty);   // K's landing plane is free for the next tile

    // Mask (only tiles where some pair can be masked), then the online
    // softmax in base 2.
    const bool whole = k_lo + TBK <= Sk && (!causal || k_lo + TBK - 1 <= q_lo) && window < 0 &&
                       chunk <= 0;
#pragma unroll
    for (int i = 0; i < TBK / 2; ++i) {
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
    for (int i = 0; i < TBK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
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
    for (int i = 0; i < TBK / 2; ++i) {
      const float p = ex2(sc[i] - m[(i / 2) % 2]);
      sc[i] = p;
      rsum[(i / 2) % 2] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];   // this thread's columns
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i / 2) % 2];

    // P as TF32 A fragments of the 8-key steps, keys in the order
    // 0 2 4 6 1 3 5 7: a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1),
    // a3 (g + 8, 2t + 1) are this thread's values 4 kk, 4 kk + 2, 4 kk + 1
    // and 4 kk + 3.
    uint32_t ph[TBK / 8][4], pl[TBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < TBK / 8; ++kk) {
      split(sc[4 * kk], ph[kk][0], pl[kk][0]);
      split(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }

    // V^T's hi and lo planes, then O += P V (3xTF32)
    mbar_wait(v_full, phase);
    split_vt<D>(vr, vh, vl, tid);
    fence_proxy_async();
    mbar_arrive(v_empty);   // V's landing plane is free for the next tile
    bar_sync(1, C::NCONSUMER);
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TBK / 8; ++kk) {
      const int voff = (kk / 4) * D * 128 + (kk % 4) * 32;
      pv_step<D>(o_acc, pl[kk], desc_sw128(vhb + voff, 16, 1024));
      pv_step<D>(o_acc, ph[kk], desc_sw128(vlb + voff, 16, 1024));
      pv_step<D>(o_acc, ph[kk], desc_sw128(vhb + voff, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    ++it;
  }

  // Epilogue: the row sums over the 4 lanes of a row, 1 / l, f32 pairs.
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
      float* orow = o + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int i = 4 * jb + 2 * r;
        *reinterpret_cast<float2*>(orow + 8 * jb + col0) =
            make_float2(o_acc[i] * inv[r], o_acc[i + 1] * inv[r]);
      }
    }
  }
}

template <class C>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                int Hq, int Hkv, float scale, int causal, int window, int chunk, int q_offset,
                cudaStream_t stream) {
  constexpr int D = C::D;
  CUtensorMap qm, km, vm;
  const uint64_t e = sizeof(float);
  const uint64_t qdims[4] = {(uint64_t)D, (uint64_t)Hq, (uint64_t)Sq, (uint64_t)B};
  const uint64_t qstr[3] = {D * e, (uint64_t)Hq * D * e, (uint64_t)Sq * Hq * D * e};
  const uint32_t qbox[4] = {TBOX, 1, TBQ, 1};
  const uint64_t kdims[4] = {(uint64_t)D, (uint64_t)Hkv, (uint64_t)Sk, (uint64_t)B};
  const uint64_t kstr[3] = {D * e, (uint64_t)Hkv * D * e, (uint64_t)Sk * Hkv * D * e};
  const uint32_t kbox[4] = {TBOX, 1, TBK, 1};
  const uint32_t vbox[4] = {(uint32_t)D, 1, TBK, 1};   // whole rows, unswizzled
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = encode_tiled(&qm, f32, q, 4, qdims, qstr, qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = encode_tiled(&km, f32, k, 4, kdims, kstr, kbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = encode_tiled(&vm, f32, v, 4, kdims, kstr, vbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  auto kern = fa_sm90_tf32_kernel<C>;
  const cudaError_t a =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid(B * Hq, (Sq + TBQ - 1) / TBQ);
  kern<<<grid, C::NTHREADS, C::SMEM, stream>>>(qm, km, vm, static_cast<float*>(o), Sq, Sk, Hq,
                                               Hkv, scale * LOG2E, causal, window, chunk,
                                               q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// The same interface as flash_attention_launch (flash_attention.cu): q, o
// (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); contiguous, 16-byte aligned. Takes
// dtype 0 (float32: the 3xTF32 kernel) or 1 (bfloat16) and D 64 or 128 only.
// window < 0 and chunk <= 0 switch those masks off. Returns
// cudaGetLastError() after the launch (0 on success), or sm90::ERR_* if the
// driver cannot encode the tensor maps.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o,
                                           int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                           float scale, int causal, int window, int chunk,
                                           int q_offset, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_tf32<Tf32Cfg<64>>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset, s);
  if (dtype == 0 && D == 128)
    return launch_tf32<Tf32Cfg<128>>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_cfg<Cfg<64>>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset, s);
  if (D == 128)
    return launch_cfg<Cfg<128>>(q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window, chunk, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
