// Grouped (per-expert) matmul for Hopper (sm_90a): bf16, wgmma fed by a
// TMA ring, each weight byte read once.
//
// Replaces src/repro/kernels/moe_gmm.py::grouped_matmul (Pallas body
// _gmm_kernel) for bf16 inputs whose d and f are multiples of 8 (TMA needs
// 16-byte row strides); f32 and other shapes take grouped_matmul.cu. It
// computes out[e] = x[e] @ w[e] for x (E, C, d), w (E, d, f), out (E, C, f),
// f32 accumulation, written as bf16. Any C; ragged d and f edges are
// zero-filled by TMA and masked at the store.
//
// What bounds it on the H100: bytes. At the MoE prefill shape (128 experts,
// C = 160, d = 2048, f = 768) the weights are 403 MB and the activations
// 115 MB: 0.155 ms at 3.35 TB/s, against 64 GFLOP, 0.065 ms at 989 TFLOP/s.
// At the folded decode (C = 32) the weights are nearly all of it (0.127 ms).
// The first kernel took one 64 x 64 output tile a block, so each expert's
// weights were streamed once per 64-row C tile (3 times at C = 160), with
// one register-staged prefetch. This one reads each weight tile from device
// memory once: a block covers up to 256 rows of C, and the f tiles of one
// expert run side by side, so x is read from L2 after its first use.
//
// Design: one block per (expert, 128-column f tile, 256-row C pass): two
// consumer warpgroups and one producer warp. The producer streams d in
// steps of 64: per step an x box (64 d values x up to 256 C rows) and two
// w boxes (64 f values x 64 d rows), 128-byte swizzled, into a ring of 4
// stages with "full" (transaction bytes) and "empty" mbarriers. Consumer
// warpgroup g owns the 64-row C tiles g and g + 2 of the pass (C = 160:
// tiles 0 and 2, and 1), each a 64 x 128 f32 accumulator: wgmma m64n128k16
// with A = x (K-major) and B = w, which is f-contiguous and so MN-major
// (transpose mode; the two 64-wide f boxes are the descriptor's leading
// offset apart). A warpgroup keeps one step's products in flight while it
// waits for the next stage, and releases a stage when its products are
// done. A warpgroup with no tile (C <= 64) exits at once; the empty
// barriers count only the warpgroups that compute.
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BN = 128;               // f columns per block
constexpr int BKD = 64;               // d per stage: one 128-byte box row
constexpr int MT = 4;                 // 64-row C tiles per block (pass of 256 rows)
constexpr int STAGES = 4;
constexpr int W_BYTES = BKD * BN * 2;       // two 64-column w boxes: 16 KB
constexpr int NTHREADS = 256 + 32;          // two consumer warpgroups and a producer warp

__device__ __forceinline__ void store_tile(const float (&acc)[64], __nv_bfloat16* oe, int row0,
                                           int col0, int C, int f) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = row0 + 8 * ((i / 2) % 2);
    const int col = col0 + 8 * (i / 4);
    if (row < C && col < f)   // f % 8 == 0: col + 1 < f too
      *reinterpret_cast<__nv_bfloat162*>(oe + (size_t)row * f + col) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// The d loop of one consumer warpgroup over NT (1 or 2) 64-row C tiles at
// tile rows t0 and t0 + 2; NT is a template argument so that no wgmma sits
// in a divergent branch (ptxas would serialize them).
template <int NT>
__device__ __forceinline__ void consume(float (&acc)[2][64], const uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int stage_bytes, int x_bytes, int t0,
                                        int nk) {
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % STAGES;
    const uint8_t* xs = smem + s * stage_bytes;
    const uint8_t* ws = xs + x_bytes;
    mbar_wait(&full[s], (ks / STAGES) & 1);
#pragma unroll
    for (int t = 0; t < NT; ++t) fence_regs(acc[t]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKD / 16; ++kk) {
      const uint64_t b = desc_sw128(ws + kk * 2048, BKD * 128, 1024);
#pragma unroll
      for (int t = 0; t < NT; ++t)
        wgmma_m64n128k16_ss<1>(acc[t], desc_sw128(xs + (t0 + 2 * t) * 8192 + kk * 32, 16, 1024),
                               b, 1);
    }
    wgmma_commit();
    if (ks > 0) {   // the previous step's products are done: release its stage
      wgmma_wait<1>();
      mbar_arrive(&empty[(ks - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < NT; ++t) fence_regs(acc[t]);
}

// x_rows: rows of the x box (64 x tiles, at most 256), the same for every block.
__global__ void __launch_bounds__(NTHREADS, 1)
gmm_sm90_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                __nv_bfloat16* __restrict__ out, int C, int d, int f, int x_rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int x_bytes = x_rows * 128;
  const int stage_bytes = x_bytes + W_BYTES;            // a multiple of 1024
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * stage_bytes);
  uint64_t* empty = full + STAGES;

  const int e = blockIdx.z;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * MT * 64;
  const int ntile = min(MT, (C - m0 + 63) / 64);
  const int nactive = min(2, ntile);                    // warpgroups with a tile
  const int nk = (d + BKD - 1) / BKD;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * nactive);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warp
    if (threadIdx.x == 256) {
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % STAGES;
        if (ks >= STAGES) mbar_wait(&empty[s], ((ks / STAGES) - 1) & 1);
        uint8_t* xs = smem + s * stage_bytes;
        uint8_t* ws = xs + x_bytes;
        mbar_expect_tx(&full[s], stage_bytes);
        tma_load_3d(xs, &xmap, &full[s], ks * BKD, m0, e);
        tma_load_3d(ws, &wmap, &full[s], n0, ks * BKD, e);
        tma_load_3d(ws + BKD * 128, &wmap, &full[s], n0 + 64, ks * BKD, e);
      }
    }
    return;
  }

  // ---- consumer warpgroups: tile wg, and wg + 2 if the pass has it
  const int wg = threadIdx.x / 128;
  if (wg >= nactive) return;
  const bool two = wg + 2 < ntile;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;

  float acc[2][64];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
  if (two)
    consume<2>(acc, smem, full, empty, stage_bytes, x_bytes, wg, nk);
  else
    consume<1>(acc, smem, full, empty, stage_bytes, x_bytes, wg, nk);

  __nv_bfloat16* oe = out + (size_t)e * C * f;
  const int row = 16 * warp + lane / 4, col = n0 + 2 * (lane % 4);
  store_tile(acc[0], oe, m0 + wg * 64 + row, col, C, f);
  if (two) store_tile(acc[1], oe, m0 + (wg + 2) * 64 + row, col, C, f);
}

}  // namespace

// x (E, C, d), w (E, d, f), out (E, C, f): contiguous bfloat16, 16-byte
// aligned, d % 8 == 0 and f % 8 == 0. Returns cudaGetLastError() after the
// launch (0 on success), or sm90::ERR_* if the driver cannot encode the
// tensor maps.
extern "C" int grouped_matmul_sm90_launch(const void* x, const void* w, void* out, int E, int C,
                                          int d, int f, void* stream) {
  if (d % 8 || f % 8 || E < 1 || C < 1 || d < 1 || f < 1) return (int)cudaErrorInvalidValue;
  const int x_rows = C >= MT * 64 ? MT * 64 : (C + 63) / 64 * 64;
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t xdims[3] = {(uint64_t)d, (uint64_t)C, (uint64_t)E};
  const uint64_t xstr[2] = {d * e, (uint64_t)C * d * e};
  const uint32_t xbox[3] = {64, (uint32_t)x_rows, 1};
  const uint64_t wdims[3] = {(uint64_t)f, (uint64_t)d, (uint64_t)E};
  const uint64_t wstr[2] = {f * e, (uint64_t)d * f * e};
  const uint32_t wbox[3] = {64, BKD, 1};
  CUtensorMap xm, wm;
  int err = encode_bf16(&xm, x, 3, xdims, xstr, xbox);
  if (!err) err = encode_bf16(&wm, w, 3, wdims, wstr, wbox);
  if (err) return err;
  const int smem = 1024 + STAGES * (x_rows * 128 + W_BYTES) + 16 * STAGES;
  const cudaError_t a =
      cudaFuncSetAttribute(gmm_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((f + BN - 1) / BN, (C + MT * 64 - 1) / (MT * 64), E);
  gmm_sm90_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      xm, wm, static_cast<__nv_bfloat16*>(out), C, d, f, x_rows);
  return (int)cudaGetLastError();
}
