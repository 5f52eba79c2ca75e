// Grouped (per-expert) matmul for Hopper (sm_90a).
//
// Replaces src/repro/kernels/moe_gmm.py::grouped_matmul (Pallas body
// _gmm_kernel): out[e] = x[e] @ w[e] for x (E, C, d), w (E, d, f), out
// (E, C, f), f32 accumulation, written in x's dtype. Any C, d and f: the
// ragged edges of every tile are masked here (zeros are loaded past the
// edge and nothing is stored there), so the reference's d % block_d == 0
// assert is not inherited.
//
// What bounds it on the H100: at the MoE prefill shape (128 experts,
// C = 160, d = 2048, f = 768, bf16) the weights alone are 403 MB and the
// activations ~0.1 GB, ~0.15 ms at 3.35 TB/s, against 64 GFLOP at
// 989 TFLOP/s = 0.065 ms: bytes bound it. At decode (C = 8 a tenant) the
// weights are the whole cost (~0.12 ms).
//
// Design: one block of 4 warps per (expert, 64-row C tile, 64-column f
// tile). A loop over d in 32-deep steps inside the block takes the place
// of the TPU grid's sequential fourth axis and its VMEM accumulator; the
// sum stays in registers in f32. bf16 runs on the tensor cores through
// mma.sync m16n8k16 (each warp owns a 32 x 32 output tile: 2 x 4 mma
// tiles); the next step's tiles are loaded into registers while the
// current one is multiplied (one stage of prefetch). Rows of x and w are
// read as 16-byte vectors when d (for x) or f (for w) is a multiple of 8
// and the base is aligned, element by element otherwise. f32 (the parity
// runs) uses a plain SIMT tile of 64 x 64 with a 4 x 4 register block per
// thread. wgmma and TMA-fed multi-stage pipelines are a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;             // rows of C per block
constexpr int BN = 64;             // columns of f per block
constexpr int BK = 32;             // depth of one step (bf16 path)
constexpr int NT = 128;            // bf16 path: 4 warps, 2 x 2, 32 x 32 each
constexpr int APITCH = BK + 8;     // smem pitches in bf16 (rows stay 16-byte aligned,
constexpr int BPITCH = BN + 8;     // fragment reads hit distinct banks)
constexpr int PER_THREAD = BM * BK / NT;   // 16 elements of each tile a thread
static_assert(BM * BK == BK * BN, "A and B tiles have the same size");

// Sixteen bf16 a thread: two 16-byte vectors, or sixteen scalars.
struct Stage {
  uint4 v[2];
  __device__ __forceinline__ uint16_t* e() { return reinterpret_cast<uint16_t*>(v); }
};

// x tile rows [m0, m0 + BM), depth [k0, k0 + BK) into registers.
__device__ __forceinline__ void load_a(Stage& r, const uint16_t* x, int C, int d,
                                       int m0, int k0, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int row = idx / (BK / 8), col = (idx % (BK / 8)) * 8;
      const int gm = m0 + row, gk = k0 + col;
      r.v[i] = (gm < C && gk < d)
                   ? *reinterpret_cast<const uint4*>(x + (size_t)gm * d + gk)
                   : make_uint4(0, 0, 0, 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int gm = m0 + idx / BK, gk = k0 + idx % BK;
      r.e()[i] = (gm < C && gk < d) ? x[(size_t)gm * d + gk] : (uint16_t)0;
    }
  }
}

__device__ __forceinline__ void store_a(uint16_t* As, Stage& r, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * NT;
      *reinterpret_cast<uint4*>(As + (idx / (BK / 8)) * APITCH + (idx % (BK / 8)) * 8) = r.v[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int idx = threadIdx.x + i * NT;
      As[(idx / BK) * APITCH + idx % BK] = r.e()[i];
    }
  }
}

// w tile depth [k0, k0 + BK), columns [n0, n0 + BN) into registers.
__device__ __forceinline__ void load_b(Stage& r, const uint16_t* w, int d, int f,
                                       int k0, int n0, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int row = idx / (BN / 8), col = (idx % (BN / 8)) * 8;
      const int gk = k0 + row, gn = n0 + col;
      r.v[i] = (gk < d && gn < f)
                   ? *reinterpret_cast<const uint4*>(w + (size_t)gk * f + gn)
                   : make_uint4(0, 0, 0, 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int gk = k0 + idx / BN, gn = n0 + idx % BN;
      r.e()[i] = (gk < d && gn < f) ? w[(size_t)gk * f + gn] : (uint16_t)0;
    }
  }
}

__device__ __forceinline__ void store_b(uint16_t* Bs, Stage& r, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * NT;
      *reinterpret_cast<uint4*>(Bs + (idx / (BN / 8)) * BPITCH + (idx % (BN / 8)) * 8) = r.v[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int idx = threadIdx.x + i * NT;
      Bs[(idx / BN) * BPITCH + idx % BN] = r.e()[i];
    }
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(NT)
gmm_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                __nv_bfloat16* __restrict__ out, int C, int d, int f, int vec_a,
                int vec_b) {
  __shared__ __align__(16) uint16_t As[BM * APITCH];
  __shared__ __align__(16) uint16_t Bs[BK * BPITCH];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const uint16_t* xe = x + (size_t)e * C * d;
  const uint16_t* we = w + (size_t)e * d * f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;   // warp's output tile
  const int g = lane / 4, t = lane % 4;                   // mma fragment coordinates

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  Stage ra, rb;
  load_a(ra, xe, C, d, m0, 0, vec_a);
  load_b(rb, we, d, f, 0, n0, vec_b);
  store_a(As, ra, vec_a);
  store_b(Bs, rb, vec_b);
  __syncthreads();

  const int nk = (d + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) {   // next step's tiles in flight while this one is multiplied
      load_a(ra, xe, C, d, m0, (kt + 1) * BK, vec_a);
      load_b(rb, we, d, f, (kt + 1) * BK, n0, vec_b);
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint16_t* p = As + (wm + i * 16 + g) * APITCH + ks + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * APITCH);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * APITCH + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint16_t* p = Bs + (ks + 2 * t) * BPITCH + wn + j * 8 + g;
        b[j][0] = (uint32_t)p[0] | ((uint32_t)p[BPITCH] << 16);
        b[j][1] = (uint32_t)p[8 * BPITCH] | ((uint32_t)p[9 * BPITCH] << 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();   // every warp is done reading this step's tiles
    if (more) {
      store_a(As, ra, vec_a);
      store_b(Bs, rb, vec_b);
      __syncthreads();
    }
  }

  __nv_bfloat16* oe = out + (size_t)e * C * f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm + i * 16 + g + (c / 2) * 8;
        const int col = n0 + wn + j * 8 + 2 * t + (c % 2);
        if (row < C && col < f) oe[(size_t)row * f + col] = __float2bfloat16(acc[i][j][c]);
      }
}

// f32: SIMT tile, 256 threads, each a 4 x 4 block of rows ty + 16 i and
// columns tx + 16 j (broadcast and consecutive shared reads).
constexpr int FK = 16;
constexpr int FT = 256;

__global__ void __launch_bounds__(FT)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int C, int d, int f) {
  __shared__ float As[FK][BM + 4];   // transposed: As[k][m]
  __shared__ float Bs[FK][BN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* xe = x + (size_t)e * C * d;
  const float* we = w + (size_t)e * d * f;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += FK) {
#pragma unroll
    for (int i = 0; i < BM * FK / FT; ++i) {
      const int idx = threadIdx.x + i * FT;
      const int row = idx / FK, col = idx % FK;
      const int gm = m0 + row, gk = k0 + col;
      As[col][row] = (gm < C && gk < d) ? xe[(size_t)gm * d + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < FK * BN / FT; ++i) {
      const int idx = threadIdx.x + i * FT;
      const int row = idx / BN, col = idx % BN;
      const int gk = k0 + row, gn = n0 + col;
      Bs[row][col] = (gk < d && gn < f) ? we[(size_t)gk * f + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* oe = out + (size_t)e * C * f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < C && col < f) oe[(size_t)row * f + col] = acc[i][j];
    }
}

}  // namespace

// x (E, C, d), w (E, d, f), out (E, C, f), all contiguous and of one
// dtype: 0 = float32, 1 = bfloat16. vec_a / vec_b (bf16 only): rows of x /
// w may be read as 16-byte vectors (d / f a multiple of 8, base 16-byte
// aligned). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out, int E,
                                     int C, int d, int f, int dtype, int vec_a,
                                     int vec_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  if (dtype == 1) {
    gmm_bf16_kernel<<<grid, NT, 0, s>>>(static_cast<const uint16_t*>(x),
                                        static_cast<const uint16_t*>(w),
                                        static_cast<__nv_bfloat16*>(out), C, d, f,
                                        vec_a, vec_b);
  } else if (dtype == 0) {
    gmm_f32_kernel<<<grid, FT, 0, s>>>(static_cast<const float*>(x),
                                       static_cast<const float*>(w),
                                       static_cast<float*>(out), C, d, f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
