// Mamba-2 SSD intra-chunk pass for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_intra_chunk (Pallas body
// _ssd_chunk_kernel). For one (batch x head, chunk) cell of Q steps, with
// xs = dt * x (Q, P), B and C (Q, N) and lda = dt * A (Q), all in f32:
//   cums = cumsum(lda)                                  (inclusive)
//   y    = (C B^T o L) xs,  L[i][j] = exp(cums[i] - cums[j]) for j <= i, else 0
//   state = (B o exp(cums[Q-1] - cums))^T xs            (N, P)
//   cdecay = cums[Q-1]
// The decay above the diagonal is selected away, never multiplied by a
// mask, so exp's overflow there cannot turn into inf * 0 = NaN. Heads share
// B and C by group: head row bh reads group row bh / rep in place (the
// reference repeats B and C over heads in memory first; the numbers are
// the same).
//
// What bounds it on the H100: at the mamba2-370m prefill shape (4 x 32
// heads, 1 group, S = 512, Q = 128, P = 64, N = 128) the causal products
// are about 1.65 GFLOP of f32 work once C B^T is shared by a group's heads,
// ~0.025 ms at 67 TFLOP/s on the CUDA cores, against ~53 MB read and
// written once (~0.016 ms): operations bound it, in f32 as the reference
// computes.
//
// Design: the scores C B^T depend on the group, not the head, so one block
// owns one (batch x group, chunk) cell and a slab of up to 4 of the
// group's heads: B and C of the chunk are loaded into shared memory once
// and C B^T is formed once (B rows padded by one float so that lanes
// reading B[j][n] for 32 consecutive j hit distinct banks), then each head
// of the slab adds only its decay, its y and its end-state. 16 warps a
// block; in every product a warp owns 4 rows and a lane 4 columns (keys
// j = lane + 32 k, or columns of P), with row operands read by broadcast.
// Query rows go in tiles of 64: per tile a warp writes its 4 rows of the
// masked, decayed scores (it alone reads them back) and forms its 4 rows
// of y; key columns past the tile's last row are skipped (causal). C's
// buffer is reused for xs and the score tile once C B^T is formed, which
// keeps a block within 227 KB at Q = N = 128. The cumulative sum is a
// warp scan. Chunks up to 128 steps and heads up to 128 wide.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;            // 16 warps
constexpr int TQ = NT / 32 * 4;    // rows per tile: 4 a warp
constexpr int HS = 4;              // heads a block (they share C B^T)
constexpr int MAXQ = 128;          // 4 key columns a lane
constexpr int MAXP = 128;          // 4 output columns a lane
constexpr unsigned FULL = 0xffffffffu;

// rows x cols contiguous floats from src into dst with row pitch `pitch`;
// 16-byte loads where the rows allow them.
__device__ __forceinline__ void copy_rows(float* dst, int pitch, const float* src,
                                          int rows, int cols) {
  const int total = rows * cols;
  if ((cols & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int v = threadIdx.x; v < total / 4; v += NT) {
      const float4 f = reinterpret_cast<const float4*>(src)[v];
      float* d = dst + (4 * v / cols) * pitch + (4 * v) % cols;
      d[0] = f.x; d[1] = f.y; d[2] = f.z; d[3] = f.w;
    }
  } else {
    for (int e = threadIdx.x; e < total; e += NT) dst[(e / cols) * pitch + e % cols] = src[e];
  }
}

// C B^T for rows i0 + 4 warp + a and keys j = lane + 32 k, k < KQ (the
// tile's keys: j < jmax); raw, before decay and mask.
template <int KQ>
__device__ __forceinline__ void cb_tile(const float* Cs, const float* Bs, float* CB,
                                        int i0, int jmax, int Q, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s[4][KQ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < KQ; ++k) s[a][k] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[KQ];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + warp * 4 + a;
      cv[a] = i < Q ? Cs[i * N + n] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
      const int j = lane + 32 * k;
      bv[k] = j < jmax ? Bs[j * (N + 1) + n] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < KQ; ++k) s[a][k] = fmaf(cv[a], bv[k], s[a][k]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + warp * 4 + a;
#pragma unroll
    for (int k = 0; k < KQ; ++k) {
      const int j = lane + 32 * k;
      if (i < Q && j < jmax) CB[i * (Q + 1) + j] = s[a][k];
    }
  }
}

__global__ void __launch_bounds__(NT)
ssd_chunk_kernel(const float* __restrict__ xs, const float* __restrict__ b,
                 const float* __restrict__ c, const float* __restrict__ lda,
                 float* __restrict__ y, float* __restrict__ state,
                 float* __restrict__ cdecay, int S, int Q, int P, int N, int rep,
                 int nc, int slabs) {
  extern __shared__ float smem[];
  const int NP = N + 1, QP = Q + 1;
  float* Bs = smem;                          // Q x (N + 1)
  float* CB = Bs + Q * NP;                   // Q x (Q + 1): C B^T
  float* Cs = CB + Q * QP;                   // Q x N, until C B^T is formed; then
  float* Xs = Cs;                            //   Q x P: xs of the current head
  float* Ds = Xs + Q * P;                    //   TQ x (Q + 1): masked, decayed scores
  float* cums = Cs + max(Q * N, Q * P + TQ * QP);   // Q
  float* dte = cums + Q;                     // Q: exp(total - cums)

  const int slab = blockIdx.x % slabs, cell = blockIdx.x / slabs;
  const int bg = cell / nc, ch = cell % nc;  // group row (batch x group), chunk
  const size_t row0 = (size_t)ch * Q;
  const int h0 = slab * HS, nh = min(HS, rep - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  copy_rows(Bs, NP, b + ((size_t)bg * S + row0) * N, Q, N);
  copy_rows(Cs, N, c + ((size_t)bg * S + row0) * N, Q, N);
  __syncthreads();
  for (int i0 = 0; i0 < Q; i0 += TQ) {
    const int jmax = min(Q, i0 + TQ);        // keys that rows of this tile can see
    switch ((jmax + 31) / 32) {
      case 1: cb_tile<1>(Cs, Bs, CB, i0, jmax, Q, N); break;
      case 2: cb_tile<2>(Cs, Bs, CB, i0, jmax, Q, N); break;
      case 3: cb_tile<3>(Cs, Bs, CB, i0, jmax, Q, N); break;
      default: cb_tile<4>(Cs, Bs, CB, i0, jmax, Q, N); break;
    }
  }
  __syncthreads();   // C B^T is complete; C's buffer is free

  const int kp = (P + 31) / 32;              // output column groups a lane holds
  for (int hh = 0; hh < nh; ++hh) {
    const int bh = bg * rep + h0 + hh;       // head row: bh / rep == bg
    copy_rows(Xs, P, xs + ((size_t)bh * S + row0) * P, Q, P);
    if (warp == 0) {   // inclusive cumsum, 32 steps at a time
      const float* lg = lda + (size_t)bh * S + row0;
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + lane;
        float v = i < Q ? lg[i] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float t = __shfl_up_sync(FULL, v, o);
          if (lane >= o) v += t;
        }
        v += carry;
        if (i < Q) cums[i] = v;
        carry = __shfl_sync(FULL, v, 31);
      }
    }
    __syncthreads();
    const float total = cums[Q - 1];
    for (int j = tid; j < Q; j += NT) dte[j] = expf(total - cums[j]);
    __syncthreads();

    for (int i0 = 0; i0 < Q; i0 += TQ) {
      const int jmax = min(Q, i0 + TQ);
      // this warp's 4 rows of the tile: decay(i <- j) selected for j <= i
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + warp * 4 + a;
        if (i >= Q) continue;
        float* drow = Ds + (warp * 4 + a) * QP;
        for (int j = lane; j < jmax; j += 32)
          drow[j] = j <= i ? CB[i * QP + j] * expf(cums[i] - cums[j]) : 0.f;
      }
      __syncwarp();

      // y rows i0 + 4 warp + a, columns lane + 32 k
      float o[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) o[a][k] = 0.f;
      for (int j = 0; j < jmax; ++j) {
        float sv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) sv[a] = Ds[(warp * 4 + a) * QP + j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = lane + 32 * k;
          xv[k] = (k < kp && p < P) ? Xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) o[a][k] = fmaf(sv[a], xv[k], o[a][k]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + warp * 4 + a;
        if (i >= Q) continue;
        float* yrow = y + ((size_t)bh * S + row0 + i) * P;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = lane + 32 * k;
          if (p < P) yrow[p] = o[a][k];
        }
      }
      __syncwarp();   // this warp's score rows are rewritten by the next tile
    }

    // chunk end-state rows n0 + 4 warp + a, columns lane + 32 k
    float* sg = state + ((size_t)bh * nc + ch) * N * P;
    for (int n0 = 0; n0 < N; n0 += TQ) {
      float o[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) o[a][k] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float wj = dte[j];
        float bv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int n = n0 + warp * 4 + a;
          bv[a] = n < N ? Bs[j * NP + n] * wj : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = lane + 32 * k;
          xv[k] = (k < kp && p < P) ? Xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) o[a][k] = fmaf(bv[a], xv[k], o[a][k]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int n = n0 + warp * 4 + a;
        if (n >= N) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = lane + 32 * k;
          if (p < P) sg[(size_t)n * P + p] = o[a][k];
        }
      }
    }
    if (tid == 0) cdecay[(size_t)bh * nc + ch] = total;
    __syncthreads();   // the next head overwrites xs, cums and dte
  }
}

}  // namespace

// xs (BH, S, P), b and c (BH / rep, S, N), lda (BH, S), all f32 and
// contiguous; S = nc * Q with 1 <= Q <= 128 and P <= 128. Outputs: y
// (BH, S, P), state (BH, nc, N, P), cdecay (BH, nc). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_chunk_launch(const float* xs, const float* b, const float* c,
                                const float* lda, float* y, float* state,
                                float* cdecay, int BH, int S, int Q, int P, int N,
                                int rep, void* stream) {
  if (Q < 1 || Q > MAXQ || P < 1 || P > MAXP || N < 1 || S % Q || rep < 1 || BH % rep)
    return (int)cudaErrorInvalidValue;
  const int nc = S / Q, slabs = (rep + HS - 1) / HS;
  // B, C B^T, then C or (xs and one score tile), cums and dte (the wrapper's smem_bytes)
  const int union_floats = Q * N > Q * P + TQ * (Q + 1) ? Q * N : Q * P + TQ * (Q + 1);
  const size_t smem = (size_t)(Q * (N + 1) + Q * (Q + 1) + union_floats + 2 * Q) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_chunk_kernel<<<(BH / rep) * nc * slabs, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, b, c, lda, y, state, cdecay, S, Q, P, N, rep, nc, slabs);
  return (int)cudaGetLastError();
}
