// Mamba-2 SSD intra-chunk pass for Hopper (sm_90a): its three products on
// the tensor cores (wgmma) at f32 accuracy (3xTF32), fed by cp.async.
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
// B and C by group: head row bh reads group row bh / rep in place.
//
// What bounds it on the H100: at the mamba2-370m prefill shape (4 x 32
// heads, 1 group, S = 512, Q = 128, P = 64, N = 128) the function reads xs,
// B, C and lda and writes y, the end-states and cdecay once: ~52.7 MB,
// 15.7 us at 3.35 TB/s. Its causal products are ~1.65 GFLOP once C B^T is
// shared by a group's heads; as three TF32 products each that is ~4.9
// GFLOP, 10.0 us at 495 TFLOP/s. Bytes bound it. (On the f32 CUDA cores,
// 67 TFLOP/s, the same products alone would take 24.6 us.)
//
// Design:
// - Every product runs as wgmma m64n64k8 TF32 at f32 accuracy: each f32
//   operand splits into hi = tf32(a) and lo = tf32(a - hi), both rounded to
//   nearest as cvt.rna does (two integer operations each), and the product
//   accumulates lo*hi' + hi*lo' + hi*hi' in f32 (the "3xTF32" scheme). The
//   A operand (C; the decayed scores; B o decay_to_end, transposed) is
//   formed and split in registers; the B operand (B^T; xs) must be K-major
//   in shared memory for TF32, so its hi and lo parts are written once as
//   128-byte-swizzled K-major planes: xs's once a head (transposed), B's
//   32 state columns at a time while C B^T is formed.
// - One block owns a (batch x group, chunk) cell and a slab of up to 4 of
//   the group's heads (on the H100, 4 ran faster than 2 or 1: fewer heads a
//   block form C B^T more often). B and C arrive by cp.async; C B^T is formed
//   once, only its 64 x 64 tiles on or below the diagonal, and kept in
//   shared memory; each head then applies its own decay while it forms
//   the A fragments of the y product (exp2 of cumsums kept times log2(e)).
// - xs of the next head is prefetched by cp.async while the current head
//   computes; the first head's xs arrives while C B^T is formed, and each
//   head's planes land in C's buffer, free by then.
// - B, C and xs are row-major f32 tiles, rows a multiple of 32 floats, with
//   column c of row r stored at c ^ (8 (r % 4) + 4 ((r / 4) % 2)): the A
//   fragments read (row = lane / 4, column = lane % 4) or the transpose,
//   both free of bank conflicts, 16-byte chunks stay whole for cp.async,
//   and a fragment's offsets are per-thread constants plus a step.
// - The tiles are fixed at 128 steps by 64 head columns, zero-filled past
//   Q and P, so every chunk up to 128 and head dim up to 64 (multiples of
//   4 for the copies) runs the same code; N is padded to a multiple of 32.
// - 16 warps, four warpgroups: three form the three 64 x 64 tiles of
//   C B^T; then for each head two form y (query rows 0-63 and 64-127) and
//   two the end-state (state rows 0-63 and 64-127).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::Frag;
using sm90::plane_at;
using sm90::smem_u32;
using sm90::split;
using sm90::wgmma3;

constexpr int NT = 512;                 // 16 warps: four warpgroups
constexpr int QP = 128;                 // chunk steps a tile (Q zero-filled up to it)
constexpr int PP = 64;                  // head columns a tile (P zero-filled up to it)
constexpr int HS = 4;                   // heads a block (at most)
constexpr size_t MAX_SMEM = 232448;     // bytes a block may have on the H100
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// The swizzle of rows r with r % 8 == k: column c is stored at c ^ swz(k).
// It touches bits 2-4 only, so 16-byte chunks stay whole, and (for c0 a
// multiple of 8 and u < 8) (c0 + u) ^ h == (c0 ^ (h & 24)) + (u ^ (h & 4)):
// a fragment's offsets are per-thread constants plus a step.
__device__ __forceinline__ int swz(int k) { return ((k & 3) << 3) | ((k >> 2) << 2); }

__device__ __forceinline__ int at(int row, int col, int pitch) {
  return row * pitch + (col ^ swz(row & 7));
}

// Offset of column c0 + u (c0 a multiple of 8, u < 8) in a row of swizzle h.
__device__ __forceinline__ int col_at(int c0, int u, int h) {
  return (c0 ^ (h & 24)) + (u ^ (h & 4));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A rows x cols f32 tile (global row stride ld floats; cols % 4 == 0) into
// a swizzled shared tile of rows_p x pitch, the padding zero-filled.
__device__ __forceinline__ void load_tile(float* dst, int pitch, int rows_p, const float* src,
                                          int ld, int rows, int cols) {
  const int cpr = pitch / 4;            // 16-byte chunks a row
  for (int v = threadIdx.x; v < rows_p * cpr; v += NT) {
    const int r = v / cpr, c = (v - r * cpr) * 4;
    float* d = dst + at(r, c, pitch);
    if (r < rows && c < cols) {
      cp_async16(d, src + (size_t)r * ld + c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// 2^x, one MUFU operation (relative error ~2^-22; results below 2^-126 flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Accumulator value e of an m64n64 wgmma sits at row 16 w + g + 8 ((e / 2) % 2)
// and column 8 (e / 4) + 2 t + e % 2.
__device__ __forceinline__ int acc_row(int e, int wl, int g) { return 16 * wl + g + 8 * ((e / 2) % 2); }
__device__ __forceinline__ int acc_col(int e, int t) { return 8 * (e / 4) + 2 * t; }

// C B^T, its three 64 x 64 tiles on or below the diagonal (query rows
// 64 (wg > 0), keys 64 (wg > 1)), into CB. B's TF32 planes are built 32
// state columns at a time, double-buffered in CB's own buffer; warpgroup 3
// only builds them.
__device__ __forceinline__ void cb_product(const float* Cs, const float* Bs, float* CB, int Np,
                                           int wg, int wl, int g, int t) {
  float* planes = CB;                       // 2 buffers x (hi, lo) x 128 keys x 32 columns
  constexpr int PLANE = QP * 32;            // floats a plane
  const int i0 = wg > 0 ? 64 : 0, j0 = wg > 1 ? 64 : 0;
  const int h = swz(g);                     // A rows are g mod 8: one swizzle
  const float* ca = Cs + (i0 + 16 * wl + g) * Np + t;
  auto build = [&](int k, float* buf) {     // B[j][32k .. 32k + 32) -> hi, lo planes
    for (int v = threadIdx.x; v < QP * 8; v += NT) {
      const int j = v / 8, c = 32 * k + 4 * (v % 8);
      const float4 f = *reinterpret_cast<const float4*>(Bs + at(j, c, Np));
      uint4 hi, lo;
      split(f.x, hi.x, lo.x);
      split(f.y, hi.y, lo.y);
      split(f.z, hi.z, lo.z);
      split(f.w, hi.w, lo.w);
      const int o = plane_at(j, c % 32, QP);
      *reinterpret_cast<uint4*>(buf + o) = hi;
      *reinterpret_cast<uint4*>(buf + PLANE + o) = lo;
    }
    sm90::fence_proxy_async();              // the planes are wgmma operands
  };
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  const int nk = Np / 32;
  build(0, planes);
  __syncthreads();
  for (int k = 0; k < nk; ++k) {
    float* buf = planes + (k % 2) * 2 * PLANE;
    if (k + 1 < nk) build(k + 1, planes + ((k + 1) % 2) * 2 * PLANE);
    if (wg < 3) {
      const uint8_t* ph = reinterpret_cast<const uint8_t*>(buf);
      const uint8_t* pl = reinterpret_cast<const uint8_t*>(buf + PLANE);
#pragma unroll
      for (int s = 0; s < 4; ++s) {         // k-steps of 8 state columns
        const int kx = (32 * k + 8 * s) ^ h, ky = kx ^ 4;   // columns + t and + t + 4
        wgmma3(acc, Frag(ca[kx], ca[8 * Np + kx], ca[ky], ca[8 * Np + ky]), ph, pl,
               j0 * 128 + s * 32);
      }
    }
    __syncthreads();   // this buffer is rebuilt two slices on; the last frees CB
  }
  if (wg < 3) {
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = i0 + acc_row(e, wl, g), j = j0 + acc_col(e, t);
      store2(CB + at(i, j, QP), acc[e], acc[e + 1]);
    }
  }
}

// xs of a head (XS, row-major, swizzled) -> its TF32 hi and lo planes,
// transposed to K-major (a row per head column, keys along it). A warp
// reads 8 rows x 4 chunks, free of bank conflicts.
__device__ __forceinline__ void split_xs(const float* XS, float* XTh, float* XTl) {
  constexpr int CPR = PP / 4;
  for (int v = threadIdx.x; v < QP * CPR; v += NT) {
    const int j = (v & 7) + 8 * (v / (8 * CPR)), pc = (v >> 3) % CPR;
    const float4 f = *reinterpret_cast<const float4*>(XS + at(j, 4 * pc, PP));
    const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = plane_at(4 * pc + e, j, PP);
      uint32_t hi, lo;
      split(fv[e], hi, lo);
      XTh[o] = __uint_as_float(hi);
      XTl[o] = __uint_as_float(lo);
    }
  }
  sm90::fence_proxy_async();                // the planes are wgmma operands
}

// y = (C B^T o L) xs for query rows [64 half, 64 half + 64) of one head, by
// one warpgroup. The A fragments carry the head's decay (selected for
// j <= i, never multiplied by a mask); cm holds the head's cumsums times
// log2(e).
__device__ __forceinline__ void y_product(const float* CB, const uint8_t* xth, const uint8_t* xtl,
                                          const float* cm, float* yh, int Q, int P, int half,
                                          int wl, int g, int t) {
  const int i0 = 64 * half, ia = i0 + 16 * wl + g, ib = ia + 8, hg = swz(g);
  const float ca = cm[ia], cb = cm[ib];
  const float* sa = CB + ia * QP + t;       // score rows ia and ib (one swizzle)
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < i0 + 64; j0 += 8) {
    const int ja = j0 + t, jb = ja + 4, jx = j0 ^ hg, jy = jx ^ 4;
    const float da = cm[ja], db = cm[jb];
    const Frag a(ja <= ia ? sa[jx] * fast_exp2(ca - da) : 0.f,
                 ja <= ib ? sa[8 * QP + jx] * fast_exp2(cb - da) : 0.f,
                 jb <= ia ? sa[jy] * fast_exp2(ca - db) : 0.f,
                 jb <= ib ? sa[8 * QP + jy] * fast_exp2(cb - db) : 0.f);
    wgmma3(acc, a, xth, xtl, (j0 / 32) * PP * 128 + (j0 % 32) * 4);
  }
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int i = i0 + acc_row(e, wl, g), p = acc_col(e, t);
    if (i < Q && p < P) store2(yh + (size_t)i * P + p, acc[e], acc[e + 1]);
  }
}

// end-state = (B o decay_to_end)^T xs for state rows [64 half, ...) (every
// 128th), by one warpgroup. total = cm[Q - 1].
__device__ __forceinline__ void state_product(const float* Bs, const uint8_t* xth,
                                              const uint8_t* xtl, const float* cm, float total,
                                              float* sh, int N, int P, int Np, int half, int wl,
                                              int g, int t) {
  const int hA = swz(t), hB = swz(t + 4);
  for (int n0 = 64 * half; n0 < Np; n0 += 128) {
    const int nw = n0 + 16 * wl;            // this warp's 16 state rows
    const bool live = nw < Np;
    // B rows j0 + t and j0 + t + 4, columns nw + g and nw + g + 8
    const int ba0 = col_at(nw, g, hA), ba1 = col_at(nw + 8, g, hA);
    const int bb0 = col_at(nw, g, hB), bb1 = col_at(nw + 8, g, hB);
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < QP; j0 += 8) {
      const float* br = Bs + (j0 + t) * Np;
      const float wa = fast_exp2(total - cm[j0 + t]), wb = fast_exp2(total - cm[j0 + t + 4]);
      const Frag a(live ? br[ba0] * wa : 0.f, live ? br[ba1] * wa : 0.f,
                   live ? br[4 * Np + bb0] * wb : 0.f, live ? br[4 * Np + bb1] * wb : 0.f);
      wgmma3(acc, a, xth, xtl, (j0 / 32) * PP * 128 + (j0 % 32) * 4);
    }
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int n = n0 + acc_row(e, wl, g), p = acc_col(e, t);
      if (n < N && p < P) store2(sh + (size_t)n * P + p, acc[e], acc[e + 1]);
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
ssd_chunk_sm90_kernel(const float* __restrict__ xs, const float* __restrict__ b,
                      const float* __restrict__ c, const float* __restrict__ lda,
                      float* __restrict__ y, float* __restrict__ state,
                      float* __restrict__ cdecay, int S, int Q, int P, int N, int rep, int nc,
                      int slabs) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // wgmma's swizzled planes need 1024-byte alignment; the launcher adds 1024 bytes
  float* smem = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int Np = (N + 31) & ~31;
  float* Bs = smem;                          // QP x Np
  float* CB = Bs + QP * Np;                  // QP x QP: C B^T (tiles on or below the diagonal)
  float* XS = CB + QP * QP;                  // QP x PP: xs of the next head, as it arrives
  float* Cs = XS + QP * PP;                  // QP x Np: C, until C B^T is formed; then
  float* XTh = Cs;                           //   xs of this head, TF32 hi planes (K-major)
  float* XTl = XTh + QP * PP;                //   and lo
  float* cums = Cs + max(QP * Np, 2 * QP * PP);   // HS x QP, times log2(e)

  const int slab = blockIdx.x % slabs, cell = blockIdx.x / slabs;
  const int bg = cell / nc, ch = cell % nc;  // group row (batch x group), chunk
  const int row0 = ch * Q;
  const int h0 = slab * HS, nh = min(HS, rep - h0);
  const int bh0 = bg * rep + h0;             // first head row of the slab
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wg = warp / 4, wl = warp % 4;

  load_tile(Bs, Np, QP, b + ((size_t)bg * S + row0) * N, N, Q, N);
  load_tile(Cs, Np, QP, c + ((size_t)bg * S + row0) * N, N, Q, N);
  cp_commit();
  load_tile(XS, PP, QP, xs + ((size_t)bh0 * S + row0) * P, P, Q, P);
  cp_commit();

  // inclusive cumsum of each head's lda, a warp a head; padded rows repeat
  // the total. The total itself is the head's cdecay.
  for (int hh = warp; hh < nh; hh += NT / 32) {
    const float* lg = lda + (size_t)(bh0 + hh) * S + row0;
    float v[QP / 32];
#pragma unroll
    for (int k = 0; k < QP / 32; ++k) {     // every load before the scan
      const int i = 32 * k + lane;
      v[k] = i < Q ? lg[i] : 0.f;
    }
    float carry = 0.f;
#pragma unroll
    for (int k = 0; k < QP / 32; ++k) {
      const int i = 32 * k + lane;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(FULL, v[k], o);
        if (lane >= o) v[k] += u;
      }
      v[k] += carry;
      cums[hh * QP + i] = v[k] * LOG2E;
      if (i == Q - 1) cdecay[(size_t)(bh0 + hh) * nc + ch] = v[k];
      carry = __shfl_sync(FULL, v[k], 31);
    }
  }

  cp_wait<1>();   // B and C
  __syncthreads();
  cb_product(Cs, Bs, CB, Np, wg, wl, g, t);

  for (int hh = 0; hh < nh; ++hh) {
    cp_wait<0>();      // this head's xs
    __syncthreads();   // ... visible to all; C B^T (or the previous head) is done
    split_xs(XS, XTh, XTl);
    __syncthreads();
    if (hh + 1 < nh)   // prefetch the next head's xs while this one computes
      load_tile(XS, PP, QP, xs + ((size_t)(bh0 + hh + 1) * S + row0) * P, P, Q, P);
    cp_commit();
    const float* cm = cums + hh * QP;
    const int bh = bh0 + hh;
    const uint8_t* xth = reinterpret_cast<const uint8_t*>(XTh);
    const uint8_t* xtl = reinterpret_cast<const uint8_t*>(XTl);
    if (wg < 2)   // the head's two products side by side, two warpgroups each
      y_product(CB, xth, xtl, cm, y + ((size_t)bh * S + row0) * P, Q, P, wg, wl, g, t);
    else
      state_product(Bs, xth, xtl, cm, cm[Q - 1], state + ((size_t)bh * nc + ch) * N * P, N, P,
                    Np, wg - 2, wl, g, t);
  }
}

size_t smem_bytes(int N) {
  const size_t Np = (N + 31) & ~31;
  const size_t c_or_x = QP * Np > 2 * QP * PP ? QP * Np : 2 * QP * PP;
  return (QP * Np + QP * QP + QP * PP + c_or_x + HS * QP) * sizeof(float) + 1024;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Shared memory a block takes (the wrapper's smem_bytes states the same sum):
// B, C B^T, the next head's xs, C or this head's xs as TF32 hi and lo
// planes, and 4 heads' rows of cumulative sums, on tiles of 128 steps and 64
// head columns with N padded to a multiple of 32, and 1024 bytes to align
// the planes.
extern "C" size_t ssd_chunk_sm90_smem_bytes(int N) { return smem_bytes(N); }

// xs (BH, S, P), b and c (BH / rep, S, N), lda (BH, S), all f32, contiguous
// and 16-byte aligned; S = nc * Q with 1 <= Q <= 128, P <= 64 and P, N
// multiples of 4. Outputs: y (BH, S, P), state (BH, nc, N, P), cdecay
// (BH, nc). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_chunk_sm90_launch(const float* xs, const float* b, const float* c,
                                     const float* lda, float* y, float* state, float* cdecay,
                                     int BH, int S, int Q, int P, int N, int rep,
                                     void* stream) {
  if (Q < 1 || Q > QP || P < 1 || P > PP || P % 4 || N < 1 || N % 4 || S % Q || rep < 1 ||
      BH % rep)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(xs) || !aligned16(b) || !aligned16(c) || !aligned16(y) || !aligned16(state))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes(N);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nc = S / Q, slabs = (rep + HS - 1) / HS;
  ssd_chunk_sm90_kernel<<<(BH / rep) * nc * slabs, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, b, c, lda, y, state, cdecay, S, Q, P, N, rep, nc, slabs);
  return (int)cudaGetLastError();
}
