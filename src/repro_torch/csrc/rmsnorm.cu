// Fused RMSNorm (+ optional residual add) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rmsnorm.py::rmsnorm, the Pallas bodies
// _rmsnorm_kernel and _rmsnorm_res_kernel: y = (x [+ r]) * rsqrt(mean((x [+ r])^2)
// + eps) * w, math in f32, output in x's dtype, rows of length d.
//
// What bounds it on the H100: bytes. Each row of x (and of r) is read once
// and each output row written once; the weight row is shared by every row
// and stays in L1/L2. At the slice's prefill shape, (2048, 2048) bf16, that
// is 16 MiB, about 5 us at 3.35 TB/s; the arithmetic is a few flops a byte.
//
// Design: a group of threads owns one row (a warp when the row fits in 32
// 16-byte vectors, otherwise up to a whole 1024-thread block), so a small-d
// call still fills the card with rows and a large-d call spreads each row
// over many threads. Loads are 16-byte vectors where the row length and
// the pointers allow (a scalar path otherwise). The row is kept in shared
// memory as f32 between the sum of squares and the scaled write, so device
// memory is read once. The sum of squares is a warp shuffle reduction,
// then shared memory across the row's warps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(T* dst, const T* src) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = src[j];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* dst, const T* src) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = src[j];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// blockDim = (threads per row, rows per block). Dynamic shared memory:
// rows_per_block * d floats for the rows, then 32 floats per row for the
// cross-warp partial sums.
template <typename T, typename W, int VEC, bool RES>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                               const W* __restrict__ w, T* __restrict__ out,
                               int n_rows, int d, float eps) {
  extern __shared__ float smem[];
  const int tpr = blockDim.x;
  const int ry = threadIdx.y;
  const int row = blockIdx.x * blockDim.y + ry;
  float* xs = smem + (size_t)ry * d;
  float* part = smem + (size_t)blockDim.y * d + ry * 32;

  float ss = 0.f;
  if (row < n_rows) {
    const T* xr = x + (size_t)row * d;
    const T* rr = RES ? r + (size_t)row * d : nullptr;
    for (int i = threadIdx.x * VEC; i < d; i += tpr * VEC) {
      alignas(16) T xv[VEC];
      load_vec<T, VEC>(xv, xr + i);
      float f[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = to_f(xv[j]);
      if constexpr (RES) {
        alignas(16) T rv[VEC];
        load_vec<T, VEC>(rv, rr + i);
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] += to_f(rv[j]);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        xs[i + j] = f[j];
        ss += f[j] * f[j];
      }
    }
  }
  ss = warp_sum(ss);
  const int nwarps = tpr / 32;
  if (nwarps > 1) {  // uniform over the block: every thread reaches the barrier
    if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int k = 0; k < nwarps; ++k) ss += part[k];
  }
  if (row >= n_rows) return;

  const float inv = rsqrtf(ss / (float)d + eps);
  T* orow = out + (size_t)row * d;
  for (int i = threadIdx.x * VEC; i < d; i += tpr * VEC) {
    alignas(16) T o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = from_f<T>(xs[i + j] * inv * to_f(w[i + j]));
    store_vec<T, VEC>(orow + i, o);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, typename W, bool RES>
int launch_t(const void* x, const void* r, const void* w, void* out, int n, int d,
             float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (d % V == 0) && aligned16(x) && aligned16(out) && (!RES || aligned16(r));
  const int per = vec ? V : 1;
  const int slots = (d + per - 1) / per;  // vectors in a row
  int tpr = 32;
  while (tpr < slots && tpr < 1024) tpr *= 2;
  const int rpb = tpr >= 256 ? 1 : 256 / tpr;  // small rows: several per block
  const size_t smem = ((size_t)rpb * d + (size_t)rpb * 32) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 block(tpr, rpb);
  const dim3 grid((n + rpb - 1) / rpb);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  if (vec) {
    rmsnorm_kernel<T, W, V, RES><<<grid, block, smem, stream>>>(xp, rp, wp, op, n, d, eps);
  } else {
    rmsnorm_kernel<T, W, 1, RES><<<grid, block, smem, stream>>>(xp, rp, wp, op, n, d, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch_w(const void* x, const void* r, const void* w, void* out, int n, int d,
             float eps, cudaStream_t s) {
  return r ? launch_t<T, W, true>(x, r, w, out, n, d, eps, s)
           : launch_t<T, W, false>(x, r, w, out, n, d, eps, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 on success). residual may be null.
extern "C" int rmsnorm_launch(const void* x, const void* residual, const void* w,
                              void* out, int n_rows, int d, float eps, int x_dtype,
                              int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_w<float, float>(x, residual, w, out, n_rows, d, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_w<float, __nv_bfloat16>(x, residual, w, out, n_rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_w<__nv_bfloat16, float>(x, residual, w, out, n_rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_w<__nv_bfloat16, __nv_bfloat16>(x, residual, w, out, n_rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
