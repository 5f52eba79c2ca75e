// Fused RMSNorm (+ optional residual add) for Hopper (sm_90a): rows held in
// registers.
//
// Replaces src/repro/kernels/rmsnorm.py::rmsnorm, the Pallas bodies
// _rmsnorm_kernel and _rmsnorm_res_kernel: y = (x [+ r]) * rsqrt(mean((x [+ r])^2)
// + eps) * w, math in f32, output in x's dtype (round to nearest even),
// rows of length d. The residual is read, not written back.
//
// What bounds it on the H100: bytes. Each row of x (and of r) is read once
// and each output row written once; the weight row is read once a warp.
// At (2048, 2048) bf16 that is 16.8 MB, 5.0 us at 3.35 TB/s; qwen3's
// qk-norm (65,536 x 128 bf16) 33.6 MB, 10.0 us; mamba2's block norm
// (2,048 x 1,024) 8.4 MB, 2.5 us; hymba's (2,048 x 1,600) 13.1 MB, 3.9 us.
// A decode call (16 x 2048) moves 139 KB: its floor is one launch and one
// memory round trip.
//
// Design: a group of lanes owns a row and holds it in registers, so there
// is no shared-memory staging and, below 8 vectors a lane, no block
// barrier. Each lane issues all its 16-byte loads of the row (up to 8, 128
// bytes in flight) before the sum of squares, a shuffle reduction inside
// the group, then scales and stores 16-byte vectors. The group is 16 lanes
// at up to 16 vectors a row (d = 128 bf16: two rows a warp), else a warp,
// or 2-8 warps with one cross-warp sum through shared memory when a row
// has more than 256 vectors. A lane's vectors past the row's end are
// predicated off (zeros in the sum, no store), so a row need only be a
// whole number of vectors: hymba's d 1600 in bf16 is 200 vectors, a warp
// of 7 or 6 vectors a lane; in f32 400, two warps. The weight is loaded in vectors once per group and
// kept in registers while the group walks rows (a grid-stride loop, the
// grid sized to the SMs' resident blocks; with fewer rows than SMs, as in
// decode, a block takes fewer rows so that they spread over more SMs).
// Vectors a lane and group width are template arguments; the wrapper sends
// d that is a multiple of one vector (8 bf16, 4 f32) and at most 8192 here. (Reading the
// weight through L1 for each row instead, or keeping no f32 copy of the
// row to halve the registers, measured no faster.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads a block, at most

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// One 16-byte vector of T, as VEC floats.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ float operator[](int e) const {
    return to_f(reinterpret_cast<const T*>(&raw)[e]);
  }
};

// The VEC weights of one x vector, in f32 (16 bytes of f32 w: one float4
// per 4 weights; bf16 w: 2 bytes a weight).
template <typename W, int VEC>
__device__ __forceinline__ void load_w(float (&wf)[VEC], const W* w) {
  if constexpr (sizeof(W) == 4) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(w) + e / 4);
      wf[e] = f.x; wf[e + 1] = f.y; wf[e + 2] = f.z; wf[e + 3] = f.w;
    }
  } else if constexpr (VEC == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(w));
#pragma unroll
    for (int e = 0; e < 8; ++e) wf[e] = to_f(reinterpret_cast<const W*>(&u)[e]);
  } else {   // 4 bf16 weights: 8 bytes
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(w));
#pragma unroll
    for (int e = 0; e < 4; ++e) wf[e] = to_f(reinterpret_cast<const W*>(&u)[e]);
  }
}

// LPR lanes of a warp own a row (16 or 32); a row is wpr warps of them
// (wpr > 1 only with LPR 32). Lane `rank` of the row holds vectors
// rank + k * (LPR * wpr), k < VPL, those below nvec.
template <typename T, typename W, bool RES, int LPR, int VPL>
__global__ void __launch_bounds__(NT)
rmsnorm_sm90_kernel(const T* __restrict__ x, const T* __restrict__ r, const W* __restrict__ w,
                    T* __restrict__ out, int n_rows, int d, int wpr, float eps) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float part[NT / 32];
  const int gsize = LPR * wpr;               // threads a row
  const int groups = blockDim.x / gsize;     // rows a block at a time
  const int gid = threadIdx.x / gsize, rank = threadIdx.x % gsize;
  const int nvec = d / VEC;

  float wf[VPL][VEC];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int v = rank + k * gsize;
    if (v < nvec) {
      load_w<W, VEC>(wf[k], w + v * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) wf[k][e] = 0.f;
    }
  }

  // block-uniform trip count, so the cross-warp sum may use __syncthreads
  for (int base = blockIdx.x * groups; base < n_rows; base += gridDim.x * groups) {
    const int row = base + gid;
    const bool live = row < n_rows;
    const size_t off = (size_t)(live ? row : 0) * d;
    Vec<T> xv[VPL], rv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {   // every load of the row before any use
      const int v = rank + k * gsize;
      const bool ok = live && v < nvec;
      xv[k].raw = ok ? reinterpret_cast<const uint4*>(x + off)[v] : make_uint4(0, 0, 0, 0);
      if constexpr (RES)
        rv[k].raw = ok ? reinterpret_cast<const uint4*>(r + off)[v] : make_uint4(0, 0, 0, 0);
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = RES ? xv[k][e] + rv[k][e] : xv[k][e];
        ss += f * f;
      }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (wpr > 1) {   // uniform over the block
      if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = ss;
      __syncthreads();
      ss = 0.f;
      for (int k = 0; k < wpr; ++k) ss += part[gid * wpr + k];
      __syncthreads();   // part is rewritten by the next rows
    }
    if (!live) continue;
    const float inv = rsqrtf(ss / (float)d + eps);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int v = rank + k * gsize;
      if (v < nvec) {
        Vec<T> o;
        T* ov = reinterpret_cast<T*>(&o.raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = RES ? xv[k][e] + rv[k][e] : xv[k][e];   // again: no f32 copy of the row
          ov[e] = from_f<T>(f * inv * wf[k][e]);
        }
        reinterpret_cast<uint4*>(out + off)[v] = o.raw;
      }
    }
  }
}

template <typename T, typename W, bool RES, int LPR, int VPL>
int launch_cfg(const void* x, const void* r, const void* w, void* out, int n, int d, int wpr,
               float eps, cudaStream_t stream) {
  auto kernel = rmsnorm_sm90_kernel<T, W, RES, LPR, VPL>;
  static int resident = 0, per_sm_blocks = 1;   // (the same on every H100)
  if (!resident) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    resident = per_sm * sms;
    per_sm_blocks = per_sm;
  }
  // few rows: fewer rows a block, so they spread over more SMs
  const int gsize = LPR * wpr, sms = resident / per_sm_blocks;
  int groups = NT / gsize;
  while (groups > 1 && (n + groups - 1) / groups < sms) groups /= 2;
  const int threads = groups * gsize < 32 ? 32 : groups * gsize;
  groups = threads / gsize;
  const int blocks = (n + groups - 1) / groups;
  const int grid = blocks < resident ? blocks : resident;
  kernel<<<grid, threads, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(r),
                                  static_cast<const W*>(w), static_cast<T*>(out), n, d, wpr, eps);
  return (int)cudaGetLastError();
}

// The group and vectors a lane for a row of nvec 16-byte vectors (at most
// 2048): 16 lanes at up to 16 vectors, else a warp of up to 8 vectors a
// lane, else 2, 4 or 8 warps of 8; the last vectors of a lane predicated.
template <typename T, typename W, bool RES>
int launch_t(const void* x, const void* r, const void* w, void* out, int n, int d, float eps,
             cudaStream_t s) {
  const int nvec = d / (16 / (int)sizeof(T));
  if (nvec <= 16) return launch_cfg<T, W, RES, 16, 1>(x, r, w, out, n, d, 1, eps, s);
  if (nvec <= 32) return launch_cfg<T, W, RES, 32, 1>(x, r, w, out, n, d, 1, eps, s);
  if (nvec <= 64) return launch_cfg<T, W, RES, 32, 2>(x, r, w, out, n, d, 1, eps, s);
  if (nvec <= 128) return launch_cfg<T, W, RES, 32, 4>(x, r, w, out, n, d, 1, eps, s);
  int wpr = 1;
  while (32 * 8 * wpr < nvec) wpr *= 2;
  return launch_cfg<T, W, RES, 32, 8>(x, r, w, out, n, d, wpr, eps, s);
}

template <typename T, typename W>
int launch_w(const void* x, const void* r, const void* w, void* out, int n, int d, float eps,
             cudaStream_t s) {
  return r ? launch_t<T, W, true>(x, r, w, out, n, d, eps, s)
           : launch_t<T, W, false>(x, r, w, out, n, d, eps, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x, residual (may be null), w and
// out contiguous and 16-byte aligned; d a multiple of one 16-byte vector of
// x's dtype (8 bf16, 4 f32), at most 8192. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int rmsnorm_sm90_launch(const void* x, const void* residual, const void* w,
                                   void* out, int n_rows, int d, float eps, int x_dtype,
                                   int w_dtype, void* stream) {
  const int vec = x_dtype == 0 ? 4 : 8;
  if (n_rows < 1 || d < vec || d % vec || d > 8192 || x_dtype < 0 || x_dtype > 1 ||
      w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out) || (residual && !aligned16(residual)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_w<float, float>(x, residual, w, out, n_rows, d, eps, s);
  if (x_dtype == 0)
    return launch_w<float, __nv_bfloat16>(x, residual, w, out, n_rows, d, eps, s);
  if (w_dtype == 0)
    return launch_w<__nv_bfloat16, float>(x, residual, w, out, n_rows, d, eps, s);
  return launch_w<__nv_bfloat16, __nv_bfloat16>(x, residual, w, out, n_rows, d, eps, s);
}
