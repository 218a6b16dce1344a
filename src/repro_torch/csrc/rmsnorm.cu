// Fused RMSNorm for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes; see repro_torch/kernels/build.py).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:_rmsnorm_kernel
// (wrapper `rmsnorm`, pallas_call at line 47).  Per row of x (N, d):
//     y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// with the mean and the products in f32 and the result rounded to x's
// dtype.  The TPU wrapper pads d to 128 lanes and N to its row block; that
// padding is a TPU artefact and is not copied here.
//
// What bounds it on this card: bytes.  It reads each element once, writes
// it once and does about 5 f32 operations per element, far below the
// ~295 operations per byte at which an H100 stops waiting on HBM.
//
// Design: one CTA of 256 threads per row.  16-byte vector loads and stores
// cover the aligned middle of the row whenever x, y and scale share the
// same 16-byte misalignment; a scalar head and tail (or a scalar loop when
// they do not) handle any d and any offset, so no padding is needed.  The
// sum of squares reduces in f32 by warp shuffles, then across warps through
// shared memory.  The second pass re-reads the row from L1/L2 (it was just
// read) instead of holding it in registers, so one kernel serves every d.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ y, int d, float eps) {
  constexpr int V = VecWidth<T>::N;
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)d;
  T* yr = y + row * (size_t)d;

  // the vector path needs x, y and scale equally misaligned; the head is
  // the run of elements before the first 16-byte boundary
  const uintptr_t ax = reinterpret_cast<uintptr_t>(xr) & 15;
  const bool vec = ax == (reinterpret_cast<uintptr_t>(yr) & 15) &&
                   ax == (reinterpret_cast<uintptr_t>(scale) & 15);
  int head = d, nvec = 0;
  if (vec) {
    head = (int)(((16 - ax) & 15) / sizeof(T));
    if (head > d) head = d;
    nvec = (d - head) / V;
  }
  const int tail0 = head + nvec * V;

  // pass 1: sum of squares in f32
  float ss = 0.f;
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    const uint4 raw = xv[j];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const float v = to_f32(e[t]);
      ss += v * v;
    }
  }
  for (int i = tail0 + threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  const float var = block_sum(ss, red) / (float)d;
  const float r = 1.0f / sqrtf(var + eps);

  // pass 2: y = x * r * (1 + scale), rounded once to T
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    yr[i] = from_f32<T>(to_f32(xr[i]) * r * (1.0f + to_f32(scale[i])));
  const uint4* sv = reinterpret_cast<const uint4*>(scale + head);
  uint4* yv = reinterpret_cast<uint4*>(yr + head);
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    const uint4 raw = xv[j];
    const uint4 sraw = sv[j];
    const T* e = reinterpret_cast<const T*>(&raw);
    const T* s = reinterpret_cast<const T*>(&sraw);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int t = 0; t < V; ++t)
      o[t] = from_f32<T>(to_f32(e[t]) * r * (1.0f + to_f32(s[t])));
    yv[j] = out;
  }
  for (int i = tail0 + threadIdx.x; i < d; i += blockDim.x)
    yr[i] = from_f32<T>(to_f32(xr[i]) * r * (1.0f + to_f32(scale[i])));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             long long n_rows, int d, int dtype, float eps,
                             void* stream) {
  if (n_rows <= 0 || n_rows > 0x7fffffffLL || d <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(y), d, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(scale),
        static_cast<__nv_bfloat16*>(y), d, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
