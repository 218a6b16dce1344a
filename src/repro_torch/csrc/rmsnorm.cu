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
// ~295 operations per byte at which an H100 stops waiting on HBM.  At the
// models' widths a row is 1-14 KB, so what stands between a launch and
// that bound is latency: enough 16-byte loads in flight per SM, and few
// dependent steps (barriers, second passes) per row.
//
// Two paths, chosen per call by repro_torch/kernels/rmsnorm.py's
// `rmsnorm_geometry` from (d, dtype) and whether x, y and scale sit on
// 16-byte boundaries -- never from the row count, so a row's arithmetic
// and the order of its reduction are the same in a call of 1 row or 8192:
//
// * the register path (`rmsnorm_rows`): a row is d / V 16-byte vectors
//   (V = 8 bf16 or 4 f32), split over `tpr` threads (a power of two,
//   32-256), each holding K of them (at most 8, 7 in bf16: 8 bf16 vectors
//   spilled under the 64-register budget) packed in registers from the
//   load through the reduction to the store: one HBM read per element, no
//   second pass.  A CTA of 256
//   threads holds 256 / tpr rows (8 rows of d 512 in bf16, one warp
//   each), and the grid is one CTA per such row group.  The sum of
//   squares reduces by warp shuffles; only a row that spans warps
//   (tpr > 32) meets in shared memory, behind one barrier.  A CTA copies
//   `scale` to shared memory once, while its rows' loads are in flight,
//   and reads it there for every row it normalizes (held in registers
//   beside x it took ptxas to 173 registers a thread, one CTA an SM).
//   __launch_bounds__ asks for 4 CTAs an SM (<= 64 registers: x stays
//   packed, 8 vectors in 32 registers), 1024 threads with up to 128 KB
//   of loads in flight.
// * the loop path (`rmsnorm_loop`): what the register path does not take
//   -- d past 256 * K vectors (14336 in bf16, 8192 in f32), d not a
//   multiple of V, or pointers off a 16-byte boundary.  One CTA of 256
//   threads per row, two passes (the second re-reads the row from L1/L2);
//   vector loads over the aligned middle when x, y and scale share one
//   16-byte misalignment, a scalar head and tail (or a scalar loop) around
//   it, so any d and any offset run without padding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // a CTA, on both paths
constexpr int kWarps = kThreads / 32;
// the register path's CTAs an SM must hold: <= 64 registers a thread, so
// x stays packed (8 vectors = 32 registers) and 1024 threads keep up to
// 128 KB of loads in flight per SM
constexpr int kMinCtas = 4;

// a 16-byte vector's elements (N) and the vectors a thread may hold (K)
template <typename T> struct VecWidth;
template <> struct VecWidth<float> {
  static constexpr int N = 4, K = 8;
};
template <> struct VecWidth<__nv_bfloat16> {
  static constexpr int N = 8, K = 7;
};

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// -- the register path ---------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, kMinCtas)
rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ scale,
             T* __restrict__ y, long long n_rows, int d, int tpr,
             float eps) {
  constexpr int V = VecWidth<T>::N;
  __shared__ float red[kWarps];
  extern __shared__ uint4 s_scale[];           // the row's d / V vectors
  const int nvec = d / V;
  const int slot = threadIdx.x / tpr;          // the CTA's row it works on
  const int lane = threadIdx.x - slot * tpr;   // its place in that row
  const int wpr = tpr >> 5;                    // warps a row spans
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  const long long row = (long long)blockIdx.x * (kThreads / tpr) + slot;
  const bool live = row < n_rows;
  const size_t off = (size_t)(live ? row : 0) * (size_t)d;
  const uint4* xv = reinterpret_cast<const uint4*>(x + off);
  uint4 v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * tpr;
    v[k] = live && j < nvec ? xv[j] : zero;
  }
  // scale: read once per CTA while the rows' loads are in flight, and
  // kept in shared memory for every row the CTA normalizes (in registers
  // it doubled a thread's count); one vector at a time: unrolled, the
  // copy's loads spilled x
  const uint4* sv = reinterpret_cast<const uint4*>(scale);
#pragma unroll 1
  for (int j = threadIdx.x; j < nvec; j += kThreads) s_scale[j] = sv[j];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T* e = reinterpret_cast<const T*>(&v[k]);
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const float f = to_f32(e[t]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if (wpr > 1 && (threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();                             // s_scale, and red
  if (wpr > 1) {
    const float* part = red + slot * wpr;
    ss = part[0];
    for (int w = 1; w < wpr; ++w) ss += part[w];
  }
  if (!live) return;
  // the store converts x again from its packed registers: without this
  // empty asm the compiler keeps the sum's floats for it (56 registers at
  // 7 bf16 vectors), and past the 64-register budget they spill
#pragma unroll
  for (int k = 0; k < K; ++k)
    asm volatile("" : "+r"(v[k].x), "+r"(v[k].y), "+r"(v[k].z),
                 "+r"(v[k].w));
  const float r = 1.0f / sqrtf(ss / (float)d + eps);
  uint4* yv = reinterpret_cast<uint4*>(y + off);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * tpr;
    if (j >= nvec) continue;
    const uint4 sraw = s_scale[j];
    const T* e = reinterpret_cast<const T*>(&v[k]);
    const T* sc = reinterpret_cast<const T*>(&sraw);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int t = 0; t < V; ++t)
      o[t] = from_f32<T>(to_f32(e[t]) * r * (1.0f + to_f32(sc[t])));
    yv[j] = out;
  }
}

// -- the loop path -------------------------------------------------------

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_loop(const T* __restrict__ x, const T* __restrict__ scale,
             T* __restrict__ y, int d, float eps) {
  constexpr int V = VecWidth<T>::N;
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)d;
  T* yr = y + row * (size_t)d;

  // the vector loads need x, y and scale equally misaligned; the head is
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

// -- launch --------------------------------------------------------------

template <typename T, int K>
int launch_rows(const void* x, const void* scale, void* y, long long n_rows,
                int d, int tpr, float eps, cudaStream_t s) {
  const long long rows_per_cta = kThreads / tpr;
  const long long grid = (n_rows + rows_per_cta - 1) / rows_per_cta;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rmsnorm_rows<T, K><<<(unsigned)grid, kThreads, d * sizeof(T), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(y), n_rows, d, tpr, eps);
  return (int)cudaGetLastError();
}

// one instance for each K up to VecWidth<T>::K, and no other
template <typename T, int K = 1>
int launch_rows_k(int k, const void* x, const void* scale, void* y,
                  long long n_rows, int d, int tpr, float eps,
                  cudaStream_t s) {
  if (k == K) return launch_rows<T, K>(x, scale, y, n_rows, d, tpr, eps, s);
  if constexpr (K < VecWidth<T>::K)
    return launch_rows_k<T, K + 1>(k, x, scale, y, n_rows, d, tpr, eps, s);
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  threads_per_row 0 takes the loop
// path; otherwise the register path with that many threads a row (32, 64,
// 128 or 256) holding vecs_per_thread vectors each (1-8 in f32, 1-7 in
// bf16), one CTA per row group.  The register path refuses a geometry
// that does not cover d or pointers off a 16-byte boundary.  Returns
// cudaGetLastError() after the launch (0 on success); the Python wrapper
// raises on anything else.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             long long n_rows, int d, int dtype, float eps,
                             int threads_per_row, int vecs_per_thread,
                             void* stream) {
  if (n_rows <= 0 || d <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads_per_row == 0) {
    if (n_rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)n_rows);
    if (dtype == 0)
      rmsnorm_loop<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<float*>(y), d, eps);
    else
      rmsnorm_loop<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(scale),
          static_cast<__nv_bfloat16*>(y), d, eps);
    return (int)cudaGetLastError();
  }
  const int v = dtype == 0 ? 4 : 8;
  const int tpr = threads_per_row;
  if ((tpr != 32 && tpr != 64 && tpr != 128 && tpr != 256) ||
      vecs_per_thread < 1 || d % v != 0 ||
      (long long)tpr * vecs_per_thread < d / v ||
      !aligned16(x) || !aligned16(scale) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  return dtype == 0
      ? launch_rows_k<float>(vecs_per_thread, x, scale, y, n_rows, d, tpr,
                             eps, s)
      : launch_rows_k<__nv_bfloat16>(vecs_per_thread, x, scale, y, n_rows,
                                     d, tpr, eps, s);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
