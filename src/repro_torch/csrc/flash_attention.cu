// SIMT flash-attention forward for Hopper (sm_90a), f32 and bf16, any head
// dim up to 256, bound to Python through a plain C interface (ctypes; see
// repro_torch/kernels/build.py).  bf16 at hd 32/64/128/256 takes
// csrc/flash_attention_sm90.cu (TMA + wgmma); f32 at every hd and bf16 at
// every other hd come here.  f32 stays on f32 FMAs because the tensor
// cores' TF32 would not hold 2e-4; bf16 at hd 12 has 24-byte rows, which
// TMA's 16-byte rule refuses.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (wrapper `flash_attention`, pallas_call at line 108).  Semantics kept:
//   * q (B, Hq, S, hd), k/v (B, Hkv, T, hd), Hq % Hkv == 0, kv head =
//     q head / (Hq / Hkv) (GQA/MQA without materialised repeats);
//   * any head dim: the TPU wrapper pads S and T, never hd, so its kernel
//     takes any hd.  Here the instances are at HD = 16, 32, 64, 128 and
//     256; a call runs in the smallest HD >= hd, with columns hd..HD-1
//     zero-filled in shared memory (they add nothing to q.k and are never
//     stored) and the scale 1/sqrt(hd) of the real hd (the wrapper's);
//   * any batch, head and row strides (the head dim is unit-stride), so
//     the model's (B, S, H, hd) activations are read and the output is
//     written in that layout without transposing copies;
//   * f32 or bf16 inputs, loaded into f32 shared tiles; online softmax
//     with f32 m, l and acc; scores are q.k * scale; the output is rounded
//     once to the input type;
//   * masks: kv_pos < T (ragged tail) and, when causal, kv_pos <= q_pos
//     with q counted from 0 (top-left alignment, also when S != T); masked
//     scores take the finite value -1e30, as in the TPU kernel;
//   * kv tiles strictly above the diagonal are skipped;
//   * out = acc / max(l, 1e-30).
// The first kv tile always holds key 0, which every row may attend to, so
// no row's running max stays at -1e30 once T >= 1.
//
// What bounds it on this card: for causal self-attention the work is
// ~2*S*S*hd flops per (b, head) against ~4*S*hd elements moved, so S/8
// flops per f32 byte (S/4 per bf16 byte), against the H100's ~20
// flops/byte ridge for f32 FMAs (67 TFLOP/s): operations bound beyond
// S ~ 160 in f32 (1.03 ms at b=8, S=1024, hd=128).  It computes with f32
// FMAs out of shared memory, bf16 too: it is the correct route for the
// head dims the sm90 kernel has no instance for, not a fast one.
//
// Design: the TPU grid's sequential kv axis becomes a loop inside one CTA.
// One CTA of 256 threads per (b*Hq, 64-row q block); heavy (late) causal q
// blocks are scheduled first.  The Q tile and one 32-key K/V tile at a
// time live in shared memory as f32 (K and Q rows padded by one word so
// the column-wise reads hit distinct banks).  Thread t owns rows
// 4*(t/16)..+3 of the block and columns t%16 + 16*j: the 16 threads of a
// row share a half-warp, so row max and row sum reduce with four xor
// shuffles and the per-row m, l and the row's slice of acc stay in that
// thread's registers.  P goes through shared memory for the P.V product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBKV = 32;       // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;

// element strides of one (B, H, rows, hd) operand; hd is unit-stride
struct Strides {
  long long b, h, r;
};

// reduce over the 16 lanes of a half-warp (one row group)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the element type's loads into f32 tiles and the output's one rounding
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename Elem>
__device__ __forceinline__ Elem from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (HD + 1) + (size_t)kBKV * (HD + 1) +
         (size_t)kBKV * HD + (size_t)kBQ * (kBKV + 1);
}

// HD: the instance's head dim (a multiple of 16); hd <= HD: the call's
template <int HD, typename Elem>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                 const Elem* __restrict__ v, Elem* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int Hq, int Hkv, int S,
                 int T_len, int hd, int causal, float scale) {
  constexpr int QS = HD + 1;      // padded row stride of the Q and K tiles
  constexpr int PS = kBKV + 1;    // padded row stride of the P tile
  constexpr int NO = HD / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBKV * QS;
  float* sP = sV + kBKV * HD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const Elem* qp = q + b * qs.b + h * qs.h;
  const Elem* kp = k + b * ks.b + hk * ks.h;
  const Elem* vp = v + b * vs.b + hk * vs.h;
  Elem* op = o + b * os.b + h * os.h;

  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4;  // first of this thread's 4 rows
  const int cg = tid & 15;        // column lane

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    const int qr = q0 + r;
    sQ[r * QS + c] = qr < S && c < hd ? to_f32(qp[qr * qs.r + c]) : 0.f;
  }

  float acc[4][NO];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NO; ++c) acc[i][c] = 0.f;
  }

  // causal: the last row of this block is q0 + kBQ - 1, so keys past it
  // (whole tiles strictly above the diagonal) are never needed
  const int kv_end = causal ? min(T_len, q0 + kBQ) : T_len;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBKV) {
    __syncthreads();  // Q written / previous tile's readers done
    for (int idx = tid; idx < kBKV * HD; idx += kThreads) {
      const int r = idx / HD, c = idx % HD;
      const int kr = kv0 + r;
      const bool ok = kr < T_len && c < hd;
      sK[r * QS + c] = ok ? to_f32(kp[kr * ks.r + c]) : 0.f;
      sV[r * HD + c] = ok ? to_f32(vp[kr * vs.r + c]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < HD; ++dd) {
      const float k0 = sK[cg * QS + dd];
      const float k1 = sK[(cg + 16) * QS + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = sQ[(r0 + i) * QS + dd];
        s[i][0] = fmaf(qv, k0, s[i][0]);
        s[i][1] = fmaf(qv, k1, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + r0 + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kv_pos = kv0 + cg + 16 * j;
        const bool valid = kv_pos < T_len && (!causal || kv_pos <= q_pos);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        sP[(r0 + i) * PS + cg + 16 * j] = p;
      }
      l[i] = l[i] * corr + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NO; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P tile complete

#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(r0 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        const float vv = sV[kk * HD + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + r0 + i;
    if (qr >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NO; ++c)
      if (cg + 16 * c < hd)
        op[qr * os.r + cg + 16 * c] = from_f32<Elem>(acc[i][c] / denom);
  }
}

template <int HD, typename Elem>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides* st, int B, int Hq, int Hkv, int S, int T_len,
           int hd, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_fwd_kernel<HD, Elem>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<Elem*>(o), st[0], st[1], st[2],
      st[3], Hq, Hkv, S, T_len, hd, causal, scale);
  return (int)cudaGetLastError();
}

// the instance of the smallest HD >= hd
template <typename Elem>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* strides, int B, int Hq, int Hkv, int S, int T,
             int hd, int causal, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || T <= 0 ||
      hd <= 0 || hd > 256 || (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (hd <= 16)
    return launch<16, Elem>(q, k, v, o, st, B, Hq, Hkv, S, T, hd, causal,
                            scale, s);
  if (hd <= 32)
    return launch<32, Elem>(q, k, v, o, st, B, Hq, Hkv, S, T, hd, causal,
                            scale, s);
  if (hd <= 64)
    return launch<64, Elem>(q, k, v, o, st, B, Hq, Hkv, S, T, hd, causal,
                            scale, s);
  if (hd <= 128)
    return launch<128, Elem>(q, k, v, o, st, B, Hq, Hkv, S, T, hd, causal,
                             scale, s);
  // 139,904 bytes of shared memory (opt-in), 1 CTA per SM
  return launch<256, Elem>(q, k, v, o, st, B, Hq, Hkv, S, T, hd, causal,
                           scale, s);
}

}  // namespace

// float32; any hd in 1..256.  strides holds 12 element strides, (batch,
// head, row) of q, k, v and o in that order.  Returns cudaGetLastError()
// after the launch (0 on success); the Python wrapper raises on anything
// else.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int B, int Hq,
                                     int Hkv, int S, int T, int hd, int causal,
                                     float scale, void* stream) {
  return dispatch<float>(q, k, v, o, strides, B, Hq, Hkv, S, T, hd, causal,
                         scale, stream);
}

// bfloat16, the same kernel and arguments: f32 tiles and math, the output
// rounded to bf16 (round to nearest even)
extern "C" int repro_flash_attention_simt_bf16(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int B, int Hq, int Hkv, int S, int T, int hd,
    int causal, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, B, Hq, Hkv, S, T, hd,
                                 causal, scale, stream);
}
