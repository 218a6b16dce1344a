// Tensor-core flash-attention forward for Hopper (sm_90a) through
// mma.sync: f32 at every head dim up to 256 (3xTF32) and bf16 at every
// head dim the sm90 kernel has no instance for.  Bound to Python through a
// plain C interface (ctypes; see repro_torch/kernels/build.py): two entry
// points, repro_flash_attention_mma_f32 and repro_flash_attention_mma_bf16.
// bf16 at hd 32/64/128/256 takes csrc/flash_attention_sm90.cu (TMA + wgmma).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (wrapper `flash_attention`, pallas_call at line 108).  Semantics kept:
//   * q (B, Hq, S, hd), k/v (B, Hkv, T, hd), Hq % Hkv == 0, kv head =
//     q head / (Hq / Hkv) (GQA/MQA without materialised repeats);
//   * any head dim: the TPU wrapper pads S and T, never hd.  Here the
//     instances are at HD = 16, 32, 48, 64, 128 and 256; a call runs in
//     the smallest HD >= hd, with columns hd..HD-1 zero in shared memory
//     (they add nothing to q.k and are never stored) and the scale of the
//     real hd (the wrapper's 1/sqrt(hd));
//   * any batch, head and row strides (the head dim is unit-stride), any
//     pointer: the model's (B, S, H, hd) activations are read and the
//     output is written in that layout without transposing copies;
//   * online softmax with f32 m, l and acc; scores are q.k * scale;
//   * masks: kv_pos < T (ragged tail) and, when causal, kv_pos <= q_pos
//     with q counted from 0 (top-left alignment, also when S != T); masked
//     scores take the finite value -1e30, as in the TPU kernel;
//   * kv tiles strictly above the diagonal are skipped;
//   * out = acc / max(l, 1e-30), rounded once to the input type.
// The first kv tile always holds key 0, which every row may attend to, so
// no row's running max stays at -1e30 past the first tile.
//
// What bounds it on this card: causal self-attention does ~2*S*S*hd
// multiply-adds per (b, head) against ~4*S*hd elements moved, so it is
// operations bound past S ~ 150 for f32 and S ~ 1200 for bf16.  f32 to
// 2e-4 cannot take one TF32 product (10 mantissa bits: 8.5e-3 at S = 1024),
// so each f32 product runs as three on split operands, x = big + small with
// big a TF32 value and small the rest (split_tf32): big.big + big.small +
// small.big, which keeps ~21 bits.  The least time is then 3 x flops /
// 495 TFLOP/s (TF32 dense), 165 TFLOP/s against the 67 of the f32 FMAs.
// bf16 runs m16n8k16 at the bf16 rate, with P.V taken twice (below).
//
// Design (the FlashAttention-2 forward on mma.sync):
//   * one CTA of 4 warps per (b*Hq, 64-row q block), heavy (late) causal q
//     blocks launched first; each warp owns 16 q rows end to end;
//   * S = Q.K^T lands in m16n8 accumulators: a thread holds 2 columns of
//     rows g and g + 8 of every 8-key tile, so a row's max and sum reduce
//     over the 4 threads of a quad with two xor shuffles.  The softmax runs
//     in f32 in the exp2 domain (log2(e) folded into the scale); each
//     thread keeps its part of the row sum until the end;
//   * P stays in registers: the m16n8 accumulator layout of S is the A
//     fragment of P.V (bf16 m16n8k16: pairwise; tf32 m16n8k8: with each
//     8-key step's keys taken in the order 0, 2, 4, 6, 1, 3, 5, 7, and V's
//     rows read in the same order), so no P tile goes to shared memory and
//     no barrier separates the softmax from P.V;
//   * K/V tiles of BN keys come through a 2-stage ring in shared memory
//     filled by cp.async: tile j + 1 is issued right after the one barrier
//     of tile j, so its copy overlaps tile j's math.  The copy width is
//     the widest of 16, 8 or 4 bytes that divides the row's bytes, every
//     stride and the pointers (the wrapper's mma_copy_width); what is left
//     (bf16 at an odd hd, stride or pointer) takes plain 2-byte loads, and
//     no input is refused.  Rows past S or T are zero-filled;
//   * shared tiles are padded by 16 bytes a row (bf16: 2*HD + 16 bytes,
//     an odd multiple of 16, so ldmatrix's 8 row addresses hit 8 distinct
//     16-byte bank groups; f32: HD + 4 words, so the fragment reads of
//     Q, K (row g, column t) and of V (row 2t, column g) hit 32 distinct
//     banks);
//   * bf16: ldmatrix for Q and K, ldmatrix.trans for V.  P enters P.V as
//     two bf16 terms, hi = bf16(P) and lo = bf16(P - hi), as in the sm90
//     kernel: with one term an output moves past 1e-2 at hd 256;
//   * f32: Q, K, V and P are split as their fragments are read (a split
//     once in shared memory would need a second copy of every tile and a
//     barrier), each product three m16n8k8 tf32 mma.  The split masks
//     bits (split_tf32) rather than converting: cvt.rna.tf32.f32 issues
//     at a quarter of the ALU rate, and the kernel ran markedly slower
//     with it;
//   * tile geometry per instance (Geo): BN = 64 keys, but 32 at f32 HD
//     128 and 256, so that two CTAs share an SM (f32 HD 256: one), and 16
//     at bf16 HD 256, where 32 spill registers.
// wgmma is not used: its TF32 form wants both operands K-major in shared
// memory, which V is not, and TMA's 16-byte rule is what the inputs here
// (hd 12 bf16: 24-byte rows) break.  The kernel allocates nothing and
// launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // q rows per CTA
constexpr int kThreads = 128;  // 4 warps of 16 q rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// element strides of one (B, H, rows, hd) operand; hd is unit-stride
struct Strides {
  long long b, h, r;
};

// Shared-memory geometry of the instance at head dim HD: the 64-row Q tile,
// then K and V tiles of BN rows for stage 0 and stage 1, every row RS
// elements long (HD and a 16-byte pad).
template <int HD, typename Elem>
struct Geo {
  static constexpr bool F32 = sizeof(Elem) == 4;
  // keys a tile: 64; f32 takes 32 at HD 128 and 256 so that two CTAs
  // (one at 256) share an SM, bf16 16 at HD 256, where 32 spill
  static constexpr int BN =
      HD == 256 ? (F32 ? 32 : 16) : (F32 && HD == 128) ? 32 : 64;
  static constexpr int RS = HD + 16 / (int)sizeof(Elem);
  // Q.K^T's k steps unrolled at once: 8, and 2 at HD 256 to hold its
  // registers
  static constexpr int QK_UNROLL = HD == 256 ? 2 : 8;
  static constexpr int ROWS = kBM + 4 * BN;
  static constexpr int SMEM = ROWS * RS * (int)sizeof(Elem);
  static_assert(HD % 16 == 0, "instances are multiples of 16");
  static_assert(SMEM <= 227 * 1024, "over the per-block shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// -- loads ------------------------------------------------------------------

template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? W : 0;  // 0: zero-fill, nothing read
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(W), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows row0 .. row0 + NR - 1 of one operand (row stride rstride elements)
// into a tile of NR padded rows, W bytes a copy; rows at or past `limit`
// are zero-filled
template <int W, int NR, int RS, typename Elem>
__device__ __forceinline__ void copy_rows(Elem* tile, const Elem* src,
                                          long long rstride, int row0,
                                          int limit, int hd) {
  const int chunks = hd * (int)sizeof(Elem) / W;
  const char* base = reinterpret_cast<const char*>(src);
  for (int idx = threadIdx.x; idx < NR * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    const bool ok = row0 + r < limit;
    const long long row = ok ? (long long)(row0 + r) * rstride : 0;
    cp_async<W>(smem_addr(reinterpret_cast<char*>(tile + r * RS) + c * W),
                base + row * (long long)sizeof(Elem) + c * W, ok);
  }
}

template <int NR, int RS, typename Elem>
__device__ __forceinline__ void load_rows(Elem* tile, const Elem* src,
                                          long long rstride, int row0,
                                          int limit, int hd, int width) {
  switch (width) {
    case 16:
      copy_rows<16, NR, RS>(tile, src, rstride, row0, limit, hd);
      break;
    case 8:
      copy_rows<8, NR, RS>(tile, src, rstride, row0, limit, hd);
      break;
    case 4:
      copy_rows<4, NR, RS>(tile, src, rstride, row0, limit, hd);
      break;
    default:  // 2-byte rows, strides or pointers: plain loads
      for (int idx = threadIdx.x; idx < NR * hd; idx += kThreads) {
        const int r = idx / hd, c = idx - r * hd;
        tile[r * RS + c] = row0 + r < limit
                               ? src[(long long)(row0 + r) * rstride + c]
                               : from_f32<Elem>(0.f);
      }
  }
}

// -- tensor-core fragments ----------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small for 3xTF32: big is x with its low 13 mantissa bits
// cleared (a TF32 value), small = x - big is exact, and the tensor core
// reads small's top 19 bits (TF32 by truncation), so big + small keeps 21
// significant bits.  One integer and one float op a value, where
// cvt.rna.tf32.f32 for both parts would take two conversions, which issue
// at a quarter of the ALU rate.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// (a, b) = hi + lo, each a bf16 pair with a in the low half
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// S (16 x BN) += Q (16 x HD, the warp's rows) . K^T, and O (16 x HD) += P . V
// with P in S's registers; g = lane / 4 and t = lane % 4 as in the PTX
// fragment tables.
template <int HD, typename Elem>
struct Mma;

template <int HD>
struct Mma<HD, float> {
  using G = Geo<HD, float>;
  static constexpr int BN = G::BN, RS = G::RS;

  static __device__ __forceinline__ void qk(float (&s)[BN / 8][4],
                                            const float* sq, const float* sk,
                                            int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll (G::QK_UNROLL)
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float* qr = sq + g * RS + kk * 8 + t;
      uint32_t ab[4], as[4];
      split_tf32(qr[0], ab[0], as[0]);            // (g, t)
      split_tf32(qr[8 * RS], ab[1], as[1]);       // (g + 8, t)
      split_tf32(qr[4], ab[2], as[2]);            // (g, t + 4)
      split_tf32(qr[8 * RS + 4], ab[3], as[3]);   // (g + 8, t + 4)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const float* kr = sk + (nt * 8 + g) * RS + kk * 8 + t;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kr[0], bb0, bs0);   // (k t, key g)
        split_tf32(kr[4], bb1, bs1);   // (k t + 4, key g)
        mma_tf32(s[nt], as, bb0, bb1);
        mma_tf32(s[nt], ab, bs0, bs1);
        mma_tf32(s[nt], ab, bb0, bb1);
      }
    }
  }

  static __device__ __forceinline__ void pv(float (&o)[HD / 8][4],
                                            const float (&s)[BN / 8][4],
                                            const float* sv, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kt = 0; kt < BN / 8; ++kt) {
      // the 8-key step's k index t holds key 2t, k index t + 4 key 2t + 1
      uint32_t pb[4], ps[4];
      split_tf32(s[kt][0], pb[0], ps[0]);   // (g, key 2t)
      split_tf32(s[kt][2], pb[1], ps[1]);   // (g + 8, key 2t)
      split_tf32(s[kt][1], pb[2], ps[2]);   // (g, key 2t + 1)
      split_tf32(s[kt][3], pb[3], ps[3]);   // (g + 8, key 2t + 1)
      const float* vr = sv + (kt * 8 + 2 * t) * RS + g;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(vr[nt * 8], bb0, bs0);        // (key 2t, column g)
        split_tf32(vr[RS + nt * 8], bb1, bs1);   // (key 2t + 1, column g)
        mma_tf32(o[nt], ps, bb0, bb1);
        mma_tf32(o[nt], pb, bs0, bs1);
        mma_tf32(o[nt], pb, bb0, bb1);
      }
    }
  }
};

template <int HD>
struct Mma<HD, __nv_bfloat16> {
  using G = Geo<HD, __nv_bfloat16>;
  static constexpr int BN = G::BN, RS = G::RS;

  static __device__ __forceinline__ void qk(float (&s)[BN / 8][4],
                                            const __nv_bfloat16* sq,
                                            const __nv_bfloat16* sk,
                                            int lane) {
    // Q's four 8x8 matrices: rows 0-7 / 8-15 by lane bit 3, columns
    // +0 / +8 by lane bit 4; K's: keys +0 / +8 by lane bit 4, columns
    // +0 / +8 by lane bit 3 (b0, b1 of one 8-key tile, then of the next)
    const uint32_t qa = smem_addr(sq + (lane & 15) * RS + (lane >> 4) * 8);
    const uint32_t ka = smem_addr(sk + ((lane & 7) + (lane >> 4) * 8) * RS +
                                  ((lane >> 3) & 1) * 8);
#pragma unroll (G::QK_UNROLL)
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qa + kk * 32);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ka + (np * 16 * RS + kk * 16) * 2);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  static __device__ __forceinline__ void pv(float (&o)[HD / 8][4],
                                            const float (&s)[BN / 8][4],
                                            const __nv_bfloat16* sv,
                                            int lane) {
    // V's four 8x8 matrices, transposed: keys +0 / +8 by lane bit 3,
    // columns +0 / +8 by lane bit 4 (b0, b1 of one 8-column tile, then of
    // the next)
    const uint32_t va = smem_addr(sv + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                           RS + (lane >> 4) * 8);
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      uint32_t hi[4], lo[4];
      split_bf16x2(s[2 * kt][0], s[2 * kt][1], hi[0], lo[0]);
      split_bf16x2(s[2 * kt][2], s[2 * kt][3], hi[1], lo[1]);
      split_bf16x2(s[2 * kt + 1][0], s[2 * kt + 1][1], hi[2], lo[2]);
      split_bf16x2(s[2 * kt + 1][2], s[2 * kt + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, va + (kt * 16 * RS + np * 16) * 2);
        mma_bf16(o[2 * np], hi, b[0], b[1]);
        mma_bf16(o[2 * np], lo, b[0], b[1]);
        mma_bf16(o[2 * np + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * np + 1], lo, b[2], b[3]);
      }
    }
  }
};

// HD: the instance's head dim; hd <= HD: the call's.  width: the cp.async
// size in bytes (16, 8 or 4), or 0 for plain loads.  The launch bounds
// name one CTA an SM: without a minimum ptxas held the bf16 HD-16
// instance to 72 registers and spilled.
template <int HD, typename Elem>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_mma(const Elem* __restrict__ q, const Elem* __restrict__ k,
              const Elem* __restrict__ v, Elem* __restrict__ o, Strides qs,
              Strides ks, Strides vs, Strides os, int Hq, int Hkv, int S,
              int T, int hd, int causal, float scale_log2, int width) {
  using G = Geo<HD, Elem>;
  using M = Mma<HD, Elem>;
  constexpr int BN = G::BN, RS = G::RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* sq = reinterpret_cast<Elem*>(smem_raw);
  Elem* skv = sq + kBM * RS;  // stage i: K at skv + 2 i BN RS, then V

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const Elem* qp = q + b * qs.b + h * qs.h;
  const Elem* kp = k + b * ks.b + hk * ks.h;
  const Elem* vp = v + b * vs.b + hk * vs.h;
  Elem* op = o + b * os.b + h * os.h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // columns hd..HD-1 of every row stay zero; the copies write 0..hd-1
  if (hd < HD) {
    const int pad = HD - hd;
    for (int idx = threadIdx.x; idx < G::ROWS * pad; idx += kThreads) {
      const int r = idx / pad;
      sq[r * RS + hd + idx - r * pad] = from_f32<Elem>(0.f);
    }
  }
  load_rows<kBM, RS>(sq, qp, qs.r, q0, S, hd, width);
  // causal: keys past the block's last row (q0 + 63) are never needed
  const int kv_end = causal ? min(T, q0 + kBM) : T;
  const int n_tiles = (kv_end + BN - 1) / BN;
  load_rows<BN, RS>(skv, kp, ks.r, 0, T, hd, width);
  load_rows<BN, RS>(skv + BN * RS, vp, vs.r, 0, T, hd, width);
  cp_async_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16;  // the warp's rows: row0 + g (+ 8)

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();  // tile j (and Q) landed
    __syncthreads();      // ... for every warp; tile j - 1's stage is free
    if (j + 1 < n_tiles) {
      Elem* nk = skv + ((j + 1) & 1) * 2 * BN * RS;
      load_rows<BN, RS>(nk, kp, ks.r, (j + 1) * BN, T, hd, width);
      load_rows<BN, RS>(nk + BN * RS, vp, vs.r, (j + 1) * BN, T, hd, width);
      cp_async_commit();
    }
    const int kv0 = j * BN;
    if (causal && kv0 > row0 + 15) continue;  // above all 16 of the rows
    const Elem* sk = skv + (j & 1) * 2 * BN * RS;

    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    M::qk(s, sq + warp * 16 * RS, sk, lane);

    const bool masked = kv0 + BN > T || (causal && kv0 + BN - 1 > row0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows row0 + g and row0 + g + 8
      const int row = row0 + g + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * i + e] * scale_log2;
          if (masked) {
            const int key = kv0 + n * 8 + 2 * t + e;
            if (key >= T || (causal && key > row)) x = kNegInf;
          }
          s[n][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[n][2 * i + e] - m_new);
          s[n][2 * i + e] = p;
          sum += p;
        }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }
    M::pv(acc, s, sk + BN * RS, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float den = l[i];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    const int row = row0 + g + 8 * i;
    if (row >= S) continue;
    Elem* orow = op + row * os.r;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < hd) orow[c] = from_f32<Elem>(acc[n][2 * i] / den);
      if (c + 1 < hd) orow[c + 1] = from_f32<Elem>(acc[n][2 * i + 1] / den);
    }
  }
}

// the copy width the wrapper chose must hold for this operand
bool copies_align(const void* p, const Strides& st, int B, int H, int rows,
                  int hd, int size, int width) {
  if (width == 0) return true;
  if (width != 4 && width != 8 && width != 16) return false;
  const auto ok = [width](long long bytes) { return bytes % width == 0; };
  return ok((long long)reinterpret_cast<uintptr_t>(p)) &&
         ok((long long)hd * size) && (B == 1 || ok(st.b * size)) &&
         (H == 1 || ok(st.h * size)) && (rows == 1 || ok(st.r * size));
}

template <int HD, typename Elem>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides* st, int B, int Hq, int Hkv, int S, int T, int hd,
           int causal, float scale, int width, cudaStream_t stream) {
  constexpr int smem = Geo<HD, Elem>::SMEM;
  auto kernel = flash_fwd_mma<HD, Elem>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + kBM - 1) / kBM));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<Elem*>(o), st[0], st[1], st[2],
      st[3], Hq, Hkv, S, T, hd, causal, scale * kLog2e, width);
  return (int)cudaGetLastError();
}

// the instance of the smallest HD >= hd
template <typename Elem>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* strides, int B, int Hq, int Hkv, int S, int T,
             int hd, int causal, float scale, int width, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || T <= 0 ||
      hd <= 0 || hd > 256 || (S + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int size = (int)sizeof(Elem);
  if (!copies_align(q, st[0], B, Hq, S, hd, size, width) ||
      !copies_align(k, st[1], B, Hkv, T, hd, size, width) ||
      !copies_align(v, st[2], B, Hkv, T, hd, size, width))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_MMA_LAUNCH(HD_)                                              \
  return launch<HD_, Elem>(q, k, v, o, st, B, Hq, Hkv, S, T, hd, causal, \
                           scale, width, s)
  if (hd <= 16) REPRO_MMA_LAUNCH(16);
  if (hd <= 32) REPRO_MMA_LAUNCH(32);
  if (hd <= 48) REPRO_MMA_LAUNCH(48);
  if (hd <= 64) REPRO_MMA_LAUNCH(64);
  if (hd <= 128) REPRO_MMA_LAUNCH(128);
  REPRO_MMA_LAUNCH(256);
#undef REPRO_MMA_LAUNCH
}

}  // namespace

// float32, 3xTF32; any hd in 1..256.  strides holds 12 element strides,
// (batch, head, row) of q, k, v and o in that order; width is the copy
// width in bytes (16, 8 or 4; the Python wrapper's mma_copy_width).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take; the
// wrapper raises on anything but 0.
extern "C" int repro_flash_attention_mma_f32(const void* q, const void* k,
                                             const void* v, void* o,
                                             const long long* strides, int B,
                                             int Hq, int Hkv, int S, int T,
                                             int hd, int causal, float scale,
                                             int width, void* stream) {
  return dispatch<float>(q, k, v, o, strides, B, Hq, Hkv, S, T, hd, causal,
                         scale, width, stream);
}

// bfloat16, the same arguments; width may also be 0 (plain 2-byte loads)
extern "C" int repro_flash_attention_mma_bf16(const void* q, const void* k,
                                              const void* v, void* o,
                                              const long long* strides, int B,
                                              int Hq, int Hkv, int S, int T,
                                              int hd, int causal, float scale,
                                              int width, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, B, Hq, Hkv, S, T, hd,
                                 causal, scale, width, stream);
}
