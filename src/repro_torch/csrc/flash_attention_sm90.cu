// bf16 flash-attention forward for Hopper (sm_90a): TMA loads, wgmma on
// the tensor cores, one producer and two consumer warpgroups.  Bound to
// Python through a plain C interface (ctypes; see
// repro_torch/kernels/build.py); every bf16 CUDA call of
// repro_torch::flash_attention at hd 32, 64, 128 or 256 launches it, and
// csrc/flash_attention_mma.cu takes f32 and the other head dims.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (wrapper `flash_attention`, pallas_call at line 108).  Semantics kept:
//   * q (B, Hq, S, hd), k/v (B, Hkv, T, hd), Hq % Hkv == 0, kv head =
//     q head / (Hq / Hkv) (GQA/MQA without materialised repeats);
//   * any batch, head and row strides that are multiples of 16 bytes (the
//     head dim is unit-stride), so the model's (B, S, H, hd) activations
//     are read and the output is written in that layout;
//   * scores are q.k * scale; softmax with f32 m, l and acc;
//   * masks: kv_pos < T (ragged tail) and, when causal, kv_pos <= q_pos
//     with q counted from 0 (top-left alignment, also when S != T);
//     masked scores take the finite value -1e30, as in the TPU kernel;
//   * out = acc / max(l, 1e-30), rounded to bf16.
// The tensor cores take P in bf16; it enters P.V as two bf16 terms (see
// below), which tests/test_torch_kernels.py emulates.
//
// What bounds it on this card: causal self-attention does ~2*S*S*hd flops
// per (b, head) against ~4*S*hd elements moved, S/4 flops per bf16 byte:
// below the H100's ~295 flops/byte ridge up to S ~ 1200 (bytes bound: 80 us
// at b=8, Hq=32, S=1024, hd=128), above it beyond (operations, 989 TFLOP/s
// bf16).  It feeds the tensor cores (wgmma) from TMA-loaded tiles so
// that neither the loads nor the address arithmetic sit on the math's
// path.
//
// Design (the FlashAttention-3 forward, simplified):
//   * one CTA of 3 warpgroups per (b*Hq, 128-row q block); heavy (late)
//     causal q blocks launch first.  Warpgroup 0 is the producer: one
//     thread issues the TMA loads (Q once, then K and V tiles of BN keys
//     into a 2-stage ring with "full" and "empty" mbarriers); setmaxnreg
//     gives it 24 registers and the consumers 240.  Warpgroups 1 and 2 are
//     consumers, each owning 64 of the 128 q rows;
//   * BN = 128 keys a tile at hd 32, 64 and 128.  At hd 256 a 128-key
//     tile would need 64 KiB Q + 2 stages x (64 + 64) KiB K/V = 320 KiB of
//     shared memory, over the 227 KiB a block may have, so hd 256 takes
//     64-key tiles: 64 + 2 x (32 + 32) = 192 KiB.  Its O accumulator is
//     128 f32 a thread; with the 64-key S tile (32) and P's two bf16 terms
//     (16 + 16) that stays under the consumers' 240 registers.  With 128
//     q rows over 64-key tiles two tiles cross the diagonal; a consumer
//     whose 64 rows all lie above a tile (causal) skips its math and only
//     releases the stage;
//   * shared tiles use the TMA's 128-byte swizzle over 64-column panels at
//     hd >= 64 (a row of hd 128 is two panels, of hd 256 four) and the
//     64-byte swizzle at hd 32; the wgmma descriptors name the same
//     swizzle;
//   * S = Q.K^T: wgmma m64nBNk16, A and B from shared memory, both
//     K-major.  Softmax in registers: a row lives in 4 threads of the
//     accumulator layout, so its max is 2 xor shuffles; the row sum stays
//     per thread until the end; exp2f with log2(e) folded into the scale.
//     The mask is applied only on tiles that cross the diagonal or the
//     ragged end (TMA fills rows past T with zeros, a score of 0 that must
//     still be masked);
//   * O += P.V: P goes to bf16 in registers and is the A operand from
//     registers (the f32 accumulator layout maps onto the A fragment
//     pairwise); V is B from shared memory, MN-major (transpose bit set).
//     P enters as two bf16 terms, hi = bf16(P) and lo = bf16(P - hi), so
//     P.V keeps ~16 bits of P: with P alone in bf16 (8 bits) the outputs
//     differ from the f32 softmax by ~1e-3 relative, and through the four
//     bf16 layers of llama2_1b one logit in 32,000 moved 0.0575 from the
//     plain path's, past the 5e-2 that chip_smoke.py holds it to.  The
//     second term costs 8 more wgmma per tile (half again the tensor work);
//   * epilogue: O / max(l, 1e-30) to bf16, staged through the consumer's
//     own rows of the Q tile and written with 16-byte stores, rows >= S
//     skipped.
// Not done yet: no overlap of one tile's softmax with the next Q.K^T inside
// a warpgroup, no ping-pong between the two consumers, no persistent tile
// scheduler.  The kernel allocates nothing and launches on the caller's
// stream.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // q rows per CTA (64 per consumer warpgroup)
constexpr int kThreads = 384;   // producer + 2 consumer warpgroups
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry at head dim HD: the 128-row Q tile and the BN-row
// K and V tiles, each stored as NPANEL panels of PC bf16 columns.
template <int HD>
struct Geo {
  static constexpr int BN = HD > 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int PC = HD >= 64 ? 64 : 32;   // columns per swizzle panel
  static constexpr int ROWB = PC * 2;             // bytes of a panel row
  static constexpr int NPANEL = HD / PC;
  static constexpr int QPANEL = kBM * ROWB;       // bytes of a Q panel
  static constexpr int QTILE = NPANEL * QPANEL;   // 128 * HD * 2 bytes
  static constexpr int KPANEL = BN * ROWB;        // bytes of a K/V panel
  static constexpr int KTILE = NPANEL * KPANEL;   // BN * HD * 2 bytes
  static constexpr int KPP = PC / 16;             // k16 steps per panel
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte swizzle
  static constexpr uint64_t LAYOUT = HD >= 64 ? 1 : 2;
  static constexpr uint32_t SWZ = HD >= 64 ? 7 : 3;
  // Q at 0, K stages at QTILE, V stages at QTILE + 2 * KTILE, then the 5
  // mbarriers
  static constexpr int BARS = QTILE + 4 * KTILE;
  // the tiles, the mbarriers, and slack to align the base to 1 KB; at
  // least 116 KB, so that a second CTA never shares the SM and holds the
  // registers that the consumers' setmaxnreg.inc waits for
  static constexpr int SMEM =
      BARS + 64 + 1024 > 116 * 1024 ? BARS + 64 + 1024 : 116 * 1024;
  static_assert(SMEM <= 227 * 1024, "over the per-block shared memory");
};

// the swizzle the TMA applies to a byte offset from a 1 KB-aligned tile
template <int HD>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & Geo<HD>::SWZ) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a 4-D (hd, rows, heads, batch) tensor into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor (start, leading and stride byte
// offsets in 16-byte units; swizzle layout in bits 62-63)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving register reads or reuse across an
// asynchronous wgmma: after wait_group, each register is "redefined" here
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x N, f32) = A (64 x 16) . B (16 x N)^T; A and B from shared
// memory, both K-major; scale_d = 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N, f32) += P (64 x 16, bf16 in registers) . V (16 x N); V from
// shared memory, MN-major (transpose bit set)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, "
      "p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;"
      "\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#undef D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One consumer warpgroup: 64 q rows against every kv tile the producer
// delivers.  Accumulator layout (wgmma m64nN, f32): register i of thread
// (warp w, lane l) holds row 16w + l/4 + 8*((i/2)%2), column
// 8*(i/4) + 2*(l%4) + i%2, so a row's values sit in the 4 threads of a quad.
// At hd 256 (BN 64) a causal tile can lie wholly above the first
// consumer's rows; that consumer releases it without computing.
template <int HD>
__device__ __forceinline__ void consume(uint32_t base, uint8_t* gbase, int cw,
                                        int q0, int b, int h, int S, int T,
                                        int n_tiles, int causal,
                                        float scale_log2,
                                        __nv_bfloat16* __restrict__ o,
                                        long long os_b, long long os_h,
                                        long long os_r) {
  using G = Geo<HD>;
  constexpr int BN = G::BN;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int row0 = 16 * warp + lane / 4;  // first of the thread's two rows
  const int qmin = q0 + 64 * cw;          // this warpgroup's first q row
  const int qrow0 = qmin + row0;
  const uint32_t sQ = base + 64 * cw * G::ROWB;
  const uint32_t bars = base + G::BARS;  // q_full, full[2], empty[2]

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(bars, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int kv0 = it * BN;
    const uint32_t sK = base + G::QTILE + st * G::KTILE;
    const uint32_t sV = base + G::QTILE + (2 + st) * G::KTILE;
    mbar_wait(bars + 8 * (1 + st), (it >> 1) & 1);
    if (causal && kv0 > qmin + 63) {  // every key above every row here
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (3 + st));
      continue;
    }

    float s[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t col = (kk % G::KPP) * 32;
      wgmma_ss<BN>(
          s,
          smem_desc(sQ + (kk / G::KPP) * G::QPANEL + col, 16, 8 * G::ROWB,
                    G::LAYOUT),
          smem_desc(sK + (kk / G::KPP) * G::KPANEL + col, 16, 8 * G::ROWB,
                    G::LAYOUT),
          kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // tiles that cross the diagonal or the ragged end get the mask
    if (kv0 + BN > T || (causal && kv0 + BN - 1 > qmin)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = kv0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int row = qrow0 + 8 * ((i / 2) % 2);
        if (col >= T || (causal && col > row)) s[i] = kNegInf;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float corr[2], nb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = exp2f((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      nb[r] = -mx[r] * scale_log2;
      l[r] *= corr[r];
    }
    // P in the A-fragment layout: p[j] packs s[2j], s[2j+1] (row j % 2),
    // as two bf16 terms, hi = bf16(P) and lo = bf16(P - hi)
    uint32_t p[BN / 4], plo[BN / 4];
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) {
      const float p0 = exp2f(fmaf(s[2 * j], scale_log2, nb[j % 2]));
      const float p1 = exp2f(fmaf(s[2 * j + 1], scale_log2, nb[j % 2]));
      l[j % 2] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      p[j] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[j] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i / 2) % 2];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv = smem_desc(sV + kk * 16 * G::ROWB, G::KPANEL,
                                    8 * G::ROWB, G::LAYOUT);
      wgmma_rs<HD>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                   p[4 * kk + 3], dv);
      wgmma_rs<HD>(acc, plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
                   plo[4 * kk + 3], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(p);
    fence_regs(plo);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (3 + st));  // release the stage
  }

  // epilogue: this warpgroup's rows of the Q tile hold O in bf16
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) {
    const int rr = 64 * cw + row0 + 8 * (j % 2);
    const int col = 8 * (j / 2) + 2 * (lane % 4);
    const uint32_t off =
        (col / G::PC) * G::QPANEL + rr * G::ROWB + (col % G::PC) * 2;
    *reinterpret_cast<uint32_t*>(gbase + swizzle<HD>(off)) =
        pack_bf16(acc[2 * j] * inv[j % 2], acc[2 * j + 1] * inv[j % 2]);
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row
  __nv_bfloat16* orow = o + b * os_b + h * os_h;
  for (int idx = tw; idx < 64 * kChunks; idx += 128) {
    const int rr = idx / kChunks;
    const int col = (idx % kChunks) * 8;
    const int q = qmin + rr;
    if (q >= S) break;  // rows grow with idx
    const uint32_t off = (col / G::PC) * G::QPANEL +
                         (64 * cw + rr) * G::ROWB + (col % G::PC) * 2;
    *reinterpret_cast<uint4*>(orow + q * os_r + col) =
        *reinterpret_cast<const uint4*>(gbase + swizzle<HD>(off));
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, long long os_b, long long os_h,
               long long os_r, int Hq, int Hkv, int S, int T, int causal,
               float scale_log2) {
  using G = Geo<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + G::BARS;  // q_full, full[2], empty[2]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int b = bh / Hq, h = bh % Hq;
  // causal: keys past the block's last row (q0 + kBM - 1) are never needed
  const int kv_end = causal ? min(T, q0 + kBM) : T;
  const int n_tiles = (kv_end + G::BN - 1) / G::BN;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init(bars + 16, 1);
    mbar_init(bars + 24, 8);  // one arrive per consumer warp
    mbar_init(bars + 32, 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 0) {
      const int hk = h / (Hq / Hkv);
      mbar_expect_tx(bars, G::QTILE);
#pragma unroll
      for (int pnl = 0; pnl < G::NPANEL; ++pnl)
        tma_load(base + pnl * G::QPANEL, &tm_q, bars, pnl * G::PC, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        const uint32_t full = bars + 8 * (1 + st);
        mbar_wait(bars + 8 * (3 + st), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(full, 2 * G::KTILE);
#pragma unroll
        for (int pnl = 0; pnl < G::NPANEL; ++pnl) {
          tma_load(base + G::QTILE + st * G::KTILE + pnl * G::KPANEL, &tm_k,
                   full, pnl * G::PC, it * G::BN, hk, b);
          tma_load(base + G::QTILE + (2 + st) * G::KTILE + pnl * G::KPANEL,
                   &tm_v, full, pnl * G::PC, it * G::BN, hk, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    consume<HD>(base, gbase, threadIdx.x / 128 - 1, q0, b, h, S, T, n_tiles,
                causal, scale_log2, o, os_b, os_h, os_r);
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// 4-D map (hd, rows, heads, batch) of a bf16 operand, boxes of box_rows
// rows; strides in elements for (batch, head, row), each a multiple of 8
// (16 bytes)
template <int HD>
bool encode(CUtensorMap* map, const void* ptr, int rows, int heads,
            int batch, const long long* st, int box_rows) {
  using G = Geo<HD>;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::PC, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE,
                   HD >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Hq, int Hkv, int S, int T,
           int causal, float scale, cudaStream_t stream) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode<HD>(&tq, q, S, Hq, B, st, kBM) ||
      !encode<HD>(&tk, k, T, Hkv, B, st + 3, Geo<HD>::BN) ||
      !encode<HD>(&tv, v, T, Hkv, B, st + 6, Geo<HD>::BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_sm90<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<HD>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + kBM - 1) / kBM));
  kernel<<<grid, kThreads, Geo<HD>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], Hq,
      Hkv, S, T, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; hd in {32, 64, 128, 256}.  strides holds 12 element strides,
// (batch, head, row) of q, k, v and o in that order, each a multiple of 8
// elements (16 bytes), and the four pointers are 16-byte aligned (the
// Python wrapper checks both).  Returns cudaGetLastError() after the
// launch (0 on success); the wrapper raises on anything else.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* o,
                                          const long long* strides, int B,
                                          int Hq, int Hkv, int S, int T,
                                          int hd, int causal, float scale,
                                          void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || T <= 0 ||
      (S + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, strides, B, Hq, Hkv, S, T, causal, scale,
                        s);
    case 64:
      return launch<64>(q, k, v, o, strides, B, Hq, Hkv, S, T, causal, scale,
                        s);
    case 128:
      return launch<128>(q, k, v, o, strides, B, Hq, Hkv, S, T, causal, scale,
                         s);
    case 256:
      return launch<256>(q, k, v, o, strides, B, Hq, Hkv, S, T, causal, scale,
                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
