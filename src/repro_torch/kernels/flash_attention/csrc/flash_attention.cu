// Blockwise (flash) attention, causal and/or sliding window, with GQA,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_kernel in
// src/repro/kernels/flash_attention/flash_attention.py (body
// _flash_kernel): out = softmax(q k^T * Dh^-0.5 + mask) v, the (S x T)
// score matrix never written to device memory, the running max and
// denominator in f32. Query head h reads kv head h / (H / Hkv), so
// grouped kv is never replicated. A row with no visible key gives exact
// zeros (every p is 0, the denominator clamped to >= 1e-30).
//
// Layout: the model's own. q and out are (B, S, H, Dh), k and v are
// (B, T, Hkv, Dh), all contiguous; the kernel reads rows of Dh values
// in place, so the wrapper transposes nothing.
//
// What bounds it: operations. At the serving slice's prefill shape
// (B = 8, H = 32, S = T = 2048, Dh = 64, causal, bf16) the two products
// are 4*B*H*Dh * (S*(S+1)/2) = 137.5 GFLOP against 268 MB of q, k, v and
// out: 0.139 ms at 989 TFLOP/s (bf16 tensor cores) against 0.080 ms at
// 3.35 TB/s. At Dh = 64 the exponentials are as long: one ex2 per score,
// 537 M of them at 16 a clock per SM, about 0.13 ms.
//
// bf16 path: warp-specialised, wgmma and TMA, persistent. A work tile
// is one head's 128 query rows; one block an SM walks the work tiles in
// a fixed order (a head's query tiles heaviest first, then the next
// head), so the causal tail stays short and the blocks resident at once
// share a few heads' K and V in L2. Three warpgroups a block:
// - warpgroup 2, the producer, gives its registers away (setmaxnreg.dec
//   to 40) and one of its threads issues TMA loads: each work tile's Q
//   once, then its K and V tiles of 128 keys into a ring of kStages
//   slots (3 at Dh = 64, 2 at Dh = 128), each slot with a full and an
//   empty mbarrier. The ring runs on across work tiles, so the next
//   tile's Q and first keys load while the consumers finish the current
//   one. The tensor maps address the model layout through its strides
//   (row stride H*Dh for q, Hkv*Dh for k and v; coordinates (column,
//   head, row, batch)), so nothing is copied; rows past S or T arrive as
//   zeros.
// - warpgroups 0 and 1, the consumers (setmaxnreg.inc to 232), own 64
//   query rows each. Per key tile: S = Q K^T by wgmma m64n128k16 with
//   both operands in shared memory (K-major); the online softmax on the
//   f32 accumulator, the scale folded into the exponent (one FMA and one
//   ex2.approx per score), maxima and sums as trees; p packed to bf16 in
//   place as the register A operand of O += P V, wgmma m64nDk16 with V
//   read from shared memory as an MN-major operand (the descriptor's
//   transpose bit), so V is never re-laid out. Lane 0 of each consumer
//   warp frees a slot once its warp's products have retired.
// - Overlap: the two consumers take turns on named barriers (bar.sync
//   1 + wg, 256). In its turn a warpgroup issues S for tile n and P V
//   for tile n - 1, hands the turn over and runs its softmax of tile n
//   while the other warpgroup's products run on the tensor cores. Its
//   own P V overlaps less than the order in the source suggests: ptxas
//   places the wait for it before the first write of the packed p (that
//   product's A operand), which it schedules early.
// Tiles are 1024-byte aligned and swizzled by 128 bytes, as TMA writes
// them and the wgmma descriptors read them; a tile is D/64 column
// blocks of 64 bf16 (one 128-byte row each), loaded as one TMA box each.
//
// Head dims: the kernel is compiled with a tile width D of 64 or 128 and
// a head dim DH <= D, a multiple of 16: Dh = 64 and 128 fill their tile,
// and Dh = 80 (zamba2-2.7b's shared attention) runs in the Dh = 128 tile.
// Its rows are 160 bytes, which no single 128-byte-swizzled box holds, so
// the tensor maps keep the head dim at 80 and the second box of a row
// (columns 64..127) reads columns 80..127 as zeros, TMA's fill for
// elements past the tensor's edge: nothing is padded or copied in device
// memory. S = Q K^T runs its 16-column steps over the first 80 columns
// only; O += P V runs over the whole tile, whose last 48 columns of V
// are zeros, and only the first 80 columns of O are stored. At zamba2's
// shape the two products so do 128/80 = 1.6x the work of Dh = 80 in P V
// and none extra in Q K^T; the exponentials, one a score, are as many as
// at any Dh.
//
// Budget (shared memory; registers a thread):
//   Dh = 64:  Q 16 KB + 3 x (K 16 KB + V 16 KB) = 112 KB;
//   Dh = 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB;
//   consumers hold S (64 f32), O (Dh/2 f32) and p (32 bf16 pairs), at
//   most 232 registers; the producer 40; 128 x 40 + 256 x 232 = 64,512
//   of the SM's 65,536. One block an SM.
//
// What holds it back (H100 SXM, scratch variants of this kernel with one
// part switched off at the prefill shape): the consumers' softmax alone
// runs about as long as the products alone, and the K and V traffic
// from L2 (each 128-row tile re-reads its head's K and V, 1.1 GB at
// Dh = 64) alone takes most of that again; the three overlap only in
// part.
//
// Key tiles wholly above the causal diagonal or outside the window are
// never visited; the element mask (two compares a score) is evaluated
// only on tiles that cut a mask edge (diagonal, window edge, ragged T:
// zero-filled keys must score -inf, not 0). A work tile whose rows see
// no key writes zeros and loads nothing.
//
// f32 path (the reduced CPU-sized configs; the TPU kernel takes any
// float dtype): plain f32 FMA, one warp per query row at a time, q
// upcast and scaled by Dh^-0.5 as the TPU kernel does, expf.
//
// Any S, T >= 0 is taken. Kernels launch on the caller's stream and
// allocate nothing. The driver's cuTensorMapEncodeTiled is reached
// through cudaGetDriverEntryPoint, so the library links no libcuda. The
// C entry point returns cudaGetLastError() after the launch, -1 for a
// dtype or head dim it does not take, or -2 when a tensor map cannot be
// made; the Python wrapper raises on any of them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ bool visible(int row, int key, int T, int causal, int window) {
  return key < T && (!causal || key <= row) && (window <= 0 || key > row - window);
}

// True when some (row, key) of the tile [q0, q0+bm) x [k0, k0+bn) is masked.
__device__ __forceinline__ bool tile_cuts_mask(int q0, int bm, int k0, int bn, int T,
                                               int causal, int window) {
  return k0 + bn > T || (causal && k0 + bn - 1 > q0) ||
         (window > 0 && k0 <= q0 + bm - 1 - window);
}

// Key tiles [t_lo, t_hi) that hold a key visible to some row of the query
// tile [q0, q0+bm); empty when no row sees any key.
__device__ __forceinline__ void key_tiles(int q0, int bm, int bn, int T, int causal,
                                          int window, int& t_lo, int& t_hi) {
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(T, q0 + bm) : T;
  t_lo = k_lo / bn;
  t_hi = k_lo < k_hi ? (k_hi + bn - 1) / bn : t_lo;
}

// ------------------------------------------------------------ bf16 path

constexpr int kBM = 128;        // query rows per block
constexpr int kBN = 128;        // keys per tile
constexpr int kConsumers = 2;   // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kCols = 64;       // bf16 columns of one 128-byte swizzled row
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared-memory plan (byte offsets from a 1024-aligned base).
template <int D>
struct Plan {
  static constexpr int kStages = D == 64 ? 3 : 2;  // K and V ring slots
  static constexpr int kQ = kBM * D * 2;          // Q tile
  static constexpr int kKV = kBN * D * 2;         // one K or V slot
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBars = kV + kStages * kKV;
  // q_full, q_empty, then per slot k_full, k_empty, v_full, v_empty
  static constexpr int kBytes = kBars + 8 * (2 + 4 * kStages) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Arrive when `pred`, without a branch.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((uint32_t)pred)
      : "memory");
}
// Arrive and announce the bytes the TMA loads of this phase will bring.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one box of a 4-D tensor map (column, head, row, batch) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row), "r"(batch),
      "r"(bar)
      : "memory");
}

// Named barriers 1 and 2 carry the consumers' turns (0 is __syncthreads).
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128 * kConsumers) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(128 * kConsumers) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// 128-byte swizzle. K-major (rows of 64 K values): sbo = 1024, the step
// between groups of 8 rows; lbo is not read. MN-major (rows of 64 N
// values, K down the rows): lbo is the step between 64-column blocks,
// sbo = 1024 the step between groups of 8 K rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin a register across an asynchronous wgmma: the compiler may not move
// its reads or writes past this point.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define FA_D8(i)                                                                      \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) = A (64 x 16) B (16 x 128) (+ d when `accumulate`);
// A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64), B in
// shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_pv_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) B (16 x 128), B in
// shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_pv_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef FA_D8

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (D == 64) wgmma_pv_n64(d, a, b);
  else wgmma_pv_n128(d, a, b);
}

// 2^x, one MUFU instruction; subnormal results flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void pin_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
}
template <int N>
__device__ __forceinline__ void pin_all(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i][0]), pin(r[i][1]), pin(r[i][2]), pin(r[i][3]);
}

// Issue S (64 x kBN) = Q K^T for this warpgroup's rows over the first DH
// columns: qd and kd describe the Q rows and the K slot, column blocks of
// 64 bf16 in 128-byte rows; a 16-deep step moves 32 bytes along a row. A descriptor
// moves by an offset in its address field (16-byte units), which no
// offset inside shared memory carries out of.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint64_t qd, uint64_t kd) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n128(sc, qd + ((kk / 4) * (kBM * 128) + (kk % 4) * 32) / 16,
                  kd + ((kk / 4) * (kBN * 128) + (kk % 4) * 32) / 16, kk > 0);
  wgmma_commit();
}

// Issue O += P V: p from registers, the V slot (descriptor vd) read
// MN-major (a 16-key step moves 16 rows; the column blocks lie kBN rows
// apart, the descriptor's lbo).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pf)[kBN / 16][4],
                                         uint64_t vd) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) wgmma_pv<D>(acc, pf[kk], vd + kk * 16 * 128 / 16);
  wgmma_commit();
}

struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
// t[0] op= t[W], ..., t[W-1] op= t[2W-1], then again with W/2, ...: a
// tree of depth log2(2W) instead of a chain of 2W - 1.
template <int W, int N, class Op>
__device__ __forceinline__ float fold(float (&t)[N], Op op) {
#pragma unroll
  for (int j = 0; j < W; ++j) t[j] = op(t[j], t[j + W]);
  if constexpr (W > 1) return fold<W / 2>(t, op);
  else return t[0];
}

// The online softmax of one thread's two rows (row0, row1 = row0 + 8) on
// raw scores; the scale (times log2 e) enters each exponent through one
// FMA. m is the running max, l this thread's share of the row sums.
struct Softmax {
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // Row r sees keys [lo[r], hi[r]], relative to this thread's first
  // key column 2 (lane % 4).
  int lo[2], hi[2], col;
  float scale_log2;

  __device__ __forceinline__ Softmax(int row0, int row1, int lane, int T, int causal,
                                     int window, float scale_log2_)
      : col(2 * (lane & 3)), scale_log2(scale_log2_) {
    const int rows[2] = {row0, row1};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lo[r] = window > 0 ? rows[r] - window + 1 : INT_MIN / 2;
      hi[r] = causal ? min(rows[r], T - 1) : T - 1;
    }
  }

  // sc: the scores of keys [k0, k0 + kBN), replaced by their p (f32);
  // `masked` when the tile cuts a mask edge (keys past T are zero-filled
  // and must score -inf). alpha rescales the old O.
  __device__ __forceinline__ void step(float (&sc)[kBN / 2], int k0, bool masked,
                                       float& alpha0, float& alpha1) {
    if (masked) {
      const int base = k0 + col;
      const int lo0 = lo[0] - base, hi0 = hi[0] - base, lo1 = lo[1] - base, hi1 = hi[1] - base;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * 8 + (e & 1);  // relative to base
          const bool seen = e < 2 ? (key >= lo0 && key <= hi0) : (key >= lo1 && key <= hi1);
          sc[4 * j + e] = seen ? sc[4 * j + e] : kNegInf;
        }
      }
    }
    // Maxima and sums as trees, so a warp's chains stay short.
    float t0[kBN / 8], t1[kBN / 8];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      t0[j] = fmaxf(sc[4 * j], sc[4 * j + 1]);
      t1[j] = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
    }
    float mx0 = fold<kBN / 16>(t0, Max()), mx1 = fold<kBN / 16>(t1, Max());
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    alpha0 = ex2((m[0] - mn0) * scale_log2);
    alpha1 = ex2((m[1] - mn1) * scale_log2);
    m[0] = mn0;
    m[1] = mn1;
    // A row whose max is still kNegInf has seen only masked keys (all
    // kNegInf): it subtracts 0, so each of its p is 2^(-1e30 c) = 0.
    const float sub0 = mn0 == kNegInf ? 0.f : mn0 * scale_log2;
    const float sub1 = mn1 == kNegInf ? 0.f : mn1 * scale_log2;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -sub0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -sub0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -sub1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -sub1));
      t0[j] = sc[4 * j] + sc[4 * j + 1];
      t1[j] = sc[4 * j + 2] + sc[4 * j + 3];
    }
    l[0] = l[0] * alpha0 + fold<kBN / 16>(t0, Sum());
    l[1] = l[1] * alpha1 + fold<kBN / 16>(t1, Sum());
  }
};

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], float alpha0, float alpha1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= alpha0;
    acc[4 * j + 1] *= alpha0;
    acc[4 * j + 2] *= alpha1;
    acc[4 * j + 3] *= alpha1;
  }
}

// p to bf16 in place: the C fragments of two 8-key blocks are the A
// fragment of one 16-key step.
__device__ __forceinline__ void pack_p(uint32_t (&pf)[kBN / 16][4], const float (&sc)[kBN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pf[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// One work tile: a head's 128 query rows, and the key tiles they see.
struct Work {
  int q0, h, b, t_lo, n_tiles;
  // Work tiles in order: a head's query tiles heaviest first, then the
  // next head, then the next batch row. Blocks resident at once so
  // share a few heads' K and V in L2 (with the head fastest they would
  // stream every head's K and V from device memory once per query tile).
  __device__ __forceinline__ Work(int w, int n_q, int H, int T, int causal, int window) {
    q0 = (n_q - 1 - w % n_q) * kBM;
    h = (w / n_q) % H;
    b = w / n_q / H;
    int t_hi;
    key_tiles(q0, kBM, kBN, T, causal, window, t_lo, t_hi);
    n_tiles = t_hi - t_lo;
  }
};

// Persistent: one block an SM walks work tiles w = blockIdx.x,
// blockIdx.x + gridDim.x, ... The K/V ring runs on across work tiles,
// so the producer loads the next tile's Q and first keys while the
// consumers finish the current one. D is the tile width, DH the head dim
// of q, k, v and out (see "Head dims" above).
template <int D, int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                     int B, int S, int T, int H, int Hkv, int causal, int window,
                     float scale_log2) {
  using P = Plan<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + P::kK, sv = base + P::kV;
  const uint32_t q_full = base + P::kBars, q_empty = q_full + 8;
  // Slot s's barriers at slot_bars + 32 s: k_full, k_empty, v_full, v_empty.
  const uint32_t slot_bars = q_full + 16;
  const int n_q = (S + kBM - 1) / kBM, n_work = n_q * H * B;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);                  // the producer
    mbar_init(q_empty, 4 * kConsumers);  // one thread of each consumer warp
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(slot_bars + 32 * s, 1);
      mbar_init(slot_bars + 32 * s + 8, 4 * kConsumers);
      mbar_init(slot_bars + 32 * s + 16, 1);
      mbar_init(slot_bars + 32 * s + 24, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else for the two roles, never reconverging, so that ptxas
  // honours setmaxnreg.
  if (threadIdx.x >= 128 * kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      int ring = 0, used = 0;  // K/V tiles loaded; work tiles with keys
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Work wk(w, n_q, H, T, causal, window);
        if (wk.n_tiles == 0) continue;
        const int hk = wk.h / (H / Hkv);
        mbar_wait(q_empty, (used & 1) ^ 1);  // the first wait is free
        mbar_expect_tx(q_full, P::kQ);
#pragma unroll
        for (int c = 0; c < D / kCols; ++c)
          tma_load(sq + c * kBM * 128, &tq, q_full, c * kCols, wk.h, wk.q0, wk.b);
        ++used;
        for (int it = 0; it < wk.n_tiles; ++it, ++ring) {
          const int s = ring % P::kStages;
          const uint32_t free_parity = ((ring / P::kStages) & 1) ^ 1;
          const uint32_t bars = slot_bars + 32 * s;
          const int k0 = (wk.t_lo + it) * kBN;
          mbar_wait(bars + 8, free_parity);
          mbar_expect_tx(bars, P::kKV);
#pragma unroll
          for (int c = 0; c < D / kCols; ++c)
            tma_load(sk + s * P::kKV + c * kBN * 128, &tk, bars, c * kCols, hk, k0, wk.b);
          mbar_wait(bars + 24, free_parity);
          mbar_expect_tx(bars + 16, P::kKV);
#pragma unroll
          for (int c = 0; c < D / kCols; ++c)
            tma_load(sv + s * P::kKV + c * kBN * 128, &tv, bars + 16, c * kCols, hk, k0, wk.b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    // Lane 0 of each consumer warp releases a slot once its warp's
    // products have retired (a predicate, not a branch).
    const bool lead = lane == 0;
    // Descriptors of this warpgroup's rows of Q and of K and V slot 0;
    // slot s lies s * kKV bytes on.
    const uint64_t qd = sw128_desc(sq + wg * 64 * 128, 16, 1024);
    const uint64_t kd = sw128_desc(sk, 16, 1024), vd = sw128_desc(sv, kBN * 128, 1024);
    constexpr uint64_t kSlot = P::kKV / 16;
    const int64_t q_stride = (int64_t)H * DH;  // between consecutive positions
    int ring = 0, used = 0;

    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const Work wk(w, n_q, H, T, causal, window);
      const int row0 = wk.q0 + 64 * wg + warp * 16 + lane / 4, row1 = row0 + 8;
      float acc[D / 2];  // O: D/8 column blocks of 8, four values a thread each
                         // (the blocks past DH hold zeros)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      Softmax sm(row0, row1, lane, T, causal, window, scale_log2);

      if (wk.n_tiles > 0) {
        const int n = wk.n_tiles;
        float sc[kBN / 2];         // S, then p in f32: kBN/8 blocks of 8 keys
        uint32_t pf[kBN / 16][4];  // p in bf16, the A operand of P V
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
#pragma unroll
        for (int i = 0; i < kBN / 16; ++i) pf[i][0] = pf[i][1] = pf[i][2] = pf[i][3] = 0u;
        // A turn issues this warpgroup's products: S for tile 0 (turn
        // 0), S for tile it and P V for tile it - 1 (turn it), P V for
        // the last tile (turn n). Warpgroup 0 takes the first turn, and
        // warpgroup 1 hands over after each of its turns but the last,
        // so each named barrier sees as many passes as waits. No branch
        // lies between a product's issue and its wait (ptxas would
        // serialise the wgmmas), so the first and last turns are peeled.
        // Q is released once the last S is in.
        if (wg == 1) turn_pass(1);
        mbar_wait(q_full, used & 1);
        ++used;

        uint32_t bars = slot_bars + 32 * (ring % P::kStages);
        mbar_wait(bars, (ring / P::kStages) & 1);
        turn_wait(my_turn);
        pin_all(sc);
        wgmma_fence();
        issue_qk<DH>(sc, qd, kd + (ring % P::kStages) * kSlot);
        turn_pass(their_turn);
        wgmma_wait<0>();
        pin_all(sc);
        mbar_arrive_if(bars + 8, lead);  // K slot free
        mbar_arrive_if(q_empty, lead && n == 1);
        float alpha0, alpha1;
        sm.step(sc, wk.t_lo * kBN,
                tile_cuts_mask(wk.q0, kBM, wk.t_lo * kBN, kBN, T, causal, window), alpha0,
                alpha1);
        pack_p(pf, sc);

        for (int it = 1; it < n; ++it) {
          const int r = ring + it, s = r % P::kStages, ps = (r - 1) % P::kStages;
          bars = slot_bars + 32 * s;
          const uint32_t pbars = slot_bars + 32 * ps;
          const int k0 = (wk.t_lo + it) * kBN;
          mbar_wait(bars, (r / P::kStages) & 1);
          mbar_wait(pbars + 16, ((r - 1) / P::kStages) & 1);
          turn_wait(my_turn);
          pin_all(sc);
          pin_all(acc);
          pin_all(pf);
          wgmma_fence();
          issue_qk<DH>(sc, qd, kd + s * kSlot);
          issue_pv<D>(acc, pf, vd + ps * kSlot);
          turn_pass(their_turn);
          wgmma_wait<1>();  // S is in; P V of the previous tile may still run
          pin_all(sc);
          mbar_arrive_if(bars + 8, lead);  // K slot free
          mbar_arrive_if(q_empty, lead && it == n - 1);
          sm.step(sc, k0, tile_cuts_mask(wk.q0, kBM, k0, kBN, T, causal, window), alpha0,
                  alpha1);
          wgmma_wait<0>();
          pin_all(acc);
          pin_all(pf);
          mbar_arrive_if(pbars + 24, lead);  // V slot free
          // O holds tiles < it: bring it to the new max, then pack p as
          // the next turn's A operand (which the wait above freed).
          rescale<D>(acc, alpha0, alpha1);
          pack_p(pf, sc);
        }

        const int lr = ring + n - 1, ls = lr % P::kStages;
        bars = slot_bars + 32 * ls;
        mbar_wait(bars + 16, (lr / P::kStages) & 1);
        turn_wait(my_turn);
        pin_all(acc);
        pin_all(pf);
        wgmma_fence();
        issue_pv<D>(acc, pf, vd + ls * kSlot);
        wgmma_wait<0>();
        pin_all(acc);
        pin_all(pf);
        mbar_arrive_if(bars + 24, lead);
        if (wg == 0) turn_pass(their_turn);
        ring += n;
      }

      float l0 = sm.l[0], l1 = sm.l[1];
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float r0 = 1.f / fmaxf(l0, 1e-30f), r1 = 1.f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* ob = o + ((int64_t)wk.b * S * H + wk.h) * DH + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        if (row0 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row0 * q_stride + j * 8) =
              __floats2bfloat162_rn(acc[4 * j] * r0, acc[4 * j + 1] * r0);
        if (row1 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row1 * q_stride + j * 8) =
              __floats2bfloat162_rn(acc[4 * j + 2] * r1, acc[4 * j + 3] * r1);
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, rows, heads, dh) bf16 tensor as a 4-D map (column, head, row,
// batch) whose box is 64 columns of one head over `box_rows` rows,
// swizzled by 128 bytes; rows past the end, and columns past dh, read as
// zeros.
bool make_map(CUtensorMap* map, const void* ptr, int dh, int heads, int rows, int B,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)rows * heads * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kCols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                int S, int T, int causal, int window, float scale, cudaStream_t stream) {
  static_assert(DH <= D && DH % 16 == 0, "head dim within the tile, in 16-column steps");
  CUtensorMap tq, tk, tv;
  // With T = 0 no block loads a key: q stands in for k and v, unread.
  const void* kp = T > 0 ? k : q;
  const void* vp = T > 0 ? v : q;
  const int rows = T > 0 ? T : 1;
  if (!make_map(&tq, q, DH, H, S, B, kBM) || !make_map(&tk, kp, DH, Hkv, rows, B, kBN) ||
      !make_map(&tv, vp, DH, Hkv, rows, B, kBN))
    return -2;
  constexpr int smem = Plan<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16<D, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const long long n_work = (long long)((S + kBM - 1) / kBM) * H * B;
  if (n_work > INT_MAX) return -1;
  flash_attention_bf16<D, DH><<<(unsigned)(n_work < sms ? n_work : sms), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, T, H, Hkv, causal, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- f32 path

constexpr int kF32Rows = 16;     // query rows per block, two per warp
constexpr int kF32Keys = 32;     // keys per tile, one per lane
constexpr int kF32Threads = 256;

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int S, int T, int H,
                    int Hkv, int causal, int window, float scale) {
  constexpr int kPer = (D + 31) / 32;  // output columns per lane (the last ragged at D = 80)
  __shared__ float qs[kF32Rows][D];
  __shared__ float ks[kF32Keys][D + 1];  // padded: lane j reads row j
  __shared__ float vs[kF32Keys][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kF32Rows;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const float* qb = q + ((int64_t)b * S * H + h) * D;
  const float* kb = k + ((int64_t)b * T * Hkv + hk) * D;
  const float* vb = v + ((int64_t)b * T * Hkv + hk) * D;
  float* ob = o + ((int64_t)b * S * H + h) * D;

  for (int i = threadIdx.x; i < kF32Rows * D; i += kF32Threads) {
    const int r = i / D, c = i % D;
    qs[r][c] = q0 + r < S ? qb[(int64_t)(q0 + r) * q_stride + c] * scale : 0.f;
  }

  int t_lo, t_hi;
  key_tiles(q0, kF32Rows, kF32Keys, T, causal, window, t_lo, t_hi);
  float acc[2][kPer] = {};
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kF32Keys;
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = threadIdx.x; i < kF32Keys * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < T;
      ks[r][c] = ok ? kb[(int64_t)(k0 + r) * kv_stride + c] : 0.f;
      vs[r][c] = ok ? vb[(int64_t)(k0 + r) * kv_stride + c] : 0.f;
    }
    __syncthreads();
    const bool masked = tile_cuts_mask(q0, kF32Rows, k0, kF32Keys, T, causal, window);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 2 + rr;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      if (masked && !visible(q0 + r, k0 + lane, T, causal, window)) s = kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m_run[rr], mx);
      const float alpha = expf(m_run[rr] - mn);
      const float p = mn == kNegInf ? 0.f : expf(s - mn);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[rr] = l_run[rr] * alpha + sum;
      m_run[rr] = mn;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[rr][i] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kF32Keys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          if (D % 32 == 0 || lane + 32 * i < D)
            acc[rr][i] = fmaf(pj, vs[j][lane + 32 * i], acc[rr][i]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + warp * 2 + rr;
    if (row >= S) continue;
    const float denom = fmaxf(l_run[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (D % 32 == 0 || lane + 32 * i < D)
        ob[(int64_t)row * q_stride + lane + 32 * i] = acc[rr][i] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
               int S, int T, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid(H, B, (S + kF32Rows - 1) / kF32Rows);
  flash_attention_f32<D><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, T, H, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: (B, S, H, D); k, v: (B, T, Hkv, D); contiguous, one dtype
// (0 = f32, 1 = bf16); H a multiple of Hkv; D 64, 80 or 128. scale is
// D^-0.5. out may not alias an input.
int flash_attention(const void* q, const void* k, const void* v, void* out, int dtype, int B,
                    int H, int Hkv, int S, int T, int D, int causal, int window, float scale,
                    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && D == 64)
    return launch_bf16<64, 64>(q, k, v, out, B, H, Hkv, S, T, causal, window, scale, s);
  if (dtype == kBF16 && D == 80)
    return launch_bf16<128, 80>(q, k, v, out, B, H, Hkv, S, T, causal, window, scale, s);
  if (dtype == kBF16 && D == 128)
    return launch_bf16<128, 128>(q, k, v, out, B, H, Hkv, S, T, causal, window, scale, s);
  if (dtype == kF32 && D == 64)
    return launch_f32<64>(q, k, v, out, B, H, Hkv, S, T, causal, window, scale, s);
  if (dtype == kF32 && D == 80)
    return launch_f32<80>(q, k, v, out, B, H, Hkv, S, T, causal, window, scale, s);
  if (dtype == kF32 && D == 128)
    return launch_f32<128>(q, k, v, out, B, H, Hkv, S, T, causal, window, scale, s);
  return -1;
}

}  // extern "C"
