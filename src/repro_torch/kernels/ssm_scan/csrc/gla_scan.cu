// Chunked gated linear recurrence (the Mamba2 SSD / mLSTM scan) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gla_scan_kernel in
// src/repro/kernels/ssm_scan/ssm_scan.py (body _gla_kernel):
//
//   H_t = a_t H_{t-1} + k_t v_t^T,   y_t = q_t^T H_t,   H_0 = 0,
//
// evaluated a chunk of C positions at a time, in f32. Within a chunk,
// la = cumsum(log(max(a, 1e-12))), and
//   y = exp(la) * (q @ H)                      (inter-chunk read)
//     + select(t >= s, (q k^T) * exp(la_t - la_s), 0) @ v   (intra-chunk)
//   H <- exp(la_end) H + (k * exp(la_end - la))^T @ v       (carry)
// The upper triangle is dropped by a select, as in the TPU kernel, so
// the exp(la_t - la_s) > 1 that overflows there for small decays never
// enters the sum (the JAX package's plain chunked_gla multiplies by a 0/1
// mask instead and gives NaN there). la is summed in f64 from f32 logs:
// the differences la_t - la_s of two sums near -800 (decays of 1e-6) keep
// their digits.
//
// Layout: the model's own. a is (B, S, H); k and q are (B, S, H, dk); v
// is (B, S, H, dv); any strides over (B, S, H), the last axis of k, v, q
// contiguous; each operand f32 or bf16, copied to shared memory as it is
// and upcast in registers, so no f32 copy of an operand is made. y is
// (B, S, H, dv) f32, contiguous. Ragged S (the last chunk) and ragged dk,
// dv are masked in the kernel (zero-filled copies, a = 1, unstored rows
// and columns).
//
// What bounds it. At the zamba2-2.7b Mamba2 shape (B = 8, S = 2048, H =
// 80, dk = dv = 64, k and q bf16 and shared by the heads) the work is 27
// GFLOP against 681 MB: bytes bound it (0.20 ms at 3.35 TB/s). At the
// xlstm-1.3b mLSTM shape (H = 4, dk = 1024, dv = 1025, f32) it is 284
// GFLOP against 1.1 GB: operations bound it, 1.7 ms as 3xTF32 at the
// 495 TFLOP/s TF32 rate. mma.sync reaches 270-285 TFLOP/s in TF32 on the
// H100 (probe.py rates), so about 3 ms is the floor of this route there.
// What the design does about it:
//
// 1. The score product q k^T is formed once, by gla_scores: one block a
//    (batch row, chunk) where k and q are both shared by the heads
//    (stride 0), else a (batch.head, chunk), writes the chunk's raw
//    scores (the causal 8x8 tiles only, in the lane order of the walk's
//    fragments) to a scratch buffer the wrapper allocates. Every path,
//    shared or not, runs the same code in the same order, so a stride-0
//    k and q give the bits of dense copies.
// 2. All four products run on the tensor cores as mma.sync m16n8k8 TF32
//    with 3xTF32: x = hi + lo, both TF32 by truncation (3 instructions;
//    cvt.rna takes 5 for each half), a b = a_lo b_hi + a_hi b_lo +
//    a_hi b_hi with f32 accumulators, about 2^-20 of each product. bf16 k
//    and q are exact in TF32: when both are bf16 (EXACT) their products
//    take one pass (scores) or two, and ldmatrix brings them.
// 3. gla_walk: a block owns one (batch.head, 64-column slice of dv) and
//    walks the chunks in order. Its state slice lies in shared memory as
//    the mma accumulator fragments of H^T, each thread's own four floats
//    at a time: the carry accumulates into them and the read takes them
//    as its A operand with the k index permuted to match, so no thread
//    reads another's state. Where dk > 64 the (dk x 64) state is too
//    large for one SM, and a cluster of four blocks splits dk: each walks
//    its quarter and the cluster sums the four outputs (and its two
//    warps' dk halves) in a fixed order through distributed shared
//    memory. One 64-column slice a block halves the q and k traffic of
//    32-column slices (xlstm: 33 slices read a head's q and k).
// 4. Loads are issued a step ahead and cost the warps nothing: q and k
//    tiles (KT dk columns, KT + 8 wide so the rows keep the padding that
//    makes the fragment loads conflict-free) and v tiles come as TMA
//    boxes, the score tiles as one bulk copy, each completing on an
//    mbarrier; where a stride is no multiple of 16 bytes (xlstm's v, dv =
//    1025) cp.async copies instead, each block of a cluster a quarter of
//    the rows, pushed to the others. One barrier a step, one more a chunk.
// 5. The chunk's decayed scores P = select(t >= s, scores exp(la_t -
//    la_s), 0) are formed once a block, in place; la is summed in f64 and
//    kept as f32 pairs (hi, lo), whose differences keep the digits of two
//    sums near -800. The carry runs G state tiles at once, one
//    accumulator each, so that G chains of products overlap.
//
// Configurations by dk (W state columns a block, warps, KT dk rows a step):
//   dk <= 64:   W = 64, 4 warps, KT = 64, no cluster (2 blocks an SM)
//   dk <= 1024: W = 64, 8 warps, KT = 64, clusters of 4 blocks
//   dk <= 1536: W = 64, 8 warps, KT = 32, clusters of 4 blocks
//
// A call makes two CUDA launches, gla_scores then gla_walk, on the
// caller's stream. No atomics: two calls give the same bits. The kernels
// allocate nothing. The C entry point returns cudaGetLastError() after
// the launches, or -1 for a chunk, dtype or size it does not take; the
// Python wrapper raises on either.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDK = 1536;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90
constexpr float kLogEps = 1e-12f;

enum DType { kF32 = 0, kBF16 = 1 };

struct Operand {
  const void* p;
  int64_t sb, ss, sh;  // element strides between batches, positions, heads
  int dtype;
  int vec;  // bytes one copy moves: 16, 8 or 4 (cp.async), or 2 (plain loads)
};

struct Params {
  Operand a, k, v, q;
  float* y;
  float* scores;  // scratch: raw causal score tiles, (B * kq_heads, n_chunks, T, 64)
  int S, H, dk, dv;
  int kq_heads;  // H, or 1 where k and q are both shared by the heads
  int n_chunks;
  int tma_qk, tma_v;  // the q and k (v) tiles come by TMA, else by cp.async
};

__host__ __device__ constexpr int score_tiles(int c) { return (c / 8) * (c / 8 + 1) / 2; }

__device__ __forceinline__ float load(const Operand& x, int64_t i) {
  return x.dtype == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x.p)[i])
                          : static_cast<const float*>(x.p)[i];
}

// One element (or a pair) of a tile in shared memory, f32 or bf16, without
// a branch: the aligned word (pair of words) that holds it, then selects.
__device__ __forceinline__ float lds1(const unsigned char* row, int col, bool bf16) {
  const int off = bf16 ? 2 * col : 4 * col;
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + (off & ~3));
  const uint32_t h = off & 2 ? w & 0xffff0000u : w << 16;
  return __uint_as_float(bf16 ? h : w);
}
__device__ __forceinline__ float2 lds2(const unsigned char* row, int col, bool bf16) {
  const int off = bf16 ? 2 * col : 4 * col;  // col is even
  const uint2 w = *reinterpret_cast<const uint2*>(row + (off & ~7));
  const uint32_t u = off & 4 ? w.y : w.x;
  return bf16 ? make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u))
              : make_float2(__uint_as_float(w.x), __uint_as_float(w.y));
}

// ---- cp.async ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int size, int valid) {
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid)
                 : "memory");
  else if (size == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// mbarriers and TMA: a tile comes as one box of a 4-D tensor map
// (column, head, row, batch), a run of bytes as one bulk copy; both
// complete on an mbarrier that expects their bytes.
__device__ __forceinline__ void mbar_init(void* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(void* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(void* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, void* bar, int col,
                                         int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row), "r"(batch),
      "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Rows s0 .. s0 + rows - 1 and columns c0 .. c0 + cols - 1 of operand x
// (row s at element base + s * x.ss) into shared memory, `pitch` bytes a
// row, in x's dtype; zeros past row S and column ncols. cols * element
// size is a power of two and a multiple of x.vec.
template <int NT>
__device__ __forceinline__ void copy_tile(unsigned char* dst, int pitch, const Operand& x,
                                          int64_t base, int s0, int S, int rows, int c0,
                                          int ncols, int cols, int tid) {
  const int es = x.dtype == kBF16 ? 2 : 4, vec = x.vec, per = vec / es;
  const int chunks = cols * es / vec, shift = __ffs(chunks) - 1;
  const unsigned char* src0 = static_cast<const unsigned char*>(x.p);
  for (int i = tid; i < rows * chunks; i += NT) {
    const int r = i >> shift, col = c0 + (i & (chunks - 1)) * per, s = s0 + r;
    const int n = s < S ? min(max(ncols - col, 0), per) : 0;
    const unsigned char* src = n ? src0 + (base + (int64_t)s * x.ss + col) * es : src0;
    unsigned char* d = dst + r * pitch + (i & (chunks - 1)) * vec;
    if (vec >= 4) {
      cp_async(smem_addr(d), src, vec, n * es);
    } else {  // a bf16 operand aligned to 2 bytes only: a plain load
      *reinterpret_cast<uint16_t*>(d) = n ? *reinterpret_cast<const uint16_t*>(src) : 0;
    }
  }
}

// The bytes copy_tile(dst, pitch, x, ..., rows, ..., cols, tid) moved for
// this thread, from this block's shared memory to the same offsets in the
// other blocks of its cluster (rank q is this block).
template <int NT, int CL>
__device__ __forceinline__ void push_tile(const unsigned char* dst, int pitch, const Operand& x,
                                          int rows, int cols, int tid, int q) {
  const int es = x.dtype == kBF16 ? 2 : 4, vec = x.vec;
  const int chunks = cols * es / vec, shift = __ffs(chunks) - 1;
  for (int i = tid; i < rows * chunks; i += NT) {
    const unsigned char* d = dst + (i >> shift) * pitch + (i & (chunks - 1)) * vec;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (vec == 16)
      w = *reinterpret_cast<const uint4*>(d);
    else if (vec == 8)
      w.x = reinterpret_cast<const uint2*>(d)->x, w.y = reinterpret_cast<const uint2*>(d)->y;
    else if (vec == 4)
      w.x = *reinterpret_cast<const uint32_t*>(d);
    else
      w.x = *reinterpret_cast<const uint16_t*>(d);
    for (int rk = 1; rk < CL; ++rk) {
      uint32_t a;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(d)), "r"((q + rk) % CL));
      if (vec == 16)
        asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(w.x), "r"(w.y),
                     "r"(w.z), "r"(w.w) : "memory");
      else if (vec == 8)
        asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(a), "r"(w.x), "r"(w.y) : "memory");
      else if (vec == 4)
        asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(a), "r"(w.x) : "memory");
      else
        asm volatile("st.shared::cluster.b16 [%0], %1;\n" ::"r"(a), "h"((unsigned short)w.x) : "memory");
    }
  }
}

// ---- 3xTF32 on mma.sync ----

// x = hi + lo to about 2^-20 of x, both TF32: hi keeps the top 10 mantissa
// bits (truncated), lo the exact remainder truncated likewise. Three
// instructions; cvt.rna.tf32 would take five for each half.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

// d += a b, A 16x8 (row), B 8x8 (col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b with both split: the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}
// d += a b with b exact in TF32.
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&b)[2]) {
  mma(d, al, b);
  mma(d, ah, b);
}

// ---- phase 1: raw scores q k^T, once per (batch row or batch.head, chunk) ----

constexpr int kScoreKT = 32;

__host__ __device__ constexpr int score_pitch(bool bf16) {
  // 4 mod 32 words: the fragment loads below hit 32 banks
  return bf16 ? (kScoreKT + 8) * 2 : (kScoreKT + 4) * 4;
}

// One block (4 warps) a (batch row or batch.head, chunk). Warp m owns the
// 16 query rows 16m .. 16m + 15 and the key columns of the causal 8x8
// tiles of those rows. The key index inside an n8 tile is permuted (slot
// n holds key n / 2 + 4 (n % 2)) so that each lane's accumulator pairs
// land in the order the walk reads them: tile (k, j) of the scratch holds,
// for lane L, the scores (t = 8j + L/4, s = 8k + L%4) and (t, s + 4).
template <int C, bool EXACT>
__global__ void __launch_bounds__(128) gla_scores(const Params p) {
  constexpr int KT = kScoreKT, J = C / 8, T = score_tiles(C);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int c = blockIdx.x, bhs = blockIdx.y;
  const int b = bhs / p.kq_heads, hs = bhs % p.kq_heads;
  const bool q16 = p.q.dtype == kBF16, k16 = p.k.dtype == kBF16;
  const int qp = score_pitch(q16), kp = score_pitch(k16), slot = C * (qp + kp);
  const int64_t q_base = b * p.q.sb + hs * p.q.sh, k_base = b * p.k.sb + hs * p.k.sh;
  const int steps = max(1, (p.dk + KT - 1) / KT);
  const int m = warp;
  const bool active = m < C / 16;

  auto issue = [&](int st) {
    unsigned char* d = smem + (st & 1) * slot;
    copy_tile<128>(d, qp, p.q, q_base, c * C, p.S, C, st * KT, p.dk, KT, tid);
    copy_tile<128>(d + C * qp, kp, p.k, k_base, c * C, p.S, C, st * KT, p.dk, KT, tid);
  };
  issue(0);
  cp_async_commit();

  float acc[J][4];
#pragma unroll
  for (int k = 0; k < J; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;

  for (int st = 0; st < steps; ++st) {
    cp_async_wait_all();
    __syncthreads();
    if (st + 1 < steps) issue(st + 1);
    cp_async_commit();
    if (!active) continue;
    const unsigned char* qs = smem + (st & 1) * slot;
    const unsigned char* ks = qs + C * qp;
    const unsigned char* qa = qs + (16 * m + gid) * qp;
    const unsigned char* qb = qa + 8 * qp;
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      const int d0 = 8 * kk + tig;
      const float a4[4] = {lds1(qa, d0, q16), lds1(qb, d0, q16), lds1(qa, d0 + 4, q16),
                           lds1(qb, d0 + 4, q16)};
      uint32_t ah[4], al[4];
      if constexpr (EXACT) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ah[i] = __float_as_uint(a4[i]);
      } else {
        split(a4, ah, al);
      }
#pragma unroll
      for (int k = 0; k < J; ++k) {
        if (k > 2 * m + 1) continue;
        const unsigned char* kr = ks + (8 * k + gid / 2 + 4 * (gid % 2)) * kp;
        const float b2[2] = {lds1(kr, d0, k16), lds1(kr, d0 + 4, k16)};
        if constexpr (EXACT) {
          const uint32_t bb[2] = {__float_as_uint(b2[0]), __float_as_uint(b2[1])};
          mma(acc[k], ah, bb);
        } else {
          uint32_t bh[2], bl[2];
          split(b2, bh, bl);
          mma3(acc[k], ah, al, bh, bl);
        }
      }
    }
  }
  if (!active) return;
  float2* out = reinterpret_cast<float2*>(p.scores + ((int64_t)bhs * p.n_chunks + c) * T * 64);
#pragma unroll
  for (int k = 0; k < J; ++k) {
    const int j = 2 * m;
    if (k <= j) out[(j * (j + 1) / 2 + k) * 32 + lane] = make_float2(acc[k][0], acc[k][1]);
    if (k <= j + 1)
      out[((j + 1) * (j + 2) / 2 + k) * 32 + lane] = make_float2(acc[k][2], acc[k][3]);
  }
}

// ---- phase 2: the walk over the chunks ----

// The walk's shared memory, byte offsets the same on host and device: the
// state, two chunk buffers (the v tile, then the score tiles), la of two
// chunks (f32 pairs), the cluster's partial outputs, then a ring of q and
// k tiles.
struct Layout {
  int qp, kp, vp;     // row pitches (bytes) of the q, k and v tiles
  int slot;           // one ring slot: a q tile, then a k tile
  int vbytes, cbuf;   // a chunk buffer: the v tile, then the score tiles
  int dkc, nsteps;    // dk rows a block owns (a multiple of KT); steps a chunk
  int slots;          // ring slots (tiles in flight + 1)
  int chunk, la, bars, recv, ring, total;
};

template <int C, int MT, int NR, int G, int CL>
__host__ __device__ Layout walk_layout(int dk, bool q16, bool k16, bool v16) {
  constexpr int KT = 8 * NR * G, W = 16 * MT, J = C / 8;
  Layout L;
  // KT + 8 and W + 8 elements a row: the fragment loads hit 32 banks.
  L.qp = (KT + 8) * (q16 ? 2 : 4);
  L.kp = (KT + 8) * (k16 ? 2 : 4);
  L.vp = (W + 8) * (v16 ? 2 : 4);
  L.slot = C * (L.qp + L.kp);
  const int share = (dk + CL - 1) / CL;
  L.nsteps = share > KT ? (share + KT - 1) / KT : 1;
  L.dkc = L.nsteps * KT;
  L.vbytes = C * L.vp;
  L.cbuf = L.vbytes + score_tiles(C) * 64 * 4;
  L.chunk = W * L.dkc * 4;
  L.la = L.chunk + 2 * L.cbuf;
  L.bars = L.la + 2 * C * 8;  // mbarriers: the ring slots', then the chunk buffers'
  L.recv = L.bars + 64;
  L.ring = (L.recv + (CL > 1 ? CL * NR * (MT / CL) * J * 32 * 16 : 0) + 127) / 128 * 128;
  // More tiles in flight where one block fills the SM anyway and they fit.
  L.slots = 2;
  if (CL > 1)
    while (L.slots < 4 && L.slots < L.nsteps + 1 && L.ring + (L.slots + 1) * L.slot <= kMaxSmem)
      ++L.slots;
  L.total = L.ring + L.slots * L.slot;
  return L;
}

__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8); with .trans each is transposed.
__device__ __forceinline__ void ldsm4(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4t(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// A pair of bf16 as the B fragment of a TF32 product (exact).
__device__ __forceinline__ void bf16_pair(uint32_t u, uint32_t (&b)[2]) {
  b[0] = u << 16;
  b[1] = u & 0xffff0000u;
}

// Thread block clusters: every thread of every block of the cluster;
// a float4 into the same offset of another block's shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void st_cluster(const void* p, int rank, float4 v) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// exp(la_t - la_s) from la kept as f32 pairs (hi, lo), hi + lo = la to f64
// digits: the difference of the hi parts is exact where it matters.
__device__ __forceinline__ float decay_of(float2 t, float2 s) {
  return __expf((t.x - s.x) + (t.y - s.y));
}

// TMA writes a tile to a 128-byte aligned row-major box; the pitches
// above make every tile and chunk buffer start on 128 bytes.

// A block owns the (dkc x W) state of one (batch.head, W-column slice of
// dv, rank q of CL dk shares): the CL blocks of a cluster split dk, each
// walking its share, and sum their outputs through distributed shared
// memory. Inside a block MT x NR warps: warp (wt, r) owns state columns
// 16 wt .. 16 wt + 15 and, each step, G tiles of 8 of the step's KT rows.
template <int C, int MT, int NR, int G, int CL, bool EXACT>
__global__ void __launch_bounds__(32 * MT * NR)
    gla_walk(const Params p, const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  constexpr int NT = 32 * MT * NR, KT = 8 * NR * G, W = 16 * MT, J = C / 8;
  constexpr int T = score_tiles(C);
  constexpr int E = C > 32 ? C / 32 : 1;  // positions of a chunk a lane sums into la
  static_assert(CL > 1 || NR == 1, "a block's dk shares are summed through the cluster");
  static_assert(MT % CL == 0, "each block of a cluster finishes whole column tiles");
  constexpr bool LDSM = EXACT && G % 4 == 0;  // bf16 k tiles four at a time by ldmatrix
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int wt = warp % MT, r = warp / MT;  // the warp's 16 state columns and dk share
  const int q = blockIdx.x % CL;            // the block's rank in its cluster: its dk share
  const int j0 = blockIdx.x / CL * W;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const bool live = j0 + 16 * wt < p.dv;  // the last slice may leave a warp no column
  const bool q16 = p.q.dtype == kBF16, k16 = p.k.dtype == kBF16, v16 = p.v.dtype == kBF16;
  const Layout L = walk_layout<C, MT, NR, G, CL>(p.dk, q16, k16, v16);
  const int ahead = L.slots - 1;  // tiles in flight
  const int dk0 = q * L.dkc;

  const int64_t a_base = b * p.a.sb + h * p.a.sh, k_base = b * p.k.sb + h * p.k.sh;
  const int64_t v_base = b * p.v.sb + h * p.v.sh, q_base = b * p.q.sb + h * p.q.sh;
  const int hs = p.kq_heads == 1 ? 0 : h;
  const float* sc_base = p.scores + (int64_t)(b * p.kq_heads + hs) * p.n_chunks * T * 64;

  float4* state = reinterpret_cast<float4*>(smem);
  for (int i = tid; i < L.chunk / 16; i += NT) state[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);  // [slots], then [2]
  if (tid == 0) {
    for (int i = 0; i < L.slots + 2; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int total = p.n_chunks * L.nsteps;
  auto slot_of = [&](int f) { return smem + L.ring + (f % L.slots) * L.slot; };
  auto buf_of = [&](int c) { return smem + L.chunk + (c & 1) * L.cbuf; };
  // The q and k tiles of step f: one TMA box each (KT + 8 columns, the
  // padding read from the next columns or as zeros past dk), or cp.async.
  auto issue_tile = [&](int f) {
    const int c = f / L.nsteps, i = f - c * L.nsteps;
    unsigned char* d = slot_of(f);
    if (p.tma_qk) {
      if (tid == 0) {
        uint64_t* bar = bars + f % L.slots;
        mbar_expect_tx(bar, L.slot);
        tma_load(d, &tq, bar, dk0 + i * KT, hs, c * C, b);
        tma_load(d + C * L.qp, &tk, bar, dk0 + i * KT, hs, c * C, b);
      }
    } else {
      copy_tile<NT>(d, L.qp, p.q, q_base, c * C, p.S, C, dk0 + i * KT, p.dk, KT, tid);
      copy_tile<NT>(d + C * L.qp, L.kp, p.k, k_base, c * C, p.S, C, dk0 + i * KT, p.dk, KT, tid);
    }
  };
  // A chunk's v tile (TMA where its strides allow, else cp.async: each
  // block of a cluster copies C / CL rows and pushes them to the others
  // before the cluster's next barrier) and its score tiles (one bulk copy).
  constexpr int VR = C / CL;  // v rows a block of the cluster copies
  auto issue_chunk = [&](int c) {
    unsigned char* d = buf_of(c);
    if (!p.tma_v)
      copy_tile<NT>(d + q * VR * L.vp, L.vp, p.v, v_base, c * C + q * VR, p.S, VR, j0, p.dv, W, tid);
    if (tid == 0) {
      uint64_t* bar = bars + L.slots + (c & 1);
      mbar_expect_tx(bar, (p.tma_v ? L.vbytes : 0) + T * 256);
      if (p.tma_v) tma_load(d, &tv, bar, j0, h, c * C, b);
      bulk_load(d + L.vbytes, sc_base + (int64_t)c * T * 64, T * 256, bar);
    }
  };
  // Warp 0 keeps a one chunk ahead in registers and writes la of a chunk
  // (inclusive cumsum of log(max(a, 1e-12)) in f64, kept as an f32 pair;
  // positions past S add 0) to its half of the la buffer, a barrier
  // before the chunk starts.
  float a_next[E];
  auto load_a = [&](int c) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = lane * E + e, s = c * C + t;
      a_next[e] = t < C && s < p.S ? load(p.a, a_base + (int64_t)s * p.a.ss) : 1.f;
    }
  };
  auto write_la = [&](int c) {
    double x[E], own = 0.0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float av = a_next[e];
      x[e] = lane * E + e < C ? (double)logf(av != av ? av : fmaxf(av, kLogEps)) : 0.0;
      own += x[e];
    }
    double inc = own;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const double n = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += n;
    }
    double run = inc - own;
    float2* la = reinterpret_cast<float2*>(smem + L.la) + (c & 1) * C;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      run += x[e];
      const float hi = (float)run;
      if (lane * E + e < C) la[lane * E + e] = make_float2(hi, (float)(run - (double)hi));
    }
    if (c + 1 < p.n_chunks) load_a(c + 1);
  };

  for (int f = 0; f < ahead; ++f) {
    if (f < total) issue_tile(f);
    if (f == 0) issue_chunk(0);
    cp_async_commit();
  }
  if (warp == 0) {
    load_a(0);
    write_la(0);
  }
  auto share_chunk = [&](int c) {
    if (!p.tma_v) {
      cp_async_wait(0);
      push_tile<NT, CL>(buf_of(c) + q * VR * L.vp, L.vp, p.v, VR, W, tid, q);
    }
  };
  if constexpr (CL > 1) {
    cluster_sync();  // every block of the cluster is running
    share_chunk(0);
    cluster_sync();
  }

  float yr[J][4];                 // y^T of the chunk: (w, t) fragments
  uint32_t vdh[J][4], vdl[J][4];  // (v * exp(la_end - la_s))^T as A fragments, split
  float decay = 0.f;

  for (int f = 0; f < total; ++f) {
    const int c = f / L.nsteps, i = f - c * L.nsteps;
    cp_async_wait(ahead - 1);
    if (p.tma_qk) mbar_wait(bars + f % L.slots, (f / L.slots) & 1);
    if (i == 0) mbar_wait(bars + L.slots + (c & 1), (c >> 1) & 1);
    __syncthreads();  // this step's tiles are in; every warp is done with the last step's
    if (f + ahead < total) issue_tile(f + ahead);
    if (i == 0 && c + 1 < p.n_chunks) issue_chunk(c + 1);
    cp_async_commit();

    const float2* la = reinterpret_cast<const float2*>(smem + L.la) + (c & 1) * C;
    unsigned char* buf = buf_of(c);
    const float2* pt = reinterpret_cast<const float2*>(buf + L.vbytes);
    if (i == 0) {
      // The chunk's P = select(t >= s, scores exp(la_t - la_s), 0), once a
      // block, in place over the score tiles (lane order of the fragments).
      float2* sc = reinterpret_cast<float2*>(buf + L.vbytes);
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int k = 0; k <= j; ++k) {
          const int tile = j * (j + 1) / 2 + k;
          if (tile % (NT / 32) != warp) continue;
          const int t = 8 * j + gid, s = 8 * k + tig;
          const float2 lt = la[t];
          float2 v = sc[tile * 32 + lane];
          v.x = t >= s ? v.x * decay_of(lt, la[s]) : 0.f;
          v.y = t >= s + 4 ? v.y * decay_of(lt, la[s + 4]) : 0.f;
          sc[tile * 32 + lane] = v;
        }
      const float2 le = la[C - 1];
      decay = __expf(le.x + le.y);
#pragma unroll
      for (int j = 0; j < J; ++j) yr[j][0] = yr[j][1] = yr[j][2] = yr[j][3] = 0.f;
      if (live) {
        // The carry's A operand (v * exp(la_end - la_s))^T. LDSM: k comes
        // transposed by ldmatrix, k slot tig is s 2 tig and slot tig + 4 is
        // s 2 tig + 1; else slot tig is s tig.
#pragma unroll
        for (int k = 0; k < J; ++k) {
          const int sa = LDSM ? 8 * k + 2 * tig : 8 * k + tig, sb = LDSM ? sa + 1 : sa + 4;
          const int w = 16 * wt + gid;
          const float ga = decay_of(le, la[sa]), gb = decay_of(le, la[sb]);
          const unsigned char* va = buf + sa * L.vp;
          const unsigned char* vb = buf + sb * L.vp;
          const float d4[4] = {lds1(va, w, v16) * ga, lds1(va, w + 8, v16) * ga,
                               lds1(vb, w, v16) * gb, lds1(vb, w + 8, v16) * gb};
          split(d4, vdh[k], vdl[k]);
        }
      }
      __syncthreads();  // P is in
    }

    if (live) {
      // This step's KT rows of the block's dk share. Read first (y^T +=
      // H^T q^T, the state as it stood before the chunk), then carry (H^T
      // <- decay H^T + (v d)^T k). The state fragment of (w, dk) holds
      // (gid, 2 tig), (gid, 2 tig + 1), (gid + 8, 2 tig), (gid + 8,
      // 2 tig + 1): as an A operand, k slot tig is dk 2 tig and slot
      // tig + 4 is dk 2 tig + 1.
      const unsigned char* qs = slot_of(f);
      const unsigned char* ks = qs + C * L.qp;
      float4* hrow = state + (i * (KT / 8) + r * G) * MT * 32 + wt * 32 + lane;
      float acc[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int col = (r * G + g) * 8;
        const float4 hv = hrow[g * MT * 32];
        acc[g][0] = hv.x * decay, acc[g][1] = hv.y * decay;
        acc[g][2] = hv.z * decay, acc[g][3] = hv.w * decay;
        const float h4[4] = {hv.x, hv.z, hv.y, hv.w};
        uint32_t ah[4], al[4];
        split(h4, ah, al);
        if constexpr (EXACT) {
#pragma unroll
          for (int j = 0; j < J; j += 4) {
            uint32_t qm[4];
            ldsm4(qs + (8 * j + lane) * L.qp + 2 * col, qm);
#pragma unroll
            for (int m = 0; m < 4 && j + m < J; ++m) {
              uint32_t bb[2];
              bf16_pair(qm[m], bb);
              mma2(yr[j + m], ah, al, bb);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float2 q2 = lds2(qs + (8 * j + gid) * L.qp, col + 2 * tig, q16);
            const float b2[2] = {q2.x, q2.y};
            uint32_t bh[2], bl[2];
            split(b2, bh, bl);
            mma3(yr[j], ah, al, bh, bl);
          }
        }
      }
      // The carry of the G tiles at once, one accumulator each.
#pragma unroll
      for (int k = 0; k < J; ++k) {
        if constexpr (LDSM) {
#pragma unroll
          for (int g = 0; g < G; g += 4) {
            uint32_t km[4];
            ldsm4t(ks + (8 * k + lane % 8) * L.kp + 2 * ((r * G + g + lane / 8) * 8), km);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              uint32_t bb[2];
              bf16_pair(km[m], bb);
              mma2(acc[g + m], vdh[k], vdl[k], bb);
            }
          }
        } else {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int col = (r * G + g) * 8;
            const float b2[2] = {lds1(ks + (8 * k + tig) * L.kp, col + gid, k16),
                                 lds1(ks + (8 * k + tig + 4) * L.kp, col + gid, k16)};
            if constexpr (EXACT) {
              const uint32_t bb[2] = {__float_as_uint(b2[0]), __float_as_uint(b2[1])};
              mma2(acc[g], vdh[k], vdl[k], bb);
            } else {
              uint32_t bh[2], bl[2];
              split(b2, bh, bl);
              mma3(acc[g], vdh[k], vdl[k], bh, bl);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        hrow[g * MT * 32] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }

    if (i == L.nsteps - 1) {
      if (live) {
        // y^T = exp(la_t) (read) + v^T P^T, the warps of a column tile
        // across the cluster taking the t tiles in turn.
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float2 l0 = la[8 * j + 2 * tig], l1 = la[8 * j + 2 * tig + 1];
          const float e0 = __expf(l0.x + l0.y), e1 = __expf(l1.x + l1.y);
          yr[j][0] *= e0, yr[j][1] *= e1, yr[j][2] *= e0, yr[j][3] *= e1;
        }
#pragma unroll
        for (int k = 0; k < J; ++k) {
          const int w = 16 * wt + gid;
          const unsigned char* va = buf + (8 * k + tig) * L.vp;
          const unsigned char* vb = buf + (8 * k + tig + 4) * L.vp;
          const float v4[4] = {lds1(va, w, v16), lds1(va, w + 8, v16), lds1(vb, w, v16),
                               lds1(vb, w + 8, v16)};
          uint32_t vah[4], val[4];
          split(v4, vah, val);
#pragma unroll
          for (int j = k; j < J; ++j) {
            if (CL * NR > 1 && j % (CL * NR) != q * NR + r) continue;
            const float2 p2 = pt[(j * (j + 1) / 2 + k) * 32 + lane];
            const float b2[2] = {p2.x, p2.y};
            uint32_t ph[2], pl[2];
            split(b2, ph, pl);
            mma3(yr[j], vah, val, ph, pl);
          }
        }
      }
      bool owner = true;
      if constexpr (CL > 1) {
        // The dk shares of the cluster: column tile wt is finished by rank
        // wt % CL, which sums the (rank, r) outputs in that order.
        float4* recv = reinterpret_cast<float4*>(smem + L.recv) + (wt / CL) * CL * NR * J * 32 + lane;
        const int dst = wt % CL;
        if (live) {
#pragma unroll
          for (int j = 0; j < J; ++j)
            st_cluster(recv + ((q * NR + r) * J + j) * 32, dst,
                       make_float4(yr[j][0], yr[j][1], yr[j][2], yr[j][3]));
        }
        if (c + 1 < p.n_chunks) share_chunk(c + 1);
        cluster_sync();
        owner = r == 0 && dst == q;
        if (live && owner) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            float4 s = recv[j * 32];
            for (int u = 1; u < CL * NR; ++u) {
              const float4 o = recv[(u * J + j) * 32];
              s.x += o.x, s.y += o.y, s.z += o.z, s.w += o.w;
            }
            yr[j][0] = s.x, yr[j][1] = s.y, yr[j][2] = s.z, yr[j][3] = s.w;
          }
        }
        cluster_sync();  // the partial outputs are read: the buffer is free
      }
      if (live && owner) {
        const int64_t row = (int64_t)p.H * p.dv;
        const int w = j0 + 16 * wt + gid;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int t = c * C + 8 * j + 2 * tig;
          float* yp = p.y + (((int64_t)b * p.S + t) * p.H + h) * p.dv + w;
          if (t < p.S) {
            if (w < p.dv) yp[0] = yr[j][0];
            if (w + 8 < p.dv) yp[8] = yr[j][2];
          }
          if (t + 1 < p.S) {
            if (w < p.dv) yp[row] = yr[j][1];
            if (w + 8 < p.dv) yp[row + 8] = yr[j][3];
          }
        }
      }
      // The next chunk's la, visible after the next step's barrier; the
      // la of this chunk's other half is no longer read.
      if (warp == 0 && c + 1 < p.n_chunks) write_la(c + 1);
    }
  }
}

// ---- launch ----

// The scores kernel's dynamic shared memory: two chunks of q and k rows.
template <int C>
int scores_smem(bool q16, bool k16) {
  return 2 * C * (score_pitch(q16) + score_pitch(k16));
}

template <int C, bool EXACT>
int launch_scores(const Params& p, int B, cudaStream_t stream) {
  const int smem = scores_smem<C>(p.q.dtype == kBF16, p.k.dtype == kBF16);
  cudaError_t err = cudaFuncSetAttribute(gla_scores<C, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gla_scores<C, EXACT><<<dim3(p.n_chunks, B * p.kq_heads), 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// Operand x, (B, S, heads, cols), as a 4-D map (column, head, row, batch)
// whose box is `box_cols` columns of one head over `box_rows` rows;
// reads past the ends give zeros. False where TMA cannot take it: an
// address or a stride of more than one element that is not a multiple of
// 16 bytes, or a zero stride.
bool make_map(CUtensorMap* map, const Operand& x, int cols, int heads, int rows, int B,
              int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  const int es = x.dtype == kBF16 ? 2 : 4;
  const int64_t st[3] = {heads > 1 ? x.sh * es : 16, rows > 1 ? x.ss * es : 16,
                         B > 1 ? x.sb * es : 16};
  if (encode == nullptr || cols <= 0 || reinterpret_cast<uintptr_t>(x.p) % 16 != 0) return false;
  for (int64_t v : st)
    if (v <= 0 || v % 16 != 0 || v >= (int64_t(1) << 40)) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[0], (cuuint64_t)st[1], (cuuint64_t)st[2]};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, x.dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(x.p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C, int MT, int NR, int G, int CL, bool EXACT>
int launch_walk(Params p, int B, cudaStream_t stream) {
  constexpr int KT = 8 * NR * G, W = 16 * MT;
  const Layout L = walk_layout<C, MT, NR, G, CL>(p.dk, p.q.dtype == kBF16, p.k.dtype == kBF16,
                                                 p.v.dtype == kBF16);
  if (L.total > kMaxSmem) return -1;
  CUtensorMap tq = {}, tk = {}, tv = {};
  p.tma_qk = make_map(&tq, p.q, p.dk, p.kq_heads, p.S, B, KT + 8, C) &&
             make_map(&tk, p.k, p.dk, p.kq_heads, p.S, B, KT + 8, C);
  p.tma_v = make_map(&tv, p.v, p.dv, p.H, p.S, B, W + 8, C);
  auto kernel = gla_walk<C, MT, NR, G, CL, EXACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.dv + W - 1) / W * CL, B * p.H);
  cfg.blockDim = dim3(32 * MT * NR);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p, tq, tk, tv);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The walk's tiling: MT column tiles of 16 and NR dk shares a block, G dk
// tiles of 8 a warp and step, CL blocks a cluster splitting dk.
template <int MT_, int NR_, int G_, int CL_>
struct Tiling {
  static constexpr int MT = MT_, NR = NR_, G = G_, CL = CL_;
};

// Calls f(Tiling<...>{}) with the walk's tiling for dk, and returns its result:
//   dk <= 64: 64 columns, 4 warps, the whole dk in one step, no cluster
//   to 1024:  64 columns, 8 warps, 64 dk rows a step, 4 blocks splitting dk
//   above:    the same with 32 dk rows a step (the state takes the room)
template <class F>
int with_tiling(int dk, F&& f) {
  if (dk <= 64) return f(Tiling<4, 1, 8, 1>{});
  if (dk <= 1024) return f(Tiling<4, 2, 4, 4>{});
  return f(Tiling<4, 2, 2, 4>{});
}

// The kernels' tiling for dk at chunk C, as launch() below takes it: out =
// {W, warps, KT, walk shared memory, scores shared memory, blocks a
// cluster}.
template <int C>
void config(int dk, bool q16, bool k16, bool v16, int* out) {
  with_tiling(dk, [&](auto t) {
    using T = decltype(t);
    out[0] = 16 * T::MT;
    out[1] = T::MT * T::NR;
    out[2] = 8 * T::NR * T::G;
    out[3] = walk_layout<C, T::MT, T::NR, T::G, T::CL>(dk, q16, k16, v16).total;
    out[4] = scores_smem<C>(q16, k16);
    out[5] = T::CL;
    return 0;
  });
}

template <int C, bool EXACT>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int rc = launch_scores<C, EXACT>(p, B, stream);
  if (rc != 0) return rc;
  return with_tiling(p.dk, [&](auto t) {
    using T = decltype(t);
    return launch_walk<C, T::MT, T::NR, T::G, T::CL, EXACT>(p, B, stream);
  });
}

// Bytes one copy of an operand may move: the largest of 16, 8, 4 that
// divides its address and every stride in bytes; 2 for a bf16 operand
// aligned to 2 bytes only.
int copy_width(const void* ptr, const long long* st, int es) {
  uint64_t m = reinterpret_cast<uint64_t>(ptr);
  for (int i = 0; i < 3; ++i) m |= static_cast<uint64_t>(st[i]) * es;
  for (int w = 16; w >= 4; w /= 2)
    if (m % w == 0) return w;
  return 2;
}

int kq_heads(int H, const long long* strides) {
  return strides[3 + 2] == 0 && strides[9 + 2] == 0 ? 1 : H;  // k's and q's head strides
}

}  // namespace

extern "C" {

// Floats of scratch gla_scan needs for the raw scores: (B * kq_heads,
// chunks, causal tiles, 64), kq_heads 1 where k and q are both shared by
// the heads (head stride 0), else H. strides as for gla_scan.
long long gla_scan_scratch_floats(int B, int S, int H, const long long* strides, int chunk) {
  if (chunk <= 0 || S <= 0) return 0;
  const long long n_chunks = (S + chunk - 1) / chunk;
  return (long long)B * kq_heads(H, strides) * n_chunks * score_tiles(chunk) * 64;
}

// The kernels' tiling for dk, dtypes[4] (a, k, v, q) and chunk: out[6] =
// the walk's state columns a block, its warps, the dk rows a step, the
// dynamic shared memory of the walk and of the scores kernel in bytes, and
// the blocks of a cluster (which split dk).
int gla_scan_config(int dk, const int* dtypes, int chunk, int* out) {
  const bool q16 = dtypes[3] == kBF16, k16 = dtypes[1] == kBF16, v16 = dtypes[2] == kBF16;
  switch (chunk) {
    case 16: config<16>(dk, q16, k16, v16, out); return 0;
    case 32: config<32>(dk, q16, k16, v16, out); return 0;
    case 64: config<64>(dk, q16, k16, v16, out); return 0;
    default: return -1;
  }
}

// a: (B, S, H); k, q: (B, S, H, dk); v: (B, S, H, dv); element strides
// over (B, S, H) in `strides` (a, k, v, q, three each), the last axis of
// k, v, q contiguous; dtypes[4] (0 = f32, 1 = bf16) for a, k, v, q. y:
// (B, S, H, dv) f32, contiguous, not aliasing an input. scores: scratch of
// gla_scan_scratch_floats() floats, 16-byte aligned. chunk 16, 32 or 64;
// dk <= 1536; B * H <= 65535.
int gla_scan(const void* a, const void* k, const void* v, const void* q, void* y, void* scores,
             const int* dtypes, const long long* strides, int B, int S, int H, int dk, int dv,
             int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dv <= 0) return 0;
  if (dk < 0 || dk > kMaxDK || (long long)B * H > 65535) return -1;
  for (int i = 0; i < 4; ++i)
    if (dtypes[i] != kF32 && dtypes[i] != kBF16) return -1;
  if (chunk != 16 && chunk != 32 && chunk != 64) return -1;
  const void* ptr[4] = {a, k, v, q};
  Operand op[4];
  for (int i = 0; i < 4; ++i) {
    const int es = dtypes[i] == kBF16 ? 2 : 4;
    op[i] = Operand{ptr[i], static_cast<int64_t>(strides[3 * i]),
                    static_cast<int64_t>(strides[3 * i + 1]),
                    static_cast<int64_t>(strides[3 * i + 2]), dtypes[i],
                    copy_width(ptr[i], strides + 3 * i, es)};
  }
  const Params p{op[0], op[1], op[2], op[3], static_cast<float*>(y), static_cast<float*>(scores),
                 S, H, dk, dv, kq_heads(H, strides), (S + chunk - 1) / chunk, 0, 0};
  if ((long long)B * p.kq_heads > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool exact = dtypes[1] == kBF16 && dtypes[3] == kBF16;
  switch (chunk) {
    case 16: return exact ? launch<16, true>(p, B, s) : launch<16, false>(p, B, s);
    case 32: return exact ? launch<32, true>(p, B, s) : launch<32, false>(p, B, s);
    default: return exact ? launch<64, true>(p, B, s) : launch<64, false>(p, B, s);
  }
}

}  // extern "C"
