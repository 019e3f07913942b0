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
// 3.35 TB/s.
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate); k and v are read from
// device memory once per 128-row query tile and shared by its 8 warps;
// tiles wholly above the causal diagonal or outside the window are never
// visited, and the element mask is only evaluated on tiles that cut a
// mask edge (diagonal, window edge, ragged T). The next k/v tile is
// copied (cp.async, double-buffered) while the current one is computed.
// Query tiles are issued heaviest first so the causal tail does not
// leave the card idle. A later change can move to wgmma, TMA and warp
// specialisation.
//
// bf16 path, one CUDA block per (head, batch, 128-row query tile): 8
// warps, 16 query rows each. S = Q K^T for a 64-key tile is (D/16) x 8
// mma's per warp; p = 2^(s c - m c) with c = Dh^-0.5 * log2(e), one FMA
// and one ex2.approx per score, in f32. p is rounded to bf16 in
// registers and fed straight back as the A operand of P V (the C
// fragments of two n8 tiles are the A fragment of one k16 step); the
// denominator sums the f32 p.
// Shared-memory rows are XOR-swizzled in 16-byte chunks so ldmatrix and
// cp.async are free of bank conflicts.
//
// f32 path (the reduced CPU-sized configs; the TPU kernel takes any
// float dtype): plain f32 FMA, one warp per query row at a time, q
// upcast and scaled by Dh^-0.5 as the TPU kernel does, expf.
//
// Ragged S and T are masked inside the kernel (zero-filled loads, masked
// keys, unstored rows): any S, T >= 0 is taken. Kernels launch on the
// caller's stream and allocate nothing. The C entry point returns
// cudaGetLastError() after the launch (or -1 for a dtype or head dim it
// does not take), which the Python wrapper raises on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

constexpr int kBM = 128;      // query rows per block
constexpr int kBN = 64;       // keys per tile
constexpr int kWarps = kBM / 16;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; zero-fills when !pred (src unread).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Element offset of 16-byte chunk `chunk` of row `row` in a swizzled
// [rows][D] bf16 tile: the chunk index is XORed with row % 8.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// Copy rows [row0, row0+n_rows) of a (rows, D) matrix with the given row
// stride into a swizzled tile; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t row_stride, int row0, int valid,
                                          int n_rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < n_rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < valid;
    const __nv_bfloat16* g = ok ? src + (int64_t)(row0 + r) * row_stride + c * 8 : src;
    cp_async_16(smem_u32(dst + swz<D>(r, c)), g, ok);
  }
}

// Dh = 64 asks for two blocks an SM, which caps it at 128 registers: its
// latency is hidden by resident warps, and without the cap ptxas takes
// more registers and leaves one block an SM. Dh = 128 needs more than
// 128 registers and runs one block an SM.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_attention_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int S, int T, int H, int Hkv, int causal, int window, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBM * D;       // two stages of kBN x D
  __nv_bfloat16* vs = ks + 2 * kBN * D;   // two stages of kBN x D

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // heaviest tiles first
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int64_t q_stride = (int64_t)H * D;     // between consecutive positions
  const int64_t kv_stride = (int64_t)Hkv * D;
  const __nv_bfloat16* qb = q + ((int64_t)b * S * H + h) * D;
  const __nv_bfloat16* kb = k + ((int64_t)b * T * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((int64_t)b * T * Hkv + hk) * D;
  __nv_bfloat16* ob = o + ((int64_t)b * S * H + h) * D;

  int t_lo, t_hi;
  key_tiles(q0, kBM, kBN, T, causal, window, t_lo, t_hi);
  const int n_tiles = t_hi - t_lo;

  if (n_tiles > 0) {  // a tile whose rows see no key writes zeros only
    load_tile<D>(qs, qb, q_stride, q0, S, kBM);
    load_tile<D>(ks, kb, kv_stride, t_lo * kBN, T, kBN);
    load_tile<D>(vs, vb, kv_stride, t_lo * kBN, T, kBN);
    cp_async_commit();
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};     // this thread's share of the row sums
  uint32_t qf[D / 16][4];
  const int row0 = q0 + warp * 16 + lane / 4, row1 = row0 + 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int k0 = (t_lo + it) * kBN;
    if (it + 1 < n_tiles) {
      load_tile<D>(ks + (stage ^ 1) * kBN * D, kb, kv_stride, k0 + kBN, T, kBN);
      load_tile<D>(vs + (stage ^ 1) * kBN * D, vb, kv_stride, k0 + kBN, T, kBN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(qs + swz<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4))));
    }
    const __nv_bfloat16* kst = ks + stage * kBN * D;
    const __nv_bfloat16* vst = vs + stage * kBN * D;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBN / 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(kst + swz<D>(j * 8 + (lane >> 4) * 8 + (lane & 7),
                                              kk * 2 + ((lane >> 3) & 1))));
        mma_bf16(s[j], qf[kk], r[0], r[1]);
        mma_bf16(s[j + 1], qf[kk], r[2], r[3]);
      }
    }

    // The softmax runs on raw scores; the scale (times log2 e) enters
    // each exponent through one FMA.
    const bool masked = tile_cuts_mask(q0, kBM, k0, kBN, T, causal, window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (masked) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
          if (!visible(e < 2 ? row0 : row1, key, T, causal, window)) s[j][e] = kNegInf;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m_run[0], mx0), mn1 = fmaxf(m_run[1], mx1);
    const float alpha0 = ex2((m_run[0] - mn0) * scale_log2);
    const float alpha1 = ex2((m_run[1] - mn1) * scale_log2);
    m_run[0] = mn0;
    m_run[1] = mn1;
    // A row whose max is still kNegInf has seen only masked keys (all
    // kNegInf): it subtracts 0, so each of its p is 2^(-1e30 c) = 0.
    const float sub0 = mn0 == kNegInf ? 0.f : mn0 * scale_log2;
    const float sub1 = mn1 == kNegInf ? 0.f : mn1 * scale_log2;

    uint32_t pf[kBN / 16][4];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float p0 = ex2(fmaf(s[j][0], scale_log2, -sub0));
      const float p1 = ex2(fmaf(s[j][1], scale_log2, -sub0));
      const float p2 = ex2(fmaf(s[j][2], scale_log2, -sub1));
      const float p3 = ex2(fmaf(s[j][3], scale_log2, -sub1));
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_run[0] = l_run[0] * alpha0 + ls0;
    l_run[1] = l_run[1] * alpha1 + ls1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // acc += P V: V is the (keys x D) row-major B operand, read transposed.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(vst + swz<D>(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                                    n + (lane >> 4))));
        mma_bf16(acc[n], pf[kk], r[0], r[1]);
        mma_bf16(acc[n + 1], pf[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float l0 = l_run[0], l1 = l_run[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row0 * q_stride + n * 8 + col) =
          __floats2bfloat162_rn(acc[n][0] / d0, acc[n][1] / d0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row1 * q_stride + n * 8 + col) =
          __floats2bfloat162_rn(acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                int S, int T, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = (kBM + 4 * kBN) * D * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + kBM - 1) / kBM);
  flash_attention_bf16<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, T, H, Hkv,
      causal, window, scale * kLog2e);
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
  constexpr int kPer = D / 32;  // output columns per lane
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
        for (int i = 0; i < kPer; ++i) acc[rr][i] = fmaf(pj, vs[j][lane + 32 * i], acc[rr][i]);
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
// (0 = f32, 1 = bf16); H a multiple of Hkv; D 64 or 128. scale is
// D^-0.5. out may not alias an input.
int flash_attention(const void* q, const void* k, const void* v, void* out, int dtype, int B,
                    int H, int Hkv, int S, int T, int D, int causal, int window, float scale,
                    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && D == 64)
    return launch_bf16<64>(q, k, v, out, B, H, Hkv, S, T, causal, window, scale, s);
  if (dtype == kBF16 && D == 128)
    return launch_bf16<128>(q, k, v, out, B, H, Hkv, S, T, causal, window, scale, s);
  if (dtype == kF32 && D == 64)
    return launch_f32<64>(q, k, v, out, B, H, Hkv, S, T, causal, window, scale, s);
  if (dtype == kF32 && D == 128)
    return launch_f32<128>(q, k, v, out, B, H, Hkv, S, T, causal, window, scale, s);
  return -1;
}

}  // extern "C"
