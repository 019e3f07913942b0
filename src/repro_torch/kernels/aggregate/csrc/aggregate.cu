// Masked, scaled client-gradient aggregation (K1) and the fused
// reduce-and-update server step (K2), for Hopper (sm_90a).
//
// Replace the TPU kernels in src/repro/kernels/aggregate/aggregate.py:
//   K1 masked_scaled_aggregate_kernel         out[p] = sum_n w[n] * sel(m[n] > 0, g[n,p], 0)
//   K2 masked_scaled_aggregate_update_kernel  out[p] = params[p] - eta * (the same sum)
//                                             or, with no params, the delta -eta * sum.
//
// What bounds them: HBM bytes. Each is a (1,N)x(N,P) matrix-vector
// product with about 0.5 flop per byte; at the Fig-1 shape (N = 40
// clients, P = 316,554 CNN parameters, f32) one step reads the 50.6 MB
// gradient buffer and moves about 52-53 MB in all, 15.5-15.9 us at
// 3.35 TB/s. The card has to keep about 20 KB a SM in flight to reach
// that rate (Little's law at ~700 ns of latency), in long contiguous runs.
//
// What the design does about it:
// - A persistent grid: one block a SM, each owning one contiguous span
//   of P in whole 16-byte units, so there is no partial second wave.
//   A small P runs fewer blocks, each owning at least 256 bytes of a row
//   (ops.MIN_UNITS units). The span is walked in chunks of at most
//   kConsumers * kCols columns.
// - One producer warp fills a ring of shared-memory stages with 1D bulk
//   async copies (cp.async.bulk, completing on the stage's mbarrier),
//   one lane a row, so the rows' address work runs side by side; a stage
//   is `rows` consecutive rows of a chunk (8 at the Fig-1 shape: fewer,
//   larger stages pay fewer barrier round trips), and the ring holds
//   150-190 KB in flight a SM. Eight consumer warps sum the
//   stages from shared memory into per-column f32 registers and release
//   each stage on its empty barrier. A warp reads only as many columns a
//   thread as the chunk gives it (at a small P, most warps none), and
//   reads a stage's rows branch-free, so their reads issue together.
// - Row n starts at byte n*P*esize, which for odd P is not 16-byte
//   aligned, so each row's run is copied from its aligned-down start and
//   read at a per-row shift of ((head + n*step) mod 16) / esize elements
//   (head: g's byte offset within a 16-byte unit; step: P*esize mod 16).
//   No byte outside g is copied: a run is clamped to g's whole 16-byte
//   units, and the elements of the partial first and last units are
//   plain loads by the producer lane of that row.
// - A masked row is never read: no copy is issued for it, and in its
//   place in the order each column adds fmaf(w[n], 0.f, acc), which
//   keeps the bits, the NaN of a non-finite weight on a masked row
//   included (the JAX kernel's jnp.where, then jnp.dot).
// - w and the mask reach each warp 32 rows at a time as one coalesced
//   load, issued a group ahead (lane i holds row n0+i; a row's weight is
//   a shuffle, its select a ballot bit), so nothing is staged through
//   __syncthreads, N has no limit, and no load of them waits behind the
//   ring's copies in the memory queue.
// The geometry (blocks, span, chunk, rows a stage, stages, row pitch,
// head, step) is computed by ops.py, where the CPU tests check it, and
// passed in; the entry points refuse one they cannot run.
//
// Determinism: each column is summed over n = 0..N-1 in that order, in
// an f32 register, with fmaf; there are no atomics. K1 and K2 share
// stream_span, so their sums are the same bits, and K2's update is
// p - (eta * acc) with explicitly rounded __fmul_rn/__fsub_rn (no FMA
// contraction): bitwise what the unfused path computes as reduce (K1),
// then sgd's -eta*agg, then params + update.
//
// Kernels launch on the caller's stream and allocate nothing. The C
// entry points return cudaGetLastError() after the launch, -1 for a
// dtype they do not take, or -2 for a geometry they cannot run, which
// the Python wrapper raises on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ops.Geometry, field for field. Outside the anonymous namespace: the C
// entry points take it, and they must keep external linkage.
struct Geometry {
  int blocks, span, chunk, rows, stages, pitch, head, step;
};

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // the consumers, then the producer warp
// The most columns a consumer thread sums in a chunk: kConsumers * kCols
// = 2,560 holds the Fig-1 shape's 2,400-column span on 132 SMs in one
// chunk. A warp sums as many columns a thread as the chunk gives it,
// rounded up to 1, 2, 4 or kCols (a compile-time count, chosen once a
// chunk), those past the chunk's width too, with no compare in the inner
// loop: their index is clamped to the chunk's last column once a chunk,
// so they read bytes of their own row that the stage's copy wrote, and
// are never stored. No read leaves the row's slot or touches an
// unwritten byte.
constexpr int kCols = 10;
constexpr int kMaxStages = 16;
constexpr int kBarBytes = 2 * kMaxStages * 8;  // full, then empty mbarriers
constexpr int kMaxSmem = 232448;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
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
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Row n's shift in elements: where its run starts inside its first
// 16-byte unit (ops.Geometry.shift).
template <typename TG>
__device__ __forceinline__ int row_shift(const Geometry& geo, int n) {
  return (int)(((uint32_t)geo.head + (uint32_t)n * (uint32_t)geo.step) & 15u) / (int)sizeof(TG);
}

// Lane i's row n0 + i of the 32-row group at n0: its weight (w ==
// nullptr: not loaded) and its mask value (mask == nullptr selects every
// row; 0 past the last row). A warp loads a group's rows while it works
// on the group before, so no load waits behind the ring's copies; the
// group's selects are the bits of __ballot_sync(~0u, m > 0.f).
struct GroupRows {
  float w, m;
};
__device__ __forceinline__ GroupRows group_rows(const float* w, const float* mask, int n_rows,
                                                int n0) {
  const int n = n0 + (threadIdx.x & 31);
  if (n >= n_rows) return {0.f, 0.f};
  return {w ? w[n] : 0.f, mask ? mask[n] : 1.f};
}
// The group after the one at n0 in a block's walk: the next 32 rows, or
// the first ones again for the next chunk.
__device__ __forceinline__ int next_group(int n0, int n_rows) {
  return n0 + 32 < n_rows ? n0 + 32 : 0;
}

// Row n's run of a chunk (cw elements from src): the aligned-down start
// s0 its slot row begins at, and [lo, hi), the 16-byte units copied in
// bulk, clamped to g's whole units [g_lo, g_hi); lo == hi == s0 when
// nothing is. The elements outside [lo, hi) are plain loads.
struct Run {
  uintptr_t s0, lo, hi;
};
template <typename TG>
__device__ __forceinline__ Run run_of(const TG* src, int cw, uintptr_t g_lo, uintptr_t g_hi) {
  const uintptr_t rs = (uintptr_t)src, re = (uintptr_t)(src + cw);
  const uintptr_t s0 = rs & ~(uintptr_t)15, e1 = (re + 15) & ~(uintptr_t)15;
  Run run{s0, s0 > g_lo ? s0 : g_lo, e1 < g_hi ? e1 : g_hi};
  if (run.hi <= run.lo) run.lo = run.hi = s0;
  return run;
}

// The producer warp: for each stage of the block's walk (chunk by chunk,
// `rows` rows at a time), wait for its slot to be free, then lane r
// copies the stage's row r, if that row is selected: the rows' address
// work runs side by side, and lane 0 arms the stage's barrier with their
// summed bytes before any copy is issued.
template <typename TG>
__device__ void produce(const TG* __restrict__ g, const float* mask, int n_rows, int64_t P,
                        int64_t c0, int64_t c1, const Geometry& geo, unsigned char* ring,
                        uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  const uintptr_t g_lo = ((uintptr_t)g + 15) & ~(uintptr_t)15;
  const uintptr_t g_hi = ((uintptr_t)(g + (int64_t)n_rows * P)) & ~(uintptr_t)15;
  int s = 0;
  uint32_t phase = 0;
  GroupRows ahead = group_rows(nullptr, mask, n_rows, 0);
  for (int64_t a = c0; a < c1; a += geo.chunk) {
    const int cw = (int)min((int64_t)geo.chunk, c1 - a);
    for (int n0 = 0; n0 < n_rows; n0 += 32) {
      const unsigned copy = __ballot_sync(~0u, ahead.m > 0.f);
      ahead = group_rows(nullptr, mask, n_rows, next_group(n0, n_rows));
      const int group = min(32, n_rows - n0);
      for (int j0 = 0; j0 < group; j0 += geo.rows) {
        mbar_wait(empty + s, phase ^ 1);
        unsigned char* row = ring + ((int64_t)s * geo.rows + lane) * geo.pitch;
        const int n = n0 + j0 + lane;
        const bool mine = lane < min(geo.rows, group - j0) && ((copy >> (j0 + lane)) & 1);
        Run run{0, 0, 0};
        if (mine) {
          const TG* src = g + (int64_t)n * P + a;
          run = run_of(src, cw, g_lo, g_hi);
          // The elements outside [lo, hi): g's partial first and last
          // 16-byte units. Plain stores here, bulk copies into the same
          // bytes in a later round: order the two proxies.
          const uintptr_t rs = (uintptr_t)src;
          const int head = run.lo > rs ? min(cw, (int)((run.lo - rs) / sizeof(TG))) : 0;
          const int tail = run.hi > rs ? (int)((run.hi - rs) / sizeof(TG)) : 0;
          if (head > 0 || tail < cw) {
            TG* dst = reinterpret_cast<TG*>(row) + row_shift<TG>(geo, n);
            for (int i = 0; i < head; ++i) dst[i] = src[i];
            for (int i = max(tail, head); i < cw; ++i) dst[i] = src[i];
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          }
        }
        uint32_t bytes = (uint32_t)(run.hi - run.lo);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) bytes += __shfl_xor_sync(~0u, bytes, o);
        __syncwarp();  // the plain stores, before lane 0's arrive releases them
        if (lane == 0) mbar_arrive_expect_tx(full + s, bytes);
        __syncwarp();  // the barrier expects the bytes before any copy lands
        if (run.hi > run.lo)
          bulk_load(row + (run.lo - run.s0), (const void*)run.lo, (uint32_t)(run.hi - run.lo),
                    full + s);
        if (++s == geo.stages) s = 0, phase ^= 1;
      }
    }
  }
}

// Where a consumer warp is in the ring's walk: the stage, its phase, and
// the next 32-row group of w and the mask, loaded ahead.
struct Walk {
  int s;
  uint32_t phase;
  GroupRows ahead;
};

// A consumer warp's walk of one chunk (cw columns from column a), kC
// columns a thread: thread t sums columns t + i * kConsumers, i < kC, the
// warp's columns in the chunk (kC may round their count up: a column past
// the chunk is clamped to its last and never stored; kC = 0 only keeps
// the walk's barriers). After the chunk's last row `store(col, acc, pre,
// scale)` writes each column, with `pre` (K2's params) loaded before the
// chunk's first row, so the stores wait on no load.
template <int kC, typename TG, typename Store>
__device__ __forceinline__ void consume_chunk(const float* __restrict__ w, const float* mask,
                                              int n_rows, int64_t a, int cw, const Geometry& geo,
                                              const unsigned char* ring, uint64_t* full,
                                              uint64_t* empty, const Store& store, float scale,
                                              Walk& walk) {
  constexpr int kN = kC > 0 ? kC : 1;
  const int t = threadIdx.x, lane = t & 31;
  float acc[kN], pre[kN];
  int col[kN];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    acc[i] = 0.f;
    col[i] = min(t + i * kConsumers, cw - 1);
    pre[i] = t + i * kConsumers < cw ? store.load(a + t + i * kConsumers) : 0.f;
  }
  for (int n0 = 0; n0 < n_rows; n0 += 32) {
    const float wv = walk.ahead.w;
    const unsigned live = __ballot_sync(~0u, walk.ahead.m > 0.f);
    walk.ahead = group_rows(w, mask, n_rows, next_group(n0, n_rows));
    const int group = min(32, n_rows - n0);
    for (int j0 = 0; j0 < group; j0 += geo.rows) {
      mbar_wait(full + walk.s, walk.phase);
      const unsigned char* slot = ring + (int64_t)walk.s * geo.rows * geo.pitch;
      const int rows = min(geo.rows, group - j0);
      // Branch-free, so the reads of several rows issue together.
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const int j = j0 + r;
        const float wn = __shfl_sync(~0u, wv, j);
        const bool sel = (live >> j) & 1;
        const TG* row =
            reinterpret_cast<const TG*>(slot + r * geo.pitch) + row_shift<TG>(geo, n0 + j);
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          // A masked row has no copy in its slot: it is not read, and
          // adds fmaf(w[n], 0.f, acc) in its place.
          const float x = sel ? to_f32(row[col[i]]) : 0.f;
          acc[i] = fmaf(wn, x, acc[i]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + walk.s);
      if (++walk.s == geo.stages) walk.s = 0, walk.phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = t + i * kConsumers;
    if (c < cw) store(a + c, acc[i], pre[i], scale);
  }
}

// The consumer warps: the walk of produce, stage by stage, chunk by
// chunk. A warp reads and sums only as many columns a thread as the
// chunk gives it (a small P's chunk gives most warps none), so a row
// costs a warp ceil(columns / kConsumers) shared-memory reads, not kCols.
template <typename TG, typename Store>
__device__ void consume(const float* __restrict__ w, const float* mask, int n_rows,
                        int64_t c0, int64_t c1, const Geometry& geo, const unsigned char* ring,
                        uint64_t* full, uint64_t* empty, const Store& store) {
  const float scale = store.scale();
  const int t0 = threadIdx.x & ~31;  // the warp's first column in a chunk
  Walk walk{0, 0, group_rows(w, mask, n_rows, 0)};
  for (int64_t a = c0; a < c1; a += geo.chunk) {
    const int cw = (int)min((int64_t)geo.chunk, c1 - a);
    const int cols = cw > t0 ? (cw - t0 + kConsumers - 1) / kConsumers : 0;
#define AGG_CHUNK(k) \
  consume_chunk<k, TG>(w, mask, n_rows, a, cw, geo, ring, full, empty, store, scale, walk)
    if (cols == 0) AGG_CHUNK(0);
    else if (cols == 1) AGG_CHUNK(1);
    else if (cols == 2) AGG_CHUNK(2);
    else if (cols <= 4) AGG_CHUNK(4);
    else AGG_CHUNK(kCols);
#undef AGG_CHUNK
  }
}

// sum_n w[n] * sel(mask[n] > 0, g[n, col], 0) over the block's span,
// each column handed to store.
template <typename TG, typename Store>
__device__ __forceinline__ void stream_span(const TG* __restrict__ g, const float* __restrict__ w,
                                            const float* __restrict__ mask, int n_rows,
                                            int64_t P, const Geometry& geo, const Store& store) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t c0 = (int64_t)blockIdx.x * geo.span;
  if (c0 >= P) return;  // a block past the end owns nothing
  const int64_t c1 = min(c0 + (int64_t)geo.span, P);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + kBarBytes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < geo.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers)
    produce(g, mask, n_rows, P, c0, c1, geo, ring, full, empty);
  else
    consume<TG>(w, mask, n_rows, c0, c1, geo, ring, full, empty, store);
}

// K1's store: the sum, in the output dtype.
template <typename TO>
struct StoreSum {
  TO* out;
  __device__ __forceinline__ float scale() const { return 0.f; }
  __device__ __forceinline__ float load(int64_t) const { return 0.f; }
  __device__ __forceinline__ void operator()(int64_t col, float acc, float, float) const {
    out[col] = from_f32<TO>(acc);
  }
};

// K2's: params - eta * acc, or with params == nullptr the delta
// -eta * acc (the client-sharded form).
template <typename TP, typename TO>
struct StoreUpdate {
  const float* eta;
  const TP* params;
  TO* out;
  __device__ __forceinline__ float scale() const { return *eta; }
  __device__ __forceinline__ float load(int64_t col) const {
    return params ? to_f32(params[col]) : 0.f;
  }
  __device__ __forceinline__ void operator()(int64_t col, float acc, float p, float eta_) const {
    const float step = __fmul_rn(eta_, acc);
    out[col] = from_f32<TO>(params ? __fsub_rn(p, step) : -step);
  }
};

template <typename TG, typename Store>
__global__ void __launch_bounds__(kThreads, 1)
aggregate_kernel(const TG* __restrict__ g, const float* __restrict__ w,
                 const float* __restrict__ mask, int n_rows, int64_t P, Geometry geo,
                 Store store) {
  stream_span(g, w, mask, n_rows, P, geo, store);
}

// The barriers and the ring.
int smem_bytes(const Geometry& geo) {
  return kBarBytes + geo.stages * geo.rows * geo.pitch;
}

// What the kernel needs of a geometry; anything else is refused (-2).
template <typename TG>
bool runnable(const Geometry& geo, int64_t P) {
  const int unit = 16 / (int)sizeof(TG);
  return geo.blocks > 0 && geo.span > 0 && geo.span % unit == 0 &&
         (int64_t)geo.blocks * geo.span >= P && geo.chunk > 0 && geo.chunk % unit == 0 &&
         geo.chunk <= kConsumers * kCols && (geo.rows == 1 || geo.rows == 2 ||
         geo.rows == 4 || geo.rows == 8) && geo.stages >= 1 && geo.stages <= kMaxStages &&
         geo.pitch % 16 == 0 && geo.pitch >= geo.chunk * (int)sizeof(TG) + 16 &&
         geo.head >= 0 && geo.head < 16 && geo.step >= 0 && geo.step < 16 &&
         smem_bytes(geo) <= kMaxSmem;
}

template <typename TG, typename Store>
int launch(const void* g, const float* w, const float* mask, int n_rows, int64_t P,
           const Geometry& geo, Store store, cudaStream_t stream) {
  if (!runnable<TG>(geo, P)) return -2;
  auto kernel = aggregate_kernel<TG, Store>;
  const int smem = smem_bytes(geo);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<geo.blocks, kThreads, smem, stream>>>(static_cast<const TG*>(g), w, mask, n_rows, P,
                                                 geo, store);
  return (int)cudaGetLastError();
}

template <typename TG>
int dispatch_aggregate(const void* g, const float* w, const float* mask, void* out,
                       int out_dtype, int n_rows, int64_t P, const Geometry& geo,
                       cudaStream_t s) {
  switch (out_dtype) {
    case kF32:
      return launch<TG>(g, w, mask, n_rows, P, geo, StoreSum<float>{static_cast<float*>(out)}, s);
    case kBF16:
      return launch<TG>(g, w, mask, n_rows, P, geo,
                        StoreSum<__nv_bfloat16>{static_cast<__nv_bfloat16*>(out)}, s);
  }
  return -1;
}

template <typename TG, typename TP>
int dispatch_update_out(const void* g, const float* w, const float* mask, const float* eta,
                        const void* params, void* out, int out_dtype, int n_rows, int64_t P,
                        const Geometry& geo, cudaStream_t s) {
  const TP* p = static_cast<const TP*>(params);
  switch (out_dtype) {
    case kF32:
      return launch<TG>(g, w, mask, n_rows, P, geo,
                        StoreUpdate<TP, float>{eta, p, static_cast<float*>(out)}, s);
    case kBF16:
      return launch<TG>(g, w, mask, n_rows, P, geo,
                        StoreUpdate<TP, __nv_bfloat16>{eta, p,
                                                       static_cast<__nv_bfloat16*>(out)}, s);
  }
  return -1;
}

template <typename TG>
int dispatch_update(const void* g, const float* w, const float* mask, const float* eta,
                    const void* params, int params_dtype, void* out, int out_dtype,
                    int n_rows, int64_t P, const Geometry& geo, cudaStream_t s) {
  switch (params_dtype) {
    case kF32:
      return dispatch_update_out<TG, float>(g, w, mask, eta, params, out, out_dtype, n_rows, P,
                                            geo, s);
    case kBF16:
      return dispatch_update_out<TG, __nv_bfloat16>(g, w, mask, eta, params, out, out_dtype,
                                                    n_rows, P, geo, s);
  }
  return -1;
}

}  // namespace

extern "C" {

// K1. g: (n_rows, P) row-major of g_dtype; w, mask: (n_rows,) f32, mask
// may be null; out: (P,) of out_dtype; geo: the launch geometry
// (ops.Geometry) for this g.
int masked_scaled_aggregate(const void* g, int g_dtype, const float* w, const float* mask,
                            void* out, int out_dtype, int n_rows, long long P,
                            const Geometry* geo, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g_dtype) {
    case kF32: return dispatch_aggregate<float>(g, w, mask, out, out_dtype, n_rows, P, *geo, s);
    case kBF16:
      return dispatch_aggregate<__nv_bfloat16>(g, w, mask, out, out_dtype, n_rows, P, *geo, s);
  }
  return -1;
}

// K2. As K1, plus eta: a device pointer to one f32, and params: (P,) of
// params_dtype, or null for the delta form (params_dtype then ignored).
// out may alias params.
int masked_scaled_aggregate_update(const void* g, int g_dtype, const float* w,
                                   const float* mask, const float* eta,
                                   const void* params, int params_dtype, void* out,
                                   int out_dtype, int n_rows, long long P,
                                   const Geometry* geo, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!params) params_dtype = kF32;
  switch (g_dtype) {
    case kF32:
      return dispatch_update<float>(g, w, mask, eta, params, params_dtype, out, out_dtype,
                                    n_rows, P, *geo, s);
    case kBF16:
      return dispatch_update<__nv_bfloat16>(g, w, mask, eta, params, params_dtype, out,
                                            out_dtype, n_rows, P, *geo, s);
  }
  return -1;
}

}  // extern "C"
