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
// mask instead and gives NaN there). la is kept in f64: it is a handful
// of values a chunk, and the differences la_t - la_s of two sums near
// -800 (decays of 1e-6) keep their digits.
//
// Layout: the model's own. a is (B, S, H); k and q are (B, S, H, dk); v
// is (B, S, H, dv); any strides over (B, S, H), the last axis of k, v, q
// contiguous; each operand f32 or bf16, upcast in registers as it is
// loaded, so no f32 copy of an operand is made. y is (B, S, H, dv) f32,
// contiguous. Ragged S (the last chunk) and ragged dk, dv are masked in
// the kernel (zero-filled loads, a = 1, unstored rows and columns).
//
// One CUDA block owns one (batch·head, 32-column slice of dv) pair and
// walks the chunks of S in order; its (dk x 32) slice of the f32 state
// stays in shared memory for the whole walk (128 KB at dk = 1024, which
// is why the state is split over dv: one head's whole state at xlstm
// width, 1024 x 1025, is 4.2 MB). Columns of H are independent, but the
// (C x C) score product needs all of dk, so each dv-slice block computes
// it again: at dk = 1024, dv = 1025 the 33 blocks of a head each repeat
// it, about as many operations as the rest of the kernel.
// Inside a chunk the block loops over dk in tiles of 32: q and k tiles
// are loaded (the next tile's global loads in flight during the current
// tile's products), stored transposed in shared memory, and feed the
// score product and the inter-chunk read; the same tile's rows of H are
// then carried. Products are plain f32 FMA from shared memory (at chunk
// 64, 4x4 scores and 4x2 outputs a thread); no tensor cores, no atomics, so the
// result is deterministic.
//
// What bounds it: operations. At the zamba2-2.7b Mamba2 shape (B = 8,
// S = 2048, H = 80, dk = dv = 64, chunk 64) the four products are 32.4
// GFLOP (0.48 ms at 67 TFLOP/s f32) against 1.0 GB moved (0.30 ms at
// 3.35 TB/s); at the xlstm-1.3b mLSTM shape (H = 4, dk = 1024, dv =
// 1025) 284 GFLOP (4.2 ms) against 1.1 GB.
//
// Kernels launch on the caller's stream and allocate nothing. The C entry
// point returns cudaGetLastError() after the launch, or -1 for a chunk,
// dtype or size it does not take; the Python wrapper raises on either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDKT = 32;      // state rows (dk) per tile of the dk loop
constexpr int kDVT = 32;      // state columns (dv) a block owns
constexpr int kMaxDK = 1536;  // the state slice then fills 192 KB of shared memory
constexpr size_t kTwoBlockSmem = 112 * 1024;  // two blocks of this size share an SM
constexpr double kLogEps = 1e-12;

enum DType { kF32 = 0, kBF16 = 1 };

struct Operand {
  const void* p;
  int64_t sb, ss, sh;  // element strides between batches, positions, heads
  int dtype;
};

struct Params {
  Operand a, k, v, q;
  float* y;
  int S, H, dk, dv;
};

__device__ __forceinline__ float load(const Operand& x, int64_t i) {
  return x.dtype == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x.p)[i])
                          : static_cast<const float*>(x.p)[i];
}

// N consecutive floats from (to) shared memory, aligned to N floats.
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&r)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x, r[1] = t.y;
  } else {
    r[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void sts(float* p, const float (&r)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    p[0] = r[0];
  }
}

template <int C>
constexpr size_t smem_bytes(int dk) {
  const size_t tiles = (dk + kDKT - 1) / kDKT;
  return C * sizeof(double) +
         sizeof(float) * (2 * kDKT * (C + 4) + 2 * C * kDVT + tiles * kDKT * kDVT);
}

// MinBlocks = 2 caps registers at 128 so that two blocks share an SM.
template <int C, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks) gla_scan_kernel(const Params p) {
  constexpr int R = C / 16;           // rows (and score columns) a thread holds
  constexpr int QP = C + 4;           // row pitch of the transposed q and k tiles
  constexpr int kQK = C * kDKT / kThreads;  // q (and k) elements a thread loads a tile
  constexpr int kV = C * kDVT / kThreads;   // v elements a thread loads a chunk
  static_assert(C * C <= 2 * kDKT * QP, "scores must fit in the q and k tiles");
  static_assert(C % 16 == 0 && C >= 16, "16 x 16 threads tile the score product");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* la = reinterpret_cast<double*>(smem_raw);  // C: log-cumsum of a
  float* qT = reinterpret_cast<float*>(la + C);      // [d][t], kDKT x QP
  float* kT = qT + kDKT * QP;                        // [d][s], kDKT x QP
  float* sT = qT;                                    // [s][t], C x C, after the dk loop
  float* vs = kT + kDKT * QP;                        // [s][j], C x kDVT
  float* vd = vs + C * kDVT;                         // v scaled by exp(la_end - la_s)
  float* hs = vd + C * kDVT;                         // [d][j]: the state slice

  const int j0 = blockIdx.x * kDVT;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = tid / 16, tx = tid % 16;
  const int hd = tid / 8, hj = 4 * (tid % 8);  // the state elements a thread carries
  const int n_dt = (p.dk + kDKT - 1) / kDKT;

  const int64_t a_base = b * p.a.sb + h * p.a.sh;
  const int64_t k_base = b * p.k.sb + h * p.k.sh;
  const int64_t v_base = b * p.v.sb + h * p.v.sh;
  const int64_t q_base = b * p.q.sb + h * p.q.sh;
  float* yb = p.y + ((int64_t)b * p.S * p.H + h) * p.dv;
  const int64_t y_stride = (int64_t)p.H * p.dv;

  for (int i = tid; i < n_dt * kDKT * kDVT; i += kThreads) hs[i] = 0.f;

  for (int s0 = 0; s0 < p.S; s0 += C) {
    // Rows of q and k tile `dt` into registers: a warp reads 4 positions
    // x 8 consecutive d, so the transposed shared-memory store below hits
    // 32 distinct banks (QP is 4 mod 32).
    auto load_qk = [&](int dt, float (&qr)[kQK], float (&kr)[kQK]) {
#pragma unroll
      for (int i = 0; i < kQK; ++i) {
        const int g = (tid + i * kThreads) / 32;
        const int t = 4 * (g / 4) + lane / 8, d = dt * kDKT + 8 * (g % 4) + lane % 8;
        const bool ok = s0 + t < p.S && d < p.dk;
        qr[i] = ok ? load(p.q, q_base + (int64_t)(s0 + t) * p.q.ss + d) : 0.f;
        kr[i] = ok ? load(p.k, k_base + (int64_t)(s0 + t) * p.k.ss + d) : 0.f;
      }
    };
    float qr[kQK], kr[kQK], vr[kV];
    load_qk(0, qr, kr);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int e = tid + i * kThreads, t = e / kDVT, j = j0 + e % kDVT;
      vr[i] = s0 + t < p.S && j < p.dv ? load(p.v, v_base + (int64_t)(s0 + t) * p.v.ss + j) : 0.f;
      vs[e] = vr[i];
    }
    if (warp == 0) {  // la = inclusive cumsum of log(max(a, 1e-12)), positions past S add 0
      constexpr int E = C > 32 ? C / 32 : 1;
      double x[E], own = 0.0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int t = lane * E + e;
        double lv = 0.0;
        if (t < C && s0 + t < p.S) {
          const double av = load(p.a, a_base + (int64_t)(s0 + t) * p.a.ss);
          lv = log(av != av ? av : fmax(av, kLogEps));  // NaN stays NaN, as jnp.maximum
        }
        x[e] = lv;
        own += lv;
      }
      double inc = own;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const double n = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += n;
      }
      double run = inc - own;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        run += x[e];
        if (lane * E + e < C) la[lane * E + e] = run;
      }
    }
    __syncthreads();

    const double la_end = la[C - 1];
    const float decay = expf((float)la_end);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int e = tid + i * kThreads;
      vd[e] = vr[i] * expf((float)(la_end - la[e / kDVT]));
    }

    float sacc[R][R], yacc[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      yacc[i][0] = yacc[i][1] = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) sacc[i][j] = 0.f;
    }

    for (int dt = 0; dt < n_dt; ++dt) {
#pragma unroll
      for (int i = 0; i < kQK; ++i) {
        const int g = (tid + i * kThreads) / 32;
        const int t = 4 * (g / 4) + lane / 8, d = 8 * (g % 4) + lane % 8;
        qT[d * QP + t] = qr[i];
        kT[d * QP + t] = kr[i];
      }
      __syncthreads();
      if (dt + 1 < n_dt) load_qk(dt + 1, qr, kr);

      // scores += q k^T; y += q H (this tile's rows of the state as it
      // stood before the chunk).
      const float* hrow = hs + dt * kDKT * kDVT + 2 * tx;
#pragma unroll 8
      for (int d = 0; d < kDKT; ++d) {
        float qa[R], kb[R];
        lds<R>(qT + d * QP + R * ty, qa);
        lds<R>(kT + d * QP + R * tx, kb);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) sacc[i][j] = fmaf(qa[i], kb[j], sacc[i][j]);
        const float2 hv = *reinterpret_cast<const float2*>(hrow + d * kDVT);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          yacc[i][0] = fmaf(qa[i], hv.x, yacc[i][0]);
          yacc[i][1] = fmaf(qa[i], hv.y, yacc[i][1]);
        }
      }
      __syncthreads();  // every read of this tile's state rows is done

      // Carry: H <- exp(la_end) H + k^T (v * exp(la_end - la)).
      float* hc = hs + (dt * kDKT + hd) * kDVT + hj;
      float4 hv = *reinterpret_cast<float4*>(hc);
      hv.x *= decay, hv.y *= decay, hv.z *= decay, hv.w *= decay;
#pragma unroll 8
      for (int s = 0; s < C; ++s) {
        const float kv = kT[hd * QP + s];
        const float4 w = *reinterpret_cast<const float4*>(vd + s * kDVT + hj);
        hv.x = fmaf(kv, w.x, hv.x);
        hv.y = fmaf(kv, w.y, hv.y);
        hv.z = fmaf(kv, w.z, hv.z);
        hv.w = fmaf(kv, w.w, hv.w);
      }
      *reinterpret_cast<float4*>(hc) = hv;
      __syncthreads();  // q and k tiles are free for the next tile
    }

    // Scores, decay-weighted and causal by select, into sT[s][t].
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int s = R * tx + j;
      float col[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int t = R * ty + i;
        col[i] = t >= s ? sacc[i][j] * expf((float)(la[t] - la[s])) : 0.f;
      }
      sts<R>(sT + s * C + R * ty, col);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float e = expf((float)la[R * ty + i]);
      yacc[i][0] *= e;
      yacc[i][1] *= e;
    }
    // Scores past the thread's last row are zero.
    for (int s = 0; s < R * (ty + 1); ++s) {
      float st[R];
      lds<R>(sT + s * C + R * ty, st);
      const float2 w = *reinterpret_cast<const float2*>(vs + s * kDVT + 2 * tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        yacc[i][0] = fmaf(st[i], w.x, yacc[i][0]);
        yacc[i][1] = fmaf(st[i], w.y, yacc[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = s0 + R * ty + i;
      if (t >= p.S) continue;
      const int j = j0 + 2 * tx;
      if (j < p.dv) yb[t * y_stride + j] = yacc[i][0];
      if (j + 1 < p.dv) yb[t * y_stride + j + 1] = yacc[i][1];
    }
    __syncthreads();  // vs, la and sT are free for the next chunk
  }
}

template <int C, int MinBlocks>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(p.dk);
  cudaError_t err = cudaFuncSetAttribute(gla_scan_kernel<C, MinBlocks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.dv + kDVT - 1) / kDVT, B * p.H);
  gla_scan_kernel<C, MinBlocks><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (B, S, H); k, q: (B, S, H, dk); v: (B, S, H, dv); element strides
// over (B, S, H) in `strides` (a, k, v, q, three each), the last axis of
// k, v, q contiguous; dtypes[4] (0 = f32, 1 = bf16) for a, k, v, q. y:
// (B, S, H, dv) f32, contiguous, not aliasing an input. chunk 16, 32 or
// 64; dk <= 1536; B * H <= 65535.
int gla_scan(const void* a, const void* k, const void* v, const void* q, void* y,
             const int* dtypes, const long long* strides, int B, int S, int H, int dk, int dv,
             int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dv <= 0) return 0;
  if (dk < 0 || dk > kMaxDK || (long long)B * H > 65535) return -1;
  for (int i = 0; i < 4; ++i)
    if (dtypes[i] != kF32 && dtypes[i] != kBF16) return -1;
  const void* ptr[4] = {a, k, v, q};
  Operand op[4];
  for (int i = 0; i < 4; ++i)
    op[i] = Operand{ptr[i], static_cast<int64_t>(strides[3 * i]),
                    static_cast<int64_t>(strides[3 * i + 1]),
                    static_cast<int64_t>(strides[3 * i + 2]), dtypes[i]};
  const Params p{op[0], op[1], op[2], op[3], static_cast<float*>(y), S, H, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16: return launch<16, 1>(p, B, s);
    case 32: return launch<32, 1>(p, B, s);
    // Unbounded, the C = 64 kernel takes 223 registers: one block an SM,
    // which leaves the small-state case (zamba2, dk = 64) latency-bound.
    // Where two blocks' shared memory fits (dk <= 608) it is capped at
    // 128 registers instead (a few spilled) and runs two blocks an SM.
    // At dk = 1024 shared memory allows one block anyway, and the cap
    // only costs spills.
    case 64:
      return smem_bytes<64>(dk) <= kTwoBlockSmem ? launch<64, 2>(p, B, s)
                                                  : launch<64, 1>(p, B, s);
    default: return -1;
  }
}

}  // extern "C"
