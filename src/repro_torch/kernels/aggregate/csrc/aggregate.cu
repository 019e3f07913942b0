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
// gradient buffer and moves about 53 MB in all.
// What the design does about it: every g element is read from HBM once
// and every output written once. A CTA owns a tile of 256 columns of P,
// each thread one column; a warp's loads along a row are 128 contiguous
// bytes (coalesced 4-byte loads: row n starts at byte n*P*4, which for
// odd P is not 16-byte aligned, so wider vector loads would need a
// row-head split; that is left for a later change). The loop over the
// N rows is unrolled so several rows' loads are in flight per thread.
// The ragged P edge is masked inside the kernel: there is no padding
// copy of the (N, P) buffer, unlike the TPU wrapper's jnp.pad.
//
// Determinism: each thread sums its column over n = 0..N-1 in that
// order, in an f32 register, with fmaf; there are no atomics. K1 and K2
// share weighted_column_sum, so their sums are the same bits, and K2's
// update is p - (eta * acc) with explicitly rounded __fmul_rn/__fsub_rn
// (no FMA contraction): bitwise what the unfused path computes as
// reduce (K1), then sgd's -eta*agg, then params + update.
//
// The mask is a row select, not a multiply: a masked row contributes an
// exact zero even when it holds inf or NaN. w and the mask are staged
// in shared memory, kStage rows at a time. Kernels launch on the
// caller's stream and allocate nothing. The C entry points return
// cudaGetLastError() after the launch (or -1 for a dtype they do not
// take), which the Python wrapper raises on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 1024;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// sum_n w[n] * sel(mask[n] > 0, g[n, col], 0) for n = 0..n_rows-1, in
// order. mask == nullptr selects every row. Every thread of the block
// must call this (it synchronises); threads with col >= P load nothing.
template <typename TG>
__device__ __forceinline__ float weighted_column_sum(
    const TG* __restrict__ g, const float* __restrict__ w,
    const float* __restrict__ mask, int n_rows, int64_t P, int64_t col) {
  __shared__ float w_s[kStage];
  __shared__ float m_s[kStage];
  const bool live = col < P;
  float acc = 0.f;
  for (int n0 = 0; n0 < n_rows; n0 += kStage) {
    const int rows = min(kStage, n_rows - n0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      w_s[i] = w[n0 + i];
      m_s[i] = mask ? mask[n0 + i] : 1.f;
    }
    __syncthreads();
    if (live) {
      const TG* gp = g + (int64_t)n0 * P + col;
#pragma unroll 8
      for (int i = 0; i < rows; ++i) {
        const float v = to_f32(gp[(int64_t)i * P]);
        acc = fmaf(w_s[i], m_s[i] > 0.f ? v : 0.f, acc);
      }
    }
  }
  return acc;
}

template <typename TG, typename TO>
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const TG* __restrict__ g, const float* __restrict__ w,
                 const float* __restrict__ mask, TO* __restrict__ out,
                 int n_rows, int64_t P) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float acc = weighted_column_sum(g, w, mask, n_rows, P, col);
  if (col < P) out[col] = from_f32<TO>(acc);
}

// params == nullptr: the delta -eta * acc (the client-sharded form).
template <typename TG, typename TP, typename TO>
__global__ void __launch_bounds__(kThreads)
aggregate_update_kernel(const TG* __restrict__ g, const float* __restrict__ w,
                        const float* __restrict__ mask,
                        const float* __restrict__ eta,
                        const TP* params, TO* out, int n_rows, int64_t P) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float acc = weighted_column_sum(g, w, mask, n_rows, P, col);
  if (col < P) {
    const float step = __fmul_rn(*eta, acc);
    const float r = params ? __fsub_rn(to_f32(params[col]), step) : -step;
    out[col] = from_f32<TO>(r);
  }
}

inline dim3 grid_for(int64_t P) { return dim3((unsigned)((P + kThreads - 1) / kThreads)); }

template <typename TG, typename TO>
int launch_aggregate(const void* g, const float* w, const float* mask, void* out,
                     int n_rows, int64_t P, cudaStream_t stream) {
  aggregate_kernel<TG, TO><<<grid_for(P), kThreads, 0, stream>>>(
      static_cast<const TG*>(g), w, mask, static_cast<TO*>(out), n_rows, P);
  return (int)cudaGetLastError();
}

template <typename TG, typename TP, typename TO>
int launch_update(const void* g, const float* w, const float* mask, const float* eta,
                  const void* params, void* out, int n_rows, int64_t P,
                  cudaStream_t stream) {
  aggregate_update_kernel<TG, TP, TO><<<grid_for(P), kThreads, 0, stream>>>(
      static_cast<const TG*>(g), w, mask, eta, static_cast<const TP*>(params),
      static_cast<TO*>(out), n_rows, P);
  return (int)cudaGetLastError();
}

template <typename TG>
int dispatch_aggregate(const void* g, const float* w, const float* mask, void* out,
                       int out_dtype, int n_rows, int64_t P, cudaStream_t s) {
  switch (out_dtype) {
    case kF32: return launch_aggregate<TG, float>(g, w, mask, out, n_rows, P, s);
    case kBF16: return launch_aggregate<TG, __nv_bfloat16>(g, w, mask, out, n_rows, P, s);
  }
  return -1;
}

template <typename TG, typename TP>
int dispatch_update_out(const void* g, const float* w, const float* mask, const float* eta,
                        const void* params, void* out, int out_dtype, int n_rows,
                        int64_t P, cudaStream_t s) {
  switch (out_dtype) {
    case kF32: return launch_update<TG, TP, float>(g, w, mask, eta, params, out, n_rows, P, s);
    case kBF16:
      return launch_update<TG, TP, __nv_bfloat16>(g, w, mask, eta, params, out, n_rows, P, s);
  }
  return -1;
}

template <typename TG>
int dispatch_update(const void* g, const float* w, const float* mask, const float* eta,
                    const void* params, int params_dtype, void* out, int out_dtype,
                    int n_rows, int64_t P, cudaStream_t s) {
  switch (params_dtype) {
    case kF32:
      return dispatch_update_out<TG, float>(g, w, mask, eta, params, out, out_dtype, n_rows, P, s);
    case kBF16:
      return dispatch_update_out<TG, __nv_bfloat16>(g, w, mask, eta, params, out, out_dtype,
                                                    n_rows, P, s);
  }
  return -1;
}

}  // namespace

extern "C" {

// K1. g: (n_rows, P) row-major of g_dtype; w, mask: (n_rows,) f32, mask
// may be null; out: (P,) of out_dtype.
int masked_scaled_aggregate(const void* g, int g_dtype, const float* w, const float* mask,
                            void* out, int out_dtype, int n_rows, long long P,
                            void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g_dtype) {
    case kF32: return dispatch_aggregate<float>(g, w, mask, out, out_dtype, n_rows, P, s);
    case kBF16: return dispatch_aggregate<__nv_bfloat16>(g, w, mask, out, out_dtype, n_rows, P, s);
  }
  return -1;
}

// K2. As K1, plus eta: a device pointer to one f32, and params: (P,) of
// params_dtype, or null for the delta form (params_dtype then ignored).
// out may alias params.
int masked_scaled_aggregate_update(const void* g, int g_dtype, const float* w,
                                   const float* mask, const float* eta,
                                   const void* params, int params_dtype, void* out,
                                   int out_dtype, int n_rows, long long P, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!params) params_dtype = kF32;
  switch (g_dtype) {
    case kF32:
      return dispatch_update<float>(g, w, mask, eta, params, params_dtype, out, out_dtype,
                                    n_rows, P, s);
    case kBF16:
      return dispatch_update<__nv_bfloat16>(g, w, mask, eta, params, params_dtype, out,
                                            out_dtype, n_rows, P, s);
  }
  return -1;
}

}  // extern "C"
