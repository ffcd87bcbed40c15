// Per-channel batch-norm sums for Hopper (sm_90a), forward and backward.
//
// Replaces the Pallas TPU kernels experiments/pallas_bn_v2.py pallas_stats
// :55 (body _stats_kernel :32) and experiments/pallas_bn_bench.py
// pallas_stats :82 (body _bn_stats_kernel :69): the train-mode statistic
// _bn_channel_sums of bpbreid_tpu/models/common.py :151, taken once for the
// forward statistics (:195) and once for the backward reductions (:220).
//
// The input is viewed as [A, C, B] and reduced over A and B, per channel c:
//   stats:       s1[c] = sum x,    s2[c] = sum x * x
//   grad stats:  s1[c] = sum dy,   s2[c] = sum dy * (x - mean[c]) * rstd[c]
// NCHW maps are [N, C, H*W]; feature-last [M, C] is [M, C, 1].
//
// Bound: device-memory bytes. Each element is read once (x, and dy in the
// backward) for 2-4 flops, far below the card's flop/byte balance.
//
// Design. The TPU kernels carry their sums across a sequential grid; here
// blocks run in no order, so the reduction takes two passes and no float
// atomics, and the sums are the same on every run:
//  1. partial pass. For B > 1, grid (C, S): block (c, s) reduces the s-th
//     of S contiguous chunks of channel c's A*B elements. Along the
//     contiguous B run it reads 8 elements at a time (16-byte loads for
//     bf16, two for f32) when B is a multiple of 8, else one at a time;
//     then warp shuffles, then shared memory. For B == 1 ([M, C]), grid
//     (ceil(C/32), S) of 32 x 8 threads: threadIdx.x walks neighbouring
//     channels, so each warp's loads coalesce, and the 8 thread rows are
//     summed in shared memory. Each block writes f64 partials [2][S][C].
//  2. finalize: one thread per channel sums its S partials in order.
// Precision: at 12.6 M elements per channel (the layer1 Bottleneck output
// [64, 256, 96, 32]) an f32 running sum of x*x loses digits; each group of
// 8 values is summed in f32 and the group sums are accumulated in f64,
// which costs two conversions per group, off the memory path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;     // partial pass, B > 1
constexpr int kVec = 8;           // elements per vector step
constexpr int kColTile = 32;      // channels per block, B == 1
constexpr int kColRows = 8;       // thread rows per block, B == 1
constexpr int kFinalThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 consecutive elements, 16-byte aligned, as floats
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// B > 1. VEC: B % 8 == 0 and both operands 16-byte aligned.
template <typename TX, typename TG, bool GRAD, bool VEC>
__global__ void __launch_bounds__(kThreads)
rows_partial_kernel(const TX* __restrict__ x, const TG* __restrict__ dy,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd, double* __restrict__ part,
                    int C, int B, unsigned int per_row, unsigned int total,
                    unsigned int chunk) {
  constexpr int V = VEC ? kVec : 1;
  const int c = blockIdx.x;
  const int s = blockIdx.y;
  const int S = gridDim.y;
  const unsigned int v0 = s * chunk;
  const unsigned int v1 = min(total, v0 + chunk);
  float mu = 0.f, rs = 0.f;
  if constexpr (GRAD) {
    mu = mean[c];
    rs = rstd[c];
  }
  double acc1 = 0.0, acc2 = 0.0;
  for (unsigned int v = v0 + threadIdx.x; v < v1; v += kThreads) {
    const unsigned int a = v / per_row;
    const unsigned int j = v - a * per_row;
    const size_t off = ((size_t)a * C + c) * B + (size_t)j * V;
    float xv[V];
    if constexpr (VEC) load8(x + off, xv);
    else xv[0] = to_float(x[off]);
    float p1 = 0.f, p2 = 0.f;
    if constexpr (GRAD) {
      float gv[V];
      if constexpr (VEC) load8(dy + off, gv);
      else gv[0] = to_float(dy[off]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        p1 += gv[e];
        p2 = fmaf(gv[e], (xv[e] - mu) * rs, p2);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        p1 += xv[e];
        p2 = fmaf(xv[e], xv[e], p2);
      }
    }
    acc1 += (double)p1;
    acc2 += (double)p2;
  }

  __shared__ double red[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc1 = warp_sum(acc1);
  acc2 = warp_sum(acc2);
  if (lane == 0) {
    red[0][warp] = acc1;
    red[1][warp] = acc2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t1 = 0.0, t2 = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) {
      t1 += red[0][w];
      t2 += red[1][w];
    }
    part[(size_t)s * C + c] = t1;
    part[(size_t)(S + s) * C + c] = t2;
  }
}

// B == 1: x is [A, C]; threadIdx.x walks channels, threadIdx.y rows.
template <typename TX, typename TG, bool GRAD>
__global__ void __launch_bounds__(kColTile * kColRows)
cols_partial_kernel(const TX* __restrict__ x, const TG* __restrict__ dy,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd, double* __restrict__ part,
                    int A, int C, int chunk) {
  const int c = blockIdx.x * kColTile + threadIdx.x;
  const int s = blockIdx.y;
  const int S = gridDim.y;
  const int r0 = s * chunk;
  const int r1 = min(A, r0 + chunk);
  double acc1 = 0.0, acc2 = 0.0;
  if (c < C) {
    float mu = 0.f, rs = 0.f;
    if constexpr (GRAD) {
      mu = mean[c];
      rs = rstd[c];
    }
    for (int r = r0 + threadIdx.y; r < r1; r += kColRows) {
      const size_t off = (size_t)r * C + c;
      const float xv = to_float(x[off]);
      if constexpr (GRAD) {
        const float g = to_float(dy[off]);
        acc1 += (double)g;
        acc2 += (double)(g * ((xv - mu) * rs));
      } else {
        acc1 += (double)xv;
        acc2 += (double)(xv * xv);
      }
    }
  }
  __shared__ double red[2][kColRows][kColTile];
  red[0][threadIdx.y][threadIdx.x] = acc1;
  red[1][threadIdx.y][threadIdx.x] = acc2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    double t1 = 0.0, t2 = 0.0;
    for (int y = 0; y < kColRows; ++y) {
      t1 += red[0][y][threadIdx.x];
      t2 += red[1][y][threadIdx.x];
    }
    part[(size_t)s * C + c] = t1;
    part[(size_t)(S + s) * C + c] = t2;
  }
}

// out[0][c] = sum_s part[0][s][c], out[1][c] = sum_s part[1][s][c]
__global__ void __launch_bounds__(kFinalThreads)
finalize_kernel(const double* __restrict__ part, float* __restrict__ out,
                int C, int S) {
  const int c = blockIdx.x * kFinalThreads + threadIdx.x;
  if (c >= C) return;
  double t1 = 0.0, t2 = 0.0;
  for (int s = 0; s < S; ++s) {
    t1 += part[(size_t)s * C + c];
    t2 += part[(size_t)(S + s) * C + c];
  }
  out[c] = (float)t1;
  out[C + c] = (float)t2;
}

template <typename TX, typename TG, bool GRAD>
cudaError_t launch(const void* xp, const void* dyp, const float* mean,
                   const float* rstd, double* part, float* out, int A, int C,
                   int B, int S, cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xp);
  const TG* dy = static_cast<const TG*>(dyp);
  if (B == 1) {
    const int chunk = (A + S - 1) / S;
    const dim3 grid((C + kColTile - 1) / kColTile, S);
    cols_partial_kernel<TX, TG, GRAD><<<grid, dim3(kColTile, kColRows), 0,
                                        stream>>>(x, dy, mean, rstd, part, A,
                                                  C, chunk);
  } else {
    const bool vec = B % kVec == 0 &&
                     reinterpret_cast<size_t>(xp) % 16 == 0 &&
                     (!GRAD || reinterpret_cast<size_t>(dyp) % 16 == 0);
    const unsigned int per_row = vec ? B / kVec : B;
    const unsigned int total = (unsigned int)A * per_row;
    const unsigned int chunk = (total + S - 1) / S;
    const dim3 grid(C, S);
    if (vec)
      rows_partial_kernel<TX, TG, GRAD, true><<<grid, kThreads, 0, stream>>>(
          x, dy, mean, rstd, part, C, B, per_row, total, chunk);
    else
      rows_partial_kernel<TX, TG, GRAD, false><<<grid, kThreads, 0, stream>>>(
          x, dy, mean, rstd, part, C, B, per_row, total, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<<<(C + kFinalThreads - 1) / kFinalThreads, kFinalThreads, 0,
                    stream>>>(part, out, C, S);
  return cudaGetLastError();
}

bool bad_shape(int A, int C, int B, int S) {
  // per-channel vector counts are 32-bit; grids stay in their limits
  return A <= 0 || C <= 0 || B <= 0 || S <= 0 || S > 65535 || S > A * (long long)B ||
         (long long)A * B > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. part: f64 scratch [2, S, C];
// out: f32 [2, C]. Returns a cudaError_t code.
int bpbreid_bn_stats(const void* x, void* part, float* out, int A, int C,
                     int B, int S, int x_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(part);
  if (bad_shape(A, C, B, S)) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    return (int)launch<float, float, false>(x, x, nullptr, nullptr, p, out,
                                            A, C, B, S, st);
  if (x_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16, false>(
        x, x, nullptr, nullptr, p, out, A, C, B, S, st);
  return (int)cudaErrorInvalidValue;
}

int bpbreid_bn_grad_stats(const void* dy, const void* x, const float* mean,
                          const float* rstd, void* part, float* out, int A,
                          int C, int B, int S, int dy_dtype, int x_dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(part);
  if (bad_shape(A, C, B, S)) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && dy_dtype == 0)
    return (int)launch<float, float, true>(x, dy, mean, rstd, p, out, A, C,
                                           B, S, st);
  if (x_dtype == 0 && dy_dtype == 1)
    return (int)launch<float, __nv_bfloat16, true>(x, dy, mean, rstd, p, out,
                                                   A, C, B, S, st);
  if (x_dtype == 1 && dy_dtype == 0)
    return (int)launch<__nv_bfloat16, float, true>(x, dy, mean, rstd, p, out,
                                                   A, C, B, S, st);
  if (x_dtype == 1 && dy_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16, true>(
        x, dy, mean, rstd, p, out, A, C, B, S, st);
  return (int)cudaErrorInvalidValue;
}

const char* bpbreid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
