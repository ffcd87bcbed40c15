// Batch norm for Hopper (sm_90a): the per-channel sums of train mode,
// forward and backward, and the elementwise passes around them.
//
// Replaces the Pallas TPU kernels experiments/pallas_bn_v2.py pallas_stats
// :55 (K3a, body _stats_kernel :32) and experiments/pallas_bn_bench.py
// pallas_stats :82 (K3b, body _bn_stats_kernel :69): the statistic
// _bn_channel_sums of bpbreid_tpu/models/common.py :151, taken for the
// forward statistics (:195) and for the backward reductions (:220). On the
// TPU, XLA fused the elementwise code around those sums (_bn_train_fwd_core
// :191, _bn_train_vjp_bwd :211); here two more kernels do it.
//
// x is viewed as [A, C, B] (NCHW maps as [N, C, H*W], feature-last [M, C]
// as [M, C, 1]) and reduced over A and B per channel; m = A * B.
//   bn_stats (K3a):      s1 = sum x, s2 = sum x*x; then mean = s1/m,
//                        var = max(0, s2/m - mean^2), rstd = rsqrt(var+eps),
//                        scale = rstd * weight, and the running statistics
//                        updated in place: 0.9*running + 0.1*batch, flax's
//                        momentum
//   bn_apply:            y = (x - mean) * (rstd * weight) + bias, cast to
//                        y's type
//                        (train mode: the batch statistics; eval mode: the
//                        running ones)
//   bn_grad_stats (K3b): sum dy and sum dy*xhat, xhat = (x - mean)*rstd:
//                        dbias and dscale
//   bn_dx:               dx = scale * (dy - sum dy/m - xhat * sum dy*xhat/m),
//                        cast to x's type; m is A * B or a count given by
//                        the caller (the global batch's, across ranks)
//   bn_apply_sums:       bn_apply from given f32 sums [2, C] of a given
//                        count m (a batch split over ranks, its sums
//                        all-reduced): each CTA runs bn_stats's epilogue
//                        on its channel's sums in registers, the CTAs of
//                        share 0 write the statistics [4, C] and move the
//                        running statistics, then it is bn_apply
// Each is one launch: a train-mode BN is two launches forward (bn_stats,
// bn_apply) and two backward (bn_grad_stats, bn_dx), an eval-mode BN one;
// across ranks too (bn_stats's sums, all_reduce, bn_apply_sums forward;
// bn_grad_stats, writing its sums twice so that one copy is all-reduced in
// place, all_reduce, bn_dx with the global count backward).
//
// Bound: device-memory bytes; each element costs 2-8 flops, far below the
// card's flop/byte balance. At bf16, per element: 2 B for the sums (read
// x), 4 B for apply (read x, write y), 4 B for the grad sums (read x and
// dy), 6 B for dx (read x and dy, write dx).
//
// Design.
//  - Reductions. A thread block cluster of S CTAs (S <= 16; above 8 with
//    the non-portable cluster size) owns one channel when B > 1, or one
//    tile of 32 channels when B == 1. Each CTA reduces a contiguous share
//    of the channel's A*B elements. Where B % 8 == 0 a thread reads 8
//    elements at a time (one 16-byte load in bf16, two in f32), four
//    vectors in flight; each vector's row and column advance by a divmod of
//    the stride worked out on the host, so the loop divides nothing. The
//    CTA's sums meet in its shared memory; after cluster.sync() rank 0 reads
//    every rank's through distributed shared memory, in rank order, and
//    runs the epilogue. The earlier design's second kernel (a finalize over
//    f64 partials in device memory) and its two allocations a call are
//    gone; there are no float atomics, and the sums are the same on every
//    run. With B == 1 ([M, C] features) threadIdx.x walks neighbouring
//    channels, so a warp's loads coalesce, and threadIdx.y walks rows.
//  - Precision: a channel holds up to 786,432 elements (the stem's
//    [64, 64, 192, 64]), where an f32 running sum of x*x loses digits; each
//    thread sums a group of up to 32 values in f32 and accumulates the
//    group sums in f64.
//  - Elementwise passes: the same walk over a grid of (share, channel)
//    CTAs, each with its channel's constants in registers; x (and dy) read
//    once, y (dx) written once. bn_apply_sums works its constants out of
//    the sums in every CTA of the channel (a few operations on 4 loads,
//    the same f32 operations in the same order in each, so every CTA
//    holds the same bits and the statistics equal bn_stats's epilogue on
//    the same sums): the finalize is no launch of its own.
//  - Rounding: the f32 arithmetic rounds each operation on its own (no
//    contraction), in the order of the plain PyTorch versions in
//    batchnorm.py; a division by m is a product with the f32 reciprocal of
//    m, as PyTorch's CUDA division by a scalar is. So apply and dx agree
//    with the plain versions given the same constants, and the statistics
//    differ only by the order of the sums.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // B > 1
constexpr int kVec = 8;           // elements per vector step
constexpr int kUnroll = 4;        // vectors in flight a thread
constexpr int kColTile = 32;      // channels per CTA, B == 1
constexpr int kColRows = 8;       // thread rows per CTA, B == 1
constexpr int kMaxCluster = 16;
// flax's running-statistics momentum; 1 - 0.9 is rounded from the double,
// as the plain version's (1.0 - MOMENTUM) is
constexpr float kMomentum = 0.9f;
constexpr float kOneMinusMomentum = (float)(1.0 - 0.9);

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive elements, 16-byte aligned
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
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  unsigned int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned int*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* o) {
  if constexpr (V == kVec) load8(p, o);
  else o[0] = to_float(*p);
}
template <int V, typename T>
__device__ __forceinline__ void load_or_zero(const T* base, size_t off,
                                             bool in, float* o) {
  if (in) {
    load_vec<V>(base + off, o);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = 0.f;
  }
}
template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (V == kVec) store8(p, v);
  else *p = from_float<T>(v[0]);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The walk over one channel's vectors (B > 1): vector v of the channel
// lies in row a = v / per_row, column j = v % per_row, at element
// ((a * C + c) * B + j * V). A thread steps by kThreads vectors, which is
// step_q rows and step_r columns.
struct Walk {
  unsigned int per_row;   // vectors a row: B / V
  unsigned int total;     // vectors a channel: A * per_row
  unsigned int chunk;     // vectors a CTA
  unsigned int step_q, step_r;
  unsigned long long row_stride;   // C * B elements
};

struct Cursor {
  unsigned int v, j;
  size_t off;
};

__device__ __forceinline__ Cursor walk_start(const Walk& w, unsigned int v,
                                             int c, int C, int B, int V) {
  const unsigned int a = v / w.per_row;
  const unsigned int j = v - a * w.per_row;
  return {v, j, ((size_t)a * C + c) * B + (size_t)j * V};
}

__device__ __forceinline__ void walk_step(const Walk& w, Cursor& k, int B,
                                          int V) {
  k.v += kThreads;
  k.j += w.step_r;
  k.off += w.step_q * w.row_stride + (size_t)w.step_r * V;
  if (k.j >= w.per_row) {
    k.j -= w.per_row;
    k.off += w.row_stride - B;
  }
}

// Statistics: pointers of the epilogue.
struct StatsOut {
  float* stats;               // [4, C]: mean, var, rstd, scale
  float* sums;                // [2, C]: s1, s2 in f32, or null
  const float* weight;        // [C]
  float* running_mean;        // [C], or null: no running update
  float* running_var;
  float eps;
};

// Backward sums: their inputs and output.
struct GradIn {
  const float* mean;
  const float* rstd;
  float* out;                 // [2, C]: sum dy, sum dy*xhat
  float* out2;                // the same sums again, or null
};

__device__ __forceinline__ void write_grad_sums(const GradIn& gi, int c,
                                                int C, double t1, double t2) {
  gi.out[c] = (float)t1;
  gi.out[C + c] = (float)t2;
  if (gi.out2 != nullptr) {
    gi.out2[c] = (float)t1;
    gi.out2[C + c] = (float)t2;
  }
}

// bn_stats's epilogue on f32 sums s1 = sum x, s2 = sum x*x of m values
struct BnStats {
  float mean, var, rstd, scale;
};

__device__ __forceinline__ BnStats finalize_stats(float s1, float s2,
                                                  unsigned int m, float eps,
                                                  float weight) {
  const float inv_m = __fdiv_rn(1.0f, (float)m);
  const float mean = __fmul_rn(s1, inv_m);
  const float d = __fsub_rn(__fmul_rn(s2, inv_m), __fmul_rn(mean, mean));
  const float var = d < 0.f ? 0.f : d;
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  return {mean, var, rstd, __fmul_rn(rstd, weight)};
}

// The statistics [4, C] and the running update of channel c
__device__ __forceinline__ void write_stats(float* stats, float* running_mean,
                                            float* running_var, int c, int C,
                                            const BnStats& st) {
  stats[c] = st.mean;
  stats[C + c] = st.var;
  stats[2 * C + c] = st.rstd;
  stats[3 * C + c] = st.scale;
  if (running_mean != nullptr) {
    running_mean[c] = __fadd_rn(__fmul_rn(kMomentum, running_mean[c]),
                                __fmul_rn(kOneMinusMomentum, st.mean));
    running_var[c] = __fadd_rn(__fmul_rn(kMomentum, running_var[c]),
                               __fmul_rn(kOneMinusMomentum, st.var));
  }
}

__device__ __forceinline__ void stats_epilogue(const StatsOut& o, int c,
                                               int C, unsigned int m,
                                               double t1, double t2) {
  const float s1 = (float)t1, s2 = (float)t2;
  write_stats(o.stats, o.running_mean, o.running_var, c, C,
              finalize_stats(s1, s2, m, o.eps, o.weight[c]));
  if (o.sums != nullptr) {
    o.sums[c] = s1;
    o.sums[C + c] = s2;
  }
}

// One vector's contribution to the two sums.
template <bool GRAD, int V>
__device__ __forceinline__ void accumulate(const float* xv, const float* gv,
                                           float mu, float rs, float& p1,
                                           float& p2) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if constexpr (GRAD) {
      p1 += gv[e];
      p2 = fmaf(gv[e], (xv[e] - mu) * rs, p2);
    } else {
      p1 += xv[e];
      p2 = fmaf(xv[e], xv[e], p2);
    }
  }
}

// B > 1: grid (S, C), cluster (S, 1, 1). VEC: B % 8 == 0, operands
// 16-byte aligned.
template <typename TX, typename TG, bool GRAD, bool VEC>
__global__ void __launch_bounds__(kThreads)
reduce_rows_kernel(const TX* __restrict__ x, const TG* __restrict__ dy,
                   StatsOut so, GradIn gi, int C, int B, Walk w) {
  constexpr int V = VEC ? kVec : 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.y;
  const unsigned int v0 = blockIdx.x * w.chunk;
  const unsigned int v1 = min(w.total, v0 + w.chunk);
  float mu = 0.f, rs = 0.f;
  if constexpr (GRAD) {
    mu = gi.mean[c];
    rs = gi.rstd[c];
  }
  double acc1 = 0.0, acc2 = 0.0;
  Cursor k = walk_start(w, v0 + threadIdx.x, c, C, B, V);
  while (k.v < v1) {
    // up to kUnroll vectors, all loads issued before any is used; a
    // vector past the share reads as zeros, which add nothing
    size_t off[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      in[u] = k.v < v1;
      off[u] = k.off;
      walk_step(w, k, B, V);
    }
    float xv[kUnroll][V], gv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_or_zero<V>(x, off[u], in[u], xv[u]);
      if constexpr (GRAD) load_or_zero<V>(dy, off[u], in[u], gv[u]);
    }
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      accumulate<GRAD, V>(xv[u], gv[u], mu, rs, p1, p2);
    acc1 += (double)p1;
    acc2 += (double)p2;
  }

  __shared__ double red[2][kThreads / 32];
  __shared__ double part[2];
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
    for (int i = 0; i < kThreads / 32; ++i) {
      t1 += red[0][i];
      t2 += red[1][i];
    }
    part[0] = t1;
    part[1] = t2;
  }
  cluster.sync();
  if (cluster.block_rank() == 0 && warp == 0) {
    // lane r reads rank r's sums; a fixed shuffle tree adds them
    double t1 = 0.0, t2 = 0.0;
    if (lane < (int)cluster.num_blocks()) {
      const double* p = cluster.map_shared_rank(part, lane);
      t1 = p[0];
      t2 = p[1];
    }
    t1 = warp_sum(t1);
    t2 = warp_sum(t2);
    if (lane == 0) {
      if constexpr (GRAD) {
        write_grad_sums(gi, c, C, t1, t2);
      } else {
        stats_epilogue(so, c, C, w.total * V, t1, t2);
      }
    }
  }
  // the other ranks keep their shared memory until rank 0 has read it
  cluster.sync();
}

// B == 1: x is [A, C]; grid (S, ceil(C / 32)), cluster (S, 1, 1);
// threadIdx.x walks channels, threadIdx.y rows.
template <typename TX, typename TG, bool GRAD>
__global__ void __launch_bounds__(kColTile * kColRows)
reduce_cols_kernel(const TX* __restrict__ x, const TG* __restrict__ dy,
                   StatsOut so, GradIn gi, int A, int C, int chunk) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.y * kColTile + threadIdx.x;
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(A, r0 + chunk);
  double acc1 = 0.0, acc2 = 0.0;
  if (c < C) {
    float mu = 0.f, rs = 0.f;
    if constexpr (GRAD) {
      mu = gi.mean[c];
      rs = gi.rstd[c];
    }
    int r = r0 + threadIdx.y;
    for (; r + (kUnroll - 1) * kColRows < r1; r += kUnroll * kColRows) {
      float xv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = (size_t)(r + u * kColRows) * C + c;
        xv[u] = to_float(x[off]);
        if constexpr (GRAD) gv[u] = to_float(dy[off]);
      }
      float p1 = 0.f, p2 = 0.f;
      accumulate<GRAD, kUnroll>(xv, gv, mu, rs, p1, p2);
      acc1 += (double)p1;
      acc2 += (double)p2;
    }
    for (; r < r1; r += kColRows) {
      const size_t off = (size_t)r * C + c;
      float xv[1] = {to_float(x[off])}, gv[1] = {0.f};
      if constexpr (GRAD) gv[0] = to_float(dy[off]);
      float p1 = 0.f, p2 = 0.f;
      accumulate<GRAD, 1>(xv, gv, mu, rs, p1, p2);
      acc1 += (double)p1;
      acc2 += (double)p2;
    }
  }
  __shared__ double red[2][kColRows][kColTile];
  __shared__ double part[2][kColTile];
  red[0][threadIdx.y][threadIdx.x] = acc1;
  red[1][threadIdx.y][threadIdx.x] = acc2;
  __syncthreads();
  if (threadIdx.y == 0) {
    double t1 = 0.0, t2 = 0.0;
    for (int y = 0; y < kColRows; ++y) {
      t1 += red[0][y][threadIdx.x];
      t2 += red[1][y][threadIdx.x];
    }
    part[0][threadIdx.x] = t1;
    part[1][threadIdx.x] = t2;
  }
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.y == 0 && c < C) {
    // every rank's loads first, then the sums in rank order
    const unsigned int S = cluster.num_blocks();
    double v1[kMaxCluster], v2[kMaxCluster];
#pragma unroll
    for (unsigned int r = 0; r < kMaxCluster; ++r) {
      if (r < S) {
        const double* p = cluster.map_shared_rank(&part[0][0], r);
        v1[r] = p[threadIdx.x];
        v2[r] = p[kColTile + threadIdx.x];
      }
    }
    double t1 = 0.0, t2 = 0.0;
#pragma unroll
    for (unsigned int r = 0; r < kMaxCluster; ++r) {
      if (r < S) {
        t1 += v1[r];
        t2 += v2[r];
      }
    }
    if constexpr (GRAD) {
      write_grad_sums(gi, c, C, t1, t2);
    } else {
      stats_epilogue(so, c, C, (unsigned int)A, t1, t2);
    }
  }
  cluster.sync();
}

// Elementwise passes: per-channel constants and the map of one element.
// kApply: y from given statistics; kApplySums: y from given sums, the
// statistics worked out in each CTA (and written by share 0's); kDx: dx.
constexpr int kApply = 0, kApplySums = 1, kDx = 2;

struct EwIn {
  const float* mean;
  const float* rstd;
  const float* weight;        // apply: scale = rstd * weight
  const float* bias;          // apply; may be null
  const float* scale;         // dx
  const float* sum_dy;        // dx
  const float* sum_dy_xhat;   // dx
  unsigned int m;             // dx, apply from sums: the count
  const float* sums;          // apply from sums: [2, C]
  float* stats;               // apply from sums: [4, C] out
  float* running_mean;        // apply from sums: [C] or null
  float* running_var;
  float eps;
};

struct EwConsts {
  float mu, sc, bi, rs, c1, c2;
  bool has_bias;
};

// writer: the one thread a channel that stores the statistics (share 0)
template <int OP>
__device__ __forceinline__ EwConsts ew_consts(const EwIn& p, int c, int C,
                                              bool writer) {
  EwConsts k;
  k.bi = k.c1 = k.c2 = 0.f;
  k.has_bias = false;
  if constexpr (OP == kDx) {
    const float inv_m = __fdiv_rn(1.0f, (float)p.m);
    k.mu = p.mean[c];
    k.rs = p.rstd[c];
    k.sc = p.scale[c];
    k.c1 = __fmul_rn(p.sum_dy[c], inv_m);
    k.c2 = __fmul_rn(p.sum_dy_xhat[c], inv_m);
  } else {
    if constexpr (OP == kApplySums) {
      const BnStats st = finalize_stats(p.sums[c], p.sums[C + c], p.m,
                                        p.eps, p.weight[c]);
      if (writer)
        write_stats(p.stats, p.running_mean, p.running_var, c, C, st);
      k.mu = st.mean;
      k.rs = st.rstd;
      k.sc = st.scale;
    } else {
      k.mu = p.mean[c];
      k.rs = p.rstd[c];
      k.sc = __fmul_rn(k.rs, p.weight[c]);
    }
    if (p.bias != nullptr) {
      k.bi = p.bias[c];
      k.has_bias = true;
    }
  }
  return k;
}

template <int OP>
__device__ __forceinline__ float ew_map(const EwConsts& k, float x, float g) {
  if constexpr (OP == kDx) {
    const float xhat = __fmul_rn(__fsub_rn(x, k.mu), k.rs);
    return __fmul_rn(k.sc, __fsub_rn(__fsub_rn(g, k.c1),
                                     __fmul_rn(xhat, k.c2)));
  } else {
    const float y = __fmul_rn(__fsub_rn(x, k.mu), k.sc);
    return k.has_bias ? __fadd_rn(y, k.bi) : y;
  }
}

// B > 1: grid (S, C). apply: out = y (type TO); dx: out = dx (TO = TX).
template <typename TX, typename TG, typename TO, int OP, bool VEC>
__global__ void __launch_bounds__(kThreads)
ewise_rows_kernel(const TX* __restrict__ x, const TG* __restrict__ dy,
                  TO* __restrict__ out, EwIn p, int C, int B, Walk w) {
  constexpr int V = VEC ? kVec : 1;
  constexpr bool DX = OP == kDx;
  const int c = blockIdx.y;
  const EwConsts k =
      ew_consts<OP>(p, c, C, blockIdx.x == 0 && threadIdx.x == 0);
  const unsigned int v0 = blockIdx.x * w.chunk;
  const unsigned int v1 = min(w.total, v0 + w.chunk);
  Cursor cur = walk_start(w, v0 + threadIdx.x, c, C, B, V);
  while (cur.v < v1) {
    // up to kUnroll vectors, all loads issued before any is used
    size_t off[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      in[u] = cur.v < v1;
      off[u] = cur.off;
      walk_step(w, cur, B, V);
    }
    float xv[kUnroll][V], gv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_or_zero<V>(x, off[u], in[u], xv[u]);
      if constexpr (DX) load_or_zero<V>(dy, off[u], in[u], gv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!in[u]) continue;
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = ew_map<OP>(k, xv[u][e], DX ? gv[u][e] : 0.f);
      store_vec<V>(out + off[u], o);
    }
  }
}

// B == 1: grid (ceil(A / chunk), ceil(C / 32)), block (32, 8).
template <typename TX, typename TG, typename TO, int OP>
__global__ void __launch_bounds__(kColTile * kColRows)
ewise_cols_kernel(const TX* __restrict__ x, const TG* __restrict__ dy,
                  TO* __restrict__ out, EwIn p, int A, int C, int chunk) {
  const int c = blockIdx.y * kColTile + threadIdx.x;
  if (c >= C) return;
  const EwConsts k =
      ew_consts<OP>(p, c, C, blockIdx.x == 0 && threadIdx.y == 0);
  const int r1 = min(A, (int)(blockIdx.x + 1) * chunk);
  for (int r = blockIdx.x * chunk + threadIdx.y; r < r1; r += kColRows) {
    const size_t off = (size_t)r * C + c;
    const float g = OP == kDx ? to_float(dy[off]) : 0.f;
    out[off] = from_float<TO>(ew_map<OP>(k, to_float(x[off]), g));
  }
}

Walk make_walk(int A, int C, int B, int S, bool vec) {
  Walk w;
  w.per_row = vec ? B / kVec : B;
  w.total = (unsigned int)A * w.per_row;
  w.chunk = (w.total + S - 1) / S;
  w.step_q = kThreads / w.per_row;
  w.step_r = kThreads % w.per_row;
  w.row_stride = (unsigned long long)C * B;
  return w;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0;
}

// Launch with a cluster of S CTAs along x.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 block,
                           unsigned int S, cudaStream_t stream,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Clusters above 8 CTAs need the non-portable size, set once for the
// three reduction kernels of an instantiation.
template <typename TX, typename TG, bool GRAD>
cudaError_t allow_large_clusters() {
  const void* kernels[3] = {
      reinterpret_cast<const void*>(reduce_cols_kernel<TX, TG, GRAD>),
      reinterpret_cast<const void*>(reduce_rows_kernel<TX, TG, GRAD, true>),
      reinterpret_cast<const void*>(reduce_rows_kernel<TX, TG, GRAD, false>)};
  for (const void* k : kernels) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename TX, typename TG, bool GRAD>
cudaError_t launch_reduce(const void* xp, const void* dyp, StatsOut so,
                          GradIn gi, int A, int C, int B, int S,
                          cudaStream_t st) {
  if (S > 8) {
    static const cudaError_t large = allow_large_clusters<TX, TG, GRAD>();
    if (large != cudaSuccess) return large;
  }
  const TX* x = static_cast<const TX*>(xp);
  const TG* dy = static_cast<const TG*>(dyp);
  if (B == 1) {
    const int chunk = (A + S - 1) / S;
    const dim3 grid(S, (C + kColTile - 1) / kColTile);
    return launch_cluster(reduce_cols_kernel<TX, TG, GRAD>, grid,
                          dim3(kColTile, kColRows), S, st, x, dy, so, gi, A,
                          C, chunk);
  }
  const bool vec = B % kVec == 0 && aligned16(xp) && (!GRAD || aligned16(dyp));
  const Walk w = make_walk(A, C, B, S, vec);
  const dim3 grid(S, C);
  if (vec)
    return launch_cluster(reduce_rows_kernel<TX, TG, GRAD, true>, grid,
                          dim3(kThreads), S, st, x, dy, so, gi, C, B, w);
  return launch_cluster(reduce_rows_kernel<TX, TG, GRAD, false>, grid,
                        dim3(kThreads), S, st, x, dy, so, gi, C, B, w);
}

template <typename TX, typename TG, typename TO, int OP>
cudaError_t launch_ewise(const void* xp, const void* dyp, void* outp,
                         EwIn p, int A, int C, int B, int S,
                         cudaStream_t st) {
  const TX* x = static_cast<const TX*>(xp);
  const TG* dy = static_cast<const TG*>(dyp);
  TO* out = static_cast<TO*>(outp);
  if (B == 1) {
    const int chunk = (A + S - 1) / S;
    const dim3 grid((A + chunk - 1) / chunk, (C + kColTile - 1) / kColTile);
    ewise_cols_kernel<TX, TG, TO, OP><<<grid, dim3(kColTile, kColRows), 0,
                                        st>>>(x, dy, out, p, A, C, chunk);
    return cudaGetLastError();
  }
  const bool vec = B % kVec == 0 && aligned16(xp) && aligned16(outp) &&
                   (OP != kDx || aligned16(dyp));
  const Walk w = make_walk(A, C, B, S, vec);
  const dim3 grid(S, C);
  if (vec)
    ewise_rows_kernel<TX, TG, TO, OP, true><<<grid, kThreads, 0, st>>>(
        x, dy, out, p, C, B, w);
  else
    ewise_rows_kernel<TX, TG, TO, OP, false><<<grid, kThreads, 0, st>>>(
        x, dy, out, p, C, B, w);
  return cudaGetLastError();
}

// bn_apply's two modes over x's and y's types
template <int OP>
cudaError_t launch_apply(const void* x, void* y, const EwIn& p, int A, int C,
                         int B, int S, int x_dtype, int y_dtype,
                         cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (x_dtype == 0 && y_dtype == 0)
    return launch_ewise<float, float, float, OP>(x, x, y, p, A, C, B, S, st);
  if (x_dtype == 0 && y_dtype == 1)
    return launch_ewise<float, float, bf, OP>(x, x, y, p, A, C, B, S, st);
  if (x_dtype == 1 && y_dtype == 0)
    return launch_ewise<bf, bf, float, OP>(x, x, y, p, A, C, B, S, st);
  if (x_dtype == 1 && y_dtype == 1)
    return launch_ewise<bf, bf, bf, OP>(x, x, y, p, A, C, B, S, st);
  return cudaErrorInvalidValue;
}

// Per-channel counts are 32-bit; C lies on the grid's y axis.
bool bad_shape(int A, int C, int B, int S, int max_s) {
  const long long m = (long long)A * B;
  const long long rows = B == 1 ? A : m;
  return A <= 0 || C <= 0 || B <= 0 || S <= 0 || S > max_s || S > rows ||
         C > 65535 * (B == 1 ? kColTile : 1) || m > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
//
// stats: f32 [4, C] (mean, var, rstd, scale); sums: f32 [2, C] or null;
// running_mean, running_var: f32 [C], both or neither, updated in place.
int bpbreid_bn_stats(const void* x, const float* weight, float* running_mean,
                     float* running_var, float* stats, float* sums, int A,
                     int C, int B, int S, float eps, int x_dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(A, C, B, S, kMaxCluster) ||
      (running_mean == nullptr) != (running_var == nullptr))
    return (int)cudaErrorInvalidValue;
  const StatsOut so{stats, sums, weight, running_mean, running_var,
                    eps};
  const GradIn gi{nullptr, nullptr, nullptr, nullptr};
  if (x_dtype == 0)
    return (int)launch_reduce<float, float, false>(x, x, so, gi, A, C, B, S,
                                                   st);
  if (x_dtype == 1)
    return (int)launch_reduce<__nv_bfloat16, __nv_bfloat16, false>(
        x, x, so, gi, A, C, B, S, st);
  return (int)cudaErrorInvalidValue;
}

// out: f32 [2, C] (sum dy, sum dy*xhat); out2: null, or f32 [2, C] that
// gets the same sums (the copy a rank all-reduces in place).
int bpbreid_bn_grad_stats(const void* dy, const void* x, const float* mean,
                          const float* rstd, float* out, float* out2, int A,
                          int C, int B, int S, int dy_dtype, int x_dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(A, C, B, S, kMaxCluster)) return (int)cudaErrorInvalidValue;
  const StatsOut so{};
  const GradIn gi{mean, rstd, out, out2};
  using bf = __nv_bfloat16;
  if (x_dtype == 0 && dy_dtype == 0)
    return (int)launch_reduce<float, float, true>(x, dy, so, gi, A, C, B, S,
                                                  st);
  if (x_dtype == 0 && dy_dtype == 1)
    return (int)launch_reduce<float, bf, true>(x, dy, so, gi, A, C, B, S, st);
  if (x_dtype == 1 && dy_dtype == 0)
    return (int)launch_reduce<bf, float, true>(x, dy, so, gi, A, C, B, S, st);
  if (x_dtype == 1 && dy_dtype == 1)
    return (int)launch_reduce<bf, bf, true>(x, dy, so, gi, A, C, B, S, st);
  return (int)cudaErrorInvalidValue;
}

// y = (x - mean) * (rstd * weight) (+ bias), y of type y_dtype. bias may
// be null.
int bpbreid_bn_apply(const void* x, const float* mean, const float* rstd,
                     const float* weight, const float* bias, void* y, int A,
                     int C, int B, int S, int x_dtype, int y_dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(A, C, B, 1, 1) || S <= 0 || S > 65535)
    return (int)cudaErrorInvalidValue;
  EwIn p{};
  p.mean = mean;
  p.rstd = rstd;
  p.weight = weight;
  p.bias = bias;
  return (int)launch_apply<kApply>(x, y, p, A, C, B, S, x_dtype, y_dtype,
                                   st);
}

// bn_apply from sums f32 [2, C] (sum x, sum x*x over m values a channel):
// stats f32 [4, C] (mean, var, rstd, scale) as bn_stats's epilogue gives
// them, y as bpbreid_bn_apply gives it from those; running_mean,
// running_var: f32 [C], both or neither, updated in place.
int bpbreid_bn_apply_sums(const void* x, const float* sums,
                          const float* weight, const float* bias,
                          float* running_mean, float* running_var,
                          float* stats, void* y, int A, int C, int B, int S,
                          int m, float eps, int x_dtype, int y_dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(A, C, B, 1, 1) || S <= 0 || S > 65535 || m <= 0 ||
      (running_mean == nullptr) != (running_var == nullptr))
    return (int)cudaErrorInvalidValue;
  EwIn p{};
  p.weight = weight;
  p.bias = bias;
  p.m = (unsigned int)m;
  p.sums = sums;
  p.stats = stats;
  p.running_mean = running_mean;
  p.running_var = running_var;
  p.eps = eps;
  return (int)launch_apply<kApplySums>(x, y, p, A, C, B, S, x_dtype,
                                       y_dtype, st);
}

// dx = scale * (dy - sum_dy/m - xhat * sum_dy_xhat/m), dx of x's type;
// sum_dy and sum_dy_xhat as bpbreid_bn_grad_stats gives them (or their
// all-reduce across ranks, with m the global count).
int bpbreid_bn_dx(const void* dy, const void* x, const float* mean,
                  const float* rstd, const float* scale, const float* sum_dy,
                  const float* sum_dy_xhat, void* dx, int A, int C, int B,
                  int S, int m, int dy_dtype, int x_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(A, C, B, 1, 1) || S <= 0 || S > 65535 || m <= 0)
    return (int)cudaErrorInvalidValue;
  EwIn p{};
  p.mean = mean;
  p.rstd = rstd;
  p.scale = scale;
  p.sum_dy = sum_dy;
  p.sum_dy_xhat = sum_dy_xhat;
  p.m = (unsigned int)m;
  using bf = __nv_bfloat16;
  if (x_dtype == 0 && dy_dtype == 0)
    return (int)launch_ewise<float, float, float, kDx>(x, dy, dx, p, A, C, B,
                                                       S, st);
  if (x_dtype == 0 && dy_dtype == 1)
    return (int)launch_ewise<float, bf, float, kDx>(x, dy, dx, p, A, C, B, S,
                                                    st);
  if (x_dtype == 1 && dy_dtype == 0)
    return (int)launch_ewise<bf, float, bf, kDx>(x, dy, dx, p, A, C, B, S,
                                                 st);
  if (x_dtype == 1 && dy_dtype == 1)
    return (int)launch_ewise<bf, bf, bf, kDx>(x, dy, dx, p, A, C, B, S, st);
  return (int)cudaErrorInvalidValue;
}

const char* bpbreid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
