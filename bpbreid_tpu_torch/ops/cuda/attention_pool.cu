// Fused part-attention softmax + masked pooling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bpbreid_tpu/ops/pallas/pooling.py
// (fused_attention_pool :47, kernel body _kernel :30). For one sample n:
//
//   probs[p, k] = softmax_k(logits[n, k, p])          (f32)
//   num[n, k, d] = sum_p probs[p, k] * feats[n, d, p]  (f32 accumulation)
//   den[n, k]    = sum_p probs[p, k]
//   vismax[n, k] = max_p probs[p, k]
//
// Layout: the port's HRNet produces channel-first maps, so features are
// read as [N, D, P] and logits as [N, K1, P] (P = H*W pixels), both
// contiguous; no transposing copy of the feature map is made.
//
// Bound: the feature map is read once (64 x 1920 x 3072 at the main path,
// bf16 as the models hand it over: 755 MB, 0.227 ms at 3.35 TB/s); 2*K1
// f32 operations an element (0.035 ms of the card's f32 rate at K1 = 6)
// are far below the flop/byte balance, so the kernel is bound by
// device-memory bytes.
//
// Design (staging the features in shared memory as f32 made the on-chip
// work as long as the bytes at bf16, so no f32 copy is made):
//  - A cluster of S <= 8 CTAs a sample; CTA r owns one slice of the
//    sample's pixels. It computes the softmax of its slice's pixels once,
//    into a [K1][slice] f32 table in shared memory, and the slice's share
//    of den and vismax from it. Grid (S, DS, N): on maps too small to cut
//    into slices (12x4, 24x8) the channels split into DS ranges instead,
//    each CTA tabling its slice again (a few pixels).
//  - The features come as 16-byte vectors of bf16 (or f32) by cp.async
//    into a ring of shared memory (64 KB a CTA: 2-8 stages), converted in
//    registers: no f32 copy of the tile and no block barrier between
//    loads, since a thread reads back only the slots it filled. A warp
//    step covers 4 channel rows x 64 pixels a load (8 lanes read a row's
//    128 contiguous bytes at bf16); a thread owns CH channels (CH rows of
//    8 pixels) and keeps the next stages' loads in flight while it
//    reduces the current one. The loads skip L1 and ask L2 for 256 bytes
//    (the next step's segment of the row). Maps whose rows are not
//    16-byte vectors load value by value into registers, one step ahead.
//  - The reduction runs on the CUDA cores in f32, K1 accumulators a
//    channel (a template parameter: the real count for the shipped masks'
//    6, 7 and 9 parts, else padded to 4, 8, 16, 32, 48 or 64, the padded
//    loop branching once a block of 4 parts). The probabilities of a
//    lane's 8 pixels are read from the table once a step for all CH
//    channels (4 up to 16 accumulators, 2 up to 48, else 1), laid out
//    so that a quarter warp reads 128 contiguous bytes; after a channel
//    group's last step the 8 lanes that share a row add their sums by a
//    butterfly of shuffles (every lane gets the same bits) into the CTA's
//    [K1][channels] partial sums in shared memory.
//  - The S slices' partial sums meet through distributed shared memory
//    after a cluster barrier: CTA r adds its share of the channels over
//    the S ranks in rank order and writes num; rank 0 of the first channel
//    range writes den and vismax. No atomics: two calls give the same
//    bits.
//  - The grid: one CTA of 256 threads on each SM, all resident at once
//    (the wrapper's plan picks S and DS from N), at most 128 registers a
//    thread up to 10 accumulators a channel. Measured with k2_bench.py on
//    an H100 at the main shape, bf16 (device time): two CTAs an SM (S =
//    4) 0.380 ms, one (S = 2) 0.297 ms with the loads in registers (one
//    or two steps in flight), 0.261 ms through the ring (three); without
//    the register cap the compiler's schedule took 0.323 ms. The bf16
//    reduction on the tensor cores (mma.sync, the probabilities split
//    into bf16 hi + lo) took 0.33-0.38 ms: the instructions were not what
//    bound the kernel, so that path was not kept.
//    Shared memory bounds the table and the partial sums; a slice longer
//    than the table is taken in sub-chunks and a channel range above the
//    partial sums' room in channel chunks (above 9 parts at the main
//    shape).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 64;                // pixels a warp step covers
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;         // bytes a block can use
constexpr int kRingBytes = 65536;        // the cp.async ring of a CTA

// stages of the ring, by the 16-byte vectors a thread loads a step
__host__ __device__ constexpr int ring_stages(int vecs) {
  return kRingBytes / (kThreads * 16 * vecs) > 8
             ? 8
             : kRingBytes / (kThreads * 16 * vecs);
}

// channels a thread owns, by the accumulators a channel needs: each read
// of the table serves CH channels (k2_bench.py on an H100, K+1 = 37 at
// the main shape: 2 channels with 48 accumulators 3.0 ms, with 64 3.4,
// 1 channel with 64 4.8)
__host__ __device__ constexpr int channels_per_thread(int kt) {
  return kt <= 16 ? 4 : (kt <= 48 ? 2 : 1);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of TF -> 16 / sizeof(TF) floats
__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* out,
                                       __nv_bfloat16) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 16 bytes of the features copied into shared memory without passing
// through registers (zeros where !in), read once: L1 skipped, L2 asked to
// fetch the 256 bytes around them (the next step's row segment rides
// along); completion by commit and wait groups.
__device__ __forceinline__ void copy16_async(uint4* dst, const void* src,
                                             bool in) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(s),
      "l"(src), "r"(in ? 16 : 0)
      : "memory");
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's 8 pixels of a step, as two quads: at bf16 one 16-byte vector
// (pixels 8l..8l+7 of the step), at f32 two (4l..4l+3 and 32+4l..32+4l+3,
// so that each load of 8 lanes is 128 contiguous bytes).
template <typename TF>
__device__ __forceinline__ int quad_offset(int lane8, int q) {
  return sizeof(TF) == 2 ? 8 * lane8 + 4 * q : 4 * lane8 + 32 * q;
}

// Where the table keeps pixel i: quad q of lane l at 4l + 32q of its step
// at either width, so that the 8 lanes of a quarter warp read 128
// contiguous bytes (no bank conflict); at bf16 the quads are swizzled.
template <typename TF>
__device__ __forceinline__ int table_pos(int i) {
  if (sizeof(TF) == 4) return i;
  const int c = (i >> 2) & 15;               // the quad in the step
  return (i & ~63) | (((c >> 1) | ((c & 1) << 3)) << 2) | (i & 3);
}

// One row's 8 pixels of one step, loaded one by one (maps whose rows are
// not 16-byte vectors)
template <typename TF, int CH>
__device__ __forceinline__ void load_step(float (&buf)[CH][8],
                                          const TF* __restrict__ f_n, int P,
                                          int d0, int dend, int p, int pend,
                                          int lane8) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int d = d0 + 4 * c;
    const bool in = d < dend;
    const TF* row = f_n + (size_t)(in ? d : 0) * P;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int px = p + quad_offset<TF>(lane8, q) + j;
        buf[c][4 * q + j] = (in && px < pend) ? to_float(row[px]) : 0.f;
      }
    }
  }
}

// One step's 8 pixels of CH rows into acc: the probabilities of the
// lane's 8 pixels are read from the table once for all CH channels. The
// parts go in blocks of 4, one uniform branch a block; in a padded
// block the parts past K1 read row K1 - 1 into accumulators that are
// never written out.
template <int KT, bool EXACT, int CH>
__device__ __forceinline__ void accumulate(float (&acc)[CH][KT],
                                           float (&f)[CH][8],
                                           const float* probs, int pc,
                                           int pp, int lane8, int K1) {
#pragma unroll
  for (int k0 = 0; k0 < KT; k0 += 4) {
    if (EXACT || k0 < K1) {
#pragma unroll
      for (int k = k0; k < k0 + 4 && k < KT; ++k) {
        const float* pr = probs + (EXACT ? k : min(k, K1 - 1)) * pc + pp;
        const float4 a = *reinterpret_cast<const float4*>(pr + 4 * lane8);
        const float4 b =
            *reinterpret_cast<const float4*>(pr + 32 + 4 * lane8);
        const float pk[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[c][k] = fmaf(pk[j], f[c][j], acc[c][k]);
      }
    }
  }
}

// A channel group's sums: the 8 lanes of a row add theirs (every lane
// gets the same bits) into the partial sums; acc back to 0.
template <int KT, bool EXACT, int CH>
__device__ __forceinline__ void flush_group(float (&acc)[CH][KT],
                                            float* partial, int dc, int d0,
                                            int dcn, int lane8, int K1,
                                            bool first) {
#pragma unroll
  for (int k0 = 0; k0 < KT; k0 += 4) {
    if (EXACT || k0 < K1) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int k = k0; k < k0 + 4 && k < KT; ++k) {
          float v = acc[c][k];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          const int dl = d0 + 4 * c;
          if ((EXACT || k < K1) && ((c * KT + k) & 7) == lane8 && dl < dcn) {
            float* out = partial + k * dc + dl;
            *out = first ? v : *out + v;
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int k = 0; k < KT; ++k) acc[c][k] = 0.f;
}

// KT: accumulators a channel (K1 itself when EXACT, else K1 <= KT). VEC:
// the features come in 16-byte vectors through a ring of shared memory
// by cp.async, else value by value into registers.
// grid (S, DS, N), cluster (S, 1, 1): blockIdx.x the pixel slice,
// blockIdx.y the channels [y * dr, (y + 1) * dr).
template <typename TF, int KT, bool EXACT, bool VEC>
__global__ void __launch_bounds__(kThreads, KT <= 10 ? 2 : 1)
attention_pool_kernel(const TF* __restrict__ feats,
                      const void* __restrict__ logits, bool logits_bf16,
                      float* __restrict__ num, float* __restrict__ den,
                      float* __restrict__ vismax, int D, int P, int K1_arg,
                      int slice, int pc, int dr, int dc) {
  constexpr int CH = channels_per_thread(KT);
  constexpr int G = 4 * CH;                  // channels a warp group
  constexpr int kVecs = (int)sizeof(TF) / 2;   // 16-byte vectors a row step
  constexpr int kStages = ring_stages(CH * kVecs);
  const int K1 = EXACT ? KT : K1_arg;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int S = cluster.num_blocks();
  const unsigned int rank = cluster.block_rank();

  extern __shared__ __align__(16) float smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);   // [stages][CH][vecs][tid]
  float* probs = smem + (VEC ? kRingBytes / 4 : 0);   // [K1][pc]
  float* partial = probs + (size_t)K1 * pc;  // [K1][dc]
  float* den_part = partial + (size_t)K1 * dc;   // [K1]
  float* max_part = den_part + K1;               // [K1]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row4 = lane >> 3, lane8 = lane & 7;
  const int n = blockIdx.z;
  const int d_lo = (int)blockIdx.y * dr;
  const int d_hi = min(D, d_lo + dr);
  const TF* f_n = feats + (size_t)n * D * P;
  const int s0 = (int)blockIdx.x * slice;
  const int s1 = min(P, s0 + slice);
  const int n_sub = (s1 - s0 + pc - 1) / pc;

  for (int dc0 = d_lo; dc0 < d_hi; dc0 += dc) {
    const int dcn = min(dc, d_hi - dc0);
    const int groups = (dcn + G - 1) / G;
    const int my_groups = groups > warp ? (groups - warp + kWarps - 1) /
                                              kWarps
                                        : 0;
    for (int sc = 0; sc < n_sub; ++sc) {
      const int p0 = s0 + sc * pc;
      const int pn = min(pc, s1 - p0);
      if (dc0 == d_lo || n_sub > 1) {
        // the table of the sub-chunk's probabilities; no warp still reads
        // the one before
        if (sc > 0 || dc0 > d_lo) __syncthreads();
        for (int i = tid; i < pc; i += kThreads) {
          if (i < pn) {
            const size_t at = (size_t)n * K1 * P + p0 + i;
            float lv[KT];
            float m = -INFINITY;
#pragma unroll
            for (int k = 0; k < KT; ++k) {
              if (EXACT || k < K1) {
                const size_t idx = at + (size_t)k * P;
                lv[k] = logits_bf16
                            ? __bfloat162float(
                                  static_cast<const __nv_bfloat16*>(
                                      logits)[idx])
                            : static_cast<const float*>(logits)[idx];
                m = fmaxf(m, lv[k]);
              }
            }
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < KT; ++k) {
              if (EXACT || k < K1) {
                lv[k] = expf(lv[k] - m);
                s += lv[k];
              }
            }
#pragma unroll
            for (int k = 0; k < KT; ++k)
              if (EXACT || k < K1) probs[k * pc + table_pos<TF>(i)] = lv[k] / s;
          } else {
            for (int k = 0; k < K1; ++k) probs[k * pc + table_pos<TF>(i)] = 0.f;
          }
        }
        __syncthreads();
        if (dc0 == d_lo) {
          // this slice's share of den and vismax: warp w owns parts
          // w, w + 8, ... (a fixed order of sums; the table's zeros past
          // pn up to the step count in)
          const int pn_steps = (pn + kStep - 1) / kStep * kStep;
          for (int k = warp; k < K1; k += kWarps) {
            float sum = 0.f, mx = 0.f;
            for (int i = lane; i < pn_steps; i += 32) {
              const float v = probs[k * pc + i];
              sum += v;
              mx = fmaxf(mx, v);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              sum += __shfl_xor_sync(0xffffffffu, sum, o);
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            }
            if (lane == 0) {
              den_part[k] = sc == 0 ? sum : den_part[k] + sum;
              max_part[k] = sc == 0 ? mx : fmaxf(max_part[k], mx);
            }
          }
        }
      }

      // the warp's channel groups, each over the sub-chunk's pixels in
      // steps of kStep
      const int steps = (pn + kStep - 1) / kStep;
      const int total = my_groups * steps;
      int lg = 0, ls = 0;            // the next step to load
      float acc[CH][KT];
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int k = 0; k < KT; ++k) acc[c][k] = 0.f;
      int cg_ = 0, cs = 0;           // the step being reduced
      if constexpr (VEC) {
        // kStages - 1 steps in flight ahead of the one reduced; a thread
        // reads back only the slots it filled, so no barrier
        auto issue = [&](int slot) {
          const int d0 = dc0 + (warp + lg * kWarps) * G + row4;
          const int p = p0 + ls * kStep;
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const int d = d0 + 4 * c;
            const bool in = d < dc0 + dcn;
            const TF* row = f_n + (size_t)(in ? d : 0) * P;
#pragma unroll
            for (int v = 0; v < kVecs; ++v) {
              const int px =
                  p + quad_offset<TF>(lane8, sizeof(TF) == 2 ? 0 : v);
              const bool ok = in && px < p0 + pn;
              copy16_async(ring + ((slot * CH + c) * kVecs + v) * kThreads +
                               tid,
                           ok ? (const void*)(row + px) : (const void*)f_n,
                           ok);
            }
          }
          if (++ls == steps) {
            ls = 0;
            ++lg;
          }
        };
#pragma unroll
        for (int u = 0; u < kStages - 1; ++u) {
          if (u < total) issue(u);
          copy_async_commit();
        }
        int slot = 0;
        for (int t = 0; t < total; ++t) {
          if (t + kStages - 1 < total)
            issue(slot == 0 ? kStages - 1 : slot - 1);
          copy_async_commit();
          copy_async_wait<kStages - 1>();
          float f[CH][8];
#pragma unroll
          for (int c = 0; c < CH; ++c) {
#pragma unroll
            for (int v = 0; v < kVecs; ++v)
              unpack(ring[((slot * CH + c) * kVecs + v) * kThreads + tid],
                     f[c] + v * 4, TF());
          }
          accumulate<KT, EXACT, CH>(acc, f, probs, pc, cs * kStep, lane8,
                                        K1);
          if (++cs == steps) {
            flush_group<KT, EXACT, CH>(acc, partial, dc,
                                       (warp + cg_ * kWarps) * G + row4, dcn,
                                       lane8, K1, sc == 0);
            cs = 0;
            ++cg_;
          }
          slot = slot + 1 == kStages ? 0 : slot + 1;
        }
      } else {
        // the next step's loads in flight while one is reduced
        float buf[CH][8];
        if (total > 0)
          load_step<TF, CH>(buf, f_n, P, dc0 + warp * G + row4, dc0 + dcn,
                            p0, p0 + pn, lane8);
        for (int t = 0; t < total; ++t) {
          float f[CH][8];
#pragma unroll
          for (int c = 0; c < CH; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) f[c][j] = buf[c][j];
          if (++ls == steps) {
            ls = 0;
            ++lg;
          }
          if (t + 1 < total)
            load_step<TF, CH>(buf, f_n, P,
                              dc0 + (warp + lg * kWarps) * G + row4,
                              dc0 + dcn, p0 + ls * kStep, p0 + pn, lane8);
          accumulate<KT, EXACT, CH>(acc, f, probs, pc, cs * kStep, lane8, K1);
          if (++cs == steps) {
            flush_group<KT, EXACT, CH>(acc, partial, dc,
                                       (warp + cg_ * kWarps) * G + row4, dcn,
                                       lane8, K1, sc == 0);
            cs = 0;
            ++cg_;
          }
        }
      }
    }

    // the S slices' sums meet: rank r adds its share of the channels over
    // the ranks in rank order
    cluster.sync();
    const int per = (dcn + (int)S - 1) / (int)S;
    const int lo = (int)rank * per;
    const int cnt = max(0, min(dcn, lo + per) - lo);
    for (int i = tid; i < K1 * cnt; i += kThreads) {
      const int k = i / cnt;
      const int dl = lo + (i - k * cnt);
      float v[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < (int)S) v[q] = cluster.map_shared_rank(partial, q)[k * dc + dl];
      float sum = v[0];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q)
        if (q < (int)S) sum += v[q];
      num[((size_t)n * K1 + k) * D + dc0 + dl] = sum;
    }
    if (dc0 == 0 && rank == 0 && tid < K1) {
      // the first channel range's CTAs write den and vismax
      float sum = 0.f, mx = 0.f;
      for (unsigned int q = 0; q < S; ++q) {
        sum += cluster.map_shared_rank(den_part, q)[tid];
        mx = fmaxf(mx, cluster.map_shared_rank(max_part, q)[tid]);
      }
      den[(size_t)n * K1 + tid] = sum;
      vismax[(size_t)n * K1 + tid] = mx;
    }
    // the other ranks keep their shared memory until every rank has read
    cluster.sync();
  }
}

size_t smem_bytes(int K1, int pc, int dc, bool vec) {
  return (size_t)(K1 * (size_t)pc + K1 * (size_t)dc + 2 * K1) *
             sizeof(float) +
         (vec ? kRingBytes : 0);
}

template <typename TF, int KT, bool EXACT, bool VEC>
cudaError_t launch(const void* feats, const void* logits, bool logits_bf16,
                   float* num, float* den, float* vismax, int N, int D, int P,
                   int K1, int S, int slice, int pc, int dr, int dc,
                   cudaStream_t stream) {
  auto kernel = attention_pool_kernel<TF, KT, EXACT, VEC>;
  // once an instantiation: the largest dynamic shared memory a plan uses
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (D + dr - 1) / dr, N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(K1, pc, dc, VEC);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = S;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const TF*>(feats),
                            logits, logits_bf16, num, den, vismax, D, P, K1,
                            slice, pc, dr, dc);
}

// K1 padded to the next accumulator count an instantiation has
template <typename TF, bool VEC>
cudaError_t launch_padded(const void* feats, const void* logits, bool lbf,
                          float* num, float* den, float* vismax, int N,
                          int D, int P, int K1, int S, int slice, int pc,
                          int dr, int dc, cudaStream_t st) {
#define K2_PADDED(kt)                                                      \
  return launch<TF, kt, false, VEC>(feats, logits, lbf, num, den, vismax, \
                                    N, D, P, K1, S, slice, pc, dr, dc, st)
  if (K1 <= 4) K2_PADDED(4);
  if (K1 <= 8) K2_PADDED(8);
  if (K1 <= 16) K2_PADDED(16);
  if (K1 <= 32) K2_PADDED(32);
  if (K1 <= 48) K2_PADDED(48);
  K2_PADDED(64);
#undef K2_PADDED
}

// 16-byte vectors of the features (P a multiple of a vector's pixels, the
// map 16-byte aligned) with the shipped masks' part counts (five_v 6,
// isp_6_parts 7, eight 9) take an instantiation of that exact count; the
// rest a padded one.
template <typename TF>
cudaError_t dispatch_k(const void* feats, const void* logits, bool lbf,
                       float* num, float* den, float* vismax, int N, int D,
                       int P, int K1, int S, int slice, int pc, int dr,
                       int dc, cudaStream_t st) {
  if (P % (16 / (int)sizeof(TF)) != 0 ||
      reinterpret_cast<size_t>(feats) % 16 != 0)
    return launch_padded<TF, false>(feats, logits, lbf, num, den, vismax, N,
                                    D, P, K1, S, slice, pc, dr, dc, st);
#define K2_EXACT(k)                                                          \
  case k:                                                                   \
    return launch<TF, k, true, true>(feats, logits, lbf, num, den, vismax, \
                                     N, D, P, K1, S, slice, pc, dr, dc, st);
  switch (K1) {
    K2_EXACT(6) K2_EXACT(7) K2_EXACT(9)
    default: break;
  }
#undef K2_EXACT
  return launch_padded<TF, true>(feats, logits, lbf, num, den, vismax, N, D,
                                 P, K1, S, slice, pc, dr, dc, st);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. The plan (the wrapper's
// attention_pool_plan): S CTAs a sample (one cluster), each a slice of
// `slice` pixels (a multiple of 64; the S slices cover P, none empty) and
// `dr` channels (a multiple of 16; ceil(D / dr) ranges), probabilities
// tabled `pc` pixels at a time (a multiple of 64), partial sums `dc`
// channels at a time (a multiple of 16). Returns a cudaError_t code.
int bpbreid_attention_pool(const void* feats, const void* logits, float* num,
                           float* den, float* vismax, int N, int D, int P,
                           int K1, int S, int slice, int pc, int dr, int dc,
                           int feat_dtype, int logit_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || D <= 0 || P <= 0 || K1 <= 0 || K1 > 64 || N > 65535 ||
      S <= 0 || S > kMaxCluster || slice <= 0 || slice % kStep != 0 ||
      (long long)S * slice < P || (long long)(S - 1) * slice >= P ||
      pc <= 0 || pc % kStep != 0 || dr <= 0 || dr % 16 != 0 ||
      (D + dr - 1) / dr > 65535 || dc <= 0 || dc % 16 != 0 ||
      smem_bytes(K1, pc, dc, true) > (size_t)kMaxSmem || logit_dtype < 0 ||
      logit_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const bool lbf = logit_dtype == 1;
  if (feat_dtype == 0)
    return (int)dispatch_k<float>(feats, logits, lbf, num, den, vismax, N, D,
                                  P, K1, S, slice, pc, dr, dc, st);
  if (feat_dtype == 1)
    return (int)dispatch_k<__nv_bfloat16>(feats, logits, lbf, num, den,
                                          vismax, N, D, P, K1, S, slice, pc,
                                          dr, dc, st);
  return (int)cudaErrorInvalidValue;
}

const char* bpbreid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
