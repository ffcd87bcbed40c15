// Eval BasicBlock chain with BN folded, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bpbreid_tpu/ops/pallas/conv_chain.py
// fused_basicblock_chain :86 (body _chain_kernel :73, im2col conv
// _conv3x3_vmem :57). Per block i of the chain, on an NHWC map:
//   y = relu(conv3x3(x) * s1 + b1)
//   y = conv3x3(y) * s2 + b2
//   x = relu(x + y)
// 3x3 convs with zero padding 1, f32 products and sums. x stays f32 from
// block to block and is cast to the output type after the last one, as in
// the TPU kernel (:74, :83).
//
// Bound: operations. At HRNet-W32's branch chains (N=64, 384x128 input)
// every conv is 2*N*H*W*9*C^2 = 3.6 GFLOP against 12.6 MB of bf16 map, far
// above the card's flop/byte balance. This first version runs on the CUDA
// cores in f32 (no tensor cores, no TMA), so it sits far from the bf16
// tensor-core bound; an implicit GEMM on wgmma is the next step.
//
// Design. One launch per BasicBlock; the wrapper runs the chain's launches
// back to back, through an f32 scratch map between blocks. A block (CTA)
// owns one image and one tile of TH x TW output pixels:
//  1. stage x rows [r0-2, r0+TH+2) x cols [c0-2, c0+TW+2) x all channels in
//     shared memory as f32, zeros outside the image;
//  2. y1 = relu(conv1(x) * s1 + b1) on rows [r0-1, r0+TH+1) x cols
//     [c0-1, c0+TW+1) into shared memory; entries outside the image are 0
//     (conv2's zero padding), not relu(b1);
//  3. out = relu(x + conv2(y1) * s2 + b2) on the tile, the residual read from
//     the staged x.
// So each block reads the map once and writes it once; the halo rows of y1
// are computed twice, by neighbouring tiles.
// Channels are padded to Cp (a multiple of 4) in shared memory, and the
// wrapper pads weights, scales and biases with zeros to Cp, so the inner
// loop reads 4 input channels at once (float4) and the pad channels of y1
// come out 0. Inner loop: each warp takes TP pixels and its 32 lanes take
// output channels co0 + lane + 32 t (t < TC); per 4 input channels a thread
// reads TP float4 from shared memory (one address per warp: a broadcast)
// and 4 * TC weights from device memory (a warp reads 128 contiguous bytes;
// a block's weights stay in L1/L2), for 4 * TP * TC FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One 3x3 conv over a shared-memory tile: output pixel (i, j) of the OH x OW
// grid reads source pixels (i + dy, j + dx) of a tile SW pixels wide, with
// channel stride Cp. w: [9][Cp][Cp] (tap, ci, co). Calls epi(i, j, co, acc)
// for every output pixel and every co < Cp.
template <int TC, int TP, typename Epi>
__device__ __forceinline__ void conv3x3_tile(const float* __restrict__ src,
                                             int SW, int OH, int OW, int Cp,
                                             const float* __restrict__ w,
                                             Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int npix = OH * OW;
  for (int co0 = 0; co0 < Cp; co0 += 32 * TC) {
    for (int pg = warp * TP; pg < npix; pg += kWarps * TP) {
      int base[TP];
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        const int p = min(pg + i, npix - 1);
        const int pi = p / OW;
        base[i] = (pi * SW + (p - pi * OW)) * Cp;
      }
      float acc[TP][TC];
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int t = 0; t < TC; ++t) acc[i][t] = 0.f;
      for (int dy = 0; dy < 3; ++dy) {
        for (int dx = 0; dx < 3; ++dx) {
          const int toff = (dy * SW + dx) * Cp;
          const float* wt = w + (size_t)(dy * 3 + dx) * Cp * Cp;
          for (int ci = 0; ci < Cp; ci += 4) {
            float wv[4][TC];
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int t = 0; t < TC; ++t) {
                const int co = co0 + lane + 32 * t;
                wv[k][t] = co < Cp ? __ldg(wt + (size_t)(ci + k) * Cp + co)
                                   : 0.f;
              }
#pragma unroll
            for (int i = 0; i < TP; ++i) {
              const float4 v =
                  *reinterpret_cast<const float4*>(src + base[i] + toff + ci);
#pragma unroll
              for (int t = 0; t < TC; ++t) {
                float a = acc[i][t];
                a = fmaf(v.x, wv[0][t], a);
                a = fmaf(v.y, wv[1][t], a);
                a = fmaf(v.z, wv[2][t], a);
                a = fmaf(v.w, wv[3][t], a);
                acc[i][t] = a;
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        const int p = pg + i;
        if (p >= npix) break;
        const int pi = p / OW;
        const int pj = p - pi * OW;
#pragma unroll
        for (int t = 0; t < TC; ++t) {
          const int co = co0 + lane + 32 * t;
          if (co < Cp) epi(pi, pj, co, acc[i][t]);
        }
      }
    }
  }
}

// One BasicBlock on one (image, tile). x, out: [N, H, W, C]; w1, w2:
// [9][Cp][Cp]; s1, b1, s2, b2: [Cp]. Grid (tiles_h * tiles_w, N).
template <typename TIn, typename TOut, int TC, int TP>
__global__ void __launch_bounds__(kThreads)
basicblock_kernel(const TIn* __restrict__ x, TOut* __restrict__ out,
                  const float* __restrict__ w1, const float* __restrict__ w2,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  const float* __restrict__ s2, const float* __restrict__ b2,
                  int H, int W, int C, int Cp, int TH, int TW, int tiles_w) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int XW = TW + 4, YW = TW + 2;
  float* ys = xs + (size_t)(TH + 4) * XW * Cp;
  const int n = blockIdx.y;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (size_t)n * H * W * C;

  // 1. x tile, f32, zeros outside the image and in the pad channels
  const int xpix = (TH + 4) * XW;
  for (int e = threadIdx.x; e < xpix * Cp; e += kThreads) {
    const int p = e / Cp;
    const int ci = e - p * Cp;
    const int pr = p / XW;
    const int r = r0 - 2 + pr;
    const int c = c0 - 2 + (p - pr * XW);
    float v = 0.f;
    if (ci < C && r >= 0 && r < H && c >= 0 && c < W)
      v = to_float(x[img + ((size_t)r * W + c) * C + ci]);
    xs[e] = v;
  }
  __syncthreads();

  // 2. y1 on the tile plus a one-pixel halo
  conv3x3_tile<TC, TP>(
      xs, XW, TH + 2, TW + 2, Cp, w1, [&](int i, int j, int co, float acc) {
        const int r = r0 - 1 + i;
        const int c = c0 - 1 + j;
        float v = 0.f;
        if (r >= 0 && r < H && c >= 0 && c < W)
          v = fmaxf(fmaf(acc, s1[co], b1[co]), 0.f);
        ys[(i * YW + j) * Cp + co] = v;
      });
  __syncthreads();

  // 3. out = relu(x + conv2(y1) * s2 + b2)
  conv3x3_tile<TC, TP>(
      ys, YW, TH, TW, Cp, w2, [&](int i, int j, int co, float acc) {
        const int r = r0 + i;
        const int c = c0 + j;
        if (co < C && r < H && c < W) {
          const float res = xs[((i + 2) * XW + (j + 2)) * Cp + co];
          store(out + img + ((size_t)r * W + c) * C + co,
                fmaxf(res + fmaf(acc, s2[co], b2[co]), 0.f));
        }
      });
}

template <typename TIn, typename TOut, int TC>
cudaError_t launch_block(const void* x, void* out, const float* w,
                         const float* s, const float* b, int N, int H, int W,
                         int C, int Cp, int TH, int TW, int blk,
                         cudaStream_t stream) {
  constexpr int TP = TC >= 4 ? 4 : 8;
  auto kernel = basicblock_kernel<TIn, TOut, TC, TP>;
  const size_t smem =
      ((size_t)(TH + 4) * (TW + 4) + (size_t)(TH + 2) * (TW + 2)) * Cp *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  const size_t wsz = (size_t)9 * Cp * Cp;
  kernel<<<dim3(tiles, N), kThreads, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<TOut*>(out),
      w + (2 * blk) * wsz, w + (2 * blk + 1) * wsz, s + (2 * blk) * Cp,
      b + (2 * blk) * Cp, s + (2 * blk + 1) * Cp, b + (2 * blk + 1) * Cp, H,
      W, C, Cp, TH, TW, tiles_w);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch_tc(const void* x, void* out, const float* w,
                      const float* s, const float* b, int N, int H, int W,
                      int C, int Cp, int TH, int TW, int blk, int TC,
                      cudaStream_t st) {
  switch (TC) {
    case 1:
      return launch_block<TIn, TOut, 1>(x, out, w, s, b, N, H, W, C, Cp, TH,
                                        TW, blk, st);
    case 2:
      return launch_block<TIn, TOut, 2>(x, out, w, s, b, N, H, W, C, Cp, TH,
                                        TW, blk, st);
    case 4:
      return launch_block<TIn, TOut, 4>(x, out, w, s, b, N, H, W, C, Cp, TH,
                                        TW, blk, st);
    case 8:
      return launch_block<TIn, TOut, 8>(x, out, w, s, b, N, H, W, C, Cp, TH,
                                        TW, blk, st);
  }
  return cudaErrorInvalidValue;
}

// one block: input and output types by dtype code (0 f32, 1 bf16)
cudaError_t launch_any(const void* x, int x_dtype, void* out, int out_dtype,
                       const float* w, const float* s, const float* b, int N,
                       int H, int W, int C, int Cp, int TH, int TW, int blk,
                       int TC, cudaStream_t st) {
  if (x_dtype == 0 && out_dtype == 0)
    return launch_tc<float, float>(x, out, w, s, b, N, H, W, C, Cp, TH, TW,
                                   blk, TC, st);
  if (x_dtype == 1 && out_dtype == 0)
    return launch_tc<__nv_bfloat16, float>(x, out, w, s, b, N, H, W, C, Cp,
                                           TH, TW, blk, TC, st);
  if (x_dtype == 0 && out_dtype == 1)
    return launch_tc<float, __nv_bfloat16>(x, out, w, s, b, N, H, W, C, Cp,
                                           TH, TW, blk, TC, st);
  if (x_dtype == 1 && out_dtype == 1)
    return launch_tc<__nv_bfloat16, __nv_bfloat16>(x, out, w, s, b, N, H, W,
                                                   C, Cp, TH, TW, blk, TC, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, out: [N, H, W, C] of dtype code x_dtype (0 float32, 1 bfloat16);
// buf0, buf1: f32 [N, H, W, C] scratch (buf0 when n_blocks > 1, buf1 when
// n_blocks > 2); w: f32 [2 * n_blocks, 9, Cp, Cp]; s, b: f32
// [2 * n_blocks, Cp], zero-padded from C to Cp. TC: output channels per
// lane per pass (1, 2, 4 or 8). Launches n_blocks kernels on `stream`;
// returns a cudaError_t code.
int bpbreid_conv_chain(const void* x, void* out, void* buf0, void* buf1,
                       const float* w, const float* s, const float* b, int N,
                       int H, int W, int C, int Cp, int n_blocks, int TH,
                       int TW, int TC, int x_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || C <= 0 || Cp < C ||
      Cp % 4 != 0 || n_blocks <= 0 || TH <= 0 || TW <= 0 ||
      (x_dtype != 0 && x_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* src = x;
  int src_dtype = x_dtype;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const bool last = blk == n_blocks - 1;
    void* dst = last ? out : (blk % 2 == 0 ? buf0 : buf1);
    const int dst_dtype = last ? x_dtype : 0;
    cudaError_t err = launch_any(src, src_dtype, dst, dst_dtype, w, s, b, N,
                                 H, W, C, Cp, TH, TW, blk, TC, st);
    if (err != cudaSuccess) return (int)err;
    src = dst;
    src_dtype = dst_dtype;
  }
  return 0;
}

const char* bpbreid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
