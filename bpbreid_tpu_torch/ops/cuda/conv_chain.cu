// Eval BasicBlock chain with BN folded, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bpbreid_tpu/ops/pallas/conv_chain.py
// fused_basicblock_chain :86 (body _chain_kernel :73, im2col conv
// _conv3x3_vmem :57). Per block i of the chain, on an NHWC map:
//   y = relu(conv3x3(x) * s1 + b1)
//   y = conv3x3(y) * s2 + b2
//   x = relu(x + y)
// 3x3 convs with zero padding 1. x stays f32 from block to block and is
// cast to the output type after the last one, as in the TPU kernel (:74,
// :83). Two kernels, one per input type:
//
// bf16 input: an implicit-GEMM 3x3 conv on the tensor cores
// (conv3x3_mma_kernel), launched twice per block. Its operands are bf16
// and its sums f32: per block, a = bf16(x), y1 = bf16(relu(conv(a,
// bf16(w1)) * s1 + b1)), x = relu(x + conv(y1, bf16(w2)) * s2 + b2) with
// x the f32 residual stream, and the output bf16(x) after the last block.
//
// Bound: operations. A chain at HRNet-W32's branch shapes (N=64, 384x128
// input, 4 blocks) is 29.0 GFLOP: 0.029 ms at the card's 989 TFLOP/s of
// dense bf16. The two-launch design moves 365 MB a chain at
// [64, 96, 32, 32] (each launch reads its bf16 operand map and writes its
// output; conv2 also reads the residual and writes the f32 stream and its
// bf16 copy): 0.109 ms at the 3.35 TB/s of device memory, less where the
// 12.6 MB maps stay in the 50 MB L2. So this design is bound by bytes, at
// about 4x the operations bound; keeping y1 and the stream on chip across
// the two convs is a later step.
//
// GEMM view of one conv: out[m, co] = sum_k A[m, k] * B[k, co], m over the
// N*H*W pixels, k = tap * Cp + ci with the taps in (dy, dx) order,
// A[m, k] = a[n, h + dy - 1, w + dx - 1, ci] (0 outside the image). The
// operand maps have Cp channels (a multiple of 16, mma's k; the pad
// channels are 0), the weights are repacked by the wrapper to bf16
// [Co_p][9 * Cp] (K-major, Co_p a multiple of 8, zero-padded). A CTA owns
// BM pixels x BN output channels; its warps own 32 x 32 each. Over the
// k-chunks (one tap x KC input channels) a ring of kStages shared-memory
// stages is filled by 16-byte cp.async, the zero-fill form (src-size 0)
// giving the image border and the ragged tile edges without branches per
// element; ldmatrix feeds mma.sync.m16n8k16 bf16 with f32 accumulators.
// Rows of a stage are KC + 8 bf16 apart, so ldmatrix's 8 row addresses
// fall in 8 different bank groups. Epilogues: conv1 stores relu(acc * s +
// b) as bf16 y1 (Cp channels, pad 0); conv2 adds the residual (x in bf16
// in the first block, the f32 stream after it), applies the ReLU and
// stores the f32 stream and its bf16 copy (the next block's operand), or,
// after the last block, the bf16 output.
// Why mma.sync and not wgmma: mma.sync needs no shared-memory matrix
// descriptors, swizzle modes, TMA tensor maps or mbarriers, so it is the
// step that is right first; wgmma with TMA-staged tiles is the next one.
//
// f32 input: one launch per BasicBlock (basicblock_kernel), f32 products
// and sums on the CUDA cores; the wrapper runs the chain's launches back
// to back, through an f32 scratch map between blocks. A block (CTA) owns
// one image and one tile of TH x TW output pixels:
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

// One f32 BasicBlock on one (image, tile). x, out: [N, H, W, C]; w1, w2:
// [9][Cp][Cp]; s1, b1, s2, b2: [Cp]. Grid (tiles_h * tiles_w, N).
template <int TC, int TP>
__global__ void __launch_bounds__(kThreads)
basicblock_kernel(const float* __restrict__ x, float* __restrict__ out,
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
      v = x[img + ((size_t)r * W + c) * C + ci];
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
          out[img + ((size_t)r * W + c) * C + co] =
              fmaxf(res + fmaf(acc, s2[co], b2[co]), 0.f);
        }
      });
}

template <int TC>
cudaError_t launch_block(const float* x, float* out, const float* w,
                         const float* s, const float* b, int N, int H, int W,
                         int C, int Cp, int TH, int TW, int blk,
                         cudaStream_t stream) {
  constexpr int TP = TC >= 4 ? 4 : 8;
  auto kernel = basicblock_kernel<TC, TP>;
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
      x, out, w + (2 * blk) * wsz, w + (2 * blk + 1) * wsz,
      s + (2 * blk) * Cp, b + (2 * blk) * Cp, s + (2 * blk + 1) * Cp,
      b + (2 * blk + 1) * Cp, H, W, C, Cp, TH, TW, tiles_w);
  return cudaGetLastError();
}

cudaError_t launch_tc(const float* x, float* out, const float* w,
                      const float* s, const float* b, int N, int H, int W,
                      int C, int Cp, int TH, int TW, int blk, int TC,
                      cudaStream_t st) {
  switch (TC) {
    case 1:
      return launch_block<1>(x, out, w, s, b, N, H, W, C, Cp, TH, TW, blk,
                             st);
    case 2:
      return launch_block<2>(x, out, w, s, b, N, H, W, C, Cp, TH, TW, blk,
                             st);
    case 4:
      return launch_block<4>(x, out, w, s, b, N, H, W, C, Cp, TH, TW, blk,
                             st);
    case 8:
      return launch_block<8>(x, out, w, s, b, N, H, W, C, Cp, TH, TW, blk,
                             st);
  }
  return cudaErrorInvalidValue;
}

// ---- bf16: implicit-GEMM 3x3 conv on the tensor cores ----

constexpr int kStages = 3;        // shared-memory ring over the k-chunks

// One conv launch. a: [M, Cp] bf16 operand map; w: [Co_p][9 * Cp] bf16;
// s, b: f32 [Cp]. The epilogue adds the residual when res_bf16 or res_f32
// ([M, C]) is given, then stores to each output that is not null: out_a
// (bf16 [M, Cp], pad channels 0), out_f32 and out_final (f32 and bf16
// [M, C]). res_f32 and out_f32 may be the same map: each element is read
// and then written by one thread.
struct ConvArgs {
  const __nv_bfloat16* a;
  const __nv_bfloat16* w;
  const float* s;
  const float* b;
  const __nv_bfloat16* res_bf16;
  const float* res_f32;
  __nv_bfloat16* out_a;
  float* out_f32;
  __nv_bfloat16* out_final;
  int M, H, W, C, Cp, Cop;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 writes 16 zero bytes and reads
// nothing
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN>
__host__ __device__ constexpr int mma_threads() {
  return (BM / 32) * (BN / 32) * 32;
}

template <int BM, int BN, int KC>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return (size_t)kStages * (BM + BN) * (KC + 8) * sizeof(__nv_bfloat16);
}

// Grid (ceil(M / BM), ceil(Co_p / BN)); (BM / 32) x (BN / 32) warps.
template <int BM, int BN, int KC>
__global__ void __launch_bounds__((BM / 32) * (BN / 32) * 32)
conv3x3_mma_kernel(const ConvArgs p) {
  constexpr int kT = mma_threads<BM, BN>();
  constexpr int WN = BN / 32;          // warps along the output channels
  constexpr int LDS = KC + 8;          // row stride of a stage, in bf16
  constexpr int CPR = KC / 8;          // 16-byte chunks per row
  constexpr int A_CHUNKS = BM * CPR, B_CHUNKS = BN * CPR;
  constexpr int A_ITERS = (A_CHUNKS + kT - 1) / kT;
  constexpr int B_ITERS = (B_CHUNKS + kT - 1) / kT;
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* Bs = As + kStages * BM * LDS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int HW = p.H * p.W;
  const int kc_per_tap = p.Cp / KC;
  const int KT = 9 * kc_per_tap;

  // the pixel (-1: none), row and column of each A chunk this thread copies
  int a_pix[A_ITERS], a_h[A_ITERS], a_w[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int idx = tid + i * kT;
    const int pix = m0 + idx / CPR;
    const bool ok = idx < A_CHUNKS && pix < p.M;
    const int rem = ok ? pix % HW : 0;
    a_pix[i] = ok ? pix : -1;
    a_h[i] = rem / p.W;
    a_w[i] = rem - (rem / p.W) * p.W;
  }

  auto load_stage = [&](int stage, int kt) {
    const int tap = kt / kc_per_tap;
    const int ci0 = (kt - tap * kc_per_tap) * KC;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __nv_bfloat16* as = As + stage * BM * LDS;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int idx = tid + i * kT;
      if (idx < A_CHUNKS) {
        const int row = idx / CPR, c = idx - row * CPR;
        const int h = a_h[i] + dy, w = a_w[i] + dx;
        const bool ok =
            a_pix[i] >= 0 && h >= 0 && h < p.H && w >= 0 && w < p.W;
        const __nv_bfloat16* src =
            ok ? p.a + (size_t)(a_pix[i] + dy * p.W + dx) * p.Cp + ci0 + c * 8
               : p.a;
        cp_async16(smem_addr(as + row * LDS + c * 8), src, ok);
      }
    }
    __nv_bfloat16* bs = Bs + stage * BN * LDS;
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int idx = tid + i * kT;
      if (idx < B_CHUNKS) {
        const int row = idx / CPR, c = idx - row * CPR;
        const int co = n0 + row;
        const bool ok = co < p.Cop;
        const __nv_bfloat16* src =
            ok ? p.w + (size_t)co * 9 * p.Cp + tap * p.Cp + ci0 + c * 8 : p.w;
        cp_async16(smem_addr(bs + row * LDS + c * 8), src, ok);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_stage(st, st);
    cp_async_commit();
  }
  // ldmatrix row and column of this lane within a 16 x 16 fragment: for A
  // the four 8 x 8 matrices are (rows 0-7, 8-15) x (k 0-7, 8-15) in the
  // order a0..a3; for B (rows = output channels) they are (k 0-7, 8-15) of
  // channels 0-7, then of channels 8-15
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 8;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // refill the stage that every warp finished with in step kt - 1
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    cp_async_commit();
    const int stage = kt % kStages;
    const __nv_bfloat16* as = As + (stage * BM + wm * 32) * LDS;
    const __nv_bfloat16* bs = Bs + (stage * BN + wn * 32) * LDS;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      unsigned af[2][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi],
                    smem_addr(as + (mi * 16 + a_row) * LDS + ks * 16 + a_k));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(bfr[nj],
                    smem_addr(bs + (nj * 16 + b_row) * LDS + ks * 16 + b_k));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2],
                   bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: thread (g, t4) holds rows g and g + 8 of each 16-row tile and
  // channels 2 t4, 2 t4 + 1 of each 8-channel tile
  const int g = lane >> 2, t4 = lane & 3;
  const bool residual = p.res_bf16 != nullptr || p.res_f32 != nullptr;
  const bool pairs = (p.C & 1) == 0;   // [M, C] maps take 2-channel stores
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int co = n0 + wn * 32 + ni * 8 + t4 * 2;
    const bool in0 = co < p.C, in1 = co + 1 < p.C;
    const float s0 = in0 ? __ldg(p.s + co) : 0.f;
    const float b0 = in0 ? __ldg(p.b + co) : 0.f;
    const float s1 = in1 ? __ldg(p.s + co + 1) : 0.f;
    const float b1 = in1 ? __ldg(p.b + co + 1) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 32 + mi * 16 + g + half * 8;
        if (m >= p.M) continue;
        // acc * s + b rounded twice, as the plain version does
        float v0 = __fadd_rn(__fmul_rn(acc[mi][ni][2 * half], s0), b0);
        float v1 = __fadd_rn(__fmul_rn(acc[mi][ni][2 * half + 1], s1), b1);
        const size_t o = (size_t)m * p.C + co;
        if (residual) {
          if (p.res_f32 != nullptr) {
            if (in0) v0 = p.res_f32[o] + v0;
            if (in1) v1 = p.res_f32[o + 1] + v1;
          } else {
            if (in0) v0 = __bfloat162float(p.res_bf16[o]) + v0;
            if (in1) v1 = __bfloat162float(p.res_bf16[o + 1]) + v1;
          }
        }
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
        if (p.out_a != nullptr && co < p.Cp)
          *reinterpret_cast<__nv_bfloat162*>(p.out_a + (size_t)m * p.Cp +
                                             co) = __floats2bfloat162_rn(v0,
                                                                         v1);
        if (p.out_f32 != nullptr) {
          if (pairs && in1) {
            *reinterpret_cast<float2*>(p.out_f32 + o) = make_float2(v0, v1);
          } else {
            if (in0) p.out_f32[o] = v0;
            if (in1) p.out_f32[o + 1] = v1;
          }
        }
        if (p.out_final != nullptr) {
          if (pairs && in1) {
            *reinterpret_cast<__nv_bfloat162*>(p.out_final + o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (in0) p.out_final[o] = __float2bfloat16_rn(v0);
            if (in1) p.out_final[o + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

template <int BM, int BN, int KC>
cudaError_t launch_mma(const ConvArgs& a, cudaStream_t st) {
  auto kernel = conv3x3_mma_kernel<BM, BN, KC>;
  constexpr size_t smem = mma_smem_bytes<BM, BN, KC>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + BM - 1) / BM, (a.Cop + BN - 1) / BN);
  kernel<<<grid, mma_threads<BM, BN>(), smem, st>>>(a);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_mma_kc(const ConvArgs& a, int KC, cudaStream_t st) {
  switch (KC) {
    case 16:
      return launch_mma<BM, BN, 16>(a, st);
    case 32:
      return launch_mma<BM, BN, 32>(a, st);
    case 64:
      return launch_mma<BM, BN, 64>(a, st);
  }
  return cudaErrorInvalidValue;
}

// the tiles of the wrapper's planner (ops/conv_chain.py plan_mma_tiles)
cudaError_t launch_conv(const ConvArgs& a, int BM, int BN, int KC,
                        cudaStream_t st) {
  if (BM == 128 && BN == 64) return launch_mma_kc<128, 64>(a, KC, st);
  if (BM == 64 && BN == 64) return launch_mma_kc<64, 64>(a, KC, st);
  if (BM == 128 && BN == 32) return launch_mma_kc<128, 32>(a, KC, st);
  if (BM == 64 && BN == 32) return launch_mma_kc<64, 32>(a, KC, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// f32 chain. x, out: f32 [N, H, W, C]; buf0, buf1: f32 [N, H, W, C]
// scratch (buf0 when n_blocks > 1, buf1 when n_blocks > 2); w: f32
// [2 * n_blocks, 9, Cp, Cp]; s, b: f32 [2 * n_blocks, Cp], zero-padded
// from C to Cp. TC: output channels per lane per pass (1, 2, 4 or 8).
// Launches n_blocks kernels on `stream`; returns a cudaError_t code.
int bpbreid_conv_chain(const void* x, void* out, void* buf0, void* buf1,
                       const float* w, const float* s, const float* b, int N,
                       int H, int W, int C, int Cp, int n_blocks, int TH,
                       int TW, int TC, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || C <= 0 || Cp < C ||
      Cp % 4 != 0 || n_blocks <= 0 || TH <= 0 || TW <= 0)
    return (int)cudaErrorInvalidValue;
  const float* src = static_cast<const float*>(x);
  for (int blk = 0; blk < n_blocks; ++blk) {
    float* dst = static_cast<float*>(
        blk == n_blocks - 1 ? out : (blk % 2 == 0 ? buf0 : buf1));
    cudaError_t err = launch_tc(src, dst, w, s, b, N, H, W, C, Cp, TH, TW,
                                blk, TC, st);
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}

// bf16 chain, two launches per block. x, out: bf16 [N, H, W, C]; a0: x
// as the first operand, bf16 [N, H, W, Cp] (x itself when C == Cp, else a
// zero-padded copy); y1: bf16 [N, H, W, Cp] scratch; abuf (bf16 [N, H, W,
// Cp]) and sbuf (f32 [N, H, W, C]): the next block's operand and the
// residual stream, needed when n_blocks > 1. w: bf16 [2 * n_blocks, Co_p,
// 9 * Cp]; s, b: f32 [2 * n_blocks, Cp]. Cp a multiple of 16, Co_p of 8.
// BM, BN, KC: the CTA tile and the k-chunk (plan_mma_tiles). Returns a
// cudaError_t code.
int bpbreid_conv_chain_bf16(const void* a0, const void* x, void* out,
                            void* y1, void* abuf, void* sbuf, const void* w,
                            const float* s, const float* b, int N, int H,
                            int W, int C, int Cp, int Cop, int n_blocks,
                            int BM, int BN, int KC, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * H * W;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cp < C || Cp % 16 != 0 ||
      Cop < C || Cop % 8 != 0 || n_blocks <= 0 || KC <= 0 || Cp % KC != 0 ||
      M * Cp >= (1LL << 31) ||
      (n_blocks > 1 && (abuf == nullptr || sbuf == nullptr)))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const bf16* wq = static_cast<const bf16*>(w);
  const size_t wsz = (size_t)Cop * 9 * Cp;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const bool first = blk == 0, last = blk == n_blocks - 1;
    ConvArgs c1 = {};
    c1.a = static_cast<const bf16*>(first ? a0 : abuf);
    c1.w = wq + (2 * blk) * wsz;
    c1.s = s + (2 * blk) * Cp;
    c1.b = b + (2 * blk) * Cp;
    c1.out_a = static_cast<bf16*>(y1);
    c1.M = (int)M;
    c1.H = H;
    c1.W = W;
    c1.C = C;
    c1.Cp = Cp;
    c1.Cop = Cop;
    ConvArgs c2 = c1;
    c2.a = static_cast<const bf16*>(y1);
    c2.w = wq + (2 * blk + 1) * wsz;
    c2.s = s + (2 * blk + 1) * Cp;
    c2.b = b + (2 * blk + 1) * Cp;
    c2.res_bf16 = first ? static_cast<const bf16*>(x) : nullptr;
    c2.res_f32 = first ? nullptr : static_cast<const float*>(sbuf);
    c2.out_a = last ? nullptr : static_cast<bf16*>(abuf);
    c2.out_f32 = last ? nullptr : static_cast<float*>(sbuf);
    c2.out_final = last ? static_cast<bf16*>(out) : nullptr;
    cudaError_t err = launch_conv(c1, BM, BN, KC, st);
    if (err == cudaSuccess) err = launch_conv(c2, BM, BN, KC, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* bpbreid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
