// int8 convolution and the static activation quantize, for Hopper (sm_90a).
//
// No TPU kernel of the repository does this work: on the TPU, XLA compiled
// it. conv_s8 stands for bpbreid_tpu/ops/quant.py quant_conv :327 (an s8 x
// s8 -> s32 lax.conv_general_dilated, then `float(acc) * sw` cast to the
// output type) with the bias add of PConv (bpbreid_tpu/models/common.py
// :110-111); quantize_s8 for quantize_static :288 (round(x / sx) clipped to
// +-127). PyTorch has no int8 convolution on CUDA, so both are written here.
//
// conv_s8. An implicit GEMM: out[m, co] = sum_k A[m, k] * B[k, co], m over
// the N*Ho*Wo output pixels, k = tap * Cp + ci with the taps in (r, s)
// order, A[m, k] = x[n, ho*stride - pad + r, wo*stride - pad + s, ci] (0
// outside the image), B[k, co] the s8 weights repacked by the wrapper to
// [Co][KH * KW * Cp] (K-major). x is the NHWC s8 copy with Cp channels (a
// multiple of 32, the pad channels 0). A CTA owns BM pixels x BN output
// channels; its warps own 32 x 32 each. Over the k-chunks (one tap x KC
// input channels) a ring of kStages shared-memory stages is filled by
// 16-byte cp.async, the zero-fill form (src-size 0) giving the padding and
// the ragged tile edges without branches per element; ldmatrix feeds
// mma.sync.aligned.m16n8k32 s8 x s8 -> s32 (the b16 ldmatrix layout of a
// 16 x 16 bf16 tile is the s8 layout of a 16 x 32 tile, so the addressing is
// K1's in bytes). Rows of a stage are KC + 16 bytes apart, so ldmatrix's 8
// row addresses fall in 8 different 16-byte bank groups.
// Epilogue, in quant_conv's order: y = out_type(float(acc) * sw[co]), then
// y + out_type(bias[co]) in the output type; each value goes through a
// [BN][BM + 4] f32 tile in shared memory so that the stores run along the
// pixels of one output channel: the output is NCHW, as the BN kernels read
// it. The sums are exact int32: |acc| <= 127^2 * KH * KW * Cp, under 3e8 for
// every conv of the repository's models.
// Bound, at the hot HRNet branch conv [64, 32, 96, 32] 3x3 32 -> 32 with a
// bf16 output: 3.6 GOP (1.8 us at the card's 1,979 dense int8 TOP/s) against
// 6.3 MB read and 12.6 MB written (5.6 us at 3.35 TB/s): bytes. This first
// version reads A once per tap (9 times for a 3x3 conv) through L2; staging
// a halo tile once per CTA, wgmma and TMA are later steps.
//
// quantize_s8. q[n, h, w, c] = clip(rint(x[n, c, h, w] / s), -127, 127) for
// c < C, 0 for C <= c < Cp, with s the per-tensor scale or s[c] (the wrapper
// floors it at 1e-8). The division is a true IEEE division (__fdiv_rn: no
// reciprocal, no fast math) and the rounding half to even (__float2int_rn),
// as jnp.round and torch.round. An NCHW input goes through a 32-channel x
// 64-pixel shared-memory tile, so the loads run along the pixels and the
// stores along the channels; a channels-last input (NHWC in memory) is read
// and written along the channels. Bound: bytes (read x once, write q once).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;        // shared-memory ring over the k-chunks

struct ConvS8Args {
  const int8_t* x;    // [N, H, W, Cp]
  const int8_t* w;    // [Co][KH * KW * Cp]
  const float* sw;    // [Co]
  const float* bias;  // [Co] or null
  void* y;            // [N, Co, Ho, Wo], f32 or bf16
  int N, H, W, Cp, Co, Ho, Wo, KH, KW, stride, pad, M, out_bf16;
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

// d += a (16 x 32, row) * b (32 x 8, col), s8 operands, s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN>
__host__ __device__ constexpr int conv_threads() {
  return (BM / 32) * (BN / 32) * 32;
}

template <int BM, int BN, int KC>
__host__ __device__ constexpr size_t conv_smem_bytes() {
  // the ring, then (reused) the epilogue's f32 tile
  return (size_t)kStages * (BM + BN) * (KC + 16) >
                 (size_t)BN * (BM + 4) * sizeof(float)
             ? (size_t)kStages * (BM + BN) * (KC + 16)
             : (size_t)BN * (BM + 4) * sizeof(float);
}

// Grid (ceil(M / BM), ceil(Co / BN)); (BM / 32) x (BN / 32) warps.
template <int BM, int BN, int KC>
__global__ void __launch_bounds__((BM / 32) * (BN / 32) * 32)
conv_s8_kernel(const ConvS8Args p) {
  constexpr int kT = conv_threads<BM, BN>();
  constexpr int WN = BN / 32;          // warps along the output channels
  constexpr int LDS = KC + 16;         // row stride of a stage, in bytes
  constexpr int CPR = KC / 16;         // 16-byte chunks per row
  constexpr int A_CHUNKS = BM * CPR, B_CHUNKS = BN * CPR;
  constexpr int A_ITERS = (A_CHUNKS + kT - 1) / kT;
  constexpr int B_ITERS = (B_CHUNKS + kT - 1) / kT;
  constexpr int LDT = BM + 4;          // row stride of the epilogue tile
  extern __shared__ uint4 smem_s8[];
  int8_t* As = reinterpret_cast<int8_t*>(smem_s8);
  int8_t* Bs = As + kStages * BM * LDS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int HoWo = p.Ho * p.Wo;
  const int kc_per_tap = p.Cp / KC;
  const int KT = p.KH * p.KW * kc_per_tap;
  const size_t K = (size_t)p.KH * p.KW * p.Cp;

  // per A chunk of this thread: the image's first pixel (-1: none) and the
  // input row and column of tap (0, 0)
  int a_img[A_ITERS], a_h[A_ITERS], a_w[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int idx = tid + i * kT;
    const int pix = m0 + idx / CPR;
    const bool ok = idx < A_CHUNKS && pix < p.M;
    const int n = ok ? pix / HoWo : 0;
    const int rem = ok ? pix - n * HoWo : 0;
    const int ho = rem / p.Wo;
    a_img[i] = ok ? n * p.H * p.W : -1;
    a_h[i] = ho * p.stride - p.pad;
    a_w[i] = (rem - ho * p.Wo) * p.stride - p.pad;
  }

  auto load_stage = [&](int stage, int kt) {
    const int tap = kt / kc_per_tap;
    const int ci0 = (kt - tap * kc_per_tap) * KC;
    const int r = tap / p.KW, s = tap - (tap / p.KW) * p.KW;
    int8_t* as = As + stage * BM * LDS;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int idx = tid + i * kT;
      if (idx < A_CHUNKS) {
        const int row = idx / CPR, c = idx - row * CPR;
        const int h = a_h[i] + r, w = a_w[i] + s;
        const bool ok =
            a_img[i] >= 0 && h >= 0 && h < p.H && w >= 0 && w < p.W;
        const int8_t* src =
            ok ? p.x + (size_t)(a_img[i] + h * p.W + w) * p.Cp + ci0 + c * 16
               : p.x;
        cp_async16(smem_addr(as + row * LDS + c * 16), src, ok);
      }
    }
    int8_t* bs = Bs + stage * BN * LDS;
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int idx = tid + i * kT;
      if (idx < B_CHUNKS) {
        const int row = idx / CPR, c = idx - row * CPR;
        const int co = n0 + row;
        const bool ok = co < p.Co;
        const int8_t* src =
            ok ? p.w + (size_t)co * K + (size_t)kt * KC + c * 16 : p.w;
        cp_async16(smem_addr(bs + row * LDS + c * 16), src, ok);
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_stage(st, st);
    cp_async_commit();
  }
  // ldmatrix row and byte column of this lane within a 16 x 32-byte
  // fragment: for A the four 8 x 16-byte matrices are (rows 0-7, 8-15) x
  // (bytes 0-15, 16-31) in the order a0..a3; for B (rows = output channels)
  // they are (bytes 0-15, 16-31) of channels 0-7, then of channels 8-15
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 16;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // refill the stage that every warp finished with in step kt - 1
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    cp_async_commit();
    const int stage = kt % kStages;
    const int8_t* as = As + (stage * BM + wm * 32) * LDS;
    const int8_t* bs = Bs + (stage * BN + wn * 32) * LDS;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      unsigned af[2][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi],
                    smem_addr(as + (mi * 16 + a_row) * LDS + ks * 32 + a_k));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(bfr[nj],
                    smem_addr(bs + (nj * 16 + b_row) * LDS + ks * 32 + b_k));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2],
                 bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();       // every warp is done with the ring: reuse it

  // epilogue: thread (g, t4) holds rows g and g + 8 of each 16-row tile and
  // channels 2 t4, 2 t4 + 1 of each 8-channel tile
  float* tile = reinterpret_cast<float*>(smem_s8);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = wn * 32 + ni * 8 + t4 * 2 + e;
      const int co = n0 + cl;
      const float s = co < p.Co ? __ldg(p.sw + co) : 0.f;
      const float b = (co < p.Co && p.bias != nullptr) ? __ldg(p.bias + co)
                                                       : 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ml = wm * 32 + mi * 16 + g + half * 8;
          float v = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + e]), s);
          if (p.out_bf16) {
            v = __bfloat162float(__float2bfloat16_rn(v));
            if (p.bias != nullptr)
              v = __bfloat162float(__float2bfloat16_rn(
                  __fadd_rn(v, __bfloat162float(__float2bfloat16_rn(b)))));
          } else if (p.bias != nullptr) {
            v = __fadd_rn(v, b);
          }
          tile[cl * LDT + ml] = v;
        }
      }
    }
  }
  __syncthreads();
  // stores along the pixels of one output channel
  for (int idx = tid; idx < BN * BM; idx += kT) {
    const int cl = idx / BM, ml = idx - cl * BM;
    const int m = m0 + ml, co = n0 + cl;
    if (m >= p.M || co >= p.Co) continue;
    const int n = m / HoWo, pix = m - n * HoWo;
    const size_t o = ((size_t)n * p.Co + co) * HoWo + pix;
    const float v = tile[cl * LDT + ml];
    if (p.out_bf16)
      static_cast<__nv_bfloat16*>(p.y)[o] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(p.y)[o] = v;
  }
}

template <int BM, int BN, int KC>
cudaError_t launch_conv(const ConvS8Args& a, cudaStream_t st) {
  auto kernel = conv_s8_kernel<BM, BN, KC>;
  constexpr size_t smem = conv_smem_bytes<BM, BN, KC>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + BM - 1) / BM, (a.Co + BN - 1) / BN);
  kernel<<<grid, conv_threads<BM, BN>(), smem, st>>>(a);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_conv_kc(const ConvS8Args& a, int KC, cudaStream_t st) {
  switch (KC) {
    case 32:
      return launch_conv<BM, BN, 32>(a, st);
    case 64:
      return launch_conv<BM, BN, 64>(a, st);
  }
  return cudaErrorInvalidValue;
}

// ---- quantize ----

__device__ __forceinline__ float load_f(const float* x, size_t i) {
  return x[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

__device__ __forceinline__ int8_t quant1(float v, float s) {
  int q = __float2int_rn(__fdiv_rn(v, s));
  q = q < -127 ? -127 : (q > 127 ? 127 : q);
  return static_cast<int8_t>(q);
}

constexpr int kQT = 256;            // threads of a quantize CTA
constexpr int kQP = 64;             // pixels of an NCHW tile
constexpr int kQC = 32;             // channels of an NCHW tile

// NCHW input. Grid (ceil(HW / kQP), Cp / kQC, N).
template <typename T>
__global__ void __launch_bounds__(kQT)
quantize_nchw_kernel(const T* x, const float* scale, int per_channel,
                     int8_t* q, int C, int HW, int Cp) {
  __shared__ float tile[kQC][kQP + 1];
  const int p0 = blockIdx.x * kQP, c0 = blockIdx.y * kQC, n = blockIdx.z;
  for (int i = threadIdx.x; i < kQC * kQP; i += kQT) {
    const int cl = i / kQP, pl = i - cl * kQP;
    const int c = c0 + cl, pix = p0 + pl;
    tile[cl][pl] = (c < C && pix < HW)
                       ? load_f(x, ((size_t)n * C + c) * HW + pix)
                       : 0.f;
  }
  __syncthreads();
  // a thread writes 4 channels of one pixel
  for (int i = threadIdx.x; i < kQP * (kQC / 4); i += kQT) {
    const int pl = i / (kQC / 4), cq = (i - pl * (kQC / 4)) * 4;
    const int pix = p0 + pl;
    if (pix >= HW) continue;
    char4 o;
    int8_t* ob = reinterpret_cast<int8_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + cq + e;
      ob[e] = c < C ? quant1(tile[cq + e][pl],
                             per_channel ? __ldg(scale + c) : __ldg(scale))
                    : (int8_t)0;
    }
    *reinterpret_cast<char4*>(q + ((size_t)n * HW + pix) * Cp + c0 + cq) = o;
  }
}

// channels-last input (NHWC in memory). A thread writes 4 channels of one
// pixel; grid-stride over the NHW * Cp / 4 quads.
template <typename T>
__global__ void __launch_bounds__(kQT)
quantize_nhwc_kernel(const T* x, const float* scale, int per_channel,
                     int8_t* q, int C, long long pixels, int Cp) {
  const long long quads = pixels * (Cp / 4);
  for (long long i = blockIdx.x * (long long)kQT + threadIdx.x; i < quads;
       i += (long long)gridDim.x * kQT) {
    const long long pix = i / (Cp / 4);
    const int cq = (int)(i - pix * (Cp / 4)) * 4;
    char4 o;
    int8_t* ob = reinterpret_cast<int8_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = cq + e;
      ob[e] = c < C ? quant1(load_f(x, (size_t)pix * C + c),
                             per_channel ? __ldg(scale + c) : __ldg(scale))
                    : (int8_t)0;
    }
    *reinterpret_cast<char4*>(q + (size_t)pix * Cp + cq) = o;
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, const float* scale,
                            int per_channel, int8_t* q, int N, int C, int HW,
                            int Cp, int channels_last, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (channels_last) {
    const long long quads = (long long)N * HW * (Cp / 4);
    long long blocks = (quads + kQT - 1) / kQT;
    if (blocks > 132 * 32) blocks = 132 * 32;
    quantize_nhwc_kernel<T><<<(unsigned)blocks, kQT, 0, st>>>(
        xt, scale, per_channel, q, C, (long long)N * HW, Cp);
  } else {
    const dim3 grid((HW + kQP - 1) / kQP, Cp / kQC, N);
    quantize_nchw_kernel<T><<<grid, kQT, 0, st>>>(xt, scale, per_channel, q,
                                                  C, HW, Cp);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: s8 [N, H, W, Cp]; w: s8 [Co][KH * KW * Cp]; sw: f32 [Co]; bias: f32
// [Co] or null; y: [N, Co, Ho, Wo], bf16 (out_bf16 = 1) or f32. Cp a
// multiple of KC, KC 32 or 64; BM 64 or 128, BN 32 or 64 (the wrapper's
// plan_conv_tiles). Returns a cudaError_t code.
int bpbreid_conv_s8(const void* x, const void* w, const float* sw,
                    const float* bias, void* y, int N, int H, int W, int Cp,
                    int Co, int Ho, int Wo, int KH, int KW, int stride,
                    int pad, int out_bf16, int BM, int BN, int KC,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo;
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0 || Ho <= 0 || Wo <= 0 ||
      KH <= 0 || KW <= 0 || stride <= 0 || pad < 0 || KC <= 0 ||
      Cp % KC != 0 || M >= (1LL << 31) ||
      (long long)N * H * W >= (1LL << 31) || Co > 65535 * 64)
    return (int)cudaErrorInvalidValue;
  ConvS8Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.sw = sw;
  a.bias = bias;
  a.y = y;
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cp = Cp;
  a.Co = Co;
  a.Ho = Ho;
  a.Wo = Wo;
  a.KH = KH;
  a.KW = KW;
  a.stride = stride;
  a.pad = pad;
  a.M = (int)M;
  a.out_bf16 = out_bf16;
  if (BM == 128 && BN == 64) return (int)launch_conv_kc<128, 64>(a, KC, st);
  if (BM == 64 && BN == 64) return (int)launch_conv_kc<64, 64>(a, KC, st);
  if (BM == 128 && BN == 32) return (int)launch_conv_kc<128, 32>(a, KC, st);
  if (BM == 64 && BN == 32) return (int)launch_conv_kc<64, 32>(a, KC, st);
  return (int)cudaErrorInvalidValue;
}

// x: [N, C, H, W] (channels_last = 0) or [N, H, W, C] (1) in memory, f32
// (dtype 0) or bf16 (1); scale: f32 [C] (per_channel = 1) or [1], floored
// by the caller; q: s8 [N, H, W, Cp], Cp a multiple of 32. Returns a
// cudaError_t code.
int bpbreid_quantize_s8(const void* x, const float* scale, int per_channel,
                        void* q, int N, int C, int HW, int Cp, int dtype,
                        int channels_last, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || N > 65535 || C <= 0 || HW <= 0 || Cp < C || Cp % 32 != 0)
    return (int)cudaErrorInvalidValue;
  int8_t* qt = static_cast<int8_t*>(q);
  if (dtype == 0)
    return (int)launch_quantize<float>(x, scale, per_channel, qt, N, C, HW,
                                       Cp, channels_last, st);
  if (dtype == 1)
    return (int)launch_quantize<__nv_bfloat16>(x, scale, per_channel, qt, N,
                                               C, HW, Cp, channels_last, st);
  return (int)cudaErrorInvalidValue;
}

const char* bpbreid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
