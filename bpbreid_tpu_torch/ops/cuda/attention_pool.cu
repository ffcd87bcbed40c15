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
// Bound: the feature map is read once (64 x 1920 x 3072 at the main
// path); ~2*K1 flops per feature element is far below the card's
// flop/byte balance, so the kernel is bound by device-memory bytes.
//
// Design: grid (D tile, sample). A block of kThreads threads owns
// kDTile = kThreads channels of one sample, one channel per thread, and
// walks the pixels in chunks of kPChunk. Per chunk it
//   1. computes the f32 softmax of kPChunk pixels (one thread per pixel)
//      into shared memory, zero-padded to KT parts;
//   2. stages the [kDTile, kPChunk] feature tile in shared memory as f32
//      (coalesced 16-byte loads, issued one chunk ahead into registers so
//      they overlap the reduction of the current chunk; rows padded to
//      kPChunk + 4 floats so the per-thread float4 row reads are
//      conflict-free);
//   3. each thread accumulates num[k, its channel] for all KT parts in
//      registers; the probs reads are warp-wide broadcasts.
// Nothing is reduced across threads, so num needs no atomics; den and
// vismax are accumulated by the first D tile only (one thread per part).
// Chunking keeps any P correct; zero padding keeps ragged P and D
// correct; KT (8/16/32/64 registers per thread) covers K1 <= 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDTile = kThreads;
constexpr int kPChunk = 64;
constexpr int kRow = kPChunk + 4;   // 16-byte rows; float4 reads conflict-free

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

// VEC: P is a multiple of 16 / sizeof(TF), so every feature row starts on
// a 16-byte boundary and the tile is fetched as 16-byte vectors, one chunk
// ahead into registers (the loads of chunk i+1 are in flight while chunk i
// is reduced). Otherwise the tile is staged with scalar loads.
template <typename TF, typename TL, int KT, bool VEC>
__global__ void __launch_bounds__(kThreads)
attention_pool_kernel(const TF* __restrict__ feats,
                      const TL* __restrict__ logits,
                      float* __restrict__ num, float* __restrict__ den,
                      float* __restrict__ vismax, int D, int P, int K1) {
  constexpr int kElems = 16 / sizeof(TF);
  constexpr int kVecPerRow = kPChunk / kElems;
  constexpr int kLoads = kDTile * kVecPerRow / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                      // [kDTile][kRow]
  float* probs = smem + kDTile * kRow;     // [kPChunk][KT]

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kDTile;
  const int n = blockIdx.y;
  const bool first_tile = blockIdx.x == 0;
  const TF* f_n = feats + (size_t)n * D * P;
  const TL* l_n = logits + (size_t)n * K1 * P;

  float acc[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.f;
  float den_acc = 0.f, max_acc = 0.f;

  uint4 buf[kLoads];
  auto load_chunk = [&](int p0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kVecPerRow;
      const int c = (i - r * kVecPerRow) * kElems;
      if (d0 + r < D && p0 + c < P)
        buf[j] = __ldg(reinterpret_cast<const uint4*>(
            f_n + (size_t)(d0 + r) * P + p0 + c));
      else
        buf[j] = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if constexpr (VEC) load_chunk(0);

  for (int p0 = 0; p0 < P; p0 += kPChunk) {
    const int pc = min(kPChunk, P - p0);

    // 1. softmax over the K1 part logits of each pixel of the chunk
    if (tid < kPChunk) {
      float* pr = probs + tid * KT;
      if (tid < pc) {
        const TL* lp = l_n + p0 + tid;
        float m = -INFINITY;
        for (int k = 0; k < K1; ++k) m = fmaxf(m, to_float(lp[(size_t)k * P]));
        float s = 0.f;
        for (int k = 0; k < K1; ++k) {
          const float e = expf(to_float(lp[(size_t)k * P]) - m);
          pr[k] = e;
          s += e;
        }
        for (int k = 0; k < K1; ++k) pr[k] = pr[k] / s;
        for (int k = K1; k < KT; ++k) pr[k] = 0.f;
      } else {
        for (int k = 0; k < KT; ++k) pr[k] = 0.f;
      }
    }

    // 2. the feature tile as f32, zero outside [D, P)
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / kVecPerRow;
        const int c = (i - r * kVecPerRow) * kElems;
        float v[kElems];
        unpack(buf[j], v, TF());
#pragma unroll
        for (int e = 0; e < kElems; e += 4)
          *reinterpret_cast<float4*>(tile + r * kRow + c + e) =
              make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      }
    } else {
      for (int i = tid; i < kDTile * kPChunk; i += kThreads) {
        const int r = i / kPChunk;
        const int c = i - r * kPChunk;
        float v = 0.f;
        if (d0 + r < D && c < pc) v = to_float(f_n[(size_t)(d0 + r) * P + p0 + c]);
        tile[r * kRow + c] = v;
      }
    }
    __syncthreads();
    if constexpr (VEC) {
      if (p0 + kPChunk < P) load_chunk(p0 + kPChunk);
    }

    // den / vismax: once per sample, one thread per part
    if (first_tile && tid < K1) {
      for (int p = 0; p < pc; ++p) {
        const float v = probs[p * KT + tid];
        den_acc += v;
        max_acc = fmaxf(max_acc, v);
      }
    }

    // 3. num[k, d] += probs[p, k] * feats[d, p] over the chunk
    const float4* row = reinterpret_cast<const float4*>(tile + tid * kRow);
#pragma unroll 2
    for (int q = 0; q < kPChunk / 4; ++q) {
      const float4 f4 = row[q];
      const float fv[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pr = probs + (4 * q + e) * KT;
#pragma unroll
        for (int k = 0; k < KT; ++k) acc[k] = fmaf(pr[k], fv[e], acc[k]);
      }
    }
    __syncthreads();
  }

  const int d = d0 + tid;
  if (d < D) {
    float* out = num + (size_t)n * K1 * D + d;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (k < K1) out[(size_t)k * D] = acc[k];
  }
  if (first_tile && tid < K1) {
    den[(size_t)n * K1 + tid] = den_acc;
    vismax[(size_t)n * K1 + tid] = max_acc;
  }
}

template <typename TF, typename TL, int KT>
cudaError_t launch(const void* feats, const void* logits, float* num,
                   float* den, float* vismax, int N, int D, int P, int K1,
                   cudaStream_t stream) {
  const bool vec = P % (16 / sizeof(TF)) == 0 &&
                   reinterpret_cast<size_t>(feats) % 16 == 0;
  auto kernel = vec ? attention_pool_kernel<TF, TL, KT, true>
                    : attention_pool_kernel<TF, TL, KT, false>;
  const size_t smem = (size_t)(kDTile * kRow + kPChunk * KT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + kDTile - 1) / kDTile, N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TF*>(feats), static_cast<const TL*>(logits), num, den,
      vismax, D, P, K1);
  return cudaGetLastError();
}

template <typename TF, typename TL>
cudaError_t dispatch_k(const void* feats, const void* logits, float* num,
                       float* den, float* vismax, int N, int D, int P, int K1,
                       cudaStream_t stream) {
  if (K1 <= 8)
    return launch<TF, TL, 8>(feats, logits, num, den, vismax, N, D, P, K1, stream);
  if (K1 <= 16)
    return launch<TF, TL, 16>(feats, logits, num, den, vismax, N, D, P, K1, stream);
  if (K1 <= 32)
    return launch<TF, TL, 32>(feats, logits, num, den, vismax, N, D, P, K1, stream);
  if (K1 <= 64)
    return launch<TF, TL, 64>(feats, logits, num, den, vismax, N, D, P, K1, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
int bpbreid_attention_pool(const void* feats, const void* logits, float* num,
                           float* den, float* vismax, int N, int D, int P,
                           int K1, int feat_dtype, int logit_dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || D <= 0 || P <= 0 || K1 <= 0 || N > 65535)
    return (int)cudaErrorInvalidValue;
  if (feat_dtype == 0 && logit_dtype == 0)
    return (int)dispatch_k<float, float>(feats, logits, num, den, vismax, N, D, P, K1, s);
  if (feat_dtype == 0 && logit_dtype == 1)
    return (int)dispatch_k<float, __nv_bfloat16>(feats, logits, num, den, vismax, N, D, P, K1, s);
  if (feat_dtype == 1 && logit_dtype == 0)
    return (int)dispatch_k<__nv_bfloat16, float>(feats, logits, num, den, vismax, N, D, P, K1, s);
  if (feat_dtype == 1 && logit_dtype == 1)
    return (int)dispatch_k<__nv_bfloat16, __nv_bfloat16>(feats, logits, num, den, vismax, N, D, P, K1, s);
  return (int)cudaErrorInvalidValue;
}

const char* bpbreid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
