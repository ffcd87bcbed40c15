// int8 convolution and the static activation quantize, for Hopper (sm_90a).
//
// No TPU kernel of the repository does this work: on the TPU, XLA compiled
// it. conv_s8 stands for bpbreid_tpu/ops/quant.py quant_conv :327 (an s8 x
// s8 -> s32 lax.conv_general_dilated, then `float(acc) * sw` cast to the
// output type) with the bias add of PConv (bpbreid_tpu/models/common.py
// :110-111); quantize_s8 for quantize_static :288 (round(x / sx) clipped to
// +-127). PyTorch has no int8 convolution on CUDA, so both are written here.
//
// conv_s8. An implicit GEMM over spatial tiles: out[m, co] = sum_k A[m, k] *
// B[k, co], k = tap * Cp + ci with the taps in (r, s) order, A[m, k] = x[n,
// ho*stride - pad + r, wo*stride - pad + s, ci] (0 outside the image), B the
// s8 weights packed to [Co][KH * KW * Cp] (K-major). x is the NHWC s8 copy
// with Cp channels (a multiple of 32, the pad channels 0).
// What bounds it on this card: every conv of the serving step but the two
// smallest HRNet branches is bound by bytes (the hot branch conv [64, 32,
// 96, 32] 3x3 32 -> 32, bf16 out: 3.6 GOP, 1.8 us at 1,979 dense int8
// TOP/s, against 6.3 MB read and 12.6 MB written, 5.6 us at 3.35 TB/s).
// The first version (PR 10) ran its M tile linearly over N*Ho*Wo and
// gathered each tap's rows afresh with cp.async, so A crossed L2 9 times
// for a 3x3 conv, stored one 2-byte value at a time, and at Cp = 32 ran
// 9 one-step k-chunks between barriers. This design:
// - Tile. A tile is th x tw output pixels of one image (th * tw = BM, 64
//   or 128 MMA rows: 4 x 32 at Wo = 32, 8 x 16, 16 x 4 at 12 x 4, ...) by
//   BN = 32 or 64 output channels; warps own 32 x 32 each. The planner
//   (ops/cuda/conv_s8.py plan_conv_tiles, plain Python, cached per shape)
//   picks (th, tw, BN, KC, stages, grouped), and conv_layout there lays out
//   the shared memory; the entry point below takes that layout and only
//   checks it. BN = 128 (512-thread CTAs, one an SM by registers) is not
//   built.
// - Persistent CTAs. One wave (as many CTAs as fit, from the occupancy
//   API) walks the tiles of each BN-channel block; a CTA's (tile, channel
//   chunk) items form one pipeline, so the next tiles' halos are in flight
//   while this tile computes and stores.
// - A's halo, staged once a tile by TMA. Per item, one tile load of a 4-D
//   tensor map over the NHWC s8 copy brings the ((th - 1) * stride + k) x
//   ((tw - 1) * stride + k) input pixels of the tile, starting at (wo0 *
//   stride - pad, ho0 * stride - pad) of image n. TMA's zero fill out of
//   bounds is the padding and the ragged tile edges: no branch per
//   element. All k * k taps read the halo in shared memory: a lane's
//   ldmatrix row is its pixel's row in the halo, shifted by the tap and
//   scaled by the stride. A crosses L2 once a tile (plus the halo rims),
//   not once a tap. Cp <= 64 goes in one chunk; where an image row is
//   whole 128-byte units, its box rows are those units ("grouped": the
//   map [N, H, W * Cp / 128, 128], 128 / Cp pixels a row, from the unit
//   that holds the halo's first pixel), but at Cp = 64 in a stride-1 3x3
//   conv, where one pixel's 64 bytes a row measured faster; the two differ
//   by at most a few per cent at the serving step's shapes on an H100
//   (int8_bench.py --box-rows). Cp a multiple of 128 goes in 128-channel
//   chunks over [N, H, W, Cp]; else 64- or 32-channel chunks.
// - Swizzle: as wide as the box row (128 bytes grouped, else KC bytes).
//   At 128: 16-byte chunk c of the row at byte offset o lands at chunk
//   c ^ ((o >> 7) & 7). The 8 row addresses of an ldmatrix phase (8
//   consecutive pixels of the tile) then fall in 8 different 16-byte bank
//   groups where they start on a 128-byte unit, in at most 2-way
//   conflicts elsewhere (a tap's shift, stride 2).
// - B by cp.async, once a CTA where it is one chunk or at most 80 KB, else
//   a chunk a ring stage beside the halo (the stage's mbarrier counts the
//   copies with cp.async.mbarrier.arrive). Rows are padded by 16 bytes,
//   so ldmatrix's 8 rows (output channels) fall in 8 bank groups with no
//   swizzle. A TMA load of B (boxes [BN][k * k][KC], swizzled) is not
//   built.
// - Pipeline. A ring of `stages` (2 or 3) shared-memory stages, each
//   tracked by an mbarrier (expect_tx of the halo's bytes); one
//   __syncthreads an item guards the refill and the epilogue tile.
// - Tensor cores: mma.sync.aligned.m16n8k32 s8 x s8 -> s32 (the b16
//   ldmatrix layout of a 16 x 16 bf16 tile is the s8 layout of a 16 x 32
//   tile); the 3x3 taps unrolled. With 32 x 32 warp tiles an mma reads 256
//   bytes of shared memory, so at 128 bytes a cycle an SM the MMA phase of
//   a 3x3 branch conv costs about as much as its bytes' bound: larger warp
//   tiles and wgmma are the next step.
// - Epilogue, in quant_conv's order: y = out_type(float(acc) * sw[co]),
//   then y + out_type(bias[co]) in the output type. bf16: the values,
//   rounded in registers, go through a [BN][BM + 8] bf16 tile written by
//   stmatrix .trans (a row is one channel's pixels; the odd 16-byte stride
//   puts its 8 rows in 8 bank groups); f32: through a [BN][BM + 4] f32
//   tile. Then out as 16-byte vectors along the pixels of one output
//   channel (8 bf16, or 2 x 4 f32), scalar stores only at a ragged edge:
//   the output is NCHW, as the BN kernels read it. The tile has its own
//   region, so the ring keeps loading. The sums are exact int32: |acc| <=
//   127^2 * KH * KW * Cp, under 3e8 for every conv of the repository's
//   models.
// The host side encodes A's tensor map per call (cuTensorMapEncodeTiled,
// found with cudaGetDriverEntryPoint so the library needs no -lcuda) and
// passes it as a __grid_constant__ kernel parameter.
//
// quantize_s8. q[n, h, w, c] = clip(rint(x[n, c, h, w] / s), -127, 127) for
// c < C, 0 for C <= c < Cp, with s the per-tensor scale or s[c] (the wrapper
// floors it at 1e-8). The division is a true IEEE division (__fdiv_rn: no
// reciprocal, no fast math) and the rounding half to even
// (__float2int_rn), as jnp.round and torch.round. Bound: bytes (read x
// once, write q once). The first version loaded one 2-byte value a thread
// and read the scale per element, in 24,576 small CTAs at [64, 256, 96,
// 32]. Here the per-channel scales are staged in shared memory once a CTA,
// and one wave of CTAs (the occupancy API) walks the tiles. An NCHW input
// goes through 64-channel x 128-pixel tiles (32 x 256 where Cp = 32;
// narrower in pixels where the map is small, so that four CTAs an SM have
// work): 16-byte loads along the pixels (8 bf16 or 2 x 4 f32 of one
// channel), all issued before the division, 4 channels of a pixel packed
// into a word of a padded s8 tile (conflict-free writes), then 16-byte
// stores of 16 channels of a pixel. A channels-last input (NHWC in
// memory) is read 16 channels of a pixel at a time with 16-byte loads and
// written with one 16-byte store. Scalar loads only where a row is ragged
// or misaligned. Zeros skip the division. (An FMA-corrected product with a fallback near ties was
// tried and was not faster than __fdiv_rn.)
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

struct ConvS8Args {
  const int8_t* w;    // [Co][K * K * Cp]
  const float* sw;    // [Co]
  const float* bias;  // [Co] or null
  void* y;            // [N, Co, Ho, Wo], f32 or bf16
  int Cp, Co, Ho, Wo, K, stride, pad, out_bf16;
  int th, tw, tw_log2, tiles_w, tiles_img, n_tiles;  // the tile grid
  int KT, stages;                 // channel chunks, ring stages
  // A's halo in a stage: pixel (hy, hx), chunk byte cb at hy * a_rb +
  // hx * a_pb + cb + a_x0 (before the swizzle a_swz); its TMA box starts
  // at kt * KC along dim 0 (0 where grouped) and at column
  // (wo0 * stride >> a_wshift) + a_w0 along dim 1
  int a_rb, a_pb, a_x0, a_swz, a_wshift, a_w0, grouped;
  int halo_bytes, stage_bytes;    // a ring stage: the halo (+ a B chunk)
  // B, padded rows of b_ld bytes: all chunks once at b_offset
  // (b_resident) or one chunk a stage after the halo
  int b_resident, b_ld, b_tap, b_offset;
  int tile_offset, bar_offset;    // the epilogue tile; the mbarriers
  int tx_bytes;                   // TMA bytes a stage brings
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// waits for the phase after `parity`; a wait that outlasts 2^28 polls
// (seconds) traps, so a fault shows as a launch error and not as a hang
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// 16 bytes global -> shared; src-size 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// the mbarrier's pending count drops by one when this thread's earlier
// cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
      : "memory");
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

// TMA's swizzle of a byte offset from a 1024-aligned region: the 16-byte
// chunk index XOR bits 7.. of the offset
__device__ __forceinline__ unsigned swizzle(unsigned off, unsigned mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

// two values (already bf16 numbers) as the bits of a bf16 pair, the
// first in the low half
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__host__ __device__ constexpr int conv_threads(int bm, int bn) {
  return bm * bn / 32;
}

// B rows [co][tap][kc] of chunk kt (or of all chunks, kc = Cp) into rows
// of p.b_ld bytes at dst, by cp.async, zero past Co
template <int BN, int kT>
__device__ __forceinline__ void load_b(const ConvS8Args& p, unsigned dst,
                                       int n0, int c0, int kc) {
  const int KK = p.K * p.K, per_tap = kc / 16, per_row = KK * per_tap;
  for (int i = threadIdx.x; i < BN * per_row; i += kT) {
    const int co_l = i / per_row, rest = i - co_l * per_row;
    const int tap = rest / per_tap, c = rest - tap * per_tap;
    const bool ok = n0 + co_l < p.Co;
    const int8_t* src =
        ok ? p.w + ((size_t)(n0 + co_l) * KK + tap) * p.Cp + c0 + c * 16
           : p.w;
    cp_async16(dst + co_l * p.b_ld + rest * 16, src, ok);
  }
}

// Grid (CTAs a co block, ceil(Co / BN)); (BM / 32) x (BN / 32) warps. A
// CTA is persistent: it walks the output tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... of its BN output channels, each tile in KT channel
// chunks, the (tile, chunk) items flattened into one pipeline, so the next
// tile's halo loads while this tile computes and stores.
template <int BM, int BN, int KC, int KSIZE>
__global__ void __launch_bounds__(conv_threads(BM, BN),
                                  (768 / conv_threads(BM, BN)) > 0
                                      ? 768 / conv_threads(BM, BN)
                                      : 1)
conv_s8_kernel(const __grid_constant__ CUtensorMap tm_x, const ConvS8Args p) {
  constexpr int kT = conv_threads(BM, BN);
  constexpr int WN = BN / 32;          // warps along the output channels
  constexpr int LDT = BM + 4;          // f32 epilogue tile: row stride
  constexpr int LDH = BM + 8;          // bf16 epilogue tile: row stride
  // the kernel size: 3 unrolled, 0 any (p.K)
  const int K = KSIZE ? KSIZE : p.K;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // regions start on 1024-byte boundaries, where the swizzle pattern does
  const unsigned raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  const unsigned sbase = smem_addr(smem);
  const unsigned bar0 = sbase + p.bar_offset;        // one a ring stage
  float* tile = reinterpret_cast<float*>(smem + p.tile_offset);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp - (warp / WN) * WN;
  const int n0 = blockIdx.y * BN;
  const int J = (p.n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x * p.KT +
                p.KT;                  // this CTA's (tile, chunk) items
  const CUtensorMap* map_x = &tm_x;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s)
      mbar_init(bar0 + 8 * s, p.b_resident ? 1 : 1 + kT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the image and output origin of this CTA's i-th tile
  auto origin = [&](int i, int& img, int& ho0, int& wo0) {
    const int t = (int)blockIdx.x + i * (int)gridDim.x;
    img = t / p.tiles_img;
    const int r = t - img * p.tiles_img, ty = r / p.tiles_w;
    ho0 = ty * p.th;
    wo0 = (r - ty * p.tiles_w) * p.tw;
  };
  // item j's halo (thread 0, TMA) and B chunk (every thread, cp.async,
  // unless B is resident) into its stage
  auto issue = [&](int j) {
    const int i = j / p.KT, kt = j - i * p.KT, s = j % p.stages;
    const unsigned dst = sbase + s * p.stage_bytes, bar = bar0 + 8 * s;
    if (tid == 0) {
      int img, ho0, wo0;
      origin(i, img, ho0, wo0);
      mbar_expect_tx(bar, p.tx_bytes);
      tma_load_4d(dst, map_x, bar, p.grouped ? 0 : kt * KC,
                  (wo0 * p.stride >> p.a_wshift) + p.a_w0,
                  ho0 * p.stride - p.pad,
                  img);
    }
    if (!p.b_resident) {
      load_b<BN, kT>(p, dst + p.halo_bytes, n0, kt * KC, KC);
      cp_async_arrive(bar);
    }
  };
  if (p.b_resident) {
    load_b<BN, kT>(p, sbase + p.b_offset, n0, 0, p.Cp);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int j = 0; j < p.stages - 1 && j < J; ++j) issue(j);
  if (p.b_resident) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }

  // ldmatrix row and byte column of this lane within a 16 x 32-byte
  // fragment: for A the four 8 x 16-byte matrices are (rows 0-7, 8-15) x
  // (bytes 0-15, 16-31) in the order a0..a3; for B (rows = output channels)
  // they are (bytes 0-15, 16-31) of channels 0-7, then of channels 8-15
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 16;
  // the halo byte of this lane's pixel at tap (0, 0), for the 2 m16 tiles,
  // and the B byte of its channel row
  int a_base[2], b_base[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m = wm * 32 + mi * 16 + a_row;
    const int ty = m >> p.tw_log2, tx = m & (p.tw - 1);
    a_base[mi] = (ty * p.a_rb + tx * p.a_pb) * p.stride + p.a_x0 + a_k;
  }
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
    b_base[nj] = (wn * 32 + nj * 16 + b_row) * p.b_ld + b_k;
  const unsigned a_swz = p.a_swz;
  const int g = lane >> 2, t4 = lane & 3;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // item j: stage s, its use `phase`, chunk kt of tile i
  for (int j = 0, s = 0, phase = 0, kt = 0, i = 0; j < J; ++j) {
    // every warp is done with the stage that item j + stages - 1 refills,
    // and with the epilogue tile of the last tile
    __syncthreads();
    if (j + p.stages - 1 < J) issue(j + p.stages - 1);
    mbar_wait(bar0 + 8 * s, phase);
    const unsigned as = sbase + s * p.stage_bytes;
    const unsigned bs = p.b_resident ? sbase + p.b_offset + kt * KC
                                     : as + p.halo_bytes;
#pragma unroll
    for (int r = 0; r < K; ++r) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int a_shift = r * p.a_rb + q * p.a_pb;
        const unsigned bt = bs + (r * K + q) * p.b_tap;
#pragma unroll
        for (int ks = 0; ks < KC / 32; ++ks) {
          unsigned af[2][4], bfr[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldmatrix_x4(af[mi],
                        as + swizzle(a_base[mi] + a_shift + ks * 32, a_swz));
#pragma unroll
          for (int nj = 0; nj < 2; ++nj)
            ldmatrix_x4(bfr[nj], bt + b_base[nj] + ks * 32);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mma_s8(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2],
                     bfr[ni >> 1][(ni & 1) * 2 + 1]);
        }
      }
    }
    if (++s == p.stages) {
      s = 0;
      phase ^= 1;
    }
    if (++kt < p.KT) continue;
    kt = 0;

    // epilogue of tile i: thread (g, t4) holds rows g and g + 8 of each
    // 16-row tile and channels 2 t4, 2 t4 + 1 of each 8-channel tile
    int img, ho0, wo0;
    origin(i++, img, ho0, wo0);
    if (p.out_bf16) {
      // bf16: the rounded values as bf16 pairs (channels 2 t4, 2 t4 + 1
      // of pixel g or g + 8), stored transposed by stmatrix into a
      // [BN][BM + 8] bf16 tile: a row is one channel's pixels, and the 8
      // rows of a matrix fall in 8 bank groups (the stride is an odd
      // number of 16 bytes)
      const unsigned th_base = smem_addr(tile);
#pragma unroll
      for (int ni = 0; ni < 4; ni += 2) {
        float sc[4], bb[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int co = n0 + wn * 32 + (ni + (c >> 1)) * 8 + t4 * 2 + (c & 1);
          sc[c] = co < p.Co ? __ldg(p.sw + co) : 0.f;
          bb[c] = (co < p.Co && p.bias != nullptr)
                      ? __bfloat162float(__float2bfloat16_rn(__ldg(p.bias + co)))
                      : 0.f;
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          unsigned r[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {       // (ni, rows g), (ni, g + 8),
            const int nn = ni + (q >> 1), half = q & 1;   // (ni + 1, ..)
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float sv = sc[(q >> 1) * 2 + e];
              float x = __bfloat162float(__float2bfloat16_rn(__fmul_rn(
                  __int2float_rn(acc[mi][nn][2 * half + e]), sv)));
              if (p.bias != nullptr)
                x = __fadd_rn(x, bb[(q >> 1) * 2 + e]);
              v[e] = x;
              acc[mi][nn][2 * half + e] = 0;
            }
            r[q] = bf16x2(v[0], v[1]);
          }
          // lane l gives the address of row l % 8 (a channel) of matrix
          // l / 8 (pixels 0-7 or 8-15 of the m16 tile, channels of ni or
          // ni + 1)
          const int q = lane >> 3;
          const int cl = wn * 32 + (ni + (q >> 1)) * 8 + (lane & 7);
          const int ml = wm * 32 + mi * 16 + (q & 1) * 8;
          asm volatile(
              "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
              "{%1, %2, %3, %4};\n" ::"r"(th_base + (cl * LDH + ml) * 2),
              "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
              : "memory");
        }
      }
    } else {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = wn * 32 + ni * 8 + t4 * 2 + e;
        const int co = n0 + cl;
        const float sc = co < p.Co ? __ldg(p.sw + co) : 0.f;
        const float b = (co < p.Co && p.bias != nullptr) ? __ldg(p.bias + co)
                                                         : 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ml = wm * 32 + mi * 16 + g + half * 8;
            float v =
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + e]), sc);
            if (p.out_bf16) {
              v = __bfloat162float(__float2bfloat16_rn(v));
              if (p.bias != nullptr)
                v = __bfloat162float(__float2bfloat16_rn(
                    __fadd_rn(v, __bfloat162float(__float2bfloat16_rn(b)))));
            } else if (p.bias != nullptr) {
              v = __fadd_rn(v, b);
            }
            tile[cl * LDT + ml] = v;
            acc[mi][ni][2 * half + e] = 0;
          }
        }
      }
    }
    }
    __syncthreads();
    // 8 pixels of one output channel a thread: one 16-byte store (bf16)
    // or two (f32) where they are consecutive and aligned in y
    constexpr int CH = BM / 8;
    const size_t HoWo = (size_t)p.Ho * p.Wo;
    for (int idx = tid; idx < BN * CH; idx += kT) {
      const int cl = idx / CH, m8 = (idx - cl * CH) * 8;
      const int co = n0 + cl;
      if (co >= p.Co) continue;
      const int ty = m8 >> p.tw_log2, tx = m8 & (p.tw - 1);
      const int ty2 = (m8 + 7) >> p.tw_log2, tx2 = (m8 + 7) & (p.tw - 1);
      const int ho = ho0 + ty, wo = wo0 + tx, ho2 = ho0 + ty2,
                wo2 = wo0 + tx2;
      const size_t base = ((size_t)img * p.Co + co) * HoWo;
      const long long g0 = (long long)ho * p.Wo + wo;
      const long long g7 = (long long)ho2 * p.Wo + wo2;
      const float* t = tile + cl * LDT + m8;
      const __nv_bfloat16* th = reinterpret_cast<const __nv_bfloat16*>(tile) +
                                cl * LDH + m8;
      if (ho2 < p.Ho && wo2 < p.Wo && g7 - g0 == 7 &&
          ((base + (size_t)g0) & 7) == 0) {
        if (p.out_bf16) {
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.y) + base +
                                    g0) = *reinterpret_cast<const uint4*>(th);
        } else {
          float4* o = reinterpret_cast<float4*>(static_cast<float*>(p.y) +
                                                base + g0);
          o[0] = *reinterpret_cast<const float4*>(t);
          o[1] = *reinterpret_cast<const float4*>(t + 4);
        }
      } else {
        for (int e = 0; e < 8; ++e) {
          const int m = m8 + e, yy = m >> p.tw_log2, xx = m & (p.tw - 1);
          const int h = ho0 + yy, w = wo0 + xx;
          if (h >= p.Ho || w >= p.Wo) continue;
          const size_t o = base + (size_t)h * p.Wo + w;
          if (p.out_bf16)
            static_cast<__nv_bfloat16*>(p.y)[o] = th[e];
          else
            static_cast<float*>(p.y)[o] = t[e];
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver the runtime has loaded
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// a tensor map of s8 values; dims and box innermost first, strides in
// bytes of dims 1..rank-1; a swizzle of `swizzle` bytes (32, 64, 128)
bool encode_s8_map(CUtensorMap* map, const void* base, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box,
                   int swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                              : (swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_128B),
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

// CTAs of `kernel` that fit on the card at once with `smem` bytes each
// (the occupancy API, kept for the last size asked), at least one
template <typename Kernel>
long long resident_ctas(Kernel kernel, int threads, size_t smem,
                        size_t& known_smem, int& known_fit) {
  if (smem != known_smem) {
    int fit = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads,
                                                      smem) != cudaSuccess)
      fit = 1;
    known_smem = smem;
    known_fit = fit > 0 ? fit : 1;
  }
  return (long long)known_fit * (sm_count() > 0 ? sm_count() : 1);
}

// one wave of persistent CTAs: as many as fit on the SMs at once, shared
// out over the co blocks, at most one a tile
template <int BM, int BN, int KC, int KSIZE>
cudaError_t launch_conv(const CUtensorMap& tm_x, const ConvS8Args& a,
                        int ctiles, size_t smem, cudaStream_t st) {
  auto kernel = conv_s8_kernel<BM, BN, KC, KSIZE>;
  static size_t set_smem = 0, known_smem = 0;
  static int known_fit = 0;
  if (smem > set_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    set_smem = smem;
  }
  const long long slots = resident_ctas(kernel, conv_threads(BM, BN), smem,
                                        known_smem, known_fit);
  long long per_block = (slots + ctiles - 1) / ctiles;
  if (per_block > a.n_tiles) per_block = a.n_tiles;
  const dim3 grid((unsigned)per_block, (unsigned)ctiles);
  kernel<<<grid, conv_threads(BM, BN), smem, st>>>(tm_x, a);
  return cudaGetLastError();
}

template <int BM, int KC>
cudaError_t launch_conv_bn(int BN, const CUtensorMap& tm_x,
                           const ConvS8Args& a, int ctiles, size_t smem,
                           cudaStream_t st) {
  if (a.K == 3)
    return BN == 32 ? launch_conv<BM, 32, KC, 3>(tm_x, a, ctiles, smem, st)
                    : launch_conv<BM, 64, KC, 3>(tm_x, a, ctiles, smem, st);
  return BN == 32 ? launch_conv<BM, 32, KC, 0>(tm_x, a, ctiles, smem, st)
                  : launch_conv<BM, 64, KC, 0>(tm_x, a, ctiles, smem, st);
}

template <int BM>
cudaError_t launch_conv_kc(int KC, int BN, const CUtensorMap& tm_x,
                           const ConvS8Args& a, int ctiles, size_t smem,
                           cudaStream_t st) {
  switch (KC) {
    case 32:
      return launch_conv_bn<BM, 32>(BN, tm_x, a, ctiles, smem, st);
    case 64:
      return launch_conv_bn<BM, 64>(BN, tm_x, a, ctiles, smem, st);
    case 128:
      return launch_conv_bn<BM, 128>(BN, tm_x, a, ctiles, smem, st);
  }
  return cudaErrorInvalidValue;
}

// ---- quantize ----

__device__ __forceinline__ float load1(const float* x, size_t i) {
  return x[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

// 8 consecutive values, kept as loaded (bf16 bits or f32) until used:
// load() from a 16-byte aligned address, load_upto() the first n by
// scalar loads (the rest 0)
template <typename T>
struct Raw8;
template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* x) {
    a = __ldg(reinterpret_cast<const float4*>(x));
    b = __ldg(reinterpret_cast<const float4*>(x) + 1);
  }
  __device__ __forceinline__ void load_upto(const float* x, int n) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? x[j] : 0.f;
    a = make_float4(v[0], v[1], v[2], v[3]);
    b = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ __forceinline__ float get(int j) const {
    const float4& h = j < 4 ? a : b;
    const int k = j & 3;
    return k == 0 ? h.x : (k == 1 ? h.y : (k == 2 ? h.z : h.w));
  }
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* x) {
    u = __ldg(reinterpret_cast<const uint4*>(x));
  }
  __device__ __forceinline__ void load_upto(const __nv_bfloat16* x, int n) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(x);
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (2 * i < n ? h[2 * i] : 0u) |
             ((2 * i + 1 < n ? (unsigned)h[2 * i + 1] : 0u) << 16);
    u = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ float get(int j) const {
    const unsigned w = j < 2 ? u.x : (j < 4 ? u.y : (j < 6 ? u.z : u.w));
    return __uint_as_float(j & 1 ? w & 0xffff0000u : w << 16);
  }
};

// clip(rint(v / s), -127, 127) as a byte: the IEEE quotient (__fdiv_rn,
// no reciprocal), rounded half to even; a zero (half of a ReLU's output)
// skips the division
__device__ __forceinline__ unsigned quant1(float v, float s) {
  if (v == 0.f) return 0u;
  int i = __float2int_rn(__fdiv_rn(v, s));
  i = i < -127 ? -127 : (i > 127 ? 127 : i);
  return static_cast<unsigned>(i) & 0xffu;
}

constexpr int kQT = 256;            // threads of a quantize CTA
constexpr int kQMaxScales = 8192;   // per-channel scales staged

// NCHW input. A grid-stride walk over the (image, QC-channel, QP-pixel)
// tiles of the output, QC = 64 (32 where Cp = 32), (QC / 4) x (QP / 8)
// threads; thread (cq, pg) quantizes channels 4 cq .. 4 cq + 3 at pixels
// 8 pg .. 8 pg + 7 of a tile and packs each pixel's 4 bytes into a word of
// the s8 tile (QC / 4 + 2 or + 1 words a pixel: conflict-free writes);
// then 16-byte stores of 16 channels of a pixel. vec: HW % 8 == 0 and x
// 16-byte aligned, so every 8-pixel run of a row is one aligned load.
template <typename T, int QC, int QP>
__global__ void __launch_bounds__(QC * QP / 32)
quantize_nchw_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     int per_channel, int8_t* __restrict__ q, int N, int C,
                     int HW, int Cp, int vec) {
  constexpr int kThreads = QC * QP / 32, CQ = QC / 4, LDW = QC == 64 ? 18 : 9;
  __shared__ __align__(16) unsigned tile[QP * LDW];
  extern __shared__ float sc[];               // [C] per-channel scales
  const int tid = threadIdx.x;
  if (per_channel)
    for (int c = tid; c < C; c += kThreads) sc[c] = scale[c];
  const float s0 = per_channel ? 0.f : __ldg(scale);
  __syncthreads();
  const int ptiles = (HW + QP - 1) / QP, ctiles = (Cp + QC - 1) / QC;
  const long long tiles = (long long)N * ctiles * ptiles;
  const int cq = tid % CQ, pg = tid / CQ;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int pt = (int)(t % ptiles);
    const long long rest = t / ptiles;
    const int ct = (int)(rest % ctiles), n = (int)(rest / ctiles);
    const int p0 = pt * QP, c0 = ct * QC, pix = p0 + pg * 8;
    unsigned packed[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    Raw8<T> v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + cq * 4 + e;
      const T* row = x + ((size_t)n * C + (c < C ? c : 0)) * HW + pix;
      if (c < C && vec && pix + 8 <= HW)
        v[e].load(row);
      else
        v[e].load_upto(row, c < C ? HW - pix : 0);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + cq * 4 + e;
      if (c >= C) continue;                   // pad channels stay 0
      const float s = per_channel ? sc[c] : s0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        packed[j] |= quant1(v[e].get(j), s) << (8 * e);
    }
    __syncthreads();          // the previous tile's stores are done with it
#pragma unroll
    for (int j = 0; j < 8; ++j) tile[(pg * 8 + j) * LDW + cq] = packed[j];
    __syncthreads();
    // 16 channels of a pixel a thread, one 16-byte store
    for (int i = tid; i < QP * (QC / 16); i += kThreads) {
      const int pl = i / (QC / 16), k = i - pl * (QC / 16);
      const int pixel = p0 + pl, c = c0 + k * 16;
      if (pixel >= HW || c >= Cp) continue;
      const unsigned* src = tile + pl * LDW + k * 4;
      *reinterpret_cast<uint4*>(q + ((size_t)n * HW + pixel) * Cp + c) =
          make_uint4(src[0], src[1], src[2], src[3]);
    }
  }
}

// channels-last input (NHWC in memory). A thread writes 16 channels of one
// pixel with one 16-byte store; grid-stride over the NHW * Cp / 16 chunks.
// vec: C % 8 == 0 and x 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kQT)
quantize_nhwc_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     int per_channel, int8_t* __restrict__ q, int C,
                     long long pixels, int Cp, int vec) {
  extern __shared__ float sc[];               // [C] per-channel scales
  if (per_channel)
    for (int c = threadIdx.x; c < C; c += kQT) sc[c] = scale[c];
  const float s0 = per_channel ? 0.f : __ldg(scale);
  __syncthreads();
  const int chunks = Cp / 16;
  const long long items = pixels * chunks;
  for (long long i = blockIdx.x * (long long)kQT + threadIdx.x; i < items;
       i += (long long)gridDim.x * kQT) {
    const long long pix = i / chunks;
    const int c0 = (int)(i - pix * chunks) * 16;
    const T* row = x + (size_t)pix * C;
    unsigned w[4] = {0, 0, 0, 0};
    if (vec && c0 + 16 <= C) {
      Raw8<T> v[2];
      v[0].load(row + c0);
      v[1].load(row + c0 + 8);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        w[j >> 2] |= quant1(v[j >> 3].get(j & 7),
                            per_channel ? sc[c0 + j] : s0)
                     << (8 * (j & 3));
    } else {
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + j;
        if (c < C)
          w[j >> 2] |= quant1(load1(row, c), per_channel ? sc[c] : s0)
                       << (8 * (j & 3));
      }
    }
    *reinterpret_cast<uint4*>(q + (size_t)pix * Cp + c0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// one wave of CTAs (as many as fit at once) walks the tiles or chunks
template <typename Kernel>
unsigned quantize_grid(Kernel kernel, int threads, size_t smem,
                       long long work, size_t& known_smem, int& known_fit) {
  long long blocks =
      resident_ctas(kernel, threads, smem, known_smem, known_fit);
  return (unsigned)(blocks < work ? blocks : work);
}

// NCHW: the widest pixel tile (of P0 > P1 > P2) that still gives four
// CTAs an SM, so small maps spread over the card
template <typename T, int QC, int QP>
cudaError_t launch_nchw_tile(const T* x, const float* scale, int per_channel,
                             int8_t* q, int N, int C, int HW, int Cp, int vec,
                             size_t smem, cudaStream_t st) {
  static size_t known_smem = (size_t)-1;
  static int known_fit = 0;
  auto kernel = quantize_nchw_kernel<T, QC, QP>;
  const unsigned grid = quantize_grid(
      kernel, QC * QP / 32, smem,
      (long long)N * ((Cp + QC - 1) / QC) * ((HW + QP - 1) / QP), known_smem,
      known_fit);
  kernel<<<grid, QC * QP / 32, smem, st>>>(x, scale, per_channel, q, N, C,
                                           HW, Cp, vec);
  return cudaGetLastError();
}

template <typename T, int QC, int P0, int P1, int P2>
cudaError_t launch_nchw(const T* x, const float* scale, int per_channel,
                        int8_t* q, int N, int C, int HW, int Cp, int vec,
                        size_t smem, cudaStream_t st) {
  const long long blocks = (long long)N * ((Cp + QC - 1) / QC);
  const long long want = 4LL * (sm_count() > 0 ? sm_count() : 1);
  if (blocks * ((HW + P0 - 1) / P0) >= want)
    return launch_nchw_tile<T, QC, P0>(x, scale, per_channel, q, N, C, HW,
                                       Cp, vec, smem, st);
  if (blocks * ((HW + P1 - 1) / P1) >= want)
    return launch_nchw_tile<T, QC, P1>(x, scale, per_channel, q, N, C, HW,
                                       Cp, vec, smem, st);
  return launch_nchw_tile<T, QC, P2>(x, scale, per_channel, q, N, C, HW, Cp,
                                     vec, smem, st);
}

template <typename T>
cudaError_t launch_quantize(const void* x, const float* scale,
                            int per_channel, int8_t* q, int N, int C, int HW,
                            int Cp, int channels_last, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const size_t smem = per_channel ? (size_t)C * sizeof(float) : 0;
  const int vec_nchw = aligned && HW % 8 == 0;
  cudaError_t err = cudaSuccess;
  if (channels_last) {
    static size_t known_smem = (size_t)-1;
    static int known_fit = 0;
    auto kernel = quantize_nhwc_kernel<T>;
    const unsigned grid = quantize_grid(
        kernel, kQT, smem, ((long long)N * HW * (Cp / 16) + kQT - 1) / kQT,
        known_smem, known_fit);
    kernel<<<grid, kQT, smem, st>>>(xt, scale, per_channel, q, C,
                                    (long long)N * HW, Cp,
                                    aligned && C % 8 == 0);
  } else if (Cp == 32) {
    err = launch_nchw<T, 32, 256, 128, 64>(xt, scale, per_channel, q, N, C,
                                           HW, Cp, vec_nchw, smem, st);
  } else {
    err = launch_nchw<T, 64, 128, 64, 32>(xt, scale, per_channel, q, N, C,
                                          HW, Cp, vec_nchw, smem, st);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {


// x: s8 [N, H, W, Cp], 16-byte aligned; w: s8 [Co][K * K * Cp], 16-byte
// aligned; sw: f32 [Co]; bias: f32 [Co] or null; y: [N, Co, Ho, Wo], bf16
// (out_bf16 = 1) or f32. The tile plan: th x tw output pixels (th * tw 64
// or 128, tw a power of two), BN 32 or 64 output channels, KC 32, 64 or
// 128 channels a chunk (Cp a multiple of KC), `stages` ring stages, A's
// box rows grouped into 128-byte units or not. The shared-memory layout
// is the caller's (ops/cuda/conv_s8.py conv_layout, its one owner): A's
// box (box_inner bytes by box_cols by box_rows), whether B is resident,
// B's padded row of b_ld bytes, the stage's halo and whole size, the
// offsets of resident B, the epilogue tile and the mbarriers, and the
// bytes to ask for; this entry point only checks that the regions hold
// what the kernel puts there and do not overlap. Returns a cudaError_t
// code.
int bpbreid_conv_s8(const void* x, const void* w, const float* sw,
                    const float* bias, void* y, int N, int H, int W, int Cp,
                    int Co, int Ho, int Wo, int K, int stride, int pad,
                    int out_bf16, int th, int tw, int BN, int KC, int stages,
                    int grouped, int box_inner, int box_cols, int box_rows,
                    int b_resident, int b_ld, int halo_bytes,
                    int stage_bytes, int b_offset, int tile_offset,
                    int bar_offset, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BM = th * tw;
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0 || Ho <= 0 || Wo <= 0 ||
      K <= 0 || stride <= 0 || pad < 0 || th <= 0 || tw <= 0 ||
      (tw & (tw - 1)) != 0 || (BM != 64 && BM != 128) ||
      (BN != 32 && BN != 64) || (KC != 32 && KC != 64 && KC != 128) ||
      Cp % KC != 0 || stages < 1 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (long long)N * Co * Ho * Wo >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const int box_h = (th - 1) * stride + K, box_w = (tw - 1) * stride + K;
  const int tiles_h = (Ho + th - 1) / th, tiles_w = (Wo + tw - 1) / tw;
  const int ctiles = (Co + BN - 1) / BN;
  if ((long long)N * tiles_h * tiles_w >= (1LL << 31) || ctiles > 65535)
    return (int)cudaErrorInvalidValue;

  ConvS8Args a;
  a.w = static_cast<const int8_t*>(w);
  a.sw = sw;
  a.bias = bias;
  a.y = y;
  a.Cp = Cp;
  a.Co = Co;
  a.Ho = Ho;
  a.Wo = Wo;
  a.K = K;
  a.stride = stride;
  a.pad = pad;
  a.out_bf16 = out_bf16;
  a.th = th;
  a.tw = tw;
  a.tw_log2 = 0;
  while ((1 << a.tw_log2) < tw) ++a.tw_log2;
  a.tiles_w = tiles_w;
  a.tiles_img = tiles_h * tiles_w;
  a.n_tiles = N * tiles_h * tiles_w;
  a.KT = Cp / KC;
  a.stages = stages;

  // A's TMA box: grouped, 128/Cp pixels of an image row a 128-byte box
  // row (Cp <= 64 in one chunk), from the 128-byte unit that holds the
  // halo's first pixel; else one pixel's KC channels a box row. Either
  // way it covers the halo, and the swizzle spans its inner dimension.
  if (box_rows < box_h || box_rows > 256 || box_cols > 256 ||
      box_inner != (grouped ? 128 : KC))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x;
  const cuuint64_t img_bytes = (cuuint64_t)H * W * Cp;
  a.grouped = grouped != 0;
  a.a_rb = box_cols * box_inner;
  a.tx_bytes = box_rows * a.a_rb;
  bool ok;
  if (a.grouped) {
    const int P = 128 / Cp, off = ((-pad) % P + P) % P;
    if (KC != Cp || Cp > 64 || (W * Cp) % 128 != 0 ||
        (tw * stride) % P != 0 || box_cols * P < off + box_w)
      return (int)cudaErrorInvalidValue;
    a.a_pb = Cp;
    a.a_x0 = off * Cp;
    a.a_swz = 7;
    a.a_wshift = P == 4 ? 2 : (P == 2 ? 1 : 0);
    a.a_w0 = -(pad + off) / P;
    const cuuint64_t dims[4] = {128, (cuuint64_t)W * Cp / 128,
                                (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t strides[3] = {128, (cuuint64_t)W * Cp, img_bytes};
    const cuuint32_t box[4] = {128, (cuuint32_t)box_cols,
                               (cuuint32_t)box_rows, 1};
    ok = encode_s8_map(&tm_x, x, dims, strides, box, 128);
  } else {
    if (box_cols < box_w) return (int)cudaErrorInvalidValue;
    a.a_pb = KC;
    a.a_x0 = 0;
    a.a_swz = KC / 16 - 1;
    a.a_wshift = 0;
    a.a_w0 = -pad;
    const cuuint64_t dims[4] = {(cuuint64_t)Cp, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)Cp, (cuuint64_t)W * Cp,
                                   img_bytes};
    const cuuint32_t box[4] = {(cuuint32_t)KC, (cuuint32_t)box_cols,
                               (cuuint32_t)box_rows, 1};
    ok = encode_s8_map(&tm_x, x, dims, strides, box, KC);
  }
  if (!ok) return (int)cudaErrorInvalidValue;

  // the layout: the ring's stages (the halo, then a B chunk unless B is
  // resident), resident B, the epilogue tile ([BN][BM + 8] bf16 or
  // [BN][BM + 4] f32), the mbarriers, and 1024 bytes to align the base;
  // TMA's destinations and the swizzle's period start on 1024 bytes, B's
  // cp.async rows and the tile's 16-byte vectors on 16
  const int KK = K * K;
  const long long b_chunk = (long long)BN * b_ld;
  const long long tile = out_bf16 ? (long long)BN * (BM + 8) * 2
                                  : (long long)BN * (BM + 4) * 4;
  if (b_ld < KK * (b_resident ? Cp : KC) || b_ld % 16 != 0 ||
      halo_bytes < a.tx_bytes || halo_bytes % 1024 != 0 ||
      stage_bytes < halo_bytes + (b_resident ? 0 : b_chunk) ||
      stage_bytes % 1024 != 0 ||
      b_offset < (long long)stages * stage_bytes || b_offset % 1024 != 0 ||
      tile_offset < b_offset + (b_resident ? b_chunk : 0) ||
      tile_offset % 16 != 0 || bar_offset < tile_offset + tile ||
      bar_offset % 8 != 0 || smem < bar_offset + 8 * stages + 1024 ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  a.b_resident = b_resident != 0;
  a.b_ld = b_ld;
  a.b_tap = b_resident ? Cp : KC;
  a.halo_bytes = halo_bytes;
  a.stage_bytes = stage_bytes;
  a.b_offset = b_offset;
  a.tile_offset = tile_offset;
  a.bar_offset = bar_offset;

  return (int)(BM == 128 ? launch_conv_kc<128>(KC, BN, tm_x, a, ctiles,
                                               (size_t)smem, st)
                         : launch_conv_kc<64>(KC, BN, tm_x, a, ctiles,
                                              (size_t)smem, st));
}

// x: [N, C, H, W] (channels_last = 0) or [N, H, W, C] (1) in memory, f32
// (dtype 0) or bf16 (1); scale: f32 [C] (per_channel = 1) or [1], floored
// by the caller; q: s8 [N, H, W, Cp], 16-byte aligned, Cp a multiple of
// 32. Returns a cudaError_t code.
int bpbreid_quantize_s8(const void* x, const float* scale, int per_channel,
                        void* q, int N, int C, int HW, int Cp, int dtype,
                        int channels_last, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || C <= 0 || HW <= 0 || Cp < C || Cp % 32 != 0 ||
      (per_channel && C > kQMaxScales) ||
      (reinterpret_cast<uintptr_t>(q) & 15) != 0)
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
