// Fused channel-attention weighted statistics, for Hopper.
//
// Replaces the TPU kernel `_attn_stats_kernel` of
// diart_tpu/ops/pallas_attn_stats.py (reached through `_run_kernel` /
// `fused_attentive_stats`). Same function, per stream b and channel c:
//
//   logit[t, c] = b2[c] + sum_h hidden[b, t, h] * w2[h, c]     (f32)
//   alpha[t, c] = softmax over t of logit[:, c]
//   den[b, s, c] = sum_t wt[b, s, t] * alpha[t, c]
//   s1[b, s, c]  = sum_t wt[b, s, t] * alpha[t, c] * x[b, t, c]
//   s2[b, s, c]  = sum_t wt[b, s, t] * alpha[t, c] * x[b, t, c]^2
//
// x (B, T, C) is f32 or bf16 and read once; hidden (B, T, H) and wt
// (B, S, T) are f32. Only den/s1/s2 (B, S, C) f32 are written: the (B, T, C)
// logits and products never reach memory.
//
// What bounds it on the H100: at the ECAPA head (B=64, T=501, H=128,
// C=1536, S=4) the logits product is 12.6 GFLOP against ~115 MB of inputs
// (~0.034 ms at 3.35 TB/s). In f32 FMAs that product alone takes 0.19 ms at
// 67 TFLOP/s. On the TF32 tensor cores (495 TFLOP/s) it is three products
// at f32 accuracy (below), 0.076 ms: the design's bound.
//
// Design: the logits are computed transposed, logit^T = W2^T (channels x H)
// . hidden^T (H x frames), with `wgmma` m64n64k8 on TF32, so channels are
// the instruction's M and frames its N.
//
// * f32 accuracy from TF32 (3xTF32): each operand v is split into
//   hi = rna_tf32(v) and lo = rna_tf32(v - hi), and the logits accumulate
//   lo.hi + hi.lo + hi.hi in f32 (the lo.lo term is below f32's rounding).
//   One TF32 pass would leave ~1e-3 relative error in the logits. W2^T's
//   hi and lo come prepared by the wrapper (once per model); hidden is split
//   in shared memory, slice by slice, while the previous slice's products
//   run.
// * A block is 128 channels, one warpgroup of 64 each, over the same frames:
//   both read the same hidden slice, so hidden is copied and split once for
//   128 channels. Each thread holds its rows of W2^T hi and lo as `wgmma` A
//   fragments in registers for the whole walk (128 registers at H = 128), so
//   the products read only hidden from shared memory: with both operands
//   there, N = 64 TF32 products need all of shared memory's 128 bytes a
//   cycle. Hidden arrives by TMA in 32-deep H slices of 64 frames (128 bytes
//   of f32, 128-byte-swizzled, K-major as it lies in memory; frames past T
//   and H read as zeros) through an 8-stage ring, seven slices ahead, each
//   stage with its mbarrier; the next slice is split while this one's
//   products run, and one barrier a slice frees its stage for TMA. The x
//   tile (64 frames x 128 channels) and the speakers' weights come by
//   `cp.async` under the products.
// * A thread's accumulators are 2 channels (rows g, g + 8 of its warp) x 16
//   frames, initialised to the bias. It runs its own online softmax over its
//   frames, in base 2 (ex2): a running max and normaliser and 3 S rescaled
//   sums a channel. At the end of a stream these are merged over the 4
//   lanes of a quad (shuffles, max first) in a fixed order and divided by
//   the normaliser. No atomics: results are deterministic and do not depend
//   on the launch plan.
// * What holds it: the epilogue (~20 instructions a logit on the FP32
//   units, 2 warps a scheduler) does not overlap the next tile's products.
//   Tried in development and slower: a second accumulator set (ptxas then
//   serialized the `wgmma`s), and warpgroups that walk different streams
//   of 64-channel blocks (twice the hidden copies and splits).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int AC = 128;               // channels a block: two warpgroups of 64 (the wgmma M)
constexpr int AFT = 64;               // frames a tile (the wgmma N)
constexpr int AK = 32;                // H slice: 32 f32 = 128 bytes
constexpr int AST = 8;                // hidden ring depth; slices are copied AST - 1 ahead
constexpr int ANT = 256;              // threads: two warpgroups
constexpr int AH_BYTES = AFT * 128;   // one hidden slice (hi or lo)
constexpr int MAX_H = 4 * AK;         // W2^T's registers hold at most four H slices
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the hidden ring (hi and lo), the x tile and the speakers' weights, from a
// 1024-byte boundary
__host__ __device__ constexpr size_t tile_bytes(int speakers, int elt) {
  return (size_t)AST * 2 * AH_BYTES + (size_t)AFT * AC * elt + sizeof(float) * speakers * AFT;
}
// ... with room to reach that boundary from the 16-byte-aligned base; the
// ring's barriers (8 AST bytes) go below the boundary, or above the tiles
// where the base is less than 8 AST bytes below it
__host__ __device__ constexpr size_t smem_bytes(int speakers, int elt) {
  return 1008 + tile_bytes(speakers, elt);
}
static_assert(smem_bytes(8, 4) <= 232448, "the widest block (S = 8, f32 x) must fit 227 KB");

// byte offset of x tile row `row`, byte `col`: 16-byte chunks XOR-swizzled so
// that the epilogue's reads (4 rows 2 apart, 16 channels) hit distinct banks
__device__ __forceinline__ unsigned x_offset(int row, int col, int row_bytes) {
  return row * row_bytes + ((((col >> 4) ^ (((row >> 1) & 3) << 1)) << 4) | (col & 15));
}

// 2^v (PTX ex2.approx: relative error below 2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// TMA: the (32 H x 64 frames) box at (h0, t0, b) of the hidden map into a
// 128-byte-swizzled tile; completion is counted on `bar`
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map, int h0, int t0,
                                            int b, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(h0), "r"(t0), "r"(b), "r"(bar)
      : "memory");
}

// x: (B, T, C); hidden, through `hmap`: (B, T, H) f32, H % 8 == 0, H <= 32 NK;
// whi/wlo: (C, Hp) f32 (W2^T split, Hp = H rounded up to 32, zero beyond H); b2 (C,);
// wt (B, S, T). xvec: the bytes of one x copy (16, 8 or 4; every x row and
// the base are aligned to it). Block (blockIdx.x, blockIdx.y): channels
// blockIdx.x * 128 .., streams blockIdx.y * per .. (at most per of them).
template <typename T, int S, int NK>
__global__ void __launch_bounds__(ANT, 1) attn_stats_tc(
    const __grid_constant__ CUtensorMap hmap, const T* __restrict__ x,
    const float* __restrict__ whi, const float* __restrict__ wlo, const float* __restrict__ b2,
    const float* __restrict__ wt, float* __restrict__ den, float* __restrict__ s1,
    float* __restrict__ s2, int batch, int time, int channels, int hdim, int per, int xvec) {
  constexpr int XROW = AC * sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;  // swizzle period
  unsigned char* tiles = smem_raw + (base - raw);
  constexpr int nk = NK;  // H slices of 32
  const int hp = (hdim + AK - 1) / AK * AK;  // whi/wlo's row stride
  unsigned char* ring = tiles;                         // [AST][hi, lo][64 rows][128 B]
  unsigned char* xs = ring + AST * 2 * AH_BYTES;       // [AFT][AC] of T, swizzled
  float* wts = reinterpret_cast<float*>(xs + AFT * XROW);  // [S][AFT]
  // [AST] mbarriers, one a stage
  const unsigned bars = base - raw >= 8 * AST ? raw : base + (unsigned)tile_bytes(S, sizeof(T));

  const int c0 = blockIdx.x * AC;
  const int b0 = blockIdx.y * per;
  const int nb = min(per, batch - b0);
  const int ntiles = (time + AFT - 1) / AFT;
  const int nq = nb * ntiles * nk;  // hidden slices the block walks: stream, frame tile, H slice
  const int tid = threadIdx.x;
  const int lane = tid & 31, wgrp = tid >> 7;
  const int g = lane >> 2, tig = lane & 3;
  const int cl = wgrp * 64 + ((tid >> 5) & 3) * 16 + g;  // channels c0 + cl and c0 + cl + 8

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < AST; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // W2^T hi and lo as this thread's A fragments: rows cl and cl + 8, columns
  // 8 k + tig and 8 k + tig + 4 of each k8 step
  unsigned ahi[NK * 4][4], alo[NK * 4][4];
#pragma unroll
  for (int k = 0; k < NK * 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + cl + 8 * (i & 1), col = 8 * k + tig + 4 * (i >> 1);
      const bool ok = c < channels && col < hp;
      ahi[k][i] = ok ? __float_as_uint(whi[(size_t)c * hp + col]) : 0u;
      alo[k][i] = ok ? __float_as_uint(wlo[(size_t)c * hp + col]) : 0u;
    }
  auto load_hidden = [&](int q) {  // slice q, raw, into the hi half of stage q % AST (one thread)
    const int t = q / nk;
    const unsigned bar = bars + 8 * (q % AST);
    mbar_expect_tx(bar, AH_BYTES);
    tma_load_3d(base + (q % AST) * 2 * AH_BYTES, &hmap, (q % nk) * AK,
                (t % ntiles) * AFT, b0 + t / ntiles, bar);
  };
  auto wait_hidden = [&](int q) { mbar_wait(bars + 8 * (q % AST), (q / AST) & 1); };
  auto load_tile = [&](int gt) {  // frame tile gt's x and speaker weights
    const int b = b0 + gt / ntiles, t0 = (gt % ntiles) * AFT;
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(x + (size_t)b * time * channels);
    const int row = XROW / xvec;  // copies a row
    for (int e = tid; e < AFT * row; e += ANT) {
      const int r = e / row, col = (e % row) * xvec;
      const int ch = col / (int)sizeof(T);  // first channel of the copy, within the tile
      const bool ok = t0 + r < time && c0 + ch < channels;
      const unsigned char* src = xb + (ok ? ((size_t)(t0 + r) * channels + c0 + ch) * sizeof(T) : 0);
      unsigned char* dst = xs + x_offset(r, col, XROW);
      if (xvec == 16) cp_async16(dst, src, ok ? 16 : 0);
      else if (xvec == 8) cp_async_ca<8>(dst, src, ok ? 8 : 0);
      else cp_async_ca<4>(dst, src, ok ? 4 : 0);
    }
    const float* wtb = wt + (size_t)b * S * time;
    for (int e = tid; e < S * AFT; e += ANT) {
      const int s = e / AFT, t = t0 + e % AFT;
      cp_async_ca<4>(wts + e, wtb + (t < time ? (size_t)s * time + t : 0), t < time ? 4 : 0);
    }
  };
  auto split = [&](int q) {  // stage q % AST: raw -> hi in place, lo beside it
    float4* hi = reinterpret_cast<float4*>(ring + (q % AST) * 2 * AH_BYTES);
    float4* lo = reinterpret_cast<float4*>(ring + (q % AST) * 2 * AH_BYTES + AH_BYTES);
#pragma unroll
    for (int i = 0; i < AH_BYTES / 16 / ANT; ++i) {
      const int e = tid + i * ANT;
      const float4 v = hi[e];
      const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
      hi[e] = h;
      lo[e] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y), tf32_rna(v.z - h.z),
                          tf32_rna(v.w - h.w));
    }
  };

  load_tile(0);
  cp_async_commit();  // W2^T, tile 0's x and weights
  __syncthreads();    // the barriers are initialised
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < AST - 1; ++i)
      if (i < nq) load_hidden(i);
  }
  cp_async_wait<0>();
  wait_hidden(0);
  __syncthreads();
  split(0);
  fence_async_shared();
  __syncthreads();

  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) bias[r] = c0 + cl + 8 * r < channels ? b2[c0 + cl + 8 * r] : 0.0f;
  // per channel row: running max (in log2 units), normaliser, and the
  // speakers' den / s1 / s2 sums, all scaled by 2^-max
  float m[2], l[2], ad[2][S], a1[2][S], a2[2][S];
  auto reset = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) ad[r][s] = a1[r][s] = a2[r][s] = 0.0f;
    }
  };
  reset();
  float acc[8][4];
  // this thread's x in the tile: frame 8 j + 2 tig + h, whose swizzle is tig's
  const unsigned char* xrow = xs + 2 * tig * XROW;
  unsigned xcol[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) xcol[r] = x_offset(2 * tig, (cl + 8 * r) * (int)sizeof(T), XROW) - 2 * tig * XROW;

  for (int gt = 0, q = 0; gt < nb * ntiles; ++gt) {  // frame tile gt of the block's walk
    const int bi = gt / ntiles, tile = gt % ntiles;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] = acc[j][1] = bias[0];
      acc[j][2] = acc[j][3] = bias[1];
    }
#pragma unroll
    for (int kb = 0; kb < nk; ++kb, ++q) {
      const unsigned bh = base + (q % AST) * 2 * AH_BYTES, bl = bh + AH_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < AK / 8; ++ks) {  // the small terms first, then hi . hi
        wgmma_m64n64k8_tf32(acc, alo[4 * kb + ks], wgmma_desc(bh + ks * 32, 16, 1024));
        wgmma_m64n64k8_tf32(acc, ahi[4 * kb + ks], wgmma_desc(bl + ks * 32, 16, 1024));
        wgmma_m64n64k8_tf32(acc, ahi[4 * kb + ks], wgmma_desc(bh + ks * 32, 16, 1024));
      }
      wgmma_commit();
      if (q + 1 < nq) {  // under slice q's products
        wait_hidden(q + 1);
        split(q + 1);
      }
      fence_async_shared();  // the split (and the stage it leaves) for the tensor cores and TMA
      wgmma_wait<1>();  // slice q - 1 is consumed; slice q runs on
      __syncthreads();  // ... in both warpgroups; slice q + 1 is split; the last epilogue is done
      if (tid == 0 && q + AST - 1 < nq) load_hidden(q + AST - 1);  // into slice q - 1's stage
      if (kb == 0 && gt > 0) {
        load_tile(gt);
        cp_async_commit();
      }
    }
    cp_async_wait<0>();  // this tile's x and weights
    __syncthreads();
    wgmma_wait<0>();

    // epilogue of the tile: acc[j][h] -> channel cl, acc[j][2 + h] -> cl + 8;
    // frame 8 j + 2 tig + h of the tile. Both channels side by side.
    const int nvalid = time - tile * AFT;  // frames of the tile below T
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (8 * j + 2 * tig + h < nvalid) {
          tmax[0] = fmaxf(tmax[0], acc[j][h]);
          tmax[1] = fmaxf(tmax[1], acc[j][2 + h]);
        }
    float mn[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rescale when the max rises (by 0 on the first frames)
      mn[r] = fmaxf(m[r], tmax[r] * kLog2e);
      const float sc = mn[r] == -INFINITY ? 1.0f : exp2f(m[r] - mn[r]);
      m[r] = mn[r];
      l[r] *= sc;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        ad[r][s] *= sc;
        a1[r][s] *= sc;
        a2[r][s] *= sc;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f0 = 8 * j + 2 * tig;
      float wv[S][2];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float2 v = *reinterpret_cast<const float2*>(&wts[s * AFT + f0]);
        wv[s][0] = v.x;
        wv[s][1] = v.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = f0 + h < nvalid;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float e = ok ? exp2_approx(fmaf(acc[j][2 * r + h], kLog2e, -mn[r])) : 0.0f;
          const float xv = to_f(*reinterpret_cast<const T*>(xrow + (8 * j + h) * XROW + xcol[r]));
          const float ex = e * xv;
          const float exx = ex * xv;
          l[r] += e;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            ad[r][s] = fmaf(wv[s][h], e, ad[r][s]);
            a1[r][s] = fmaf(wv[s][h], ex, a1[r][s]);
            a2[r][s] = fmaf(wv[s][h], exx, a2[r][s]);
          }
        }
      }
    }
    if (tile != ntiles - 1) continue;

    // the stream is done: merge the quad's 4 lanes, max first, in a fixed
    // order, divide by the normaliser and store
    const size_t ob = (size_t)(b0 + bi) * S * channels;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mq = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
      const float f = m[r] == -INFINITY ? 0.0f : exp2f(m[r] - mq);
      float v[1 + 3 * S];
      v[0] = l[r] * f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        v[1 + 3 * s] = ad[r][s] * f;
        v[2 + 3 * s] = a1[r][s] * f;
        v[3 + 3 * s] = a2[r][s] * f;
      }
#pragma unroll
      for (int i = 0; i < 1 + 3 * S; ++i) {
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
      }
      const int c = c0 + cl + 8 * r;
      if (tig == 0 && c < channels) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          den[ob + (size_t)s * channels + c] = v[1 + 3 * s] / v[0];
          s1[ob + (size_t)s * channels + c] = v[2 + 3 * s] / v[0];
          s2[ob + (size_t)s * channels + c] = v[3 + 3 * s] / v[0];
        }
      }
    }
    reset();
  }
}

// hidden (B, T, H) f32 as a TMA map of (32 H x 64 frames) boxes, 128-byte
// swizzle; frames past T and H read as zeros
int hidden_map(CUtensorMap* map, const void* hidden, int batch, int time, int hdim) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hdim, (cuuint64_t)time, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)hdim * 4, (cuuint64_t)time * hdim * 4};
  const cuuint32_t box[3] = {AK, AFT, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(hidden),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int S, int NK>
int launch_nk(const CUtensorMap& hmap, const void* x, const float* whi, const float* wlo,
             const float* b2, const float* wt, float* den, float* s1, float* s2, int batch,
             int time, int channels, int hdim, int per, int xvec, cudaStream_t stream) {
  const size_t smem = smem_bytes(S, sizeof(T));
  const cudaError_t err = cudaFuncSetAttribute(
      attn_stats_tc<T, S, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((channels + AC - 1) / AC, (batch + per - 1) / per);
  attn_stats_tc<T, S, NK><<<grid, ANT, smem, stream>>>(hmap, static_cast<const T*>(x), whi, wlo,
                                                       b2, wt, den, s1, s2, batch, time, channels,
                                                       hdim, per, xvec);
  return (int)cudaGetLastError();
}

// W2^T's registers are sized for two H slices (H <= 64) or four (H <= 128);
// slices past H hold zeros
template <typename T, int S>
int launch_s(const CUtensorMap& hmap, const void* x, const float* whi, const float* wlo,
             const float* b2, const float* wt, float* den, float* s1, float* s2, int batch,
             int time, int channels, int hdim, int per, int xvec, cudaStream_t stream) {
  if (hdim <= 2 * AK)
    return launch_nk<T, S, 2>(hmap, x, whi, wlo, b2, wt, den, s1, s2, batch, time, channels,
                              hdim, per, xvec, stream);
  return launch_nk<T, S, 4>(hmap, x, whi, wlo, b2, wt, den, s1, s2, batch, time, channels, hdim,
                            per, xvec, stream);
}

template <typename T>
int launch(const CUtensorMap& hmap, const void* x, const float* whi, const float* wlo,
           const float* b2, const float* wt, float* den, float* s1, float* s2, int batch,
           int time, int channels, int hdim, int speakers, int per, int xvec,
           cudaStream_t stream) {
#define DIART_ATTN_CASE(S_)                                                                    \
  case S_:                                                                                     \
    return launch_s<T, S_>(hmap, x, whi, wlo, b2, wt, den, s1, s2, batch, time, channels, hdim, \
                           per, xvec, stream);
  switch (speakers) {
    DIART_ATTN_CASE(1)
    DIART_ATTN_CASE(2)
    DIART_ATTN_CASE(3)
    DIART_ATTN_CASE(4)
    DIART_ATTN_CASE(5)
    DIART_ATTN_CASE(6)
    DIART_ATTN_CASE(7)
    DIART_ATTN_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DIART_ATTN_CASE
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16. hidden (B, T, H), wt (B, S, T), b2
// (C,): f32, contiguous, hidden 16-byte aligned; whi/wlo (C, Hp): W2^T split
// into TF32 hi and lo, Hp = H rounded up to 32, zero beyond H; den/s1/s2:
// (B, S, C) f32. H must be a multiple of 8, at most 128 (MAX_H);
// xvec (16, 8 or 4) divides C * sizeof(x) and x's address. per: streams a
// block walks. Returns the launch's cudaError_t.
extern "C" int attn_stats_launch(const void* x, const void* hidden, const void* whi,
                                 const void* wlo, const void* b2, const void* wt, void* den,
                                 void* s1, void* s2, int batch, int time, int channels, int hdim,
                                 int speakers, int dtype, int per, int xvec, void* stream) {
  const int elt = dtype == 1 ? 2 : 4;
  if (batch < 1 || time < 1 || channels < 1 || hdim < 8 || hdim % 8 || per < 1 ||
      (batch + per - 1) / per > 65535 || (dtype != 0 && dtype != 1) ||
      (xvec != 16 && xvec != 8 && xvec != 4) || (channels * elt) % xvec ||
      reinterpret_cast<uintptr_t>(hidden) % 16 || hdim > MAX_H)
    return (int)cudaErrorInvalidValue;
  CUtensorMap hmap;
  const int err = hidden_map(&hmap, hidden, batch, time, hdim);
  if (err != 0) return err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(hmap, x, f(whi), f(wlo), f(b2), f(wt), o(den), o(s1), o(s2), batch, time,
                         channels, hdim, speakers, per, xvec, st);
  return launch<__nv_bfloat16>(hmap, x, f(whi), f(wlo), f(b2), f(wt), o(den), o(s1), o(s2),
                               batch, time, channels, hdim, speakers, per, xvec, st);
}

// Shared memory of a launch (the kernel's layout), 0 where H is not taken.
extern "C" long long attn_stats_smem(int hdim, int speakers, int dtype) {
  if (hdim < 8 || hdim % 8 || hdim > MAX_H) return 0;
  return (long long)smem_bytes(speakers, dtype == 1 ? 2 : 4);
}

extern "C" const char* attn_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
