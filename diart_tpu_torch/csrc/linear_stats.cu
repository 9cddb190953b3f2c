// Fused final-TDNN projection + weighted statistics, for Hopper.
//
// Replaces the TPU kernel `_stats_kernel` of diart_tpu/ops/pallas_stats.py
// (reached through `_run_kernel` / `fused_linear_stats`). Same function:
//
//   Z = a * leaky(X @ W + b) + c          (B, T, C), never written to memory
//   s1[b, s, :] = sum_t wt[b, s, t] * Z[b, t, :]
//   s2[b, s, :] = sum_t wt[b, s, t] * Z[b, t, :]^2
//
// X (B, T, Cin) is f32 or bf16 and W (Cin, C) has X's dtype (the wrapper
// prepares it once per model, as the TPU wrapper casts it); every product
// accumulates in f32.
//
// What bounds it on the H100: at the x-vector head (B=64, T=279, Cin=512,
// C=1500, S=4) the X @ W product is 27.4 GFLOP against ~25 MB of inputs
// and outputs, so the function is bound by the bf16 tensor cores (0.028 ms
// at 989 TFLOP/s), not bytes. Leaving Z out of memory saves the 107 MB
// (f32) that the unfused version writes and reads back twice.
//
// `linear_stats_wgmma` (bf16 X, Cin % 8 == 0, Cin <= 576 — the main path)
// computes the transposed tile Z^T = W^T (channels x Cin) . X^T (Cin x
// frames) with `wgmma` m64n144k16 (bf16 in, f32 accumulate; bf16 products
// are exact in f32), so channels are the instruction's M and frames its N:
//
// * A thread's accumulators are 2 channels (rows g and g + 8 of its warp's
//   16) x 36 frames. The epilogue (bias, leaky ReLU, folded batch norm, the
//   S speakers' weighted sums) therefore sums over frames inside the thread:
//   2 x S x 2 running sums a thread (16 at S = 4), merged once per (stream,
//   channel) over the 4 lanes of a quad with two shuffles in a fixed order.
//   Nothing is merged per frame tile, and there are no atomics: the same
//   inputs give the same bits, whatever the launch plan.
// * A block is two warpgroups of 64 channels (128 channels). Its W tile
//   (all of Cin, 128 KB at Cin = 512) is copied into shared memory once, as
//   it lies in memory (channels contiguous: A is M-major, `wgmma`'s
//   transpose flag), and stays there while the block walks its streams.
// * X arrives in 64-deep k slices of 144 frames (K-major, as it lies in
//   memory) through a 4-stage `cp.async` ring, two slices ahead of the
//   products, with two `wgmma` groups in flight; both operands sit in the
//   128-byte-swizzled layout the instruction reads. Frames past T are
//   zero-filled and weigh 0 (T = 279 computes 288 frames).
// * The launch plan (`per`, the streams a block walks) is the wrapper's: a
//   persistent grid of about one block a multiprocessor, each walking
//   several streams of one channel tile so that W is copied once a block
//   (it measured faster than one stream a block). The route and the shared
//   memory are this file's (`linear_stats_wgmma_smem`).
// * What holds it (clock counters and stripped builds in development): the
//   X copies. Each of the 12 channel tiles reads X again from L2, every
//   thread issues its share by `cp.async`, and the epilogue does not overlap
//   the next tile's products. TMA copies (as `attn_stats.cu` does for its
//   hidden slices) and a cluster that multicasts X to several channel tiles
//   are the next steps.
//
// `linear_stats_wgmma_tf32` (f32 X, Cin % 8 == 0 — the f32 policy's path)
// keeps that design on the TF32 tensor cores at f32 accuracy (3xTF32: each
// operand split into hi = rna_tf32(v) and lo = rna_tf32(v - hi), each k8
// step accumulating lo.hi + hi.lo + hi.hi, `wgmma` m64n144k8 .tf32), so
// the frame sums stay in the thread and the result stays independent of the
// launch plan. The bound: 3 x 27.4 GFLOP of TF32 at 495 TFLOP/s, 0.166 ms,
// against 0.41 ms as f32 FMAs.
//
// * A `wgmma` reads a .tf32 operand from shared memory only K-major, and an
//   f32 W tile split in hi and lo (512 KB for 128 channels at Cin = 512)
//   cannot stay resident. So W^T's hi and lo come from registers: the
//   wrapper prepares them once per model in the A-fragment order, and each
//   thread loads its 8 floats a k8 step straight from memory (L2) at the
//   start of a slice, under the previous slice's products. Shared memory
//   holds only X.
// * X stays the B operand (frames, K-major as it lies in memory), so its lo
//   half has to be in shared memory: X arrives raw by `cp.async` in 32-deep
//   k slices of 144 frames (128-byte rows, swizzled) through a 5-stage ring,
//   and each thread splits the chunks it copied into hi (in place) and lo
//   (beside it) one slice ahead of the products. Swapping the roles (frames
//   as M, X split in registers) would spread a channel's frames over the
//   rows of the warpgroups and cost a reduction across lanes and warps a
//   tile, where this layout sums them in the thread.
// * The A fragments of two slices live in registers at once (a `wgmma`
//   reads its A registers while it runs).
//
// `linear_stats_fma` (a width neither tensor-core kernel takes: Cin % 8 !=
// 0, or bf16 whose W tile does not fit): 64 frames x 64 channels a tile
// with plain f32 FMAs — 256 threads each own 4 frames x 4 channels — and
// the partial sums of a channel combined at the end in a fixed order
// (shared memory). In all three, padded channels are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CT = 64;   // channels per block
constexpr int TT = 64;   // frames per tile
constexpr int KC = 32;   // Cin chunk staged per pass
constexpr int NT = 256;  // threads
constexpr int GROUPS = TT / 4;  // frame groups (threads per channel group)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int S>
__global__ void __launch_bounds__(NT) linear_stats_fma(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const float* __restrict__ wt, float* __restrict__ s1, float* __restrict__ s2, int time,
    int cin, int channels, int ldw, float slope) {
  __shared__ float xs[TT][KC + 1];
  __shared__ __align__(16) float ws[KC][CT];
  __shared__ float wts[S][TT];
  __shared__ float red[GROUPS][CT];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  const int tid = threadIdx.x;
  const int tx = tid % (CT / 4);  // channel group: channels tx*4 .. tx*4+3
  const int ty = tid / (CT / 4);  // frame group: frames ty*4 .. ty*4+3

  float bq[4], aq[4], cq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + tx * 4 + q;
    const bool ok = c < channels;
    bq[q] = ok ? bias[c] : 0.0f;
    aq[q] = ok ? scale[c] : 0.0f;
    cq[q] = ok ? shift[c] : 0.0f;
  }
  float p1[S][4], p2[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) p1[s][q] = p2[s][q] = 0.0f;

  const T* xb = x + (size_t)b * time * cin;
  const float* wtb = wt + (size_t)b * S * time;

  for (int t0 = 0; t0 < time; t0 += TT) {
    for (int e = tid; e < S * TT; e += NT) {
      const int s = e / TT, t = e % TT;
      wts[s][t] = (t0 + t < time) ? wtb[(size_t)s * time + t0 + t] : 0.0f;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

    for (int k0 = 0; k0 < cin; k0 += KC) {
#pragma unroll
      for (int r = 0; r < TT * KC / NT; ++r) {
        const int e = tid + r * NT;
        const int t = e / KC, k = e % KC;
        const bool ok = (t0 + t < time) && (k0 + k < cin);
        xs[t][k] = ok ? to_f(xb[(size_t)(t0 + t) * cin + k0 + k]) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < KC * CT / NT; ++r) {
        const int e = tid + r * NT;
        const int k = e / CT, c = e % CT;
        const bool ok = (k0 + k < cin) && (c0 + c < channels);
        ws[k][c] = ok ? to_f(w[(size_t)(k0 + k) * ldw + c0 + c]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
        const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[ty * 4 + i][k];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(xv, wq[q], acc[i][q]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty * 4 + i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float y = acc[i][q] + bq[q];
        y = y >= 0.0f ? y : slope * y;
        const float z = y * aq[q] + cq[q];
        const float zz = z * z;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float wv = wts[s][t];
          p1[s][q] = fmaf(wv, z, p1[s][q]);
          p2[s][q] = fmaf(wv, zz, p2[s][q]);
        }
      }
    }
    __syncthreads();  // wts is rewritten by the next tile
  }

  // Sum the GROUPS frame groups of each channel in a fixed order.
#pragma unroll
  for (int m = 0; m < 2 * S; ++m) {
    const int s = m >> 1;
#pragma unroll
    for (int q = 0; q < 4; ++q) red[ty][tx * 4 + q] = (m & 1) ? p2[s][q] : p1[s][q];
    __syncthreads();
    if (tid < CT && c0 + tid < channels) {
      float sum = 0.0f;
      for (int g = 0; g < GROUPS; ++g) sum += red[g][tid];
      float* dst = (m & 1) ? s2 : s1;
      dst[((size_t)b * S + s) * channels + c0 + tid] = sum;
    }
    __syncthreads();
  }
}

template <typename T, int S>
int launch_fma(const void* x, const void* w, const float* bias, const float* scale,
               const float* shift, const float* wt, float* s1, float* s2, int batch, int time,
               int cin, int channels, int ldw, float slope, cudaStream_t stream) {
  const dim3 grid((channels + CT - 1) / CT, batch);
  linear_stats_fma<T, S><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                  bias, scale, shift, wt, s1, s2, time, cin,
                                                  channels, ldw, slope);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------- //
// Tensor-core kernel (bf16)

constexpr int LC = 128;              // channels a block: two warpgroups of 64
constexpr int LN = 144;              // frames a tile: the wgmma N
constexpr int LK = 64;               // k slice: 128 bytes of bf16
constexpr int LST = 4;               // X ring depth
constexpr int LNT = 256;             // threads
constexpr int LX_BYTES = LN * 128;   // one X slice, 144 rows of 128 bytes
constexpr int LWT = (8 * LN + LNT - 1) / LNT;  // weights a thread prefetches (S <= 8)
constexpr size_t kMaxSmem = 232448;  // 227 KB, the per-block opt-in limit

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// W (all of Cin, 128 channels), the X ring and one tile's weights
__host__ __device__ constexpr size_t wgmma_smem_bytes(int cin, int speakers) {
  return 1024 + (size_t)2 * round_up(cin, LK) * 128 + (size_t)LST * LX_BYTES +
         sizeof(float) * speakers * LN;
}

// d (64 x 144, f32) += A (64 x 16, M-major) @ B (16 x 144, K-major)
__device__ __forceinline__ void wgmma_m64n144k16(float (&d)[18][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, %72, %73, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3])
      : "l"(da), "l"(db));
}

// The tensor-core kernels' epilogue of a frame tile: acc[j][h] -> channel
// row g, acc[j][2 + h] -> g + 8 (bq/aq/sq: their bias and affine), frame 8 j
// + 2 tig + h of the tile; wts [S][LN] the tile's speaker weights. Adds
// each frame's weighted z and z^2 to the thread's running sums.
template <int S>
__device__ __forceinline__ void tile_sums(const float (&acc)[18][4], const float* wts,
                                          const float (&bq)[2], const float (&aq)[2],
                                          const float (&sq)[2], float slope, int tig,
                                          float (&p1)[2][S], float (&p2)[2][S]) {
#pragma unroll
  for (int j = 0; j < 18; ++j) {
    float wv[S][2];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float2 v = *reinterpret_cast<const float2*>(&wts[s * LN + 8 * j + 2 * tig]);
      wv[s][0] = v.x;
      wv[s][1] = v.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1, h = i & 1;
      float y = acc[j][i] + bq[r];
      y = y >= 0.0f ? y : slope * y;
      const float z = y * aq[r] + sq[r];
      const float zz = z * z;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        p1[r][s] = fmaf(wv[s][h], z, p1[r][s]);
        p2[r][s] = fmaf(wv[s][h], zz, p2[r][s]);
      }
    }
  }
}

// The stream is done: sum the quad's four lanes (fixed order), store the
// rows cr and cr + 8 at ob, and reset the sums.
template <int S>
__device__ __forceinline__ void store_stream(float (&p1)[2][S], float (&p2)[2][S],
                                             float* __restrict__ s1, float* __restrict__ s2,
                                             size_t ob, int cr, int channels, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float v1 = p1[r][s], v2 = p2[r][s];
      v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
      v2 += __shfl_xor_sync(0xffffffffu, v2, 1);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
      v2 += __shfl_xor_sync(0xffffffffu, v2, 2);
      const int c = cr + 8 * r;
      if (tig == 0 && c < channels) {
        s1[ob + (size_t)s * channels + c] = v1;
        s2[ob + (size_t)s * channels + c] = v2;
      }
      p1[r][s] = p2[r][s] = 0.0f;
    }
  }
}

// x: (B, T, Cin) bf16, Cin % 8 == 0; w: (Cin, ldw) bf16, ldw % 8 == 0, zero
// beyond C. Block (blockIdx.x, blockIdx.y): channels blockIdx.x * 128 ..,
// streams blockIdx.y * per .. (at most per of them).
template <int S>
__global__ void __launch_bounds__(LNT, 1) linear_stats_wgmma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ wt, float* __restrict__ s1,
    float* __restrict__ s2, int batch, int time, int cin, int channels, int ldw, int per,
    float slope) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* tiles = smem_raw + (base - smem_u32(smem_raw));
  const int nk = (cin + LK - 1) / LK;
  const int panel = nk * LK * 128;  // one warpgroup's 64 channels of W, k rows of 128 bytes
  unsigned char* ws = tiles;                      // [2 panels][cin_pad][128 B]
  unsigned char* xs = tiles + 2 * panel;          // [LST][LN][128 B]
  float* wts = reinterpret_cast<float*>(xs + LST * LX_BYTES);  // [S][LN]

  const int c0 = blockIdx.x * LC;
  const int b0 = blockIdx.y * per;
  const int nb = min(per, batch - b0);
  const int ntiles = (time + LN - 1) / LN;
  const int nq = nb * ntiles * nk;  // X slices the block walks: stream, frame tile, k slice
  const int tid = threadIdx.x;
  const int lane = tid & 31, wgrp = tid >> 7;
  const int g = lane >> 2, tig = lane & 3;
  // this thread's channels: rows g and g + 8 of its warp's 16 in its warpgroup's 64
  const int cr = c0 + wgrp * 64 + ((tid >> 5) & 3) * 16 + g;

  // W: cin_pad k rows x 16 chunks of 8 channels, two 64-channel panels
  for (int e = tid; e < nk * LK * 16; e += LNT) {
    const int k = e >> 4, cn = e & 15;
    const bool ok = k < cin && c0 + cn * 8 < ldw;
    cp_async16(ws + (cn >> 3) * panel + swizzle128(k, cn & 7),
               w + (size_t)(ok ? k : 0) * ldw + (ok ? c0 + cn * 8 : 0), ok ? 16 : 0);
  }
  auto load = [&](int q) {  // X slice q into stage q % LST
    const int gt = q / nk, k0 = (q % nk) * LK;
    const int t0 = (gt % ntiles) * LN;
    const __nv_bfloat16* xb = x + (size_t)(b0 + gt / ntiles) * time * cin;
    unsigned char* xd = xs + (q % LST) * LX_BYTES;
    for (int e = tid; e < LN * 8; e += LNT) {
      const int r = e >> 3, c = e & 7;
      const bool ok = t0 + r < time && k0 + c * 8 < cin;
      cp_async16(xd + swizzle128(r, c), xb + (ok ? (size_t)(t0 + r) * cin + k0 + c * 8 : 0),
                 ok ? 16 : 0);
    }
  };
  load(0);
  cp_async_commit();  // W and slice 0
  if (1 < nq) load(1);
  cp_async_commit();

  float bq[2], aq[2], sq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = cr + 8 * r;
    const bool ok = c < channels;
    bq[r] = ok ? bias[c] : 0.0f;
    aq[r] = ok ? scale[c] : 0.0f;
    sq[r] = ok ? shift[c] : 0.0f;
  }
  float p1[2][S], p2[2][S];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int s = 0; s < S; ++s) p1[r][s] = p2[r][s] = 0.0f;
  float acc[18][4];
  float wpre[LWT];

  for (int gt = 0, q = 0; gt < nb * ntiles; ++gt) {  // frame tile gt of the block's walk
    const int bi = gt / ntiles, tile = gt % ntiles;
#pragma unroll
    for (int j = 0; j < 18; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    // this tile's speaker weights, in registers until the epilogue
    const float* wtb = wt + (size_t)(b0 + bi) * S * time;
#pragma unroll
    for (int r = 0; r < LWT; ++r) {
      const int e = tid + r * LNT, s = e / LN, t = tile * LN + e % LN;
      wpre[r] = (s < S && t < time) ? wtb[(size_t)s * time + t] : 0.0f;
    }
    for (int kb = 0; kb < nk; ++kb, ++q) {
      cp_async_wait<1>();  // slice q has landed (only slice q + 1 may be in flight)
      fence_async_shared();
      __syncthreads();  // ... for every thread; and every warpgroup is done with slice q - 2
      if (q + 2 < nq) load(q + 2);
      cp_async_commit();
      const unsigned wa = base + wgrp * panel + kb * LK * 128;
      const unsigned xa = base + 2 * panel + (q % LST) * LX_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < LK / 16; ++ks)
        wgmma_m64n144k16(acc, wgmma_desc(wa + ks * 16 * 128, panel, 1024),
                         wgmma_desc(xa + ks * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // slice q - 1 is consumed; slice q runs on
    }
    wgmma_wait<0>();

    // epilogue of the tile
#pragma unroll
    for (int r = 0; r < LWT; ++r) {
      const int e = tid + r * LNT;
      if (e < S * LN) wts[e] = wpre[r];
    }
    __syncthreads();
    tile_sums<S>(acc, wts, bq, aq, sq, slope, tig, p1, p2);
    if (tile == ntiles - 1) store_stream<S>(p1, p2, s1, s2, (size_t)(b0 + bi) * S * channels, cr, channels, tig);
  }
  cp_async_wait<0>();
}

// --------------------------------------------------------------------- //
// Tensor-core kernel, f32 (3xTF32)

constexpr int LTK = 32;               // k slice: 32 f32 = 128 bytes
constexpr int LTST = 5;               // X ring depth
constexpr int LT_X_BYTES = LN * 128;  // one X slice, hi or lo: 144 rows of 128 bytes

// the X ring (hi and lo halves) and one tile's weights
__host__ __device__ constexpr size_t tf32_smem_bytes(int speakers) {
  return 1024 + (size_t)LTST * 2 * LT_X_BYTES + sizeof(float) * speakers * LN;
}
static_assert(tf32_smem_bytes(8) <= kMaxSmem, "the widest block (S = 8) must fit 227 KB");

// x: (B, T, Cin) f32, Cin % 8 == 0; wf: W^T split into TF32 hi and lo in
// the A-fragment order of `wgmma` (`prepare_stats_operands`): for channel
// tile ct, k8 step k, warp w (rows ct * 128 + 16 w + g and + 8) and lane
// (g, tig), 8 floats: hi of (g, tig), (g + 8, tig), (g, tig + 4), (g + 8,
// tig + 4) of the step, then lo of the same; channels past C hold zeros.
// Blocks as `linear_stats_wgmma`.
template <int S>
__global__ void __launch_bounds__(LNT, 1) linear_stats_wgmma_tf32(
    const float* __restrict__ x, const float* __restrict__ wf, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const float* __restrict__ wt, float* __restrict__ s1, float* __restrict__ s2, int batch,
    int time, int cin, int channels, int per, float slope) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* tiles = smem_raw + (base - smem_u32(smem_raw));
  float* wts = reinterpret_cast<float*>(tiles + LTST * 2 * LT_X_BYTES);  // [S][LN]

  const int nk8 = cin / 8, nk = (cin + LTK - 1) / LTK;
  const int c0 = blockIdx.x * LC;
  const int b0 = blockIdx.y * per;
  const int nb = min(per, batch - b0);
  const int ntiles = (time + LN - 1) / LN;
  const int nq = nb * ntiles * nk;  // X slices the block walks: stream, frame tile, k slice
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, wgrp = tid >> 7;
  const int tig = lane & 3;
  const int cr = c0 + wgrp * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  // this thread's 8 floats of each k8 step: two float4s, 512 float4s a step apart
  const float4* wfb = reinterpret_cast<const float4*>(wf) + ((size_t)blockIdx.x * nk8 * 8 + warp) * 64 + lane * 2;

  auto load_a = [&](int q, unsigned (&ah)[LTK / 8][4], unsigned (&al)[LTK / 8][4]) {
    const int k8 = (q % nk) * (LTK / 8);
#pragma unroll
    for (int ks = 0; ks < LTK / 8; ++ks) {
      const bool ok = k8 + ks < nk8;  // a partial last slice: zeros
      const float4 h = ok ? wfb[(size_t)(k8 + ks) * 512] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 l = ok ? wfb[(size_t)(k8 + ks) * 512 + 1] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      ah[ks][0] = __float_as_uint(h.x), ah[ks][1] = __float_as_uint(h.y);
      ah[ks][2] = __float_as_uint(h.z), ah[ks][3] = __float_as_uint(h.w);
      al[ks][0] = __float_as_uint(l.x), al[ks][1] = __float_as_uint(l.y);
      al[ks][2] = __float_as_uint(l.z), al[ks][3] = __float_as_uint(l.w);
    }
  };
  auto load_x = [&](int q) {  // X slice q, raw, into the hi half of stage q % LTST
    const int gt = q / nk, k0 = (q % nk) * LTK;
    const int t0 = (gt % ntiles) * LN;
    const float* xb = x + (size_t)(b0 + gt / ntiles) * time * cin;
    unsigned char* xd = tiles + (q % LTST) * 2 * LT_X_BYTES;
    for (int e = tid; e < LN * 8; e += LNT) {
      const int r = e >> 3, c = e & 7;
      const bool ok = t0 + r < time && k0 + c * 4 < cin;
      cp_async16(xd + swizzle128(r, c), xb + (ok ? (size_t)(t0 + r) * cin + k0 + c * 4 : 0),
                 ok ? 16 : 0);
    }
  };
  auto split = [&](int q) {  // the chunks of slice q that this thread copied: hi in place, lo beside
    float4* hi = reinterpret_cast<float4*>(tiles + (q % LTST) * 2 * LT_X_BYTES);
    float4* lo = hi + LT_X_BYTES / 16;
    for (int e = tid; e < LN * 8; e += LNT) {
      const int at = swizzle128(e >> 3, e & 7) >> 4;
      const float4 v = hi[at];
      const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
      hi[at] = h;
      lo[at] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y), tf32_rna(v.z - h.z),
                           tf32_rna(v.w - h.w));
    }
  };

  float bq[2], aq[2], sq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = cr + 8 * r;
    const bool ok = c < channels;
    bq[r] = ok ? bias[c] : 0.0f;
    aq[r] = ok ? scale[c] : 0.0f;
    sq[r] = ok ? shift[c] : 0.0f;
  }
  float p1[2][S], p2[2][S];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int s = 0; s < S; ++s) p1[r][s] = p2[r][s] = 0.0f;
  float acc[18][4];
  float wpre[LWT];
  // two register sets of A fragments, taken in turns by a frame tile's k
  // slices (a wgmma reads its A registers while it runs)
  unsigned ah0[LTK / 8][4], al0[LTK / 8][4], ah1[LTK / 8][4], al1[LTK / 8][4];

#pragma unroll
  for (int s = 0; s < LTST - 1; ++s) {
    if (s < nq) load_x(s);
    cp_async_commit();
  }
  cp_async_wait<LTST - 2>();  // slice 0 (this thread's copies)
  split(0);
  fence_async_shared();  // the split, for the tensor cores
  __syncthreads();

  // slice q of the walk (stream, frame tile, k slice): its A fragments into
  // ah/al (the last products to read them, two slices back or the previous
  // tile's, are done; the loads' latency hides under slice q - 1's
  // products), its products, then, under them, slice q + 1's split and the
  // copy of slice q + LTST - 1
  auto slice = [&](int q, unsigned (&ah)[LTK / 8][4], unsigned (&al)[LTK / 8][4]) {
    load_a(q, ah, al);
    const unsigned xh = base + (q % LTST) * 2 * LT_X_BYTES, xl = xh + LT_X_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < LTK / 8; ++ks) {  // the small terms first, then hi . hi
      wgmma_m64n144k8_tf32(acc, al[ks], wgmma_desc(xh + ks * 32, 16, 1024));
      wgmma_m64n144k8_tf32(acc, ah[ks], wgmma_desc(xl + ks * 32, 16, 1024));
      wgmma_m64n144k8_tf32(acc, ah[ks], wgmma_desc(xh + ks * 32, 16, 1024));
    }
    wgmma_commit();
    if (q + 1 < nq) {
      cp_async_wait<LTST - 3>();  // slice q + 1 (this thread's copies) has landed
      split(q + 1);
    }
    fence_async_shared();
    wgmma_wait<1>();  // slice q - 1 is done
    __syncthreads();  // slice q + 1 is split in every thread; both warpgroups are done with q - 1
    if (q + LTST - 1 < nq) load_x(q + LTST - 1);  // into slice q - 1's stage
    cp_async_commit();
  };

  for (int gt = 0; gt < nb * ntiles; ++gt) {  // frame tile gt of the block's walk
    const int bi = gt / ntiles, tile = gt % ntiles;
#pragma unroll
    for (int j = 0; j < 18; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    const float* wtb = wt + (size_t)(b0 + bi) * S * time;
#pragma unroll
    for (int r = 0; r < LWT; ++r) {  // this tile's speaker weights, in registers until the epilogue
      const int e = tid + r * LNT, s = e / LN, t = tile * LN + e % LN;
      wpre[r] = (s < S && t < time) ? wtb[(size_t)s * time + t] : 0.0f;
    }
    for (int kb = 0; kb < nk; kb += 2) {
      slice(gt * nk + kb, ah0, al0);
      if (kb + 1 < nk) slice(gt * nk + kb + 1, ah1, al1);
    }
    wgmma_wait<0>();

    // epilogue of the tile
#pragma unroll
    for (int r = 0; r < LWT; ++r) {
      const int e = tid + r * LNT;
      if (e < S * LN) wts[e] = wpre[r];
    }
    __syncthreads();
    tile_sums<S>(acc, wts, bq, aq, sq, slope, tig, p1, p2);
    if (tile == ntiles - 1) store_stream<S>(p1, p2, s1, s2, (size_t)(b0 + bi) * S * channels, cr, channels, tig);
  }
  cp_async_wait<0>();
}

// The route of a call (the wrapper's `launch_plan` reports it): 1 = bf16 on
// the tensor cores (Cin % 8 == 0, W resident, its tiles fit), 2 = f32 on the
// TF32 tensor cores (Cin % 8 == 0), 0 = the FMA kernel (every other call).
int route_of(int cin, int ldw, int speakers, int dtype) {
  if (cin % 8 != 0) return 0;
  if (dtype == 0) return 2;
  return ldw % 8 == 0 && wgmma_smem_bytes(cin, speakers) <= kMaxSmem ? 1 : 0;
}

// --------------------------------------------------------------------- //
template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int S>
int launch_s(const void* x, const void* w, const float* wf, const float* bias, const float* scale,
             const float* shift, const float* wt, float* s1, float* s2, int batch, int time,
             int cin, int channels, int ldw, int per, float slope, cudaStream_t stream) {
  const int route = route_of(cin, ldw, S, sizeof(T) == 2 ? 1 : 0);
  const dim3 grid((channels + LC - 1) / LC, (batch + per - 1) / per);
  if constexpr (sizeof(T) == 2) {
    if (route == 1) {
      const size_t smem = wgmma_smem_bytes(cin, S);
      if (const int err = set_smem(linear_stats_wgmma<S>, smem)) return err;
      linear_stats_wgmma<S><<<grid, LNT, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bias,
          scale, shift, wt, s1, s2, batch, time, cin, channels, ldw, per, slope);
      return (int)cudaGetLastError();
    }
  } else {
    if (route == 2) {
      const size_t smem = tf32_smem_bytes(S);
      if (const int err = set_smem(linear_stats_wgmma_tf32<S>, smem)) return err;
      linear_stats_wgmma_tf32<S><<<grid, LNT, smem, stream>>>(
          static_cast<const float*>(x), wf, bias, scale, shift, wt, s1, s2, batch, time, cin,
          channels, per, slope);
      return (int)cudaGetLastError();
    }
  }
  return launch_fma<T, S>(x, w, bias, scale, shift, wt, s1, s2, batch, time, cin, channels, ldw,
                          slope, stream);
}

template <typename T>
int launch(const void* x, const void* w, const float* wf, const float* bias, const float* scale,
           const float* shift, const float* wt, float* s1, float* s2, int batch, int time,
           int cin, int channels, int ldw, int speakers, int per, float slope,
           cudaStream_t stream) {
#define DIART_STATS_CASE(S_)                                                                 \
  case S_:                                                                                  \
    return launch_s<T, S_>(x, w, wf, bias, scale, shift, wt, s1, s2, batch, time, cin,       \
                           channels, ldw, per, slope, stream);
  switch (speakers) {
    DIART_STATS_CASE(1)
    DIART_STATS_CASE(2)
    DIART_STATS_CASE(3)
    DIART_STATS_CASE(4)
    DIART_STATS_CASE(5)
    DIART_STATS_CASE(6)
    DIART_STATS_CASE(7)
    DIART_STATS_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DIART_STATS_CASE
}

}  // namespace

// dtype of x and w: 0 = float32, 1 = bfloat16. w: (Cin, ldw) row-major with
// ldw >= C; wf: f32 with Cin % 8 == 0 only (else unread), W^T split in the
// A-fragment order above (`prepare_stats_operands`). bias/scale/shift: (C,)
// f32; wt: (B, S, T) f32; s1, s2: (B, S, C) f32. per: streams a block walks
// on the tensor-core routes (the launch plan's; the FMA route takes one).
// Returns the launch's cudaError_t.
extern "C" int linear_stats_launch(const void* x, const void* w, const void* wf, const void* bias,
                                   const void* scale, const void* shift, const void* wt,
                                   void* s1, void* s2, int batch, int time, int cin,
                                   int channels, int ldw, int speakers, int dtype, float slope,
                                   int per, void* stream) {
  if (batch < 1 || time < 1 || cin < 1 || channels < 1 || ldw < channels || batch > 65535 ||
      per < 1 || (route_of(cin, ldw, 1, dtype) == 2 && wf == nullptr))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o1 = static_cast<float*>(s1);
  float* o2 = static_cast<float*>(s2);
  if (dtype == 0)
    return launch<float>(x, w, f(wf), f(bias), f(scale), f(shift), f(wt), o1, o2, batch, time,
                         cin, channels, ldw, speakers, per, slope, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, f(wf), f(bias), f(scale), f(shift), f(wt), o1, o2, batch,
                                 time, cin, channels, ldw, speakers, per, slope, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of a tensor-core launch (either route), or 0 where the call
// takes the FMA route.
extern "C" long long linear_stats_wgmma_smem(int cin, int ldw, int speakers, int dtype) {
  switch (route_of(cin, ldw, speakers, dtype)) {
    case 1: return (long long)wgmma_smem_bytes(cin, speakers);
    case 2: return (long long)tf32_smem_bytes(speakers);
    default: return 0;
  }
}

extern "C" const char* linear_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
