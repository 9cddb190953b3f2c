// Dynamic int8 convolution (per-sample activation scales, per-output-channel
// weight scales, s8 x s8 -> s32 on the tensor cores), for Hopper.
//
// Replaces the XLA integer convolution of diart_tpu/ops/quant.py
// (`_int8_conv_forward`: `lax.conv_general_dilated` on int8 operands with
// `preferred_element_type=int32`), which is not a Pallas kernel. Same
// function, in the same f32 arithmetic:
//
//   s_x[b]   = max(max |x[b]|, 1e-12) / 127           quantize_rows
//   q_x      = clip(rint(x / s_x[b]), -127, 127)      (rint: half to even,
//                                                      as jnp.round)
//   acc      = conv(q_x, q_w)                          int32, exact
//   y        = out_dtype(float(acc) * (s_x[b] * s_w[c]))   then + bias in
//                                                      out_dtype
//
// The weights' q_w and s_w are made once per model by the wrapper (plain
// PyTorch) and held, as XLA folds them at trace time. Every multiply, divide
// and add of the epilogue and the quantizer is an `_rn` intrinsic, so the
// compiler contracts none of them into an FMA: the bits are the plain
// version's. The build has no --use_fast_math.
//
// What bounds it on the H100: at the quantizable sites of the five embedding
// families at B = 64 the products are 2-200 GOP and the activations 10-330
// MB (f32 or bf16 in, int8 staging, the output), so most sites sit near the
// ridge: 1,979 TOP/s of dense int8 against 3.35 TB/s is ~590 operations a
// byte. The 3x3 ResNet convolutions and TitaNet's 1024-wide pointwise ones
// are bound by operations, the x-vector's TDNN 0 and the ECAPA stem by bytes.
//
// What this design does about it:
//
// * The quantizer, two passes over the input (a sample's scale needs all of
//   the sample before any value is rounded). `absmax_rows`: 8192 elements
//   a block, read flat in 16-byte pieces where the sample is one dense,
//   aligned block; a sample's blocks merged with atomicMax on the float
//   bits (max is exact in any order). It is not folded into the producing
//   op: on every int8 route the convolution's input comes from PyTorch's
//   own kernels (a batch norm, a ReLU, a residual add, a concatenation),
//   never from one of these. `quantize_rows`: one block a tile of 64
//   positions x 32 channels, read in pieces of up to 16 bytes along
//   whichever input axis is contiguous (as wide as the strides and the
//   base address allow), transposed through shared memory where positions
//   are contiguous, written channels-last (B, S, C_pad) in 16-byte pieces,
//   channels C .. C_pad - 1 as zeros. It rounds v * (1 / s_x) and divides
//   only within 1e-4 of a tie (`quantize`): the same integers as the
//   division, at a fraction of its instructions.
// * `int8_conv_wgmma`: implicit GEMM on `wgmma.mma_async` m64nNk32 s8 x s8
//   -> s32, fed by TMA, one persistent block an SM. M = output channels, N =
//   output positions of one sample (a tile never crosses a sample), K = one
//   window tap (k1, k2) x a slice of BK (32, 64 or 128) input channels: the
//   reduction is laid out as taps x C_pad (C_in rounded up to 32 and
//   zero-filled, in q_w and q_x alike), so every K slice of either operand
//   is one dense TMA box whose swizzle (32, 64 or 128 bytes) is its row.
//   `wgmma` takes 8-bit operands K-major only: q_w (C_out, taps x C_pad) is,
//   and so is the channels-last q_x, one tap at a time. The activation box
//   of tap (i, j) of an output tile starts at o * stride + tap * dilation -
//   padding on each spatial axis: the tensor map's element strides give the
//   convolution's stride and its out-of-bounds zero fill the padding, so no
//   unfolded or padded copy of the input is written (each tap re-reads its
//   box from L2: the 3x3 convolutions are bound by that, not by the tensor
//   cores). The tensor maps are encoded on the host at each call
//   (`cuTensorMapEncodeTiled` through the runtime's entry-point query: no
//   -lcuda) and passed as `__grid_constant__` parameters.
//   A block is 9 warps: one producer warp whose lane 0 keeps a ring of
//   stages (as many as fit in 200 KB, at most 8) of TMA loads in flight on
//   `mbarrier`s, and two consumer warpgroups that hold the s32 sums in
//   registers. Output channels > 64: the warpgroups split a 128 x N tile by
//   rows; <= 64 (ResNet34's first stages): a 64 x 2N tile by positions. The
//   block walks tiles (M tile fastest, then position tile, then sample), so
//   the producer loads the next tile while the consumers run the epilogue
//   of this one. N (80, 128 or 160 a warpgroup) and the box of positions it
//   covers (O1 rows x O2 columns; the whole O2 axis where it divides N) are
//   chosen by the wrapper from the geometry (`ops/quant.py` `conv_plan`).
//   The epilogue keeps every multiply and add an `_rn` intrinsic and writes
//   channels-first (B, C_out, O1[, O2]): where the tile's positions are
//   contiguous in the output, each warp stages 16 rows x 16 positions in
//   shared memory and writes them back as row segments (scattered 8-row
//   stores from the accumulator fragments took most of the kernel's time).
//   An int32 output (`out_dtype` 2) writes the raw sums, which the checks
//   hold bitwise against the plain version's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int QT = 256;       // quantizer threads
constexpr int QCHUNK = 8192;  // elements of a sample a max block reads
constexpr int QS = 64;        // quantize tile: positions
constexpr int QC = 32;        // quantize tile: channels
constexpr int QROW = QS + 16;  // the tile's shared row stride in bytes (a channel's positions)

constexpr int CONSUMER_WARPS = 8;                 // two warpgroups
constexpr int CONV_THREADS = 32 * CONSUMER_WARPS + 32;  // + the producer warp
constexpr int MAX_STAGES = 8;
constexpr int RING_BYTES = 200 * 1024;            // the ring's shared memory budget
// the epilogue's staging: a warp's 16 rows x 16 positions (+ 8 of padding:
// the fragments' stores then hit 32 distinct banks) of the output type
constexpr int EPI_COLS = 16, EPI_ROW = EPI_COLS + 8;
constexpr int EPI_BYTES = CONSUMER_WARPS * 16 * EPI_ROW * 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void set_zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) { v = __float2bfloat16_rn(0.0f); }

// E consecutive elements, loaded as one piece of E * sizeof(T) bytes
template <typename T, int E>
struct alignas(E * sizeof(T)) Piece {
  T v[E];
};

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Pass 1: |x|'s largest value of each sample, as the bits of a
// non-negative float (their unsigned order is the floats' order), merged
// over the blocks of a sample with atomicMax. x element (b, c, s) at
// b * sb + c * sc + s * ss. E > 1: the sample's C * S elements are one dense
// block (channels-first or channels-last) whose start is aligned to E
// elements, read flat in pieces of E; E == 1: element by element.
template <typename T, int E>
__global__ void __launch_bounds__(QT) absmax_rows(const T* __restrict__ x, unsigned* __restrict__ amax,
                                                  int C, int S, long long sb, long long sc,
                                                  long long ss) {
  __shared__ float red[QT / 32];
  const int b = blockIdx.y;
  const T* xb = x + (long long)b * sb;
  const int n = C * S;
  const int start = blockIdx.x * QCHUNK, stop = min(start + QCHUNK, n);
  float m = 0.0f;
  if (E > 1) {
    for (int e = start + threadIdx.x * E; e < stop; e += QT * E) {
      if (e + E <= stop) {
        const Piece<T, E> p = *reinterpret_cast<const Piece<T, E>*>(xb + e);
#pragma unroll
        for (int i = 0; i < E; ++i) m = fmaxf(m, fabsf(to_f(p.v[i])));
      } else {
        for (int i = e; i < stop; ++i) m = fmaxf(m, fabsf(to_f(xb[i])));
      }
    }
  } else {
    const bool flat = (sc == S && ss == 1) || (sc == 1 && ss == C);
    for (int e = start + threadIdx.x; e < stop; e += QT) {
      long long at = e;
      if (!flat) {
        const int c = e / S, s = e - (e / S) * S;
        at = c * sc + s * ss;
      }
      m = fmaxf(m, fabsf(to_f(xb[at])));
    }
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) atomicMax(amax + b, __float_as_uint(m));
}

// clip(rint(v / sx), -127, 127), bit for bit, without a division for most
// values: y = v * rx (rx = 1 / sx, rounded) lies within 1.9e-5 of the
// rounded quotient (|v / sx| <= 127: both are a few ulps of 2^-17 from the
// exact one), so the two round to the same integer unless a half-integer
// lies within that distance of y; within 1e-4 of one the quotient itself
// is taken (`__fdiv_rn`, the plain version's division)
__device__ __forceinline__ int8_t quantize(float v, float sx, float rx) {
  const float y = __fmul_rn(v, rx);
  float r = rintf(y);
  if (fabsf(y - r) > 0.5f - 1e-4f) r = rintf(__fdiv_rn(v, sx));  // within 1e-4 of a tie
  return (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
}

// Pass 2: one block a (QS positions x QC channels) tile of one sample,
// rounded and clipped to int8 with the sample's scale and written
// channels-last (B, S, C_pad); channels C .. C_pad - 1 are zeros. The input
// is read in pieces of E elements along its contiguous axis, every piece
// start aligned to E elements, and all of a thread's pieces are loaded
// before the scale is computed and any value rounded, so that its loads
// are in flight at once. POS (positions contiguous, ss == 1): a thread
// reads E positions of one channel and puts the E bytes into shared memory
// in the input's orientation (a row a channel; lanes along positions);
// then a thread a (position, 16 channels) gathers that column's 16 bytes
// and writes them as one 16-byte piece of the position's row. Otherwise
// (channels contiguous, sc == 1; or neither, E == 1): a thread reads E
// channels of one position and writes its E bytes straight to the
// position's row. The first tile's block writes the scale. At most 32
// registers a thread, so that eight blocks fit on a multiprocessor.
template <typename T, int E, bool POS>
__global__ void __launch_bounds__(QT, 8) quantize_rows(const T* __restrict__ x,
                                                       const unsigned* __restrict__ amax,
                                                       int8_t* __restrict__ q,
                                                       float* __restrict__ scale, int C, int S,
                                                       int c_pad, long long sb, long long sc,
                                                       long long ss) {
  __shared__ __align__(16) int8_t tile[POS ? QC * QROW : 16];  // POS: [channel][position]
  const int b = blockIdx.z, s0 = blockIdx.x * QS, c0 = blockIdx.y * QC;
  const T* xb = x + (long long)b * sb;
  int8_t* qb = q + (long long)b * S * c_pad;
  constexpr int PIECES = QS * QC / E, MINE = PIECES / QT;
  static_assert(PIECES % QT == 0, "the tile's pieces divide among the threads");
  Piece<T, E> in[MINE];
  int cs[MINE], ts[MINE];
#pragma unroll
  for (int k = 0; k < MINE; ++k) {
    const int g = threadIdx.x + k * QT;
    int cc, tt;
    if (POS) {
      cc = g / (QS / E);
      tt = (g - cc * (QS / E)) * E;
    } else {
      tt = g / (QC / E);
      cc = (g - tt * (QC / E)) * E;
    }
    cs[k] = cc;
    ts[k] = tt;
    const int c = c0 + cc, s = s0 + tt;
    const bool whole = POS ? (c < C && s + E <= S) : (s < S && c + E <= C);
    if (whole) {
      in[k] = *reinterpret_cast<const Piece<T, E>*>(xb + (long long)c * sc + (long long)s * ss);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int ci = POS ? c : c + i, si = POS ? s + i : s;
        if (ci < C && si < S)
          in[k].v[i] = xb[(long long)ci * sc + (long long)si * ss];
        else
          set_zero(in[k].v[i]);
      }
    }
  }
  const float sx = __fdiv_rn(fmaxf(__uint_as_float(amax[b]), 1e-12f), 127.0f);
  const float rx = __frcp_rn(sx);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) scale[b] = sx;
#pragma unroll
  for (int k = 0; k < MINE; ++k) {
    const int cc = cs[k], tt = ts[k], c = c0 + cc, s = s0 + tt;
    Piece<int8_t, E> v;
#pragma unroll
    for (int i = 0; i < E; ++i) v.v[i] = quantize(to_f(in[k].v[i]), sx, rx);  // zeros stay zeros
    if (POS)
      *reinterpret_cast<Piece<int8_t, E>*>(tile + cc * QROW + tt) = v;
    else if (s < S)
      *reinterpret_cast<Piece<int8_t, E>*>(qb + (long long)s * c_pad + c) = v;
  }
  if (!POS) return;
  __syncthreads();
  for (int e = threadIdx.x; e < QS * (QC / 16); e += QT) {
    const int t = e % QS, half = e / QS;
    if (s0 + t >= S) continue;
    Piece<int8_t, 16> row;
#pragma unroll
    for (int i = 0; i < 16; ++i) row.v[i] = tile[(16 * half + i) * QROW + t];
    *reinterpret_cast<Piece<int8_t, 16>*>(qb + (long long)(s0 + t) * c_pad + c0 + 16 * half) = row;
  }
}

// ---------------------------------------------------------------------- //
// the convolution

__device__ __forceinline__ void tma_2d(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                       unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_4d(unsigned dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       int c3, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// (generated: one wrapper a tile width N, accumulators d[N / 8][4])
// d (64 x 80, s32) (+)= A (64 x 32, s8, K-major) . B (80 x 32, s8, K-major)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[10][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]), "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]), "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]), "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 128, s32) (+)= A (64 x 32, s8, K-major) . B (128 x 32, s8, K-major)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[16][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]), "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]), "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]), "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]), "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]), "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]), "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]), "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]), "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]), "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 160, s32) (+)= A (64 x 32, s8, K-major) . B (160 x 32, s8, K-major)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[20][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]), "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]), "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]), "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]), "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]), "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]), "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]), "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]), "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]), "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]), "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]), "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]), "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]), "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the epilogue, in JAX's order: y = float(acc) * (s_x[b] * s_w[c]) rounded to
// the output dtype, then + bias in that dtype (`bias` already rounded to
// it: `bias_in`); int32 output: the raw sums
__device__ __forceinline__ float bias_in(float*, float v) { return v; }
__device__ __forceinline__ float bias_in(__nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bias_in(int*, float) { return 0.0f; }
__device__ __forceinline__ float epilogue(float*, int acc, float s, bool hb, float bias) {
  const float y = __fmul_rn(__int2float_rn(acc), s);
  return hb ? __fadd_rn(y, bias) : y;
}
__device__ __forceinline__ __nv_bfloat16 epilogue(__nv_bfloat16*, int acc, float s, bool hb,
                                                  float bias) {
  const __nv_bfloat16 v = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), s));
  return hb ? __float2bfloat16_rn(__fadd_rn(__bfloat162float(v), bias)) : v;
}
__device__ __forceinline__ int epilogue(int*, int acc, float, bool, float) { return acc; }

// the launch's geometry and tiling (see int8_conv_launch)
struct Plan {
  int batch, M, O1, O2;        // samples, output channels, output positions
  int cpad, bk, slices;        // padded channels, K slice, slices a tap
  int k2, taps;                // window columns, window taps
  int s1, s2, p1, p2, d1, d2;  // stride, padding, dilation
  int box1, box2;              // a warpgroup's positions: box1 rows x box2 columns
  int mt, nt1, nt2, tiles;     // tiles along M, O1, O2; all tiles
  int stages;                  // ring depth
  int has_bias;
};

// q_x through `xmap`: (B, S1, S2, C_pad) int8, boxes (bk, box2, box1, 1)
// with element strides (1, s2, s1, 1); q_w through `wmap`: (C_out, taps x
// C_pad) int8, boxes (bk, 64 MW). out (B, C_out, O1, O2) in OutT.
template <int N, int MW, typename OutT>
__global__ void __launch_bounds__(CONV_THREADS, 1)
    int8_conv_wgmma(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    const float* __restrict__ bias, OutT* __restrict__ out, const Plan p) {
  constexpr int NW = 2 / MW;  // warpgroups along positions
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  const unsigned a_bytes = 64 * MW * p.bk;
  const unsigned b_stride = (N * p.bk + 1023u) & ~1023u;
  const unsigned stage_bytes = a_bytes + NW * b_stride;
  const unsigned epi = base + p.stages * stage_bytes;  // EPI_BYTES of staging
  const unsigned full = epi + EPI_BYTES, empty = full + 8 * p.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nk = p.taps * p.slices;

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      const unsigned tx = a_bytes + NW * N * p.bk;
      int stage = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        int r = t;
        const int m0 = (r % p.mt) * 64 * MW;
        r /= p.mt;
        const int o2 = (r % p.nt2) * p.box2;
        r /= p.nt2;
        const int o1 = (r % p.nt1) * p.box1 * NW;
        const int b = r / p.nt1;
        for (int kk = 0; kk < nk; ++kk) {
          const int tap = kk / p.slices, c0 = (kk - tap * p.slices) * p.bk;
          const int i1 = tap / p.k2, i2 = tap - i1 * p.k2;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, tx);
          const unsigned dst = base + stage * stage_bytes;
          tma_2d(dst, &wmap, tap * p.cpad + c0, m0, full + 8 * stage);
#pragma unroll
          for (int w = 0; w < NW; ++w)
            tma_4d(dst + a_bytes + w * b_stride, &xmap, c0, o2 * p.s2 - p.p2 + i2 * p.d2,
                   (o1 + w * p.box1) * p.s1 - p.p1 + i1 * p.d1, b, full + 8 * stage);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg computes rows wm * 64 .. of the M tile
  // against positions sub-tile wn
  const int wg = warp >> 2, wm = wg % MW, wn = wg / MW;
  const int g = lane >> 2, tig = lane & 3;
  const int nks = p.bk / 32;  // k32 products a slice
  int acc[N / 8][4];
  int stage = 0, last = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int r = t;
    const int m0 = (r % p.mt) * 64 * MW;
    r /= p.mt;
    const int o2 = (r % p.nt2) * p.box2;
    r /= p.nt2;
    const int o1 = (r % p.nt1) * p.box1 * NW + wn * p.box1;
    const int b = r / p.nt1;
    // the epilogue's scales and bias, loaded under the products
    const int co0 = m0 + wm * 64 + (warp & 3) * 16 + g;
    float s[2], bv[2];
    const float s_b = sx[b];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + 8 * h;
      s[h] = co < p.M ? __fmul_rn(s_b, sw[co]) : 0.0f;
      bv[h] = co < p.M && p.has_bias ? bias_in(out, bias[co]) : 0.0f;
    }
    for (int kk = 0; kk < nk; ++kk) {
      mbar_wait(full + 8 * stage, phase);
      const unsigned a = base + stage * stage_bytes + wm * 64 * p.bk;
      const unsigned bt = base + stage * stage_bytes + a_bytes + wn * b_stride;
      wgmma_fence();
      // unrolled, so that the accumulators stay in the same registers from
      // one product to the next (a uniform branch skips past the slice)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < nks)  // K-major tiles of bk-byte rows, swizzled by their row
          wgmma_s8(acc, wgmma_desc(a + 32 * ks, 16, 8 * p.bk, p.bk),
                   wgmma_desc(bt + 32 * ks, 16, 8 * p.bk, p.bk), kk > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: its stage is free
      if (kk > 0 && lane == 0) mbar_arrive(empty + 8 * last);
      last = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * last);

    // accumulator (j, i): row (warp % 4) * 16 + g + 8 (i / 2), column
    // 8 j + 2 tig + i % 2 of the warpgroup's 64 x N tile
    const int npos = p.O1 * p.O2;
    if (p.nt2 == 1 && p.box2 == p.O2) {
      // a box row is a whole output row (1-D, or box2 == O2): the tile's
      // positions are contiguous in the output. Each warp stages its 16
      // rows x 16 positions at a time in shared memory and writes them
      // back a row segment a half-warp, positions across the lanes.
      OutT* st = reinterpret_cast<OutT*>(smem_raw + (epi - raw)) + warp * 16 * EPI_ROW;
      const int pos0 = o1 * p.O2, row0 = co0 - g;
#pragma unroll
      for (int c = 0; c < N / EPI_COLS; ++c) {
#pragma unroll
        for (int jj = 0; jj < EPI_COLS / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              st[(g + 8 * h) * EPI_ROW + 8 * jj + 2 * tig + e] =
                  epilogue(out, acc[c * (EPI_COLS / 8) + jj][2 * h + e], s[h], p.has_bias, bv[h]);
        __syncwarp();
        const int pos = pos0 + c * EPI_COLS + (lane & 15);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int rr = 2 * i + (lane >> 4), co = row0 + rr;
          if (co < p.M && pos < npos)
            out[((long long)b * p.M + co) * npos + pos] = st[rr * EPI_ROW + (lane & 15)];
        }
        __syncwarp();
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + 8 * h;
        if (co >= p.M) continue;
        const long long row = ((long long)b * p.M + co) * npos;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * tig + e;
            const int q1 = o1 + col / p.box2, q2 = o2 + col % p.box2;
            if (q1 < p.O1 && q2 < p.O2)
              out[row + (long long)q1 * p.O2 + q2] =
                  epilogue(out, acc[j][2 * h + e], s[h], p.has_bias, bv[h]);
          }
      }
    }
  }
}

CUtensorMapSwizzle swizzle_of(int bk) {
  return bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <int N, int MW, typename OutT>
int launch(const CUtensorMap& wmap, const CUtensorMap& xmap, const float* sx, const float* sw,
           const float* bias, void* out, const Plan& p, int grid, size_t smem, cudaStream_t s) {
  static bool ready = false;  // the attribute is the kernel's, set once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_wgmma<N, MW, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  int8_conv_wgmma<N, MW, OutT><<<grid, CONV_THREADS, smem, s>>>(wmap, xmap, sx, sw, bias,
                                                               static_cast<OutT*>(out), p);
  return (int)cudaGetLastError();
}

template <int N, int MW>
int launch_out(int out_dtype, const CUtensorMap& wmap, const CUtensorMap& xmap, const float* sx,
               const float* sw, const float* bias, void* out, const Plan& p, int grid, size_t smem,
               cudaStream_t s) {
  if (out_dtype == 0) return launch<N, MW, float>(wmap, xmap, sx, sw, bias, out, p, grid, smem, s);
  if (out_dtype == 1)
    return launch<N, MW, __nv_bfloat16>(wmap, xmap, sx, sw, bias, out, p, grid, smem, s);
  return launch<N, MW, int>(wmap, xmap, sx, sw, bias, out, p, grid, smem, s);
}

template <typename T>
int quantize_launch(const T* x, unsigned* am, int8_t* q, float* scale, int batch, int C, int S,
                    int c_pad, long long sb, long long sc, long long ss, cudaStream_t s) {
  // the widest piece (at most 16 bytes) that the strides and the base allow
  constexpr int ES = sizeof(T);
  auto fits = [&](int e, long long along, long long a1, long long a2) {
    return along == 1 && reinterpret_cast<uintptr_t>(x) % (e * ES) == 0 &&
           a1 % e == 0 && a2 % e == 0;
  };
  const int n = C * S;
  dim3 grid_max((n + QCHUNK - 1) / QCHUNK, batch);
  const bool dense = (sc == S && ss == 1) || (sc == 1 && ss == C);
  int ef = 1;  // absmax: the sample read flat
  for (int e = 16 / ES; e > 1; e >>= 1)
    if (dense && fits(e, 1, sb, 0)) {
      ef = e;
      break;
    }
  if (ef == 8)
    absmax_rows<T, 8><<<grid_max, QT, 0, s>>>(x, am, C, S, sb, sc, ss);
  else if (ef == 4)
    absmax_rows<T, 4><<<grid_max, QT, 0, s>>>(x, am, C, S, sb, sc, ss);
  else if (ef == 2)
    absmax_rows<T, 2><<<grid_max, QT, 0, s>>>(x, am, C, S, sb, sc, ss);
  else
    absmax_rows<T, 1><<<grid_max, QT, 0, s>>>(x, am, C, S, sb, sc, ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const bool pos = ss == 1 && (sc != 1 || S >= C);  // read along positions
  int e = 1;
  for (int v = 16 / ES; v > 1; v >>= 1)
    if (pos ? fits(v, ss, sb, sc) : fits(v, sc, sb, ss)) {
      e = v;
      break;
    }
  dim3 grid_q((S + QS - 1) / QS, c_pad / QC, batch);
#define DIART_Q(E_, POS_) \
  quantize_rows<T, E_, POS_><<<grid_q, QT, 0, s>>>(x, am, q, scale, C, S, c_pad, sb, sc, ss)
#define DIART_QE(POS_)      \
  if (e == 8)               \
    DIART_Q(8, POS_);       \
  else if (e == 4)          \
    DIART_Q(4, POS_);       \
  else if (e == 2)          \
    DIART_Q(2, POS_);       \
  else                      \
    DIART_Q(1, POS_);
  if (pos) {
    DIART_QE(true)
  } else {
    DIART_QE(false)
  }
#undef DIART_QE
#undef DIART_Q
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, C, S) f32 (dtype 0) or bf16 (1) at b * sb + c * sc + s * ss; amax
// (B,) scratch; q (B, S, c_pad) int8, c_pad a multiple of 32 >= C; scale
// (B,) f32.
extern "C" int int8_conv_quantize(const void* x, int dtype, int batch, int channels, int spatial,
                                  int c_pad, long long sb, long long sc, long long ss, void* amax,
                                  void* q, void* scale, void* stream) {
  if (batch < 1 || channels < 1 || spatial < 1 || batch > 65535 || c_pad < channels ||
      c_pad % QC || c_pad / QC > 65535 || (long long)channels * spatial > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* am = static_cast<unsigned*>(amax);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  const cudaError_t err = cudaMemsetAsync(am, 0, sizeof(unsigned) * batch, s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return quantize_launch(static_cast<const float*>(x), am, qo, so, batch, channels, spatial, c_pad,
                           sb, sc, ss, s);
  if (dtype == 1)
    return quantize_launch(static_cast<const __nv_bfloat16*>(x), am, qo, so, batch, channels,
                           spatial, c_pad, sb, sc, ss, s);
  return (int)cudaErrorInvalidValue;
}

// qx (B, S1, S2, c_pad) int8 channels-last, c_pad a multiple of 32 and of
// bk; qw (C_out, k1 x k2 x c_pad) int8, taps in (k1, k2) order, each tap's
// channels zero beyond C_in; sx (B,), sw (C_out,), bias (C_out,) or null:
// f32. out (B, C_out, O1, O2): f32 (out_dtype 0), bf16 (1) or the int32
// sums (2). The tiling (`ops/quant.py` conv_plan): tile_n (80, 128 or 160)
// positions a warpgroup as box1 rows x box2 columns (box1 * box2 == tile_n,
// box1 * stride1 <= 256, box2 * stride2 <= 256), mw (1: C_out <= 64, two
// warpgroups along positions; 2: along channels), bk (32, 64 or 128) the K
// slice. sms: the persistent grid's size.
extern "C" int int8_conv_launch(const void* qx, const void* qw, const void* sx, const void* sw,
                                const void* bias, void* out, int out_dtype, int batch, int c_pad,
                                int s1_len, int s2_len, int out_channels, int o1_len, int o2_len,
                                int k1, int k2, int stride1, int stride2, int pad1, int pad2,
                                int dil1, int dil2, int tile_n, int mw, int box1, int box2, int bk,
                                int sms, void* stream) {
  if (batch < 1 || c_pad < 32 || c_pad % 32 || (bk != 32 && bk != 64 && bk != 128) || c_pad % bk ||
      out_channels < 1 || o1_len < 1 || o2_len < 1 || k1 < 1 || k2 < 1 || (mw != 1 && mw != 2) ||
      (tile_n != 80 && tile_n != 128 && tile_n != 160) || box1 < 1 || box2 < 1 ||
      box1 * box2 != tile_n || box1 * stride1 > 256 || box2 * stride2 > 256 || stride1 < 1 ||
      stride2 < 1 || stride1 > 8 || stride2 > 8 || out_dtype < 0 || out_dtype > 2 || sms < 1 ||
      reinterpret_cast<uintptr_t>(qx) % 16 || reinterpret_cast<uintptr_t>(qw) % 16)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int nw = 2 / mw;
  Plan p;
  p.batch = batch;
  p.M = out_channels;
  p.O1 = o1_len;
  p.O2 = o2_len;
  p.cpad = c_pad;
  p.bk = bk;
  p.slices = c_pad / bk;
  p.k2 = k2;
  p.taps = k1 * k2;
  p.s1 = stride1;
  p.s2 = stride2;
  p.p1 = pad1;
  p.p2 = pad2;
  p.d1 = dil1;
  p.d2 = dil2;
  p.box1 = box1;
  p.box2 = box2;
  p.mt = (out_channels + 64 * mw - 1) / (64 * mw);
  p.nt1 = (o1_len + box1 * nw - 1) / (box1 * nw);
  p.nt2 = (o2_len + box2 - 1) / box2;
  const long long tiles = (long long)p.mt * p.nt1 * p.nt2 * batch;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.has_bias = bias != nullptr;
  const unsigned stage_bytes = 64 * mw * bk + nw * ((tile_n * bk + 1023u) & ~1023u);
  p.stages = (int)(RING_BYTES / stage_bytes) < MAX_STAGES ? (int)(RING_BYTES / stage_bytes) : MAX_STAGES;
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)p.stages * stage_bytes + EPI_BYTES + 16 * p.stages;

  CUtensorMap wmap, xmap;
  const int ktot = p.taps * c_pad;
  const cuuint64_t wdims[2] = {(cuuint64_t)ktot, (cuuint64_t)out_channels};
  const cuuint64_t wstrides[1] = {(cuuint64_t)ktot};
  const cuuint32_t wbox[2] = {(cuuint32_t)bk, (cuuint32_t)(64 * mw)};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(qw), wdims,
                      wstrides, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(bk),
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const cuuint64_t xdims[4] = {(cuuint64_t)c_pad, (cuuint64_t)s2_len, (cuuint64_t)s1_len,
                               (cuuint64_t)batch};
  const cuuint64_t xstrides[3] = {(cuuint64_t)c_pad, (cuuint64_t)s2_len * c_pad,
                                  (cuuint64_t)s1_len * s2_len * c_pad};
  // a box traverses box * stride elements of an axis and loads every
  // stride-th: box elements
  const cuuint32_t xbox[4] = {(cuuint32_t)bk, (cuuint32_t)(box2 * stride2),
                              (cuuint32_t)(box1 * stride1), 1};
  const cuuint32_t xstep[4] = {1, (cuuint32_t)stride2, (cuuint32_t)stride1, 1};
  r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(qx), xdims, xstrides, xbox,
             xstep, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(bk), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;

  const int grid = p.tiles < sms ? p.tiles : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(sx);
  const float* fw = static_cast<const float*>(sw);
  const float* fb = static_cast<const float*>(bias);
#define DIART_CONV(N_, MW_)                                                                     \
  if (tile_n == N_ && mw == MW_)                                                               \
    return launch_out<N_, MW_>(out_dtype, wmap, xmap, fx, fw, fb, out, p, grid, smem, s);
  DIART_CONV(80, 1)
  DIART_CONV(80, 2)
  DIART_CONV(128, 1)
  DIART_CONV(128, 2)
  DIART_CONV(160, 1)
  DIART_CONV(160, 2)
#undef DIART_CONV
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* int8_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
