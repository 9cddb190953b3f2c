// SincNet's second and third stages for Hopper, in three launches that keep
// each stage's f32 activation out of device memory:
//
//   x1 = leaky(norm1(pooled))                       pooled: (B, 80, P1) f32
//   m2 = max_pool3(conv2(x1) + b2)                  (B, 60, P2), P2 = (P1 - 4) / 3
//   x2 = leaky(norm2(m2))
//   out = leaky(norm3(max_pool3(conv3(x2) + b3)))   (B, 60, P3), P3 = (P2 - 4) / 3
//
// each norm an instance norm over time with its affine, leaky the slope
// 0.01, the convolutions k = 5 with no padding (frames that a pool drops are
// not pooled).
//
// It replaces no TPU kernel: the JAX package leaves these stages to XLA
// (`nn.Conv` k = 5, `_max_pool_time`, `_instance_norm` and `nn.leaky_relu`
// in `SincNet.__call__`, diart_tpu/models/sincnet.py:301-320). On the card
// it replaces cuDNN's true-f32 implicit GEMM of the two convolutions and
// some 30 launches of PyTorch's glue (each instance norm's mean, variance
// and four broadcast passes, leaky ReLU, max-pool, dtype casts) over the
// (B, 80, 2658) and (B, 60, 2654) f32 tensors (218 and 163 MB at B = 256).
//
// What bounds it on the H100. At B = 256 and 5 s windows the convolutions
// are 40.7 GFLOP (conv2 2 x 80 x 60 x 5 x 2654 a window, conv3 2 x 60 x 60
// x 5 x 880): 0.247 ms as three TF32 products at 495 TFLOP/s, 0.61 ms as
// f32 FMAs. Its bytes (the pooled input read once, the (B, 60, 293) output
// written once) take 0.070 ms. So it is bound by the products, and the
// design puts them on the tensor cores at f32 accuracy and keeps the rest
// off the memory:
//
// * `sinc_stage_stats`: norm1's mean and 1 / sqrt(var + eps) of each
//   (stream, channel) row, one warp a row read once: each lane's (count,
//   mean, M2) over chunks of its values merged by Chan's formula in a fixed
//   order, then the lanes' by a fixed butterfly.
// * `sinc_stage2`: conv2 as an implicit GEMM over (stream, tile of 42 pooled
//   frames) items, a persistent grid of two blocks an SM, each two
//   warpgroups: M = the tile's 128 conv frames (a warpgroup's m64 each), N =
//   60 channels padded to 64, K = 5 taps x 80 channels. Each item's 132 input
//   frames x 80 channels arrive by `cp.async` and are turned in place into
//   leaky(norm1(x)) (a channel's frames at a stride of 136 floats, so the A
//   fragments' 32 loads fall in 32 banks). A tap is a shift of the rows, so
//   no im2col is formed: A comes from registers, loaded from the tile. B,
//   the weights as W^T (channels x k, k = tap x 80 + channel) split hi and
//   lo by the wrapper, streams through a ring of four 32-k slices by
//   `cp.async` (128-byte rows, swizzled, K-major as a `.tf32` `wgmma`
//   operand must be), two slices ahead of the products. The epilogue adds
//   the bias, lays the tile out in shared memory, max-pools by 3, writes m2
//   (54 MB at B = 256) and each (stream, tile, channel)'s mean and M2 of it
//   for norm2. Two blocks share an SM, so that one block's copies, norm
//   and pool can run under the other's products.
// * `sinc_stage3`: one block a stream (the grid persistent over streams, two
//   blocks an SM): norm2's statistics merged from the tiles' partials by
//   Chan's formula in tile order, then conv3 tile by tile as above with
//   norm2 and leaky applied on load, the pooled rows written once, then
//   norm3's statistics (one read of those rows, which only this block wrote,
//   as norm1's) and norm3 + leaky in place.
// * Products: `wgmma` m64n64k8 .tf32. At f32 (3xTF32) the A operand is
//   split into hi = rna_tf32(v) and lo = rna_tf32(v - hi) in registers, B
//   comes split, and a k8 step accumulates lo.hi + hi.lo into one
//   accumulator and hi.hi into another (the tensor cores' accumulation
//   truncates: the small terms lose less in their own), added to nearest
//   before the bias; the lo.lo term lies below f32's rounding. At bf16 the
//   operands are rounded to bf16, which a TF32 register holds exactly, and
//   one product is taken, accumulated in f32 as a bf16 `wgmma` would; the
//   output is rounded to bf16 and the bias added in bf16, as PyTorch's bf16
//   convolution and its bias add round.
// * What holds it (0.93 ms for the three launches at B = 256 on an H100 SXM:
//   conv2 0.65, conv3 0.19, norm1's statistics 0.09; the composition it
//   replaced 3.8, cuDNN's two convolutions alone 2.1): with the products
//   left out conv2 still takes 0.34 ms (the input tile's copy and norm, the
//   A fragments' loads and splits, the W^T ring's copies from L2 and the
//   slice barriers), and the two blocks of an SM overlap that with each
//   other's products only in part. `mma.sync` m16n8k8 .tf32 with the
//   weights resident in shared memory read 0.87 ms for conv2: its TF32 rate
//   is about a third of `wgmma`'s.
// * No atomics: every sum runs in an order fixed by the shapes, so the same
//   inputs give the same bits whatever the launch plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_ca;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::fence_async_shared;
using hopper::smem_u32;
using hopper::swizzle128;
using hopper::tf32_split;
using hopper::wgmma_commit;
using hopper::wgmma_desc;
using hopper::wgmma_fence;
using hopper::wgmma_m64n64k8_tf32;
using hopper::wgmma_wait;

constexpr int kTaps = 5;
constexpr int kPool = 3;
constexpr int kIn1 = 80;       // conv2's input channels
constexpr int kOut = 60;       // both convolutions' output channels
constexpr int kN = 64;         // output channels padded to the wgmma's N
constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr int kRows = 128;                // conv frames a tile: a warpgroup's m64 each
constexpr int kTile = 42;                 // pooled frames a tile (3 x 42 <= 128)
constexpr int kSpan = kRows + kTaps - 1;  // input frames a tile reads
constexpr int kSX = 136;  // shared stride of an input channel's frames (= 8 mod 32)
constexpr int kSY = 132;  // shared stride of an output channel's frames (= 4 mod 32)
constexpr int kSlice = 32;   // k a ring stage holds: 128-byte rows of W^T
constexpr int kStages = 4;   // the ring; slices are copied kStages - 2 ahead
constexpr int kBBytes = kN * kSlice * 4;  // W^T hi (or lo) of a slice: 8 KB
constexpr int kStatsThreads = 256, kStatsRows = kStatsThreads / 32;  // a statistics block: a row a warp
constexpr int kMaxSmem = 232448;
constexpr float kEps = 1e-5f;
constexpr float kSlope = 0.01f;

// a convolution's geometry by its input channels: k = tap x kCinPad +
// channel, padded to whole slices
template <int CIN>
struct Geo {
  static constexpr int kCinPad = (CIN + 7) / 8 * 8;  // 80, or 60 -> 64
  static constexpr int kSteps = kCinPad / 8;         // k8 steps a tap
  static constexpr int kAllSteps = kTaps * kSteps;   // 50, 40
  static constexpr int kKPad = (8 * kAllSteps + kSlice - 1) / kSlice * kSlice;  // 416, 320
  static constexpr int kSlices = kKPad / kSlice;     // 13, 10
  static constexpr int kXFloats = kCinPad * kSX;     // the input tile (then the output tile)
  static constexpr int kPFloats = 4 * kCinPad + kN;  // mean, rstd, scale, shift; bias
  static constexpr size_t kSmem = 1024 + (size_t)kStages * 2 * kBBytes + sizeof(float) * (kXFloats + kPFloats);
  static_assert(kXFloats >= kN * kSY, "the output tile reuses the input tile's shared memory");
  static_assert(kAllSteps % 2 == 0, "a slice's steps go in pairs");
};

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// leaky(((v - mean) * rstd) * scale + shift), each operation rounded as
// PyTorch's separate ops round it
__device__ __forceinline__ float norm_leaky(float v, float mean, float rstd, float scale, float shift) {
  const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), scale), shift);
  return y > 0.f ? y : __fmul_rn(y, kSlope);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // the same bits in every lane: each step adds the same two values
}

// the max of three frames, NaN propagating as max_pool1d's does
__device__ __forceinline__ float pool3(const float* y) {
  float m = y[0];
#pragma unroll
  for (int j = 1; j < kPool; ++j) {
    const float v = y[j];
    if (v > m || v != v) m = v;
  }
  return m;
}

// The shared memory of a stage block: the ring of W^T slices (1024-aligned:
// stage i's hi at ring + 2 i kBBytes, its lo kBBytes on), the input tile xs
// (channel c's frame r at c * kSX + r), the input norm's per-channel mean,
// rstd, scale and shift and the convolution's bias.
template <int CIN>
struct Smem {
  unsigned char* ring;  // the ring, 1024-aligned; every other area lies at a fixed offset from it
  __device__ explicit Smem(unsigned char* raw) : ring(raw + (((smem_u32(raw) + 1023u) & ~1023u) - smem_u32(raw))) {}
  __device__ unsigned ring_addr() const { return smem_u32(ring); }  // for the wgmma descriptors
  __device__ float* xs() const { return reinterpret_cast<float*>(ring + kStages * 2 * kBBytes); }
  __device__ float* mean() const { return xs() + Geo<CIN>::kXFloats; }
  __device__ float* rstd() const { return mean() + Geo<CIN>::kCinPad; }
  __device__ float* scale() const { return rstd() + Geo<CIN>::kCinPad; }
  __device__ float* shift() const { return scale() + Geo<CIN>::kCinPad; }
  __device__ float* bias() const { return shift() + Geo<CIN>::kCinPad; }
};

// the block's bias (0 on the padded channels) and input norm's affine
template <int CIN>
__device__ void load_params(const Smem<CIN>& s, const float* __restrict__ bias, const float* __restrict__ scale,
                            const float* __restrict__ shift) {
  for (int c = threadIdx.x; c < kN; c += kThreads) s.bias()[c] = c < kOut ? bias[c] : 0.f;
  for (int c = threadIdx.x; c < Geo<CIN>::kCinPad; c += kThreads) {
    s.scale()[c] = c < CIN ? scale[c] : 0.f;
    s.shift()[c] = c < CIN ? shift[c] : 0.f;
  }
}

// slice kb of W^T (2, 64, kKPad): hi, and lo at f32, into ring stage kb %
// kStages, 64 rows of 128 bytes with 16-byte chunk c of row r at c ^ (r % 8)
template <int CIN, bool BF16>
__device__ __forceinline__ void load_slice(const Smem<CIN>& s, const float* __restrict__ wt, int kb) {
  unsigned char* st = s.ring + (kb % kStages) * 2 * kBBytes;
  const float* src = wt + kb * kSlice;
  for (int e = threadIdx.x; e < kN * 8; e += kThreads) {
    const int row = e >> 3, c = e & 7;
    cp_async16(st + swizzle128(row, c), src + (size_t)row * Geo<CIN>::kKPad + 4 * c);
    if (!BF16) cp_async16(st + kBBytes + swizzle128(row, c), src + (size_t)(kN + row) * Geo<CIN>::kKPad + 4 * c);
  }
}

// The ring's first kStages - 2 slices, issued before the tile's input so
// that they arrive under it.
template <int CIN, bool BF16>
__device__ __forceinline__ void ring_prologue(const Smem<CIN>& s, const float* __restrict__ wt) {
#pragma unroll
  for (int kb = 0; kb < kStages - 2; ++kb) {
    load_slice<CIN, BF16>(s, wt, kb);
    cp_async_commit();
  }
}

// The input tile: xs[c][r] = leaky(norm(src[c][f0 + r])) for the tile's
// kSpan frames, 0 past the stream's `frames` and on the padded channels;
// rounded to bf16 at BF16. src: the stream's (CIN, frames) rows. A warp
// takes every 8th channel, a lane every 32nd frame, and turns in place the
// values its own copies brought. Ends with a barrier; the ring's slices in
// flight have landed by then too.
template <int CIN, bool BF16>
__device__ void fill_tile(const Smem<CIN>& s, const float* __restrict__ src, int frames, int f0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int avail = frames - f0;  // the tile's frames that exist
  for (int c = warp; c < CIN; c += kWarps) {
    const float* sc = src + (size_t)c * frames + f0;
    float* xc = s.xs() + c * kSX;
    for (int r = lane; r < kSpan; r += 32) cp_async_ca<4>(xc + r, r < avail ? sc + r : src, r < avail ? 4 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  for (int c = warp; c < Geo<CIN>::kCinPad; c += kWarps) {
    float* xc = s.xs() + c * kSX;
    if (c >= CIN) {
      for (int r = lane; r < kSpan; r += 32) xc[r] = 0.f;
      continue;
    }
    const float mean = s.mean()[c], rstd = s.rstd()[c], scale = s.scale()[c], shift = s.shift()[c];
    for (int r = lane; r < kSpan; r += 32) {
      float v = r < avail ? norm_leaky(xc[r], mean, rstd, scale, shift) : 0.f;
      if (BF16) v = bf16_round(v);
      xc[r] = v;
    }
  }
  __syncthreads();
}

// This thread's A fragment of k8 step `step` (tap step / kSteps, channels 8
// (step % kSteps) + t and + 4): rows 16 warp + g and + 8 of the tile, a
// tap later in the input tile; split into hi and lo at f32.
template <int CIN, bool BF16>
__device__ __forceinline__ void a_fragment(const Smem<CIN>& s, int step, unsigned (&ah)[4], unsigned (&al)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tap = step / Geo<CIN>::kSteps, cs = step - tap * Geo<CIN>::kSteps;
  const float* x0 = s.xs() + (8 * cs + (lane & 3)) * kSX + 16 * warp + (lane >> 2) + tap;
  const float v[4] = {x0[0], x0[8], x0[4 * kSX], x0[4 * kSX + 8]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (BF16) {
      ah[i] = __float_as_uint(v[i]);
    } else {
      tf32_split(v[i], ah[i], al[i]);
    }
  }
}

// This warpgroup's 64 conv frames x 64 channels of the tile: acc the hi.hi
// sums (every product at BF16), lo the lo.hi + hi.lo sums (f32 only). The
// ring's first slices were issued by ring_prologue; each k8 step's products
// are a commit group whose A fragments take one of two register sets in
// turn, so one step's products run while the next step's fragments are
// loaded and split. (Groups of two steps held 32 registers of fragments and
// made conv3's block spill at two blocks an SM.)
template <int CIN, bool BF16>
__device__ __forceinline__ void conv_tile(const Smem<CIN>& s, const float* __restrict__ wt, float (&acc)[8][4],
                                          float (&lo)[8][4]) {
  constexpr int NS = Geo<CIN>::kSlices, ALL = Geo<CIN>::kAllSteps;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = lo[j][i] = 0.f;
  unsigned ah[2][4], al[2][4];  // [group][register]
  for (int kb = 0; kb < NS; ++kb) {
    cp_async_wait<kStages - 3>();  // slice kb has landed (this thread's copies)
    fence_async_shared();          // ... for the tensor cores
    __syncthreads();               // ... every thread's; both warpgroups are done with slice kb - 2
    if (kb + kStages - 2 < NS) load_slice<CIN, BF16>(s, wt, kb + kStages - 2);  // into slice kb - 2's stage
    cp_async_commit();
    const unsigned hi = s.ring_addr() + (kb % kStages) * 2 * kBBytes, low = hi + kBBytes;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (4 * kb + ks >= ALL) break;  // conv2's last slice holds two steps
      const int h = ks & 1;
      a_fragment<CIN, BF16>(s, 4 * kb + ks, ah[h], al[h]);
      wgmma_fence();
      const int at = 32 * ks;  // the step's 8 k: 32 bytes into each 128-byte row
      if (!BF16) {
        wgmma_m64n64k8_tf32(lo, al[h], wgmma_desc(hi + at, 16, 1024));
        wgmma_m64n64k8_tf32(lo, ah[h], wgmma_desc(low + at, 16, 1024));
      }
      wgmma_m64n64k8_tf32(acc, ah[h], wgmma_desc(hi + at, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the group before is done: its register set is free again
    }
  }
  wgmma_wait<0>();
}

// The tile's conv output with its bias, channel c's frame m at ys[c * kSY +
// m] (ys: the input tile's memory; every warp is done reading it). f32: the
// two sums added to nearest, then the bias; BF16: the sum rounded to bf16,
// then the bias added in bf16.
template <int CIN, bool BF16>
__device__ __forceinline__ void store_tile(const Smem<CIN>& s, const float (&acc)[8][4], const float (&lo)[8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* ys = s.xs();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 16 * warp + g + 8 * (i >> 1), c = 8 * j + 2 * t + (i & 1);
      const float y = BF16 ? bf16_round(__fadd_rn(bf16_round(acc[j][i]), s.bias()[c]))
                           : __fadd_rn(__fadd_rn(acc[j][i], lo[j][i]), s.bias()[c]);
      ys[c * kSY + m] = y;
    }
}

// (n, mean, M2) of a set merged with another's (Chan's formula); an empty
// side (n = 0) leaves the other as it is
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb, float qb) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb, mean = mb, m2 = qb;
    return;
  }
  const float tot = n + nb, d = mb - mean;
  mean += d * (nb / tot);
  m2 += qb + d * d * (n * nb / tot);
  n = tot;
}

// One warp a (stream, channel) row of `frames` values, read once: its mean
// and 1 / sqrt(var + eps) (the biased variance) in every lane. Each lane
// merges chunks of four of its values (their own mean and M2) in a fixed
// order, then the lanes merge by a fixed butterfly; lane 0's result is
// broadcast.
__device__ __forceinline__ void row_stats(const float* row, int frames, float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float n = 0.f, m = 0.f, q = 0.f;
  int i = lane;
  for (; i + 96 < frames; i += 128) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = row[i + 32 * u];
    const float mc = ((v[0] + v[1]) + (v[2] + v[3])) * 0.25f;
    float qc = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) qc = fmaf(v[u] - mc, v[u] - mc, qc);
    chan_merge(n, m, q, 4.f, mc, qc);
  }
  for (; i < frames; i += 32) chan_merge(n, m, q, 1.f, row[i], 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, o), mb = __shfl_xor_sync(0xffffffffu, m, o),
                qb = __shfl_xor_sync(0xffffffffu, q, o);
    chan_merge(n, m, q, nb, mb, qb);
  }
  mean = __shfl_sync(0xffffffffu, m, 0);
  const float var = __fdiv_rn(__shfl_sync(0xffffffffu, q, 0), (float)frames);
  rstd = __fdiv_rn(1.f, __fsqrt_rn(var + kEps));
}

// norm1's statistics: x (B, 80, P1) at `batch_stride` floats a stream ->
// stats (B, 80, 2) = (mean, rstd)
__global__ void __launch_bounds__(kStatsThreads) sinc_stage_stats(const float* __restrict__ x, long long batch_stride,
                                                              float* __restrict__ stats, int batch, int frames) {
  const int row = blockIdx.x * kStatsRows + (threadIdx.x >> 5);
  if (row >= batch * kIn1) return;
  const int b = row / kIn1, c = row - b * kIn1;
  float mean, rstd;
  row_stats(x + b * batch_stride + (size_t)c * frames, frames, mean, rstd);
  if ((threadIdx.x & 31) == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = rstd;
  }
}

// conv2 over (stream, tile) items: x (B, 80, P1) at `batch_stride`; stats
// (B, 80, 2); w2 W^T (2, 64, 416); mid (B, 60, P2) the pooled conv2 output;
// part (B, tiles, 60, 2) each tile's (mean, M2) of mid over its pooled frames.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    sinc_stage2(const float* __restrict__ x, long long batch_stride, const float* __restrict__ stats,
                const float* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ scale1,
                const float* __restrict__ shift1, float* __restrict__ mid, float* __restrict__ part, int batch,
                int p1, int p2, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<kIn1> s(smem_raw);
  load_params<kIn1>(s, b2, scale1, shift1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[8][4], lo[8][4];
  for (int item = blockIdx.x; item < batch * tiles; item += gridDim.x) {
    const int b = item / tiles, tile = item - b * tiles, p0 = tile * kTile;
    ring_prologue<kIn1, BF16>(s, w2);
    for (int c = threadIdx.x; c < kIn1; c += kThreads) {
      s.mean()[c] = stats[2 * (b * kIn1 + c)];
      s.rstd()[c] = stats[2 * (b * kIn1 + c) + 1];
    }
    __syncthreads();  // the stream's statistics (and, the first time, the parameters) are in
    fill_tile<kIn1, BF16>(s, x + b * batch_stride, p1, kPool * p0);
    conv_tile<kIn1, BF16>(s, w2, acc, lo);
    __syncthreads();  // both warpgroups are done with the input tile
    store_tile<kIn1, BF16>(s, acc, lo);
    __syncthreads();
    // max-pool, mid, and this tile's (mean, M2) of each channel
    const int valid = min(kTile, p2 - p0);
    for (int c = warp; c < kOut; c += kWarps) {
      const float* yc = s.xs() + c * kSY;
      float* mc = mid + ((size_t)b * kOut + c) * p2 + p0;
      float v[2], sum = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = lane + 32 * q;
        v[q] = 0.f;
        if (p < valid) {
          v[q] = pool3(yc + kPool * p);
          mc[p] = v[q];
          sum += v[q];
        }
      }
      const float mean = __fdiv_rn(warp_sum(sum), (float)valid);
      float m2 = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (lane + 32 * q < valid) {
          const float d = v[q] - mean;
          m2 = fmaf(d, d, m2);
        }
      m2 = warp_sum(m2);
      if (lane == 0) {
        float* pc = part + (((size_t)b * tiles + tile) * kOut + c) * 2;
        pc[0] = mean;
        pc[1] = m2;
      }
    }
    __syncthreads();  // the output tile is read; the next item may overwrite it
  }
}

// conv3, a stream at a time: mid (B, 60, P2), part (B, tiles2, 60, 2), w3
// W^T (2, 64, 320) -> out (B, 60, P3) = leaky(norm3(max_pool3(conv3(
// leaky(norm2(mid))) + b3)))
template <bool BF16>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    sinc_stage3(const float* __restrict__ mid, const float* __restrict__ part, const float* __restrict__ w3,
                const float* __restrict__ b3, const float* __restrict__ scale2, const float* __restrict__ shift2,
                const float* __restrict__ scale3, const float* __restrict__ shift3, float* out, int batch, int p2,
                int tiles2, int p3, int tiles3) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<kOut> s(smem_raw);
  load_params<kOut>(s, b3, scale2, shift2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[8][4], lo[8][4];
  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    // norm2's statistics: the tiles' (count, mean, M2) merged in tile order
    for (int c = threadIdx.x; c < kOut; c += kThreads) {
      float n = 0.f, mean = 0.f, m2 = 0.f;
      for (int tile = 0; tile < tiles2; ++tile) {
        const float* pc = part + (((size_t)b * tiles2 + tile) * kOut + c) * 2;
        chan_merge(n, mean, m2, (float)min(kTile, p2 - tile * kTile), pc[0], pc[1]);
      }
      s.mean()[c] = mean;
      s.rstd()[c] = __fdiv_rn(1.f, __fsqrt_rn(__fdiv_rn(m2, n) + kEps));
    }
    __syncthreads();
    float* ob = out + (size_t)b * kOut * p3;
    for (int tile = 0; tile < tiles3; ++tile) {
      const int p0 = tile * kTile;
      ring_prologue<kOut, BF16>(s, w3);
      fill_tile<kOut, BF16>(s, mid + (size_t)b * kOut * p2, p2, kPool * p0);
      conv_tile<kOut, BF16>(s, w3, acc, lo);
      __syncthreads();
      store_tile<kOut, BF16>(s, acc, lo);
      __syncthreads();
      const int valid = min(kTile, p3 - p0);
      for (int c = warp; c < kOut; c += kWarps)
        for (int p = lane; p < valid; p += 32) ob[(size_t)c * p3 + p0 + p] = pool3(s.xs() + c * kSY + kPool * p);
      __syncthreads();
    }
    // norm3 and leaky over the stream's pooled rows, which this block wrote
    for (int c = warp; c < kOut; c += kWarps) {
      float* row = ob + (size_t)c * p3;
      float mean, rstd;
      row_stats(row, p3, mean, rstd);
      const float sc = scale3[c], sh = shift3[c];
      for (int p = lane; p < p3; p += 32) row[p] = norm_leaky(row[p], mean, rstd, sc, sh);
    }
    __syncthreads();  // before the next stream's statistics replace these
  }
}

// the launch plan, as the wrapper's `launch_plan` makes it
struct Plan {
  int p2, p3, tiles2, tiles3, grid2, grid3;
};

// whether a plan keeps the kernels inside their buffers: each pool reads
// frames its convolution has, and the tiles cover their frames with no
// tile left empty (conv3 merges tiles2 partials, each of a tile's frames)
bool plan_fits(int p1, const Plan& p) {
  return p.p3 >= 1 && kPool * p.p2 <= p1 - (kTaps - 1) && kPool * p.p3 <= p.p2 - (kTaps - 1) &&
         (p.tiles2 - 1) * kTile < p.p2 && p.p2 <= p.tiles2 * kTile && (p.tiles3 - 1) * kTile < p.p3 &&
         p.p3 <= p.tiles3 * kTile && p.grid2 >= 1 && p.grid3 >= 1;
}

// a stage kernel's dynamic shared memory, and all of the SM's for shared
// memory, so that two blocks fit
template <typename F>
cudaError_t allow_smem(F* fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <bool BF16>
int launch(const float* x, long long batch_stride, const float* w2, const float* b2, const float* w3, const float* b3,
           const float* s1, const float* c1, const float* s2, const float* c2, const float* s3, const float* c3,
           float* stats, float* mid, float* part, float* out, int batch, int p1, const Plan& p, cudaStream_t stream) {
  constexpr size_t smem2 = Geo<kIn1>::kSmem, smem3 = Geo<kOut>::kSmem;
  static_assert(smem2 <= (size_t)kMaxSmem && smem3 <= (size_t)kMaxSmem, "a stage block's shared memory");
  static_assert(kBlocksPerSm * (smem2 + 1024) <= 233472, "two stage blocks an SM");
  if (const cudaError_t err = allow_smem(sinc_stage2<BF16>, smem2)) return (int)err;
  if (const cudaError_t err = allow_smem(sinc_stage3<BF16>, smem3)) return (int)err;
  sinc_stage_stats<<<(batch * kIn1 + kStatsRows - 1) / kStatsRows, kStatsThreads, 0, stream>>>(x, batch_stride, stats,
                                                                                               batch, p1);
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  sinc_stage2<BF16><<<p.grid2, kThreads, smem2, stream>>>(x, batch_stride, stats, w2, b2, s1, c1, mid, part, batch,
                                                          p1, p.p2, p.tiles2);
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  sinc_stage3<BF16><<<p.grid3, kThreads, smem3, stream>>>(mid, part, w3, b3, s2, c2, s3, c3, out, batch, p.p2,
                                                          p.tiles2, p.p3, p.tiles3);
  return (int)cudaGetLastError();
}

}  // namespace

// pooled x: (B, 80, P1) f32, each stream's (80, P1) rows contiguous, streams
// `batch_stride` floats apart; w2 (2, 64, 416) and w3 (2, 64, 320): W^T hi
// and lo as `prepare_stage_operands` lays them out (k = tap x 80, or x 64,
// + channel; bf16 values and a zero lo at bf16); b2, b3 (60,); s1, c1 (80,),
// s2, c2, s3, c3 (60,): the norms' scales and shifts; stats (B, 80, 2), mid
// (B, 60, P2), part (B, tiles2, 60, 2): scratch; out (B, 60, P3). p2 to
// grid3: the wrapper's launch plan (P2, P3, the tiles of each, and the
// persistent grids of conv2 and conv3), refused unless it fits the buffers.
// Returns the first failing launch's cudaError_t.
extern "C" int sinc_stages_launch(const void* x, long long batch_stride, const void* w2, const void* b2,
                                  const void* w3, const void* b3, const void* s1, const void* c1, const void* s2,
                                  const void* c2, const void* s3, const void* c3, void* stats, void* mid, void* part,
                                  void* out, int batch, int p1, int p2, int p3, int tiles2, int tiles3, int grid2,
                                  int grid3, int bf16, void* stream) {
  const Plan p{p2, p3, tiles2, tiles3, grid2, grid3};
  if (batch < 1 || batch_stride < (long long)kIn1 * p1 || !plan_fits(p1, p)) return (int)cudaErrorInvalidValue;
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto m = [](void* v) { return static_cast<float*>(v); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(f(x), batch_stride, f(w2), f(b2), f(w3), f(b3), f(s1), f(c1), f(s2), f(c2), f(s3),
                             f(c3), m(stats), m(mid), m(part), m(out), batch, p1, p, st)
              : launch<false>(f(x), batch_stride, f(w2), f(b2), f(w3), f(b3), f(s1), f(c1), f(s2), f(c2), f(s3),
                              f(c3), m(stats), m(mid), m(part), m(out), batch, p1, p, st);
}

extern "C" const char* sinc_stages_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
