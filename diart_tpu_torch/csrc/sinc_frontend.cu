// SincNet's first stage for Hopper, in one kernel that writes only its
// result:
//
//   out[b, f, p] = max_{j < 3} |bias[f] + sum_k w[f, k] x[b, 30 p + 10 j + k]|
//
// the stride-10 sinc convolution (251 taps) of the standardized waveform,
// its magnitude and the non-overlapping max-pool(3) over frames; under
// `bf16_frontend` the pooled value is rounded to bf16 (round to nearest
// even is monotone and symmetric in sign, so bf16(max |y|) equals the max
// of |bf16(y)| bit for bit). The last frame that max-pool drops (frame
// 3 (T / 3) and on) is not computed.
//
// It replaces no TPU kernel: the JAX package leaves this stage to XLA
// (`conv_general_dilated` in `SincConv.__call__`, diart_tpu/models/
// sincnet.py:138, then `frontend_pool` :212). On the card it replaces
// cuDNN's true-f32 implicit GEMM of the convolution and the four passes of
// `frontend_pool` (bf16 cast, abs, max-pool, f32 cast) over the (B, F, T)
// f32 tensor the convolution wrote (653 MB at B = 256, F = 80).
//
// What bounds it on the H100. At B = 256, S = 80000, F = 80 the convolution
// is 82 GFLOP as written. The filterbank is structured (sinc_filters lays
// the cosine filters out exactly symmetric and the sine filters exactly
// antisymmetric about the centre tap), so a filter's 251 products fold into
// 126 (cosine: the sums x[k] + x[250 - k] and the centre tap) or 125
// (sine: the differences), each pair formed once for the 10 filters of
// that kind a thread holds: 41.0 GFLOP, 0.61 ms as f32 FMAs at 67 TFLOP/s
// (0.25 ms at the 3xTF32 rate). Its bytes (the waveform read once, 82 MB;
// the pooled output written once, 218 MB) take 0.09 ms. So it is bound by
// f32 FMAs, and the design is about keeping the FMA pipes fed:
//
// * Threads own pooled frames, warps own filters. A warp computes 32
//   pooled frames (one a lane) x one group of 20 filters: 10 symmetric
//   (cosine) and 10 antisymmetric (sine), so each pair sum and difference
//   a thread forms feeds 10 FMAs, and the three frames of a pool sit in
//   one thread's accumulators (3 x 20 = 60): the pool and |.| are the
//   epilogue, with no shuffle.
// * A pair step reads the 20 coefficients of its group as five 16-byte
//   loads that every lane of the warp shares (a broadcast), and two
//   waveform samples a pooled frame: frame j + 1 at tap k is frame j at tap
//   k + 10, so walking k = 10 a + r with r outer and a inner (unrolled)
//   slides a window of three samples a side along a, one new sample a side
//   a step. A step is 60 FMAs against 6 adds and 7 loads.
// * The prepared coefficients (126 pair steps x 20 filters a group: the
//   125 pairs, then the centre tap as a pair of itself at half weight,
//   which is exact) stay resident in shared memory for a persistent walk
//   over (stream, tile of pooled frames) items, two blocks of 8 warps an
//   SM. (Two frames a thread, 120 accumulators at one block an SM, ran
//   3.5% slower at B = 256 and 1.8x slower at B = 1 on an H100 SXM.) The
//   waveform strip of the next item (30 samples a pooled frame plus the
//   241 of a filter's reach) arrives by `cp.async` under the current
//   item's products, into the other of two buffers.
// * What holds it (1.05 ms at B = 256, F = 80 on an H100 SXM, 39 TFLOP/s
//   of folded work, 58% of the FMA peak): not occupancy (16 warps an SM
//   against 8 moved it 3.5%) and not the step's instruction mix (FMAs are
//   85% of a step's instructions). Register-bank conflicts of the FMAs and
//   the shared-memory broadcasts are the candidates; a 3xTF32 route
//   (`mma.sync` on pair sums split in registers) is the next step.
// * Sums run in the order k = 0, 10, .., 120, 1, 11, .., 121, .., 9, .., 119
//   (the centre at r = 5), one fused multiply-add a step, independent of
//   the launch plan: the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTaps = 251;
constexpr int kStride = 10;
constexpr int kPool = 3;
constexpr int kSpan = kStride * kPool;  // samples a pooled frame advances
constexpr int kSteps = 126;             // pair steps laid out: 125 pairs and the centre tap
constexpr int kGroup = 20;              // filters a warp: 10 symmetric, then 10 antisymmetric
constexpr int kHalf = kGroup / 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 1;               // pooled frames a thread (32 apart where more)
constexpr int kWarpPooled = 32 * kPerThread;  // pooled frames a warp
constexpr int kBlocksPerSm = 2;
constexpr int kMaxSmem = 232448;

// pooled frames an item (one block's tile of one stream) for `groups`
// groups of filters: the block's 8 warps cover groups x tiles of 32
__host__ __device__ inline int tile_of(int groups) { return kWarpPooled * kWarps / groups; }
// floats of one waveform strip, rounded up to whole 16-byte chunks
__host__ __device__ inline int strip_of(int tile) { return (kSpan * tile + kTaps - kStride + 3) / 4 * 4; }

size_t smem_bytes(int groups) {
  return sizeof(float) * ((size_t)groups * kSteps * kGroup + 2 * (size_t)strip_of(tile_of(groups)));
}

// the samples [30 p0, 30 p0 + strip) of stream b into `dst`; past the
// stream's end, zeros (the frames that read them are not stored)
__device__ __forceinline__ void load_strip(float* dst, const float* __restrict__ wave, int b, int p0,
                                           int samples, int strip) {
  const float* src = wave + (size_t)b * samples + (size_t)kSpan * p0;
  const int avail = samples - kSpan * p0;
  for (int i = threadIdx.x; i < strip; i += kThreads) {
    const bool in = i < avail;
    hopper::cp_async_ca<4>(dst + i, in ? src + i : wave, in ? 4 : 0);
  }
}

// wave (B, S) f32; taps (groups, 126, 20): pair step k's coefficient of each
// column (k < 125: tap k of the filter's left half; k = 125: half the centre
// tap for a symmetric column, 0 for an antisymmetric one); rows (groups, 20):
// the output row of each column; shift (groups, 20): its bias; out (B, F, P).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sinc_frontend_kernel(const float* __restrict__ wave, const float* __restrict__ taps,
                     const float* __restrict__ shift, const int* __restrict__ rows,
                     float* __restrict__ out, int batch, int samples, int pooled, int groups,
                     int filters, int bf16) {
  extern __shared__ __align__(16) float smem[];
  const int tile = tile_of(groups);
  const int strip = kSpan * tile + kTaps - kStride;
  const int stride = strip_of(tile);
  float* taps_s = smem;
  float* strips = smem + groups * kSteps * kGroup;

  for (int i = threadIdx.x; i < groups * kSteps * kGroup / 4; i += kThreads)
    reinterpret_cast<float4*>(taps_s)[i] = reinterpret_cast<const float4*>(taps)[i];

  const int tiles = (pooled + tile - 1) / tile;
  const int items = batch * tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp % groups;
  const int first = (warp / groups) * kWarpPooled + lane;  // the thread's first pooled frame in a tile
  const float* wg = taps_s + g * kSteps * kGroup;

  int item = blockIdx.x;
  if (item < items) load_strip(strips, wave, item / tiles, (item % tiles) * tile, samples, strip);
  hopper::cp_async_commit();

  for (int buf = 0; item < items; item += gridDim.x, buf ^= 1) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // this strip (and, the first time, the taps) landed; the other buffer is free
    const int next = item + gridDim.x;
    if (next < items)
      load_strip(strips + (buf ^ 1) * stride, wave, next / tiles, (next % tiles) * tile, samples, strip);
    hopper::cp_async_commit();

    const float* xs = strips + buf * stride + kSpan * first;
    float acc[kPerThread][kPool][kGroup];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q)
#pragma unroll
      for (int j = 0; j < kPool; ++j)
#pragma unroll
        for (int c = 0; c < kGroup; ++c) acc[q][j][c] = 0.f;

#pragma unroll 1
    for (int r = 0; r < kStride; ++r) {
      // tap k = 10 a + r of frame j reads fw[10 (j + a)]; its mirror
      // 250 - k reads mw[10 (j - a)]
      const float* fw = xs + r;
      const float* mw = xs + (kTaps - 1) - r;
      const float* wk = wg + r * kGroup;
      float u[kPerThread][15], v[kPerThread][15];  // u[n] = fw[10 n], v[12 + m] = mw[10 m]
#pragma unroll
      for (int a = 0; a < 13; ++a) {
        if (a == 12 && r > 5) continue;  // k = 126 .. 129: no such pair
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          const int o = q * 32 * kSpan;
          if (a == 0) {
            u[q][0] = fw[o];
            u[q][1] = fw[o + kStride];
            v[q][13] = mw[o + kStride];
            v[q][14] = mw[o + 2 * kStride];
          }
          u[q][a + 2] = fw[o + kStride * (a + 2)];
          v[q][12 - a] = mw[o - kStride * a];
        }
        float w[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup / 4; ++i) {
          const float4 c4 = *reinterpret_cast<const float4*>(wk + a * kStride * kGroup + 4 * i);
          w[4 * i] = c4.x;
          w[4 * i + 1] = c4.y;
          w[4 * i + 2] = c4.z;
          w[4 * i + 3] = c4.w;
        }
#pragma unroll
        for (int q = 0; q < kPerThread; ++q)
#pragma unroll
          for (int j = 0; j < kPool; ++j) {
            const float s = u[q][a + j] + v[q][12 + j - a];
            const float d = u[q][a + j] - v[q][12 + j - a];
#pragma unroll
            for (int c = 0; c < kHalf; ++c) acc[q][j][c] = fmaf(w[c], s, acc[q][j][c]);
#pragma unroll
            for (int c = kHalf; c < kGroup; ++c) acc[q][j][c] = fmaf(w[c], d, acc[q][j][c]);
          }
      }
    }

    // epilogue: bias, |.|, the max over the pool's three frames (NaN
    // propagates, as max_pool1d's does), the bf16 rounding, one store each
    const int b = item / tiles, p0 = (item % tiles) * tile;
    const int* rg = rows + g * kGroup;
    const float* sg = shift + g * kGroup;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int p = p0 + first + 32 * q;
      if (p >= pooled) continue;
      float* o = out + (size_t)b * filters * pooled + p;
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        const float bc = __ldg(sg + c);
        float m = fabsf(acc[q][0][c] + bc);
#pragma unroll
        for (int j = 1; j < kPool; ++j) {
          const float y = fabsf(acc[q][j][c] + bc);
          if (y > m || y != y) m = y;
        }
        if (bf16) m = __bfloat162float(__float2bfloat16_rn(m));
        o[(size_t)__ldg(rg + c) * pooled] = m;
      }
    }
  }
}

}  // namespace

// wave: (B, 1, S) f32, S >= 251; taps, shift, rows: the prepared operands
// (`prepare_sinc_operands`, F / 20 groups, F / 20 in {1, 2, 4, 8}); out:
// (B, F, P) f32 with P = ((S - 251) / 10 + 1) / 3 >= 1; bf16: round the
// pooled value to bf16; grid: the persistent blocks (the launch plan's:
// two an SM, fewer where there are fewer items).
// Returns the launch's cudaError_t.
extern "C" int sinc_frontend_launch(const void* wave, const void* taps, const void* shift, const void* rows,
                                    void* out, int batch, int samples, int filters, int bf16, int grid,
                                    void* stream) {
  const int groups = filters / kGroup;
  if (batch < 1 || samples < kTaps || filters % kGroup != 0 || grid < 1 ||
      (groups != 1 && groups != 2 && groups != 4 && groups != 8))
    return (int)cudaErrorInvalidValue;
  const int pooled = ((samples - kTaps) / kStride + 1) / kPool;
  if (pooled < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(groups);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (const cudaError_t err =
          cudaFuncSetAttribute(sinc_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return (int)err;
  sinc_frontend_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(taps), static_cast<const float*>(shift),
      static_cast<const int*>(rows), static_cast<float*>(out), batch, samples, pooled, groups, filters, bf16);
  return (int)cudaGetLastError();
}

// the shared memory a block of a call with `filters` filters takes (the
// launch plan's `smem`), 0 where the kernel does not take that width
extern "C" long long sinc_frontend_smem(int filters) {
  const int groups = filters / kGroup;
  if (filters % kGroup != 0 || (groups != 1 && groups != 2 && groups != 4 && groups != 8)) return 0;
  return (long long)smem_bytes(groups);
}

extern "C" const char* sinc_frontend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
