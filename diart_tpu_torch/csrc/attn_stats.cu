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
// x (B, T, C) is f32 or bf16 and read once; hidden (B, T, H), w2 (H, C),
// b2 (C) and wt (B, S, T) are f32 (the wrapper casts them, as the TPU
// wrapper does). Only den/s1/s2 (B, S, C) f32 are written: the (B, T, C)
// logits and products never reach memory.
//
// What bounds it on the H100: at the ECAPA head (B=64, T=501, H=128,
// C=1536, S=4) the logits product is 12.6 GFLOP of f32 against ~115 MB
// of inputs, so the function is bound by f32 operations (~0.2 ms at
// 67 TFLOP/s), not bytes (~0.03 ms).
//
// Design: one block (8 warps) per (stream, tile of 64 channels). The
// block keeps w2's (H, 64) tile in shared memory and walks T in tiles of
// 64 frames, staging the hidden tile (64, H) and the speakers' weights.
// A thread owns 2 channels (lane) x 8 frames of the tile (warp): it
// computes their 16 logits with FMAs (hidden read as broadcast float4,
// w2 as float2) and folds them into its own online softmax: a running max
// and normaliser per channel, with the den/s1/s2 sums of the S speakers
// rescaled whenever the max rises. No thread waits on another inside the
// walk. At the end the 8 warps' partial states of a channel are merged in
// a fixed order through shared memory (max, then rescaled sums) and
// divided by the normaliser: no atomics, so results are deterministic.
// Frames t >= T are skipped. Tensor cores (the logits in TF32 or bf16)
// would change the f32 numbers of the TPU kernel and are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CT = 64;   // channels per block (2 per lane)
constexpr int TT = 64;   // frames per tile
constexpr int NW = 8;    // warps; warp w owns frames w*RW .. w*RW+RW-1 of a tile
constexpr int RW = TT / NW;
constexpr int NT = NW * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int S>
__global__ void __launch_bounds__(NT) attn_stats_kernel(
    const T* __restrict__ x, const float* __restrict__ hidden, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ wt, float* __restrict__ den,
    float* __restrict__ s1, float* __restrict__ s2, int time, int channels, int hdim) {
  extern __shared__ __align__(16) float smem[];
  float* w2s = smem;                    // [hdim][CT]
  float* hs = w2s + hdim * CT;          // [TT][hdim]
  float* wts = hs + TT * hdim;          // [S][TT]
  float* red = hs;                      // [NW][CT], reused after the walk
  float* lsum = hs + NW * CT;           // [CT]

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cl = 2 * lane;  // this thread's first channel within the tile

  for (int e = tid; e < hdim * CT; e += NT) {
    const int k = e / CT, c = e % CT;
    w2s[e] = (c0 + c < channels) ? w2[(size_t)k * channels + c0 + c] : 0.0f;
  }
  float bias[2];
  bool cok[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    cok[q] = c0 + cl + q < channels;
    bias[q] = cok[q] ? b2[c0 + cl + q] : 0.0f;
  }

  float m[2], l[2], ad[S][2], a1[S][2], a2[S][2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    m[q] = -INFINITY;
    l[q] = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) ad[s][q] = a1[s][q] = a2[s][q] = 0.0f;
  }

  const float* hb = hidden + (size_t)b * time * hdim;
  const T* xb = x + (size_t)b * time * channels;
  const float* wtb = wt + (size_t)b * S * time;

  for (int t0 = 0; t0 < time; t0 += TT) {
    __syncthreads();  // the previous tile's hs / wts are no longer read
    for (int e = tid; e < TT * hdim; e += NT) {
      const int t = e / hdim;
      hs[e] = (t0 + t < time) ? hb[(size_t)t0 * hdim + e] : 0.0f;
    }
    for (int e = tid; e < S * TT; e += NT) {
      const int s = e / TT, t = e % TT;
      wts[e] = (t0 + t < time) ? wtb[(size_t)s * time + t0 + t] : 0.0f;
    }
    __syncthreads();

    float lg[RW][2];
#pragma unroll
    for (int i = 0; i < RW; ++i) lg[i][0] = lg[i][1] = 0.0f;
    const float* hrow = hs + (warp * RW) * hdim;
    for (int k = 0; k < hdim; k += 4) {
      float2 wv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wv[kk] = *reinterpret_cast<const float2*>(&w2s[(k + kk) * CT + cl]);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(&hrow[i * hdim + k]);
        lg[i][0] = fmaf(hv.x, wv[0].x, lg[i][0]);
        lg[i][1] = fmaf(hv.x, wv[0].y, lg[i][1]);
        lg[i][0] = fmaf(hv.y, wv[1].x, lg[i][0]);
        lg[i][1] = fmaf(hv.y, wv[1].y, lg[i][1]);
        lg[i][0] = fmaf(hv.z, wv[2].x, lg[i][0]);
        lg[i][1] = fmaf(hv.z, wv[2].y, lg[i][1]);
        lg[i][0] = fmaf(hv.w, wv[3].x, lg[i][0]);
        lg[i][1] = fmaf(hv.w, wv[3].y, lg[i][1]);
      }
    }

    const int nvalid = min(RW, max(0, time - (t0 + warp * RW)));
    if (nvalid == 0) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float tmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        lg[i][q] += bias[q];
        if (i < nvalid) tmax = fmaxf(tmax, lg[i][q]);
      }
      const float mn = fmaxf(m[q], tmax);
      const float sc = expf(m[q] - mn);  // 0 on the first valid tile
      m[q] = mn;
      l[q] *= sc;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        ad[s][q] *= sc;
        a1[s][q] *= sc;
        a2[s][q] *= sc;
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (i >= nvalid) break;
      const int t = warp * RW + i;
      const T* xr = xb + (size_t)(t0 + t) * channels + c0 + cl;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float e = expf(lg[i][q] - m[q]);
        const float xv = cok[q] ? to_f(xr[q]) : 0.0f;
        const float ex = e * xv;
        const float exx = ex * xv;
        l[q] += e;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float wv = wts[s * TT + t];
          ad[s][q] = fmaf(wv, e, ad[s][q]);
          a1[s][q] = fmaf(wv, ex, a1[s][q]);
          a2[s][q] = fmaf(wv, exx, a2[s][q]);
        }
      }
    }
  }
  __syncthreads();

  // merge the NW warps' partial softmax states of each channel, fixed order
  float f[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) red[warp * CT + cl + q] = m[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float mx = -INFINITY;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red[w * CT + cl + q]);
    f[q] = (m[q] == -INFINITY) ? 0.0f : expf(m[q] - mx);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q) red[warp * CT + cl + q] = l[q] * f[q];
  __syncthreads();
  if (tid < CT) {
    float sum = 0.0f;
    for (int w = 0; w < NW; ++w) sum += red[w * CT + tid];
    lsum[tid] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 3 * S; ++j) {
    const int s = j / 3, which = j % 3;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float v = which == 0 ? ad[s][q] : (which == 1 ? a1[s][q] : a2[s][q]);
      red[warp * CT + cl + q] = v * f[q];
    }
    __syncthreads();
    if (tid < CT && c0 + tid < channels) {
      float sum = 0.0f;
      for (int w = 0; w < NW; ++w) sum += red[w * CT + tid];
      float* dst = which == 0 ? den : (which == 1 ? s1 : s2);
      dst[((size_t)b * S + s) * channels + c0 + tid] = sum / lsum[tid];
    }
    __syncthreads();
  }
}

// w2 tile, then the walk's hidden tile and weights or, after it, the merge buffers
size_t smem_bytes(int hdim, int speakers) {
  const size_t walk = (size_t)TT * hdim + (size_t)speakers * TT;
  const size_t merge = (size_t)NW * CT + CT;
  return sizeof(float) * ((size_t)hdim * CT + (walk > merge ? walk : merge));
}

template <typename T, int S>
int launch_s(const void* x, const float* hidden, const float* w2, const float* b2,
             const float* wt, float* den, float* s1, float* s2, int batch, int time,
             int channels, int hdim, cudaStream_t stream) {
  const size_t smem = smem_bytes(hdim, S);
  cudaError_t err = cudaFuncSetAttribute(attn_stats_kernel<T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((channels + CT - 1) / CT, batch);
  attn_stats_kernel<T, S><<<grid, NT, smem, stream>>>(static_cast<const T*>(x), hidden, w2, b2,
                                                      wt, den, s1, s2, time, channels, hdim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* hidden, const float* w2, const float* b2, const float* wt,
           float* den, float* s1, float* s2, int batch, int time, int channels, int hdim,
           int speakers, cudaStream_t stream) {
#define DIART_ATTN_CASE(S_) \
  case S_:                  \
    return launch_s<T, S_>(x, hidden, w2, b2, wt, den, s1, s2, batch, time, channels, hdim, stream);
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

// dtype of x: 0 = float32, 1 = bfloat16. hidden (B, T, H), w2 (H, C),
// b2 (C,), wt (B, S, T): f32, contiguous; den/s1/s2: (B, S, C) f32.
// H must be a multiple of 4 (float4 reads) and fit the shared-memory
// budget. Returns the launch's cudaError_t.
extern "C" int attn_stats_launch(const void* x, const void* hidden, const void* w2,
                                 const void* b2, const void* wt, void* den, void* s1, void* s2,
                                 int batch, int time, int channels, int hdim, int speakers,
                                 int dtype, void* stream) {
  if (batch < 1 || time < 1 || channels < 1 || hdim < 4 || hdim % 4 || batch > 65535 ||
      smem_bytes(hdim, speakers) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, f(hidden), f(w2), f(b2), f(wt), o(den), o(s1), o(s2), batch, time,
                         channels, hdim, speakers, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f(hidden), f(w2), f(b2), f(wt), o(den), o(s1), o(s2), batch,
                                 time, channels, hdim, speakers, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* attn_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
