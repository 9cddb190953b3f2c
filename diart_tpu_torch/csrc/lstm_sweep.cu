// Bidirectional LSTM sweep over a pre-projected gate stream, for Hopper.
//
// Replaces the TPU kernels `_lstm_kernel` / `_lstm_block_kernel` of
// diart_tpu/ops/pallas_lstm.py (reached through `_pallas_sweep` and
// `_pallas_sweep_blocked`, i.e. `lstm_sweep_tm`). Same function:
//
//   proj (T, 2, B, 4H) -> out (T, 2, B, H), both directions in natural time
//   order; direction 1 walks t = T-1 .. 0 by indexing (no flipped copies).
//   gates = proj[t] + h_{t-1} @ w_hh^T   (gate order i, f, g, o)
//   c = sig(f) * c + sig(i) * tanh(g);  h = sig(o) * tanh(c)
//
// h and c are f32; h is rounded to the stream dtype before it multiplies
// w_hh (as the TPU kernel casts h to w_hh's dtype), and the output is
// written in the stream dtype. Gate math uses precise expf/tanhf.
//
// What bounds it on the H100: not bytes or FLOPs. At T=293, B=64, H=128 a
// layer moves ~48 MB (bf16) and does ~4.9 GFLOP — ~15 us at the card's
// peaks — but the recurrence is 293 dependent steps, each a (B, H) x (H, 4H)
// product followed by a barrier. The kernel is latency-bound: its time is
// T x (the time of one step inside one block).
//
// Design:
// * ONE persistent launch per layer: the whole time loop runs inside the
//   kernel (never one launch per step). One block per (direction, tile of
//   BT batch rows). Each step has two phases split by __syncthreads:
//   1. the (BT, H) x (H, 4H) product: KS groups of H threads each take a
//      quarter (KS=4) or half (KS=2) of the k range; thread j of a group
//      accumulates all four gate rows of hidden unit j for the BT rows and
//      leaves its partial sums in shared memory;
//   2. thread (j, q) sums the KS partials of its gates in a fixed order
//      (deterministic) and updates the cell of hidden unit j for batch
//      rows b = q, q + KS, ...: c stays in that thread's registers, h goes
//      to shared memory for the next step and to the output.
// * w_hh is packed by the wrapper as (2, H_k, H_j, 4 gates) so thread j
//   reads its 4 gate weights for one k with one vector load, neighbouring
//   threads on neighbouring addresses. In bf16 (the default stream dtype)
//   one direction's w_hh is 4H*H*2 = 128 KB and is held in dynamic shared
//   memory for the whole sweep. In f32 it is 256 KB, above the 227 KB a
//   block may use, so the f32 path reads it through L2 (resident there:
//   512 KB for both directions).
// * Each step's gate-stream values are loaded one step ahead, so their
//   latency hides behind the previous step.
// * BT adapts to the batch and the card: with w_hh in shared memory the
//   smallest BT in {1, 2, 4, 8} whose 2 * ceil(B / BT) blocks fit one wave
//   on the card's SMs (B=64 on an H100: BT=1, 128 blocks) — the per-step
//   latency shrinks with BT while every extra block takes an idle SM. The
//   f32 path, whose weights come from L2 per step, keeps BT=4 so fewer
//   blocks re-read them.
// * Known limit, left for later work: beyond one wave (B > 4 x SMs) the
//   blocks run in several waves; splitting a direction's gate rows over a
//   thread-block cluster would then cut the per-step time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB, the per-block opt-in limit

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load_w4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load_w4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

// BT consecutive floats from shared memory (16-byte aligned when BT >= 4)
template <int BT>
__device__ __forceinline__ void load_h(const float* p, float (&h)[BT]) {
  if constexpr (BT == 1) {
    h[0] = p[0];
  } else if constexpr (BT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    h[0] = v.x; h[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < BT; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      h[i] = v.x; h[i + 1] = v.y; h[i + 2] = v.z; h[i + 3] = v.w;
    }
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// proj: (T, 2, B, 4H); wp: (2, H, H, 4) packed [d][k][j][gate]; out: (T, 2, B, H).
// blockDim.x = KS * hp, hp = H rounded up to a warp.
template <typename T, bool W_SMEM, int BT, int KS>
__global__ void __launch_bounds__(512) lstm_sweep_kernel(
    const T* __restrict__ proj, const T* __restrict__ wp, T* __restrict__ out,
    int time, int batch, int hidden) {
  constexpr int RB = (BT + KS - 1) / KS;  // batch rows each thread updates
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = blockDim.x / KS;
  float* h_s = reinterpret_cast<float*>(smem);  // [hp][BT]
  float* red = h_s + hp * BT;                   // [KS][4][BT][hp]
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int q = threadIdx.x / hp;
  const int j = threadIdx.x % hp;
  const bool active = j < hidden;
  const int kc = (hidden + KS - 1) / KS;
  const int k0 = q * kc;
  const int k1 = min(hidden, k0 + kc);

  const T* w = wp + (size_t)d * hidden * hidden * 4;
  if constexpr (W_SMEM) {
    T* w_s = reinterpret_cast<T*>(red + KS * 4 * BT * hp);
    using Quad = typename std::conditional<sizeof(T) == 4, float4, uint2>::type;
    const Quad* src = reinterpret_cast<const Quad*>(w);
    Quad* dst = reinterpret_cast<Quad*>(w_s);
    for (int i = threadIdx.x; i < hidden * hidden; i += blockDim.x) dst[i] = src[i];
    w = w_s;
  }
  for (int i = threadIdx.x; i < hp * BT; i += blockDim.x) h_s[i] = 0.0f;
  __syncthreads();

  const size_t slab = (size_t)batch * 4 * hidden;  // elements per (t, d)
  auto load_x = [&](int t, float (&dst)[4][RB]) {
    const int tt = d == 0 ? t : time - 1 - t;
    const T* base = proj + ((size_t)tt * 2 + d) * slab;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int b = q + r * KS;
      const bool ok = active && b < BT && (b0 + b) < batch;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        dst[g][r] = ok ? to_f(base[(size_t)(b0 + b) * 4 * hidden + g * hidden + j]) : 0.0f;
    }
  };

  float c[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) c[r] = 0.0f;
  float xn[4][RB];
  load_x(0, xn);

  for (int t = 0; t < time; ++t) {
    float xc[4][RB];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < RB; ++r) xc[g][r] = xn[g][r];
    if (t + 1 < time) load_x(t + 1, xn);

    // phase 1: partial gate sums over this group's k range
    if (active) {
      float acc[4][BT];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[g][b] = 0.0f;
      const T* wj = w + (size_t)j * 4;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        float hv[BT];
        load_h<BT>(h_s + k * BT, hv);
        float wk[4];
        load_w4(wj + (size_t)k * hidden * 4, wk);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[g][b] = fmaf(wk[g], hv[b], acc[g][b]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int b = 0; b < BT; ++b) red[((q * 4 + g) * BT + b) * hp + j] = acc[g][b];
    }
    __syncthreads();

    // phase 2: gates, cell and hidden state of unit j for rows q, q+KS, ...
    const int tt = d == 0 ? t : time - 1 - t;
    T* orow = out + (((size_t)tt * 2 + d) * batch) * hidden;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int b = q + r * KS;
      if (active && b < BT) {
        float gs[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = 0.0f;
#pragma unroll
          for (int qq = 0; qq < KS; ++qq) sum += red[((qq * 4 + g) * BT + b) * hp + j];
          gs[g] = xc[g][r] + sum;
        }
        c[r] = sigmoid(gs[1]) * c[r] + sigmoid(gs[0]) * tanhf(gs[2]);
        const T hq = from_f<T>(sigmoid(gs[3]) * tanhf(c[r]));
        h_s[j * BT + b] = to_f(hq);
        if (b0 + b < batch) orow[(size_t)(b0 + b) * hidden + j] = hq;
      }
    }
    __syncthreads();
  }
}

struct Plan {
  int bt, ks, hp;
  bool w_smem;
  size_t smem;
};

Plan plan(int batch, int hidden, size_t elt, int num_sms) {
  Plan p;
  p.hp = (hidden + 31) / 32 * 32;
  p.ks = p.hp <= 128 ? 4 : 2;
  const size_t w_bytes = (size_t)hidden * hidden * 4 * elt;
  auto smem_for = [&](int bt, bool w_smem) {
    return (size_t)p.hp * bt * 4 + (size_t)p.ks * 4 * bt * p.hp * 4 + (w_smem ? w_bytes : 0);
  };
  p.w_smem = smem_for(1, true) <= kMaxSmem;
  if (p.w_smem) {
    p.bt = 8;
    for (int bt : {1, 2, 4, 8}) {
      if (2 * ((batch + bt - 1) / bt) <= num_sms) {
        p.bt = bt;
        break;
      }
    }
    while (p.bt > 1 && smem_for(p.bt, true) > kMaxSmem) p.bt /= 2;
  } else {
    p.bt = 4;
  }
  p.smem = smem_for(p.bt, p.w_smem);
  return p;
}

template <typename T, bool W, int BT>
int launch_bt(const Plan& p, const void* proj, const void* wp, void* out, int time, int batch,
              int hidden, cudaStream_t stream) {
  auto kern = p.ks == 4 ? lstm_sweep_kernel<T, W, BT, 4> : lstm_sweep_kernel<T, W, BT, 2>;
  if (p.smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((batch + BT - 1) / BT, 2);
  kern<<<grid, p.ks * p.hp, p.smem, stream>>>(static_cast<const T*>(proj),
                                             static_cast<const T*>(wp), static_cast<T*>(out),
                                             time, batch, hidden);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(const Plan& p, const void* proj, const void* wp, void* out, int time, int batch,
             int hidden, cudaStream_t s) {
  switch (p.bt) {
    case 1: return launch_bt<T, true, 1>(p, proj, wp, out, time, batch, hidden, s);
    case 2: return launch_bt<T, true, 2>(p, proj, wp, out, time, batch, hidden, s);
    case 4: return launch_bt<T, true, 4>(p, proj, wp, out, time, batch, hidden, s);
    default: return launch_bt<T, true, 8>(p, proj, wp, out, time, batch, hidden, s);
  }
}

template <typename T>
int launch(const void* proj, const void* wp, void* out, int time, int batch, int hidden,
           int num_sms, cudaStream_t stream) {
  const Plan p = plan(batch, hidden, sizeof(T), num_sms);
  if (p.w_smem) return launch_w<T>(p, proj, wp, out, time, batch, hidden, stream);
  return launch_bt<T, false, 4>(p, proj, wp, out, time, batch, hidden, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; num_sms: the card's SM count (sizes the
// batch tile). Returns the cudaError_t of the launch.
extern "C" int lstm_sweep_launch(const void* proj, const void* wp, void* out, int time, int batch,
                                 int hidden, int dtype, int num_sms, void* stream) {
  if (time < 1 || batch < 1 || hidden < 1 || hidden > 256 || num_sms < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(proj, wp, out, time, batch, hidden, num_sms, s);
  if (dtype == 1) return launch<__nv_bfloat16>(proj, wp, out, time, batch, hidden, num_sms, s);
  return (int)cudaErrorInvalidValue;
}

// The launch plan for a sweep of this size: rows per block (BT), k groups
// (KS), and 1 if w_hh is held in shared memory — for reports.
extern "C" void lstm_sweep_plan(int batch, int hidden, int dtype, int num_sms, int* bt, int* ks,
                                int* w_smem) {
  const Plan p = plan(batch, hidden, dtype == 0 ? 4 : 2, num_sms);
  *bt = p.bt;
  *ks = p.ks;
  *w_smem = p.w_smem;
}

extern "C" const char* lstm_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
