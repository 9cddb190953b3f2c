// Backward of the bidirectional LSTM sweep, for Hopper.
//
// Replaces no Pallas kernel: diart_tpu differentiates its sweep with the
// VJP of `_with_vjp_tm` (diart_tpu/ops/pallas_lstm.py:303-305), `jax.vjp`
// of `_tm_reference`, an XLA scan that XLA compiles together with its VJP
// into one loop on the device. Added because autograd through the plain
// step loop makes some 13k launches a layer. Plain version:
// `_bptt_reference` in diart_tpu_torch/ops/lstm_sweep.py; the wrapper
// `lstm_sweep_backward` runs the two large products around it (every
// step's recurrent product r(h_{s-1}) W^T before, the weight gradient
// after) as batched products.
//
// Function (per direction d, step s at time t = s for d = 0, T-1-s for
// d = 1; r rounds to the stream dtype, the identity for f32; W = r(w_hh[d])):
//   phase A, s = 0 .. T-1:   a_s = float(proj[t, d]) + pre[d, t]
//                            c_s = sig(a_f) c_{s-1} + sig(a_i) tanh(a_g)
//   phase B, s = T-1 .. 0:   dh = float(dout[t, d]) + e_{s+1}
//                            dc = dh o (1 - tanh^2 c_s) + dc_{s+1} f_{s+1}
//                            da = [dc g i(1-i), dc c_{s-1} f(1-f),
//                                  dc i (1-g^2), dh tanh(c_s) o(1-o)]
//                            e_s = r(da W)       (e_T = 0, dc_T = 0)
// da overwrites pre in place: (2, T, B, 4H) f32.
//
// What bounds it on the H100: not bytes or FLOPs. At T=293, B=64, H=128 it
// moves ~80 MB and does ~4.9 GFLOP of f32 FMAs (~0.07 ms at the card's f32
// peak), but phase B is T dependent steps: each needs the whole da of the
// step before. The kernel is latency-bound, as the forward: its time is
// T x (one step inside one block). ONE persistent launch a layer; one
// block per (direction, batch tile), one thread per hidden unit j, which
// updates the cells (b, j) of its tile's rows AND computes e[b][j] (column
// j of W against the rows of da), so e never leaves the thread's registers
// and a step has ONE barrier: da goes through a double-buffered shared
// tile. The product is f32 FMAs on purpose: the plain version multiplies
// an f32 da by W in f32, and a bf16 tensor-core product would round da
// first. W sits in shared memory laid out [m / 4][j][m % 4] (four rows m
// of a thread's column in one 8- or 16-byte load): all of it for bf16 at
// H <= 128; for f32 at H = 128 (256 KB) the first rows that fit (111 of
// 128 groups of four) and the rest through L2. Phase A is elementwise on
// each thread's own cells (no barrier); its loads are issued 8 cells-steps
// ahead. Phase B loads step s-1's inputs before step s's product. Precise
// expf / tanhf and IEEE division (the gradient is held to f32 autograd at
// 1e-5). Deterministic: fixed sum orders, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB, the per-block opt-in limit
constexpr int kMaxThreads = 256;     // one thread a hidden unit, H <= 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// r: the rounding to the stream dtype
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four consecutive stream values (16 B f32, 8 B bf16) as floats, from
// shared memory or, through the read-only path, from global memory
__device__ __forceinline__ void unpack4(const float4& v, float (&w)[4]) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void unpack4(const uint2& v, float (&w)[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}
template <typename T>
using Quad = typename std::conditional<sizeof(T) == 4, float4, uint2>::type;

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&w)[4]) {
  unpack4(*reinterpret_cast<const Quad<T>*>(p), w);
}
template <typename T>
__device__ __forceinline__ void ldg4(const T* p, float (&w)[4]) {
  unpack4(__ldg(reinterpret_cast<const Quad<T>*>(p)), w);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// proj (T, 2, B, 4H) and dout (T, 2, B, H) in the stream dtype; gates
// (2, T, B, 4H) f32, in: r(h_{s-1}) W^T, out: da; wp (2, H, H, 4) in the
// stream dtype, [d][m / 4][j][m % 4] = w_hh[d][m][j]; cells (2, T, B, H)
// f32 scratch (c_s). blockDim.x = H rounded up to a warp; the first w_rows
// groups of four rows of wp are copied to shared memory.
template <typename T, int BT>
__global__ void __launch_bounds__(kMaxThreads, 1) lstm_sweep_bwd_kernel(
    const T* __restrict__ proj, float* __restrict__ gates, const T* __restrict__ dout,
    const T* __restrict__ wp, float* __restrict__ cells, int time, int batch, int hidden,
    int w_rows) {
  constexpr int U = BT >= 8 ? 1 : 8 / BT;  // phase A: steps whose loads fly together
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = hidden, G = 4 * hidden;
  float* da_s = reinterpret_cast<float*>(smem);       // [2][BT][4H]
  T* w_s = reinterpret_cast<T*>(da_s + 2 * BT * G);   // [w_rows][H][4]
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;
  const bool active = j < H;
  const T* w = wp + (size_t)d * H * H * 4;
  {
    const Quad<T>* src = reinterpret_cast<const Quad<T>*>(w);
    Quad<T>* dst = reinterpret_cast<Quad<T>*>(w_s);
    for (int q = threadIdx.x; q < w_rows * H; q += blockDim.x) dst[q] = src[q];
  }
  bool ok[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) ok[r] = active && b0 + r < batch;

  const size_t gsl = (size_t)batch * G;  // proj / gates elements per (time, direction)
  const size_t hsl = (size_t)batch * H;  // dout / cells elements per (time, direction)
  auto tof = [&](int s) { return d == 0 ? s : time - 1 - s; };
  auto pidx = [&](int t, int r) { return ((size_t)t * 2 + d) * gsl + (size_t)(b0 + r) * G + j; };
  auto gidx = [&](int t, int r) { return ((size_t)d * time + t) * gsl + (size_t)(b0 + r) * G + j; };
  auto hidx = [&](int t, int r) { return ((size_t)t * 2 + d) * hsl + (size_t)(b0 + r) * H + j; };
  auto cidx = [&](int t, int r) { return ((size_t)d * time + t) * hsl + (size_t)(b0 + r) * H + j; };

  // ---- phase A: the forward's cell states, step by step, in f32 scratch
  {
    float c[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) c[r] = 0.0f;
    for (int s0 = 0; s0 < time; s0 += U) {
      float xa[U][BT][3];  // gates i, f, g of U steps, loaded together
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const bool in = ok[r] && s0 + u < time;
          const int t = tof(s0 + u);
#pragma unroll
          for (int g = 0; g < 3; ++g)
            xa[u][r][g] = in ? to_f(proj[pidx(t, r) + g * H]) + gates[gidx(t, r) + g * H] : 0.0f;
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s0 + u >= time) break;
        const int t = tof(s0 + u);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          c[r] = sigmoid(xa[u][r][1]) * c[r] + sigmoid(xa[u][r][0]) * tanhf(xa[u][r][2]);
          if (ok[r]) cells[cidx(t, r)] = c[r];
        }
      }
    }
  }

  // ---- phase B: back through time
  float e[BT], dcn[BT], fn[BT];  // e_{s+1}, dc_{s+1}, f_{s+1}
  // step s's inputs: pre-activations, c_s, c_{s-1}, dout; loaded a step ahead
  float na[BT][4], ncs[BT], ncp[BT], nd[BT];
  auto load_step = [&](int s) {
    const int t = tof(s), tp = tof(s - 1);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (ok[r]) {
#pragma unroll
        for (int g = 0; g < 4; ++g) na[r][g] = to_f(proj[pidx(t, r) + g * H]) + gates[gidx(t, r) + g * H];
        ncs[r] = cells[cidx(t, r)];
        ncp[r] = s > 0 ? cells[cidx(tp, r)] : 0.0f;
        nd[r] = to_f(dout[hidx(t, r)]);
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g) na[r][g] = 0.0f;
        ncs[r] = ncp[r] = nd[r] = 0.0f;
      }
    }
  };
#pragma unroll
  for (int r = 0; r < BT; ++r) e[r] = dcn[r] = fn[r] = 0.0f;
  load_step(time - 1);

  for (int s = time - 1; s >= 0; --s) {
    float a[BT][4], cs[BT], cp[BT], dd[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
#pragma unroll
      for (int g = 0; g < 4; ++g) a[r][g] = na[r][g];
      cs[r] = ncs[r]; cp[r] = ncp[r]; dd[r] = nd[r];
    }
    if (s > 0) load_step(s - 1);  // in flight under this step's work

    float* dab = da_s + (s & 1) * BT * G;
    const int t = tof(s);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float ig = sigmoid(a[r][0]), fg = sigmoid(a[r][1]);
      const float gg = tanhf(a[r][2]), og = sigmoid(a[r][3]);
      const float tc = tanhf(cs[r]);
      const float dh = dd[r] + e[r];
      const float dc = dh * og * (1.0f - tc * tc) + dcn[r] * fn[r];
      const float di = dc * gg * (1.0f - ig) * ig;
      const float df = dc * cp[r] * (1.0f - fg) * fg;
      const float dg = dc * ig * (1.0f - gg * gg);
      const float dout_o = dh * tc * (1.0f - og) * og;
      dcn[r] = dc;
      fn[r] = fg;
      if (active) {
        float* row = dab + r * G + j;
        row[0] = di; row[H] = df; row[2 * H] = dg; row[3 * H] = dout_o;
      }
      if (ok[r]) {
        float* gp = gates + gidx(t, r);
        gp[0] = di; gp[H] = df; gp[2 * H] = dg; gp[3 * H] = dout_o;
      }
    }
    __syncthreads();  // the step's da is whole; the other buffer is free

    if (s > 0 && active) {
      // e_s[b][j] = r(sum_m da[b][m] W[m][j]): four chains (m % 4), summed
      // in a fixed order
      float acc[BT][4];
#pragma unroll
      for (int r = 0; r < BT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      auto fma_rows = [&](int m4, const float (&wv)[4]) {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(dab + r * G + 4 * m4);
          acc[r][0] = fmaf(x.x, wv[0], acc[r][0]);
          acc[r][1] = fmaf(x.y, wv[1], acc[r][1]);
          acc[r][2] = fmaf(x.z, wv[2], acc[r][2]);
          acc[r][3] = fmaf(x.w, wv[3], acc[r][3]);
        }
      };
#pragma unroll 4
      for (int m4 = 0; m4 < w_rows; ++m4) {
        float wv[4];
        load4(w_s + ((size_t)m4 * H + j) * 4, wv);
        fma_rows(m4, wv);
      }
#pragma unroll 4
      for (int m4 = w_rows; m4 < H; ++m4) {
        float wv[4];
        ldg4(w + ((size_t)m4 * H + j) * 4, wv);
        fma_rows(m4, wv);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) e[r] = rnd<T>((acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]));
    }
  }
}

struct Plan {
  int bt, w_rows, threads;
  size_t smem;
};

// the smallest batch tile whose blocks fit one wave of the card; W's
// leading rows in the shared memory that the da tile leaves
Plan plan(int batch, int hidden, size_t elt, int num_sms) {
  Plan p;
  p.threads = (hidden + 31) / 32 * 32;
  p.bt = 8;
  for (int bt : {1, 2, 4, 8}) {
    if (2 * ((batch + bt - 1) / bt) <= num_sms) {
      p.bt = bt;
      break;
    }
  }
  const size_t da = (size_t)2 * p.bt * 4 * hidden * sizeof(float);
  const size_t row = (size_t)hidden * 4 * elt;  // four rows m of W, every column
  p.w_rows = (int)std::min<size_t>((size_t)hidden, (kMaxSmem - da) / row);
  p.smem = da + (size_t)p.w_rows * row;
  return p;
}

template <typename T, int BT>
int launch_bt(const Plan& p, const void* proj, void* gates, const void* dout, const void* wp,
              void* cells, int time, int batch, int hidden, cudaStream_t stream) {
  auto kern = lstm_sweep_bwd_kernel<T, BT>;
  if (p.smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((batch + BT - 1) / BT, 2);
  kern<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(proj), static_cast<float*>(gates), static_cast<const T*>(dout),
      static_cast<const T*>(wp), static_cast<float*>(cells), time, batch, hidden, p.w_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* proj, void* gates, const void* dout, const void* wp, void* cells, int time,
           int batch, int hidden, int num_sms, cudaStream_t s) {
  const Plan p = plan(batch, hidden, sizeof(T), num_sms);
  switch (p.bt) {
    case 1: return launch_bt<T, 1>(p, proj, gates, dout, wp, cells, time, batch, hidden, s);
    case 2: return launch_bt<T, 2>(p, proj, gates, dout, wp, cells, time, batch, hidden, s);
    case 4: return launch_bt<T, 4>(p, proj, gates, dout, wp, cells, time, batch, hidden, s);
    default: return launch_bt<T, 8>(p, proj, gates, dout, wp, cells, time, batch, hidden, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (proj, dout, wp); gates and cells f32.
// num_sms: the card's SM count (sizes the batch tile). Returns the
// cudaError_t of the launch.
extern "C" int lstm_sweep_bwd_launch(const void* proj, void* gates, const void* dout,
                                     const void* wp, void* cells, int time, int batch, int hidden,
                                     int dtype, int num_sms, void* stream) {
  if (time < 1 || batch < 1 || hidden < 1 || hidden > kMaxThreads || num_sms < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(proj, gates, dout, wp, cells, time, batch, hidden, num_sms, s);
  return launch<__nv_bfloat16>(proj, gates, dout, wp, cells, time, batch, hidden, num_sms, s);
}

// The launch plan, for reports: batch rows per block and how many of W's
// groups of four rows (of H) sit in shared memory.
extern "C" void lstm_sweep_bwd_plan(int batch, int hidden, int dtype, int num_sms, int* bt,
                                    int* w_rows) {
  const Plan p = plan(batch, hidden, dtype == 0 ? 4 : 2, num_sms);
  *bt = p.bt;
  *w_rows = p.w_rows;
}

extern "C" const char* lstm_sweep_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
