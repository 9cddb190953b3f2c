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
// What bounds it on the H100: not bytes or FLOPs alone. At T=293, B=64,
// H=128 its inputs and outputs are ~80 MB and it does ~4.9 GFLOP of f32
// FMAs (~0.07 ms at the card's f32 peak), but phase B is T dependent
// steps: each needs the whole da of the step before. Its time is phase A
// (parallel over time, bounded by bytes) plus T x (one step of phase B in
// one block or cluster). ONE persistent launch a layer. The product is f32
// FMAs on purpose: the plain version multiplies an f32 da by W in f32, and
// a bf16 tensor-core product would round da first. Precise expf / tanhf
// and IEEE division (the gradient is held to f32 autograd at 1e-5).
// Deterministic: fixed sum orders, no atomics.
//
// Two routes, chosen by H (`lstm_sweep_bwd_plan` reports them):
//
// * Split route (H = 128 or 64, both dtypes). A step of the column route
//   below streams all of W through shared memory: one thread a unit walks
//   the 4H rows of its column, 128 / 227 KB a step at H = 128 (bf16 / f32),
//   f32's last 68 rows through L2, one warp on each scheduler: ~6,700 /
//   8,500 cycles a step. Here W never moves during the walk. A block holds
//   64 units (columns of W) and all 4H rows of them in registers: 4H x 64
//   f32 values over 4H threads, 64 registers a thread (the f32 value of
//   r(w_hh) in both dtypes, so the product needs no unpacking). At H = 128
//   that is 128 KB a block, and a direction's W (256 KB, the whole register
//   file of one SM) takes a CLUSTER OF 2 blocks, one for units 0..63, one
//   for 64..127; at H = 64 one block of 256 threads holds it. ptxas: 124-132
//   registers a thread, no spill. W's rows are in unit-major order (row 4 u
//   + g is gate g of unit u). Thread tid = 16 p + q holds rows 16p .. 16p+15
//   (its "part": units 4p .. 4p+3) of columns 4q .. 4q+3 of its block, so
//   each unit's 4H-row sum is split over 4H / 16 parts, i.e. over every warp
//   of the block (16 at H = 128: 4 a scheduler). A part is one FMA chain of
//   16 rows a column and batch row, reading da as 4 broadcast 16-byte loads
//   a batch row (each feeds 16 FMAs: shared memory delivers 32 floats a
//   clock to 128 FMA lanes). The parts' sums go to shared memory; the thread
//   of cell (b, u) adds them as a balanced tree in part order and rounds
//   once: e = r(sum). It then writes its unit's four da (16 bytes) into its
//   block's da buffer and, with `st.async`, into its peer's, where the bytes
//   complete a phase of the peer's mbarrier (one a step parity; da double-
//   buffered by the step's parity, so a block may write step s-1 while its
//   peer still reads step s). A step is: the cell update, a block barrier,
//   the product (warps whose parts are the block's own units at once, the
//   others after the mbarrier), a block barrier, the tree. No cluster-scope
//   fence a step: a cluster barrier's release would wait for the loads in
//   flight two steps ahead and for da's global stores. The batch tile BT (1
//   or 2 rows) is the smallest whose 2 x ceil(B / BT) x cluster blocks fit
//   one wave of SMs: BT = 1 at B = 32 and BT = 2 at B = 64 for H = 128 (128
//   blocks; the card holds 66 such clusters). Phase A works in chunks of
//   steps: every thread computes the gates of 4 cells side by side (loads a
//   chunk ahead, kept raw until used) and tanh c of its cells two chunks
//   back; one thread a cell scans c through the chunk from shared memory. It
//   leaves in pre [g i(1-i), f, i(1-g^2), o] and in a scratch (2, T, B, 2,
//   H) [c_{s-1} f(1-f), tanh c_s], so phase B's cell update is a few
//   multiplies on values loaded two steps ahead. Measured (chip_smoke.py
//   phase 8 and scripts/lstm_bwd_step_probe.py, a clock64 copy of this
//   source; H100 80GB HBM3, 700 W): phase A is ~30% of the kernel and moves
//   ~230-270 MB at B = 64 (proj and pre read, the six values a cell written)
//   at ~80% of the card's HBM rate; a phase-B step takes ~1,460 cycles at B
//   = 64, of which the cell thread's tree ~350, its update and stores ~215,
//   and the product ~700 (its FMAs alone 512 a scheduler at BT = 2, beside
//   the broadcast loads of da), while the product warps wait at the barrier
//   for the tree and the update. What a step still waits for: the product's
//   issue and shared-memory traffic and, around it, one serial tree and cell
//   update.
// * Column route (every other H <= 256, e.g. H = 20, or 256 whose f32 W
//   of 1 MB a direction fits no cluster's registers). One block per
//   (direction, batch tile), one thread per hidden unit j, which
//   updates the cells (b, j) of its tile's rows AND computes e[b][j]
//   (column j of W against the rows of da), so e never leaves the thread's
//   registers and a step has ONE barrier: da goes through a
//   double-buffered shared tile. W sits in shared memory laid out
//   [m / 4][j][m % 4] (four rows m of a thread's column in one 8- or
//   16-byte load): all of it when it fits, else the first rows that fit
//   and the rest through L2. Phase A is elementwise on each thread's own
//   cells (no barrier); its loads are issued 8 cells-steps ahead. Phase B
//   loads step s-1's inputs before step s's product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper.cuh"

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
int launch_column(const void* proj, void* gates, const void* dout, const void* wp, void* cells,
                  int time, int batch, int hidden, int num_sms, cudaStream_t s) {
  const Plan p = plan(batch, hidden, sizeof(T), num_sms);
  switch (p.bt) {
    case 1: return launch_bt<T, 1>(p, proj, gates, dout, wp, cells, time, batch, hidden, s);
    case 2: return launch_bt<T, 2>(p, proj, gates, dout, wp, cells, time, batch, hidden, s);
    case 4: return launch_bt<T, 4>(p, proj, gates, dout, wp, cells, time, batch, hidden, s);
    default: return launch_bt<T, 8>(p, proj, gates, dout, wp, cells, time, batch, hidden, s);
  }
}

// ------------------------------------------------------------ split route

namespace cg = cooperative_groups;

constexpr int kUnits = 64;  // units (columns of W) a block holds
constexpr int kRows = 16;   // rows of W a thread holds: one part
constexpr int kCols = 4;    // columns of W a thread holds
constexpr int kCellsA = 4;  // phase A: cells a thread takes a chunk

template <int H>
struct Split {
  static constexpr int kCluster = H / kUnits;  // blocks a cluster: 2 at H = 128, 1 at H = 64
  static constexpr int kThreads = 4 * H;       // kParts parts x 16 column quads
  static constexpr int kParts = 4 * H / kRows;
  static constexpr int kSlots = kThreads / kUnits;  // phase A: cells of a unit one pass takes
  static constexpr int kChunk = kCellsA * kSlots;   // phase A: (step, row) pairs a chunk
};

// floats of shared memory: da by the step's parity [2][BT][4H] (rows in
// unit-major order, 4 j + gate), then phase A's two chunks
// [2][f, i g, c][kChunk][64] or, in phase B, the parts' sums
// [BT][kParts][64] in the same place
template <int H, int BT>
struct SplitSmem {
  static constexpr int kPhaseA = 2 * 3 * Split<H>::kChunk * kUnits;
  static constexpr int kParts = BT * Split<H>::kParts * kUnits;
  static constexpr int kFloats = 2 * BT * 4 * H + (kPhaseA > kParts ? kPhaseA : kParts);
  static constexpr int kBytes = 4 * kFloats;  // dynamic: 56 KB at H = 128, BT = 2
};

// Phase A for the split route, in chunks of steps: every thread computes
// the gates of kCellsA cells of chunk ch (their loads issued a chunk
// ahead, kept raw until used) and tanh c of its cells of chunk ch - 2;
// then one thread a cell scans c through chunk ch (a multiply and an add a
// step). Leaves in `gates` [g i(1-i), f, i(1-g^2), o] and in `cells`
// [c_{s-1} f(1-f), tanh c_s].
template <typename T, int H, int BT>
__device__ __forceinline__ void split_phase_a(const T* __restrict__ proj, float* __restrict__ gates,
                                              float* __restrict__ cells, float* work, int time,
                                              int batch, int d, int b0, int j) {
  using S = Split<H>;
  constexpr int G = 4 * H, TC = S::kChunk / BT;  // steps a chunk
  constexpr int BUF = 3 * S::kChunk * kUnits;     // one chunk's f, i g and c
  static_assert(S::kChunk % BT == 0, "a chunk holds whole steps");
  const int tid = threadIdx.x, jl = tid % kUnits, q = tid / kUnits;
  const size_t gsl = (size_t)batch * G;
  auto tof = [&](int s) { return d == 0 ? s : time - 1 - s; };
  auto pidx = [&](int t, int b) { return ((size_t)t * 2 + d) * gsl + (size_t)(b0 + b) * G + j; };
  auto gidx = [&](int t, int b) { return ((size_t)d * time + t) * gsl + (size_t)(b0 + b) * G + j; };
  auto kidx = [&](int t, int b) { return (((size_t)d * time + t) * batch + b0 + b) * 2 * H + j; };
  // this thread's cell u of chunk ch: its step and batch row, and whether it is in the sweep
  auto cell_of = [&](int ch, int u, int& s, int& b) {
    const int idx = u * S::kSlots + q;
    s = ch * TC + idx / BT;
    b = idx % BT;
    return s < time && b0 + b < batch;
  };
  T rp[kCellsA][4];      // proj of the next chunk's cells
  float rg[kCellsA][4];  // r(h) W^T of the same
  auto load_chunk = [&](int ch) {
#pragma unroll
    for (int u = 0; u < kCellsA; ++u) {
      int s, b;
      const bool in = cell_of(ch, u, s, b);
      const int t = in ? tof(s) : 0;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        rp[u][g] = in ? proj[pidx(t, b) + g * H] : T(0.0f);
        rg[u][g] = in ? gates[gidx(t, b) + g * H] : 0.0f;
      }
    }
  };
  auto tanh_pass = [&](int ch) {  // tanh c of this thread's cells of chunk ch
    const float* cb = work + (ch & 1) * BUF + 2 * S::kChunk * kUnits;
#pragma unroll
    for (int u = 0; u < kCellsA; ++u) {
      int s, b;
      if (cell_of(ch, u, s, b)) cells[kidx(tof(s), b) + H] = tanhf(cb[(u * S::kSlots + q) * kUnits + jl]);
    }
  };
  const bool scan = tid < kUnits * BT;  // the scan thread of cell (sb, jl)
  const int sb = tid / kUnits;
  const bool sok = scan && b0 + sb < batch;
  const int chunks = (time + TC - 1) / TC;
  float c = 0.0f;
  load_chunk(0);
  for (int ch = 0; ch < chunks; ++ch) {
    float* fb = work + (ch & 1) * BUF;     // f of each (step, row) of the chunk
    float* igb = fb + S::kChunk * kUnits;  // i g
    float* cbuf = igb + S::kChunk * kUnits;  // c
    float a[kCellsA][4];
#pragma unroll
    for (int u = 0; u < kCellsA; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g) a[u][g] = to_f(rp[u][g]) + rg[u][g];
    if (ch + 1 < chunks) load_chunk(ch + 1);
#pragma unroll
    for (int u = 0; u < kCellsA; ++u) {
      int s, b;
      const bool in = cell_of(ch, u, s, b);
      const int idx = u * S::kSlots + q;
      const float ig = sigmoid(a[u][0]), fg = sigmoid(a[u][1]);
      const float gg = tanhf(a[u][2]), og = sigmoid(a[u][3]);
      fb[idx * kUnits + jl] = fg;
      igb[idx * kUnits + jl] = __fmul_rn(ig, gg);
      if (in) {
        float* gp = gates + gidx(tof(s), b);
        gp[0] = gg * (1.0f - ig) * ig;
        gp[H] = fg;
        gp[2 * H] = ig * (1.0f - gg * gg);
        gp[3 * H] = og;
      }
    }
    if (ch >= 2) tanh_pass(ch - 2);  // its c were scanned before the last barrier
    __syncthreads();  // the chunk's f and i g are whole
    if (scan) {
#pragma unroll
      for (int sl = 0; sl < TC; ++sl) {
        const int s = ch * TC + sl, idx = sl * BT + sb;
        if (s < time) {
          const float fg = fb[idx * kUnits + jl], ig = igb[idx * kUnits + jl];
          const float kf = c * (1.0f - fg) * fg;
          c = __fadd_rn(__fmul_rn(fg, c), ig);  // the plain version's c = f c + i g
          cbuf[idx * kUnits + jl] = c;
          if (sok) cells[kidx(tof(s), sb)] = kf;
        }
      }
    }
  }
  __syncthreads();  // the last chunk's c
  if (chunks >= 2) tanh_pass(chunks - 2);
  tanh_pass(chunks - 1);
}

// proj (T, 2, B, 4H) and dout (T, 2, B, H) in the stream dtype; gates
// (2, T, B, 4H) f32, in: r(h_{s-1}) W^T, out: da; wp (2, CL, 16, 4H, 4)
// f32, [d][rank][r][16 p + q][c] = W[d][row 16 p + r][64 rank + 4 q + c],
// W's rows in unit-major order (row 4 j + g is gate g of unit j); cells
// (2, T, B, 2, H) f32 scratch. Grid (CL x ceil(B / BT), 2), clusters of CL
// blocks along x; 4H threads a block. kPhaseAOnly stops after phase A (to
// time it; never on the path).
template <typename T, int H, int BT, bool kPhaseAOnly>
__global__ void __launch_bounds__(4 * H, 1) lstm_sweep_bwd_split(
    const T* __restrict__ proj, float* __restrict__ gates, const T* __restrict__ dout,
    const float* __restrict__ wp, float* __restrict__ cells, int time, int batch) {
  using S = Split<H>;
  constexpr int G = 4 * H, CL = S::kCluster, NP = S::kParts;
  extern __shared__ __align__(16) unsigned char smem[];  // SplitSmem<H, BT>::kBytes
  __shared__ __align__(8) unsigned long long mbar[2];  // the peer's da of a step, by its parity
  float* da_s = reinterpret_cast<float*>(smem);  // [2][BT][4H]
  float* work = da_s + 2 * BT * G;               // phase A's chunks, then [BT][NP][64]
  const int tid = threadIdx.x;
  int rank = 0;
  if constexpr (CL > 1) rank = (int)cg::this_cluster().block_rank();
  const int d = blockIdx.y, b0 = (blockIdx.x / CL) * BT;
  const int j = rank * kUnits + tid % kUnits;  // the unit of phase A's and the cell's thread

  split_phase_a<T, H, BT>(proj, gates, cells, work, time, batch, d, b0, j);
  if constexpr (!kPhaseAOnly) {
    if constexpr (CL > 1) {
      if (tid == 0) {
        hopper::mbar_init(hopper::smem_u32(&mbar[0]), 1);
        hopper::mbar_init(hopper::smem_u32(&mbar[1]), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      // both blocks run and are past phase A, their mbarriers set: the
      // peer's shared memory may be written from here on
      hopper::cluster_barrier();
    } else {
      __syncthreads();  // phase A's stores are seen
    }

    const int p = tid / 16, q = tid % 16;  // rows 16p.., columns 64 rank + 4q..
    float w[kRows][kCols];
    {
      const float4* src = reinterpret_cast<const float4*>(wp) + (size_t)(d * CL + rank) * kRows * S::kThreads + tid;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 v = __ldg(src + (size_t)r * S::kThreads);
        w[r][0] = v.x; w[r][1] = v.y; w[r][2] = v.z; w[r][3] = v.w;
      }
    }
    unsigned peer_da = 0, peer_bar = 0;  // the peer's da buffer and mbarriers
    if constexpr (CL > 1) {
      peer_da = hopper::map_rank(hopper::smem_u32(da_s), rank ^ 1);
      peer_bar = hopper::map_rank(hopper::smem_u32(&mbar[0]), rank ^ 1);
    }

    const size_t gsl = (size_t)batch * G, hsl = (size_t)batch * H;
    auto tof = [&](int s) { return d == 0 ? s : time - 1 - s; };
    auto gidx = [&](int t, int b) { return ((size_t)d * time + t) * gsl + (size_t)(b0 + b) * G + j; };
    auto hidx = [&](int t, int b) { return ((size_t)t * 2 + d) * hsl + (size_t)(b0 + b) * H + j; };
    auto kidx = [&](int t, int b) { return (((size_t)d * time + t) * batch + b0 + b) * 2 * H + j; };
    const bool cell = tid < kUnits * BT;  // the thread of cell (cb, j)
    const int cb = tid / kUnits;
    const bool cok = cell && b0 + cb < batch;
    // a step's inputs [g i(1-i), f, i(1-g^2), o, c_{s-1} f(1-f), tanh c_s]
    // and dout (raw), loaded two steps ahead (zeros outside the batch: da
    // stays 0)
    float x0[6], x1[6];
    T d0, d1;
    auto load_in = [&](int s, float (&x)[6], T& dd) {
      if (cok && s >= 0) {
        const int t = tof(s);
        const float* gp = gates + gidx(t, cb);
        const float* kp = cells + kidx(t, cb);
        x[0] = gp[0]; x[1] = gp[H]; x[2] = gp[2 * H]; x[3] = gp[3 * H];
        x[4] = kp[0]; x[5] = kp[H];
        dd = dout[hidx(t, cb)];
      } else {
#pragma unroll
        for (int i = 0; i < 6; ++i) x[i] = 0.0f;
        dd = T(0.0f);
      }
    };
    load_in(time - 1, x0, d0);
    load_in(time - 2, x1, d1);
    float e = 0.0f, dcn = 0.0f, fn = 0.0f;  // e_{s+1}, dc_{s+1}, f_{s+1}
    for (int s = time - 1; s >= 0; --s) {
      float x[6];
      const float dd = to_f(d0);
#pragma unroll
      for (int i = 0; i < 6; ++i) { x[i] = x0[i]; x0[i] = x1[i]; }
      d0 = d1;
      load_in(s - 2, x1, d1);
      float* dab = da_s + (s & 1) * BT * G;
      if (CL > 1 && s > 0 && tid == 0)
        hopper::mbar_expect_tx(hopper::smem_u32(&mbar[s & 1]), 16 * kUnits * BT);
      if (cell) {
        const float og = x[3], tc = x[5];
        const float dh = dd + e;
        const float dc = dh * (og * (1.0f - tc * tc)) + dcn * fn;
        const float4 da = make_float4(dc * x[0], dc * x[4], dc * x[2], dh * (tc * (1.0f - og) * og));
        dcn = dc;
        fn = x[1];
        if (s > 0) {  // step 0's da is not multiplied
          const int off = cb * G + 4 * j;  // unit-major: the unit's four gates side by side
          *reinterpret_cast<float4*>(dab + off) = da;
          if constexpr (CL > 1)
            hopper::st_async16(peer_da + 4u * ((s & 1) * BT * G + off), da, peer_bar + 8u * (s & 1));
        }
        if (cok) {
          float* gp = gates + gidx(tof(s), cb);
          gp[0] = da.x; gp[H] = da.y; gp[2 * H] = da.z; gp[3 * H] = da.w;
        }
      }
      if (s == 0) break;
      __syncthreads();  // this block's units of da_s are whole
      // the peer's units: their step parity's phase ((T - 1 - s) / 2 phases
      // before); warps whose parts are this block's units go on at once
      if (CL > 1 && p / (NP / CL) != rank)
        hopper::mbar_wait(hopper::smem_u32(&mbar[s & 1]), ((time - 1 - s) >> 1) & 1);

      // this thread's part of e_s: rows 16p.. against columns 4q.., one
      // chain of 16 a column and batch row
      float acc[BT][kCols];
#pragma unroll
      for (int b = 0; b < BT; ++b)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[b][c] = 0.0f;
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4) {
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float4 v = *reinterpret_cast<const float4*>(dab + b * G + kRows * p + 4 * r4);
          const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[b][c] = fmaf(xs[rr], w[4 * r4 + rr][c], acc[b][c]);
        }
      }
#pragma unroll
      for (int b = 0; b < BT; ++b)
        *reinterpret_cast<float4*>(work + (b * NP + p) * kUnits + kCols * q) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      __syncthreads();  // the parts' sums are whole
      if (cell) {
        // e_s = r(the parts' sums as a balanced tree in part order), taken
        // in groups of 8 parts (the same tree)
        const float* col = work + cb * NP * kUnits + tid % kUnits;
        float g8[NP / 8];
#pragma unroll
        for (int k = 0; k < NP / 8; ++k) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = col[(8 * k + i) * kUnits];
          g8[k] = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
        }
#pragma unroll
        for (int st = 1; st < NP / 8; st *= 2)
#pragma unroll
          for (int i = 0; i < NP / 8; i += 2 * st) g8[i] += g8[i + st];
        e = rnd<T>(g8[0]);
      }
    }
    // every st.async into this block was waited for; no block leaves before its peer is done
    if constexpr (CL > 1) hopper::cluster_barrier();
  }
}

bool split_route(int hidden) { return hidden == 64 || hidden == 128; }

// the split route's batch tile: 1 row while 2 x B x cluster blocks fit one
// wave of the card, else 2 (more waves beyond 2 x ceil(B / 2) x cluster)
int split_bt(int batch, int hidden, int num_sms) {
  return 2 * batch * (hidden / kUnits) <= num_sms ? 1 : 2;
}

template <int H, int BT>
cudaLaunchConfig_t split_config(int batch, cudaStream_t stream, cudaLaunchAttribute* attr) {
  constexpr int CL = Split<H>::kCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * ((batch + BT - 1) / BT), 2, 1);
  cfg.blockDim = dim3(Split<H>::kThreads, 1, 1);
  cfg.dynamicSmemBytes = SplitSmem<H, BT>::kBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the dynamic shared memory the kernel takes above 48 KB
template <typename T, int H, int BT, bool A>
cudaError_t split_smem_limit() {
  return cudaFuncSetAttribute(lstm_sweep_bwd_split<T, H, BT, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SplitSmem<H, BT>::kBytes);
}

template <typename T, int H, int BT, bool A>
int launch_split_kernel(const void* proj, void* gates, const void* dout, const void* wp, void* cells,
                        int time, int batch, cudaStream_t stream) {
  cudaError_t err = split_smem_limit<T, H, BT, A>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = split_config<H, BT>(batch, stream, attr);
  err = cudaLaunchKernelEx(
      &cfg, lstm_sweep_bwd_split<T, H, BT, A>, static_cast<const T*>(proj), static_cast<float*>(gates),
      static_cast<const T*>(dout), static_cast<const float*>(wp), static_cast<float*>(cells), time, batch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// kPhaseAOnly: phase A alone, at H = 128 only
template <typename T, bool kPhaseAOnly>
int launch_split(const void* proj, void* gates, const void* dout, const void* wp, void* cells, int time,
                 int batch, int hidden, int num_sms, cudaStream_t s) {
  const int bt = split_bt(batch, hidden, num_sms);
  if (hidden == 128) {
    if (bt == 1) return launch_split_kernel<T, 128, 1, kPhaseAOnly>(proj, gates, dout, wp, cells, time, batch, s);
    return launch_split_kernel<T, 128, 2, kPhaseAOnly>(proj, gates, dout, wp, cells, time, batch, s);
  }
  if constexpr (kPhaseAOnly) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (bt == 1) return launch_split_kernel<T, 64, 1, false>(proj, gates, dout, wp, cells, time, batch, s);
    return launch_split_kernel<T, 64, 2, false>(proj, gates, dout, wp, cells, time, batch, s);
  }
}

template <typename T, int BT>
int max_clusters(int batch, int* clusters) {
  cudaError_t err = split_smem_limit<T, 128, BT, false>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = split_config<128, BT>(batch, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, lstm_sweep_bwd_split<T, 128, BT, false>, &cfg);
}

bool valid(int time, int batch, int hidden, int dtype, int num_sms) {
  return time >= 1 && batch >= 1 && hidden >= 1 && hidden <= kMaxThreads && num_sms >= 1 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (proj, dout); gates and cells f32; wp
// as `pack_backward_w` lays it out for the route (f32 on the split route,
// the stream dtype on the column route). num_sms: the card's SM count
// (sizes the batch tile). Returns the cudaError_t of the launch.
extern "C" int lstm_sweep_bwd_launch(const void* proj, void* gates, const void* dout,
                                     const void* wp, void* cells, int time, int batch, int hidden,
                                     int dtype, int num_sms, void* stream) {
  if (!valid(time, batch, hidden, dtype, num_sms)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_route(hidden)) {
    if (dtype == 0) return launch_split<float, false>(proj, gates, dout, wp, cells, time, batch, hidden, num_sms, s);
    return launch_split<__nv_bfloat16, false>(proj, gates, dout, wp, cells, time, batch, hidden, num_sms, s);
  }
  if (dtype == 0) return launch_column<float>(proj, gates, dout, wp, cells, time, batch, hidden, num_sms, s);
  return launch_column<__nv_bfloat16>(proj, gates, dout, wp, cells, time, batch, hidden, num_sms, s);
}

// The split route's phase A alone (H = 128), to time the kernel's phase
// split: the same arguments; `gates` and `cells` are left as phase A
// leaves them. Never called on the path.
extern "C" int lstm_sweep_bwd_phase_a_launch(const void* proj, void* gates, const void* dout,
                                             const void* wp, void* cells, int time, int batch,
                                             int hidden, int dtype, int num_sms, void* stream) {
  if (!valid(time, batch, hidden, dtype, num_sms) || hidden != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_split<float, true>(proj, gates, dout, wp, cells, time, batch, hidden, num_sms, s);
  return launch_split<__nv_bfloat16, true>(proj, gates, dout, wp, cells, time, batch, hidden, num_sms, s);
}

// The launch plan, for reports: fields[0..9] = route (1 split, 0 column),
// blocks a cluster, batch rows a block, threads a block, blocks, warps
// that add to each unit's sum, units (columns of W) a block, and W's rows
// held in registers, in shared memory and read through L2 (of 4H).
extern "C" void lstm_sweep_bwd_plan(int batch, int hidden, int dtype, int num_sms, int* fields) {
  if (split_route(hidden)) {
    const int bt = split_bt(batch, hidden, num_sms), cl = hidden / kUnits;
    const int f[10] = {1, cl, bt, 4 * hidden, 2 * cl * ((batch + bt - 1) / bt), hidden / 8, kUnits,
                       4 * hidden, 0, 0};
    for (int i = 0; i < 10; ++i) fields[i] = f[i];
    return;
  }
  const Plan p = plan(batch, hidden, dtype == 0 ? 4 : 2, num_sms);
  const int f[10] = {0, 1, p.bt, p.threads, 2 * ((batch + p.bt - 1) / p.bt), 1, hidden, 0,
                     4 * p.w_rows, 4 * (hidden - p.w_rows)};
  for (int i = 0; i < 10; ++i) fields[i] = f[i];
}

// How many clusters of the split route at H = 128 the card holds at once
// (cudaOccupancyMaxActiveClusters), for reports. Returns the cudaError_t.
extern "C" int lstm_sweep_bwd_max_clusters(int batch, int dtype, int num_sms, int* clusters) {
  return split_bt(batch, 128, num_sms) == 1
             ? (dtype == 0 ? max_clusters<float, 1>(batch, clusters) : max_clusters<__nv_bfloat16, 1>(batch, clusters))
             : (dtype == 0 ? max_clusters<float, 2>(batch, clusters) : max_clusters<__nv_bfloat16, 2>(batch, clusters));
}

extern "C" const char* lstm_sweep_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
