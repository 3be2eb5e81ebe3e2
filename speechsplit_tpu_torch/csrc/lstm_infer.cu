// One direction of one LSTM layer, forward: the lean forward (lstm_infer,
// h only) and the residual-saving forward of training (lstm_fwd), at
// float32 and at the bfloat16 dtype sets of the JAX single route.
//
// Replaces: speechsplit_tpu/ops/pallas_lstm.py::_infer_kernel (wrapper
// _infer) and ::_fwd_kernel (wrapper _fwd), the TPU kernels of
// lstm_sequence: one direction over a grid of T steps, W_hh resident.
// Same math as pallas_lstm._cell: gates = xp + h_{t-1} W_hh^T ordered
// i, f, g, o; sigmoid/sigmoid/tanh/sigmoid; c = f c + i g; h = o tanh(c);
// state float32 from zero. With reverse the recurrence walks T-1 -> 0 over
// inputs and outputs kept in real time order, as the TPU kernels' index
// maps do (pallas_lstm._sd_maps).
//
// Layouts: xp [T, B, 4H] (time-major, real time order); w [4H, H] (torch's
// weight_hh_l{k}: row g*H + u holds gate g of unit u); h [T, B, H]; the
// lean forward also takes a scratch c [B, H] for the wide plan's cell
// state; lstm_fwd also writes g [T, B, 4H] (the gates i, f, g, o after
// their activations) and c [T, B, H].
//
// Element types, as pallas_lstm._infer_kernel and _fwd_kernel run them
// (template arguments W, X, R of every plan): W_hh float or bfloat16
// (bfloat16 compute: widened as it is staged, and the product reads
// h_{t-1} rounded to bfloat16 nearest even, its sums float32, :263, :293);
// xp float, or bfloat16 beside a bfloat16 W_hh (the lean forward at
// either, the residual-saving one where the residuals are bfloat16 too,
// pallas_lstm.stream_dtype), widened as it is read; g and c float or
// bfloat16 (R, the JAX residual_dtype), rounded as they are stored, while
// h and the c carry stay float32. The float32 instances keep the machine
// code they had before the type arguments; every plan and kMaxBatch are
// the same at every type.
//
// What bounds it on an H100: step t needs all of h_{t-1}, so the T steps
// are serial. Each step is a [B, H] x [H, 4H] product (2*B*H*4H flops) and
// a cell update; xp is read once and h written once. The port runs the
// lean forward where the merged kernels cannot hold a batch (conversion of
// 731 pairs or more: 5117 rows at the mel decoder's H = 512 and at content
// layer 1's H = 8) and for LSTM(bidirectional=False). At B = 5117, H = 512
// a step is 10.7 GFLOP against 42 MB of xp: float32 FMAs bound it (0.16 ms
// a step at 67 TFLOP/s). At H = 8 a step is 2.6 MFLOP: nothing bounds it
// but latency, and rows of an LSTM never depend on each other. lstm_fwd
// runs under autograd, at the train step's B = 16: a step at H = 512 is
// 34 MFLOP, so latency bounds it at every width (the wait for every
// block's h_{t-1}, the reload of it, one step's chain of FMAs).
//
// lstm_infer has two plans, split at kNarrowMaxH (chosen from a width sweep
// at B = 5117 on the H100, PERF.md):
//
// - Wide (H > kNarrowMaxH): one launch a step, issued by the host in a loop
//   on the caller's stream, each a tiled float32 GEMM with the LSTM cell in
//   its epilogue. A block owns kWideRows batch rows and kWideUnits hidden
//   units, i.e. all four gate columns of those units, so the cell update
//   of its (rows, units) runs in registers right after the product and the
//   gates never go to memory. 256 threads, each a 4 x 8 register tile
//   (4 rows x 2 units x 4 gates) of FFMA. The K loop stages kWideK-deep
//   tiles of h_{t-1} and W_hh in shared memory, transposed and swizzled,
//   double-buffered through registers (the next tile's loads are in flight
//   while the current one is multiplied). W_hh (4 MiB at H = 512) is
//   re-read by every row tile from L2. The batch is tiled over the grid, so
//   the plan has no batch limit; the cell state lives in the c scratch,
//   which step 0 writes without reading. No TF32.
// - Narrow (H <= kNarrowMaxH): one launch for the whole sequence with no
//   barrier between blocks: a batch row belongs to L lanes of a warp (L the
//   least power of 2 >= H), each lane owning one unit with all four of its
//   gates, so the row's c stays in registers for all T steps and its h
//   moves between the lanes by warp shuffles. W_hh is staged once into
//   shared memory as (i, f, g, o) float4s, zero-padded to L units. Each
//   lane fetches the next step's gate inputs while it computes this one.
//
// Both plans round the cell update as the plain version's separate ops do
// (no FMA contraction), so given the same gates c agrees with it to the
// last bit.
//
// lstm_fwd has two plans too, split at the same width (lane_fwd::kLaneMaxH
// = kNarrowMaxH = 32, also the border of lstm_bwd's plans, so a layer's
// forward, lean forward and gradient split at one width), one launch a
// call either way:
//
// - Narrow (H <= 32): the multi-stream forwards' lane step
//   (csrc/lane_fwd.cuh) for one direction: a batch row on L lanes, one
//   unit a lane with all four of its gates, W_hh's L float4s a lane in
//   registers, h_{t-1} by __shfl_sync of width L, c in a register, the
//   next step's gate inputs in flight, stores of h, g and c, no barrier.
//   No batch limit of its own.
// - Wide (H > 32): the merged forward's step (csrc/bilstm_infer.cu,
//   bilstm_infer_kernel with kResid, on csrc/merged_step.cuh) for one
//   direction, in one persistent cooperative launch. A block owns UN
//   consecutive hidden units (1 up to H = 128, 2 up to 256, 4 above: 128
//   blocks at H = 128, 256 and 512), with two warps a unit that deal out
//   the rounds of 8 batch rows between them (one warp a unit, and 4 units
//   a block at H = 256, were slower in a sweep at B = 16). A warp holds
//   its unit's four gate rows of W_hh in registers at k = 128 q + 4 lane
//   + kk, so one 16-byte shared load of h_{t-1} feeds 16 FMAs; a round
//   covers 8 batch rows x 4 gates and ends in one butterfly
//   (merged_step.cuh) that leaves lane 4 r + g the sum of row r, gate g;
//   rows past the batch read its last row, so that a round's loads issue
//   together. Each lane applies its gate's
//   activation and lane 4 r the cell update; c stays in shared memory
//   ([UN][B]). h_{t-1}, written by every block in the step before, is
//   staged by 16-byte cp.async through L2, batch tiles double-buffered.
//   The gate inputs of the block's units go in by cp.async a step ahead,
//   between the block's arrival at the split grid barrier (step::Barrier,
//   on a word the wrapper zeroes) and its wait. The outputs are staged in
//   the slots of the gate inputs they replace and stored in runs of the
//   block's units. The cell state and one batch row of each buffer fit in
//   the 227 KB a block may opt into: that sets kMaxBatch. The host side
//   checks occupancy before the launch and fails rather than deadlocks
//   when the grid cannot be co-resident. The body is a copy of the merged
//   step, not shared with it: sharing it would change bilstm_infer_kernel's
//   machine code.
//
// Built with -DLSTM_FWD_PROBE (chip_smoke.py's probe build), each lstm_fwd
// plan also adds up clock64() laps of the phases of a step per warp, which
// lstm_fwd_probe_read returns: 0 the barrier wait (wide plan only), 1 the
// wait for h_{t-1} and the gate inputs, 2 the product, 3 the cell and the
// stores, 4 the prefetch of the next step's gate inputs and the arrival.

#include <cuda_runtime.h>

#ifdef LSTM_FWD_PROBE
#define LANE_FWD_PROBE
#endif
#include "lane_fwd.cuh"
#include "merged_step.cuh"

namespace {

constexpr int kMaxH = 512;

// lstm_infer's plans. ops/lstm.py reads kNarrowMaxH from this line.
constexpr int kNarrowMaxH = 32;    // H <= this runs the narrow plan
constexpr int kNarrowThreads = 128;
constexpr int kWideUnits = 32;     // hidden units a wide block (128 columns)
constexpr int kWideRows = 64;      // batch rows a wide block
constexpr int kWideK = 16;         // depth of a staged K tile
constexpr int kWideThreads = 256;  // 16 x 16 threads, each 4 rows x 8 cols
static_assert(kNarrowMaxH == lane_fwd::kLaneMaxH,
              "lstm_infer's and lstm_fwd's plans split at one width");

// lstm_fwd's wide plan
constexpr int kRound = 8;      // batch rows a warp sums at once (x 4 gates)
constexpr int kKSpan = 128;    // k of h_{t-1} one pass covers, 4 a lane
// warps a unit, dealing out the rounds (one warp a unit was slower at
// H = 128, 256 and 512 in a sweep at B = 16, PERF.md)
constexpr int kSplits = 2;
// the most a block may opt into on an H100
constexpr size_t kSmemBudget = 227 * 1024;
static_assert(kRound * 4 == 32, "a round reduces 32 sums a warp");

// The wide plan's units a block at width H: 128 blocks at H = 128, 256
// and 512.
constexpr int plan_units(int H) { return H <= 128 ? 1 : H <= 256 ? 2 : 4; }

// Shared-memory floats of a wide block: the cell state [units][B], then
// per batch row of a tile two buffers of h_{t-1} [Hp] (H padded to 4) and
// of the gate inputs [4][units], and the row's h and c [2][units].
constexpr size_t cell_floats(int units, int B) {
  return static_cast<size_t>(units) * B;
}
constexpr size_t row_floats(int units, int H) {
  return 2 * (static_cast<size_t>((H + 3) & ~3) + 4 * units) + 2 * units;
}

// The largest batch lstm_fwd takes, at every H <= kMaxH: the cell state of
// plan_units(kMaxH) units and one batch row in kSmemBudget (a narrower
// layer has fewer units a block and shorter rows; the narrow plan has no
// limit of its own). ops/lstm.py reads the value from this line, so the
// kernel is the one owner of the limit. lstm_infer has no batch limit.
constexpr int kMaxBatch = 14262;
static_assert((cell_floats(plan_units(kMaxH), kMaxBatch) +
               row_floats(plan_units(kMaxH), kMaxH)) * sizeof(float) <=
                      kSmemBudget &&
                  (cell_floats(plan_units(kMaxH), kMaxBatch + 1) +
                   row_floats(plan_units(kMaxH), kMaxH)) * sizeof(float) >
                      kSmemBudget,
              "kMaxBatch must be the largest batch the plan holds at kMaxH");

#ifdef LSTM_FWD_PROBE
constexpr int kPhases = 5;
__device__ unsigned long long g_probe_cycles[kPhases];
__device__ unsigned long long g_probe_laps[kPhases];
__device__ float g_probe_sink;
static_assert(lane_fwd::kPhases == kPhases - 1,
              "the lane step's phases are slots 1 .. 4");
#define PROBE_LAP(phase)                 \
  do {                                   \
    const long long now_ = clock64();    \
    probe_cycles[phase] += now_ - lap_;  \
    ++probe_laps[phase];                 \
    lap_ = now_;                         \
  } while (0)
#else
#define PROBE_LAP(phase) \
  do {                   \
  } while (0)
#endif

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ------------------------------------------------- lstm_infer, wide plan

// The shared-memory column of element (k, col) of a staged [kWideK][cols]
// tile: col's 8-float block XORed with k's 4-float group. A warp's
// transposing stores (8 consecutive rows or columns x 4 k-groups) then hit
// 32 distinct banks, and the 4 columns a thread reads as a float4 stay
// side by side.
__device__ __forceinline__ int swizzle(int k, int col) {
  return col ^ (((k >> 2) & 3) << 3);
}

// Elements k .. k+3 of a row of h_{t-1} or W_hh at p, zero past H or for a
// row outside the matrix. kVec: H % 4 == 0, so rows are 16-byte aligned and
// the four are all inside or all outside.
template <bool kVec>
__device__ __forceinline__ float4 stage4(const float* p, bool ok, int k,
                                         int H) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!ok) return v;
  if (kVec) {
    if (k < H) v = *reinterpret_cast<const float4*>(p);
  } else {
    if (k < H) v.x = p[0];
    if (k + 1 < H) v.y = p[1];
    if (k + 2 < H) v.z = p[2];
    if (k + 3 < H) v.w = p[3];
  }
  return v;
}
// The same of a bfloat16 row (a bfloat16 W_hh), widened: kVec, one 8-byte
// load of the four.
template <bool kVec>
__device__ __forceinline__ float4 stage4(const resid::bf16* p, bool ok,
                                         int k, int H) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!ok) return v;
  if (kVec) {
    if (k < H) {
      const uint2 bits = *reinterpret_cast<const uint2*>(p);
      v = make_float4(__uint_as_float(bits.x << 16),
                      __uint_as_float(bits.x & 0xffff0000u),
                      __uint_as_float(bits.y << 16),
                      __uint_as_float(bits.y & 0xffff0000u));
    }
  } else {
    if (k < H) v.x = resid::widen(p[0]);
    if (k + 1 < H) v.y = resid::widen(p[1]);
    if (k + 2 < H) v.z = resid::widen(p[2]);
    if (k + 3 < H) v.w = resid::widen(p[3]);
  }
  return v;
}

// One step: h_out = cell(xp + h_prev W_hh^T) over a tile of kWideRows rows
// and kWideUnits units; h_prev == nullptr at the first step (h and c from
// zero). W: W_hh's element type, widened as it is staged into w_s; beside
// a bfloat16 one h_prev is rounded to bfloat16 as it is staged into a_s
// (once a tile, not at each read of it). X: xp's, widened where the cell
// reads it.
template <bool kVec, typename W = float, typename X = float>
__global__ void __launch_bounds__(kWideThreads, 3)
lstm_wide_step_kernel(const float* __restrict__ xp,
                      const float* __restrict__ w,
                      const float* __restrict__ h_prev,
                      float* __restrict__ h_out, float* __restrict__ c,
                      int B, int H) {
  constexpr int MR = 4;                 // batch rows a thread
  constexpr int BM = kWideRows;         // batch rows of the tile
  constexpr int BN = 4 * kWideUnits;    // gate columns: unit j gate g at 4j+g
  constexpr int KQ = kWideK / 4;        // float4s in a staged row
  constexpr int A_LD = BM * KQ / kWideThreads;  // float4s of h a thread stages
  constexpr int W_LD = BN * KQ / kWideThreads;  // ... and of W_hh
  static_assert(BM == 16 * MR && KQ == 4 &&
                    A_LD * kWideThreads == BM * KQ &&
                    W_LD * kWideThreads == BN * KQ,
                "staging plan");
  __shared__ __align__(16) float a_s[2][kWideK][BM];
  __shared__ __align__(16) float w_s[2][kWideK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // units tx and tx + 16 of the tile
  const int ty = tid >> 4;  // rows MR ty + {0 .. MR-1} of the tile
  const int q = tid & 3;    // the k-group this thread stages
  const int m0 = blockIdx.x * BM;
  const int u0 = blockIdx.y * kWideUnits;

  float acc[MR][8];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[i][n] = 0.0f;
  }

  if (h_prev != nullptr) {
    // staged element p of a k-tile: row (or column) (tid + p * threads) / 4
    // at k-group q; the rows of h_{t-1}, and the W_hh rows of gate g of
    // unit j for column 4 j + g
    const float* a_src[A_LD];
    bool a_ok[A_LD];
    const W* w_src[W_LD];
    bool w_ok[W_LD];
#pragma unroll
    for (int p = 0; p < A_LD; ++p) {
      const int m = m0 + ((tid + p * kWideThreads) >> 2);
      a_ok[p] = m < B;
      a_src[p] = h_prev + static_cast<size_t>(a_ok[p] ? m : 0) * H + 4 * q;
    }
#pragma unroll
    for (int p = 0; p < W_LD; ++p) {
      const int col = (tid + p * kWideThreads) >> 2;
      const int u = u0 + (col >> 2);
      w_ok[p] = u < H;
      w_src[p] = reinterpret_cast<const W*>(w) +
                 static_cast<size_t>((col & 3) * H + (w_ok[p] ? u : 0)) * H +
                 4 * q;
    }
    float4 a_reg[A_LD], w_reg[W_LD];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int p = 0; p < A_LD; ++p) {
        a_reg[p] = stage4<kVec>(a_src[p] + k0, a_ok[p], k0 + 4 * q, H);
      }
#pragma unroll
      for (int p = 0; p < W_LD; ++p) {
        w_reg[p] = stage4<kVec>(w_src[p] + k0, w_ok[p], k0 + 4 * q, H);
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int p = 0; p < A_LD; ++p) {
        const int col = ((tid + p * kWideThreads) >> 2) ^ (q << 3);
        // h_{t-1} as the product reads it: rounded beside a bfloat16 W
        const float4 a = resid::operand<W>(a_reg[p]);
        a_s[buf][4 * q][col] = a.x;
        a_s[buf][4 * q + 1][col] = a.y;
        a_s[buf][4 * q + 2][col] = a.z;
        a_s[buf][4 * q + 3][col] = a.w;
      }
#pragma unroll
      for (int p = 0; p < W_LD; ++p) {
        const int col = ((tid + p * kWideThreads) >> 2) ^ (q << 3);
        w_s[buf][4 * q][col] = w_reg[p].x;
        w_s[buf][4 * q + 1][col] = w_reg[p].y;
        w_s[buf][4 * q + 2][col] = w_reg[p].z;
        w_s[buf][4 * q + 3][col] = w_reg[p].w;
      }
    };
    const int nk = (H + kWideK - 1) / kWideK;
    fetch(0);
    store(0);
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      const int buf = kt & 1;
      if (kt + 1 < nk) fetch((kt + 1) * kWideK);  // in flight meanwhile
#pragma unroll
      for (int kk = 0; kk < kWideK; ++kk) {
        float a[MR], b[8];
        const float4 v = *reinterpret_cast<const float4*>(
            &a_s[buf][kk][swizzle(kk, MR * ty)]);
        a[0] = v.x;
        a[1] = v.y;
        a[2] = v.z;
        a[3] = v.w;
        const float4 b0 = *reinterpret_cast<const float4*>(
            &w_s[buf][kk][swizzle(kk, 4 * tx)]);
        const float4 b1 = *reinterpret_cast<const float4*>(
            &w_s[buf][kk][swizzle(kk, 64 + 4 * tx)]);
        b[0] = b0.x;
        b[1] = b0.y;
        b[2] = b0.z;
        b[3] = b0.w;
        b[4] = b1.x;
        b[5] = b1.y;
        b[6] = b1.z;
        b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < MR; ++i) {
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[i][n] = fmaf(a[i], b[n], acc[i][n]);
        }
      }
      // the other buffer's last readers passed the barrier below in the
      // previous iteration
      if (kt + 1 < nk) store(buf ^ 1);
      __syncthreads();
    }
  }

  // the cell update of (row, unit) from acc[row][4 v + gate]
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int m = m0 + MR * ty + i;
    if (m >= B) continue;
    const X* x =
        reinterpret_cast<const X*>(xp) + static_cast<size_t>(m) * 4 * H;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int u = u0 + tx + 16 * v;
      if (u >= H) continue;
      const float i_g = sigmoid_f(resid::widen(x[u]) + acc[i][4 * v]);
      const float f_g = sigmoid_f(resid::widen(x[H + u]) + acc[i][4 * v + 1]);
      const float g_g = tanhf(resid::widen(x[2 * H + u]) + acc[i][4 * v + 2]);
      const float o_g =
          sigmoid_f(resid::widen(x[3 * H + u]) + acc[i][4 * v + 3]);
      const size_t at = static_cast<size_t>(m) * H + u;
      const float c_prev = h_prev != nullptr ? c[at] : 0.0f;
      // each product and the sum rounded on its own, as the plain
      // version's separate ops round them
      const float c_new =
          __fadd_rn(__fmul_rn(f_g, c_prev), __fmul_rn(i_g, g_g));
      c[at] = c_new;
      h_out[at] = o_g * tanhf(c_new);
    }
  }
}

template <bool kVec, typename W, typename X>
cudaError_t wide_steps(const float* xp, const float* w, float* h, float* c,
                       int T, int B, int H, int reverse,
                       cudaStream_t stream) {
  const dim3 grid((B + kWideRows - 1) / kWideRows,
                  (H + kWideUnits - 1) / kWideUnits);
  const size_t xs = static_cast<size_t>(B) * 4 * H;  // a step of xp
  const size_t hs = static_cast<size_t>(B) * H;      // a step of h
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // the previous step's index
    lstm_wide_step_kernel<kVec, W, X><<<grid, kWideThreads, 0, stream>>>(
        reinterpret_cast<const float*>(reinterpret_cast<const X*>(xp) +
                                       t * xs),
        w, s ? h + tp * hs : nullptr, h + t * hs, c, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ----------------------------------------------- lstm_infer, narrow plan

// The whole sequence for 128 / L batch rows a block; L lanes a row, one
// unit a lane (all four gates of it), H <= L. W: W_hh's element type,
// widened as it is staged; beside a bfloat16 one the product reads
// h_{t-1} rounded to bfloat16, once a step before the shuffles. X: xp's,
// widened as it is fetched.
template <int L, typename W = float, typename X = float>
__global__ void __launch_bounds__(kNarrowThreads)
lstm_narrow_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                   float* __restrict__ h, int T, int B, int H, int reverse) {
  constexpr int ROWS = 32 / L;  // batch rows a warp
  const W* wv = reinterpret_cast<const W*>(w);
  // W_hh as [k][u] float4s (i, f, g, o of unit u at column k), L x L with
  // zeros past H
  extern __shared__ float4 wt[];
  for (int i = threadIdx.x; i < L * L; i += blockDim.x) {
    const int k = i / L;
    const int u = i % L;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < H && u < H) {
      v.x = resid::widen(wv[static_cast<size_t>(u) * H + k]);
      v.y = resid::widen(wv[static_cast<size_t>(H + u) * H + k]);
      v.z = resid::widen(wv[static_cast<size_t>(2 * H + u) * H + k]);
      v.w = resid::widen(wv[static_cast<size_t>(3 * H + u) * H + k]);
    }
    wt[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int u = lane & (L - 1);  // this lane's unit in its row's group
  const int row =
      (blockIdx.x * (kNarrowThreads / 32) + (threadIdx.x >> 5)) * ROWS +
      lane / L;
  const bool live = row < B;
  // rows past B and units past H run on zero inputs (their h stays 0) and
  // store nothing; every lane takes part in the shuffles
  const bool ok = live && u < H;
  float c_st = 0.0f, h_st = 0.0f, xn[4];
  auto fetch = [&](int t) {
    const X* x = reinterpret_cast<const X*>(xp) +
                 (static_cast<size_t>(t) * B + (live ? row : 0)) * 4 * H;
#pragma unroll
    for (int g = 0; g < 4; ++g) xn[g] = ok ? resid::widen(x[g * H + u]) : 0.0f;
  };
  fetch(reverse ? T - 1 : 0);
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    float x[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = xn[g];
    if (s + 1 < T) fetch(reverse ? t - 1 : t + 1);  // in flight meanwhile
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float h_op = resid::operand<W>(h_st);  // as the product reads it
#pragma unroll
    for (int k = 0; k < L; ++k) {
      // h_{t-1}[k], from the lane that owns it
      const float hk = __shfl_sync(0xffffffffu, h_op, k, L);
      const float4 v = wt[k * L + u];
      acc[0] = fmaf(hk, v.x, acc[0]);
      acc[1] = fmaf(hk, v.y, acc[1]);
      acc[2] = fmaf(hk, v.z, acc[2]);
      acc[3] = fmaf(hk, v.w, acc[3]);
    }
    const float i_g = sigmoid_f(x[0] + acc[0]);
    const float f_g = sigmoid_f(x[1] + acc[1]);
    const float g_g = tanhf(x[2] + acc[2]);
    const float o_g = sigmoid_f(x[3] + acc[3]);
    c_st = __fadd_rn(__fmul_rn(f_g, c_st), __fmul_rn(i_g, g_g));
    h_st = o_g * tanhf(c_st);
    if (ok) h[(static_cast<size_t>(t) * B + row) * H + u] = h_st;
  }
}

template <int L, typename W, typename X>
cudaError_t narrow_launch(const float* xp, const float* w, float* h, int T,
                          int B, int H, int reverse, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float4) * L * L;
  constexpr int rows = kNarrowThreads / L;  // batch rows a block
  const unsigned blocks = (static_cast<unsigned>(B) + rows - 1) / rows;
  lstm_narrow_kernel<L, W, X><<<blocks, kNarrowThreads, smem, stream>>>(
      xp, w, h, T, B, H, reverse);
  return cudaGetLastError();
}

static_assert(kNarrowMaxH == 32, "narrow_plan's widest instance is L = 32");
template <typename W, typename X>
cudaError_t narrow_plan(const float* xp, const float* w, float* h, int T,
                        int B, int H, int reverse, cudaStream_t s) {
  if (H <= 1) return narrow_launch<1, W, X>(xp, w, h, T, B, H, reverse, s);
  if (H <= 2) return narrow_launch<2, W, X>(xp, w, h, T, B, H, reverse, s);
  if (H <= 4) return narrow_launch<4, W, X>(xp, w, h, T, B, H, reverse, s);
  if (H <= 8) return narrow_launch<8, W, X>(xp, w, h, T, B, H, reverse, s);
  if (H <= 16) return narrow_launch<16, W, X>(xp, w, h, T, B, H, reverse, s);
  return narrow_launch<32, W, X>(xp, w, h, T, B, H, reverse, s);
}

// The lean forward at W_hh's and xp's element types, in `plan`.
template <typename W, typename X>
cudaError_t infer_plan(const float* xp, const float* w, float* h, float* c,
                       int T, int B, int H, int reverse, int plan,
                       cudaStream_t s) {
  if (plan == 1 || (plan == 0 && H <= kNarrowMaxH)) {
    return narrow_plan<W, X>(xp, w, h, T, B, H, reverse, s);
  }
  return H % 4 == 0
             ? wide_steps<true, W, X>(xp, w, h, c, T, B, H, reverse, s)
             : wide_steps<false, W, X>(xp, w, h, c, T, B, H, reverse, s);
}


// ----------------------------------------------- lstm_fwd, narrow plan

// R, W, X: the element types of the residuals, W_hh and xp (lane_fwd.cuh)
template <int L, typename R = float, typename W = float, typename X = float>
__global__ void __launch_bounds__(lane_fwd::kThreads)
lstm_fwd_narrow_kernel(lane_fwd::Dir d, int T, int B, int reverse) {
  extern __shared__ float4 lane_smem[];
  lane_fwd::Probe probe;
  // a reverse direction is an odd one; W_hh is W's type throughout
  lane_fwd::steps<L, true, R, W, X>(d, blockIdx.x, reverse, T, B, lane_smem,
                                    probe, !std::is_same<W, float>::value);
#ifdef LSTM_FWD_PROBE
  // the lane step's phases 0 .. 3 are this file's 1 .. 4
  probe.flush(g_probe_cycles + 1, g_probe_laps + 1, &g_probe_sink);
#endif
}

// ------------------------------------------------- lstm_fwd, wide plan

// A launch of the wide plan: its arguments and plan.
struct FwdArgs {
  const float* xp;
  const float* w;
  float* h;
  float* g;
  float* c;
  unsigned* barrier;  // zeroed before the launch
  int T, B, H, reverse;
  int bt;
};

// Shared memory: hbuf [2][bt][Hp] two buffers of h_{t-1}; xbuf
// [2][bt][4][UN] two buffers of the units' gate inputs; hc_s [bt][2][UN]
// the tile's h and c; c_s [UN][B] the cell state.
// KQ: passes of kKSpan, ceil(H / kKSpan); UN: units a block. R: the
// residuals' element type, staged in float32 and rounded as they are
// stored (h stays float32). W: W_hh's, widened into the registers that
// hold it, and beside a bfloat16 one h_{t-1} rounded to bfloat16 where
// the product reads it. X: xp's, widened as it is staged (cp.async cannot
// widen, so a bfloat16 xp is loaded through registers). All staging is
// float32, so the plan and kMaxBatch do not depend on them.
template <int KQ, int UN, typename R = float, typename W = float,
          typename X = float>
__global__ void __launch_bounds__(UN * kSplits * 32, 1)
lstm_fwd_wide_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, B = a.B, H = a.H, bt = a.bt;
  const int Hp = (H + 3) & ~3;
  constexpr int xrow = 4 * UN;  // a tile row of gate inputs: [4][UN]
  float* hbuf = smem;                  // [2][bt][Hp]
  float* xbuf = hbuf + 2 * bt * Hp;    // [2][bt][4][UN]
  float* hc_s = xbuf + 2 * bt * xrow;  // [bt][2][UN]
  float* c_s = hc_s + 2 * bt * UN;     // [UN][B]

  const bool reverse = a.reverse != 0;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int uw = warp % UN;     // this warp's unit in the block
  const int split = warp / UN;  // its share of the rounds
  const int u0 = blockIdx.x * UN;
  const int nu = min(UN, H - u0);  // this block's units
  const int u = u0 + uw;
  const bool active = uw < nu;
  // gate-input and output rows in 16-byte copies where every run of the
  // block's units is whole quads
  const bool quads = (H & 3) == 0 && (UN & 3) == 0;
  step::Barrier bar(a.barrier);

  // this warp's four gate rows of W_hh at k = kKSpan q + 4 lane + kk
  float wr[KQ][4][4];
#pragma unroll
  for (int q = 0; q < KQ; ++q) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = kKSpan * q + 4 * lane + kk;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        wr[q][kk][g] = (active && k < H)
                           ? resid::widen(reinterpret_cast<const W*>(
                                 a.w)[static_cast<size_t>(g * H + u) * H + k])
                           : 0.0f;
      }
    }
  }
  for (int i = tid; i < UN * B; i += nthreads) c_s[i] = 0.0f;

  // issue the copies of step s's gate inputs of tile rows b0 .. into
  // buffer buf: gate g of the block's units is one run of 4 UN bytes
  auto stage_x = [&](int s, int b0, int buf) {
    const int t = reverse ? T - 1 - s : s;
    const int nb = min(bt, B - b0);
    float* dst = xbuf + buf * bt * xrow;
    if constexpr (!std::is_same<X, float>::value) {
      const X* src = reinterpret_cast<const X*>(a.xp) +
                     (static_cast<size_t>(t) * B + b0) * 4 * H + u0;
      for (int i = tid; i < nb * xrow; i += nthreads) {
        const int r = i / xrow;
        const int g = (i / UN) & 3;
        const int v = i % UN;
        if (v < nu) {
          dst[i] = resid::widen_loaded(resid::load(
              src + static_cast<size_t>(r) * 4 * H + g * H + v));
        }
      }
      return;
    }
    const float* src = a.xp + (static_cast<size_t>(t) * B + b0) * 4 * H + u0;
    if (quads) {
      constexpr int nq = UN >= 4 ? UN / 4 : 1;  // quads only at UN = 4
      for (int i = tid; i < nb * 4 * nq; i += nthreads) {
        const int r = i / (4 * nq);
        const int g = (i / nq) & 3;
        const int q4 = 4 * (i % nq);
        if (q4 < nu) {
          step::copy16(dst + r * xrow + g * UN + q4,
                       src + static_cast<size_t>(r) * 4 * H + g * H + q4);
        }
      }
    } else {
      for (int i = tid; i < nb * xrow; i += nthreads) {
        const int r = i / xrow;
        const int g = (i / UN) & 3;
        const int v = i % UN;
        if (v < nu) {
          step::copy4(dst + i,
                      src + static_cast<size_t>(r) * 4 * H + g * H + v);
        }
      }
    }
  };
  // issue the copies of h_{t-1} of tile rows b0 .. into buffer buf:
  // written by every block in the step before, read through L2, all in
  // flight at once
  auto stage_h = [&](int s, int b0, int buf) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    const int nb = min(bt, B - b0);
    float* dst = hbuf + buf * bt * Hp;
    const float* src = a.h + (static_cast<size_t>(tp) * B + b0) * H;
    if (Hp == H) {
      for (int i = tid; i < nb * H / 4; i += nthreads) {
        step::copy16(dst + 4 * i, src + 4 * i);
      }
    } else {
      for (int i = tid; i < nb * Hp; i += nthreads) {
        const int r = i / Hp;
        const int k = i % Hp;
        step::copy4(dst + i, k < H ? src + r * H + k : src, k < H);
      }
    }
  };

#ifdef LSTM_FWD_PROBE
  long long probe_cycles[kPhases] = {};
  long long probe_laps[kPhases] = {};
  long long lap_ = clock64();
#endif
  const int tiles = (B + bt - 1) / bt;
  int buf = 0;
  stage_x(0, 0, 0);
  step::commit();
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    if (s > 0) bar.wait();  // every block's h of step s - 1 is stored
    PROBE_LAP(0);
    for (int tile = 0; tile < tiles; ++tile) {
      const int b0 = tile * bt;
      const int nb = min(bt, B - b0);
      if (tile == 0) {
        if (s > 0) stage_h(s, 0, buf);
        step::commit();
      }
      if (tile + 1 < tiles) {
        // the next tile's gate inputs and h in flight while this one runs
        stage_x(s, b0 + bt, buf ^ 1);
        if (s > 0) stage_h(s, b0 + bt, buf ^ 1);
        step::commit();
        step::wait<1>();
      } else {
        step::wait<0>();
      }
      __syncthreads();  // this tile's gate inputs and h are in place
      PROBE_LAP(1);
      const float* h_s = hbuf + buf * bt * Hp;
      float* x_s = xbuf + buf * bt * xrow;
      if (active) {  // warp-uniform
        for (int r0 = kRound * split; r0 < nb; r0 += kRound * kSplits) {
          // lane 4 r + g: the product's sum for gate g of round row r
          // (rows past the tile read its last row, and are not stored)
          float acc[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
          if (s > 0) {  // h_{-1} is zero
#pragma unroll
            for (int q = 0; q < KQ; ++q) {
              const int k = kKSpan * q + 4 * lane;
              if (k < Hp) {
#pragma unroll
                for (int r = 0; r < kRound; ++r) {
                  const float4 hv = resid::operand<W>(
                      *reinterpret_cast<const float4*>(
                          h_s + min(r0 + r, nb - 1) * Hp + k));
#pragma unroll
                  for (int g = 0; g < 4; ++g) {
                    const int x = r * 4 + g;
                    acc[x] = fmaf(hv.x, wr[q][0][g], acc[x]);
                    acc[x] = fmaf(hv.y, wr[q][1][g], acc[x]);
                    acc[x] = fmaf(hv.z, wr[q][2][g], acc[x]);
                    acc[x] = fmaf(hv.w, wr[q][3][g], acc[x]);
                  }
                }
              }
            }
          }
          const float pre = step::reduce_scatter32(acc, lane);
          PROBE_LAP(2);
          // each lane its gate's activation; lane 4 r gathers its row's
          const int rr = r0 + (lane >> 2);
          const int g = lane & 3;
          float* x = x_s + min(rr, nb - 1) * xrow + g * UN + uw;
          const float v = *x + pre;
          const float act = g == 2 ? tanhf(v) : sigmoid_f(v);
          const int base = lane & ~3;
          const float i_g = __shfl_sync(0xffffffffu, act, base);
          const float f_g = __shfl_sync(0xffffffffu, act, base + 1);
          const float g_g = __shfl_sync(0xffffffffu, act, base + 2);
          const float o_g = __shfl_sync(0xffffffffu, act, base + 3);
          if (rr < nb) {
            *x = act;  // the gate takes the slot of its input
            if (g == 0) {
              float* c = c_s + uw * B + b0 + rr;
              // each product and the sum rounded on its own, as the plain
              // version's separate ops round them (no FMA contraction)
              const float c_new =
                  __fadd_rn(__fmul_rn(f_g, *c), __fmul_rn(i_g, g_g));
              *c = c_new;
              hc_s[rr * 2 * UN + uw] = o_g * tanhf(c_new);
              hc_s[(rr * 2 + 1) * UN + uw] = c_new;
            }
          }
          PROBE_LAP(3);
        }
      }
      __syncthreads();  // the tile's outputs are staged
      // the tile's outputs, a run of the block's units a (row, output):
      // the gates i, f, g, o, then h and c
      constexpr int n_out = 6;
      const size_t row0 = static_cast<size_t>(t) * B + b0;
      if constexpr (!std::is_same<R, float>::value) {
        // bfloat16 residuals: g and c rounded, 4 values in 8 bytes where
        // the runs are whole quads; h float32
        R* gres = reinterpret_cast<R*>(a.g);
        R* cres = reinterpret_cast<R*>(a.c);
        const int per = quads ? 4 : 1;  // values a thread stores
        const int nq = UN / per;
        for (int i = tid; i < nb * n_out * nq; i += nthreads) {
          const int r = i / (n_out * nq);
          const int j = (i / nq) % n_out;
          const int v = per * (i % nq);
          if (v >= nu) continue;
          const size_t row = row0 + r;
          if (j == 4) {
            const float* from = hc_s + r * 2 * UN + v;
            float* to = a.h + row * H + u0 + v;
            if (quads) {
              *reinterpret_cast<float4*>(to) =
                  *reinterpret_cast<const float4*>(from);
            } else {
              *to = *from;
            }
            continue;
          }
          const float* from = j < 4 ? x_s + r * xrow + j * UN + v
                                    : hc_s + (r * 2 + 1) * UN + v;
          R* to = j < 4 ? gres + row * 4 * H + j * H + u0 + v
                        : cres + row * H + u0 + v;
          if (quads) {
            resid::store4(to, *reinterpret_cast<const float4*>(from));
          } else {
            *to = resid::narrow<R>(*from);
          }
        }
      } else {
        auto out_of = [&](int r, int j, int v, const float** from) {
          const size_t row = row0 + r;
          if (j < 4) {
            *from = x_s + r * xrow + j * UN + v;
            return a.g + row * 4 * H + j * H + u0 + v;
          }
          *from = hc_s + (r * 2 + j - 4) * UN + v;
          return (j == 4 ? a.h : a.c) + row * H + u0 + v;
        };
        if (quads) {
          constexpr int nq = UN >= 4 ? UN / 4 : 1;
          for (int i = tid; i < nb * n_out * nq; i += nthreads) {
            const int r = i / (n_out * nq);
            const int j = (i / nq) % n_out;
            const int q4 = 4 * (i % nq);
            if (q4 < nu) {
              const float* from;
              float* to = out_of(r, j, q4, &from);
              *reinterpret_cast<float4*>(to) =
                  *reinterpret_cast<const float4*>(from);
            }
          }
        } else {
          for (int i = tid; i < nb * n_out * UN; i += nthreads) {
            const int r = i / (n_out * UN);
            const int j = (i / UN) % n_out;
            const int v = i % UN;
            if (v < nu) {
              const float* from;
              float* to = out_of(r, j, v, &from);
              *to = *from;
            }
          }
        }
      }
      PROBE_LAP(3);
      // the buffer's next copies go in at the next tile's start
      if (tile + 1 < tiles) __syncthreads();
      buf ^= 1;
    }
    bar.arrive();
    // the next step's first gate inputs in flight during the wait (the
    // buffer's readers passed the arrival's __syncthreads)
    if (s + 1 < T) stage_x(s + 1, 0, buf);
    step::commit();
    PROBE_LAP(4);
  }
#ifdef LSTM_FWD_PROBE
  if (lane == 0) {
    for (int p = 0; p < kPhases; ++p) {
      atomicAdd(&g_probe_cycles[p],
                static_cast<unsigned long long>(probe_cycles[p]));
      atomicAdd(&g_probe_laps[p],
                static_cast<unsigned long long>(probe_laps[p]));
    }
  }
#endif
}

template <int L, typename R, typename W, typename X>
cudaError_t fwd_narrow(const FwdArgs& a, cudaStream_t stream) {
  const lane_fwd::Dir d{a.xp, a.w, a.h, a.g, a.c, a.H};
  constexpr int rows = lane_fwd::kThreads / L;  // rows a block
  constexpr size_t smem = sizeof(float4) * L * L;
  const unsigned blocks = (static_cast<unsigned>(a.B) + rows - 1) / rows;
  lstm_fwd_narrow_kernel<L, R, W, X>
      <<<blocks, lane_fwd::kThreads, smem, stream>>>(d, a.T, a.B, a.reverse);
  return cudaGetLastError();
}

// The wide plan's batch tile: the largest that fits the budget beside the
// cell state, then evened out over the tiles it takes. Refuses a batch
// whose cell state leaves no room for one row.
template <int KQ, int UN, typename R, typename W, typename X>
cudaError_t fwd_wide(FwdArgs a, cudaStream_t stream) {
  const size_t budget = kSmemBudget / sizeof(float);
  const size_t c_f = cell_floats(UN, a.B);
  const size_t r_f = row_floats(UN, a.H);
  if (c_f + r_f > budget) {
    return cudaErrorInvalidValue;  // batch too large for the cell state
  }
  size_t bt = (budget - c_f) / r_f;
  if (bt > static_cast<size_t>(a.B)) bt = a.B;
  const size_t tiles = (a.B + bt - 1) / bt;
  a.bt = static_cast<int>((a.B + tiles - 1) / tiles);
  const size_t smem = (c_f + a.bt * r_f) * sizeof(float);
  void* args[] = {&a};
  return step::launch_cooperative(lstm_fwd_wide_kernel<KQ, UN, R, W, X>,
                                  (a.H + UN - 1) / UN, UN * kSplits * 32,
                                  smem, args, stream);
}

template <int KQ>
cudaError_t fwd_wide_units(const FwdArgs& a, int units, cudaStream_t s) {
  switch (units) {
    case 1: return fwd_wide<KQ, 1, float, float, float>(a, s);
    case 2: return fwd_wide<KQ, 2, float, float, float>(a, s);
    default: return fwd_wide<KQ, 4, float, float, float>(a, s);
  }
}

// The residual-saving forward at the residuals', W_hh's and xp's element
// types: the narrow plan where H <= lane_fwd::kLaneMaxH, else the wide one.
// The float32 instances keep every (passes, units) pair the dispatch of
// the float32 kernel had; the others build only the three pairs a width
// reaches (plan_units(H) and ceil(H / kKSpan): 1 and 1 up to H = 128, 2
// and 2 up to 256, 4 and 4 above).
template <typename R, typename W, typename X>
cudaError_t fwd_dispatch(const FwdArgs& a, cudaStream_t s) {
  const int H = a.H;
  if (H <= 1) return fwd_narrow<1, R, W, X>(a, s);
  if (H <= 2) return fwd_narrow<2, R, W, X>(a, s);
  if (H <= 4) return fwd_narrow<4, R, W, X>(a, s);
  if (H <= 8) return fwd_narrow<8, R, W, X>(a, s);
  if (H <= 16) return fwd_narrow<16, R, W, X>(a, s);
  if (H <= lane_fwd::kLaneMaxH) return fwd_narrow<32, R, W, X>(a, s);
  const int units = plan_units(H);
  const int kq = (H + kKSpan - 1) / kKSpan;
  if constexpr (std::is_same<R, float>::value &&
                std::is_same<W, float>::value &&
                std::is_same<X, float>::value) {
    if (kq <= 1) return fwd_wide_units<1>(a, units, s);
    if (kq <= 2) return fwd_wide_units<2>(a, units, s);
    return fwd_wide_units<4>(a, units, s);
  } else {
    if (kq <= 1 && units == 1) return fwd_wide<1, 1, R, W, X>(a, s);
    if (kq <= 2 && units == 2) return fwd_wide<2, 2, R, W, X>(a, s);
    return fwd_wide<4, 4, R, W, X>(a, s);
  }
}

static_assert(lane_fwd::kLaneMaxH == 32,
              "the narrow plan's widest instance is L = 32");
static_assert(plan_units(kMaxH) == 4 && kMaxH <= 4 * kKSpan,
              "the wide plan's widest block and passes");
static_assert(plan_units(kKSpan) == 1 && plan_units(kKSpan + 1) == 2 &&
                  plan_units(2 * kKSpan) == 2 &&
                  plan_units(2 * kKSpan + 1) == 4,
              "fwd_dispatch's (passes, units) pairs follow plan_units");

}  // namespace

extern "C" {

// Lean forward of one direction; reverse != 0 walks T-1 -> 0. plan: 0 by
// width (narrow where H <= kNarrowMaxH, else wide), 1 narrow (H <=
// kNarrowMaxH), 2 wide; only a measurement forces one. c is a [B, H]
// scratch. w_bf16: W_hh in bfloat16 (bfloat16 compute), and then xp_bf16:
// xp in bfloat16 too (a bfloat16 xp beside a float32 W_hh returns
// cudaErrorInvalidValue); h is float32. Returns a cudaError_t (0 on
// success). Does not synchronise.
int lstm_infer_launch(const void* xp, const void* w, void* h, void* c, int T,
                      int B, int H, int reverse, int plan, int w_bf16,
                      int xp_bf16, int device, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxH || plan < 0 || plan > 2 ||
      (plan == 1 && H > kNarrowMaxH)) {
    return cudaErrorInvalidValue;
  }
  if (xp_bf16 && !w_bf16) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xp);
  auto wh = static_cast<const float*>(w);
  auto ho = static_cast<float*>(h);
  auto co = static_cast<float*>(c);
  const int r = reverse ? 1 : 0;
  using resid::bf16;
  if (!w_bf16) return infer_plan<float, float>(x, wh, ho, co, T, B, H, r,
                                               plan, s);
  if (xp_bf16) return infer_plan<bf16, bf16>(x, wh, ho, co, T, B, H, r,
                                             plan, s);
  return infer_plan<bf16, float>(x, wh, ho, co, T, B, H, r, plan, s);
}

// Residual-saving forward: also writes g [T, B, 4H] and c [T, B, H], in
// float32, or with resid_bf16 in bfloat16 (h stays float32). w_bf16:
// W_hh in bfloat16 (bfloat16 compute), and xp_bf16: xp in bfloat16; xp
// is bfloat16 exactly where W_hh and the residuals both are
// (pallas_lstm.stream_dtype), and other sets return
// cudaErrorInvalidValue. The narrow plan where H <= lane_fwd::kLaneMaxH,
// else the wide one. barrier: one 32-bit word, zero at the launch (the
// wide plan's grid barrier). Returns a cudaError_t (0 on success). Does
// not synchronise.
int lstm_fwd_launch(const void* xp, const void* w, void* h, void* g, void* c,
                    void* barrier, int T, int B, int H, int reverse,
                    int resid_bf16, int w_bf16, int xp_bf16, int device,
                    void* stream) {
  if (T < 1 || B < 1 || B > kMaxBatch || H < 1 || H > kMaxH ||
      (xp_bf16 != 0) != (resid_bf16 && w_bf16)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  FwdArgs a = {};
  a.xp = static_cast<const float*>(xp);
  a.w = static_cast<const float*>(w);
  a.h = static_cast<float*>(h);
  a.g = static_cast<float*>(g);
  a.c = static_cast<float*>(c);
  a.barrier = static_cast<unsigned*>(barrier);
  a.T = T;
  a.B = B;
  a.H = H;
  a.reverse = reverse ? 1 : 0;
  auto s = static_cast<cudaStream_t>(stream);
  using resid::bf16;
  if (w_bf16) {
    if (resid_bf16) return fwd_dispatch<bf16, bf16, bf16>(a, s);
    return fwd_dispatch<float, bf16, float>(a, s);
  }
  if (resid_bf16) return fwd_dispatch<bf16, float, float>(a, s);
  return fwd_dispatch<float, float, float>(a, s);
}

const char* lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef LSTM_FWD_PROBE
// Cycles and laps of each phase of lstm_fwd since the last reset, summed
// over warps.
int lstm_fwd_probe_read(unsigned long long* cycles, unsigned long long* laps,
                        int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_probe_cycles,
                                         sizeof(g_probe_cycles));
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(laps, g_probe_laps, sizeof(g_probe_laps));
  }
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(g_probe_cycles, zero, sizeof(zero));
    if (err == cudaSuccess) {
      err = cudaMemcpyToSymbol(g_probe_laps, zero, sizeof(zero));
    }
  }
  return err;
}
#endif

}  // extern "C"
