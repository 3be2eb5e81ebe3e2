// Merged bidirectional LSTM layer forward, float32 or with bfloat16
// compute: the lean forward
// (h only) and the residual-saving forward of training, each either on
// pre-projected gate inputs (one kernel body) or with the input
// projection in the kernel (a body of its own).
//
// Replaces: speechsplit_tpu/ops/pallas_lstm.py::_bd_infer_kernel (wrapper
// _bd_infer), the TPU kernel that runs both directions of one BiLSTM layer
// in one grid, and, with kResid, ::_bd_fwd_kernel (wrapper _bd_fwd), which
// also writes each step's post-activation gates and cell state for the
// backward (csrc/bilstm_bwd.cu). With kProj the same two replace
// ::_bdp_infer_kernel (wrapper _bdp_infer) and ::_bdp_fwd_kernel (wrapper
// _bdp_fwd), which compute the gate inputs x W_ih^T + b inside the grid so
// the [T, B, 4H] projected tensors never go through HBM. Same math as
// pallas_lstm._cell: gates = xp + h_{t-1} W_hh^T ordered i, f, g, o;
// sigmoid/sigmoid/tanh/sigmoid; c = f c + i g; h = o tanh(c); state float32
// from zero. The backward direction walks T-1 -> 0 over inputs and outputs
// kept in real time order.
//
// Layouts: xp_f, xp_b [T, B, 4H] (time-major, real time order); w_f, w_b
// [4H, H] (torch's weight_hh_l{k}: row g*H + u holds gate g of unit u);
// h_f, h_b [T, B, H]; with kResid also g_f, g_b [T, B, 4H] (the gates
// i, f, g, o after their activations) and c_f, c_b [T, B, H]. With kProj
// the inputs are x [T, B, I] (both directions read it), wi_f, wi_b [4H, I]
// (torch's weight_ih_l{k}) and b_f, b_b [4H] (b_ih + b_hh) in place of xp.
// The unfused residual-saving forward stores g and c in float32 or, as
// _bd_fwd does under the JAX default residual_dtype, in bfloat16 (R):
// rounded as they are stored, while h and the c carry stay float32
// (pallas_lstm.py:648-657); so do the fused ones (_bdp_fwd). The
// kernels also run the JAX package's bfloat16 compute
// (compute_dtype="bfloat16"): W_hh in bfloat16, widened into the
// registers that hold it, and h_{t-1} rounded to bfloat16 where a step's
// product reads it (pallas_lstm._cell's h.astype(w.dtype)); the sums, the
// gates, c and the h stored stay float32. Their gate inputs xp are
// float32, or bfloat16 beside bfloat16 residuals (pallas_lstm.stream_dtype),
// widened as they are staged. At bfloat16 compute the fused kernels take
// x and W_ih in bfloat16 as well (JAX's _proj: both in W_ih's dtype, the
// products summed in float32, then the float32 bias): they are widened as
// they are staged, so that each product of two bfloat16 values is exact
// in float32 and only the order of the sum differs from JAX's. The gate
// inputs stay float32 in the kernel, and h is float32 out of it
// (_h_stream_dtype).
//
// What bounds it on an H100: the recurrence. Step t needs all of h_{t-1},
// so the T steps are serial and each is a small [B, H] x [H, 4H] product
// followed by a cell update. At the mel decoder's H = 512, W_hh is 4 MiB a
// direction, far more than one SM's 227 KB of shared memory, so one block
// cannot hold a direction and the steps need a barrier across blocks. The
// per-step work is small (2*B*H*4H flops), so the time goes to latency:
// the grid-wide barrier and the reload of h_{t-1}, not to bytes from HBM
// (W is read once) or to arithmetic. The fused projection adds
// 2*T*B*I*4H flops a direction with no dependence between steps: at
// I = 1024 that is 4x the recurrence's flops, in float32 FMAs (no TF32).
//
// What the design of the unfused kernels (bilstm_infer_kernel) does
// about it. One persistent cooperative launch a layer, its blocks split
// between the two directions; the launch fails rather than deadlocks
// when the grid cannot be co-resident. A block owns up to 8 hidden units
// and keeps their four gate rows of W_hh in registers for the whole
// sequence, so W is read from HBM once. The probe build below splits a
// step into its phases (PERF.md); against what they showed:
// - The step product: warp w owns a unit and holds its rows at k = 128 q
//   + 4 lane + kk, so one 16-byte shared load of h_{t-1} feeds 16 FMAs;
//   a round covers 8 batch rows x 4 gates, reduced by one butterfly
//   (merged_step.cuh) that leaves lane 4 r + g the sum of row r, gate g.
//   Rows past the batch read its last row instead of branching, so that
//   the loads of a round issue together. Each lane applies its gate's
//   activation and lane 4 r the cell update; c stays in shared memory.
// - Up to H = 8 (one block a direction) lane 4 r + g holds all of gate
//   g's row and sums its dot product alone: no butterfly. Such a block
//   keeps h_{t-1} in shared memory when the batch is one tile.
// - From H = 9 to kSplitMaxH a block runs 4 units with two warps each,
//   the rounds dealt out between them: 2 x 64 blocks at H = 256, where
//   8 units a block used 64 of the 132 SMs.
// - h_{t-1} (read from the output itself, written by every block of the
//   direction in the step before) is staged with 16-byte cp.async
//   through L2, all in flight at once. Where the batch does not fit,
//   its tiles are double-buffered: tile k + 1's copies fly while tile k
//   is summed.
// - The gate inputs of the block's units (32 contiguous bytes a row and
//   gate) go into shared memory by 16-byte cp.async a step ahead,
//   between the block's arrival at the barrier and its wait, so the cell
//   update reads shared memory only.
// - The barrier is split and per direction (merged_step.cuh): a block
//   waits only on its own direction's blocks, and a direction of one
//   block uses __syncthreads() alone.
// - The outputs are staged in the slots of the gate inputs they replace
//   (h; with kResid the gates, and h and c beside them) and stored in
//   runs of the block's units, 32 bytes a row and output.
// Built with -DBILSTM_INFER_PROBE (chip_smoke.py's probe build), the
// kernel also adds up clock64() laps of each phase of a step per warp,
// which bilstm_infer_probe_read returns.
//
// The fused kernels (bilstm_fused_kernel; kProj above) have an entry and
// a body of their own; the unfused kernels' design above does not change
// their machine code.
// What bounds them beyond the recurrence: the projection's FMAs (4x the
// step products' at I = 4H), with all of x read by every block of a
// direction, and a projection computed between steps holds every step
// back. What the design does about it:
// - Two fold buffers. The gate inputs of fold k + 1 are computed in
//   slices during fold k's steps, each slice a share of the K-tiles of
//   all the fold's rows, added onto the partial sums in the buffer; a
//   block needs the gate inputs of its own units only, so no block waits
//   on another's projection.
// - A split grid barrier (merged_step.cuh): a block arrives once its h
//   stores of the step are made, runs its slice, then waits, so a slice
//   fills the time the block would spend waiting on the slowest block.
// - Every copy into shared memory is a 16-byte cp.async (4-byte ones only
//   for rows that are not 16-byte aligned), all of a tile in flight at
//   once; W_ih's rows go in once a fold. A slice's pass covers 256 fold
//   rows, 8 rows x one unit's 4 gates a thread, in float32 FMAs over
//   ascending k, then the bias in the slice that ends the fold's K-tiles.
// - The step product: warp w owns unit w with its 4 gate rows of W_hh in
//   registers at k = 4 lane + kk + 128 q, so one 16-byte shared load of
//   h_{t-1} feeds 16 FMAs; 8 batch rows x 4 gates of partial sums are
//   reduced by one butterfly (merged_step.cuh) that leaves lane 4 r + g
//   the sum of row r, gate g, and lane 4 r applies the cell update.
// - Thread-block clusters would share the staging of x and h across
//   blocks, but a cooperative grid of 128 blocks at this shared memory
//   fits the card only in clusters of 2 (PERF.md), so the grid has none.
// - bfloat16 x and W_ih (bfloat16 compute) cannot go in by cp.async,
//   which does not widen: their instances load them (8 bytes, four
//   values, where the rows are whole quads) and store them widened into
//   the same float32 K-tiles, before the tile's sums start. The float32
//   instances keep their machine code.

#include <cuda_runtime.h>

#include "merged_step.cuh"
#include "resid.cuh"

namespace {

constexpr int kMaxUnits = 8;   // hidden units (= warps) per block
constexpr int kMaxH = 512;
constexpr size_t kSmemBudget = 160 * 1024;
// The fused kernels. A (step, batch row) row of the fold buffer holds the
// gate inputs of the block's units, unit-major, gates i f g o.
constexpr int kGateRow = 4 * kMaxUnits;
constexpr int kFusedThreads = kMaxUnits * 32;
constexpr int kRound = 8;     // batch rows a warp sums at once (x 4 gates)
constexpr int kKSpan = 128;   // k of h_{t-1} one pass covers, 4 a lane
constexpr int kChunk = 256;   // fold rows a projection pass covers
constexpr int kKT = 32;       // K-tile of the projection
constexpr int kXS = kKT + 4;  // x and W_ih tile row stride: aligned float4
constexpr int kMaxFold = 32;
constexpr size_t kProjSmemBudget = 220 * 1024;
static_assert(kRound * 4 == 32, "a round reduces 32 sums a warp");
static_assert(kChunk == 8 * kFusedThreads / kMaxUnits, "8 rows a thread");

// The input projection of the fused kernels.
struct Proj {
  const float* x;
  const float* wi_f;
  const float* wi_b;
  const float* b_f;
  const float* b_b;
  int I, fold;
};

// A fused launch's arguments and plan (the kernels take it whole). xp_f
// and xp_b are not read: they hold the layout the fused kernels were
// compiled against, so that their machine code stays as it was.
struct Params {
  const float* xp_f;
  const float* xp_b;
  const float* w_f;
  const float* w_b;
  float* h_f;
  float* h_b;
  float* g_f;
  float* g_b;
  float* c_f;
  float* c_b;
  Proj proj;           // kProj only
  unsigned* barrier;   // kProj only: zeroed before the launch
  int T, B, H;
  // the launch plan
  int blocks_per_dir, units, bt, region;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shared-memory floats of the projection's staging: the global offsets of
// a pass's kChunk rows of x (64-bit), then two buffers, each an x K-tile
// [kChunk][kXS] and a W_ih K-tile [kGateRow][kXS].
constexpr int proj_tile_floats() {
  return 2 * kChunk + 2 * (kChunk * kXS + kGateRow * kXS);
}

// The largest batch the fused kernels take: at fold 1 and one batch row
// of h, each batch row holds two buffers of kGateRow gate inputs and
// kMaxUnits cell states beside the projection's staging. ops/bilstm.py
// reads the value from this line, so the kernel is the one owner of the
// limit.
constexpr int kMaxFusedBatch = 487;
constexpr size_t fold1_floats(int batch) {
  return static_cast<size_t>(batch) * (2 * kGateRow + kMaxUnits) +
         proj_tile_floats();
}
static_assert(fold1_floats(kMaxFusedBatch) <= kProjSmemBudget / 4 &&
                  fold1_floats(kMaxFusedBatch + 1) > kProjSmemBudget / 4,
              "kMaxFusedBatch must be the largest batch plan_fused holds");

// The unfused kernels (bilstm_infer, bilstm_fwd). A block runs `units`
// hidden units with `splits` warps a unit (the rounds of 8 batch rows
// dealt out between them), at most kMaxUnits warps in all. Shared
// memory: two buffers, each a batch tile of h_{t-1} [bt][Hp] (H padded
// to 4) and of the units' gate inputs [bt][4][units]; with kResid the
// tile's h and c [bt][2][units]; the cell state [units][B]. A tile's
// outputs are staged in the gate-input slots they replace (and the h, c
// rows), so that they leave in 32-byte runs. The kernels take B rows at
// width H while the cell state and one row of each buffer (and of the
// h, c rows) fit these floats (launch_unfused() below). ops/bilstm.py
// reads the value from this line (merged_max_batch), so the kernel is
// the one owner of the limit.
constexpr int kUnfusedSmemFloats = 40960;
static_assert(kUnfusedSmemFloats * sizeof(float) == kSmemBudget,
              "kUnfusedSmemFloats must be the unfused launch's budget");
// Widths above kMaxUnits and up to this one run 4 units a block with 2
// warps a unit (2 x 64 blocks at H = 256), so that twice the SMs share
// the rounds; wider layers and narrower ones run 8 units a block, one
// warp each. ops/bilstm.py reads the value from this line.
constexpr int kSplitMaxH = 256;
// Widths up to this one (one block a direction) run the narrow product:
// lane 4 r + g sums row r's dot product with gate g's row of W_hh
// itself, no reduction across lanes.
constexpr int kNarrowMaxH = kMaxUnits;

#ifdef BILSTM_INFER_PROBE
// phases: 0 barrier wait, 1 h staging, 2 FMAs and reduction, 3 cell and
// stores, 4 gate-input prefetch and arrival
constexpr int kPhases = 5;
__device__ unsigned long long g_probe_cycles[kPhases];
__device__ unsigned long long g_probe_laps[kPhases];
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

// A launch of the unfused kernels: its arguments and plan.
struct Unfused {
  const float* xp[2];
  const float* w[2];
  float* h[2];
  float* g[2];
  float* c[2];
  unsigned* barrier;  // one word a direction, zeroed before the launch
  int T, B, H;
  int splits, units, blocks_per_dir, bt;
};

// The recurrence of both directions on pre-projected gate inputs. KQ:
// passes of kKSpan, ceil(H / kKSpan); 0 for the narrow product. R: the
// element type of the residuals g and c (kResid), float or bfloat16; they
// are staged in float32 like h and rounded as they are stored. W: the
// element type of W_hh, float or bfloat16 (bfloat16 compute): widened
// into the registers that hold it, and h_{t-1} rounded to bfloat16 where
// the product reads it, the sums, the cell and h itself float32. X: the
// element type of the gate inputs xp, float or bfloat16 (bfloat16 W with
// bfloat16 residuals, as pallas_lstm.stream_dtype): widened as they are
// staged.
template <int KQ, bool kResid, typename R = float, typename W = float,
          typename X = float>
__global__ void __launch_bounds__(kMaxUnits * 32, 1)
bilstm_infer_kernel(const Unfused a) {
  extern __shared__ __align__(16) float smem_unfused[];
  const int T = a.T, B = a.B, H = a.H, U = a.units, S = a.splits;
  const int bt = a.bt;
  const int Hp = (H + 3) & ~3;
  const int xrow = 4 * U;  // a tile row of gate inputs: [4][U]
  float* hbuf = smem_unfused;                           // [2][bt][Hp]
  float* xbuf = hbuf + 2 * bt * Hp;                     // [2][bt][4][U]
  float* hc_s = xbuf + 2 * bt * xrow;                   // [bt][2][U]
  float* c_s = hc_s + (kResid ? 2 * bt * U : 0);        // [U][B]

  const int dir = blockIdx.x / a.blocks_per_dir;
  const int blk = blockIdx.x % a.blocks_per_dir;
  const float* xp = dir == 0 ? a.xp[0] : a.xp[1];
  const float* w = dir == 0 ? a.w[0] : a.w[1];
  float* hout = dir == 0 ? a.h[0] : a.h[1];
  float* gout = dir == 0 ? a.g[0] : a.g[1];
  float* cout = dir == 0 ? a.c[0] : a.c[1];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int uw = warp % U;     // this warp's unit in the block
  const int split = warp / U;  // its share of the rounds
  const int u0 = blk * U;
  const int nu = min(U, H - u0);  // this block's units
  const int u = u0 + uw;
  const bool active = uw < nu;
  // gate-input and output rows in 16-byte copies where every run of the
  // block's units is whole quads
  const bool quads = (H & 3) == 0 && (U & 3) == 0;
  step::DirBarrier bar(dir == 0 ? a.barrier : a.barrier + 1,
                       a.blocks_per_dir);

  // wide (KQ > 0): this warp's four gate rows of W_hh at k = kKSpan q +
  // 4 lane + kk; narrow (KQ = 0, H <= kNarrowMaxH): lane 4 r + g holds
  // all of gate g's row
  constexpr int kQ = KQ > 0 ? KQ : 1;
  float wr[kQ][4][4];
  float wn[kNarrowMaxH];
  if constexpr (KQ > 0) {
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = kKSpan * q + 4 * lane + kk;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          wr[q][kk][g] =
              (active && k < H)
                  ? resid::widen(reinterpret_cast<const W*>(
                        w)[static_cast<size_t>(g * H + u) * H + k])
                  : 0.0f;
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kNarrowMaxH; ++k) {
      wn[k] = (active && k < H)
                  ? resid::widen(reinterpret_cast<const W*>(
                        w)[static_cast<size_t>((lane & 3) * H + u) * H + k])
                  : 0.0f;
    }
  }
  for (int i = tid; i < U * B; i += nthreads) c_s[i] = 0.0f;
  // A direction of one block whose batch is one tile keeps its h_{t-1} in
  // shared memory: the tile's h goes into the next step's buffer as well
  // as out, whose padding stays zero.
  const int tiles = (B + bt - 1) / bt;
  const bool own_h = a.blocks_per_dir == 1 && tiles == 1;
  if (own_h) {
    for (int i = tid; i < 2 * bt * Hp; i += nthreads) hbuf[i] = 0.0f;
  }

  // issue the copies of step s's gate inputs of tile rows b0 .. into
  // buffer buf: gate g of the block's units is one run of 4 U bytes (2 U
  // bytes of bfloat16 ones, loaded and widened as they are stored: cp.async
  // cannot widen)
  auto stage_x = [&](int s, int b0, int buf) {
    const int t = dir == 0 ? s : T - 1 - s;
    const int nb = min(bt, B - b0);
    float* dst = xbuf + buf * bt * xrow;
    if constexpr (!std::is_same<X, float>::value) {
      const X* src = reinterpret_cast<const X*>(xp) +
                     (static_cast<size_t>(t) * B + b0) * 4 * H + u0;
      if (quads) {
        // 4 bfloat16s a load of 8 bytes
        const int nq = U / 4;
        for (int i = tid; i < nb * 4 * nq; i += nthreads) {
          const int r = i / (4 * nq);
          const int g = (i / nq) & 3;
          const int q4 = 4 * (i % nq);
          if (q4 < nu) {
            const uint2 bits = __ldg(reinterpret_cast<const uint2*>(
                src + static_cast<size_t>(r) * 4 * H + g * H + q4));
            *reinterpret_cast<float4*>(dst + r * xrow + g * U + q4) =
                make_float4(__uint_as_float(bits.x << 16),
                            __uint_as_float(bits.x & 0xffff0000u),
                            __uint_as_float(bits.y << 16),
                            __uint_as_float(bits.y & 0xffff0000u));
          }
        }
      } else {
        for (int i = tid; i < nb * xrow; i += nthreads) {
          const int r = i / xrow;
          const int g = (i / U) & 3;
          const int v = i % U;
          if (v < nu) {
            dst[i] = resid::widen_loaded(resid::load(
                src + static_cast<size_t>(r) * 4 * H + g * H + v));
          }
        }
      }
      return;
    }
    const float* src = xp + (static_cast<size_t>(t) * B + b0) * 4 * H + u0;
    if (quads) {
      const int nq = U / 4;
      for (int i = tid; i < nb * 4 * nq; i += nthreads) {
        const int r = i / (4 * nq);
        const int g = (i / nq) & 3;
        const int q4 = 4 * (i % nq);
        if (q4 < nu) {
          step::copy16(dst + r * xrow + g * U + q4,
                       src + static_cast<size_t>(r) * 4 * H + g * H + q4);
        }
      }
    } else {
      for (int i = tid; i < nb * xrow; i += nthreads) {
        const int r = i / xrow;
        const int g = (i / U) & 3;
        const int v = i % U;
        if (v < nu) {
          step::copy4(dst + i,
                      src + static_cast<size_t>(r) * 4 * H + g * H + v);
        }
      }
    }
  };
  // issue the copies of h_{t-1} of tile rows b0 .. into buffer buf:
  // written by every block of the direction in the step before, read
  // through L2, all in flight at once
  auto stage_h = [&](int s, int b0, int buf) {
    const int t = dir == 0 ? s : T - 1 - s;
    const int tp = dir == 0 ? t - 1 : t + 1;
    const int nb = min(bt, B - b0);
    float* dst = hbuf + buf * bt * Hp;
    const float* src = hout + (static_cast<size_t>(tp) * B + b0) * H;
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

#ifdef BILSTM_INFER_PROBE
  long long probe_cycles[kPhases] = {};
  long long probe_laps[kPhases] = {};
  long long lap_ = clock64();
#endif
  int buf = 0;
  stage_x(0, 0, 0);
  step::commit();
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? s : T - 1 - s;
    if (s > 0) bar.wait();  // the direction's h of step s - 1 is stored
    PROBE_LAP(0);
    for (int tile = 0; tile < tiles; ++tile) {
      const int b0 = tile * bt;
      const int nb = min(bt, B - b0);
      if (tile == 0) {
        if (s > 0 && !own_h) stage_h(s, 0, buf);
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
        for (int r0 = kRound * split; r0 < nb; r0 += kRound * S) {
          // lane 4 r + g: the product's sum for gate g of round row r
          // (rows past the tile read its last row, and are not stored)
          float pre = 0.0f;
          if constexpr (KQ > 0) {
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
            pre = step::reduce_scatter32(acc, lane);
          } else if (s > 0) {
            const float* hr = h_s + min(r0 + (lane >> 2), nb - 1) * Hp;
#pragma unroll
            for (int k = 0; k < kNarrowMaxH; k += 4) {
              if (k < Hp) {
                const float4 hv = resid::operand<W>(
                    *reinterpret_cast<const float4*>(hr + k));
                pre = fmaf(hv.x, wn[k], pre);
                pre = fmaf(hv.y, wn[k + 1], pre);
                pre = fmaf(hv.z, wn[k + 2], pre);
                pre = fmaf(hv.w, wn[k + 3], pre);
              }
            }
          }
          PROBE_LAP(2);
          // each lane its gate's activation; lane 4 r gathers its row's
          const int rr = r0 + (lane >> 2);
          const int g = lane & 3;
          float* x = x_s + min(rr, nb - 1) * xrow + g * U + uw;
          const float v = *x + pre;
          const float act = g == 2 ? tanhf(v) : sigmoid_f(v);
          const int base = lane & ~3;
          const float i_g = __shfl_sync(0xffffffffu, act, base);
          const float f_g = __shfl_sync(0xffffffffu, act, base + 1);
          const float g_g = __shfl_sync(0xffffffffu, act, base + 2);
          const float o_g = __shfl_sync(0xffffffffu, act, base + 3);
          if (rr < nb) {
            // the outputs take the slots of the inputs they came from
            if constexpr (kResid) *x = act;
            if (g == 0) {
              float* c = c_s + uw * B + b0 + rr;
              const float c_new = f_g * *c + i_g * g_g;
              *c = c_new;
              const float h_new = o_g * tanhf(c_new);
              if constexpr (kResid) {
                hc_s[rr * 2 * U + uw] = h_new;
                hc_s[(rr * 2 + 1) * U + uw] = c_new;
              } else {
                *x = h_new;
              }
            }
          }
          PROBE_LAP(3);
        }
      }
      __syncthreads();  // the tile's outputs are staged
      if constexpr (!std::is_same<R, float>::value) {
        // bfloat16 residuals: h as below, g and c rounded, 4 values
        // in 8 bytes where the runs are whole quads
        float* next_h = hbuf + (buf ^ 1) * bt * Hp;  // own_h only
        const size_t row0 = static_cast<size_t>(t) * B + b0;
        R* gres = reinterpret_cast<R*>(dir == 0 ? a.g[0] : a.g[1]);
        R* cres = reinterpret_cast<R*>(dir == 0 ? a.c[0] : a.c[1]);
        // output j of tile row r at unit v: j < 4 the gates, 4 h, 5 c
        auto res_of = [&](int r, int j, int v, const float** from) -> R* {
          const size_t row = row0 + r;
          if (j < 4) {
            *from = x_s + r * xrow + j * U + v;
            return gres + row * 4 * H + j * H + u0 + v;
          }
          *from = hc_s + (r * 2 + 1) * U + v;
          return cres + row * H + u0 + v;
        };
        const int per = quads ? 4 : 1;  // values a thread stores
        const int nq = U / per;
        for (int i = tid; i < nb * 6 * nq; i += nthreads) {
          const int r = i / (6 * nq);
          const int j = (i / nq) % 6;
          const int v = per * (i % nq);
          if (v >= nu) continue;
          if (j == 4) {
            const float* from = hc_s + r * 2 * U + v;
            float* to = hout + (row0 + r) * H + u0 + v;
            if (quads) {
              const float4 hv = *reinterpret_cast<const float4*>(from);
              *reinterpret_cast<float4*>(to) = hv;
              if (own_h) {
                *reinterpret_cast<float4*>(next_h + r * Hp + v) = hv;
              }
            } else {
              *to = *from;
              if (own_h) next_h[r * Hp + v] = *from;
            }
          } else {
            const float* from;
            R* to = res_of(r, j, v, &from);
            if (quads) {
              resid::store4(to, *reinterpret_cast<const float4*>(from));
            } else {
              *to = resid::narrow<R>(*from);
            }
          }
        }
      } else {
        // the tile's outputs, a run of the block's units a (row, output):
        // lean h (from slot 0); with kResid the gates i, f, g, o, then h, c
        const int n_out = kResid ? 6 : 1;
        const int j_h = kResid ? 4 : 0;  // h among them
        float* next_h = hbuf + (buf ^ 1) * bt * Hp;  // own_h only
        const size_t row0 = static_cast<size_t>(t) * B + b0;
        auto out_of = [&](int r, int j, int v, const float** from) {
          const size_t row = row0 + r;
          if (!kResid) {
            *from = x_s + r * xrow + v;
            return hout + row * H + u0 + v;
          }
          if (j < 4) {
            *from = x_s + r * xrow + j * U + v;
            return gout + row * 4 * H + j * H + u0 + v;
          }
          *from = hc_s + (r * 2 + j - 4) * U + v;
          return (j == 4 ? hout : cout) + row * H + u0 + v;
        };
        if (quads) {
          const int nq = U / 4;
          for (int i = tid; i < nb * n_out * nq; i += nthreads) {
            const int r = i / (n_out * nq);
            const int j = (i / nq) % n_out;
            const int q4 = 4 * (i % nq);
            if (q4 < nu) {
              const float* from;
              float* to = out_of(r, j, q4, &from);
              const float4 v = *reinterpret_cast<const float4*>(from);
              *reinterpret_cast<float4*>(to) = v;
              if (own_h && j == j_h) {
                *reinterpret_cast<float4*>(next_h + r * Hp + q4) = v;
              }
            }
          }
        } else {
          for (int i = tid; i < nb * n_out * U; i += nthreads) {
            const int r = i / (n_out * U);
            const int j = (i / U) % n_out;
            const int v = i % U;
            if (v < nu) {
              const float* from;
              float* to = out_of(r, j, v, &from);
              *to = *from;
              if (own_h && j == j_h) next_h[r * Hp + v] = *from;
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
#ifdef BILSTM_INFER_PROBE
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

// K-tiles kt_lo .. kt_hi - 1 of the gate inputs of `rows` fold rows (row
// m: step s0 + m / B, batch row m % B) of this block's units, added to
// the partial sums in gates[m][kGateRow] (kt_lo = 0 starts them from
// zero; kt_hi = the last tile adds the bias): gates[m][wi * 4 + g] +=
// sum_i x[t][b][i] * wih[g*H + unit0 + wi][i] over the tiles' i, in
// ascending i. A pass covers kChunk rows, 8 a thread, so thread (row
// group mg, unit rg) keeps 8 x 4 sums, of rows mg + 32 j (neighbouring
// row groups in neighbouring rows: a warp's shared loads of x meet no
// bank conflict). The K-tiles are double-buffered, tile k + 1 in flight
// (cp.async) while tile k is summed. Called by every thread of the
// block; `tiles` is proj_tile_floats() of shared memory. X: the element
// type of x and W_ih, float or bfloat16 (widened as they are staged).
template <typename X = float>
__device__ void project_slice(const Proj& q, const float* __restrict__ wih,
                              const float* __restrict__ bias, float* gates,
                              float* tiles, int dir, int s0, int rows,
                              int T, int B, int H, int unit0, int nu,
                              int kt_lo, int kt_hi) {
  if (kt_lo >= kt_hi) return;  // block-uniform
  const int I = q.I;
  const int n_kt = (I + kKT - 1) / kKT;
  const int tid = threadIdx.x;
  const int rg = tid & 7;
  const int mg = tid >> 3;
  long long* row_off = reinterpret_cast<long long*>(tiles);  // [kChunk]
  float* bufs = tiles + 2 * kChunk;
  constexpr int kBufFloats = (kChunk + kGateRow) * kXS;
  const bool quads = (I & 3) == 0;  // x and W_ih rows in 16-byte copies
  const bool last = kt_hi == n_kt;
  float bias_r[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bias_r[g] = last && rg < nu ? bias[g * H + unit0 + rg] : 0.0f;
  }

  // issue the copies of K-tile kt into buffer kt % 2: x [kChunk][kXS],
  // then W_ih [g * 8 + wi][kXS]
  auto stage = [&](int kt) {
    float* xs = bufs + (kt & 1) * kBufFloats;
    float* ws = xs + kChunk * kXS;
    const int k0 = kt * kKT;
    if constexpr (!std::is_same<X, float>::value) {
      // loaded and stored widened (zeros past I and past the rows);
      // four values a load of 8 bytes where the rows are whole quads
      const X* xq = reinterpret_cast<const X*>(q.x);
      const X* wq = reinterpret_cast<const X*>(wih);
      const int per = quads ? 4 : 1;
      for (int i = tid; i < (kChunk + kGateRow) * (kKT / per);
           i += kFusedThreads) {
        const int r = i / (kKT / per);
        const int k = k0 + per * (i % (kKT / per));
        const X* src = nullptr;
        float* dst;
        if (r < kChunk) {
          const long long off = row_off[r];
          if (off >= 0 && k < I) src = xq + off + k;
          dst = xs + r * kXS + k - k0;
        } else {
          const int rw = r - kChunk;  // rw = g * 8 + wi
          const int wi = rw & 7;
          if (wi < nu && k < I) {
            src = wq + static_cast<size_t>((rw >> 3) * H + unit0 + wi) * I +
                  k;
          }
          dst = ws + rw * kXS + k - k0;
        }
        if (quads) {
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (src != nullptr) {
            const uint2 bits = __ldg(reinterpret_cast<const uint2*>(src));
            v = make_float4(__uint_as_float(bits.x << 16),
                            __uint_as_float(bits.x & 0xffff0000u),
                            __uint_as_float(bits.y << 16),
                            __uint_as_float(bits.y & 0xffff0000u));
          }
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          *dst = src != nullptr ? resid::widen(*src) : 0.0f;
        }
      }
      return;
    }
    if (quads) {
      for (int i = tid; i < kChunk * (kKT / 4); i += kFusedThreads) {
        const int r = i / (kKT / 4);
        const int k = k0 + 4 * (i % (kKT / 4));
        const long long off = row_off[r];
        const bool ok = off >= 0 && k < I;
        step::copy16(xs + r * kXS + k - k0, ok ? q.x + off + k : q.x,
                          ok);
      }
      for (int i = tid; i < kGateRow * (kKT / 4); i += kFusedThreads) {
        const int r = i / (kKT / 4);  // r = g * 8 + wi
        const int k = k0 + 4 * (i % (kKT / 4));
        const int wi = r & 7;
        const bool ok = wi < nu && k < I;
        step::copy16(
            ws + r * kXS + k - k0,
            ok ? wih + static_cast<size_t>((r >> 3) * H + unit0 + wi) * I + k
               : wih,
            ok);
      }
    } else {
      for (int i = tid; i < kChunk * kKT; i += kFusedThreads) {
        const int r = i / kKT;
        const int k = k0 + i % kKT;
        const long long off = row_off[r];
        const bool ok = off >= 0 && k < I;
        step::copy4(xs + r * kXS + k - k0, ok ? q.x + off + k : q.x,
                         ok);
      }
      for (int i = tid; i < kGateRow * kKT; i += kFusedThreads) {
        const int r = i / kKT;
        const int k = k0 + i % kKT;
        const int wi = r & 7;
        const bool ok = wi < nu && k < I;
        step::copy4(
            ws + r * kXS + k - k0,
            ok ? wih + static_cast<size_t>((r >> 3) * H + unit0 + wi) * I + k
               : wih,
            ok);
      }
    }
    step::commit();
  };

  for (int m0 = 0; m0 < rows; m0 += kChunk) {
    __syncthreads();  // the region's last readers are done
    for (int r = tid; r < kChunk; r += kFusedThreads) {
      const int m = m0 + r;
      long long off = -1;
      if (m < rows) {
        const int s = s0 + m / B;
        const int t = dir == 0 ? s : T - 1 - s;
        off = (static_cast<long long>(t) * B + m % B) * I;
      }
      row_off[r] = off;
    }
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + mg + 32 * j;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kt_lo > 0 && m < rows) {
        v = *reinterpret_cast<const float4*>(
            gates + static_cast<size_t>(m) * kGateRow + rg * 4);
      }
      acc[j][0] = v.x;
      acc[j][1] = v.y;
      acc[j][2] = v.z;
      acc[j][3] = v.w;
    }
    stage(kt_lo);
    for (int kt = kt_lo; kt < kt_hi; ++kt) {
      if (kt + 1 < kt_hi) {
        stage(kt + 1);
        step::wait<1>();
      } else {
        step::wait<0>();
      }
      __syncthreads();  // tile kt is in place for every thread
      const float* xs = bufs + (kt & 1) * kBufFloats;
      const float* ws = xs + kChunk * kXS;
      // zero-padded tiles: the padding adds exact zeros
#pragma unroll 2
      for (int kk = 0; kk < kKT; kk += 4) {
        float4 wv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          wv[g] = *reinterpret_cast<const float4*>(ws + (g * 8 + rg) * kXS +
                                                   kk);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(
              xs + (mg + 32 * j) * kXS + kk);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[j][g] = fmaf(xv.x, wv[g].x, acc[j][g]);
            acc[j][g] = fmaf(xv.y, wv[g].y, acc[j][g]);
            acc[j][g] = fmaf(xv.z, wv[g].z, acc[j][g]);
            acc[j][g] = fmaf(xv.w, wv[g].w, acc[j][g]);
          }
        }
      }
      __syncthreads();  // every thread is done with tile kt
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + mg + 32 * j;
      if (m < rows) {
        *reinterpret_cast<float4*>(gates + static_cast<size_t>(m) * kGateRow +
                                   rg * 4) =
            make_float4(acc[j][0] + bias_r[0], acc[j][1] + bias_r[1],
                        acc[j][2] + bias_r[2], acc[j][3] + bias_r[3]);
      }
    }
  }
}

// The kernels with the projection inside (bilstm_fused_infer,
// bilstm_fused_fwd). R, W and X: the residuals', W_hh's and x's and
// W_ih's element types, as in bilstm_infer_kernel and project_slice. A block of kFusedThreads threads owns up to 8 units;
// warp wi owns unit unit0 + wi and holds its four gate rows of W_hh for
// k = 4 lane + kk + kKSpan q in registers. Shared memory: gates
// [2][fold][B][kGateRow], two fold buffers of gate inputs; a region that
// holds h_{t-1}'s tile [bt][Hp] (H padded to 4) or, between a block's
// arrival at the step barrier and its wait, the projection's K-tiles;
// c_s [units][B], the cell state. A cooperative grid of at most 128
// blocks uses one block an SM, so the bound lets the compiler take up to
// 255 registers.
// KQ: passes of kKSpan, ceil(H / kKSpan)
template <int KQ, bool kResid, typename R = float, typename W = float,
          typename X = float>
__global__ void __launch_bounds__(kFusedThreads, 1)
bilstm_fused_kernel(const Params p) {
  extern __shared__ __align__(16) float smem_fused[];
  const int T = p.T, B = p.B, H = p.H, F = p.proj.fold, bt = p.bt;
  const int Hp = (H + 3) & ~3;
  const size_t fold_floats = static_cast<size_t>(F) * B * kGateRow;
  float* gates = smem_fused;
  float* h_s = gates + 2 * fold_floats;
  float* c_s = h_s + p.region;

  const int dir = blockIdx.x / p.blocks_per_dir;
  const int blk = blockIdx.x % p.blocks_per_dir;
  const float* w = dir == 0 ? p.w_f : p.w_b;
  const float* wih = dir == 0 ? p.proj.wi_f : p.proj.wi_b;
  const float* bias = dir == 0 ? p.proj.b_f : p.proj.b_b;
  float* hout = dir == 0 ? p.h_f : p.h_b;
  float* gout = dir == 0 ? p.g_f : p.g_b;
  float* cout = dir == 0 ? p.c_f : p.c_b;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int unit0 = blk * p.units;
  const int nu = min(p.units, H - unit0);  // this block's units
  const int u = unit0 + warp;
  const bool active = warp < nu;
  const int n_kt = (p.proj.I + kKT - 1) / kKT;
  step::Barrier bar(p.barrier);

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
                                 w)[static_cast<size_t>(g * H + u) * H + k])
                           : 0.0f;
      }
    }
  }
  for (int i = tid; i < p.units * B; i += kFusedThreads) c_s[i] = 0.0f;

  // fold 0's gate inputs before the first step
  project_slice<X>(p.proj, wih, bias, gates, h_s, dir, 0, min(F, T) * B, T,
                   B, H, unit0, nu, 0, n_kt);

  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? s : T - 1 - s;
    const int tp = dir == 0 ? t - 1 : t + 1;  // previous step's time index
    const int fold = s / F;
    const int k_fold = s - fold * F;  // step within its fold
    const float* xg = gates + (fold & 1) * fold_floats +
                      static_cast<size_t>(k_fold) * B * kGateRow;
    if (s > 0) bar.wait();  // every block's h of step s - 1 is stored
    for (int b0 = 0; b0 < B; b0 += bt) {
      const int nb = min(bt, B - b0);
      __syncthreads();  // the region's last readers are done
      if (s > 0) {
        // h_{t-1}, written by every block in the step before: 16-byte
        // copies through L2, all in flight at once
        const float* src = hout + (static_cast<size_t>(tp) * B + b0) * H;
        if (Hp == H) {
          for (int i = tid; i < nb * H / 4; i += kFusedThreads) {
            step::copy16(h_s + 4 * i, src + 4 * i);
          }
        } else {
          for (int i = tid; i < nb * Hp; i += kFusedThreads) {
            const int r = i / Hp;
            const int k = i % Hp;
            step::copy4(h_s + i, k < H ? src + r * H + k : src, k < H);
          }
        }
        step::commit();
        step::wait<0>();
      } else {
        for (int i = tid; i < nb * Hp; i += kFusedThreads) h_s[i] = 0.0f;
      }
      __syncthreads();
      if (!active) continue;  // warp-uniform
      for (int r0 = 0; r0 < nb; r0 += kRound) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int q = 0; q < KQ; ++q) {
          const int k = kKSpan * q + 4 * lane;
          if (k < Hp) {
#pragma unroll
            for (int r = 0; r < kRound; ++r) {
              if (r0 + r < nb) {
                const float4 hv = resid::operand<W>(
                    *reinterpret_cast<const float4*>(h_s + (r0 + r) * Hp + k));
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
        // lane 4 r + g: gate g of round row r; lane 4 r gathers its row
        const float sum = step::reduce_scatter32(acc, lane);
        const int base = lane & ~3;
        const float gi = __shfl_sync(0xffffffffu, sum, base);
        const float gf = __shfl_sync(0xffffffffu, sum, base + 1);
        const float gg = __shfl_sync(0xffffffffu, sum, base + 2);
        const float go = __shfl_sync(0xffffffffu, sum, base + 3);
        const int bb = r0 + (lane >> 2);
        if ((lane & 3) == 0 && bb < nb) {
          const int b = b0 + bb;
          const float4 x = *reinterpret_cast<const float4*>(
              xg + static_cast<size_t>(b) * kGateRow + warp * 4);
          const float i_g = sigmoid_f(x.x + gi);
          const float f_g = sigmoid_f(x.y + gf);
          const float g_g = tanhf(x.z + gg);
          const float o_g = sigmoid_f(x.w + go);
          float* c = c_s + warp * B + b;
          const float c_new = f_g * *c + i_g * g_g;
          *c = c_new;
          const size_t row = static_cast<size_t>(t) * B + b;
          hout[row * H + u] = o_g * tanhf(c_new);
          if constexpr (kResid) {
            R* gr = reinterpret_cast<R*>(gout) + row * 4 * H;
            gr[u] = resid::narrow<R>(i_g);
            gr[H + u] = resid::narrow<R>(f_g);
            gr[2 * H + u] = resid::narrow<R>(g_g);
            gr[3 * H + u] = resid::narrow<R>(o_g);
            reinterpret_cast<R*>(cout)[row * H + u] = resid::narrow<R>(c_new);
          }
        }
      }
    }
    bar.arrive();
    // Before the wait: a slice of the next fold's projection into the
    // other buffer (its readers finished with the fold before this one).
    // The fold's steps share its K-tiles evenly, so the next fold is
    // complete once this fold's last step has run its slice.
    const int next = (fold + 1) * F;
    if (next < T) {
      const int steps = min(F, T - fold * F);
      project_slice<X>(p.proj, wih, bias,
                       gates + ((fold + 1) & 1) * fold_floats, h_s, dir, next,
                       min(F, T - next) * B, T, B, H, unit0, nu,
                       n_kt * k_fold / steps, n_kt * (k_fold + 1) / steps);
    }
  }
}

// Shared-memory plan of the fused kernels: two fold buffers, a region
// that holds the h tile or the projection's K-tiles, and the cell state.
// Of the folds up to kMaxFold whose buffers fit beside a whole-batch h
// tile it takes the one with the fewest projection rows a step (a pass
// covers kChunk rows, so a fold of F steps costs ceil(F B / kChunk)
// passes), the smaller on a tie; where even fold 1 does not leave room,
// fold 1 and a batch-tiled h. Returns false when one batch row of h does
// not fit.
bool plan_fused(Params& p, size_t* smem) {
  const size_t budget = kProjSmemBudget / sizeof(float);
  const size_t c_floats = static_cast<size_t>(p.units) * p.B;
  const size_t tiles = proj_tile_floats();
  const size_t hp = (p.H + 3) & ~3;
  auto total = [&](int fold, int bt, size_t* region) {
    const size_t h = static_cast<size_t>(bt) * hp;
    *region = ((h > tiles ? h : tiles) + 3) / 4 * 4;  // keeps c_s aligned
    return 2 * static_cast<size_t>(fold) * p.B * kGateRow + *region +
           c_floats;
  };
  size_t region = 0;
  int fold = 1;
  // a fold of f steps costs passes(f) / f passes a step; the folds are
  // compared by cross-multiplying
  auto passes = [&](int f) { return (f * p.B + kChunk - 1) / kChunk; };
  for (int f = 2; f <= (p.T < kMaxFold ? p.T : kMaxFold); ++f) {
    if (total(f, p.B, &region) > budget) break;
    if (passes(f) * fold < passes(fold) * f) fold = f;
  }
  int bt = p.B;
  if (total(fold, bt, &region) > budget) {
    const size_t fixed =
        2 * static_cast<size_t>(fold) * p.B * kGateRow + c_floats;
    if (fixed + tiles > budget) return false;
    bt = static_cast<int>((budget - fixed) / hp);
    if (bt > p.B) bt = p.B;
    if (bt < 1 || total(fold, bt, &region) > budget) return false;
  }
  const size_t floats = total(fold, bt, &region);
  p.proj.fold = fold;
  p.bt = bt;
  p.region = static_cast<int>(region);
  *smem = floats * sizeof(float);
  return true;
}

// The plan of the unfused kernels: `splits` warps a unit (0: the
// source's choice, kSplitMaxH), units = min(H, kMaxUnits / splits) a
// block; the batch tile the largest that fits the budget beside the cell
// state, then evened out over the tiles it takes. Refuses a batch whose
// cell state leaves no room for one row of each buffer. The plan does not
// depend on W and X: bfloat16 compute takes the float32 plan's batches.
template <int KQ, bool kResid, typename R, typename W, typename X>
cudaError_t launch_unfused(Unfused a, cudaStream_t stream) {
  if (a.splits == 0) {
    a.splits = a.H > kMaxUnits && a.H <= kSplitMaxH ? 2 : 1;
  }
  if (a.splits < 1 || kMaxUnits % a.splits) return cudaErrorInvalidValue;
  const int per_block = kMaxUnits / a.splits;
  a.units = a.H < per_block ? a.H : per_block;
  a.blocks_per_dir = (a.H + a.units - 1) / a.units;
  const int threads = a.units * a.splits * 32;
  // the cell state [units][B], then per batch row of a tile: two buffers
  // of h_{t-1} [Hp] and gate inputs [4][units], and with kResid h and c
  // [2][units]
  const size_t hp = (a.H + 3) & ~3;
  const size_t c_floats = static_cast<size_t>(a.units) * a.B;
  const size_t row_floats =
      2 * (hp + 4 * a.units) + (kResid ? 2 * a.units : 0);
  const size_t budget = kUnfusedSmemFloats;
  if (c_floats + row_floats > budget) {
    return cudaErrorInvalidValue;  // batch too large for the cell state
  }
  size_t bt = (budget - c_floats) / row_floats;
  if (bt > static_cast<size_t>(a.B)) bt = a.B;
  const size_t tiles = (a.B + bt - 1) / bt;
  a.bt = static_cast<int>((a.B + tiles - 1) / tiles);
  const size_t smem = (c_floats + a.bt * row_floats) * sizeof(float);
  void* args[] = {&a};
  return step::launch_cooperative(bilstm_infer_kernel<KQ, kResid, R, W, X>,
                                  2 * a.blocks_per_dir, threads, smem, args,
                                  stream);
}

// R: the residuals' element type (kResid); W and X: W_hh's and the gate
// inputs' (bfloat16 compute)
template <bool kResid, typename R = float, typename W = float,
          typename X = float>
int dispatch_unfused(Unfused a, int device, void* stream) {
  if (a.T < 1 || a.B < 1 || a.H < 1 || a.H > kMaxH) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const int kq = (a.H + kKSpan - 1) / kKSpan;
  if (a.H <= kNarrowMaxH) return launch_unfused<0, kResid, R, W, X>(a, s);
  if (kq <= 1) return launch_unfused<1, kResid, R, W, X>(a, s);
  if (kq <= 2) return launch_unfused<2, kResid, R, W, X>(a, s);
  return launch_unfused<4, kResid, R, W, X>(a, s);
}

Unfused unfused(const void* xp_f, const void* xp_b, const void* w_f,
                const void* w_b, void* h_f, void* h_b, void* barrier, int T,
                int B, int H, int splits) {
  Unfused a = {};
  a.xp[0] = static_cast<const float*>(xp_f);
  a.xp[1] = static_cast<const float*>(xp_b);
  a.w[0] = static_cast<const float*>(w_f);
  a.w[1] = static_cast<const float*>(w_b);
  a.h[0] = static_cast<float*>(h_f);
  a.h[1] = static_cast<float*>(h_b);
  a.barrier = static_cast<unsigned*>(barrier);
  a.T = T;
  a.B = B;
  a.H = H;
  a.splits = splits;
  return a;
}
// The plan does not depend on R, W and X: the K-tiles are float32 in
// shared memory at every compute dtype, so bfloat16 takes the float32
// plan's batches (kMaxFusedBatch).
template <int KQ, bool kResid, typename R, typename W, typename X>
cudaError_t launch_fused(Params p, cudaStream_t stream) {
  p.units = p.H < kMaxUnits ? p.H : kMaxUnits;
  p.blocks_per_dir = (p.H + p.units - 1) / p.units;
  size_t smem = 0;
  if (!plan_fused(p, &smem)) {
    return cudaErrorInvalidValue;  // batch too large for the fold buffers
  }
  void* args[] = {&p};
  return step::launch_cooperative(bilstm_fused_kernel<KQ, kResid, R, W, X>,
                            2 * p.blocks_per_dir, kFusedThreads, smem, args,
                            stream);
}

template <bool kResid, typename R = float, typename W = float,
          typename X = float>
int dispatch_fused(const Params& p, int device, void* stream) {
  if (p.T < 1 || p.B < 1 || p.H < 1 || p.H > kMaxH || p.proj.I < 1 ||
      p.B > kMaxFusedBatch) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const int kq = (p.H + kKSpan - 1) / kKSpan;
  if (kq <= 1) return launch_fused<1, kResid, R, W, X>(p, s);
  if (kq <= 2) return launch_fused<2, kResid, R, W, X>(p, s);
  return launch_fused<4, kResid, R, W, X>(p, s);
}

Params outputs(void* h_f, void* h_b, void* g_f, void* g_b, void* c_f,
               void* c_b, const void* w_f, const void* w_b, int T, int B,
               int H) {
  Params p = {};
  p.w_f = static_cast<const float*>(w_f);
  p.w_b = static_cast<const float*>(w_b);
  p.h_f = static_cast<float*>(h_f);
  p.h_b = static_cast<float*>(h_b);
  p.g_f = static_cast<float*>(g_f);
  p.g_b = static_cast<float*>(g_b);
  p.c_f = static_cast<float*>(c_f);
  p.c_b = static_cast<float*>(c_b);
  p.T = T;
  p.B = B;
  p.H = H;
  return p;
}

Params fused(const void* x, const void* wi_f, const void* wi_b,
             const void* b_f, const void* b_b, const void* w_f,
             const void* w_b, void* h_f, void* h_b, void* g_f, void* g_b,
             void* c_f, void* c_b, void* barrier, int T, int B, int H,
             int I) {
  Params p = outputs(h_f, h_b, g_f, g_b, c_f, c_b, w_f, w_b, T, B, H);
  p.barrier = static_cast<unsigned*>(barrier);
  p.proj.x = static_cast<const float*>(x);
  p.proj.wi_f = static_cast<const float*>(wi_f);
  p.proj.wi_b = static_cast<const float*>(wi_b);
  p.proj.b_f = static_cast<const float*>(b_f);
  p.proj.b_b = static_cast<const float*>(b_b);
  p.proj.I = I;
  return p;
}

}  // namespace

extern "C" {

// Lean forward. barrier: two 32-bit words (one a direction), zero at the
// launch; splits: warps a hidden unit, 0 for the source's plan. w_bf16:
// W_hh in bfloat16 (bfloat16 compute), and then xp_bf16: xp in bfloat16
// too; h is float32. Returns a cudaError_t (0 on success). Does not
// synchronise.
int bilstm_infer_launch(const void* xp_f, const void* xp_b, const void* w_f,
                        const void* w_b, void* h_f, void* h_b, void* barrier,
                        int T, int B, int H, int splits, int w_bf16,
                        int xp_bf16, int device, void* stream) {
  const Unfused a =
      unfused(xp_f, xp_b, w_f, w_b, h_f, h_b, barrier, T, B, H, splits);
  if (!w_bf16) {
    if (xp_bf16) return cudaErrorInvalidValue;
    return dispatch_unfused<false>(a, device, stream);
  }
  using resid::bf16;
  if (xp_bf16) {
    return dispatch_unfused<false, float, bf16, bf16>(a, device, stream);
  }
  return dispatch_unfused<false, float, bf16>(a, device, stream);
}

// Residual-saving forward: also writes g_f, g_b [T, B, 4H] and c_f, c_b
// [T, B, H], in float32, or with resid_bf16 in bfloat16. w_bf16: W_hh in
// bfloat16 (bfloat16 compute), and xp_bf16: xp in bfloat16; with bfloat16
// W the gate inputs follow the residuals (both float32 or both bfloat16,
// as pallas_lstm.stream_dtype), and other pairs return
// cudaErrorInvalidValue. Returns a cudaError_t (0 on success). Does not
// synchronise.
int bilstm_fwd_launch(const void* xp_f, const void* xp_b, const void* w_f,
                      const void* w_b, void* h_f, void* h_b, void* g_f,
                      void* g_b, void* c_f, void* c_b, void* barrier, int T,
                      int B, int H, int splits, int resid_bf16, int w_bf16,
                      int xp_bf16, int device, void* stream) {
  Unfused a =
      unfused(xp_f, xp_b, w_f, w_b, h_f, h_b, barrier, T, B, H, splits);
  a.g[0] = static_cast<float*>(g_f);
  a.g[1] = static_cast<float*>(g_b);
  a.c[0] = static_cast<float*>(c_f);
  a.c[1] = static_cast<float*>(c_b);
  using resid::bf16;
  if (w_bf16) {
    if (xp_bf16 != resid_bf16) return cudaErrorInvalidValue;
    if (resid_bf16) {
      return dispatch_unfused<true, bf16, bf16, bf16>(a, device, stream);
    }
    return dispatch_unfused<true, float, bf16>(a, device, stream);
  }
  if (xp_bf16) return cudaErrorInvalidValue;
  if (resid_bf16) {
    return dispatch_unfused<true, bf16>(a, device, stream);
  }
  return dispatch_unfused<true>(a, device, stream);
}


// Lean forward with the input projection in the kernel: x [T, B, I],
// wi_f, wi_b [4H, I], b_f, b_b [4H] (float32); barrier: one 32-bit word,
// zero at the launch. compute_bf16: bfloat16 compute, x, W_ih and W_hh
// all in bfloat16 (JAX casts all three to W_hh's dtype); h is float32.
// Returns a cudaError_t (0 on success). Does not synchronise.
int bilstm_fused_infer_launch(const void* x, const void* wi_f,
                              const void* wi_b, const void* b_f,
                              const void* b_b, const void* w_f,
                              const void* w_b, void* h_f, void* h_b,
                              void* barrier, int T, int B, int H, int I,
                              int compute_bf16, int device, void* stream) {
  const Params p = fused(x, wi_f, wi_b, b_f, b_b, w_f, w_b, h_f, h_b,
                         nullptr, nullptr, nullptr, nullptr, barrier, T, B,
                         H, I);
  using resid::bf16;
  if (compute_bf16) {
    return dispatch_fused<false, float, bf16, bf16>(p, device, stream);
  }
  return dispatch_fused<false>(p, device, stream);
}

// Residual-saving forward with the input projection in the kernel: g_f,
// g_b [T, B, 4H] and c_f, c_b [T, B, H] in float32, or with resid_bf16 in
// bfloat16; compute_bf16 as above. Returns a cudaError_t (0 on success).
// Does not synchronise.
int bilstm_fused_fwd_launch(const void* x, const void* wi_f,
                            const void* wi_b, const void* b_f,
                            const void* b_b, const void* w_f,
                            const void* w_b, void* h_f, void* h_b, void* g_f,
                            void* g_b, void* c_f, void* c_b, void* barrier,
                            int T, int B, int H, int I, int resid_bf16,
                            int compute_bf16, int device, void* stream) {
  const Params p = fused(x, wi_f, wi_b, b_f, b_b, w_f, w_b, h_f, h_b, g_f,
                         g_b, c_f, c_b, barrier, T, B, H, I);
  using resid::bf16;
  if (compute_bf16 && resid_bf16) {
    return dispatch_fused<true, bf16, bf16, bf16>(p, device, stream);
  }
  if (compute_bf16) {
    return dispatch_fused<true, float, bf16, bf16>(p, device, stream);
  }
  if (resid_bf16) return dispatch_fused<true, bf16>(p, device, stream);
  return dispatch_fused<true>(p, device, stream);
}

const char* bilstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef BILSTM_INFER_PROBE
// Cycles and laps of each phase of the unfused kernels since the last
// reset, summed over warps.
int bilstm_infer_probe_read(unsigned long long* cycles,
                            unsigned long long* laps, int reset) {
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
