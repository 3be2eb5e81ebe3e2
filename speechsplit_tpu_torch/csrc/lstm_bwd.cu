// One direction of one LSTM layer, gradient recurrence, at float32 and at
// the bfloat16 dtype sets of the JAX single route.
//
// Replaces: speechsplit_tpu/ops/pallas_lstm.py::_bwd_kernel (wrapper
// _bwd_call), the TPU kernel that runs the gate-gradient recurrence of
// lstm_sequence. Same math as pallas_lstm._cell_bwd, step for step:
//   dh  = dh_out[t] + dh_carry           tanh_c = tanh(c[t])
//   do  = dh tanh_c                      dc = dc_carry + dh o (1 - tanh_c^2)
//   d_pre = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), do o(1-o)]
//   dh_carry' = d_pre W_hh               dc_carry' = dc f
// with both carries float32 from zero. The gradient walks the opposite of
// the forward's order: a forward direction's T-1 -> 0, its c_prev c[t-1]
// and zero at t = 0; a reverse direction's (reverse != 0) 0 -> T-1, its
// c_prev c[t+1] and zero at t = T-1 (the TPU kernel's `edge` index map).
// The arrays stay in real time order.
//
// Layouts: dh [T, B, H] (cotangent of h); g [T, B, 4H] (post-activation
// gates i, f, g, o from the residual-saving forward, csrc/lstm_infer.cu);
// c [T, B, H]; w [4H, H] (torch's weight_hh_l{k}); out dx [T, B, 4H] =
// d_pre, the cotangent of the projected input. dW_hh is one GEMM outside
// (ops/lstm.py), as in the JAX package.
//
// Element types (template arguments R, W of both plans): dh, g, c and dx
// float, or all bfloat16 as _bwd_call runs under the JAX default
// residual_dtype (dh rounded at the VJP's boundary, _dh_stream_dtype;
// dxp stored rounded, _grad_stream_dtype; pallas_lstm.py:432): read
// widened, the dh, dc and d_pre carries float32. W_hh float or bfloat16
// (bfloat16 compute): widened into the registers that hold it, and the
// product reads d_pre rounded to bfloat16 (:437). The narrow plan carries
// d_pre in registers; the wide plan, whose product stages the previous
// step's d_pre from memory, keeps it in a float32 scratch of two steps
// beside the rounded dx. The float32 instances keep their machine code;
// the plans and kMaxBatch are the same at every type.
//
// What bounds it on an H100: the recurrence, as in the merged kernel
// (csrc/bilstm_bwd.cu). Step s needs all of the previous step's d_pre,
// because dh_carry of unit k sums over all 4H gate rows (column k of
// W_hh). The arithmetic (2*B*4H*H a step) and the HBM bytes (the
// residuals are read once) are small at small batches; the time goes to
// latency.
//
// What the design does about it: two plans, chosen by width, one launch
// a call either way.
// - Narrow (H <= lane_bwd::kLaneMaxH = 32): the multi-stream gradient's
//   lane step (csrc/lane_bwd.cuh) for one direction. A row takes L lanes,
//   one unit a lane, W_hh's column of the lane in registers, the dc carry
//   in a register; the whole recurrence of a row lives in one warp, so
//   there is no barrier at all.
// - Wide (H > 32): the merged gradient's step (csrc/bilstm_bwd.cu, on
//   csrc/merged_step.cuh) for one direction, in one persistent
//   cooperative launch. A block owns UN consecutive hidden units (1 up
//   to H = 128, 2 up to 256, 4 above: 128 blocks at H = 256 and 512)
//   and keeps W_hh's columns of them in registers. Each step it stages
//   the previous step's d_pre with 16-byte cp.async copies through L2;
//   the product is blocked over its units (a thread holds W_hh[j][u] for
//   its 4 or 8 rows j and every unit, so one 16-byte shared load feeds
//   4 x UN FMAs) and ends in one butterfly per 32 sums
//   (merged_step.cuh) and a sum of the 8 warps' partials; the residuals
//   of the next step are prefetched by cp.async into a second buffer
//   while the step computes; one thread a (row, unit) applies the cell
//   gradient, so each gate of a row is stored as one run; the grid
//   barrier is split, the next step's prefetch issued between arrive and
//   wait. The dc carry [UN][B] sits in shared memory beside one row
//   of the d_pre tile and the staged values, within the 227 KB a block
//   may opt into: that sets kMaxBatch. The host side checks occupancy
//   before the cooperative launch and fails rather than deadlock when
//   the grid cannot be co-resident.
//
// Built with -DLSTM_BWD_PROBE (chip_smoke.py's probe build), each plan
// also adds up clock64() laps of the phases of a step per warp, which
// lstm_bwd_probe_read returns: 0 the barrier wait (wide plan only), 1
// the wait for the residuals and the d_pre tile, 2 the product, 3 the
// cell gradient and the stores, 4 the prefetch and the arrival.

#include <cuda_runtime.h>

#ifdef LSTM_BWD_PROBE
#define LANE_BWD_PROBE
#endif
#include "lane_bwd.cuh"
#include "merged_step.cuh"
#include "resid.cuh"

namespace {

constexpr int kMaxH = 512;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kJSpan = 4 * kThreads;  // rows j of W_hh one pass covers
constexpr int kRes = 7;  // residuals per (unit, row): i f g o c c_prev dh
// Shared-memory floats a (unit, row) takes beside the row's d_pre: the 8
// warps' partial sums and two buffers of the kRes residuals.
constexpr int kVals = kWarps + 2 * kRes;
// the most a block may opt into on an H100
constexpr size_t kSmemBudget = 227 * 1024;

// The wide plan's units a block at width H.
constexpr int plan_units(int H) { return H <= 128 ? 1 : H <= 256 ? 2 : 4; }

// Shared memory of a wide block: the dc carry [units][B], then per batch
// row of a tile the previous d_pre [4H] and the staged values
// [kVals][units].
constexpr size_t carry_bytes(int units, int B) {
  return static_cast<size_t>(units) * B * sizeof(float);
}
constexpr size_t row_bytes(int units, int H) {
  return static_cast<size_t>(4 * H + kVals * units) * sizeof(float);
}

// The largest batch the kernel takes, at every H <= kMaxH (the narrow
// plan has no limit of its own). ops/lstm.py reads the value from this
// line.
constexpr int kMaxBatch = 13994;
static_assert(carry_bytes(plan_units(kMaxH), kMaxBatch) +
                      row_bytes(plan_units(kMaxH), kMaxH) <= kSmemBudget &&
                  carry_bytes(plan_units(kMaxH), kMaxBatch + 1) +
                          row_bytes(plan_units(kMaxH), kMaxH) > kSmemBudget,
              "kMaxBatch must be the largest batch the plan holds at kMaxH");

#ifdef LSTM_BWD_PROBE
constexpr int kPhases = 5;
__device__ unsigned long long g_probe_cycles[kPhases];
__device__ unsigned long long g_probe_laps[kPhases];
__device__ float g_probe_sink;
static_assert(lane_bwd::kPhases == kPhases - 1,
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

// R: the element type of dh, g, c and dx; W: W_hh's (lane_bwd.cuh)
template <int L, typename R = float, typename W = float>
__global__ void __launch_bounds__(lane_bwd::kThreads)
lstm_bwd_narrow_kernel(lane_bwd::Dir d, int T, int B, int reverse) {
  extern __shared__ float4 lane_smem[];
  lane_bwd::Probe probe;
  // dh and dx follow the residuals; W_hh is W's type throughout
  lane_bwd::steps<L, R, W, R>(d, blockIdx.x, reverse != 0, T, B, lane_smem,
                              probe, !std::is_same<W, float>::value);
#ifdef LSTM_BWD_PROBE
  // the lane step's phases 0 .. 3 are this file's 1 .. 4
  probe.flush(g_probe_cycles + 1, g_probe_laps + 1, &g_probe_sink);
#endif
}

struct Args {
  const float* dh;
  const float* g;
  const float* c;
  const float* w;
  float* dx;
  unsigned* barrier;  // zeroed before the launch
  int T, B, H, reverse, bt;
  // the wide plan at bfloat16 residuals only: [2 step parities][B][4H],
  // the float32 d_pre of the last two steps
  float* carry;
};

// Shared memory: d_s [bt][4H] the previous step's d_pre tile; res_s
// [2][kRes][bt][UN] two buffers of residuals (in R, the bfloat16 ones in
// the first half of the float plan); red_s [bt][kWarps][UN] the warps'
// partial sums; dc_s [UN][B] the dc carry.
// KQ: passes of kJSpan rows j; UN: units a block. R: the element type of
// dh, g, c and dx, float or bfloat16 (pallas_lstm._bwd_kernel under the
// JAX default residual_dtype: dh and the residuals widened where they
// are read, dx d_pre rounded as it is stored); with bfloat16 the d_pre
// that the next step's product reads is the float32 one of a.carry (by
// step parity: a step's readers pass the grid barrier before any block
// writes that parity again), so the carry is never rounded. W: W_hh's
// element type, widened into the registers that hold it; beside a
// bfloat16 one the product reads d_pre rounded to bfloat16 (_cell_bwd's
// d_pre.astype(w.dtype)). The plan and kMaxBatch do not depend on them.
template <int KQ, int UN, typename R = float, typename W = float>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_wide_kernel(const Args a) {
  constexpr int kRows = 32 / UN;  // batch rows a reduction round
  static_assert(kRows * UN == 32, "a round reduces 32 sums a warp");
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, B = a.B, H = a.H, G = 4 * H, bt = a.bt;
  float* d_s = smem;
  float* res_s = d_s + static_cast<size_t>(bt) * G;
  float* red_s = res_s + 2 * kRes * bt * UN;
  float* dc_s = red_s + bt * kWarps * UN;

  constexpr bool kF32 = std::is_same<R, float>::value;
  const R* dho = reinterpret_cast<const R*>(a.dh);
  const R* gin = reinterpret_cast<const R*>(a.g);
  const R* cin = reinterpret_cast<const R*>(a.c);
  R* dx = reinterpret_cast<R*>(a.dx);
  const bool reverse = a.reverse != 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int u0 = blockIdx.x * UN;
  const int nu = min(UN, H - u0);  // this block's units
  // residual rows go in 16-byte copies where every run is whole quads
  const bool quads = (H & 3) == 0 && (UN & 3) == 0;
  step::Barrier bar(a.barrier);

  // W_hh[j][u0 + u] for j = 4 tid + jj + kJSpan q
  float wr[KQ][4][UN];
#pragma unroll
  for (int q = 0; q < KQ; ++q) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = kJSpan * q + 4 * tid + jj;
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        wr[q][jj][u] = (j < G && u < nu)
                           ? resid::widen(reinterpret_cast<const W*>(
                                 a.w)[static_cast<size_t>(j) * H + u0 + u])
                           : 0.0f;
      }
    }
  }
  for (int i = tid; i < UN * B; i += kThreads) dc_s[i] = 0.0f;

  // issue the copies of step s's residuals for rows b0 .. b0 + nb - 1
  // into buffer buf
  auto prefetch = [&](int s, int b0, int buf) {
    const int t = reverse ? s : T - 1 - s;
    const int tc = reverse ? t + 1 : t - 1;  // c_prev's time index
    const bool has_cp = tc >= 0 && tc < T;
    const int nb = min(bt, B - b0);
    R* dst0 = reinterpret_cast<R*>(res_s) + buf * kRes * bt * UN;
    auto src_of = [&](int k, int b, int u) -> const R* {
      const size_t row = static_cast<size_t>(t) * B + b;
      if (k < 4) return gin + row * G + k * H + u0 + u;
      if (k == 4) return cin + row * H + u0 + u;
      if (k == 5) {
        return has_cp ? cin + (static_cast<size_t>(tc) * B + b) * H + u0 + u
                      : cin;
      }
      return dho + row * H + u0 + u;
    };
    if constexpr (!kF32) {
      // bfloat16 residuals: loaded one by one (a run of the block's units
      // is at most 8 bytes, and cp.async cannot take 2)
      for (int i = tid; i < kRes * nb * UN; i += kThreads) {
        const int k = i / (nb * UN);
        const int bb = (i / UN) % nb;
        const int u = i % UN;
        const bool ok = u < nu && (k != 5 || has_cp);
        dst0[(k * bt + bb) * UN + u] =
            ok ? __ldg(src_of(k, b0 + bb, u)) : resid::narrow<R>(0.0f);
      }
    } else if (quads) {
      constexpr int nq = UN >= 4 ? UN / 4 : 1;  // quads only at UN = 4
      for (int i = tid; i < kRes * nb * nq; i += kThreads) {
        const int k = i / (nb * nq);
        const int bb = (i / nq) % nb;
        const int u = 4 * (i % nq);
        const bool ok = u < nu && (k != 5 || has_cp);
        step::copy16(dst0 + (k * bt + bb) * UN + u,
                     ok ? src_of(k, b0 + bb, u) : cin, ok);
      }
    } else {
      for (int i = tid; i < kRes * nb * UN; i += kThreads) {
        const int k = i / (nb * UN);
        const int bb = (i / UN) % nb;
        const int u = i % UN;
        const bool ok = u < nu && (k != 5 || has_cp);
        step::copy4(dst0 + (k * bt + bb) * UN + u,
                    ok ? src_of(k, b0 + bb, u) : cin, ok);
      }
    }
    step::commit();
  };

#ifdef LSTM_BWD_PROBE
  long long probe_cycles[kPhases] = {};
  long long probe_laps[kPhases] = {};
  long long lap_ = clock64();
#endif
  const int tiles = (B + bt - 1) / bt;
  int buf = 0;
  prefetch(0, 0, 0);
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const int tp = reverse ? t - 1 : t + 1;  // previous step's time index
    if (s > 0) bar.wait();
    PROBE_LAP(0);
    for (int tile = 0; tile < tiles; ++tile) {
      const int b0 = tile * bt;
      const int nb = min(bt, B - b0);
      if (s > 0) {
        // the previous step's d_pre rows, written by every block: all
        // copies in flight at once
        const float* src;
        if constexpr (kF32) {
          src = a.dx + (static_cast<size_t>(tp) * B + b0) * G;
        } else {
          src = a.carry + (static_cast<size_t>((s - 1) & 1) * B + b0) * G;
        }
        for (int i = tid; i < nb * G / 4; i += kThreads) {
          step::copy16(d_s + 4 * i, src + 4 * i);
        }
        step::commit();
      }
      step::wait<0>();  // the d_pre tile and this tile's residuals
      __syncthreads();
      PROBE_LAP(1);
      if (s > 0) {
        for (int r0 = 0; r0 < nb; r0 += kRows) {
          float acc[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
          for (int q = 0; q < KQ; ++q) {
            const int j = kJSpan * q + 4 * tid;
            if (j < G) {
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                if (r0 + r < nb) {
                  const float4 d = resid::operand<W>(
                      *reinterpret_cast<const float4*>(d_s + (r0 + r) * G +
                                                       j));
#pragma unroll
                  for (int u = 0; u < UN; ++u) {
                    const int x = r * UN + u;
                    acc[x] = fmaf(d.x, wr[q][0][u], acc[x]);
                    acc[x] = fmaf(d.y, wr[q][1][u], acc[x]);
                    acc[x] = fmaf(d.z, wr[q][2][u], acc[x]);
                    acc[x] = fmaf(d.w, wr[q][3][u], acc[x]);
                  }
                }
              }
            }
          }
          const float sum = step::reduce_scatter32(acc, lane);
          const int r = r0 + lane / UN;
          const int u = lane % UN;
          if (r < nb) red_s[(r * kWarps + warp) * UN + u] = sum;
        }
        __syncthreads();  // every warp's partial sums are in red_s
      }
      PROBE_LAP(2);
      const R* res = reinterpret_cast<const R*>(res_s) + buf * kRes * bt * UN;
      for (int i = tid; i < nb * UN; i += kThreads) {
        const int bb = i / UN;
        const int u = i % UN;
        if (u >= nu) continue;
        float dh_carry = 0.0f;
        if (s > 0) {
#pragma unroll
          for (int wp = 0; wp < kWarps; ++wp) {
            dh_carry += red_s[(bb * kWarps + wp) * UN + u];
          }
        }
        const int off = bb * UN + u;
        const int plane = bt * UN;
        const float i_g = resid::widen(res[off]);
        const float f_g = resid::widen(res[plane + off]);
        const float g_g = resid::widen(res[2 * plane + off]);
        const float o_g = resid::widen(res[3 * plane + off]);
        const float tanh_c = tanhf(resid::widen(res[4 * plane + off]));
        const float c_prev = resid::widen(res[5 * plane + off]);
        const float dh = resid::widen(res[6 * plane + off]) + dh_carry;
        const float d_o = dh * tanh_c;
        const int b = b0 + bb;
        float* dcp = dc_s + u * B + b;
        const float dc = *dcp + dh * o_g * (1.0f - tanh_c * tanh_c);
        if constexpr (kF32) {
          float* out = dx + (static_cast<size_t>(t) * B + b) * G + u0 + u;
          out[0] = dc * g_g * i_g * (1.0f - i_g);
          out[H] = dc * c_prev * f_g * (1.0f - f_g);
          out[2 * H] = dc * i_g * (1.0f - g_g * g_g);
          out[3 * H] = d_o * o_g * (1.0f - o_g);
        } else {
          // the float32 d_pre for the next step's product, dx rounded
          const float dp[4] = {dc * g_g * i_g * (1.0f - i_g),
                               dc * c_prev * f_g * (1.0f - f_g),
                               dc * i_g * (1.0f - g_g * g_g),
                               d_o * o_g * (1.0f - o_g)};
          float* keep = a.carry + (static_cast<size_t>(s & 1) * B + b) * G +
                        u0 + u;
          R* out = dx + (static_cast<size_t>(t) * B + b) * G + u0 + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            keep[q * H] = dp[q];
            out[q * H] = resid::narrow<R>(dp[q]);
          }
        }
        *dcp = dc * f_g;
      }
      PROBE_LAP(3);
      // the next (step, tile)'s residuals into the other buffer, whose
      // last readers passed this tile's __syncthreads above; d_s's
      // readers passed the one after the partial sums, and red_s is
      // written again only after the next tile's first __syncthreads
      buf ^= 1;
      if (tile + 1 < tiles) {
        prefetch(s, b0 + bt, buf);
      } else if (s + 1 < T) {
        prefetch(s + 1, 0, buf);
      }
    }
    bar.arrive();
    PROBE_LAP(4);
  }
#ifdef LSTM_BWD_PROBE
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

template <int L, typename R, typename W>
cudaError_t launch_narrow(const Args& a, cudaStream_t stream) {
  const lane_bwd::Dir d{a.dh, a.g, a.c, a.w, a.dx, a.H};
  const int rows = lane_bwd::kThreads / L;  // rows a block
  const size_t smem = sizeof(float4) * lane_bwd::smem_float4s(L);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_narrow_kernel<L, R, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_bwd_narrow_kernel<L, R, W><<<(a.B + rows - 1) / rows,
                                    lane_bwd::kThreads, smem, stream>>>(
      d, a.T, a.B, a.reverse);
  return cudaGetLastError();
}

template <int KQ, int UN, typename R, typename W>
cudaError_t launch_wide(Args a, cudaStream_t stream) {
  if (!std::is_same<R, float>::value && a.carry == nullptr) {
    return cudaErrorInvalidValue;  // bfloat16 residuals need the carry
  }
  const size_t c_b = carry_bytes(UN, a.B);
  const size_t r_b = row_bytes(UN, a.H);
  if (c_b + r_b > kSmemBudget) {
    return cudaErrorInvalidValue;  // batch too large for the dc carry
  }
  const int bt = static_cast<int>((kSmemBudget - c_b) / r_b);
  a.bt = bt > a.B ? a.B : bt;
  const size_t smem = c_b + static_cast<size_t>(a.bt) * r_b;
  void* args[] = {&a};
  return step::launch_cooperative(lstm_bwd_wide_kernel<KQ, UN, R, W>,
                                  (a.H + UN - 1) / UN, kThreads, smem, args,
                                  stream);
}

// The gradient at the residuals' (dh's, dx's) and W_hh's element types.
template <typename R, typename W>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  const int H = a.H;
  if (H <= 1) return launch_narrow<1, R, W>(a, s);
  if (H <= 2) return launch_narrow<2, R, W>(a, s);
  if (H <= 4) return launch_narrow<4, R, W>(a, s);
  if (H <= 8) return launch_narrow<8, R, W>(a, s);
  if (H <= 16) return launch_narrow<16, R, W>(a, s);
  if (H <= lane_bwd::kLaneMaxH) return launch_narrow<32, R, W>(a, s);
  switch (plan_units(H)) {
    case 1: return launch_wide<1, 1, R, W>(a, s);
    case 2: return launch_wide<1, 2, R, W>(a, s);
    default: return launch_wide<2, 4, R, W>(a, s);
  }
}

// a pass of kJSpan rows j covers 4H up to H = 256 (1 and 2 units a
// block), two passes above
static_assert(4 * 256 <= kJSpan && 4 * kMaxH <= 2 * kJSpan,
              "the wide plan's passes");

}  // namespace

extern "C" {

// The gradient recurrence of one direction; reverse != 0 for a direction
// whose forward walked T-1 -> 0. barrier: one 32-bit word, zero at the
// launch (the wide plan's grid barrier). dh, g, c and dx are float32, or
// with resid_bf16 bfloat16, and then the wide plan (H > 32) takes carry,
// a float32 scratch of 2 x B x 4H (unused otherwise). w_bf16: W_hh in
// bfloat16 (bfloat16 compute). Returns a cudaError_t (0 on success).
// Does not synchronise.
int lstm_bwd_launch(const void* dh, const void* g, const void* c,
                    const void* w, void* dx, void* barrier, void* carry,
                    int T, int B, int H, int reverse, int resid_bf16,
                    int w_bf16, int device, void* stream) {
  if (T < 1 || B < 1 || B > kMaxBatch || H < 1 || H > kMaxH) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a = {};
  a.dh = static_cast<const float*>(dh);
  a.g = static_cast<const float*>(g);
  a.c = static_cast<const float*>(c);
  a.w = static_cast<const float*>(w);
  a.dx = static_cast<float*>(dx);
  a.barrier = static_cast<unsigned*>(barrier);
  a.carry = static_cast<float*>(carry);
  a.T = T;
  a.B = B;
  a.H = H;
  a.reverse = reverse ? 1 : 0;
  auto s = static_cast<cudaStream_t>(stream);
  using resid::bf16;
  if (w_bf16) {
    if (resid_bf16) return dispatch<bf16, bf16>(a, s);
    return dispatch<float, bf16>(a, s);
  }
  if (resid_bf16) return dispatch<bf16, float>(a, s);
  return dispatch<float, float>(a, s);
}

const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef LSTM_BWD_PROBE
// Cycles and laps of each phase since the last reset, summed over warps.
int lstm_bwd_probe_read(unsigned long long* cycles, unsigned long long* laps,
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
