// Merged bidirectional LSTM layer, gradient recurrence, float32 or on
// bfloat16 residuals, with a float32 or (bfloat16 compute) a bfloat16
// W_hh.
//
// Replaces: speechsplit_tpu/ops/pallas_lstm.py::_bd_bwd_kernel (wrapper
// _bd_bwd_call), the TPU kernel that runs the gate-gradient recurrence of
// both directions of one BiLSTM layer in one grid. Same math as
// pallas_lstm._cell_bwd, step for step:
//   dh  = dh_out[t] + dh_carry           tanh_c = tanh(c[t])
//   do  = dh tanh_c                      dc = dc_carry + dh o (1 - tanh_c^2)
//   d_pre = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), do o(1-o)]
//   dh_carry' = d_pre W_hh               dc_carry' = dc f
// with both carries float32 from zero. The forward direction's gradient
// walks T-1 -> 0 (its c_prev is c[t-1], zero at t = 0); the backward
// direction's walks 0 -> T-1 (c_prev = c[t+1], zero at t = T-1). The input
// arrays stay in real time order.
//
// Layouts: dh_f, dh_b [T, B, H] (cotangents of h); g_f, g_b [T, B, 4H]
// (post-activation gates i, f, g, o from the residual-saving forward);
// c_f, c_b [T, B, H]; w_f, w_b [4H, H] (torch's weight_hh_l{k}); out
// dx_f, dx_b [T, B, 4H] = d_pre, the cotangent of the projected inputs.
// dW_hh is one GEMM outside (ops/bilstm.py), as in the JAX package.
// dh, g, c and dx are float32, or all bfloat16 as _bd_bwd_call runs under
// the JAX default residual_dtype: the residuals and dh are widened where
// they are read (pallas_lstm.py:806-810), the dh, dc and d_pre carries
// stay float32 (:826), and dx is d_pre rounded as it is stored (:870).
// The next step's product must read d_pre unrounded, so the bfloat16
// kernel keeps it in a float32 scratch of two steps a direction (by step
// parity: a step's readers pass the grid barrier before any block writes
// that parity again) and stages it from there, where the float32 kernel
// stages it from dx itself. bfloat16 residuals go into shared memory 8
// to a 16-byte copy in the plan of the float32 ones (half of it unused),
// so both take the same batch. With a bfloat16 W_hh (the JAX package's
// compute_dtype="bfloat16", at either residual dtype) W is widened into
// the registers that hold it and the product reads d_pre rounded to
// bfloat16 (_cell_bwd's d_pre.astype(w.dtype), pallas_lstm.py:825-828):
// the staged d_pre, the carries and dx are as above, and only the
// product's operand is rounded, where it is read. The plan and the batch
// limit do not depend on W's type.
//
// What bounds it on an H100: the recurrence, as in the forward. Step s
// needs all of the previous step's d_pre, because dh_carry of unit k sums
// over all 4H gate rows (column k of W_hh). At H = 512 W_hh is 4 MiB a
// direction, so the steps need a barrier across blocks, and every block
// reads the whole previous d_pre (B x 4H, 128 KiB at B = 16) each step.
// The arithmetic (2*B*4H*H a step) and the HBM bytes (the residuals are
// read once) are small; the time goes to latency: the barrier, the
// staging of d_pre, and the instructions of a step on 8 warps an SM.
//
// What the design does about it. One persistent cooperative launch per
// layer, blocks split between the two directions, each block owning up
// to 8 consecutive hidden units (W_hh's columns of them stay in
// registers for the whole sequence). The probe build below splits a
// step into its phases (PERF.md); against what they showed:
// - d_pre is staged with 16-byte cp.async copies through L2, all in
//   flight at once, no register on the way.
// - The product is blocked over the block's units: a thread holds
//   W_hh[j][u] for its 4 or 8 rows j (4 consecutive, 1024 apart) and all
//   8 units, so one 16-byte shared load feeds 32 FMAs. A warp's partial
//   sums of 4 batch rows x 8 units are reduced by a butterfly that leaves
//   each lane one (row, unit) sum (merged_step.cuh), and the 8 warps'
//   partials are added in shared memory.
// - The residuals a step needs (i, f, g, o, c, c_prev, dh_out of the
//   block's units) do not depend on the recurrence: they are prefetched
//   with cp.async into a second buffer during the step before, so only
//   d_pre stays on the critical path.
// - One thread a (row, unit) applies the cell gradient, the dc carry in
//   shared memory; a block's units are consecutive, so each gate of a row
//   is stored as one run of 32 bytes.
// - The grid barrier is split (merged_step.cuh): a block arrives after
//   its stores, with the next step's prefetch already in flight.
// - Clusters could share the staging of d_pre between blocks, but a
//   cooperative grid of 128 such blocks fits the card only in clusters
//   of 2 (PERF.md), so the grid has none.
// The launch is cooperative: it fails rather than deadlock when the grid
// cannot be co-resident.
//
// Built with -DBILSTM_BWD_PROBE (chip_smoke.py's probe build), the kernel
// also adds up clock64() laps of each phase of a step per warp, which
// bilstm_bwd_probe_read returns.

#include <cuda_runtime.h>

#include "merged_step.cuh"
#include "resid.cuh"

namespace {

constexpr int kMaxUnits = 8;   // hidden units per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;       // batch rows per reduction round
constexpr int kRes = 7;        // residuals per (unit, row): i f g o c c_prev dh
constexpr int kJSpan = 4 * kThreads;  // rows j of W_hh one pass covers
constexpr int kMaxH = 512;
static_assert(kRows * kMaxUnits == 32, "a round reduces 32 sums a warp");
// Shared-memory floats a (unit, row) takes beside the row's d_pre: the 8
// warps' partial sums and two buffers of the kRes residuals.
constexpr int kVals = 22;
static_assert(kVals == kWarps + 2 * kRes, "kVals must match the layout");
constexpr size_t kSmemBudget = 160 * 1024;
// The kernel takes B rows at width H while the dc carry [units][B] and
// one batch row of the d_pre tile and the staged values, 4H + kVals *
// units floats, fit these floats, with units = min(H, kMaxUnits)
// (launch() below). ops/bilstm.py reads the value from this line
// (merged_bidir_fits), so the kernel is the one owner of the limit.
constexpr int kBwdSmemFloats = 40960;
static_assert(kBwdSmemFloats * sizeof(float) == kSmemBudget,
              "kBwdSmemFloats must be the launch's budget");

#ifdef BILSTM_BWD_PROBE
// phases: 0 barrier wait, 1 d_pre staging, 2 FMAs and reduction, 3 cell
// gradient and stores, 4 prefetch and arrival
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

struct Args {
  const float* dh[2];
  const float* g[2];
  const float* c[2];
  const float* w[2];
  float* dx[2];
  unsigned* barrier;  // zeroed before the launch
  int T, B, H, blocks_per_dir, units, bt;
  // bfloat16 residuals only: [2 directions][2 step parities][B][4H], the
  // float32 d_pre of the last two steps
  float* carry;
};

// Shared memory: d_s [bt][4H] the previous step's d_pre tile; res_s
// [2][kRes][bt][units] two buffers of residuals (in R, the bfloat16 ones
// in the first half of the float plan); red_s [bt][kWarps][units] the
// warps' partial sums; dc_s [units][B] the dc carry.
// KQ: passes of kJSpan rows j, ceil(4H / kJSpan). R: the element type of
// dh, g, c and dx, float or bfloat16; with bfloat16 the d_pre that the
// next step's product reads is the float32 one of a.carry, and dx holds
// it rounded. W: W_hh's element type, float or bfloat16; with bfloat16
// the product reads d_pre rounded to bfloat16.
template <int KQ, typename R = float, typename W = float>
__global__ void __launch_bounds__(kThreads, 1)
bilstm_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, B = a.B, H = a.H, G = 4 * H;
  const int units = a.units, bt = a.bt;
  float* d_s = smem;
  float* res_s = d_s + static_cast<size_t>(bt) * G;
  float* red_s = res_s + 2 * kRes * bt * units;
  float* dc_s = red_s + bt * kWarps * units;

  const int dir = blockIdx.x / a.blocks_per_dir;
  const int blk = blockIdx.x % a.blocks_per_dir;
  constexpr bool kF32 = std::is_same<R, float>::value;
  const R* dho = reinterpret_cast<const R*>(dir == 0 ? a.dh[0] : a.dh[1]);
  const R* gin = reinterpret_cast<const R*>(dir == 0 ? a.g[0] : a.g[1]);
  const R* cin = reinterpret_cast<const R*>(dir == 0 ? a.c[0] : a.c[1]);
  const float* w = dir == 0 ? a.w[0] : a.w[1];
  R* dx = reinterpret_cast<R*>(dir == 0 ? a.dx[0] : a.dx[1]);
  // bfloat16: this direction's d_pre of the last two steps, by parity
  float* carry =
      kF32 ? nullptr : a.carry + static_cast<size_t>(dir) * 2 * B * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int u0 = blk * units;
  const int nu = min(units, H - u0);  // this block's units
  // residual rows go in 16-byte copies where every run is whole quads
  const bool quads = (H & 3) == 0 && (units & 3) == 0;
  step::Barrier bar(a.barrier);

  // W_hh[j][u0 + u] for j = 4 tid + jj + kJSpan q
  float wr[KQ][4][kMaxUnits];
#pragma unroll
  for (int q = 0; q < KQ; ++q) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = kJSpan * q + 4 * tid + jj;
#pragma unroll
      for (int u = 0; u < kMaxUnits; ++u) {
        wr[q][jj][u] = (j < G && u < nu)
                           ? resid::widen(reinterpret_cast<const W*>(
                                 w)[static_cast<size_t>(j) * H + u0 + u])
                           : 0.0f;
      }
    }
  }
  for (int i = tid; i < units * B; i += kThreads) dc_s[i] = 0.0f;

  // issue the copies of step s's residuals for rows b0 .. b0 + nb - 1
  // into buffer buf
  auto prefetch = [&](int s, int b0, int buf) {
    const int t = dir == 0 ? T - 1 - s : s;
    const int tc = dir == 0 ? t - 1 : t + 1;  // c_prev's time index
    const bool has_cp = tc >= 0 && tc < T;
    const int nb = min(bt, B - b0);
    R* dst0 = reinterpret_cast<R*>(res_s) + buf * kRes * bt * units;
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
      // 8 bfloat16s a 16-byte copy where every run is one whole group of
      // 8 (cp.async has no 2-byte form), else loads one by one
      if ((H & 7) == 0 && units == 8) {
        for (int i = tid; i < kRes * nb; i += kThreads) {
          const int k = i / nb;
          const int bb = i % nb;
          const bool ok = k != 5 || has_cp;
          step::copy16(dst0 + (k * bt + bb) * units,
                       ok ? src_of(k, b0 + bb, 0) : cin, ok);
        }
      } else {
        for (int i = tid; i < kRes * nb * units; i += kThreads) {
          const int k = i / (nb * units);
          const int bb = (i / units) % nb;
          const int u = i % units;
          const bool ok = u < nu && (k != 5 || has_cp);
          dst0[(k * bt + bb) * units + u] =
              ok ? __ldg(src_of(k, b0 + bb, u)) : resid::narrow<R>(0.0f);
        }
      }
    } else if (quads) {
      const int nq = units / 4;
      for (int i = tid; i < kRes * nb * nq; i += kThreads) {
        const int k = i / (nb * nq);
        const int bb = (i / nq) % nb;
        const int u = 4 * (i % nq);
        const bool ok = u < nu && (k != 5 || has_cp);
        step::copy16(dst0 + (k * bt + bb) * units + u,
                          ok ? src_of(k, b0 + bb, u) : cin, ok);
      }
    } else {
      for (int i = tid; i < kRes * nb * units; i += kThreads) {
        const int k = i / (nb * units);
        const int bb = (i / units) % nb;
        const int u = i % units;
        const bool ok = u < nu && (k != 5 || has_cp);
        step::copy4(dst0 + (k * bt + bb) * units + u,
                         ok ? src_of(k, b0 + bb, u) : cin, ok);
      }
    }
    step::commit();
  };

#ifdef BILSTM_BWD_PROBE
  long long probe_cycles[kPhases] = {};
  long long probe_laps[kPhases] = {};
  long long lap_ = clock64();
#endif
  const int tiles = (B + bt - 1) / bt;
  int buf = 0;
  prefetch(0, 0, 0);
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? T - 1 - s : s;
    const int tp = dir == 0 ? t + 1 : t - 1;  // previous step's time index
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
          src = dx + (static_cast<size_t>(tp) * B + b0) * G;
        } else {
          src = carry + (static_cast<size_t>((s - 1) & 1) * B + b0) * G;
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
                  for (int u = 0; u < kMaxUnits; ++u) {
                    const int x = r * kMaxUnits + u;
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
          const int r = r0 + (lane >> 3);
          const int u = lane & 7;
          if (r < nb && u < units) {
            red_s[(r * kWarps + warp) * units + u] = sum;
          }
        }
        __syncthreads();  // every warp's partial sums are in red_s
      }
      PROBE_LAP(2);
      const R* res =
          reinterpret_cast<const R*>(res_s) + buf * kRes * bt * units;
      for (int i = tid; i < nb * units; i += kThreads) {
        const int bb = i / units;
        const int u = i % units;
        if (u >= nu) continue;
        float dh_carry = 0.0f;
        if (s > 0) {
#pragma unroll
          for (int wp = 0; wp < kWarps; ++wp) {
            dh_carry += red_s[(bb * kWarps + wp) * units + u];
          }
        }
        const int off = bb * units + u;
        const int plane = bt * units;
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
          float* keep = carry + (static_cast<size_t>(s & 1) * B + b) * G +
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
#ifdef BILSTM_BWD_PROBE
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

template <int KQ, typename R, typename W>
cudaError_t launch(Args a, cudaStream_t stream) {
  a.units = a.H < kMaxUnits ? a.H : kMaxUnits;
  a.blocks_per_dir = (a.H + a.units - 1) / a.units;
  // dc carry [units][B], then per batch row of a tile: the previous d_pre
  // [4H] and the staged values [kVals][units]
  const size_t c_bytes = static_cast<size_t>(a.units) * a.B * sizeof(float);
  const size_t row_bytes =
      static_cast<size_t>(4 * a.H + kVals * a.units) * sizeof(float);
  if (c_bytes + row_bytes > kSmemBudget) {
    return cudaErrorInvalidValue;  // batch too large for the dc carry
  }
  int bt = static_cast<int>((kSmemBudget - c_bytes) / row_bytes);
  a.bt = bt > a.B ? a.B : bt;
  const size_t smem = c_bytes + static_cast<size_t>(a.bt) * row_bytes;
  void* args[] = {&a};
  return step::launch_cooperative(bilstm_bwd_kernel<KQ, R, W>,
                                  2 * a.blocks_per_dir, kThreads, smem, args,
                                  stream);
}

// W_hh's element type W: float or bfloat16 (bfloat16 compute)
template <typename W>
int launch_by_width(Args a, int resid_bf16, cudaStream_t s) {
  if (resid_bf16) {
    if (a.carry == nullptr) return cudaErrorInvalidValue;
    if (4 * a.H <= kJSpan) return launch<1, resid::bf16, W>(a, s);
    return launch<2, resid::bf16, W>(a, s);
  }
  if (4 * a.H <= kJSpan) return launch<1, float, W>(a, s);
  return launch<2, float, W>(a, s);
}

}  // namespace

extern "C" {

// barrier: one 32-bit word, zero at the launch. dh, g, c and dx are
// float32, or with resid_bf16 bfloat16, and then carry is a float32
// scratch of 2 x 2 x B x 4H (unused otherwise). w_f, w_b are float32, or
// with w_bf16 bfloat16. Returns a cudaError_t (0 on success). Does not
// synchronise.
int bilstm_bwd_launch(const void* dh_f, const void* dh_b, const void* g_f,
                      const void* g_b, const void* c_f, const void* c_b,
                      const void* w_f, const void* w_b, void* dx_f,
                      void* dx_b, void* carry, void* barrier, int T, int B,
                      int H, int resid_bf16, int w_bf16, int device,
                      void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxH) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a = {};
  a.dh[0] = static_cast<const float*>(dh_f);
  a.dh[1] = static_cast<const float*>(dh_b);
  a.g[0] = static_cast<const float*>(g_f);
  a.g[1] = static_cast<const float*>(g_b);
  a.c[0] = static_cast<const float*>(c_f);
  a.c[1] = static_cast<const float*>(c_b);
  a.w[0] = static_cast<const float*>(w_f);
  a.w[1] = static_cast<const float*>(w_b);
  a.dx[0] = static_cast<float*>(dx_f);
  a.dx[1] = static_cast<float*>(dx_b);
  a.barrier = static_cast<unsigned*>(barrier);
  a.carry = static_cast<float*>(carry);
  a.T = T;
  a.B = B;
  a.H = H;
  auto s = static_cast<cudaStream_t>(stream);
  if (w_bf16) return launch_by_width<resid::bf16>(a, resid_bf16, s);
  return launch_by_width<float>(a, resid_bf16, s);
}

const char* bilstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef BILSTM_BWD_PROBE
// Cycles and laps of each phase since the last reset, summed over warps.
int bilstm_bwd_probe_read(unsigned long long* cycles,
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
