// The lane step of the LSTM forward for narrow widths (H <= 32), shared by
// the multi-stream forwards (multi_bilstm_infer.cu, every direction of a
// call whose widths are all at most kLaneMaxH) and the single-direction
// residual-saving forward's narrow plan (lstm_infer.cu, lstm_fwd).
//
// Per cell it is pallas_lstm._cell: gates = xp + h_{t-1} W_hh^T ordered
// i, f, g, o; sigmoid/sigmoid/tanh/sigmoid; c = f c + i g; h = o tanh(c);
// state float32 from zero. A reverse direction walks T-1 -> 0 over data
// kept in real time order. Layouts: xp [T, B, 4H], w [4H, H] (torch's
// weight_hh_l{k}), h [T, B, H]; with kResid also g [T, B, 4H] (gates i,
// f, g, o after their activations) and c [T, B, H], in float32 or in
// bfloat16 (R: rounded as they are stored; h and the c carry stay
// float32, as _fwd_kernel under the JAX default residual_dtype). With
// bfloat16 compute (W: bfloat16) a direction's W_hh is bfloat16, widened
// as it is staged, and the product reads h_{t-1} rounded to bfloat16
// (pallas_lstm._cell's h.astype(w.dtype)); h, the sums and the cell stay
// float32. xp is float32, or bfloat16 (X) where the single-direction
// forward runs bfloat16 W beside bfloat16 residuals
// (pallas_lstm.stream_dtype), widened as it is loaded.
//
// What bounds it on an H100: latency. A step of a row is at most 4H x H
// = 4096 multiply-adds, and the T dependent steps cost the latency of one
// step's chain each; the cell's five activations take about half of it.
// What the step does about it:
// - A batch row takes L lanes of a warp, L the least power of two >= H
//   (32 / L rows a warp); each lane owns one unit and all four of its
//   gates, so a step needs no barrier: c stays in a register for all T
//   steps and h_{t-1} reaches the row's other lanes by __shfl_sync of
//   width L.
// - W_hh sits in registers: a lane holds its unit's L float4s (i, f, g, o
//   at column k, zero-padded to L), staged once through shared memory. A
//   step's product is L shuffles and 4L FMAs, one chain a gate over
//   ascending k, no load.
// - The next step's gate inputs are in flight in registers while a step
//   computes.
// - The cell update rounds each product and the sum on its own, as the
//   plain version's separate ops do.
// Rows past B and units past H run on zero inputs (their h stays 0) and
// store nothing; every lane of the warp takes part in the shuffles.
//
// Built with LANE_FWD_PROBE defined (by a source's probe build), a step
// also adds up clock64() laps of its phases per warp (Probe below).
#pragma once

#include <cuda_runtime.h>

#include "resid.cuh"

namespace lane_fwd {

// Widths up to this one run the lane step (a row on up to 32 lanes).
constexpr int kLaneMaxH = 32;
constexpr int kThreads = 128;  // a block: 4 warps

struct Dir {
  const float* xp;  // elements of type X (steps below)
  const float* w;  // elements of type W (steps below)
  float* h;
  float* g;  // residual-saving forward only, elements of type R
  float* c;
  int H;
};

// phases of a step: 0 the gate inputs' wait, 1 the product, 2 the cell
// and the stores, 3 the issue of the next step's gate inputs
constexpr int kPhases = 4;

#ifdef LANE_FWD_PROBE
struct Probe {
  long long cycles[kPhases] = {};
  long long laps[kPhases] = {};
  long long last = 0;
  float sink = 0.0f;

  // called before the first lap
  __device__ __forceinline__ void restart() { last = clock64(); }

  __device__ __forceinline__ void lap(int phase) {
    const long long now = clock64();
    cycles[phase] += now - last;
    ++laps[phase];
    last = now;
  }

  // an instruction that reads v, so that the next lap starts after v is
  // ready
  __device__ __forceinline__ void ready(float v) {
    asm volatile("add.f32 %0, %0, %1;" : "+f"(sink) : "f"(v));
  }

  // lane 0 of each warp adds the warp's laps to cycles[0 .. kPhases)
  // and laps[0 .. kPhases)
  __device__ void flush(unsigned long long* cycles_out,
                        unsigned long long* laps_out, float* sink_out) {
    if ((threadIdx.x & 31) == 0) {
      for (int p = 0; p < kPhases; ++p) {
        atomicAdd(cycles_out + p, static_cast<unsigned long long>(cycles[p]));
        atomicAdd(laps_out + p, static_cast<unsigned long long>(laps[p]));
      }
    }
    if (sink == 1234.5f) *sink_out = sink;
  }
};
#else
struct Probe {
  __device__ __forceinline__ void restart() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void ready(float) {}
};
#endif

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The T steps of the rows of block `blk` (blockDim.x / L rows a block) of
// one direction at width L >= d.H; an odd `dir` walks T-1 -> 0. wt: L * L
// float4s of shared memory. R: the residuals' element type. W: float, or
// bfloat16 for a kernel built for bfloat16 compute, where `w_bf16` says
// whether this direction's W_hh is bfloat16 (resid::weight, and the
// product reads h_{t-1} rounded) or float32. X: the element type of xp.
template <int L, bool kResid, typename R = float, typename W = float,
          typename X = float>
__device__ __forceinline__ void steps(const Dir& d, int blk, int dir, int T,
                                      int B, float4* wt, Probe& probe,
                                      bool w_bf16 = false) {
  constexpr int kRows = 32 / L;  // batch rows a warp
  const int H = d.H;
  const bool reverse = dir & 1;
  const resid::Operand<W> op(w_bf16);  // h_{t-1} as the product reads it
  // wt[k * L + u]: (i, f, g, o) of unit u at column k, zeros past H
  for (int i = threadIdx.x; i < L * L; i += blockDim.x) {
    const int k = i / L;
    const int u = i % L;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < H && u < H) {
      v.x = resid::weight<W>(d.w, static_cast<size_t>(u) * H + k, w_bf16);
      v.y = resid::weight<W>(d.w, static_cast<size_t>(H + u) * H + k, w_bf16);
      v.z = resid::weight<W>(d.w, static_cast<size_t>(2 * H + u) * H + k,
                             w_bf16);
      v.w = resid::weight<W>(d.w, static_cast<size_t>(3 * H + u) * H + k,
                             w_bf16);
    }
    wt[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row0 = (blk * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kRows;
  if (row0 >= B) return;  // a warp without a live row (warp-uniform)
  const int u = lane & (L - 1);
  const int row = row0 + lane / L;
  const bool ok = row < B && u < H;
  // this lane's unit's W_hh, L float4s in registers (indices known at
  // compile time): shared memory only stages it
  float4 wr[L];
#pragma unroll
  for (int k = 0; k < L; ++k) wr[k] = wt[k * L + u];
  const size_t xstep = static_cast<size_t>(B) * 4 * H;  // a step of xp
  const X* xrow = reinterpret_cast<const X*>(d.xp) +
                  (ok ? static_cast<size_t>(row) * 4 * H + u : 0);
  auto fetch = [&](float(&r)[4], int s) {
    const X* x = xrow + static_cast<size_t>(reverse ? T - 1 - s : s) *
                            xstep;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      r[g] = ok ? resid::widen_loaded(resid::load(x + g * H)) : 0.0f;
    }
  };
  float next[4];  // the next step's gate inputs, in flight during a step
  fetch(next, 0);
  probe.restart();
  float c_st = 0.0f, h_st = 0.0f;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    float x[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      x[g] = next[g];
      probe.ready(x[g]);
    }
    probe.lap(0);
    if (s + 1 < T) fetch(next, s + 1);
    probe.lap(3);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    // the product's operand: h_{t-1}, rounded beside a bfloat16 W
    const float h_op = op(h_st);
#pragma unroll
    for (int k = 0; k < L; ++k) {
      // h_{t-1}[k], from the lane that owns it
      const float hk = L == 1 ? h_op : __shfl_sync(0xffffffffu, h_op, k, L);
      acc[0] = fmaf(hk, wr[k].x, acc[0]);
      acc[1] = fmaf(hk, wr[k].y, acc[1]);
      acc[2] = fmaf(hk, wr[k].z, acc[2]);
      acc[3] = fmaf(hk, wr[k].w, acc[3]);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) probe.ready(acc[g]);
    probe.lap(1);
    const float i_g = sigmoid_f(x[0] + acc[0]);
    const float f_g = sigmoid_f(x[1] + acc[1]);
    const float g_g = tanhf(x[2] + acc[2]);
    const float o_g = sigmoid_f(x[3] + acc[3]);
    // each product and the sum rounded on its own, as the plain version's
    // separate ops round them
    c_st = __fadd_rn(__fmul_rn(f_g, c_st), __fmul_rn(i_g, g_g));
    h_st = o_g * tanhf(c_st);
    if (ok) {
      const size_t at = (static_cast<size_t>(t) * B + row) * H + u;
      d.h[at] = h_st;
      if constexpr (kResid) {
        R* gr = reinterpret_cast<R*>(d.g) +
                (static_cast<size_t>(t) * B + row) * 4 * H + u;
        gr[0] = resid::narrow<R>(i_g);
        gr[H] = resid::narrow<R>(f_g);
        gr[2 * H] = resid::narrow<R>(g_g);
        gr[3 * H] = resid::narrow<R>(o_g);
        reinterpret_cast<R*>(d.c)[at] = resid::narrow<R>(c_st);
      }
    }
    probe.ready(h_st);
    probe.lap(2);
  }
}

}  // namespace lane_fwd
