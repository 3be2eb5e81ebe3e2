// The lane step of the LSTM gradient recurrence for narrow widths
// (H <= 32), shared by the multi-stream gradient (multi_bilstm_bwd.cu,
// every direction of a call whose widths are all at most kLaneMaxH) and
// the single-direction gradient's narrow plan (lstm_bwd.cu).
//
// Per cell it is pallas_lstm._cell_bwd:
//   dh  = dh_out[t] + dh_carry           tanh_c = tanh(c[t])
//   dc  = dc_carry + dh o (1 - tanh_c^2)
//   d_pre = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), dh tanh_c o(1-o)]
//   dh_carry' = d_pre W_hh               dc_carry' = dc f
// with both carries float32 from zero. A forward direction's gradient
// walks T-1 -> 0 (c_prev = c[t-1], zero at t = 0), a reverse one's
// (reverse) 0 -> T-1 (c_prev = c[t+1], zero at t = T-1); the arrays stay
// in real time order. Layouts: dh [T, B, H], g [T, B, 4H] (gates i, f, g,
// o after their activations), c [T, B, H], w [4H, H] (torch's
// weight_hh_l{k}); out dx [T, B, 4H] = d_pre. g and c are float32 or
// bfloat16 (R, widened where they are read, as _cell_bwd does); dh and
// dx (D) float32, as the multi-stream VJP of the JAX package keeps them
// (pallas_multilstm.py:368-384, 406-433), or bfloat16 where the
// single-direction gradient runs bfloat16 residuals (_dh_stream_dtype,
// _grad_stream_dtype: dh widened where it is read, dx d_pre rounded as
// it is stored, the carries unrounded). With bfloat16 compute (W:
// bfloat16) a direction's W_hh is bfloat16, widened as it is staged, and
// the product reads d_pre rounded to bfloat16 (_cell_bwd's
// d_pre.astype(w.dtype)); dx, the carries and the sums stay float32.
//
// What bounds it on an H100: latency. A step of a row is at most 4H x H
// = 4096 multiply-adds, and the 192 dependent steps cost the latency of
// one step's chain each. What the step does about it:
// - A batch row takes L lanes of a warp, L the least power of two >= H
//   (32 / L rows a warp), and lane u owns unit u and its four gates: no
//   barrier, and the dc carry stays in a register for all T steps.
// - Everything that does not depend on the recurrence is off the chain:
//   the residuals are loaded two steps ahead, and one step ahead they
//   become the gate factors a = o (1 - tanh_c^2), p_i = g i (1-i),
//   p_f = c_prev f (1-f), p_g = i (1-g^2), p_o = tanh_c o (1-o) (each
//   product and difference rounded on its own). The chain of a step is
//   dh = dh_out + dh_carry, dc = fma(dh, a, dc_carry), d_pre = (dc p_i,
//   dc p_f, dc p_g, dh p_o), then the product.
// - The product: lane k holds column k of W_hh in registers as L float4s
//   (W[u][k], W[H+u][k], W[2H+u][k], W[3H+u][k]), u < L, zero past H. The
//   row's d_pre reaches its lanes through a per-warp slice of shared
//   memory (one 16-byte store a lane, __syncwarp, then L broadcast
//   16-byte loads; two slices by step parity, so one __syncwarp a step),
//   and dh_carry[k] = (acc_i + acc_f) + (acc_g + acc_o), each acc_q a
//   chain of L FMAs over u in order.
// - d_pre goes out as four L-wide runs a row.
// Rows past B and units past H run on zero residuals (their d_pre is 0)
// and store nothing; every lane of the warp takes part in the exchange.
//
// Built with LANE_BWD_PROBE defined (by a source's probe build), a step
// also adds up clock64() laps of its phases per warp (Probe below).
#pragma once

#include <cuda_runtime.h>

#include "resid.cuh"

namespace lane_bwd {

// Widths up to this one run the lane step (a row on up to 32 lanes).
constexpr int kLaneMaxH = 32;
constexpr int kThreads = 128;  // a block: 4 warps

struct Dir {
  const float* dh;  // elements of type D (steps below)
  const float* g;   // elements of type R
  const float* c;   // elements of type R
  const float* w;   // elements of type W
  float* dx;        // elements of type D
  int H;
};

// The float4s of shared memory a block of the lane step uses at width
// L: W_hh staged once, then two exchange slices of a float4 a thread.
constexpr int smem_float4s(int L) { return L * L + 2 * kThreads; }

// phases of a step: 0 the next step's residuals (the wait for them, and
// its gate factors), 1 the product, 2 the cell gradient and the stores,
// 3 the prefetch two steps ahead
constexpr int kPhases = 4;

#ifdef LANE_BWD_PROBE
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

// The residuals of one (row, unit) at one step, as loaded: g and c of
// element type R in resid::Loaded<R> registers, dh of type D in
// resid::Loaded<D> (a bfloat16 one is widened only when the step's
// factors are formed, a step after its load, so that no instruction
// waits on the load before then).
template <typename R, typename D = float>
struct Res {
  typename resid::Loaded<R>::type i, f, g, o, c, c_prev;
  typename resid::Loaded<D>::type dh;
};

// The gate factors of a step (see the top of the file) and its dh_out.
struct Factors {
  float a, p_i, p_f, p_g, p_o, f, dh;
};

template <typename R, typename D>
__device__ __forceinline__ Factors factors(const Res<R, D>& res) {
  const float i = resid::widen_loaded(res.i);
  const float f = resid::widen_loaded(res.f);
  const float g = resid::widen_loaded(res.g);
  const float o = resid::widen_loaded(res.o);
  const float c_prev = resid::widen_loaded(res.c_prev);
  const float tanh_c = tanhf(resid::widen_loaded(res.c));
  Factors x;
  x.a = __fmul_rn(o, __fsub_rn(1.0f, __fmul_rn(tanh_c, tanh_c)));
  x.p_i = __fmul_rn(__fmul_rn(g, i), __fsub_rn(1.0f, i));
  x.p_f = __fmul_rn(__fmul_rn(c_prev, f), __fsub_rn(1.0f, f));
  x.p_g = __fmul_rn(i, __fsub_rn(1.0f, __fmul_rn(g, g)));
  x.p_o = __fmul_rn(__fmul_rn(tanh_c, o), __fsub_rn(1.0f, o));
  x.f = f;
  x.dh = resid::widen_loaded(res.dh);
  return x;
}

// The T steps of the rows of block `blk` (blockDim.x / L rows a block)
// of one direction at width L >= d.H. smem: smem_float4s(L) float4s. R:
// the element type of g and c. W: float, or bfloat16 for a kernel built
// for bfloat16 compute, where `w_bf16` says whether this direction's W_hh
// is bfloat16 (resid::weight, and the product reads d_pre rounded) or
// float32. D: the element type of dh and dx.
template <int L, typename R = float, typename W = float, typename D = float>
__device__ __forceinline__ void steps(const Dir& d, int blk, bool reverse,
                                      int T, int B, float4* smem,
                                      Probe& probe, bool w_bf16 = false) {
  constexpr int kRows = 32 / L;  // batch rows a warp
  const int H = d.H;
  float4* wt = smem;             // [L][L]: wt[k * L + u] column k, unit u
  float4* xch = smem + L * L;    // [2][kThreads] the exchange slices
  const resid::Operand<W> op(w_bf16);  // d_pre as the product reads it
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
  // column u of W_hh, L float4s in registers (indices known at compile
  // time): shared memory only stages it
  float4 wr[L];
#pragma unroll
  for (int k = 0; k < L; ++k) wr[k] = wt[u * L + k];
  // this row's slots of the exchange: slot (s & 1) * kThreads + base + k
  // holds unit k's d_pre
  const int base = (threadIdx.x & ~31) + (lane & ~(L - 1));

  const size_t hstep = static_cast<size_t>(B) * H;  // a step of dh and c
  const size_t at = ok ? static_cast<size_t>(row) * H + u : 0;
  const size_t gat = ok ? static_cast<size_t>(row) * 4 * H + u : 0;
  const typename resid::Loaded<R>::type zero = 0;
  const typename resid::Loaded<D>::type zero_dh = 0;
  auto fetch = [&](Res<R, D>& r, int s) {
    const bool live = ok && s < T;
    const int t = s >= T ? 0 : reverse ? s : T - 1 - s;
    const int tc = reverse ? t + 1 : t - 1;  // c_prev's time index
    const R* g = reinterpret_cast<const R*>(d.g) +
                 static_cast<size_t>(t) * 4 * hstep + gat;
    const R* c = reinterpret_cast<const R*>(d.c);
    r.i = live ? resid::load(g) : zero;
    r.f = live ? resid::load(g + H) : zero;
    r.g = live ? resid::load(g + 2 * H) : zero;
    r.o = live ? resid::load(g + 3 * H) : zero;
    r.c = live ? resid::load(c + static_cast<size_t>(t) * hstep + at) : zero;
    r.c_prev = live && tc >= 0 && tc < T
                   ? resid::load(c + static_cast<size_t>(tc) * hstep + at)
                   : zero;
    r.dh = live ? resid::load(reinterpret_cast<const D*>(d.dh) +
                              static_cast<size_t>(t) * hstep + at)
                : zero_dh;
  };

  Res<R, D> next, after;  // the residuals of steps s + 1 and s + 2
  fetch(next, 0);
  Factors fac = factors(next);
  fetch(next, 1);
  float dh_carry = 0.0f, dc_carry = 0.0f;
  probe.restart();
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    // the chain: the cell gradient of step s
    const float dh = __fadd_rn(fac.dh, dh_carry);
    const float dc = fmaf(dh, fac.a, dc_carry);
    const float4 dp = make_float4(__fmul_rn(dc, fac.p_i),
                                  __fmul_rn(dc, fac.p_f),
                                  __fmul_rn(dc, fac.p_g),
                                  __fmul_rn(dh, fac.p_o));
    dc_carry = __fmul_rn(dc, fac.f);
    if (ok) {
      D* out = reinterpret_cast<D*>(d.dx) +
               (static_cast<size_t>(t) * B + row) * 4 * H + u;
      out[0] = resid::narrow<D>(dp.x);
      out[H] = resid::narrow<D>(dp.y);
      out[2 * H] = resid::narrow<D>(dp.z);
      out[3 * H] = resid::narrow<D>(dp.w);
    }
    float4* slot = xch + (s & 1) * kThreads + base;
    if constexpr (L > 1) {
      slot[u] = op(dp);
      __syncwarp();
    }
    probe.ready(dp.x);
    probe.lap(2);
    fetch(after, s + 2);
    probe.lap(3);
    fac = factors(next);
    probe.ready(fac.a);
    probe.ready(fac.p_o);
    probe.ready(fac.p_i);
    probe.lap(0);
    next = after;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const float4 v = L > 1 ? slot[k] : op(dp);
      acc[0] = fmaf(v.x, wr[k].x, acc[0]);
      acc[1] = fmaf(v.y, wr[k].y, acc[1]);
      acc[2] = fmaf(v.z, wr[k].z, acc[2]);
      acc[3] = fmaf(v.w, wr[k].w, acc[3]);
    }
    dh_carry = __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
    probe.ready(dh_carry);
    probe.lap(1);
  }
}

}  // namespace lane_bwd
