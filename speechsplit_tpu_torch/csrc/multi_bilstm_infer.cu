// N independent bidirectional LSTMs of mixed widths in one launch, float32
// forward: the lean forward (h only) and the residual-saving forward of
// training, one kernel body a plan. The residual-saving forward stores g
// and c in float32 or bfloat16 (rounded as they are stored). With
// bfloat16 compute each direction's W_hh is float32 or bfloat16, as the
// launch's flags say: the JAX model's _recurrent_dtype keeps the H=1
// rhythm stream's W float32 beside the bfloat16 W of the others, in one
// call. A bfloat16 W is widened (exactly) as it is staged and the product
// reads h_{t-1} rounded to bfloat16 (csrc/lane_fwd.cuh; the block plan
// keeps its h_{t-1} rounded so in shared memory); xp and h stay float32,
// as the JAX multi-stream op keeps them. Both plans run every dtype.
//
// Replaces: speechsplit_tpu/ops/pallas_multilstm.py::_infer_kernel (wrapper
// _infer), the TPU kernel that interleaves the 2N directions of the
// generator's narrow encoder recurrences (content layer 0 H=8, pitch H=32,
// rhythm H=1) or the F0 converter's (f0 H=32, rhythm H=1) in one grid,
// and, with kResid, ::_fwd_kernel (wrapper _fwd), which also writes each
// step's post-activation gates and cell state for the backward
// (csrc/multi_bilstm_bwd.cu).
// Same cell math as pallas_lstm._cell; directions are ordered
// [f0, b0, f1, b1, ...], odd ones walk T-1 -> 0 over data kept in real
// time order.
//
// Layouts per direction d: xp [T, B, 4H_d], w [4H_d, H_d] (torch's
// weight_hh_l{k}), h [T, B, H_d]; with kResid also g [T, B, 4H_d] (gates
// i, f, g, o after their activations) and c [T, B, H_d], the layout
// csrc/multi_bilstm_bwd.cu reads.
//
// What bounds it on an H100: latency. The widths are tiny (4H <= 256), so
// a step of a row is at most a few thousand multiply-adds, and the 192
// dependent steps of a direction cost the latency of one step's chain;
// bytes and arithmetic bound a call at a few µs (0.0026 ms at B28, by
// the H100's published rates). With the design below the chain is set by
// the cell: at B28 a step of the widest direction (H=32) takes about 950
// cycles, the cell's five activations (three sigmoids with an IEEE
// division each, two tanhf, c between them) about 550 and the product
// about 230 (chip_smoke.py's [multi probe] on an NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md). At large batches (the 731-pair call's 5117
// rows) the SMs' issue rate and the registers take over: 168 a thread in
// the lane plan, so three blocks of 128 threads an SM.
//
// What the design does about it (the lane plan, widths up to kLaneMaxH;
// its step is csrc/lane_fwd.cuh, which lstm_fwd's narrow plan shares):
// - A block serves one direction; a descriptor gives each direction its
//   own range of blocks, and all 2N directions run in one launch.
// - A batch row takes L lanes of a warp, L the least power of two >= H
//   (32 / L rows a warp); each lane owns one unit and all four of its
//   gates, so a step needs no barrier: c stays in a register for all T
//   steps and h_{t-1} reaches the row's other lanes by __shfl_sync of
//   width L.
// - W_hh sits in registers: a lane holds its unit's L float4s (i, f, g, o
//   at column k, zero-padded to L), staged once through shared memory. A
//   step's product is L shuffles and 4L FMAs, no load (read from shared
//   memory instead, 32 16-byte loads a lane a step bound the product by
//   shared-memory bandwidth: 1.6x the time at B28 on the same card).
// - The next step's gate inputs are in flight in registers while a step
//   computes (more steps ahead cost registers, and with them the large
//   batches, and gained at most 4% at B28).
// - The cell update rounds each product and the sum on its own, as the
//   plain version's separate ops do.
// A call with a direction wider than kLaneMaxH (33..kMaxH) runs the block
// plan for all its directions, in a kernel of its own that keeps its own
// register count: one block of kThreads per (direction, tile of
// kBatchTile rows), W_hh transposed and h and c of the tile in shared
// memory, two __syncthreads() a step (the kernel before the lane plan;
// its bfloat16 instances widen W as they stage it and round h_{t-1} and
// the residuals as they store them, and its float32 ones keep their
// machine code).
//
// Built with -DMULTI_BILSTM_PROBE (chip_smoke.py's probe build), the lane
// plan also adds up clock64() laps of each phase of a step per warp and
// direction, which multi_bilstm_probe_read returns.

#include <cuda_runtime.h>

#ifdef MULTI_BILSTM_PROBE
#define LANE_FWD_PROBE
#endif
#include "lane_fwd.cuh"

namespace {

constexpr int kMaxDirs = 8;
constexpr int kMaxH = 64;
// Widths up to this one run the lane plan (a row on up to 32 lanes).
constexpr int kLaneMaxH = 32;
constexpr int kLaneThreads = 128;
// the block plan's rows and threads a block
constexpr int kBatchTile = 8;
constexpr int kThreads = 256;

using Dir = lane_fwd::Dir;

// the block plan's descriptor; w_bf16[i]: direction i's W_hh is
// bfloat16 (read only by a kernel built for bfloat16 compute)
struct Params {
  Dir d[kMaxDirs];
  int T;
  int B;
  int tiles;
  int w_bf16[kMaxDirs];
};

// the lane plan's: direction i runs L[i] lanes a row on the blocks from
// first[i]; w_bf16[i]: its W_hh is bfloat16 (read only by a kernel built
// for bfloat16 compute)
struct LaneParams {
  Dir d[kMaxDirs];
  int L[kMaxDirs];
  int first[kMaxDirs];
  int n_dirs;
  int T;
  int B;
  int w_bf16[kMaxDirs];
};

#ifdef MULTI_BILSTM_PROBE
// the lane step's phases (lane_fwd::kPhases), per direction
constexpr int kPhases = lane_fwd::kPhases;
__device__ unsigned long long g_probe_cycles[kMaxDirs * kPhases];
__device__ unsigned long long g_probe_laps[kMaxDirs * kPhases];
__device__ float g_probe_sink;
#endif

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// R: the residuals' element type (kResid), float or bfloat16. W: float,
// every W_hh float32; or bfloat16 (bfloat16 compute), each direction's
// W_hh of the type p.w_bf16 names for it, so that the encoders'
// bfloat16 W (H >= 2) and the rhythm stream's float32 one (H = 1,
// _recurrent_dtype) share a launch. One step body a width takes either
// type (lane_fwd::steps): a block serves one direction, so its flag is
// uniform across the block.
template <bool kResid, typename R = float, typename W = float>
__global__ void __launch_bounds__(kLaneThreads)
multi_bilstm_lane_kernel(LaneParams p) {
  extern __shared__ float4 lane_smem[];
  // the block's direction: the last one whose range starts at or before
  // this block (indices known at compile time: a descriptor indexed at
  // run time would be copied to local memory)
  Dir d = p.d[0];
  int L = p.L[0];
  int first = p.first[0];
  int dir = 0;
#pragma unroll
  for (int i = 1; i < kMaxDirs; ++i) {
    if (i < p.n_dirs && static_cast<int>(blockIdx.x) >= p.first[i]) {
      d = p.d[i];
      L = p.L[i];
      first = p.first[i];
      dir = i;
    }
  }
  const int blk = static_cast<int>(blockIdx.x) - first;
  lane_fwd::Probe probe;
  bool w_bf16 = false;
  if constexpr (!std::is_same<W, float>::value) {
#pragma unroll
    for (int i = 0; i < kMaxDirs; ++i) {
      if (i == dir) w_bf16 = p.w_bf16[i] != 0;
    }
  }
  switch (L) {
    case 1:
      lane_fwd::steps<1, kResid, R, W>(d, blk, dir, p.T, p.B, lane_smem,
                                       probe, w_bf16);
      break;
    case 2:
      lane_fwd::steps<2, kResid, R, W>(d, blk, dir, p.T, p.B, lane_smem,
                                       probe, w_bf16);
      break;
    case 4:
      lane_fwd::steps<4, kResid, R, W>(d, blk, dir, p.T, p.B, lane_smem,
                                       probe, w_bf16);
      break;
    case 8:
      lane_fwd::steps<8, kResid, R, W>(d, blk, dir, p.T, p.B, lane_smem,
                                       probe, w_bf16);
      break;
    case 16:
      lane_fwd::steps<16, kResid, R, W>(d, blk, dir, p.T, p.B, lane_smem,
                                        probe, w_bf16);
      break;
    default:
      lane_fwd::steps<32, kResid, R, W>(d, blk, dir, p.T, p.B, lane_smem,
                                        probe, w_bf16);
  }
#ifdef MULTI_BILSTM_PROBE
  probe.flush(g_probe_cycles + dir * kPhases, g_probe_laps + dir * kPhases,
              &g_probe_sink);
#endif
}

static_assert(kLaneMaxH == 32 && kLaneMaxH == lane_fwd::kLaneMaxH &&
                  kLaneThreads == lane_fwd::kThreads,
              "the lane plan's widest instance is L = 32");

// The block plan: kBatchTile rows of one direction a block, a thread per
// (row, gate row) in the product and per (row, unit) in the cell. R and W
// as in the lane plan: the residuals' element type, and float or
// bfloat16 W_hh, each direction's of the type p.w_bf16 names for it. A
// bfloat16 W is widened as it is staged into w_s (exact), and h_s holds
// h_{t-1} rounded to bfloat16 (the product is its only reader; the h
// stored and the cell stay float32).
template <bool kResid, typename R = float, typename W = float>
__global__ void __launch_bounds__(kThreads)
multi_bilstm_infer_kernel(Params p) {
  extern __shared__ float smem[];
  const int dir = blockIdx.x / p.tiles;
  const int tile = blockIdx.x % p.tiles;
  const Dir d = p.d[dir];
  const int H = d.H;
  const int G = 4 * H;
  const int T = p.T;
  const int B = p.B;
  const int b0 = tile * kBatchTile;
  const int nb = min(kBatchTile, B - b0);
  const bool reverse = dir & 1;
  bool w_bf16 = false;
  if constexpr (!std::is_same<W, float>::value) w_bf16 = p.w_bf16[dir] != 0;
  const resid::Operand<W> operand(w_bf16);

  float* w_s = smem;                  // [H][G]: w_s[k*G + j] = w[j*H + k]
  float* h_s = w_s + H * G;           // [nb][H]
  float* c_s = h_s + kBatchTile * H;  // [nb][H]
  float* g_s = c_s + kBatchTile * H;  // [nb][G] pre-activations

  for (int i = threadIdx.x; i < H * G; i += blockDim.x) {
    const int j = i / H;
    const int k = i % H;
    w_s[k * G + j] = resid::weight<W>(d.w, i, w_bf16);
  }
  for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
    h_s[i] = 0.0f;
    c_s[i] = 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* x = d.xp + (static_cast<size_t>(t) * B + b0) * G;
    for (int i = threadIdx.x; i < nb * G; i += blockDim.x) {
      const int b = i / G;
      const int j = i % G;
      const float* hb = h_s + b * H;
      float acc = 0.0f;
      for (int k = 0; k < H; ++k) acc = fmaf(hb[k], w_s[k * G + j], acc);
      g_s[i] = x[i] + acc;
    }
    __syncthreads();
    float* out = d.h + (static_cast<size_t>(t) * B + b0) * H;
    for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
      const int b = i / H;
      const int u = i % H;
      const float* g = g_s + b * G;
      const float i_g = sigmoid_f(g[u]);
      const float f_g = sigmoid_f(g[H + u]);
      const float g_g = tanhf(g[2 * H + u]);
      const float o_g = sigmoid_f(g[3 * H + u]);
      const float c_new = f_g * c_s[i] + i_g * g_g;
      const float h_new = o_g * tanhf(c_new);
      c_s[i] = c_new;
      h_s[i] = operand(h_new);
      out[i] = h_new;
      if constexpr (kResid) {
        R* gr = reinterpret_cast<R*>(d.g) +
                (static_cast<size_t>(t) * B + b0 + b) * G;
        gr[u] = resid::narrow<R>(i_g);
        gr[H + u] = resid::narrow<R>(f_g);
        gr[2 * H + u] = resid::narrow<R>(g_g);
        gr[3 * H + u] = resid::narrow<R>(o_g);
        reinterpret_cast<R*>(d.c)[(static_cast<size_t>(t) * B + b0) * H + i] =
            resid::narrow<R>(c_new);
      }
    }
    __syncthreads();
  }
}

// R: the residuals' element type. w_bf16: per direction, 1 where its W_hh
// is bfloat16 (bfloat16 compute), or null where every W_hh is float32.
template <bool kResid, typename R = float>
int dispatch(int n_dirs, const void* const* xp, const void* const* w,
             void* const* h, void* const* g, void* const* c, const int* hs,
             const int* w_bf16, int T, int B, int device, void* stream) {
  if (n_dirs < 1 || n_dirs > kMaxDirs || T < 1 || B < 1) {
    return cudaErrorInvalidValue;
  }
  Dir dirs[kMaxDirs] = {};
  int max_h = 0;
  bool any_bf16 = false;
  for (int i = 0; i < n_dirs; ++i) {
    if (hs[i] < 1 || hs[i] > kMaxH) return cudaErrorInvalidValue;
    dirs[i] = Dir{static_cast<const float*>(xp[i]),
                  static_cast<const float*>(w[i]), static_cast<float*>(h[i]),
                  kResid ? static_cast<float*>(g[i]) : nullptr,
                  kResid ? static_cast<float*>(c[i]) : nullptr, hs[i]};
    if (hs[i] > max_h) max_h = hs[i];
    any_bf16 = any_bf16 || (w_bf16 != nullptr && w_bf16[i] != 0);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (max_h > kLaneMaxH) {
    Params p{};
    for (int i = 0; i < n_dirs; ++i) {
      p.d[i] = dirs[i];
      p.w_bf16[i] = w_bf16 != nullptr && w_bf16[i] != 0;
    }
    p.T = T;
    p.B = B;
    p.tiles = (B + kBatchTile - 1) / kBatchTile;
    const size_t smem =
        (static_cast<size_t>(max_h) * 4 * max_h +
         2 * static_cast<size_t>(kBatchTile) * max_h +
         static_cast<size_t>(kBatchTile) * 4 * max_h) * sizeof(float);
    auto block = any_bf16
                     ? multi_bilstm_infer_kernel<kResid, R, resid::bf16>
                     : multi_bilstm_infer_kernel<kResid, R>;
    err = cudaFuncSetAttribute(block,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    block<<<n_dirs * p.tiles, kThreads, smem,
            static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
  }
  LaneParams p{};
  int blocks = 0;
  int max_l = 1;
  for (int i = 0; i < n_dirs; ++i) {
    int L = 1;
    while (L < hs[i]) L *= 2;
    const int rows = kLaneThreads / L;  // rows a block
    p.d[i] = dirs[i];
    p.L[i] = L;
    p.first[i] = blocks;
    p.w_bf16[i] = w_bf16 != nullptr && w_bf16[i] != 0;
    blocks += (B + rows - 1) / rows;
    if (L > max_l) max_l = L;
  }
  p.n_dirs = n_dirs;
  p.T = T;
  p.B = B;
  const size_t smem = sizeof(float4) * max_l * max_l;
  auto kernel = any_bf16 ? multi_bilstm_lane_kernel<kResid, R, resid::bf16>
                         : multi_bilstm_lane_kernel<kResid, R>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lean forward. xp, w, h: n_dirs device pointers each; hs: n_dirs widths;
// w_bf16: n_dirs flags, 1 where that direction's W_hh is bfloat16, or
// null. xp and h are float32. Returns a cudaError_t (0 on success). Does
// not synchronise.
int multi_bilstm_infer_launch(int n_dirs, const void* const* xp,
                              const void* const* w, void* const* h,
                              const int* hs, const int* w_bf16, int T, int B,
                              int device, void* stream) {
  return dispatch<false>(n_dirs, xp, w, h, nullptr, nullptr, hs, w_bf16, T,
                         B, device, stream);
}

// Residual-saving forward: as above, and g [T, B, 4H_d], c [T, B, H_d]
// per direction, in float32 or with resid_bf16 in bfloat16; w_bf16 as
// above.
int multi_bilstm_fwd_launch(int n_dirs, const void* const* xp,
                            const void* const* w, void* const* h,
                            void* const* g, void* const* c, int resid_bf16,
                            const int* hs, const int* w_bf16, int T, int B,
                            int device, void* stream) {
  if (resid_bf16) {
    return dispatch<true, resid::bf16>(n_dirs, xp, w, h, g, c, hs, w_bf16,
                                       T, B, device, stream);
  }
  return dispatch<true>(n_dirs, xp, w, h, g, c, hs, w_bf16, T, B, device,
                        stream);
}

const char* multi_bilstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef MULTI_BILSTM_PROBE
// Cycles and laps of each phase of the lane plan since the last reset,
// summed over warps: [kMaxDirs][kPhases] each.
int multi_bilstm_probe_read(unsigned long long* cycles,
                            unsigned long long* laps, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_probe_cycles,
                                         sizeof(g_probe_cycles));
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(laps, g_probe_laps, sizeof(g_probe_laps));
  }
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kMaxDirs * kPhases] = {};
    err = cudaMemcpyToSymbol(g_probe_cycles, zero, sizeof(zero));
    if (err == cudaSuccess) {
      err = cudaMemcpyToSymbol(g_probe_laps, zero, sizeof(zero));
    }
  }
  return err;
}
#endif

}  // extern "C"
