// N independent bidirectional LSTMs of mixed widths in one launch, the
// gradient recurrence, float32 (g and c also bfloat16, and each
// direction's W_hh float32 or, with bfloat16 compute, bfloat16: the
// product then reads d_pre rounded to bfloat16, csrc/lane_bwd.cuh), on
// either plan.
//
// Replaces: speechsplit_tpu/ops/pallas_multilstm.py::_bwd_kernel (wrapper
// _bwd_call), the TPU kernel that runs the gate-gradient recurrences of
// the 2N narrow encoder directions in one grid. Per cell it is
// pallas_lstm._cell_bwd (see csrc/lane_bwd.cuh for the formulas), with
// the dh and dc carries float32 from zero. Directions are ordered
// [f0, b0, f1, b1, ...]: a forward direction's gradient walks T-1 -> 0
// (c_prev = c[t-1], zero at t = 0), a backward direction's walks 0 -> T-1
// (c_prev = c[t+1], zero at t = T-1), over data kept in real time order.
//
// Layouts per direction d: dh [T, B, H_d] (cotangent of h), g [T, B, 4H_d]
// (post-activation gates from the residual-saving forward), c [T, B, H_d],
// w [4H_d, H_d] (torch's weight_hh_l{k}); out dx [T, B, 4H_d] = d_pre.
// dW_hh is a GEMM outside (ops/multi_bilstm.py), as in the JAX package.
//
// What bounds it on an H100: latency, as in the forward. The widths are
// tiny (4H <= 256), so a step is a few thousand multiply-adds and each of
// the 192 dependent steps costs the latency of its chain. The directions
// are independent of each other.
//
// What the design does about it (the lane plan, for calls whose widths
// are all up to lane_bwd::kLaneMaxH = 32; the generator's (8, 32, 1) and
// the F0 converter's (32, 1)): the forward's lane plan
// (csrc/multi_bilstm_infer.cu) with the gradient's lane step
// (csrc/lane_bwd.cuh). A block serves one direction, a descriptor gives
// each direction its own range of blocks, and all 2N directions run in
// one launch; a row takes L lanes, each lane one unit, W_hh's column of
// the lane in registers, the dc carry in a register, no barrier; the
// residuals and the gate factors are ready a step ahead, so a step's
// chain is the cell's few multiply-adds and the product.
// A call with a direction wider than 32 (33..kMaxH) runs the block plan
// for all its directions, in a kernel of its own that keeps its own
// register count (the kernel before the lane plan): one block per
// (direction, batch tile of up to 8 rows), W_hh, d_pre and both carries
// in shared memory, two __syncthreads() a step. Its bfloat16 instances
// read g and c widened, widen a bfloat16 W as they stage it (exact) and
// round d_pre where the product reads it; dx stays the float32 d_pre, and
// the float32 instance keeps its machine code.
//
// Built with -DMULTI_BILSTM_BWD_PROBE (chip_smoke.py's probe build), the
// lane plan also adds up clock64() laps of each phase of a step per warp
// and direction (lane_bwd.cuh), which multi_bilstm_bwd_probe_read
// returns.

#include <cuda_runtime.h>

#ifdef MULTI_BILSTM_BWD_PROBE
#define LANE_BWD_PROBE
#endif
#include "lane_bwd.cuh"

namespace {

constexpr int kMaxDirs = 8;
constexpr int kMaxH = 64;
constexpr int kBatchTile = 8;
constexpr int kThreads = 256;

struct Dir {
  const float* dh;
  const float* g;
  const float* c;
  const float* w;
  float* dx;
  int H;
};

// the block plan's descriptor; w_bf16[i]: direction i's W_hh is
// bfloat16 (read only by a kernel built for bfloat16 W)
struct Params {
  Dir d[kMaxDirs];
  int T;
  int B;
  int tiles;
  int w_bf16[kMaxDirs];
};

// the lane plan's descriptor: direction i runs L[i] lanes a row on the
// blocks from first[i]
struct LaneParams {
  lane_bwd::Dir d[kMaxDirs];
  int L[kMaxDirs];
  int first[kMaxDirs];
  int n_dirs;
  int T;
  int B;
  int w_bf16[kMaxDirs];  // read only by a kernel built for bfloat16 W
};

#ifdef MULTI_BILSTM_BWD_PROBE
// lane_bwd::kPhases slots per direction
__device__ unsigned long long g_probe_cycles[kMaxDirs * lane_bwd::kPhases];
__device__ unsigned long long g_probe_laps[kMaxDirs * lane_bwd::kPhases];
__device__ float g_probe_sink;
#endif

// R: the element type of g and c, float or bfloat16. W: float, every
// W_hh float32; or bfloat16 (bfloat16 compute), each direction's W_hh of
// the type p.w_bf16 names for it (the encoders' bfloat16 W and the
// rhythm stream's float32 one share a launch, as in the forward), one
// step body a width taking either type (lane_bwd::steps). A bfloat16-W
// instance asks for one block a multiprocessor at least: left to itself
// ptxas held the float32-residual one to 168 registers and it took 2.2x
// the time it takes at 214 (PERF.md §6); a minimum of 0, the float32
// instances', leaves their machine code as it was.
template <typename R = float, typename W = float>
__global__ void __launch_bounds__(lane_bwd::kThreads,
                                  std::is_same<W, float>::value ? 0 : 1)
multi_bilstm_bwd_lane_kernel(LaneParams p) {
  extern __shared__ float4 lane_smem[];
  // the block's direction: the last one whose range starts at or before
  // this block (indices known at compile time: a descriptor indexed at
  // run time would be copied to local memory)
  lane_bwd::Dir d = p.d[0];
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
  const bool reverse = dir & 1;  // a backward direction
  lane_bwd::Probe probe;
  bool w_bf16 = false;
  if constexpr (!std::is_same<W, float>::value) {
#pragma unroll
    for (int i = 0; i < kMaxDirs; ++i) {
      if (i == dir) w_bf16 = p.w_bf16[i] != 0;
    }
  }
  switch (L) {
    case 1:
      lane_bwd::steps<1, R, W>(d, blk, reverse, p.T, p.B, lane_smem, probe,
                               w_bf16);
      break;
    case 2:
      lane_bwd::steps<2, R, W>(d, blk, reverse, p.T, p.B, lane_smem, probe,
                               w_bf16);
      break;
    case 4:
      lane_bwd::steps<4, R, W>(d, blk, reverse, p.T, p.B, lane_smem, probe,
                               w_bf16);
      break;
    case 8:
      lane_bwd::steps<8, R, W>(d, blk, reverse, p.T, p.B, lane_smem, probe,
                               w_bf16);
      break;
    case 16:
      lane_bwd::steps<16, R, W>(d, blk, reverse, p.T, p.B, lane_smem,
                                probe, w_bf16);
      break;
    default:
      lane_bwd::steps<32, R, W>(d, blk, reverse, p.T, p.B, lane_smem,
                                probe, w_bf16);
  }
#ifdef MULTI_BILSTM_BWD_PROBE
  probe.flush(g_probe_cycles + dir * lane_bwd::kPhases,
              g_probe_laps + dir * lane_bwd::kPhases, &g_probe_sink);
#endif
}

static_assert(lane_bwd::kLaneMaxH == 32,
              "the lane plan's widest instance is L = 32");

// The block plan. R: the element type of g and c, float or bfloat16. W:
// float, or bfloat16 (each direction's W_hh of the type p.w_bf16 names
// for it), as in the lane plan.
template <typename R = float, typename W = float>
__global__ void __launch_bounds__(kThreads)
multi_bilstm_bwd_kernel(Params p) {
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
  const bool reverse = dir & 1;  // a backward direction
  bool w_bf16 = false;
  if constexpr (!std::is_same<W, float>::value) w_bf16 = p.w_bf16[dir] != 0;
  const resid::Operand<W> operand(w_bf16);
  const R* gres = reinterpret_cast<const R*>(d.g);
  const R* cres = reinterpret_cast<const R*>(d.c);

  float* w_s = smem;                   // [G][H], as w
  float* dp_s = w_s + G * H;           // [nb][G] this step's d_pre
  float* dh_s = dp_s + kBatchTile * G; // [nb][H] dh carry
  float* dc_s = dh_s + kBatchTile * H; // [nb][H] dc carry

  for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
    w_s[i] = resid::weight<W>(d.w, i, w_bf16);
  }
  for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    // the gradient runs the recurrence backwards
    const int t = reverse ? s : T - 1 - s;
    const int tc = reverse ? t + 1 : t - 1;  // c_prev's time index
    const bool has_cp = tc >= 0 && tc < T;
    const size_t row0 = static_cast<size_t>(t) * B + b0;
    for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
      const int b = i / H;
      const int u = i % H;
      const R* g = gres + (row0 + b) * G;
      const float i_g = resid::widen(g[u]), f_g = resid::widen(g[H + u]),
                  g_g = resid::widen(g[2 * H + u]),
                  o_g = resid::widen(g[3 * H + u]);
      const float tanh_c = tanhf(resid::widen(cres[row0 * H + i]));
      const float c_prev =
          has_cp ? resid::widen(
                       cres[(static_cast<size_t>(tc) * B + b0) * H + i])
                 : 0.0f;
      const float dh = d.dh[row0 * H + i] + dh_s[i];
      const float d_o = dh * tanh_c;
      const float dc = dc_s[i] + dh * o_g * (1.0f - tanh_c * tanh_c);
      float* dp = dp_s + b * G;
      dp[u] = dc * g_g * i_g * (1.0f - i_g);
      dp[H + u] = dc * c_prev * f_g * (1.0f - f_g);
      dp[2 * H + u] = dc * i_g * (1.0f - g_g * g_g);
      dp[3 * H + u] = d_o * o_g * (1.0f - o_g);
      dc_s[i] = dc * f_g;
    }
    __syncthreads();
    float* out = d.dx + row0 * G;
    for (int i = threadIdx.x; i < nb * G; i += blockDim.x) out[i] = dp_s[i];
    for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
      const int b = i / H;
      const int k = i % H;
      const float* dp = dp_s + b * G;
      float acc = 0.0f;
      for (int j = 0; j < G; ++j) {
        acc = fmaf(operand(dp[j]), w_s[j * H + k], acc);
      }
      dh_s[i] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// dh, g, c, w, dx: n_dirs device pointers each; hs: n_dirs widths. g
// and c float32, or with resid_bf16 bfloat16; dh and dx float32. w_bf16:
// n_dirs flags, 1 where that direction's W_hh is bfloat16, or null. Returns a cudaError_t (0 on
// success). Does not synchronise.
int multi_bilstm_bwd_launch(int n_dirs, const void* const* dh,
                            const void* const* g, const void* const* c,
                            const void* const* w, void* const* dx,
                            int resid_bf16, const int* hs, const int* w_bf16,
                            int T, int B, int device, void* stream) {
  if (n_dirs < 1 || n_dirs > kMaxDirs || T < 1 || B < 1) {
    return cudaErrorInvalidValue;
  }
  Dir dirs[kMaxDirs] = {};
  int max_h = 0;
  bool any_bf16 = false;
  for (int i = 0; i < n_dirs; ++i) {
    any_bf16 = any_bf16 || (w_bf16 != nullptr && w_bf16[i] != 0);
    if (hs[i] < 1 || hs[i] > kMaxH) return cudaErrorInvalidValue;
    dirs[i] = Dir{static_cast<const float*>(dh[i]),
                  static_cast<const float*>(g[i]),
                  static_cast<const float*>(c[i]),
                  static_cast<const float*>(w[i]), static_cast<float*>(dx[i]),
                  hs[i]};
    if (hs[i] > max_h) max_h = hs[i];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  using resid::bf16;
  if (max_h > lane_bwd::kLaneMaxH) {
    Params p{};
    for (int i = 0; i < n_dirs; ++i) {
      p.d[i] = dirs[i];
      p.w_bf16[i] = w_bf16 != nullptr && w_bf16[i] != 0;
    }
    p.T = T;
    p.B = B;
    p.tiles = (B + kBatchTile - 1) / kBatchTile;
    const size_t smem =
        (static_cast<size_t>(4 * max_h) * max_h +
         static_cast<size_t>(kBatchTile) * 4 * max_h +
         2 * static_cast<size_t>(kBatchTile) * max_h) * sizeof(float);
    auto block =
        any_bf16 ? (resid_bf16 ? multi_bilstm_bwd_kernel<bf16, bf16>
                               : multi_bilstm_bwd_kernel<float, bf16>)
                 : (resid_bf16 ? multi_bilstm_bwd_kernel<bf16>
                               : multi_bilstm_bwd_kernel<float>);
    err = cudaFuncSetAttribute(block,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    block<<<n_dirs * p.tiles, kThreads, smem, s>>>(p);
    return cudaGetLastError();
  }
  LaneParams p{};
  int blocks = 0;
  int max_l = 1;
  for (int i = 0; i < n_dirs; ++i) {
    int L = 1;
    while (L < hs[i]) L *= 2;
    const int rows = lane_bwd::kThreads / L;  // rows a block
    const Dir& d = dirs[i];
    p.d[i] = lane_bwd::Dir{d.dh, d.g, d.c, d.w, d.dx, d.H};
    p.w_bf16[i] = w_bf16 != nullptr && w_bf16[i] != 0;
    p.L[i] = L;
    p.first[i] = blocks;
    blocks += (B + rows - 1) / rows;
    if (L > max_l) max_l = L;
  }
  p.n_dirs = n_dirs;
  p.T = T;
  p.B = B;
  const size_t smem = sizeof(float4) * lane_bwd::smem_float4s(max_l);
  auto kernel =
      any_bf16 ? (resid_bf16 ? multi_bilstm_bwd_lane_kernel<bf16, bf16>
                             : multi_bilstm_bwd_lane_kernel<float, bf16>)
               : (resid_bf16 ? multi_bilstm_bwd_lane_kernel<bf16>
                             : multi_bilstm_bwd_lane_kernel<float>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, lane_bwd::kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

const char* multi_bilstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef MULTI_BILSTM_BWD_PROBE
// Cycles and laps of each phase of the lane plan since the last reset,
// summed over warps: [kMaxDirs][lane_bwd::kPhases] each.
int multi_bilstm_bwd_probe_read(unsigned long long* cycles,
                                unsigned long long* laps, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_probe_cycles,
                                         sizeof(g_probe_cycles));
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(laps, g_probe_laps, sizeof(g_probe_laps));
  }
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kMaxDirs * lane_bwd::kPhases] = {};
    err = cudaMemcpyToSymbol(g_probe_cycles, zero, sizeof(zero));
    if (err == cudaSuccess) {
      err = cudaMemcpyToSymbol(g_probe_laps, zero, sizeof(zero));
    }
  }
  return err;
}
#endif

}  // extern "C"
