// N independent bidirectional LSTMs of mixed widths in one launch, the
// gradient recurrence, float32.
//
// Replaces: speechsplit_tpu/ops/pallas_multilstm.py::_bwd_kernel (wrapper
// _bwd_call), the TPU kernel that runs the gate-gradient recurrences of
// the 2N narrow encoder directions in one grid. Per cell it is
// pallas_lstm._cell_bwd (see csrc/bilstm_bwd.cu for the formulas), with the
// dh and dc carries float32 from zero. Directions are ordered
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
// the 192 dependent steps costs its synchronisation and the latency of
// its residual loads. The directions are independent of each other.
//
// What the design does about it: one block per (direction, batch tile of
// up to 8 rows). A block keeps its direction's W_hh (at most 256 x 64
// floats, 64 KB) and its rows' d_pre, dh carry and dc carry in shared
// memory, and walks the T steps with only __syncthreads(): one pass
// applies the cell gradient per (row, unit) and writes d_pre, a second
// forms the next dh carry as d_pre W_hh. No grid barrier, no global
// exchange; all 2N directions run at once in one launch.

#include <cuda_runtime.h>

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

struct Params {
  Dir d[kMaxDirs];
  int T;
  int B;
  int tiles;
};

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

  float* w_s = smem;                   // [G][H], as w
  float* dp_s = w_s + G * H;           // [nb][G] this step's d_pre
  float* dh_s = dp_s + kBatchTile * G; // [nb][H] dh carry
  float* dc_s = dh_s + kBatchTile * H; // [nb][H] dc carry

  for (int i = threadIdx.x; i < G * H; i += blockDim.x) w_s[i] = d.w[i];
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
      const float* g = d.g + (row0 + b) * G;
      const float i_g = g[u], f_g = g[H + u], g_g = g[2 * H + u],
                  o_g = g[3 * H + u];
      const float tanh_c = tanhf(d.c[row0 * H + i]);
      const float c_prev =
          has_cp ? d.c[(static_cast<size_t>(tc) * B + b0) * H + i] : 0.0f;
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
      for (int j = 0; j < G; ++j) acc = fmaf(dp[j], w_s[j * H + k], acc);
      dh_s[i] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// dh, g, c, w, dx: n_dirs device pointers each; hs: n_dirs widths.
// Returns a cudaError_t (0 on success). Does not synchronise.
int multi_bilstm_bwd_launch(int n_dirs, const void* const* dh,
                            const void* const* g, const void* const* c,
                            const void* const* w, void* const* dx,
                            const int* hs, int T, int B, int device,
                            void* stream) {
  if (n_dirs < 1 || n_dirs > kMaxDirs || T < 1 || B < 1) {
    return cudaErrorInvalidValue;
  }
  Params p{};
  int max_h = 0;
  for (int i = 0; i < n_dirs; ++i) {
    if (hs[i] < 1 || hs[i] > kMaxH) return cudaErrorInvalidValue;
    p.d[i] = Dir{static_cast<const float*>(dh[i]),
                 static_cast<const float*>(g[i]),
                 static_cast<const float*>(c[i]),
                 static_cast<const float*>(w[i]), static_cast<float*>(dx[i]),
                 hs[i]};
    if (hs[i] > max_h) max_h = hs[i];
  }
  p.T = T;
  p.B = B;
  p.tiles = (B + kBatchTile - 1) / kBatchTile;
  const size_t smem =
      (static_cast<size_t>(4 * max_h) * max_h +
       static_cast<size_t>(kBatchTile) * 4 * max_h +
       2 * static_cast<size_t>(kBatchTile) * max_h) * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(multi_bilstm_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  multi_bilstm_bwd_kernel<<<n_dirs * p.tiles, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

const char* multi_bilstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
