// N independent bidirectional LSTMs of mixed widths in one launch, float32
// forward: the lean forward (h only) and the residual-saving forward of
// training, one kernel body.
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
// i, f, g, o after their activations) and c [T, B, H_d].
//
// What bounds it on an H100: latency. The widths are tiny (4H <= 128), so
// a step is a few thousand multiply-adds and the 192 dependent steps of a
// direction cost their synchronisation and memory latency, not bytes or
// arithmetic. The directions are independent of each other.
//
// What the design does about it: one block per (direction, batch tile of
// up to 8 rows). A block keeps its direction's W_hh (at most 64 x 256
// floats, 64 KB) transposed in shared memory, and h and c of its rows in
// shared memory, and walks the T steps with only __syncthreads(): no grid
// barrier and no global exchange. All directions of all N streams run at
// once in one launch, so the group costs about one stream's latency.
// Per-direction pointers and widths travel in a small descriptor passed
// by value. The residual-saving forward adds five stores a cell; the lean
// instantiation compiles without them.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDirs = 8;
constexpr int kMaxH = 64;
constexpr int kBatchTile = 8;
constexpr int kThreads = 256;

struct Dir {
  const float* xp;
  const float* w;
  float* h;
  float* g;  // residual-saving forward only
  float* c;
  int H;
};

struct Params {
  Dir d[kMaxDirs];
  int T;
  int B;
  int tiles;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kResid>
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

  float* w_s = smem;                  // [H][G]: w_s[k*G + j] = w[j*H + k]
  float* h_s = w_s + H * G;           // [nb][H]
  float* c_s = h_s + kBatchTile * H;  // [nb][H]
  float* g_s = c_s + kBatchTile * H;  // [nb][G] pre-activations

  for (int i = threadIdx.x; i < H * G; i += blockDim.x) {
    const int j = i / H;
    const int k = i % H;
    w_s[k * G + j] = d.w[i];
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
      h_s[i] = h_new;
      out[i] = h_new;
      if constexpr (kResid) {
        float* gr = d.g + (static_cast<size_t>(t) * B + b0 + b) * G;
        gr[u] = i_g;
        gr[H + u] = f_g;
        gr[2 * H + u] = g_g;
        gr[3 * H + u] = o_g;
        d.c[(static_cast<size_t>(t) * B + b0) * H + i] = c_new;
      }
    }
    __syncthreads();
  }
}

template <bool kResid>
int dispatch(int n_dirs, const void* const* xp, const void* const* w,
             void* const* h, void* const* g, void* const* c, const int* hs,
             int T, int B, int device, void* stream) {
  if (n_dirs < 1 || n_dirs > kMaxDirs || T < 1 || B < 1) {
    return cudaErrorInvalidValue;
  }
  Params p{};
  int max_h = 0;
  for (int i = 0; i < n_dirs; ++i) {
    if (hs[i] < 1 || hs[i] > kMaxH) return cudaErrorInvalidValue;
    p.d[i] = Dir{static_cast<const float*>(xp[i]),
                 static_cast<const float*>(w[i]), static_cast<float*>(h[i]),
                 kResid ? static_cast<float*>(g[i]) : nullptr,
                 kResid ? static_cast<float*>(c[i]) : nullptr, hs[i]};
    if (hs[i] > max_h) max_h = hs[i];
  }
  p.T = T;
  p.B = B;
  p.tiles = (B + kBatchTile - 1) / kBatchTile;
  const size_t smem =
      (static_cast<size_t>(max_h) * 4 * max_h +
       2 * static_cast<size_t>(kBatchTile) * max_h +
       static_cast<size_t>(kBatchTile) * 4 * max_h) * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(multi_bilstm_infer_kernel<kResid>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  multi_bilstm_infer_kernel<kResid><<<n_dirs * p.tiles, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lean forward. xp, w, h: n_dirs device pointers each; hs: n_dirs widths.
// Returns a cudaError_t (0 on success). Does not synchronise.
int multi_bilstm_infer_launch(int n_dirs, const void* const* xp,
                              const void* const* w, void* const* h,
                              const int* hs, int T, int B, int device,
                              void* stream) {
  return dispatch<false>(n_dirs, xp, w, h, nullptr, nullptr, hs, T, B,
                         device, stream);
}

// Residual-saving forward: as above, and g [T, B, 4H_d], c [T, B, H_d]
// per direction.
int multi_bilstm_fwd_launch(int n_dirs, const void* const* xp,
                            const void* const* w, void* const* h,
                            void* const* g, void* const* c, const int* hs,
                            int T, int B, int device, void* stream) {
  return dispatch<true>(n_dirs, xp, w, h, g, c, hs, T, B, device, stream);
}

const char* multi_bilstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
