// Merged bidirectional LSTM layer forward, float32: the lean forward
// (h only) and the residual-saving forward of training, one kernel body.
//
// Replaces: speechsplit_tpu/ops/pallas_lstm.py::_bd_infer_kernel (wrapper
// _bd_infer), the TPU kernel that runs both directions of one BiLSTM layer
// in one grid, and, with kResid, ::_bd_fwd_kernel (wrapper _bd_fwd), which
// also writes each step's post-activation gates and cell state for the
// backward (csrc/bilstm_bwd.cu). Same math as pallas_lstm._cell: gates =
// xp + h_{t-1} W_hh^T ordered i, f, g, o; sigmoid/sigmoid/tanh/sigmoid;
// c = f c + i g; h = o tanh(c); state float32 from zero. The backward
// direction walks T-1 -> 0 over inputs and outputs kept in real time order.
//
// Layouts: xp_f, xp_b [T, B, 4H] (time-major, real time order); w_f, w_b
// [4H, H] (torch's weight_hh_l{k}: row g*H + u holds gate g of unit u);
// h_f, h_b [T, B, H]; with kResid also g_f, g_b [T, B, 4H] (the gates
// i, f, g, o after their activations) and c_f, c_b [T, B, H].
//
// What bounds it on an H100: the recurrence. Step t needs all of h_{t-1},
// so the T steps are serial and each is a small [B, H] x [H, 4H] product
// followed by a cell update. At the mel decoder's H = 512, W_hh is 4 MiB a
// direction, far more than one SM's 227 KB of shared memory, so one block
// cannot hold a direction and the steps need a barrier across blocks. The
// per-step work is small (2*B*H*4H flops), so the time goes to latency:
// the grid-wide barrier and the reload of h_{t-1}, not to bytes from HBM
// (W is read once) or to arithmetic.
//
// What the design does about it: one persistent cooperative launch per
// layer. Blocks are split between the two directions; each block owns up
// to 8 hidden units, one warp per unit, and keeps that unit's four gate
// rows of W_hh in registers for the whole sequence (4 * H/32 floats a
// lane), so W is read from HBM once. A lane owns the k = lane + 32 j
// slice of the dot products; a warp butterfly sums the slices, and the
// cell update of unit u stays inside its warp, so c never leaves the
// block. Each step a block stages into shared memory, in one round of
// loads whose latencies overlap, its units' gate inputs xp[t] and its
// direction's h_{t-1} (read from the output array itself, written by
// every block in the step before), tiled over the batch when B*H floats
// do not fit; then all blocks meet at a grid-wide barrier (cooperative
// groups). The
// launch is cooperative, so it fails rather than deadlocks when the grid
// cannot be co-resident; the host side checks occupancy first and says so.
// The residual-saving forward is the same kernel with five more stores a
// cell (g and c), made by the lane that already holds the values; the
// lean instantiation compiles without them. Making it fast (wgmma on the
// step product, clusters with distributed shared memory in place of the
// grid barrier) is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxUnits = 8;   // hidden units (= warps) per block
constexpr int kBC = 4;         // batch rows per register tile
constexpr int kMaxH = 512;
constexpr size_t kSmemBudget = 160 * 1024;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int KPL, bool kResid>
__global__ void __launch_bounds__(kMaxUnits * 32)
bilstm_infer_kernel(const float* __restrict__ xp_f,
                    const float* __restrict__ xp_b,
                    const float* __restrict__ w_f,
                    const float* __restrict__ w_b,
                    float* h_f, float* h_b,
                    float* __restrict__ g_f, float* __restrict__ g_b,
                    float* __restrict__ c_f, float* __restrict__ c_b,
                    int T, int B, int H,
                    int blocks_per_dir, int units_per_block, int bt) {
  extern __shared__ float smem[];
  float* h_s = smem;                       // [bt][H] tile of h_{t-1}
  float* c_s = h_s + bt * H;               // [units_per_block][B] cell state
  float* x_s = c_s + units_per_block * B;  // [units_per_block][bt][4] xp
  cg::grid_group grid = cg::this_grid();

  const int dir = blockIdx.x / blocks_per_dir;
  const int blk = blockIdx.x % blocks_per_dir;
  const float* xp = dir == 0 ? xp_f : xp_b;
  const float* w = dir == 0 ? w_f : w_b;
  float* hout = dir == 0 ? h_f : h_b;
  float* gout = dir == 0 ? g_f : g_b;
  float* cout = dir == 0 ? c_f : c_b;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int u = blk * units_per_block + warp;
  const bool active = warp < units_per_block && u < H;

  // this warp's four gate rows of W_hh, k = lane + 32 j
  float wr[4][KPL];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int k = lane + 32 * j;
      wr[g][j] = (active && k < H)
                     ? w[static_cast<size_t>(g * H + u) * H + k]
                     : 0.0f;
    }
  }
  for (int i = threadIdx.x; i < units_per_block * B; i += blockDim.x) {
    c_s[i] = 0.0f;
  }

  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? s : T - 1 - s;
    const int tp = dir == 0 ? t - 1 : t + 1;  // previous step's time index
    for (int b0 = 0; b0 < B; b0 += bt) {
      const int nb = min(bt, B - b0);
      __syncthreads();  // the previous tile's readers are done with smem
      // this tile's gate inputs of the block's units, gathered once per
      // step so the cell updates below do not each wait on global memory
      for (int i = threadIdx.x; i < units_per_block * nb * 4;
           i += blockDim.x) {
        const int w_i = i / (nb * 4);
        const int bb = (i / 4) % nb;
        const int g = i % 4;
        const int u_i = blk * units_per_block + w_i;
        x_s[(w_i * bt + bb) * 4 + g] =
            u_i < H ? xp[(static_cast<size_t>(t) * B + b0 + bb) * 4 * H +
                         g * H + u_i]
                    : 0.0f;
      }
      if (s > 0) {
        // written by other blocks during the kernel: read through L2
        const float* src = hout + (static_cast<size_t>(tp) * B + b0) * H;
        if ((H & 3) == 0) {
          const float4* src4 = reinterpret_cast<const float4*>(src);
          float4* dst4 = reinterpret_cast<float4*>(h_s);
          for (int i = threadIdx.x; i < nb * H / 4; i += blockDim.x) {
            dst4[i] = __ldcg(src4 + i);
          }
        } else {
          for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
            h_s[i] = __ldcg(src + i);
          }
        }
      } else {
        for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
          h_s[i] = 0.0f;
        }
      }
      __syncthreads();
      if (!active) continue;  // warp-uniform
      for (int bc = 0; bc < nb; bc += kBC) {
        float acc[kBC][4];
#pragma unroll
        for (int r = 0; r < kBC; ++r) {
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int k = lane + 32 * j;
          if (k < H) {
#pragma unroll
            for (int r = 0; r < kBC; ++r) {
              const float hv = (bc + r < nb) ? h_s[(bc + r) * H + k] : 0.0f;
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                acc[r][g] = fmaf(hv, wr[g][j], acc[r][g]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kBC; ++r) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              acc[r][g] += __shfl_xor_sync(0xffffffffu, acc[r][g], off);
            }
          }
        }
        // lane r < kBC finishes batch row b0 + bc + r of unit u
        float gi = acc[0][0], gf = acc[0][1], gg = acc[0][2], go = acc[0][3];
#pragma unroll
        for (int r = 1; r < kBC; ++r) {
          if (lane == r) {
            gi = acc[r][0];
            gf = acc[r][1];
            gg = acc[r][2];
            go = acc[r][3];
          }
        }
        if (lane < kBC && bc + lane < nb) {
          const int b = b0 + bc + lane;
          const float* x = x_s + (warp * bt + bc + lane) * 4;
          const float i_g = sigmoid_f(x[0] + gi);
          const float f_g = sigmoid_f(x[1] + gf);
          const float g_g = tanhf(x[2] + gg);
          const float o_g = sigmoid_f(x[3] + go);
          float* c = c_s + warp * B + b;
          const float c_new = f_g * *c + i_g * g_g;
          *c = c_new;
          const size_t row = static_cast<size_t>(t) * B + b;
          hout[row * H + u] = o_g * tanhf(c_new);
          if constexpr (kResid) {
            float* gr = gout + row * 4 * H;
            gr[u] = i_g;
            gr[H + u] = f_g;
            gr[2 * H + u] = g_g;
            gr[3 * H + u] = o_g;
            cout[row * H + u] = c_new;
          }
        }
      }
    }
    grid.sync();
  }
}

template <int KPL, bool kResid>
cudaError_t launch(const float* xp_f, const float* xp_b, const float* w_f,
                   const float* w_b, float* h_f, float* h_b, float* g_f,
                   float* g_b, float* c_f, float* c_b, int T, int B, int H,
                   cudaStream_t stream) {
  auto kernel = bilstm_infer_kernel<KPL, kResid>;
  const int units = H < kMaxUnits ? H : kMaxUnits;
  const int blocks_per_dir = (H + units - 1) / units;
  const int threads = units * 32;
  // cell state [units][B], then per batch row of a tile: h_{t-1} [H] and
  // the units' gate inputs [units][4]
  const size_t c_bytes = static_cast<size_t>(units) * B * sizeof(float);
  const size_t row_bytes = static_cast<size_t>(H + 4 * units) * sizeof(float);
  if (c_bytes + row_bytes > kSmemBudget) {
    return cudaErrorInvalidValue;  // batch too large for the cell state
  }
  int bt = static_cast<int>((kSmemBudget - c_bytes) / row_bytes);
  if (bt > B) bt = B;
  const size_t smem = c_bytes + static_cast<size_t>(bt) * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    device)) != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess) return err;
  const int grid = 2 * blocks_per_dir;
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&xp_f, &xp_b, &w_f, &w_b, &h_f, &h_b, &g_f, &g_b, &c_f,
                  &c_b, &T, &B, &H,
                  const_cast<int*>(&blocks_per_dir),
                  const_cast<int*>(&units), &bt};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kResid>
int dispatch(const void* xp_f, const void* xp_b, const void* w_f,
             const void* w_b, void* h_f, void* h_b, void* g_f, void* g_b,
             void* c_f, void* c_b, int T, int B, int H, int device,
             void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxH) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(xp_f);
  auto xb = static_cast<const float*>(xp_b);
  auto wf = static_cast<const float*>(w_f);
  auto wb = static_cast<const float*>(w_b);
  auto hf = static_cast<float*>(h_f);
  auto hb = static_cast<float*>(h_b);
  auto gf = static_cast<float*>(g_f);
  auto gb = static_cast<float*>(g_b);
  auto cf = static_cast<float*>(c_f);
  auto cb = static_cast<float*>(c_b);
  const int kpl = (H + 31) / 32;
  if (kpl <= 1)
    return launch<1, kResid>(xf, xb, wf, wb, hf, hb, gf, gb, cf, cb, T, B, H, s);
  if (kpl <= 2)
    return launch<2, kResid>(xf, xb, wf, wb, hf, hb, gf, gb, cf, cb, T, B, H, s);
  if (kpl <= 4)
    return launch<4, kResid>(xf, xb, wf, wb, hf, hb, gf, gb, cf, cb, T, B, H, s);
  if (kpl <= 8)
    return launch<8, kResid>(xf, xb, wf, wb, hf, hb, gf, gb, cf, cb, T, B, H, s);
  return launch<16, kResid>(xf, xb, wf, wb, hf, hb, gf, gb, cf, cb, T, B, H, s);
}

}  // namespace

extern "C" {

// Lean forward. Returns a cudaError_t (0 on success). Does not synchronise.
int bilstm_infer_launch(const void* xp_f, const void* xp_b, const void* w_f,
                        const void* w_b, void* h_f, void* h_b, int T, int B,
                        int H, int device, void* stream) {
  return dispatch<false>(xp_f, xp_b, w_f, w_b, h_f, h_b, nullptr, nullptr,
                         nullptr, nullptr, T, B, H, device, stream);
}

// Residual-saving forward: also writes g_f, g_b [T, B, 4H] and c_f, c_b
// [T, B, H]. Returns a cudaError_t (0 on success). Does not synchronise.
int bilstm_fwd_launch(const void* xp_f, const void* xp_b, const void* w_f,
                      const void* w_b, void* h_f, void* h_b, void* g_f,
                      void* g_b, void* c_f, void* c_b, int T, int B, int H,
                      int device, void* stream) {
  return dispatch<true>(xp_f, xp_b, w_f, w_b, h_f, h_b, g_f, g_b, c_f, c_b,
                        T, B, H, device, stream);
}

const char* bilstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
