// Merged bidirectional LSTM layer, gradient recurrence, float32.
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
//
// What bounds it on an H100: the recurrence, as in the forward. Step s
// needs all of the previous step's d_pre, because dh_carry of unit k sums
// over all 4H gate rows (column k of W_hh). At H = 512 W_hh is 4 MiB a
// direction, so the steps need a barrier across blocks, and each step
// moves 4x more data between blocks than the forward (d_pre is 4H wide,
// h is H wide). The arithmetic (2*B*4H*H a step) and the HBM bytes (the
// residuals are read once) are small; the time goes to latency.
//
// What the design does about it: it mirrors csrc/bilstm_infer.cu. One
// persistent cooperative launch per layer; blocks split between the two
// directions; each block owns up to 8 hidden units, one warp per unit,
// and keeps that unit's COLUMN of W_hh (4H values, 4H/32 a lane) in
// registers for the whole sequence. Each step a block stages into shared
// memory, in one round of loads, the previous step's d_pre (read back
// from the dx output itself through L2 with __ldcg; tiled over the batch
// when B*4H floats do not fit) and its units' residuals (4 gates, c,
// c_prev, dh_out); a warp forms dh_carry by a butterfly sum, applies the
// cell gradient for its unit with dc_carry kept in shared memory, writes
// its unit's four d_pre values, and all blocks meet at a grid barrier.
// The host side checks occupancy before the cooperative launch and fails
// rather than deadlock when the grid cannot be co-resident.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxUnits = 8;   // hidden units (= warps) per block
constexpr int kBC = 4;         // batch rows per register tile
constexpr int kMaxH = 512;
constexpr int kVals = 8;       // staged per (unit, row): i f g o c c_prev dh
constexpr size_t kSmemBudget = 160 * 1024;
// The kernel takes B rows at width H while the dc carry [units][B] and
// one batch row of the d_pre tile and the staged residuals, 4H + kVals *
// units floats, fit these floats, with units = min(H, kMaxUnits)
// (launch() below). ops/bilstm.py reads the value from this line
// (merged_bidir_fits), so the kernel is the one owner of the limit.
constexpr int kBwdSmemFloats = 40960;
static_assert(kBwdSmemFloats * sizeof(float) == kSmemBudget,
              "kBwdSmemFloats must be the launch's budget");

template <int KPL>  // ceil(4H / 32): W_hh column entries per lane
__global__ void __launch_bounds__(kMaxUnits * 32)
bilstm_bwd_kernel(const float* __restrict__ dh_f,
                  const float* __restrict__ dh_b,
                  const float* __restrict__ g_f,
                  const float* __restrict__ g_b,
                  const float* __restrict__ c_f,
                  const float* __restrict__ c_b,
                  const float* __restrict__ w_f,
                  const float* __restrict__ w_b,
                  float* dx_f, float* dx_b,
                  int T, int B, int H,
                  int blocks_per_dir, int units_per_block, int bt) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* d_s = smem;                        // [bt][4H] previous d_pre tile
  float* dc_s = d_s + bt * G;               // [units_per_block][B] dc carry
  float* v_s = dc_s + units_per_block * B;  // [units_per_block][bt][kVals]
  cg::grid_group grid = cg::this_grid();

  const int dir = blockIdx.x / blocks_per_dir;
  const int blk = blockIdx.x % blocks_per_dir;
  const float* dho = dir == 0 ? dh_f : dh_b;
  const float* gin = dir == 0 ? g_f : g_b;
  const float* cin = dir == 0 ? c_f : c_b;
  const float* w = dir == 0 ? w_f : w_b;
  float* dx = dir == 0 ? dx_f : dx_b;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int u = blk * units_per_block + warp;
  const bool active = warp < units_per_block && u < H;

  // column u of W_hh, rows j = lane + 32 m
  float wc[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int j = lane + 32 * m;
    wc[m] = (active && j < G) ? w[static_cast<size_t>(j) * H + u] : 0.0f;
  }
  for (int i = threadIdx.x; i < units_per_block * B; i += blockDim.x) {
    dc_s[i] = 0.0f;
  }

  for (int s = 0; s < T; ++s) {
    // forward direction: gradient walks T-1 -> 0; backward: 0 -> T-1
    const int t = dir == 0 ? T - 1 - s : s;
    const int tp = dir == 0 ? t + 1 : t - 1;  // previous step's time index
    const int tc = dir == 0 ? t - 1 : t + 1;  // c_prev's time index
    const bool has_cp = tc >= 0 && tc < T;
    for (int b0 = 0; b0 < B; b0 += bt) {
      const int nb = min(bt, B - b0);
      __syncthreads();  // the previous tile's readers are done with smem
      // this tile's residuals of the block's units, gathered once per step
      for (int i = threadIdx.x; i < units_per_block * nb * 7;
           i += blockDim.x) {
        const int w_i = i / (nb * 7);
        const int bb = (i / 7) % nb;
        const int k = i % 7;
        const int u_i = blk * units_per_block + w_i;
        float v = 0.0f;
        if (u_i < H) {
          const size_t row = static_cast<size_t>(t) * B + b0 + bb;
          if (k < 4) {
            v = gin[row * G + k * H + u_i];
          } else if (k == 4) {
            v = cin[row * H + u_i];
          } else if (k == 5) {
            v = has_cp
                    ? cin[(static_cast<size_t>(tc) * B + b0 + bb) * H + u_i]
                    : 0.0f;
          } else {
            v = dho[row * H + u_i];
          }
        }
        v_s[(w_i * bt + bb) * kVals + k] = v;
      }
      if (s > 0) {
        // written by other blocks during the kernel: read through L2
        const float4* src4 = reinterpret_cast<const float4*>(
            dx + (static_cast<size_t>(tp) * B + b0) * G);
        float4* dst4 = reinterpret_cast<float4*>(d_s);
        for (int i = threadIdx.x; i < nb * G / 4; i += blockDim.x) {
          dst4[i] = __ldcg(src4 + i);
        }
      } else {
        for (int i = threadIdx.x; i < nb * G; i += blockDim.x) {
          d_s[i] = 0.0f;
        }
      }
      __syncthreads();
      if (!active) continue;  // warp-uniform
      for (int bc = 0; bc < nb; bc += kBC) {
        float acc[kBC];
#pragma unroll
        for (int r = 0; r < kBC; ++r) acc[r] = 0.0f;
#pragma unroll
        for (int m = 0; m < KPL; ++m) {
          const int j = lane + 32 * m;
          if (j < G) {
#pragma unroll
            for (int r = 0; r < kBC; ++r) {
              const float dv = (bc + r < nb) ? d_s[(bc + r) * G + j] : 0.0f;
              acc[r] = fmaf(dv, wc[m], acc[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kBC; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
          }
        }
        // lane r < kBC finishes batch row b0 + bc + r of unit u
        float dh_carry = acc[0];
#pragma unroll
        for (int r = 1; r < kBC; ++r) {
          if (lane == r) dh_carry = acc[r];
        }
        if (lane < kBC && bc + lane < nb) {
          const int b = b0 + bc + lane;
          const float* v = v_s + (warp * bt + bc + lane) * kVals;
          const float i_g = v[0], f_g = v[1], g_g = v[2], o_g = v[3];
          const float tanh_c = tanhf(v[4]);
          const float dh = v[6] + dh_carry;
          const float d_o = dh * tanh_c;
          float* dcp = dc_s + warp * B + b;
          const float dc = *dcp + dh * o_g * (1.0f - tanh_c * tanh_c);
          float* out = dx + (static_cast<size_t>(t) * B + b) * G;
          out[u] = dc * g_g * i_g * (1.0f - i_g);
          out[H + u] = dc * v[5] * f_g * (1.0f - f_g);
          out[2 * H + u] = dc * i_g * (1.0f - g_g * g_g);
          out[3 * H + u] = d_o * o_g * (1.0f - o_g);
          *dcp = dc * f_g;
        }
      }
    }
    grid.sync();
  }
}

template <int KPL>
cudaError_t launch(const float* dh_f, const float* dh_b, const float* g_f,
                   const float* g_b, const float* c_f, const float* c_b,
                   const float* w_f, const float* w_b, float* dx_f,
                   float* dx_b, int T, int B, int H, cudaStream_t stream) {
  auto kernel = bilstm_bwd_kernel<KPL>;
  const int units = H < kMaxUnits ? H : kMaxUnits;
  const int blocks_per_dir = (H + units - 1) / units;
  const int threads = units * 32;
  // dc carry [units][B], then per batch row of a tile: the previous d_pre
  // [4H] and the units' staged residuals [units][kVals]
  const size_t c_bytes = static_cast<size_t>(units) * B * sizeof(float);
  const size_t row_bytes =
      static_cast<size_t>(4 * H + kVals * units) * sizeof(float);
  if (c_bytes + row_bytes > kSmemBudget) {
    return cudaErrorInvalidValue;  // batch too large for the dc carry
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
  void* args[] = {&dh_f, &dh_b, &g_f, &g_b, &c_f, &c_b, &w_f, &w_b,
                  &dx_f, &dx_b, &T, &B, &H,
                  const_cast<int*>(&blocks_per_dir),
                  const_cast<int*>(&units), &bt};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Does not synchronise.
int bilstm_bwd_launch(const void* dh_f, const void* dh_b, const void* g_f,
                      const void* g_b, const void* c_f, const void* c_b,
                      const void* w_f, const void* w_b, void* dx_f,
                      void* dx_b, int T, int B, int H, int device,
                      void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxH) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(dh_f);
  auto b = static_cast<const float*>(dh_b);
  auto gf = static_cast<const float*>(g_f);
  auto gb = static_cast<const float*>(g_b);
  auto cf = static_cast<const float*>(c_f);
  auto cb = static_cast<const float*>(c_b);
  auto wf = static_cast<const float*>(w_f);
  auto wb = static_cast<const float*>(w_b);
  auto xf = static_cast<float*>(dx_f);
  auto xb = static_cast<float*>(dx_b);
  const int kpl = (4 * H + 31) / 32;
  if (kpl <= 1) return launch<1>(a, b, gf, gb, cf, cb, wf, wb, xf, xb, T, B, H, s);
  if (kpl <= 2) return launch<2>(a, b, gf, gb, cf, cb, wf, wb, xf, xb, T, B, H, s);
  if (kpl <= 4) return launch<4>(a, b, gf, gb, cf, cb, wf, wb, xf, xb, T, B, H, s);
  if (kpl <= 8) return launch<8>(a, b, gf, gb, cf, cb, wf, wb, xf, xb, T, B, H, s);
  if (kpl <= 16) return launch<16>(a, b, gf, gb, cf, cb, wf, wb, xf, xb, T, B, H, s);
  if (kpl <= 32) return launch<32>(a, b, gf, gb, cf, cb, wf, wb, xf, xb, T, B, H, s);
  return launch<64>(a, b, gf, gb, cf, cb, wf, wb, xf, xb, T, B, H, s);
}

const char* bilstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
