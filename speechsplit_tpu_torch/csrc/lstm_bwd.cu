// One direction of one LSTM layer, gradient recurrence, float32.
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
// What bounds it on an H100: the recurrence, as in the merged kernel
// (csrc/bilstm_bwd.cu). Step s needs all of the previous step's d_pre,
// because dh_carry of unit k sums over all 4H gate rows (column k of
// W_hh). At H = 512 W_hh is 4 MiB, so the steps need a barrier across
// blocks, and each step moves d_pre, 4H wide, between blocks. The
// arithmetic (2*B*4H*H a step) and the HBM bytes (the residuals are read
// once) are small at small batches; the time goes to latency.
//
// What the design does about it: the merged kernel's recurrence for one
// direction, with csrc/lstm_infer.cu's launch plan: units = ceil(H / 128)
// hidden units a block (4 at H = 512, 128 blocks), one warp a unit, which
// keeps that unit's COLUMN of W_hh (4H values, 4H/32 a lane) in registers
// for the whole sequence. Each step a block stages into shared memory the
// previous step's d_pre (read back from the dx output itself through L2;
// tiled over the batch when the rows do not fit beside the dc carry) and
// its units' residuals (4 gates, c, c_prev, dh_out); a warp forms
// dh_carry by a butterfly sum, applies the cell gradient for its unit
// with dc_carry [units][B] kept in shared memory, writes its unit's four
// d_pre values, and all blocks meet at a grid barrier. The host side
// checks occupancy before the cooperative launch and fails rather than
// deadlock when the grid cannot be co-resident.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxUnits = 4;    // hidden units (= warps) per block, at most
constexpr int kBC = 4;          // batch rows per register tile
constexpr int kMaxH = 512;
constexpr int kPlanSms = 128;   // the plan spreads H over this many blocks
constexpr int kVals = 8;        // staged per (unit, row): i f g o c c_prev dh
constexpr size_t kSmemBudget = 220 * 1024;

// The launch plan's units a block: ceil(H / kPlanSms), 1 .. kMaxUnits.
constexpr int plan_units(int H) { return (H + kPlanSms - 1) / kPlanSms; }

// Shared memory of a block: the dc carry [units][B], then per batch row
// of a tile the previous d_pre [4H] and the units' residuals
// [units][kVals].
constexpr size_t carry_bytes(int units, int B) {
  return static_cast<size_t>(units) * B * sizeof(float);
}
constexpr size_t row_bytes(int units, int H) {
  return static_cast<size_t>(4 * H + kVals * units) * sizeof(float);
}

// The largest batch the kernel takes, at every H <= kMaxH (see
// csrc/lstm_infer.cu). ops/lstm.py reads the value from this line.
constexpr int kMaxBatch = 13560;
static_assert(plan_units(kMaxH) == kMaxUnits, "the plan's widest block");
static_assert(carry_bytes(kMaxUnits, kMaxBatch) +
                      row_bytes(kMaxUnits, kMaxH) <= kSmemBudget &&
                  carry_bytes(kMaxUnits, kMaxBatch + 1) +
                          row_bytes(kMaxUnits, kMaxH) > kSmemBudget,
              "kMaxBatch must be the largest batch the plan holds");

template <int KPL>  // ceil(4H / 32): W_hh column entries per lane
__global__ void __launch_bounds__(kMaxUnits * 32)
lstm_bwd_kernel(const float* __restrict__ dh, const float* __restrict__ g,
                const float* __restrict__ c, const float* __restrict__ w,
                float* dx, int T, int B, int H, int reverse, int units,
                int bt) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* d_s = smem;                 // [bt][4H] previous d_pre tile
  float* dc_s = d_s + bt * G;        // [units][B] dc carry
  float* v_s = dc_s + units * B;     // [units][bt][kVals]
  cg::grid_group grid = cg::this_grid();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * units + warp;
  const bool active = warp < units && u < H;

  // column u of W_hh, rows j = lane + 32 m
  float wc[KPL];
#pragma unroll
  for (int m = 0; m < KPL; ++m) {
    const int j = lane + 32 * m;
    wc[m] = (active && j < G) ? w[static_cast<size_t>(j) * H + u] : 0.0f;
  }
  for (int i = threadIdx.x; i < units * B; i += blockDim.x) dc_s[i] = 0.0f;

  for (int s = 0; s < T; ++s) {
    // forward direction: gradient walks T-1 -> 0; reverse: 0 -> T-1
    const int t = reverse ? s : T - 1 - s;
    const int tp = reverse ? t - 1 : t + 1;  // previous step's time index
    const int tc = reverse ? t + 1 : t - 1;  // c_prev's time index
    const bool has_cp = tc >= 0 && tc < T;
    for (int b0 = 0; b0 < B; b0 += bt) {
      const int nb = min(bt, B - b0);
      __syncthreads();  // the previous tile's readers are done with smem
      // this tile's residuals of the block's units, gathered once per step
      for (int i = threadIdx.x; i < units * nb * 7; i += blockDim.x) {
        const int w_i = i / (nb * 7);
        const int bb = (i / 7) % nb;
        const int k = i % 7;
        const int u_i = blockIdx.x * units + w_i;
        float v = 0.0f;
        if (u_i < H) {
          const size_t row = static_cast<size_t>(t) * B + b0 + bb;
          if (k < 4) {
            v = g[row * G + k * H + u_i];
          } else if (k == 4) {
            v = c[row * H + u_i];
          } else if (k == 5) {
            v = has_cp ? c[(static_cast<size_t>(tc) * B + b0 + bb) * H + u_i]
                       : 0.0f;
          } else {
            v = dh[row * H + u_i];
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
        for (int i = threadIdx.x; i < nb * G; i += blockDim.x) d_s[i] = 0.0f;
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
          const float d = v[6] + dh_carry;
          const float d_o = d * tanh_c;
          float* dcp = dc_s + warp * B + b;
          // every product and sum rounded on its own, in the plain
          // version's order (no FMA contraction)
          const float dc = __fadd_rn(
              *dcp, __fmul_rn(d * o_g,
                              __fsub_rn(1.0f, __fmul_rn(tanh_c, tanh_c))));
          float* out = dx + (static_cast<size_t>(t) * B + b) * G;
          out[u] = dc * g_g * i_g * (1.0f - i_g);
          out[H + u] = dc * v[5] * f_g * (1.0f - f_g);
          out[2 * H + u] =
              dc * i_g * __fsub_rn(1.0f, __fmul_rn(g_g, g_g));
          out[3 * H + u] = d_o * o_g * (1.0f - o_g);
          *dcp = dc * f_g;
        }
      }
    }
    grid.sync();
  }
}

template <int KPL>
cudaError_t launch(const float* dh, const float* g, const float* c,
                   const float* w, float* dx, int T, int B, int H,
                   int reverse, cudaStream_t stream) {
  auto kernel = lstm_bwd_kernel<KPL>;
  int units = plan_units(H);
  const int blocks = (H + units - 1) / units;
  const int threads = units * 32;
  const size_t c_b = carry_bytes(units, B);
  const size_t r_b = row_bytes(units, H);
  if (c_b + r_b > kSmemBudget) {
    return cudaErrorInvalidValue;  // batch too large for the dc carry
  }
  int bt = static_cast<int>((kSmemBudget - c_b) / r_b);
  if (bt > B) bt = B;
  const size_t smem = c_b + static_cast<size_t>(bt) * r_b;
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
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&dh, &g, &c, &w, &dx, &T, &B, &H, &reverse, &units, &bt};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The gradient recurrence of one direction; reverse != 0 for a direction
// whose forward walked T-1 -> 0. Returns a cudaError_t (0 on success).
// Does not synchronise.
int lstm_bwd_launch(const void* dh, const void* g, const void* c,
                    const void* w, void* dx, int T, int B, int H, int reverse,
                    int device, void* stream) {
  if (T < 1 || B < 1 || B > kMaxBatch || H < 1 || H > kMaxH) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(dh);
  auto gg = static_cast<const float*>(g);
  auto cc = static_cast<const float*>(c);
  auto ww = static_cast<const float*>(w);
  auto out = static_cast<float*>(dx);
  const int r = reverse ? 1 : 0;
  const int kpl = (4 * H + 31) / 32;
  if (kpl <= 1) return launch<1>(a, gg, cc, ww, out, T, B, H, r, s);
  if (kpl <= 2) return launch<2>(a, gg, cc, ww, out, T, B, H, r, s);
  if (kpl <= 4) return launch<4>(a, gg, cc, ww, out, T, B, H, r, s);
  if (kpl <= 8) return launch<8>(a, gg, cc, ww, out, T, B, H, r, s);
  if (kpl <= 16) return launch<16>(a, gg, cc, ww, out, T, B, H, r, s);
  if (kpl <= 32) return launch<32>(a, gg, cc, ww, out, T, B, H, r, s);
  return launch<64>(a, gg, cc, ww, out, T, B, H, r, s);
}

const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
