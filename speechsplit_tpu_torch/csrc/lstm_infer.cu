// One direction of one LSTM layer, forward, float32: the lean forward (h
// only) and, with kResid, the residual-saving forward of training.
//
// Replaces: speechsplit_tpu/ops/pallas_lstm.py::_infer_kernel (wrapper
// _infer) and, with kResid, ::_fwd_kernel (wrapper _fwd), the TPU kernels
// of lstm_sequence: one direction over a grid of T steps, W_hh resident.
// Same math as pallas_lstm._cell: gates = xp + h_{t-1} W_hh^T ordered
// i, f, g, o; sigmoid/sigmoid/tanh/sigmoid; c = f c + i g; h = o tanh(c);
// state float32 from zero. With reverse the recurrence walks T-1 -> 0 over
// inputs and outputs kept in real time order, as the TPU kernels' index
// maps do (pallas_lstm._sd_maps).
//
// Layouts: xp [T, B, 4H] (time-major, real time order); w [4H, H] (torch's
// weight_hh_l{k}: row g*H + u holds gate g of unit u); h [T, B, H]; with
// kResid also g [T, B, 4H] (the gates i, f, g, o after their activations)
// and c [T, B, H].
//
// What bounds it on an H100: the recurrence, as in the merged kernel
// (csrc/bilstm_infer.cu). Step t needs all of h_{t-1}, so the T steps are
// serial; at H = 512 W_hh is 4 MiB, more than one SM holds, so the steps
// need a barrier across blocks. Each step is a [B, H] x [H, 4H] product
// (2*B*H*4H flops) and a cell update; W is read from HBM once and xp once.
// At the batches this kernel exists for (thousands of rows) the step's
// product is large, and the time goes to the FMAs and to each block's
// reload of h_{t-1} from L2; at small batches, to the barrier's latency.
//
// What the design does about it: the merged kernel's recurrence for one
// direction, with a launch plan of its own. The port runs this kernel
// where the merged kernels cannot hold the batch (ops/bilstm.py::
// merged_bidir_fits) and for LSTM(bidirectional=False). A single direction
// has the card to itself, so the plan gives each block the fewest hidden
// units that keep the grid to one block an SM of a 128-SM card:
// units = ceil(H / 128), 4 at H = 512 (128 blocks), 1 at H <= 128. That
// spreads each step's product over the most SMs and keeps the cell state
// a block holds in shared memory, [units][B], small: at 4 units a block it
// is half the merged kernel's 8, so the kernel takes batches up to
// kMaxBatch (13948 rows at H = 512), beyond the merged kernels' 5052. One
// persistent cooperative launch; one warp a unit, whose four gate rows of
// W_hh stay in registers for the whole sequence (4 * H/32 floats a lane);
// a lane owns the k = lane + 32 j slice of the dot products and a warp
// butterfly sums them, so the cell update of unit u stays in its warp.
// Each step a block stages its units' gate inputs xp[t] and h_{t-1} (read
// back from the output itself, written by every block in the step before,
// through L2), tiled over the batch when the rows do not fit beside the
// cell state; then all blocks meet at a grid barrier. The launch fails
// rather than deadlocks when the grid cannot be co-resident: the host side
// checks occupancy first. The cell update rounds each product and the sum
// on its own, as the plain version's separate ops do, where nvcc would
// contract it into an FMA (the merged kernels let it): given the same
// gates, c agrees with the plain version to the last bit, and with the
// merged kernels to within a few ulps. Making it fast (wgmma on the step
// product, clusters in place of the grid barrier, more warps a block at
// large batches) is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxUnits = 4;    // hidden units (= warps) per block, at most
constexpr int kBC = 4;          // batch rows per register tile
constexpr int kMaxH = 512;
constexpr int kPlanSms = 128;   // the plan spreads H over this many blocks
constexpr size_t kSmemBudget = 220 * 1024;

// The launch plan's units a block: ceil(H / kPlanSms), 1 .. kMaxUnits.
constexpr int plan_units(int H) { return (H + kPlanSms - 1) / kPlanSms; }

// Shared memory of a block: the cell state [units][B], then per batch row
// of a tile h_{t-1} [H] and the units' gate inputs [units][4].
constexpr size_t cell_bytes(int units, int B) {
  return static_cast<size_t>(units) * B * sizeof(float);
}
constexpr size_t row_bytes(int units, int H) {
  return static_cast<size_t>(H + 4 * units) * sizeof(float);
}

// The largest batch the kernels take, at every H <= kMaxH: the cell state
// of plan_units(kMaxH) units and one batch row in kSmemBudget (a narrower
// layer has fewer units a block and shorter rows). ops/lstm.py reads the
// value from this line, so the kernel is the one owner of the limit.
constexpr int kMaxBatch = 13948;
static_assert(plan_units(kMaxH) == kMaxUnits, "the plan's widest block");
static_assert(cell_bytes(kMaxUnits, kMaxBatch) +
                      row_bytes(kMaxUnits, kMaxH) <= kSmemBudget &&
                  cell_bytes(kMaxUnits, kMaxBatch + 1) +
                          row_bytes(kMaxUnits, kMaxH) > kSmemBudget,
              "kMaxBatch must be the largest batch the plan holds");

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int KPL, bool kResid>  // KPL = ceil(H / 32): W_hh entries a lane
__global__ void __launch_bounds__(kMaxUnits * 32)
lstm_infer_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                  float* h, float* __restrict__ g, float* __restrict__ c,
                  int T, int B, int H, int reverse, int units, int bt) {
  extern __shared__ float smem[];
  float* h_s = smem;               // [bt][H], the tile of h_{t-1}
  float* c_s = h_s + bt * H;       // [units][B], the cell state
  float* x_s = c_s + units * B;    // [units][bt][4], the tile's gate inputs
  cg::grid_group grid = cg::this_grid();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * units + warp;
  const bool active = warp < units && u < H;

  // this warp's four gate rows of W_hh, k = lane + 32 j
  float wr[4][KPL];
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int k = lane + 32 * j;
      wr[gi][j] = (active && k < H)
                      ? w[static_cast<size_t>(gi * H + u) * H + k]
                      : 0.0f;
    }
  }
  for (int i = threadIdx.x; i < units * B; i += blockDim.x) c_s[i] = 0.0f;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // previous step's time index
    for (int b0 = 0; b0 < B; b0 += bt) {
      const int nb = min(bt, B - b0);
      __syncthreads();  // the previous tile's readers are done with smem
      // this tile's gate inputs of the block's units, gathered once per
      // step so the cell updates below do not each wait on global memory
      for (int i = threadIdx.x; i < units * nb * 4; i += blockDim.x) {
        const int w_i = i / (nb * 4);
        const int bb = (i / 4) % nb;
        const int gi = i % 4;
        const int u_i = blockIdx.x * units + w_i;
        x_s[(w_i * bt + bb) * 4 + gi] =
            u_i < H ? xp[(static_cast<size_t>(t) * B + b0 + bb) * 4 * H +
                         gi * H + u_i]
                    : 0.0f;
      }
      if (s > 0) {
        // written by other blocks during the kernel: read through L2
        const float* src = h + (static_cast<size_t>(tp) * B + b0) * H;
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
        for (int i = threadIdx.x; i < nb * H; i += blockDim.x) h_s[i] = 0.0f;
      }
      __syncthreads();
      if (!active) continue;  // warp-uniform
      for (int bc = 0; bc < nb; bc += kBC) {
        float acc[kBC][4];
#pragma unroll
        for (int r = 0; r < kBC; ++r) {
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) acc[r][gi] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int k = lane + 32 * j;
          if (k < H) {
#pragma unroll
            for (int r = 0; r < kBC; ++r) {
              const float hv = (bc + r < nb) ? h_s[(bc + r) * H + k] : 0.0f;
#pragma unroll
              for (int gi = 0; gi < 4; ++gi) {
                acc[r][gi] = fmaf(hv, wr[gi][j], acc[r][gi]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kBC; ++r) {
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              acc[r][gi] += __shfl_xor_sync(0xffffffffu, acc[r][gi], off);
            }
          }
        }
        // lane r < kBC finishes batch row b0 + bc + r of unit u
        float a_i = acc[0][0], a_f = acc[0][1], a_g = acc[0][2],
              a_o = acc[0][3];
#pragma unroll
        for (int r = 1; r < kBC; ++r) {
          if (lane == r) {
            a_i = acc[r][0];
            a_f = acc[r][1];
            a_g = acc[r][2];
            a_o = acc[r][3];
          }
        }
        if (lane < kBC && bc + lane < nb) {
          const int b = b0 + bc + lane;
          const float* x = x_s + (warp * bt + bc + lane) * 4;
          const float i_g = sigmoid_f(x[0] + a_i);
          const float f_g = sigmoid_f(x[1] + a_f);
          const float g_g = tanhf(x[2] + a_g);
          const float o_g = sigmoid_f(x[3] + a_o);
          float* cp = c_s + warp * B + b;
          // each product and the sum rounded on its own, as the plain
          // version's separate ops round them (no FMA contraction): given
          // the same gates, c agrees with it to the last bit
          const float c_new =
              __fadd_rn(__fmul_rn(f_g, *cp), __fmul_rn(i_g, g_g));
          *cp = c_new;
          const size_t row = static_cast<size_t>(t) * B + b;
          h[row * H + u] = o_g * tanhf(c_new);
          if constexpr (kResid) {
            float* gr = g + row * 4 * H;
            gr[u] = i_g;
            gr[H + u] = f_g;
            gr[2 * H + u] = g_g;
            gr[3 * H + u] = o_g;
            c[row * H + u] = c_new;
          }
        }
      }
    }
    grid.sync();
  }
}

// Sets the kernel's shared memory, checks that its grid can be
// co-resident, and launches it cooperatively.
template <typename Kernel>
cudaError_t launch_cooperative(Kernel kernel, int grid, int threads,
                               size_t smem, void** args,
                               cudaStream_t stream) {
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
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KPL, bool kResid>
cudaError_t launch(const float* xp, const float* w, float* h, float* g,
                   float* c, int T, int B, int H, int reverse,
                   cudaStream_t stream) {
  int units = plan_units(H);
  const int blocks = (H + units - 1) / units;
  const int threads = units * 32;
  const size_t c_b = cell_bytes(units, B);
  const size_t r_b = row_bytes(units, H);
  if (c_b + r_b > kSmemBudget) {
    return cudaErrorInvalidValue;  // batch too large for the cell state
  }
  int bt = static_cast<int>((kSmemBudget - c_b) / r_b);
  if (bt > B) bt = B;
  const size_t smem = c_b + static_cast<size_t>(bt) * r_b;
  void* args[] = {&xp, &w, &h, &g, &c, &T, &B, &H, &reverse, &units, &bt};
  return launch_cooperative(lstm_infer_kernel<KPL, kResid>, blocks, threads,
                            smem, args, stream);
}

template <bool kResid>
int dispatch(const void* xp, const void* w, void* h, void* g, void* c,
             int T, int B, int H, int reverse, int device, void* stream) {
  if (T < 1 || B < 1 || B > kMaxBatch || H < 1 || H > kMaxH) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xp);
  auto wh = static_cast<const float*>(w);
  auto ho = static_cast<float*>(h);
  auto go = static_cast<float*>(g);
  auto co = static_cast<float*>(c);
  const int r = reverse ? 1 : 0;
  const int kpl = (H + 31) / 32;
  if (kpl <= 1) return launch<1, kResid>(x, wh, ho, go, co, T, B, H, r, s);
  if (kpl <= 2) return launch<2, kResid>(x, wh, ho, go, co, T, B, H, r, s);
  if (kpl <= 4) return launch<4, kResid>(x, wh, ho, go, co, T, B, H, r, s);
  if (kpl <= 8) return launch<8, kResid>(x, wh, ho, go, co, T, B, H, r, s);
  return launch<16, kResid>(x, wh, ho, go, co, T, B, H, r, s);
}

}  // namespace

extern "C" {

// Lean forward of one direction; reverse != 0 walks T-1 -> 0. Returns a
// cudaError_t (0 on success). Does not synchronise.
int lstm_infer_launch(const void* xp, const void* w, void* h, int T, int B,
                      int H, int reverse, int device, void* stream) {
  return dispatch<false>(xp, w, h, nullptr, nullptr, T, B, H, reverse,
                         device, stream);
}

// Residual-saving forward: also writes g [T, B, 4H] and c [T, B, H].
// Returns a cudaError_t (0 on success). Does not synchronise.
int lstm_fwd_launch(const void* xp, const void* w, void* h, void* g, void* c,
                    int T, int B, int H, int reverse, int device,
                    void* stream) {
  return dispatch<true>(xp, w, h, g, c, T, B, H, reverse, device, stream);
}

const char* lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
