// One direction of one LSTM layer, forward, float32: the lean forward
// (lstm_infer, h only) and the residual-saving forward of training
// (lstm_fwd).
//
// Replaces: speechsplit_tpu/ops/pallas_lstm.py::_infer_kernel (wrapper
// _infer) and ::_fwd_kernel (wrapper _fwd), the TPU kernels of
// lstm_sequence: one direction over a grid of T steps, W_hh resident.
// Same math as pallas_lstm._cell: gates = xp + h_{t-1} W_hh^T ordered
// i, f, g, o; sigmoid/sigmoid/tanh/sigmoid; c = f c + i g; h = o tanh(c);
// state float32 from zero. With reverse the recurrence walks T-1 -> 0 over
// inputs and outputs kept in real time order, as the TPU kernels' index
// maps do (pallas_lstm._sd_maps).
//
// Layouts: xp [T, B, 4H] (time-major, real time order); w [4H, H] (torch's
// weight_hh_l{k}: row g*H + u holds gate g of unit u); h [T, B, H]; the
// lean forward also takes a scratch c [B, H] for the wide plan's cell
// state; lstm_fwd also writes g [T, B, 4H] (the gates i, f, g, o after
// their activations) and c [T, B, H].
//
// What bounds it on an H100: step t needs all of h_{t-1}, so the T steps
// are serial. Each step is a [B, H] x [H, 4H] product (2*B*H*4H flops) and
// a cell update; xp is read once and h written once. The port runs the
// lean forward where the merged kernels cannot hold a batch (conversion of
// 731 pairs or more: 5117 rows at the mel decoder's H = 512 and at content
// layer 1's H = 8) and for LSTM(bidirectional=False). At B = 5117, H = 512
// a step is 10.7 GFLOP against 42 MB of xp: float32 FMAs bound it (0.16 ms
// a step at 67 TFLOP/s). At H = 8 a step is 2.6 MFLOP: nothing bounds it
// but latency, and rows of an LSTM never depend on each other.
//
// lstm_infer has two plans, split at kNarrowMaxH (chosen from a width sweep
// at B = 5117 on the H100, PERF.md):
//
// - Wide (H > kNarrowMaxH): one launch a step, issued by the host in a loop
//   on the caller's stream, each a tiled float32 GEMM with the LSTM cell in
//   its epilogue. A block owns kWideRows batch rows and kWideUnits hidden
//   units, i.e. all four gate columns of those units, so the cell update
//   of its (rows, units) runs in registers right after the product and the
//   gates never go to memory. 256 threads, each a 4 x 8 register tile
//   (4 rows x 2 units x 4 gates) of FFMA. The K loop stages kWideK-deep
//   tiles of h_{t-1} and W_hh in shared memory, transposed and swizzled,
//   double-buffered through registers (the next tile's loads are in flight
//   while the current one is multiplied). W_hh (4 MiB at H = 512) is
//   re-read by every row tile from L2. The batch is tiled over the grid, so
//   the plan has no batch limit; the cell state lives in the c scratch,
//   which step 0 writes without reading. No TF32.
// - Narrow (H <= kNarrowMaxH): one launch for the whole sequence with no
//   barrier between blocks: a batch row belongs to L lanes of a warp (L the
//   least power of 2 >= H), each lane owning one unit with all four of its
//   gates, so the row's c stays in registers for all T steps and its h
//   moves between the lanes by warp shuffles. W_hh is staged once into
//   shared memory as (i, f, g, o) float4s, zero-padded to L units. Each
//   lane fetches the next step's gate inputs while it computes this one.
//
// Both plans round the cell update as the plain version's separate ops do
// (no FMA contraction), so given the same gates c agrees with it to the
// last bit.
//
// lstm_fwd is the merged kernel's recurrence for one direction (csrc/
// bilstm_infer.cu), with a launch plan of its own: each block gets the
// fewest hidden units that keep the grid to one block an SM of a 128-SM
// card, units = ceil(H / 128), 4 at H = 512 (128 blocks). That keeps the
// cell state a block holds in shared memory, [units][B], to half the
// merged kernel's, so it takes batches up to kMaxBatch (13948 rows at
// H = 512). One persistent cooperative launch; one warp a unit, whose four
// gate rows of W_hh stay in registers for the whole sequence; a lane owns
// the k = lane + 32 j slice of the dot products and a warp butterfly sums
// them. Each step a block stages its units' gate inputs and h_{t-1} (read
// back from the output through L2), tiled over the batch, then all blocks
// meet at a grid barrier. The launch fails rather than deadlocks when the
// grid cannot be co-resident: the host side checks occupancy first.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxUnits = 4;    // hidden units (= warps) per block, at most
constexpr int kBC = 4;          // batch rows per register tile
constexpr int kMaxH = 512;
constexpr int kPlanSms = 128;   // the plan spreads H over this many blocks
constexpr size_t kSmemBudget = 220 * 1024;

// lstm_fwd's plan: units a block, ceil(H / kPlanSms), 1 .. kMaxUnits.
constexpr int plan_units(int H) { return (H + kPlanSms - 1) / kPlanSms; }

// Shared memory of a block: the cell state [units][B], then per batch row
// of a tile h_{t-1} [H] and the units' gate inputs [units][4].
constexpr size_t cell_bytes(int units, int B) {
  return static_cast<size_t>(units) * B * sizeof(float);
}
constexpr size_t row_bytes(int units, int H) {
  return static_cast<size_t>(H + 4 * units) * sizeof(float);
}

// The largest batch lstm_fwd takes, at every H <= kMaxH: the cell state
// of plan_units(kMaxH) units and one batch row in kSmemBudget (a narrower
// layer has fewer units a block and shorter rows). ops/lstm.py reads the
// value from this line, so the kernel is the one owner of the limit.
// lstm_infer has no batch limit.
constexpr int kMaxBatch = 13948;
static_assert(plan_units(kMaxH) == kMaxUnits, "the plan's widest block");
static_assert(cell_bytes(kMaxUnits, kMaxBatch) +
                      row_bytes(kMaxUnits, kMaxH) <= kSmemBudget &&
                  cell_bytes(kMaxUnits, kMaxBatch + 1) +
                          row_bytes(kMaxUnits, kMaxH) > kSmemBudget,
              "kMaxBatch must be the largest batch the plan holds");

// lstm_infer's plans. ops/lstm.py reads kNarrowMaxH from this line.
constexpr int kNarrowMaxH = 32;    // H <= this runs the narrow plan
constexpr int kNarrowThreads = 128;
constexpr int kWideUnits = 32;     // hidden units a wide block (128 columns)
constexpr int kWideRows = 64;      // batch rows a wide block
constexpr int kWideK = 16;         // depth of a staged K tile
constexpr int kWideThreads = 256;  // 16 x 16 threads, each 4 rows x 8 cols

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// lstm_fwd's kernel (lstm_infer's before the wide and narrow plans, whose
// name it keeps so that its machine code compares with earlier builds);
// compiled with kResid only.
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

int fwd_dispatch(const void* xp, const void* w, void* h, void* g, void* c,
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
  if (kpl <= 1) return launch<1, true>(x, wh, ho, go, co, T, B, H, r, s);
  if (kpl <= 2) return launch<2, true>(x, wh, ho, go, co, T, B, H, r, s);
  if (kpl <= 4) return launch<4, true>(x, wh, ho, go, co, T, B, H, r, s);
  if (kpl <= 8) return launch<8, true>(x, wh, ho, go, co, T, B, H, r, s);
  return launch<16, true>(x, wh, ho, go, co, T, B, H, r, s);
}

// ------------------------------------------------- lstm_infer, wide plan

// The shared-memory column of element (k, col) of a staged [kWideK][cols]
// tile: col's 8-float block XORed with k's 4-float group. A warp's
// transposing stores (8 consecutive rows or columns x 4 k-groups) then hit
// 32 distinct banks, and the 4 columns a thread reads as a float4 stay
// side by side.
__device__ __forceinline__ int swizzle(int k, int col) {
  return col ^ (((k >> 2) & 3) << 3);
}

// Elements k .. k+3 of a row of h_{t-1} or W_hh at p, zero past H or for a
// row outside the matrix. kVec: H % 4 == 0, so rows are 16-byte aligned and
// the four are all inside or all outside.
template <bool kVec>
__device__ __forceinline__ float4 stage4(const float* p, bool ok, int k,
                                         int H) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!ok) return v;
  if (kVec) {
    if (k < H) v = *reinterpret_cast<const float4*>(p);
  } else {
    if (k < H) v.x = p[0];
    if (k + 1 < H) v.y = p[1];
    if (k + 2 < H) v.z = p[2];
    if (k + 3 < H) v.w = p[3];
  }
  return v;
}

// One step: h_out = cell(xp + h_prev W_hh^T) over a tile of kWideRows rows
// and kWideUnits units; h_prev == nullptr at the first step (h and c from
// zero).
template <bool kVec>
__global__ void __launch_bounds__(kWideThreads, 3)
lstm_wide_step_kernel(const float* __restrict__ xp,
                      const float* __restrict__ w,
                      const float* __restrict__ h_prev,
                      float* __restrict__ h_out, float* __restrict__ c,
                      int B, int H) {
  constexpr int MR = 4;                 // batch rows a thread
  constexpr int BM = kWideRows;         // batch rows of the tile
  constexpr int BN = 4 * kWideUnits;    // gate columns: unit j gate g at 4j+g
  constexpr int KQ = kWideK / 4;        // float4s in a staged row
  constexpr int A_LD = BM * KQ / kWideThreads;  // float4s of h a thread stages
  constexpr int W_LD = BN * KQ / kWideThreads;  // ... and of W_hh
  static_assert(BM == 16 * MR && KQ == 4 &&
                    A_LD * kWideThreads == BM * KQ &&
                    W_LD * kWideThreads == BN * KQ,
                "staging plan");
  __shared__ __align__(16) float a_s[2][kWideK][BM];
  __shared__ __align__(16) float w_s[2][kWideK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // units tx and tx + 16 of the tile
  const int ty = tid >> 4;  // rows MR ty + {0 .. MR-1} of the tile
  const int q = tid & 3;    // the k-group this thread stages
  const int m0 = blockIdx.x * BM;
  const int u0 = blockIdx.y * kWideUnits;

  float acc[MR][8];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[i][n] = 0.0f;
  }

  if (h_prev != nullptr) {
    // staged element p of a k-tile: row (or column) (tid + p * threads) / 4
    // at k-group q; the rows of h_{t-1}, and the W_hh rows of gate g of
    // unit j for column 4 j + g
    const float* a_src[A_LD];
    bool a_ok[A_LD];
    const float* w_src[W_LD];
    bool w_ok[W_LD];
#pragma unroll
    for (int p = 0; p < A_LD; ++p) {
      const int m = m0 + ((tid + p * kWideThreads) >> 2);
      a_ok[p] = m < B;
      a_src[p] = h_prev + static_cast<size_t>(a_ok[p] ? m : 0) * H + 4 * q;
    }
#pragma unroll
    for (int p = 0; p < W_LD; ++p) {
      const int col = (tid + p * kWideThreads) >> 2;
      const int u = u0 + (col >> 2);
      w_ok[p] = u < H;
      w_src[p] = w + static_cast<size_t>((col & 3) * H + (w_ok[p] ? u : 0)) *
                         H + 4 * q;
    }
    float4 a_reg[A_LD], w_reg[W_LD];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int p = 0; p < A_LD; ++p) {
        a_reg[p] = stage4<kVec>(a_src[p] + k0, a_ok[p], k0 + 4 * q, H);
      }
#pragma unroll
      for (int p = 0; p < W_LD; ++p) {
        w_reg[p] = stage4<kVec>(w_src[p] + k0, w_ok[p], k0 + 4 * q, H);
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int p = 0; p < A_LD; ++p) {
        const int col = ((tid + p * kWideThreads) >> 2) ^ (q << 3);
        a_s[buf][4 * q][col] = a_reg[p].x;
        a_s[buf][4 * q + 1][col] = a_reg[p].y;
        a_s[buf][4 * q + 2][col] = a_reg[p].z;
        a_s[buf][4 * q + 3][col] = a_reg[p].w;
      }
#pragma unroll
      for (int p = 0; p < W_LD; ++p) {
        const int col = ((tid + p * kWideThreads) >> 2) ^ (q << 3);
        w_s[buf][4 * q][col] = w_reg[p].x;
        w_s[buf][4 * q + 1][col] = w_reg[p].y;
        w_s[buf][4 * q + 2][col] = w_reg[p].z;
        w_s[buf][4 * q + 3][col] = w_reg[p].w;
      }
    };
    const int nk = (H + kWideK - 1) / kWideK;
    fetch(0);
    store(0);
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      const int buf = kt & 1;
      if (kt + 1 < nk) fetch((kt + 1) * kWideK);  // in flight meanwhile
#pragma unroll
      for (int kk = 0; kk < kWideK; ++kk) {
        float a[MR], b[8];
        const float4 v = *reinterpret_cast<const float4*>(
            &a_s[buf][kk][swizzle(kk, MR * ty)]);
        a[0] = v.x;
        a[1] = v.y;
        a[2] = v.z;
        a[3] = v.w;
        const float4 b0 = *reinterpret_cast<const float4*>(
            &w_s[buf][kk][swizzle(kk, 4 * tx)]);
        const float4 b1 = *reinterpret_cast<const float4*>(
            &w_s[buf][kk][swizzle(kk, 64 + 4 * tx)]);
        b[0] = b0.x;
        b[1] = b0.y;
        b[2] = b0.z;
        b[3] = b0.w;
        b[4] = b1.x;
        b[5] = b1.y;
        b[6] = b1.z;
        b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < MR; ++i) {
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[i][n] = fmaf(a[i], b[n], acc[i][n]);
        }
      }
      // the other buffer's last readers passed the barrier below in the
      // previous iteration
      if (kt + 1 < nk) store(buf ^ 1);
      __syncthreads();
    }
  }

  // the cell update of (row, unit) from acc[row][4 v + gate]
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int m = m0 + MR * ty + i;
    if (m >= B) continue;
    const float* x = xp + static_cast<size_t>(m) * 4 * H;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int u = u0 + tx + 16 * v;
      if (u >= H) continue;
      const float i_g = sigmoid_f(x[u] + acc[i][4 * v]);
      const float f_g = sigmoid_f(x[H + u] + acc[i][4 * v + 1]);
      const float g_g = tanhf(x[2 * H + u] + acc[i][4 * v + 2]);
      const float o_g = sigmoid_f(x[3 * H + u] + acc[i][4 * v + 3]);
      const size_t at = static_cast<size_t>(m) * H + u;
      const float c_prev = h_prev != nullptr ? c[at] : 0.0f;
      // each product and the sum rounded on its own, as the plain
      // version's separate ops round them
      const float c_new =
          __fadd_rn(__fmul_rn(f_g, c_prev), __fmul_rn(i_g, g_g));
      c[at] = c_new;
      h_out[at] = o_g * tanhf(c_new);
    }
  }
}

template <bool kVec>
cudaError_t wide_steps(const float* xp, const float* w, float* h, float* c,
                       int T, int B, int H, int reverse,
                       cudaStream_t stream) {
  const dim3 grid((B + kWideRows - 1) / kWideRows,
                  (H + kWideUnits - 1) / kWideUnits);
  const size_t xs = static_cast<size_t>(B) * 4 * H;  // a step of xp
  const size_t hs = static_cast<size_t>(B) * H;      // a step of h
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;  // the previous step's index
    lstm_wide_step_kernel<kVec><<<grid, kWideThreads, 0, stream>>>(
        xp + t * xs, w, s ? h + tp * hs : nullptr, h + t * hs, c, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ----------------------------------------------- lstm_infer, narrow plan

// The whole sequence for 128 / L batch rows a block; L lanes a row, one
// unit a lane (all four gates of it), H <= L.
template <int L>
__global__ void __launch_bounds__(kNarrowThreads)
lstm_narrow_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                   float* __restrict__ h, int T, int B, int H, int reverse) {
  constexpr int ROWS = 32 / L;  // batch rows a warp
  // W_hh as [k][u] float4s (i, f, g, o of unit u at column k), L x L with
  // zeros past H
  extern __shared__ float4 wt[];
  for (int i = threadIdx.x; i < L * L; i += blockDim.x) {
    const int k = i / L;
    const int u = i % L;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < H && u < H) {
      v.x = w[static_cast<size_t>(u) * H + k];
      v.y = w[static_cast<size_t>(H + u) * H + k];
      v.z = w[static_cast<size_t>(2 * H + u) * H + k];
      v.w = w[static_cast<size_t>(3 * H + u) * H + k];
    }
    wt[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int u = lane & (L - 1);  // this lane's unit in its row's group
  const int row =
      (blockIdx.x * (kNarrowThreads / 32) + (threadIdx.x >> 5)) * ROWS +
      lane / L;
  const bool live = row < B;
  // rows past B and units past H run on zero inputs (their h stays 0) and
  // store nothing; every lane takes part in the shuffles
  const bool ok = live && u < H;
  float c_st = 0.0f, h_st = 0.0f, xn[4];
  auto fetch = [&](int t) {
    const float* x =
        xp + (static_cast<size_t>(t) * B + (live ? row : 0)) * 4 * H;
#pragma unroll
    for (int g = 0; g < 4; ++g) xn[g] = ok ? x[g * H + u] : 0.0f;
  };
  fetch(reverse ? T - 1 : 0);
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    float x[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = xn[g];
    if (s + 1 < T) fetch(reverse ? t - 1 : t + 1);  // in flight meanwhile
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < L; ++k) {
      // h_{t-1}[k], from the lane that owns it
      const float hk = __shfl_sync(0xffffffffu, h_st, k, L);
      const float4 v = wt[k * L + u];
      acc[0] = fmaf(hk, v.x, acc[0]);
      acc[1] = fmaf(hk, v.y, acc[1]);
      acc[2] = fmaf(hk, v.z, acc[2]);
      acc[3] = fmaf(hk, v.w, acc[3]);
    }
    const float i_g = sigmoid_f(x[0] + acc[0]);
    const float f_g = sigmoid_f(x[1] + acc[1]);
    const float g_g = tanhf(x[2] + acc[2]);
    const float o_g = sigmoid_f(x[3] + acc[3]);
    c_st = __fadd_rn(__fmul_rn(f_g, c_st), __fmul_rn(i_g, g_g));
    h_st = o_g * tanhf(c_st);
    if (ok) h[(static_cast<size_t>(t) * B + row) * H + u] = h_st;
  }
}

template <int L>
cudaError_t narrow_launch(const float* xp, const float* w, float* h, int T,
                          int B, int H, int reverse, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float4) * L * L;
  constexpr int rows = kNarrowThreads / L;  // batch rows a block
  const unsigned blocks = (static_cast<unsigned>(B) + rows - 1) / rows;
  lstm_narrow_kernel<L><<<blocks, kNarrowThreads, smem, stream>>>(
      xp, w, h, T, B, H, reverse);
  return cudaGetLastError();
}

static_assert(kNarrowMaxH == 32, "narrow_plan's widest instance is L = 32");
cudaError_t narrow_plan(const float* xp, const float* w, float* h, int T,
                        int B, int H, int reverse, cudaStream_t s) {
  if (H <= 1) return narrow_launch<1>(xp, w, h, T, B, H, reverse, s);
  if (H <= 2) return narrow_launch<2>(xp, w, h, T, B, H, reverse, s);
  if (H <= 4) return narrow_launch<4>(xp, w, h, T, B, H, reverse, s);
  if (H <= 8) return narrow_launch<8>(xp, w, h, T, B, H, reverse, s);
  if (H <= 16) return narrow_launch<16>(xp, w, h, T, B, H, reverse, s);
  return narrow_launch<32>(xp, w, h, T, B, H, reverse, s);
}

}  // namespace

extern "C" {

// Lean forward of one direction; reverse != 0 walks T-1 -> 0. plan: 0 by
// width (narrow where H <= kNarrowMaxH, else wide), 1 narrow (H <=
// kNarrowMaxH), 2 wide; only a measurement forces one. c is a [B, H]
// scratch. Returns a cudaError_t (0 on success). Does not synchronise.
int lstm_infer_launch(const void* xp, const void* w, void* h, void* c, int T,
                      int B, int H, int reverse, int plan, int device,
                      void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxH || plan < 0 || plan > 2 ||
      (plan == 1 && H > kNarrowMaxH)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xp);
  auto wh = static_cast<const float*>(w);
  auto ho = static_cast<float*>(h);
  auto co = static_cast<float*>(c);
  const int r = reverse ? 1 : 0;
  if (plan == 1 || (plan == 0 && H <= kNarrowMaxH)) {
    return narrow_plan(x, wh, ho, T, B, H, r, s);
  }
  return H % 4 == 0 ? wide_steps<true>(x, wh, ho, co, T, B, H, r, s)
                    : wide_steps<false>(x, wh, ho, co, T, B, H, r, s);
}

// Residual-saving forward: also writes g [T, B, 4H] and c [T, B, H].
// Returns a cudaError_t (0 on success). Does not synchronise.
int lstm_fwd_launch(const void* xp, const void* w, void* h, void* g, void* c,
                    int T, int B, int H, int reverse, int device,
                    void* stream) {
  return fwd_dispatch(xp, w, h, g, c, T, B, H, reverse, device, stream);
}

const char* lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
