// Merged bidirectional LSTM layer forward, float32: the lean forward
// (h only) and the residual-saving forward of training, one kernel body,
// each either on pre-projected gate inputs or with the input projection
// in the kernel.
//
// Replaces: speechsplit_tpu/ops/pallas_lstm.py::_bd_infer_kernel (wrapper
// _bd_infer), the TPU kernel that runs both directions of one BiLSTM layer
// in one grid, and, with kResid, ::_bd_fwd_kernel (wrapper _bd_fwd), which
// also writes each step's post-activation gates and cell state for the
// backward (csrc/bilstm_bwd.cu). With kProj the same two replace
// ::_bdp_infer_kernel (wrapper _bdp_infer) and ::_bdp_fwd_kernel (wrapper
// _bdp_fwd), which compute the gate inputs x W_ih^T + b inside the grid so
// the [T, B, 4H] projected tensors never go through HBM. Same math as
// pallas_lstm._cell: gates = xp + h_{t-1} W_hh^T ordered i, f, g, o;
// sigmoid/sigmoid/tanh/sigmoid; c = f c + i g; h = o tanh(c); state float32
// from zero. The backward direction walks T-1 -> 0 over inputs and outputs
// kept in real time order.
//
// Layouts: xp_f, xp_b [T, B, 4H] (time-major, real time order); w_f, w_b
// [4H, H] (torch's weight_hh_l{k}: row g*H + u holds gate g of unit u);
// h_f, h_b [T, B, H]; with kResid also g_f, g_b [T, B, 4H] (the gates
// i, f, g, o after their activations) and c_f, c_b [T, B, H]. With kProj
// the inputs are x [T, B, I] (both directions read it), wi_f, wi_b [4H, I]
// (torch's weight_ih_l{k}) and b_f, b_b [4H] (b_ih + b_hh) in place of xp.
//
// What bounds it on an H100: the recurrence. Step t needs all of h_{t-1},
// so the T steps are serial and each is a small [B, H] x [H, 4H] product
// followed by a cell update. At the mel decoder's H = 512, W_hh is 4 MiB a
// direction, far more than one SM's 227 KB of shared memory, so one block
// cannot hold a direction and the steps need a barrier across blocks. The
// per-step work is small (2*B*H*4H flops), so the time goes to latency:
// the grid-wide barrier and the reload of h_{t-1}, not to bytes from HBM
// (W is read once) or to arithmetic. The fused projection adds
// 2*T*B*I*4H flops a direction with no dependence between steps: at
// I = 1024 that is 4x the recurrence's flops, in float32 FMAs (no TF32).
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
// lean instantiation compiles without them.
//
// The fused projection (kProj): a block needs the gate inputs of its own
// units only, so no block waits on another's projection and the
// projection adds no grid barrier. Once per fold of F steps (F up to 16,
// the largest whose buffer fits beside a whole-batch h tile), the block
// computes its 4 * units gate rows for the F * B (step, batch row) rows
// of the fold: x and its W_ih rows staged through shared memory in
// K-tiles of 32, double-buffered with cp.async so the next tile's loads
// overlap this tile's sums, a 4x4 register tile of sums a thread (four
// rows, one unit's four gates) in float32 FMAs over ascending k, then the
// bias; the result stays in shared memory for the fold's F recurrence
// steps. The backward direction's fold covers its own next F steps, so it
// walks the folds back to front. The K-tiles share their space with the h
// tile, which is staged only after the projection. The fused kernels have
// an entry of their own (bilstm_fused_kernel: the launch in one struct,
// __launch_bounds__(256, 1)); the unfused entry keeps its own parameter
// list and bound, so its machine code does not move with theirs. Making
// it fast (wgmma on the step product and the projection, clusters with
// distributed shared memory in place of the grid barrier) is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxUnits = 8;   // hidden units (= warps) per block
constexpr int kBC = 4;         // batch rows per register tile
constexpr int kMaxH = 512;
constexpr size_t kSmemBudget = 160 * 1024;
// the fused projection: a (step, batch row) row of the fold buffer holds
// the 4 gates of each of the block's units
constexpr int kGateRow = 4 * kMaxUnits;
constexpr int kKT = 32;              // K-tile of the projection
constexpr int kXS = kKT + 4;         // x tile row stride: aligned float4
constexpr int kWS = kGateRow + 4;    // W_ih tile row stride: aligned float4
constexpr int kMaxFold = 16;
constexpr size_t kProjSmemBudget = 220 * 1024;

// The input projection of the fused kernels.
struct Proj {
  const float* x;
  const float* wi_f;
  const float* wi_b;
  const float* b_f;
  const float* b_b;
  int I, fold;
};

// A launch's arguments and plan (the fused kernels take it whole).
struct Params {
  const float* xp_f;
  const float* xp_b;
  const float* w_f;
  const float* w_b;
  float* h_f;
  float* h_b;
  float* g_f;
  float* g_b;
  float* c_f;
  float* c_b;
  Proj proj;  // kProj only
  int T, B, H;
  // the launch plan
  int blocks_per_dir, units, bt, region;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shared-memory floats of the projection's staging for a block of
// `threads` threads: the global offsets of a chunk's threads / 2 rows of
// x (64-bit), then two buffers, each an x K-tile [threads / 2][kXS] and a
// W_ih K-tile [kKT][kWS].
constexpr int proj_tile_floats(int threads) {
  return 2 * (threads / 2) + 2 * ((threads / 2) * kXS + kKT * kWS);
}

// The largest batch the fused kernels take: at fold 1 and one batch row
// of h, each batch row holds kGateRow gate inputs and kMaxUnits cell
// states beside the projection's staging. ops/bilstm.py reads the value
// from this line, so the kernel is the one owner of the limit.
constexpr int kMaxFusedBatch = 1113;
constexpr size_t fold1_floats(int batch) {
  return static_cast<size_t>(batch) * (kGateRow + kMaxUnits) +
         proj_tile_floats(kMaxUnits * 32);
}
static_assert(fold1_floats(kMaxFusedBatch) <= kProjSmemBudget / 4 &&
                  fold1_floats(kMaxFusedBatch + 1) > kProjSmemBudget / 4,
              "kMaxFusedBatch must be the largest batch plan_fused holds");

// The unfused kernels (bilstm_infer, bilstm_fwd) take B rows at width H
// while the cell state [units][B] and one batch row of the h tile and the
// gate inputs, H + 4 * units floats, fit these floats, with units =
// min(H, kMaxUnits) (launch() below). ops/bilstm.py reads the value from
// this line (merged_bidir_fits), so the kernel is the one owner of the
// limit.
constexpr int kUnfusedSmemFloats = 40960;
static_assert(kUnfusedSmemFloats * sizeof(float) == kSmemBudget,
              "kUnfusedSmemFloats must be the unfused launch's budget");

// cp.async: a 4-byte copy from global to shared memory that holds no
// register while it is in flight; a src size of 0 writes a zero.
__device__ __forceinline__ void copy_async4(float* dst, const float* src,
                                            bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The gate inputs of this block's units (unit0 .. unit0 + units - 1) for
// steps s0 .. s0 + nk - 1 of direction dir, every batch row:
// gates[(k * B + b) * kGateRow + wi * 4 + g] = bias[g*H + u] +
// sum_i x[t][b][i] * wih[g*H + u][i], with u = unit0 + wi and t the time
// index of step s0 + k. The rows go in chunks of threads / 2; thread
// (row group mg, unit rg) sums rows 4 mg .. 4 mg + 3 of a chunk for the
// four gates of unit rg. K-tiles are double-buffered: tile k + 1 is in
// flight (cp.async) while tile k is summed. Called by every thread of
// the block.
__device__ void project_fold(const float* __restrict__ x,
                             const float* __restrict__ wih,
                             const float* __restrict__ bias,
                             float* gates, float* tiles, int dir, int s0,
                             int nk, int T, int B, int H, int I, int unit0,
                             int units) {
  const int threads = blockDim.x;
  const int chunk = threads / 2;
  const int rg = threadIdx.x & 7;
  const int mg = threadIdx.x >> 3;
  long long* row_off = reinterpret_cast<long long*>(tiles);  // [chunk]
  float* bufs = tiles + 2 * chunk;
  const int buf_floats = chunk * kXS + kKT * kWS;
  const int rows = nk * B;
  const int n_kt = (I + kKT - 1) / kKT;
  const int u = unit0 + rg;
  const bool unit_ok = rg < units && u < H;
  float bias_r[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias_r[g] = unit_ok ? bias[g * H + u] : 0.0f;

  // issue the copies of K-tile kt into buffer kt % 2
  auto stage = [&](int kt) {
    float* xs = bufs + (kt & 1) * buf_floats;
    float* ws = xs + chunk * kXS;
    const int k0 = kt * kKT;
    for (int i = threadIdx.x; i < chunk * kKT; i += threads) {
      const int r = i / kKT;
      const int kk = i % kKT;
      const long long off = row_off[r];
      const bool ok = off >= 0 && k0 + kk < I;
      copy_async4(xs + r * kXS + kk, ok ? x + off + k0 + kk : x, ok);
    }
    for (int i = threadIdx.x; i < kGateRow * kKT; i += threads) {
      const int r = i / kKT;  // r = wi * 4 + g
      const int kk = i % kKT;
      const int wi = r >> 2;
      const int uu = unit0 + wi;
      const bool ok = wi < units && uu < H && k0 + kk < I;
      copy_async4(ws + kk * kWS + r,
                  ok ? wih + static_cast<size_t>((r & 3) * H + uu) * I +
                           k0 + kk
                     : wih,
                  ok);
    }
    copy_async_commit();
  };

  for (int m0 = 0; m0 < rows; m0 += chunk) {
    __syncthreads();  // the h tile's or the last chunk's readers are done
    for (int r = threadIdx.x; r < chunk; r += threads) {
      const int m = m0 + r;
      long long off = -1;
      if (m < rows) {
        const int s = s0 + m / B;
        const int t = dir == 0 ? s : T - 1 - s;
        off = (static_cast<long long>(t) * B + m % B) * I;
      }
      row_off[r] = off;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[j][g] = 0.0f;
    }
    stage(0);
    for (int kt = 0; kt < n_kt; ++kt) {
      if (kt + 1 < n_kt) {
        stage(kt + 1);
        copy_async_wait<1>();
      } else {
        copy_async_wait<0>();
      }
      __syncthreads();  // tile kt is in place for every thread
      const float* xs = bufs + (kt & 1) * buf_floats;
      const float* ws = xs + chunk * kXS;
      // zero-padded tiles: the padding adds exact zeros
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 4) {
        float xv[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              xs + (mg * 4 + j) * kXS + kk);
          xv[j][0] = v.x;
          xv[j][1] = v.y;
          xv[j][2] = v.z;
          xv[j][3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(ws + (kk + q) * kWS + rg * 4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[j][0] = fmaf(xv[j][q], w4.x, acc[j][0]);
            acc[j][1] = fmaf(xv[j][q], w4.y, acc[j][1]);
            acc[j][2] = fmaf(xv[j][q], w4.z, acc[j][2]);
            acc[j][3] = fmaf(xv[j][q], w4.w, acc[j][3]);
          }
        }
      }
      __syncthreads();  // every thread is done with tile kt
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + mg * 4 + j;
      if (m < rows) {
        *reinterpret_cast<float4*>(gates + static_cast<size_t>(m) * kGateRow +
                                   rg * 4) =
            make_float4(acc[j][0] + bias_r[0], acc[j][1] + bias_r[1],
                        acc[j][2] + bias_r[2], acc[j][3] + bias_r[3]);
      }
    }
  }
  __syncthreads();  // the fold's gate inputs are in place
}

// The recurrence of both directions, shared by the kernels below. Shared
// memory: h_s [bt][H], the tile of h_{t-1}; c_s [units_per_block][B],
// the cell state; without kProj x_s [units_per_block][bt][4], a step's
// gate inputs of the block's units; with kProj gates [fold][B][kGateRow],
// the fold's gate inputs, and h_s also holds the projection's K-tiles.
template <int KPL, bool kResid, bool kProj>
__device__ __forceinline__ void recurrence(
    float* h_s, float* c_s, float* x_s, float* gates,
    const float* __restrict__ xp_f, const float* __restrict__ xp_b,
    const float* __restrict__ w_f, const float* __restrict__ w_b,
    float* h_f, float* h_b, float* __restrict__ g_f,
    float* __restrict__ g_b, float* __restrict__ c_f,
    float* __restrict__ c_b, int T, int B, int H, int blocks_per_dir,
    int units_per_block, int bt, const Proj& q) {
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
    const int k_fold = kProj ? s % q.fold : 0;  // step within its fold
    if constexpr (kProj) {
      if (k_fold == 0) {
        project_fold(q.x, dir == 0 ? q.wi_f : q.wi_b,
                     dir == 0 ? q.b_f : q.b_b, gates, h_s, dir, s,
                     min(q.fold, T - s), T, B, H, q.I,
                     blk * units_per_block, units_per_block);
      }
    }
    for (int b0 = 0; b0 < B; b0 += bt) {
      const int nb = min(bt, B - b0);
      __syncthreads();  // the previous tile's readers are done with smem
      if constexpr (!kProj) {
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
          const float* x =
              kProj ? gates +
                          (static_cast<size_t>(k_fold) * B + b) * kGateRow +
                          warp * 4
                    : x_s + (warp * bt + bc + lane) * 4;
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

// The kernels on pre-projected gate inputs (bilstm_infer, bilstm_fwd).
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
  float* h_s = smem;
  float* c_s = h_s + bt * H;
  float* x_s = c_s + units_per_block * B;
  recurrence<KPL, kResid, false>(h_s, c_s, x_s, nullptr, xp_f, xp_b, w_f,
                                 w_b, h_f, h_b, g_f, g_b, c_f, c_b, T, B, H,
                                 blocks_per_dir, units_per_block, bt, Proj{});
}

// The kernels with the projection inside (bilstm_fused_infer,
// bilstm_fused_fwd). A cooperative grid of at most 128 blocks uses one
// block an SM, so the bound lets the compiler take up to 255 registers.
template <int KPL, bool kResid>
__global__ void __launch_bounds__(kMaxUnits * 32, 1)
bilstm_fused_kernel(const Params p) {
  extern __shared__ __align__(16) float smem_fused[];
  float* gates = smem_fused;
  float* h_s = gates + static_cast<size_t>(p.proj.fold) * p.B * kGateRow;
  float* c_s = h_s + p.region;
  recurrence<KPL, kResid, true>(h_s, c_s, nullptr, gates, nullptr, nullptr,
                                p.w_f, p.w_b, p.h_f, p.h_b, p.g_f, p.g_b,
                                p.c_f, p.c_b, p.T, p.B, p.H, p.blocks_per_dir,
                                p.units, p.bt, p.proj);
}

// Shared-memory plan of the fused kernels: the fold buffer, a region that
// holds the h tile or the projection's K-tiles, and the cell state. Takes
// the largest fold up to kMaxFold beside a whole-batch h tile; where even
// fold 1 does not leave room for one, fold 1 and a batch-tiled h.
// Returns false when one batch row of h does not fit.
bool plan_fused(Params& p, int threads, size_t* smem) {
  const size_t budget = kProjSmemBudget / sizeof(float);
  const size_t c_floats = static_cast<size_t>(p.units) * p.B;
  const size_t tiles = proj_tile_floats(threads);
  auto total = [&](int fold, int bt, size_t* region) {
    const size_t h = static_cast<size_t>(bt) * p.H;
    *region = ((h > tiles ? h : tiles) + 3) / 4 * 4;  // keeps c_s aligned
    return static_cast<size_t>(fold) * p.B * kGateRow + *region + c_floats;
  };
  size_t region = 0;
  int fold = p.T < kMaxFold ? p.T : kMaxFold;
  while (fold > 1 && total(fold, p.B, &region) > budget) --fold;
  int bt = p.B;
  if (total(fold, bt, &region) > budget) {
    const size_t fixed = static_cast<size_t>(fold) * p.B * kGateRow + c_floats;
    if (fixed + tiles > budget) return false;
    bt = static_cast<int>((budget - fixed) / p.H);
    if (bt > p.B) bt = p.B;
    if (bt < 1 || total(fold, bt, &region) > budget) return false;
  }
  const size_t floats = total(fold, bt, &region);
  p.proj.fold = fold;
  p.bt = bt;
  p.region = static_cast<int>(region);
  *smem = floats * sizeof(float);
  return true;
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

template <int KPL, bool kResid, bool kProj>
cudaError_t launch(Params p, cudaStream_t stream) {
  p.units = p.H < kMaxUnits ? p.H : kMaxUnits;
  p.blocks_per_dir = (p.H + p.units - 1) / p.units;
  const int threads = p.units * 32;
  const int grid = 2 * p.blocks_per_dir;
  size_t smem = 0;
  if constexpr (kProj) {
    if (!plan_fused(p, threads, &smem)) {
      return cudaErrorInvalidValue;  // batch too large for the fold buffer
    }
    void* args[] = {&p};
    return launch_cooperative(bilstm_fused_kernel<KPL, kResid>, grid,
                              threads, smem, args, stream);
  } else {
    // cell state [units][B], then per batch row of a tile: h_{t-1} [H]
    // and the units' gate inputs [units][4]
    const size_t c_bytes = static_cast<size_t>(p.units) * p.B * sizeof(float);
    const size_t row_bytes =
        static_cast<size_t>(p.H + 4 * p.units) * sizeof(float);
    if (c_bytes + row_bytes > kSmemBudget) {
      return cudaErrorInvalidValue;  // batch too large for the cell state
    }
    int bt = static_cast<int>((kSmemBudget - c_bytes) / row_bytes);
    if (bt > p.B) bt = p.B;
    p.bt = bt;
    smem = c_bytes + static_cast<size_t>(bt) * row_bytes;
    void* args[] = {&p.xp_f, &p.xp_b, &p.w_f, &p.w_b, &p.h_f, &p.h_b,
                    &p.g_f,  &p.g_b,  &p.c_f, &p.c_b, &p.T,   &p.B,
                    &p.H,    &p.blocks_per_dir, &p.units, &p.bt};
    return launch_cooperative(bilstm_infer_kernel<KPL, kResid>, grid,
                              threads, smem, args, stream);
  }
}

template <bool kResid, bool kProj>
int dispatch(const Params& p, int device, void* stream) {
  if (p.T < 1 || p.B < 1 || p.H < 1 || p.H > kMaxH) {
    return cudaErrorInvalidValue;
  }
  if (kProj && (p.proj.I < 1 || p.B > kMaxFusedBatch)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const int kpl = (p.H + 31) / 32;
  if (kpl <= 1) return launch<1, kResid, kProj>(p, s);
  if (kpl <= 2) return launch<2, kResid, kProj>(p, s);
  if (kpl <= 4) return launch<4, kResid, kProj>(p, s);
  if (kpl <= 8) return launch<8, kResid, kProj>(p, s);
  return launch<16, kResid, kProj>(p, s);
}

Params outputs(void* h_f, void* h_b, void* g_f, void* g_b, void* c_f,
               void* c_b, const void* w_f, const void* w_b, int T, int B,
               int H) {
  Params p = {};
  p.w_f = static_cast<const float*>(w_f);
  p.w_b = static_cast<const float*>(w_b);
  p.h_f = static_cast<float*>(h_f);
  p.h_b = static_cast<float*>(h_b);
  p.g_f = static_cast<float*>(g_f);
  p.g_b = static_cast<float*>(g_b);
  p.c_f = static_cast<float*>(c_f);
  p.c_b = static_cast<float*>(c_b);
  p.T = T;
  p.B = B;
  p.H = H;
  return p;
}

Params fused(const void* x, const void* wi_f, const void* wi_b,
             const void* b_f, const void* b_b, const void* w_f,
             const void* w_b, void* h_f, void* h_b, void* g_f, void* g_b,
             void* c_f, void* c_b, int T, int B, int H, int I) {
  Params p = outputs(h_f, h_b, g_f, g_b, c_f, c_b, w_f, w_b, T, B, H);
  p.proj.x = static_cast<const float*>(x);
  p.proj.wi_f = static_cast<const float*>(wi_f);
  p.proj.wi_b = static_cast<const float*>(wi_b);
  p.proj.b_f = static_cast<const float*>(b_f);
  p.proj.b_b = static_cast<const float*>(b_b);
  p.proj.I = I;
  return p;
}

}  // namespace

extern "C" {

// Lean forward. Returns a cudaError_t (0 on success). Does not synchronise.
int bilstm_infer_launch(const void* xp_f, const void* xp_b, const void* w_f,
                        const void* w_b, void* h_f, void* h_b, int T, int B,
                        int H, int device, void* stream) {
  Params p = outputs(h_f, h_b, nullptr, nullptr, nullptr, nullptr, w_f, w_b,
                     T, B, H);
  p.xp_f = static_cast<const float*>(xp_f);
  p.xp_b = static_cast<const float*>(xp_b);
  return dispatch<false, false>(p, device, stream);
}

// Residual-saving forward: also writes g_f, g_b [T, B, 4H] and c_f, c_b
// [T, B, H]. Returns a cudaError_t (0 on success). Does not synchronise.
int bilstm_fwd_launch(const void* xp_f, const void* xp_b, const void* w_f,
                      const void* w_b, void* h_f, void* h_b, void* g_f,
                      void* g_b, void* c_f, void* c_b, int T, int B, int H,
                      int device, void* stream) {
  Params p = outputs(h_f, h_b, g_f, g_b, c_f, c_b, w_f, w_b, T, B, H);
  p.xp_f = static_cast<const float*>(xp_f);
  p.xp_b = static_cast<const float*>(xp_b);
  return dispatch<true, false>(p, device, stream);
}

// Lean forward with the input projection in the kernel: x [T, B, I],
// wi_f, wi_b [4H, I], b_f, b_b [4H]. Returns a cudaError_t (0 on
// success). Does not synchronise.
int bilstm_fused_infer_launch(const void* x, const void* wi_f,
                              const void* wi_b, const void* b_f,
                              const void* b_b, const void* w_f,
                              const void* w_b, void* h_f, void* h_b, int T,
                              int B, int H, int I, int device, void* stream) {
  return dispatch<false, true>(
      fused(x, wi_f, wi_b, b_f, b_b, w_f, w_b, h_f, h_b, nullptr, nullptr,
            nullptr, nullptr, T, B, H, I),
      device, stream);
}

// Residual-saving forward with the input projection in the kernel.
// Returns a cudaError_t (0 on success). Does not synchronise.
int bilstm_fused_fwd_launch(const void* x, const void* wi_f,
                            const void* wi_b, const void* b_f,
                            const void* b_b, const void* w_f,
                            const void* w_b, void* h_f, void* h_b, void* g_f,
                            void* g_b, void* c_f, void* c_b, int T, int B,
                            int H, int I, int device, void* stream) {
  return dispatch<true, true>(
      fused(x, wi_f, wi_b, b_f, b_b, w_f, w_b, h_f, h_b, g_f, g_b, c_f, c_b,
            T, B, H, I),
      device, stream);
}

const char* bilstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
