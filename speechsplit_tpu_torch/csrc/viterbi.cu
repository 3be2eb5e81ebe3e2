// The pitch tracker's serial Viterbi decoder, for a batch of utterances.
//
// Replaces speechsplit_tpu/ops/pitch.py::_viterbi_scan (:497), the one
// recurrence of the feature front end. JAX runs it as a T-step lax.scan of
// a (K+1)-state min-plus step inside one XLA program, then a reverse
// backtrace scan; it is not a Pallas kernel. In eager PyTorch the same
// loop launches about 15 small ops a frame, so this kernel runs both
// passes of every utterance in one launch.
//
// What bounds it on the H100: neither bytes (3 inputs of B*T*K floats, a
// few hundred KB at an extraction's T = 257) nor operations, but the T
// dependent steps of the forward pass and the T dependent loads of the
// backtrace: a latency chain. The design keeps each step inside one warp:
//   - one warp an utterance, lane s holding the path cost of state s
//     (K voiced candidates, lane K the unvoiced state, K + 1 <= 32);
//   - lane j < K takes the min over i < K of
//     prev[i] + freq_weight * |ll[j] - prev_ll[i]|, prev and prev_ll read
//     by __shfl_sync, the first index on a tie (jnp.argmin), and keeps the
//     voiced predecessor when best_v_prev <= cost_from_u; lane K takes the
//     unvoiced update in the order of pitch.py:522-528;
//   - the next frame's inputs are loaded a step ahead;
//   - backpointers go to a [B, T-1, K+1] int8 scratch in device memory, so
//     no length limit; after a __syncwarp lane 0 backtraces.
// Every addition and product is __fadd_rn / __fmul_rn, so nvcc contracts
// no multiply-add and the states equal the plain PyTorch loop's
// (ops/pitch.py::viterbi_decode_reference) bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kMaxStates = 32;  // K + 1 states, one lane each
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32) viterbi_kernel(
    const float* __restrict__ local_v, const float* __restrict__ local_u,
    const float* __restrict__ log_lag, int8_t* __restrict__ back,
    int* __restrict__ states, int T, int K, float freq_weight,
    float trans_cost) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const bool voiced_lane = lane < K;
  const float* lv = local_v + static_cast<size_t>(b) * T * K;
  const float* lu = local_u + static_cast<size_t>(b) * T;
  const float* ll = log_lag + static_cast<size_t>(b) * T * K;
  int8_t* bk = back + static_cast<size_t>(b) * (T > 1 ? T - 1 : 1) * (K + 1);

  // frame 0: the local costs
  float cost = CUDART_INF_F;
  if (voiced_lane) cost = lv[lane];
  if (lane == K) cost = lu[0];
  float ll_prev = voiced_lane ? ll[lane] : 0.0f;

  // frame 1's inputs, loaded a step ahead
  float lv_next = 0.0f, lu_next = 0.0f, ll_next = 0.0f;
  if (T > 1) {
    if (voiced_lane) {
      lv_next = lv[K + lane];
      ll_next = ll[K + lane];
    }
    if (lane == K) lu_next = lu[1];
  }

  for (int t = 1; t < T; ++t) {
    const float lv_t = lv_next, lu_t = lu_next, ll_t = ll_next;
    if (t + 1 < T) {
      if (voiced_lane) {
        lv_next = lv[(t + 1) * K + lane];
        ll_next = ll[(t + 1) * K + lane];
      }
      if (lane == K) lu_next = lu[t + 1];
    }
    // voiced -> voiced (lanes j < K), and the cheapest voiced state (every
    // lane; lane K keeps it): min and first argmin over i < K
    float best_v = CUDART_INF_F;
    int arg_v = 0;
    float best_prev = CUDART_INF_F;
    int arg_prev = 0;
    for (int i = 0; i < K; ++i) {
      const float pc = __shfl_sync(kFull, cost, i);
      const float pll = __shfl_sync(kFull, ll_prev, i);
      const float c = __fadd_rn(
          pc, __fmul_rn(freq_weight, fabsf(__fsub_rn(ll_t, pll))));
      if (c < best_v) {
        best_v = c;
        arg_v = i;
      }
      if (pc < best_prev) {
        best_prev = pc;
        arg_prev = i;
      }
    }
    const float prev_u = __shfl_sync(kFull, cost, K);
    float next = CUDART_INF_F;
    int arg = K;
    if (voiced_lane) {
      const float from_u = __fadd_rn(prev_u, trans_cost);
      const bool keep_v = best_v <= from_u;
      next = __fadd_rn(lv_t, keep_v ? best_v : from_u);
      arg = keep_v ? arg_v : K;
    } else if (lane == K) {
      const float to_u_from_v = __fadd_rn(best_prev, trans_cost);
      const bool from_v = to_u_from_v <= prev_u;
      next = __fadd_rn(lu_t, from_v ? to_u_from_v : prev_u);
      arg = from_v ? arg_prev : K;
    }
    if (lane <= K) bk[(t - 1) * (K + 1) + lane] = static_cast<int8_t>(arg);
    cost = next;
    ll_prev = ll_t;
  }

  // the cheapest final state, the first on a tie (jnp.argmin)
  float best = CUDART_INF_F;
  int state = 0;
  for (int s = 0; s <= K; ++s) {
    const float c = __shfl_sync(kFull, cost, s);
    if (c < best) {
      best = c;
      state = s;
    }
  }
  __syncwarp();  // the other lanes' backpointers, visible to lane 0
  if (lane == 0) {
    int* out = states + static_cast<size_t>(b) * T;
    out[T - 1] = state;
    for (int t = T - 1; t >= 1; --t) {
      state = bk[(t - 1) * (K + 1) + state];
      out[t - 1] = state;
    }
  }
}

}  // namespace

extern "C" {

// local_v, log_lag [B, T, K], local_u [B, T] float32; back [B, max(T-1, 1),
// K+1] int8 scratch; states [B, T] int32. Returns a cudaError_t (0 on
// success); K + 1 > kMaxStates returns cudaErrorInvalidValue. Does not
// synchronise.
int viterbi_launch(const void* local_v, const void* local_u,
                   const void* log_lag, void* back, void* states, int B,
                   int T, int K, float freq_weight, float trans_cost,
                   int device, void* stream) {
  if (K < 1 || K + 1 > kMaxStates || T < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  viterbi_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(local_v), static_cast<const float*>(local_u),
      static_cast<const float*>(log_lag), static_cast<int8_t*>(back),
      static_cast<int*>(states), T, K, freq_weight, trans_cost);
  return static_cast<int>(cudaGetLastError());
}

const char* viterbi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
