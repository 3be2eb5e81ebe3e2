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
// few hundred KB at an extraction's T = 257) nor operations, but the T - 1
// dependent steps of the forward pass: a chain of steps, which one warp an
// utterance runs, lane s holding the path cost of state s (K voiced
// candidates, lane K the unvoiced state, K + 1 <= 32); with K <=
// kPairMaxK lanes s and s + 16 both hold state s, each taking the min over
// half the predecessors (6), since a step is bound by the instructions
// each lane issues (the compares, selects and mins go at half rate), not
// by the chain's latency. The design keeps each step short:
//   - the step's inputs come from shared memory: local_v (local_u in its
//     column K) and log_lag are staged kChunkFrames frames at a time by
//     cp.async (16-byte pieces where K is a multiple of 4) into a
//     two-chunk ring, a chunk ahead of the step that reads it;
//   - the transition weights w[i] = freq_weight * |ll_{t+1}[j] - ll_t[i]|
//     of step t + 1 are computed during step t, so only the adds
//     prev[i] + w[i] and the min stay on the chain; the unvoiced lane's
//     weights are 0 (its min is over the voiced costs alone), the padded
//     predecessors i >= K have cost +inf;
//   - the previous costs reach every lane by NP independent shuffles;
//   - the min over predecessors is a tree of ceil(log2(NP)) levels over a
//     lane's NP predecessors (NP = 6 on two lanes a state for K <=
//     kPairMaxK, then one exchange of (value, index) between the two;
//     else NP = 32, padded, on one lane); a right half (the higher indices)
//     wins only when strictly smaller, so the argmin is the first index on
//     a tie, as jnp.argmin's and the sequential c < best's; the unvoiced
//     lane takes the same tree and keeps pitch.py:522-528's update;
//   - the backpointers go to shared memory ((T-1) x (K+1) int8) while they
//     fit in kSharedBackBytes, past that to a [B, T-1, K+1] device-memory
//     scratch (the same kernel, another template instance);
//   - the backtrace is the warp's: each lane composes the backpointer maps
//     of one of kTraceChunks chunks of rows for every end state (K + 1
//     independent chains), a pass over the 32 chunk maps gives each
//     chunk's top state, then each lane writes its chunk's states: about
//     2(T-1)/32 + 32 dependent reads instead of T - 1.
// Every addition and product is __fadd_rn / __fmul_rn / __fsub_rn in the
// order of pitch.py:510-528, so nvcc contracts no multiply-add and the
// states equal the plain PyTorch loop's
// (ops/pitch.py::viterbi_decode_reference) bit for bit. The tree's values
// are fminf: a cost reaches the states only through comparisons and sums,
// in which the one pair fminf may order otherwise than the select, -0 and
// +0, acts alike.
//
// Built with -DVITERBI_PROBE (chip_smoke.py's probe build, tools/
// viterbi_probe.py), each block also adds up clock64() laps of its
// phases (kPhases below; viterbi_probe_read); the build adds the latency
// floor's kernel (viterbi_floor_launch).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

// ops/pitch.py reads these lines.
constexpr int kMaxStates = 32;            // K + 1 states on a warp's lanes
constexpr int kChunkFrames = 64;          // frames a staged chunk
constexpr int kSharedBackBytes = 196608;  // the shared plan's backpointers
constexpr int kTraceChunks = 32;          // backtrace chunks, one a lane
constexpr int kPairMaxK = 12;  // K up to this: two lanes a state, 6 each

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRing = 2 * kChunkFrames;  // ring rows: two chunks
static_assert((kChunkFrames & (kChunkFrames - 1)) == 0,
              "a frame's ring row is its index modulo kRing");

// Dynamic shared memory of a block: the local-cost and log-lag rings
// [kRing][KP] float each, the chunk maps [kTraceChunks][KP] int8, then on
// the shared plan the backpointers [T - 1][K + 1] int8. Each part a
// multiple of 16 bytes, so every row of the rings is float4-aligned.
template <int KP>
constexpr size_t fixed_bytes() {
  return 2 * kRing * KP * sizeof(float) + kTraceChunks * KP;
}
static_assert(kPairMaxK + 1 <= 16 && kPairMaxK % 4 == 0,
              "two copies of the states on 32 lanes, NP even (float2s)");
static_assert(fixed_bytes<32>() + kSharedBackBytes <= 232448,
              "the shared plan fits the 227 KB a block may opt into");

bool shared_plan(int T, int K) {
  return static_cast<long long>(T - 1) * (K + 1) <= kSharedBackBytes;
}

template <int KP>
size_t smem_bytes(int T, int K, bool shared) {
  return fixed_bytes<KP>() +
         (shared ? static_cast<size_t>(T - 1) * (K + 1) : 0);
}

#ifdef VITERBI_PROBE
// 0 issuing the first two chunks, 1 waiting for the first, 2 the forward
// steps, 3 the refills (the wait for a chunk and the next one's issue),
// 4 the final argmin and the backtrace
constexpr int kPhases = 5;
__device__ unsigned long long g_probe_cycles[kPhases];
#define PROBE_LAP(phase)                         \
  do {                                           \
    const long long now_ = clock64();            \
    probe_cycles[phase] += now_ - lap_;          \
    lap_ = now_;                                 \
  } while (0)
#else
#define PROBE_LAP(phase) \
  do {                   \
  } while (0)
#endif

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage chunk q (frames q * kChunkFrames ...) of one utterance into the
// rings: local_v and log_lag in columns < K, local_u in column K of the
// local-cost ring. With vec (K a multiple of 4, local_v and log_lag
// 16-byte aligned) the chunk's rows go as 16-byte pieces, each within a
// row; else lane l copies column l % KP of every (32 / KP)-th row.
template <int KP>
__device__ __forceinline__ void stage(float* loc, float* llr,
                                      const float* lv, const float* lu,
                                      const float* ll, int q, int T, int K,
                                      bool vec, int lane) {
  const int t0 = q * kChunkFrames;
  const int rows = min(kChunkFrames, T - t0);
  if (vec) {
    const int quads = K / 4;  // 16-byte pieces a row
    const float* lv0 = lv + static_cast<size_t>(t0) * K;
    const float* ll0 = ll + static_cast<size_t>(t0) * K;
    for (int e = lane; e < rows * quads; e += 32) {
      const int r = e / quads;
      const int slot = ((t0 + r) & (kRing - 1)) * KP + 4 * (e - r * quads);
      copy16(loc + slot, lv0 + 4 * e);
      copy16(llr + slot, ll0 + 4 * e);
    }
    for (int r = lane; r < rows; r += 32) {
      copy4(loc + ((t0 + r) & (kRing - 1)) * KP + K, lu + t0 + r);
    }
    return;
  }
  const int col = lane % KP;
  for (int r = lane / KP; r < rows; r += 32 / KP) {
    const int t = t0 + r;
    const int slot = (t & (kRing - 1)) * KP + col;
    if (col < K) {
      copy4(loc + slot, lv + static_cast<size_t>(t) * K + col);
      copy4(llr + slot, ll + static_cast<size_t>(t) * K + col);
    } else if (col == K) {
      copy4(loc + slot, lu + t);
    }
  }
}

// N consecutive floats of shared memory into registers: float4 loads,
// or float2 where N is not a multiple of 4 (src then 8-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* src) {
  if constexpr (N % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = s4[q];
      v[4 * q + 0] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
    static_assert(N % 2 == 0, "rows load in pairs");
    const float2* s2 = reinterpret_cast<const float2*>(src);
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 x = s2[q];
      v[2 * q + 0] = x.x;
      v[2 * q + 1] = x.y;
    }
  }
}

// A step's transition weights into this lane's state from N predecessors:
// fw * |ll_own - ll_prev[i]| (fw 0 on the unvoiced lane; the padded
// columns of ll_prev are 0, so every weight is finite).
template <int N>
__device__ __forceinline__ void weights(float (&w)[N], const float* ll_prev,
                                        float ll_own, float fw) {
  float v[N];
  load_row<N>(v, ll_prev);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    w[i] = __fmul_rn(fw, fabsf(__fsub_rn(ll_own, v[i])));
  }
}

// The levels of a min tree over kN values: pair (2i, 2i + 1) into slot i,
// an odd last value carried into slot kN / 2; the right value (the higher
// indices) wins only when strictly smaller. A level a template instance,
// so every index is a constant and the arrays stay in registers.
template <int kN, int N>
__device__ __forceinline__ void argmin_levels(float (&c)[N], int (&idx)[N]) {
  if constexpr (kN > 1) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const bool right = c[2 * i + 1] < c[2 * i];
      idx[i] = right ? idx[2 * i + 1] : idx[2 * i];
      c[i] = fminf(c[2 * i], c[2 * i + 1]);
    }
    if constexpr (kN % 2 == 1) {
      c[kN / 2] = c[kN - 1];
      idx[kN / 2] = idx[kN - 1];
    }
    argmin_levels<(kN + 1) / 2>(c, idx);
  }
}

// The min of c[0 .. N) and its first index.
template <int N>
__device__ __forceinline__ float tree_argmin(float (&c)[N], int& arg) {
  int idx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) idx[i] = i;
  argmin_levels<N>(c, idx);
  arg = idx[0];
  return c[0];
}

// KP: a ring row's floats and the lanes a copy of the states takes (16:
// two lanes a state; 32: one). NP: the predecessors a lane takes.
template <int KP, int NP, bool kSharedBack>
__global__ void __launch_bounds__(32) viterbi_kernel(
    const float* __restrict__ local_v, const float* __restrict__ local_u,
    const float* __restrict__ log_lag, int8_t* __restrict__ back,
    int* __restrict__ states, int T, int K, float freq_weight,
    float trans_cost) {
#ifdef VITERBI_PROBE
  long long lap_ = clock64();
  long long probe_cycles[kPhases] = {};
#endif
  extern __shared__ __align__(16) unsigned char smem[];
  float* loc = reinterpret_cast<float*>(smem);
  float* llr = loc + kRing * KP;
  int8_t* maps = reinterpret_cast<int8_t*>(llr + kRing * KP);
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int S = K + 1;
  int8_t* bk;
  if constexpr (kSharedBack) {
    bk = maps + kTraceChunks * KP;
  } else {
    bk = back + static_cast<size_t>(b) * (T - 1) * S;
  }
  const float* lv = local_v + static_cast<size_t>(b) * T * K;
  const float* lu = local_u + static_cast<size_t>(b) * T;
  const float* ll = log_lag + static_cast<size_t>(b) * T * K;

  // the log-lag ring's padded columns read as 0; chunks 0 and 1 in flight
  for (int i = lane; i < kRing * KP; i += 32) {
    if (i % KP >= K) llr[i] = 0.0f;
  }
  const bool vec = (K & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(local_v) |
                     reinterpret_cast<uintptr_t>(log_lag)) & 15) == 0;
  stage<KP>(loc, llr, lv, lu, ll, 0, T, K, vec, lane);
  commit();
  stage<KP>(loc, llr, lv, lu, ll, 1, T, K, vec, lane);
  commit();
  PROBE_LAP(0);
  wait_older();  // this lane's copies of chunk 0
  __syncwarp();  // and every lane's

  // lane l holds state l % KP and takes its min over the NP predecessors
  // [first, first + NP): at KP = 16 two lanes a state, each over half
  constexpr int kHalves = 32 / KP;
  static_assert(NP * kHalves <= KP, "a lane's predecessors are states");
  const int state_of_lane = lane % KP;
  const int first = lane / KP * NP;
  const bool voiced = state_of_lane < K;
  const bool state_lane = state_of_lane <= K;
  // lanes past K read the unvoiced column
  const int own = min(state_of_lane, K);
  const float fw = voiced ? freq_weight : 0.0f;
  float cost = state_lane ? loc[own] : CUDART_INF_F;  // frame 0
  float wa[NP], wb[NP];
  weights<NP>(wa, llr + first, llr[min(1, T - 1) * KP + own], fw);
  PROBE_LAP(1);

  // step t: the costs of frame t from frame t - 1's through w (step t's
  // weights), and w_next, step t + 1's, off the chain. Steps go in pairs
  // from t = 1, so frame t + 1 opens a chunk (t + 1 a multiple of
  // kChunkFrames, t odd) only at a pair's first step (checks set), and
  // only the last step lacks frame t + 1 (last set).
  auto step = [&](int t, float(&w)[NP], float(&w_next)[NP], bool checks,
                  bool last) {
    const bool boundary =
        checks && ((t + 1) & (kChunkFrames - 1)) == 0 && !last;
    if (boundary) {  // frame t + 1 opens the next chunk
      PROBE_LAP(2);
      wait_all();
      __syncwarp();
      PROBE_LAP(3);
    }
    float p[NP];
    const float mine = voiced ? cost : CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < NP; ++i) p[i] = __shfl_sync(kFull, mine, first + i);
    const float prev_u = __shfl_sync(kFull, cost, K);
    const int row = (t & (kRing - 1)) * KP;
    const int row_next = ((last ? t : t + 1) & (kRing - 1)) * KP;
    const float lc = loc[row + own];
    weights<NP>(w_next, llr + row + first, llr[row_next + own], fw);

    float c[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) c[i] = __fadd_rn(p[i], w[i]);
    int arg;
    float best = tree_argmin<NP>(c, arg);
    arg += first;
    if constexpr (kHalves == 2) {
      // the two halves' (value, index) pairs: the lower half's indices
      // win a tie
      const float other = __shfl_xor_sync(kFull, best, KP);
      const int other_arg = __shfl_xor_sync(kFull, arg, KP);
      const bool take = first == 0 ? other < best : !(best < other);
      best = fminf(best, other);
      arg = take ? other_arg : arg;
    }
    // voiced: keep the voiced predecessor when best <= prev_u + trans;
    // unvoiced: come from the cheapest voiced state when best + trans <=
    // prev_u (pitch.py:518-528)
    const float x = voiced ? best : __fadd_rn(best, trans_cost);
    const float y = voiced ? __fadd_rn(prev_u, trans_cost) : prev_u;
    const bool take_x = x <= y;
    const float next = __fadd_rn(lc, take_x ? x : y);
    if (state_lane && first == 0) {
      bk[static_cast<size_t>(t - 1) * S + state_of_lane] =
          static_cast<int8_t>(take_x ? arg : K);
    }
    cost = next;  // lanes past K: never read before the final argmin

    if (boundary) {  // chunk (t + 1) / kChunkFrames - 1 is read: refill it
      PROBE_LAP(2);
      __syncwarp();
      stage<KP>(loc, llr, lv, lu, ll, (t + 1) / kChunkFrames + 1, T, K, vec,
                lane);
      commit();
      PROBE_LAP(3);
    }
  };
  int t = 1;
  for (; t + 2 < T; t += 2) {
    step(t, wa, wb, true, false);
    step(t + 1, wb, wa, false, false);
  }
  if (t + 1 < T) {
    step(t, wa, wb, true, false);
    step(t + 1, wb, wa, false, true);
  } else if (t < T) {
    step(t, wa, wb, true, true);
  }
  PROBE_LAP(2);

  // the cheapest final state, the first on a tie (jnp.argmin)
  float best = state_lane ? cost : CUDART_INF_F;
  int state = state_of_lane;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int os = __shfl_xor_sync(kFull, state, off);
    if (ob < best || (ob == best && os < state)) {
      best = ob;
      state = os;
    }
  }
  __syncwarp();  // every lane's backpointers, visible to the warp

  // lane l's chunk: backpointer rows [lo, hi), row r mapping the state of
  // frame r + 1 to frame r's
  const int n = T - 1;
  const int span = (n + kTraceChunks - 1) / kTraceChunks;
  const int lo = min(lane * span, n);
  const int hi = min(lo + span, n);
  // the chunk's map from its top frame's state to its bottom frame's, for
  // every state: K + 1 independent chains
  int m[KP];
#pragma unroll
  for (int s = 0; s < KP; ++s) m[s] = s;
  for (int r = hi - 1; r >= lo; --r) {
    const int8_t* row = bk + static_cast<size_t>(r) * S;
#pragma unroll
    for (int s = 0; s < KP; ++s) {
      if (s < S) m[s] = row[m[s]];
    }
  }
#pragma unroll
  for (int s = 0; s < KP; ++s) {
    if (s < S) maps[lane * KP + s] = static_cast<int8_t>(m[s]);
  }
  __syncwarp();
  // each chunk's top state, from the last chunk down
  int top = state;
  int e = state;
  for (int l = kTraceChunks - 1; l >= 0; --l) {
    if (l == lane) top = e;
    e = maps[l * KP + e];
  }
  int* out = states + static_cast<size_t>(b) * T;
  if (lane == 0) out[n] = state;
  for (int r = hi - 1; r >= lo; --r) {
    top = bk[static_cast<size_t>(r) * S + top];
    out[r] = top;
  }
  PROBE_LAP(4);
#ifdef VITERBI_PROBE
  if (lane == 0) {
    for (int i = 0; i < kPhases; ++i) {
      atomicAdd(&g_probe_cycles[i],
                static_cast<unsigned long long>(probe_cycles[i]));
    }
  }
#endif
}

template <int KP, int NP, bool kSharedBack>
cudaError_t launch(const float* local_v, const float* local_u,
                   const float* log_lag, int8_t* back, int* states, int B,
                   int T, int K, float freq_weight, float trans_cost,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<KP>(T, K, kSharedBack);
  auto kernel = viterbi_kernel<KP, NP, kSharedBack>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, 32, bytes, stream>>>(local_v, local_u, log_lag, back, states,
                                   T, K, freq_weight, trans_cost);
  return cudaGetLastError();
}

#ifdef VITERBI_PROBE
// The recurrence's irreducible step, for the latency floor: one shuffle
// round, kFloorLeaves independent adds, a log2(kFloorLeaves) min tree and
// one add, T - 1 times in a chain. One warp a block; cycles[b] the chain's
// clock64 cycles, sink[b * 32 + lane] its result (kept live).
constexpr int kFloorLeaves = 16;

__global__ void __launch_bounds__(32) viterbi_floor_kernel(
    const float* __restrict__ w_in, float* __restrict__ sink,
    long long* __restrict__ cycles, int T) {
  const int lane = threadIdx.x;
  float w[kFloorLeaves];
#pragma unroll
  for (int i = 0; i < kFloorLeaves; ++i) w[i] = w_in[i * 32 + lane];
  const float local = w_in[kFloorLeaves * 32 + lane];
  float cost = w_in[(kFloorLeaves + 1) * 32 + lane];
  __syncwarp();
  const long long start = clock64();
  for (int t = 1; t < T; ++t) {
    const float p = __shfl_sync(kFull, cost, (lane + 1) & 31);
    float c[kFloorLeaves];
#pragma unroll
    for (int i = 0; i < kFloorLeaves; ++i) c[i] = __fadd_rn(p, w[i]);
    int unused;
    cost = __fadd_rn(local, tree_argmin<kFloorLeaves>(c, unused));
  }
  const long long stop = clock64();
  sink[blockIdx.x * 32 + lane] = cost;
  if (lane == 0) cycles[blockIdx.x] = stop - start;
}
#endif

}  // namespace

extern "C" {

// local_v, log_lag [B, T, K], local_u [B, T] float32; states [B, T] int32;
// back a [B, T-1, K+1] int8 scratch where (T-1)(K+1) > kSharedBackBytes
// (the device-memory plan), else unused (may be null). Returns a
// cudaError_t (0 on success); K + 1 > kMaxStates, or a missing scratch,
// returns cudaErrorInvalidValue. Does not synchronise.
int viterbi_launch(const void* local_v, const void* local_u,
                   const void* log_lag, void* back, void* states, int B,
                   int T, int K, float freq_weight, float trans_cost,
                   int device, void* stream) {
  if (K < 1 || K + 1 > kMaxStates || T < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool shared = shared_plan(T, K);
  if (!shared && back == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* lv = static_cast<const float*>(local_v);
  const auto* lu = static_cast<const float*>(local_u);
  const auto* ll = static_cast<const float*>(log_lag);
  auto* bk = static_cast<int8_t*>(back);
  auto* st = static_cast<int*>(states);
  auto* s = static_cast<cudaStream_t>(stream);
  if (K <= kPairMaxK) {
    constexpr int np = kPairMaxK / 2;
    err = shared ? launch<16, np, true>(lv, lu, ll, bk, st, B, T, K,
                                        freq_weight, trans_cost, s)
                 : launch<16, np, false>(lv, lu, ll, bk, st, B, T, K,
                                         freq_weight, trans_cost, s);
  } else {
    err = shared ? launch<32, 32, true>(lv, lu, ll, bk, st, B, T, K,
                                        freq_weight, trans_cost, s)
                 : launch<32, 32, false>(lv, lu, ll, bk, st, B, T, K,
                                         freq_weight, trans_cost, s);
  }
  return static_cast<int>(err);
}

// The dynamic shared memory of a launch at (T, K), in bytes.
long long viterbi_shared_bytes(int T, int K) {
  const bool shared = shared_plan(T, K);
  return static_cast<long long>(K <= kPairMaxK ? smem_bytes<16>(T, K, shared)
                                              : smem_bytes<32>(T, K, shared));
}

const char* viterbi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef VITERBI_PROBE
// Cycles of each phase since the last reset, summed over blocks (lane 0
// of each).
int viterbi_probe_read(unsigned long long* cycles, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_probe_cycles,
                                         sizeof(g_probe_cycles));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(g_probe_cycles, zero, sizeof(zero));
  }
  return err;
}

// B warps of the floor kernel: w [kFloorLeaves + 2, 32] float32, sink
// [B, 32] float32, cycles [B] int64.
int viterbi_floor_launch(const void* w, void* sink, void* cycles, int B,
                         int T, void* stream) {
  viterbi_floor_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(sink),
      static_cast<long long*>(cycles), T);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // extern "C"
