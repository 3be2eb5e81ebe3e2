// IIR sample recurrences of the filter oracles: a cascade of second-order
// sections (sosfilt) and the direct form (lfilter), both direct form II
// transposed, for a batch of signals.
//
// Replaces speechsplit_tpu/ops/filters.py::sosfilt (:48, the lax.scan over
// samples at :70) and ::lfilter (:104, the lax.scan at :117). JAX runs each
// as one on-device loop inside an XLA program and vmaps it over signals.
// They are not Pallas kernels. In eager PyTorch the same loop launches
// about ten small ops a sample and section, seconds for a 3 s clip, so
// both passes of the zero-phase oracles (sosfiltfilt, filtfilt,
// highpass_filtfilt) run here, one launch a pass.
//
// What bounds it on the H100: neither bytes (a signal is read once and
// written once, a few hundred KB) nor operations (9 a sample and section),
// but the chain of dependent steps: sample t of section s needs sample t
// of section s - 1 and sample t - 1 of section s. The design is the
// simplest that is right:
//   - one thread a signal, serial over samples, so a batch of B signals
//     runs B threads (the card is mostly idle: these are parity oracles;
//     the production high-pass is ops/filters.py::zero_phase_highpass, an
//     FFT);
//   - the coefficients are kernel parameters and the states registers:
//     the section count (order) is a template argument up to kMaxSections
//     (kMaxOrder), so every loop over sections unrolls and no array is
//     indexed at run time (such an array goes to local memory without a
//     spill report);
//   - every product and sum is __fmul_rn / __fadd_rn / __fsub_rn (the
//     __d*_rn ones at float64) in JAX's order of operations
//     (filters.py:63-65, :109-114), so nvcc contracts no multiply-add and
//     the output equals the plain PyTorch loop's
//     (ops/filters.py::sosfilt_reference, ::lfilter_reference) bit for
//     bit. A contracted FMA would round once where the loop rounds twice,
//     and this 30 Hz / 16 kHz high-pass (pole radius about 0.9987)
//     carries such a rounding through thousands of samples;
//   - a sample runs the chain through the cascade (each section's output)
//     before the sections' state updates, so that the updates, which no
//     later section of the sample reads, issue together off the chain;
//   - a thread loads the next kChunk samples before it steps through the
//     current ones, so that no sample waits on its own load (each thread
//     reads its own row: the loads of a warp are not coalesced, and a
//     sample loaded just before its step stalled the chain: 2.9 ms a pass
//     at B16 x 3 s float32 against a 0.65 ms floor in the first design);
//   - the pass runs forward only; the zero-phase oracles flip the signal
//     between the passes in PyTorch, as JAX does.
// iir_floor_launch times the chain alone: steps dependent multiply-adds
// in the same rounded arithmetic (chip_smoke.py's measured floor, samples
// x sections steps).

#include <cuda_runtime.h>

namespace {

// ops/filters.py reads these lines.
constexpr int kMaxSections = 8;  // sosfilt: sections a cascade
constexpr int kMaxOrder = 8;     // lfilter: len(a) - 1

constexpr int kBlock = 64;  // threads a block, one signal each
constexpr int kChunk = 16;  // samples a thread loads ahead of its steps

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// The coefficients of S sections (a0 normalized to 1), by value.
template <typename T, int S>
struct Sos {
  T b0[S], b1[S], b2[S], a1[S], a2[S];
};

// A cascade's states and one sample's step (filters.py:63-65):
//   y = b0 x + z0;  z0' = (b1 x + z1) - a1 y;  z1' = b2 x - a2 y,
// the sections' outputs first (the chain through the cascade), then
// their state updates, which no later section of the sample reads: the
// same operations, so the same roundings.
template <typename T, int S>
struct SosState {
  T z0[S], z1[S];

  __device__ __forceinline__ T step(const Sos<T, S>& c, T x) {
    T in[S], out[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      in[s] = x;
      out[s] = add(mul(c.b0[s], x), z0[s]);
      x = out[s];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      z0[s] = sub(add(mul(c.b1[s], in[s]), z1[s]), mul(c.a1[s], out[s]));
      z1[s] = sub(mul(c.b2[s], in[s]), mul(c.a2[s], out[s]));
    }
    return x;
  }
};

// The (b, a) coefficients of order NO, by value (a[0] unused: 1).
template <typename T, int NO>
struct Ba {
  T b[NO + 1], a[NO + 1];
};

// A direct form's states and one sample's step (filters.py:109-114):
//   y = b0 x + z0;  z_i' = (b_{i+1} x + z_{i+1}) - a_{i+1} y,
// z_NO taken as 0 (JAX's concatenated zero: an addition of 0.0 here too).
template <typename T, int NO>
struct BaState {
  T z[NO];

  __device__ __forceinline__ T step(const Ba<T, NO>& c, T x) {
    const T y = add(mul(c.b[0], x), z[0]);
#pragma unroll
    for (int i = 0; i + 1 < NO; ++i) {
      z[i] = sub(add(mul(c.b[i + 1], x), z[i + 1]), mul(c.a[i + 1], y));
    }
    z[NO - 1] = sub(add(mul(c.b[NO], x), T(0)), mul(c.a[NO], y));
    return y;
  }
};

// One signal's pass: the samples kChunk at a time, the next chunk's loads
// issued before this chunk's steps, so that their latency hides behind
// the chain instead of stalling each sample; the last N % kChunk samples
// one by one.
template <typename T, typename State, typename Coefs>
__device__ __forceinline__ void run_signal(const T* __restrict__ xr,
                                           T* __restrict__ yr, State& state,
                                           const Coefs& c, long long N) {
  const long long full = N / kChunk * kChunk;
  T buf[kChunk];
  if (full > 0) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) buf[k] = xr[k];
  }
  for (long long t = 0; t < full; t += kChunk) {
    T next[kChunk];
    const bool more = t + kChunk < full;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      next[k] = more ? xr[t + kChunk + k] : T(0);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) yr[t + k] = state.step(c, buf[k]);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) buf[k] = next[k];
  }
  for (long long t = full; t < N; ++t) yr[t] = state.step(c, xr[t]);
}

// x, y [M, N]; zi [M, S, 2].
template <typename T, int S>
__global__ void __launch_bounds__(kBlock)
    sosfilt_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const T* __restrict__ zi, const Sos<T, S> c, int M,
                   long long N) {
  const int m = blockIdx.x * kBlock + threadIdx.x;
  if (m >= M) return;
  SosState<T, S> state;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    state.z0[s] = zi[(static_cast<long long>(m) * S + s) * 2];
    state.z1[s] = zi[(static_cast<long long>(m) * S + s) * 2 + 1];
  }
  run_signal(x + static_cast<long long>(m) * N,
             y + static_cast<long long>(m) * N, state, c, N);
}

// x, y [M, N]; zi [M, NO].
template <typename T, int NO>
__global__ void __launch_bounds__(kBlock)
    lfilter_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const T* __restrict__ zi, const Ba<T, NO> c, int M,
                   long long N) {
  const int m = blockIdx.x * kBlock + threadIdx.x;
  if (m >= M) return;
  BaState<T, NO> state;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    state.z[i] = zi[static_cast<long long>(m) * NO + i];
  }
  run_signal(x + static_cast<long long>(m) * N,
             y + static_cast<long long>(m) * N, state, c, N);
}

// The measured floor: each thread runs `steps` dependent multiply-adds,
// v = v * a + d, rounded as the filters round.
template <typename T>
__global__ void __launch_bounds__(kBlock)
    iir_floor_kernel(T* __restrict__ sink, int M, long long steps) {
  const int m = blockIdx.x * kBlock + threadIdx.x;
  if (m >= M) return;
  T v = sink[m];
  const T a = T(0.5), d = T(0.25);
#pragma unroll 8
  for (long long i = 0; i < steps; ++i) v = add(mul(v, a), d);
  sink[m] = v;
}

int blocks(int M) { return (M + kBlock - 1) / kBlock; }

template <typename T, int S>
cudaError_t launch_sos(const void* x, void* y, const void* zi,
                       const double* sos, int M, long long N,
                       cudaStream_t stream) {
  Sos<T, S> c;
  for (int s = 0; s < S; ++s) {
    c.b0[s] = static_cast<T>(sos[6 * s]);
    c.b1[s] = static_cast<T>(sos[6 * s + 1]);
    c.b2[s] = static_cast<T>(sos[6 * s + 2]);
    c.a1[s] = static_cast<T>(sos[6 * s + 4]);
    c.a2[s] = static_cast<T>(sos[6 * s + 5]);
  }
  sosfilt_kernel<T, S><<<blocks(M), kBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(zi), c, M, N);
  return cudaGetLastError();
}

template <typename T, int S = 1>
cudaError_t dispatch_sos(int sections, const void* x, void* y,
                         const void* zi, const double* sos, int M,
                         long long N, cudaStream_t stream) {
  if constexpr (S > kMaxSections) {
    return cudaErrorInvalidValue;
  } else {
    if (sections == S) return launch_sos<T, S>(x, y, zi, sos, M, N, stream);
    return dispatch_sos<T, S + 1>(sections, x, y, zi, sos, M, N, stream);
  }
}

template <typename T, int NO>
cudaError_t launch_ba(const void* x, void* y, const void* zi,
                      const double* b, const double* a, int M, long long N,
                      cudaStream_t stream) {
  Ba<T, NO> c;
  for (int i = 0; i <= NO; ++i) {
    c.b[i] = static_cast<T>(b[i]);
    c.a[i] = static_cast<T>(a[i]);
  }
  lfilter_kernel<T, NO><<<blocks(M), kBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(zi), c, M, N);
  return cudaGetLastError();
}

template <typename T, int NO = 1>
cudaError_t dispatch_ba(int order, const void* x, void* y, const void* zi,
                        const double* b, const double* a, int M,
                        long long N, cudaStream_t stream) {
  if constexpr (NO > kMaxOrder) {
    return cudaErrorInvalidValue;
  } else {
    if (order == NO) return launch_ba<T, NO>(x, y, zi, b, a, M, N, stream);
    return dispatch_ba<T, NO + 1>(order, x, y, zi, b, a, M, N, stream);
  }
}

}  // namespace

extern "C" {

// x, y [M, N] and zi [M, sections, 2], all float32 (dtype 0) or float64
// (dtype 1), contiguous; sos [sections, 6] float64 on the host, cast to
// the dtype here (round to nearest, as a tensor cast). Returns a
// cudaError_t (0 on success); sections outside 1..kMaxSections or another
// dtype return cudaErrorInvalidValue. Does not synchronise.
int iir_sosfilt_launch(const void* x, void* y, const void* zi,
                       const double* sos, int sections, int M, long long N,
                       int dtype, int device, void* stream) {
  if (sections < 1 || sections > kMaxSections || M < 1 || N < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? dispatch_sos<float>(sections, x, y, zi, sos, M, N, s)
            : dispatch_sos<double>(sections, x, y, zi, sos, M, N, s);
  return static_cast<int>(err);
}

// x, y [M, N] and zi [M, order] as above; b, a [order + 1] float64 on the
// host. order outside 1..kMaxOrder returns cudaErrorInvalidValue.
int iir_lfilter_launch(const void* x, void* y, const void* zi,
                       const double* b, const double* a, int order, int M,
                       long long N, int dtype, int device, void* stream) {
  if (order < 1 || order > kMaxOrder || M < 1 || N < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? dispatch_ba<float>(order, x, y, zi, b, a, M, N, s)
                   : dispatch_ba<double>(order, x, y, zi, b, a, M, N, s);
  return static_cast<int>(err);
}

// M threads of the floor kernel on sink [M] (float32 or float64 by dtype).
int iir_floor_launch(void* sink, int M, long long steps, int dtype,
                     void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    iir_floor_kernel<float><<<blocks(M), kBlock, 0, s>>>(
        static_cast<float*>(sink), M, steps);
  } else {
    iir_floor_kernel<double><<<blocks(M), kBlock, 0, s>>>(
        static_cast<double*>(sink), M, steps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* iir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
