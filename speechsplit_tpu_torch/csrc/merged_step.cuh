// The step machinery shared by the merged BiLSTM kernels
// (bilstm_infer.cu, bilstm_bwd.cu): asynchronous 16-byte copies into
// shared memory, a split grid barrier (and one per direction), the warp
// reduction the redesigned step products end in, and the cooperative
// launch.
//
// The split barrier replaces cooperative groups' grid.sync() where a
// block has work that does not depend on the other blocks' step: it
// arrives (release: its global stores of the step are ordered before the
// arrival), does that work, and then waits (acquire: every block's stores
// of the step are visible after it). The launch stays cooperative, so the
// grid is co-resident or the launch fails; the barrier only needs its
// counter zeroed before the launch (the wrapper passes zeroed words).
#pragma once

#include <cuda_runtime.h>

namespace step {

// cp.async.cg: a 16-byte copy from global to shared memory through L2
// only (the source may have been written by another block during the
// kernel), holding no register while in flight. A src size of 0 writes
// zeros.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

// cp.async.ca with 4 bytes, for rows that are not 16-byte aligned.
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A grid barrier split into arrive and wait, on a counter that only
// grows: the n-th wait of a block returns once all gridDim.x blocks
// have arrived n times.
struct Barrier {
  unsigned* count;
  unsigned target;

  __device__ explicit Barrier(unsigned* c) : count(c), target(0) {}

  // Called by every thread of the block after its stores of the step.
  __device__ __forceinline__ void arrive() {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(count, 1u);
    }
  }

  // Called by every thread of the block.
  __device__ __forceinline__ void wait() {
    target += gridDim.x;
    if (threadIdx.x == 0) {
      while (*static_cast<volatile unsigned*>(count) < target) {
      }
      __threadfence();
    }
    __syncthreads();
  }
};

// The same split barrier for the blocks of one direction of a merged
// layer, which read only their own direction's h: `count` is that
// direction's word, and a wait returns once its `blocks` blocks have
// arrived as often. A direction of one block needs no counter: arrive
// and wait are then __syncthreads() alone.
struct DirBarrier {
  unsigned* count;
  unsigned blocks;
  unsigned target;

  __device__ DirBarrier(unsigned* c, unsigned n)
      : count(c), blocks(n), target(0) {}

  // Called by every thread of the block after its stores of the step.
  __device__ __forceinline__ void arrive() {
    __syncthreads();
    if (blocks > 1 && threadIdx.x == 0) {
      __threadfence();
      atomicAdd(count, 1u);
    }
  }

  // Called by every thread of the block.
  __device__ __forceinline__ void wait() {
    if (blocks > 1) {
      target += blocks;
      if (threadIdx.x == 0) {
        while (*static_cast<volatile unsigned*>(count) < target) {
        }
        __threadfence();
      }
    }
    __syncthreads();
  }
};

// One level of reduce_scatter32: lanes kOff apart swap the halves of
// v[0 .. 2 kOff) each does not keep and add them to the halves they keep;
// the lane with bit kOff set keeps the upper half. Every index is a
// compile-time constant, so v stays in registers.
template <int kOff>
__device__ __forceinline__ void butterfly_level(float (&v)[32], int lane) {
  const bool upper = lane & kOff;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = upper ? v[i] : v[i + kOff];
    const float keep = upper ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
  if constexpr (kOff > 1) butterfly_level<kOff / 2>(v, lane);
}

// A warp's 32 partial sums v[i] added over its 32 lanes by a butterfly
// that halves the values a lane keeps at each level (31 shuffles in all):
// afterwards lane L's v[0] holds the warp's sum of index L. The order of
// the additions is fixed.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  butterfly_level<16>(v, lane);
  return v[0];
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

}  // namespace step
