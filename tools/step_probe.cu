// A probe of the step machinery the merged BiLSTM kernels can use on
// one H100, run by tools/step_probe.py:
// - whether a cooperative launch takes a cluster dimension, and how many
//   clusters of 1-16 blocks of 256 threads and 200 KiB of shared memory
//   the card holds at once (a grid of 128 such blocks must be
//   co-resident), with a grid.sync() and a distributed-shared-memory
//   read checked inside;
// - the cost of grid.sync() against a barrier on a global counter;
// - the cost, per step of 192, of staging the same tile into all 128
//   blocks: __ldcg float4 loads or 16-byte cp.async, in one order or
//   from each block's own offset, or half a tile each through a
//   cluster's distributed shared memory; tiles of 128 KiB (d_pre at B16
//   H512), 32 KiB and 112 KiB (h at B56 H512).
// Prints one PROBE line per measurement.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdlib>

namespace cg = cooperative_groups;

#define CK(x) do { cudaError_t e_ = (x); if (e_ != cudaSuccess) { \
  printf("ERR %s: %s\n", #x, cudaGetErrorString(e_)); } } while (0)

__device__ __forceinline__ void bar_arrive(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
  }
}
__device__ __forceinline__ void bar_wait(unsigned* bar, unsigned target) {
  if (threadIdx.x == 0) {
    while (*(volatile unsigned*)bar < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void k_check(int* out, int steps) {
  extern __shared__ float sm[];
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cl = cg::this_cluster();
  unsigned rank = cl.block_rank();
  if (threadIdx.x == 0) sm[0] = (float)blockIdx.x;
  cl.sync();
  float* peer = cl.map_shared_rank(sm, (rank + 1) % cl.num_blocks());
  int got = (int)peer[0];
  cl.sync();
  for (int s = 0; s < steps; ++s) {
    if (threadIdx.x == 0) atomicAdd(out + 0, 1);
    grid.sync();
    if (threadIdx.x == 0 && atomicAdd(out + 0, 0) < (s + 1) * (int)gridDim.x)
      atomicAdd(out + 1, 1);
    grid.sync();
  }
  if (threadIdx.x == 0) out[2 + blockIdx.x] = got;
}

// mode 0: grid.sync only; 1: own barrier only
__global__ void k_bar(unsigned* bar, int steps, int mode) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < steps; ++s) {
    if (mode == 0) {
      grid.sync();
    } else {
      bar_arrive(bar);
      bar_wait(bar, (s + 1) * gridDim.x);
    }
  }
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// every block stages n floats of src into smem, then a grid barrier
// mode 0: __ldcg float4 loop, same order; 1: rotated by block;
// 2: cp.async 16B same order; 3: cp.async rotated;
// 4: cluster split (cp.async own 1/N, then DSMEM copy of the rest)
// 5: barrier only
__global__ void k_stage(const float* src, float* sink, unsigned* bar, int n,
                        int steps, int mode) {
  extern __shared__ __align__(16) float sm[];
  const int n4 = n / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(sm);
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    if (mode == 0 || mode == 1) {
      const int rot = mode == 1 ? (blockIdx.x * 97) % n4 : 0;
      for (int i = threadIdx.x; i < n4; i += blockDim.x) {
        int j = i + rot;
        if (j >= n4) j -= n4;
        d4[j] = __ldcg(s4 + j);
      }
      __syncthreads();
    } else if (mode == 2 || mode == 3) {
      const int rot = mode == 3 ? (blockIdx.x * 97) % n4 : 0;
      for (int i = threadIdx.x; i < n4; i += blockDim.x) {
        int j = i + rot;
        if (j >= n4) j -= n4;
        cp16(sm + 4 * j, src + 4 * j);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
    } else if (mode == 4) {
      cg::cluster_group cl = cg::this_cluster();
      const int nb = cl.num_blocks();
      const int r = cl.block_rank();
      const int part = n4 / nb;
      for (int i = threadIdx.x; i < part; i += blockDim.x) {
        cp16(sm + 4 * (r * part + i), src + 4 * (r * part + i));
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      cl.sync();
      for (int q = 1; q < nb; ++q) {
        const int p = (r + q) % nb;
        const float4* peer =
            reinterpret_cast<const float4*>(cl.map_shared_rank(sm, p));
        for (int i = threadIdx.x; i < part; i += blockDim.x) {
          d4[p * part + i] = peer[p * part + i];
        }
      }
      cl.sync();
    }
    acc += sm[(threadIdx.x * 7 + s) % n];
    bar_arrive(bar);
    bar_wait(bar, (s + 1) * gridDim.x);
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, int grid, int threads, size_t smem, int cluster,
                   bool coop, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attrs[2];
  int na = 0;
  if (coop) {
    attrs[na].id = cudaLaunchAttributeCooperative;
    attrs[na].val.cooperative = 1;
    ++na;
  }
  if (cluster > 1) {
    attrs[na].id = cudaLaunchAttributeClusterDimension;
    attrs[na].val.clusterDim.x = cluster;
    attrs[na].val.clusterDim.y = 1;
    attrs[na].val.clusterDim.z = 1;
    ++na;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = na;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

int main() {
  const int grid = 128, threads = 256;
  const size_t smem = 200 * 1024;
  int* out;
  unsigned* bar;
  CK(cudaMalloc(&out, 4096 * sizeof(int)));
  CK(cudaMalloc(&bar, sizeof(unsigned)));
  CK(cudaFuncSetAttribute(k_check, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          (int)smem));
  CK(cudaFuncSetAttribute(k_check,
                          cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  CK(cudaFuncSetAttribute(k_stage, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          (int)smem));
  CK(cudaFuncSetAttribute(k_stage,
                          cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  int host[2 + 128];
  int cl_ok[17] = {0};
  for (int cluster : {1, 2, 4, 8, 16}) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute a;
    a.id = cudaLaunchAttributeClusterDimension;
    a.val.clusterDim.x = cluster;
    a.val.clusterDim.y = 1;
    a.val.clusterDim.z = 1;
    cfg.attrs = &a;
    cfg.numAttrs = 1;
    int nclusters = -1;
    cudaError_t oe = cudaOccupancyMaxActiveClusters(&nclusters, k_check, &cfg);
    CK(cudaMemset(out, 0, 4096 * sizeof(int)));
    cudaError_t le = launch(k_check, grid, threads, smem, cluster, true, out, 20);
    cudaError_t se = cudaDeviceSynchronize();
    CK(cudaMemcpy(host, out, sizeof(host), cudaMemcpyDeviceToHost));
    int bad_peer = 0;
    for (int b = 0; b < grid; ++b) {
      int want = (b / cluster) * cluster + ((b % cluster) + 1) % cluster;
      if (host[2 + b] != want) ++bad_peer;
    }
    printf("PROBE cluster=%d max_active_clusters=%d (%s) need=%d launch=%s "
           "sync=%s arrivals=%d barrier_errors=%d bad_peer=%d\n",
           cluster, nclusters, cudaGetErrorString(oe), grid / cluster,
           cudaGetErrorString(le), cudaGetErrorString(se), host[0], host[1],
           bad_peer);
    if (le == cudaSuccess && se == cudaSuccess && host[1] == 0 &&
        bad_peer == 0)
      cl_ok[cluster] = 1;
    cudaGetLastError();
  }
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  const int steps = 2000;
  for (int mode = 0; mode < 2; ++mode) {
    for (int rep = 0; rep < 2; ++rep) {
      CK(cudaMemset(bar, 0, sizeof(unsigned)));
      CK(cudaEventRecord(e0));
      CK(launch(k_bar, grid, threads, 0, 1, true, bar, steps, mode));
      CK(cudaEventRecord(e1));
      CK(cudaEventSynchronize(e1));
      float ms = 0;
      CK(cudaEventElapsedTime(&ms, e0, e1));
      if (rep) printf("PROBE barrier mode=%s us_per_barrier=%.4f\n",
                      mode ? "own_counter" : "grid.sync", ms * 1e3 / steps);
    }
  }
  float* src;
  float* sink;
  const int n = 16 * 2048;  // B16 x 4H at H=512: 128 KiB
  CK(cudaMalloc(&src, n * sizeof(float) * 4));
  CK(cudaMemset(src, 0, n * sizeof(float) * 4));
  CK(cudaMalloc(&sink, grid * threads * sizeof(float)));
  const char* names[] = {"ldcg_same", "ldcg_rotated", "cpasync_same",
                         "cpasync_rotated", "cluster_dsmem", "barrier_only"};
  for (int nn : {n, n / 4, 56 * 512}) {
    for (int mode = 0; mode < 6; ++mode) {
      for (int cluster : {1, 2, 4, 8}) {
        if ((mode == 4) != (cluster > 1)) continue;
        if (cluster > 1 && !cl_ok[cluster]) continue;
        float best = 1e30f;
        for (int rep = 0; rep < 3; ++rep) {
          CK(cudaMemset(bar, 0, sizeof(unsigned)));
          CK(cudaEventRecord(e0));
          cudaError_t le = launch(k_stage, grid, threads, smem, cluster, true,
                                  (const float*)src, sink, bar, nn, 192, mode);
          if (le != cudaSuccess) {
            printf("ERR launch mode %d cluster %d: %s\n", mode, cluster,
                   cudaGetErrorString(le));
            cudaGetLastError();
            break;
          }
          CK(cudaEventRecord(e1));
          CK(cudaEventSynchronize(e1));
          float ms = 0;
          CK(cudaEventElapsedTime(&ms, e0, e1));
          if (rep && ms < best) best = ms;
        }
        printf("PROBE stage floats=%d mode=%s cluster=%d us_per_step=%.4f\n",
               nn, names[mode], cluster, best * 1e3 / 192);
      }
    }
  }
  CK(cudaDeviceSynchronize());
  printf("PROBE done\n");
  return 0;
}
