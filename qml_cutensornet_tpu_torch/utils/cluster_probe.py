"""Latency probe for the synchronisation rounds of the cluster kernels.

    python3 -m qml_cutensornet_tpu_torch.utils.cluster_probe   # needs one H100

Builds a small standalone CUDA program (``build/probe/``, gitignored) and
prints, on the card, the time of one round of each kind, from CUDA events
around a kernel that runs many rounds back to back (one round per loop
iteration; every value read feeds the next round, so nothing overlaps):

- ``syncthreads`` at 256 and 1024 threads: write a shared slot, one
  ``__syncthreads``, read a neighbour's slot (double-buffered slots, so one
  barrier a round);
- ``block reduction`` at 256 threads: the reduction round of a block-wide
  BCGS2 chain (a block sum: warp shuffles, two barriers, a sum of the warps'
  partials);
- ``cluster barrier`` for C = 2, 4, 8: ``barrier.cluster.arrive`` + ``wait``
  alone;
- ``cluster round`` for C = 2, 4, 8: one scalar reduced over the cluster as
  the cluster kernels do it (warp shuffles, the warps' partials summed in
  shared memory, the CTA's partial written to a double-buffered slot, one
  cluster barrier, then every thread adds the C partials read over
  distributed shared memory in rank order);
- ``cluster vector round`` for C = 2, 4, 8: 1024 values reduced over the
  cluster (each of 256 threads reads 4 values from each of the C CTAs).

Each kind runs on 16 thread blocks or clusters at once (about the occupancy
of one sim batch). The last lines are the card's name and power limit and a
JSON object of the times in microseconds.
"""

from __future__ import annotations

import json
import subprocess
import sys

from qml_cutensornet_tpu_torch.ops import _build
from qml_cutensornet_tpu_torch.utils.device import nvidia_smi

PROBE_DIR = _build.BUILD_DIR.parent / "probe"

SOURCE = r"""
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NT>
__global__ void __launch_bounds__(NT) k_syncthreads(int iters, float* out) {
  __shared__ float buf[2][NT];
  float acc = threadIdx.x * 1e-3f;
  for (int i = 0; i < iters; ++i) {
    buf[i & 1][threadIdx.x] = acc;
    __syncthreads();
    acc = 0.5f * acc + buf[i & 1][(threadIdx.x + 1) % NT];
  }
  out[blockIdx.x * NT + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(256) k_block_reduce(int iters, float* out) {
  __shared__ float red[8];
  float acc = threadIdx.x * 1e-3f;
  for (int i = 0; i < iters; ++i) {
    float v = warp_sum(acc);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w];
    acc = 0.5f * acc + 1e-6f * s;
  }
  out[blockIdx.x * 256 + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(256) k_cluster_barrier(int iters, float* out) {
  cg::cluster_group cl = cg::this_cluster();
  float acc = threadIdx.x * 1e-3f;
  for (int i = 0; i < iters; ++i) {
    cl.sync();
    acc = acc * 0.999f + 1.f;
  }
  out[blockIdx.x * 256 + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(256) k_cluster_round(int iters, float* out) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ float red[8];
  __shared__ float slot[2];
  const int C = (int)cl.num_blocks();
  float acc = threadIdx.x * 1e-3f;
  for (int i = 0; i < iters; ++i) {
    float v = warp_sum(acc);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x < 32) {
      float s = threadIdx.x < 8 ? red[threadIdx.x] : 0.f;
      s = warp_sum(s);
      if (threadIdx.x == 0) slot[i & 1] = s;
    }
    cl.sync();
    float tot = 0.f;
    for (int c = 0; c < C; ++c) tot += *cl.map_shared_rank(&slot[i & 1], c);
    acc = 0.5f * acc + 1e-6f * tot;
  }
  out[blockIdx.x * 256 + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(256) k_cluster_vector(int iters, float* out) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ float slot[2][1024];
  __shared__ float sum[1024];
  const int C = (int)cl.num_blocks();
  float acc = threadIdx.x * 1e-3f;
  for (int i = 0; i < iters; ++i) {
    for (int u = 0; u < 4; ++u) slot[i & 1][threadIdx.x + 256 * u] = acc + u;
    cl.sync();
    for (int u = 0; u < 4; ++u) {
      float t = 0.f;
      for (int c = 0; c < C; ++c) t += cl.map_shared_rank(&slot[i & 1][0], c)[threadIdx.x + 256 * u];
      sum[threadIdx.x + 256 * u] = t;
    }
    __syncthreads();
    acc = 0.5f * acc + 1e-6f * sum[(threadIdx.x * 4 + 1) % 1024];
  }
  out[blockIdx.x * 256 + threadIdx.x] = acc;
}

typedef void (*Kern)(int, float*);

static float run(Kern k, int cluster, int nthreads, int nunits, int iters, float* out) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(nunits * cluster);
  cfg.blockDim = dim3(nthreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = 0;
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchKernelEx(&cfg, k, 100, out);  // warm-up
  cudaEventRecord(a);
  cudaLaunchKernelEx(&cfg, k, iters, out);
  cudaEventRecord(b);
  cudaError_t e = cudaEventSynchronize(b);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) {
    fprintf(stderr, "launch failed: %s\n", cudaGetErrorString(e));
    return -1.f;
  }
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms * 1e3f / iters;  // microseconds per round
}

int main() {
  const int iters = 20000, units = 16;
  float* out;
  cudaMalloc(&out, 16 * 1024 * 8 * sizeof(float));
  printf("{\"syncthreads_256_us\": %.5f", run(k_syncthreads<256>, 1, 256, units, iters, out));
  printf(", \"syncthreads_1024_us\": %.5f", run(k_syncthreads<1024>, 1, 1024, units, iters, out));
  printf(", \"block_reduce_256_us\": %.5f", run(k_block_reduce, 1, 256, units, iters, out));
  for (int C = 2; C <= 8; C *= 2) {
    printf(", \"cluster_barrier_C%d_us\": %.5f", C, run(k_cluster_barrier, C, 256, units, iters, out));
    printf(", \"cluster_round_C%d_us\": %.5f", C, run(k_cluster_round, C, 256, units, iters, out));
    printf(", \"cluster_vector_round_C%d_us\": %.5f", C,
           run(k_cluster_vector, C, 256, units, iters, out));
  }
  printf("}\n");
  cudaFree(out);
  return 0;
}
"""


def main() -> int:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src, exe = PROBE_DIR / "cluster_probe.cu", PROBE_DIR / "cluster_probe"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-o", str(exe), str(src)], check=True)
    res = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300)
    sys.stderr.write(res.stderr)
    if res.returncode != 0:
        return res.returncode
    times = json.loads(res.stdout.strip().splitlines()[-1])
    print(nvidia_smi())
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
