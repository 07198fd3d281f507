// linear_scan: the linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper
// (sm_90a), h_{-1} = 0, over float32 (B, S, D) tensors.
//
// Replaces the Pallas TPU kernel `_scan_kernel` of
// src/repro/kernels/linear_scan/kernel.py (reached through `linear_scan`).
// On the TPU the grid is (B, S/chunk) with the chunk axis sequential and
// the carry h kept in VMEM scratch across chunks.  In the port it is the
// prefill recurrence of every RG-LRU layer (recurrentgemma-2b: 18 layers,
// D = lru_width 2560).
//
// What bounds it on this card: bytes.  It reads a and b once and writes h
// once, 12 bytes per element, and does 2 flops per element, so device
// memory (3.35 TB/s) sets the floor: at B 4, S 3000, D 2560 that is
// 369 MB, about 0.110 ms.
//
// Design, one thread per (b, d) channel:
// * the thread walks t = 0..S-1 in order, which is the plain version's
//   order; neighbouring threads own neighbouring d, so every load and
//   store of a warp is one coalesced 128-byte line;
// * loads of a and b do not depend on h, so each thread loads kUnroll
//   steps ahead into registers before it runs their multiply-adds: that
//   keeps kUnroll loads in flight per thread while the chain of dependent
//   multiply-adds waits on nothing but itself;
// * built with --fmad=false, so a*h + b rounds after the multiply and
//   after the add, exactly as the plain torch version's two operations
//   do: on the card the two agree bit for bit.
// Occupancy: B*D channels are B*D threads.  At B 4, D 2560 that is 10,240
// threads, 80 blocks of 128 on 132 SMs, too few loads in flight to reach
// the memory rate.  A chunked two-pass scan (chunk-local scans, then a
// scan of the chunk carries) would fill the card; that is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ h, int B, int S, int D) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * D) return;
  const int bi = idx / D;
  const int d = idx - bi * D;
  const size_t base = static_cast<size_t>(bi) * S * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float hv = 0.0f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = ap[static_cast<size_t>(t + u) * D];
      bv[u] = bp[static_cast<size_t>(t + u) * D];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = av[u] * hv + bv[u];
      hp[static_cast<size_t>(t + u) * D] = hv;
    }
  }
  for (; t < S; ++t) {
    hv = ap[static_cast<size_t>(t) * D] * hv + bp[static_cast<size_t>(t) * D];
    hp[static_cast<size_t>(t) * D] = hv;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int linear_scan_launch(const float* a, const float* b, float* h,
                                  int B, int S, int D, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  const int channels = B * D;
  const dim3 grid((channels + kThreads - 1) / kThreads);
  linear_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h, B, S, D);
  return static_cast<int>(cudaGetLastError());
}
