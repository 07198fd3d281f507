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
// 369 MB, about 0.110 ms.  The recurrence itself is short beside it: one
// channel's chain of S dependent multiplies and adds is some 8 cycles a
// step, 3000 steps about 13 us.  So the chain stays sequential per channel,
// in the plain loop's order (bitwise equal to it), and the design's work
// is to keep enough bytes in flight.
//
// Two designs, chosen by the wrapper from the shape and the pointers:
//
// "ring" (linear_scan_ring_launch): one warp per block owns 32 consecutive
// channels of one batch row over all of S (at B 4, D 2560: 320 blocks,
// all resident at three an SM).  Lane 0 keeps a ring of kStages stages in
// shared memory full with TMA copies: each stage holds kSteps time steps
// x 32 channels of a and of b (a 128-byte row per step per array), copied
// as one (kSteps, 32) box per array through a 3-D tensor map over
// (D, S, B) and completed on the stage's mbarrier.  The warp, lane =
// channel, waits on the stage and walks its steps in order (h = a*h + b,
// a rounded multiply then a rounded add) into one of two staging tiles;
// lane 0 stores the tile with one TMA store and refills the stage kStages
// chunks ahead.  That keeps kStages x 16 KB of loads in flight per block,
// some 15 MB across the card against the ~3.4 MB that the memory's
// latency asks for, while no thread spends registers or instructions on
// addresses, loads or global stores.  (Storing h from the lanes with
// coalesced 128-byte stores and a fourth stage ran no faster at B 4 and
// slower at B 1 on the H100.)  The tensor maps zero-fill the box past D
// and past S on loads and clip it on stores, so the ragged last channel
// tile and the last chunk need no special case beyond the step count.
// TMA needs 16-byte aligned rows: D a multiple of 4 and a, b and h on
// 16-byte boundaries.
//
// "direct" (linear_scan_launch), every other shape: one thread per
// (b, d) channel walks t = 0..S-1 in order, loading kUnroll steps ahead
// into registers; neighbouring threads own neighbouring d, so every load
// and store of a warp is one coalesced line.  It has few loads in flight
// (B*D threads), so it is slow at the serving shapes, which never take it.
//
// Both are built with --fmad=false, so a*h + b rounds after the multiply
// and after the add, exactly as the plain torch version's two operations
// do: on the card both designs agree with it bit for bit.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

constexpr int kTileD = 32;                       // channels per ring block
constexpr int kSteps = 64;                       // time steps per stage
constexpr int kStages = 3;
constexpr int kStageFloats = kSteps * kTileD;    // one array's stage
constexpr uint32_t kStageBytes = kStageFloats * 4;
constexpr int kRingSmem = 128                    // alignment slack
    + (kStages * 2 + 2) * kStageFloats * 4 + kStages * 8;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Lane 0: copy chunk `c` of a and b (kSteps steps from c * kSteps, the
// block's 32 channels from d0, batch row bi) into `stage`, completing on
// `bar`.
__device__ __forceinline__ void load_chunk(const CUtensorMap* map_a,
                                           const CUtensorMap* map_b,
                                           float* stage, uint32_t bar,
                                           int d0, int c, int bi) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(2 * kStageBytes) : "memory");
  const int t0 = c * kSteps;
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_addr(stage)), "l"(reinterpret_cast<uint64_t>(map_a)),
      "r"(d0), "r"(t0), "r"(bi), "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_addr(stage + kStageFloats)),
      "l"(reinterpret_cast<uint64_t>(map_b)), "r"(d0), "r"(t0), "r"(bi),
      "r"(bar)
      : "memory");
}

__global__ void __launch_bounds__(32)
linear_scan_ring_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const __grid_constant__ CUtensorMap map_h, int S,
                        int D, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  // TMA writes boxes to 128-byte aligned shared memory
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* stg = ring + kStages * 2 * kStageFloats;
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + 2 * kStageFloats);
  const int lane = threadIdx.x;
  const int bi = blockIdx.x / tiles;
  const int d0 = (blockIdx.x - bi * tiles) * kTileD;
  const int chunks = (S + kSteps - 1) / kSteps;

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int c = 0; c < kStages && c < chunks; ++c)
      load_chunk(&map_a, &map_b, ring + c * 2 * kStageFloats,
                 smem_addr(full + c), d0, c, bi);
  }
  __syncwarp();

  float hv = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kStages;
    const float* as = ring + s * 2 * kStageFloats;
    const float* bs = as + kStageFloats;
    float* hs = stg + (c & 1) * kStageFloats;
    // the store that last read this staging tile (chunk c - 2) is done
    // reading it once at most one store group (chunk c - 1) is pending
    if (lane == 0)
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncwarp();
    wait_parity(smem_addr(full + s), (c / kStages) & 1);
    const int steps = min(kSteps, S - c * kSteps);
    if (steps == kSteps) {
#pragma unroll 16
      for (int u = 0; u < kSteps; ++u) {
        hv = as[u * kTileD + lane] * hv + bs[u * kTileD + lane];
        hs[u * kTileD + lane] = hv;
      }
    } else {
      for (int u = 0; u < steps; ++u) {
        hv = as[u * kTileD + lane] * hv + bs[u * kTileD + lane];
        hs[u * kTileD + lane] = hv;
      }
    }
    // each lane's writes to the tile, before the TMA store reads it; every
    // lane has also read the stage, so lane 0 may refill it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
          " [%0, {%2, %3, %4}], [%1];\n"
          ::"l"(reinterpret_cast<uint64_t>(&map_h)), "r"(smem_addr(hs)),
          "r"(d0), "r"(c * kSteps), "r"(bi)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (c + kStages < chunks) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_chunk(&map_a, &map_b, ring + s * 2 * kStageFloats,
                   smem_addr(full + s), d0, c + kStages, bi);
      }
    }
  }
  // the last stores read shared memory until they complete
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query, so the library needs no -lcuda; null if not found.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (kSteps, 32) box of x over the (D, S, B) float32 tensor; 0 = encoded.
int encode_map(EncodeTiled encode, CUtensorMap* map, const float* x, int B,
               int S, int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(S) * D * 4};
  const cuuint32_t box[3] = {kTileD, kSteps, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace

// The direct design.  Launches on `stream`; returns cudaGetLastError()
// (0 = launched).
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

// The ring design, same arguments.  Refuses (cudaErrorInvalidValue) a
// shape or pointer that TMA cannot describe: D no multiple of 4, or a, b
// or h off a 16-byte boundary.  Returns cudaGetLastError() (0 = launched).
extern "C" int linear_scan_ring_launch(const float* a, const float* b,
                                       float* h, int B, int S, int D,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  if (D % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(h) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a, map_b, map_h;
  if (encode_map(encode, &map_a, a, B, S, D) != 0 ||
      encode_map(encode, &map_b, b, B, S, D) != 0 ||
      encode_map(encode, &map_h, h, B, S, D) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(linear_scan_ring_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRingSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (D + kTileD - 1) / kTileD;
  linear_scan_ring_kernel<<<B * tiles, 32, kRingSmem,
                            static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, map_h, S, D, tiles);
  return static_cast<int>(cudaGetLastError());
}
