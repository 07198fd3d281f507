// expert_matmul: the batched expert product of the capacity-buffer MoE,
// out[e, c, f] = cast(sum_d buf[e, c, d] * w[e, d, f]), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_gmm_kernel` of
// src/repro/kernels/moe_gmm/kernel.py:20 (reached through
// `expert_matmul`, kernel.py:37).  Same function: buf (E, C, D) and
// w (E, D, F) of one type (fp32 or bf16), an fp32 accumulator, the output
// (E, C, F) cast once to buf's type.  Not the same block structure: the
// Pallas grid (E, C/bc, F/bf, D/bd) carries a VMEM accumulator across its
// sequential D axis and needs C, F and D to be multiples of its blocks;
// Hopper blocks run in no order, so here the D loop lives inside the
// block and ragged C, D and F edges are masked in the kernel.
//
// What bounds it on this card, at the shapes of granite-moe-3b-a800m
// serving (E 40, D 1536, F 512):
// * prefill, C 2000: the gate and up launches (40, 2000, 1536) x
//   (40, 1536, 512) and the down launch (40, 2000, 512) x (40, 512, 1536)
//   each need 1.258e11 flops against about 0.39 GB moved, 322 flops a
//   byte against the card's 295, so operations bound them: 0.127 ms at
//   the 989 TFLOP/s bf16 tensor-core rate;
// * decode, C 8: each launch reads one 62.9 MB expert weight tensor for
//   5.0e8 flops, so bytes bound it: 0.019 ms at 3.35 TB/s.
//
// Two designs; the wrapper picks one before it launches and passes it
// here (`design`), nothing falls back after a launch.
//
// The tensor-core design (design 1; bf16 with D and F multiples of 8, so
// every row starts on a 16-byte boundary).  Both variants copy their
// operands into a ring of shared-memory stages with 16-byte cp.async
// copies, the next slabs in flight while the tensor cores work on the
// current one; the slabs are XOR-swizzled (tensor_core.cuh) so every copy
// and every operand read is free of bank conflicts; rows past C, depth
// past D and columns past F are copied as zeros (source size 0) and not
// stored; the sum over D runs in one fixed order, so a launch's result is
// the same bits every time.
// * prefill (C > 16), operations-bound: wgmma.  One block per 128 x 128
//   output tile of one expert (2560 blocks for gate/up, 7680 for down),
//   grid (F / 128, C / 128, E), columns fastest so neighbouring blocks
//   share buf's rows and one expert's weights in L2.  Two warpgroups of
//   64 rows each issue wgmma.m64n128k16 (bf16 in, fp32 accumulators in
//   registers) straight from shared memory; buf's 64-deep slab is K-major
//   and w's is MN-major (wgmma's transposed B), both in the 128-byte
//   swizzle.  Three stages, two slabs loading ahead, and at most 128
//   registers a thread, so two blocks share an SM; the finished tile
//   leaves through shared memory as 16-byte row segments (the down
//   launch writes 246 MB).  Measured with more stages, a persistent grid,
//   256-row tiles and a wgmma group kept in flight across slabs: all
//   slower on this card than two resident blocks;
// * decode (C <= 16), bytes-bound: mma.sync.m16n8k16 fed by ldmatrix
//   (buf) and ldmatrix.trans (w, row-major, N contiguous).  16-row tiles
//   (rows past C are zeros, never read from memory) 64 columns wide (320
//   blocks for gate/up, 960 for down; four fit on an SM, 528 at once
//   across the 132 SMs), BK 64 and four stages, so each block keeps
//   three slabs of w, 24 KB, in flight (more stages, wider or deeper
//   slabs measured no faster); buf's 16-row slab rides in the same ring
//   (2 KB a stage, from L2);
// * not yet used: TMA, warp specialisation, thread-block clusters, and
//   one fused gate-and-up launch.
//
// The FMA design (design 0; float32, and bf16 whose D or F is no multiple
// of 8): tensor cores would compute float32 in TF32 and break the 1e-5
// tolerance, so it runs on the fp32 FMA units (67 TFLOP/s) and cannot
// come within 14x of the prefill bound:
// * grid (ceil(F / 64), ceil(C / BM), E): one block of 256 threads per
//   BM x 64 output tile of one expert, BM = 64 for C > 16 and BM = 16
//   for the decode's C <= 16 (four times fewer zero rows computed);
// * D is walked in slabs of 32: each slab of buf (BM x 32) and w
//   (32 x 64) is read with neighbouring threads on neighbouring
//   addresses, converted to fp32 and staged in shared memory; the next
//   slab's loads are issued into registers before the current slab's
//   multiply-adds, so their latency hides behind the arithmetic;
// * the 16 x 16 threads own BM/16 rows x 4 neighbouring columns each:
//   per step of d one 16-byte shared load of w's four columns, the
//   rows' values (one 16-byte load at BM = 64, broadcast across the
//   warp), and 4 * BM/16 fmas into fp32 registers;
// * buf's slab is stored transposed (d-major) with rows padded to 68
//   floats, so a thread's 4 rows sit in one aligned 16-byte word;
// * rows past C, depth past D and columns past F are loaded as zeros and
//   not stored, so any shape is taken.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBN = 64;               // output columns per block
constexpr int kBK = 32;               // depth per shared-memory slab
constexpr int kThreads = 256;         // 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
expert_matmul_kernel(const T* __restrict__ buf, const T* __restrict__ w,
                     T* __restrict__ out, int C, int D, int F) {
  constexpr int kRM = BM / 16;                 // rows per thread
  constexpr int kAS = BM + 4;                  // padded row of As
  constexpr int kALoads = BM * kBK / kThreads; // buf values per thread
  constexpr int kBLoads = kBK * kBN / kThreads;
  static_assert(kRM == 1 || kRM % 4 == 0, "rows per thread: 1 or 4k");
  __shared__ __align__(16) float As[kBK][kAS];   // [d][c]
  __shared__ __align__(16) float Bs[kBK][kBN];   // [d][f]

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * kBN;
  const T* A = buf + static_cast<size_t>(e) * C * D;
  const T* B = w + static_cast<size_t>(e) * D * F;
  T* O = out + static_cast<size_t>(e) * C * F;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float ra[kALoads], rb[kBLoads];
  auto load = [&](int d0) {
#pragma unroll
    for (int r = 0; r < kALoads; ++r) {
      const int idx = tid + kThreads * r;
      const int c = c0 + idx / kBK;
      const int d = d0 + idx % kBK;
      ra[r] = (c < C && d < D) ? to_f(A[static_cast<size_t>(c) * D + d])
                               : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBLoads; ++r) {
      const int idx = tid + kThreads * r;
      const int d = d0 + idx / kBN;
      const int f = f0 + idx % kBN;
      rb[r] = (d < D && f < F) ? to_f(B[static_cast<size_t>(d) * F + f])
                               : 0.f;
    }
  };

  float acc[kRM][4];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  for (int d0 = 0; d0 < D; d0 += kBK) {
#pragma unroll
    for (int r = 0; r < kALoads; ++r) {
      const int idx = tid + kThreads * r;
      As[idx % kBK][idx / kBK] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < kBLoads; ++r) {
      const int idx = tid + kThreads * r;
      Bs[idx / kBN][idx % kBN] = rb[r];
    }
    __syncthreads();
    if (d0 + kBK < D) load(d0 + kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      float a[kRM];
      if constexpr (kRM == 1) {
        a[0] = As[k][ty];
      } else {
#pragma unroll
        for (int i = 0; i < kRM; i += 4) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(&As[k][ty * kRM + i]);
          a[i] = a4.x;
          a[i + 1] = a4.y;
          a[i + 2] = a4.z;
          a[i + 3] = a4.w;
        }
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int c = c0 + ty * kRM + i;
    if (c >= C) continue;
    T* orow = O + static_cast<size_t>(c) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < F) orow[f] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* buf, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  const T* b = static_cast<const T*>(buf);
  const T* ww = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (C <= 16) {
    const dim3 grid((F + kBN - 1) / kBN, (C + 15) / 16, E);
    expert_matmul_kernel<T, 16><<<grid, kThreads, 0, stream>>>(b, ww, o, C,
                                                               D, F);
  } else {
    const dim3 grid((F + kBN - 1) / kBN, (C + 63) / 64, E);
    expert_matmul_kernel<T, 64><<<grid, kThreads, 0, stream>>>(b, ww, o, C,
                                                               D, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
namespace {

// decode on mma.sync: one block of 4 warps per 16 x 64 output tile, each
// warp 16 columns (two n8 tiles); 64-deep slabs, four stages (40 KB, four
// blocks an SM).  buf's slab is row-major (K contiguous) and read through
// ldmatrix; w's slab is row-major (N contiguous) and read through
// ldmatrix.trans
struct DecodeTile {
  static constexpr int kBM = 16, kBN = 64, kBK = 64, kWN = 16;
  static constexpr int kThreads = 32 * kBN / kWN, kStages = 4;
  static constexpr int kAChunks = kBK / 8;       // 16-byte chunks a row
  static constexpr int kBChunks = kBN / 8;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBK * kBN * 2;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kBM * kAChunks % kThreads == 0 &&
                kBK * kBChunks % kThreads == 0, "whole copies a thread");
};

__global__ void __launch_bounds__(DecodeTile::kThreads, 4)
expert_matmul_tc_kernel(const __nv_bfloat16* __restrict__ buf,
                        const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, int C, int D,
                        int F) {
  using L = DecodeTile;
  constexpr int kNT = L::kWN / 8;       // n8 tiles a warp
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = tc::smem_addr(smem);

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * L::kBM;
  const int n0 = blockIdx.x * L::kBN;
  const __nv_bfloat16* A = buf + static_cast<size_t>(e) * C * D;
  const __nv_bfloat16* B = w + static_cast<size_t>(e) * D * F;
  __nv_bfloat16* O = out + static_cast<size_t>(e) * C * F;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = tid >> 5;              // the warp's 16 columns
  const int n_slabs = (D + L::kBK - 1) / L::kBK;

  // one slab of buf (16 x BK) and of w (BK x BN) into `stage`
  auto load_slab = [&](int stage, int slab) {
    const int k0 = slab * L::kBK;
    const uint32_t sa = s0 + stage * L::kStageBytes;
    const uint32_t sb = sa + L::kABytes;
#pragma unroll
    for (int j = 0; j < L::kBM * L::kAChunks / L::kThreads; ++j) {
      const int i = tid + j * L::kThreads;
      const int r = i / L::kAChunks;
      const int c = i % L::kAChunks;
      const int gr = m0 + r;
      const int gk = k0 + c * 8;
      const bool ok = gr < C && gk < D;
      tc::cp_async_16(sa + tc::tile_offset<L::kAChunks>(r, c),
                      ok ? A + static_cast<size_t>(gr) * D + gk : A, ok);
    }
#pragma unroll
    for (int j = 0; j < L::kBK * L::kBChunks / L::kThreads; ++j) {
      const int i = tid + j * L::kThreads;
      const int r = i / L::kBChunks;
      const int c = i % L::kBChunks;
      const int gk = k0 + r;
      const int gn = n0 + c * 8;
      const bool ok = gk < D && gn < F;
      tc::cp_async_16(sb + tc::tile_offset<L::kBChunks>(r, c),
                      ok ? B + static_cast<size_t>(gk) * F + gn : B, ok);
    }
  };

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n_slabs) load_slab(s, s);
    tc::cp_async_commit();
  }
  for (int slab = 0; slab < n_slabs; ++slab) {
    tc::cp_async_wait<L::kStages - 2>();  // this slab has landed
    __syncthreads();                      // ... for every thread; and the
                                          // stage read last step is free
    const int next = slab + L::kStages - 1;
    if (next < n_slabs) load_slab(next % L::kStages, next);
    tc::cp_async_commit();

    const uint32_t sa = s0 + (slab % L::kStages) * L::kStageBytes;
    const uint32_t sb = sa + L::kABytes;
#pragma unroll
    for (int kk = 0; kk < L::kBK / 16; ++kk) {
      uint32_t a[4], b[4];
      tc::ldmatrix_x4(a, sa + tc::tile_offset<L::kAChunks>(
                             lane & 15, kk * 2 + (lane >> 4)));
      tc::ldmatrix_x4_trans(b, sb + tc::tile_offset<L::kBChunks>(
          kk * 16 + (lane & 15), wn * L::kWN / 8 + (lane >> 4)));
      tc::mma_bf16(acc[0], a, b[0], b[1]);
      tc::mma_bf16(acc[1], a, b[2], b[3]);
    }
  }
  tc::cp_async_wait<0>();

  // each lane holds rows g and g + 8, columns 2t, 2t + 1 of each n8 tile:
  // F is a multiple of 8, so a column pair is whole
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + wn * L::kWN + nt * 8 + 2 * t;
    if (col >= F) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + g + 8 * half;
      if (row < C)
        *reinterpret_cast<uint32_t*>(O + static_cast<size_t>(row) * F
                                     + col) =
            tc::pack_bf16(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

int launch_decode(const void* buf, const void* w, void* out, int E, int C,
                  int D, int F, cudaStream_t stream) {
  using L = DecodeTile;
  const cudaError_t err = cudaFuncSetAttribute(
      expert_matmul_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + L::kBN - 1) / L::kBN, (C + L::kBM - 1) / L::kBM, E);
  expert_matmul_tc_kernel<<<grid, L::kThreads, L::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(buf),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

// prefill on wgmma: one block of two warpgroups per 128 x 128 output
// tile, each warpgroup 64 rows; BK 64, three stages (97 KB of shared
// memory and at most 128 registers a thread, so two blocks share an SM
// and one's prologue and epilogue overlap the other's products).  buf's
// slab is K-major (128-byte rows); w's slab is kept as two 64-column
// halves with 128-byte rows (MN-major, wgmma's transposed B); both in the
// 128-byte swizzle that tile_offset<8> writes and wgmma reads.
struct WgmmaTile {
  static constexpr int kBM = 128, kBN = 128, kBK = 64, kThreads = 256;
  static constexpr int kStages = 3;
  static constexpr int kABytes = kBM * kBK * 2;      // 16 KB
  static constexpr int kBHalf = kBK * 64 * 2;        // 8 KB: 64 columns
  static constexpr int kStageBytes = kABytes + 2 * kBHalf;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
  static constexpr int kLd = kBN + 8;   // padded row of the output tile
  static_assert(kBM * kLd * 2 <= kStages * kStageBytes, "epilogue tile");
};

__global__ void __launch_bounds__(WgmmaTile::kThreads, 2)
expert_matmul_wgmma_kernel(const __nv_bfloat16* __restrict__ buf,
                           const __nv_bfloat16* __restrict__ w,
                           __nv_bfloat16* __restrict__ out, int C, int D,
                           int F) {
  using L = WgmmaTile;
  constexpr int kAhead = L::kStages - 1;   // slabs loading ahead
  extern __shared__ __align__(1024) unsigned char smem[];
  // swizzle atoms must start on 1024-byte boundaries
  const uint32_t s0 = (tc::smem_addr(smem) + 1023u) & ~1023u;

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * L::kBM;
  const int n0 = blockIdx.x * L::kBN;
  const __nv_bfloat16* A = buf + static_cast<size_t>(e) * C * D;
  const __nv_bfloat16* B = w + static_cast<size_t>(e) * D * F;
  __nv_bfloat16* O = out + static_cast<size_t>(e) * C * F;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;              // warpgroup: rows 64 wg ..
  const int n_slabs = (D + L::kBK - 1) / L::kBK;

  auto load_slab = [&](int stage, int slab) {
    const int k0 = slab * L::kBK;
    const uint32_t sa = s0 + stage * L::kStageBytes;
    const uint32_t sb = sa + L::kABytes;
#pragma unroll
    for (int j = 0; j < L::kBM * 8 / L::kThreads; ++j) {
      const int i = tid + j * L::kThreads;
      const int r = i >> 3;
      const int c = i & 7;
      const int gr = m0 + r;
      const int gk = k0 + c * 8;
      const bool ok = gr < C && gk < D;
      tc::cp_async_16(sa + tc::tile_offset<8>(r, c),
                      ok ? A + static_cast<size_t>(gr) * D + gk : A, ok);
    }
#pragma unroll
    for (int j = 0; j < L::kBK * 16 / L::kThreads; ++j) {
      const int i = tid + j * L::kThreads;
      const int r = i >> 4;
      const int c = i & 15;
      const int gk = k0 + r;
      const int gn = n0 + c * 8;
      const bool ok = gk < D && gn < F;
      tc::cp_async_16(sb + (c >> 3) * L::kBHalf + tc::tile_offset<8>(r, c & 7),
                      ok ? B + static_cast<size_t>(gk) * F + gn : B, ok);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_slabs) load_slab(s, s);
    tc::cp_async_commit();
  }
  for (int slab = 0; slab < n_slabs; ++slab) {
    tc::cp_async_wait<kAhead - 1>();    // this slab has landed ...
    tc::fence_proxy_async();            // ... is visible to wgmma ...
    __syncthreads();                    // ... for every thread's copies;
    const int next = slab + kAhead;     // the stage refilled here was
    if (next < n_slabs)                 // read, and waited for, last step
      load_slab(next % L::kStages, next);
    tc::cp_async_commit();

    const uint32_t sa = s0 + (slab % L::kStages) * L::kStageBytes
        + wg * 64 * 128;
    const uint32_t sb = s0 + (slab % L::kStages) * L::kStageBytes
        + L::kABytes;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kBK / 16; ++kk)
      tc::wgmma_m64n128k16(acc, tc::wgmma_desc(sa + kk * 32, 16, 1024),
                           tc::wgmma_desc(sb + kk * 16 * 128, L::kBHalf,
                                          1024));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
  }
  tc::cp_async_wait<0>();

  // the tile goes through shared memory (rows padded to 136 values, so
  // the fragments' 4-byte writes are conflict-free), then out as 16-byte
  // stores of whole row segments; F is a multiple of 8, so a segment is
  // in or out whole.  The lane holds rows 16 warp + g (+ 8) of its
  // warpgroup's 64, columns 2t, 2t + 1 of each n8 tile j
  unsigned char* tile = smem + (s0 - tc::smem_addr(smem));
  __syncthreads();                      // every warpgroup is done reading
  const int lane = tid & 31;
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(
          tile + ((r0 + 8 * half) * L::kLd + j * 8 + 2 * (lane & 3)) * 2) =
          tc::pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < L::kBM * 16 / L::kThreads; ++k) {
    const int i = tid + k * L::kThreads;
    const int r = i >> 4;
    const int c = i & 15;
    const int row = m0 + r;
    const int col = n0 + c * 8;
    if (row < C && col < F)
      *reinterpret_cast<uint4*>(O + static_cast<size_t>(row) * F + col) =
          *reinterpret_cast<const uint4*>(tile + (r * L::kLd + c * 8) * 2);
  }
}

int launch_wgmma(const void* buf, const void* w, void* out, int E, int C,
                 int D, int F, cudaStream_t stream) {
  using L = WgmmaTile;
  const cudaError_t err = cudaFuncSetAttribute(
      expert_matmul_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + L::kBN - 1) / L::kBN, (C + L::kBM - 1) / L::kBM, E);
  expert_matmul_wgmma_kernel<<<grid, L::kThreads, L::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(buf),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: float32, 1: bfloat16; design 0: FMA units, 1: tensor cores
// (bfloat16 only, D and F multiples of 8, 16-byte aligned pointers).
// buf (E, C, D), w (E, D, F) and out (E, C, F) are contiguous on
// `device`.  Launches on `stream`; returns cudaGetLastError()
// (0 = launched).
extern "C" int expert_matmul_launch(const void* buf, const void* w,
                                    void* out, int E, int C, int D, int F,
                                    int dtype, int design, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E <= 0 || C <= 0 || F <= 0 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (dtype != 1 || D % 8 != 0 || F % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (C <= 16 || D == 0)
      return launch_decode(buf, w, out, E, C, D, F, s);
    return launch_wgmma(buf, w, out, E, C, D, F, s);
  }
  if (design != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(buf, w, out, E, C, D, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(buf, w, out, E, C, D, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
