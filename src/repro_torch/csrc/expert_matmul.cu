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
//   each need 1.258e11 flops against about 0.39 GB moved, so operations
//   bound them: 0.127 ms at the 989 TFLOP/s bf16 tensor-core rate;
// * decode, C 8: each launch reads one 62.9 MB expert weight tensor for
//   5.0e8 flops, so bytes bound it: 0.019 ms at 3.35 TB/s.
// This first kernel runs its products on the fp32 FMA units (67 TFLOP/s),
// not the tensor cores, so at prefill it cannot come within 14x of its
// bound; mma.sync / wgmma, TMA and a fused gate-and-up launch are later
// work.  At decode it has to stream the weights at the memory's rate,
// which a small row tile (below) keeps from being wasted on empty rows.
//
// Design:
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

// dtype 0: float32, 1: bfloat16.  buf (E, C, D), w (E, D, F) and out
// (E, C, F) are contiguous on `device`.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int expert_matmul_launch(const void* buf, const void* w,
                                    void* out, int E, int C, int D, int F,
                                    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E <= 0 || C <= 0 || F <= 0 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(buf, w, out, E, C, D, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(buf, w, out, E, C, D, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
