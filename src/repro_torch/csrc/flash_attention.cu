// flash_attention: GQA online-softmax attention forward for Hopper
// (sm_90a), causal and sliding-window masks on right-aligned positions.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention/kernel.py (reached through
// `flash_attention_fwd`).  Same function: q (B, Sq, Hq, d), k and v
// (B, Sk, Hkv, d) in the JAX package's layout, KV head h // (Hq/Hkv);
// query row i sits at position i + Sk - Sq; a key at position t is seen
// when t <= pos (causal) and t > pos - window (window > 0); a row that
// sees no key gives 0.  Softmax statistics and the accumulator are fp32;
// the output is acc / max(l, 1e-30) in the input type (fp32 or bf16).
//
// What bounds it on this card: at the shapes the port runs
// (recurrentgemma-2b prefill: B 4, S 3000, Hq 10, Hkv 1, d 256, window
// 2048) the unmasked (query, key) pairs need about 1.66e11 flops against
// about 135 MB of q, k, v and o, so operations bound it: 0.168 ms at the
// H100's 989 TFLOP/s bf16 tensor-core rate.  This first kernel does its
// dot products on the fp32 FMA units (67 TFLOP/s), not the tensor cores,
// so it cannot come near that bound; wgmma and TMA are later work.
//
// Design:
// * grid (ceil(Sq / 64), B * Hq): one block of 256 threads per 64-row
//   query tile of one (batch, Q head).  The TPU's sequential k-grid axis
//   becomes a loop inside the block over 32-key tiles, with m, l and acc
//   for the block's rows in registers across the loop;
// * the loop visits only the key tiles that meet
//   [first row's pos - window + 1, last row's pos]: tiles that the mask
//   would zero whole are skipped, not computed, which keeps a windowed
//   layer's cost at O(S * window) instead of O(S^2);
// * the 16 x 16 threads own 4 query rows x 2 key columns of each score
//   tile and 4 rows x d/16 output columns; a row's max and sum are
//   shuffles among the 16 threads of its half-warp.  Q, K and V tiles
//   sit in shared memory in the input type, K and Q rows padded so the
//   16 rows read at one column fall in 16 banks;
// * ragged Sq and Sk edges are masked in the kernel (rows past Sq are
//   computed on zeros and not stored; keys past Sk are masked), so no
//   shape needs padding;
// * shared memory exceeds the 48 KB static limit at d = 256 (72.6 KB in
//   bf16, 136.6 KB in fp32), so it is dynamic, raised with
//   cudaFuncSetAttribute; a refused launch returns its error code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 32;               // keys per tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kRows = kBQ / 16;       // query rows per thread
constexpr int kCols = kBK / 16;       // score columns per thread
constexpr float kNegInf = -1e30f;     // the Pallas kernel's NEG_INF

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, Hq, Hkv;
  float scale;
  int causal, window;
};

template <typename T, int D>
struct Layout {
  // one pad element (fp32) or two (bf16, keeping 4-byte words whole) makes
  // the row stride an odd number of 4-byte words: 16 rows read at one
  // column then hit 16 different banks
  static constexpr int kPad = sizeof(T) == 4 ? 1 : 2;
  static constexpr int kStride = D + kPad;       // Q and K rows
  static constexpr int kStrideP = kBK + 1;       // score rows (fp32)
  static constexpr size_t kQ = static_cast<size_t>(kBQ) * kStride;
  static constexpr size_t kK = static_cast<size_t>(kBK) * kStride;
  static constexpr size_t kV = static_cast<size_t>(kBK) * D;
  static constexpr size_t kBytes =
      (kQ + kK + kV) * sizeof(T) + static_cast<size_t>(kBQ) * kStrideP * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args A) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + L::kQ;
  T* Vs = Ks + L::kK;
  float* Ps = reinterpret_cast<float*>(Vs + L::kV);

  const T* q = static_cast<const T*>(A.q);
  const T* k = static_cast<const T*>(A.k);
  const T* v = static_cast<const T*>(A.v);
  T* o = static_cast<T*>(A.o);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / A.Hq;
  const int h = blockIdx.y - b * A.Hq;
  const int hk = h / (A.Hq / A.Hkv);
  const int off = A.Sk - A.Sq;          // right-aligned query positions
  const size_t q_row = static_cast<size_t>(A.Hq) * D;    // stride of s
  const size_t k_row = static_cast<size_t>(A.Hkv) * D;
  const T* qb = q + static_cast<size_t>(b) * A.Sq * q_row
      + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * A.Sk * k_row
      + static_cast<size_t>(hk) * D;
  const T* vb = v + static_cast<size_t>(b) * A.Sk * k_row
      + static_cast<size_t>(hk) * D;
  T* ob = o + static_cast<size_t>(b) * A.Sq * q_row
      + static_cast<size_t>(h) * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int qi = q0 + r;
    Qs[r * L::kStride + c] = qi < A.Sq ? qb[qi * q_row + c] : from_f<T>(0.f);
  }

  // the key tiles that meet the block's rows' windows
  const int q_last = min(q0 + kBQ, A.Sq) - 1;
  const int k_hi = A.causal ? min(A.Sk, q_last + off + 1) : A.Sk;
  int k_lo = A.window > 0 ? max(0, q0 + off - A.window + 1) : 0;
  k_lo = (k_lo / kBK) * kBK;

  float m[kRows], l[kRows], acc[kRows][D / 16];
  int qpos[kRows];
  bool qok[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    const int r = ty * kRows + i;
    qpos[i] = q0 + r + off;
    qok[i] = q0 + r < A.Sq;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();                    // the last tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int t = k0 + r;
      const bool in = t < A.Sk;
      Ks[r * L::kStride + c] = in ? kb[t * k_row + c] : from_f<T>(0.f);
      Vs[r * D + c] = in ? vb[t * k_row + c] : from_f<T>(0.f);
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = to_f(Qs[(ty * kRows + i) * L::kStride + kk]);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = to_f(Ks[(tx + 16 * j) * L::kStride + kk]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      bool ok[kCols];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int t = k0 + tx + 16 * j;
        ok[j] = qok[i] && t < A.Sk && (!A.causal || t <= qpos[i])
            && (A.window <= 0 || t > qpos[i] - A.window);
        s[i][j] = ok[j] ? s[i][j] * A.scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xFFFFFFFFu, mt, w));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * kRows + i) * L::kStrideP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xFFFFFFFFu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[D / 16];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = Ps[(ty * kRows + i) * L::kStrideP + kk];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) vv[c] = to_f(Vs[kk * D + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < D / 16; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (!qok[i]) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + static_cast<size_t>(q0 + ty * kRows + i) * q_row;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      orow[tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const Args& A, cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::kBytes;
  auto kernel = flash_fwd_kernel<T, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((A.Sq + kBQ - 1) / kBQ, A.B * A.Hq);
  kernel<<<grid, kThreads, bytes, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& A, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(A, stream);
    case 32: return launch<T, 32>(A, stream);
    case 64: return launch<T, 64>(A, stream);
    case 128: return launch<T, 128>(A, stream);
    case 256: return launch<T, 256>(A, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched), or the error of a refused
// shared-memory request.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      float scale, int causal, int window,
                                      int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args A{q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(A, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(A, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
