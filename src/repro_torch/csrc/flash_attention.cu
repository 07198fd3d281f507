// flash_attention: GQA online-softmax attention forward for Hopper
// (sm_90a), causal and sliding-window masks on right-aligned positions.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention/kernel.py:30 (reached through
// `flash_attention_fwd`, kernel.py:80).  Same function: q (B, Sq, Hq, d),
// k and v (B, Sk, Hkv, d) in the JAX package's layout, KV head
// h // (Hq/Hkv); query row i sits at position i + Sk - Sq; a key at
// position t is seen when t <= pos (causal) and t > pos - window
// (window > 0); a row that sees no key gives 0.  Softmax statistics and
// the accumulator are fp32; the output is acc / max(l, 1e-30) in the
// input type (fp32 or bf16).
//
// What bounds it on this card: at both serving prefills the unmasked
// (query, key) pairs need far more operations than bytes, so operations
// bound it at the 989 TFLOP/s bf16 tensor-core rate: recurrentgemma-2b
// (B 4, S 3000, Hq 10, Hkv 1, d 256, window 2048) needs 1.66e11 flops
// against about 135 MB of q, k, v and o, 0.168 ms; granite-moe-3b-a800m
// (B 4, S 2000, Hq 24, Hkv 8, d 64, causal) 4.92e10 flops against 66 MB,
// 0.050 ms.
//
// Both designs visit only the key tiles that meet [first row's
// pos - window + 1, last row's pos]: tiles that the mask would zero whole
// are skipped, not computed, which keeps a windowed layer's cost at
// O(S * window) instead of O(S^2).  Ragged Sq and Sk edges are masked in
// the kernel (rows past Sq are computed on zeros and not stored; keys
// past Sk are zeros and masked), so no shape needs padding.  The wrapper
// picks the design before it launches and passes it here (`design`).
//
// The tensor-core design (design 1; bf16, every head dim 16-256), the
// FlashAttention-2 layout on mma.sync.m16n8k16 (bf16 in, fp32 out):
// * one block of 4 warps per 64-row query tile of one (batch, Q head);
//   each warp owns 16 query rows, and blocks are issued longest key
//   range first so causal tiles do not leave a tail;
// * Q (64 x d) and two buffers each of K and V (BKV x d; BKV 64, and 32
//   at d = 256) sit in dynamic shared memory, rows XOR-swizzled
//   (tensor_core.cuh); the next key tile's K and V are copied with
//   16-byte cp.async while the tensor cores work on this one (double
//   buffering).  Shared memory is 40 KB at d = 64 and 96 KB at d = 256,
//   raised with cudaFuncSetAttribute;
// * S = Q K^T: Q fragments through ldmatrix (kept in registers for
//   d <= 128; re-read from shared memory at d = 256, where the 16 x 256
//   fp32 accumulator alone takes 128 registers a thread), K fragments
//   through ldmatrix (K rows are the "col" operand as stored);
// * the online softmax runs on the accumulator fragments in the exp2
//   domain (scores scaled by scale * log2 e, ex2.approx): each lane holds
//   two rows, whose max is reduced over the 4 lanes of a quad with two
//   shuffles; the row sums stay per lane until the end.  Only tiles that
//   straddle a mask edge (the diagonal, the window's start, Sk) evaluate
//   the mask;
// * P is rounded to bf16 in registers and reused as the A operand of
//   P V, whose B fragments come through ldmatrix.trans from V as stored.
//   Rounding P adds at most 2^-9 relative error to each probability; the
//   output is a convex combination of rows of V, so its error is at most
//   2^-9 max|v| and averages far below that, against the 2e-2 tolerance;
// * the same inputs take the same order of operations on every launch,
//   so the result is deterministic;
// * measured and not kept: 128-row blocks of 8 warps (slower), two row
//   tiles a warp (within 3%, at 255 registers), and 64-key tiles at
//   d = 256 (which spill);
// * not yet used: wgmma and TMA, warp specialisation, one block for the
//   g Q heads of a KV head (each K and V tile is loaded once per Q head).
//
// The FMA design (design 0; float32, where tensor cores would compute in
// TF32 and break the 2e-5 tolerance) runs on the fp32 FMA units:
// * grid (ceil(Sq / 64), B * Hq): one block of 256 threads per 64-row
//   query tile of one (batch, Q head).  The TPU's sequential k-grid axis
//   becomes a loop inside the block over 32-key tiles, with m, l and acc
//   for the block's rows in registers across the loop;
// * the 16 x 16 threads own 4 query rows x 2 key columns of each score
//   tile and 4 rows x d/16 output columns; a row's max and sum are
//   shuffles among the 16 threads of its half-warp.  Q, K and V tiles
//   sit in shared memory in fp32, K and Q rows padded so the
//   16 rows read at one column fall in 16 banks;
// * shared memory exceeds the 48 KB static limit at d = 256 (136.6 KB),
//   so it is dynamic, raised with cudaFuncSetAttribute; a refused launch
//   returns its error code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 32;               // keys per tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kRows = kBQ / 16;       // query rows per thread
constexpr int kCols = kBK / 16;       // score columns per thread
constexpr float kNegInf = -1e30f;     // the Pallas kernel's NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, Hq, Hkv;
  float scale;
  int causal, window;
};

template <int D>
struct Layout {
  // one pad element makes the row stride an odd number of 4-byte words:
  // 16 rows read at one column then hit 16 different banks
  static constexpr int kStride = D + 1;          // Q and K rows
  static constexpr int kStrideP = kBK + 1;       // score rows (fp32)
  static constexpr size_t kQ = static_cast<size_t>(kBQ) * kStride;
  static constexpr size_t kK = static_cast<size_t>(kBK) * kStride;
  static constexpr size_t kV = static_cast<size_t>(kBK) * D;
  static constexpr size_t kBytes =
      (kQ + kK + kV) * 4 + static_cast<size_t>(kBQ) * kStrideP * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args A) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + L::kQ;
  float* Vs = Ks + L::kK;
  float* Ps = Vs + L::kV;

  const float* q = static_cast<const float*>(A.q);
  const float* k = static_cast<const float*>(A.k);
  const float* v = static_cast<const float*>(A.v);
  float* o = static_cast<float*>(A.o);

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
  const float* qb = q + static_cast<size_t>(b) * A.Sq * q_row
      + static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * A.Sk * k_row
      + static_cast<size_t>(hk) * D;
  const float* vb = v + static_cast<size_t>(b) * A.Sk * k_row
      + static_cast<size_t>(hk) * D;
  float* ob = o + static_cast<size_t>(b) * A.Sq * q_row
      + static_cast<size_t>(h) * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int qi = q0 + r;
    Qs[r * L::kStride + c] = qi < A.Sq ? qb[qi * q_row + c] : 0.f;
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
      Ks[r * L::kStride + c] = in ? kb[t * k_row + c] : 0.f;
      Vs[r * D + c] = in ? vb[t * k_row + c] : 0.f;
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
        qv[i] = Qs[(ty * kRows + i) * L::kStride + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = Ks[(tx + 16 * j) * L::kStride + kk];
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
      for (int c = 0; c < D / 16; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
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
    float* orow = ob + static_cast<size_t>(q0 + ty * kRows + i) * q_row;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      orow[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
int launch(const Args& A, cudaStream_t stream) {
  constexpr size_t bytes = Layout<D>::kBytes;
  auto kernel = flash_fwd_kernel<D>;
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

int launch_d(const Args& A, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(A, stream);
    case 32: return launch<32>(A, stream);
    case 64: return launch<64>(A, stream);
    case 128: return launch<128>(A, stream);
    case 256: return launch<256>(A, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
namespace {

// the tensor-core design's tile at head dim D: 4 warps of 16 query rows,
// BKV keys a K/V tile.  At d = 256 the 16 x 256 fp32 output accumulator
// takes 128 registers a thread, so the key tile is 32 (16 score
// registers) to stay clear of spills; shared memory is then 96 KB (Q
// 32 KB, K and V 2 x 2 x 16 KB), two blocks an SM
template <int D>
struct FlashTile {
  static constexpr int kBQ = 64, kThreads = 128;  // query rows a block
  static constexpr int kBKV = D == 256 ? 32 : 64;
  static constexpr int kChunks = D / 8;           // 16-byte chunks a row
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBKV * D * 2;   // one K or V buffer
  static constexpr int kSmem = kQBytes + 4 * kKVBytes;
  static_assert(D % 16 == 0 && kBKV * kChunks % kThreads == 0,
                "whole copies a thread");
};

template <int D>
__global__ void __launch_bounds__(FlashTile<D>::kThreads)
flash_tc_kernel(Args A) {
  using L = FlashTile<D>;
  constexpr int BKV = L::kBKV;
  constexpr int kCh = L::kChunks;
  constexpr int kDT = D / 8;            // n8 tiles of a warp's output
  constexpr int kST = BKV / 8;          // n8 tiles of a warp's scores
  constexpr bool kQInRegs = D <= 128;
  const float kMinusInf = -__int_as_float(0x7f800000);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = tc::smem_addr(smem);
  const uint32_t sk0 = sq + L::kQBytes;            // K buffers 0, 1
  const uint32_t sv0 = sk0 + 2 * L::kKVBytes;      // V buffers 0, 1

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(A.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(A.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(A.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(A.o);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * L::kBQ;   // longest first
  const int b = blockIdx.y / A.Hq;
  const int h = blockIdx.y - b * A.Hq;
  const int hk = h / (A.Hq / A.Hkv);
  const int off = A.Sk - A.Sq;          // right-aligned query positions
  const size_t q_row = static_cast<size_t>(A.Hq) * D;    // stride of s
  const size_t k_row = static_cast<size_t>(A.Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * A.Sq * q_row
      + static_cast<size_t>(h) * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * A.Sk * k_row
      + static_cast<size_t>(hk) * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * A.Sk * k_row
      + static_cast<size_t>(hk) * D;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * A.Sq * q_row
      + static_cast<size_t>(h) * D;

  // Q's tile: rows past Sq are zeros
#pragma unroll
  for (int j = 0; j < L::kBQ * kCh / L::kThreads; ++j) {
    const int i = tid + j * L::kThreads;
    const int r = i / kCh;
    const int c = i % kCh;
    const int qi = q0 + r;
    const bool ok = qi < A.Sq;
    tc::cp_async_16(sq + tc::tile_offset<kCh>(r, c),
                    ok ? qb + qi * q_row + c * 8 : qb, ok);
  }
  // one tile of K and V into buffer `buf`: keys past Sk are zeros
  auto load_kv = [&](int k0, int buf) {
#pragma unroll
    for (int j = 0; j < BKV * kCh / L::kThreads; ++j) {
      const int i = tid + j * L::kThreads;
      const int r = i / kCh;
      const int c = i % kCh;
      const int t = k0 + r;
      const bool ok = t < A.Sk;
      const size_t at = static_cast<size_t>(t) * k_row + c * 8;
      const uint32_t so = buf * L::kKVBytes + tc::tile_offset<kCh>(r, c);
      tc::cp_async_16(sk0 + so, ok ? kb + at : kb, ok);
      tc::cp_async_16(sv0 + so, ok ? vb + at : vb, ok);
    }
  };

  // the key tiles that meet the block's rows' windows
  const int q_last = min(q0 + L::kBQ, A.Sq) - 1;
  const int k_hi = A.causal ? min(A.Sk, q_last + off + 1) : A.Sk;
  int k_lo = A.window > 0 ? max(0, q0 + off - A.window + 1) : 0;
  k_lo = (k_lo / BKV) * BKV;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BKV - 1) / BKV : 0;
  if (n_tiles > 0) load_kv(k_lo, 0);
  tc::cp_async_commit();

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = warp * 16 + g;       // the lane's rows: row0, row0 + 8
  const int pos0 = q0 + row0 + off;     // and their positions
  const float sl2 = A.scale * 1.4426950408889634f;
  // a tile needs the mask only where it meets an edge of some row's range
  const int pos_min = q0 + off;
  const int pos_max = q0 + L::kBQ - 1 + off;

  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kMinusInf, kMinusInf};
  float l[2] = {0.f, 0.f};
  uint32_t qf[kQInRegs ? D / 16 : 1][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_lo + j * BKV;
    if (j + 1 < n_tiles) load_kv(k0 + BKV, (j + 1) & 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();             // Q and this tile have landed
    __syncthreads();
    const uint32_t sk = sk0 + (j & 1) * L::kKVBytes;
    const uint32_t sv = sv0 + (j & 1) * L::kKVBytes;
    if constexpr (kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          tc::ldmatrix_x4(qf[kk], sq + tc::tile_offset<kCh>(
                                       warp * 16 + (lane & 15),
                                       kk * 2 + (lane >> 4)));
      }
    }

    // S = Q K^T for the warp's 16 rows and the tile's BKV keys
    float s[kST][4];
#pragma unroll
    for (int i = 0; i < kST; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        tc::ldmatrix_x4(a, sq + tc::tile_offset<kCh>(warp * 16 + (lane & 15),
                                                     kk * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < kST / 2; ++np) {
        uint32_t r4[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        tc::ldmatrix_x4(r4, sk + tc::tile_offset<kCh>(
                                key, kk * 2 + ((lane >> 3) & 1)));
        tc::mma_bf16(s[2 * np], a, r4[0], r4[1]);
        tc::mma_bf16(s[2 * np + 1], a, r4[2], r4[3]);
      }
    }

    // scale into the exp2 domain; mask where the tile meets an edge
    const bool edge = k0 + BKV > A.Sk
        || (A.causal && k0 + BKV - 1 > pos_min)
        || (A.window > 0 && k0 <= pos_max - A.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * sl2;
        if (edge) {
          const int t = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int pos = pos0 + (e < 2 ? 0 : 8);
          if (t >= A.Sk || (A.causal && t > pos)
              || (A.window > 0 && t <= pos - A.window))
            x = kMinusInf;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 2));
      // a row that has seen no key yet keeps p = 0 and acc = 0
      mu[r] = mx[r] == kMinusInf ? 0.f : mx[r];
      const float alpha = tc::exp2_approx(m[r] - mu[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tc::exp2_approx(s[nt][e] - mu[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P V, P rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {
          tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t r4[4];
        tc::ldmatrix_x4_trans(r4, sv + tc::tile_offset<kCh>(
                                      kk * 16 + (lane & 15),
                                      np * 2 + (lane >> 4)));
        tc::mma_bf16(acc[2 * np], a, r4[0], r4[1]);
        tc::mma_bf16(acc[2 * np + 1], a, r4[2], r4[3]);
      }
    }
    __syncthreads();                    // this tile's buffers are free
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xFFFFFFFFu, lr, 1);
    lr += __shfl_xor_sync(0xFFFFFFFFu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int qi = q0 + row0 + 8 * r;
    if (qi >= A.Sq) continue;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<uint32_t*>(ob + qi * q_row + dt * 8 + 2 * t4) =
          tc::pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
  }
}

template <int D>
int launch_tc(const Args& A, cudaStream_t stream) {
  using L = FlashTile<D>;
  auto kernel = flash_tc_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((A.Sq + L::kBQ - 1) / L::kBQ, A.B * A.Hq);
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc_d(const Args& A, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_tc<16>(A, stream);
    case 32: return launch_tc<32>(A, stream);
    case 64: return launch_tc<64>(A, stream);
    case 128: return launch_tc<128>(A, stream);
    case 256: return launch_tc<256>(A, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16; design 0: FMA units (float32 only), 1:
// tensor cores (bfloat16 only, 16-byte aligned pointers).  Launches on `stream`;
// returns cudaGetLastError() (0 = launched), or the error of a refused
// shared-memory request.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int D,
                                      float scale, int causal, int window,
                                      int dtype, int design, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args A{q, k, v, o, B, Sq, Sk, Hq, Hkv, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_tc_d(A, D, s);
  }
  if (design != 0 || dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_d(A, D, s);
}
