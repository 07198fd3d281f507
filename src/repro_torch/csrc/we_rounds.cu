// we_rounds: the fused work-exchange round pipeline for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_we_rounds_body` of
// src/repro/kernels/we_rounds/kernel.py (entries `_we_rounds_kernel`,
// `_we_rounds_drift_kernel`, `_we_rounds_panel_kernel`,
// `_we_rounds_panel_drift_kernel`, reached through `we_rounds_pallas`).
// It computes exactly what that body computes, with the same counter
// layout, so it draws the same Threefry words as the JAX package and as the
// plain PyTorch version in src/repro_torch/kernels/we_rounds/ref.py:
// per (trial row, worker column, exchange round), 4 Threefry-2x32 calls
// keyed by (seed, row, (round*K + worker)*4 + slot) -> Box-Muller normals ->
// the Marsaglia-Tsang Gamma with the 3-step boost below shape 3 -> the
// row's argmin straggler -> normal-limit Binomial done-counts -> the online
// rate estimate; then the wait-for-all final phase at round index max_iter.
// Output: (B, 3) float32 rows [t_comp, iterations, n_comm].
//
// What bounds it on this card: operations, not bytes.  The kernel reads
// each rate row once (plus one schedule row per round under drift) and
// writes 12 bytes per trial; everything else lives in registers.  Each
// busy cell-round needs at least two Threefry-2x32 calls of 20
// add/rotate/xor rounds (about 77 integer ops each: the Gamma's normal and
// the Binomial's; two more below shape 3) plus log, cos, sqrt, exp and
// IEEE divides on the FMA pipe.  Hopper has 64 INT32 lanes an SM, half
// the FP32 rate, so the integer ALU sets the floor.  The bound that
// chip_smoke.py states counts only those two Threefry calls per busy
// cell-round at the INT32 peak: no transcendentals, no boost pairs, no
// reductions, every lane useful.  It is a loose floor.
//
// Within a warp the Gamma's Threefry chain (~72 dependent integer
// instructions), the row minimum and the Binomial's chain would run one
// after another; the design below interleaves them and cuts the minimum
// to one instruction, yet on the H100 that and more or fewer resident
// warps (launch bounds, warps per block) move the time by a few percent
// only: what is left is the number of instructions the warps execute,
// not latency.  Per column-round a warp executes the two Threefry chains
// and, as many again, the IEEE logf, cosf, sqrtf and divides of
// libdevice that the bitwise match with the plain version keeps; and at
// K = 56 (50 workers) only 50 of the 64 column slots of a CPL-2 warp hold
// a worker.  PERF.md keeps the times.
//
// Design, one warp per trial row:
// * lanes own worker columns (column = lane + 32*i, i < CPL) and keep
//   lam, n_left, lam_hat, est_done and the round's draws in registers;
//   K <= 32*CPL, CPL in {1, 2, 4, 8}, so K <= 256;
// * the Binomial's counter (row, (round*K + j)*4 + 3) does not depend on
//   the round's straggler, so each cell draws its Binomial normal in the
//   same column loop as its Gamma: two independent Threefry chains that
//   the scheduler interleaves, and the row minimum no longer stands
//   between them.  No branch splits the loop by column either (idle cells
//   draw at shape 3 and drop the result), so the chains of all CPL
//   columns interleave.  The finisher, idle cells and cells with n = 0
//   discard their draws (the same bits and arithmetic as the plain
//   version, so the outputs are bitwise equal to it).  The boost pairs
//   stay conditional on shape 3;
// * the row minimum (t_star) and the final phase's maximum are one
//   REDUX each on the float's bit pattern: every t there is +0, a
//   positive finite float or +inf (see warp_min_nonneg), where unsigned
//   order is float order;
// * row sums keep their xor-butterfly order (one sequential sum per lane,
//   then the butterfly), which the plain version repeats
//   (ref.py's `lane_sum`): the bitwise match rests on it.  A known row's
//   rate sum does not change between rounds, so it is taken once;
// * each warp loops until its own row is inactive, then runs the final
//   phase.  No warp waits for the slowest row of a tile, as the TPU tile
//   does: extra trips of a frozen row change nothing that reaches the
//   outputs (its RNG round index is its own `iters`), so per-row exit is
//   exact;
// * `__launch_bounds__` asks for min_blocks(CPL) blocks of kWarpsPerBlock
//   warps an SM, so that enough warps are resident to hide what latency
//   is left.  Zero-rate padding columns (inv_lam = inf) are never busy;
//   their draws (at inv_rate 1) are dropped, never computed as 0 * inf.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC (no --use_fast_math).  --fmad=false keeps
// `mean + z*std` as a rounded multiply then add, as the reference does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 4;
constexpr int kWarpsPerBlock = 4;
// blocks an SM that __launch_bounds__ asks for: 8 blocks of 4 warps cap a
// thread at 64 registers; each doubling of CPL past 2 halves the blocks,
// so that the wider rows keep their registers without a spill
constexpr int min_blocks(int cpl) { return cpl <= 2 ? 8 : 16 / cpl; }
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kTwoPi = 6.28318548202514648438f;   // float32(2*pi)
constexpr float kThird = 0.333333343267440796f;     // float32(1/3)

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

struct Key {
  uint32_t k0, k1, ks2;
};

__device__ __forceinline__ void threefry(const Key& k, uint32_t c0,
                                         uint32_t c1, uint32_t& o0,
                                         uint32_t& o1) {
  uint32_t x0 = c0 + k.k0;
  uint32_t x1 = c1 + k.k1;
#define TF_MIX(d) \
  x0 += x1;       \
  x1 = rotl(x1, d) ^ x0;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  x0 += k.k1; x1 += k.ks2 + 1u;
  TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
  x0 += k.ks2; x1 += k.k0 + 2u;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  x0 += k.k0; x1 += k.k1 + 3u;
  TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
  x0 += k.k1; x1 += k.ks2 + 4u;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  x0 += k.ks2; x1 += k.k0 + 5u;
#undef TF_MIX
  o0 = x0;
  o1 = x1;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  return fmaxf(u, 1e-12f);
}

__device__ __forceinline__ float box_muller(uint32_t w0, uint32_t w1) {
  return sqrtf(-2.0f * logf(uniform01(w0))) * cosf(kTwoPi * uniform01(w1));
}

// Gamma(alpha) * inv_rate from the normal z of the cell's slot-0 pair
// (c1 = slot-0 counter); below shape 3 the boost pairs (slots 1, 2).
// Every result is +0, positive or +inf (with a positive inv_rate): d > 0,
// c = fmaxf(1 + y, 0) is never -0 (1 + y rounds an exact cancellation to
// +0), and expf is >= +0.
__device__ __forceinline__ float gamma_mt(const Key& key, uint32_t c0,
                                          uint32_t c1, float z, float alpha,
                                          float inv_rate) {
  const bool boost = alpha < 3.0f;
  const float a = boost ? alpha + 3.0f : alpha;
  const float d = a - kThird;
  const float c = fmaxf(1.0f + z / (3.0f * sqrtf(d)), 0.0f);
  const float raw = d * (c * c * c) * inv_rate;
  if (!boost) return raw;
  uint32_t b0, b1, e0, e1;
  threefry(key, c0, c1 + 1u, b0, b1);
  threefry(key, c0, c1 + 2u, e0, e1);
  const float log_pow = logf(uniform01(b0)) / fmaxf(alpha, 1e-12f)
                      + logf(uniform01(b1)) / fmaxf(alpha + 1.0f, 1e-12f)
                      + logf(uniform01(e0)) / fmaxf(alpha + 2.0f, 1e-12f);
  return raw * expf(log_pow);
}

__device__ __forceinline__ float gamma_draw(const Key& key, uint32_t c0,
                                            uint32_t c1, float alpha,
                                            float inv_rate) {
  uint32_t w0, w1;
  threefry(key, c0, c1, w0, w1);
  return gamma_mt(key, c0, c1, box_muller(w0, w1), alpha, inv_rate);
}

__device__ __forceinline__ float binomial_normal(float z, float n, float p) {
  const float mean = n * p;
  const float std = sqrtf(fmaxf(n * p * (1.0f - p), 0.0f));
  return fminf(fmaxf(mean + z * std, 0.0f), n);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// Minimum and maximum over the warp of floats that are +0, positive
// finite or +inf (never -0 or NaN: the lanes start from +inf / +0 and fold
// in gamma_mt's results with fminf / fmaxf, which drop a NaN).  For those
// floats the bit patterns, read as unsigned integers, order exactly as
// the floats do, so one REDUX gives the same value as an fminf / fmaxf
// butterfly.
__device__ __forceinline__ float warp_min_nonneg(float v) {
  return __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(v)));
}

__device__ __forceinline__ float warp_max_nonneg(float v) {
  return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v)));
}

struct Params {
  const float* lam;     // (B, K)
  const float* sched;   // (B, R, K) or null
  const float* flags;   // (B,) or null; nonzero = known row
  float* out;           // (B, 3)
  int B, K, R;
  Key key;
  float n0, threshold, cap;
  int known, max_iter, active0;
};

template <int CPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, min_blocks(CPL))
we_rounds_kernel(const Params P) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= P.B) return;   // the whole warp leaves together
  const int K = P.K;
  const float kInf = __int_as_float(0x7f800000);
  const bool known = P.flags ? (P.flags[row] > 0.0f) : (P.known != 0);
  // mixed panel: known rows are uncapped; otherwise the caller's cap holds
  const float cap = (P.flags && known) ? kInf : P.cap;
  const uint32_t c0 = static_cast<uint32_t>(row);
  const float* lam_row = P.lam + static_cast<size_t>(row) * K;
  const float* sched_row =
      P.sched ? P.sched + static_cast<size_t>(row) * P.R * K : nullptr;

  float lam[CPL], inv_lam[CPL], n_left[CPL], lam_hat[CPL], est_done[CPL];
  float assign[CPL], t_k[CPL], z_b[CPL];
  float lam_sum = 0.0f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int j = lane + 32 * i;
    lam[i] = j < K ? lam_row[j] : 0.0f;
    inv_lam[i] = 1.0f / lam[i];
    n_left[i] = 0.0f;
    lam_hat[i] = lam[i] > 0.0f ? 1.0f : 0.0f;
    est_done[i] = 0.0f;
    lam_sum += lam[i];
  }
  // a known row's rate sum is the same every round
  lam_sum = warp_sum(lam_sum);
  float n_rem = P.n0, t_comp = 0.0f, n_comm = 0.0f, est_time = 0.0f;
  int iters = 0;
  bool active = P.active0 != 0;

  while (active) {
    const uint32_t round_base = static_cast<uint32_t>(iters * K);
    const float* srow =
        sched_row ? sched_row + static_cast<size_t>(min(iters, P.R - 1)) * K
                  : nullptr;
    float rsum = lam_sum;
    if (!known) {
      rsum = 0.0f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) rsum += lam_hat[i];
      rsum = warp_sum(rsum);
    }
    const float scale = n_rem / rsum;
    float tmin = kInf;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int j = lane + 32 * i;
      const float a = fminf((known ? lam[i] : lam_hat[i]) * scale, cap);
      assign[i] = a;
      // busy; padding and lanes past K never are.  Every lane draws, so
      // that no branch splits the columns' chains: an idle cell draws at
      // shape 3 (no boost pairs) and its t is dropped
      const bool busy = a > 0.5f;
      const uint32_t c1 = (round_base + j) * kPairs;
      const float inv = (srow && busy) ? 1.0f / srow[j] : inv_lam[i];
      // the Gamma's normal (slot 0) and the Binomial's (slot 3): two
      // independent Threefry chains, scheduled together
      uint32_t g0, g1, q0, q1;
      threefry(P.key, c0, c1, g0, g1);
      threefry(P.key, c0, c1 + 3u, q0, q1);
      z_b[i] = box_muller(q0, q1);
      const float t = gamma_mt(P.key, c0, c1, box_muller(g0, g1),
                               busy ? a : 3.0f, busy ? inv : 1.0f);
      t_k[i] = busy ? t : kInf;
      tmin = fminf(tmin, t_k[i]);
    }
    const float t_star = warp_min_nonneg(tmin);
    if (!isfinite(t_star)) break;   // no busy worker: the row freezes as is

    float done_sum = 0.0f, comm_sum = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const float a = assign[i];
      float done = 0.0f;
      if (t_k[i] == t_star) {
        done = a;                         // the finisher clears its queue
      } else if (a > 0.5f) {
        // n = 0 gives done = 0 exactly, as the plain version's draw does
        const float n = fmaxf(a - 1.0f, 0.0f);
        const float p = fminf(fmaxf(t_star / t_k[i], 0.0f), 1.0f);
        done = binomial_normal(z_b[i], n, p);
      }
      done_sum += done;
      comm_sum += fmaxf(a - n_left[i], 0.0f);
      n_left[i] = a - done;
      est_done[i] += done;
    }
    done_sum = warp_sum(done_sum);
    comm_sum = warp_sum(comm_sum);
    n_rem = n_rem - done_sum;
    t_comp = t_comp + t_star;
    if (iters > 0) n_comm = n_comm + comm_sum;
    iters += 1;
    if (!known) {
      est_time = est_time + t_star;
      const float et = fmaxf(est_time, 1e-30f);
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        lam_hat[i] = est_done[i] > 0.0f ? est_done[i] / et
                                        : (lam[i] > 0.0f ? 1.0f : 0.0f);
    }
    active = (n_rem > P.threshold) && (iters < P.max_iter);
  }

  // final phase: assign the remainder, wait for all workers
  const bool has_rem = n_rem > 1e-6f;
  if (has_rem) {
    const uint32_t round_base = static_cast<uint32_t>(P.max_iter * K);
    const float* srow =
        sched_row ? sched_row + static_cast<size_t>(min(iters, P.R - 1)) * K
                  : nullptr;
    float rsum = lam_sum;
    if (!known) {
      rsum = 0.0f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) rsum += lam_hat[i];
      rsum = warp_sum(rsum);
    }
    const float scale = n_rem / rsum;
    float tmax = 0.0f, comm_sum = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int j = lane + 32 * i;
      const float share = (known ? lam[i] : lam_hat[i]) * scale;
      comm_sum += fmaxf(share - n_left[i], 0.0f);
      if (share > 1e-9f) {
        const float inv = srow ? 1.0f / srow[j] : inv_lam[i];
        tmax = fmaxf(tmax, gamma_draw(P.key, c0, (round_base + j) * kPairs,
                                      fmaxf(share, 1e-9f), inv));
      }
    }
    tmax = warp_max_nonneg(tmax);
    comm_sum = warp_sum(comm_sum);
    t_comp = t_comp + tmax;
    if (iters > 0) n_comm = n_comm + comm_sum;
    iters += 1;
  }
  if (lane == 0) {
    float* o = P.out + static_cast<size_t>(row) * 3;
    o[0] = t_comp;
    o[1] = static_cast<float>(iters);
    o[2] = n_comm;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int we_rounds_launch(const float* lam, const float* sched,
                                const float* flags, float* out, int B, int K,
                                int R, unsigned int k0, unsigned int k1,
                                float n0, float threshold, float cap,
                                int known, int max_iter, int active0,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  Params P{lam, sched, flags, out, B, K, R, {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu},
           n0, threshold, cap, known, max_iter, active0};
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 32) {
    we_rounds_kernel<1><<<grid, block, 0, s>>>(P);
  } else if (K <= 64) {
    we_rounds_kernel<2><<<grid, block, 0, s>>>(P);
  } else if (K <= 128) {
    we_rounds_kernel<4><<<grid, block, 0, s>>>(P);
  } else if (K <= 256) {
    we_rounds_kernel<8><<<grid, block, 0, s>>>(P);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
