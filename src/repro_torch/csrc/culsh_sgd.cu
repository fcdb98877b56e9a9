// Fused, in-place six-parameter CULSH-MF SGD step over the packed planes
// (paper Alg. 3, update rule Eq. 5), for Hopper (sm_90a).
//
// Replaces the TPU kernel `culsh_sgd_step` (src/repro/kernels/mf_sgd/
// kernel.py, body `_culsh_kernel`) together with the plane gathers and the
// delta scatter around it (src/repro/kernels/mf_sgd/ops.py::
// apply_culsh_sgd): one launch per conflict-free batch.  Slot s of the
// batch is triple p = start + s of the schedule-ordered data (i, j, r and
// the [K] rows nb, rnb, expl); valid[s] == 0 marks a padding slot.  For
// each valid slot a warp reads row i of the row plane (U||b, F+1 floats)
// and row j of the col plane (V||W||C||b^, F+2K+1 floats) by id, and the
// neighbour baselines b^[nb_k] from the col plane, then computes
//   pred = mu + b + b^ + sR * sum_k resid_k w_k + sN * sum_k impl_k c_k + u.v
//   resid_k = (rnb_k - (mu + b + b^[nb_k])) * expl_k,   impl_k = 1 - expl_k,
//   sR = |R|^-1/2, sN = |N|^-1/2 (0 for an empty set),
//   e = (r - pred) * valid   (r - sigmoid(pred) for the BCE loss),
// and moves b, b^, u, v, w (explicit slots) and c (implicit slots) each by
// gamma * (gradient - lambda * value), every update from the pre-update
// operands, writing the new rows straight back into the planes.
// hp[13] = (gb, gbh, gu, gv, gw, gc, lb, lbh, lu, lv, lw, lc, mu) lives on
// the device, so a launch reads nothing from the host.
//
// Three hazards, and what the design does about each:
//   1. Stale b^ of neighbours.  The reference reads b^[J^K[j]] from the
//      planes before the step, but a neighbour column of one slot may be
//      another live slot's j, which this launch rewrites.  The kernel is a
//      cooperative launch: every warp reads all of its operands and
//      computes e, then the whole grid meets at
//      cooperative_groups::this_grid().sync(), and only then does any warp
//      write.  A batch is at most a few hundred warps, two per block, so
//      the grid is co-resident; the wrapper checks that with
//      cudaOccupancyMaxActiveBlocksPerMultiprocessor (culsh_sgd_capacity)
//      and raises rather than split a batch.  (Two launches -- a gather of
//      b^[nb] into a scratch, then the step -- give the same results; on
//      the H100 they took the same device time in a CUDA graph and more
//      host time per step, so the single launch stays.)
//   2. Padding slots that repeat a live i or j.  A schedule window reads
//      past its batch's fill, so an invalid slot may carry the ids of a
//      valid one.  Invalid slots write nothing (they still meet the grid
//      barrier), so the live slot's update is the only write to that row.
//   3. Conflict-freedom is assumed, not checked: no two valid slots of a
//      batch may share an i or a j, which is what makes the in-place writes
//      race-free without atomics.  Only the conflict-free tiers of the
//      schedule come here; its leftover batches stay on the plain packed
//      step (core/sgd.py).
//
// What bounds it on the H100: memory, and at the fit's widths the latency
// of the dependent round trips (ids, then rows and b^[nb]) and the grid
// barrier.  At B = 512, F = 128, K = 64 it reads both rows, the [K] rows
// nb, rnb, expl and the K neighbour baselines of every slot, and writes
// both rows back (about 1.9 MB, 0.57 us at 3.35 TB/s), for ~8F + 12K flops
// a slot.  The design:
//   * one warp per slot, two warps per 64-thread block, so a 512-wide
//     batch spreads over 256 blocks on all 132 SMs;
//   * lanes stride F and K (f = l, l+32, ...; k likewise) in rounds of
//     NF = 4 and NK = 2 values a lane; row loads are coalesced across the
//     lanes but scalar, since a col row of F+2K+1 = 257 floats is not
//     16-byte aligned;
//   * across the grid barrier a warp keeps the first round of u, v, w, c,
//     the explicit mask and the neighbour residuals in registers (all of
//     them up to F = 128, K = 64, the fit's widths); wider rows keep their
//     later residuals in shared memory (their b^[nb] may be rewritten by
//     then) and read their later rounds of u, v, w, c and the mask again
//     after the barrier, which is safe because no other slot writes them;
//   * warp shuffles reduce u.v, sum resid*w, sum impl*c, |R| and |N|: no
//     block barrier besides the grid's.
// The sums are taken in another order than the plain version's and the
// compiler may fuse multiply-adds, so results agree to ~1e-6 relative.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

// The operands of one conflict-free tier (or one batch), set once by the
// caller; each launch adds the batch's start and its row of `valid`.
struct CulshArgs {
  float* row;          // [M, F+1] row plane, updated in place
  float* col;          // [N, F+2K+1] col plane, updated in place
  const int* i;        // [P] row ids of the schedule-ordered triples
  const int* j;        // [P] col ids
  const float* r;      // [P] ratings
  const int* nb;       // [P, K] neighbour col ids (J^K[j])
  const float* rnb;    // [P, K] neighbour ratings
  const float* expl;   // [P, K] explicit-slot mask
  const float* valid;  // [n_batches, width] per-batch slot masks
  const float* hp;     // [13] hyper-parameters (see the header)
  void* stream;        // the CUDA stream launches go to
  int width, F, K, bce;
};

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr int NF = 4, NK = 2;  // values a lane a round (see the header)

// kWide: F > 32 * NF or K > 32 * NK, so later rounds run; without it each
// loop over rounds compiles to its single first round.
template <bool kBce, bool kWide>
__global__ void __launch_bounds__(kThreads)
culsh_sgd_kernel(CulshArgs a, long long start, const float* valid) {
  extern __shared__ float resid_all[];  // [kWarps, K]; rounds after the first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + warp;
  const int F = a.F, K = a.K;
  const int Fr = F + 1, Fc = F + 2 * K + 1;
  const float vld = s < a.width ? valid[s] : 0.f;
  const bool live = vld != 0.f;  // uniform across the warp
  float* resid = resid_all + warp * K;  // this warp's, one lane per k
  const int f_end = kWide ? F : 1, k_end = kWide ? K : 1;

  float u[NF], v[NF], w[NK], c[NK], ex[NK], rsd[NK];  // the first round
  float b = 0.f, bh = 0.f, e = 0.f, sR = 0.f, sN = 0.f;
  float* ur = nullptr;
  float* cr = nullptr;
  const float* ke = nullptr;
  if (live) {
    const long long p = start + s;
    ur = a.row + (long long)a.i[p] * Fr;
    cr = a.col + (long long)a.j[p] * Fc;
    b = ur[F];
    bh = cr[F + 2 * K];
    const float mub = a.hp[12] + b;
    const int* kn = a.nb + p * K;
    const float* kr = a.rnb + p * K;
    ke = a.expl + p * K;

    // phase 1: read every operand and take the Eq. (1) forward
    float dot = 0.f, sw = 0.f, sc = 0.f, nR = 0.f, nN = 0.f;
    for (int f0 = 0; f0 < f_end; f0 += 32 * NF) {
#pragma unroll
      for (int t = 0; t < NF; ++t) {
        const int f = f0 + lane + 32 * t;
        const float uf = f < F ? ur[f] : 0.f, vf = f < F ? cr[f] : 0.f;
        dot += uf * vf;
        if (f0 == 0) {
          u[t] = uf;
          v[t] = vf;
        }
      }
    }
    for (int k0 = 0; k0 < k_end; k0 += 32 * NK) {
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        const int k = k0 + lane + 32 * t;
        float exk = 1.f, wk = 0.f, ck = 0.f;  // no implicit slot beyond K
        if (k < K) {
          const float bh_nb = a.col[(long long)kn[k] * Fc + F + 2 * K];
          exk = ke[k];
          wk = cr[F + k];
          ck = cr[F + K + k];
          const float rs = (kr[k] - (mub + bh_nb)) * exk;
          if (k0 == 0)
            rsd[t] = rs;
          else
            resid[k] = rs;
          sw += rs * wk;
          nR += exk;
        }
        sc += (1.f - exk) * ck;
        nN += 1.f - exk;
        if (k0 == 0) {
          w[t] = wk;
          c[t] = ck;
          ex[t] = exk;
        }
      }
    }
    dot = warp_sum(dot);
    sw = warp_sum(sw);
    sc = warp_sum(sc);
    nR = warp_sum(nR);
    nN = warp_sum(nN);
    sR = nR > 0.f ? 1.f / sqrtf(fmaxf(nR, 1.f)) : 0.f;
    sN = nN > 0.f ? 1.f / sqrtf(fmaxf(nN, 1.f)) : 0.f;
    const float pred = (mub + bh) + sR * sw + sN * sc + dot;
    const float out = kBce ? 1.f / (1.f + expf(-pred)) : pred;
    e = (a.r[p] - out) * vld;
  }

  // hazard 1: no warp writes before every warp has read its b^[nb]
  cg::this_grid().sync();
  if (!live) return;  // hazard 2: padding slots write nothing

  // phase 2: Eq. (5) from the pre-update operands, written in place; rounds
  // after the first read u, v, w, c again, which are this slot's alone
  // (hazard 3), so they still hold what phase 1 read
  const float* hp = a.hp;
  const float gb = hp[0], gbh = hp[1], gu = hp[2], gv = hp[3];
  const float gw = hp[4], gc = hp[5];
  const float lb = hp[6], lbh = hp[7], lu = hp[8], lv = hp[9];
  const float lw = hp[10], lc = hp[11];
  for (int f0 = 0; f0 < f_end; f0 += 32 * NF) {
#pragma unroll
    for (int t = 0; t < NF; ++t) {
      const int f = f0 + lane + 32 * t;
      if (f < F) {
        const float uf = f0 == 0 ? u[t] : ur[f];
        const float vf = f0 == 0 ? v[t] : cr[f];
        ur[f] = uf + gu * (e * vf - lu * uf) * vld;
        cr[f] = vf + gv * (e * uf - lv * vf) * vld;
      }
    }
  }
  for (int k0 = 0; k0 < k_end; k0 += 32 * NK) {
#pragma unroll
    for (int t = 0; t < NK; ++t) {
      const int k = k0 + lane + 32 * t;
      if (k < K) {
        const float exk = k0 == 0 ? ex[t] : ke[k];
        const float wk = k0 == 0 ? w[t] : cr[F + k];
        const float ck = k0 == 0 ? c[t] : cr[F + K + k];
        const float rk = k0 == 0 ? rsd[t] : resid[k];
        cr[F + k] = wk + gw * (sR * e * rk - lw * wk) * exk * vld;
        cr[F + K + k] = ck + gc * (sN * e - lc * ck) * (1.f - exk) * vld;
      }
    }
  }
  if (lane == 0) {  // b and b^: every lane read them before the barrier
    ur[F] = b + gb * (e - lb * b) * vld;
    cr[F + 2 * K] = bh + gbh * (e - lbh * bh) * vld;
  }
}

typedef void (*Kernel)(CulshArgs, long long, const float*);

Kernel pick(int F, int K, int bce) {
  if (F > 32 * NF || K > 32 * NK)
    return bce ? culsh_sgd_kernel<true, true> : culsh_sgd_kernel<false, true>;
  return bce ? culsh_sgd_kernel<true, false> : culsh_sgd_kernel<false, false>;
}

// The residuals' shared memory for K, raising the kernel's limit past the
// default 48 KB where it needs more.
cudaError_t prepare(Kernel k, int K, size_t* smem) {
  *smem = (size_t)kWarps * K * sizeof(float);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

// How many blocks of the kernel for (F, K, bce) the card holds at once, or
// a negative CUDA error code (-1: F or K out of range).  A batch of `width`
// slots needs ceil(width / 2) of them.
extern "C" int culsh_sgd_capacity(int F, int K, int bce) {
  if (F < 1 || K < 0) return -1;
  Kernel k = pick(F, K, bce);
  size_t smem = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = prepare(k, K, &smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                      smem);
  if (e != cudaSuccess) return -(int)e;
  return sms * per_sm;
}

// One cooperative launch on a->stream: the batch at `start` whose slot
// mask is row `k` of a->valid.  Returns the launch's CUDA error code.
extern "C" int culsh_sgd_launch(const CulshArgs* a, long long start,
                                long long k) {
  if (a->width <= 0) return 0;
  if (a->F < 1 || a->K < 0) return (int)cudaErrorInvalidValue;
  Kernel kern = pick(a->F, a->K, a->bce);
  size_t smem = 0;
  cudaError_t e = prepare(kern, a->K, &smem);
  if (e != cudaSuccess) return (int)e;
  CulshArgs args = *a;
  const float* valid = a->valid + k * a->width;
  void* params[] = {(void*)&args, (void*)&start, (void*)&valid};
  const int blocks = (a->width + kWarps - 1) / kWarps;
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(blocks), dim3(kThreads),
                                  params, smem, (cudaStream_t)a->stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next call starts clean
    return (int)e;
  }
  return (int)cudaGetLastError();
}
