// Fused, in-place CUSGD++ SGD step for plain MF over the packed planes
// (paper Alg. 2), for Hopper (sm_90a).
//
// Replaces the TPU kernel `mf_sgd_step` (src/repro/kernels/mf_sgd/
// kernel.py, body `_sgd_kernel`) together with the plane gathers and the
// delta scatter around it (src/repro/kernels/mf_sgd/ops.py::apply_mf_sgd):
// one launch per conflict-free batch.  Slot s of the batch is triple
// p = start + s of the schedule-ordered data (i, j, r); valid[s] == 0 marks
// a padding slot.  For each valid slot a warp reads u = U[i] (the first F
// floats of row i of the row plane) and v = V[j] (of row j of the col
// plane) by id, then computes
//   e  = r - u.v                  (r - sigmoid(u.v) for the BCE loss)
//   u' = u + gu * (e * v - lu * u)
//   v' = v + gv * (e * u - lv * v)
// both updates from the stale u and v, and writes u' and v' straight back
// into the planes.  hp[4] = (gu, gv, lu, lv) lives on the device, so a
// launch reads nothing from the host.
//
// Two hazards, and what the design does about each:
//   1. Padding slots that repeat a live i or j.  A schedule window reads
//      past its batch's fill, so an invalid slot may carry the ids of a
//      valid one.  Invalid slots write nothing (not even an unchanged
//      copy, which would race with the live slot's write).
//   2. Conflict-freedom is assumed, not checked: no two valid slots of a
//      batch may share an i or a j.  A slot then reads and writes only its
//      own u and v, so no grid barrier is needed (unlike the CULSH-MF step,
//      whose neighbour baselines belong to other slots): this is a plain
//      launch.  Only the conflict-free tiers of the schedule come here; the
//      leftover batches stay on the plain packed step (core/sgd.py).
//
// What bounds it on the H100: memory, and at the fit's widths the latency
// of two dependent round trips (the ids, then the rows).  At B = 512,
// F = 128 it reads and writes back 2 * F floats per live slot plus i, j, r
// and the mask (about 1.05 MB, 0.31 us at 3.35 TB/s) for ~14 F flops a
// slot.  The design:
//   * one warp per slot, two warps per 64-thread block, so a 512-wide batch
//     spreads over 256 blocks on all 132 SMs;
//   * lanes stride F (f = l, l+32, ...) in rounds of NF = 4 values a lane,
//     and a lane issues all of a round's loads of u and v before it
//     reduces; loads are scalar, since the rows are not 16-byte aligned
//     (the row plane is F+1 floats wide, the col plane F+2K+1);
//   * up to F = 128 the round is the whole row and stays in registers
//     between the reduction and the write; wider rows (the `kWide`
//     instance) read their later rounds again for the write, which is safe
//     because no other slot writes them (hazard 2);
//   * a warp-shuffle reduction of u.v: no shared memory, no block barrier.
// The dot product is summed in another order than the plain version's and
// the compiler may fuse multiply-adds, so results agree to ~1e-6 relative.
#include <cuda_runtime.h>
#include <math.h>

// The operands of one conflict-free tier (or one batch), set once by the
// caller; each launch adds the batch's start and its row of `valid`.
struct MfArgs {
  float* row;          // [M, row_w] row plane (U in its first F columns)
  float* col;          // [N, col_w] col plane (V in its first F columns)
  const int* i;        // [P] row ids of the schedule-ordered triples
  const int* j;        // [P] col ids
  const float* r;      // [P] ratings
  const float* valid;  // [n_batches, width] per-batch slot masks
  const float* hp;     // [4] (gu, gv, lu, lv)
  void* stream;        // the CUDA stream launches go to
  int width, F, row_w, col_w, bce;
};

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int NF = 4;  // values a lane a round (see the header)

// kWide: F > 32 * NF, so later rounds run; without it the loop over rounds
// compiles to its single first round.
template <bool kBce, bool kWide>
__global__ void __launch_bounds__(kThreads)
mf_sgd_kernel(MfArgs a, long long start, const float* valid) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= a.width) return;  // the whole warp leaves together
  const float vld = valid[s];
  if (vld == 0.f) return;    // hazard 1: padding slots write nothing
  const int F = a.F;
  const int f_end = kWide ? F : 1;
  const long long p = start + s;
  float* ur = a.row + (long long)a.i[p] * a.row_w;
  float* vr = a.col + (long long)a.j[p] * a.col_w;
  const float rating = a.r[p];

  float u[NF], v[NF];  // the first round
  float dot = 0.f;
  for (int f0 = 0; f0 < f_end; f0 += 32 * NF) {
    float uf[NF], vf[NF];
#pragma unroll
    for (int t = 0; t < NF; ++t) {  // every load of the round first
      const int f = f0 + lane + 32 * t;
      uf[t] = f < F ? ur[f] : 0.f;
      vf[t] = f < F ? vr[f] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < NF; ++t) {
      dot += uf[t] * vf[t];
      if (f0 == 0) {
        u[t] = uf[t];
        v[t] = vf[t];
      }
    }
  }
  for (int off = 16; off; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  const float out = kBce ? 1.f / (1.f + expf(-dot)) : dot;
  const float e = (rating - out) * vld;
  const float gu = a.hp[0], gv = a.hp[1], lu = a.hp[2], lv = a.hp[3];
  for (int f0 = 0; f0 < f_end; f0 += 32 * NF) {
#pragma unroll
    for (int t = 0; t < NF; ++t) {
      const int f = f0 + lane + 32 * t;
      if (f < F) {
        const float uf = f0 == 0 ? u[t] : ur[f];
        const float vf = f0 == 0 ? v[t] : vr[f];
        ur[f] = uf + gu * (e * vf - lu * uf) * vld;
        vr[f] = vf + gv * (e * uf - lv * vf) * vld;
      }
    }
  }
}

typedef void (*Kernel)(MfArgs, long long, const float*);

Kernel pick(int F, int bce) {
  if (F > 32 * NF)
    return bce ? mf_sgd_kernel<true, true> : mf_sgd_kernel<false, true>;
  return bce ? mf_sgd_kernel<true, false> : mf_sgd_kernel<false, false>;
}

}  // namespace

// One launch on a->stream: the batch at `start` whose slot mask is row `k`
// of a->valid.  Returns the launch's CUDA error code.
extern "C" int mf_sgd_launch(const MfArgs* a, long long start, long long k) {
  if (a->width <= 0) return 0;
  if (a->F < 1 || a->row_w < a->F || a->col_w < a->F)
    return (int)cudaErrorInvalidValue;
  const int blocks = (a->width + kWarps - 1) / kWarps;
  Kernel kern = pick(a->F, a->bce);
  kern<<<blocks, kThreads, 0, (cudaStream_t)a->stream>>>(
      *a, start, a->valid + k * a->width);
  return (int)cudaGetLastError();
}
