// Fused six-parameter CULSH-MF SGD step (paper Alg. 3, update rule Eq. 5),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `culsh_sgd_step` (src/repro/kernels/mf_sgd/
// kernel.py, body `_culsh_kernel`).  Per sample s of a conflict-free batch
// it takes the gathered packed rows row[s] = U||b and col[s] = V||W||C||b^,
// the neighbour operands rnb, bh_nb = b^[J^K[j]] and expl ([K] each), the
// rating r and the valid flag, and writes the updated rows:
//   pred = mu + b + b^ + sR * sum_k resid_k w_k + sN * sum_k impl_k c_k + u.v
//   resid_k = (rnb_k - (mu + b + bh_nb_k)) * expl_k,   impl_k = 1 - expl_k,
//   sR = |R|^-1/2, sN = |N|^-1/2 (0 for an empty set),
//   e = (r - pred) * valid   (r - sigmoid(pred) for the BCE loss),
// then b, b^, u, v, w (explicit slots) and c (implicit slots) each move by
// gamma * (gradient - lambda * value), every update from the pre-update
// operands.  hp[13] = (gb, gbh, gu, gv, gw, gc, lb, lbh, lu, lv, lw, lc, mu)
// lives on the device, so a launch reads nothing from the host.  A sample
// with valid == 0 is copied bit for bit: the caller scatters out - in, so
// a padding slot that repeats a live i or j adds exactly 0.
//
// What bounds it on the H100: memory, and at the fit's batch widths launch
// latency.  At B = 512, F = 128, K = 64 it must read and write the two
// tiles (2 * B * (F+1) + 2 * B * (F+2K+1) floats) and read 3*B*K + 2*B + 13
// more (about 2.0 MB in all, 0.59 us at 3.35 TB/s) for ~8*F + 12*K flops a
// sample.  The
// design keeps each sample's work inside one warp and touches each byte
// once from device memory:
//   * one warp per sample, eight samples per 256-thread block;
//   * lane l holds u, v at f = l, l+32, ... and w, c, rnb, bh_nb, expl at
//     k = l, l+32, ...; loads of a row are coalesced across the lanes
//     (scalar loads: a col row of F+2K+1 = 257 floats is not 16-byte
//     aligned);
//   * warp shuffles reduce u.v, sum resid*w, sum impl*c, |R| and |N|, so no
//     shared memory and no block barrier is needed;
//   * the second pass, which writes the outputs, re-reads the row from L1.
// The sums are taken in another order than the plain version's and the
// compiler may fuse multiply-adds, so results agree to ~1e-6 relative.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <bool kBce>
__global__ void __launch_bounds__(kThreads)
culsh_sgd_kernel(const float* __restrict__ row, const float* __restrict__ col,
                 const float* __restrict__ rnb,
                 const float* __restrict__ bh_nb,
                 const float* __restrict__ expl, const float* __restrict__ r,
                 const float* __restrict__ valid,
                 const float* __restrict__ hp, float* __restrict__ row_out,
                 float* __restrict__ col_out, int B, int F, int K) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= B) return;  // the whole warp leaves together
  const int Fr = F + 1, Fc = F + 2 * K + 1;
  const float* ur = row + s * Fr;
  const float* cr = col + s * Fc;
  float* uo = row_out + s * Fr;
  float* co = col_out + s * Fc;
  const float vld = valid[s];
  if (vld == 0.f) {
    for (int f = lane; f < Fr; f += 32) uo[f] = ur[f];
    for (int f = lane; f < Fc; f += 32) co[f] = cr[f];
    return;
  }
  const float gb = hp[0], gbh = hp[1], gu = hp[2], gv = hp[3];
  const float gw = hp[4], gc = hp[5];
  const float lb = hp[6], lbh = hp[7], lu = hp[8], lv = hp[9];
  const float lw = hp[10], lc = hp[11], mu = hp[12];
  const float b = ur[F], bh = cr[F + 2 * K];
  const float* kr = rnb + s * K;
  const float* kb = bh_nb + s * K;
  const float* ke = expl + s * K;
  const float* w = cr + F;
  const float* c = cr + F + K;
  const float mub = mu + b;

  // pass 1: the Eq. (1) forward
  float dot = 0.f, sw = 0.f, sc = 0.f, nR = 0.f, nN = 0.f;
  for (int f = lane; f < F; f += 32) dot += ur[f] * cr[f];
  for (int k = lane; k < K; k += 32) {
    const float ex = ke[k], im = 1.f - ex;
    const float resid = (kr[k] - (mub + kb[k])) * ex;
    sw += resid * w[k];
    sc += im * c[k];
    nR += ex;
    nN += im;
  }
  dot = warp_sum(dot);
  sw = warp_sum(sw);
  sc = warp_sum(sc);
  nR = warp_sum(nR);
  nN = warp_sum(nN);
  const float sR = nR > 0.f ? 1.f / sqrtf(fmaxf(nR, 1.f)) : 0.f;
  const float sN = nN > 0.f ? 1.f / sqrtf(fmaxf(nN, 1.f)) : 0.f;
  const float pred = (mub + bh) + sR * sw + sN * sc + dot;
  const float out = kBce ? 1.f / (1.f + expf(-pred)) : pred;
  const float e = (r[s] - out) * vld;

  // pass 2: Eq. (5) from the pre-update operands
  for (int f = lane; f < F; f += 32) {
    const float u = ur[f], v = cr[f];
    uo[f] = u + gu * (e * v - lu * u) * vld;
    co[f] = v + gv * (e * u - lv * v) * vld;
  }
  for (int k = lane; k < K; k += 32) {
    const float ex = ke[k], im = 1.f - ex;
    const float resid = (kr[k] - (mub + kb[k])) * ex;
    const float wk = w[k], ck = c[k];
    co[F + k] = wk + gw * (sR * e * resid - lw * wk) * ex * vld;
    co[F + K + k] = ck + gc * (sN * e - lc * ck) * im * vld;
  }
  if (lane == 0) {
    uo[F] = b + gb * (e - lb * b) * vld;
    co[F + 2 * K] = bh + gbh * (e - lbh * bh) * vld;
  }
}

}  // namespace

// Launch on `stream`: one warp per sample.  Shapes: row/row_out [B, F+1],
// col/col_out [B, F+2K+1], rnb/bh_nb/expl [B, K], r/valid [B], hp [13], all
// float32 and contiguous.  Returns cudaGetLastError().
extern "C" int culsh_sgd_step_launch(const float* row, const float* col,
                                     const float* rnb, const float* bh_nb,
                                     const float* expl, const float* r,
                                     const float* valid, const float* hp,
                                     float* row_out, float* col_out, int B,
                                     int F, int K, int bce, void* stream) {
  if (B == 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  cudaStream_t st = (cudaStream_t)stream;
  if (bce)
    culsh_sgd_kernel<true><<<blocks, kThreads, 0, st>>>(
        row, col, rnb, bh_nb, expl, r, valid, hp, row_out, col_out, B, F, K);
  else
    culsh_sgd_kernel<false><<<blocks, kThreads, 0, st>>>(
        row, col, rnb, bh_nb, expl, r, valid, hp, row_out, col_out, B, F, K);
  return (int)cudaGetLastError();
}
