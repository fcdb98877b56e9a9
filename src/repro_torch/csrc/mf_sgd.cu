// CUSGD++ SGD step (paper Alg. 2) for plain MF, for Hopper (sm_90a).
//
// Replaces the TPU kernel `mf_sgd_step` (src/repro/kernels/mf_sgd/
// kernel.py, body `_sgd_kernel`).  Per sample s of a conflict-free batch:
//   e  = (r - u.v) * valid        (r - sigmoid(u.v) for the BCE loss)
//   u' = u + gu * (e * v - lu * u) * valid
//   v' = v + gv * (e * u - lv * v) * valid
// both updates from the stale u and v, as the register-resident CUDA kernel
// of the paper does.  hp[4] = (gu, gv, lu, lv) lives on the device.  A
// sample with valid == 0 is copied bit for bit and gets e = 0.
//
// What bounds it on the H100: memory, and at the fit's batch widths launch
// latency.  At B = 512, F = 128 it reads 2 * B * F + 2 * B floats and
// writes 2 * B * F + B (about 1.05 MB, 0.31 us at 3.35 TB/s) for ~8 * F
// flops a sample.  One warp per sample, lane l holding f = l, l+32, ...;
// the dot product is a warp-shuffle reduction, so no shared memory and no
// barrier; the update pass re-reads u and v from L1.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kBce>
__global__ void __launch_bounds__(kThreads)
mf_sgd_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const float* __restrict__ r, const float* __restrict__ valid,
              const float* __restrict__ hp, float* __restrict__ u_out,
              float* __restrict__ v_out, float* __restrict__ e_out, int B,
              int F) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= B) return;  // the whole warp leaves together
  const float* us = u + s * F;
  const float* vs = v + s * F;
  float* uo = u_out + s * F;
  float* vo = v_out + s * F;
  const float vld = valid[s];
  if (vld == 0.f) {
    for (int f = lane; f < F; f += 32) {
      uo[f] = us[f];
      vo[f] = vs[f];
    }
    if (lane == 0) e_out[s] = 0.f;
    return;
  }
  const float gu = hp[0], gv = hp[1], lu = hp[2], lv = hp[3];
  float dot = 0.f;
  for (int f = lane; f < F; f += 32) dot += us[f] * vs[f];
  for (int off = 16; off; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  const float out = kBce ? 1.f / (1.f + expf(-dot)) : dot;
  const float e = (r[s] - out) * vld;
  for (int f = lane; f < F; f += 32) {
    const float a = us[f], b = vs[f];
    uo[f] = a + gu * (e * b - lu * a) * vld;
    vo[f] = b + gv * (e * a - lv * b) * vld;
  }
  if (lane == 0) e_out[s] = e;
}

}  // namespace

// Launch on `stream`: one warp per sample.  Shapes: u/v/u_out/v_out [B, F],
// r/valid/e_out [B], hp [4], all float32 and contiguous.  Returns
// cudaGetLastError().
extern "C" int mf_sgd_step_launch(const float* u, const float* v,
                                  const float* r, const float* valid,
                                  const float* hp, float* u_out, float* v_out,
                                  float* e_out, int B, int F, int bce,
                                  void* stream) {
  if (B == 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  cudaStream_t st = (cudaStream_t)stream;
  if (bce)
    mf_sgd_kernel<true><<<blocks, kThreads, 0, st>>>(u, v, r, valid, hp, u_out,
                                                     v_out, e_out, B, F);
  else
    mf_sgd_kernel<false><<<blocks, kThreads, 0, st>>>(u, v, r, valid, hp, u_out,
                                                      v_out, e_out, B, F);
  return (int)cudaGetLastError();
}
