// Fused Eq. (1) prediction (CULSH-MF Alg. 3, lines 9-11), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `neighbor_predict` (src/repro/kernels/
// neighbor_predict/kernel.py, body `_predict_kernel`).  Per sample b:
//   pred[b] = bbar[b] + sR[b] * sum_k resid[b,k] * w[b,k]
//                     + sN[b] * sum_k impl[b,k] * c[b,k]
//                     + sum_f u[b,f] * v[b,f]
// with the operands gathered and masked by the caller (`ops.py`).
//
// What bounds it on the H100: memory.  It reads 2 * F + 4 * K + 3 floats
// and writes one per sample (at B = 8,192, F = 128, K = 64: 16.9 MB, 5 us
// at 3.35 TB/s) for 2 * F + 4 * K + 4 flops.  One warp per sample, lanes
// striding over F and K so each row is read once, coalesced; the three
// sums are warp-shuffle reductions and lane 0 writes the prediction.
// Deterministic, no shared memory, no barrier, no padding of B.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
neighbor_predict_kernel(const float* __restrict__ u,
                        const float* __restrict__ v,
                        const float* __restrict__ w,
                        const float* __restrict__ c,
                        const float* __restrict__ resid,
                        const float* __restrict__ impl,
                        const float* __restrict__ bbar,
                        const float* __restrict__ sR,
                        const float* __restrict__ sN,
                        float* __restrict__ out, int B, int F, int K) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const float* ub = u + b * F;
  const float* vb = v + b * F;
  const float* wb = w + b * K;
  const float* cb = c + b * K;
  const float* rb = resid + b * K;
  const float* ib = impl + b * K;
  float dot = 0.f, expl = 0.f, imp = 0.f;
  for (int f = lane; f < F; f += 32) dot = fmaf(ub[f], vb[f], dot);
  for (int k = lane; k < K; k += 32) {
    expl = fmaf(rb[k], wb[k], expl);
    imp = fmaf(ib[k], cb[k], imp);
  }
  dot = warp_sum(dot);
  expl = warp_sum(expl);
  imp = warp_sum(imp);
  if (lane == 0) out[b] = bbar[b] + sR[b] * expl + sN[b] * imp + dot;
}

}  // namespace

// Launch on `stream`: one warp per sample.  Shapes: u, v [B, F]; w, c,
// resid, impl [B, K]; bbar, sR, sN, out [B]; all float32 and contiguous.
// Returns cudaGetLastError().
extern "C" int neighbor_predict_launch(const float* u, const float* v,
                                       const float* w, const float* c,
                                       const float* resid, const float* impl,
                                       const float* bbar, const float* sR,
                                       const float* sN, float* out, int B,
                                       int F, int K, void* stream) {
  if (B == 0) return 0;
  const int blocks = (B + kWarps - 1) / kWarps;
  neighbor_predict_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      u, v, w, c, resid, impl, bbar, sR, sN, out, B, F, K);
  return (int)cudaGetLastError();
}
