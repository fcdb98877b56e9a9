// simLSH weighted sign-projection accumulator (paper Alg. 1, Eq. 3), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `simlsh_encode` (src/repro/kernels/
// simlsh_encode/kernel.py, body `_encode_kernel`).  Per item n of an
// ELL-padded rater list:
//   S[n, g] = sum_d psi[n, d] * phi[n, d, g]      (g < bits <= 30)
// the pre-sign accumulator whose sign bits are the band signature.
// Padding slots carry psi = 0 and add +-0.
//
// What bounds it on the H100: memory.  Each item reads deg weights and
// deg * bits floats of Phi and writes bits floats; at the serving catalog
// (N = 10^6, deg 24, bits 18) one band moves 1.9 GB against 0.86 GFLOP,
// so 0.57 ms at 3.35 TB/s is its floor.  The design is the paper's CUDA
// one, not the TPU's (items x deg x bits) VMEM tile: one warp per item,
// lane g < bits owning S[n, g] in a register and looping over d, with
// f32 FMAs in d order (no tensor cores, no TF32).  The warp loads 32
// weights at a time with one coalesced read and broadcasts each with a
// shuffle; Phi[n, d, 0:bits] is one contiguous run per step.  Lanes >=
// bits idle (14 of 32 at bits = 18); no shared memory, no barrier, no
// padding of N.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
simlsh_encode_kernel(const float* __restrict__ psi,
                     const float* __restrict__ phi, float* __restrict__ out,
                     long long N, int deg, int bits) {
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  const float* w = psi + n * deg;
  const float* ph = phi + n * deg * bits;
  float acc = 0.f;
  for (int d0 = 0; d0 < deg; d0 += 32) {
    const float mine = d0 + lane < deg ? w[d0 + lane] : 0.f;
    const int span = deg - d0 < 32 ? deg - d0 : 32;
    for (int k = 0; k < span; ++k) {
      const float wk = __shfl_sync(0xffffffffu, mine, k);
      if (lane < bits) acc = fmaf(wk, ph[(long long)(d0 + k) * bits + lane],
                                  acc);
    }
  }
  if (lane < bits) out[n * bits + lane] = acc;
}

}  // namespace

// Launch on `stream`: one warp per item.  Shapes: psi [N, deg], phi
// [N, deg, bits], out [N, bits], all float32 and contiguous; bits <= 32.
// Returns cudaGetLastError().
extern "C" int simlsh_encode_launch(const float* psi, const float* phi,
                                    float* out, long long N, int deg,
                                    int bits, void* stream) {
  if (N == 0) return 0;
  const long long blocks = (N + kWarps - 1) / kWarps;
  simlsh_encode_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(psi, phi, out, N, deg, bits);
  return (int)cudaGetLastError();
}
