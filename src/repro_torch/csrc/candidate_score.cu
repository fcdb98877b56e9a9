// Candidate gather + score + top-N, for Hopper (sm_90a).
//
// Replaces the TPU kernel `candidate_score_topn` (src/repro/kernels/
// candidate_score/kernel.py, body `_gather_score_kernel`).  Per user b it
// gathers the C candidate rows of the [N, F+1] = V||b^ serve plane by id,
// scores s[c] = v.u + b^ + (mu + b_i) (the mu + b_i term arrives folded
// into the user row's last column), gives masked slots NEG, and picks the
// top-N by iterative argmax on (max score, min slot) -- the first-index
// tie rule of `lax.top_k` -- knocking each winner out with -3.4e38.
//
// What bounds it on the H100: memory.  The function must read B*C plane
// rows of (F+1) floats (38.5 MB per 256-user flush at C = 768, F = 48),
// scattered by id, against 2*B*C*(F+1) flops.  The design reads each row
// once and keeps everything else on chip:
//   * one thread block per user; the user row (F+1 floats) sits in
//     shared memory;
//   * warps stride over the candidates; for each one the lanes read the
//     plane row together (coalesced within the row) and reduce the dot
//     product by warp shuffle;
//   * the C scores stay in shared memory (3 KB at C = 768) -- no
//     [B, C, F] cube and no [B, C] score matrix in device memory;
//   * topn rounds of a block-wide (score, slot) argmax select the output.
// The summation order differs from the plain version's, so scores agree
// to ~1e-6 relative and exact near-ties may swap order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3e38f;    // masked-slot score
constexpr float kNeg2 = -3.4e38f; // knock-out, strictly below kNeg
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (v, i) beats (w, j) if its score is higher, or equal with a lower slot.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
candidate_score_kernel(const float* __restrict__ urow,
                       const float* __restrict__ plane,
                       const int* __restrict__ cand,
                       const float* __restrict__ mask,
                       float* __restrict__ scores_out,
                       int* __restrict__ idx_out, int C, int Fp1, int topn,
                       long long N) {
  extern __shared__ float smem[];
  float* u = smem;                          // [Fp1]
  float* s = smem + Fp1;                    // [C]
  float* red_v = s + C;                     // [kWarps]
  int* red_i = (int*)(red_v + kWarps);      // [kWarps]
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int F = Fp1 - 1;

  for (int f = threadIdx.x; f < Fp1; f += kThreads) u[f] = urow[b * Fp1 + f];
  __syncthreads();
  const float bu = u[F];

  const int* cb = cand + b * C;
  const float* mb = mask + b * C;
  for (int c = warp; c < C; c += kWarps) {
    long long id = cb[c];
    id = id < 0 ? 0 : (id >= N ? N - 1 : id);  // ids arrive pre-clipped
    const float* row = plane + id * Fp1;
    float acc = 0.f;
    for (int f = lane; f < F; f += 32) acc = fmaf(u[f], row[f], acc);
    for (int off = 16; off; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s[c] = mb[c] > 0.f ? (acc + row[F]) + bu : kNeg;
  }
  __syncthreads();

  for (int t = 0; t < topn; ++t) {
    float best = -INFINITY;
    int bi = 0x7FFFFFFF;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float v = s[c];
      if (better(v, c, best, bi)) {
        best = v;
        bi = c;
      }
    }
    warp_argmax(best, bi);
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? red_v[lane] : -INFINITY;
      bi = lane < kWarps ? red_i[lane] : 0x7FFFFFFF;
      warp_argmax(best, bi);
      if (lane == 0) {
        scores_out[b * topn + t] = best;
        idx_out[b * topn + t] = bi;
        s[bi] = kNeg2;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launch on `stream`: one block per user.  Shapes: urow [B, Fp1], plane
// [N, Fp1], cand [B, C] int32 ids in [0, N), mask [B, C] f32 (> 0 =
// valid), scores/idx [B, topn].  Returns cudaGetLastError().
extern "C" int candidate_score_topn_launch(const float* urow,
                                           const float* plane,
                                           const int* cand, const float* mask,
                                           float* scores, int* idx, int B,
                                           int C, int Fp1, int topn,
                                           long long N, void* stream) {
  if (B == 0) return 0;
  const size_t smem =
      ((size_t)Fp1 + (size_t)C + kWarps) * sizeof(float) + kWarps * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        candidate_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  candidate_score_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      urow, plane, cand, mask, scores, idx, C, Fp1, topn, N);
  return (int)cudaGetLastError();
}
