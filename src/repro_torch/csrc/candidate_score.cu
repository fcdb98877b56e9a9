// Serve-plane gather + candidate score + top-N of one flush, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `candidate_score_topn` (src/repro/kernels/
// candidate_score/kernel.py, body `_gather_score_kernel`) together with
// the scoring plumbing around it (src/repro/kernels/candidate_score/
// ops.py::score_candidates): the user-row gather, the mu fold, the id clip,
// the SENTINEL mask and the slot-to-item translation.  Per user b it reads
// row user_ids[b] of the [M, F+1] = U||b row plane and the C candidate rows
// of the [N, F+1] = V||b^ col plane by id, scores
//   s[c] = v[cand[c]].u + b^[cand[c]] + (mu + b_b)
// (ids clipped to [0, N); SENTINEL slots score NEG), and returns the top-N
// by (max score, min slot) -- the first-index tie rule of `lax.top_k` --
// as scores and item ids, SENTINEL where a slot was padding.  No
// [B, C, F] cube and no [B, C] score matrix reach device memory.
//
// What bounds it on the H100: memory.  It must read B*C plane rows of
// F+1 floats scattered by id (38.5 MB per 256-user flush at C = 768,
// F = 48; 11.5 us at 3.35 TB/s) against 2*B*C*(F+1) flops.  A row is 196
// bytes, 7 sectors, and not 16-byte aligned, so neither float4 loads nor
// TMA apply; the rate comes from keeping enough rows in flight (Little's
// law: 3.35 TB/s x ~0.7 us of latency is ~550 sectors per SM).  The
// design:
//   * one 512-thread block (16 warps) per user, two blocks per SM, so a
//     256-user flush is resident at once in one wave;
//   * the block stages the user's C ids in shared memory with one
//     coalesced read, and the user row beside them (1.0 in the b^ slot,
//     so the bias rides in the dot product);
//   * each warp walks chunks of R candidates and issues the loads of all R
//     rows before it reduces any (R x NFL independent loads a lane, R = 8
//     at F = 48), so a warp has ~56 sectors in flight and an SM ~1,800;
//     rows wider than 128 floats take rounds of 256 (NFL = 8);
//   * each warp keeps its running top-min(topn, 32) in registers, entry t
//     on lane t, and inserts a candidate by ballot and shuffle as it
//     scores it -- no block barrier;
//   * one barrier, then warp 0 merges the 16 sorted lists (a list stops at
//     its first entry that cannot enter) and writes the result;
//   * topn > 32 takes further passes of 32: each slot's score overwrites
//     its id in shared memory (the warp that scores a slot is the only one
//     that reads its id), and each pass lists the best slots below the
//     last pass's cut from there.  No [B, C] matrix reaches device memory.
// A thread-block cluster that splits a user over 2-4 blocks would add
// warps, but the chunked loads already keep more sectors in flight than
// the memory needs, with the whole flush resident.  The summation order
// differs from the plain version's, so scores agree to ~1e-6 relative and
// exact near-ties may swap order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -3e38f;     // masked-slot score
constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

// (v, i) beats (w, j) if its score is higher, or equal with a lower slot.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// A warp's running top-`topn`, best first, entry t on lane t (t < topn).
struct TopList {
  float s = -INFINITY;   // this lane's entry
  int i = kSentinel;
  float ws = -INFINITY;  // the list's worst entry (warp-uniform)
  int wi = kSentinel;

  // Insert (v, c); v and c must be warp-uniform.
  __device__ __forceinline__ void insert(float v, int c, int lane, int topn) {
    if (!better(v, c, ws, wi)) return;
    const unsigned beaten = __ballot_sync(kAll, lane < topn && better(v, c, s, i));
    const int pos = __ffs(beaten) - 1;  // the list is sorted: a suffix
    const float up_s = __shfl_up_sync(kAll, s, 1);
    const int up_i = __shfl_up_sync(kAll, i, 1);
    if (lane > pos) {
      s = up_s;
      i = up_i;
    } else if (lane == pos) {
      s = v;
      i = c;
    }
    ws = __shfl_sync(kAll, s, topn - 1);
    wi = __shfl_sync(kAll, i, topn - 1);
  }
};

template <int NFL>
__global__ void __launch_bounds__(kThreads, 2)
score_topn_kernel(const float* __restrict__ row, const float* __restrict__ mu,
                  const float* __restrict__ col,
                  const int* __restrict__ users, const int* __restrict__ cand,
                  float* __restrict__ scores_out, int* __restrict__ items_out,
                  int C, int Fp1, int topn, long long M, long long N) {
  constexpr int R = NFL >= 8 ? 2 : 16 / NFL;  // rows in flight per warp
  // rounds of 32 * NFL features: only the widest instance takes more than
  // one, so the others compile to a single round
  const int f_end = NFL == 8 ? Fp1 : 1;
  extern __shared__ int smem[];
  int* slot = smem;  // [C] candidate ids, then the slots' score bits
  float* u = reinterpret_cast<float*>(slot + C);   // [Fp1]
  float* list_s = u + Fp1;                         // [kWarps * 32]
  int* list_i = reinterpret_cast<int*>(list_s + kWarps * 32);
  float* cut_s = reinterpret_cast<float*>(list_i + kWarps * 32);  // [1]
  int* cut_i = reinterpret_cast<int*>(cut_s + 1);                 // [1]
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int F = Fp1 - 1;

  for (int c = threadIdx.x; c < C; c += kThreads) slot[c] = cand[b * C + c];
  long long uid = users[b];
  uid = uid < 0 ? 0 : (uid >= M ? M - 1 : uid);  // ids arrive in range
  const float* ur = row + uid * Fp1;
  for (int f = threadIdx.x; f < Fp1; f += kThreads) u[f] = f < F ? ur[f] : 1.f;
  const float bu = ur[F] + mu[0];  // mu + b_b
  __syncthreads();

  // score; each warp owns the slots of its chunks of R and builds its
  // list of the first pass (the best n0 slots) as it goes
  const int n0 = min(topn, 32);
  TopList top;
  for (int c0 = warp * R; c0 < C; c0 += kWarps * R) {
    int ids[R];
#pragma unroll
    for (int g = 0; g < R; ++g)  // a slot past C reads slot C-1, same chunk
      ids[g] = slot[min(c0 + g, C - 1)];
    float acc[R];
#pragma unroll
    for (int g = 0; g < R; ++g) acc[g] = 0.f;
    for (int f0 = 0; f0 < f_end; f0 += 32 * NFL) {
      float x[R][NFL], uu[NFL];
#pragma unroll
      for (int t = 0; t < NFL; ++t) {
        const int f = f0 + lane + 32 * t;
        uu[t] = f < Fp1 ? u[f] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < R; ++g) {  // every load of the round, then the math
        long long id = ids[g];
        id = id < 0 ? 0 : (id >= N ? N - 1 : id);
        const float* vr = col + id * Fp1;
#pragma unroll
        for (int t = 0; t < NFL; ++t) {
          const int f = f0 + lane + 32 * t;
          x[g][t] = f < Fp1 ? __ldg(vr + f) : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < R; ++g)
#pragma unroll
        for (int t = 0; t < NFL; ++t) acc[g] = fmaf(uu[t], x[g][t], acc[g]);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
#pragma unroll
      for (int g = 0; g < R; ++g)
        acc[g] += __shfl_xor_sync(kAll, acc[g], off);  // equal on all lanes
    float mine = 0.f;
#pragma unroll
    for (int g = 0; g < R; ++g) {
      const int c = c0 + g;
      if (c >= C) break;
      const float v = ids[g] != kSentinel ? acc[g] + bu : kNeg;
      top.insert(v, c, lane, n0);
      if (lane == g) mine = v;
    }
    // every lane read its ids before the shuffles; lane g owns slot c0 + g
    if (topn > 32 && lane < R && c0 + lane < C)
      slot[c0 + lane] = __float_as_int(mine);
  }

  // top-N in passes of n <= 32; pass p > 0 takes the best n slots below
  // the cut (cs, ci) that pass p - 1 left, from the scores in `slot`
  float cs = INFINITY;
  int ci = -1;
  for (int done = 0; done < topn; done += 32) {
    const int n = min(topn - done, 32);
    if (done > 0) {
      top = TopList();
      for (int c0 = warp * 32; c0 < C; c0 += kThreads) {
        const int c = c0 + lane;
        const float v = c < C ? __int_as_float(slot[c]) : 0.f;
        unsigned m = __ballot_sync(kAll, c < C && better(cs, ci, v, c) &&
                                             better(v, c, top.ws, top.wi));
        while (m) {  // warp-uniform; insert re-checks against the new worst
          const int g = __ffs(m) - 1;
          m &= m - 1;
          top.insert(__shfl_sync(kAll, v, g), c0 + g, lane, n);
        }
      }
    }
    if (lane < n) {
      list_s[warp * 32 + lane] = top.s;
      list_i[warp * 32 + lane] = top.i;
    }
    __syncthreads();
    if (warp == 0) {
      for (int w = 1; w < kWarps; ++w) {
        for (int t = 0; t < n; ++t) {
          const float v = list_s[w * 32 + t];
          const int c = list_i[w * 32 + t];
          if (!better(v, c, top.ws, top.wi)) break;  // the rest of w's too
          top.insert(v, c, lane, n);
        }
      }
      if (lane < n) {
        scores_out[b * topn + done + lane] = top.s;
        items_out[b * topn + done + lane] =
            top.s > kNeg && top.i < C ? cand[b * C + top.i] : kSentinel;
      }
      if (lane == 0) {
        *cut_s = top.ws;
        *cut_i = top.wi;
      }
    }
    if (done + 32 >= topn) break;
    __syncthreads();
    cs = *cut_s;
    ci = *cut_i;
  }
}

typedef void (*Kernel)(const float*, const float*, const float*, const int*,
                       const int*, float*, int*, int, int, int, long long,
                       long long);

}  // namespace

// Launch on `stream`: one block per user.  Shapes: row [M, Fp1], mu [1],
// col [N, Fp1], users [B] int32, cand [B, C] int32 (SENTINEL-padded),
// scores [B, topn] f32, items [B, topn] int32; 1 <= topn <= C, and
// (C + Fp1 + 1026) * 4 bytes of shared memory.  Returns cudaGetLastError().
extern "C" int candidate_score_launch(const float* row, const float* mu,
                                      const float* col, const int* users,
                                      const int* cand, float* scores,
                                      int* items, int B, int C, int Fp1,
                                      int topn, long long M, long long N,
                                      void* stream) {
  if (B == 0) return 0;
  if (topn < 1 || topn > C || Fp1 < 1) return (int)cudaErrorInvalidValue;
  const int nfl = (Fp1 + 31) / 32;
  Kernel k = nfl <= 1   ? score_topn_kernel<1>
             : nfl <= 2 ? score_topn_kernel<2>
             : nfl <= 4 ? score_topn_kernel<4>
                        : score_topn_kernel<8>;
  const size_t smem = ((size_t)C + Fp1 + 2 * kWarps * 32 + 2) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      row, mu, col, users, cand, scores, items, C, Fp1, topn, M, N);
  return (int)cudaGetLastError();
}
