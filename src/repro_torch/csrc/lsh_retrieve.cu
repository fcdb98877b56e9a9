// LSH bucket walk + dedup -> per-user candidate ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel `lsh_retrieve_topc` (src/repro/kernels/
// lsh_retrieve/kernel.py, body `_retrieve_kernel`).  Per user it reads I
// cap-wide windows of the flat sorted-id plane at `starts`, masks them to
// `lens`, appends the `extra` ids (online-tail hits), knocks out the
// `exclude` ids, pushes every surviving id through the invertible 30-bit
// hash h = (id * 2654435761) mod 2^30, sorts, drops adjacent duplicates,
// sorts again and unhashes the first C keys.  The output equals the plain
// version (`kernels/lsh_retrieve/ref.py`) bit for bit: any correct sort of
// the same keys gives the same rows.
//
// What bounds it on the H100: memory.  The function must read each
// user's window slots (sum(lens) ids, at most I*cap) plus the small
// descriptor and exclude arrays, and write B*C ids; the per-user sort of
// Wp <= a few thousand keys is cheap next to the scattered 32-byte window
// reads.  The design keeps everything between the window reads and the
// output write in shared memory:
//   * one thread block per user (no grid-order dependence: the TPU
//     kernel's double-buffered DMA across a sequential grid has no
//     counterpart here, the other resident blocks hide the read latency);
//   * consecutive threads read consecutive slots of a window; slots past
//     `lens` are never read, so the kernel does not rely on the id
//     plane's SENTINEL apron (it also bounds-checks against n_flat);
//   * the exclude set lives in shared memory;
//   * two bitonic networks over the power-of-two padded row (Wp int32
//     keys, 8 KB at Wp = 2048), with the duplicate marking written to a
//     second shared buffer so no thread reads a slot another rewrites.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7FFFFFFF;   // id padding (int32 max)
constexpr int kIntMax = 0x7FFFFFFF;     // sort-domain padding, > any hash
constexpr uint32_t kMult = 2654435761u; // == -1640531535 as int32
constexpr uint32_t kInv = 244002641u;   // kMult^-1 mod 2^30
constexpr uint32_t kMask30 = 0x3FFFFFFFu;

// Ascending bitonic sort of s[0..n), n a power of two, by the whole block.
__device__ void bitonic_sort(int* s, int n) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        // p-th compare-exchange pair: lo has bit j clear, hi = lo + j
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int hi = lo + j;
        const bool up = (lo & k) == 0;
        const int a = s[lo], b = s[hi];
        if ((a > b) == up) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void lsh_retrieve_kernel(const int* __restrict__ starts,
                                    const int* __restrict__ lens,
                                    const int* __restrict__ extra,
                                    const int* __restrict__ ids_flat,
                                    const int* __restrict__ exclude,
                                    int* __restrict__ out, int I, int X,
                                    int E, int C, int cap, int Wp,
                                    long long n_flat) {
  extern __shared__ int smem[];
  int* keys = smem;          // [Wp] hashed pool
  int* uniq = smem + Wp;     // [Wp] duplicates marked as kIntMax
  int* excl = smem + 2 * Wp; // [E]
  const long long b = blockIdx.x;

  for (int e = threadIdx.x; e < E; e += blockDim.x) excl[e] = exclude[e];
  __syncthreads();

  const int W = I * cap;
  const int* st = starts + b * I;
  const int* ln = lens + b * I;
  const int* xr = extra + b * X;
  for (int t = threadIdx.x; t < Wp; t += blockDim.x) {
    int key = kIntMax;
    if (t < W + X) {
      int id = kSentinel;
      if (t < W) {
        const int i = t / cap, d = t - i * cap;
        const long long pos = (long long)st[i] + d;
        if (d < ln[i] && pos >= 0 && pos < n_flat) id = ids_flat[pos];
      } else {
        id = xr[t - W];
      }
      for (int e = 0; e < E; ++e) {
        if (id == excl[e]) {
          id = kSentinel;
          break;
        }
      }
      if (id != kSentinel && id >= 0)
        key = (int)(((uint32_t)id * kMult) & kMask30);
    }
    keys[t] = key;
  }
  __syncthreads();

  bitonic_sort(keys, Wp);
  for (int t = threadIdx.x; t < Wp; t += blockDim.x) {
    const int h = keys[t];
    const int prev = t ? keys[t - 1] : -1;
    uniq[t] = (h != prev && h != kIntMax) ? h : kIntMax;
  }
  __syncthreads();
  bitonic_sort(uniq, Wp);   // compact the survivors to the left

  int* o = out + b * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int h = uniq[c];
    o[c] = h != kIntMax ? (int)(((uint32_t)h * kInv) & kMask30) : kSentinel;
  }
}

}  // namespace

// Launch on `stream`: one block per user.  Shapes: starts/lens [B, I],
// extra [B, X], ids_flat [n_flat], exclude [E], out [B, C]; Wp is the
// next power of two of I*cap + X.  Returns cudaGetLastError().
extern "C" int lsh_retrieve_topc_launch(const int* starts, const int* lens,
                                        const int* extra, const int* ids_flat,
                                        const int* exclude, int* out, int B,
                                        int I, int X, int E, int C, int cap,
                                        int Wp, long long n_flat,
                                        void* stream) {
  if (B == 0) return 0;
  int threads = Wp / 2;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const size_t smem = (2 * (size_t)Wp + (size_t)E) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lsh_retrieve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lsh_retrieve_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      starts, lens, extra, ids_flat, exclude, out, I, X, E, C, cap, Wp,
      n_flat);
  return (int)cudaGetLastError();
}
