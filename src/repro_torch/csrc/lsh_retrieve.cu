// LSH bucket walk + dedup -> per-user candidate ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel `lsh_retrieve_topc` (src/repro/kernels/
// lsh_retrieve/kernel.py, body `_retrieve_kernel`).  Per user it reads I
// cap-wide windows of the flat sorted-id plane at `starts`, masks them to
// `lens`, appends the `extra` ids (online-tail hits), knocks out the
// `exclude` ids, pushes every surviving id through the invertible 30-bit
// hash h = (id * 2654435761) mod 2^30, sorts, drops adjacent duplicates
// and unhashes the first C survivors.  The output equals the plain version
// (`kernels/lsh_retrieve/ref.py`) bit for bit: any correct sort of the same
// keys gives the same rows.
//
// What bounds it on the H100.  The bytes are few: each user's window slots
// (sum(lens) ids, at most I*cap), the descriptors and the [B, C] output,
// 0.6 us at 3.35 TB/s for a 256-user flush.  The 256 users fit in one wave,
// so the kernel's time is one block's serial chain: two dependent rounds
// of loads (descriptors, then ids), then the sort of its Wp-wide pool
// (Wp = 2048 at the serving shapes).  A bitonic network through shared
// memory spends a block barrier on each of its log2(Wp)(log2(Wp)+1)/2
// stages (66 at Wp = 2048), so the design keeps the pool in registers:
//   * one block per user, Wp / KPT threads, each holding KPT keys in
//     registers (KPT = 8 and 256 threads at Wp = 2048; KPT = 16 at the
//     largest pool, 16384; one warp below Wp = 256).  Thread t holds the
//     keys at sorted positions t*KPT .. t*KPT + KPT-1;
//   * one bitonic sort over that layout: compare-exchange stages whose
//     partner lies in the same thread run in registers, those whose partner
//     lies in the same warp run with __shfl_xor_sync, and only those whose
//     partner lies in another warp go through shared memory behind a block
//     barrier (6 of the 66 stages at Wp = 2048), in two alternating
//     buffers so one barrier per stage suffices.  (A block radix sort of
//     the 30-bit keys takes four passes of histogram, scan and scatter,
//     each with several barriers and scattered shared-memory traffic; the
//     register network needs fewer barriers at these widths.)
//   * no second sort: each thread flags its unique survivors (a key unlike
//     the one before it), a block-wide exclusive scan of the flags (warp
//     ballot and popcount, then the warps' totals through shared memory)
//     gives each survivor its output slot, and survivors below C are
//     unhashed and written, the rest of the row SENTINEL;
//   * the exclude set is sorted once per block (64-id blocks in one warp's
//     registers, wider merges in shared memory) while the pool's loads are
//     in flight, and every pool id is binary-searched in it: log2(E)
//     shared reads, not E;
//   * pool slot q = r*T + t is read by thread t, so consecutive threads
//     read consecutive slots of a window; slots past `lens` are never read,
//     so the kernel does not rely on the id plane's SENTINEL apron (it also
//     bounds-checks against n_flat).
// Shared memory: the two exchange buffers of Wp keys and the E exclude ids,
// (2 Wp + E) * 4 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSentinel = 0x7FFFFFFF;   // id padding (int32 max)
constexpr int kIntMax = 0x7FFFFFFF;     // sort-domain padding, > any hash
constexpr uint32_t kMult = 2654435761u; // == -1640531535 as int32
constexpr uint32_t kInv = 244002641u;   // kMult^-1 mod 2^30
constexpr uint32_t kMask30 = 0x3FFFFFFFu;
constexpr unsigned kFull = 0xffffffffu;

// One compare-exchange of a bitonic merge across threads: this side of
// the pair holds `a`, the other `b`; keep the smaller where this side is the
// lower position of an ascending pair or the upper of a descending one.
__device__ __forceinline__ int keep(int a, int b, bool lower, bool up) {
  return lower == up ? min(a, b) : max(a, b);
}

// The stages j = J, J/2, .., 1 (J < KPT) of the merge of blocks of k keys,
// whose pairs lie inside one thread: registers r and r | j.  `base` is the
// thread's first position, so position base | r is ascending in this merge
// where its bit k is clear.
template <int KPT, int J>
struct RegStages {
  static __device__ __forceinline__ void run(int (&key)[KPT], int base,
                                             int k) {
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      if (r & J) continue;
      const bool up = ((base | r) & k) == 0;
      const int a = key[r], b = key[r | J];
      key[r] = up ? min(a, b) : max(a, b);
      key[r | J] = up ? max(a, b) : min(a, b);
    }
    RegStages<KPT, J / 2>::run(key, base, k);
  }
  // the same stages where k > KPT: one direction for the whole thread
  static __device__ __forceinline__ void run(int (&key)[KPT], bool up) {
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      if (r & J) continue;
      const int a = key[r], b = key[r | J];
      key[r] = up ? min(a, b) : max(a, b);
      key[r | J] = up ? max(a, b) : min(a, b);
    }
    RegStages<KPT, J / 2>::run(key, up);
  }
};
template <int KPT>
struct RegStages<KPT, 0> {
  static __device__ __forceinline__ void run(int (&)[KPT], int, int) {}
  static __device__ __forceinline__ void run(int (&)[KPT], bool) {}
};

// The whole merges of blocks of k = K, 2K, .., KPT keys, inside the thread.
template <int KPT, int K, bool kGo = (K <= KPT)>
struct RegMerges {
  static __device__ __forceinline__ void run(int (&key)[KPT], int base) {
    RegStages<KPT, K / 2>::run(key, base, K);
    RegMerges<KPT, 2 * K>::run(key, base);
  }
};
template <int KPT, int K>
struct RegMerges<KPT, K, false> {
  static __device__ __forceinline__ void run(int (&)[KPT], int) {}
};

// Ascending bitonic sort of the n = T * KPT keys of threads 0 .. T-1 (the
// block, or with T = 32 one warp), thread t holding positions t*KPT ..
// t*KPT + KPT-1 in key[].  Pairs inside a thread are compared in
// registers, pairs inside a warp through __shfl_xor_sync, and pairs across
// warps through `xbuf` (two buffers of n ints, used in turn, thread t's
// register r at r*T + t so neither side conflicts on a bank), one block
// barrier each.  Returns the number of those stages.
template <int KPT>
__device__ int block_sort(int (&key)[KPT], int* xbuf, int t, int T) {
  const int n = T * KPT;
  const int base = t * KPT;
  RegMerges<KPT, 2>::run(key, base);
  int stages = 0;
  for (int k = 2 * KPT; k <= n; k <<= 1) {
    const bool up = (base & k) == 0;
    for (int j = k >> 1; j >= KPT; j >>= 1) {
      const int m = j / KPT;  // the partner thread is t ^ m
      const bool lower = (t & m) == 0;
      if (m < 32) {
#pragma unroll
        for (int r = 0; r < KPT; ++r)
          key[r] = keep(key[r], __shfl_xor_sync(kFull, key[r], m), lower, up);
      } else {
        int* buf = xbuf + (stages & 1) * n;
#pragma unroll
        for (int r = 0; r < KPT; ++r) buf[r * T + t] = key[r];
        __syncthreads();
        const int t2 = t ^ m;
#pragma unroll
        for (int r = 0; r < KPT; ++r)
          key[r] = keep(key[r], buf[r * T + t2], lower, up);
        ++stages;
      }
    }
    RegStages<KPT, KPT / 2>::run(key, up);
  }
  return stages;
}

// Ascending sort of ex[0..E) by the whole block.  Each warp sorts 64-key
// blocks in registers (2 keys a lane, padded past E with kIntMax, which
// sorts last), then the blocks are merged in shared memory by the bitonic
// network whose every merge sorts ascending (its first stage compares
// mirrored pairs), so the slots past E act as +infinity and their pairs are
// skipped.  The caller has synced the block after filling ex.
__device__ void sort_exclude(int* ex, int E) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 64 * warp; c < E; c += 2 * blockDim.x) {
    int key[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = c + 2 * lane + r;
      key[r] = p < E ? ex[p] : kIntMax;
    }
    block_sort<2>(key, nullptr, lane, 32);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = c + 2 * lane + r;
      if (p < E) ex[p] = key[r];
    }
  }
  int Ep = 64;
  while (Ep < E) Ep <<= 1;
  for (int k = 128; k <= Ep; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int p = threadIdx.x; p < (Ep >> 1); p += blockDim.x) {
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int hi = j == (k >> 1) ? lo ^ (k - 1) : lo + j;
        if (hi < E) {
          const int a = ex[lo], b = ex[hi];
          if (a > b) {
            ex[lo] = b;
            ex[hi] = a;
          }
        }
      }
    }
  }
  __syncthreads();
}

template <int KPT>
__global__ void __launch_bounds__(1024)
lsh_retrieve_kernel(const int* __restrict__ starts,
                    const int* __restrict__ lens,
                    const int* __restrict__ extra,
                    const int* __restrict__ ids_flat,
                    const int* __restrict__ exclude, int* __restrict__ out,
                    int I, int X, int E, int C, int cap, int Wp,
                    long long n_flat) {
  extern __shared__ int smem[];
  int* xbuf = smem;           // [2, Wp] sort exchange; free after the sort
  int* ex = smem + 2 * Wp;    // [E] the exclude ids, sorted
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31;
  const int warp = t >> 5, nwarps = T >> 5;
  const long long b = blockIdx.x;

  for (int e = t; e < E; e += T) ex[e] = exclude[e];
  // the pool: slot q = r*T + t, window slots, then the extras, then padding
  const int W = I * cap;
  const int* st = starts + b * I;
  const int* ln = lens + b * I;
  const int* xr = extra + b * X;
  // two rounds of loads, each issued for all KPT slots before any is used
  // (a branch on one slot's descriptor would otherwise hold back the next
  // slot's loads): the windows' descriptors and the extras, then the ids
  int id[KPT], sv[KPT], lv[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int q = r * T + t;
    const bool win = q < W;
    const int i = win ? q / cap : 0;
    sv[r] = win ? st[i] : 0;
    lv[r] = win ? ln[i] : 0;
    id[r] = !win && q < W + X ? xr[q - W] : kSentinel;
  }
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int q = r * T + t;
    const int d = q % cap;
    const long long pos = (long long)sv[r] + d;
    if (q < W && d < lv[r] && pos >= 0 && pos < n_flat) id[r] = ids_flat[pos];
  }
  __syncthreads();  // the exclude ids are in
  sort_exclude(ex, E);

  // binary search of every id in the sorted exclude ids, the KPT searches
  // of a thread interleaved; then the 30-bit hash of the survivors
  int top = 1;
  while (2 * top <= E) top <<= 1;
  int at[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) at[r] = 0;
  for (int step = top; step > 0; step >>= 1) {
#pragma unroll
    for (int r = 0; r < KPT; ++r)
      if (at[r] + step <= E && ex[at[r] + step - 1] < id[r]) at[r] += step;
  }
  int key[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int v = id[r];
    const bool out_ = at[r] < E && ex[at[r]] == v;
    key[r] = (v != kSentinel && v >= 0 && !out_)
                 ? (int)(((uint32_t)v * kMult) & kMask30)
                 : kIntMax;
  }

  const int stages = block_sort<KPT>(key, xbuf, t, T);

  // unique survivors: a key unlike the one before it (the previous thread's
  // last key for r = 0), padding excluded
  int* spare = xbuf + (stages & 1) * (T * KPT);  // [2 * nwarps] ints
  int prev = __shfl_up_sync(kFull, key[KPT - 1], 1);
  if (nwarps > 1) {
    if (lane == 31) spare[warp] = key[KPT - 1];
    __syncthreads();
    if (lane == 0) prev = warp ? spare[warp - 1] : -1;
  } else if (lane == 0) {
    prev = -1;
  }
  bool keep_[KPT];
  int before = 0, wtotal = 0;  // flags before this thread's, in its warp
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int pk = r ? key[r - 1] : prev;
    keep_[r] = key[r] != kIntMax && key[r] != pk;
    const unsigned bal = __ballot_sync(kFull, keep_[r]);
    before += __popc(bal & lt);
    wtotal += __popc(bal);
  }
  // exclusive scan over the warps' totals
  int offset = 0, total = wtotal;
  if (nwarps > 1) {
    if (lane == 0) spare[nwarps + warp] = wtotal;
    __syncthreads();
    total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = spare[nwarps + w];
      offset += w < warp ? c : 0;
      total += c;
    }
  }

  int* o = out + b * C;
  int slot = offset + before;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    if (keep_[r]) {
      if (slot < C) o[slot] = (int)(((uint32_t)key[r] * kInv) & kMask30);
      ++slot;
    }
  }
  for (int c = total + t; c < C; c += T) o[c] = kSentinel;
}

template <int KPT>
int launch(const int* starts, const int* lens, const int* extra,
           const int* ids_flat, const int* exclude, int* out, int B, int I,
           int X, int E, int C, int cap, int Wp, long long n_flat,
           int threads, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)Wp + (size_t)E) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lsh_retrieve_kernel<KPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lsh_retrieve_kernel<KPT><<<B, threads, smem, stream>>>(
      starts, lens, extra, ids_flat, exclude, out, I, X, E, C, cap, Wp,
      n_flat);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`: one block per user.  Shapes: starts/lens [B, I],
// extra [B, X], ids_flat [n_flat], exclude [E], out [B, C]; Wp is the
// next power of two of I*cap + X, at most 16384.  The block sorts
// max(Wp, 32) keys: one warp of Wp/32 keys a thread up to Wp = 256, then
// Wp/8 threads of 8 keys, and 1024 threads of 16 keys at Wp = 16384.
// Returns cudaGetLastError().
extern "C" int lsh_retrieve_topc_launch(const int* starts, const int* lens,
                                        const int* extra, const int* ids_flat,
                                        const int* exclude, int* out, int B,
                                        int I, int X, int E, int C, int cap,
                                        int Wp, long long n_flat,
                                        void* stream) {
  if (B == 0) return 0;
  if (Wp < 1 || Wp > 16384 || (Wp & (Wp - 1)) || E < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  const int n = Wp < 32 ? 32 : Wp;
  const int kpt = n <= 256 ? n / 32 : (n <= 8192 ? 8 : 16);
  const int threads = n / kpt;
  cudaStream_t st = (cudaStream_t)stream;
#define LSH_LAUNCH(K)                                                      \
  launch<K>(starts, lens, extra, ids_flat, exclude, out, B, I, X, E, C,    \
            cap, Wp, n_flat, threads, st)
  switch (kpt) {
    case 1: return LSH_LAUNCH(1);
    case 2: return LSH_LAUNCH(2);
    case 4: return LSH_LAUNCH(4);
    case 8: return LSH_LAUNCH(8);
    default: return LSH_LAUNCH(16);
  }
#undef LSH_LAUNCH
}
