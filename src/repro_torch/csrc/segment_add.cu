// Deterministic scatter-add along dim 0, for Hopper (sm_90a).
//
// No TPU kernel: it replaces `torch.Tensor.index_add_` on the card, whose
// CUDA version adds colliding rows with atomics in an order that changes
// from run to run.  The port's colliding float scatters (the online
// update's masked step, the packed steps' leftover batches, simLSH's
// segment sum, the baselines) go through `core/scatter.py::index_add_det_`,
// which sorts the ids stably and launches this kernel.
//
// Given the ids sorted stably (`sorted_ids`) and the permutation that
// sorts them (`order`), each thread takes one (sorted position p, column
// c) pair, consecutive threads on consecutive columns of a row.  Only the
// thread at the first position of a run of equal ids works: it starts from
// dst[id, c], adds src[order[p], c], src[order[p + 1], c], ... in sorted
// (= original, the sort being stable) order, and writes once.  That is the
// order of the CPU's `index_add_` (`dst[idx[i]] += src[i]` for i = 0, 1,
// ...), so the card gives the CPU's bits, on every run.  No atomics, no
// barrier, no shared memory: each (id, c) has exactly one writer.
//
// What bounds it on the H100: memory.  It reads src and the two id arrays
// once and reads and writes each touched dst row once (at the online
// step's scatter of 4,096 rows into the 128-wide V: ~4 MB, 1.2 us at
// 3.35 TB/s).  The adds of one (id, c) form one dependent chain in index
// order — the price of the CPU's bits — so a hot id costs L adds in a row
// (the fit's popular items run to thousands).  To keep that chain short
// in time, the working thread first finds the run's end (a galloping then
// binary search: one load for a run of one), so the loop's trip count is
// known and eight loads of `order` and of src are in flight before the
// eight adds that consume them, in order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
segment_add_kernel(float* __restrict__ dst, long long ld, long long rows,
                   const int* __restrict__ sorted_ids,
                   const long long* __restrict__ order,
                   const float* __restrict__ src, long long n, int width) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n * width) return;
  const long long p = t / width;
  const int c = (int)(t - p * width);
  const int id = sorted_ids[p];
  if (p > 0 && sorted_ids[p - 1] == id) return;  // not the run's first slot
  if (id < 0 || id >= rows) __trap();  // as index_add_'s device assert
  // the run is [p, end): gallop until a probe leaves it, then bisect
  long long known = p, step = 1, hi = n;
  while (true) {
    const long long probe = known + step;
    if (probe >= n || sorted_ids[probe] != id) {
      hi = probe < n ? probe : n;
      break;
    }
    known = probe;
    step <<= 1;
  }
  long long lo = known + 1;  // [p, lo) is the run; hi is past it
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (sorted_ids[mid] == id) lo = mid + 1; else hi = mid;
  }
  const long long end = lo;
  float* out = dst + (long long)id * ld + c;
  float acc = *out;
  long long q = p;
  for (; q + kUnroll <= end; q += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[order[q + u] * width + c];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, v[u]);  // in order
  }
  for (; q < end; ++q) acc = __fadd_rn(acc, src[order[q] * width + c]);
  *out = acc;
}

}  // namespace

// Launch on `stream`.  dst: `rows` rows of `width` float32 at a row stride
// of `ld` elements (a column slice of a wider plane has ld > width);
// sorted_ids: int32 [n], order: int64 [n]; src: float32 [n, width],
// contiguous.  Returns cudaGetLastError().
extern "C" int segment_add_launch(float* dst, long long ld, long long rows,
                                  const int* sorted_ids,
                                  const long long* order, const float* src,
                                  long long n, int width, void* stream) {
  if (n == 0 || width == 0) return 0;
  const long long total = n * width;
  const long long blocks = (total + kThreads - 1) / kThreads;
  segment_add_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      dst, ld, rows, sorted_ids, order, src, n, width);
  return (int)cudaGetLastError();
}
