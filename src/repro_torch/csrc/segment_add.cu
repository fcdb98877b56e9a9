// Deterministic scatter-add along dim 0, for Hopper (sm_90a).
//
// No TPU kernel: it replaces `torch.Tensor.index_add_` on the card, whose
// CUDA version adds colliding rows with atomics in an order that changes
// from run to run.  The port's colliding float scatters (the online
// update's masked step, the packed steps' leftover batches, simLSH's
// segment sum, the baselines, `gather_rows`'s backward, the MoE combine)
// go through `core/scatter.py::index_add_det_`.
//
// Contract: dst[idx[i]] += src[i] for i = 0, 1, ... in that order, in
// float32 with __fadd_rn -- the order of the CPU's `index_add_` -- so the
// card gives the CPU's bits on every run.  No atomics in the adds: each
// (id, column) is one chain of adds in index order, run by one thread.
//
// Two steps, each a hand-written kernel of this file:
//
// 1. Grouping (the plan, `core/scatter.py::segment_plan`).  The positions
//    0..n-1 are grouped by id, stably, and a run table is written: each run
//    of equal ids' id, first grouped position and (from the next start)
//    length, plus the list of runs longer than `long_run` rows.
//      * n <= kGroupMax (8,192: the fit's leftover batches of 512 and the
//        online step's 4,096 fit with room) -- `segment_group_kernel`, one
//        block an id vector, up to two vectors a launch (a step's row ids
//        and column ids are grouped together).  The ids are read once
//        (int32 or int64, no cast launch, a thread's loads all in flight)
//        and an LSD radix sort of the bits the largest id uses, 5 a pass,
//        runs in shared memory: each thread ranks its ~4 consecutive
//        entries against its own counter of each digit, and a block scan
//        of the counters, digit-major then thread, places them -- stable
//        by construction.  At most 12 bytes an id plus 32 counters a
//        thread: 164 KB at 8,192 ids.  One scan counts the run heads
//        (where the id changes) and the long runs (where the id long_run
//        entries on is the same); the run table is staged in shared
//        memory and written out coalesced.  No torch.sort.
//      * larger n (the encode's bands, `from_coo`'s sums, long LM batches)
//        -- torch.sort of the ids sorts, and `segment_runs_kernel`, one
//        cooperative launch, writes the run table from the sorted ids (a
//        count per block, a grid barrier, each block's runs at its prefix;
//        the same again for the long runs).  Those callers reuse one plan
//        over many scatters or scatter once.
//
// 2. The adds (`segment_add_kernel`), work by (run, column tile), not by
//    position.  A tile is TW adjacent columns (32, or the width rounded up
//    to a power of two below 32); a persistent grid of 8-warp blocks walks
//    the tasks.
//      * Short runs (<= long_run rows, most ids): a warp takes 32 / TW runs
//        at once, each lane one (run, column) -- or, where dst, its row
//        stride, src and the width are 16-byte aligned, one run's 128
//        columns, four a lane; it reads the run's positions eight at a
//        time, then the eight source rows, all in flight, and adds them in
//        order into registers that started from dst.  The next task's
//        run-table entry is read before the current task's adds.
//      * Long runs: warp 0 of every block takes the (long run, tile) tasks
//        first.  The run's rows stream in index order through a ring of
//        shared-memory stages of 32 rows filled by cp.async (8 stages at
//        TW = 32: 224 rows in flight ahead of the adds; 16-byte copies
//        where aligned), its positions through a second ring two stages'
//        depth further ahead, so no load waits on another.  Lane c < TW
//        keeps column c's sum in a register and adds each staged row in
//        order; the other lanes only copy (for TW = 1 the 32 lanes copy 32
//        consecutive rows of the run and lane 0 sums them in lane order:
//        still one chain).
//      * A column slice keeps its row stride `ld` (a plane row of
//        F + 2K + 1 floats is not 16-byte aligned: scalar copies there).
//      * A run's end is its next start in the table: no search.
//
// What bounds it on the H100: the bytes (the ids, src once, each touched
// dst row read and written once) or, for a hot id, the chain: L_max
// dependent float32 adds of ~4 cycles each, which no order-preserving
// design can beat.  The one-block grouping is bound by neither: its
// passes are chains of shared-memory round trips and block barriers.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <type_traits>

namespace cg = cooperative_groups;

// An id vector to group: `n` ids (int64 if is64, else int32) into
// `plan` (int32 [4n + 4]).  Outside the anonymous namespace: the C entry
// point takes an array of them.
struct GroupJob {
  const void* idx;
  long long n;
  int is64;
  int* plan;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kGroupMax = 8192;        // the one-block grouping's largest n
constexpr int kGroupThreads = 512;
constexpr int kIpt = kGroupMax / kGroupThreads;  // ids a thread, at most
constexpr int kDigitBits = 5;          // a radix pass's digit
constexpr int kBins = 1 << kDigitBits;
constexpr int kGroupJobs = 2;          // id vectors a grouping launch
constexpr int kRunThreads = 512;       // the run-table kernel's block
constexpr int kRunMaxBlocks = 1024;    // its scratch holds 2 * this
constexpr int kAddThreads = 256;       // 8 warps; warp 0 also takes long runs
constexpr int kAddWarps = kAddThreads / 32;
constexpr int kRingFloats = 8192;      // 32 KB of staged rows for warp 0

// The plan (int32): order [n] | run_ids [n] | starts [n + 1] | long [n] |
// R, n_long, long_run.
struct PlanView {
  int* order;
  int* run_ids;
  int* starts;
  int* longs;
  int* counts;
  __host__ __device__ PlanView(int* plan, long long n)
      : order(plan), run_ids(plan + n), starts(plan + 2 * n),
        longs(plan + 3 * n + 1), counts(plan + 4 * n + 1) {}
};

__device__ __forceinline__ unsigned warp_incl_scan(unsigned x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix of `v` (one value a thread) over the block, in thread
// order; the block's total in *total.  Every thread must call it.
__device__ unsigned block_excl_scan(unsigned v, unsigned* tmp,
                                    unsigned* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned x = warp_incl_scan(v, lane);
  if (lane == 31) tmp[w] = x;
  __syncthreads();
  if (w == 0) {
    const unsigned t = warp_incl_scan(lane < nw ? tmp[lane] : 0u, lane);
    if (lane < nw) tmp[lane] = t;
  }
  __syncthreads();
  *total = tmp[nw - 1];
  const unsigned ex = (w ? tmp[w - 1] : 0u) + x - v;
  __syncthreads();  // tmp is free again
  return ex;
}

// ---------------------------------------------------------------- grouping

struct GroupJobs {  // a launch's id vectors, one block each
  GroupJob job[kGroupJobs];
};

// Shared-memory index of entry i of an array read "blocked" (thread t
// takes entries t*k .. t*k + k-1): one pad word every 32 keeps the lanes
// of a warp on distinct banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// LSD radix sort of the n ids in shared memory, then the run table.
// Thread t owns the ipt consecutive entries t*ipt .. of the current order
// and ranks them in order against its own counter of each digit, so a
// pass is stable; the counters, scanned digit-major then thread, place
// them.  Digits of 5 bits keep the counters at 32 x threads.
__global__ void __launch_bounds__(kGroupThreads)
segment_group_kernel(GroupJobs jobs, int long_run) {
  extern __shared__ unsigned sm[];
  __shared__ unsigned tmp[32];
  GroupJob job = jobs.job[0];  // one id vector a block (no local copy)
#pragma unroll
  for (int k = 1; k < kGroupJobs; ++k)
    if (blockIdx.x == k) job = jobs.job[k];
  const void* idx = job.idx;
  const int is64 = job.is64, n = (int)job.n;
  int* plan = job.plan;
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, nw = nt >> 5;
  const int ipt = (n + nt - 1) / nt;             // <= kIpt
  const int np = padded(n) + 1;
  unsigned* key = sm;                            // [n] the ids
  int* from = reinterpret_cast<int*>(sm + n);    // [np] positions
  int* to = from + np;                           // [np]
  unsigned* cnt = reinterpret_cast<unsigned*>(to + np);  // [32 * nt]
  // every load of the thread issued before the first is used
  unsigned mx = 0, kk[kIpt];
  if (is64) {  // an id outside int32 becomes -1, which the adds refuse
    long long v[kIpt];
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      const int i = tid + j * nt;
      v[j] = j < ipt && i < n ? static_cast<const long long*>(idx)[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kIpt; ++j)
      kk[j] = v[j] < 0 || v[j] > INT_MAX ? 0xffffffffu : (unsigned)v[j];
  } else {
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      const int i = tid + j * nt;
      kk[j] = j < ipt && i < n ? (unsigned)static_cast<const int*>(idx)[i]
                               : 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int i = tid + j * nt;
    if (j < ipt && i < n) {
      key[i] = kk[j];
      from[padded(i)] = i;
      mx = max(mx, kk[j]);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = max(mx, __shfl_xor_sync(kFull, mx, o));
  if (lane == 0) tmp[w] = mx;
  __syncthreads();
  mx = lane < nw ? tmp[lane] : 0u;
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = max(mx, __shfl_xor_sync(kFull, mx, o));
  __syncthreads();
  // only the bits the largest id uses, kDigitBits a pass
  const int bits = mx ? 32 - __clz((int)mx) : 0;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const int lo = tid * ipt;
  unsigned* mine = cnt + padded(tid * kBins);  // this thread's scan chunk
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kDigitBits;
#pragma unroll
    for (int k = 0; k < kBins; ++k) mine[k] = 0;  // every entry, once
    __syncthreads();
    int rank[kIpt], pos[kIpt];
    unsigned dig[kIpt];
#pragma unroll
    for (int j = 0; j < kIpt; ++j) {
      if (j < ipt && lo + j < n) {
        const int p = from[padded(lo + j)];
        const unsigned d = (key[p] >> shift) & (kBins - 1);
        unsigned* c = &cnt[padded((int)d * nt + tid)];
        rank[j] = (int)*c;
        *c = rank[j] + 1;
        pos[j] = p;
        dig[j] = d;
      }
    }
    __syncthreads();
    {  // exclusive scan of the counters, digit-major then thread
      unsigned v[kBins], s = 0;
#pragma unroll
      for (int k = 0; k < kBins; ++k) {
        v[k] = mine[k];
        s += v[k];
      }
      unsigned total;
      unsigned base = block_excl_scan(s, tmp, &total);
#pragma unroll
      for (int k = 0; k < kBins; ++k) {
        mine[k] = base;
        base += v[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kIpt; ++j)
      if (j < ipt && lo + j < n)
        to[padded((int)cnt[padded((int)dig[j] * nt + tid)] + rank[j])] =
            pos[j];
    __syncthreads();
    int* t = from;
    from = to;
    to = t;
  }
  // `from` is the grouped order.  A run starts where the id changes and
  // is long where the id long_run entries on is the same: one scan counts
  // both (run heads in the low 16 bits, long runs above; each at most
  // kGroupMax).  The run ids and starts are staged in shared memory (`cnt`,
  // `to`) and written out with consecutive threads on consecutive entries;
  // the few long runs go straight out.
  PlanView pv(plan, n);
  for (int i = tid; i < n; i += nt) pv.order[i] = from[padded(i)];
  int* sstart = to;
  unsigned* sid = cnt;
  unsigned heads = 0, longs = 0, c = 0;
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    const int i = lo + j;
    if (j < ipt && i < n) {
      const unsigned k = key[from[padded(i)]];
      if (i == 0 || k != key[from[padded(i - 1)]]) {
        heads |= 1u << j;
        ++c;
        if (i + long_run < n && key[from[padded(i + long_run)]] == k) {
          longs |= 1u << j;
          c += 1u << 16;
        }
      }
    }
  }
  unsigned total;
  const unsigned r0 = block_excl_scan(c, tmp, &total);
  unsigned r = r0 & 0xffffu, l = r0 >> 16;
  const int R = (int)(total & 0xffffu);
#pragma unroll
  for (int j = 0; j < kIpt; ++j) {
    if ((heads >> j) & 1u) {
      const int i = lo + j;
      sid[padded((int)r)] = key[from[padded(i)]];
      sstart[padded((int)r)] = i;
      if ((longs >> j) & 1u) pv.longs[l++] = (int)r;
      ++r;
    }
  }
  __syncthreads();
  for (int q = tid; q < R; q += nt) {
    pv.run_ids[q] = (int)sid[padded(q)];
    pv.starts[q] = sstart[padded(q)];
  }
  if (tid == 0) {
    pv.starts[R] = n;
    pv.counts[0] = R;
    pv.counts[1] = (int)(total >> 16);
    pv.counts[2] = long_run;
  }
}

// The run table of ids that torch.sort sorted (n > kGroupMax): one
// cooperative launch, each block a chunk of positions, then of runs.
__global__ void __launch_bounds__(kRunThreads)
segment_runs_kernel(const int* sorted, const long long* order, int n,
                    int long_run, int* plan, unsigned* scratch) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned tmp[32];
  const int B = gridDim.x, blk = blockIdx.x, nt = blockDim.x;
  const int tid = threadIdx.x;
  PlanView pv(plan, n);
  const int chunk = (n + B - 1) / B;
  const int lo = min(n, blk * chunk), hi = min(n, lo + chunk);
  auto head = [&](int i) { return i == 0 || sorted[i] != sorted[i - 1]; };
  unsigned c = 0, total;
  for (int i = lo + tid; i < hi; i += nt) {
    pv.order[i] = (int)order[i];
    c += head(i);
  }
  block_excl_scan(c, tmp, &total);
  if (tid == 0) scratch[blk] = total;
  grid.sync();
  unsigned pre = 0;
  for (int j = tid; j < blk; j += nt) pre += __ldcg(scratch + j);
  block_excl_scan(pre, tmp, &pre);
  for (int base = lo; base < hi; base += nt) {  // block-uniform
    const int i = base + tid;
    const bool f = i < hi && head(i);
    const unsigned r = pre + block_excl_scan(f, tmp, &total);
    if (f) {
      pv.run_ids[r] = sorted[i];
      pv.starts[r] = i;
    }
    pre += total;
  }
  if (blk == B - 1 && tid == 0) {
    pv.starts[pre] = n;
    pv.counts[0] = (int)pre;
    pv.counts[2] = long_run;
  }
  grid.sync();
  const int R = __ldcg(pv.counts);
  const int chunkR = (R + B - 1) / B;
  const int loR = min(R, blk * chunkR), hiR = min(R, loR + chunkR);
  auto is_long = [&](int q) {
    return __ldcg(pv.starts + q + 1) - __ldcg(pv.starts + q) > long_run;
  };
  c = 0;
  for (int q = loR + tid; q < hiR; q += nt) c += is_long(q);
  block_excl_scan(c, tmp, &total);
  if (tid == 0) scratch[B + blk] = total;
  grid.sync();
  pre = 0;
  for (int j = tid; j < blk; j += nt) pre += __ldcg(scratch + B + j);
  block_excl_scan(pre, tmp, &pre);
  for (int base = loR; base < hiR; base += nt) {
    const int q = base + tid;
    const bool f = q < hiR && is_long(q);
    const unsigned l = pre + block_excl_scan(f, tmp, &total);
    if (f) pv.longs[l] = q;
    pre += total;
  }
  if (blk == B - 1 && tid == 0) pv.counts[1] = (int)pre;
}

// -------------------------------------------------------------------- adds

struct AddArgs {
  float* dst;
  long long ld, rows;
  const float* src;
  int width;
  int n;
  const int* order;
  const int* run_ids;
  const int* starts;
  const int* longs;
  const int* counts;
};

template <int TW>
struct Ring {  // warp 0's stages of 32 rows x TW columns
  static constexpr int kStages =
      kRingFloats / (32 * TW) < 16 ? kRingFloats / (32 * TW) : 16;
};

// cp.async of VEC 4-byte words (4 or 16 bytes).  No memory clobber: the
// waits below order the copies, and the compiler may hoist the next
// copy's address loads above this one.
template <int VEC>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void check_id(int id, long long rows) {
  if (id < 0 || id >= rows) __trap();  // as index_add_'s device assert
}

// One long run's tile of TW columns, by the whole warp.  Stage t holds
// rows 32t .. 32t+31 of the run; lane group rho (LPR lanes, VEC floats a
// lane) copies rows rho*LPR .. rho*LPR + LPR - 1 of it, one row a copy
// instruction.  The positions of stage t land in the same cp.async group
// as stage t - S + 1's rows, S - 1 groups before stage t's rows are
// issued.  Lane c < TW adds column c.  Each iteration is one basic block
// (predicated copies; a row past the run adds -0.0, which leaves every
// sum as it is), so the compiler interleaves the copies with the chain.
template <int TW, int VEC>
__device__ void add_long_run(const AddArgs& a, int start, int len, int id,
                             int tile, float (*ring)[32][TW],
                             int (*pos)[32]) {
  constexpr int S = Ring<TW>::kStages;
  constexpr int LPR = TW / VEC;  // lanes a row = copies a lane a stage
  const int lane = threadIdx.x & 31, rho = lane / LPR;
  const int cv = (lane % LPR) * VEC;
  const bool copy_ok = tile * TW + cv < a.width;
  const int nst = (len + 31) / 32;
  const int* ord = a.order + start;
  const float* src = a.src + tile * TW + cv;
  for (int t = 0; t < 2 * S - 2 && t < nst; ++t)
    if (32 * t + lane < len)
      cp_async<1>(&pos[t][lane], ord + 32 * t + lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  auto issue = [&](int t) {
    const int rows_in = min(32, len - 32 * t);
    float(*stage)[TW] = ring[t % S];
    const int* p = pos[t % (2 * S)] + rho * LPR;
    int pj[LPR];
    if constexpr (LPR % 4 == 0) {
#pragma unroll
      for (int m = 0; m < LPR; m += 4) {
        const int4 q = *reinterpret_cast<const int4*>(p + m);
        pj[m] = q.x;
        pj[m + 1] = q.y;
        pj[m + 2] = q.z;
        pj[m + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int m = 0; m < LPR; ++m) pj[m] = p[m];
    }
#pragma unroll
    for (int m = 0; m < LPR; ++m) {
      const int j = rho * LPR + m;
      if (j < rows_in && copy_ok)
        cp_async<VEC>(&stage[j][cv], src + (long long)pj[m] * a.width);
    }
  };
#pragma unroll 1
  for (int t = 0; t < S - 1; ++t) {
    if (t < nst) issue(t);
    cp_async_commit();
  }
  const int col = tile * TW + lane;
  const bool add_ok = lane < TW && col < a.width;
  float* out = a.dst + (long long)id * a.ld + col;
  float acc = add_ok ? *out : 0.f;
  const int c = lane < TW ? lane : 0;
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<S - 2>();  // stage s's rows, stage s+S-1's positions
    __syncwarp();
    const float(*stage)[TW] = ring[s % S];
    const int rows_in = min(32, len - 32 * s);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      acc = __fadd_rn(acc, j < rows_in ? stage[j][c] : -0.0f);
    if (s + S - 1 < nst) issue(s + S - 1);
    const int tp = s + 2 * S - 2;
    if (tp < nst && 32 * tp + lane < len)
      cp_async<1>(&pos[tp % (2 * S)][lane], ord + 32 * tp + lane);
    cp_async_commit();
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncwarp();
  if (add_ok) *out = acc;
}

__device__ __forceinline__ void add_in_order(float& acc, float v) {
  acc = __fadd_rn(acc, v);
}
__device__ __forceinline__ void add_in_order(float4& acc, float4 v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}

// TW: a long task's tile (and a short one's, times VEC); VEC = 4 reads
// and copies 16 bytes a lane where dst, its row stride, src and the width
// allow it.
template <int TW, int VEC>
__global__ void __launch_bounds__(kAddThreads)
segment_add_kernel(AddArgs a) {
  using Vec = typename std::conditional<VEC == 4, float4, float>::type;
  constexpr int G = 32 / TW;      // runs a warp in a short task
  constexpr int CT = TW * VEC;    // columns a short task
  constexpr int S = Ring<TW>::kStages;
  __shared__ __align__(16) float ring[S][32][TW];
  __shared__ __align__(16) int pos[2 * S][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = a.counts[0], nlong = a.counts[1], long_run = a.counts[2];
  if (warp == 0) {  // the long runs first, one (run, tile) a warp 0
    const int ntl = (a.width + TW - 1) / TW;
    const long long tasks = (long long)nlong * ntl;
    for (long long t = blockIdx.x; t < tasks; t += gridDim.x) {
      const int li = (int)(t / ntl), tile = (int)(t - (long long)li * ntl);
      const int r = a.longs[li];
      const int start = a.starts[r], id = a.run_ids[r];
      check_id(id, a.rows);
      add_long_run<TW, VEC>(a, start, a.starts[r + 1] - start, id, tile,
                            ring, pos);
    }
  }
  // the short runs: G runs a warp, lane (g, c) on run g's columns c..
  // (the table is read for runs up to n, beside R, and used below R)
  const int g = lane / TW, c = (lane % TW) * VEC;
  const int nts = (a.width + CT - 1) / CT;
  const long long tasks = ((long long)a.n + G - 1) / G * nts;
  const long long stride = (long long)gridDim.x * kAddWarps;
  long long t = (long long)blockIdx.x * kAddWarps + warp;
  int start = 0, end = 0, id = 0;
  auto fetch = [&](long long tk) {
    const long long r = tk / nts * G + g;
    if (tk < tasks && r < a.n) {
      start = a.starts[r];
      end = a.starts[r + 1];
      id = a.run_ids[r];
    }
  };
  fetch(t);
  for (; t < tasks; t += stride) {
    const long long r0 = t / nts * G;
    if (r0 >= R) break;  // and so is every later task of this warp
    const int s0 = start, l0 = r0 + g < R ? end - start : 0, i0 = id;
    const int col = (int)(t - r0 / G * nts) * CT + c;
    fetch(t + stride);  // the next task's entry, in flight meanwhile
    if (l0 == 0 || l0 > long_run || col >= a.width) continue;
    check_id(i0, a.rows);
    Vec* out = reinterpret_cast<Vec*>(a.dst + (long long)i0 * a.ld + col);
    Vec acc = *out;
    const int* ord = a.order + s0;
    const float* src = a.src + col;
    for (int q = 0; q < l0; q += 8) {
      int p[8];
      Vec v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) p[u] = q + u < l0 ? ord[q + u] : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q + u < l0)
          v[u] = *reinterpret_cast<const Vec*>(src +
                                              (long long)p[u] * a.width);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q + u < l0) add_in_order(acc, v[u]);  // in index order
    }
    *out = acc;
  }
}

int device_index() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

// blocks of `kernel` the card holds at once (cached per device), <= 0 on
// an error
template <typename K>
int capacity(K kernel, int threads, size_t smem, int* cache) {
  const int dev = device_index();
  if (dev < 0) return -1;
  if (cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  return cache[dev];
}

template <int TW, int VEC>
int launch_add(const AddArgs& a, cudaStream_t stream) {
  static int cache[kMaxDevices] = {};
  const int cap =
      capacity(segment_add_kernel<TW, VEC>, kAddThreads, 0, cache);
  if (cap <= 0) return (int)cudaErrorInvalidDevice;
  const long long G = 32 / TW, CT = TW * VEC;
  long long blocks = (((long long)a.n + G - 1) / G * ((a.width + CT - 1) / CT)
                      + kAddWarps - 1) / kAddWarps;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  segment_add_kernel<TW, VEC>
      <<<(unsigned)blocks, kAddThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Group `count` (<= 2) id vectors stably, each into its plan, on
// `stream`: one launch, one block a vector of at most 8,192 ids.
// Returns the CUDA error.
extern "C" int segment_group_launch(const GroupJob* jobs, int count,
                                    int long_run, void* stream) {
  static bool raised[kMaxDevices] = {};
  if (count < 1 || count > kGroupJobs) return (int)cudaErrorInvalidValue;
  GroupJobs js{};
  long long n = 0;
  for (int k = 0; k < count; ++k) {
    js.job[k] = jobs[k];
    if (jobs[k].n < 0 || jobs[k].n > kGroupMax)
      return (int)cudaErrorInvalidValue;
    n = jobs[k].n > n ? jobs[k].n : n;
  }
  const int dev = device_index();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  // about four ids a thread, at most kIpt
  int threads = (int)((n + 127) / 128) * 32;
  threads = threads < 32 ? 32 : threads > kGroupThreads ? kGroupThreads
                                                         : threads;
  const auto bytes = [](long long n_, int nt) {
    const long long np = n_ + n_ / 32 + 1;
    return (size_t)(4 * n_ + 8 * np + 4 * (32LL * nt + nt));
  };
  if (!raised[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes(kGroupMax, kGroupThreads));
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  segment_group_kernel<<<count, threads, bytes(n, threads),
                         (cudaStream_t)stream>>>(js, long_run);
  return (int)cudaGetLastError();
}

// The run table of `n` ids sorted stably (`sorted` int32, `order` int64:
// torch.sort's values and indices) into `plan`; `scratch`: 2 * 1024
// uint32.  One cooperative launch on `stream`.  Returns the CUDA error.
extern "C" int segment_runs_launch(const int* sorted, const long long* order,
                                   long long n, int long_run, int* plan,
                                   unsigned* scratch, void* stream) {
  static int cache[kMaxDevices] = {};
  if (n < 1 || n > INT_MAX / 4) return (int)cudaErrorInvalidValue;
  const int cap = capacity(segment_runs_kernel, kRunThreads, 0, cache);
  if (cap <= 0) return (int)cudaErrorInvalidDevice;
  long long blocks = (n + 4095) / 4096;
  if (blocks > cap) blocks = cap;
  if (blocks > kRunMaxBlocks) blocks = kRunMaxBlocks;
  int nn = (int)n;
  void* params[] = {(void*)&sorted, (void*)&order,   (void*)&nn,
                    (void*)&long_run, (void*)&plan, (void*)&scratch};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)segment_runs_kernel, dim3((unsigned)blocks), dim3(kRunThreads),
      params, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next call starts clean
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// dst[idx[i]] += src[i] in index order, by `plan` (segment_group_launch's
// or segment_runs_launch's for the same n ids), on `stream`.  dst: `rows`
// rows of `width` float32 at a row stride of `ld` elements (a column slice
// of a wider plane has ld > width); src: float32 [n, width], contiguous.
// Returns the CUDA error.
extern "C" int segment_add_launch(float* dst, long long ld, long long rows,
                                  const float* src, long long n, int width,
                                  const int* plan, void* stream) {
  if (n == 0 || width == 0) return 0;
  if (n < 0 || width < 0 || n > INT_MAX / 4) return (int)cudaErrorInvalidValue;
  PlanView pv(const_cast<int*>(plan), n);
  const int tw = width > 16 ? 32 : width > 8 ? 16 : width > 4 ? 8
                 : width > 2 ? 4 : width;
  const AddArgs a{dst,      ld,         rows,      src,      width, (int)n,
                  pv.order, pv.run_ids, pv.starts, pv.longs, pv.counts};
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec4 = width % 4 == 0 && ld % 4 == 0 &&
                    (size_t)dst % 16 == 0 && (size_t)src % 16 == 0;
  switch (tw) {
    case 32: return vec4 ? launch_add<32, 4>(a, st) : launch_add<32, 1>(a, st);
    case 16: return launch_add<16, 1>(a, st);
    case 8: return launch_add<8, 1>(a, st);
    case 4: return launch_add<4, 1>(a, st);
    case 2: return launch_add<2, 1>(a, st);
    default: return launch_add<1, 1>(a, st);
  }
}
