// Fused multi-table embedding gradient scatter for sm_90a: the backward of
// the fused lookup (fused_lookup.cu).
//
// Replaces repro/kernels/embedding_grad.py::fused_scatter_kernel_call
// (Pallas body _fused_scatter_kernel), the SparseCore Flush-unit model.
// Same function as repro_torch/kernels/ref.py::fused_scatter_ref:
//
//   gout     (B, K, Dm) f32 slot gradients (already scaled for mean slots)
//   rows     (B, S) int32 group-local row ids, -1 = no value
//   slots    (K, 4) int32: per slot its group g, its descriptor-column
//            span [a, b) of rows, and a mean flag (unused here)
//   col_slot (S,) int32: the slot whose span holds each descriptor
//            column, -1 for none (fixed per layout; the caller caches it)
//   -> grad  G row spaces, group g is (rows_g, dim_g) f32, zero on entry:
//            every valid descriptor (b, s) adds gout[b, k(s), :dim_g] into
//            row rows[b, s] of group g(k(s)).
//
// The Pallas kernel is exact only because its grid runs in order, one
// descriptor at a time.  Here rows repeat heavily (Zipf ids: the hottest
// row of a dlrm0 batch of 4096 is named 13,605 times), so plain atomicAdd
// would give sums that change in the last bits from run to run and
// contend on the hot rows.  The design is deterministic instead:
//
//   1. fused_scatter_keys_kernel: one thread per descriptor writes its
//      key, or NONE (the type's max, which sorts last) for an invalid one
//      (id < 0, id >= rows_g, a column no slot spans).  The key is
//      first_g + row, where first_g is the sum of the rows of the row
//      spaces before g: int32 whenever all row spaces hold fewer than
//      2^31 - 1 rows together (every dlrm0 cut: the published tables hold
//      291M rows), otherwise int64.  The wrapper picks the width from the
//      shapes; both widths run the same kernels and decode a key the same
//      way (a search over the first_g);
//   2. the wrapper orders the keys with a stable sort (torch.sort), so the
//      descriptors of one row form a run in the reference's (b, s) order;
//   3. fused_scatter_runs_kernel: each warp takes 32 sorted positions; the
//      runs that end there are summed by lane groups with up to 16 float4
//      loads a lane in flight before any add (scatter_runs.cuh); a run
//      that goes on past the chunk is walked in order by the warp that
//      owns its head, unless it is HOT (at least HOT_MIN = 512
//      descriptors: keys[p + HOT_MIN - 1] is still its key; the wrapper's
//      HOT_RUN is the same number), when the warp finds its
//      end (a 32-way search of the sorted keys) and appends (start, end)
//      to a hot list;
//   4. fused_scatter_hot_kernel (a second launch on the same stream): a
//      fixed grid takes (hot run, 32-lane slice) items; a block walks ALL
//      the run's descriptors for its 32 lanes, in run order, through a
//      ring of 5 stages of 64 rows in shared memory filled by cp.async
//      (256 rows in flight; the descriptor ids 4 stages further ahead),
//      one warp adding.  A d256 run spans 8 blocks.
//
// Split lanes, never runs: the bits depend on it.  Every output lane is
// one f32 sum in run order, so splitting a run's lanes over threads,
// warps or blocks keeps every bit, and the order of the hot list does not
// matter; splitting its descriptors would not.  The result equals a
// sequential sum in (b, s) order and is the same on every run.
//
// Bound on the H100: the zeroed gradient (written by the wrapper, as
// large as the tables) is most of the bytes; the kernels read each valid
// descriptor's dim_g lanes of gout (15.6 GB at B = 4096, much of it from
// L2: the descriptors of one table are adjacent in key order and read only
// that table's slot of gout) and write each touched row once.  Hot rows
// no longer serialise on one warp.  Every row offset is 64-bit: a dlrm0
// row space holds ~1e9 elements.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "scatter_runs.cuh"

namespace {

using namespace async_copy;
using namespace scatter_runs;

constexpr int MAXG = 128;       // row spaces one launch can address
constexpr int WARPS = 8;        // warps per block of the run kernel
constexpr int NT = WARPS * 32;
// the hot-run kernel: a block sums 32 lanes of one run
constexpr int HOT_NT = 256;
constexpr int SLICE = 32;       // f32 lanes a block sums
constexpr int RS = 64;          // rows a stage
constexpr int NST = 5;          // stages in the ring
// descriptors from which a run is hot (fused_scatter.py's HOT_RUN)
constexpr long long HOT_MIN = 512;

template <typename Key> struct KeyOf;
template <> struct KeyOf<int> {
  static constexpr int NONE = 0x7fffffff;
};
template <> struct KeyOf<long long> {
  static constexpr long long NONE = 0x7fffffffffffffffLL;
};

struct GroupOut {
  float4* base[MAXG];
  int dim[MAXG];
  long long first[MAXG];        // the key of row 0 of group g
  int n;
};

struct GroupRows {
  int rows[MAXG];
  long long first[MAXG];
  int n;
};

// The hot list: one item per 32-lane slice of a hot run: its positions
// [start, end) in key order and its first lane.
struct HotItem {
  long long start, end, lane0;
};

struct HotList {
  unsigned long long* count;   // items, zero on entry
  HotItem* items;
};

template <typename Key>
__device__ __forceinline__ void split_key(const GroupOut& go, Key key,
                                          int& g, int& row) {
  int lo = 0, hi = go.n - 1;      // the last group whose first <= key
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (go.first[mid] <= key) lo = mid; else hi = mid - 1;
  }
  g = lo;
  row = (int)(key - go.first[lo]);
}

template <typename Key>
__global__ void __launch_bounds__(NT) fused_scatter_keys_kernel(
    const __grid_constant__ GroupRows groups, const int* __restrict__ rows,
    const int4* __restrict__ slots, const int* __restrict__ col_slot,
    Key* __restrict__ keys, long long N, int S, int K) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= N) return;
  const int k = col_slot[i % S];
  const int r = rows[i];
  Key key = KeyOf<Key>::NONE;
  if (k >= 0 && k < K && r >= 0) {
    const int g = slots[k].x;
    if (g >= 0 && g < groups.n && r < groups.rows[g])
      key = (Key)(groups.first[g] + r);
  }
  keys[i] = key;
}

// float4 offset in gout of the slot gradient that descriptor d reads
// (32-bit division where d fits, as every dlrm0 batch's does)
__device__ __forceinline__ long long gout_offset(long long d, int S, int K,
                                                 const int* col_slot,
                                                 int cpr) {
  long long b;
  int s;
  if (d <= 0xffffffffLL) {
    const unsigned u = (unsigned)d, q = u / (unsigned)S;
    b = q;
    s = (int)(u - q * (unsigned)S);
  } else {
    b = d / S;
    s = (int)(d - b * S);
  }
  return (b * K + __ldg(col_slot + s)) * (long long)cpr;
}

// First position past lo whose key is not `key`, or N (keys sorted,
// keys[lo] == key): each round the 32 lanes probe the open range.
template <typename Key>
__device__ long long run_end(const Key* __restrict__ keys, long long lo,
                             long long N, Key key, int lane) {
  long long a = lo + 1, b = N;      // keys[a - 1] == key; b == N or past it
  while (a < b) {
    const long long pr = a + (b - a) * (lane + 1) / 33;
    const int in = __popc(__ballot_sync(FULL, keys[pr] == key));
    const long long pa = __shfl_sync(FULL, pr, (in + 31) & 31);
    const long long pb = __shfl_sync(FULL, pr, in & 31);
    if (in) a = pa + 1;
    if (in < 32) b = pb;
  }
  return a;
}

// 2 blocks an SM (128 registers) with int32 keys; int64 keys take one
// block an SM, so that their wider keys do not spill.
template <typename Key, int CPL>  // float4 chunks per lane: dim_g <= 128 * CPL
__global__ void __launch_bounds__(NT, sizeof(Key) == 4 ? 2 : 1)
    fused_scatter_runs_kernel(
    const __grid_constant__ GroupOut groups, const Key* __restrict__ keys,
    const long long* __restrict__ order, long long N,
    const float4* __restrict__ gout, const int* __restrict__ col_slot, int S,
    int K, int Dm, HotList hot) {
  constexpr Key NONE = KeyOf<Key>::NONE;
  const int lane = threadIdx.x % 32;
  const long long nchunks = (N + 31) / 32;
  const long long stride = (long long)gridDim.x * WARPS;
  const int cpr = Dm / 4;                   // float4 chunks of a gout row
  // a chunk's keys (lane 0 also the key before it, lane 31 the key after
  // it) and descriptors, loaded one chunk ahead
  Key nk = NONE, nkp = NONE, nkn = NONE;
  long long nd = 0;
  auto fetch = [&](long long c) {
    const long long i = c * 32 + lane;
    nk = i < N ? keys[i] : NONE;
    nkp = lane == 0 && i > 0 && i < N ? keys[i - 1] : NONE;
    nkn = lane == 31 && i + 1 < N ? keys[i + 1] : NONE;
    nd = nk != NONE ? order[i] : 0;
  };
  long long c = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (c < nchunks) fetch(c);
  for (; c < nchunks; c += stride) {
    const Key k = nk;
    const long long d = nd;
    Key kp = __shfl_up_sync(FULL, k, 1);
    if (lane == 0) kp = nkp;
    Key kn = __shfl_down_sync(FULL, k, 1);
    if (lane == 31) kn = nkn;
    if (c + stride < nchunks) fetch(c + stride);
    const bool valid = k != NONE;
    const Chunk ck = chunk_runs(valid, valid && kp != k, valid && kn == k);
    if (!ck.heads) continue;                // the same for the whole warp
    // is the tail run hot?  loaded now, read after the short runs
    const long long P = c * 32 + ck.tail;
    Key probe = NONE;
    if (ck.tail >= 0 && P + HOT_MIN - 1 < N) probe = keys[P + HOT_MIN - 1];
    int nch = 0;
    long long off = 0;
    float4* dst = nullptr;
    if ((ck.shorts >> lane) & 1) {
      int g, row;
      split_key(groups, k, g, row);
      nch = groups.dim[g] / 4;
      off = gout_offset(d, S, K, col_slot, cpr);
      dst = groups.base[g] + (size_t)row * nch;
    }
    sum_short_runs<CPL>(ck, gout, off, nch, dst, lane);
    if (ck.tail < 0) continue;
    const Key key = __shfl_sync(FULL, k, ck.tail);
    int g, row;
    split_key(groups, key, g, row);
    if (probe == key) {                     // one item a 32-lane slice
      const long long end = run_end(keys, P + HOT_MIN - 1, N, key, lane);
      const int slices = (groups.dim[g] + SLICE - 1) / SLICE;
      unsigned long long h = 0;
      if (lane == 0) h = atomicAdd(hot.count, (unsigned long long)slices);
      h = __shfl_sync(FULL, h, 0);
      if (lane < slices) hot.items[h + lane] = {P, end, lane * SLICE};
      continue;
    }
    const int tn = groups.dim[g] / 4;
    walk_run<CPL>(
        P, N, gout, tn, groups.base[g] + (size_t)row * tn, lane,
        [&](long long p) { return keys[p] == key; },
        [&](long long p) {
          return gout_offset(order[p], S, K, col_slot, cpr);
        });
  }
}

__device__ __forceinline__ void producers_sync() {   // warps 1..7 only
  asm volatile("bar.sync 1, %0;\n" ::"n"(HOT_NT - 32) : "memory");
}

// The hot runs, one item (a 32-lane slice of a run) a block at a time.
// The run streams through the ring in stages of RS rows.  Warp 0 adds;
// warps 1-7 load: in iteration j they commit one cp.async group with the
// rows of stage j + NST - 1 and the descriptor ids of stage j + 2 NST - 2,
// so both arrive NST - 1 iterations ahead of their use, while warp 0 adds
// stage j.
template <typename Key>
__global__ void __launch_bounds__(HOT_NT) fused_scatter_hot_kernel(
    const __grid_constant__ GroupOut groups, const Key* __restrict__ keys,
    const long long* __restrict__ order, const float* __restrict__ gout,
    const int* __restrict__ col_slot, int S, int K, int Dm, HotList hot) {
  __shared__ __align__(16) float ring[NST][RS][SLICE];
  __shared__ long long desc[NST][RS];     // descriptor ids of a stage
  __shared__ long long src[NST][RS];      // f32 offset of each row's slice
  const int tid = threadIdx.x;
  const int pt = tid - 32;                // producer thread, < 0 in warp 0
  const long long items = (long long)*hot.count;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const HotItem it = hot.items[w];
    int g, row;
    split_key(groups, keys[it.start], g, row);
    const int D = groups.dim[g], lane0 = (int)it.lane0;
    const long long R = it.end - it.start;
    const long long stages = (R + RS - 1) / RS;
    auto fetch = [&](long long t) {         // stage t's descriptor ids
      if (pt >= 0 && pt < RS && t * RS + pt < R)
        cp_async8(&desc[t % NST][pt], order + it.start + t * RS + pt);
    };
    auto offsets = [&](long long t) {       // from its landed ids
      if (pt >= 0 && pt < RS && t * RS + pt < R)
        src[t % NST][pt] =
            gout_offset(desc[t % NST][pt], S, K, col_slot, Dm) + lane0;
    };
    auto copies = [&](long long t) {        // RS rows x 8 float4
      for (int e = pt; e < RS * (SLICE / 4); e += HOT_NT - 32) {
        const int r = e / (SLICE / 4), c4 = (e % (SLICE / 4)) * 4;
        if (t * RS + r < R && lane0 + c4 < D)
          cp_async16(&ring[t % NST][r][c4], gout + src[t % NST][r] + c4);
      }
    };
    if (pt >= 0) {
      for (int t = 0; t < NST - 1; ++t) fetch(t);
      cp_async_commit();
      cp_async_wait<0>();
      producers_sync();
      for (int t = 0; t < NST - 1; ++t) offsets(t);
      producers_sync();
      for (int t = 0; t < NST - 1; ++t) {   // the groups of iterations < 0
        copies(t);
        fetch(t + NST - 1);
        cp_async_commit();
      }
    }
    float acc = 0.f;
    for (long long j = 0; j < stages; ++j) {
      if (pt >= 0) cp_async_wait<NST - 2>();  // rows of j, ids of j + NST - 1
      __syncthreads();                      // ... visible; slot j - 1 added
      if (pt < 0) {                         // one lane a thread, in run order
        const long long n = R - j * RS < RS ? R - j * RS : RS;
        const float* col = &ring[j % NST][0][tid];
#pragma unroll 8
        for (int r = 0; r < n; ++r) acc += col[r * SLICE];
      } else {
        offsets(j + NST - 1);
        producers_sync();
        copies(j + NST - 1);
        fetch(j + 2 * NST - 2);
        cp_async_commit();
      }
    }
    if (pt >= 0) cp_async_wait<0>();
    if (pt < 0 && lane0 + tid < D)
      reinterpret_cast<float*>(groups.base[g])[(size_t)row * D + lane0 + tid] =
          acc;
    __syncthreads();                        // the ring is free again
  }
}

int fill_groups(GroupOut& go, void* const* group_ptrs, const int* group_dims,
                const int* group_rows, int n_groups, int Dm, int& dmax) {
  dmax = 4;
  long long first = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (group_dims[g] <= 0 || group_dims[g] % 4 != 0 ||
        group_dims[g] > Dm || group_rows[g] <= 0)
      return (int)cudaErrorInvalidValue;
    go.base[g] = static_cast<float4*>(group_ptrs[g]);
    go.dim[g] = group_dims[g];
    go.first[g] = first;
    first += group_rows[g];
    dmax = group_dims[g] > dmax ? group_dims[g] : dmax;
  }
  go.n = n_groups;
  return (int)cudaSuccess;
}

}  // namespace

// Step 1: the sort keys (first_g + row) of the B * S descriptors into
// keys (B * S,), int32 or, when `wide`, int64.
extern "C" int repro_fused_scatter_keys(
    const int* group_rows, int n_groups, const void* rows, const void* slots,
    const void* col_slot, void* keys, int B, int S, int K, int wide,
    void* stream) {
  if (n_groups <= 0 || n_groups > MAXG || B < 0 || S < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  GroupRows gr = {};
  long long first = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (group_rows[g] <= 0) return (int)cudaErrorInvalidValue;
    gr.rows[g] = group_rows[g];
    gr.first[g] = first;
    first += group_rows[g];
    if (!wide && first >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  gr.n = n_groups;
  const long long N = (long long)B * S;
  if (N == 0) return (int)cudaSuccess;
  const long long blocks = (N + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  const int4* sl = static_cast<const int4*>(slots);
  const int* cs = static_cast<const int*>(col_slot);
  if (wide)
    fused_scatter_keys_kernel<long long><<<(unsigned)blocks, NT, 0, st>>>(
        gr, r, sl, cs, static_cast<long long*>(keys), N, S, K);
  else
    fused_scatter_keys_kernel<int><<<(unsigned)blocks, NT, 0, st>>>(
        gr, r, sl, cs, static_cast<int*>(keys), N, S, K);
  return (int)cudaGetLastError();
}

// Step 3: sum each run of the sorted keys into its row, except the hot
// runs (>= HOT_MIN descriptors), which go to the hot list `hot_ws`
// (int64: the item count, zero on entry, a pad, then (start, end, first
// lane) an item, one item a 32-lane slice of a hot run; room for
// (N / HOT_MIN + 1) * ceil(Dm / 32) items).  keys (int32 or, when `wide`,
// int64) and order are
// torch.sort's outputs over step 1's keys (stable); the row spaces are
// zero on entry and only touched rows are written.
extern "C" int repro_fused_scatter_f32(
    void* const* group_ptrs, const int* group_dims, const int* group_rows,
    int n_groups, const void* keys, const void* order, long long N,
    const void* gout, const void* col_slot, int S, int K, int Dm, int wide,
    void* hot_ws, void* stream) {
  if (n_groups <= 0 || n_groups > MAXG || N < 0 || S <= 0 || K <= 0 ||
      Dm <= 0 || Dm % 4 != 0 || Dm > 128 * 4)
    return (int)cudaErrorInvalidValue;
  GroupOut go = {};
  int dmax;
  const int err = fill_groups(go, group_ptrs, group_dims, group_rows,
                              n_groups, Dm, dmax);
  if (err) return err;
  if (N == 0) return (int)cudaSuccess;
  const long long nchunks = (N + 31) / 32;
  long long blocks = (nchunks + WARPS - 1) / WARPS;
  if (blocks > 132 * 128) blocks = 132 * 128;   // grid-stride past this
  const long long* od = static_cast<const long long*>(order);
  const float4* gv = static_cast<const float4*>(gout);
  const int* cs = static_cast<const int*>(col_slot);
  unsigned long long* ws = static_cast<unsigned long long*>(hot_ws);
  const HotList hot = {ws, reinterpret_cast<HotItem*>(ws + 2)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks;
#define RUNS(KEY, CPL)                                                     \
  fused_scatter_runs_kernel<KEY, CPL><<<nb, NT, 0, st>>>(                  \
      go, static_cast<const KEY*>(keys), od, N, gv, cs, S, K, Dm, hot)
  if (wide) {
    if (dmax <= 128) RUNS(long long, 1);
    else if (dmax <= 256) RUNS(long long, 2);
    else RUNS(long long, 4);
  } else {
    if (dmax <= 128) RUNS(int, 1);
    else if (dmax <= 256) RUNS(int, 2);
    else RUNS(int, 4);
  }
#undef RUNS
  return (int)cudaGetLastError();
}

// Step 4: sum the hot runs step 3 listed in `hot_ws` (same stream, after
// it).  A fixed grid (5 blocks an SM fit its 45 KB of shared memory);
// blocks with no item return at once.
extern "C" int repro_fused_scatter_hot_f32(
    void* const* group_ptrs, const int* group_dims, const int* group_rows,
    int n_groups, const void* keys, const void* order, const void* gout,
    const void* col_slot, int S, int K, int Dm, int wide, const void* hot_ws,
    void* stream) {
  if (n_groups <= 0 || n_groups > MAXG || S <= 0 || K <= 0 || Dm <= 0 ||
      Dm % 4 != 0 || Dm > 128 * 4)
    return (int)cudaErrorInvalidValue;
  GroupOut go = {};
  int dmax;
  const int err = fill_groups(go, group_ptrs, group_dims, group_rows,
                              n_groups, Dm, dmax);
  if (err) return err;
  unsigned long long* ws =
      static_cast<unsigned long long*>(const_cast<void*>(hot_ws));
  const HotList hot = {ws, reinterpret_cast<HotItem*>(ws + 2)};
  const long long* od = static_cast<const long long*>(order);
  const float* gv = static_cast<const float*>(gout);
  const int* cs = static_cast<const int*>(col_slot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = 132 * 5;
  if (wide)
    fused_scatter_hot_kernel<long long><<<blocks, HOT_NT, 0, st>>>(
        go, static_cast<const long long*>(keys), od, gv, cs, S, K, Dm, hot);
  else
    fused_scatter_hot_kernel<int><<<blocks, HOT_NT, 0, st>>>(
        go, static_cast<const int*>(keys), od, gv, cs, S, K, Dm, hot);
  return (int)cudaGetLastError();
}
