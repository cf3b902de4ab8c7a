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
// row of a dlrm0 batch of 4096 is named ~10^4 times), so plain atomicAdd
// would give sums that change in the last bits from run to run and
// contend on the hot rows.  The design is deterministic instead:
//
//   1. fused_scatter_keys_kernel: one thread per descriptor writes the key
//      (g << 32) | row, or KEY_NONE for an invalid one (id < 0, id >=
//      rows_g, a column no slot spans);
//   2. the wrapper orders the keys with a stable sort (torch.sort), so the
//      descriptors of one row form a run in the reference's (b, s) order;
//   3. fused_scatter_runs_kernel: each warp takes 32 sorted positions,
//      finds the runs that start there (a ballot of key changes), and for
//      each run sums its descriptors' gradient rows in f32 registers, in
//      run order, then writes the row once.  Lane l owns float4 chunks l,
//      l + 32, ... of the row; the run's keys and descriptor ids load 32
//      at a time and are broadcast by shuffles; UNROLL rows' loads are in
//      flight before they are added.
//
// The result equals a sequential sum in (b, s) order and is the same on
// every run.  Bound on the H100: bytes (the zeroed gradient, written by
// the wrapper, is as large as the tables; the kernel writes only touched
// rows and reads each valid descriptor's dim_g lanes of gout once).
// Every row offset is 64-bit: a dlrm0 row space holds ~1e9 elements.
// Not yet done (a later PR): splitting a hot row's long run over several
// warps (one warp walks it serially), and narrower sort keys.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXG = 128;       // row spaces one launch can address
constexpr int WARPS = 8;        // warps per block
constexpr int NT = WARPS * 32;
constexpr int UNROLL = 4;       // rows whose loads are in flight per warp
constexpr long long KEY_NONE = 0x7fffffffffffffffLL;   // sorts last

struct GroupOut {
  float4* base[MAXG];
  int dim[MAXG];
  int rows[MAXG];
  int n;
};

struct GroupRows {
  int rows[MAXG];
  int n;
};

__global__ void __launch_bounds__(NT) fused_scatter_keys_kernel(
    const __grid_constant__ GroupRows groups, const int* __restrict__ rows,
    const int4* __restrict__ slots, const int* __restrict__ col_slot,
    long long* __restrict__ keys, long long N, int S, int K) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= N) return;
  const int k = col_slot[i % S];
  const int r = rows[i];
  long long key = KEY_NONE;
  if (k >= 0 && k < K && r >= 0) {
    const int g = slots[k].x;
    if (g >= 0 && g < groups.n && r < groups.rows[g])
      key = ((long long)g << 32) | (long long)r;
  }
  keys[i] = key;
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

template <int CPL>              // float4 chunks per lane: dim_g <= 128 * CPL
__global__ void __launch_bounds__(NT) fused_scatter_runs_kernel(
    const __grid_constant__ GroupOut groups,
    const long long* __restrict__ keys, const long long* __restrict__ order,
    long long N, const float4* __restrict__ gout,
    const int* __restrict__ col_slot, int S, int K, int Dm) {
  const int lane = threadIdx.x % 32;
  const long long nchunks = (N + 31) / 32;
  const long long stride = (long long)gridDim.x * WARPS;
  const int cpr = Dm / 4;                   // float4 chunks of a gout row
  for (long long c = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
       c < nchunks; c += stride) {
    const long long i = c * 32 + lane;
    const long long ki = i < N ? keys[i] : KEY_NONE;
    const long long kp = (i > 0 && i < N) ? keys[i - 1] : KEY_NONE;
    unsigned heads =
        __ballot_sync(0xffffffffu, ki != KEY_NONE && (i == 0 || kp != ki));
    while (heads) {                         // the same for the whole warp
      const int h = __ffs(heads) - 1;
      heads &= heads - 1;
      const long long key = __shfl_sync(0xffffffffu, ki, h);
      const int g = (int)(key >> 32);
      const int row = (int)(key & 0xffffffffLL);
      const int nch = groups.dim[g] / 4;
      float4 acc[CPL];
#pragma unroll
      for (int q = 0; q < CPL; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (long long p = c * 32 + h;;) {
        // the next 32 positions: the run's own form a prefix (keys sorted)
        const long long pj = p + lane;
        const bool same = pj < N && keys[pj] == key;
        const int n = __popc(__ballot_sync(0xffffffffu, same));
        long long off = 0;                  // float4 offset of gout[b, k]
        if (same) {
          const long long d = order[pj];
          const long long b = d / S;
          const int k = col_slot[d % S];
          off = (b * K + k) * (long long)cpr;
        }
        for (int j = 0; j < n; j += UNROLL) {
          float4 v[UNROLL][CPL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const long long o = __shfl_sync(0xffffffffu, off, (j + u) & 31);
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              const int ch = lane + 32 * q;
              v[u][q] = (j + u < n && ch < nch)
                            ? __ldg(gout + o + ch)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (j + u >= n) break;          // the same for the whole warp
#pragma unroll
            for (int q = 0; q < CPL; ++q) add4(acc[q], v[u][q]);
          }
        }
        p += n;
        if (n < 32) break;
      }
      float4* out = groups.base[g] + (size_t)row * nch;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int ch = lane + 32 * q;
        if (ch < nch) out[ch] = acc[q];
      }
    }
  }
}

}  // namespace

// Step 1: the sort keys of the B * S descriptors into keys (B * S,) int64.
extern "C" int repro_fused_scatter_keys(
    const int* group_rows, int n_groups, const void* rows, const void* slots,
    const void* col_slot, void* keys, int B, int S, int K, void* stream) {
  if (n_groups <= 0 || n_groups > MAXG || B < 0 || S < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  GroupRows gr = {};
  for (int g = 0; g < n_groups; ++g) {
    if (group_rows[g] <= 0) return (int)cudaErrorInvalidValue;
    gr.rows[g] = group_rows[g];
  }
  gr.n = n_groups;
  const long long N = (long long)B * S;
  if (N == 0) return (int)cudaSuccess;
  const long long blocks = (N + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_scatter_keys_kernel<<<(unsigned)blocks, NT, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      gr, static_cast<const int*>(rows), static_cast<const int4*>(slots),
      static_cast<const int*>(col_slot), static_cast<long long*>(keys), N, S,
      K);
  return (int)cudaGetLastError();
}

// Step 3: sum each run of the sorted keys into its row.  keys and order
// are torch.sort's outputs over step 1's keys (stable); the row spaces are
// zero on entry and only touched rows are written.
extern "C" int repro_fused_scatter_f32(
    void* const* group_ptrs, const int* group_dims, const int* group_rows,
    int n_groups, const void* keys, const void* order, long long N,
    const void* gout, const void* col_slot, int S, int K, int Dm,
    void* stream) {
  if (n_groups <= 0 || n_groups > MAXG || N < 0 || S <= 0 || K <= 0 ||
      Dm <= 0 || Dm % 4 != 0 || Dm > 128 * 4)
    return (int)cudaErrorInvalidValue;
  GroupOut go = {};
  int dmax = 4;
  for (int g = 0; g < n_groups; ++g) {
    if (group_dims[g] <= 0 || group_dims[g] % 4 != 0 ||
        group_dims[g] > Dm || group_rows[g] <= 0)
      return (int)cudaErrorInvalidValue;
    go.base[g] = static_cast<float4*>(group_ptrs[g]);
    go.dim[g] = group_dims[g];
    go.rows[g] = group_rows[g];
    dmax = group_dims[g] > dmax ? group_dims[g] : dmax;
  }
  go.n = n_groups;
  if (N == 0) return (int)cudaSuccess;
  const long long nchunks = (N + 31) / 32;
  long long blocks = (nchunks + WARPS - 1) / WARPS;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride past this
  const long long* ky = static_cast<const long long*>(keys);
  const long long* od = static_cast<const long long*>(order);
  const float4* gv = static_cast<const float4*>(gout);
  const int* cs = static_cast<const int*>(col_slot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dmax <= 128)
    fused_scatter_runs_kernel<1><<<(unsigned)blocks, NT, 0, st>>>(
        go, ky, od, N, gv, cs, S, K, Dm);
  else if (dmax <= 256)
    fused_scatter_runs_kernel<2><<<(unsigned)blocks, NT, 0, st>>>(
        go, ky, od, N, gv, cs, S, K, Dm);
  else
    fused_scatter_runs_kernel<4><<<(unsigned)blocks, NT, 0, st>>>(
        go, ky, od, N, gv, cs, S, K, Dm);
  return (int)cudaGetLastError();
}
