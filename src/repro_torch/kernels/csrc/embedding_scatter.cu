// Embedding gradient scatter over deduplicated ids for sm_90a (the
// SparseCore Flush unit, paper §3.5).
//
// Replaces repro/kernels/embedding_grad.py::scatter_kernel_call (Pallas
// body _scatter_kernel), which writes each unique id's gradient row into a
// zeroed table-shaped buffer; repro.kernels.ops.embedding_scatter reaches
// it with the output of repro/embeddings/dedup.py::dedup_ids.  Same
// function as repro_torch/kernels/ref.py::embedding_scatter_ref:
//
//   grads (N, D) f32, row-major
//   ids   (N,) int32: equal ids must be ADJACENT (dedup_ids' unique ids
//         with a -1 tail, or any sorted stream); -1 anywhere adds nothing;
//         an id >= V is dropped
//   out   (V, D) f32, zero on entry (the wrapper fills it): every run of
//         equal adjacent ids writes the sum of its gradient rows, in index
//         order, into its row, once.
// Non-adjacent duplicates are not supported: each run writes its row, so
// the last run to be written wins.
//
// Bound on the H100: bytes.  The zero fill of the (V, D) table is most of
// them (the wrapper's torch.zeros, at ~92% of its bytes); the kernel reads
// each valid gradient row once and writes each named row once, and is
// bound by how many of those reads are in flight: dedup_ids' runs are one
// row long, so a design that walks one run at a time has one row in
// flight a warp.  Design (scatter_runs.cuh):
//   * each warp takes 32 positions and reads each id once (one chunk
//     ahead), with its neighbours by shuffles; one ballot gives every run
//     of the chunk;
//   * the runs that end in the chunk are summed by lane groups of
//     nextpow2(D / 4) lanes (at least 4, at most 32: D = 32 -> 4 runs at
//     once, D = 64 -> 2, D >= 128 -> the whole warp), every group issuing
//     up to 16 / CPL rows' loads before it adds any: 8 KB in flight a warp
//     at every D;
//   * the run that goes on past the chunk (adjacent duplicates) is walked
//     in order by the warp that owns its head, 16 / CPL rows in flight;
//   * split lanes, never runs: the bits depend on it.  Each lane's sum is
//     one f32 add at a time in index order: the same bits as index_add_
//     in index order, and for unique ids exactly 0 + g, as the reference;
//   * offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scatter_runs.cuh"

namespace {

using namespace scatter_runs;

constexpr int WARPS = 4;        // warps per block
constexpr int NT = WARPS * 32;

template <int CPL>              // float4 chunks per lane: D <= 128 * CPL
__global__ void __launch_bounds__(NT) scatter_runs_kernel(
    const float4* __restrict__ grads, const int* __restrict__ ids,
    float4* __restrict__ out, long long N, int V, int nch) {
  const int lane = threadIdx.x % 32;
  const long long nchunks = (N + 31) / 32;
  const long long stride = (long long)gridDim.x * WARPS;
  // a chunk's ids (lane 0 also the id before it, lane 31 the id after
  // it), loaded one chunk ahead
  int nid = -1, nprev = -1, nnext = -1;
  auto fetch = [&](long long c) {
    const long long i = c * 32 + lane;
    nid = i < N ? __ldg(ids + i) : -1;
    nprev = lane == 0 && i > 0 && i < N ? __ldg(ids + i - 1) : -1;
    nnext = lane == 31 && i + 1 < N ? __ldg(ids + i + 1) : -1;
  };
  long long c = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (c < nchunks) fetch(c);
  for (; c < nchunks; c += stride) {
    const long long i = c * 32 + lane;
    const int id = nid;
    int prev = __shfl_up_sync(FULL, id, 1);
    if (lane == 0) prev = nprev;
    int next = __shfl_down_sync(FULL, id, 1);
    if (lane == 31) next = nnext;
    if (c + stride < nchunks) fetch(c + stride);
    const bool valid = id >= 0 && id < V;
    const Chunk ck = chunk_runs(valid, valid && (i == 0 || prev != id),
                                valid && next == id);
    sum_short_runs<CPL>(ck, grads, i * nch, (ck.shorts >> lane) & 1 ? nch : 0,
                        out + (size_t)(valid ? id : 0) * nch, lane);
    if (ck.tail >= 0) {                     // the same for the whole warp
      const int key = __shfl_sync(FULL, id, ck.tail);
      walk_run<CPL>(
          c * 32 + ck.tail, N, grads, nch, out + (size_t)key * nch, lane,
          [&](long long p) { return __ldg(ids + p) == key; },
          [&](long long p) { return p * nch; });
    }
  }
}

}  // namespace

// out (V, D) must be zero on entry; only the named rows are written.
extern "C" int repro_embedding_scatter_f32(const void* grads, const void* ids,
                                           void* out, long long N, int V,
                                           int D, void* stream) {
  if (N < 0 || V <= 0 || D <= 0 || D % 4 != 0 || D > 128 * 4)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const long long nchunks = (N + 31) / 32;
  long long blocks = (nchunks + WARPS - 1) / WARPS;
  if (blocks > 132 * 32) blocks = 132 * 32;   // grid-stride past this
  const float4* g = static_cast<const float4*>(grads);
  const int* i = static_cast<const int*>(ids);
  float4* o = static_cast<float4*>(out);
  const int nch = D / 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 128)
    scatter_runs_kernel<1><<<(unsigned)blocks, NT, 0, st>>>(g, i, o, N, V,
                                                            nch);
  else if (D <= 256)
    scatter_runs_kernel<2><<<(unsigned)blocks, NT, 0, st>>>(g, i, o, N, V,
                                                            nch);
  else
    scatter_runs_kernel<4><<<(unsigned)blocks, NT, 0, st>>>(g, i, o, N, V,
                                                            nch);
  return (int)cudaGetLastError();
}
