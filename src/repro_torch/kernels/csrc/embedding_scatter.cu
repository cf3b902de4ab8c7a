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
// them; the kernel reads each valid gradient row once and writes each
// named row once.  Design (the run walk of fused_scatter.cu, with the ids
// as the keys, already in order):
//   * each warp takes 32 positions, finds the runs that start there (a
//     ballot of id changes), and for each run loads its positions' ids 32
//     at a time; the run is the prefix of equal ids;
//   * lane l owns float4 chunks l, l + 32, ... of the row; the rows of
//     UNROLL positions are in flight before they are added, one f32 add
//     at a time in index order: the same bits as index_add_ in index
//     order, and for unique ids exactly 0 + g, as the reference;
//   * offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;        // warps per block
constexpr int NT = WARPS * 32;
constexpr int UNROLL = 4;       // rows whose loads are in flight per warp

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

template <int CPL>              // float4 chunks per lane: D <= 128 * CPL
__global__ void __launch_bounds__(NT) scatter_runs_kernel(
    const float4* __restrict__ grads, const int* __restrict__ ids,
    float4* __restrict__ out, long long N, int V, int nch) {
  const int lane = threadIdx.x % 32;
  const long long nchunks = (N + 31) / 32;
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long c = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
       c < nchunks; c += stride) {
    const long long i = c * 32 + lane;
    const int id = i < N ? __ldg(ids + i) : -1;
    const int prev = (i > 0 && i < N) ? __ldg(ids + i - 1) : -1;
    unsigned heads = __ballot_sync(
        0xffffffffu, id >= 0 && id < V && (i == 0 || prev != id));
    while (heads) {                         // the same for the whole warp
      const int h = __ffs(heads) - 1;
      heads &= heads - 1;
      const int key = __shfl_sync(0xffffffffu, id, h);
      float4 acc[CPL];
#pragma unroll
      for (int q = 0; q < CPL; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (long long p = c * 32 + h;;) {
        // the run is the prefix of equal ids among the next 32 positions
        const long long pj = p + lane;
        const bool same = pj < N && __ldg(ids + pj) == key;
        const unsigned other = ~__ballot_sync(0xffffffffu, same);
        const int n = other ? __ffs(other) - 1 : 32;
        for (int j = 0; j < n; j += UNROLL) {
          float4 v[UNROLL][CPL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const size_t row = (size_t)(p + j + u) * nch;
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              const int ch = lane + 32 * q;
              v[u][q] = (j + u < n && ch < nch)
                            ? __ldg(grads + row + ch)
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
      float4* o = out + (size_t)key * nch;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int ch = lane + 32 * q;
        if (ch < nch) o[ch] = acc[q];
      }
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
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride past this
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
