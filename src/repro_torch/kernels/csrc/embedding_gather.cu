// Embedding row gather for sm_90a.
//
// Replaces repro/kernels/embedding_lookup.py::gather_kernel_call (Pallas
// body _gather_kernel), which the per-table ("legacy") lookup reaches
// through repro/embeddings/engine.py::_gather_rows.  Same function as
// repro_torch/kernels/ref.py::embedding_gather_ref:
//
//   table (V, D) f32, row-major; ids (B, Vl) int32, -1 = no value
//   -> out (B, Vl, D) f32: out[b, j] = table[ids[b, j]], zeros for an id < 0
//
// An id >= V reads row V - 1 (JAX's mode="clip").
//
// Bound on the H100: bytes (no arithmetic at all): the valid rows are read
// once and every output row is written once.  The Pallas grid copies one
// row per step; here one thread moves one 16-byte chunk of one output row,
// so consecutive threads read consecutive chunks of a table row and write
// consecutive chunks of the output, and every block has many independent
// loads in flight.  Offsets are 64-bit (a dlrm0 row space holds more than
// 2^31 elements).  Not yet done (a later PR): TMA row copies.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr long long MAX_BLOCKS = 132 * 64;   // grid-stride beyond this

__global__ void __launch_bounds__(NT) gather_kernel(
    const float4* __restrict__ table, const int* __restrict__ ids,
    float4* __restrict__ out, long long n_chunks, int nch, int last) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long t = (long long)blockIdx.x * NT + threadIdx.x; t < n_chunks;
       t += stride) {
    const long long row = t / nch;
    const int ch = (int)(t - row * nch);
    const int id = __ldg(ids + row);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (id >= 0) v = __ldg(table + (size_t)min(id, last) * nch + ch);
    out[t] = v;
  }
}

}  // namespace

extern "C" int repro_embedding_gather_f32(const void* table, const void* ids,
                                          void* out, long long n_ids, int V,
                                          int D, void* stream) {
  if (n_ids < 0 || V <= 0 || D <= 0 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_ids == 0) return (int)cudaSuccess;
  const int nch = D / 4;
  const long long n_chunks = n_ids * nch;
  long long blocks = (n_chunks + NT - 1) / NT;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  gather_kernel<<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(ids),
      static_cast<float4*>(out), n_chunks, nch, V - 1);
  return (int)cudaGetLastError();
}
