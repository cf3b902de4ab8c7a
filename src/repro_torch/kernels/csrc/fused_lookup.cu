// Fused multi-table embedding lookup (sum / mean per table) for sm_90a,
// over f32 row spaces and over int8 row spaces with per-tile scales.
//
// Replaces repro/kernels/embedding_lookup.py::fused_lookup_kernel_call
// (Pallas bodies _fused_lookup_kernel and, with scales=, the int8
// _fused_lookup_kernel_q), the SparseCore Fetch-unit model: one launch
// over every table.  Same function as repro_torch/kernels/ref.py::
// fused_lookup_ref (f32) and fused_lookup_q_ref (int8):
//
//   groups   G row spaces, group g is (rows_g, dim_g), row-major, f32 or
//            int8; an int8 group has scales (rows_g, ceil(dim_g / 128))
//            f32, one per 128-lane tile from lane 0 (the last partial)
//   rows     (B, S) int32 group-local row ids, -1 = no value
//   slots    (K, 4) int32: per output slot k (one table) the group g, the
//            descriptor-column span [a, b) of rows, and a mean flag
//   -> out   (B, K, Dm) f32; out[b, k, :dim_g] is the sum (or the mean,
//            count floored at 1) of the valid rows of columns [a, b), an
//            int8 row dequantised (q * its tile's scale, f32) before it is
//            added, and lanes >= dim_g are zero
//
// The Pallas kernel reads ONE (R, Dm) table: every width-group padded to
// Dm lanes and concatenated, on every call.  For dlrm0 that copy would be
// as large as the tables themselves (tens of GB), so this kernel reads the
// G row spaces where they lie: their base pointers, dims and row counts
// travel by value in the kernel's parameters (__grid_constant__, no copy).
//
// Bound on the H100: bytes.  Each valid id reads one row of dim_g elements
// (4 bytes each in f32, 1 in int8, plus one scale per tile) and adds it
// (one flop per element); rows that repeat within a batch (the Zipf ids)
// can come from L2.  The bag combine is `bag_rows.cuh`, shared with the
// single-table lookup: blocks in table-major order (block x is slot
// x / tiles, tile x % tiles of its samples), lane groups sized by the
// slot's dim, the valid ids compacted and 16 row loads of 16 bytes a lane
// in flight.  f32 rows take `F32Row`; int8 rows `Q8Row` (16 elements a
// 16-byte load, one scale) where the dim is a multiple of 16 and the row
// space is 16-byte aligned, else `Q8NRow` (4 elements a load).  Every
// offset is 64-bit: a dlrm0 row space holds more than 2^31 elements.
// A span outside [0, S) is clamped to it; a slot whose group is out of
// range writes zeros.
// Not yet done (a later PR): the (B, sum of dims) output the dense tower
// reads (lanes past a slot's dim are written as zeros, 629 MB against
// 314.6 MB of real lanes for dlrm0 at B = 4096), TMA staging, and a
// row's chunks split over warps where a grid is small and rows are wide.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bag_rows.cuh"

namespace {

constexpr int MAXG = 128;       // row spaces one launch can address

struct GroupTable {
  const void* base[MAXG];
  const float* scale[MAXG];     // int8 groups: (rows, ceil(dim / 128)) f32
  int dim[MAXG];
  int rows[MAXG];
  int n;
};

// INT8: the row spaces are int8 with scales, else f32.
template <bool INT8>
__global__ void __launch_bounds__(bag_rows::MAX_WARPS * 32, 2)
    fused_lookup_kernel(const __grid_constant__ GroupTable groups,
                        const int* __restrict__ rows,
                        const int4* __restrict__ slots,
                        float* __restrict__ out, int B, int S, int K, int Dm,
                        long long tiles, int spread) {
  extern __shared__ int sid[];
  const int k = (int)(blockIdx.x / tiles);
  const long long tile = blockIdx.x % tiles;
  const int4 sl = slots[k];                 // group, col a, col b, mean
  const bool ok = sl.x >= 0 && sl.x < groups.n;
  const int g = ok ? sl.x : 0;
  bag_rows::Bags s;
  s.base = groups.base[g];
  s.scale = groups.scale[g];
  s.dim = ok ? groups.dim[g] : 0;
  s.last = groups.rows[g] - 1;
  s.ids = rows;
  s.S = S;
  s.a = max(sl.y, 0);
  s.e = ok ? min(sl.z, S) : 0;
  s.mean = sl.w;
  s.out = out + (size_t)k * Dm;
  s.out_stride = (long long)K * Dm;
  s.Dm = Dm;
  s.B = B;
  if (!INT8)
    bag_rows::run<bag_rows::F32Row>(s, tile, spread, sid);
  else if (s.dim % 16 == 0 && reinterpret_cast<uintptr_t>(s.base) % 16 == 0)
    bag_rows::run<bag_rows::Q8Row>(s, tile, spread, sid);
  else
    bag_rows::run<bag_rows::Q8NRow>(s, tile, spread, sid);
}

template <bool INT8>
int launch(const void* const* group_ptrs, const void* const* scale_ptrs,
           const int* group_dims, const int* group_rows, int n_groups,
           const void* rows, const void* slots, void* out, int B, int S,
           int K, int Dm, void* stream) {
  if (n_groups <= 0 || n_groups > MAXG || B < 0 || S < 0 || K < 0 ||
      Dm <= 0 || Dm % 4 != 0 || Dm > 128 * 4)
    return (int)cudaErrorInvalidValue;
  GroupTable gt = {};
  for (int g = 0; g < n_groups; ++g) {
    if (group_dims[g] <= 0 || group_dims[g] % 4 != 0 ||
        group_dims[g] > Dm || group_rows[g] <= 0)
      return (int)cudaErrorInvalidValue;
    gt.base[g] = group_ptrs[g];
    gt.scale[g] =
        scale_ptrs ? static_cast<const float*>(scale_ptrs[g]) : nullptr;
    if (INT8 && gt.scale[g] == nullptr) return (int)cudaErrorInvalidValue;
    gt.dim[g] = group_dims[g];
    gt.rows[g] = group_rows[g];
  }
  gt.n = n_groups;
  if (B == 0 || K == 0) return (int)cudaSuccess;
  // the widest lane groups any slot can take set the blocks a slot
  const bool spread = bag_rows::spread_for(B, K);
  int lanes = 4;
  for (int g = 0; g < n_groups; ++g) {
    const bool q16 = group_dims[g] % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(gt.base[g]) % 16 == 0;
    const int L = INT8 && q16 ? bag_rows::lanes_for(gt.dim[g], 16, true)
                              : bag_rows::lanes_for(gt.dim[g], 4, spread);
    if (L > lanes) lanes = L;
  }
  const bag_rows::Shape sh = bag_rows::shape(B, K, spread, lanes);
  const long long blocks = sh.tiles * K;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_lookup_kernel<INT8>
      <<<(unsigned)blocks, sh.warps * 32, sh.smem(),
         static_cast<cudaStream_t>(stream)>>>(
          gt, static_cast<const int*>(rows), static_cast<const int4*>(slots),
          static_cast<float*>(out), B, S, K, Dm, sh.tiles, sh.spread);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_fused_lookup_f32(
    const void* const* group_ptrs, const int* group_dims,
    const int* group_rows, int n_groups, const void* rows, const void* slots,
    void* out, int B, int S, int K, int Dm, void* stream) {
  return launch<false>(group_ptrs, nullptr, group_dims, group_rows, n_groups,
                       rows, slots, out, B, S, K, Dm, stream);
}

// int8 row spaces: scale_ptrs[g] is group g's (rows, ceil(dim / 128)) f32
// scales.
extern "C" int repro_fused_lookup_q8(
    const void* const* group_ptrs, const void* const* scale_ptrs,
    const int* group_dims, const int* group_rows, int n_groups,
    const void* rows, const void* slots, void* out, int B, int S, int K,
    int Dm, void* stream) {
  return launch<true>(group_ptrs, scale_ptrs, group_dims, group_rows,
                      n_groups, rows, slots, out, B, S, K, Dm, stream);
}
