// Single-table embedding lookup (gather + sum / mean over the valency) for
// sm_90a.
//
// Replaces repro/kernels/embedding_lookup.py::lookup_kernel_call (Pallas
// body _lookup_kernel), the one-table SparseCore Fetch-unit model that the
// paper's Figure 9 benchmark drives through repro.kernels.ops.
// embedding_lookup.  Same function as repro_torch/kernels/ref.py::
// embedding_lookup_ref:
//
//   table (V, D) f32, row-major (a row slice of a row space is fine)
//   ids   (B, Vl) int32, -1 = no value
//   -> out (B, D) f32: the sum of the valid rows of sample b, or for a
//          mean their sum divided by their count floored at 1
//
// An id at or past V reads row V - 1 (JAX's mode="clip").  It gathers and
// combines in one pass: (B, Vl, D) is never built.
//
// Bound on the H100: bytes.  Each valid id reads one row of D floats once
// and adds it (one flop per 4 bytes).  The fused lookup's bag combine
// (`bag_rows.cuh`) with one group and one slot, the bags of the B samples:
// lane groups sized by D, the valid ids compacted, f32 sums in column
// order with no atomics (the result is the same run to run).  A launch
// reads one table, so the host picks the kernel: the lane-group shape
// from D (a launch of few bags, B below 128 bags an SM as at B = 256 and
// 4096, takes the widest lane groups and blocks of fewer warps, so that
// more SMs share it), and the loads a lane keeps in flight from the
// valency and the batch (`launch_depth`: 16 where the warps fit one wave,
// 4 with twice the warps an SM where they do not, 1 row for univalent
// bags).  Row offsets are 64-bit (a dlrm0 row space holds ~1e9
// elements).
// Not yet done (a later PR): a row's chunks split over warps where rows
// are wide and the grid is small, TMA staging, and one launch for the
// tables of a batch (each call is one table).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bag_rows.cuh"

namespace {

// One kernel a lane-group shape (L lanes a bag, C chunks a lane) and depth
// (F loads a lane in flight), all chosen on the host: a launch reads one
// table, so its registers, and with them how many warps an SM holds, fit
// that table's rows and valency.
template <int L, int C, int F>
__global__ void __launch_bounds__(bag_rows::MAX_WARPS * 32, F >= 16 ? 2 : 4)
    lookup_kernel(const float* __restrict__ table,
                  const int* __restrict__ ids, float* __restrict__ out,
                  int B, int Vl, int D, int last, int mean) {
  extern __shared__ int sid[];
  bag_rows::Bags s;
  s.base = table;
  s.scale = nullptr;
  s.dim = D;
  s.last = last;
  s.ids = ids;
  s.S = Vl;
  s.a = 0;
  s.e = Vl;
  s.mean = mean;
  s.out = out;
  s.out_stride = D;
  s.Dm = D;
  s.B = B;
  bag_rows::tile_bags<bag_rows::F32Row, L, C, F>(s, blockIdx.x, sid);
}

struct Args {
  const float* table;
  const int* ids;
  float* out;
  int B, Vl, D, last, mean;
};

template <int L, int C, int F>
int launch(const Args& a, const bag_rows::Shape& sh, cudaStream_t st) {
  lookup_kernel<L, C, F><<<(unsigned)sh.tiles, sh.warps * 32, sh.smem(),
                           st>>>(a.table, a.ids, a.out, a.B, a.Vl, a.D,
                                 a.last, a.mean);
  return (int)cudaGetLastError();
}

// F: one row in flight where a bag holds at most one id; 16 loads where
// the bags' warps fit one wave of 16 warps an SM (a small batch: the
// latency of a bag's rows sets the time); else as many as 64 registers
// hold (4 rows of one chunk, 4 of two, 2 of three, 1 of four), so that an
// SM holds 32 warps (a large batch: warps in flight set it).
template <int L, int C>
int launch_depth(const Args& a, const bag_rows::Shape& sh, cudaStream_t st) {
  const long long warps = ((long long)a.B * L + 31) / 32;
  if (a.Vl <= 1) return launch<L, C, C>(a, sh, st);
  if (warps <= 2LL * bag_rows::MAX_WARPS * bag_rows::SMS)
    return launch<L, C, 16>(a, sh, st);
  return launch<L, C, C == 2 ? 8 : C == 3 ? 6 : 4>(a, sh, st);
}

}  // namespace

extern "C" int repro_embedding_lookup_f32(const void* table, const void* ids,
                                          void* out, int B, int Vl, int V,
                                          int D, int mean, void* stream) {
  if (B < 0 || Vl < 0 || V <= 0 || D <= 0 || D % 4 != 0 || D > 128 * 4)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Args a{static_cast<const float*>(table), static_cast<const int*>(ids),
               static_cast<float*>(out), B, Vl, D, V - 1, mean};
  const bool spread = bag_rows::spread_for(B, 1);
  int L, C;
  bag_rows::lane_groups(D / 4, spread, L, C);
  const bag_rows::Shape sh = bag_rows::shape(B, 1, spread, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (L * 8 + C) {
    case 4 * 8 + 1: return launch_depth<4, 1>(a, sh, st);
    case 4 * 8 + 3: return launch_depth<4, 3>(a, sh, st);
    case 8 * 8 + 1: return launch_depth<8, 1>(a, sh, st);
    case 8 * 8 + 3: return launch_depth<8, 3>(a, sh, st);
    case 16 * 8 + 1: return launch_depth<16, 1>(a, sh, st);
    case 16 * 8 + 3: return launch_depth<16, 3>(a, sh, st);
    case 32 * 8 + 1: return launch_depth<32, 1>(a, sh, st);
    case 32 * 8 + 2: return launch_depth<32, 2>(a, sh, st);
    case 32 * 8 + 3: return launch_depth<32, 3>(a, sh, st);
    default: return launch_depth<32, 4>(a, sh, st);
  }
}
