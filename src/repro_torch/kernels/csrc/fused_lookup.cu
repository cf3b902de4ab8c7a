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
// once (4 bytes each in f32, 1 in int8, plus one scale per tile) and adds
// it (one flop per element), so the kernel's job is to keep enough row
// loads in flight.  Design (one body, templated on the row type):
//   * one warp per (sample b, slot k); it loads 32 row ids at once
//     (coalesced), broadcasts them with shuffles, and issues the loads of
//     UNROLL rows before it adds them; lane l owns chunks l, l+32, ... of
//     4 row elements (a 16-byte float4 in f32, a 4-byte char4 in int8: an
//     int8 row of d32 is 32 bytes), so one row is read by consecutive
//     lanes; chunk l + 32c lies in tile c, so an int8 lane dequantises
//     its chunk c with scale c of the row;
//   * the sum and the count stay in f32 registers and are added in column
//     order, with no atomics: the result is the same run to run;
//   * every offset is 64-bit: a dlrm0 row space holds more than 2^31
//     elements.
// An id at or past the group's last row reads the last row (JAX's
// mode="clip"); a span outside [0, S) is clamped to it.
// Not yet done (a later PR): TMA/cp.async staging, packing several narrow
// slots into one warp (a dim-32 slot keeps 8 of 32 lanes busy), and
// reading each distinct hot row once per block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXG = 128;       // row spaces one launch can address
constexpr int WARPS = 8;        // (b, k) pairs per block
constexpr int NT = WARPS * 32;
constexpr int UNROLL = 4;       // rows whose loads are in flight per warp

struct GroupTable {
  const void* base[MAXG];
  const float* scale[MAXG];     // int8 groups: (rows, ceil(dim / 128)) f32
  int dim[MAXG];
  int rows[MAXG];
  int n;
};

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// Chunk ch (4 elements) of row r as f32; c = ch / 32 is its 128-lane tile.
template <typename T>
__device__ __forceinline__ float4 load_chunk(const void* base,
                                             const float* scale, size_t r,
                                             int nch, int nt, int ch, int c);

template <>
__device__ __forceinline__ float4 load_chunk<float>(const void* base,
                                                    const float*, size_t r,
                                                    int nch, int, int ch,
                                                    int) {
  return __ldg(static_cast<const float4*>(base) + r * nch + ch);
}

template <>
__device__ __forceinline__ float4 load_chunk<int8_t>(const void* base,
                                                     const float* scale,
                                                     size_t r, int nch,
                                                     int nt, int ch, int c) {
  const char4 q = __ldg(static_cast<const char4*>(base) + r * nch + ch);
  const float s = __ldg(scale + r * nt + c);
  return make_float4((float)q.x * s, (float)q.y * s, (float)q.z * s,
                     (float)q.w * s);
}

// CPL: chunks per lane (Dm <= 128 * CPL); T: the row type, float or int8_t
template <int CPL, typename T>
__global__ void __launch_bounds__(NT) fused_lookup_kernel(
    const __grid_constant__ GroupTable groups, const int* __restrict__ rows,
    const int4* __restrict__ slots, float* __restrict__ out, int B, int S,
    int K, int Dm) {
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= (long long)B * K) return;
  const int lane = threadIdx.x % 32;
  const int b = (int)(w / K), k = (int)(w % K);
  const int4 sl = slots[k];                 // group, col a, col b, mean
  const bool ok = sl.x >= 0 && sl.x < groups.n;
  const int g = ok ? sl.x : 0;
  const int nch = ok ? groups.dim[g] / 4 : 0;
  const int nt = (nch + 31) / 32;          // 128-lane tiles of a row
  const int last = groups.rows[g] - 1;
  const void* __restrict__ base = groups.base[g];
  const float* __restrict__ scale = groups.scale[g];
  const int a = max(sl.y, 0);
  const int e = ok ? min(sl.z, S) : 0;
  const int* __restrict__ rrow = rows + (size_t)b * S;

  float4 acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  int cnt = 0;
  for (int c0 = a; c0 < e; c0 += 32) {
    const int n = min(32, e - c0);
    const int mine = lane < n ? __ldg(rrow + c0 + lane) : -1;
    for (int j = 0; j < n; j += UNROLL) {  // j <= 28, so j + u <= 31
      int r[UNROLL];
      float4 v[UNROLL][CPL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        r[u] = min(__shfl_sync(0xffffffffu, mine, j + u), last);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int ch = lane + 32 * c;
          v[u][c] = (r[u] >= 0 && ch < nch)
                        ? load_chunk<T>(base, scale, (size_t)r[u], nch, nt,
                                        ch, c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r[u] < 0) continue;             // the same for the whole warp
        ++cnt;
#pragma unroll
        for (int c = 0; c < CPL; ++c) add4(acc[c], v[u][c]);
      }
    }
  }

  const float denom = (sl.w != 0 && cnt > 0) ? (float)cnt : 1.f;
  float4* o = reinterpret_cast<float4*>(out + ((size_t)b * K + k) * Dm);
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int ch = lane + 32 * c;
    if (ch >= Dm / 4) continue;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < nch)
      val = make_float4(acc[c].x / denom, acc[c].y / denom,
                        acc[c].z / denom, acc[c].w / denom);
    o[ch] = val;
  }
}

template <typename T>
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
    if (sizeof(T) == 1 && gt.scale[g] == nullptr)
      return (int)cudaErrorInvalidValue;
    gt.dim[g] = group_dims[g];
    gt.rows[g] = group_rows[g];
  }
  gt.n = n_groups;
  if (B == 0 || K == 0) return (int)cudaSuccess;
  const long long blocks = ((long long)B * K + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(rows);
  const int4* sl = static_cast<const int4*>(slots);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dm <= 128)
    fused_lookup_kernel<1, T><<<(unsigned)blocks, NT, 0, st>>>(gt, r, sl, o,
                                                               B, S, K, Dm);
  else if (Dm <= 256)
    fused_lookup_kernel<2, T><<<(unsigned)blocks, NT, 0, st>>>(gt, r, sl, o,
                                                               B, S, K, Dm);
  else
    fused_lookup_kernel<4, T><<<(unsigned)blocks, NT, 0, st>>>(gt, r, sl, o,
                                                               B, S, K, Dm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_fused_lookup_f32(
    const void* const* group_ptrs, const int* group_dims,
    const int* group_rows, int n_groups, const void* rows, const void* slots,
    void* out, int B, int S, int K, int Dm, void* stream) {
  return launch<float>(group_ptrs, nullptr, group_dims, group_rows, n_groups,
                       rows, slots, out, B, S, K, Dm, stream);
}

// int8 row spaces: scale_ptrs[g] is group g's (rows, ceil(dim / 128)) f32
// scales.
extern "C" int repro_fused_lookup_q8(
    const void* const* group_ptrs, const void* const* scale_ptrs,
    const int* group_dims, const int* group_rows, int n_groups,
    const void* rows, const void* slots, void* out, int B, int S, int K,
    int Dm, void* stream) {
  return launch<int8_t>(group_ptrs, scale_ptrs, group_dims, group_rows,
                        n_groups, rows, slots, out, B, S, K, Dm, stream);
}
