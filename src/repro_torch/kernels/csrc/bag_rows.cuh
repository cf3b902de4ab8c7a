// The bag combine shared by the embedding lookups (fused_lookup.cu: f32
// and int8 row spaces; embedding_lookup.cu: one f32 table): each bag is a
// span of id columns of one sample, and its output row is the sum (or the
// mean, count floored at 1) of the rows its valid ids name.
//
// Add rows, never split them: the bits depend on it.  Each output lane is
// one f32 sum over the bag's valid columns in column order, started from
// +0 (so it is never -0, and skipping an invalid id is the same as adding
// zero), then divided by the count floored at 1 (1 for a sum).  A bag's
// output lanes may be spread over threads, but each lane's rows are added
// by one thread, in order.  An int8 element is widened and multiplied by its tile's
// scale (f32, `__fmul_rn`: never contracted into the add) before it is
// added.
//
// Design, for the bytes-bound gather on the H100:
//   * table-major work: a block takes bags of one slot (one table) only,
//     consecutive samples, and the blocks of a slot are adjacent in the
//     grid; so a block's bags share one row width and one valency class
//     (no short bag waits behind a long one), and a table's hot rows are
//     read again while they are still in the 50 MB L2;
//   * lane groups fit the row: a row is `nch` chunks of 16 bytes (4 f32
//     elements, or 16 int8 elements inside one 128-lane tile and so one
//     scale a chunk; 4 int8 elements where the dim is not a multiple of
//     16), and a bag takes a group of L lanes (4, 8, 16 or 32), C chunks
//     a lane (chunk lg + L c), chosen per slot to leave the fewest lanes
//     idle (`lane_groups`); a warp takes 32 / L bags;
//   * rows in flight: a group reads 32 id columns at once (the next 32 a
//     chunk ahead), compacts the valid ones in column order through
//     shared memory, and issues the loads of F / C rows a lane before it
//     adds any (F = 16 loads of 16 bytes a lane in the fused lookup; the
//     single-table lookup picks F per table);
//   * small grids (few bags: the single-table lookup of one batch) take
//     the widest lane groups (C = 1 up to 32 lanes) and smaller blocks,
//     so more warps and SMs share the work.
// An id at or past the row space's last row reads the last row (JAX's
// mode="clip"); any negative id is no value.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bag_rows {

constexpr unsigned FULL = 0xffffffffu;
constexpr int IN_FLIGHT = 16;   // 16-byte loads a lane issues before adding
                                // (the default of `run`'s F)
constexpr int MAX_WARPS = 8;    // warps a block
constexpr int SMS = 132;        // the H100's SMs
constexpr int ID_ROW = 33;      // shared ints a group's compacted ids take
constexpr int WARP_IDS = 8 * ID_ROW;   // a warp's: at most 8 groups

// The bags of one slot.
struct Bags {
  const void* base;       // row space: rows of `dim` elements, row-major
  const float* scale;     // int8: (rows, ceil(dim / 128)) f32 scales
  int dim;                // elements a row (0: a slot with no row space)
  int last;               // the last row id
  const int* ids;         // (B, S) int32 ids; the slot reads [a, e)
  long long S;
  int a, e, mean;
  float* out;             // sample b's output row: out + b * out_stride
  long long out_stride;
  int Dm;                 // floats an output row: zero past dim
  int B;
};

// Row types: E elements a 16-byte (or 4-byte) chunk, the raw chunk that
// is in flight, its load and its add.
struct F32Row {
  static constexpr int E = 4;
  static constexpr int MAXC = 4;          // dims up to 512
  static constexpr bool FIT = true;
  struct Raw { float4 v; };
  static __device__ __forceinline__ Raw zero() {
    return {make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  static __device__ __forceinline__ Raw load(const void* base, const float*,
                                             size_t r, int nch, int, int ch) {
    return {__ldg(static_cast<const float4*>(base) + r * nch + ch)};
  }
  static __device__ __forceinline__ void add(float* acc, const Raw& x) {
    acc[0] += x.v.x;
    acc[1] += x.v.y;
    acc[2] += x.v.z;
    acc[3] += x.v.w;
  }
};

__device__ __forceinline__ float widen(int word, int byte) {
  return (float)(int8_t)(word >> (8 * byte));
}

// int8, dim a multiple of 16: 16 elements a chunk, chunk ch in tile ch / 8.
// Always the widest lane groups (C = 1): 16 accumulators a chunk.
struct Q8Row {
  static constexpr int E = 16;
  static constexpr int MAXC = 1;          // 32 chunks of 16: dims up to 512
  static constexpr bool FIT = false;
  struct Raw { int4 q; float s; };
  static __device__ __forceinline__ Raw zero() {
    return {make_int4(0, 0, 0, 0), 0.f};
  }
  static __device__ __forceinline__ Raw load(const void* base,
                                             const float* scale, size_t r,
                                             int nch, int nt, int ch) {
    return {__ldg(static_cast<const int4*>(base) + r * nch + ch),
            __ldg(scale + r * nt + ch / 8)};
  }
  static __device__ __forceinline__ void add(float* acc, const Raw& x) {
    const int w[4] = {x.q.x, x.q.y, x.q.z, x.q.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      acc[i] += __fmul_rn(widen(w[i / 4], i % 4), x.s);
  }
};

// int8, other dims (a multiple of 4): 4 elements a chunk, tile ch / 32.
struct Q8NRow {
  static constexpr int E = 4;
  static constexpr int MAXC = 4;
  static constexpr bool FIT = true;
  struct Raw { char4 q; float s; };
  static __device__ __forceinline__ Raw zero() {
    return {make_char4(0, 0, 0, 0), 0.f};
  }
  static __device__ __forceinline__ Raw load(const void* base,
                                             const float* scale, size_t r,
                                             int nch, int nt, int ch) {
    return {__ldg(static_cast<const char4*>(base) + r * nch + ch),
            __ldg(scale + r * nt + ch / 32)};
  }
  static __device__ __forceinline__ void add(float* acc, const Raw& x) {
    acc[0] += __fmul_rn((float)x.q.x, x.s);
    acc[1] += __fmul_rn((float)x.q.y, x.s);
    acc[2] += __fmul_rn((float)x.q.z, x.s);
    acc[3] += __fmul_rn((float)x.q.w, x.s);
  }
};

// Lanes a bag (L) and chunks a lane (C) for rows of `nch` chunks.  Fit:
// the fewest idle lanes, L * C - nch, with C <= 4 (a tie goes to the
// wider group, which keeps more rows in flight); spread: the widest group
// up to 32 lanes, C = 1 where the row fits a warp.
__host__ __device__ inline void lane_groups(int nch, bool spread, int& L,
                                            int& C) {
  if (spread) {
    L = 4;
    while (L < nch && L < 32) L <<= 1;
    C = nch > L ? (nch + L - 1) / L : 1;
    return;
  }
  L = 32;
  C = nch > 32 ? (nch + 31) / 32 : 1;
  for (int l = 16; l >= 4; l >>= 1) {
    const int c = nch > l ? (nch + l - 1) / l : 1;
    if (c <= 4 && l * c - nch < L * C - nch) {
      L = l;
      C = c;
    }
  }
}

// The bags of this warp: samples bw .. bw + 32 / L - 1 of the slot, one a
// lane group; F loads a lane in flight.  `sid`: this warp's WARP_IDS
// shared ints.
template <class Row, int L, int C, int F>
__device__ __forceinline__ void sum_bags(const Bags& s, long long bw,
                                         int* sid) {
  constexpr int H = 32 / L;               // ids a lane holds of 32 columns
  constexpr int U = F / C > 0 ? F / C : 1;   // rows in flight a group
  constexpr int E = Row::E;
  constexpr unsigned LOW = L == 32 ? FULL : (1u << L) - 1;
  using Raw = typename Row::Raw;
  const int lane = threadIdx.x & 31, grp = lane / L, lg = lane % L;
  const long long b = bw + grp;
  const bool live = b < s.B;
  const int* __restrict__ ids = s.ids + (live ? b : 0) * s.S;
  const int nch = s.dim / E;
  const int nt = (s.dim + 127) / 128;
  int* gid = sid + grp * ID_ROW;

  float acc[C][E];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < E; ++i) acc[c][i] = 0.f;
  int cnt = 0;
  int next[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int p = s.a + lg + L * h;
    next[h] = live && p < s.e ? __ldg(ids + p) : -1;
  }
  for (int c0 = s.a; c0 < s.e; c0 += 32) {        // the same for the warp
    int held[H];
    unsigned m = 0;                               // the group's valid columns
#pragma unroll
    for (int h = 0; h < H; ++h) {
      held[h] = next[h];
      const int p = c0 + 32 + lg + L * h;         // the next chunk's ids
      next[h] = live && p < s.e ? __ldg(ids + p) : -1;
      const unsigned bal = __ballot_sync(FULL, held[h] >= 0);
      m |= ((bal >> (grp * L)) & LOW) << (L * h);
    }
    const int nv = __popc(m);
    __syncwarp();                   // the previous chunk's ids are read
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int p = lg + L * h;
      if (held[h] >= 0) gid[__popc(m & ((1u << p) - 1))] = held[h];
    }
    __syncwarp();
    cnt += nv;
    const int todo = __reduce_max_sync(FULL, nv);
    for (int j = 0; j < todo; j += U) {
      Raw v[U][C];
#pragma unroll
      for (int u = 0; u < U; ++u) {               // issue every load first
        const int r = j + u < nv ? min(gid[j + u], s.last) : -1;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int ch = lg + L * c;
          v[u][c] = r >= 0 && ch < nch
                        ? Row::load(s.base, s.scale, (size_t)r, nch, nt, ch)
                        : Row::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {               // then add them in order
        if (j + u < nv) {
#pragma unroll
          for (int c = 0; c < C; ++c) Row::add(acc[c], v[u][c]);
        }
      }
    }
  }

  if (!live) return;
  const float denom = (s.mean != 0 && cnt > 0) ? (float)cnt : 1.f;
  float4* o = reinterpret_cast<float4*>(s.out + b * s.out_stride);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ch = lg + L * c;
    if (ch >= nch) continue;
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      o[ch * (E / 4) + q] = make_float4(
          acc[c][4 * q] / denom, acc[c][4 * q + 1] / denom,
          acc[c][4 * q + 2] / denom, acc[c][4 * q + 3] / denom);
  }
  for (int q = nch * (E / 4) + lg; q < s.Dm / 4; q += L)
    o[q] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <class Row, int L, int C, int F>
__device__ __forceinline__ void sum_bags_if(const Bags& s, long long bw,
                                            int* sid) {
  if constexpr (C <= Row::MAXC) sum_bags<Row, L, C, F>(s, bw, sid);
}

// Block `tile` of the slot, lane groups of L lanes: its warps take
// consecutive bags.  `sid`: the block's dynamic shared memory, WARP_IDS
// ints a warp.
template <class Row, int L, int C, int F>
__device__ __forceinline__ void tile_bags(const Bags& s, long long tile,
                                          int* sid) {
  const int warp = threadIdx.x >> 5;
  const long long bw = (tile * (blockDim.x >> 5) + warp) * (32 / L);
  if (bw >= s.B) return;                          // the same for the warp
  sum_bags_if<Row, L, C, F>(s, bw, sid + warp * WARP_IDS);
}

// `tile_bags` with the lane groups of the slot's row width.
template <class Row, int F = IN_FLIGHT>
__device__ __forceinline__ void run(const Bags& s, long long tile,
                                    bool spread, int* sid) {
  int L, C;
  lane_groups(s.dim / Row::E, spread || !Row::FIT, L, C);
  switch (L * 8 + C) {
    case 4 * 8 + 1: tile_bags<Row, 4, 1, F>(s, tile, sid); break;
    case 4 * 8 + 3: tile_bags<Row, 4, 3, F>(s, tile, sid); break;
    case 8 * 8 + 1: tile_bags<Row, 8, 1, F>(s, tile, sid); break;
    case 8 * 8 + 3: tile_bags<Row, 8, 3, F>(s, tile, sid); break;
    case 16 * 8 + 1: tile_bags<Row, 16, 1, F>(s, tile, sid); break;
    case 16 * 8 + 3: tile_bags<Row, 16, 3, F>(s, tile, sid); break;
    case 32 * 8 + 1: tile_bags<Row, 32, 1, F>(s, tile, sid); break;
    case 32 * 8 + 2: tile_bags<Row, 32, 2, F>(s, tile, sid); break;
    case 32 * 8 + 3: tile_bags<Row, 32, 3, F>(s, tile, sid); break;
    default: tile_bags<Row, 32, 4, F>(s, tile, sid); break;
  }
}

// The launch shape: warps a block, whether the lane groups spread (fewer
// than 128 bags an SM), and blocks a slot, enough for the slot whose lane
// groups are widest (`lanes`: its L, from `lanes_for`); blocks shrink
// while a launch would have fewer than two a SM.
struct Shape {
  int warps;
  bool spread;
  long long tiles;
  size_t smem() const { return (size_t)warps * WARP_IDS * sizeof(int); }
};

inline bool spread_for(int B, int K) {
  return (long long)B * K < 128LL * SMS;
}

// L of a row of `dim` elements read `E` at a time.
inline int lanes_for(int dim, int E, bool spread) {
  int L, C;
  lane_groups(dim / E, spread, L, C);
  return L;
}

inline Shape shape(int B, int K, bool spread, int lanes) {
  const long long per_warp = 32 / lanes;      // the fewest bags a warp
  Shape sh{MAX_WARPS, spread, 0};
  auto tiles = [&](int w) { return (B + w * per_warp - 1) / (w * per_warp); };
  while (sh.warps > 1 && K * tiles(sh.warps) < 2LL * SMS) sh.warps >>= 1;
  sh.tiles = tiles(sh.warps);
  return sh;
}

}  // namespace bag_rows
