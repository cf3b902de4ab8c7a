// The run walk shared by the two embedding-gradient scatters
// (embedding_scatter.cu, fused_scatter.cu): a stream of positions whose
// equal keys are adjacent, each run summed into one output row, in
// position order, one f32 add a lane at a time.
//
// Split lanes, never runs: the bits depend on it.  Every output lane is
// an independent f32 sum in the run's order, so a run's lanes may be
// spread over threads, warps or blocks, but its positions are added by
// one thread a lane, in order.  Cutting a run into segments and adding
// their partial sums would change the bits.
//
// A warp takes 32 positions (a chunk).  One ballot of each per-lane flag
// gives every run head, every run end and so every run's extent in the
// chunk; each run lies wholly in the chunk except the one that goes on
// past it (its `tail`).  The runs that end in the chunk are summed by
// lane groups of L lanes (a power of two >= the row's float4 chunks,
// capped at 32; groups take runs in turn): every group issues the loads
// of up to 16 / CPL rows before it adds any (16 where a row fits the
// warp), so a warp has 16 float4 a lane in flight (8 KB) whatever the row
// width.  The tail run is left to the caller (`walk_run`, or the fused
// scatter's hot list).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scatter_runs {

constexpr unsigned FULL = 0xffffffffu;
constexpr int IN_FLIGHT = 16;   // float4 loads a lane issues before adding

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// The runs of one chunk, from each lane's flags: valid (the position
// adds into a row), head (valid and the run starts here), cont (valid
// and the next position is in the same run).
struct Chunk {
  unsigned heads;    // run heads
  unsigned ends;     // last positions of runs
  unsigned shorts;   // positions of the runs that start and end here
  int tail;          // head of the run that starts here and goes on, or -1
};

__device__ __forceinline__ Chunk chunk_runs(bool valid, bool head,
                                            bool cont) {
  const unsigned vm = __ballot_sync(FULL, valid);
  const unsigned cm = __ballot_sync(FULL, cont);
  Chunk c;
  c.heads = __ballot_sync(FULL, head);
  c.ends = vm & ~cm;
  c.shorts = 0;
  c.tail = -1;
  if (!c.heads) return c;
  // positions before the first head belong to a run an earlier chunk owns
  const unsigned owned = vm & (FULL << (__ffs(c.heads) - 1));
  c.shorts = owned;
  if ((owned & cm) >> 31) {       // position 31 is ours and its run goes on
    c.tail = 31 - __clz(c.heads);
    c.shorts = owned & ((1u << c.tail) - 1);
  }
  return c;
}

// Each lane group of L lanes (lg: the lane in it) adds the runs at its
// positions `m` (`todo`: the most any group has), in order, C float4
// chunks a lane (chunk lg + L k of a row), IN_FLIGHT / C rows' loads
// issued before any add.
template <int C>
__device__ __forceinline__ void add_group_runs(
    unsigned m, int todo, unsigned ends, int L, int lg,
    const float4* __restrict__ src, long long off, int nch, float4* dst) {
  constexpr int U = IN_FLIGHT / C;
  float4 acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = zero4();
  for (int t = 0; t < todo; t += U) {
    float4 v[U][C];
    unsigned mm = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {             // issue every load first
      const bool live = mm != 0;
      const int p = live ? __ffs(mm) - 1 : 0;
      mm &= mm - 1;
      const long long o = __shfl_sync(FULL, off, p);
      const int n = __shfl_sync(FULL, nch, p);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int ch = lg + L * k;
        v[u][k] = live && ch < n ? __ldg(src + o + ch) : zero4();
      }
    }
    mm = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {             // then add them in order
      const bool live = mm != 0;
      const int p = live ? __ffs(mm) - 1 : 0;
      mm &= mm - 1;
      float4* d = reinterpret_cast<float4*>(__shfl_sync(
          FULL, reinterpret_cast<unsigned long long>(dst), p));
      const int n = __shfl_sync(FULL, nch, p);
      if (live) {
#pragma unroll
        for (int k = 0; k < C; ++k) add4(acc[k], v[u][k]);
        if ((ends >> p) & 1) {                // the run is complete
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const int ch = lg + L * k;
            if (ch < n) d[ch] = acc[k];
            acc[k] = zero4();
          }
        }
      }
    }
    m = mm;
  }
}

// Sum the chunk's short runs.  Per lane, for its own position: `off`, the
// float4 offset of its gradient row in `src`; `nch`, the row's float4
// chunks (0 where the position is not in a short run); `dst`, its output
// row.  CPL: float4 chunks a lane holds of one row (rows of up to
// 128 * CPL lanes); a chunk whose rows all fit 32 float4 takes 16 rows a
// group in flight, whatever CPL.  The whole warp must call this.
template <int CPL>
__device__ __forceinline__ void sum_short_runs(const Chunk& c,
                                               const float4* __restrict__ src,
                                               long long off, int nch,
                                               float4* dst, int lane) {
  if (!c.shorts) return;                      // the same for the whole warp
  const bool mine = (c.shorts >> lane) & 1;
  const int widest = __reduce_max_sync(FULL, mine ? nch : 0);
  int L = 4;                                  // lanes a run
  while (L < widest && L < 32) L <<= 1;
  const int shift = __ffs(L) - 1;
  const int groups = 32 >> shift;
  const int q = lane >> shift, lg = lane & (L - 1);
  // runs go to the groups in turn: run r (the r-th head) to group r % groups
  const int r = __popc(c.heads & (FULL >> (31 - lane))) - 1;
  unsigned m = 0;                             // this group's positions
  for (int gq = 0; gq < groups; ++gq) {
    const unsigned b = __ballot_sync(FULL, mine && (r & (groups - 1)) == gq);
    if (gq == q) m = b;
  }
  const int todo = __reduce_max_sync(FULL, __popc(m));
  if (widest <= 32)
    add_group_runs<1>(m, todo, c.ends, L, lg, src, off, nch, dst);
  else
    add_group_runs<CPL>(m, todo, c.ends, L, lg, src, off, nch, dst);
}

// The whole warp sums one run, C float4 chunks a lane (lane l holds chunks
// l, l + 32, ...), IN_FLIGHT / C rows in flight.
template <int C, class Same, class Offset>
__device__ __forceinline__ void walk_body(long long P, long long N,
                                          const float4* __restrict__ src,
                                          int nch, float4* dst, int lane,
                                          Same& same, Offset& offset) {
  constexpr int U = IN_FLIGHT / C;
  float4 acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = zero4();
  for (long long p = P;;) {
    const long long pj = p + lane;
    const bool in = pj < N && same(pj);
    const unsigned other = ~__ballot_sync(FULL, in);
    const int n = other ? __ffs(other) - 1 : 32;
    const long long off = in ? offset(pj) : 0;
    for (int j = 0; j < n; j += U) {
      float4 v[U][C];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long o = __shfl_sync(FULL, off, (j + u) & 31);
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const int ch = lane + 32 * k;
          v[u][k] = j + u < n && ch < nch ? __ldg(src + o + ch) : zero4();
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u >= n) break;                // the same for the whole warp
#pragma unroll
        for (int k = 0; k < C; ++k) add4(acc[k], v[u][k]);
      }
    }
    p += n;
    if (n < 32) break;
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int ch = lane + 32 * k;
    if (ch < nch) dst[ch] = acc[k];
  }
}

// Sum the run that starts at position P, in position order, with the whole
// warp, then write it to `dst` (`nch` float4 chunks).  `same(p)` says
// whether position p < N is in the run (the run is the prefix of such
// positions); `offset(p)` is the float4 offset of position p's gradient
// row in `src`.
template <int CPL, class Same, class Offset>
__device__ __forceinline__ void walk_run(long long P, long long N,
                                         const float4* __restrict__ src,
                                         int nch, float4* dst, int lane,
                                         Same same, Offset offset) {
  if (nch <= 32)
    walk_body<1>(P, N, src, nch, dst, lane, same, offset);
  else
    walk_body<CPL>(P, N, src, nch, dst, lane, same, offset);
}

}  // namespace scatter_runs
