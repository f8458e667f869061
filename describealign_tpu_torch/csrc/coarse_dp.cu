// The coarse max-plus track DP for Hopper (sm_90a): dp_forward on one
// thread-block cluster, dp_backtrace as a row pre-pass over all SMs plus a
// one-warp walk over a 5-lane window.
//
// Replaces the XLA lax.scan programs of the JAX package's coarse pass,
// describealign_tpu/alignment/matching.py: `_coarse_dp` (forward scan and
// backtrace scan) and the row loops inside `_coarse_dp_streamed`, whose
// steps are `_dp_relax` and `_dp_backstep`. (They are XLA programs, not
// Pallas kernels; in eager PyTorch each step is ~29 small launches, and a
// 27-minute pair has 1,663 steps per track, a film 6,143.)
//
// dp_forward, for r = 0..n-1 with prev = rows[r-1] (rows[-1] given):
//   prev10[j] = j < 10 ? -1e30 : prev[j - 10]
//   fwd[j]    = max_{i<=j}(prev10[i] + 0.5 i) - 0.5 j
//   bwd[j]    = max_{i>=j}(prev10[i] - 0.5 i) + 0.5 j
//   rows[r][j] = max(fwd[j], bwd[j], max(prev) - 1) + scores[r][j]
// dp_backtrace, for r = n-1..0 with o the lane chosen after row r:
//   moved[j] = rows[r][j] - 0.5 |j - (o - 10)|
//   o = max(moved) >= max(rows[r]) - 1 ? first argmax(moved)
//                                      : first argmax(rows[r])
//   path[r] = o
// (without a given o, path[n-1] is the first argmax of the last row and the
// walk starts at n-2).
//
// What bounds it. The steps are strictly sequential and each forward step
// needs the whole previous row: two running maxima across all D lanes and a
// global max. The work per step is tiny (8 bytes and ~10 operations per
// lane; at 3.35 TB/s a 61k-lane step would move its bytes in 0.15 us), so
// the time is n times the latency of one step: its dependent instructions
// per thread and its barriers. An earlier design walked the steps with one
// 1024-thread CTA, 17 lanes per thread in 544-lane sub-tiles, the previous
// row read back from global memory: 7.0 us per step at 16,638 lanes and
// 36.2 us at 61,438 on an H100 (one SM's instruction and shared-memory rate);
// its backtrace scanned the whole row at every step, 3.65 and 5.9 us.
//
// dp_forward_kernel<L>: one cluster of 1-16 CTAs per DP; CTA q owns the
// lanes [q S, (q + 1) S), S = threads x L, each thread L consecutive lanes
// (L odd, so L-strided shared accesses hit 32 banks).
//   - The row never leaves the cluster: each CTA keeps its slice of the
//     current row in shared memory, double-buffered by step parity, behind
//     a 10-lane halo that the left neighbour stores into it remotely, so
//     prev10 is a read at offset -10. rows[r] goes to global memory by
//     coalesced stores that the forward pass never reads back.
//   - Carries across CTAs are three numbers each, computed from the row as
//     it is produced: max(v[j] + 0.5 (j + 10)) and max(v[j] - 0.5 (j + 10))
//     over the CTA's lanes with j + 10 < D (the same single rounding as
//     prev10[j'] + 0.5 j' at j' = j + 10), and max(v). Every CTA stores its
//     three into every peer's slot for the next parity and arrives at the
//     one cluster barrier of the step. The last 10 lanes of a slice lie in
//     the right neighbour's halo: that neighbour gets the forward aggregate
//     without them, and the CTA itself adds their backward aggregate to its
//     carry from the right.
//   - Inside a CTA: register chains over the thread's L lanes, a shuffle
//     scan of the thread aggregates, the warps' totals through shared
//     memory (one CTA barrier), then the combine; the three aggregates of
//     the new row take a second CTA barrier before they are pushed.
//   - The score rows come NST steps ahead into a shared ring by cp.async,
//     so device-memory latency is off the step; the fetch is started and
//     the row goes out between the cluster barrier's arrive and wait.
// On an H100 (700 W) a step of this takes 1.86 us at 16,638 lanes (16 CTAs
// x 352 threads x 3 lanes) and 3.0 us at 61,438 (16 x 768 x 5); the same
// cluster doing only the halo, the exchange and the barriers of a step
// takes 1.1-1.2 us, of which the cluster barrier with its stores is
// ~0.8 us even on one CTA. Two variants were measured and dropped: words
// that carry their own step tag, polled by the receiver instead of the
// cluster barrier (1.4-2.0 us for the empty step), and the in-slice scans
// run between the barrier's arrive and wait with the halo joined after it
// (2.17 and 3.60 us per step: the halo's extra work after the wait costs
// what the overlap saves). More threads of fewer lanes beat fewer threads
// of more at both widths.
// dp_forward_wide_kernel takes the widths beyond a cluster's shared memory
// (above 16 x 1024 x 9 lanes): the same cluster, each CTA looping over
// passes of its slice, the previous row read back from global memory, two
// cluster barriers per step.
//
// dp_backtrace: max(rows[r]) and its first lane do not depend on o, so
// dp_rowmax_kernel computes all n of them first, one CTA per row on all
// SMs. moved[j] >= max(rows[r]) - 1 can hold only for |j - (o - 10)| <= 2
// while ulp(max) <= 0.5, so dp_backtrace_kernel (one warp) reads a 5-lane
// window per step, with the row maxima loaded a row ahead and the window
// of the row 8 steps on prefetched along the nominal advance: 0.5-0.6 us
// per step at both widths. Where |max(rows[r])| >= 2^22 (a row of -1e30:
// there x - 1 == x) the warp scans the whole row, a uniform branch on the
// row's maximum (26 us for a 61,438-lane row).
//
// Bit-equality with the plain PyTorch version: max is exact in any order;
// every add and subtract is one IEEE f32 rounding (__fadd_rn / __fsub_rn,
// never contracted); 0.5 * lane is exact. No fast-math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 16;
constexpr int ADV = 10;              // COARSE_PER_BLOCK: lanes per block
constexpr float SLOPE = 0.5f;        // DP_SLOPE_COST
constexpr float JUMP = 1.0f;         // DP_JUMP_COST
constexpr float NEG = -1e30f;        // cost shifted in below lane ADV
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_LANE = 0x7fffffff;
constexpr int NST = 3;               // score rows in the shared ring
constexpr int WIDE_L = 9;            // lanes per thread of the wide kernel
constexpr int ROWMAX_THREADS = 256;
constexpr float WINDOW_LIMIT = 4194304.0f;  // 2^22: above, x - 1 may be x
constexpr int WINDOW = 2;            // lanes each side of o - 10
constexpr int AHEAD = 8;             // rows the walk prefetches ahead

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// --- the cluster: remote shared-memory stores and the split barrier -------

__device__ __forceinline__ void st_peer(float* local, unsigned rank,
                                        float v) {
  const unsigned here = (unsigned)__cvta_generic_to_shared(local);
  unsigned there;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(there) : "r"(here), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :: "r"(there), "f"(v) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Shared scratch of the forward kernels.
struct ForwardShared {
  float wa[32], wb[32];              // warp totals of the in-slice scans
  float ra[32], rb[32], rm[32];      // warp aggregates of the new row
  float tail_a[2], tail_b[2];        // the slice's last ADV lanes, by parity
  // the CTAs' aggregates, by parity and rank (stored by the peers)
  float xa[2][MAX_CLUSTER], xb[2][MAX_CLUSTER], xm[2][MAX_CLUSTER];
};

// Exclusive prefix maximum of ta and exclusive suffix maximum of tb over the
// CTA's threads in thread order (one __syncthreads); with TOTALS also the
// maxima over all threads.
template <bool TOTALS>
__device__ __forceinline__ void block_scan(float ta, float tb,
                                           ForwardShared& sh, int lane,
                                           int warp, int nwarps, float& ea,
                                           float& eb, float& tot_a,
                                           float& tot_b) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float ua = __shfl_up_sync(FULL, ta, off);
    const float ub = __shfl_down_sync(FULL, tb, off);
    if (lane >= off) ta = fmaxf(ta, ua);
    if (lane + off < 32) tb = fmaxf(tb, ub);
  }
  if (lane == 31) sh.wa[warp] = ta;
  if (lane == 0) sh.wb[warp] = tb;
  ea = __shfl_up_sync(FULL, ta, 1);
  eb = __shfl_down_sync(FULL, tb, 1);
  if (lane == 0) ea = -INFINITY;
  if (lane == 31) eb = -INFINITY;
  __syncthreads();
  const float oa = lane < nwarps ? sh.wa[lane] : -INFINITY;
  const float ob = lane < nwarps ? sh.wb[lane] : -INFINITY;
  ea = fmaxf(ea, warp_max(lane < warp ? oa : -INFINITY));
  eb = fmaxf(eb, warp_max(lane > warp ? ob : -INFINITY));
  if (TOTALS) {
    tot_a = warp_max(oa);
    tot_b = warp_max(ob);
  }
}

// The carries into CTA `rank` and the jump cap from the cluster's slots.
__device__ __forceinline__ void cluster_carries(const ForwardShared& sh,
                                                int par, int lane,
                                                unsigned rank, unsigned csize,
                                                float& cf, float& cb,
                                                float& jump) {
  const bool in = (unsigned)lane < csize;
  const float a = in ? sh.xa[par][lane] : -INFINITY;
  const float b = in ? sh.xb[par][lane] : -INFINITY;
  const float m = in ? sh.xm[par][lane] : -INFINITY;
  cf = warp_max((unsigned)lane < rank ? a : -INFINITY);
  cb = warp_max((unsigned)lane > rank ? b : -INFINITY);
  jump = __fsub_rn(warp_max(m), JUMP);
}

// Row `v` (the thread's L lanes from local lane x0, global lane j0) becomes
// the cluster's current row of parity `par`: into the slice, the last ADV
// lanes into the right neighbour's halo, the three aggregates into every
// peer's slots; ends with the arrive of the step's cluster barrier.
template <int L>
__device__ __forceinline__ void publish(const float (&v)[L], float* slice,
                                        ForwardShared& sh, int par, int x0,
                                        int j0, int s, int d, int lane,
                                        int warp, int nwarps, unsigned rank,
                                        unsigned csize) {
#pragma unroll
  for (int i = 0; i < L; ++i) slice[ADV + x0 + i] = v[i];
  if (x0 + L > s - ADV && rank + 1 < csize) {
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (x0 + i >= s - ADV)
        st_peer(slice + (x0 + i - (s - ADV)), rank + 1, v[i]);
  }
  float a = -INFINITY, b = -INFINITY, m = -INFINITY;
  float a10 = -INFINITY, b10 = -INFINITY;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    m = fmaxf(m, v[i]);                      // -inf at lanes past D
    if (j0 + i + ADV < d) {
      const float sl = SLOPE * (float)(j0 + i + ADV);
      const float fa = __fadd_rn(v[i], sl);
      const float fb = __fsub_rn(v[i], sl);
      b = fmaxf(b, fb);
      if (x0 + i < s - ADV) {
        a = fmaxf(a, fa);
      } else {
        a10 = fmaxf(a10, fa);
        b10 = fmaxf(b10, fb);
      }
    }
  }
  a = warp_max(a);
  b = warp_max(b);
  m = warp_max(m);
  if (warp == nwarps - 1) {                  // holds the last ADV lanes
    a10 = warp_max(a10);
    b10 = warp_max(b10);
    if (lane == 0) {
      sh.tail_a[par] = a10;
      sh.tail_b[par] = b10;
    }
  }
  if (lane == 0) {
    sh.ra[warp] = a;
    sh.rb[warp] = b;
    sh.rm[warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
    a = warp_max(lane < nwarps ? sh.ra[lane] : -INFINITY);
    b = warp_max(lane < nwarps ? sh.rb[lane] : -INFINITY);
    m = warp_max(lane < nwarps ? sh.rm[lane] : -INFINITY);
    if ((unsigned)lane < csize) {
      // the right neighbour has this slice's last lanes in its halo
      const float af = (unsigned)lane == rank + 1
                           ? a : fmaxf(a, sh.tail_a[par]);
      st_peer(&sh.xa[par][rank], lane, af);
      st_peer(&sh.xb[par][rank], lane, b);
      st_peer(&sh.xm[par][rank], lane, m);
    }
  }
  cluster_arrive();
}

extern __shared__ float dp_smem[];

template <int L>
__global__ void __launch_bounds__(MAX_THREADS)
dp_forward_kernel(const float* __restrict__ prev0,
                  const float* __restrict__ scores, float* __restrict__ rows,
                  long long n, int d) {
  __shared__ ForwardShared sh;
  const int t = threadIdx.x, threads = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = threads >> 5;
  const unsigned rank = blockIdx.x, csize = gridDim.x;
  const int s = threads * L;                 // lanes per CTA
  const int rs = s + ADV;                    // the halo, then the slice
  float* row_buf = dp_smem;                  // [2][rs]
  float* ring = dp_smem + 2 * rs;            // [NST][s]
  const int lo = (int)rank * s;
  const int x0 = t * L, j0 = lo + x0;

  // score row q on its way into the ring (coalesced, 4 bytes a thread);
  // one commit group per row, empty past the last row
  auto fetch = [&](long long q) {
    if (q < n) {
      const float* src = scores + q * d;
      float* dst = ring + (int)(q % NST) * s;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const int x = k * threads + t;
        if (lo + x < d) {
          const unsigned to = (unsigned)__cvta_generic_to_shared(dst + x);
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                       :: "r"(to), "l"(src + lo + x));
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int q = 0; q < NST; ++q) fetch(q);

  if (rank == 0 && t < ADV) {                // below lane ADV: both parities
    row_buf[t] = NEG;
    row_buf[rs + t] = NEG;
  }
  float v[L];
#pragma unroll
  for (int i = 0; i < L; ++i) v[i] = j0 + i < d ? prev0[j0 + i] : -INFINITY;
  int par = 0;
  publish<L>(v, row_buf, sh, par, x0, j0, s, d, lane, warp, nwarps, rank,
             csize);
  cluster_wait();

  // prev10's lanes 0..ADV-1 hold NEG and lie left of every later CTA
  const float floor_f = __fadd_rn(NEG, SLOPE * (float)(ADV - 1));
  for (long long r = 0; r < n; ++r) {
    const float* slice = row_buf + par * rs;
    float cfq, cbq, jump;
    cluster_carries(sh, par, lane, rank, csize, cfq, cbq, jump);
    if (rank > 0) cfq = fmaxf(cfq, floor_f);
    cbq = fmaxf(cbq, sh.tail_b[par]);

    // prev10 of the thread's lanes and its running maxima
    float f[L], b[L];
    const float s0 = SLOPE * (float)j0;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const float p = j0 + i < d ? slice[x0 + i] : -INFINITY;
      const float sl = s0 + SLOPE * (float)i;  // exact: multiples of 0.5
      f[i] = __fadd_rn(p, sl);
      b[i] = __fsub_rn(p, sl);
    }
#pragma unroll
    for (int i = 1; i < L; ++i) f[i] = fmaxf(f[i], f[i - 1]);
#pragma unroll
    for (int i = L - 2; i >= 0; --i) b[i] = fmaxf(b[i], b[i + 1]);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(NST - 1));
    float ea, eb, unused_a, unused_b;
    block_scan<false>(f[L - 1], b[0], sh, lane, warp, nwarps, ea, eb,
                      unused_a, unused_b);   // barrier: row r's scores landed
    const float cf = fmaxf(ea, cfq), cb = fmaxf(eb, cbq);
    const float* srow = ring + (int)(r % NST) * s;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const float sl = s0 + SLOPE * (float)i;
      const float fw = __fsub_rn(fmaxf(f[i], cf), sl);
      const float bw = __fadd_rn(fmaxf(b[i], cb), sl);
      const float best = fmaxf(fmaxf(fw, bw), jump);
      v[i] = j0 + i < d ? __fadd_rn(best, srow[x0 + i]) : -INFINITY;
    }
    par ^= 1;
    float* next = row_buf + par * rs;
    publish<L>(v, next, sh, par, x0, j0, s, d, lane, warp, nwarps, rank,
               csize);
    // while the cluster gathers, the row goes out and a score row comes
    // into the ring slot this step has read
    float* out = rows + r * d;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int x = k * threads + t;
      if (lo + x < d) out[lo + x] = next[ADV + x];
    }
    fetch(r + NST);
    cluster_wait();
  }
}

// --- widths beyond a cluster's shared memory -------------------------------

// maxima of a and b over the CTA (two barriers; every thread gets both)
__device__ __forceinline__ void block_max2(float& a, float& b,
                                           ForwardShared& sh, int lane,
                                           int warp, int nwarps) {
  a = warp_max(a);
  b = warp_max(b);
  if (lane == 0) {
    sh.ra[warp] = a;
    sh.rb[warp] = b;
  }
  __syncthreads();
  a = warp_max(lane < nwarps ? sh.ra[lane] : -INFINITY);
  b = warp_max(lane < nwarps ? sh.rb[lane] : -INFINITY);
  __syncthreads();
}

// prev shifted by the nominal advance, -inf past the row; the row was
// written by other SMs of the cluster, so the load bypasses L1
__device__ __forceinline__ float shifted(const float* prev, int j, int d) {
  if (j >= d) return -INFINITY;
  return j >= ADV ? __ldcg(prev + j - ADV) : NEG;
}

__global__ void __launch_bounds__(MAX_THREADS)
dp_forward_wide_kernel(const float* prev0, const float* __restrict__ scores,
                       float* rows, long long n, int d, int npass) {
  __shared__ ForwardShared sh;
  constexpr int L = WIDE_L;
  float* suffix = dp_smem;                   // [npass]: bwd of later passes
  const int t = threadIdx.x, threads = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = threads >> 5;
  const unsigned rank = blockIdx.x, csize = gridDim.x;
  const int pass = threads * L;              // lanes per pass
  const int lo = (int)rank * npass * pass;

  float m = -INFINITY, none = -INFINITY;
  for (int k = 0; k < npass; ++k)
    for (int i = 0; i < L; ++i) {
      const int j = lo + k * pass + i * threads + t;
      if (j < d) m = fmaxf(m, prev0[j]);
    }
  block_max2(m, none, sh, lane, warp, nwarps);

  const float* prev = prev0;
  int par = 0;
  for (long long r = 0; r < n; ++r, par ^= 1) {
    // 1. the slice's aggregates in prev10's lanes, per pass the bwd
    // maximum of the passes after it
    float agg_a = -INFINITY, agg_b = -INFINITY;
    for (int k = npass - 1; k >= 0; --k) {
      if (t == 0) suffix[k] = agg_b;
      const int j0 = lo + k * pass + t * L;
      float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float p = shifted(prev, j0 + i, d);
        const float sl = SLOPE * (float)(j0 + i);
        ta = fmaxf(ta, __fadd_rn(p, sl));
        tb = fmaxf(tb, __fsub_rn(p, sl));
      }
      block_max2(ta, tb, sh, lane, warp, nwarps);
      agg_a = fmaxf(agg_a, ta);
      agg_b = fmaxf(agg_b, tb);
    }
    if (warp == 0 && (unsigned)lane < csize) {
      st_peer(&sh.xa[par][rank], lane, agg_a);
      st_peer(&sh.xb[par][rank], lane, agg_b);
      st_peer(&sh.xm[par][rank], lane, m);
    }
    cluster_arrive();
    cluster_wait();
    float run_f, cbq, jump;
    cluster_carries(sh, par, lane, rank, csize, run_f, cbq, jump);

    // 2. pass by pass
    const float* srow = scores + r * d;
    float* out = rows + r * d;
    m = -INFINITY;
    for (int k = 0; k < npass; ++k) {
      const int j0 = lo + k * pass + t * L;
      const float s0 = SLOPE * (float)j0;
      float f[L], b[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float p = shifted(prev, j0 + i, d);
        const float sl = s0 + SLOPE * (float)i;
        f[i] = __fadd_rn(p, sl);
        b[i] = __fsub_rn(p, sl);
      }
#pragma unroll
      for (int i = 1; i < L; ++i) f[i] = fmaxf(f[i], f[i - 1]);
#pragma unroll
      for (int i = L - 2; i >= 0; --i) b[i] = fmaxf(b[i], b[i + 1]);
      float ea, eb, tot_a, tot_b;
      block_scan<true>(f[L - 1], b[0], sh, lane, warp, nwarps, ea, eb, tot_a,
                       tot_b);
      const float cf = fmaxf(ea, run_f);
      const float cb = fmaxf(eb, fmaxf(suffix[k], cbq));
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (j0 + i < d) {
          const float sl = s0 + SLOPE * (float)i;
          const float fw = __fsub_rn(fmaxf(f[i], cf), sl);
          const float bw = __fadd_rn(fmaxf(b[i], cb), sl);
          const float v = __fadd_rn(fmaxf(fmaxf(fw, bw), jump),
                                    srow[j0 + i]);
          out[j0 + i] = v;
          m = fmaxf(m, v);
        }
      }
      run_f = fmaxf(run_f, tot_a);
      __syncthreads();                       // the warp totals are reused
    }
    block_max2(m, none, sh, lane, warp, nwarps);
    // rows[r] is visible to the cluster after its barrier
    cluster_arrive();
    cluster_wait();
    prev = out;
  }
}

// --- the empty step: what the cluster costs a step, with no arithmetic ----

__global__ void __launch_bounds__(MAX_THREADS)
dp_empty_step_kernel(long long n, int cta_barriers, float* sink) {
  __shared__ ForwardShared sh;
  __shared__ float halo[2][ADV];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned rank = blockIdx.x, csize = gridDim.x;
  float acc = 0.0f;
  int par = 0;
  if (t < ADV) halo[0][t] = halo[1][t] = 0.0f;
  if (t < MAX_CLUSTER)
    for (int p = 0; p < 2; ++p) sh.xa[p][t] = sh.xb[p][t] = sh.xm[p][t] = 0.0f;
  __syncthreads();
  cluster_arrive();
  cluster_wait();
  for (long long r = 0; r < n; ++r, par ^= 1) {
    for (int k = 0; k < cta_barriers; ++k) __syncthreads();
    if (warp == (int)(blockDim.x >> 5) - 1 && lane < ADV && rank + 1 < csize)
      st_peer(&halo[par][lane], rank + 1, acc);
    if (warp == 0 && (unsigned)lane < csize) {
      st_peer(&sh.xa[par][rank], lane, acc);
      st_peer(&sh.xb[par][rank], lane, acc);
      st_peer(&sh.xm[par][rank], lane, acc);
    }
    cluster_arrive();
    cluster_wait();
    float cf, cb, jump;
    cluster_carries(sh, par, lane, rank, csize, cf, cb, jump);
    acc = fmaxf(acc, fmaxf(cf, fmaxf(cb, jump)) + halo[par][lane % ADV]);
  }
  if (t == 0) sink[rank] = acc;
}

// --- the backtrace ----------------------------------------------------------

// (value, lane) maximum, the lower lane winning ties
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    take_better(v, i, ov, oi);
  }
}

// max(rows[r]) and its first lane, one CTA per row
__global__ void __launch_bounds__(ROWMAX_THREADS)
dp_rowmax_kernel(const float* __restrict__ rows, float* __restrict__ row_max,
                 int* __restrict__ row_arg, int d) {
  __shared__ float best_v[ROWMAX_THREADS / 32];
  __shared__ int best_i[ROWMAX_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = rows + (long long)blockIdx.x * d;
  float v = -INFINITY;
  int at = NO_LANE;
  for (int j = threadIdx.x; j < d; j += ROWMAX_THREADS) {
    const float c = row[j];
    if (c > v) {                             // ascending j: the first stays
      v = c;
      at = j;
    }
  }
  warp_argmax(v, at);
  if (lane == 0) {
    best_v[warp] = v;
    best_i[warp] = at;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < ROWMAX_THREADS / 32 ? best_v[lane] : -INFINITY;
    at = lane < ROWMAX_THREADS / 32 ? best_i[lane] : NO_LANE;
    warp_argmax(v, at);
    if (lane == 0) {
      row_max[blockIdx.x] = v;
      row_arg[blockIdx.x] = at;
    }
  }
}

// one warp walks the rows backwards
__global__ void __launch_bounds__(32)
dp_backtrace_kernel(const long long* o_in, const float* __restrict__ rows,
                    const float* __restrict__ row_max,
                    const int* __restrict__ row_arg,
                    long long* __restrict__ path, long long n, int d) {
  const int lane = threadIdx.x;
  long long r = n - 1;
  int o;
  if (o_in == nullptr) {                     // the DP's last row: its argmax
    o = row_arg[r];
    if (lane == 0) path[r] = o;
    --r;
  } else {
    o = (int)*o_in;
  }
  float top = r >= 0 ? row_max[r] : 0.0f;    // neither depends on o: both
  int arg = r >= 0 ? row_arg[r] : 0;         // are loaded a row ahead
  for (; r >= 0; --r) {
    const float* row = rows + r * d;
    const int c = o - ADV;
    const float top_r = top;
    const int arg_r = arg;
    if (r > 0) {
      top = row_max[r - 1];
      arg = row_arg[r - 1];
    }
    // the window of the row AHEAD steps on, along the nominal advance
    if (r >= AHEAD && lane < 2) {
      const int j = min(max(c - ADV * AHEAD + (lane ? 8 : -8), 0), d - 1);
      asm volatile("prefetch.global.L2 [%0];\n"
                   :: "l"(row - (long long)AHEAD * d + j));
    }
    float mv = -INFINITY;
    int mi = NO_LANE;
    if (fabsf(top_r) < WINDOW_LIMIT) {
      const int j = c - WINDOW + lane;
      if (lane <= 2 * WINDOW && j >= 0 && j < d) {
        mv = __fsub_rn(row[j], SLOPE * fabsf((float)j - (float)c));
        mi = j;
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float mo = __fsub_rn(row[j], SLOPE * fabsf((float)j - (float)c));
        if (mo > mv) {
          mv = mo;
          mi = j;
        }
      }
    }
    warp_argmax(mv, mi);
    o = mv >= __fsub_rn(top_r, JUMP) ? mi : arg_r;
    if (lane == 0) path[r] = o;
  }
}

typedef void (*ForwardKernel)(const float*, const float*, float*, long long,
                              int);

ForwardKernel forward_kernel(int lanes) {
  switch (lanes) {
    case 1: return dp_forward_kernel<1>;
    case 3: return dp_forward_kernel<3>;
    case 5: return dp_forward_kernel<5>;
    case 7: return dp_forward_kernel<7>;
    case 9: return dp_forward_kernel<9>;
  }
  return nullptr;
}

// One cluster of `cluster` CTAs; refuses a shape the card cannot co-schedule.
template <typename... Args>
cudaError_t launch_cluster(void (*kernel)(Args...), int cluster, int threads,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// One DP on one cluster of `cluster` CTAs of `threads` threads. npass == 0:
// dp_forward_kernel<lanes>, each CTA a slice of threads x lanes lanes;
// npass > 0: dp_forward_wide_kernel, each CTA npass passes of threads x 9.
// The caller chooses the shape from the width (ops/coarse_dp.py).
extern "C" int dp_forward_launch(const float* prev, const float* scores,
                                 float* rows, long long n, long long d,
                                 int cluster, int threads, int lanes,
                                 int npass, void* stream) {
  if (d < 1 || d >= (1LL << 24) || n < 1 || cluster < 1 ||
      cluster > MAX_CLUSTER || (cluster & (cluster - 1)) || threads < 32 ||
      threads > MAX_THREADS || threads % 32 || npass < 0 ||
      (npass > 0 ? lanes != WIDE_L : forward_kernel(lanes) == nullptr) ||
      (long long)cluster * threads * lanes * (npass > 0 ? npass : 1) < d)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (npass > 0) {
    err = launch_cluster(dp_forward_wide_kernel, cluster, threads,
                         sizeof(float) * (size_t)npass, (cudaStream_t)stream,
                         prev, scores, rows, n, (int)d, npass);
  } else {
    const size_t s = (size_t)threads * lanes;
    const size_t smem = sizeof(float) * (2 * (s + ADV) + NST * s);
    err = launch_cluster(forward_kernel(lanes), cluster, threads, smem,
                         (cudaStream_t)stream, prev, scores, rows, n, (int)d);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// n empty steps on a cluster: the halo, the three-number exchange and the
// cluster barrier, plus `cta_barriers` __syncthreads per step
extern "C" int dp_empty_step_launch(long long n, int cluster, int threads,
                                    int cta_barriers, float* sink,
                                    void* stream) {
  const cudaError_t err =
      launch_cluster(dp_empty_step_kernel, cluster, threads, 0,
                     (cudaStream_t)stream, n, cta_barriers, sink);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// scratch: n floats (row maxima) then n ints (their first lanes)
extern "C" int dp_backtrace_launch(const long long* o_in, const float* rows,
                                   long long* path, void* scratch,
                                   long long n, long long d, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || d < 1 || d > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* row_max = (float*)scratch;
  int* row_arg = (int*)scratch + n;
  dp_rowmax_kernel<<<(unsigned)n, ROWMAX_THREADS, 0, (cudaStream_t)stream>>>(
      rows, row_max, row_arg, (int)d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dp_backtrace_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      o_in, rows, row_max, row_arg, path, n, (int)d);
  return (int)cudaGetLastError();
}
