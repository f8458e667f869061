// The coarse max-plus track DP for Hopper (sm_90a): two persistent kernels.
//
// Replaces the XLA lax.scan programs of the JAX package's coarse pass,
// describealign_tpu/alignment/matching.py: `_coarse_dp` (forward scan and
// backtrace scan) and the row loops inside `_coarse_dp_streamed`, whose
// steps are `_dp_relax` and `_dp_backstep`. (They are XLA programs, not
// Pallas kernels; in eager PyTorch each step is ~29 small launches, and a
// 27-minute pair has 1,663 steps per track, a film 6,143.)
//
// dp_forward_kernel, for r = 0..n-1 with prev = rows[r-1] (rows[-1] given):
//   prev10[j] = j < 10 ? -1e30 : prev[j - 10]
//   fwd[j]    = max_{i<=j}(prev10[i] + 0.5 i) - 0.5 j
//   bwd[j]    = max_{i>=j}(prev10[i] - 0.5 i) + 0.5 j
//   rows[r][j] = max(fwd[j], bwd[j], max(prev) - 1) + scores[r][j]
// dp_backtrace_kernel, for r = n-1..0 with o the lane chosen after row r:
//   moved[j] = rows[r][j] - 0.5 |j - (o - 10)|
//   o = max(moved) >= max(rows[r]) - 1 ? first argmax(moved)
//                                      : first argmax(rows[r])
//   path[r] = o
// (without a given o, path[n-1] is the first argmax of the last row and the
// walk starts at n-2).
//
// What bounds it. The steps are strictly sequential and each needs the
// whole previous row: two running maxima across all D lanes and a global
// max. The work per step is tiny (8 bytes and ~10 operations per lane), so
// the time is the per-step latency times n, not device memory or FLOPs:
// at 3.35 TB/s a 16.6k-lane step would move its bytes in 0.04 us.
//
// Design. One CTA of 1024 threads walks all n steps, so a whole DP is one
// launch and nothing waits on the host. The previous row is read back from
// rows[r-1] in global memory (L2 resident: a film row is 240 KB, more than
// the 227 KB of shared memory a CTA can have), visible to the whole CTA
// after __syncthreads(). Each warp owns a contiguous range of lanes, cut
// into sub-tiles of 32 x 17 = 544 lanes; in a sub-tile each thread owns 17
// consecutive lanes, so the running maxima are register loops and only the
// 32 thread aggregates need a shuffle scan. A step is:
//   1. every warp reduces, with coalesced loads, its range's max of
//      prev10 + slope and, per sub-tile, the max of prev10 - slope over the
//      later sub-tiles of its range (into shared memory);
//   2. after one barrier, it takes the carries into its range from the 32
//      warp aggregates (prefix for fwd, suffix for bwd) and the global max
//      of prev (reduced while the row before was written);
//   3. per sub-tile it stages prev10 through its own slice of shared
//      memory (coalesced global access, conflict-free 17-strided shared
//      access) into registers, scans the thread aggregates by shuffles,
//      runs bwd and fwd in registers, combines them in the slice with the
//      jump cap and the score (fetched ahead into a second slice with
//      cp.async: the only read from device memory), and stores the row
//      coalesced from the slice. A range of one sub-tile (the bench
//      pair's width) keeps prev10 in registers from step 1.
// Two barriers per step. (A first version scanned 32-lane chunks by
// shuffles, one dependent L2 round trip and five shuffle steps per chunk:
// 16.5 us per step at 16,630 lanes and 56.8 us at 61,438 on an H100.)
// The backtrace keeps a (value, lane) pair per thread for both argmaxes,
// reduced by shuffles and one barrier per step (double-buffered shared
// memory), the lower lane winning ties.
//
// Bit-equality with the plain PyTorch version: max is exact in any order;
// every add and subtract is one IEEE f32 rounding (__fadd_rn / __fsub_rn,
// never contracted); 0.5 * lane is exact. No fast-math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int ADV = 10;              // COARSE_PER_BLOCK: lanes per block
constexpr float SLOPE = 0.5f;        // DP_SLOPE_COST
constexpr float JUMP = 1.0f;         // DP_JUMP_COST
constexpr float NEG = -1e30f;        // cost shifted in below lane ADV
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_LANE = 0x7fffffff;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// prev shifted by the nominal advance
__device__ __forceinline__ float shifted(const float* prev, int j) {
  return j >= ADV ? prev[j - ADV] : NEG;
}

constexpr int T = 17;                // lanes per thread in a sub-tile; odd,
                                     // so 17-strided shared reads hit 32 banks
constexpr int SUB = 32 * T;          // lanes per sub-tile

// dynamic shared memory: [WARPS][SUB] staging of prev10 / bwd / the new
// row, [WARPS][SUB] staging of the scores, then [WARPS][nsub] suffix
// maxima; nsub = sub-tiles per warp range
extern __shared__ float dp_smem[];

// sub-tile [base, base + SUB) of the score row on its way into the warp's
// score slice, asynchronously (the row comes from device memory, the only
// read of a step that is not L2 resident)
__device__ __forceinline__ void fetch_scores(const float* srow, int base,
                                             int hi, float* sstage,
                                             int lane) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int j = base + i * 32 + lane;
    if (j < hi) {
      const unsigned dst =
          (unsigned)__cvta_generic_to_shared(sstage + i * 32 + lane);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(srow + j));
    } else {
      sstage[i * 32 + lane] = 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// prev10 of sub-tile [base, base + SUB) into registers, thread l taking
// lanes base + l T .. + T - 1 (through the warp's slice: coalesced global
// loads, conflict-free shared reads), and the thread's aggregates
__device__ __forceinline__ void load_segment(const float* prev, int base,
                                             int hi, float* stage, int lane,
                                             float (&p)[T], float& ta,
                                             float& tb) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int j = base + i * 32 + lane;
    stage[i * 32 + lane] = j < hi ? shifted(prev, j) : -INFINITY;
  }
  __syncwarp();
  const float s0 = SLOPE * (float)(base + lane * T);
  ta = -INFINITY;
  tb = -INFINITY;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    p[i] = stage[lane * T + i];
    const float s = s0 + SLOPE * (float)i;      // exact: multiples of 0.5
    ta = fmaxf(ta, __fadd_rn(p[i], s));
    tb = fmaxf(tb, __fsub_rn(p[i], s));
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
dp_forward_kernel(const float* prev0, const float* __restrict__ scores,
                  float* rows, long long n, int d, int nsub) {
  __shared__ float agg_a[WARPS], agg_b[WARPS], agg_m[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* stage = dp_smem + warp * SUB;
  float* sstage = dp_smem + (WARPS + warp) * SUB;
  float* suf_b = dp_smem + 2 * WARPS * SUB + warp * nsub;
  // trailing ranges may be empty
  const int lo = (int)min((long long)warp * nsub * SUB, (long long)d);
  const int hi = (int)min((long long)lo + (long long)nsub * SUB,
                          (long long)d);

  float m_new = -INFINITY;
  for (int j = lo + lane; j < hi; j += 32) m_new = fmaxf(m_new, prev0[j]);
  m_new = warp_max(m_new);
  if (lane == 0) agg_m[warp] = m_new;

  const float* prev = prev0;
  for (long long r = 0; r < n; ++r) {
    const float* srow = scores + r * d;
    float* out = rows + r * d;
    if (lo < hi) fetch_scores(srow, lo, hi, sstage, lane);

    // 1. this range's aggregates; per sub-tile the bwd maximum of the
    // sub-tiles after it. A range of one sub-tile keeps it in registers.
    float p[T], ta, tb;
    float la = -INFINITY, sb = -INFINITY;
    if (nsub == 1) {
      load_segment(prev, lo, hi, stage, lane, p, ta, tb);
      la = ta;
      sb = warp_max(tb);
      if (lane == 0) suf_b[0] = -INFINITY;
    } else {
      for (int k = nsub - 1; k >= 0; --k) {
        const int base = lo + k * SUB;
        if (lane == 0) suf_b[k] = sb;
        float lb = -INFINITY;
#pragma unroll
        for (int i = 0; i < T; ++i) {
          const int j = base + i * 32 + lane;
          if (j < hi) {
            const float q = shifted(prev, j);
            const float s = SLOPE * (float)j;
            la = fmaxf(la, __fadd_rn(q, s));
            lb = fmaxf(lb, __fsub_rn(q, s));
          }
        }
        sb = fmaxf(sb, warp_max(lb));
      }
    }
    la = warp_max(la);
    if (lane == 0) {
      agg_a[warp] = la;
      agg_b[warp] = sb;
    }
    __syncthreads();

    // 2. carries into this range, and the jump cap
    float carry_f = warp_max(lane < warp ? agg_a[lane] : -INFINITY);
    const float carry_b = warp_max(lane > warp ? agg_b[lane] : -INFINITY);
    const float jump = __fsub_rn(warp_max(agg_m[lane]), JUMP);

    // 3. sub-tile by sub-tile, each thread on T consecutive lanes
    m_new = -INFINITY;
    for (int k = 0; k < nsub; ++k) {
      const int base = lo + k * SUB;
      if (base >= hi) break;
      if (nsub > 1) load_segment(prev, base, hi, stage, lane, p, ta, tb);
      // exclusive prefix of ta and exclusive suffix of tb over the warp
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float ua = __shfl_up_sync(FULL, ta, off);
        const float ub = __shfl_down_sync(FULL, tb, off);
        if (lane >= off) ta = fmaxf(ta, ua);
        if (lane + off < 32) tb = fmaxf(tb, ub);
      }
      float cf = __shfl_up_sync(FULL, ta, 1);
      float cb = __shfl_down_sync(FULL, tb, 1);
      cf = fmaxf(lane == 0 ? -INFINITY : cf, carry_f);
      cb = fmaxf(lane == 31 ? -INFINITY : cb, fmaxf(suf_b[k], carry_b));
      carry_f = fmaxf(carry_f, __shfl_sync(FULL, ta, 31));
      // bwd from the right into the thread's own slots of the slice, then
      // fwd from the left, combined in place
      const int j0 = base + lane * T;
      const float s0 = SLOPE * (float)j0;
#pragma unroll
      for (int i = T - 1; i >= 0; --i) {
        const float s = s0 + SLOPE * (float)i;
        cb = fmaxf(cb, __fsub_rn(p[i], s));
        stage[lane * T + i] = __fadd_rn(cb, s);
      }
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const float s = s0 + SLOPE * (float)i;
        cf = fmaxf(cf, __fadd_rn(p[i], s));
        float v = fmaxf(fmaxf(__fsub_rn(cf, s), stage[lane * T + i]), jump);
        v = __fadd_rn(v, sstage[lane * T + i]);
        stage[lane * T + i] = v;
        if (j0 + i < hi) m_new = fmaxf(m_new, v);
      }
      __syncwarp();
      if (k + 1 < nsub && base + SUB < hi)
        fetch_scores(srow, base + SUB, hi, sstage, lane);
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int j = base + i * 32 + lane;
        if (j < hi) out[j] = stage[i * 32 + lane];
      }
      __syncwarp();
    }
    m_new = warp_max(m_new);
    // every warp has read the aggregates and written its part of rows[r]
    __syncthreads();
    if (lane == 0) agg_m[warp] = m_new;
    prev = out;
  }
}

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

__global__ void __launch_bounds__(THREADS)
dp_backtrace_kernel(const long long* o_in, const float* __restrict__ rows,
                    long long* __restrict__ path, long long n, int d) {
  // [buffer][moved / cost][warp]; buffers alternate by step, so one barrier
  // per step separates a buffer's writes from its reads two steps later
  __shared__ float best_v[2][2][WARPS];
  __shared__ int best_i[2][2][WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int buf = 0;
  // without a given lane the first step takes the first argmax of the
  // last row (its moved values are computed and ignored)
  const bool start = o_in == nullptr;
  int o = start ? 0 : (int)*o_in;
  for (long long r = n - 1; r >= 0; --r, buf ^= 1) {
    const float* row = rows + r * d;
    const bool first = start && r == n - 1;
    const float base = (float)(o - ADV);
    float mv = -INFINITY, cv = -INFINITY;
    int mi = NO_LANE, ci = NO_LANE;
#pragma unroll 4
    for (int j = threadIdx.x; j < d; j += THREADS) {
      const float c = row[j];
      const float m = __fsub_rn(c, SLOPE * fabsf((float)j - base));
      if (m > mv) {
        mv = m;
        mi = j;
      }
      if (c > cv) {
        cv = c;
        ci = j;
      }
    }
    warp_argmax(mv, mi);
    warp_argmax(cv, ci);
    if (lane == 0) {
      best_v[buf][0][warp] = mv;
      best_i[buf][0][warp] = mi;
      best_v[buf][1][warp] = cv;
      best_i[buf][1][warp] = ci;
    }
    __syncthreads();
    mv = best_v[buf][0][lane];
    mi = best_i[buf][0][lane];
    cv = best_v[buf][1][lane];
    ci = best_i[buf][1][lane];
    warp_argmax(mv, mi);
    warp_argmax(cv, ci);
    o = (!first && mv >= __fsub_rn(cv, JUMP)) ? mi : ci;
    if (threadIdx.x == 0) path[r] = o;
  }
}

}  // namespace

extern "C" int dp_forward_launch(const float* prev, const float* scores,
                                 float* rows, long long n, long long d,
                                 void* stream) {
  // sub-tiles per warp range, and the shared memory they need
  const long long nsub = ((d + WARPS - 1) / WARPS + SUB - 1) / SUB;
  const long long smem = (long long)sizeof(float) * WARPS * (2 * SUB + nsub);
  if (d < 1 || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory only after an opt-in (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      dp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dp_forward_kernel<<<1, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      prev, scores, rows, n, (int)d, (int)nsub);
  return (int)cudaGetLastError();
}

extern "C" int dp_backtrace_launch(const long long* o_in, const float* rows,
                                   long long* path, long long n, long long d,
                                   void* stream) {
  dp_backtrace_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      o_in, rows, path, n, (int)d);
  return (int)cudaGetLastError();
}
