// Fine matching pass for Hopper (sm_90a): per 210-frame audio block, the
// windowed Pearson correlations of 5 features against a 768-frame video
// band, the Naive-Bayes quality with its gates, and a top-8 per audio frame.
//
// Replaces the Pallas TPU kernel describealign_tpu/ops/fine_kernel.py
// (_kernel, launched by fine_match_fused). It computes the same function:
//   c_f(l, e) = sum_t a_f[l + t] v_f[e + t] / (|a_f|_l |v_f|_e), t < 41
//   p3 = prod_{f<3} max(1e-8, 1 - c_f);   lp = log p3
//   keep iff lp <= log(1e-8)/2.9, max(c_3, c_4) >= 0.2, e in [l, l + 558],
//            a_mask[l] > 0, v_mask[e] > 0
//   qual = min(50, 1e-4 exp(-2.9/3 lp)); top-8 by (qual desc, e asc).
// Only the TPU layout is not carried over: no 128-lane DMA windows, rolls
// or 8-sublane bundles.
//
// What bounds it on the H100: per pair about 1.7k blocks x 2 tracks x 210
// rows x 559 band columns x 5 features x 41 taps = 8e10 FMA if every
// column is scored. The video mask keeps every 4th non-quiet frame, so 3 of
// 4 columns can never pass; the kernel compacts the band's valid columns
// first and scores only those (~2e10 FMA). Each FMA reads one video value
// from shared memory (the audio value is a warp broadcast reused across the
// J columns a lane holds), so shared-memory load bandwidth, not the FP32
// pipes, is the limit; device memory traffic is small (each CTA reads ~20 KB
// of features and norms, writes 2 KB). IEEE fp32 FFMA, no tensor cores: TF32
// would put ~1e-3 error on a correlation, the size of the u8 quality step.
//
// Layout: one CTA per (block, tile of ROWS audio frames), one warp per audio
// frame at a time. The CTA stages the block's audio window, its video
// window, reciprocal norms and the compacted valid video columns in shared
// memory (~37 KB). Each lane walks the frame's in-band valid columns in
// ascending order and keeps a private sorted top-8 in registers; a warp
// merge of 8 shuffle arg-max rounds picks the frame's top-8, ties going to
// the lower column (the Pallas kernel's first-index argmax: QUAL_MAX clamps
// many candidates to equal quality). Empty slots have quality 0 and an
// unspecified offset.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 210;                 // audio frames per block
constexpr int WIN = 41;                    // correlation taps
constexpr int NF = 5;                      // feature streams
constexpr int FINE_W = 768;                // band columns per block
constexpr int BAND = 558;                  // in-band: e - l in [0, BAND]
constexpr int SEG_A = 296;                 // audio start clamp span
constexpr int SEG_V = FINE_W + WIN - 1;    // 808 video frames per band
constexpr int TOP_K = 8;
constexpr int ROWS = 32;                   // audio frames per CTA
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int AROWS = ROWS + WIN - 1;
constexpr int J = 5;                       // columns per lane per pass
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float qa, int ea, float qb, int eb) {
  return qa > qb || (qa == qb && ea < eb);
}

// first position p in cols[0, n) with cols[p] >= key
__device__ __forceinline__ int lower_bound(const int* cols, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (cols[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
fine_match_kernel(const float* __restrict__ ms_a,
                  const float* __restrict__ norms_a,
                  const float* __restrict__ a_mask,
                  const float* __restrict__ ms_v,
                  const float* __restrict__ norms_v,
                  const float* __restrict__ v_mask,
                  const int* __restrict__ v_starts,
                  const int* __restrict__ a_starts,
                  int npad, float log_cut, float exp_coef,
                  float* __restrict__ quals, int* __restrict__ offs) {
  __shared__ float s_a[NF][AROWS];
  __shared__ float s_ra[NF][ROWS];
  __shared__ float s_am[ROWS];
  __shared__ float s_v[NF][SEG_V];
  __shared__ float s_rv[NF][FINE_W];       // indexed by compacted position
  __shared__ int s_col[FINE_W];
  __shared__ int s_ncol;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, BLOCK - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // streamed chunks pad past the last real block: clamp as fine_kernel.py
  const int a0 = min(max(a_starts[b], 0), npad - SEG_A) + r0;
  const int v0 = min(max(v_starts[b], 0), npad - SEG_V);

  for (int i = tid; i < NF * AROWS; i += THREADS) {
    const int f = i / AROWS, t = i % AROWS;
    s_a[f][t] = ms_a[(size_t)f * npad + a0 + t];
  }
  for (int i = tid; i < NF * ROWS; i += THREADS) {
    const int f = i / ROWS, r = i % ROWS;
    s_ra[f][r] = 1.0f / norms_a[(size_t)f * npad + a0 + r];
  }
  for (int r = tid; r < ROWS; r += THREADS) s_am[r] = a_mask[a0 + r];
  for (int i = tid; i < NF * SEG_V; i += THREADS) {
    const int f = i / SEG_V, t = i % SEG_V;
    s_v[f][t] = ms_v[(size_t)f * npad + v0 + t];
  }
  if (warp == 0) {
    // ascending list of the band columns the video mask keeps
    int base = 0;
    for (int e0 = 0; e0 < FINE_W; e0 += 32) {
      const bool ok = v_mask[v0 + e0 + lane] > 0.0f;
      const unsigned m = __ballot_sync(FULL, ok);
      if (ok) s_col[base + __popc(m & ((1u << lane) - 1u))] = e0 + lane;
      base += __popc(m);
    }
    if (lane == 0) s_ncol = base;
  }
  __syncthreads();
  const int ncol = s_ncol;
  for (int i = tid; i < NF * ncol; i += THREADS) {
    const int f = i / ncol, p = i % ncol;
    s_rv[f][p] = 1.0f / norms_v[(size_t)f * npad + v0 + s_col[p]];
  }
  __syncthreads();

  for (int r = warp; r < nrows; r += WARPS) {
    const int l = r0 + r;
    float tq[TOP_K];
    int te[TOP_K];
#pragma unroll
    for (int k = 0; k < TOP_K; ++k) { tq[k] = 0.0f; te[k] = 0; }

    if (s_am[r] > 0.0f) {
      const int lo = lower_bound(s_col, ncol, l);
      const int hi = lower_bound(s_col, ncol, l + BAND + 1);
      for (int p0 = lo; p0 < hi; p0 += 32 * J) {
        int pos[J], col[J];
        float p3[J], bmax[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int p = p0 + 32 * j + lane;
          pos[j] = p < hi ? p : lo;
          col[j] = s_col[pos[j]];
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          float acc[J];
#pragma unroll
          for (int j = 0; j < J; ++j) acc[j] = 0.0f;
          const float* a = &s_a[f][r];
          const float* v = s_v[f];
#pragma unroll
          for (int t = 0; t < WIN; ++t) {
            const float av = a[t];
#pragma unroll
            for (int j = 0; j < J; ++j)
              acc[j] = fmaf(av, v[col[j] + t], acc[j]);
          }
          const float ra = s_ra[f][r];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float c = acc[j] * (ra * s_rv[f][pos[j]]);
            if (f == 0) p3[j] = fmaxf(1e-8f, 1.0f - c);
            else if (f < 3) p3[j] = p3[j] * fmaxf(1e-8f, 1.0f - c);
            else if (f == 3) bmax[j] = c;
            else bmax[j] = fmaxf(bmax[j], c);
          }
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (p0 + 32 * j + lane >= hi) continue;
          const float lp = logf(p3[j]);
          if (!(lp <= log_cut && bmax[j] >= 0.2f)) continue;
          const float q = fminf(50.0f, 1e-4f * expf(exp_coef * lp));
          if (q > tq[TOP_K - 1]) {
            // columns arrive in ascending order: an equal quality never
            // moves ahead of an earlier column
            tq[TOP_K - 1] = q;
            te[TOP_K - 1] = col[j];
#pragma unroll
            for (int k = TOP_K - 1; k > 0; --k) {
              if (tq[k] > tq[k - 1]) {
                const float sq = tq[k]; tq[k] = tq[k - 1]; tq[k - 1] = sq;
                const int se = te[k]; te[k] = te[k - 1]; te[k - 1] = se;
              }
            }
          }
        }
      }
    }

    float* qo = quals + ((size_t)b * BLOCK + l) * TOP_K;
    int* oo = offs + ((size_t)b * BLOCK + l) * TOP_K;
#pragma unroll
    for (int k = 0; k < TOP_K; ++k) {
      float q = tq[0];
      int e = te[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float q2 = __shfl_xor_sync(FULL, q, off);
        const int e2 = __shfl_xor_sync(FULL, e, off);
        if (better(q2, e2, q, e)) { q = q2; e = e2; }
      }
      if (lane == 0) { qo[k] = q; oo[k] = e; }
      if (q > 0.0f && tq[0] == q && te[0] == e) {
#pragma unroll
        for (int i = 0; i < TOP_K - 1; ++i) { tq[i] = tq[i + 1]; te[i] = te[i + 1]; }
        tq[TOP_K - 1] = 0.0f;
        te[TOP_K - 1] = 0;
      }
    }
  }
}

}  // namespace

// Launch over c blocks on `stream`; returns cudaGetLastError() (0 = ok).
// Inputs: ms_*, norms_* (5, npad) f32; masks (npad,) f32 0/1; v_starts,
// a_starts (c,) i32. Outputs: quals (c, 210, 8) f32, offs (c, 210, 8) i32
// in-band offsets (video frame = v_starts[b] + off).
extern "C" int fine_match_launch(const float* ms_a, const float* norms_a,
                                 const float* a_mask, const float* ms_v,
                                 const float* norms_v, const float* v_mask,
                                 const int* v_starts, const int* a_starts,
                                 long long npad, long long c, float log_cut,
                                 float exp_coef, float* quals, int* offs,
                                 void* stream) {
  if (c > 0) {
    const dim3 grid((BLOCK + ROWS - 1) / ROWS, (unsigned)c);
    fine_match_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, v_starts, a_starts,
        (int)npad, log_cut, exp_coef, quals, offs);
  }
  return (int)cudaGetLastError();
}
