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
// The TPU layout is not carried over: no 128-lane DMA windows, rolls or
// 8-sublane bundles.
//
// Bound on the H100. The video mask keeps every 4th non-quiet frame, so a
// row scores at most ~140 of its 559 band columns; useful work is U = sum
// over blocks and rows with a_mask > 0 of (valid band columns) x 5 x 41
// FMA, ~1.5e9 FMA per 256-block chunk (chip_smoke.py counts it from the
// masks and bands). In 3xTF32 each useful FMA is 3 tensor-core products:
// 6U FLOP / 495 TFLOP/s, ~18 us per chunk; as fp32 FFMA it would be
// 2U FLOP / 67 TFLOP/s, ~46 us. Device memory traffic is ~8 MB per chunk
// (~2.5 us at 3.35 TB/s), so the bound is operations. Measured, the kernel
// is held by shared loads and instruction issue, not by the tensor cores:
// a variant without the mma took the same time, one without the log/exp
// epilogue and top-8 ~20 % less (PERF.md).
//
// Design, against what held the FFMA version (one CTA per 32 rows, one
// shared load per FFMA) at ~4 % of its bound:
// - Tensor cores, 3xTF32: mma.sync m16n8k8 (row.col, f32 += tf32 x tf32),
//   M = audio frames (16-row tiles), N = compacted valid video columns
//   (only the n8 tiles that meet the row tile's band), K = the 41 taps
//   padded to 48 (6 k-steps; taps 41-47 are zero in the B fragment). Each
//   staged value is split once into hi = rna_tf32(x), lo = rna_tf32(x - hi)
//   and stored as a float2; a k-step issues lo*hi + hi*lo + hi*hi from a
//   zero accumulator and adds that partial to the feature's fp32 sum with
//   an IEEE add (the tensor core truncates at every mma). Plain TF32 would
//   put ~1e-3 on a correlation, the size of the u8 quality step.
// - No im2col: A(row, k) = s_a[r0 + row + k] and B(k, n) = s_v[col[n] + k]
//   are read straight from the staged windows. A is Hankel, so a k-step's
//   a0/a2 fragments are the previous step's a1/a3 and only two new float2
//   loads are issued per k-step. A warp's B loads touch ~32 consecutive
//   float2 (8 columns ~4 frames apart x 4 taps): no bank conflicts beyond
//   the two wavefronts of a 64-bit load. A thread issues 25 64-bit shared
//   loads per tile and feature for up to 164 useful FMA, ~7 per load where
//   the FFMA version had 1.
// - One CTA per block (was 7): the audio window, the video window, the
//   reciprocal norms and the masks are staged once with 16-byte cp.async
//   copies (aligned down to 16 B; the residue is carried in the index),
//   and the ballot compaction of valid columns runs once.
// - A warp walks its row tile's n8 tiles one at a time (one in flight per
//   pass measured fastest: wider passes spill or hold more registers).
//   128 registers, 89 KB of dynamic shared memory: two 224-thread CTAs per
//   SM, so a 256-block chunk is one wave on 132 SMs.
// - Epilogue in registers, in the Pallas kernel's log-space form; logf is
//   skipped where p3 exceeds the gate by more than 2^-10. In the C
//   fragment a thread holds rows g, g+8 and columns 2t, 2t+1 of every n8
//   tile, so walking the tiles in ascending order hands it its columns in
//   ascending order: a private sorted top-8 per row with insertion on a
//   strictly greater quality keeps the first column among equal qualities.
//   The 4 lanes of a quad (all columns of those rows) merge with 8 shuffle
//   arg-max rounds ordered by (quality desc, column asc). QUAL_MAX clamps
//   many candidates to equal quality, so the order is load-bearing. Empty
//   slots have quality 0 and an unspecified offset.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 210;                 // audio frames per block
constexpr int WIN = 41;                    // correlation taps
constexpr int NF = 5;                      // feature streams
constexpr int FINE_W = 768;                // band columns per block
constexpr int BAND = 558;                  // in-band: e - l in [0, BAND]
constexpr int SEG_A = 296;                 // audio start clamp span
constexpr int SEG_V = FINE_W + WIN - 1;    // 808 video frames per band
constexpr int TOP_K = 8;
constexpr int MT = (BLOCK + 15) / 16;      // 14 row tiles of 16
constexpr int KSTEPS = 6;                  // 41 taps padded to 48
constexpr int WARPS = 7;                   // 2 row tiles per warp
constexpr int THREADS = WARPS * 32;
constexpr int A_RAW = 276;                 // >= 3 + 16 * MT + 47, 4 | A_RAW
constexpr int V_RAW = 812;                 // >= 3 + SEG_V, 4 | V_RAW
constexpr unsigned FULL = 0xffffffffu;

// dynamic shared memory layout (bytes, each 16-aligned)
constexpr int OFF_RAWV = 0;                              // f32 [NF][V_RAW]
constexpr int OFF_RAWA = OFF_RAWV + NF * V_RAW * 4;      // f32 [NF][A_RAW]
constexpr int OFF_V2 = OFF_RAWA + NF * A_RAW * 4;        // f32x2 [NF][V_RAW]
constexpr int OFF_A2 = OFF_V2 + NF * V_RAW * 8;          // f32x2 [NF][A_RAW]
constexpr int OFF_RV = OFF_A2 + NF * A_RAW * 8;          // f32 [NF][FINE_W]
constexpr int OFF_RA = OFF_RV + NF * FINE_W * 4;         // f32 [NF][16 MT]
constexpr int OFF_AM = OFF_RA + NF * 16 * MT * 4;        // f32 [16 MT]
constexpr int OFF_COL = OFF_AM + 16 * MT * 4;            // i32 [FINE_W]
constexpr int OFF_NCOL = OFF_COL + FINE_W * 4;           // i32
constexpr int SMEM_BYTES = OFF_NCOL + 16;
static_assert(OFF_RAWA % 16 == 0 && OFF_V2 % 16 == 0 && OFF_A2 % 16 == 0,
              "cp.async destinations and float2 arrays must be aligned");

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

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float2 split_tf32(float x) {
  const float hi = tf32_rna(x);
  return make_float2(hi, tf32_rna(x - hi));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], float a0, float a1,
                                         float a2, float a3, float b0,
                                         float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// acc += A B in 3xTF32; A0..A3 and B0, B1 hold (hi, lo) pairs. The tensor
// core truncates its fp32 sum at every mma, so the three products of one
// k-step start from zero and the k-step's partial joins the accumulator
// by an IEEE add: passing the running sum through 18 mma would truncate it
// 18 times, a bias of ~2e-6 on a correlation.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], float2 A0,
                                           float2 A1, float2 A2, float2 A3,
                                           float2 B0, float2 B1) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(d, A0.y, A1.y, A2.y, A3.y, B0.x, B1.x);     // lo * hi
  mma_tf32(d, A0.x, A1.x, A2.x, A3.x, B0.y, B1.y);     // hi * lo
  mma_tf32(d, A0.x, A1.x, A2.x, A3.x, B0.x, B1.x);     // hi * hi
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

__device__ __forceinline__ void insert_top(float (&tq)[TOP_K],
                                           int (&te)[TOP_K], float q, int e) {
  // columns arrive in ascending order: an equal quality never moves ahead
  // of an earlier column
  if (q > tq[TOP_K - 1]) {
    tq[TOP_K - 1] = q;
    te[TOP_K - 1] = e;
#pragma unroll
    for (int k = TOP_K - 1; k > 0; --k) {
      if (tq[k] > tq[k - 1]) {
        const float sq = tq[k]; tq[k] = tq[k - 1]; tq[k - 1] = sq;
        const int se = te[k]; te[k] = te[k - 1]; te[k - 1] = se;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
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
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw_v = reinterpret_cast<float*>(smem + OFF_RAWV);
  float* raw_a = reinterpret_cast<float*>(smem + OFF_RAWA);
  float2* s_v = reinterpret_cast<float2*>(smem + OFF_V2);
  float2* s_a = reinterpret_cast<float2*>(smem + OFF_A2);
  float* s_rv = reinterpret_cast<float*>(smem + OFF_RV);
  float* s_ra = reinterpret_cast<float*>(smem + OFF_RA);
  float* s_am = reinterpret_cast<float*>(smem + OFF_AM);
  int* s_col = reinterpret_cast<int*>(smem + OFF_COL);
  int* s_ncol = reinterpret_cast<int*>(smem + OFF_NCOL);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // streamed chunks pad past the last real block: clamp as fine_kernel.py
  const int a0 = min(max(a_starts[b], 0), npad - SEG_A);
  const int v0 = min(max(v_starts[b], 0), npad - SEG_V);
  const int a_al = a0 & ~3, a_res = a0 - a_al;
  const int v_al = v0 & ~3, v_res = v0 - v_al;
  // 16-byte chunks of the video window; ends at <= npad (4 | npad)
  const int nv4 = (v_res + SEG_V + 3) >> 2;

  // --- stage: windows by cp.async, while the masks and norms are read ---
  for (int i = tid; i < NF * nv4; i += THREADS) {
    const int f = i / nv4, c = i - f * nv4;
    cp_async16(raw_v + f * V_RAW + 4 * c,
               ms_v + (size_t)f * npad + v_al + 4 * c);
  }
  for (int i = tid; i < NF * (A_RAW / 4); i += THREADS) {
    const int f = i / (A_RAW / 4), c = i - f * (A_RAW / 4);
    cp_async16(raw_a + f * A_RAW + 4 * c,
               ms_a + (size_t)f * npad + a_al + 4 * c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (warp == 0) {
    // ascending list of the band columns the video mask keeps
    int base = 0;
    for (int e0 = 0; e0 < FINE_W; e0 += 32) {
      const bool ok = v_mask[v0 + e0 + lane] > 0.0f;
      const unsigned m = __ballot_sync(FULL, ok);
      if (ok) s_col[base + __popc(m & ((1u << lane) - 1u))] = e0 + lane;
      base += __popc(m);
    }
    if (lane == 0) *s_ncol = base;
  } else {
    for (int i = tid - 32; i < NF * 16 * MT; i += THREADS - 32) {
      const int f = i / (16 * MT), r = i - f * (16 * MT);
      s_ra[i] = 1.0f / norms_a[(size_t)f * npad + a0 + r];
    }
    for (int r = tid - 32; r < 16 * MT; r += THREADS - 32)
      s_am[r] = r < BLOCK ? a_mask[a0 + r] : 0.0f;
  }
  __syncthreads();
  const int ncol = *s_ncol;
  for (int i = tid; i < NF * FINE_W; i += THREADS) {
    const int f = i / FINE_W, p = i - f * FINE_W;
    s_rv[i] = p < ncol ? 1.0f / norms_v[(size_t)f * npad + v0 + s_col[p]]
                       : 0.0f;
  }
  // padded positions read column 0: in bounds, masked in the epilogue
  for (int p = ncol + tid; p < FINE_W; p += THREADS) s_col[p] = 0;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int i = tid; i < NF * 4 * nv4; i += THREADS) {
    const int f = i / (4 * nv4), t = i - f * 4 * nv4;
    s_v[f * V_RAW + t] = split_tf32(raw_v[f * V_RAW + t]);
  }
  for (int i = tid; i < NF * A_RAW; i += THREADS)
    s_a[i] = split_tf32(raw_a[i]);
  __syncthreads();

  // --- correlations on the tensor cores, epilogue, top-8 ---------------
  // 2^-10 above the gate: far beyond logf's and expf's ulp errors, so
  // skipping logf there changes no decision
  const float p3_skip = expf(log_cut) * (1.0f + 0.0009765625f);
  const int g = lane >> 2;             // fragment row group
  const int t = lane & 3;              // thread in group
  for (int mt = warp; mt < MT; mt += WARPS) {
    const int r0 = 16 * mt;
    const int rows[2] = {r0 + g, r0 + g + 8};
    const bool row_ok[2] = {s_am[rows[0]] > 0.0f, s_am[rows[1]] > 0.0f};
    float tq[2][TOP_K];
    int te[2][TOP_K];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < TOP_K; ++k) { tq[h][k] = 0.0f; te[h][k] = 0; }

    int j0 = 0, j1 = 0;                // n8 tiles meeting the tile's band
    if (__any_sync(FULL, row_ok[0] || row_ok[1])) {
      const int r_last = min(r0 + 15, BLOCK - 1);
      j0 = lower_bound(s_col, ncol, r0) >> 3;
      j1 = (lower_bound(s_col, ncol, r_last + BAND + 1) + 7) >> 3;
    }
    for (int j = j0; j < j1; ++j) {
      // B(k, n) = s_v[v_res + col[n] + k]: (k = t, n = g) at k-step 0
      const int col_g = s_col[8 * j + g];
      float p3[4], bmax[4];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        // A(row, k) = s_a[a_res + r0 + row + k]: (g, t) at k-step 0
        const float2* sa = s_a + f * A_RAW + a_res + r0 + g + t;
        const float2* sv = s_v + f * V_RAW + v_res + col_g + t;
        float2 A0 = sa[0], A2 = sa[4];
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const float2 A1 = sa[8 * ks + 8], A3 = sa[8 * ks + 12];
          float2 B0, B1;
          if (ks < KSTEPS - 1) {
            B0 = sv[8 * ks];
            B1 = sv[8 * ks + 4];
          } else {                     // taps 40-47: only tap 40 is real
            B0 = t == 0 ? sv[8 * ks] : make_float2(0.0f, 0.0f);
            B1 = make_float2(0.0f, 0.0f);
          }
          mma_3xtf32(acc, A0, A1, A2, A3, B0, B1);
          A0 = A1;
          A2 = A3;
        }
        const float ra[2] = {s_ra[f * 16 * MT + rows[0]],
                             s_ra[f * 16 * MT + rows[1]]};
        const float2 rv =
            *reinterpret_cast<const float2*>(s_rv + f * FINE_W + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c = acc[i] * (ra[i >> 1] * (i & 1 ? rv.y : rv.x));
          if (f == 0) p3[i] = fmaxf(1e-8f, 1.0f - c);
          else if (f < 3) p3[i] = p3[i] * fmaxf(1e-8f, 1.0f - c);
          else if (f == 3) bmax[i] = c;
          else bmax[i] = fmaxf(bmax[i], c);
        }
      }
      const int pos = 8 * j + 2 * t;
      const int2 e2 = *reinterpret_cast<const int2*>(s_col + pos);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int e = i & 1 ? e2.y : e2.x;
        const int l = rows[h];
        if (!(row_ok[h] && pos + (i & 1) < ncol && e >= l && e <= l + BAND
              && bmax[i] >= 0.2f)) continue;
        if (p3[i] > p3_skip) continue;   // logf(p3) > log_cut for sure
        const float lp = logf(p3[i]);
        if (!(lp <= log_cut)) continue;
        insert_top(tq[h], te[h], fminf(50.0f, 1e-4f * expf(exp_coef * lp)),
                   e);
      }
    }

    // quad merge: lanes 4g..4g+3 hold disjoint columns of rows g, g + 8
#pragma unroll
    for (int k = 0; k < TOP_K; ++k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float q = tq[h][0];
        int e = te[h][0];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float q2 = __shfl_xor_sync(FULL, q, off);
          const int e2 = __shfl_xor_sync(FULL, e, off);
          if (better(q2, e2, q, e)) { q = q2; e = e2; }
        }
        if (t == (k & 3) && rows[h] < BLOCK) {
          const size_t o = ((size_t)b * BLOCK + rows[h]) * TOP_K + k;
          quals[o] = q;
          offs[o] = e;
        }
        if (q > 0.0f && tq[h][0] == q && te[h][0] == e) {
#pragma unroll
          for (int i = 0; i < TOP_K - 1; ++i) {
            tq[h][i] = tq[h][i + 1];
            te[h][i] = te[h][i + 1];
          }
          tq[h][TOP_K - 1] = 0.0f;
          te[h][TOP_K - 1] = 0;
        }
      }
    }
  }
}

}  // namespace

// Launch over c blocks on `stream`; returns a CUDA error code (0 = ok).
// Inputs: ms_*, norms_* (5, npad) f32 with 4 | npad and 16-byte aligned
// rows; masks (npad,) f32 0/1; v_starts, a_starts (c,) i32. Outputs: quals
// (c, 210, 8) f32, offs (c, 210, 8) i32 in-band offsets (video frame =
// v_starts[b] + off).
extern "C" int fine_match_launch(const float* ms_a, const float* norms_a,
                                 const float* a_mask, const float* ms_v,
                                 const float* norms_v, const float* v_mask,
                                 const int* v_starts, const int* a_starts,
                                 long long npad, long long c, float log_cut,
                                 float exp_coef, float* quals, int* offs,
                                 void* stream) {
  // above 48 KB of dynamic shared memory only after an opt-in (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      fine_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (c > 0) {
    fine_match_kernel<<<(unsigned)c, THREADS, SMEM_BYTES,
                        (cudaStream_t)stream>>>(
        ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, v_starts, a_starts,
        (int)npad, log_cut, exp_coef, quals, offs);
  }
  return (int)cudaGetLastError();
}
