// Coarse score map for Hopper (sm_90a): the 7 sub-lane phases' descriptor
// products, the skew max over each block's 10 coarse rows, the max over
// the phases and the k-best suppression, in one kernel.
//
// Replaces the XLA program of describealign_tpu/alignment/matching.py
// `_chunk_scores` (171-192) and `_block_scores_local` (194-222), with the
// streamed DP's suppression (`_coarse_dp_streamed`, 319-326):
//   S_ph = desc_a . desc_v[ph]^T                          (fp32)
//   P[b, v] = max_ph max_{p < 10} S_ph[10 b + p, v + p]   (0 where v+p >= Kv)
//   P[b, v] = -1e30 where |v - vp[b]| <= 25 for a suppress path vp.
// The 7 x (640 x Kv) products of a 64-block chunk are never written to
// device memory: one write per output element.
//
// Bound on the H100. Every S element is read by the skew max, so the work
// is 7 x 10 n x Kv x K FMA: 2.48e11 on the bench pair's map (K 128), 3.5e10
// on a film tile. In 3xTF32 each FMA is three tensor-core products: 6 FLOP
// at 495 TFLOP/s, 3.0 ms for the bench map (fp32 FFMA: 7.4 ms at 67
// TFLOP/s). The bytes (inputs once, the map once) are ~179 MB, 0.053 ms at
// 3.35 TB/s: the kernel is bound by operations. Measured, it runs at
// 23-24 % of the 3xTF32 bound (12.6 ms for the bench map, PERF.md); 16
// warps of fewer tiles, or A split once per slab in shared memory, were
// slower (scripts/torch_coarse_map.py --trial).
//
// Design:
// - One CTA of 8 warps owns 8 audio blocks (80 descriptor rows, 5 m16
//   tiles) x 240 output lanes. Per phase it computes the S sub-tile of 80
//   rows x 256 columns: the 9-column halo of the skew, rounded up to two
//   n8 tiles. A warp owns 32 of the columns (4 n8 tiles) over all 80 rows.
// - 3xTF32 mma.sync m16n8k8 (row.col, f32 += tf32 x tf32) as in
//   fine_match.cu: each value is split into hi = rna_tf32(x) and lo =
//   rna_tf32(x - hi) as its fragment is loaded; a k-step issues lo*hi +
//   hi*lo + hi*hi from a zero accumulator and adds that partial to the fp32
//   sum with an IEEE add (the tensor core truncates its sum at every mma).
//   Plain TF32 would move a score by ~1e-3.
// - The mma's k index t of a thread maps to the column 2t of a k-step and
//   t + 4 to 2t + 1, for A and B alike: the two values a thread needs are
//   adjacent, one 64-bit shared load, and the products sum over the same 8
//   columns as in k order. Row strides of 8 mod 32 words make those loads
//   conflict-free.
// - K (128, or 256 for the 5-stream retry) is streamed in slabs of 32 by
//   16-byte cp.async, double-buffered over the flattened (phase, slab)
//   sequence, so the next phase's first slab is in flight during a
//   phase's epilogue. Rows past the range and lanes past Kv are filled
//   with zeros by the copies (src-size 0).
// - The epilogue goes through shared memory: the warps store their S
//   sub-tile, then a thread per output lane takes the diagonal max over
//   the 10 rows of each of the 8 blocks and folds it into a running max
//   over the phases held in registers (phases and rows in the plain
//   version's order). After the last phase the zero-past-Kv edge (applied
//   per row read) and the suppression are lane tests, and each output is
//   written once, coalesced along the lanes.
// - The grid runs the row groups fastest, so CTAs that share a lane range
//   (and its 7 phases' descriptors) run together and find them in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PER_BLOCK = 10;         // COARSE_PER_BLOCK
constexpr int N_PHASES = 7;                // SUB_LANE_SHIFTS
constexpr int BLOCKS = 8;                  // audio blocks per CTA
constexpr int BM = BLOCKS * ROWS_PER_BLOCK;  // 80 rows
constexpr int MT = BM / 16;                // 5 m16 tiles
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WN = 4;                      // n8 tiles per warp
constexpr int BNC = WARPS * WN * 8;        // 256 computed columns
constexpr int LANES = BNC - 16;            // 240 output lanes per CTA
constexpr int KSLAB = 32;                  // K per pipeline stage
constexpr int SLAB_STRIDE = KSLAB + 8;     // 40 floats = 8 mod 32 words
constexpr int S_STRIDE = BNC + 8;          // 264 floats = 8 mod 32 words
constexpr int SUPPRESS_LANES = 25;
constexpr float NEG = -1e30f;

// dynamic shared memory: two stages of (A slab, B slab), then S
constexpr int A_STAGE = BM * SLAB_STRIDE;          // floats
constexpr int B_STAGE = BNC * SLAB_STRIDE;
constexpr int STAGE = A_STAGE + B_STAGE;
constexpr int S_OFF = 2 * STAGE;
constexpr int SMEM_BYTES = (S_OFF + BM * S_STRIDE) * 4;   // 192,000
static_assert(LANES + ROWS_PER_BLOCK - 1 <= BNC, "halo too small");
static_assert(A_STAGE % 4 == 0 && STAGE % 4 == 0 && S_OFF % 4 == 0,
              "cp.async destinations must be 16-byte aligned");

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// (hi, lo) of x
__device__ __forceinline__ float2 split_tf32(float x) {
  const float hi = tf32_rna(x);
  return make_float2(hi, tf32_rna(x - hi));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
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

__global__ void __launch_bounds__(THREADS, 1)
coarse_map_kernel(const float* __restrict__ desc_a,
                  const float* __restrict__ desc_v,
                  const int* __restrict__ sup, float* __restrict__ out,
                  int a_lim, int K, int kv, int b0, int n, int n_sup,
                  int sup_len) {
  extern __shared__ __align__(16) float smem[];
  float* s_s = smem + S_OFF;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // fragment row group
  const int t = lane & 3;                  // thread in group
  const int blk0 = blockIdx.x * BLOCKS;    // first block, relative to b0
  const int arow0 = (b0 + blk0) * ROWS_PER_BLOCK;
  const int v0 = blockIdx.y * LANES;
  const int spp = K / KSLAB;               // slabs per phase
  const int n_stages = N_PHASES * spp;

  // stage i = (phase i / spp, slab i % spp) into buffer i & 1
  auto load_stage = [&](int i) {
    const int ph = i / spp;
    const int k0 = (i - ph * spp) * KSLAB;
    float* sa = smem + (i & 1) * STAGE;
    float* sb = sa + A_STAGE;
    for (int c = tid; c < BM * (KSLAB / 4); c += THREADS) {
      const int r = c >> 3, j = c & 7;
      const int row = arow0 + r;
      const bool ok = row < a_lim;
      cp_async16(sa + r * SLAB_STRIDE + 4 * j,
                 desc_a + (size_t)(ok ? row : 0) * K + k0 + 4 * j,
                 ok ? 16 : 0);
    }
    const float* vph = desc_v + (size_t)ph * kv * K;
    for (int c = tid; c < BNC * (KSLAB / 4); c += THREADS) {
      const int col = c >> 3, j = c & 7;
      const int v = v0 + col;
      const bool ok = v < kv;
      cp_async16(sb + col * SLAB_STRIDE + 4 * j,
                 vph + (size_t)(ok ? v : 0) * K + k0 + 4 * j, ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[MT][WN][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < WN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  float best[BLOCKS];                      // running max over the phases
#pragma unroll
  for (int bl = 0; bl < BLOCKS; ++bl) best[bl] = 0.0f;

  load_stage(0);
  for (int i = 0; i < n_stages; ++i) {
    if (i + 1 < n_stages) {
      load_stage(i + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    const float* sa = smem + (i & 1) * STAGE;
    const float* sb = sa + A_STAGE + (warp * WN * 8 + g) * SLAB_STRIDE;
#pragma unroll
    for (int ks = 0; ks < KSLAB / 8; ++ks) {
      const int kk = ks * 8 + 2 * t;
      float2 bh[WN], bl[WN];
#pragma unroll
      for (int ni = 0; ni < WN; ++ni) {
        const float2 z =
            *reinterpret_cast<const float2*>(sb + ni * 8 * SLAB_STRIDE + kk);
        const float2 z0 = split_tf32(z.x), z1 = split_tf32(z.y);
        bh[ni] = make_float2(z0.x, z1.x);  // (b0, b1) hi
        bl[ni] = make_float2(z0.y, z1.y);  // (b0, b1) lo
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        // (a0, a2) of row g and (a1, a3) of row g + 8
        const float2 x = *reinterpret_cast<const float2*>(
            sa + (16 * mi + g) * SLAB_STRIDE + kk);
        const float2 y = *reinterpret_cast<const float2*>(
            sa + (16 * mi + g + 8) * SLAB_STRIDE + kk);
        const float2 a0 = split_tf32(x.x), a2 = split_tf32(x.y);
        const float2 a1 = split_tf32(y.x), a3 = split_tf32(y.y);
#pragma unroll
        for (int ni = 0; ni < WN; ++ni) {
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(d, a0.y, a1.y, a2.y, a3.y, bh[ni].x, bh[ni].y);  // lo*hi
          mma_tf32(d, a0.x, a1.x, a2.x, a3.x, bl[ni].x, bl[ni].y);  // hi*lo
          mma_tf32(d, a0.x, a1.x, a2.x, a3.x, bh[ni].x, bh[ni].y);  // hi*hi
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += d[e];
        }
      }
    }

    if ((i + 1) % spp == 0) {
      // the phase's S sub-tile to shared memory; the sums restart at 0
      const int ph = i / spp;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int ni = 0; ni < WN; ++ni) {
          const int col = warp * WN * 8 + ni * 8 + 2 * t;
          float* r0 = s_s + (16 * mi + g) * S_STRIDE + col;
          *reinterpret_cast<float2*>(r0) =
              make_float2(acc[mi][ni][0], acc[mi][ni][1]);
          *reinterpret_cast<float2*>(r0 + 8 * S_STRIDE) =
              make_float2(acc[mi][ni][2], acc[mi][ni][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
        }
      }
      __syncthreads();
      if (tid < LANES) {
        const int v = v0 + tid;
#pragma unroll
        for (int b = 0; b < BLOCKS; ++b) {
          float m = 0.0f;
#pragma unroll
          for (int p = 0; p < ROWS_PER_BLOCK; ++p) {
            // columns past Kv score 0 (the plain version's zero pad)
            const float s = v + p < kv
                ? s_s[(ROWS_PER_BLOCK * b + p) * S_STRIDE + tid + p]
                : 0.0f;
            m = p == 0 ? s : fmaxf(m, s);
          }
          best[b] = ph == 0 ? m : fmaxf(best[b], m);
        }
      }
      // the next S store comes after the trailing barrier below
    }
    __syncthreads();   // the buffer computed on is refilled next
  }

  const int v = v0 + tid;
  if (tid < LANES && v < kv) {
#pragma unroll
    for (int b = 0; b < BLOCKS; ++b) {
      const int blk = blk0 + b;
      if (blk < n) {
        float val = best[b];
        for (int q = 0; q < n_sup; ++q) {
          const int d = v - sup[(size_t)q * sup_len + b0 + blk];
          if (d <= SUPPRESS_LANES && d >= -SUPPRESS_LANES) val = NEG;
        }
        out[(size_t)blk * kv + v] = val;
      }
    }
  }
}

}  // namespace

// The kernel's tile: audio blocks and output lanes per CTA, threads per
// CTA, dynamic shared memory bytes, K per slab.
extern "C" void coarse_map_config(int* cfg) {
  cfg[0] = BLOCKS;
  cfg[1] = LANES;
  cfg[2] = THREADS;
  cfg[3] = SMEM_BYTES;
  cfg[4] = KSLAB;
}

// P[b - b0, v] for blocks b in [b0, b0 + n) on `stream`; returns a CUDA
// error code (0 = ok). desc_a: (a_rows, K) f32 with a_rows >= 10 (b0 + n);
// desc_v: (7, kv, K) f32; K a multiple of 32; both 16-byte aligned. sup:
// (n_sup, sup_len) i32 lane paths with sup_len >= b0 + n, or null with
// n_sup 0. out: (n, kv) f32.
extern "C" int coarse_map_launch(const float* desc_a, const float* desc_v,
                                 const int* sup, float* out,
                                 long long a_rows, long long K, long long kv,
                                 long long b0, long long n, long long n_sup,
                                 long long sup_len, void* stream) {
  if (K <= 0 || K % KSLAB != 0 || kv <= 0 || n <= 0 || b0 < 0
      || a_rows < ROWS_PER_BLOCK * (b0 + n) || (n_sup > 0 && !sup)
      || (n_sup > 0 && sup_len < b0 + n)
      || (kv + LANES - 1) / LANES > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      coarse_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long a_lim = ROWS_PER_BLOCK * (b0 + n);
  const dim3 grid((unsigned)((n + BLOCKS - 1) / BLOCKS),
                  (unsigned)((kv + LANES - 1) / LANES));
  coarse_map_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      desc_a, desc_v, sup, out, (int)a_lim, (int)K, (int)kv, (int)b0,
      (int)n, (int)n_sup, (int)sup_len);
  return (int)cudaGetLastError();
}
