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
// No S element is written to device memory: one write per output element.
//
// Bound on the H100. Every S element is read by the skew max, so the work
// is 7 x 10 n x Kv x K FMA: 2.48e11 on the bench pair's map (K 128), 3.5e10
// on a film tile. In 3xTF32 each FMA is three tensor-core products: 6 FLOP
// at 495 TFLOP/s, 3.0 ms for the bench map (fp32 FFMA: 7.4 ms at 67
// TFLOP/s). The bytes (inputs once, the map once) are ~179 MB, 0.053 ms at
// 3.35 TB/s: the kernel is bound by operations, and only wgmma reaches the
// tensor cores' full rate on Hopper.
//
// Design:
// - The skew is moved onto the B operand. With the audio rows grouped by
//   p = row mod 10, P_p[b, v] = (A_p . B_ph^T)[b, v + p]: a product of
//   A_p (the 64 rows 10 b + p of a 64-block tile) with the video rows
//   v + p .. is already aligned to output lanes, so the maxima over the 10
//   rows and the 7 phases are per-register fmaxf into a running max. No S
//   tile is staged and no column is computed twice.
// - A CTA owns 64 blocks (one wgmma m64) x N output lanes (the wgmma n:
//   128, or 64 for K above 128) and keeps the phase's video rows v0 ..
//   v0 + N + 8 resident in shared memory as tf32 hi and lo, K-major
//   without swizzle in planes of 4 floats (row r, column k at plane k / 4,
//   byte 16 r + 4 (k % 4)). The wgmma descriptor of the (p, k-step)
//   product starts p rows (16 p bytes) into the plane.
// - Warp specialisation, 384 threads. Producer warpgroup (40 registers):
//   warps 0 and 1 stream each consumer's A slabs (64 rows x 32 columns of
//   one p, by TMA with 128-byte swizzle, so the fragment loads are free of
//   bank conflicts) through a ring of mbarriers; warps 2-3 bring each
//   32-column slab of the next phase's video rows by TMA into a two-stage
//   raw ring and split it once into the resident hi / lo planes, slab by
//   slab, as soon as both consumers are past that slab in their last p:
//   the phase change overlaps the tail of the previous phase. Two consumer
//   warpgroups (232 registers: a partial, the sum and the running max of
//   64 x N) take alternating p (5 each) over all N lanes; consumer 1 hands
//   its running max to consumer 0 once, at the end.
// - 3xTF32 as in fine_match.cu: a consumer loads its A fragment from the
//   slab and splits it in registers (hi = cvt.rna.tf32(x), lo =
//   cvt.rna.tf32(x - hi)); a k-step of 8 issues lo*hi + hi*lo + hi*hi as
//   three wgmma from a zeroed accumulator (the tensor core truncates its
//   sum), and after wait_group 0 the partial joins the fp32 sum by an IEEE
//   add. One consumer's adds and loads run while the other's products
//   fill the tensor cores. No accumulator is read while a wgmma of its
//   warpgroup is in flight: ptxas serializes every wgmma otherwise.
// - m64n128 and not two consumers of m64n64 over half the lanes each: at
//   n64 the wgmma stream reached under half the tensor cores' rate even
//   with the adds removed (scripts/torch_coarse_map.py, PERF.md).
// - TMA's out-of-bounds fill gives the zero columns past Kv (the plain
//   version's pad) and the zero rows past block b0 + n. The suppression
//   is a lane test on the way out; each output is written once.
// - Shared memory: K <= 128, 128 lanes, 3 A slabs a consumer (224,688 B);
//   K <= 256 (the 5-stream retry), 64 lanes (217,584 B): the resident
//   planes take 8 B per row and column of K.
// - The grid runs the row tiles fastest, so CTAs that share a lane range
//   (and its 7 phases' video rows) run together and find them in L2.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PER_BLOCK = 10;         // COARSE_PER_BLOCK
constexpr int N_PHASES = 7;                // SUB_LANE_SHIFTS
constexpr int TILE_BLOCKS = 64;            // audio blocks per CTA: wgmma m64
constexpr int THREADS = 384;               // producer + 2 consumer warpgroups
constexpr int K_SLAB = 32;                 // K per TMA slab (128 bytes)
constexpr int K_MAX = 256;
constexpr int RAW_STAGES = 2;              // raw video slabs in flight
constexpr int SPLIT_THREADS = 64;          // producer warps 2-3
constexpr int CONSUMER_WARPS = 8;
constexpr int P_EACH = ROWS_PER_BLOCK / 2;   // rows p of each consumer
constexpr int SUPPRESS_LANES = 25;
constexpr float NEG = -1e30f;
constexpr int A_SLAB_BYTES = TILE_BLOCKS * K_SLAB * 4;   // 8,192
constexpr int SMEM_LIMIT = 232448;
constexpr int PRODUCER_REGS = 40;          // setmaxnreg of the warpgroups
constexpr int CONSUMER_REGS = 232;
constexpr long long WATCHDOG_CYCLES = 1LL << 32;

// Shared memory of a tile of N lanes, K <= 32 KS_MAX, A_STAGES A slabs a
// consumer: the two consumers' A rings, the raw video ring, the resident
// hi and lo planes (one SLAB_BYTES per 32 columns of K), then the
// mbarriers. Consumer 1 hands its running max to consumer 0 through the
// raw ring at the end.
template <int N_, int KS_MAX_, int A_STAGES_>
struct Tile {
  static constexpr int N = N_;             // lanes per CTA: the wgmma n
  static constexpr int KS_MAX = KS_MAX_;
  static constexpr int A_STAGES = A_STAGES_;
  static constexpr int ROWS = N + ROWS_PER_BLOCK - 1;
  static constexpr int SLAB_BYTES = ROWS * K_SLAB * 4;
  static constexpr int RAW_OFF = 2 * A_STAGES * A_SLAB_BYTES;
  static constexpr int HI_OFF = RAW_OFF + RAW_STAGES * SLAB_BYTES;
  static constexpr int LO_OFF = HI_OFF + KS_MAX * SLAB_BYTES;
  static constexpr int BAR_OFF = LO_OFF + KS_MAX * SLAB_BYTES;
  static constexpr int SMEM_BYTES =
      BAR_OFF + 8 * (4 * A_STAGES + RAW_STAGES + 2 * KS_MAX);
  // k-steps per wgmma group: the partials of a group must fit beside the
  // sum and the running max
  static constexpr int STEPS_PER_WAIT = N >= 128 ? 1 : 2;
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "tile does not fit");
  static_assert(N % 8 == 0 && ROWS <= 256, "wgmma n or TMA box");
  static_assert(RAW_STAGES * SLAB_BYTES >= TILE_BLOCKS * N * 4, "merge");
  // TMA destinations: 128-byte aligned; the swizzled A slabs 1,024
  static_assert(A_SLAB_BYTES % 1024 == 0 && SLAB_BYTES % 128 == 0, "align");
};
using TileK128 = Tile<128, 4, 3>;          // K <= 128
using TileK256 = Tile<64, 8, 3>;           // K <= 256

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// arrive and expect `bytes` from TMA on the same phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// until the phase of parity `parity` has completed; a wait of more than
// ~2 s is a fault of the pipeline's protocol, and traps rather than hangs
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin == 0)
      t0 = clock64();
    else if (clock64() - t0 > WATCHDOG_CYCLES)
      __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// until every committed wgmma group of the warpgroup has completed
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses of d across the wgmma pipeline
template <int NR>
__device__ __forceinline__ void fence_regs(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma descriptor of a K-major operand without swizzle: core matrices of
// 8 rows x 16 bytes, the next 8 rows 128 bytes on (SBO), the k-step's
// second 4 columns one plane on (LBO)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr,
                                                uint32_t plane_bytes) {
  return (uint64_t)((addr >> 4) & 0x3FFF)
         | ((uint64_t)((plane_bytes >> 4) & 0x3FFF) << 16)
         | ((uint64_t)(128 >> 4) << 32);
}

// d (+)= a . B over one k-step of 8, m64n64k8, A from registers
template <int SCALE_D>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(SCALE_D));
}

// d (+)= a . B over one k-step of 8, m64n128k8, A from registers
template <int SCALE_D>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(SCALE_D));
}

// The A fragment of k-step s4 of a slab: rows g and g + 8 of the thread's
// m16 at columns t and t + 4 of the k-step. Row r's 16-byte chunk q sits
// at chunk q ^ (r % 8) (TMA's 128-byte swizzle); `a` points at row g, t.
__device__ __forceinline__ void load_a(float (&x)[4], const float* a, int g,
                                       int s4) {
  const int q0 = ((2 * s4) ^ g) * 4, q1 = ((2 * s4 + 1) ^ g) * 4;
  x[0] = a[q0];
  x[1] = a[256 + q0];
  x[2] = a[q1];
  x[3] = a[256 + q1];
}

// One 32-column slab of a consumer's (phase, p) product, in batches of SPW
// k-steps of 8, k-step u of a batch into part[u]: its A fragment split in
// registers (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)), then lo*hi
// + hi*lo + hi*hi as three wgmma from zero. One commit per batch; the next
// batch's fragments are loaded while its products run; after wait_group
// 0 the partials join the fp32 sum in k order, one IEEE add per k-step.
// No accumulator is read while a wgmma is in flight (ptxas would
// serialize every wgmma otherwise).
template <int SPW, int NR, int PLANE, int LO>
__device__ __forceinline__ void k_slab(float (&sum)[NR], const float* a,
                                       int g, uint32_t b) {
  float x[SPW][4];
#pragma unroll
  for (int u = 0; u < SPW; ++u) load_a(x[u], a, g, u);
#pragma unroll
  for (int s0 = 0; s0 < K_SLAB / 8; s0 += SPW) {
    float part[SPW][NR];
#pragma unroll
    for (int u = 0; u < SPW; ++u) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = tf32_rna(x[u][i]);
        al[i] = tf32_rna(x[u][i] - __uint_as_float(ah[i]));
      }
      const uint32_t bk = b + 2 * (s0 + u) * PLANE;
      const uint64_t d_hi = kmajor_desc(bk, PLANE);
      const uint64_t d_lo = kmajor_desc(bk + LO, PLANE);
      wgmma_fence();
      wgmma_tf32<0>(part[u], al, d_hi);   // lo * hi
      wgmma_tf32<1>(part[u], ah, d_lo);   // + hi * lo
      wgmma_tf32<1>(part[u], ah, d_hi);   // + hi * hi
    }
    wgmma_commit();
    if (s0 + SPW < K_SLAB / 8) {
#pragma unroll
      for (int u = 0; u < SPW; ++u) load_a(x[u], a, g, s0 + SPW + u);
    }
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < SPW; ++u) {
      fence_regs(part[u]);
#pragma unroll
      for (int i = 0; i < NR; ++i) sum[i] += part[u][i];
    }
  }
}

template <int N, int KS_MAX, int A_STAGES>
__global__ void __launch_bounds__(THREADS, 1)
coarse_map_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_v,
                  const int* __restrict__ sup, float* __restrict__ out,
                  int ks, int kv, int b0, int n, int n_sup, int sup_len) {
  using T = Tile<N, KS_MAX, A_STAGES>;
  constexpr int NR = N / 2;                // accumulator registers a thread
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t bars = base + T::BAR_OFF;
  const uint32_t a_full = bars;                        // [2][A_STAGES]
  const uint32_t a_empty = a_full + 16 * A_STAGES;     // [2][A_STAGES]
  const uint32_t raw_full = a_empty + 16 * A_STAGES;   // [RAW_STAGES]
  const uint32_t b_full = raw_full + 8 * RAW_STAGES;   // [KS_MAX]
  const uint32_t b_empty = b_full + 8 * KS_MAX;        // [KS_MAX]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tile0 = blockIdx.x * TILE_BLOCKS;          // first block - b0
  const int v0 = blockIdx.y * N;
  const int b_slabs = N_PHASES * ks;                   // (phase, slab)
  const int a_slabs = P_EACH * ks;                     // a consumer's, a phase

  if (tid == 0) {
    for (int s = 0; s < 2 * A_STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, CONSUMER_WARPS / 2);
    }
    for (int s = 0; s < RAW_STAGES; ++s) mbar_init(raw_full + 8 * s, 1);
    for (int j = 0; j < KS_MAX; ++j) {
      mbar_init(b_full + 8 * j, SPLIT_THREADS);
      mbar_init(b_empty + 8 * j, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                 :: "n"(PRODUCER_REGS));
    const int warp = tid >> 5;
    if (warp < 2) {
      // warp c: consumer c's A ring, slab i = (phase, p = c + 2 (q / ks),
      // slab j = q % ks): rows 10 b + p of the tile's blocks, columns
      // [32 j, 32 j + 32); the same slabs for every phase
      if (lane == 0) {
        const int c = warp;
        const uint32_t ring = base + c * A_STAGES * A_SLAB_BYTES;
        const uint32_t full = a_full + 8 * A_STAGES * c;
        const uint32_t empty = a_empty + 8 * A_STAGES * c;
        for (int i = 0; i < N_PHASES * a_slabs; ++i) {
          const int s = i % A_STAGES, q = i % a_slabs;
          if (i >= A_STAGES) mbar_wait(empty + 8 * s, (i / A_STAGES - 1) & 1);
          mbar_expect_tx(full + 8 * s, A_SLAB_BYTES);
          tma_load_3d(ring + s * A_SLAB_BYTES, &map_a, K_SLAB * (q % ks),
                      c + 2 * (q / ks), b0 + tile0, full + 8 * s);
        }
      }
    } else {
      // video slab i = (phase, slab j): rows v0 .. v0 + ROWS - 1, columns
      // [32 j, 32 j + 32) into the raw ring, then split into the planes
      const int bt = tid - 64;
      auto load_raw = [&](int i) {
        const int s = i % RAW_STAGES;
        mbar_expect_tx(raw_full + 8 * s, T::SLAB_BYTES);
        tma_load_3d(base + T::RAW_OFF + s * T::SLAB_BYTES, &map_v,
                    K_SLAB * (i % ks), v0, i / ks, raw_full + 8 * s);
      };
      if (bt == 0)
        for (int i = 0; i < RAW_STAGES && i < b_slabs; ++i) load_raw(i);
      for (int i = 0; i < b_slabs; ++i) {
        const int ph = i / ks, j = i - ph * ks, s = i % RAW_STAGES;
        mbar_wait(raw_full + 8 * s, (i / RAW_STAGES) & 1);
        // both consumers are past slab j in their last p of the phase
        if (ph > 0) mbar_wait(b_empty + 8 * j, (ph - 1) & 1);
        const float4* src = reinterpret_cast<const float4*>(
            smem + T::RAW_OFF + s * T::SLAB_BYTES);
        float4* hi = reinterpret_cast<float4*>(smem + T::HI_OFF
                                               + j * T::SLAB_BYTES);
        float4* lo = reinterpret_cast<float4*>(smem + T::LO_OFF
                                               + j * T::SLAB_BYTES);
        // raw float4 e = (row e / 8, columns 4 (e % 8) ..) -> plane e % 8
        for (int e = bt; e < T::ROWS * (K_SLAB / 4); e += SPLIT_THREADS) {
          const float4 x = src[e];
          const int d = (e & 7) * T::ROWS + (e >> 3);
          float4 h, l;
          h.x = __uint_as_float(tf32_rna(x.x));
          h.y = __uint_as_float(tf32_rna(x.y));
          h.z = __uint_as_float(tf32_rna(x.z));
          h.w = __uint_as_float(tf32_rna(x.w));
          l.x = __uint_as_float(tf32_rna(x.x - h.x));
          l.y = __uint_as_float(tf32_rna(x.y - h.y));
          l.z = __uint_as_float(tf32_rna(x.z - h.z));
          l.w = __uint_as_float(tf32_rna(x.w - h.w));
          hi[d] = h;
          lo[d] = l;
        }
        // the planes are read by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(b_full + 8 * j);
        // every split thread is done with the raw stage before its refill
        asm volatile("bar.sync 1, %0;" :: "n"(SPLIT_THREADS) : "memory");
        if (bt == 0 && i + RAW_STAGES < b_slabs) load_raw(i + RAW_STAGES);
      }
    }
    return;
  }

  // ---- consumer warpgroups: c takes rows p = c, c + 2, .. over all lanes
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
               :: "n"(CONSUMER_REGS));
  const int c = (tid >> 7) - 1;
  const int ct = tid & 127;
  const int w = ct >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g;                 // tile rows r0 and r0 + 8
  const unsigned char* ring = smem + c * A_STAGES * A_SLAB_BYTES;
  const uint32_t full = a_full + 8 * A_STAGES * c;
  const uint32_t empty = a_empty + 8 * A_STAGES * c;
  constexpr int PLANE = 16 * T::ROWS;
  constexpr int LO = T::LO_OFF - T::HI_OFF;  // a hi plane to its lo twin
  float best[NR], sum[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) best[i] = -INFINITY;
  int ai = 0;                                // A slabs consumed
  for (int ph = 0; ph < N_PHASES; ++ph) {
    for (int pp = 0; pp < P_EACH; ++pp) {
      const int p = c + 2 * pp;
#pragma unroll
      for (int i = 0; i < NR; ++i) sum[i] = 0.0f;
      for (int j = 0; j < ks; ++j, ++ai) {
        const int s = ai % A_STAGES;
        mbar_wait(full + 8 * s, (ai / A_STAGES) & 1);
        mbar_wait(b_full + 8 * j, ph & 1);
        // A slab: row r at 32 r floats; the (p, slab) product's B: p rows
        // into the resident planes
        const float* a = reinterpret_cast<const float*>(
            ring + s * A_SLAB_BYTES) + 32 * r0 + t;
        const uint32_t b = base + T::HI_OFF + j * T::SLAB_BYTES + 16 * p;
        k_slab<T::STEPS_PER_WAIT, NR, PLANE, LO>(sum, a, g, b);
        // the slab's A is in registers and its B products are done
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty + 8 * s);
          if (pp == P_EACH - 1) mbar_arrive(b_empty + 8 * j);
        }
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) best[i] = fmaxf(best[i], sum[i]);
    }
  }

  // consumer 1's running max to consumer 0 through the raw ring (every
  // split is done once consumer 1 has seen the last phase's planes)
  float* xfer = reinterpret_cast<float*>(smem + T::RAW_OFF) + ct;
  if (c == 1) {
#pragma unroll
    for (int i = 0; i < NR; ++i) xfer[128 * i] = best[i];
  }
  asm volatile("bar.sync 2, %0;" :: "n"(2 * 128) : "memory");
  if (c == 1) return;
#pragma unroll
  for (int i = 0; i < NR; ++i) best[i] = fmaxf(best[i], xfer[128 * i]);

  // register i: row r0 + 8 ((i / 2) % 2), lane 8 (i / 4) + 2 t + i % 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int blk = tile0 + r0 + 8 * h;      // relative to b0
    if (blk >= n) continue;
    // -1e30 within SUPPRESS_LANES of each suppress path's lane
    for (int q = 0; q < n_sup; ++q) {
      const int vp = sup[(size_t)q * sup_len + b0 + blk];
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = v0 + 8 * jj + 2 * t + e - vp;
          if (d <= SUPPRESS_LANES && d >= -SUPPRESS_LANES)
            best[4 * jj + 2 * h + e] = NEG;
        }
    }
    float* orow = out + (size_t)blk * kv;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = v0 + 8 * jj + 2 * t + e;
        if (v < kv) orow[v] = best[4 * jj + 2 * h + e];
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a 3-D f32 tensor map (dims innermost first, strides of dims 1 and 2 in
// bytes, box b0 x b1 x b2); out-of-bounds elements read as zero
bool encode_3d(CUtensorMap* map, const float* ptr, cuuint64_t d0,
               cuuint64_t d1, cuuint64_t d2, cuuint64_t s1, cuuint64_t s2,
               cuuint32_t b0, cuuint32_t b1, cuuint32_t b2,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T>
int launch(const float* desc_a, const float* desc_v, const int* sup,
           float* out, long long K, long long kv, long long b0, long long n,
           long long n_sup, long long sup_len, cudaStream_t stream) {
  const auto kernel = coarse_map_kernel<T::N, T::KS_MAX, T::A_STAGES>;
  if ((kv + T::N - 1) / T::N > 65535)
    return (int)cudaErrorInvalidValue;
  // setmaxnreg.inc waits for registers the producer released: the CTA's
  // allocation at launch must cover both warpgroups' targets, or the
  // consumers would wait forever
  static const int regs = [&] {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess
               ? (attr.numRegs + 7) / 8 * 8 : 0;
  }();
  if (regs * THREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * 256)
    return (int)cudaErrorInvalidConfiguration;
  // A: (K, 10 rows p, b0 + n blocks), box 32 x 1 x 64 -> a (64, 32) slab
  // with 128-byte swizzle; video: (K, Kv, 7), box 32 x ROWS x 1
  CUtensorMap map_a, map_v;
  if (!encode_3d(&map_a, desc_a, K, ROWS_PER_BLOCK, b0 + n, 4 * K,
                 4 * ROWS_PER_BLOCK * K, K_SLAB, 1, TILE_BLOCKS,
                 CU_TENSOR_MAP_SWIZZLE_128B)
      || !encode_3d(&map_v, desc_v, K, kv, N_PHASES, 4 * K, 4 * kv * K,
                    K_SLAB, T::ROWS, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
    return -1;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + TILE_BLOCKS - 1) / TILE_BLOCKS),
                  (unsigned)((kv + T::N - 1) / T::N));
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      map_a, map_v, sup, out, (int)(K / K_SLAB), (int)kv, (int)b0, (int)n,
      (int)n_sup, (int)sup_len);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel's tiles: audio blocks per CTA, output lanes per CTA for K <=
// 128 and for K <= 256, threads per CTA, dynamic shared memory bytes of
// each tile, K per slab, the largest K.
extern "C" void coarse_map_config(int* cfg) {
  cfg[0] = TILE_BLOCKS;
  cfg[1] = TileK128::N;
  cfg[2] = TileK256::N;
  cfg[3] = THREADS;
  cfg[4] = TileK128::SMEM_BYTES;
  cfg[5] = TileK256::SMEM_BYTES;
  cfg[6] = K_SLAB;
  cfg[7] = K_MAX;
}

// P[b - b0, v] for blocks b in [b0, b0 + n) on `stream`; returns a CUDA
// error code (0 = ok), or -1 if a TMA tensor map could not be encoded.
// desc_a: (a_rows, K) f32 with a_rows >= 10 (b0 + n); desc_v: (7, kv, K)
// f32; K a multiple of 32 up to 256; both 16-byte aligned. sup: (n_sup,
// sup_len) i32 lane paths with sup_len >= b0 + n, or null with n_sup 0.
// out: (n, kv) f32.
extern "C" int coarse_map_launch(const float* desc_a, const float* desc_v,
                                 const int* sup, float* out,
                                 long long a_rows, long long K, long long kv,
                                 long long b0, long long n, long long n_sup,
                                 long long sup_len, void* stream) {
  if (K <= 0 || K % K_SLAB != 0 || K > K_MAX || kv <= 0 || n <= 0 || b0 < 0
      || a_rows < ROWS_PER_BLOCK * (b0 + n) || (n_sup > 0 && !sup)
      || (n_sup > 0 && sup_len < b0 + n)
      || ((uintptr_t)desc_a | (uintptr_t)desc_v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return K <= 4 * K_SLAB
             ? launch<TileK128>(desc_a, desc_v, sup, out, K, kv, b0, n,
                                n_sup, sup_len, s)
             : launch<TileK256>(desc_a, desc_v, sup, out, K, kv, b0, n,
                                n_sup, sup_len, s);
}
