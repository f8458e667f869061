// pv_phase_lock: the phase vocoder's frame recurrence as three hand-written
// kernels per block of frames.
//
// Replaces describealign_tpu/stretch/phase_vocoder.py `_pv_segment`'s
// `propagate` (60-94): a `lax.scan` over analysis frames (`:84`) that
// carries the locked synthesis phase. Per bin b and frame k:
//   mag = hypotf(z), pa = atan2f(z)                  (z the bin's value)
//   dphi = (pa - pa_prev) - omega*rate, wrapped by rintf(dphi / 2pi)
//   q = (omega*rate + dphi) / rate
//   s = the bin whose rotation b takes: the left neighbour where its
//       magnitude beats max(own, right), else the right one where it beats
//       the own, else b itself (zeros past both edges)
//   lk = pa + ((lk_prev[s] + q[s]) - pa[s])           (identity locking)
//   out = (mag cos(lk), mag sin(lk))
// Without a carry, frame 0's phases pass through (phase_vocoder.py:83-86);
// with one, every frame runs the recurrence from the carried (last pa, last
// lk), and the block's last pair is written back, so the wrapper walks
// bounded frame blocks exactly.
//
// Only lk_prev -> lk is sequential, and it is three rounded adds and a
// 3-way choice per bin. Everything else is hoisted out of the walk:
//   1. prologue (every SM; one thread per lane's run of RUN bins walking
//      PRO_FRAMES frames): hypotf, atan2f, the wrapped increment, q and
//      s, written as one record per (channel, frame) in the walk's order;
//   2. walk (one CTA per channel; WARPS = 2 walking warps, each lane a
//      contiguous run of RUN = 9 bins in registers): per frame the own
//      bins' rotations, the run edges' neighbours by one __shfl_up_sync
//      and one __shfl_down_sync, the two warps' edge values through shared
//      memory under the walking warps' own named barrier (bar.sync 1, 64:
//      not CTA-wide, the producers never take it), the choice by two byte
//      permutes, then lk, written back with coalesced 16-byte stores.
//      PRODUCERS warps stream the records into a ring of RING_STAGES
//      slots with 16-byte cp.async copies that complete on mbarriers, so
//      the walk never waits on device memory: one SM takes ~25-50 GB/s
//      through a single bulk-copy queue but ~45 GB/s for each warp issuing
//      cp.async (scripts/torch_smem_feed.cu), and the walk needs ~50.
//      A walk of one warp (runs of 17, shuffles only) measured ~15 %
//      slower, one of four warps (runs of 5) ~50 % slower (PERF.md);
//   3. epilogue (every SM; one thread per bin and frame): hypotf again
//      and the precise cosf / sinf of phases that grow to ~1e8 rad (their
//      slow path), now on 132 SMs instead of 2.
//
// Record layout: lane t owns bins t * RUN ... t * RUN + RUN - 1. A
// frame's record is one block of LANE_BYTES per lane, read as 16-byte
// vectors: per bin pa, q and a selector word, whose low and high halves
// are the byte-permute selectors that take the left and the right
// neighbour's rotation (0x7654) or keep the value (0x3210). Runs past the
// bins hold zeros and stay zero: the zeros past the edge. lk goes out as
// [channel][frame][lane][LK_RUN].
//
// What bounds it: the walk, each warp issuing ~6 instructions per bin and
// frame (two adds, two permutes, an add, the loads and stores) plus the
// exchange, times the frame count; the three passes' bytes (pv_pass_bytes
// in ops/pv_kernel.py) at 3.35 TB/s beside it. The wrapper measures an
// empty walk of the same shape (the adds, shuffles, exchanges and
// permutes, no loads) to state the floor.
//
// Arithmetic: every product, sum and quotient rounded alone (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn), precise atan2f / hypotf / cosf / sinf,
// no fast math: the same CUDA functions torch calls for the plain version
// (ops/pv_kernel.py `pv_phase_lock_plain`), in its order. Only where each
// value is computed moved, so the kernels are bit-equal to it.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_BINS = 544;      // bins the launch takes (513 live)
constexpr int WARPS = 2;           // walking warps per channel
constexpr int LANES = 32 * WARPS;
constexpr int RUN = (MAX_BINS + LANES - 1) / LANES;   // bins per lane
constexpr int VECS = (3 * RUN + 3) / 4;   // float4 per lane record
constexpr int LANE_BYTES = 16 * VECS;     // RUN (pa, q, selector) + pad
constexpr int REC = LANES * LANE_BYTES;   // bytes per frame record
constexpr int LK_RUN = (RUN + 3) / 4 * 4; // lk floats per lane
constexpr int PRO_FRAMES = 8;      // frames per prologue thread
constexpr int PRO_THREADS = 512;   // threads per prologue CTA
constexpr int CHUNK_FRAMES = 4;    // frames per ring slot
constexpr int PRODUCERS = 4;       // warps that fill the ring
// the ring's slots: a power of two (8, else 4) that fits beside the rest
constexpr int RING_STAGES = 8 * CHUNK_FRAMES * REC <= 216 * 1024 ? 8 : 4;
constexpr int WALK_SMEM = RING_STAGES * CHUNK_FRAMES * REC;
constexpr unsigned KEEP = 0x3210u, TAKE = 0x7654u;  // byte-permute selectors
constexpr float TWO_PI = 6.283185307179586f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(RING_STAGES * CHUNK_FRAMES * REC <= 216 * 1024,
              "the ring fits in shared memory");

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// ---- mbarrier and cp.async helpers (PTX, sm_90) ----
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_test(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, P1;\n\t"
      "}" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}
// the walking warps spin; a producer, mostly far ahead, backs off between
// polls so it leaves the shared-memory pipe to the walk
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  while (!mbar_test(bar, parity)) {
  }
}
__device__ __forceinline__ void mbar_wait_idle(unsigned long long* bar,
                                               unsigned parity) {
  while (!mbar_test(bar, parity)) __nanosleep(256);
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
// an arrival on bar once the lane's earlier cp.async copies have landed
__device__ __forceinline__ void arrive_on_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar)) : "memory");
}

// d = bytes of {b, a} picked by the low 16 bits of s (prmt; the selectors
// here never set a nibble's sign-mode bit, so nothing needs masking)
__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b, unsigned s) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// the walking warps' own barrier (id 1; the producers never take it)
__device__ __forceinline__ void walkers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(LANES) : "memory");
}

// One frame of the walk for one lane. lk: its run's locked phases, from
// the previous frame's to this frame's. v: the lane's record, per bin pa,
// q and the selector word. edge[frame parity][0 first / 1 last][warp]:
// the rotations at the warps' ends, double-buffered so a warp never
// overwrites a value its neighbour has still to read.
__device__ __forceinline__ void walk_frame(float (&lk)[RUN],
                                           const float (&v)[4 * VECS],
                                           float (*edge)[2][WARPS], int par,
                                           int warp, int lane) {
  float rot[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j)
    rot[j] = sub(add(lk[j], v[3 * j + 1]), v[3 * j]);
  float left = __shfl_up_sync(FULL, rot[RUN - 1], 1);
  float right = __shfl_down_sync(FULL, rot[0], 1);
  if (lane == 0) edge[par][0][warp] = rot[0];
  if (lane == 31) edge[par][1][warp] = rot[RUN - 1];
  walkers_sync();
  if (lane == 0) left = warp > 0 ? edge[par][1][warp - 1] : 0.f;
  if (lane == 31) right = warp < WARPS - 1 ? edge[par][0][warp + 1] : 0.f;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const unsigned sel = __float_as_uint(v[3 * j + 2]);
    const unsigned l = __float_as_uint(j > 0 ? rot[j - 1] : left);
    const unsigned r = __float_as_uint(j < RUN - 1 ? rot[j + 1] : right);
    const unsigned own = __float_as_uint(rot[j]);
    const unsigned dom = prmt(prmt(own, l, sel), r, sel >> 16);
    lk[j] = add(v[3 * j], __uint_as_float(dom));
  }
}

// 1. prologue: grid (frame groups, channels), CTAs of (LANES, PRO_THREADS
// / LANES) threads; thread (t, y) takes lane t's run in PRO_FRAMES frames
__global__ void __launch_bounds__(PRO_THREADS)
pv_prologue_kernel(const float2* __restrict__ spec,
                   const float* __restrict__ omega, float rate,
                   const float* __restrict__ carry_in,
                   float* __restrict__ carry_out, unsigned char* __restrict__ rec,
                   long long f, int bins) {
  const int t = threadIdx.x, ch = blockIdx.y;
  const long long k0 =
      ((long long)blockIdx.x * blockDim.y + threadIdx.y) * PRO_FRAMES;
  if (k0 >= f) return;
  const long long k1 = k0 + PRO_FRAMES < f ? k0 + PRO_FRAMES : f;
  const int b0 = t * RUN;
  float4* out = (float4*)(rec + (long long)ch * f * REC + t * LANE_BYTES);
  constexpr int stride = REC / 16;                      // float4 per record
  if (b0 >= bins) {                                     // a dead run
    for (long long k = k0; k < k1; ++k)
#pragma unroll
      for (int i = 0; i < VECS; ++i)
        out[k * stride + i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float2* sp = spec + (long long)ch * f * bins;
  const bool carried = carry_in != nullptr;
  float om[RUN], prev[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int b = b0 + j;
    om[j] = b < bins ? mul(omega[b], rate) : 0.f;       // omega * rate
    prev[j] = 0.f;
    if (b < bins) {
      if (k0 > 0) {
        const float2 z = sp[(k0 - 1) * bins + b];
        prev[j] = atan2f(z.y, z.x);
      } else if (carried) {
        prev[j] = carry_in[(long long)ch * bins + b];
      }
    }
  }
  for (long long k = k0; k < k1; ++k) {
    const float2* row = sp + k * bins;
    float m[RUN + 2], w[4 * VECS];
    m[0] = 0.f;
    if (b0 > 0) {
      const float2 z = row[b0 - 1];
      m[0] = hypotf(z.x, z.y);
    }
#pragma unroll
    for (int j = 0; j < RUN + 1; ++j) {
      const int b = b0 + j;
      float mag = 0.f, phase = 0.f;
      if (b < bins) {
        const float2 z = row[b];
        mag = hypotf(z.x, z.y);
        if (j < RUN) phase = atan2f(z.y, z.x);
      }
      m[j + 1] = mag;
      if (j < RUN) w[3 * j] = phase;
    }
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      float q = 0.f;                    // frame 0 without a carry: unused
      unsigned sel_l = KEEP, sel_r = KEEP;
      if (b0 + j < bins) {
        if (k > 0 || carried) {
          float dphi = sub(sub(w[3 * j], prev[j]), om[j]);
          dphi = sub(dphi, mul(TWO_PI, rintf(dvd(dphi, TWO_PI))));
          q = dvd(add(om[j], dphi), rate);      // per synthesis hop
        }
        const float lm = m[j], mag = m[j + 1], rm = m[j + 2];
        if (lm > fmaxf(mag, rm)) sel_l = TAKE;
        else if (rm > mag) sel_r = TAKE;
      }
      prev[j] = w[3 * j];
      w[3 * j + 1] = q;
      w[3 * j + 2] = __uint_as_float(sel_l | sel_r << 16);
    }
#pragma unroll
    for (int i = 3 * RUN; i < 4 * VECS; ++i) w[i] = 0.f;
    float4* o = out + k * stride;
#pragma unroll
    for (int i = 0; i < VECS; ++i)
      o[i] = make_float4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  }
  if (k1 == f) {
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (b0 + j < bins) carry_out[(long long)ch * bins + b0 + j] = prev[j];
  }
}

// 2. walk: one CTA per channel, WARPS walking warps and PRODUCERS warps
// that fill the ring
__global__ void __launch_bounds__(32 * (WARPS + PRODUCERS), 1)
pv_walk_kernel(const unsigned char* __restrict__ rec, float* __restrict__ lkbuf,
               const float* __restrict__ carry_in,
               float* __restrict__ carry_out, long long f, int bins) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[RING_STAGES];
  __shared__ __align__(8) unsigned long long empty[RING_STAGES];
  __shared__ float edge[2][2][WARPS];
  const int ch = blockIdx.x, nch = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (int)((f + CHUNK_FRAMES - 1) / CHUNK_FRAMES);
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING_STAGES; ++i) {
      mbar_init(&full[i], 32 * PRODUCERS);
      mbar_init(&empty[i], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= WARPS) {                  // the producers: 16 bytes a copy
    const int p = threadIdx.x - LANES;
    const unsigned char* src = rec + (long long)ch * f * REC;
    for (int c = 0; c < chunks; ++c) {
      const int st = c % RING_STAGES;
      if (c >= RING_STAGES) {
        if (lane == 0)
          mbar_wait_idle(&empty[st], (unsigned)((c / RING_STAGES - 1) & 1));
        __syncwarp();
      }
      const long long k0 = c * CHUNK_FRAMES;
      const int nf = f - k0 < CHUNK_FRAMES ? (int)(f - k0) : CHUNK_FRAMES;
      unsigned char* dst = ring + (long long)st * CHUNK_FRAMES * REC;
      const unsigned char* s = src + k0 * REC;
      for (int v = p; v < nf * (REC / 16); v += 32 * PRODUCERS)
        copy16(dst + 16 * v, s + 16 * v);
      arrive_on_copies(&full[st]);
    }
    return;
  }

  const int t = threadIdx.x;            // bins t * RUN ... t * RUN + RUN - 1
  const bool carried = carry_in != nullptr;
  float lk[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int b = t * RUN + j;
    lk[j] = carried && b < bins ? carry_in[(long long)(nch + ch) * bins + b]
                                : 0.f;
  }
  float* gout = lkbuf + (long long)ch * f * LANES * LK_RUN + t * LK_RUN;

  // the lane's record of frame kk in a ring slot
  auto load = [&](const unsigned char* base, int kk, float (&v)[4 * VECS]) {
    const float4* lr = (const float4*)(base + kk * REC + t * LANE_BYTES);
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const float4 x = lr[i];
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  };
  auto put = [&](long long k) {
    float4* o = (float4*)(gout + k * LANES * LK_RUN);
#pragma unroll
    for (int i = 0; i < LK_RUN / 4; ++i) {
      const int j = 4 * i;
      o[i] = make_float4(lk[j], j + 1 < RUN ? lk[j + 1] : 0.f,
                         j + 2 < RUN ? lk[j + 2] : 0.f,
                         j + 3 < RUN ? lk[j + 3] : 0.f);
    }
  };

  for (int c = 0; c < chunks; ++c) {
    const int st = c % RING_STAGES;
    mbar_wait(&full[st], (unsigned)((c / RING_STAGES) & 1));
    const unsigned char* base = ring + (long long)st * CHUNK_FRAMES * REC;
    const long long k0 = c * CHUNK_FRAMES;
    const int nf = f - k0 < CHUNK_FRAMES ? (int)(f - k0) : CHUNK_FRAMES;
    int kk = 0;
    float v[4 * VECS];
    if (c == 0 && !carried) {           // frame 0 passes through
      load(base, 0, v);
#pragma unroll
      for (int j = 0; j < RUN; ++j) lk[j] = v[3 * j];
      put(0);
      kk = 1;
    }
    if (kk == 0 && nf == CHUNK_FRAMES) {
      // each frame's record is loaded while the frame before is walked
      float w[4 * VECS];
      load(base, 0, v);
#pragma unroll
      for (int u = 0; u < CHUNK_FRAMES; u += 2) {
        load(base, u + 1, w);
        walk_frame(lk, v, edge, u & 1, warp, lane);
        put(k0 + u);
        if (u + 2 < CHUNK_FRAMES) load(base, u + 2, v);
        walk_frame(lk, w, edge, (u + 1) & 1, warp, lane);
        put(k0 + u + 1);
      }
    } else {
      for (; kk < nf; ++kk) {
        load(base, kk, v);
        walk_frame(lk, v, edge, kk & 1, warp, lane);
        put(k0 + kk);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int b = t * RUN + j;
    if (b < bins) carry_out[(long long)(nch + ch) * bins + b] = lk[j];
  }
}

// 3. epilogue: one CTA per (channel, frame) row, one thread per bin
__global__ void __launch_bounds__(MAX_BINS)
pv_epilogue_kernel(const float2* __restrict__ spec, float2* __restrict__ out,
                   const float* __restrict__ lkbuf, int bins) {
  const long long row = blockIdx.x;     // channel * f + frame
  const int b = threadIdx.x;
  if (b >= bins) return;
  // lk's place: [channel][frame][lane][LK_RUN]
  const float lk = lkbuf[row * LANES * LK_RUN + (b / RUN) * LK_RUN + b % RUN];
  const float2 z = spec[row * bins + b];
  const float mag = hypotf(z.x, z.y);
  out[row * bins + b] = make_float2(mul(mag, cosf(lk)), mul(mag, sinf(lk)));
}

// an empty walk of the same shape: the adds, shuffles, edge exchanges and
// permutes per frame, no loads or stores. The record's values pass an
// empty asm each frame, so nothing is hoisted out of the loop.
__global__ void __launch_bounds__(LANES, 1)
pv_empty_walk_kernel(long long f, float q0, float pa0, float* sink) {
  __shared__ float edge[2][2][WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float lk[RUN], v[4 * VECS];
#pragma unroll
  for (int i = 0; i < 4 * VECS; ++i) v[i] = 0.f;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    lk[j] = 0.f;
    v[3 * j] = pa0;
    v[3 * j + 1] = q0;
    const int s = (j + lane) % 3;
    v[3 * j + 2] = __uint_as_float(s == 0 ? (KEEP | TAKE << 16)
                                   : (s == 1 ? (TAKE | KEEP << 16)
                                             : (KEEP | KEEP << 16)));
  }
  for (long long k = 0; k < f; ++k) {
#pragma unroll
    for (int i = 0; i < 3 * RUN; ++i) asm volatile("" : "+f"(v[i]));
    walk_frame(lk, v, edge, (int)(k & 1), warp, lane);
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < RUN; ++j) acc = add(acc, lk[j]);
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

}  // namespace

extern "C" int pv_walk_warps() { return WARPS; }

// Scratch bytes pv_lock_launch needs for c channels x f frames: the
// records and the locked phases.
extern "C" long long pv_lock_scratch_bytes(long long c, long long f) {
  return c * f * (REC + 4LL * LANES * LK_RUN);
}

// spec, out: (c, f, bins) complex64 as float2; omega: (bins,); carry_in:
// (2, c, bins) - [0] the last frame's phase_a, [1] its locked phase - or
// null for a segment's first block; carry_out: (2, c, bins); scratch:
// pv_lock_scratch_bytes(c, f) bytes, 16-byte aligned. passes: a mask of
// the kernels to launch (1 prologue, 2 walk, 4 epilogue; 7 the function,
// one pass alone to time it on the scratch an earlier call filled), on
// `stream`; returns the CUDA error of the first launch that fails.
extern "C" int pv_lock_launch(const void* spec, void* out, const float* omega,
                              float rate, const float* carry_in,
                              float* carry_out, void* scratch, long long c,
                              long long f, int bins, int passes,
                              void* stream) {
  if (c < 1 || c > 65535 || f < 1 || bins < 2 || bins > MAX_BINS ||
      scratch == nullptr || ((unsigned long long)scratch & 15) ||
      c * f > 0x7fffffffLL || passes < 1 || passes > 7)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  unsigned char* rec = (unsigned char*)scratch;
  float* lkbuf = (float*)(rec + c * f * REC);
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    const int rows = PRO_THREADS / LANES;               // frame groups a CTA
    const long long groups = (f + PRO_FRAMES - 1) / PRO_FRAMES;
    pv_prologue_kernel<<<dim3((unsigned)((groups + rows - 1) / rows),
                              (unsigned)c),
                         dim3(LANES, rows), 0, st>>>(
        (const float2*)spec, omega, rate, carry_in, carry_out, rec, f, bins);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    err = cudaFuncSetAttribute(pv_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WALK_SMEM);
    if (err != cudaSuccess) return (int)err;
    pv_walk_kernel<<<(unsigned)c, 32 * (WARPS + PRODUCERS), WALK_SMEM, st>>>(
        rec, lkbuf, carry_in, carry_out, f, bins);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 4) {
    pv_epilogue_kernel<<<(unsigned)(c * f), 32 * ((bins + 31) / 32), 0, st>>>(
        (const float2*)spec, (float2*)out, lkbuf, bins);
    err = cudaGetLastError();
  }
  return (int)err;
}

// an empty walk of f frames on c CTAs of the walking warps
extern "C" int pv_empty_walk_launch(long long f, long long c, float* sink,
                                    void* stream) {
  if (f < 0 || c < 1 || c > 65535) return (int)cudaErrorInvalidValue;
  pv_empty_walk_kernel<<<(unsigned)c, LANES, 0, (cudaStream_t)stream>>>(
      f, 0.25f, 0.5f, sink);
  return (int)cudaGetLastError();
}
