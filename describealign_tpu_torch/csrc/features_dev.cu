// Device feature extraction for Hopper (sm_90a): int16 (or f32) PCM to the
// reference's five feature streams at 210 frames per second, in two
// kernels and two launches per stream.
//
// Replaces the XLA device programs of describealign_tpu/ops/features.py
// (energy_feature, zero_crossing_feature, _downsample_blur,
// freq_band_features, _conv_same), which the JAX package's
// matching.extract_and_match fuses into one program. The plain PyTorch
// version, ops/features.py, repeats their arithmetic in the JAX order and
// makes ~800 small launches per stream.
//
// K1 pcm_frontend: one pass over the PCM (C channels x S samples), in
// windows of FR = 16 frames of 210 samples plus an 8-sample halo on each
// side (the stage-1 FIR reaches 5 samples before the window and 5 past
// it, the sign transition 1 before it). It writes
//   energy[k]   = sum_c sum_i x_c[105k + i]^2 / (105 C), in that order
//                 (features.py:55-56);
//   crossings[j] = signbit transitions in samples 210j..210j+209 summed
//                 over channels, x2 for mono (features.py:69-81), read off
//                 the f32 sign bits; the first sample's predecessor is +0;
//   bottom[j]   = _downsample_blur(arr, 5, 3)[j] (features.py:123), and
//   band[j]     = sum_i (arr[5j + i] - bottom[j])^2 (features.py:125-129),
// where arr is the channel mean rounded to f16 for C > 1 and the one
// channel for C = 1 (features.py:108-113), zero from S - S % 210 on. The
// int16 input is rounded to f16 as it is read (matching.py:441).
//
// K2 polyphase_blur: _downsample_blur(y, ds, blur) (features.py:85-98):
// phase i convolves y[i::ds] with taps[i::ds] ("same", zero padded) around
// its centre (blur - 1) / 2, and the phase partials are added in phase
// order. ds = 1 is _conv_same itself. Prologues build y from x while
// staging: (1) y[q] = sum_i (x[r q + i] - bot[q])^2 and (2) y[q] = sum_i
// x[r q + i]^2 (stages 2 and 3, features.py:125-129). Epilogues:
// log10(1 + v) / 2 on every 2nd output (energy, features.py:57-58) and
// log10(1 + v / 210) / 2 (the bands, :130-131). One launch runs a table of
// stages (a grouped launch). A stream's cascade is one launch: energy and
// crossings smoothing, band 1, and bands 2 and 3 fused (prologue 3: their
// CTAs recompute from bottom 1 the bottom-2 values they read, so bottom 2
// never reaches device memory and bottom 1 is read once: 232 MB per bench
// pair, where two launches with bottom 2 between them moved 384 MB and
// were slower, PERF.md section 6). Prologues 1 and 2 and blur 3 serve the
// one-stage launches of polyphase_blur.
//
// Numerics: every product and every add is rounded to f32 as it is made
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: no FMA contraction), in the
// plain version's order: taps m = 0..blur-1 within a phase, phases in
// order, squares in order, channels in order. The parallelism comes from
// independent chains, never from reassociation, so the FIR outputs are
// bit-equal to the plain version; log10f is libdevice's, as torch's. No
// atomics: a pair in a batch equals the pair alone. Build without
// --use_fast_math.
//
// Bound on the H100: device-memory bytes. K1 reads 2 B per int16 sample and
// writes ~1.66 B (0.40 f32 outputs per sample); K2 must read K1's outputs
// (~1.6 B per sample) and write the five streams. Both do little
// arithmetic per byte. What held the first design back was too few bytes
// in flight: one 2- or 4-byte load per thread per staging iteration, and
// a CTA that loads, computes and exits. So:
// - K1 runs a persistent grid (the SM count x the resident CTAs). A CTA
//   walks windows blockIdx.x, + gridDim.x, ... through a ring of up to 4
//   slots of shared memory, staging window k + slots - 1 with 16-byte
//   cp.async (zero-fill for the edges) while it computes window k; the
//   samples stay int16 in the ring, converted at use. Rows that do not
//   start on 16 bytes (C > 1, S % 8 != 0 for int16) take a scalar staging
//   loop in the same kernel. Warp 0 runs the 32 energy chains and the
//   crossing counts of a window, one 105-sample block per lane; warps 1-6
//   compute stage 1 at 4 outputs per thread from a 30-sample register
//   window (20 independent 3-tap chains, then 5-add phase sums); the only
//   barrier that waits for warp 0 is the one that releases the slot.
// - K2 stages its span (and halo) in one batch of 16-byte cp.async per CTA
//   and splits every output's work into its ds phase partials: a thread
//   takes one phase of R2 = 9 consecutive outputs from a register window
//   of 9 + blur - 1 inputs (blur-tap chains, 9 in flight), writes them to
//   a phase-partial table, and one thread per output adds its partials in
//   phase order (band 1: 15 + 41 dependent adds instead of 630). Lanes
//   take neighbouring phases (neighbouring words of y) or, for ds = 1,
//   outputs 9 apart (odd: no bank conflicts).
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

// One stage of a K2 grouped launch; laid out as ops/features_kernel._Stage.
// (Outside the anonymous namespace: polyphase_group_launch takes it.)
constexpr int K2_MAX_STAGES = 4;
struct Stage {
  const float* x;          // input: y itself (prologue 0) or y's source
  const float* bot;        // prologue 1's bottom, else null
  float* out;
  const float* taps;       // the ds * blur values of hann_taps(ds*blur + 2)
  float* out2;             // prologue 3: band 3
  const float* taps2;      // prologue 3: bottom 2's 21 taps
  const float* taps3;      // prologue 3: band 3's 15 taps
  long long n;             // len(y) less len(y) % ds
  long long n_out;         // n / ds, or ceil(n / 2) for epilogue 1
  long long n_src;         // prologue 3: len(bottom 1) less len % 7
  int ds, blur, r;         // r: x values per y (prologues 1 to 3)
  int prologue;            // 0 y = x; 1 residual squares; 2 squares;
                           // 3 bands 2 and 3 off bottom 1 (fused)
  int epilogue;            // 0 none; 1 energy (stride 2); 2 band
  int per_block;           // outputs per CTA, a multiple of R2
  int first_block;         // this stage's first blockIdx.x
  int n_blocks;
};
struct StageTable {
  Stage s[K2_MAX_STAGES];
  int n;
};

namespace {

constexpr int FRAME = 210;
constexpr int FR = 16;                     // frames per K1 window
constexpr int RUN = FR * FRAME;            // 3360 samples per window
constexpr int HALO = 8;                    // K1 staging halo, each side
constexpr int STAGE = RUN + 2 * HALO;      // 3376 staged samples per row
constexpr int K1_THREADS = 224;            // warp 0 + 6 stage-1 warps
constexpr int K1_SLOTS = 4;                // ring slots, at most
constexpr int K1_SLOT_BUDGET = 108 * 1024; // ring bytes a CTA aims at
constexpr int DS1 = 5;                     // stage-1 decimation
constexpr int L1 = 15;                     // stage-1 taps: hann_taps(17)
constexpr int R1 = 4;                      // stage-1 outputs per thread
constexpr int N1 = RUN / DS1;              // 672 stage-1 outputs per window
constexpr int W1 = DS1 * (R1 + 2);         // 30-sample register window
constexpr int K2_THREADS = 256;
constexpr int R2 = 9;                      // outputs per K2 phase item
constexpr int MAX_SMEM = 227 * 1024;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most n of this thread's groups are in flight (n <= 3)
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// bytes of a 16-byte chunk of elements q, q + 1, ... that lie in [0, lim)
template <typename T>
__device__ __forceinline__ int chunk_bytes(long long q, long long lim) {
  constexpr int E = 16 / sizeof(T);
  if (q < 0 || q >= lim) return 0;
  return lim - q >= E ? 16 : (int)(lim - q) * (int)sizeof(T);
}

__device__ __forceinline__ float sample(int16_t v) {
  return __half2float(__short2half_rn(v));
}
__device__ __forceinline__ float sample(float v) { return v; }

// ------------------------------------------------------------------- K1

// Stage window w of every channel into one ring slot: slot[ch * STAGE + p]
// = row_ch[w * RUN - HALO + p], zero outside [0, S). 16-byte cp.async
// chunks where the rows start on 16 bytes (the window start always does),
// else a scalar loop.
template <typename T>
__device__ __forceinline__ void stage_window(T* slot, const T* pcm, int C,
                                             long long S, long long w,
                                             bool vec) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CHUNKS = STAGE / E;
  static_assert(STAGE % E == 0 && (HALO * sizeof(T)) % 16 == 0 &&
                    (RUN * sizeof(T)) % 16 == 0,
                "K1 windows must start on 16 bytes");
  const long long q0 = w * RUN - HALO;
  if (vec) {
    for (int k = threadIdx.x; k < C * CHUNKS; k += K1_THREADS) {
      const int ch = k / CHUNKS, kk = k - ch * CHUNKS;
      const long long q = q0 + (long long)kk * E;
      const int bytes = chunk_bytes<T>(q, S);
      const T* row = pcm + (long long)ch * S;
      cp_async16(slot + ch * STAGE + kk * E, bytes ? row + q : row, bytes);
    }
  } else {
    for (int p = threadIdx.x; p < C * STAGE; p += K1_THREADS) {
      const int ch = p / STAGE;
      const long long s = q0 + (p - ch * STAGE);
      slot[p] = (s >= 0 && s < S) ? pcm[(long long)ch * S + s] : T(0);
    }
  }
}

// Warp 0: lane k sums the squares of 105-sample block k of the window over
// the channels (channel by channel, sample by sample) and counts its sign
// transitions; lanes 2f and 2f + 1 make frame f's count.
template <typename T>
__device__ __forceinline__ void energy_crossings(const T* xs, int C,
                                                 long long w,
                                                 long long n_energy,
                                                 long long n_frames,
                                                 float* energy,
                                                 float* crossings) {
  const int lane = threadIdx.x;
  float e = 0.0f;
  int zc = 0;
  for (int ch = 0; ch < C; ++ch) {
    const T* row = xs + ch * STAGE + HALO + 105 * lane;
    unsigned sp = __float_as_uint(sample(row[-1])) >> 31;
#pragma unroll 5
    for (int i = 0; i < 105; ++i) {
      const float v = sample(row[i]);
      e = __fadd_rn(e, __fmul_rn(v, v));
      const unsigned sv = __float_as_uint(v) >> 31;
      zc += (int)(sv ^ sp);
      sp = sv;
    }
  }
  const long long k = w * (2 * FR) + lane;
  if (k < n_energy) energy[k] = __fdiv_rn(e, (float)(105 * C));
  const int pair = zc + __shfl_down_sync(0xffffffffu, zc, 1);
  const long long f = w * FR + lane / 2;
  if ((lane & 1) == 0 && f < n_frames)
    crossings[f] = (float)(C == 1 ? 2 * pair : pair);
}

// arr at staged position p: the channel mean on the f16 grid (C > 1) or
// the one channel, zero from staged position lim (the trim) on
template <typename T>
__device__ __forceinline__ float arr_at(const T* xs, int C, int p, int lim) {
  float v = sample(xs[p]);
  if (C > 1) {
    for (int ch = 1; ch < C; ++ch) v = __fadd_rn(v, sample(xs[ch * STAGE + p]));
    v = __half2float(__float2half_rn(__fdiv_rn(v, (float)C)));
  }
  return p < lim ? v : 0.0f;
}

// Warps 1-6: stage-1 thread t (< 168) takes outputs 4t..4t+3 of the window
// from a register window of arr at staged positions 20t + 3 .. 20t + 32.
// Output j's phase i reads arr[5(j+1)+i], arr[5j+i], arr[5(j-1)+i] with
// taps i, i + 5, i + 10 (3 taps per phase, centre 1).
template <typename T>
__device__ __forceinline__ void stage1(const T* xs, int C, long long w,
                                       int lim, long long n_bottom,
                                       const float (&taps)[L1],
                                       float* bottom, float* band) {
  const int t = threadIdx.x - 32;
  if (t >= N1 / R1) return;
  const long long j0 = w * N1 + R1 * t;
  if (j0 >= n_bottom) return;
  float a[W1];
#pragma unroll
  for (int m = 0; m < W1; ++m) a[m] = arr_at(xs, C, 20 * t + 3 + m, lim);
  float bo[R1], ba[R1];
#pragma unroll
  for (int r = 0; r < R1; ++r) {
    float part[DS1];
#pragma unroll
    for (int i = 0; i < DS1; ++i)
      part[i] = __fmul_rn(taps[i], a[5 * r + 10 + i]);
#pragma unroll
    for (int i = 0; i < DS1; ++i)
      part[i] = __fadd_rn(part[i], __fmul_rn(taps[i + 5], a[5 * r + 5 + i]));
#pragma unroll
    for (int i = 0; i < DS1; ++i)
      part[i] = __fadd_rn(part[i], __fmul_rn(taps[i + 10], a[5 * r + i]));
    float b = part[0];
#pragma unroll
    for (int i = 1; i < DS1; ++i) b = __fadd_rn(b, part[i]);
    float e = 0.0f;
#pragma unroll
    for (int i = 0; i < DS1; ++i) {
      const float d = __fsub_rn(a[5 * r + 5 + i], b);
      const float sq = __fmul_rn(d, d);
      e = i == 0 ? sq : __fadd_rn(e, sq);
    }
    bo[r] = b;
    ba[r] = e;
  }
  if (j0 + R1 <= n_bottom) {
    *reinterpret_cast<float4*>(bottom + j0) = make_float4(bo[0], bo[1], bo[2], bo[3]);
    *reinterpret_cast<float4*>(band + j0) = make_float4(ba[0], ba[1], ba[2], ba[3]);
  } else {
#pragma unroll
    for (int r = 0; r < R1; ++r)
      if (j0 + r < n_bottom) {
        bottom[j0 + r] = bo[r];
        band[j0 + r] = ba[r];
      }
  }
}

// At most 58 registers, so 5 CTAs fit an SM where 72 registers gave 4:
// 2-3 % faster on the bench streams (PERF.md section 6).
template <typename T>
__global__ void __launch_bounds__(K1_THREADS, 5)
pcm_frontend_kernel(const T* __restrict__ pcm, int C, long long S, int vec,
                    int slots, const float* __restrict__ taps15,
                    float* __restrict__ energy, float* __restrict__ crossings,
                    float* __restrict__ bottom, float* __restrict__ band) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  T* ring = reinterpret_cast<T*>(k1_smem);
  const int slot_elems = C * STAGE;
  const long long n_windows = (S + RUN - 1) / RUN;
  const long long n_energy = S / 105;
  const long long n_frames = S / FRAME;
  const long long s_trim = n_frames * FRAME;     // arr is zero from here
  const long long n_bottom = s_trim / DS1;
  float taps[L1];
#pragma unroll
  for (int i = 0; i < L1; ++i) taps[i] = __ldg(taps15 + i);

  long long w_next = blockIdx.x;                 // next window to stage
  for (int u = 0; u + 1 < slots; ++u) {
    if (w_next < n_windows)
      stage_window(ring + u * slot_elems, pcm, C, S, w_next, vec);
    cp_async_commit();
    w_next += gridDim.x;
  }
  int slot = 0;
  for (long long w = blockIdx.x; w < n_windows; w += gridDim.x) {
    // the slot the last iteration released takes window w + slots - 1
    const int fill = slot == 0 ? slots - 1 : slot - 1;
    if (w_next < n_windows)
      stage_window(ring + fill * slot_elems, pcm, C, S, w_next, vec);
    cp_async_commit();
    w_next += gridDim.x;
    cp_async_wait_pending(slots - 1);            // window w has landed
    __syncthreads();
    const T* xs = ring + slot * slot_elems;
    if (threadIdx.x < 32) {
      energy_crossings(xs, C, w, n_energy, n_frames, energy, crossings);
    } else {
      const long long lim = s_trim - (w * RUN - HALO);
      stage1(xs, C, w, (int)(lim < 0 ? 0 : lim > STAGE ? STAGE : lim),
             n_bottom, taps, bottom, band);
    }
    __syncthreads();                             // release the slot
    slot = slot + 1 == slots ? 0 : slot + 1;
  }
  cp_async_wait_pending(0);
}

// ------------------------------------------------------------------- K2

__host__ __device__ __forceinline__ int round4(long long n) {
  return (int)((n + 3) & ~3LL);
}
__host__ __device__ __forceinline__ int phase_stride(int ds) {
  return ds | 1;                    // odd: the phase sums read no bank twice
}

// Shared floats of one stage's CTA: taps, staged input (+3 for the 16-byte
// alignment of its first element), bottom, prologue output, partials.
__host__ __device__ __forceinline__ int stage_smem_floats(const Stage& st) {
  const int stride = st.epilogue == 1 ? 2 : 1;
  const long long span_y =
      (long long)st.ds * (stride * (st.per_block - 1) + st.blur);
  long long f = round4((long long)st.ds * st.blur);
  if (st.prologue == 3) {              // taps, bottom 1, bottom 2, y2, y3
    f += round4(21) + round4(15) + round4(7 * span_y + 14 + 3) +
         2 * round4(span_y) + round4(st.per_block + 14) + st.per_block;
  } else if (st.prologue == 0) {
    f += round4(span_y + 3);
  } else {
    f += round4(st.r * span_y + 3) + round4(span_y);
    if (st.prologue == 1) f += round4(span_y + 3);
  }
  f += (long long)st.per_block * phase_stride(st.ds);
  return f > (1 << 28) ? (1 << 28) : (int)f;
}

// dst[k] = src[a0 + k], k < n (a0 % 4 == 0), zero outside [0, lim):
// 16-byte cp.async chunks where src starts on 16 bytes, else scalar loads
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long a0, int n,
                                          long long lim) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int k = threadIdx.x; 4 * k < n; k += K2_THREADS) {
      const long long q = a0 + 4LL * k;
      const int bytes = chunk_bytes<float>(q, lim);
      cp_async16(dst + 4 * k, bytes ? src + q : src, bytes);
    }
  } else {
    for (int k = threadIdx.x; k < n; k += K2_THREADS) {
      const long long q = a0 + k;
      dst[k] = (q >= 0 && q < lim) ? src[q] : 0.0f;
    }
  }
}

// Phase i of outputs 9g .. 9g + 8 of a block, from a register window of
// Y_i[u] = s_y[ds u + i], u = STRIDE 9g .. STRIDE 9g + W - 1: R2 chains of
// BLUR taps in tap order, written to the partial table s_p[output][phase]
// (rows of ds | 1 words).
template <int BLUR, int STRIDE>
__device__ __forceinline__ void fir_item(const float* s_y,
                                         const float* s_taps, int ds, int g,
                                         int i, float* s_p) {
  constexpr int W = STRIDE * (R2 - 1) + BLUR;
  float tp[BLUR], win[W], part[R2];
#pragma unroll
  for (int m = 0; m < BLUR; ++m) tp[m] = s_taps[i + ds * m];
  const float* yb = s_y + i + ds * (STRIDE * R2 * g);
#pragma unroll
  for (int k = 0; k < W; ++k) win[k] = yb[ds * k];
#pragma unroll
  for (int r = 0; r < R2; ++r)
    part[r] = __fmul_rn(tp[0], win[STRIDE * r + BLUR - 1]);
#pragma unroll
  for (int m = 1; m < BLUR; ++m)
#pragma unroll
    for (int r = 0; r < R2; ++r)
      part[r] = __fadd_rn(part[r],
                          __fmul_rn(tp[m], win[STRIDE * r + BLUR - 1 - m]));
  const int ps = phase_stride(ds);
#pragma unroll
  for (int r = 0; r < R2; ++r) s_p[(R2 * g + r) * ps + i] = part[r];
}

// One thread per output: its phase partials in phase order, the epilogue.
__device__ __forceinline__ void phase_sum(const float* s_p, int ds, int O,
                                          long long o0, long long n_out,
                                          int epilogue, float* out) {
  const int ps = phase_stride(ds);
  for (int j = threadIdx.x; j < O; j += K2_THREADS) {
    const long long o = o0 + j;
    if (o >= n_out) break;
    const float* pj = s_p + j * ps;
    float v = pj[0];
    for (int i = 1; i < ds; ++i) v = __fadd_rn(v, pj[i]);
    if (epilogue == 2) v = __fdiv_rn(v, 210.0f);
    if (epilogue != 0) v = __fdiv_rn(log10f(__fadd_rn(1.0f, v)), 2.0f);
    out[o] = v;
  }
}

template <int BLUR, int STRIDE>
__device__ __forceinline__ void run_stage(const Stage& st, int blk,
                                          float* smem) {
  constexpr int C0 = (BLUR - 1) / 2;            // each phase's centre
  constexpr int HB = BLUR - 1 - C0;             // its taps before
  constexpr int W = STRIDE * (R2 - 1) + BLUR;   // register window
  const int tid = threadIdx.x;
  const int ds = st.ds, O = st.per_block, ps = phase_stride(ds);
  const long long o0 = (long long)blk * O;
  const int span_y = ds * (STRIDE * (O - 1) + BLUR);
  const long long q0 = (long long)ds * (STRIDE * o0 - HB);  // y of s_y[0]
  float* s_taps = smem;
  float* p = smem + round4((long long)ds * BLUR);
  for (int i = tid; i < ds * BLUR; i += K2_THREADS) s_taps[i] = st.taps[i];

  const float* s_y;
  if (st.prologue == 0) {
    const long long a0 = q0 & ~3LL;
    stage_f32(p, st.x, a0, (int)(q0 - a0) + span_y, st.n);
    s_y = p + (q0 - a0);
    p += round4(span_y + 3);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  } else {
    const int r = st.r;
    const long long xa0 = (r * q0) & ~3LL;
    stage_f32(p, st.x, xa0, (int)(r * q0 - xa0) + r * span_y,
              (long long)r * st.n);
    const float* s_x = p + (r * q0 - xa0);
    p += round4((long long)r * span_y + 3);
    const float* s_b = nullptr;
    if (st.prologue == 1) {
      const long long ba0 = q0 & ~3LL;
      stage_f32(p, st.bot, ba0, (int)(q0 - ba0) + span_y, st.n);
      s_b = p + (q0 - ba0);
      p += round4(span_y + 3);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float* s_w = p;
    p += round4(span_y);
    for (int k = tid; k < span_y; k += K2_THREADS) {
      const long long q = q0 + k;
      float v = 0.0f;
      if (q >= 0 && q < st.n) {
        const float b = s_b ? s_b[k] : 0.0f;
        for (int i = 0; i < r; ++i) {
          const float d = __fsub_rn(s_x[r * k + i], b);
          const float sq = __fmul_rn(d, d);
          v = i == 0 ? sq : __fadd_rn(v, sq);
        }
      }
      s_w[k] = v;
    }
    __syncthreads();
    s_y = s_w;
  }

  float* s_p = p;
  for (int it = tid; it < ds * (O / R2); it += K2_THREADS)
    fir_item<BLUR, STRIDE>(s_y, s_taps, ds, it / ds, it % ds, s_p);
  __syncthreads();
  phase_sum(s_p, ds, O, o0, st.n_out, st.epilogue, st.out);
}

// Prologue 3, bands 2 and 3 in one CTA without bottom 2 in device memory:
// outputs o0 .. o0 + O - 1 of both read bottom 2 at q = 6 o0 - 42 ..
// 6 (o0 + O) + 41, which the CTA recomputes from its bottom-1 span (7 q - 7
// .. 7 q + 13) as the bottom-2 stage does (7 phases of 3 taps, in order):
// the same values, so the bands are bit-equal to the two-level cascade's.
__device__ __forceinline__ void run_fused_bands(const Stage& st, int blk,
                                                float* smem) {
  const int tid = threadIdx.x;
  const int O = st.per_block;
  const long long o0 = (long long)blk * O;
  const long long n2 = st.n_src / 7;            // bottom 2's length
  const long long n3 = n2 / 6;                  // band 3's y length
  const int span2 = 6 * (O - 1 + 15);           // bottom 2, y2
  const int span3 = O + 14;                     // y3
  const long long q2 = 6 * o0 - 42, q3 = o0 - 7, q1 = 7 * q2 - 7;
  float* s_t2 = smem;                           // band 2's 90 taps
  float* s_tb = s_t2 + round4(90);              // bottom 2's 21
  float* s_t3 = s_tb + round4(21);              // band 3's 15
  float* p = s_t3 + round4(15);
  for (int i = tid; i < 90; i += K2_THREADS) s_t2[i] = st.taps[i];
  if (tid < 21) s_tb[tid] = st.taps2[tid];
  if (tid < 15) s_t3[tid] = st.taps3[tid];
  const long long a1 = q1 & ~3LL;
  stage_f32(p, st.x, a1, (int)(q1 - a1) + 7 * span2 + 14, st.n_src);
  const float* s_b1 = p + (q1 - a1);            // bottom 1 from q1
  p += round4(7 * span2 + 14 + 3);
  float* s_b2 = p;
  p += round4(span2);
  float* s_y2 = p;
  p += round4(span2);
  float* s_y3 = p;
  p += round4(span3);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int k = tid; k < span2; k += K2_THREADS) {
    // bottom 2 at q2 + k: phase i reads bottom 1 at 7 (q + 1 - m) + i
    const float* b = s_b1 + 7 * k + 7;          // bottom 1 at 7 q
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      float part = __fmul_rn(s_tb[i], b[7 + i]);
      part = __fadd_rn(part, __fmul_rn(s_tb[i + 7], b[i]));
      part = __fadd_rn(part, __fmul_rn(s_tb[i + 14], b[i - 7]));
      v = i == 0 ? part : __fadd_rn(v, part);
    }
    const long long q = q2 + k;
    s_b2[k] = (q >= 0 && q < n2) ? v : 0.0f;
  }
  __syncthreads();
  for (int k = tid; k < span2 + span3; k += K2_THREADS) {
    float v = 0.0f;
    if (k < span2) {                            // y2: residual squares
      const long long q = q2 + k;
      if (q >= 0 && q < st.n) {
        const float* b = s_b1 + 7 * k + 7;
#pragma unroll
        for (int i = 0; i < 7; ++i) {
          const float d = __fsub_rn(b[i], s_b2[k]);
          const float sq = __fmul_rn(d, d);
          v = i == 0 ? sq : __fadd_rn(v, sq);
        }
      }
      s_y2[k] = v;
    } else {                                    // y3: squares of bottom 2
      const int k3 = k - span2;
      const long long q = q3 + k3;
      if (q >= 0 && q < n3) {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float d = __fsub_rn(s_b2[6 * k3 + i], 0.0f);
          const float sq = __fmul_rn(d, d);
          v = i == 0 ? sq : __fadd_rn(v, sq);
        }
      }
      s_y3[k3] = v;
    }
  }
  __syncthreads();
  float* s_p2 = p;                              // [O][7]
  float* s_p3 = p + O * phase_stride(6);        // [O][1]
  const int items2 = 6 * (O / R2);
  for (int it = tid; it < items2 + O / R2; it += K2_THREADS) {
    if (it < items2)
      fir_item<15, 1>(s_y2, s_t2, 6, it / 6, it % 6, s_p2);
    else
      fir_item<15, 1>(s_y3, s_t3, 1, it - items2, 0, s_p3);
  }
  __syncthreads();
  phase_sum(s_p2, 6, O, o0, st.n_out, 2, st.out);
  phase_sum(s_p3, 1, O, o0, st.n_out, 2, st.out2);
}

__global__ void __launch_bounds__(K2_THREADS)
polyphase_group_kernel(const __grid_constant__ StageTable tab) {
  extern __shared__ __align__(16) float k2_smem[];
  int s = 0;
  while (s + 1 < tab.n && (int)blockIdx.x >= tab.s[s + 1].first_block) ++s;
  const Stage& st = tab.s[s];
  const int blk = (int)blockIdx.x - st.first_block;
  if (st.prologue == 3) {
    run_fused_bands(st, blk, k2_smem);
  } else if (st.epilogue == 1) {
    run_stage<13, 2>(st, blk, k2_smem);
  } else if (st.blur == 13) {
    run_stage<13, 1>(st, blk, k2_smem);
  } else if (st.blur == 15) {
    run_stage<15, 1>(st, blk, k2_smem);
  } else {
    run_stage<3, 1>(st, blk, k2_smem);
  }
}

bool stage_ok(const Stage& st) {
  const bool kind =
      st.prologue == 3
          ? (st.ds == 6 && st.blur == 15 && st.r == 7 && st.epilogue == 2 &&
             st.out2 && st.taps2 && st.taps3 && st.n_src % 7 == 0 &&
             st.n == st.n_src / 7 - st.n_src / 7 % 6)
      : st.epilogue == 1 ? (st.blur == 13 && st.ds == 1)
                         : (st.blur == 13 || st.blur == 15 || st.blur == 3);
  return kind && st.ds >= 1 && st.x && st.out && st.taps && st.n >= 0 &&
         st.per_block >= R2 && st.per_block % R2 == 0 && st.n_blocks >= 0 &&
         (st.prologue == 0 || st.r >= 1) && (st.prologue != 1 || st.bot) &&
         st.prologue >= 0 && st.prologue <= 3 && st.epilogue >= 0 &&
         st.epilogue <= 2 &&
         (long long)st.n_blocks * st.per_block >= st.n_out;
}

}  // namespace

// The launchers' per-device state, so that a launch costs the host no more
// than the kernel costs the card: the dynamic shared bytes each kernel is
// allowed (cudaFuncSetAttribute, raised only when a launch needs more) and
// K1's shape per (int16 or f32, C) for C <= K1_CACHED_C.
constexpr int MAX_DEVICES = 64;
constexpr int K1_CACHED_C = 8;
struct K1Shape {
  int slots, smem, per_sm;      // per_sm 0: not computed yet
};
static std::mutex g_mu;
static int g_smem_allowed[MAX_DEVICES][3];  // K1 f32, K1 int16, K2
static K1Shape g_k1[MAX_DEVICES][2][K1_CACHED_C + 1];

// Allow `fn` (kernel slot `which` of g_smem_allowed) `smem` dynamic shared
// bytes on the current device, once per device for the largest seen.
static cudaError_t allow_smem(const void* fn, int which, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mu);
  int* allowed = dev < MAX_DEVICES ? &g_smem_allowed[dev][which] : nullptr;
  if (allowed && *allowed >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && allowed) *allowed = smem;
  return err;
}

// K1's ring and occupancy for C channels of int16 (is_i16) or f32: the
// slots that fit K1_SLOT_BUDGET (1 to 4), the dynamic shared bytes, the
// kernel, and the resident CTAs per SM, cached per device. Returns a CUDA
// error code.
static int k1_shape(int is_i16, int C, int* slots, int* smem,
                    const void** fn, int* per_sm) {
  const long long slot_bytes = (long long)C * STAGE * (is_i16 ? 2 : 4);
  if (C <= 0 || slot_bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  *fn = is_i16 ? (const void*)pcm_frontend_kernel<int16_t>
               : (const void*)pcm_frontend_kernel<float>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  K1Shape* cached = dev < MAX_DEVICES && C <= K1_CACHED_C
                        ? &g_k1[dev][is_i16 ? 1 : 0][C]
                        : nullptr;
  if (cached) {
    std::lock_guard<std::mutex> lock(g_mu);
    if (cached->per_sm > 0) {
      *slots = cached->slots;
      *smem = cached->smem;
      *per_sm = cached->per_sm;
      return 0;
    }
  }
  const int n = (int)(K1_SLOT_BUDGET / slot_bytes);
  *slots = n < 1 ? 1 : n > K1_SLOTS ? K1_SLOTS : n;
  *smem = (int)(*slots * slot_bytes);
  err = allow_smem(*fn, is_i16 ? 1 : 0, *smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, *fn,
                                                        K1_THREADS, *smem);
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess && cached) {
    std::lock_guard<std::mutex> lock(g_mu);
    *cached = K1Shape{*slots, *smem, *per_sm};
  }
  return (int)err;
}

// K1 over (C, S) PCM, contiguous rows; is_i16: int16 (rounded to f16 on
// load) or f32 samples. taps15: hann_taps(17), 15 values, on the device;
// num_sms: the card's SM count. Outputs: energy (S / 105), crossings
// (S / 210), bottom and band (S / 210 * 42), each starting on 16 bytes.
// Returns a CUDA error code (0 = ok).
extern "C" int pcm_frontend_launch(const void* pcm, int is_i16, int C,
                                   long long S, const float* taps15,
                                   float* energy, float* crossings,
                                   float* bottom, float* band, int num_sms,
                                   void* stream) {
  const long long windows = (S + RUN - 1) / RUN;
  if (windows <= 0 || C <= 0) return (int)cudaGetLastError();
  if ((reinterpret_cast<uintptr_t>(bottom) & 15) ||
      (reinterpret_cast<uintptr_t>(band) & 15) || num_sms <= 0)
    return (int)cudaErrorInvalidValue;
  int slots, smem, per_sm;
  const void* fn;
  const int rc = k1_shape(is_i16, C, &slots, &smem, &fn, &per_sm);
  if (rc != 0) return rc;
  const int elem = is_i16 ? 2 : 4;
  const int vec = (reinterpret_cast<uintptr_t>(pcm) & 15) == 0 &&
                  (C == 1 || (S * elem) % 16 == 0);
  const long long grid_max = (long long)num_sms * per_sm;
  const unsigned grid = (unsigned)(windows < grid_max ? windows : grid_max);
  if (is_i16)
    pcm_frontend_kernel<int16_t><<<grid, K1_THREADS, smem,
                                   (cudaStream_t)stream>>>(
        (const int16_t*)pcm, C, S, vec, slots, taps15, energy, crossings,
        bottom, band);
  else
    pcm_frontend_kernel<float><<<grid, K1_THREADS, smem,
                                 (cudaStream_t)stream>>>(
        (const float*)pcm, C, S, vec, slots, taps15, energy, crossings,
        bottom, band);
  return (int)cudaGetLastError();
}

// K1's ring slots and resident CTAs per SM for C channels (is_i16 or
// f32), as pcm_frontend_launch takes them. Returns a CUDA error code.
extern "C" int pcm_frontend_config(int is_i16, int C, int* slots,
                                   int* per_sm) {
  int smem;
  const void* fn;
  return k1_shape(is_i16, C, slots, &smem, &fn, per_sm);
}

// K2: one grouped launch of n_stages (<= 4) stages, CTAs first_block ..
// first_block + n_blocks - 1 for each, in order and without gaps. Returns
// a CUDA error code (0 = ok).
extern "C" int polyphase_group_launch(const Stage* stages, int n_stages,
                                      void* stream) {
  if (n_stages < 1 || n_stages > K2_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  StageTable tab;
  tab.n = n_stages;
  int smem_floats = 0;
  long long blocks = 0;
  for (int s = 0; s < n_stages; ++s) {
    tab.s[s] = stages[s];
    if (!stage_ok(stages[s]) || stages[s].first_block != blocks)
      return (int)cudaErrorInvalidValue;
    blocks += stages[s].n_blocks;
    const int f = stage_smem_floats(stages[s]);
    smem_floats = f > smem_floats ? f : smem_floats;
  }
  const long long smem = 4LL * smem_floats;
  if (smem > MAX_SMEM || blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  const cudaError_t err =
      allow_smem((const void*)polyphase_group_kernel, 2, (int)smem);
  if (err != cudaSuccess) return (int)err;
  polyphase_group_kernel<<<(unsigned)blocks, K2_THREADS, (size_t)smem,
                           (cudaStream_t)stream>>>(tab);
  return (int)cudaGetLastError();
}
