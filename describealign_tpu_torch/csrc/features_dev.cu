// Device feature extraction for Hopper (sm_90a): int16 (or f32) PCM to the
// reference's five feature streams at 210 frames per second, in two
// kernels.
//
// Replaces the XLA device programs of describealign_tpu/ops/features.py
// (energy_feature, zero_crossing_feature, _downsample_blur,
// freq_band_features, _conv_same), which the JAX package's
// matching.extract_and_match fuses into one program. The plain PyTorch
// version, ops/features.py, repeats their arithmetic in the JAX order and
// makes ~800 small launches per stream; these kernels make 7.
//
// K1 pcm_frontend: one pass over the PCM (C channels x S samples). A
// thread block takes FR = 16 frames of 210 samples, plus a 16-sample halo
// on each side (the stage-1 FIR reaches 5 samples before the run and 5
// past it, the sign transition 1 before it), one channel at a time. It
// writes
//   energy[k]   = sum_c sum_i x_c[105k + i]^2 / (105 C), in that order
//                 (features.py:55-56);
//   crossings[j] = signbit transitions in samples 210j..210j+209 summed
//                 over channels, x2 for mono (features.py:69-81), read off
//                 the f32 sign bits; the first sample's predecessor is +0,
//                 whose signbit is false;
//   bottom[j]   = _downsample_blur(arr, 5, 3)[j] (features.py:123), and
//   band[j]     = sum_i (arr[5j + i] - bottom[j])^2 (features.py:125-129),
// where arr is the channel mean rounded to f16 for C > 1 and the one
// channel for C = 1 (features.py:108-113), zero from S - S % 210 on. The
// int16 input is rounded to f16 first (matching.py:441). The full-rate
// f32 arr and the per-phase temporaries never reach device memory.
//
// K2 polyphase_blur: _downsample_blur(y, ds, blur) (features.py:85-98) for
// any ds and blur: phase i convolves y[i::ds] with taps[i::ds] ("same",
// zero padded) around its own centre (t_i - 1) / 2, t_i = ceil((L - i) /
// ds), and the phase partials are added in phase order. ds = 1 is
// _conv_same itself. Prologues build y from x on the fly while staging:
// (a) y[q] = sum_i (x[r q + i] - bottom[q])^2 and (b) y[q] = sum_i
// x[r q + i]^2 (stage 2 and stage 3, features.py:125-129). Epilogues:
// log10(1 + v) / 2 on every 2nd output (energy, features.py:57-58) and
// log10(1 + v / 210) / 2 (the bands, :130-131).
//
// Numerics: every product and every add is rounded to f32 as it is made
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: no FMA contraction), in the
// plain version's order: taps m = 0..t-1 within a phase, phases in order,
// squares in order. The FIR outputs are then bit-equal to the plain
// version on the card; log10f is libdevice's, as torch's. No atomics:
// runs are deterministic and a pair in a batch equals the pair alone.
// Build without --use_fast_math.
//
// Bound on the H100: both kernels move bytes and do little arithmetic
// (~20 flop per sample in K1, at most 1,260 per output of the 630-tap
// band-1 stage, which has one output per 210 samples). K1 reads 2 B per
// int16 sample and writes ~1.66 B (0.40 f32 outputs per sample); the K2
// stages together move less than K1. The design keeps each input byte to
// one read from device memory: a block stages its run (and halo) in shared
// memory with coalesced loads and computes every output of the run from
// there.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FRAME = 210;
constexpr int FR = 16;                     // frames per K1 block
constexpr int RUN = FR * FRAME;            // 3360 samples per K1 block
constexpr int HALO = 16;                   // K1 staging halo, each side
constexpr int STAGE = RUN + 2 * HALO;      // staged samples per K1 block
constexpr int K1_THREADS = 256;
constexpr int ZC_SPLIT = K1_THREADS / FR;  // 16 threads per frame's count
constexpr int DS1 = 5;                     // stage-1 decimation
constexpr int L1 = 15;                     // stage-1 taps: hann_taps(17)
constexpr int K2_OUT = 128;                // outputs per K2 block
constexpr int MAX_TAPS = 1024;

__device__ __forceinline__ float load_sample(const int16_t* p, long long i) {
  return __half2float(__short2half_rn(p[i]));
}
__device__ __forceinline__ float load_sample(const float* p, long long i) {
  return p[i];
}

// part_0(j) + part_1(j) + ... of _downsample_blur at output j, phases in
// order. y(q) reads the staged input at absolute index q; taps are the L
// = ds * blur values of hann_taps(L + 2).
template <typename Y>
__device__ __forceinline__ float polyphase_at(Y y, const float* taps, int L,
                                              int ds, long long j) {
  float out = 0.0f;
  for (int i = 0; i < ds; ++i) {
    const int t = (L - i + ds - 1) / ds;
    const int c = (t - 1) / 2;
    float part = __fmul_rn(taps[i], y(ds * (j + c) + i));
    for (int m = 1; m < t; ++m)
      part = __fadd_rn(part, __fmul_rn(taps[i + ds * m],
                                       y(ds * (j + c - m) + i)));
    out = i == 0 ? part : __fadd_rn(out, part);
  }
  return out;
}

template <typename T>
__global__ void __launch_bounds__(K1_THREADS)
pcm_frontend_kernel(const T* __restrict__ pcm, int C, long long S,
                    const float* __restrict__ taps15,
                    float* __restrict__ energy, float* __restrict__ crossings,
                    float* __restrict__ bottom, float* __restrict__ band) {
  __shared__ float s_x[STAGE];     // this channel, samples s0 - HALO ..
  __shared__ float s_arr[STAGE];   // channel sum, then arr
  __shared__ float s_taps[L1];
  const int tid = threadIdx.x;
  const long long s0 = (long long)blockIdx.x * RUN;
  const long long n_energy = S / 105;
  const long long n_frames = S / FRAME;
  const long long s_trim = n_frames * FRAME;     // arr is zero from here
  if (tid < L1) s_taps[tid] = taps15[tid];

  float e_acc = 0.0f;              // threads 0..2FR-1: one 105-block each
  int zc = 0;                      // ZC_SPLIT threads per frame
  const int zf = tid / ZC_SPLIT, zr = tid % ZC_SPLIT;
  for (int ch = 0; ch < C; ++ch) {
    __syncthreads();               // the previous channel's reads are done
    const T* row = pcm + (long long)ch * S;
    for (int p = tid; p < STAGE; p += K1_THREADS) {
      const long long s = s0 - HALO + p;
      const float v = (s >= 0 && s < S) ? load_sample(row, s) : 0.0f;
      s_x[p] = v;
      s_arr[p] = ch == 0 ? v : __fadd_rn(s_arr[p], v);
    }
    __syncthreads();
    if (tid < 2 * FR) {
      const float* xs = s_x + HALO + 105 * tid;
#pragma unroll 5
      for (int i = 0; i < 105; ++i)
        e_acc = __fadd_rn(e_acc, __fmul_rn(xs[i], xs[i]));
    }
    for (int i = zr; i < FRAME; i += ZC_SPLIT) {
      const int p = HALO + FRAME * zf + i;
      zc += (__float_as_uint(s_x[p]) ^ __float_as_uint(s_x[p - 1])) >> 31;
    }
  }
  // energy and crossings of this block's run
  const long long k = s0 / 105 + tid;
  if (tid < 2 * FR && k < n_energy)
    energy[k] = __fdiv_rn(e_acc, (float)(105 * C));
#pragma unroll
  for (int off = ZC_SPLIT / 2; off > 0; off >>= 1)
    zc += __shfl_down_sync(0xffffffffu, zc, off, ZC_SPLIT);
  const long long jf = s0 / FRAME + zf;
  if (zr == 0 && jf < n_frames)
    crossings[jf] = (float)(C == 1 ? 2 * zc : zc);

  // arr: the channel mean on the f16 grid (C > 1), zero past the trim
  for (int p = tid; p < STAGE; p += K1_THREADS) {
    const long long s = s0 - HALO + p;
    float v = s_arr[p];
    if (C > 1) v = __half2float(__float2half_rn(__fdiv_rn(v, (float)C)));
    s_arr[p] = (s >= 0 && s < s_trim) ? v : 0.0f;
  }
  __syncthreads();
  // stage 1: bottom = _downsample_blur(arr, 5, 3) and its residual energy
  const long long j0 = s0 / DS1;
  const long long n_bottom = s_trim / DS1;
  const long long base = s0 - HALO;
  auto arr = [&](long long s) { return s_arr[s - base]; };
  for (int jj = tid; jj < RUN / DS1; jj += K1_THREADS) {
    const long long j = j0 + jj;
    if (j >= n_bottom) break;
    const float b = polyphase_at(arr, s_taps, L1, DS1, j);
    float e = 0.0f;
#pragma unroll
    for (int i = 0; i < DS1; ++i) {
      const float d = __fsub_rn(arr(DS1 * j + i), b);
      const float sq = __fmul_rn(d, d);
      e = i == 0 ? sq : __fadd_rn(e, sq);
    }
    bottom[j] = b;
    band[j] = e;
  }
}

// prologue: 0 y = x; 1 y[q] = sum_i (x[r q + i] - bot[q])^2;
// 2 y[q] = sum_i x[r q + i]^2. epilogue: 0 none; 1 log10(1 + v) / 2 on
// outputs 0, 2, 4, ...; 2 log10(1 + v / 210) / 2.
__global__ void __launch_bounds__(K2_OUT)
polyphase_blur_kernel(const float* __restrict__ x,
                      const float* __restrict__ bot, int prologue, int r,
                      long long n, int ds, const float* __restrict__ taps,
                      int L, int epilogue, long long n_out,
                      float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_taps = smem;                         // [L]
  float* s_y = smem + ((L + 3) & ~3);           // [stage]
  const int tid = threadIdx.x;
  const int stride = epilogue == 1 ? 2 : 1;
  const int t0 = (L + ds - 1) / ds;             // phase 0 has the most taps
  const int hb = t0 / 2;                        // ceil((t0 - 1) / 2)
  const int ha = (t0 - 1) / 2;
  const long long o0 = (long long)blockIdx.x * K2_OUT;
  const long long j_lo = o0 * stride;
  const int span = (K2_OUT - 1) * stride + 1;
  const int stage = ds * (span + hb + ha);
  const long long q0 = ds * (j_lo - hb);
  for (int i = tid; i < L; i += K2_OUT) s_taps[i] = taps[i];
  for (int p = tid; p < stage; p += K2_OUT) {
    const long long q = q0 + p;
    float v = 0.0f;
    if (q >= 0 && q < n) {
      if (prologue == 0) {
        v = x[q];
      } else {
        const float b = prologue == 1 ? bot[q] : 0.0f;
        for (int i = 0; i < r; ++i) {
          const float d = __fsub_rn(x[(long long)r * q + i], b);
          const float sq = __fmul_rn(d, d);
          v = i == 0 ? sq : __fadd_rn(v, sq);
        }
      }
    }
    s_y[p] = v;
  }
  __syncthreads();
  const long long o = o0 + tid;
  if (o >= n_out) return;
  auto y = [&](long long q) { return s_y[q - q0]; };
  float v = polyphase_at(y, s_taps, L, ds, o * stride);
  if (epilogue == 2) v = __fdiv_rn(v, 210.0f);
  if (epilogue != 0) v = __fdiv_rn(log10f(__fadd_rn(1.0f, v)), 2.0f);
  out[o] = v;
}

}  // namespace

// K1 over (C, S) PCM, contiguous rows; is_i16: int16 (rounded to f16 on
// load) or f32 samples. taps15: hann_taps(17), 15 values, on the device.
// Outputs: energy (S / 105), crossings (S / 210), bottom and band
// (S / 210 * 42).
// Returns a CUDA error code (0 = ok).
extern "C" int pcm_frontend_launch(const void* pcm, int is_i16, int C,
                                   long long S, const float* taps15,
                                   float* energy, float* crossings,
                                   float* bottom, float* band, void* stream) {
  const long long blocks = (S + RUN - 1) / RUN;
  if (blocks > 0 && C > 0) {
    if (is_i16)
      pcm_frontend_kernel<int16_t><<<(unsigned)blocks, K1_THREADS, 0,
                                     (cudaStream_t)stream>>>(
          (const int16_t*)pcm, C, S, taps15, energy, crossings, bottom, band);
    else
      pcm_frontend_kernel<float><<<(unsigned)blocks, K1_THREADS, 0,
                                   (cudaStream_t)stream>>>(
          (const float*)pcm, C, S, taps15, energy, crossings, bottom, band);
  }
  return (int)cudaGetLastError();
}

// K2: y is x (prologue 0) or built from x (r inputs per y, bottom for
// prologue 1); n = len(y) - len(y) % ds; taps: the L = ds * blur values
// of hann_taps(L + 2) on the device; n_out = n / ds, or ceil(n / 2) for
// epilogue 1 (ds = 1). Returns a CUDA error code (0 = ok).
extern "C" int polyphase_blur_launch(const float* x, const float* bot,
                                     int prologue, int r, long long n, int ds,
                                     const float* taps, int L, int epilogue,
                                     long long n_out, float* out,
                                     void* stream) {
  if (L > MAX_TAPS || ds < 1 || (epilogue == 1 && ds != 1))
    return (int)cudaErrorInvalidValue;
  const int stride = epilogue == 1 ? 2 : 1;
  const int t0 = (L + ds - 1) / ds;
  const int stage = ds * ((K2_OUT - 1) * stride + 1 + t0 / 2 + (t0 - 1) / 2);
  const size_t smem = ((L + 3) & ~3) * 4 + (size_t)stage * 4;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_out + K2_OUT - 1) / K2_OUT;
  if (blocks > 0)
    polyphase_blur_kernel<<<(unsigned)blocks, K2_OUT, smem,
                            (cudaStream_t)stream>>>(
        x, bot, prologue, r, n, ds, taps, L, epilogue, n_out, out);
  return (int)cudaGetLastError();
}
