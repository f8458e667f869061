// pv_phase_lock: the phase vocoder's frame recurrence as one hand-written
// kernel.
//
// Replaces describealign_tpu/stretch/phase_vocoder.py `_pv_segment`'s
// `propagate` (60-94): a `lax.scan` over analysis frames (`:84`) that
// carries the locked synthesis phase. In eager torch each frame is ~12
// elementwise launches over 513 bins, ~2.7 M launches for a 22-min stereo
// segment. Here one CTA per channel walks every frame of a block in order,
// one thread per bin (544 threads, 513 live):
//   1. the bin's complex value z: mag = hypotf(re, im) (torch.hypot, a
//      faithful |z| like jnp.abs), phase_a = atan2f(im, re);
//   2. the phase increment against the previous frame's phase_a (held in a
//      register), wrapped by rintf(dphi / 2pi) - a true division, as JAX
//      computes it - and rot = (prev_locked + inst / rate) - phase_a;
//   3. mag and rot into a double-buffered shared row, one barrier;
//   4. identity phase locking: the left neighbour's rotation where its
//      magnitude beats max(own, right), else the right one's where it beats
//      the own, else the own (zeros past both edges);
//   5. out = (mag cos(locked), mag sin(locked)).
// Without a carry, frame 0's phases pass through (phase_vocoder.py:83-86);
// with one, every frame runs the recurrence from the carried (last
// phase_a, last locked phase), and the block's last pair is written back,
// so the wrapper walks bounded frame blocks exactly.
//
// What bounds it: the frames are sequential, so a frame's latency (loads
// prefetched PF frames ahead, the atan2f / hypotf / cosf / sinf chains,
// one barrier) times the frame count; the bytes (8 in + 8 out per bin and
// frame) take a small share of that on two CTAs. The wrapper measures an
// empty frame step of the same launch shape to state the floor.
//
// Arithmetic: every product, sum and quotient rounded alone (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn), precise atan2f / hypotf / cosf / sinf,
// no fast math: the same CUDA functions torch calls for the plain version
// (ops/pv_kernel.py `pv_phase_lock_plain`), in its order.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 544;     // 17 warps: one thread per bin of 513
constexpr int MAX_BINS = THREADS;
constexpr int PF = 4;            // frames of z prefetched into registers
constexpr float TWO_PI = 6.283185307179586f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__global__ void __launch_bounds__(THREADS)
pv_lock_kernel(const float2* __restrict__ spec, float2* __restrict__ out,
               const float* __restrict__ omega, float rate,
               const float* __restrict__ carry_in, float* __restrict__ carry_out,
               long long f, int bins) {
  // magnitude and rotation rows, double-buffered by frame parity; entry
  // b + 1 is bin b, entries 0 and bins + 1 the zeros past the edges
  __shared__ float mrow[2][MAX_BINS + 2];
  __shared__ float rrow[2][MAX_BINS + 2];
  const int ch = blockIdx.x, nch = gridDim.x;
  const int b = threadIdx.x;
  const bool live = b < bins;
  const float2* sp = spec + (long long)ch * f * bins + b;
  float2* op = out + (long long)ch * f * bins + b;
  const float om = live ? mul(omega[b], rate) : 0.f;     // omega * rate
  for (int i = b; i < 2 * (MAX_BINS + 2); i += THREADS) {
    (&mrow[0][0])[i] = 0.f;
    (&rrow[0][0])[i] = 0.f;
  }
  float prev_pa = 0.f, prev_lk = 0.f;
  long long k0 = 0;
  if (carry_in != nullptr) {
    if (live) {
      prev_pa = carry_in[(long long)ch * bins + b];
      prev_lk = carry_in[(long long)(nch + ch) * bins + b];
    }
  } else {
    // frame 0 passes its phases through
    if (live && f > 0) {
      const float2 z = sp[0];
      const float mag = hypotf(z.x, z.y);
      const float pa = atan2f(z.y, z.x);
      op[0] = make_float2(mul(mag, cosf(pa)), mul(mag, sinf(pa)));
      prev_pa = pa;
      prev_lk = pa;
    }
    k0 = 1;
  }
  __syncthreads();

  float2 cur[PF], nxt[PF];
#pragma unroll
  for (int u = 0; u < PF; ++u)
    cur[u] = (live && k0 + u < f) ? sp[(k0 + u) * bins] : make_float2(0.f, 0.f);
  for (long long k = k0; k < f; k += PF) {
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const long long kn = k + PF + u;
      nxt[u] = (live && kn < f) ? sp[kn * bins] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const long long kk = k + u;
      if (kk >= f) break;                 // uniform across the CTA
      const int buf = (int)(kk & 1);
      const float mag = hypotf(cur[u].x, cur[u].y);
      const float pa = atan2f(cur[u].y, cur[u].x);
      float dphi = sub(sub(pa, prev_pa), om);
      dphi = sub(dphi, mul(TWO_PI, rintf(dvd(dphi, TWO_PI))));
      const float inst = add(om, dphi);                 // per analysis hop
      const float rot = sub(add(prev_lk, dvd(inst, rate)), pa);
      if (live) {
        mrow[buf][b + 1] = mag;
        rrow[buf][b + 1] = rot;
      }
      __syncthreads();
      if (live) {
        const float lm = mrow[buf][b], rm = mrow[buf][b + 2];
        const float dom = lm > fmaxf(mag, rm) ? rrow[buf][b]
                          : (rm > mag ? rrow[buf][b + 2] : rot);
        const float lk = add(pa, dom);
        op[kk * bins] = make_float2(mul(mag, cosf(lk)), mul(mag, sinf(lk)));
        prev_pa = pa;
        prev_lk = lk;
      }
    }
#pragma unroll
    for (int u = 0; u < PF; ++u) cur[u] = nxt[u];
  }
  if (live) {
    carry_out[(long long)ch * bins + b] = prev_pa;
    carry_out[(long long)(nch + ch) * bins + b] = prev_lk;
  }
}

// n empty frame steps of a CTA of the kernel's shape: one barrier each and
// a shared word carried from step to step, no arithmetic
__global__ void pv_empty_steps_kernel(long long steps, float* sink) {
  __shared__ float word[2];
  if (threadIdx.x == 0) word[0] = 0.f;
  __syncthreads();
  for (long long k = 0; k < steps; ++k) {
    if (threadIdx.x == (k & 31)) word[(k + 1) & 1] = word[k & 1] + 1.f;
    __syncthreads();
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = word[steps & 1];
}

}  // namespace

// spec, out: (c, f, bins) complex64 as float2; omega: (bins,); carry_in:
// (2, c, bins) - [0] the last frame's phase_a, [1] its locked phase - or
// null for a segment's first block; carry_out: (2, c, bins). Returns the
// CUDA error of the launch.
extern "C" int pv_lock_launch(const void* spec, void* out, const float* omega,
                              float rate, const float* carry_in,
                              float* carry_out, long long c, long long f,
                              int bins, void* stream) {
  if (c < 1 || c > 65535 || f < 1 || bins < 2 || bins > MAX_BINS)
    return (int)cudaErrorInvalidValue;
  pv_lock_kernel<<<(unsigned)c, THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)spec, (float2*)out, omega, rate, carry_in, carry_out, f,
      bins);
  return (int)cudaGetLastError();
}

extern "C" int pv_empty_steps_launch(long long steps, long long c, float* sink,
                                     void* stream) {
  if (steps < 0 || c < 1 || c > 65535) return (int)cudaErrorInvalidValue;
  pv_empty_steps_kernel<<<(unsigned)c, THREADS, 0, (cudaStream_t)stream>>>(
      steps, sink);
  return (int)cudaGetLastError();
}
