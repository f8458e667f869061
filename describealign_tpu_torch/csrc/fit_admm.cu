// fused_lasso_admm: the on-device L1 fit's ADMM as one hand-written kernel.
//
// Replaces describealign_tpu/alignment/fit_device.py `_fused_lasso_admm`
// (86-124: 800 over-relaxed ADMM iterations in a `lax.scan`, `:123`), its
// tridiagonal solve `_cr_solve` (35-78) and the vmapped batch
// `_fused_lasso_admm_batched` (170-175). Each problem is
//
//     min_t  sum_i c_i |t_i - b_i|  +  sum_k kappa_k |t_{k+1} - t_k|
//
// padded to n a power of two >= 16. In eager torch the scan is ~300 small
// launches per iteration (two cyclic-reduction sweeps of log2(n) levels
// plus the updates): ~250k launches per solve. Here one CTA runs all
// iterations of one problem; the grid is the batch.
//
// What bounds it: not bytes or arithmetic (a few hundred kB and ~40 n flops
// per iteration) but the chain of dependent steps. Each iteration is 2
// log2(n) + 3 barrier-separated steps (the right-hand side, log2(n)
// elimination levels, the top equation, log2(n) back-substitution levels,
// the updates), so 800 x (2 log2(n) + 3) CTA barriers are the floor; the
// wrapper measures an empty barrier step of the same launch shape
// (fit_empty_steps_launch) to state it.
//
// Design:
// - The system matrix rho1 I + D^T diag(rho2) D is constant, so the
//   elimination factors are computed once per launch, with the same
//   operations the plain version repeats every iteration: an in-place
//   cyclic reduction over positions. At level k (stride s = 2^k) the rows
//   left are positions s-1 + i*2s... and each odd one q eliminates its even
//   neighbours q-s and q+s. a, b, c are reduced in place, so after the
//   setup position e holds exactly the a, b, c of the level at which it was
//   eliminated (what back substitution reads), position n-1 the top
//   equation's b; alpha and gamma of each level are kept compactly.
// - Per iteration only the right-hand side d changes: it is reduced in
//   place and back-substituted in place, so d ends as t.
// - State: 14 arrays of n floats (b, c/rho1, kappa/rho2, rho2, p, z, the
//   two duals, d, a, b, c and the two factor arrays). n <= 4096 keeps them
//   in shared memory (229,376 bytes at 4096); above, in a global scratch
//   the wrapper allocates (1.8 MB at n = 32,768, resident in L2).
// - Arithmetic: every product, sum, difference and quotient is rounded
//   alone (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc never contracts
//   them into FMAs) in the plain version's order, padding constants
//   included (gamma * 0 at the right edge, a * 0 at the left), so the kernel
//   is bit-equal to ops/fit_kernel.py `fused_lasso_admm_plain`, signed zeros
//   too.
#include <cuda_runtime.h>

namespace {

constexpr int NARR = 14;            // arrays of n floats per problem
constexpr int MAX_THREADS = 1024;
constexpr int SHARED_MAX_N = 4096;  // largest n whose state fits in shared

// array slots in the per-problem buffer
enum { kB = 0, kCT, kKT, kR2, kP, kZ, kA, kE, kD, kWA, kWB, kWC, kAL, kGA };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// _soft(v, thr) = sign(v) * max(|v| - thr, 0), as the plain version writes
// it: where(v < 0, -m, m)
__device__ __forceinline__ float soft(float v, float thr) {
  float m = sub(fabsf(v), thr);
  m = m < 0.f ? 0.f : m;
  return v < 0.f ? -m : m;
}

// offset of level k's alpha/gamma in the compact factor arrays: the levels
// below hold n/2 + n/4 + ... + n/2^k rows
__device__ __forceinline__ int level_base(int n, int k) {
  return n - (n >> k);
}

template <bool kShared>
__global__ void __launch_bounds__(MAX_THREADS)
fit_admm_kernel(const float* __restrict__ b_in, const float* __restrict__ c_in,
                const float* __restrict__ k_in, const float* __restrict__ rho1_in,
                const float* __restrict__ rho2_in, float* __restrict__ t_out,
                float* __restrict__ z_out, float* __restrict__ scratch, int n,
                int levels, int iters, float over, float under) {
  extern __shared__ float smem[];
  const long long prob = blockIdx.x;
  float* S = kShared ? smem : scratch + prob * NARR * (long long)n;
  float* B = S + kB * n;
  float* CT = S + kCT * n;
  float* KT = S + kKT * n;
  float* R2 = S + kR2 * n;
  float* P = S + kP * n;
  float* Z = S + kZ * n;
  float* A = S + kA * n;
  float* E = S + kE * n;
  float* D = S + kD * n;
  float* WA = S + kWA * n;
  float* WB = S + kWB * n;
  float* WC = S + kWC * n;
  float* AL = S + kAL * n;
  float* GA = S + kGA * n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float r1 = rho1_in[prob];
  const float* bp = b_in + prob * n;
  const float* cp = c_in + prob * n;
  const float* kp = k_in + prob * (n - 1);
  const float* rp = rho2_in + prob * (n - 1);

  // ---- set-up: inputs, thresholds, the level-0 matrix, initial state ----
  for (int i = tid; i < n; i += nt) {
    const float bi = bp[i];
    B[i] = bi;
    CT[i] = dvd(cp[i], r1);
    const float rl = i > 0 ? rp[i - 1] : 0.f;      // rho2_l
    const float rr = i < n - 1 ? rp[i] : 0.f;      // rho2_r
    WB[i] = add(add(r1, rl), rr);                  // diag
    WA[i] = i > 0 ? -rp[i - 1] : 0.f;              // a = [0, off]
    WC[i] = i < n - 1 ? -rp[i] : 0.f;              // c = [off, 0]
    P[i] = 0.f;
    A[i] = 0.f;
    if (i < n - 1) {
      R2[i] = rp[i];
      KT[i] = dvd(kp[i], rp[i]);
      Z[i] = sub(bp[i + 1], bi);                   // dt(t0), t0 = b
      E[i] = 0.f;
    }
  }
  __syncthreads();
  // the constant elimination, level by level (_cr_solve's forward loop
  // without d)
  for (int k = 0; k < levels; ++k) {
    const int s = 1 << k, rows = n >> (k + 1), base = level_base(n, k);
    for (int j = tid; j < rows; j += nt) {
      const int q = (2 * s - 1) + j * 2 * s, l = q - s, r = q + s;
      const bool right = r < n;
      const float alpha = dvd(WA[q], WB[l]);
      const float gamma = dvd(WC[q], right ? WB[r] : 1.f);
      const float a_next = right ? WA[r] : 0.f;
      const float ce_next = right ? WC[r] : 0.f;
      const float nb = sub(sub(WB[q], mul(alpha, WC[l])), mul(gamma, a_next));
      const float na = mul(-alpha, WA[l]);
      const float nc = mul(-gamma, ce_next);
      WB[q] = nb;
      WA[q] = na;
      WC[q] = nc;
      AL[base + j] = alpha;
      GA[base + j] = gamma;
    }
    __syncthreads();
  }

  for (int it = 0; it < iters; ++it) {
    // rhs = rho1 * (b + p - a) + D^T diag(rho2) (z - e)
    for (int i = tid; i < n; i += nt) {
      const float w_i = i < n - 1 ? mul(R2[i], sub(Z[i], E[i])) : 0.f;
      const float w_l = i > 0 ? mul(R2[i - 1], sub(Z[i - 1], E[i - 1])) : 0.f;
      const float dtw = i == 0 ? -w_i : (i == n - 1 ? w_l : sub(w_l, w_i));
      D[i] = add(mul(r1, sub(add(B[i], P[i]), A[i])), dtw);
    }
    __syncthreads();
    // forward reduction of d
    for (int k = 0; k < levels; ++k) {
      const int s = 1 << k, rows = n >> (k + 1), base = level_base(n, k);
      for (int j = tid; j < rows; j += nt) {
        const int q = (2 * s - 1) + j * 2 * s, l = q - s, r = q + s;
        const float de_next = r < n ? D[r] : 0.f;
        D[q] = sub(sub(D[q], mul(AL[base + j], D[l])), mul(GA[base + j], de_next));
      }
      __syncthreads();
    }
    if (tid == 0) D[n - 1] = dvd(D[n - 1], WB[n - 1]);   // the top equation
    __syncthreads();
    // back substitution: the even rows of each level, top down
    for (int k = levels - 1; k >= 0; --k) {
      const int s = 1 << k, rows = n >> (k + 1);
      for (int j = tid; j < rows; j += nt) {
        const int e = (s - 1) + j * 2 * s;
        const float x_left = j > 0 ? D[e - s] : 0.f;
        const float x_right = D[e + s];
        D[e] = dvd(sub(sub(D[e], mul(WA[e], x_left)), mul(WC[e], x_right)),
                   WB[e]);
      }
      __syncthreads();
    }
    // over-relaxed splitting updates, soft-thresholds, dual updates
    for (int i = tid; i < n; i += nt) {
      const float t = D[i];
      const float thp = add(mul(over, sub(t, B[i])), mul(under, P[i]));
      const float p = soft(add(thp, A[i]), CT[i]);
      A[i] = sub(add(A[i], thp), p);
      P[i] = p;
      if (i < n - 1) {
        const float thz = add(mul(over, sub(D[i + 1], t)), mul(under, Z[i]));
        const float z = soft(add(thz, E[i]), KT[i]);
        E[i] = sub(add(E[i], thz), z);
        Z[i] = z;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += nt) {
    t_out[prob * n + i] = D[i];
    if (i < n - 1) z_out[prob * (n - 1) + i] = Z[i];
  }
}

// n empty steps of a CTA: one barrier each and a shared word that carries
// a dependence from step to step, no arithmetic. The ADMM cannot take
// fewer than 800 x (2 log2(n) + 3) such steps.
__global__ void fit_empty_steps_kernel(long long steps, float* sink) {
  __shared__ float word[2];
  if (threadIdx.x == 0) word[0] = 0.f;
  __syncthreads();
  for (long long k = 0; k < steps; ++k) {
    if (threadIdx.x == (k & 31)) word[(k + 1) & 1] = word[k & 1] + 1.f;
    __syncthreads();
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = word[steps & 1];
}

int threads_for(int n) {
  int t = n < MAX_THREADS ? n : MAX_THREADS;
  return t < 32 ? 32 : t;
}

}  // namespace

// b, c: (batch, n); k, rho2: (batch, n - 1); rho1: (batch,); t: (batch, n),
// z: (batch, n - 1) out. scratch: (batch, 14, n) floats where n > 4096,
// else unused (may be null). Returns the CUDA error of the launch.
extern "C" int fit_admm_launch(const float* b, const float* c, const float* k,
                               const float* rho1, const float* rho2, float* t,
                               float* z, float* scratch, long long batch,
                               long long n, int iters, float over, float under,
                               void* stream) {
  if (batch < 1 || batch > 0x7fffffffLL || n < 16 || n > (1LL << 24) ||
      (n & (n - 1)) || iters < 0 || (n > SHARED_MAX_N && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  int levels = 0;
  while ((1LL << levels) < n) ++levels;
  const int threads = threads_for((int)n);
  cudaError_t err;
  if (n <= SHARED_MAX_N) {
    const size_t smem = sizeof(float) * NARR * (size_t)n;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(fit_admm_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    fit_admm_kernel<true><<<(unsigned)batch, threads, smem,
                            (cudaStream_t)stream>>>(
        b, c, k, rho1, rho2, t, z, nullptr, (int)n, levels, iters, over,
        under);
  } else {
    fit_admm_kernel<false><<<(unsigned)batch, threads, 0,
                             (cudaStream_t)stream>>>(
        b, c, k, rho1, rho2, t, z, scratch, (int)n, levels, iters, over,
        under);
  }
  return (int)cudaGetLastError();
}

// the empty-step floor at the launch shape of n: one CTA of the kernel's
// threads walking `steps` barriers
extern "C" int fit_empty_steps_launch(long long steps, long long n, float* sink,
                                      void* stream) {
  if (steps < 0 || n < 16 || n > (1LL << 24)) return (int)cudaErrorInvalidValue;
  fit_empty_steps_kernel<<<1, threads_for((int)n), 0, (cudaStream_t)stream>>>(
      steps, sink);
  return (int)cudaGetLastError();
}
