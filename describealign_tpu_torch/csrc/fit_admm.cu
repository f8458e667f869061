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
// What bounds it: not bytes or arithmetic across the card (a few hundred
// kB and ~40 n flops per iteration) but the chain of dependent steps on
// one SM, and that SM's issue rate for the elementwise steps. Each
// iteration is the right-hand side, log2(n) elimination levels, the top
// equation, log2(n) back-substitution levels and the updates. The levels
// of more than WARP_ROWS rows are CTA steps, one barrier each; the top
// levels (at most WARP_ROWS rows: levels 7-12 at n 8,192), the top
// equation and the matching back-substitution levels run in warp 0 under
// __syncwarp, their factors in a small shared table. That is 2 (log2(n) -
// 6) + 3 CTA barriers and 13 warp steps per iteration for n >= 64 (17 and
// 13 at 8,192, was 29 barriers); the wrapper measures an empty CTA step
// and an empty warp step (fit_empty_steps_launch,
// fit_empty_warp_steps_launch) to state the floor.
//
// Design:
// - The system matrix rho1 I + D^T diag(rho2) D is constant, so the
//   elimination factors are computed once per launch, with the same
//   operations the plain version repeats every iteration (_cr_solve's
//   forward loop on a, b, c): each level's arrays compact, as the plain
//   version's slices make them, so the factors of level k sit at
//   level_base(n, k) + j: alpha and gamma of its odd rows, a, c and b of
//   its even rows (what back substitution reads), and the top equation's b.
// - Per iteration only the right-hand side d changes. Its levels are
//   compact too: level k (n >> k values) at dbase(k), so a level's step
//   reads and writes d at stride 1 or 2 (in place by position, the strides
//   grow to 2^k and a level of more than 16 rows hits one shared-memory
//   bank 32 times). Back substitution writes level k's solution over its
//   d: the even values solved, the odd ones copied from level k + 1, so
//   level 0 ends as t. d (2n floats) is the only array a step reads that
//   an earlier step of the same solve wrote, so it lives in shared memory
//   at every n up to 16,384 (128 KB): no elimination or back-substitution
//   step reads it from device memory.
// - Arrays of n floats, claiming shared memory in this order: d (two),
//   then the factors (alpha, gamma, a, c, b: read by every CTA level), then
//   p, z and the two duals and the constants b, rho2, c/rho1, kappa/rho2,
//   which only the two elementwise steps touch. As many as fit in 227 KB
//   beside the warp table go to shared memory (all but kappa/rho2 up to n
//   4,096; d and the factors at 8,192; d and alpha at 16,384), the rest to
//   a global scratch the wrapper allocates (L2-resident). The factors'
//   addresses never depend on d, so each thread loads its rows' factors
//   for the next CTA level (up to PF rows) into registers before the
//   barrier that ends the current step.
// - Arithmetic: every product, sum, difference and quotient is rounded
//   alone (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc never contracts
//   them into FMAs) in the plain version's order, padding constants
//   included (gamma * 0 at the right edge, a * 0 at the left), so the kernel
//   is bit-equal to ops/fit_kernel.py `fused_lasso_admm_plain`, signed zeros
//   too.
#include <cuda_runtime.h>

namespace {

constexpr int NSLOT = 15;           // slots of n floats per problem
constexpr int MAX_THREADS = 1024;
constexpr int SMEM_LIMIT = 232448;  // shared bytes a block can use (sm_90)
constexpr int WARP_ROWS = 32;       // levels of at most this many rows: warp 0
constexpr int WARP_LEVELS = 6;      // log2(WARP_ROWS) + 1
constexpr int TAB_ROWS = 2 * WARP_ROWS - 1;   // rows of the warp levels
constexpr int TAB_BYTES = 4 * (5 * TAB_ROWS + 1);
constexpr int PF = 4;               // rows per thread prefetched per level

// slots, in the order they claim shared memory; d takes two
enum { kD = 0, kAL = 2, kGA, kCA, kCC, kCB, kP, kZ, kA, kE, kB, kR2, kCT, kKT };

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

// offset of level k's factors in the compact arrays: the levels below hold
// n/2 + n/4 + ... + n/2^k rows
__device__ __forceinline__ int level_base(int n, int k) {
  return n - (n >> k);
}
// offset of level k's d (n >> k values): n + n/2 + ... + n/2^(k-1)
__device__ __forceinline__ int dbase(int n, int k) {
  return 2 * n - ((2 * n) >> k);
}

// slots in shared memory at n: whole arrays, d's two together or not at all
int shared_slots(long long n) {
  const long long fit = (SMEM_LIMIT - TAB_BYTES) / (4 * n);
  return fit < 2 ? 0 : (fit < NSLOT ? (int)fit : NSLOT);
}

// NS: the slots in dynamic shared memory (shared_slots(n): 15, 14, 7, 3
// or 0 for a power of two n), so every array's place is known when the
// kernel is compiled.
template <int NS>
__global__ void __launch_bounds__(MAX_THREADS)
fit_admm_kernel(const float* __restrict__ b_in, const float* __restrict__ c_in,
                const float* __restrict__ k_in, const float* __restrict__ rho1_in,
                const float* __restrict__ rho2_in, float* __restrict__ t_out,
                float* __restrict__ z_out, float* __restrict__ scratch, int n,
                int levels, int iters, float over, float under) {
  extern __shared__ float smem[];
  // the warp levels' factors: alpha, gamma, a, c, b by table row, then the
  // top equation's b
  __shared__ float tab[5 * TAB_ROWS + 1];
  float* const tAL = tab;
  float* const tGA = tab + TAB_ROWS;
  float* const tCA = tab + 2 * TAB_ROWS;
  float* const tCC = tab + 3 * TAB_ROWS;
  float* const tCB = tab + 4 * TAB_ROWS;
  const long long prob = blockIdx.x;
  float* const scr = scratch + prob * (long long)(NSLOT - NS) * n;
  auto slot = [&](int a) -> float* {
    return a < NS ? smem + a * n : scr + (long long)(a - NS) * n;
  };
  float* const D = slot(kD);
  float* const AL = slot(kAL);
  float* const GA = slot(kGA);
  float* const CA = slot(kCA);
  float* const CC = slot(kCC);
  float* const CB = slot(kCB);
  float* const P = slot(kP);
  float* const Z = slot(kZ);
  float* const A = slot(kA);
  float* const E = slot(kE);
  float* const B = slot(kB);
  float* const R2 = slot(kR2);
  float* const CT = slot(kCT);
  float* const KT = slot(kKT);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int kw = levels > WARP_LEVELS ? levels - WARP_LEVELS : 0;
  const float r1 = rho1_in[prob];
  const float* bp = b_in + prob * n;
  const float* cp = c_in + prob * n;
  const float* kp = k_in + prob * (n - 1);
  const float* rp = rho2_in + prob * (n - 1);

  // ---- set-up: the constants and the level-0 matrix ----
  // a, b, c of the level being reduced and of the next one, ping-ponged in
  // the six slots d, p, z, a, e hold later
  float* xa = D;
  float* xb = P;
  float* xc = Z;
  float* ya = D + n;
  float* yb = A;
  float* yc = E;
  for (int i = tid; i < n; i += nt) {
    B[i] = bp[i];
    CT[i] = dvd(cp[i], r1);
    const float rl = i > 0 ? rp[i - 1] : 0.f;      // rho2_l
    const float rr = i < n - 1 ? rp[i] : 0.f;      // rho2_r
    xb[i] = add(add(r1, rl), rr);                  // diag
    xa[i] = i > 0 ? -rp[i - 1] : 0.f;              // a = [0, off]
    xc[i] = i < n - 1 ? -rp[i] : 0.f;              // c = [off, 0]
    if (i < n - 1) {
      R2[i] = rp[i];
      KT[i] = dvd(kp[i], rp[i]);
    }
  }
  __syncthreads();
  // the constant elimination, level by level (_cr_solve's forward loop
  // without d)
  for (int k = 0; k < levels; ++k) {
    const int m = n >> k, rows = m >> 1, base = level_base(n, k);
    for (int j = tid; j < rows; j += nt) {
      const bool right = 2 * j + 2 < m;
      const float be = xb[2 * j];
      const float be_next = right ? xb[2 * j + 2] : 1.f;
      const float alpha = dvd(xa[2 * j + 1], be);
      const float gamma = dvd(xc[2 * j + 1], be_next);
      const float ae = xa[2 * j], ce = xc[2 * j];
      const float a_next = right ? xa[2 * j + 2] : 0.f;
      const float ce_next = right ? xc[2 * j + 2] : 0.f;
      yb[j] = sub(sub(xb[2 * j + 1], mul(alpha, ce)), mul(gamma, a_next));
      ya[j] = mul(-alpha, ae);
      yc[j] = mul(-gamma, ce_next);
      AL[base + j] = alpha;
      GA[base + j] = gamma;
      CA[base + j] = ae;
      CC[base + j] = ce;
      CB[base + j] = be;
    }
    __syncthreads();
    float* s;
    s = xa; xa = ya; ya = s;
    s = xb; xb = yb; yb = s;
    s = xc; xc = yc; yc = s;
  }
  // the warp levels' factors into the table (row base_k - base_kw + j)
  const int tab0 = level_base(n, kw);
  for (int i = tid; i < level_base(n, levels) - tab0; i += nt) {
    tAL[i] = AL[tab0 + i];
    tGA[i] = GA[tab0 + i];
    tCA[i] = CA[tab0 + i];
    tCC[i] = CC[tab0 + i];
    tCB[i] = CB[tab0 + i];
  }
  if (tid == 0) tab[5 * TAB_ROWS] = xb[0];         // the top equation's b
  __syncthreads();
  for (int i = tid; i < n; i += nt) {              // the initial state
    P[i] = 0.f;
    A[i] = 0.f;
    if (i < n - 1) {
      Z[i] = sub(bp[i + 1], bp[i]);                // dt(t0), t0 = b
      E[i] = 0.f;
    }
  }

  // a thread's rows' factors for the next CTA level, in registers
  float c0[PF], c1[PF], c2[PF];
  auto fetch_forward = [&](int k) {
    const int rows = n >> (k + 1), base = level_base(n, k);
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int j = tid + u * nt;
      if (j < rows) {
        c0[u] = AL[base + j];
        c1[u] = GA[base + j];
      }
    }
  };
  auto fetch_back = [&](int k) {
    const int rows = n >> (k + 1), base = level_base(n, k);
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int j = tid + u * nt;
      if (j < rows) {
        c0[u] = CA[base + j];
        c1[u] = CC[base + j];
        c2[u] = CB[base + j];
      }
    }
  };
  // row j of level k: d's next level from this one's odd and even values
  auto forward_row = [&](int k, int j, float al, float ga) {
    const int m = n >> k;
    const float* dk = D + dbase(n, k);
    const float2 de = *(const float2*)(dk + 2 * j);    // (even, odd)
    const float de_next = 2 * j + 2 < m ? dk[2 * j + 2] : 0.f;
    D[dbase(n, k + 1) + j] = sub(sub(de.y, mul(al, de.x)), mul(ga, de_next));
  };
  // row j of level k: its even unknown from level k + 1's solution, which
  // fills the odd place beside it
  auto back_row = [&](int k, int j, float ca, float cc, float cb) {
    float* dk = D + dbase(n, k);
    const float* x = D + dbase(n, k + 1);
    const float xr = x[j];
    const float xl = j > 0 ? x[j - 1] : 0.f;
    const float xe = dvd(sub(sub(dk[2 * j], mul(ca, xl)), mul(cc, xr)), cb);
    *(float2*)(dk + 2 * j) = make_float2(xe, xr);
  };

  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    // rhs = rho1 * (b + p - a) + D^T diag(rho2) (z - e): d's level 0
    for (int i = tid; i < n; i += nt) {
      const float w_i = i < n - 1 ? mul(R2[i], sub(Z[i], E[i])) : 0.f;
      const float w_l = i > 0 ? mul(R2[i - 1], sub(Z[i - 1], E[i - 1])) : 0.f;
      const float dtw = i == 0 ? -w_i : (i == n - 1 ? w_l : sub(w_l, w_i));
      D[i] = add(mul(r1, sub(add(B[i], P[i]), A[i])), dtw);
    }
    if (kw > 0) fetch_forward(0);
    __syncthreads();
    // forward reduction of d, CTA levels
    for (int k = 0; k < kw; ++k) {
      const int rows = n >> (k + 1), base = level_base(n, k);
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int j = tid + u * nt;
        if (j < rows) forward_row(k, j, c0[u], c1[u]);
      }
      for (int j = tid + PF * nt; j < rows; j += nt)
        forward_row(k, j, AL[base + j], GA[base + j]);
      if (k + 1 < kw) fetch_forward(k + 1);
      else fetch_back(kw - 1);
      __syncthreads();
    }
    // the warp levels, the top equation and their back substitution
    if (tid < 32) {
      for (int k = kw; k < levels; ++k) {
        const int rows = n >> (k + 1), tb = level_base(n, k) - tab0;
        if (tid < rows) forward_row(k, tid, tAL[tb + tid], tGA[tb + tid]);
        __syncwarp();
      }
      if (tid == 0) {
        float* top = D + dbase(n, levels);
        *top = dvd(*top, tab[5 * TAB_ROWS]);
      }
      __syncwarp();
      for (int k = levels - 1; k >= kw; --k) {
        const int rows = n >> (k + 1), tb = level_base(n, k) - tab0;
        if (tid < rows)
          back_row(k, tid, tCA[tb + tid], tCC[tb + tid], tCB[tb + tid]);
        __syncwarp();
      }
    }
    __syncthreads();
    // back substitution, CTA levels, top down
    for (int k = kw - 1; k >= 0; --k) {
      const int rows = n >> (k + 1), base = level_base(n, k);
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int j = tid + u * nt;
        if (j < rows) back_row(k, j, c0[u], c1[u], c2[u]);
      }
      for (int j = tid + PF * nt; j < rows; j += nt)
        back_row(k, j, CA[base + j], CC[base + j], CB[base + j]);
      if (k > 0) fetch_back(k - 1);
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
// a dependence from step to step, no arithmetic
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

// n empty steps of one warp: __syncwarp each and the same carried word
__global__ void fit_empty_warp_steps_kernel(long long steps, float* sink) {
  __shared__ float word[2];
  if (threadIdx.x == 0) word[0] = 0.f;
  __syncwarp();
  for (long long k = 0; k < steps; ++k) {
    if (threadIdx.x == (k & 31)) word[(k + 1) & 1] = word[k & 1] + 1.f;
    __syncwarp();
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = word[steps & 1];
}

int threads_for(int n) {
  int t = n < MAX_THREADS ? n : MAX_THREADS;
  return t < 32 ? 32 : t;
}

}  // namespace

// Slots of n floats of a problem that the kernel keeps in shared memory (in
// the order above); the rest live in the scratch.
extern "C" int fit_admm_shared_slots(long long n) {
  return n < 16 ? -1 : shared_slots(n);
}

// b, c: (batch, n); k, rho2: (batch, n - 1); rho1: (batch,); t: (batch, n),
// z: (batch, n - 1) out. scratch: (batch, 15 - fit_admm_shared_slots(n),
// n) floats, or null where every slot is in shared memory. Returns the
// CUDA error of the launch.
extern "C" int fit_admm_launch(const float* b, const float* c, const float* k,
                               const float* rho1, const float* rho2, float* t,
                               float* z, float* scratch, long long batch,
                               long long n, int iters, float over, float under,
                               void* stream) {
  if (batch < 1 || batch > 0x7fffffffLL || n < 16 || n > (1LL << 24) ||
      (n & (n - 1)) || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int n_shared = shared_slots(n);
  if (n_shared < NSLOT && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  int levels = 0;
  while ((1LL << levels) < n) ++levels;
  const int threads = threads_for((int)n);
  const size_t smem = sizeof(float) * (size_t)n_shared * (size_t)n;
  void (*kernel)(const float*, const float*, const float*, const float*,
                 const float*, float*, float*, float*, int, int, int, float,
                 float);
  switch (n_shared) {
    case NSLOT: kernel = fit_admm_kernel<NSLOT>; break;
    case 14: kernel = fit_admm_kernel<14>; break;
    case 7: kernel = fit_admm_kernel<7>; break;
    case 3: kernel = fit_admm_kernel<3>; break;
    case 0: kernel = fit_admm_kernel<0>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)batch, threads, smem, (cudaStream_t)stream>>>(
      b, c, k, rho1, rho2, t, z, scratch, (int)n, levels, iters, over, under);
  return (int)cudaGetLastError();
}

// the empty-step floors at the launch shape of n: one CTA of the kernel's
// threads walking `steps` barriers, or one warp walking `steps` __syncwarp
extern "C" int fit_empty_steps_launch(long long steps, long long n, float* sink,
                                      void* stream) {
  if (steps < 0 || n < 16 || n > (1LL << 24)) return (int)cudaErrorInvalidValue;
  fit_empty_steps_kernel<<<1, threads_for((int)n), 0, (cudaStream_t)stream>>>(
      steps, sink);
  return (int)cudaGetLastError();
}

extern "C" int fit_empty_warp_steps_launch(long long steps, float* sink,
                                           void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  fit_empty_warp_steps_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(steps, sink);
  return (int)cudaGetLastError();
}
