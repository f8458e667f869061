// How fast one SM can stream data from device memory into its shared
// memory, by the two mechanisms a ring buffer can use: one bulk copy
// (cp.async.bulk, the TMA's 1-D copy) per slot issued by a single lane and
// completing on an mbarrier, or 16-byte cp.async copies issued by 1-4
// whole warps. Two CTAs (two SMs) each stream their own 64 MB; the
// consumer reads every 16-byte vector of a slot once. Built and run by
// scripts/torch_output_kernels.py --feed; prints GB/s per SM.
#include <cuda_runtime.h>
#include <cstdio>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}

// a ring of `stages` slots of `slot` bytes, one lane issuing a bulk copy
// per slot, one warp reading each slot and freeing it
__global__ void bulk_ring(const unsigned char* src, long long bytes, int slot,
                          int stages, float* sink) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[16], empty[16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  src += blockIdx.x * bytes;
  const long long slots = bytes / slot;
  if (warp == 1) {
    if (lane == 0)
      for (long long c = 0; c < slots; ++c) {
        const int st = (int)(c % stages);
        if (c >= stages) mbar_wait(&empty[st], (unsigned)((c / stages - 1) & 1));
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     ::"r"(smem_u32(&full[st])), "r"(slot) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem_u32(ring + st * slot)),
            "l"(src + c * slot), "r"(slot), "r"(smem_u32(&full[st]))
            : "memory");
      }
    return;
  }
  float acc = 0.f;
  for (long long c = 0; c < slots; ++c) {
    const int st = (int)(c % stages);
    mbar_wait(&full[st], (unsigned)((c / stages) & 1));
    const float4* p = (const float4*)(ring + st * slot);
    for (int i = lane; i < slot / 16; i += 32) acc += p[i].x;
    __syncwarp();
    if (lane == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                       smem_u32(&empty[st])) : "memory");
  }
  sink[blockIdx.x * 32 + lane] = acc;
}

// each warp its own ring of 8 slots of 4 KB, filled by its lanes' 16-byte
// cp.async copies seven slots ahead
__global__ void warp_rings(const unsigned char* src, long long bytes,
                           float* sink) {
  extern __shared__ __align__(128) unsigned char ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const long long mine = bytes / nw / 4096 * 4096;   // 16-byte aligned
  const unsigned char* s = src + blockIdx.x * bytes + warp * mine;
  unsigned char* r = ring + warp * 8 * 4096;
  const long long slots = mine / 4096;
  auto issue = [&](long long c) {
    if (c < slots)
      for (int i = 0; i < 8; ++i) {
        const int off = (i * 32 + lane) * 16;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         smem_u32(r + (c % 8) * 4096 + off)),
                     "l"(s + c * 4096 + off) : "memory");
      }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (int c = 0; c < 7; ++c) issue(c);
  float acc = 0.f;
  for (long long c = 0; c < slots; ++c) {
    asm volatile("cp.async.wait_group 6;" ::: "memory");
    __syncwarp();
    const float4* p = (const float4*)(r + (c % 8) * 4096);
    for (int i = 0; i < 8; ++i) acc += p[i * 32 + lane].x;
    __syncwarp();
    issue(c + 7);
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

}  // namespace

int main() {
  const long long bytes = 64LL << 20;              // per CTA
  unsigned char* buf;
  float* sink;
  if (cudaMalloc(&buf, 2 * bytes) != cudaSuccess ||
      cudaMalloc(&sink, 1 << 16) != cudaSuccess)
    return 1;
  cudaMemset(buf, 1, 2 * bytes);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaFuncSetAttribute(bulk_ring, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       220 * 1024);
  cudaFuncSetAttribute(warp_rings, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       220 * 1024);
  auto rate = [&](auto launch) {
    float best = 1e30f;
    for (int rep = 0; rep < 3; ++rep) {
      cudaEventRecord(a);
      launch();
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      if (rep) best = ms < best ? ms : best;
    }
    return bytes / best / 1e6;
  };
  const int slots[][2] = {{26624, 7}, {106496, 2}, {6656, 16}};
  for (auto& sl : slots)
    printf("[feed] bulk copies of %d B, %d slots: %.1f GB/s per SM\n", sl[0],
           sl[1], rate([&] {
             bulk_ring<<<2, 64, sl[0] * sl[1]>>>(buf, bytes, sl[0], sl[1],
                                                 sink);
           }));
  for (int w = 1; w <= 4; ++w)
    printf("[feed] cp.async by %d warp(s), 32 KB in flight each: %.1f GB/s "
           "per SM\n", w, rate([&] {
             warp_rings<<<2, 32 * w, w * 8 * 4096>>>(buf, bytes, sink);
           }));
  const cudaError_t err = cudaDeviceSynchronize();
  printf("[feed] %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
