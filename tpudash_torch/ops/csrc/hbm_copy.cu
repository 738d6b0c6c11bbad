// Device-memory copy pass: dst[i] = src[i] over n f32 values.
//
// Replaces the Pallas kernel tpudash/ops/probes.py::_copy_kernel (with
// _hbm_copy_once and the loop _hbm_copy_loop that chains it).
//
// Bound on an H100 SXM5: the pass reads n*4 bytes and writes n*4 bytes and
// computes nothing.  At the probe's 256 MiB buffer that is 537 MB / 3.35 TB/s
// = 160 us: bound by bytes.
//
// Design: a persistent grid of two CTAs per SM, each with a ring of 3 stages
// of 32 KiB in dynamic shared memory that one thread keeps full with
// Hopper's bulk asynchronous copies (TMA, 1-D form, no tensor map).  No byte
// passes through registers.
// - The flat body of n/4 float4s is cut into tiles of tile_bytes; the bytes
//   past the last whole tile form one shorter item (a multiple of 16 bytes).
//   CTA b takes items b, b + grid, b + 2*grid, ... (interleaved), so at any
//   moment the grid streams one contiguous window of the buffer; this
//   measured faster than one contiguous run of tiles per CTA.
// - Load: mbarrier.arrive.expect_tx for the item's bytes, then
//   cp.async.bulk global -> shared with mbarrier::complete_tx completion.
// - Store: once the stage's mbarrier phase completes (try_wait.parity; the
//   parity flips each time round the ring), cp.async.bulk shared -> global
//   in a bulk group.  Bulk groups belong to the thread, so the one thread
//   that issues does all the waiting.
// - Reuse: loads run stages - 1 items ahead of the stores.  The load of
//   item k + stages - 1 goes into the stage that item k - 1 was stored
//   from, after cp.async.bulk.wait_group.read 1 (every store but the newest
//   has finished reading shared memory).  The CTA waits for all its stores
//   (wait_group 0) before it exits.
// - L2 policy: evict_first on every load and store.  Neither side is read
//   again within a pass and the buffer is five times the 50 MB L2; the hint
//   measured slightly faster than none, and is kept for that.
// - The n % 4 floats past the last float4 are copied by threads 1..3 of
//   CTA 0 with plain loads and stores.
// - A wait that sees no progress for kWatchdogNs traps, so a fault in the
//   ring fails the launch instead of hanging the card.
// Grid, tile bytes and stages come from the caller
// (tpudash_torch/ops/kernels.py::_copy_plan), which keeps the arithmetic
// that cuts the buffer testable on a host without a GPU.  The C entry owns
// the limits: it returns cudaErrorInvalidValue for a plan the kernel cannot
// run, a ring larger than a block's shared memory included.  The variants
// measured against this one (CTAs per SM, ring shapes, tile order, L2 hint)
// are built and timed by tools/copy_sweep.py; PERF.md has the numbers.
//
// The caller checks: both pointers 16-byte aligned, contiguous f32, no
// overlap.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxStages = 8;
constexpr int kMaxDevices = 64;
// the mbarrier's transaction count holds less than 2^20 bytes
constexpr int kMaxTileBytes = (1 << 20) - 16;
constexpr unsigned long long kWatchdogNs = 30ull * 1000 * 1000 * 1000;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const unsigned long long t0 = globaltimer_ns();
  while (!bar_try_wait(bar, parity)) {
    if (globaltimer_ns() - t0 > kWatchdogNs) __trap();
  }
}

// an L2 policy that marks the lines a copy touches first to be evicted
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes,
                                           unsigned long long policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
               ::"l"(dst), "r"(src), "r"(bytes), "l"(policy)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// This CTA's items are first, first + step, ... (count of them).
__device__ __forceinline__ void cta_items(long long n_items, long long& first, long long& step,
                                          long long& count) {
  const long long b = blockIdx.x, g = gridDim.x;
  first = b;
  step = g;
  count = b < n_items ? (n_items - 1 - b) / g + 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
copy_ring(const char* __restrict__ src, char* __restrict__ dst, int tile_bytes, int stages,
          long long n_tiles, int tail_bytes, int tail_floats) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[kMaxStages];

  if (blockIdx.x == 0 && threadIdx.x >= 1 && threadIdx.x <= tail_floats) {
    const long long i =
        (n_tiles * tile_bytes + tail_bytes) / 4 + static_cast<long long>(threadIdx.x) - 1;
    reinterpret_cast<float*>(dst)[i] = reinterpret_cast<const float*>(src)[i];
  }
  if (threadIdx.x != 0) return;

  long long first, step, count;
  cta_items(n_tiles + (tail_bytes > 0 ? 1 : 0), first, step, count);
  if (count == 0) return;
  for (int s = 0; s < stages; ++s) bar_init(smem_addr(&full[s]));
  // make the initialised barriers visible to the async proxy (the TMA unit)
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  const unsigned long long policy = evict_first_policy();
  const uint32_t ring0 = smem_addr(ring);
  const uint32_t bar0 = smem_addr(&full[0]);
  auto load = [&](long long k, int s) {
    const long long item = first + k * step;
    const uint32_t bytes = item < n_tiles ? tile_bytes : tail_bytes;
    const uint32_t bar = bar0 + 8u * s;
    bar_expect_tx(bar, bytes);
    bulk_load(ring0 + static_cast<uint32_t>(s) * tile_bytes, src + item * tile_bytes, bytes, bar,
              policy);
  };

  const long long ahead = count < stages - 1 ? count : stages - 1;
  for (long long k = 0; k < ahead; ++k) load(k, static_cast<int>(k));
  int s = 0;
  uint32_t parity = 0;
  for (long long k = 0; k < count; ++k) {
    bar_wait(bar0 + 8u * s, parity);
    const long long item = first + k * step;
    bulk_store(dst + item * tile_bytes, ring0 + static_cast<uint32_t>(s) * tile_bytes,
               item < n_tiles ? tile_bytes : tail_bytes, policy);
    if (k + stages - 1 < count) {
      // the stage item k - 1 was stored from takes item k + stages - 1
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(k + stages - 1, s == 0 ? stages - 1 : s - 1);
    }
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// the dynamic shared memory a launch may ask for, per device (0: not set
// yet): the opt-in maximum of a block less the kernel's static barriers
std::atomic<int> g_max_ring_bytes[kMaxDevices];

}  // namespace

extern "C" int tpudash_hbm_copy(const float* src, float* dst, int grid, int tile_bytes,
                                int stages, long long n_tiles, int tail_bytes, int tail_floats,
                                int device, cudaStream_t stream) {
  if (grid < 1 || tile_bytes < 16 || tile_bytes % 16 || tile_bytes > kMaxTileBytes ||
      stages < 2 || stages > kMaxStages || n_tiles < 0 || tail_bytes < 0 || tail_bytes % 16 ||
      tail_bytes >= tile_bytes || tail_floats < 0 || tail_floats > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  // this library links its own CUDA runtime: select the tensors' device here
  // rather than rely on the caller's runtime having made it current
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_ring = g_max_ring_bytes[device].load();
  if (max_ring == 0) {
    // let every launch ask for all of it (set once per device)
    int optin = 0;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncGetAttributes(&attr, copy_ring);
    if (err != cudaSuccess) return static_cast<int>(err);
    max_ring = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(copy_ring, cudaFuncAttributeMaxDynamicSharedMemorySize, max_ring);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_max_ring_bytes[device].store(max_ring);
  }
  const long long smem = static_cast<long long>(stages) * tile_bytes;
  if (smem > max_ring) return static_cast<int>(cudaErrorInvalidValue);
  copy_ring<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      reinterpret_cast<const char*>(src), reinterpret_cast<char*>(dst), tile_bytes, stages,
      n_tiles, tail_bytes, tail_floats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpudash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
