// RMSNorm of the model step, forward and backward, over the rows of a
// contiguous (rows, d) bf16 x with an f32 scale of length d:
//   y      = bf16((f32(x) * r) * scale),  r = rsqrt(mean(f32(x)^2) + eps)
//   dx     = bf16(r * (g * scale - xh * mean(g * scale * xh))),  xh = f32(x) * r
//   dscale = sum over rows of f32(g) * xh
// with every step in f32 and one rounding to bf16, at the reference's
// rounding points (tpudash/models/workload.py::_rmsnorm, and autograd of it).
// eps is the caller's: 1e-6 for the demo model and DeepSeek-V2-Lite, 1e-5
// for Kimi-Linear.
//
// Replaces no Pallas kernel: the reference leaves the norm to XLA, which
// fuses it.  Plain PyTorch runs the same expression as ~8 full f32 passes
// forward and ~15 backward (the casts, x*x, the mean, rsqrt, the broadcast
// products, and autograd's mirror of each), so every tp column of the
// sharded step paid ~1.2 GB of traffic a norm for ~0.08 GB of work.
//
// Bound on an H100 SXM5: bytes.  Forward reads x and writes y, 4 bytes a
// value: at the tp step's (8176, 1024), 33.5 MB / 3.35 TB/s = 10.0 us.
// Backward reads x and g and writes dx, 6 bytes a value: 50.2 MB, 15.0 us.
// The arithmetic (about 5 and 10 f32 operations a value) takes about 1 us
// at 67 TFLOP/s.  So the design's one job is to touch each byte once:
// - A team of WPR warps owns a row.  Each thread holds VPT 16-byte vectors
//   (8 values) of it in registers, loaded once: the row's sum of squares
//   (and, backward, the dot of g*scale with xh) is reduced by a butterfly of
//   shuffles within each warp, then across the team's warps in warp order
//   through shared memory, so that every thread of the team ends with the
//   same bits, and the second use of x reads registers, not memory.
//   WPR = 1 up to d = 1024 (VPT = d / 256 rounded up), and doubles up to 8
//   warps (the whole block) for d = 8192.
// - Forward: one row a team, a grid of ceil(rows / teams) blocks.
// - Backward: a fixed grid of at most kMaxBackwardBlocks blocks; team t of
//   block b takes rows b*teams + t, then every (grid * teams) rows after.
//   Each thread adds its columns' g * xh over its rows, in row order, in
//   registers; the block adds its teams' sums in team order in shared
//   memory and writes one partial row; a second kernel adds the partial
//   rows in a fixed order (kFinishSegments runs of consecutive rows, then
//   the runs in order).  No float atomics: dscale's bits depend only on the
//   shape and the inputs, so every tp column's replica of a norm gets the
//   same gradient.  The partials add grid * d * 8 bytes (2.2 MB at the tp
//   step's shape, 4 % of the pass).
//
// Plan (VPT, WPR, grids) comes from the caller
// (tpudash_torch/ops/kernels.py::_norm_plan), which keeps its arithmetic
// testable on a host without a GPU; the C entries refuse a plan the kernels
// cannot run with cudaErrorInvalidValue.  The caller checks: x, g, y and dx
// contiguous bf16, scale and the partials contiguous f32, every pointer
// 16-byte aligned, d a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8192;
constexpr int kMaxVecs = 4;              // 16-byte vectors a thread holds of its row
constexpr int kMaxBackwardBlocks = 264;  // two blocks on each of an H100's 132 SMs
constexpr int kFinishSegments = kWarps;
constexpr int kFinishUnroll = 8;

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ void load_scale8(const float4* scale, int v, float (&s)[8]) {
  const float4 a = __ldg(scale + 2 * v);
  const float4 b = __ldg(scale + 2 * v + 1);
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

// The sum of v over the WPR warps of the calling thread's team, the same
// bits in every thread of the team.  With WPR > 1 every thread of the block
// must call it (it holds two barriers).
template <int WPR>
__device__ __forceinline__ float team_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (WPR == 1) {
    return v;
  } else {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) red[warp] = v;
    __syncthreads();
    const int first = warp / WPR * WPR;
    float s = red[first];
#pragma unroll
    for (int i = 1; i < WPR; ++i) s += red[first + i];
    __syncthreads();
    return s;
  }
}

template <int VPT, int WPR>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_forward(const uint4* __restrict__ x, const float4* __restrict__ scale,
                uint4* __restrict__ y, int rows, int d8, float eps) {
  __shared__ float red[kWarps];
  constexpr int kTeams = kWarps / WPR;
  const int t = threadIdx.x % (32 * WPR);
  const long long row = static_cast<long long>(blockIdx.x) * kTeams + threadIdx.x / (32 * WPR);
  const bool live = row < rows;
  uint4 raw[VPT];
  float sc[VPT][8];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = t + k * 32 * WPR;
    raw[k] = (live && v < d8) ? __ldg(x + row * d8 + v) : make_uint4(0u, 0u, 0u, 0u);
    if (v < d8) load_scale8(scale, v, sc[k]);
    float f[8];
    unpack8(raw[k], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += f[i] * f[i];
  }
  ss = team_sum<WPR>(ss, red);
  const float r = rsqrtf(ss / static_cast<float>(8 * d8) + eps);
  if (!live) return;  // past the last barrier
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = t + k * 32 * WPR;
    if (v < d8) {
      float f[8];
      unpack8(raw[k], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = (f[i] * r) * sc[k][i];
      y[row * d8 + v] = pack8(f);
    }
  }
}

template <int VPT, int WPR>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_backward(const uint4* __restrict__ x, const float4* __restrict__ scale,
                 const uint4* __restrict__ g, uint4* __restrict__ dx,
                 float4* __restrict__ partial, int rows, int d8,
                 float eps) {
  __shared__ float red[kWarps];
  __shared__ float4 colsum[kMaxD / 4];
  constexpr int kTeams = kWarps / WPR;
  const int team = threadIdx.x / (32 * WPR);
  const int t = threadIdx.x % (32 * WPR);
  const float d = static_cast<float>(8 * d8);
  const long long stride = static_cast<long long>(gridDim.x) * kTeams;
  const long long first = static_cast<long long>(blockIdx.x) * kTeams + team;
  // every team runs the same number of rounds, so the team sums' barriers match
  const long long rounds = (rows + stride - 1) / stride;
  float acc[VPT][8], sc[VPT][8];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[k][i] = sc[k][i] = 0.f;
    if (t + k * 32 * WPR < d8) load_scale8(scale, t + k * 32 * WPR, sc[k]);
  }

  for (long long it = 0; it < rounds; ++it) {
    const long long row = first + it * stride;
    const bool live = row < rows;
    uint4 xraw[VPT], graw[VPT];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = t + k * 32 * WPR;
      const bool in = live && v < d8;
      xraw[k] = in ? __ldg(x + row * d8 + v) : make_uint4(0u, 0u, 0u, 0u);
      graw[k] = in ? __ldg(g + row * d8 + v) : make_uint4(0u, 0u, 0u, 0u);
      float f[8];
      unpack8(xraw[k], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss += f[i] * f[i];
    }
    ss = team_sum<WPR>(ss, red);
    const float r = rsqrtf(ss / d + eps);
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = t + k * 32 * WPR;
      if (v < d8) {  // rows past the end hold zeros and add nothing
        float f[8], gf[8];
        unpack8(xraw[k], f);
        unpack8(graw[k], gf);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xh = f[i] * r;
          acc[k][i] += gf[i] * xh;
          dot += (gf[i] * sc[k][i]) * xh;
        }
      }
    }
    dot = team_sum<WPR>(dot, red);
    const float mean = dot / d;
    if (live) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int v = t + k * 32 * WPR;
        if (v < d8) {
          float f[8], gf[8];
          unpack8(xraw[k], f);
          unpack8(graw[k], gf);
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = r * (gf[i] * sc[k][i] - (f[i] * r) * mean);
          dx[row * d8 + v] = pack8(f);
        }
      }
    }
  }

  // the block's teams' column sums, added in team order
  for (int tm = 0; tm < kTeams; ++tm) {
    if (team == tm) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int v = t + k * 32 * WPR;
        if (v < d8) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float4 a = make_float4(acc[k][4 * h], acc[k][4 * h + 1], acc[k][4 * h + 2],
                                   acc[k][4 * h + 3]);
            if (tm > 0) {
              const float4 c = colsum[2 * v + h];
              a = make_float4(c.x + a.x, c.y + a.y, c.z + a.z, c.w + a.w);
            }
            colsum[2 * v + h] = a;
          }
        }
      }
    }
    __syncthreads();
  }
  const int d4 = 2 * d8;
  for (int j = threadIdx.x; j < d4; j += kThreads)
    partial[static_cast<long long>(blockIdx.x) * d4 + j] = colsum[j];
}

// dscale[c] = the sum of partial[b][c] over the blocks b: kFinishSegments
// warps each add a run of consecutive rows in order, then warp 0 adds the
// runs in order.  A block covers 32 columns.
__global__ void __launch_bounds__(kThreads)
rmsnorm_backward_finish(const float* __restrict__ partial, float* __restrict__ dscale,
                        int blocks, int d) {
  __shared__ float seg[kFinishSegments][32];
  const int lane = threadIdx.x % 32;
  const int s = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const int per = (blocks + kFinishSegments - 1) / kFinishSegments;
  const int b0 = s * per;
  const int b1 = min(blocks, b0 + per);
  float acc = 0.f;
  if (col < d) {
    const float* p = partial + col;
    int b = b0;
    for (; b + kFinishUnroll <= b1; b += kFinishUnroll) {  // loads in flight, adds in order
      float v[kFinishUnroll];
#pragma unroll
      for (int u = 0; u < kFinishUnroll; ++u) v[u] = p[static_cast<long long>(b + u) * d];
#pragma unroll
      for (int u = 0; u < kFinishUnroll; ++u) acc += v[u];
    }
    for (; b < b1; ++b) acc += p[static_cast<long long>(b) * d];
  }
  seg[s][lane] = acc;
  __syncthreads();
  if (s == 0 && col < d) {
    float total = seg[0][lane];
#pragma unroll
    for (int j = 1; j < kFinishSegments; ++j) total += seg[j][lane];
    dscale[col] = total;
  }
}

// Makes `device` current for this library's runtime, and the caller's device
// current again when it goes out of scope.  This library links its own CUDA
// runtime, which shares the thread's current context with the caller's:
// left switched, the caller (PyTorch, capturing a graph over several GPUs)
// would find itself on the last device a norm ran on.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) err_ = cudaSetDevice(device);
  }
  ~DeviceScope() {
    int now = -1;
    if (cudaGetDevice(&now) == cudaSuccess && now != prev_ && prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_;
};

bool plan_ok(int rows, int d, int vpt, int wpr) {
  return rows >= 1 && d >= 8 && d % 8 == 0 && d <= kMaxD && vpt >= 1 && vpt <= kMaxVecs &&
         (wpr == 1 || wpr == 2 || wpr == 4 || wpr == 8) && vpt * wpr * 32 * 8 >= d;
}

}  // namespace

// every (VPT, WPR) the plan may give
#define TPUDASH_NORM_PLANS(X)                                                   \
  X(1, 1) X(2, 1) X(3, 1) X(4, 1) X(1, 2) X(2, 2) X(3, 2) X(4, 2) X(1, 4) X(2, 4) \
  X(3, 4) X(4, 4) X(1, 8) X(2, 8) X(3, 8) X(4, 8)

extern "C" int tpudash_rmsnorm_forward(const void* x, const float* scale, void* y, int rows,
                                       int d, int vpt, int wpr, int grid, float eps,
                                       int device, cudaStream_t stream) {
  if (!plan_ok(rows, d, vpt, wpr) || grid < 1 ||
      static_cast<long long>(grid) * (kWarps / wpr) < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const int d8 = d / 8;
#define TPUDASH_LAUNCH(V, W)                                                          \
  if (vpt == V && wpr == W) {                                                         \
    rmsnorm_forward<V, W><<<grid, kThreads, 0, stream>>>(                             \
        static_cast<const uint4*>(x), reinterpret_cast<const float4*>(scale),        \
        static_cast<uint4*>(y), rows, d8, eps);                                       \
    return static_cast<int>(cudaGetLastError());                                      \
  }
  TPUDASH_NORM_PLANS(TPUDASH_LAUNCH)
#undef TPUDASH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tpudash_rmsnorm_backward(const void* x, const float* scale, const void* g,
                                        void* dx, float* partial, float* dscale, int rows,
                                        int d, int vpt, int wpr, int grid, float eps,
                                        int device, cudaStream_t stream) {
  if (!plan_ok(rows, d, vpt, wpr) || grid < 1 || grid > kMaxBackwardBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const int d8 = d / 8;
  bool launched = false;
#define TPUDASH_LAUNCH(V, W)                                                          \
  if (vpt == V && wpr == W) {                                                         \
    rmsnorm_backward<V, W><<<grid, kThreads, 0, stream>>>(                            \
        static_cast<const uint4*>(x), reinterpret_cast<const float4*>(scale),        \
        static_cast<const uint4*>(g), static_cast<uint4*>(dx),                       \
        reinterpret_cast<float4*>(partial), rows, d8, eps);                           \
    launched = true;                                                                  \
  }
  TPUDASH_NORM_PLANS(TPUDASH_LAUNCH)
#undef TPUDASH_LAUNCH
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_backward_finish<<<(d + 31) / 32, kThreads, 0, stream>>>(partial, dscale, grid, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpudash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
