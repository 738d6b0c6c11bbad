// The dropless MoE dispatch of the DeepSeek-V2-Lite step
// (tpudash_torch/models/deepseek_v2.py::_held_experts), forward and backward,
// over the buffer of (token, choice) pairs sorted by held expert:
//   gather    xs[pos[t,k]] = x[t]
//             dx[t] = bf16(sum over k of f32(dxs[pos[t,k]]))
//   SwiGLU    act[p] = bf16(silu(f32 gate[p]) * f32 up[p]),  h[p] = [gate | up]
//             dgate = bf16(silu'(gate) * (f32 dact * f32 up)),  dup = bf16(f32 dact * silu(gate))
//   combine   y[t] = bf16(sum over k of g[t,k] * f32(ys[pos[t,k]]))
//             dys[pos[t,k]] = bf16(g[t,k] * f32(dy[t])),  dg[t,k] = sum_d f32(dy[t]) * f32(ys[pos[t,k]])
// Every sum over k runs in k order and counts only the choices whose row is
// valid, pos[t,k] < n_valid; every value in f32, rounded once to bf16, at the
// precision points of the module's docstring.
//
// Replaces no Pallas kernel: the reference's MoE (tpudash/models/moe.py) is a
// dense one-hot product and has no dispatch.  Added because plain PyTorch ran
// every pass of this layer over the whole static buffer of
// cap = S * min(top_k, held) rows, while only the first n_valid = offs[-1] are
// valid (about 12.5 % with 8 of 64 experts held, top-6): a zero-padded
// gather, two f32 copies of the SwiGLU's input, an f32 broadcast product of
// the buffer with the gates and an index_add whose invalid rows all added
// into one dropped row, about 1.7 TB of traffic a step of 26 layers.
//
// Bound on an H100 SXM5: bytes (one f32 operation or a few a value, against
// about 300 the tensor cores would need a byte).  Each kernel moves the bytes
// of the valid rows once, and of the (S, d) token tensors once:
//   gather forward   x's rows of tokens with a valid choice, then n_valid rows written
//   gather backward  n_valid rows read, S rows written
//   SwiGLU           n_valid rows of h (and dact) read, of act (or dh) written
//   combine forward  n_valid rows read, S rows written
//   combine backward dy's rows of tokens with a valid choice, n_valid rows of ys
//                    read and of dys written, the gates' gradient (S, K)
// So the design's jobs are to touch no invalid row and to stream the rest:
// - n_valid is read from device memory (the grouped products' offsets) by
//   every thread, so that no shape depends on it and the step stays one CUDA
//   graph.  Invalid rows cost no block and no byte; rows from n_valid on are
//   never written, and never read.
// - A persistent grid of a few blocks a SM walks the work with a grid stride:
//   tokens for the gather and the combine (one warp a token), 16-byte
//   vectors of the valid rows for the SwiGLU (one thread a vector).
// - Token-major: a token's warp reads its K positions and gates once (lane k
//   holds choice k, a ballot gives the valid ones), then walks the row in
//   16-byte vectors.  Every output row has one writer, so there are no
//   atomics: each result's bits depend only on the inputs, and a token with
//   no valid choice writes zeros.  pos is the inverse of the stable sort by
//   held slot, so a choice of an expert held elsewhere sorts after every
//   held one and is invalid.
//
// The caller (tpudash_torch/ops/kernels.py::moe_*) checks: bf16 row tensors
// contiguous and 16-byte aligned, row widths (d, and f for the SwiGLU's
// halves) multiples of 8, pos (S, K) contiguous int32, gates (S, K)
// contiguous f32, n_valid one int32 on the same device, 1 <= K <= kMaxK.
// The C entries refuse other sizes with cudaErrorInvalidValue; n_valid is
// clamped to [0, cap] on the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;  // choices a token may make
constexpr unsigned kFull = 0xffffffffu;

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

// The valid rows of the sorted buffer, read on the device, within [0, cap].
__device__ __forceinline__ int valid_rows(const int* n_valid, int cap) {
  const int n = __ldg(n_valid);
  return n < 0 ? 0 : (n > cap ? cap : n);
}

// A token's choices, the same in every lane of its warp: the row of choice k
// in row[k], its gate in gate[k] (1 without gates), and a bit for each valid
// one in the returned mask.  Every lane of the warp must call it.
__device__ __forceinline__ unsigned token_choices(const int* __restrict__ pos,
                                                  const float* __restrict__ gates, long long t,
                                                  int K, int n_valid, long long (&row)[kMaxK],
                                                  float (&gate)[kMaxK]) {
  const int lane = threadIdx.x % 32;
  int p = -1;
  float g = 1.f;
  if (lane < K) {
    p = __ldg(pos + t * K + lane);
    if (gates != nullptr) g = __ldg(gates + t * K + lane);
  }
  const unsigned mask = __ballot_sync(kFull, lane < K && p >= 0 && p < n_valid);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    row[k] = __shfl_sync(kFull, p, k);
    gate[k] = __shfl_sync(kFull, g, k);
  }
  return mask;
}

// Gather forward: each valid choice's row of xs gets its token's row of x,
// read once for all of the token's choices.
template <int U>
__global__ void __launch_bounds__(kThreads)
moe_gather_forward(const uint4* __restrict__ x, const int* __restrict__ pos,
                   const int* __restrict__ n_valid, uint4* __restrict__ xs, int S, int K, int cap,
                   int d8) {
  const int lane = threadIdx.x % 32;
  const int n = valid_rows(n_valid, cap);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long t = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32; t < S;
       t += stride) {
    long long row[kMaxK];
    float gate[kMaxK];
    const unsigned mask = token_choices(pos, nullptr, t, K, n, row, gate);
    if (mask == 0) continue;
    for (int v0 = lane; v0 < d8; v0 += 32 * U) {
      uint4 r[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + 32 * u < d8) r[u] = __ldg(x + t * d8 + v0 + 32 * u);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (!((mask >> k) & 1u)) continue;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (v0 + 32 * u < d8) xs[row[k] * d8 + v0 + 32 * u] = r[u];
      }
    }
  }
}

// out[t] = bf16(sum over the token's valid choices, in k order, of
// gate * f32(rows[pos[t,k]])): the gather's backward (no gates, a plain sum)
// and the combine's forward (the gates).  Every token's row is written.
template <bool kGated, int U>
__global__ void __launch_bounds__(kThreads)
moe_sum_rows(const uint4* __restrict__ rows, const float* __restrict__ gates,
             const int* __restrict__ pos, const int* __restrict__ n_valid,
             uint4* __restrict__ out, int S, int K, int cap, int d8) {
  const int lane = threadIdx.x % 32;
  const int n = valid_rows(n_valid, cap);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long t = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32; t < S;
       t += stride) {
    long long row[kMaxK];
    float gate[kMaxK];
    const unsigned mask = token_choices(pos, kGated ? gates : nullptr, t, K, n, row, gate);
    for (int v0 = lane; v0 < d8; v0 += 32 * U) {
      float acc[U][8];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[u][i] = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (!((mask >> k) & 1u)) continue;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (v0 + 32 * u >= d8) continue;
          float f[8];
          unpack8(__ldg(rows + row[k] * d8 + v0 + 32 * u), f);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[u][i] = __fadd_rn(acc[u][i], kGated ? __fmul_rn(gate[k], f[i]) : f[i]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + 32 * u < d8) out[t * d8 + v0 + 32 * u] = pack8(acc[u]);
    }
  }
}

// The combine's backward: for each valid choice, dys's row gets the gated
// gradient of its token, and dgates[t,k] the dot of dy[t] with ys's row
// (each lane's share over its vectors in order, then a butterfly of
// shuffles); an invalid choice's dgates is 0.
__global__ void __launch_bounds__(kThreads)
moe_combine_backward(const uint4* __restrict__ dy, const uint4* __restrict__ ys,
                     const float* __restrict__ gates, const int* __restrict__ pos,
                     const int* __restrict__ n_valid, uint4* __restrict__ dys,
                     float* __restrict__ dgates, int S, int K, int cap, int d8) {
  const int lane = threadIdx.x % 32;
  const int n = valid_rows(n_valid, cap);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long t = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32; t < S;
       t += stride) {
    long long row[kMaxK];
    float gate[kMaxK];
    const unsigned mask = token_choices(pos, gates, t, K, n, row, gate);
    float dot[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) dot[k] = 0.f;
    if (mask != 0) {
      for (int v = lane; v < d8; v += 32) {
        float g[8];
        unpack8(__ldg(dy + t * d8 + v), g);
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (!((mask >> k) & 1u)) continue;
          float y[8], o[8];
          unpack8(__ldg(ys + row[k] * d8 + v), y);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            dot[k] += g[i] * y[i];
            o[i] = __fmul_rn(gate[k], g[i]);
          }
          dys[row[k] * d8 + v] = pack8(o);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= K) break;
      float s = dot[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (lane == k) dgates[t * K + k] = ((mask >> k) & 1u) ? s : 0.f;
    }
  }
}

// silu(x) = x / (1 + exp(-x)), and its sigmoid, as PyTorch computes them.
__device__ __forceinline__ float sigmoid_of(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}
__device__ __forceinline__ float silu_of(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// SwiGLU forward over the valid rows of h = [gate | up] (each half f8
// vectors wide): one 16-byte vector of act a thread and step.
__global__ void __launch_bounds__(kThreads)
moe_swiglu_forward(const uint4* __restrict__ h, const int* __restrict__ n_valid,
                   uint4* __restrict__ act, int cap, int f8) {
  const long long total = static_cast<long long>(valid_rows(n_valid, cap)) * f8;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += stride) {
    const long long p = i / f8;
    const long long v = i - p * f8;
    float g[8], u[8];
    unpack8(__ldg(h + p * 2 * f8 + v), g);
    unpack8(__ldg(h + p * 2 * f8 + f8 + v), u);
#pragma unroll
    for (int j = 0; j < 8; ++j) g[j] = __fmul_rn(silu_of(g[j]), u[j]);
    act[i] = pack8(g);
  }
}

// SwiGLU backward: autograd's chain for the forward's expression, in f32:
// the product's gradients (dact * up for silu's output, dact * silu(gate)
// for up), then silu's, dy * s * (1 + x * (1 - s)) with s = sigmoid(x).
__global__ void __launch_bounds__(kThreads)
moe_swiglu_backward(const uint4* __restrict__ h, const uint4* __restrict__ dact,
                    const int* __restrict__ n_valid, uint4* __restrict__ dh, int cap, int f8) {
  const long long total = static_cast<long long>(valid_rows(n_valid, cap)) * f8;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += stride) {
    const long long p = i / f8;
    const long long v = i - p * f8;
    float g[8], u[8], a[8], dg[8], du[8];
    unpack8(__ldg(h + p * 2 * f8 + v), g);
    unpack8(__ldg(h + p * 2 * f8 + f8 + v), u);
    unpack8(__ldg(dact + i), a);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s = sigmoid_of(g[j]);
      const float ds = __fmul_rn(a[j], u[j]);
      dg[j] = __fmul_rn(__fmul_rn(ds, s), __fadd_rn(1.f, __fmul_rn(g[j], __fsub_rn(1.f, s))));
      du[j] = __fmul_rn(a[j], silu_of(g[j]));
    }
    dh[p * 2 * f8 + v] = pack8(dg);
    dh[p * 2 * f8 + f8 + v] = pack8(du);
  }
}

// Vectors a lane keeps in flight in the gather and the sums over choices.
constexpr int kUnroll = 2;

// Makes `device` current for this library's runtime, and the caller's device
// current again when it goes out of scope (csrc/rmsnorm.cu says why).
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

bool tokens_ok(int S, int K, int cap, int d, int grid) {
  return S >= 0 && K >= 1 && K <= kMaxK && cap >= 0 && d >= 8 && d % 8 == 0 && grid >= 1 &&
         static_cast<long long>(S) * K < (1LL << 31);
}

bool rows_ok(int cap, int f, int grid) { return cap >= 0 && f >= 8 && f % 8 == 0 && grid >= 1; }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

extern "C" int tpudash_moe_gather_forward(const void* x, const int* pos, const int* n_valid,
                                          void* xs, int S, int K, int cap, int d, int grid,
                                          int device, cudaStream_t stream) {
  if (!tokens_ok(S, K, cap, d, grid)) return invalid();
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  moe_gather_forward<kUnroll><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), pos, n_valid, static_cast<uint4*>(xs), S, K, cap, d / 8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpudash_moe_gather_backward(const void* dxs, const int* pos, const int* n_valid,
                                           void* dx, int S, int K, int cap, int d, int grid,
                                           int device, cudaStream_t stream) {
  if (!tokens_ok(S, K, cap, d, grid)) return invalid();
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  moe_sum_rows<false, kUnroll><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(dxs), nullptr, pos, n_valid, static_cast<uint4*>(dx), S, K, cap,
      d / 8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpudash_moe_swiglu_forward(const void* h, const int* n_valid, void* act, int cap,
                                          int f, int grid, int device, cudaStream_t stream) {
  if (!rows_ok(cap, f, grid)) return invalid();
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  moe_swiglu_forward<<<grid, kThreads, 0, stream>>>(static_cast<const uint4*>(h), n_valid,
                                                    static_cast<uint4*>(act), cap, f / 8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpudash_moe_swiglu_backward(const void* h, const void* dact, const int* n_valid,
                                           void* dh, int cap, int f, int grid, int device,
                                           cudaStream_t stream) {
  if (!rows_ok(cap, f, grid)) return invalid();
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  moe_swiglu_backward<<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(h), static_cast<const uint4*>(dact), n_valid,
      static_cast<uint4*>(dh), cap, f / 8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpudash_moe_combine_forward(const void* ys, const float* gates, const int* pos,
                                           const int* n_valid, void* y, int S, int K, int cap,
                                           int d, int grid, int device, cudaStream_t stream) {
  if (!tokens_ok(S, K, cap, d, grid)) return invalid();
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  moe_sum_rows<true, kUnroll><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(ys), gates, pos, n_valid, static_cast<uint4*>(y), S, K, cap,
      d / 8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpudash_moe_combine_backward(const void* dy, const void* ys, const float* gates,
                                            const int* pos, const int* n_valid, void* dys,
                                            float* dgates, int S, int K, int cap, int d,
                                            int grid, int device, cudaStream_t stream) {
  if (!tokens_ok(S, K, cap, d, grid)) return invalid();
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  moe_combine_backward<<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(dy), static_cast<const uint4*>(ys), gates, pos, n_valid,
      static_cast<uint4*>(dys), dgates, S, K, cap, d / 8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpudash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
