// Kimi Delta Attention's chunked gated delta rule
// (tpudash_torch/models/kimi_linear.py, through
// tpudash_torch/ops/kernels.py::kda_chunk), in f32, chunks of kC = 64
// positions, heads kD = 128 wide (keys and values).  Every tensor is
// (B, H, N, C, D) or (B, H, N, ...) contiguous f32; G is the cumulative sum
// of the log-decays inside each chunk (G_t <= G_s for s <= t, all <= 0).
//
//   kda_pairs_fwd  akk[t,s] = sum_c k_t k_s e^{G_t - G_s}  (s < t, else 0)
//                  aqk[t,s] = sum_c q_t k_s e^{G_t - G_s}  (s <= t, else 0)
//   kda_pairs_bwd  per channel c, with a = dakk (s < t), b = daqk (s <= t),
//                  E = e^{G_t - G_s}:
//                  R1_t = sum_s a E k_s,  R2_t = sum_s b E k_s,
//                  Col_s = sum_t (a k_t + b q_t) E;
//                  dq = R2, dk = R1 + Col, dG = k R1 + q R2 - k Col
//   kda_state_fwd  S_0 = 0; for n = 0 .. N-1:
//                    states[n] = S;  X = u_n - w_n S;  v_new[n] = X
//                    S = gamma_n * S + kd_n^T X
//                  states[N] = S
//   kda_state_bwd  D = gS[N]; for n = N-1 .. 0:
//                    dnext[n] = D;  X = gv_n + kd_n D;  dv[n] = X
//                    D = gamma_n * D + gS[n] - w_n^T X
//
// Every exponent is a difference G_t - G_s with s <= t: the pair kernels
// take it only below or on the diagonal, so no positive cumulative
// log-decay is ever exponentiated (the caller makes gamma = e^{G_C} and
// kd = k e^{G_C - G}, also non-positive exponents).
//
// Replaces no Pallas kernel: the JAX package has no linear attention (the
// model's reference is the benchmark's plain PyTorch,
// gpubench/reference/kimi_linear.py).  Added because the chunked algorithm
// needs (a) per-channel decays inside every (t, s) pair of a chunk, which
// batched PyTorch can only form as a (C, C, D) tensor a chunk, 2 GB a layer
// at the cell's shapes, and (b) a sequential pass over a sequence's 128
// chunks, which a Python loop would issue as thousands of launches a layer.
//
// Bounds on an H100 SXM5, at the cell's shapes (B 4, H 32, T 8,192: 16,384
// chunks a layer):
// - the pair kernels: 2,080 (t, s) pairs x 128 channels a chunk, an exp and
//   3 f32 products each forward: about 4.4e9 exps a call, bound by the
//   SMs' instruction rate, not by bytes (q, k, G read once: 1.6 GB);
// - the state pass: 2 x 64 x 128 x 128 multiply-adds a chunk and head,
//   6.9e10 f32 FLOPs a call, and states[] written once (1.1 GB);
// so on CUDA cores in f32 a few ms a call each.  The design keeps every
// operand in shared memory and every sum in registers:
// - pairs forward: a block a chunk; 256 threads, each a 4 x 4 tile of
//   (t, s); channels in slices of 32 staged in shared memory transposed
//   ([c][t], so a thread's 4 rows or 4 columns are one float4); tiles above
//   the diagonal write zeros and do no work.
// - pairs backward: a block a chunk; 256 threads, thread (c, parity) owns
//   channel c and the rows t of one parity; Col's 64 sums in registers, the
//   two parities' added through shared memory at the end; dq and the row
//   parts of dk and dG written first, the column parts added after one
//   barrier (each element has one writer at a time).
// - state pass: a block a (head, 32-column slab of the values): the slab's
//   columns of S are independent of the others', so 4 blocks a head walk
//   the chunks side by side; S in registers (16 values a thread) and in
//   shared memory, w and kd of the chunk staged in shared memory.
//
// The caller (tpudash_torch/ops/kernels.py::kda_*_forward/_backward) checks
// shapes, f32, contiguity, one device and 16-byte alignment; the C entries
// refuse a non-positive count with cudaErrorInvalidValue.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 64;         // chunk
constexpr int kD = 128;        // head width, keys and values
constexpr int kThreads = 256;
constexpr int kSlice = 32;     // channels a slice, pairs forward
constexpr int kPadT = kC + 4;  // row length of a transposed slice (float4-aligned)
constexpr int kSlab = 32;      // value columns a state block

// ---- pairs forward ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
kda_pairs_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ G, float* __restrict__ akk,
              float* __restrict__ aqk) {
  __shared__ __align__(16) float sq[kSlice][kPadT];
  __shared__ __align__(16) float sk[kSlice][kPadT];
  __shared__ __align__(16) float sg[kSlice][kPadT];
  const long long chunk = blockIdx.x;
  const float* qc = q + chunk * kC * kD;
  const float* kc = k + chunk * kC * kD;
  const float* gc = G + chunk * kC * kD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t0 = ty * 4, s0 = tx * 4;
  const bool live = tx <= ty;   // the tile holds a pair with s <= t
  const bool diag = tx == ty;
  float ak[4][4], aq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ak[i][j] = aq[i][j] = 0.f;

  for (int c0 = 0; c0 < kD; c0 += kSlice) {
    __syncthreads();  // the previous slice is read
    // 64 rows x 8 float4 of the slice, twice a thread, stored transposed
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int f = threadIdx.x + r * kThreads;
      const int t = f / 8, c4 = (f % 8) * 4;
      const long long off = static_cast<long long>(t) * kD + c0 + c4;
      const float4 vq = *reinterpret_cast<const float4*>(qc + off);
      const float4 vk = *reinterpret_cast<const float4*>(kc + off);
      const float4 vg = *reinterpret_cast<const float4*>(gc + off);
      sq[c4][t] = vq.x; sq[c4 + 1][t] = vq.y; sq[c4 + 2][t] = vq.z; sq[c4 + 3][t] = vq.w;
      sk[c4][t] = vk.x; sk[c4 + 1][t] = vk.y; sk[c4 + 2][t] = vk.z; sk[c4 + 3][t] = vk.w;
      sg[c4][t] = vg.x; sg[c4 + 1][t] = vg.y; sg[c4 + 2][t] = vg.z; sg[c4 + 3][t] = vg.w;
    }
    __syncthreads();
    if (live) {
      for (int c = 0; c < kSlice; ++c) {
        const float4 qt = *reinterpret_cast<const float4*>(&sq[c][t0]);
        const float4 kt = *reinterpret_cast<const float4*>(&sk[c][t0]);
        const float4 gt = *reinterpret_cast<const float4*>(&sg[c][t0]);
        const float4 ks = *reinterpret_cast<const float4*>(&sk[c][s0]);
        const float4 gs = *reinterpret_cast<const float4*>(&sg[c][s0]);
        const float qv[4] = {qt.x, qt.y, qt.z, qt.w};
        const float kv[4] = {kt.x, kt.y, kt.z, kt.w};
        const float gv[4] = {gt.x, gt.y, gt.z, gt.w};
        const float ksv[4] = {ks.x, ks.y, ks.z, ks.w};
        const float gsv[4] = {gs.x, gs.y, gs.z, gs.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (!diag || j <= i) {  // s <= t
              const float p = ksv[j] * expf(gv[i] - gsv[j]);
              ak[i][j] += kv[i] * p;
              aq[i][j] += qv[i] * p;
            }
          }
        }
      }
    }
  }
  float* akc = akk + chunk * kC * kC;
  float* aqc = aqk + chunk * kC * kC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + i;
    float4 vk, vq;
    float* pk = &vk.x;
    float* pq = &vq.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + j;
      pk[j] = (live && s < t) ? ak[i][j] : 0.f;
      pq[j] = (live && s <= t) ? aq[i][j] : 0.f;
    }
    *reinterpret_cast<float4*>(akc + t * kC + s0) = vk;
    *reinterpret_cast<float4*>(aqc + t * kC + s0) = vq;
  }
}

// ---- pairs backward -----------------------------------------------------------

// dynamic shared memory: a[64][64], b[64][64], k[64][128], G[64][128]
constexpr int kPairsBwdSmem = (2 * kC * kC + 2 * kC * kD) * static_cast<int>(sizeof(float));

__global__ void __launch_bounds__(kThreads)
kda_pairs_bwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ G, const float* __restrict__ dakk,
              const float* __restrict__ daqk, float* __restrict__ dq,
              float* __restrict__ dk, float* __restrict__ dG) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                // [t][s]
  float* sb = sa + kC * kC;        // [t][s]
  float* sk = sb + kC * kC;        // [t][c]
  float* sg = sk + kC * kD;        // [t][c]
  const long long chunk = blockIdx.x;
  const long long rows = chunk * kC * kD;
  const long long pairs = chunk * kC * kC;
  {
    const float4* a4 = reinterpret_cast<const float4*>(dakk + pairs);
    const float4* b4 = reinterpret_cast<const float4*>(daqk + pairs);
    const float4* k4 = reinterpret_cast<const float4*>(k + rows);
    const float4* g4 = reinterpret_cast<const float4*>(G + rows);
    for (int f = threadIdx.x; f < kC * kC / 4; f += kThreads) {
      reinterpret_cast<float4*>(sa)[f] = a4[f];
      reinterpret_cast<float4*>(sb)[f] = b4[f];
    }
    for (int f = threadIdx.x; f < kC * kD / 4; f += kThreads) {
      reinterpret_cast<float4*>(sk)[f] = k4[f];
      reinterpret_cast<float4*>(sg)[f] = g4[f];
    }
  }
  __syncthreads();
  const int c = threadIdx.x % kD;
  const int par = threadIdx.x / kD;
  float col[kC];
#pragma unroll
  for (int s = 0; s < kC; ++s) col[s] = 0.f;
  for (int t = par; t < kC; t += 2) {
    const float qt = q[rows + t * kD + c];
    const float kt = sk[t * kD + c];
    const float gt = sg[t * kD + c];
    float r1 = 0.f, r2 = 0.f;
#pragma unroll
    for (int s = 0; s < kC; ++s) {
      if (s <= t) {
        const float e = expf(gt - sg[s * kD + c]);
        const float ks = sk[s * kD + c];
        const float pa = (s < t ? sa[t * kC + s] : 0.f) * e;
        const float pb = sb[t * kC + s] * e;
        r1 += pa * ks;
        r2 += pb * ks;
        col[s] += pa * kt + pb * qt;
      }
    }
    dq[rows + t * kD + c] = r2;
    dk[rows + t * kD + c] = r1;
    dG[rows + t * kD + c] = kt * r1 + qt * r2;
  }
  __syncthreads();  // every row part written, sa and sb read
  if (par == 1) {
#pragma unroll
    for (int s = 0; s < kC; ++s) sa[s * kD + c] = col[s];  // sa and sb: kC x kD floats
  }
  __syncthreads();
  if (par == 0) {
#pragma unroll
    for (int s = 0; s < kC; ++s) {
      const float total = col[s] + sa[s * kD + c];
      const long long at = rows + s * kD + c;
      dk[at] += total;
      dG[at] -= sk[s * kD + c] * total;
    }
  }
}

// ---- state pass ---------------------------------------------------------------

// dynamic shared memory: ma[64][128], mb[64][128], S[128][32], X[64][32], gamma[128]
constexpr int kStateSmem =
    (2 * kC * kD + kD * kSlab + kC * kSlab + kD) * static_cast<int>(sizeof(float));

// One (head, slab) block of the pass.  Forward: ma = w, mb = kd, p = u, out
// = states (N + 1 slots), x_out = v_new.  Backward: ma = kd, mb = w, p = gv,
// extra = gS (N + 1 slots), out = dnext (N slots), x_out = dv.
template <bool kBackward>
__device__ __forceinline__ void state_pass(const float* __restrict__ ma,
                                           const float* __restrict__ mb,
                                           const float* __restrict__ p,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ extra,
                                           float* __restrict__ out,
                                           float* __restrict__ x_out, int N) {
  extern __shared__ __align__(16) float smem[];
  float* sma = smem;               // [t][c]
  float* smb = sma + kC * kD;      // [t][c]
  float* sS = smb + kC * kD;       // [c][j]
  float* sX = sS + kD * kSlab;     // [t][j]
  float* sgam = sX + kC * kSlab;   // [c]
  const int slab = blockIdx.x * kSlab;
  const long long head = blockIdx.y;
  const int j = threadIdx.x % 32;
  const int r0 = threadIdx.x / 32;  // rows r0 + 8 i
  const long long slots = kBackward ? N : N + 1;  // of out
  float S[kD / 8];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    const int c = r0 + 8 * i;
    S[i] = kBackward ? extra[((head * (N + 1) + N) * kD + c) * kD + slab + j] : 0.f;
    sS[c * kSlab + j] = S[i];
  }
  for (int step = 0; step < N; ++step) {
    const int n = kBackward ? N - 1 - step : step;
    const long long rows = (head * N + n) * kC * kD;
    __syncthreads();  // the last chunk's reads of sma, smb, sX are done
    {
      const float4* a4 = reinterpret_cast<const float4*>(ma + rows);
      const float4* b4 = reinterpret_cast<const float4*>(mb + rows);
      for (int f = threadIdx.x; f < kC * kD / 4; f += kThreads) {
        reinterpret_cast<float4*>(sma)[f] = a4[f];
        reinterpret_cast<float4*>(smb)[f] = b4[f];
      }
      if (threadIdx.x < kD) sgam[threadIdx.x] = gamma[(head * N + n) * kD + threadIdx.x];
    }
    {
      const long long at = ((head * slots + n) * kD) * kD + slab + j;
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) out[at + static_cast<long long>(r0 + 8 * i) * kD] = S[i];
    }
    __syncthreads();
    // X[t][j] = p[t][j] -/+ sum_c ma[t][c] S[c][j], t = r0 + 8 i
    float x[kC / 8];
#pragma unroll
    for (int i = 0; i < kC / 8; ++i) x[i] = 0.f;
    for (int c = 0; c < kD; ++c) {
      const float s = sS[c * kSlab + j];
#pragma unroll
      for (int i = 0; i < kC / 8; ++i) x[i] += sma[(r0 + 8 * i) * kD + c] * s;
    }
#pragma unroll
    for (int i = 0; i < kC / 8; ++i) {
      const int t = r0 + 8 * i;
      const long long at = rows + static_cast<long long>(t) * kD + slab + j;
      const float v = kBackward ? p[at] + x[i] : p[at] - x[i];
      x_out[at] = v;
      sX[t * kSlab + j] = v;
    }
    __syncthreads();
    // S[c][j] = gamma[c] S[c][j] (+ gS[n][c][j]) +/- sum_t mb[t][c] X[t][j], c = r0 + 8 i
    float acc[kD / 8];
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) acc[i] = 0.f;
    for (int t = 0; t < kC; ++t) {
      const float xv = sX[t * kSlab + j];
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) acc[i] += smb[t * kD + r0 + 8 * i] * xv;
    }
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      const int c = r0 + 8 * i;
      float v = sgam[c] * S[i];
      if (kBackward) {
        v += extra[((head * (N + 1) + n) * kD + c) * kD + slab + j];
        v -= acc[i];
      } else {
        v += acc[i];
      }
      S[i] = v;
      sS[c * kSlab + j] = v;
    }
  }
  if (!kBackward) {
    const long long at = ((head * (N + 1) + N) * kD) * kD + slab + j;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) out[at + static_cast<long long>(r0 + 8 * i) * kD] = S[i];
  }
}

__global__ void __launch_bounds__(kThreads)
kda_state_fwd(const float* __restrict__ w, const float* __restrict__ u,
              const float* __restrict__ kd, const float* __restrict__ gamma,
              float* __restrict__ states, float* __restrict__ v_new, int N) {
  state_pass<false>(w, kd, u, gamma, nullptr, states, v_new, N);
}

__global__ void __launch_bounds__(kThreads)
kda_state_bwd(const float* __restrict__ w, const float* __restrict__ kd,
              const float* __restrict__ gamma, const float* __restrict__ gS,
              const float* __restrict__ gv, float* __restrict__ dnext,
              float* __restrict__ dv, int N) {
  state_pass<true>(kd, w, gv, gamma, gS, dnext, dv, N);
}

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

// The kernels above 48 KB of shared memory opt in once a device, on the
// first (eager) call, before any graph captures a launch.
constexpr int kMaxDevices = 64;
bool g_opted[3][kMaxDevices] = {};

template <typename F>
cudaError_t opt_in(int which, int device, F* kernel, int bytes) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_opted[which][device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) g_opted[which][device] = true;
  return err;
}

}  // namespace

extern "C" int tpudash_kda_pairs_forward(const float* q, const float* k, const float* G,
                                         float* akk, float* aqk, int chunks, int device,
                                         cudaStream_t stream) {
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  kda_pairs_fwd<<<chunks, kThreads, 0, stream>>>(q, k, G, akk, aqk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpudash_kda_pairs_backward(const float* q, const float* k, const float* G,
                                          const float* dakk, const float* daqk, float* dq,
                                          float* dk, float* dG, int chunks, int device,
                                          cudaStream_t stream) {
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  cudaError_t err = opt_in(0, device, kda_pairs_bwd, kPairsBwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kda_pairs_bwd<<<chunks, kThreads, kPairsBwdSmem, stream>>>(q, k, G, dakk, daqk, dq, dk, dG);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpudash_kda_state_forward(const float* w, const float* u, const float* kd,
                                         const float* gamma, float* states, float* v_new,
                                         int heads, int N, int device, cudaStream_t stream) {
  if (heads < 1 || heads > 65535 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  cudaError_t err = opt_in(1, device, kda_state_fwd, kStateSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kda_state_fwd<<<dim3(kD / kSlab, heads), kThreads, kStateSmem, stream>>>(w, u, kd, gamma,
                                                                          states, v_new, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpudash_kda_state_backward(const float* w, const float* kd, const float* gamma,
                                          const float* gS, const float* gv, float* dnext,
                                          float* dv, int heads, int N, int device,
                                          cudaStream_t stream) {
  if (heads < 1 || heads > 65535 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  cudaError_t err = opt_in(2, device, kda_state_bwd, kStateSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kda_state_bwd<<<dim3(kD / kSlab, heads), kThreads, kStateSmem, stream>>>(w, kd, gamma, gS, gv,
                                                                          dnext, dv, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpudash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
