// MLA's RoPE and q/k assembly of the DeepSeek-V2-Lite step
// (tpudash_torch/models/deepseek_v2.py::_mla), forward and backward, token by
// token.  Per token s at position t = s mod T, with n = rope, m = n / 2, and
// RoPE over the interleaved pairs regrouped (n/2, 2) -> (2, n/2) as the
// released apply_rotary_pos_emb does (x'[p] = x[2p], x'[m + p] = x[2p + 1]):
//   forward   q[s,h] = [q_raw[s,h,:nope] | rope(q_raw[s,h,nope:])]
//             k[s,h] = [kv[s,h,:nope]    | rope(kv_a[s,r:])]   (the shared key, every head)
//             rope(x)[p]     = bf16(x'[p] * cos[t,p]         - x'[m+p] * sin[t,p])
//             rope(x)[m + p] = bf16(x'[m+p] * cos[t,m+p]     + x'[p] * sin[t,m+p])
//   backward  dq_raw[s,h] = [dq[s,h,:nope] | rope^T(dq[s,h,nope:])]
//             dkv[s,h]    = [dk[s,h,:nope] | dv[s,h]]
//             dkv_a[s]    = [0 (the latent's columns) | rope^T(bf16(sum over h of dk[s,h,nope:]))]
//             rope^T(g)[2p]     = bf16(g[p] * cos[t,p]     + g[m+p] * sin[t,m+p])
//             rope^T(g)[2p + 1] = bf16(g[m+p] * cos[t,m+p] - g[p] * sin[t,p])
// In f32: every product and sum rounded (__fmul_rn, __fadd_rn; no FMA
// contraction), each result rounded once to bf16, as PyTorch's chain of
// separate kernels rounds it: the forward is that chain's bits, dq_raw and
// dkv autograd's bits, and the shared key's gradient sums the heads in f32
// in head order where autograd's expand backward reduces them in its own
// order (within a bf16 ulp), then rounds to bf16 as it does.
//
// Replaces no Pallas kernel: the JAX package has no MLA and no RoPE (the
// model's reference is the benchmark's plain PyTorch,
// gpubench/reference/deepseek_v2.py).  Added because plain PyTorch ran this
// glue as 18 kernels forward and 26 backward: seven f32 passes over each
// rope part (the cast, the regrouping copy, the negation, the rotating cat,
// two products, the sum, the cast back), two cats of (S, H, 192) to build q
// and k, autograd's zero-filled slices of q_raw, a full-size add merging
// q's two slice gradients, and split's cat of dkv: about 10.5 GB a layer a
// step (forward, recompute and backward) at the cell's widths, 285 GB over
// 27 layers.
//
// Bound on an H100 SXM5: bytes (a few f32 operations a value).  Forward
// reads q_raw, kv's k_nope half and kv_a's rope columns, and writes q and k,
// once: at S 32,760, H 16, nope 128, rope 64, 0.74 GB, 221 us at 3.35 TB/s.
// Backward reads dq, dk and dv and writes dq_raw, dkv and dkv_a once:
// 1.04 GB, 311 us.  So the design's job is to touch each byte once:
// - One block a token at a time (a persistent grid walks the tokens).  Its
//   threads take the token's work in units, in memory order of each head's
//   rows, so that neighbouring threads move neighbouring 16-byte vectors: a
//   copy unit moves one vector (8 values) of a nope, v or latent part; a
//   rope unit takes 4 pairs (one 16-byte vector of the interleaved side,
//   two 8-byte halves of the regrouped side).  A thread issues the loads of
//   up to kInFlight units before it finishes any: with a unit at a time the
//   SMs kept too few bytes in flight (65 % of the bound forward).
// - Forward, the shared key is rotated by each head's unit again from kv_a's
//   128 bytes, which the other heads read from L1: no shared memory, no
//   barrier.
// - Backward, the key's gradient adds the H heads' dk at the key's columns in order.  Each
//   head's share is a unit like any other (its loads in flight with the
//   rest), parked in shared memory; after one barrier a token, rope/8
//   threads add the shares in head order.  Where rope/8 threads loaded and
//   added the heads themselves, each a load's latency after the last, those
//   threads' warp set the pace and the backward ran at 37 % of its bound
//   (48 % with 8 heads' loads issued together).
// - dq, dk and dv come in the strides SDPA's backward returns, any order of
//   (b, t, h) with contiguous rows: they are read where they lie, with no
//   copy.  The outputs are written contiguous, each value once; dkv_a's
//   latent columns are written zero in the same pass (autograd adds the
//   latent's own gradient from the norm's backward).
//
// The caller (tpudash_torch/ops/kernels.py::mla_rope_forward/_backward)
// checks: bf16 rows and f32 cos/sin (T, rope) contiguous where they are
// written or read whole, row strides multiples of 8 values, every pointer
// 16-byte aligned, nope, v and r multiples of 8, rope a multiple of 8.  The
// C entries refuse other extents with cudaErrorInvalidValue, and so a
// backward whose two tokens' key shares (2 * H * rope/8 * 16 bytes) pass
// 48 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

// A token's extents, in values.
struct Dims {
  int S, T, H, nope, rope, vd, r;
};

// Element strides of a (B, T, H, width) gradient whose rows are contiguous.
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_lo(w[i]);
    f[2 * i + 1] = bf16_hi(w[i]);
  }
}

__device__ __forceinline__ void unpack4(const uint2& v, float (&f)[4]) {
  f[0] = bf16_lo(v.x);
  f[1] = bf16_hi(v.x);
  f[2] = bf16_lo(v.y);
  f[3] = bf16_hi(v.y);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// cos or sin at the 4 regrouped positions p.. and m + p.. of a row.
struct Table4 {
  float lo[4], hi[4];
};

__device__ __forceinline__ Table4 table4(const float* __restrict__ row, int p, int m) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row + p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(row + m + p));
  return {{a.x, a.y, a.z, a.w}, {b.x, b.y, b.z, b.w}};
}

// RoPE of the 4 pairs p.. of xv (one 16-byte vector of the interleaved
// side, pairs (x[2i], x[2i+1])): the regrouped outputs p.. into dst[p..]
// and m + p.. into dst[m + p..], 8 bytes each.
__device__ __forceinline__ void rope_pairs(const uint4& xv, bf16* __restrict__ dst,
                                           const Table4& c, const Table4& s, int p, int m) {
  float v[8];
  unpack8(xv, v);
  float lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = v[2 * i], b = v[2 * i + 1];
    lo[i] = __fadd_rn(__fmul_rn(a, c.lo[i]), __fmul_rn(-b, s.lo[i]));
    hi[i] = __fadd_rn(__fmul_rn(b, c.hi[i]), __fmul_rn(a, s.hi[i]));
  }
  *reinterpret_cast<uint2*>(dst + p) = make_uint2(pack2(lo[0], lo[1]), pack2(lo[2], lo[3]));
  *reinterpret_cast<uint2*>(dst + m + p) = make_uint2(pack2(hi[0], hi[1]), pack2(hi[2], hi[3]));
}

// RoPE's transpose for the 4 pairs p..: lo the gradient at the regrouped
// positions p.., hi at m + p..; the 8 interleaved values into dst, one
// 16-byte vector.
__device__ __forceinline__ void rope_pairs_t(const float (&lo)[4], const float (&hi)[4],
                                             bf16* __restrict__ dst, const Table4& c,
                                             const Table4& s) {
  float out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __fadd_rn(__fmul_rn(lo[i], c.lo[i]), __fmul_rn(hi[i], s.hi[i]));
    out[2 * i + 1] = __fadd_rn(__fmul_rn(hi[i], c.hi[i]), __fmul_rn(-lo[i], s.lo[i]));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack2(out[0], out[1]), pack2(out[2], out[3]),
                                              pack2(out[4], out[5]), pack2(out[6], out[7]));
}

// A thread's units in flight: their loads are issued together, then each
// unit is finished in turn.
constexpr int kInFlight = 4;

// A forward unit: which row (q's or k's, of head h) and which of its
// nope/8 + rope/8 units.
struct FwdUnit {
  long long row;
  int j;
  bool key;
};

__device__ __forceinline__ FwdUnit fwd_unit(int i, long long s, int H, int side) {
  const int h = i / (2 * side);
  int j = i - h * 2 * side;
  const bool key = j >= side;
  return {s * H + h, key ? j - side : j, key};
}

// Forward.  A head's units: q's row (nope/8 copies, then rope/8 rope units),
// then k's row alike, the rope units from kv_a's shared key.
__global__ void __launch_bounds__(kThreads)
mla_rope_forward(const bf16* __restrict__ q_raw, const bf16* __restrict__ kv,
                 const bf16* __restrict__ kv_a, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, bf16* __restrict__ q, bf16* __restrict__ k,
                 Dims d) {
  const int nope8 = d.nope / 8, m = d.rope / 2;
  const int side = nope8 + d.rope / 8;
  const int units = d.H * 2 * side;
  const int qw = d.nope + d.rope, kvw = d.nope + d.vd, kaw = d.r + d.rope;
  for (long long s = blockIdx.x; s < d.S; s += gridDim.x) {
    const long long t = s % d.T;
    const float* c_row = cos_t + t * d.rope;
    const float* s_row = sin_t + t * d.rope;
    for (int i0 = threadIdx.x; i0 < units; i0 += kInFlight * kThreads) {
      uint4 x[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= units) continue;
        const FwdUnit w = fwd_unit(i, s, d.H, side);
        const bf16* src;
        if (w.j < nope8)
          src = (w.key ? kv + w.row * kvw : q_raw + w.row * qw) + 8 * w.j;
        else
          src = (w.key ? kv_a + s * kaw + d.r : q_raw + w.row * qw + d.nope) + 8 * (w.j - nope8);
        x[u] = __ldg(reinterpret_cast<const uint4*>(src));
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= units) continue;
        const FwdUnit w = fwd_unit(i, s, d.H, side);
        bf16* dst = (w.key ? k : q) + w.row * qw;
        if (w.j < nope8) {
          *reinterpret_cast<uint4*>(dst + 8 * w.j) = x[u];
        } else {
          const int p = 4 * (w.j - nope8);
          rope_pairs(x[u], dst + d.nope, table4(c_row, p, m), table4(s_row, p, m), p, m);
        }
      }
    }
  }
}

// Backward.  A head's units: dq_raw's row (nope/8 copies of dq, then rope/8
// units of RoPE's transpose), then dkv's row (nope/8 copies of dk, v/8 of
// dv); after the heads, H * rope/8 units that each load one head's dk at 4
// pairs of the shared key into shared memory.  Then the block's threads
// write dkv_a's latent columns zero, meet at a barrier, and rope/8 of them
// add the heads there in order and write the key's gradient.  The shared
// memory holds two tokens' loads (the block's turns alternate), so one
// barrier a token keeps a token's writers from the previous token's
// readers.
__global__ void __launch_bounds__(kThreads)
mla_rope_backward(const bf16* __restrict__ dq, const bf16* __restrict__ dk,
                  const bf16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                  const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                  bf16* __restrict__ dq_raw, bf16* __restrict__ dkv, bf16* __restrict__ dkv_a,
                  Dims d) {
  extern __shared__ uint4 key_parts[];  // [2][rope/8][H]: (p.., m + p..) of each head
  const int nope8 = d.nope / 8, rope8 = d.rope / 8, m = d.rope / 2;
  const int per_head = 2 * nope8 + rope8 + d.vd / 8;
  const int heads = d.H * per_head;
  const int units = heads + d.H * rope8;
  const int qw = d.nope + d.rope, kvw = d.nope + d.vd, kaw = d.r + d.rope;
  int turn = 0;  // which of the two buffers this token's shares go to
  for (long long s = blockIdx.x; s < d.S; s += gridDim.x, turn ^= 1) {
    const long long b = s / d.T, t = s - b * d.T;
    const float* c_row = cos_t + t * d.rope;
    const float* s_row = sin_t + t * d.rope;
    const bf16* dq_s = dq + b * sq.b + t * sq.t;
    const bf16* dk_s = dk + b * sk.b + t * sk.t;
    const bf16* dv_s = dv + b * sv.b + t * sv.t;
    uint4* parts = key_parts + turn * rope8 * d.H;
    for (int i0 = threadIdx.x; i0 < units; i0 += kInFlight * kThreads) {
      uint4 x[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= units) continue;
        if (i >= heads) {  // head h's dk at the key's pairs 4j..
          const int h = (i - heads) / rope8, j = i - heads - h * rope8;
          const bf16* g = dk_s + h * sk.h + d.nope + 4 * j;
          const uint2 lo = __ldg(reinterpret_cast<const uint2*>(g));
          const uint2 hi = __ldg(reinterpret_cast<const uint2*>(g + m));
          x[u] = make_uint4(lo.x, lo.y, hi.x, hi.y);
          continue;
        }
        const int h = i / per_head;
        int j = i - h * per_head;
        if (j < nope8) {
          x[u] = __ldg(reinterpret_cast<const uint4*>(dq_s + h * sq.h + 8 * j));
        } else if ((j -= nope8) < rope8) {
          const bf16* g = dq_s + h * sq.h + d.nope + 4 * j;
          const uint2 lo = __ldg(reinterpret_cast<const uint2*>(g));
          const uint2 hi = __ldg(reinterpret_cast<const uint2*>(g + m));
          x[u] = make_uint4(lo.x, lo.y, hi.x, hi.y);
        } else if ((j -= rope8) < nope8) {
          x[u] = __ldg(reinterpret_cast<const uint4*>(dk_s + h * sk.h + 8 * j));
        } else {
          x[u] = __ldg(reinterpret_cast<const uint4*>(dv_s + h * sv.h + 8 * (j - nope8)));
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= units) continue;
        if (i >= heads) {
          const int h = (i - heads) / rope8, j = i - heads - h * rope8;
          parts[j * d.H + h] = x[u];
          continue;
        }
        const int h = i / per_head;
        int j = i - h * per_head;
        const long long row = s * d.H + h;
        if (j < nope8) {
          *reinterpret_cast<uint4*>(dq_raw + row * qw + 8 * j) = x[u];
        } else if ((j -= nope8) < rope8) {
          const int p = 4 * j;
          float lo[4], hi[4];
          unpack4(make_uint2(x[u].x, x[u].y), lo);
          unpack4(make_uint2(x[u].z, x[u].w), hi);
          rope_pairs_t(lo, hi, dq_raw + row * qw + d.nope + 8 * j, table4(c_row, p, m),
                       table4(s_row, p, m));
        } else if ((j -= rope8) < nope8) {
          *reinterpret_cast<uint4*>(dkv + row * kvw + 8 * j) = x[u];
        } else {
          *reinterpret_cast<uint4*>(dkv + row * kvw + d.nope + 8 * (j - nope8)) = x[u];
        }
      }
    }
    for (int z = threadIdx.x; z < d.r / 8; z += kThreads)
      *reinterpret_cast<uint4*>(dkv_a + s * kaw + 8 * z) = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    for (int j = threadIdx.x; j < rope8; j += kThreads) {
      const int p = 4 * j;
      float lo[4], hi[4];
      unpack4(make_uint2(parts[j * d.H].x, parts[j * d.H].y), lo);
      unpack4(make_uint2(parts[j * d.H].z, parts[j * d.H].w), hi);
      for (int h = 1; h < d.H; ++h) {
        const uint4 v = parts[j * d.H + h];
        float a[4], c[4];
        unpack4(make_uint2(v.x, v.y), a);
        unpack4(make_uint2(v.z, v.w), c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[e] = __fadd_rn(lo[e], a[e]);
          hi[e] = __fadd_rn(hi[e], c[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo[e] = round_bf16(lo[e]);
        hi[e] = round_bf16(hi[e]);
      }
      rope_pairs_t(lo, hi, dkv_a + s * kaw + d.r + 8 * j, table4(c_row, p, m),
                   table4(s_row, p, m));
    }
  }
}

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

// The backward's shared memory: two tokens' heads at the shared key.
long long key_bytes(const Dims& d) {
  return 2LL * (d.rope / 8) * d.H * static_cast<long long>(sizeof(uint4));
}
constexpr long long kMaxKeyBytes = 48 * 1024;  // without opting in to more

bool dims_ok(const Dims& d, int grid) {
  const bool widths = d.nope >= 0 && d.nope % 8 == 0 && d.rope >= 8 && d.rope % 8 == 0 &&
                      d.vd >= 8 && d.vd % 8 == 0 && d.r >= 0 && d.r % 8 == 0;
  // the most units a token has, forward or backward
  const long long per_token =
      static_cast<long long>(d.H) * (2LL * (d.nope + d.rope) + d.vd) / 8 + (d.rope + d.r) / 8;
  return widths && d.S >= 0 && d.T >= 1 && d.H >= 1 && grid >= 1 && per_token < (1LL << 31) &&
         key_bytes(d) <= kMaxKeyBytes;
}

bool strides_ok(const Strides& s) { return s.b % 8 == 0 && s.t % 8 == 0 && s.h % 8 == 0; }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

extern "C" int tpudash_mla_rope_forward(const void* q_raw, const void* kv, const void* kv_a,
                                        const float* cos_t, const float* sin_t, void* q, void* k,
                                        int S, int T, int H, int nope, int rope, int vd, int r,
                                        int grid, int device, cudaStream_t stream) {
  const Dims d{S, T, H, nope, rope, vd, r};
  if (!dims_ok(d, grid)) return invalid();
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  if (S == 0) return static_cast<int>(cudaSuccess);
  mla_rope_forward<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q_raw), static_cast<const bf16*>(kv), static_cast<const bf16*>(kv_a),
      cos_t, sin_t, static_cast<bf16*>(q), static_cast<bf16*>(k), d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpudash_mla_rope_backward(const void* dq, const void* dk, const void* dv,
                                         const float* cos_t, const float* sin_t, void* dq_raw,
                                         void* dkv, void* dkv_a, long long dq_b, long long dq_t,
                                         long long dq_h, long long dk_b, long long dk_t,
                                         long long dk_h, long long dv_b, long long dv_t,
                                         long long dv_h, int S, int T, int H, int nope, int rope,
                                         int vd, int r, int grid, int device,
                                         cudaStream_t stream) {
  const Dims d{S, T, H, nope, rope, vd, r};
  const Strides sq{dq_b, dq_t, dq_h}, sk{dk_b, dk_t, dk_h}, sv{dv_b, dv_t, dv_h};
  if (!dims_ok(d, grid) || !strides_ok(sq) || !strides_ok(sk) || !strides_ok(sv)) return invalid();
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  if (S == 0) return static_cast<int>(cudaSuccess);
  mla_rope_backward<<<grid, kThreads, key_bytes(d), stream>>>(
      static_cast<const bf16*>(dq), static_cast<const bf16*>(dk), static_cast<const bf16*>(dv), sq,
      sk, sv, cos_t, sin_t, static_cast<bf16*>(dq_raw), static_cast<bf16*>(dkv),
      static_cast<bf16*>(dkv_a), d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpudash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
