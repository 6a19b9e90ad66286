// GQA decode attention: one query token per head against a KV cache, the
// cache of each (batch row, kv head) split over many CTAs, float32 inside.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (body _decode_kernel). For batch row b and kv head h it serves the G =
// Hq / Hkv query heads h*G .. h*G + G - 1 (q viewed as (B, Hkv, G, D)):
// softmax(q * scale . k^T) . v over the first length[b] cache slots, masked
// logits at -1e30 with their probabilities zeroed, output acc / max(l,
// 1e-30) in q's dtype. A row with length 0 gets zeros, as the TPU kernel
// gives; a length past S counts as S.
//
// What bounds it on the H100: bytes. Each cache slot's K and V row is read
// once and used for G heads, ~4G FLOP per 4 bytes of bf16 at D=128 (G=4 at
// the serving shape), far below the ridge, and nothing for a tensor core to
// do at G = 4 rows. At (B=4, Hkv=8, S=1016, D=128) the K/V rows of the
// cache are 16.6 MB, ~5 us at 3.35 TB/s: the card's bandwidth is reached
// only with most SMs pulling at once.
//
// Design. The Pallas grid (B, Hkv, nk) runs the kv axis in order with m, l,
// acc in VMEM. Here the kv axis is spread over the grid instead, in two
// passes:
// - decode_split_kernel, grid (splits, Hkv, B) with splits = ceil(S / 64)
//   from the cache's capacity (length stays on the device): CTA s covers
//   slots [64 s, 64 s + 64) of [0, length[b]), 16 x 8 x 4 = 512 CTAs at the
//   serving shape, four resident on an SM (at most 128 registers a
//   thread), so one wave. It copies its K and V rows to shared memory once,
//   16 bytes a thread with neighbouring threads on neighbouring addresses
//   (8 loads of each in flight; rows past length are never read), computes
//   the G logits of each slot (one thread per (head, slot)), the split's
//   max and normaliser per head (one warp per head) and its unnormalised
//   output (one thread per (head, dim)), and writes (m, l, acc) in float32
//   to a workspace. A split past length[b] writes m = -1e30, l = 0, acc = 0
//   and reads nothing.
// - decode_combine_kernel, one CTA per (b, query head): M = max m_i, L =
//   sum l_i e^(m_i - M), O = sum acc_i e^(m_i - M) / max(L, 1e-30). A row
//   with length 0 has only empty splits, so L = 0 and O = 0. Where the
//   caller asks for it, it also writes the row's log-sum-exp of the
//   scaled logits, M + log L in float32 (-inf where L = 0): ranks that
//   each attend over a slice of one cache merge their outputs by it.
// Two launches a call; a last-CTA combine with a self-resetting counter
// would save the second, but needs a buffer shared across calls and
// streams.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;     // cache slots per split
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the 16 bytes of one load as float32 (the last argument picks the type)
__device__ __forceinline__ void unpack(const uint4& u, float* x, float) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float* x, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int D>
struct Split {
  static constexpr int kVec = 16 / sizeof(T);  // elements of one 16-byte load
  static constexpr int kLD = D + kVec;         // row of a staged tile, 16 bytes padded
  static constexpr int kRowVecs = D / kVec;
  static constexpr int kLoads = kChunk * kRowVecs / kThreads;  // per thread, K and V each
  static constexpr int kBatch = kLoads < 8 ? kLoads : 8;
};

// K and V tiles (kChunk x kLD of T each), q scaled (G x D) and the logits
// (G x kChunk) in float32; kept equal to decode_attention._smem_bytes
template <typename T, int D>
size_t smem_bytes(int G) {
  return 2 * static_cast<size_t>(kChunk) * Split<T, D>::kLD * sizeof(T) +
         sizeof(float) * static_cast<size_t>(G) * (D + kChunk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 4)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ part_acc, float* __restrict__ part_ml, int Hkv,
                    int G, int S, float scale) {
  using P = Split<T, D>;
  extern __shared__ __align__(16) uint8_t smem[];
  T* Ks = reinterpret_cast<T*>(smem);                      // kChunk x kLD
  T* Vs = Ks + kChunk * P::kLD;                            // kChunk x kLD
  float* Qs = reinterpret_cast<float*>(Vs + kChunk * P::kLD);  // G x D, scaled
  float* Ps = Qs + G * D;                                  // G x kChunk

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int row = b * Hkv + kvh;
  const int part = row * gridDim.x + split;  // this CTA's (G, D) and (G, 2) partials
  float* acc_out = part_acc + static_cast<size_t>(part) * G * D;
  float* ml_out = part_ml + static_cast<size_t>(part) * G * 2;
  const int start = split * kChunk;
  const int n = min(min(max(length[b], 0), S) - start, kChunk);  // live slots here

  if (n <= 0) {
    for (int e = threadIdx.x; e < G * D; e += kThreads) acc_out[e] = 0.f;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      ml_out[2 * g] = kNeg;
      ml_out[2 * g + 1] = 0.f;
    }
    return;
  }

  const T* qp = q + static_cast<size_t>(row) * G * D;
  for (int e = threadIdx.x; e < G * D; e += kThreads) Qs[e] = to_float(qp[e]) * scale;
  // K and V rows [start, start + n), batches of 8 loads of each in flight
  const size_t base = (static_cast<size_t>(row) * S + start) * D;
  const uint4* kp = reinterpret_cast<const uint4*>(k + base);
  const uint4* vp = reinterpret_cast<const uint4*>(v + base);
#pragma unroll
  for (int i0 = 0; i0 < P::kLoads; i0 += P::kBatch) {
    uint4 kr[P::kBatch], vr[P::kBatch];
#pragma unroll
    for (int i = 0; i < P::kBatch; ++i) {
      const int idx = threadIdx.x + (i0 + i) * kThreads;
      const bool ok = idx / P::kRowVecs < n;
      kr[i] = ok ? kp[idx] : make_uint4(0, 0, 0, 0);
      vr[i] = ok ? vp[idx] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < P::kBatch; ++i) {
      const int idx = threadIdx.x + (i0 + i) * kThreads;
      const int off = (idx / P::kRowVecs) * P::kLD + (idx % P::kRowVecs) * P::kVec;
      *reinterpret_cast<uint4*>(Ks + off) = kr[i];
      *reinterpret_cast<uint4*>(Vs + off) = vr[i];
    }
  }
  __syncthreads();

  // logits, one thread per (head, slot), four partial sums; a row is
  // padded by 16 bytes, so 8 neighbouring slots' 16-byte reads hit all
  // 32 banks once
  for (int e = threadIdx.x; e < G * kChunk; e += kThreads) {
    const int g = e / kChunk;
    const int j = e % kChunk;
    const uint4* kr_s = reinterpret_cast<const uint4*>(Ks + j * P::kLD);
    const float* qr = Qs + g * D;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < P::kRowVecs; ++c) {
      float x[P::kVec];
      unpack(kr_s[c], x, T());
#pragma unroll
      for (int u = 0; u < P::kVec; ++u)
        a[u % 4] = fmaf(qr[c * P::kVec + u], x[u], a[u % 4]);
    }
    Ps[e] = j < n ? (a[0] + a[1]) + (a[2] + a[3]) : kNeg;
  }
  __syncthreads();

  // the split's max and normaliser per head, one warp per head
  for (int g = threadIdx.x / 32; g < G; g += kWarps) {
    const int lane = threadIdx.x % 32;
    const float s0 = Ps[g * kChunk + lane];
    const float s1 = Ps[g * kChunk + lane + 32];
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = lane < n ? expf(s0 - m) : 0.f;
    const float p1 = lane + 32 < n ? expf(s1 - m) : 0.f;
    const float l = warp_sum(p0 + p1);
    Ps[g * kChunk + lane] = p0;
    Ps[g * kChunk + lane + 32] = p1;
    if (lane == 0) {
      ml_out[2 * g] = m;
      ml_out[2 * g + 1] = l;
    }
  }
  __syncthreads();

  // the split's unnormalised output, one thread per (head, dim)
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D;
    const int d = e % D;
    const float* pg = Ps + g * kChunk;
    const T* vc = Vs + d;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < kChunk; j += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = fmaf(pg[j + u], to_float(vc[(j + u) * P::kLD]), a[u]);
    acc_out[e] = (a[0] + a[1]) + (a[2] + a[3]);
  }
}

// one CTA per (b * Hkv + kv head, head of the group): warp 0 finds M and L
// and each split's weight e^(m_i - M); then each thread sums the splits of
// its dims, eight loads in flight
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, T* __restrict__ o,
                      float* __restrict__ lse, int G, int D, int splits) {
  extern __shared__ float weight[];  // splits
  __shared__ float total;
  const int g = blockIdx.x;
  const int row = blockIdx.y;
  const float* ml = part_ml + (static_cast<size_t>(row) * splits * G + g) * 2;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float M = kNeg;
    for (int s = lane; s < splits; s += 32) M = fmaxf(M, ml[2 * s * G]);
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float w = expf(ml[2 * s * G] - M);
      weight[s] = w;
      L += ml[2 * s * G + 1] * w;
    }
    L = warp_sum(L);
    if (lane == 0) {
      total = fmaxf(L, 1e-30f);
      if (lse != nullptr) lse[row * G + g] = L > 0.f ? M + logf(L) : -INFINITY;
    }
  }
  __syncthreads();
  const float* acc = part_acc + (static_cast<size_t>(row) * splits * G + g) * D;
  const size_t step = static_cast<size_t>(G) * D;  // from one split to the next
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) A += acc[s * step + d] * weight[s];
    store(o + (static_cast<size_t>(row) * G + g) * D + d, A / total);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* length, void* o,
           float* lse, float* work, int B, int Hkv, int G, int S, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(G);
  auto split = decode_split_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = max(1, (S + kChunk - 1) / kChunk);  // decode_attention._splits
  float* part_acc = work;  // (B, Hkv, splits, G, D), then (B, Hkv, splits, G, 2)
  float* part_ml = work + static_cast<size_t>(B) * Hkv * splits * G * D;
  split<<<dim3(splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      length, part_acc, part_ml, Hkv, G, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<dim3(G, B * Hkv), kCombineThreads, splits * sizeof(float),
                             stream>>>(
      part_acc, part_ml, static_cast<T*>(o), lse, G, D, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* length, void* o,
             float* lse, float* work, int B, int Hkv, int G, int S, int D, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, length, o, lse, work, B, Hkv, G, S, scale, stream);
    case 32: return launch<T, 32>(q, k, v, length, o, lse, work, B, Hkv, G, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, length, o, lse, work, B, Hkv, G, S, scale, stream);
    case 128: return launch<T, 128>(q, k, v, length, o, lse, work, B, Hkv, G, S, scale, stream);
    case 256: return launch<T, 256>(q, k, v, length, o, lse, work, B, Hkv, G, S, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Hkv * G, D), k and v (B, Hkv, S, D), length (B,) int32, o like q,
// contiguous, of one dtype (0: float32, 1: bfloat16); D in {16, 32, 64,
// 128, 256}; lse (B, Hkv * G) float32, or null for none; work holds B *
// Hkv * max(1, ceil(S / 64)) * G * (D + 2) float32.
// Launches both passes on `stream`; returns the cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* length, void* o, void* lse,
                                       void* work,
                                       int dtype, int B, int Hkv, int G, int S, int D,
                                       float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_d<float>(q, k, v, length, o, l, w, B, Hkv, G, S, D, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, length, o, l, w, B, Hkv, G, S, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
