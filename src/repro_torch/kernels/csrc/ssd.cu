// Mamba-2 SSD chunked scan (ngroups = 1), float32 inside.
//
// Replaces the TPU kernel repro/kernels/ssd.py::ssd (body _ssd_kernel). For
// batch row b and head h it computes y_t = C_t^T h_t with the state
// h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t^T, h in (N, P), by the chunked
// decomposition: within a chunk of rows with in-chunk cumulative decay
// exponents cum_i = sum_{j<=i} A dt_j,
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j       (intra)
//        + exp(cum_i) (C_i . h)                                     (inter)
//   h'   = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T,
// each product in the Pallas body's order. B and C are shared by all heads.
//
// What bounds it on the H100: bytes, at this tile. At the serving shape
// (B=4, S=1000, H=64, P=64, N=128, x and y in bf16, dt, B, C in float32)
// the call moves 70.7 MB (21 us at 3.35 TB/s). The chunked algorithm's
// work grows with the chunk: 2T^2(N+P) + 4TNP FLOP per T rows and head,
// 11.8 GFLOP at this kernel's T = 32 (12 us at the bf16 tensor-core rate),
// 34.4 GFLOP at the TPU kernel's chunk of 256. This first version does
// its products on the float32 CUDA cores (explicit fmaf); C.B^T is
// recomputed per head, as in the Pallas body; sharing it across heads and
// the tensor cores are later speed items.
//
// Design. The Pallas grid (B, H, chunks) carries h in VMEM scratch across
// its sequential chunk axis; Hopper blocks run in no order, so here one CTA
// owns one (b, h) and walks the sequence itself, 256 CTAs at the serving
// shape, two resident per SM. A chunk of 256 rows of B and C alone would be
// 256 KB of float32, more than a block may hold, and the decomposition is
// exact for any chunk length, so the CTA works in tiles of T = 32 rows
// (results differ from the chunk-256 body by rounding only; the wrapper
// keeps the JAX signature's `chunk`). Per tile: warp 0 scans the 32 decay
// exponents with shuffles; B, C (float4 rows padded by 4 floats) and x go
// to shared memory as float32; the masked, decayed scores C.B^T form a
// 32 x 32 tile; each thread then owns 4 rows x 2 columns of y (intra term
// plus C.h from the state in shared memory) and N/8 x 2 entries of the
// state, which it keeps in registers and mirrors to shared memory after
// the update. G is formed from differences of in-tile cumulative sums,
// never as a ratio of exponentials, so exp(cum) may underflow to 0 (the
// true decay) without harm; expf, not __expf. Rows past S load as zeros
// with dt = 0 (inert: decay 1, no state contribution) and are never
// stored, so S needs no padded copy. The library is built with
// --fmad=false; the dot products call fmaf, the rest rounds as written.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;         // rows per tile: one warp scans them
constexpr int kThreads = 256;

template <int N, int P>
struct Layout {
  static constexpr int kLDB = N + 4;            // B and C rows, float4-aligned
  static constexpr int kPP = P / 2;             // threads along p, 2 columns each
  static constexpr int kRG = kThreads / kPP;    // row groups (and n groups)
  static constexpr int kRPT = kT / kRG;         // y rows per thread
  static constexpr int kNPT = N >= kRG ? N / kRG : 1;  // state rows per thread
  static constexpr int kOwners = N / kNPT;      // n groups that own state
  // Bs, Cs (kT x kLDB), Xs (kT x P), Ms (kT x kT), Hs (N x P), 4 x kT scalars
  static constexpr size_t kFloats = static_cast<size_t>(2 * kT * kLDB + kT * P +
                                                        kT * kT + N * P + 4 * kT);
  static_assert(kRPT >= 1 && kT % kRG == 0, "P must be 16, 32 or 64");
  static_assert(N % 4 == 0 && N % kNPT == 0, "N must be a multiple of 4");
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, T* __restrict__ y, int S, int H) {
  using L = Layout<N, P>;
  constexpr int kLDB = L::kLDB;
  constexpr int kRPT = L::kRPT;
  constexpr int kNPT = L::kNPT;
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;               // kT x kLDB: B, then B * w
  float* Cs = Bs + kT * kLDB;     // kT x kLDB
  float* Xs = Cs + kT * kLDB;     // kT x P
  float* Ms = Xs + kT * P;        // kT x kT: (C.B^T) * G * dt
  float* Hs = Ms + kT * kT;       // N x P: the state entering the tile
  float* cum = Hs + N * P;        // in-tile inclusive sums of A dt
  float* ecum = cum + kT;         // exp(cum_i)
  float* wts = ecum + kT;         // exp(cum_last - cum_j) * dt_j
  float* dts = wts + kT;          // dt_j

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float a_h = A[h];
  const size_t xrow = static_cast<size_t>(H) * P;   // x and y, one s to the next
  const T* xb = x + static_cast<size_t>(b) * S * xrow + static_cast<size_t>(h) * P;
  T* yb = y + static_cast<size_t>(b) * S * xrow + static_cast<size_t>(h) * P;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  const float* Bb = Bm + static_cast<size_t>(b) * S * N;
  const float* Cb = Cm + static_cast<size_t>(b) * S * N;

  const int pp = tid % L::kPP;
  const int rg = tid / L::kPP;
  const int p = pp * 2;
  const int i0 = rg * kRPT;          // this thread's y rows
  const int n0 = rg * kNPT;          // this thread's state rows
  const bool owner = rg < L::kOwners;
  float hreg[kNPT][2];
#pragma unroll
  for (int k = 0; k < kNPT; ++k) hreg[k][0] = hreg[k][1] = 0.f;
  for (int i = tid; i < N * P; i += kThreads) Hs[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kT) {
    // --- decay exponents of the tile: an inclusive scan in warp 0 ---
    if (warp == 0) {
      const int s = s0 + lane;
      const float d = s < S ? dtb[static_cast<size_t>(s) * H] : 0.f;
      float c = a_h * d;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, c, off);
        if (lane >= off) c += u;
      }
      const float last = __shfl_sync(0xffffffffu, c, 31);
      cum[lane] = c;
      ecum[lane] = expf(c);
      wts[lane] = expf(last - c) * d;
      dts[lane] = d;
    }
    // --- B, C and x of the tile as float32; rows past S are zero ---
    constexpr int kV = N / 4;
    for (int i = tid; i < kT * kV; i += kThreads) {
      const int r = i / kV;
      const int c = (i % kV) * 4;
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 cv = bv;
      if (s0 + r < S) {
        bv = *reinterpret_cast<const float4*>(Bb + static_cast<size_t>(s0 + r) * N + c);
        cv = *reinterpret_cast<const float4*>(Cb + static_cast<size_t>(s0 + r) * N + c);
      }
      *reinterpret_cast<float4*>(Bs + r * kLDB + c) = bv;
      *reinterpret_cast<float4*>(Cs + r * kLDB + c) = cv;
    }
    constexpr int kX = P / 2;
    for (int i = tid; i < kT * kX; i += kThreads) {
      const int r = i / kX;
      const int c = (i % kX) * 2;
      float2 v = make_float2(0.f, 0.f);
      if (s0 + r < S) v = load2(xb + static_cast<size_t>(s0 + r) * xrow + c);
      *reinterpret_cast<float2*>(Xs + r * P + c) = v;
    }
    __syncthreads();

    // --- scores: Ms[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j, j <= i ---
    {
      const int j = lane;
      const int r0 = warp * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* bj = Bs + j * kLDB;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(bj + n);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 cv = *reinterpret_cast<const float4*>(Cs + (r0 + r) * kLDB + n);
          acc[r] = fmaf(cv.x, bv.x, acc[r]);
          acc[r] = fmaf(cv.y, bv.y, acc[r]);
          acc[r] = fmaf(cv.z, bv.z, acc[r]);
          acc[r] = fmaf(cv.w, bv.w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + r;
        Ms[i * kT + j] = j <= i ? acc[r] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
      }
    }
    __syncthreads();

    // --- y rows of the tile; B scaled by w for the state update ---
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N;
      Bs[r * kLDB + i % N] *= wts[r];
    }
    {
      float acc[kRPT][2], accs[kRPT][2];
#pragma unroll
      for (int r = 0; r < kRPT; ++r) acc[r][0] = acc[r][1] = accs[r][0] = accs[r][1] = 0.f;
#pragma unroll 2
      for (int j = 0; j < kT; j += 4) {
        float2 xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = load2(Xs + (j + q) * P + p);
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
          const float4 m = *reinterpret_cast<const float4*>(Ms + (i0 + r) * kT + j);
          const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][0] = fmaf(mv[q], xv[q].x, acc[r][0]);
            acc[r][1] = fmaf(mv[q], xv[q].y, acc[r][1]);
          }
        }
      }
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float2 hv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[q] = load2(Hs + (n + q) * P + p);
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
          const float4 c = *reinterpret_cast<const float4*>(Cs + (i0 + r) * kLDB + n);
          const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            accs[r][0] = fmaf(cv[q], hv[q].x, accs[r][0]);
            accs[r][1] = fmaf(cv[q], hv[q].y, accs[r][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        const int i = i0 + r;
        if (s0 + i < S)
          store2(yb + static_cast<size_t>(s0 + i) * xrow + p,
                 acc[r][0] + ecum[i] * accs[r][0], acc[r][1] + ecum[i] * accs[r][1]);
      }
    }
    __syncthreads();

    // --- state: h' = exp(cum_last) h + sum_j (B_j w_j) x_j^T ---
    if (owner) {
      float d[kNPT][2];
#pragma unroll
      for (int k = 0; k < kNPT; ++k) d[k][0] = d[k][1] = 0.f;
#pragma unroll 2
      for (int j = 0; j < kT; ++j) {
        const float2 xv = load2(Xs + j * P + p);
        const float* bw = Bs + j * kLDB + n0;
        if constexpr (kNPT % 4 == 0) {
#pragma unroll
          for (int k = 0; k < kNPT; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(bw + k);
            const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              d[k + q][0] = fmaf(bv[q], xv.x, d[k + q][0]);
              d[k + q][1] = fmaf(bv[q], xv.y, d[k + q][1]);
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < kNPT; ++k) {
            d[k][0] = fmaf(bw[k], xv.x, d[k][0]);
            d[k][1] = fmaf(bw[k], xv.y, d[k][1]);
          }
        }
      }
      const float el = ecum[kT - 1];
#pragma unroll
      for (int k = 0; k < kNPT; ++k) {
        hreg[k][0] = el * hreg[k][0] + d[k][0];
        hreg[k][1] = el * hreg[k][1] + d[k][1];
        store2(Hs + (n0 + k) * P + p, hreg[k][0], hreg[k][1]);
      }
    }
    __syncthreads();
  }
}

template <typename T, int N, int P>
int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, void* y, int B, int S, int H, cudaStream_t stream) {
  constexpr size_t smem = Layout<N, P>::kFloats * sizeof(float);
  auto kernel = ssd_kernel<T, N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), dt, A, Bm, Cm,
                                           static_cast<T*>(y), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_p(const void* x, const float* dt, const float* A, const float* Bm,
             const float* Cm, void* y, int B, int S, int H, int P, cudaStream_t st) {
  switch (P) {
    case 16: return launch<T, N, 16>(x, dt, A, Bm, Cm, y, B, S, H, st);
    case 32: return launch<T, N, 32>(x, dt, A, Bm, Cm, y, B, S, H, st);
    case 64: return launch<T, N, 64>(x, dt, A, Bm, Cm, y, B, S, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_np(const void* x, const float* dt, const float* A, const float* Bm,
              const float* Cm, void* y, int B, int S, int H, int N, int P,
              cudaStream_t st) {
  switch (N) {
    case 8: return launch_p<T, 8>(x, dt, A, Bm, Cm, y, B, S, H, P, st);
    case 16: return launch_p<T, 16>(x, dt, A, Bm, Cm, y, B, S, H, P, st);
    case 128: return launch_p<T, 128>(x, dt, A, Bm, Cm, y, B, S, H, P, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x and y (B, S, H, P) of one dtype (0: float32, 1: bfloat16); dt (B, S, H),
// A (H,), Bm and Cm (B, S, N) float32; all contiguous, Bm and Cm 16-byte
// aligned. N in {8, 16, 128} (the reduced configs, hymba, mamba2), P in
// {16, 32, 64}. Launches on `stream`; returns the cudaError_t.
extern "C" int ssd_launch(const void* x, const float* dt, const float* A,
                          const float* Bm, const float* Cm, void* y, int dtype,
                          int B, int S, int H, int N, int P, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_np<float>(x, dt, A, Bm, Cm, y, B, S, H, N, P, st);
  if (dtype == 1)
    return launch_np<__nv_bfloat16>(x, dt, A, Bm, Cm, y, B, S, H, N, P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
