// Mamba-2 SSD chunked scan (ngroups = 1), float32 inside. Two designs,
// chosen by x's dtype alone: bfloat16 x runs four passes on the tensor
// cores (wgmma), float32 x one kernel on the float32 CUDA cores.
//
// Replaces the TPU kernel repro/kernels/ssd.py::ssd (body _ssd_kernel). For
// batch row b and head h it computes y_t = C_t^T h_t with the state
// h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t^T, h in (N, P), by the chunked
// decomposition: within a chunk of rows with in-chunk cumulative decay
// exponents cum_i = sum_{j<=i} A dt_j,
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j       (intra)
//        + exp(cum_i) (C_i . h)                                     (inter)
//   h'   = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T.
// B and C are shared by all heads. Decays are formed from differences of
// in-chunk sums, never as a ratio of exponentials, so exp(cum) may
// underflow to 0 (the true decay) without harm; expf, not __expf. Rows
// past S load as zeros with dt = 0 (inert: decay 1, no state
// contribution) and are never stored, so S needs no padded copy.
//
// What bounds it on the H100: bytes. At the serving shape (B=4, S=1000,
// H=64, P=64, N=128, x and y in bf16, dt, B, C in float32) the call moves
// 70.7 MB (21 us at 3.35 TB/s); the algorithm at a chunk of 32 rows needs
// 11.8 GFLOP (12 us at the bf16 tensor-core rate).
//
// bfloat16: the SSD paper's chunked algorithm (Dao & Gu 2024, section 6)
// run across chunks in parallel, in chunks of kT = 256 rows (the
// reference's chunk; the decomposition is exact for any chunk, so the
// caller's chunk changes only rounding), every product a wgmma m64n64k16
// with float32 accumulators:
//   1. ssd_cb_kernel, one CTA per lower 64 x 64 tile of each (b, chunk):
//      C.B^T once for all heads, a T x T float32 matrix per chunk.
//   2. ssd_state_kernel, one CTA per (h, chunk, b): the scan of A dt over
//      the chunk (kept with dt for pass 4), exp(cum_last), and the chunk's
//      own state S_c = (B w)^T X, w_j = exp(cum_last - cum_j) dt_j, in
//      64-row slabs. Both operands are row-major in the sequence, so the
//      product has both transpose bits set.
//   3. ssd_pass_kernel, a thread per run of 8 state entries:
//      h_in[c] = exp(cum_last[c-1]) h_in[c-1] + S[c-1], sequential over the
//      chunks, written over the chunk states as hi and lo bf16 terms.
//   4. ssd_scan_kernel, one CTA per (128-row block, 8 heads, b and chunk),
//      64 rows to each of two warpgroups: per head (exp(cum_i) C) . h_in,
//      then the masked, decayed scores M = C.B^T exp(cum_i - cum_j) dt_j
//      times X, tile by tile. Tiles above the diagonal, and those whose
//      decays all underflow, are skipped. C.B^T and C are loaded once for
//      the 8 heads, x and h_in once per head for both warpgroups.
// The passes share a float32 workspace that the caller allocates (tc::Work;
// ssd.py's _workspace_floats mirrors its size): 33.5 MB of chunk states at
// the serving shape, written once and read twice.
//
// Precision. The check is one bf16 step of each output plus 1e-2, about a
// bf16 ULP, so no operand may be rounded to bf16 once: every float32
// operand goes in as two bf16 terms, hi = rounded, lo = the remainder
// rounded (~16 bits). C.B^T and (exp(cum_i) C) . h_in are three products
// (hi.hi + hi.lo + lo.hi); M and B w are two (x is bf16 already, exact).
// tests/test_torch_ssm.py models this scheme on the CPU against the
// sequential recurrence, beside the scheme it rejects (one bf16 term per
// operand), which exceeds the allowance several times over.
//
// Layouts. Every bf16 tile sits in shared memory as 64-column boxes of
// 128-byte rows with the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r % 8)), written by the threads themselves (stores, or
// cp.async where no split is needed), so each writer fences its writes to
// the async proxy that wgmma reads through before the barrier. N is padded
// with zeros to 64 or 128 columns (at least 16 rows of h_in) and P to 64,
// so the reduced shapes (N = 8 or 16, P = 16 or 32) take the same path.
//
// Not yet: a producer warp with TMA and an mbarrier ring, overlap of one
// tile's M with the previous tile's products, a fused single-pass variant
// (chunk CTAs taking h_in from their predecessor), and the final state as
// an optional output.
//
// float32: ssd_kernel, exact to float32 rounding; no served path runs it.
// One CTA owns one (b, h) and walks the sequence in tiles of T = 32 rows (a
// chunk of 256 rows of B and C would be 256 KB of float32, more than a
// block may hold). Per tile:
// warp 0 scans the 32 decay exponents with shuffles; B, C (float4 rows
// padded by 4 floats) and x go to shared memory as float32; the masked,
// decayed scores C.B^T form a 32 x 32 tile; each thread then owns 4 rows x
// 2 columns of y (intra term plus C.h from the state in shared memory) and
// N/8 x 2 entries of the state, which it keeps in registers and mirrors to
// shared memory after the update. The library is built with --fmad=false;
// the dot products call fmaf, the rest rounds as written.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores.
// ---------------------------------------------------------------------------

namespace f32 {


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
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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


}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), four passes.
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kT = 256;                 // chunk rows
constexpr int kR = 64;                  // rows of one wgmma tile
constexpr int kBox = kR * 128;          // 64 rows x 64 bf16 columns
constexpr int kBlocks = kT / kR;        // 64-row blocks of a chunk
constexpr int kTiles = kBlocks * (kBlocks + 1) / 2;  // lower tiles of C.B^T
constexpr uint64_t kSw = 1;             // wgmma's code for the 128-byte swizzle

// N padded to whole 64-column boxes; the bytes of one 64-row tile of it
template <int N>
struct Dims {
  static constexpr int kNP = N > 64 ? 128 : 64;
  static constexpr int kTile = kR * kNP * 2;
  static constexpr int kWG = kNP / 64;  // warpgroups of the state pass
  static_assert(N == 8 || N == 16 || N == 128, "N must be 8, 16 or 128");
};

// shared memory of each pass (1024 bytes of alignment slack first)
template <int N>
constexpr int cb_smem() { return 1024 + 4 * Dims<N>::kTile; }
template <int N>
constexpr int state_smem() {
  return 1024 + 2 * Dims<N>::kTile + kBox + (2 * kT + kT / 32) * 4;
}
constexpr int kHG = 8;                  // heads per scan CTA
constexpr int kScanRows = 2 * kR;       // rows per scan CTA, 64 per warpgroup
constexpr int kLDS = kT + 8;            // C.B^T rows in shared memory (floats)
// h_in rows in the scan's shared memory: N, at least one k-step
template <int N>
__host__ __device__ constexpr int h_rows() { return N < 16 ? 16 : N; }
// the block's C.B^T, x (kT rows), h_in hi and lo, cum and dt
template <int N>
constexpr int scan_smem() {
  return 1024 + kScanRows * kLDS * 4 + kT * 128 + 2 * h_rows<N>() * 128 + 2 * kT * 4;
}

// the float32 workspace: C.B^T (B, nc, T, T); the chunk states, then h_in,
// (B, nc, H, N, P); cum and dt (B, nc, H, 2, T); the chunk decays (B, nc,
// H). h_in is stored as pairs: each run of 8 float32 of a row holds the 8
// hi terms, then the 8 lo terms, in bf16.
struct Work {
  float* cb;
  float* st;
  float* cdt;
  float* decay;
};

Work carve(float* ws, int B, int nc, int H, int N, int P) {
  const size_t bc = static_cast<size_t>(B) * nc;
  Work w;
  w.cb = ws;
  w.st = w.cb + bc * kT * kT;
  w.cdt = w.st + bc * H * N * P;
  w.decay = w.cdt + bc * H * 2 * kT;
  return w;
}

// byte offset of bf16 element (r, c), c < 64, in a tile of 128-byte rows
// with the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// 16 bytes from global to shared memory, asynchronously; zeros unless `ok`
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// closes this thread's group of cp.async copies; cp_wait<n> waits until at
// most n of its groups are still in flight
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// rows [r0, r0 + 64) of a row-major (S, N) float32 matrix, times w[r] when
// w is given, as hi and lo bf16 terms into two tiles of N padded to kNP
// columns (64-column boxes `box` bytes apart); rows past S and columns
// past N zero. Every load is issued before the first is used.
template <int N, int kThreads>
__device__ __forceinline__ void load_split(uint8_t* hi, uint8_t* lo, const float* src, int r0,
                                           int S, const float* w, int tid, int box) {
  constexpr int kV = Dims<N>::kNP / 4;
  constexpr int kIter = kR * kV / kThreads;
  static_assert(kIter * kThreads == kR * kV, "threads must divide the tile");
  float4 v[kIter];
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kV;
    const int c = (i % kV) * 4;
    v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < N && r0 + r < S)
      v[it] = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * N + c);
  }
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kV;
    const int c = (i % kV) * 4;
    float4 f = v[it];
    if (w != nullptr) {
      const float s = w[r];
      f = make_float4(f.x * s, f.y * s, f.z * s, f.w * s);
    }
    uint32_t h0, l0, h1, l1;
    split_bf16(f.x, f.y, h0, l0);
    split_bf16(f.z, f.w, h1, l1);
    const uint32_t off = (c / 64) * box + swz(r, c % 64);
    *reinterpret_cast<uint2*>(hi + off) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(lo + off) = make_uint2(l0, l1);
  }
}

// rows [r0, r0 + rows) of head h's x (row stride H * P) into a tile of 64
// columns; columns past P and rows past S zero (asynchronous)
__device__ __forceinline__ void load_x(uint32_t dst, const __nv_bfloat16* xb, int r0, int rows,
                                       int S, int H, int P, int tid, int nthreads) {
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int r = i / 8;
    const int k = (i % 8) * 8;
    const bool ok = k < P && r0 + r < S;
    cp16(dst + swz(r, k), ok ? xb + static_cast<size_t>(r0 + r) * H * P + k : xb, ok);
  }
}

// h_in of one (b, chunk, head), (N, P) as pairs, into hi and lo tiles of
// 64 columns (past P zero), rows n (past N zero up to `rows`), asynchronous
__device__ __forceinline__ void load_h(uint32_t hi, uint32_t lo, const float* src, int rows,
                                       int N, int P, int tid, int nthreads) {
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int n = i / 8;
    const int p = (i % 8) * 8;
    const bool ok = n < N && p < P;
    const float* g = ok ? src + static_cast<size_t>(n) * P + p : src;
    cp16(hi + swz(n, p), g, ok);
    cp16(lo + swz(n, p), g + 4, ok);
  }
}

// acc (64 x 64) += A . B^T over kNP columns, A and B each as hi and lo
// tiles (K-major, 64 rows): hi.hi + hi.lo + lo.hi
template <int N>
__device__ __forceinline__ void split_product(float* acc, uint32_t ahi, uint32_t alo,
                                              uint32_t bhi, uint32_t blo) {
  pin<32>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Dims<N>::kNP / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    const uint64_t ah = desc(ahi + off, 16, 1024, kSw);
    const uint64_t al = desc(alo + off, 16, 1024, kSw);
    const uint64_t bh = desc(bhi + off, 16, 1024, kSw);
    const uint64_t bl = desc(blo + off, 16, 1024, kSw);
    wgmma_ss_n64(acc, ah, bh, 1);
    wgmma_ss_n64(acc, ah, bl, 1);
    wgmma_ss_n64(acc, al, bh, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  pin<32>(acc);
}

// inclusive sums of v[0, kT) in place; every thread of the block calls it
__device__ void block_scan(float* v, float* seg) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int s = warp; s < kT / 32; s += nwarps) {
    float x = v[s * 32 + lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += u;
    }
    v[s * 32 + lane] = x;
    if (lane == 31) seg[s] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int s = 0; s < kT / 32; ++s) {
      const float t = seg[s];
      seg[s] = run;
      run += t;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kT; i += blockDim.x) v[i] += seg[i / 32];
  __syncthreads();
}

// Register fragments of one warpgroup (wgmma's m64nN accumulator): thread
// (warp w, lane t) holds rows 16w + t/4 and 16w + t/4 + 8; its element 4j + e
// is column 8j + 2(t%4) + (e & 1) of the first row (e < 2) or the second.

// Pass 1. Grid (kTiles, B * nc): tile (ib, jb), jb <= ib, of chunk c's
// C.B^T = C[ib rows] . B[jb rows]^T, float32, into cb (B, nc, T, T).
template <int N>
__global__ void __launch_bounds__(128)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int S, int nc) {
  using D = Dims<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* chi = aligned_smem(smem_raw);
  uint8_t* clo = chi + D::kTile;
  uint8_t* bhi = clo + D::kTile;
  uint8_t* blo = bhi + D::kTile;
  int t = blockIdx.x;
  int ib = 0;
  while (t > ib) t -= ++ib;
  const int jb = t;
  const int bc = blockIdx.y;
  const int b = bc / nc;
  const int s0 = (bc % nc) * kT;
  if (s0 + ib * kR >= S) return;
  const int tid = threadIdx.x;
  const size_t mat = static_cast<size_t>(b) * S * N;
  load_split<N, 128>(chi, clo, Cm + mat, s0 + ib * kR, S, nullptr, tid, kBox);
  load_split<N, 128>(bhi, blo, Bm + mat, s0 + jb * kR, S, nullptr, tid, kBox);
  fence_proxy_async();
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  split_product<N>(acc, smem_addr(chi), smem_addr(clo), smem_addr(bhi), smem_addr(blo));

  const int lane = tid % 32;
  const int row0 = (tid / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float* out = cb + (static_cast<size_t>(bc) * kT + ib * kR) * kT + jb * kR;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (row0 + 8 * r) * kT + 8 * j + cq) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
}

// Pass 2. Grid (H, nc, B), 128 threads per 64 state rows: the scan of
// A dt over the chunk (kept with dt for pass 4), its decay, and the chunk's
// own state (B w)^T X, (N, P) float32, w_j = exp(cum_last - cum_j) dt_j,
// in 64-row slabs with B w as two bf16 terms against the bf16 x. Both
// operands are row-major in the sequence: wgmma with both transpose bits.
template <int N>
__global__ void __launch_bounds__(128 * Dims<N>::kWG)
ssd_state_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ st, float* __restrict__ cdt,
                 float* __restrict__ decay, int S, int H, int P, int nc) {
  using D = Dims<N>;
  constexpr int kThreads = 128 * D::kWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ahi = aligned_smem(smem_raw);
  uint8_t* alo = ahi + D::kTile;
  uint8_t* xs = alo + D::kTile;
  float* cum = reinterpret_cast<float*>(xs + kBox);  // kT
  float* w = cum + kT;                               // kT: dt, then the weights
  float* seg = w + kT;                               // kT / 32
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int bc = b * nc + c;
  const int s0 = c * kT;
  const int tid = threadIdx.x;
  const float a_h = A[h];
  for (int j = tid; j < kT; j += kThreads) {
    const float d = s0 + j < S ? dt[(static_cast<size_t>(b) * S + s0 + j) * H + h] : 0.f;
    cum[j] = a_h * d;
    w[j] = d;
  }
  __syncthreads();
  block_scan(cum, seg);
  const float last = cum[kT - 1];
  float* cd = cdt + (static_cast<size_t>(bc) * H + h) * 2 * kT;
  for (int j = tid; j < kT; j += kThreads) {
    cd[j] = cum[j];
    cd[kT + j] = w[j];
    w[j] = expf(last - cum[j]) * w[j];
  }
  if (tid == 0) decay[static_cast<size_t>(bc) * H + h] = expf(last);
  __syncthreads();

  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row0 = (tid % 128) / 32 * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * S * H * P + static_cast<size_t>(h) * P;
  const float* Bb = Bm + static_cast<size_t>(b) * S * N;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int slabs = (min(kT, S - s0) + kR - 1) / kR;
  for (int sl = 0; sl < slabs; ++sl) {
    const int r0 = s0 + sl * kR;
    // B w: row j of the slab, columns n; read as A (n x j), MN-major
    load_x(smem_addr(xs), xb, r0, kR, S, H, P, tid, kThreads);
    load_split<N, kThreads>(ahi, alo, Bb, r0, S, w + sl * kR, tid, kBox);
    cp_wait_all();
    fence_proxy_async();
    __syncthreads();
    pin<32>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk) {
      const uint32_t rows = kk * 16 * 128;
      const uint64_t dx = desc(smem_addr(xs) + rows, kBox, 1024, kSw);
      wgmma_ss_tt_n64(acc, desc(smem_addr(ahi) + wg * kBox + rows, kBox, 1024, kSw), dx);
      wgmma_ss_tt_n64(acc, desc(smem_addr(alo) + wg * kBox + rows, kBox, 1024, kSw), dx);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin<32>(acc);
    __syncthreads();  // before the next slab overwrites the tiles
  }

  float* out = st + (static_cast<size_t>(bc) * H + h) * N * P;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = wg * 64 + row0 + 8 * r;
      const int p = 8 * j + cq;
      if (n < N && p < P)
        *reinterpret_cast<float2*>(out + n * P + p) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
}

// Pass 3. Grid (ceil(N P / 8 / 256), H, B), a thread per run of 8 state
// entries: h_in[c] = decay[c-1] h_in[c-1] + S[c-1], h_in[0] = 0, written
// over S[c] as pairs; four chunks' loads at a time.
__global__ void __launch_bounds__(256)
ssd_pass_kernel(float* __restrict__ st, const float* __restrict__ decay, int H, int NP,
                int nc) {
  constexpr int kAhead = 4;
  const int e = (blockIdx.x * 256 + threadIdx.x) * 8;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= NP) return;
  float run[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) run[k] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 s[kAhead][2];
    float d[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (c0 + q >= nc) break;
      const size_t head = static_cast<size_t>(b * nc + c0 + q) * H + h;
      const float4* at = reinterpret_cast<const float4*>(st + head * NP + e);
      s[q][0] = at[0];
      s[q][1] = at[1];
      d[q] = decay[head];
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (c0 + q >= nc) break;
      const size_t head = static_cast<size_t>(b * nc + c0 + q) * H + h;
      float4* at = reinterpret_cast<float4*>(st + head * NP + e);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) split_bf16(run[2 * k], run[2 * k + 1], hi[k], lo[k]);
      at[0] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                          __uint_as_float(hi[2]), __uint_as_float(hi[3]));
      at[1] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                          __uint_as_float(lo[2]), __uint_as_float(lo[3]));
      const float v[8] = {s[q][0].x, s[q][0].y, s[q][0].z, s[q][0].w,
                          s[q][1].x, s[q][1].y, s[q][1].z, s[q][1].w};
#pragma unroll
      for (int k = 0; k < 8; ++k) run[k] = d[q] * run[k] + v[k];
    }
  }
}

// Pass 4. Grid (kT / kScanRows, ceil(H / kHG), B * nc), the blocks of one
// (b, chunk, head group) next to each other, the last block first. Rows
// [i2, i2 + 128) of chunk c for kHG heads, 64 rows to each of two
// warpgroups: the block's C.B^T (all columns <= its last row) is staged once
// in shared memory and each thread's C entries are held in registers, for
// every head; per head both warpgroups share one load of x, h_in, cum and
// dt, and the products of exp(cum_i) C . h_in run while x lands. Per head:
//   y = (exp(cum_i) C) . h_in + (C.B^T * exp(cum_i - cum_j) * dt_j, j <= i) . X
// with exp(cum_i) C and M formed in registers as the A operand (two bf16
// terms each) and h_in (hi and lo) and X read MN-major.
template <int N>
__global__ void __launch_bounds__(256, 1)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ cb,
                const float* __restrict__ Cm, const float* __restrict__ st,
                const float* __restrict__ cdt, __nv_bfloat16* __restrict__ y, int S, int H,
                int P, int nc) {
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kHR = h_rows<N>();
  constexpr int kKS = kHR / 16;                       // k-steps of C . h_in
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  float* cbs = reinterpret_cast<float*>(base);        // kScanRows x kLDS
  uint8_t* xs = base + kScanRows * kLDS * 4;          // kT rows of 64 columns
  uint8_t* hhi = xs + kT * 128;
  uint8_t* hlo = hhi + kHR * 128;
  float* cum = reinterpret_cast<float*>(hlo + kHR * 128);
  float* dts = cum + kT;
  const int i2 = (kT / kScanRows - 1 - static_cast<int>(blockIdx.x)) * kScanRows;
  const int hg = blockIdx.y;
  const int bc = blockIdx.z;
  const int b = bc / nc;
  const int c = bc % nc;
  const int s0 = c * kT;
  if (s0 + i2 >= S) return;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wt = tid % 128;
  const int i0 = i2 + wg * kR;                        // this warpgroup's rows
  const int ib = i0 / kR;
  const bool live = s0 + i0 < S;                      // the same for its 128 threads
  const int jend = i2 + kScanRows;                    // chunk rows read

  // the block's C.B^T rows, columns [0, jend), shared by every head
  const float* cbg = cb + (static_cast<size_t>(bc) * kT + i2) * kT;
  const int q4 = jend / 4;
  for (int i = tid; i < kScanRows * q4; i += 256) {
    const int r = i / q4;
    const int q = (i % q4) * 4;
    cp16(smem_addr(cbs + r * kLDS + q), cbg + r * kT + q, true);
  }
  // this thread's C entries as A fragments over n: element (t & 1) is row
  // ia or ia + 8, (t & 2) columns + 8; zero past N and S
  const int lane = wt % 32;
  const int row0 = (wt / 32) * 16 + lane / 4;         // warpgroup rows row0, row0 + 8
  const int cq = 2 * (lane % 4);
  const int ia = i0 + row0;                           // chunk rows ia, ia + 8
  const float* cbw = cbs + (wg * kR + row0) * kLDS;   // C.B^T row ia
  float2 cf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int s = s0 + ia + ((t & 1) ? 8 : 0);
      const int n = 16 * kk + cq + ((t & 2) ? 8 : 0);
      const float* at = Cm + (static_cast<size_t>(b) * S + s) * N + n;
      cf[kk][t] = n < N && s < S ? *reinterpret_cast<const float2*>(at) : make_float2(0.f, 0.f);
    }
  cp_wait_all();
  __syncthreads();

  const int h_end = min(H, (hg + 1) * kHG);
  for (int h = hg * kHG; h < h_end; ++h) {
    // cum, dt and h_in (chunks after the first), then x rows [0, jend)
    const float* cd = cdt + (static_cast<size_t>(bc) * H + h) * 2 * kT;
    for (int i = tid; i < q4; i += 256) {
      cp16(smem_addr(cum) + 16 * i, cd + 4 * i, true);
      cp16(smem_addr(dts) + 16 * i, cd + kT + 4 * i, true);
    }
    if (c > 0)
      load_h(smem_addr(hhi), smem_addr(hlo), st + (static_cast<size_t>(bc) * H + h) * N * P,
             kHR, N, P, tid, 256);
    cp_commit();
    const __nv_bfloat16* xb =
        x + static_cast<size_t>(b) * S * H * P + static_cast<size_t>(h) * P;
    load_x(smem_addr(xs), xb, s0, jend, S, H, P, tid, 256);
    cp_commit();
    cp_wait<1>();
    fence_proxy_async();
    __syncthreads();

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (c > 0 && live) {
      // (exp(cum_i) C) . h_in: hi.hi + hi.lo + lo.hi, four k-steps at a time
      const float ea = expf(cum[ia]);
      const float eb = expf(cum[ia + 8]);
#pragma unroll
      for (int k0 = 0; k0 < kKS; k0 += 4) {
        uint32_t eh[4][4], el[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (k0 + q < kKS) {
              const float e = (t & 1) ? eb : ea;
              split_bf16(cf[k0 + q][t].x * e, cf[k0 + q][t].y * e, eh[q][t], el[q][t]);
            }
        pin<32>(acc);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k0 + q < kKS) {
            const uint32_t rows = (k0 + q) * 16 * 128;
            const uint64_t dh = desc(smem_addr(hhi) + rows, kHR * 128, 1024, kSw);
            const uint64_t dl = desc(smem_addr(hlo) + rows, kHR * 128, 1024, kSw);
            wgmma_rs_n64(acc, eh[q], dh);
            wgmma_rs_n64(acc, eh[q], dl);
            wgmma_rs_n64(acc, el[q], dh);
          }
        wgmma_commit();
        wgmma_wait_all();
        pin<32>(acc);
      }
    }
    cp_wait<0>();
    fence_proxy_async();
    __syncthreads();

    if (live) {
      const float cum_a = cum[ia];
      const float cum_b = cum[ia + 8];
      const uint32_t xa = smem_addr(xs);
      for (int jt = 0; jt <= ib; ++jt) {
        // a tile whose every decay is below 2^-127 (cum falls, so its
        // largest is at its top-right corner) is exactly zero after
        // ex2.approx.ftz's flush: skipped
        if ((cum[i0] - cum[jt * kR + kR - 1]) * kLog2e < -127.f) continue;
        const bool diag = jt == ib;
        // M's fragments for columns [64 jt, 64 jt + 64), 16 per k-step. The
        // decay is 2^x of the difference of the in-chunk sums (ex2.approx:
        // 2^-22 relative); only the diagonal tile is masked
        uint32_t ph[4][4], pl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int r = row0 + ((t & 1) ? 8 : 0);
            const int j = jt * kR + 16 * kk + cq + ((t & 2) ? 8 : 0);
            const float2 g = *reinterpret_cast<const float2*>(cbw + ((t & 1) ? 8 * kLDS : 0) + j);
            const float2 cj = *reinterpret_cast<const float2*>(cum + j);
            const float2 dj = *reinterpret_cast<const float2*>(dts + j);
            const float ci = (t & 1) ? cum_b : cum_a;
            float m0 = g.x * fast_exp2((ci - cj.x) * kLog2e) * dj.x;
            float m1 = g.y * fast_exp2((ci - cj.y) * kLog2e) * dj.y;
            if (diag) {
              if (j > i0 + r) m0 = 0.f;
              if (j + 1 > i0 + r) m1 = 0.f;
            }
            split_bf16(m0, m1, ph[kk][t], pl[kk][t]);
          }
        pin<32>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dx = desc(xa + (jt * kR + 16 * kk) * 128, kT * 128, 1024, kSw);
          wgmma_rs_n64(acc, ph[kk], dx);
          wgmma_rs_n64(acc, pl[kk], dx);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin<32>(acc);
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = s0 + ia + 8 * r;
        if (s >= S) continue;
        __nv_bfloat16* yp =
            y + (static_cast<size_t>(b) * S + s) * H * P + static_cast<size_t>(h) * P;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * j < P)
            *reinterpret_cast<__nv_bfloat162*>(yp + 8 * j + cq) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
    __syncthreads();  // before the next head overwrites x, h_in, cum and dt
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

#define SSD_TRY(call)                                   \
  do {                                                  \
    const cudaError_t e_ = (call);                      \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

template <int N>
int launch(const void* x, const float* dt, const float* A, const float* Bm, const float* Cm,
           void* y, float* ws, int B, int S, int H, int P, cudaStream_t stream) {
  const int nc = (S + kT - 1) / kT;
  const Work w = carve(ws, B, nc, H, N, P);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  SSD_TRY(allow_smem(ssd_cb_kernel<N>, cb_smem<N>()));
  SSD_TRY(allow_smem(ssd_state_kernel<N>, state_smem<N>()));
  SSD_TRY(allow_smem(ssd_scan_kernel<N>, scan_smem<N>()));
  ssd_cb_kernel<N><<<dim3(kTiles, B * nc), 128, cb_smem<N>(), stream>>>(Bm, Cm, w.cb, S, nc);
  SSD_TRY(cudaGetLastError());
  ssd_state_kernel<N><<<dim3(H, nc, B), 128 * Dims<N>::kWG, state_smem<N>(), stream>>>(
      xb, dt, A, Bm, w.st, w.cdt, w.decay, S, H, P, nc);
  SSD_TRY(cudaGetLastError());
  ssd_pass_kernel<<<dim3((N * P / 8 + 255) / 256, H, B), 256, 0, stream>>>(w.st, w.decay, H,
                                                                            N * P, nc);
  SSD_TRY(cudaGetLastError());
  ssd_scan_kernel<N><<<dim3(kT / kScanRows, (H + kHG - 1) / kHG, B * nc), 256, scan_smem<N>(),
                       stream>>>(xb, w.cb, Cm, w.st, w.cdt, static_cast<__nv_bfloat16*>(y), S, H,
                                 P, nc);
  return static_cast<int>(cudaGetLastError());
}

#undef SSD_TRY

}  // namespace tc

}  // namespace

// x and y (B, S, H, P) of one dtype (0: float32 -> one kernel on the CUDA
// cores, 1: bfloat16 -> four passes on the tensor cores); dt (B, S, H),
// A (H,), Bm and Cm (B, S, N) float32; all contiguous and 16-byte aligned.
// N in {8, 16, 128} (the reduced configs, hymba, mamba2), P in {16, 32,
// 64}. `ws`: the float32 workspace of tc::carve's layout (bfloat16 only,
// null for float32; ssd.py's _workspace_floats gives its size). Launches
// on `stream`; returns the cudaError_t of the first launch that fails.
extern "C" int ssd_launch(const void* x, const float* dt, const float* A,
                          const float* Bm, const float* Cm, void* y, float* ws, int dtype,
                          int B, int S, int H, int N, int P, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P != 16 && P != 32 && P != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return f32::launch_np<float>(x, dt, A, Bm, Cm, y, B, S, H, N, P, st);
  if (dtype != 1 || ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {
    case 8: return tc::launch<8>(x, dt, A, Bm, Cm, y, ws, B, S, H, P, st);
    case 16: return tc::launch<16>(x, dt, A, Bm, Cm, y, ws, B, S, H, P, st);
    case 128: return tc::launch<128>(x, dt, A, Bm, Cm, y, ws, B, S, H, P, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
