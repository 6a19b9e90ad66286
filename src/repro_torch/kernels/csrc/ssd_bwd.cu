// Backward of the Mamba-2 SSD scan (ssd.cu): dx, ddt, dA, dB and dC of
// y = ssd(x, dt, A, Bm, Cm) against dy, float32 inside, for bfloat16 and
// float32 x.
//
// Replaces no TPU kernel. The JAX package has no backward kernel: its
// training differentiates the plain ref.ssd, a sequential scan. On the card
// the forward is a kernel whose output carries no autograd graph, so
// training needs the gradient as a kernel too (kernels/ops.py's SSDScan
// calls it); the plain version is ref.ssd_grads.
//
// The math, per batch row b and head h, with a_t = exp(A dt_t) and the state
// h_t = a_t h_{t-1} + dt_t B_t x_t^T (N x P): the adjoint state runs in
// reverse, g_t = C_t dy_t^T + a_{t+1} g_{t+1}, and
//   dx_t = dt_t g_t^T B_t,   dB_t = sum_h dt_t g_t x_t,   dC_t = sum_h h_t dy_t.
// The decay terms need no inner product of states: with
// r_t = C_t . (h_t dy_t) - x_t . dx_t (per head; C_t . (h_t dy_t) = y_t . dy_t,
// taken from the float32 dC partial, not from the forward's y, which in
// bfloat16 was rounded), the gradient with respect to A dt_i is
// ddA_i = sum_{k >= i} r_k, so ddt_i = B_i . (g_i x_i) + A ddA_i and
// dA = sum_{b, i} dt_i ddA_i.
//
// Within a tile of kT rows with in-tile sums cum_i = sum_{j <= i} A dt_j, the
// state entering the tile h_in and the adjoint leaving it G (= a_{next}
// g_{next}), the chunked form of the forward (ssd.cu) transposed:
//   Z[i][k] = exp(cum_k - cum_i) (C_k . B_i),  W[i][k] = exp(cum_k - cum_i)
//   (x_i . dy_k), both for k >= i (0 else);
//   v_i    = sum_k Z[i][k] dy_k + exp(cum_last - cum_i) G^T B_i,   dx_i = dt_i v_i;
//   dB_i   = dt_i (sum_k W[i][k] C_k + exp(cum_last - cum_i) G x_i);
//   dC_k   = sum_i dt_i W[i][k] B_i + exp(cum_k) h_in dy_k;
//   r_k    = C_k . dC_k - dt_k (x_k . v_k),   x_k . v_k = B_k . (g_k x_k).
// Across tiles, h_in' = exp(cum_last) h_in + sum_j exp(cum_last - cum_j) dt_j
// B_j x_j^T (the forward's update) and, in reverse, G' = exp(cum_last) G +
// sum_k exp(cum_k) C_k dy_k^T. Every exponent is a difference of in-tile sums
// of A dt <= 0, so no decay exceeds 1 and none overflows; expf, not __expf.
// Rows past S load as zeros with dt = 0 (inert) and are never stored.
//
// What bounds it on the H100: bytes, for the function; this design is bound
// by its float32 CUDA-core work. At mamba2-1.3b's training shape (B 8, S 256,
// 64 heads of P 64, N 128, x and dy bf16) the function reads x, dy, dt, B,
// C and writes dx, ddt, dB, dC: 55.6 MB, 16.6 us at 3.35 TB/s; the chunked
// algorithm at 32-row tiles needs 15.0 GFLOP (15.2 us at the bf16
// tensor-core rate, 224 us at the 67 TFLOP/s float32 rate of the CUDA
// cores, where this design runs it).
//
// The design, simple and deterministic (no atomics: every output element is
// written by one thread in one fixed order, so two calls give the same bits):
//   1. ssd_bwd_state_kernel, one CTA per (h, b, direction): the state
//      entering each 32-row tile (forward over the tiles) or the adjoint
//      leaving it (in reverse), a rank-32 update of the N x P state a tile,
//      each thread owning a block of the state in registers as the forward's
//      float32 kernel does; written to a float32 workspace.
//   2. ssd_bwd_chunk_kernel, one CTA per (tile, h, b): Z and W, then dx and
//      the head's partials of dB (with G in shared memory), then of dC (with
//      h_in), and r and x . v of each row.
//   3. ssd_bwd_dt_kernel, a warp per (b, h): the reverse cumulative sum of r
//      in 32-row blocks from the end (a suffix scan by shuffles, a carry),
//      ddt, and the (b, h) partial of dA in a fixed tree.
//   4. ssd_bwd_reduce_kernel: dB and dC summed over the heads in order, dA
//      over the batch rows in order.
// The workspace (ssd.py's _bwd_workspace_floats mirrors its size): the
// states and adjoints (B, H, tiles, N, P) each, the partials of dB and dC
// (B, H, S, N) each, r and x . v (B, H, S), dA's partials (B, H).
//
// Not yet: the tensor cores (the forward's four passes transposed, in chunks
// of 256 rows, every float32 operand as two bf16 terms), and dB and dC summed
// over the heads inside the chunk kernel.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace bwd {

constexpr int kT = 32;         // rows per tile: one warp scans them
constexpr int kThreads = 256;
constexpr int kLDZ = kT + 1;   // padded row of a kT x kT tile

template <int N, int P>
struct Layout {
  static constexpr int kLDB = N + 4;  // B and C rows, float4-aligned
  static constexpr int kLDX = P + 4;  // x and dy rows, float4-aligned
  static constexpr int kLDS = P + 1;  // state rows: odd, no bank conflicts
  // the state update (kernel 1): thread (rg, pp) owns rows n0 .. n0 + kNPT - 1
  // and columns 2 pp, 2 pp + 1
  static constexpr int kPP = P / 2;
  static constexpr int kRG = kThreads / kPP;
  static constexpr int kNPT = N >= kRG ? N / kRG : 1;
  static constexpr int kOwners = N / kNPT;
  // (kT, P) outputs (kernel 2): thread (xr, xc) owns rows xr * kRX .. and
  // columns xc, xc + P / 2, so a row's threads are kXC neighbours of a warp
  static constexpr int kXC = P / 2;
  static constexpr int kXR = kThreads / kXC;
  static constexpr int kRX = kT / kXR;
  // (kT, N) outputs (kernel 2): thread (nr, nc) owns rows nr * kRN .. and
  // columns nc + kNC c, c < 4; threads past kNR * kNC idle
  static constexpr int kNC = N / 4;
  static constexpr int kNR = kThreads / kNC < kT ? kThreads / kNC : kT;
  static constexpr int kRN = kT / kNR;
  static_assert(kRX >= 1 && kT % kXR == 0, "P must be 16, 32 or 64");
  static_assert(kNC <= 32 && 32 % kNC == 0 && kT % kNR == 0, "N must be 8, 16 or 128");
  static_assert(N % kNPT == 0 && N % 4 == 0, "N must be a multiple of 4");
};

__device__ __forceinline__ float load_x(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// inclusive scan of one tile's A dt in warp 0: cum, exp(cum), exp(last -
// cum), dt; rows past S have dt = 0. Returns nothing; the caller syncs.
__device__ __forceinline__ void scan_tile(const float* dtb, int H, int s0, int S, float a_h,
                                          float* cum, float* ecum, float* elast, float* dts) {
  const int lane = threadIdx.x & 31;
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
  elast[lane] = expf(last - c);
  dts[lane] = d;
}

// rows [s0, s0 + kT) of a (S, N) float32 matrix into a kT x (N + 4) tile
template <int N>
__device__ __forceinline__ void load_bc(float* dst, const float* src, int s0, int S) {
  constexpr int kV = N / 4;
  for (int i = threadIdx.x; i < kT * kV; i += kThreads) {
    const int r = i / kV;
    const int c = (i % kV) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < S) v = *reinterpret_cast<const float4*>(src + static_cast<size_t>(s0 + r) * N + c);
    *reinterpret_cast<float4*>(dst + r * (N + 4) + c) = v;
  }
}

// rows [s0, s0 + kT) of one head of x or dy ((S, H, P), row stride H * P)
// widened into a kT x (P + 4) tile
template <int P>
__device__ __forceinline__ void load_rows(float* dst, const void* src, size_t base, size_t xrow,
                                          int s0, int S, int bf16) {
  for (int i = threadIdx.x; i < kT * P; i += kThreads) {
    const int r = i / P;
    const int c = i % P;
    dst[r * (P + 4) + c] =
        s0 + r < S ? load_x(src, base + static_cast<size_t>(s0 + r) * xrow + c, bf16) : 0.f;
  }
}

// 1. The state entering each tile (blockIdx.z 0, forward) or the adjoint
// leaving it (blockIdx.z 1, reverse) of one (b, h), into `out` (B, H, nt, N,
// P).
template <int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const void* __restrict__ x, const void* __restrict__ dy,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     float* __restrict__ hs, float* __restrict__ gs, int S, int H, int nt,
                     int bf16) {
  using L = Layout<N, P>;
  constexpr int kNPT = L::kNPT;
  __shared__ __align__(16) float Ls[kT * L::kLDB];  // B w (forward) or C exp(cum)
  __shared__ __align__(16) float Rs[kT * L::kLDX];  // x (forward) or dy
  __shared__ float cum[kT], ecum[kT], elast[kT], dts[kT];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool rev = blockIdx.z == 1;
  const int tid = threadIdx.x;
  const float a_h = A[h];
  const size_t xrow = static_cast<size_t>(H) * P;
  const size_t xbase = static_cast<size_t>(b) * S * xrow + static_cast<size_t>(h) * P;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  const float* vb = (rev ? Cm : Bm) + static_cast<size_t>(b) * S * N;
  const void* rows = rev ? dy : x;
  float* out = (rev ? gs : hs) + (static_cast<size_t>(b) * H + h) * nt * N * P;

  const int pp = tid % L::kPP;
  const int rg = tid / L::kPP;
  const int p = 2 * pp;
  const int n0 = rg * kNPT;
  const bool owner = rg < L::kOwners;
  float st[kNPT][2];
#pragma unroll
  for (int k = 0; k < kNPT; ++k) st[k][0] = st[k][1] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int t = rev ? nt - 1 - it : it;
    const int s0 = t * kT;
    if (owner) {
      float* o = out + static_cast<size_t>(t) * N * P;
#pragma unroll
      for (int k = 0; k < kNPT; ++k)
        *reinterpret_cast<float2*>(o + (n0 + k) * P + p) = make_float2(st[k][0], st[k][1]);
    }
    if (tid < 32) scan_tile(dtb, H, s0, S, a_h, cum, ecum, elast, dts);
    load_bc<N>(Ls, vb, s0, S);
    load_rows<P>(Rs, rows, xbase, xrow, s0, S, bf16);
    __syncthreads();
    // row j's vector times its weight: exp(cum_last - cum_j) dt_j forward,
    // exp(cum_j) in reverse
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N;
      Ls[r * L::kLDB + i % N] *= rev ? ecum[r] : elast[r] * dts[r];
    }
    __syncthreads();
    if (owner) {
      float d[kNPT][2];
#pragma unroll
      for (int k = 0; k < kNPT; ++k) d[k][0] = d[k][1] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kT; ++j) {
        const float2 rv = *reinterpret_cast<const float2*>(Rs + j * L::kLDX + p);
        const float* lv = Ls + j * L::kLDB + n0;
#pragma unroll
        for (int k = 0; k < kNPT; ++k) {
          d[k][0] = fmaf(lv[k], rv.x, d[k][0]);
          d[k][1] = fmaf(lv[k], rv.y, d[k][1]);
        }
      }
      const float el = ecum[kT - 1];
#pragma unroll
      for (int k = 0; k < kNPT; ++k) {
        st[k][0] = el * st[k][0] + d[k][0];
        st[k][1] = el * st[k][1] + d[k][1];
      }
    }
    __syncthreads();  // before the next tile overwrites the tiles
  }
}

template <int N, int P>
constexpr size_t chunk_smem() {
  using L = Layout<N, P>;
  return sizeof(float) * (2 * kT * L::kLDB + 2 * kT * L::kLDX + N * L::kLDS + 2 * kT * kLDZ +
                          5 * kT);
}

// 2. One tile of one (b, h): dx, the head's partials of dB and dC, r and
// x . v per row.
template <int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const void* __restrict__ x, const void* __restrict__ dy,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     const float* __restrict__ hs, const float* __restrict__ gs,
                     void* __restrict__ dx, float* __restrict__ pdB, float* __restrict__ pdC,
                     float* __restrict__ rr, float* __restrict__ qq, int S, int H, int nt,
                     int bf16) {
  using L = Layout<N, P>;
  constexpr int kLDB = L::kLDB, kLDX = L::kLDX, kLDS = L::kLDS;
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                 // kT x kLDB
  float* Cs = Bs + kT * kLDB;       // kT x kLDB
  float* Xs = Cs + kT * kLDB;       // kT x kLDX
  float* Ys = Xs + kT * kLDX;       // kT x kLDX: dy
  float* Ss = Ys + kT * kLDX;       // N x kLDS: G, then h_in
  float* Zs = Ss + N * kLDS;        // kT x kLDZ
  float* Ws = Zs + kT * kLDZ;       // kT x kLDZ
  float* cum = Ws + kT * kLDZ;
  float* ecum = cum + kT;
  float* elast = ecum + kT;
  float* dts = elast + kT;
  float* qs = dts + kT;             // x_i . v_i

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = t * kT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t xrow = static_cast<size_t>(H) * P;
  const size_t xbase = static_cast<size_t>(b) * S * xrow + static_cast<size_t>(h) * P;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* st = hs + (bh * nt + t) * N * P;
  const float* ad = gs + (bh * nt + t) * N * P;

  if (tid < 32) scan_tile(dt + static_cast<size_t>(b) * S * H + h, H, s0, S, A[h], cum, ecum,
                          elast, dts);
  load_bc<N>(Bs, Bm + static_cast<size_t>(b) * S * N, s0, S);
  load_bc<N>(Cs, Cm + static_cast<size_t>(b) * S * N, s0, S);
  load_rows<P>(Xs, x, xbase, xrow, s0, S, bf16);
  load_rows<P>(Ys, dy, xbase, xrow, s0, S, bf16);
  for (int i = tid; i < N * P; i += kThreads) Ss[(i / P) * kLDS + i % P] = ad[i];
  __syncthreads();

  // --- Z[i][k] = exp(cum_k - cum_i) (C_k . B_i), W[i][k] = exp(cum_k - cum_i)
  // (x_i . dy_k), k >= i: warp w rows 4w .. 4w + 3, lane k ---
  {
    const int k = lane;
    const int i0 = warp * 4;
    float z[4] = {0.f, 0.f, 0.f, 0.f}, w[4] = {0.f, 0.f, 0.f, 0.f};
    const float* ck = Cs + k * kLDB;
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(ck + n);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 bv = *reinterpret_cast<const float4*>(Bs + (i0 + r) * kLDB + n);
        z[r] = fmaf(cv.x, bv.x, z[r]);
        z[r] = fmaf(cv.y, bv.y, z[r]);
        z[r] = fmaf(cv.z, bv.z, z[r]);
        z[r] = fmaf(cv.w, bv.w, z[r]);
      }
    }
    const float* yk = Ys + k * kLDX;
#pragma unroll 4
    for (int p = 0; p < P; p += 4) {
      const float4 yv = *reinterpret_cast<const float4*>(yk + p);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(Xs + (i0 + r) * kLDX + p);
        w[r] = fmaf(xv.x, yv.x, w[r]);
        w[r] = fmaf(xv.y, yv.y, w[r]);
        w[r] = fmaf(xv.z, yv.z, w[r]);
        w[r] = fmaf(xv.w, yv.w, w[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
      const float g = k >= i ? expf(cum[k] - cum[i]) : 0.f;
      Zs[i * kLDZ + k] = g * z[r];
      Ws[i * kLDZ + k] = g * w[r];
    }
  }
  __syncthreads();

  // --- dx (P outputs): v_i = sum_k Z[i][k] dy_k + exp(cum_last - cum_i) G^T B_i ---
  {
    const int xc = tid % L::kXC;
    const int xi0 = (tid / L::kXC) * L::kRX;
    float acc[L::kRX][2], accg[L::kRX][2];
#pragma unroll
    for (int r = 0; r < L::kRX; ++r) acc[r][0] = acc[r][1] = accg[r][0] = accg[r][1] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kT; ++k) {
      const float y0 = Ys[k * kLDX + xc];
      const float y1 = Ys[k * kLDX + xc + L::kXC];
#pragma unroll
      for (int r = 0; r < L::kRX; ++r) {
        const float z = Zs[(xi0 + r) * kLDZ + k];
        acc[r][0] = fmaf(z, y0, acc[r][0]);
        acc[r][1] = fmaf(z, y1, acc[r][1]);
      }
    }
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float g0 = Ss[n * kLDS + xc];
      const float g1 = Ss[n * kLDS + xc + L::kXC];
#pragma unroll
      for (int r = 0; r < L::kRX; ++r) {
        const float bv = Bs[(xi0 + r) * kLDB + n];
        accg[r][0] = fmaf(bv, g0, accg[r][0]);
        accg[r][1] = fmaf(bv, g1, accg[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < L::kRX; ++r) {
      const int i = xi0 + r;
      const float v0 = acc[r][0] + elast[i] * accg[r][0];
      const float v1 = acc[r][1] + elast[i] * accg[r][1];
      float q = Xs[i * kLDX + xc] * v0 + Xs[i * kLDX + xc + L::kXC] * v1;
#pragma unroll
      for (int off = L::kXC / 2; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
      const int s = s0 + i;
      if (xc == 0) qs[i] = q;
      if (s < S) {
        const size_t o = xbase + static_cast<size_t>(s) * xrow + xc;
        const float d0 = dts[i] * v0;
        const float d1 = dts[i] * v1;
        if (bf16) {
          static_cast<__nv_bfloat16*>(dx)[o] = __float2bfloat16_rn(d0);
          static_cast<__nv_bfloat16*>(dx)[o + L::kXC] = __float2bfloat16_rn(d1);
        } else {
          static_cast<float*>(dx)[o] = d0;
          static_cast<float*>(dx)[o + L::kXC] = d1;
        }
      }
    }
  }

  // --- dB (N outputs): dt_i (sum_k W[i][k] C_k + exp(cum_last - cum_i) G x_i) ---
  const int nc = tid % L::kNC;
  const int ni0 = (tid / L::kNC) * L::kRN;
  const bool nlive = tid < L::kNR * L::kNC;
  if (nlive) {
    float acc[L::kRN][4], accg[L::kRN][4];
#pragma unroll
    for (int r = 0; r < L::kRN; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = accg[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kT; ++k) {
      float cv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) cv[c] = Cs[k * kLDB + nc + L::kNC * c];
#pragma unroll
      for (int r = 0; r < L::kRN; ++r) {
        const float w = Ws[(ni0 + r) * kLDZ + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(w, cv[c], acc[r][c]);
      }
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float gv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) gv[c] = Ss[(nc + L::kNC * c) * kLDS + p];
#pragma unroll
      for (int r = 0; r < L::kRN; ++r) {
        const float xv = Xs[(ni0 + r) * kLDX + p];
#pragma unroll
        for (int c = 0; c < 4; ++c) accg[r][c] = fmaf(gv[c], xv, accg[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < L::kRN; ++r) {
      const int i = ni0 + r;
      const int s = s0 + i;
      if (s >= S) continue;
      float* o = pdB + (bh * S + s) * N + nc;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[L::kNC * c] = dts[i] * (acc[r][c] + elast[i] * accg[r][c]);
    }
  }
  __syncthreads();  // G's last reader, qs's writers
  for (int i = tid; i < N * P; i += kThreads) Ss[(i / P) * kLDS + i % P] = st[i];
  __syncthreads();

  // --- dC (N outputs): sum_i dt_i W[i][k] B_i + exp(cum_k) h_in dy_k; then r ---
  if (nlive) {
    float acc[L::kRN][4], acch[L::kRN][4];
#pragma unroll
    for (int r = 0; r < L::kRN; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = acch[r][c] = 0.f;
#pragma unroll 4
    for (int i = 0; i < kT; ++i) {
      float bv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[i * kLDB + nc + L::kNC * c];
#pragma unroll
      for (int r = 0; r < L::kRN; ++r) {
        const float w = dts[i] * Ws[i * kLDZ + ni0 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(w, bv[c], acc[r][c]);
      }
    }
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float hv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) hv[c] = Ss[(nc + L::kNC * c) * kLDS + p];
#pragma unroll
      for (int r = 0; r < L::kRN; ++r) {
        const float yv = Ys[(ni0 + r) * kLDX + p];
#pragma unroll
        for (int c = 0; c < 4; ++c) acch[r][c] = fmaf(hv[c], yv, acch[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < L::kRN; ++r) {
      const int k = ni0 + r;
      const int s = s0 + k;
      float dc[4];
      float cd = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dc[c] = acc[r][c] + ecum[k] * acch[r][c];
        cd = fmaf(Cs[k * kLDB + nc + L::kNC * c], dc[c], cd);
      }
#pragma unroll
      for (int off = L::kNC / 2; off > 0; off >>= 1) cd += __shfl_xor_sync(0xffffffffu, cd, off, L::kNC);
      if (s >= S) continue;
      float* o = pdC + (bh * S + s) * N + nc;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[L::kNC * c] = dc[c];
      if (nc == 0) {
        rr[bh * S + s] = cd - dts[k] * qs[k];
        qq[bh * S + s] = qs[k];
      }
    }
  }
}

// 3. A warp per (b, h): ddA_i = sum_{k >= i} r_k from the end in 32-row
// blocks, ddt_i = x_i . v_i + A ddA_i, and sum_i dt_i ddA_i.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ rr, const float* __restrict__ qq,
                  float* __restrict__ ddt, float* __restrict__ pdA, int B, int S, int H) {
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (bh >= B * H) return;
  const int b = bh / H;
  const int h = bh % H;
  const float a_h = A[h];
  const float* r = rr + static_cast<size_t>(bh) * S;
  const float* q = qq + static_cast<size_t>(bh) * S;
  float carry = 0.f, acc = 0.f;
  for (int s0 = (S - 1) / 32 * 32; s0 >= 0; s0 -= 32) {
    const int s = s0 + lane;
    float v = s < S ? r[s] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, v, off);
      if (lane + off < 32) v += u;
    }
    const float dda = v + carry;
    carry += __shfl_sync(0xffffffffu, v, 0);
    if (s < S) {
      const size_t o = (static_cast<size_t>(b) * S + s) * H + h;
      ddt[o] = q[s] + a_h * dda;
      acc = fmaf(dt[o], dda, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) pdA[bh] = acc;
}

// 4. dB and dC: the heads' partials summed in order, a thread per (b, s, n);
// dA: the batch rows' partials summed in order, the H threads after those.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ pdB, const float* __restrict__ pdC,
                      const float* __restrict__ pdA, float* __restrict__ dB,
                      float* __restrict__ dC, float* __restrict__ dA, int B, int S, int H,
                      int N) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t total = static_cast<size_t>(B) * S * N;
  if (i < total) {
    const size_t sn = static_cast<size_t>(S) * N;
    const size_t b = i / sn;
    const float* pb = pdB + b * H * sn + i % sn;
    const float* pc = pdC + b * H * sn + i % sn;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += pb[h * sn];
      sc += pc[h * sn];
    }
    dB[i] = sb;
    dC[i] = sc;
  } else if (i < total + H) {
    const int h = static_cast<int>(i - total);
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += pdA[static_cast<size_t>(b) * H + h];
    dA[h] = s;
  }
}

#define SSD_BWD_TRY(call)                               \
  do {                                                  \
    const cudaError_t e_ = (call);                      \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

template <int N, int P>
int launch(const void* x, const float* dt, const float* A, const float* Bm, const float* Cm,
           const void* dy, void* dx, float* ddt, float* dA, float* dB, float* dC, float* ws,
           int bf16, int B, int S, int H, cudaStream_t stream) {
  const int nt = (S + kT - 1) / kT;
  const size_t states = static_cast<size_t>(B) * H * nt * N * P;
  const size_t parts = static_cast<size_t>(B) * H * S * N;
  const size_t rows = static_cast<size_t>(B) * H * S;
  float* hs = ws;
  float* gs = hs + states;
  float* pdB = gs + states;
  float* pdC = pdB + parts;
  float* rr = pdC + parts;
  float* qq = rr + rows;
  float* pdA = qq + rows;
  ssd_bwd_state_kernel<N, P><<<dim3(H, B, 2), kThreads, 0, stream>>>(x, dy, dt, A, Bm, Cm, hs,
                                                                      gs, S, H, nt, bf16);
  SSD_BWD_TRY(cudaGetLastError());
  constexpr size_t smem = chunk_smem<N, P>();
  auto chunk = ssd_bwd_chunk_kernel<N, P>;
  SSD_BWD_TRY(cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem)));
  chunk<<<dim3(nt, H, B), kThreads, smem, stream>>>(x, dy, dt, A, Bm, Cm, hs, gs, dx, pdB, pdC,
                                                    rr, qq, S, H, nt, bf16);
  SSD_BWD_TRY(cudaGetLastError());
  const int warps = kThreads / 32;
  ssd_bwd_dt_kernel<<<(B * H + warps - 1) / warps, kThreads, 0, stream>>>(dt, A, rr, qq, ddt,
                                                                          pdA, B, S, H);
  SSD_BWD_TRY(cudaGetLastError());
  const size_t total = static_cast<size_t>(B) * S * N + H;
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                          stream>>>(pdB, pdC, pdA, dB, dC, dA, B, S, H, N);
  return static_cast<int>(cudaGetLastError());
}

#undef SSD_BWD_TRY

}  // namespace bwd

}  // namespace

// x, dy and dx (B, S, H, P) of one dtype (0: float32, 1: bfloat16); dt and
// ddt (B, S, H), A and dA (H,), Bm, Cm, dB and dC (B, S, N) float32; all
// contiguous and 16-byte aligned. (N, P) one of the SSM configs' (8, 16),
// (16, 64) and (128, 64) (ssd.py's BWD_WIDTHS). `ws`: the float32 workspace
// of bwd::launch's layout (ssd.py's _bwd_workspace_floats gives its size).
// Launches the four kernels on `stream`; returns the cudaError_t of the
// first launch that fails.
extern "C" int ssd_bwd_launch(const void* x, const float* dt, const float* A, const float* Bm,
                              const float* Cm, const void* dy, void* dx, float* ddt, float* dA,
                              float* dB, float* dC, float* ws, int dtype, int B, int S, int H,
                              int N, int P, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 8 && P == 16)
    return bwd::launch<8, 16>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, ws, dtype, B, S, H, st);
  if (N == 16 && P == 64)
    return bwd::launch<16, 64>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, ws, dtype, B, S, H, st);
  if (N == 128 && P == 64)
    return bwd::launch<128, 64>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, ws, dtype, B, S, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
