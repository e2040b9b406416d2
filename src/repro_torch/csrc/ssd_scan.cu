// Mamba-2 SSD chunked scan (prefill) for NVIDIA Hopper, written by hand.
//
// Replaces the TPU kernel `ssd_scan` -> `_kernel` of
// src/repro/kernels/ssd_scan.py and computes the same function:
// x (B,S,H,P), B/C (B,S,G,N) in bf16 or f32 (one dtype for the three),
// dt (B,S,H) f32 (post-softplus), A (H,) f32 (negative); y (B,S,H,P) in x's
// dtype and the final state (B,H,P,N) in f32. Head h reads group
// h / (H/G) of B and C. Per chunk of Q steps, with cum = cumsum(dt*A) and
// total = cum[Q-1]:
//   y[i]    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i . state
//   state'  = state exp(total) + sum_j x_j dt_j exp(total - cum_j) B_j^T
// all in f32.
//
// What bounds it on the H100: at the serving path's full width (H = 80,
// P = 64, N = 128, G = 1, Q = 256, S <= 1024) the function moves x, y, B, C,
// dt and the final state once (about 24 MB at S = 1024 in bf16) and needs
// about 4 GFLOP when C.B^T is formed once per group: it is bound by bytes.
// This kernel recomputes C.B^T per head and per head-dim tile, as the TPU
// kernel does, and runs every product as f32 FMA on CUDA cores, so it does
// some 20x that work and is bound by its own operations, far above the
// bound; sharing C.B^T across the heads of a group and tensor cores are
// later work.
//
// What its design does about the TPU kernel's assumptions:
// - The carry has no grid order on the card. The TPU kernel keeps the state
//   in VMEM scratch across the ordered chunk axis of its grid. Here one
//   block owns (batch, head, a tile of 32 head-dim columns) and loops over
//   the chunks itself, keeping its 32 x N f32 slice of the state in shared
//   memory; y[:, p] and state[p, :] depend on no other column p, so the
//   head-dim tiles are independent blocks.
// - The Q x Q decay matrix does not fit. At Q = 256 each of L, C.B^T and the
//   weights is 256 KB in f32, over the 227 KB a block may have. The block
//   walks the chunk in 64-row tiles of i and, for each, the 64-column tiles
//   of j at or below the diagonal, forming a 64 x 64 weight tile at a time.
// - The masked exponent overflows. exp(cum_i - cum_j) for i < j is exp of a
//   positive number and reaches inf in f32 once |dA| sums past ~88; the TPU
//   kernel masks it afterwards with `where`. Here it is computed only for
//   i >= j, and masked weights are set to 0, never multiplied by a mask.
// - cumsum within a chunk is a block-wide scan (warp shuffles, then one
//   warp over the warp totals), one step per thread, so Q <= 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kR = 64;         // rows (i) and columns (j) of a chunk tile
constexpr int kPT = 32;        // head-dim columns per block
constexpr int kMaxN = 128;     // state width: 8 columns a thread
constexpr int kMaxQ = 256;     // chunk: one scan step a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int N) {
  const int NP = N + 1;
  // C tile, B tile [kR][N+1]; x tile [kR][kPT+1]; weights [kR][kR+1];
  // state [kPT][N+1]; dt and cum [kMaxQ]; warp totals [32]
  return sizeof(float) * ((size_t)2 * kR * NP + kR * (kPT + 1) +
                          kR * (kR + 1) + kPT * NP + 2 * kMaxQ + 32);
}

// Inclusive prefix sum of one value per thread over the block.
__device__ float block_inclusive_scan(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? warp_tot[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += n;
    }
    if (lane < kThreads / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, T* __restrict__ y,
            float* __restrict__ fin, int S, int H, int P, int G, int N,
            int Q) {
  const int NP = N + 1;
  constexpr int XP = kPT + 1;
  constexpr int WP = kR + 1;
  extern __shared__ float smem[];
  float* Cs = smem;
  float* Bs = Cs + kR * NP;
  float* xs = Bs + kR * NP;
  float* ws = xs + kR * XP;
  float* St = ws + kR * WP;
  float* dts = St + kPT * NP;
  float* cum = dts + kMaxQ;
  float* warp_tot = cum + kMaxQ;

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float a = A[h];

  for (int idx = tid; idx < kPT * NP; idx += kThreads) St[idx] = 0.f;

  // row r of a tile of B or C at sequence step s
  auto bc_off = [&](int s) { return ((size_t)b * S + s) * G * N + (size_t)g * N; };
  auto x_off = [&](int s) { return (((size_t)b * S + s) * H + h) * P; };

  const int n_chunks = S / Q;
  const int n_tiles = (Q + kR - 1) / kR;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * Q;
    __syncthreads();  // the previous chunk is done with dts, cum and St
    float da = 0.f;
    if (tid < Q) {
      const float d = dt[((size_t)b * S + s0 + tid) * H + h];
      dts[tid] = d;
      da = d * a;
    }
    const float cv = block_inclusive_scan(da, warp_tot);
    if (tid < Q) cum[tid] = cv;
    __syncthreads();
    const float total = cum[Q - 1];

    // ---- y, one 64-row tile of the chunk at a time ----
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kR;
      __syncthreads();  // the previous tile is done with Cs
      for (int idx = tid; idx < kR * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        Cs[r * NP + n] =
            i0 + r < Q ? to_f32(Cm[bc_off(s0 + i0 + r) + n]) : 0.f;
      }
      float yacc[4][2];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) yacc[ii][0] = yacc[ii][1] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kR;
        __syncthreads();  // every thread is done with Bs, xs and ws
        for (int idx = tid; idx < kR * N; idx += kThreads) {
          const int r = idx / N, n = idx % N;
          Bs[r * NP + n] =
              j0 + r < Q ? to_f32(Bm[bc_off(s0 + j0 + r) + n]) : 0.f;
        }
        for (int idx = tid; idx < kR * kPT; idx += kThreads) {
          const int r = idx / kPT, col = idx % kPT;
          xs[r * XP + col] = (j0 + r < Q && p0 + col < P)
                                 ? to_f32(x[x_off(s0 + j0 + r) + p0 + col])
                                 : 0.f;
        }
        __syncthreads();

        // C_i . B_j for this thread's 4 x 4 (i, j)
        float sc[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cr[4], br[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) cr[ii] = Cs[(ty * 4 + ii) * NP + n];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) br[jj] = Bs[(tx + 16 * jj) * NP + n];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              sc[ii][jj] = fmaf(cr[ii], br[jj], sc[ii][jj]);
        }
        // weights: the decay is evaluated only where i >= j
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = i0 + ty * 4 + ii;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = j0 + tx + 16 * jj;
            float w = 0.f;
            if (i < Q && j <= i)
              w = sc[ii][jj] * expf(cum[i] - cum[j]) * dts[j];
            ws[(ty * 4 + ii) * WP + tx + 16 * jj] = w;
          }
        }
        __syncthreads();

        // y_i += sum_j w_ij x_j for this thread's 4 rows x 2 columns
#pragma unroll 8
        for (int j = 0; j < kR; ++j) {
          const float x0 = xs[j * XP + tx], x1 = xs[j * XP + tx + 16];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float w = ws[(ty * 4 + ii) * WP + j];
            yacc[ii][0] = fmaf(w, x0, yacc[ii][0]);
            yacc[ii][1] = fmaf(w, x1, yacc[ii][1]);
          }
        }
      }

      // the incoming state: y_i += exp(cum_i) C_i . state[p]
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = ty * 4 + ii;
        float s0v = 0.f, s1v = 0.f;
        for (int n = 0; n < N; ++n) {
          const float cval = Cs[r * NP + n];
          s0v = fmaf(cval, St[tx * NP + n], s0v);
          s1v = fmaf(cval, St[(tx + 16) * NP + n], s1v);
        }
        const int i = i0 + r;
        if (i < Q) {
          const float e = expf(cum[i]);
          T* dst = y + x_off(s0 + i) + p0;
          if (p0 + tx < P) store(dst + tx, fmaf(e, s0v, yacc[ii][0]));
          if (p0 + tx + 16 < P)
            store(dst + tx + 16, fmaf(e, s1v, yacc[ii][1]));
        }
      }
    }

    // ---- state for the next chunk ----
    // this thread owns state rows ty*2 .. ty*2+1 and columns tx + 16*nn
    float sacc[2][kMaxN / 16];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nn = 0; nn < kMaxN / 16; ++nn) sacc[r][nn] = 0.f;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * kR;
      __syncthreads();  // every thread is done with Bs and xs (and St reads)
      for (int idx = tid; idx < kR * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        Bs[r * NP + n] =
            j0 + r < Q ? to_f32(Bm[bc_off(s0 + j0 + r) + n]) : 0.f;
      }
      for (int idx = tid; idx < kR * kPT; idx += kThreads) {
        const int r = idx / kPT, col = idx % kPT;
        const int j = j0 + r;
        float u = 0.f;
        if (j < Q && p0 + col < P)
          u = to_f32(x[x_off(s0 + j) + p0 + col]) *
              (dts[j] * expf(total - cum[j]));
        xs[r * XP + col] = u;
      }
      __syncthreads();
      const int jn = min(kR, Q - j0);
      for (int j = 0; j < jn; ++j) {
        const float u0 = xs[j * XP + ty * 2], u1 = xs[j * XP + ty * 2 + 1];
#pragma unroll
        for (int nn = 0; nn < kMaxN / 16; ++nn) {
          const int n = tx + 16 * nn;
          if (n < N) {
            const float bv = Bs[j * NP + n];
            sacc[0][nn] = fmaf(u0, bv, sacc[0][nn]);
            sacc[1][nn] = fmaf(u1, bv, sacc[1][nn]);
          }
        }
      }
    }
    const float et = expf(total);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nn = 0; nn < kMaxN / 16; ++nn) {
        const int n = tx + 16 * nn;
        if (n < N) {
          float* sp = St + (ty * 2 + r) * NP + n;
          *sp = fmaf(*sp, et, sacc[r][nn]);
        }
      }
  }

  __syncthreads();
  for (int idx = tid; idx < kPT * N; idx += kThreads) {
    const int r = idx / N, n = idx % N;
    if (p0 + r < P)
      fin[(((size_t)b * H + h) * P + p0 + r) * N + n] = St[r * NP + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* fin,
                   int Bsz, int S, int H, int P, int G, int N, int Q,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kPT - 1) / kPT, H, Bsz);
  ssd_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), fin, S, H, P, G, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 on success). All tensors are contiguous; `is_bf16` selects bf16
// over f32 for x, B, C and y; dt, A and the final state are f32.
int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* fin,
                       int Bsz, int S, int H, int P, int G, int N, int Q,
                       int is_bf16, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* finf = static_cast<float*>(fin);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, finf, Bsz, S, H,
                                      P, G, N, Q, s);
  return (int)launch<float>(x, dtf, Af, Bm, Cm, y, finf, Bsz, S, H, P, G, N,
                            Q, s);
}

const char* repro_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
