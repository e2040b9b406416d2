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
// with f32 sums.
//
// What bounds it on the H100: at the serving path's full width (H = 80,
// P = 64, N = 128, G = 1, Q = 256, S <= 1024) the function moves x, y, B, C,
// dt and the final state once (about 24 MB at S = 1024 in bf16) and needs
// about 5 GFLOP when C.B^T is formed once per group: it is bound by bytes,
// and at these sizes by a few launches and their tails.
//
// bf16 (the serving path): the chunked decomposition of
// models/mamba2.py's ssd_chunked, in two launches on the tensor cores, one
// warpgroup (128 threads) a block, every product a wgmma (bf16 in, f32
// sums; x, B and C are bf16, so their products are exact):
//   1. ssd_state_cb, two kinds of block in one grid:
//      - CB = C_c B_c^T, per (batch, chunk, group) and 64 x 64 tile at or
//        below the diagonal, ONCE PER GROUP (not per head): every head of
//        the group reads it. f32, in the order of the second kernel's
//        register fragments (a wgmma accumulator is laid out as the A
//        fragment of the same tile, so a thread of ssd_out reads the 32
//        values that the same thread here wrote, as 8 coalesced float4);
//        160 KB a chunk at Q = 256, which stays in the 50 MB L2.
//      - per (batch, head, 64-column tile of the state): the in-chunk
//        cumsum of dt*A (a block scan), the chunk state
//        S_c = sum_j (x_j dt_j e^{total - cum_j}) B_j^T as a wgmma whose A
//        (the scaled x, from registers) is split into bf16 hi + lo, and
//        the inter-chunk recurrence state_c = state_{c-1} e^{total} +
//        S_{c-1}, sequential over the chunks in registers. It writes the
//        state entering each chunk as bf16 hi + lo (the next launch's
//        operand) while the chunk's products run, and the f32 final
//        state. The products go four k-steps a batch; the next batch's A
//        fragments are built while one runs.
//   2. ssd_out, per (batch, chunk, head, 64-row tile of the chunk, 64-column
//      tile of P): y = (CB o L o dt) . x + e^{cum_i} C_i . state_in. The
//      weights W = CB o L o dt are formed in registers from CB, with the
//      decay exponentiated ONLY WHERE i >= j (masked weights are set to 0,
//      never multiplied by a mask: exp(cum_i - cum_j) above the diagonal
//      would overflow once |dt*A| sums past ~88; below the diagonal tile it
//      factors through the j tile's last cumsum into two factors <= 1, so
//      those tiles take no exp per weight), split into bf16 hi + lo and
//      multiplied with x by wgmma from registers; C . state_in is a wgmma
//      from shared memory with the state's hi and lo parts. The grid
//      is chunks x heads x row tiles x P tiles: 1,280 blocks at S = 1024,
//      320 at the 256-step serving bucket, not a serial chunk loop.
//   Tiles reach shared memory by TMA (64 x 64 boxes, one thread issuing, an
//   mbarrier counting the bytes) in the 128-byte swizzle that the wgmma
//   descriptors name, while the block computes its decays: a warpgroup's
//   own cp.async copies keep too few bytes in flight on the H100 for a
//   chunk's 64 KB. A box past P or N is zero-filled, so any P and N that
//   are multiples of 8 (16-byte rows, as a tensor map needs) take this one
//   route; rows past Q belong to the next chunk and meet zero weights.
// f32 (the tests' `1e-4 x mean` cases): the first port's body, IEEE fmaf on
// the CUDA cores, no TF32: one block owns (batch, head, a tile of 32
// head-dim columns) and loops over the chunks itself, keeping its 32 x N
// f32 slice of the state in shared memory; it walks the chunk in 64-row
// tiles of i and, for each, the 64-column tiles of j at or below the
// diagonal, forming a 64 x 64 weight tile at a time (the Q x Q decay matrix
// does not fit), evaluating the decay only for i >= j; the in-chunk cumsum
// is a block-wide scan, one step per thread, so Q <= 256.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kR = 64;         // rows (i) and columns (j) of a chunk tile
constexpr int kPT = 32;        // head-dim columns per block
constexpr int kMaxN = 128;     // state width: 8 columns a thread
constexpr int kMaxQ = 256;     // chunk: one scan step a thread


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

__global__ void __launch_bounds__(kThreads)
    ssd_fwd(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const float* __restrict__ Bm,
            const float* __restrict__ Cm, float* __restrict__ y,
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
            i0 + r < Q ? Cm[bc_off(s0 + i0 + r) + n] : 0.f;
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
              j0 + r < Q ? Bm[bc_off(s0 + j0 + r) + n] : 0.f;
        }
        for (int idx = tid; idx < kR * kPT; idx += kThreads) {
          const int r = idx / kPT, col = idx % kPT;
          xs[r * XP + col] = (j0 + r < Q && p0 + col < P)
                                 ? x[x_off(s0 + j0 + r) + p0 + col]
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
          float* dst = y + x_off(s0 + i) + p0;
          if (p0 + tx < P) dst[tx] = fmaf(e, s0v, yacc[ii][0]);
          if (p0 + tx + 16 < P)
            dst[tx + 16] = fmaf(e, s1v, yacc[ii][1]);
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
            j0 + r < Q ? Bm[bc_off(s0 + j0 + r) + n] : 0.f;
      }
      for (int idx = tid; idx < kR * kPT; idx += kThreads) {
        const int r = idx / kPT, col = idx % kPT;
        const int j = j0 + r;
        float u = 0.f;
        if (j < Q && p0 + col < P)
          u = x[x_off(s0 + j) + p0 + col] *
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


// ---------------------------------------------------------------------------
// bf16: CB once per group, chunk states and their recurrence, then y
// ---------------------------------------------------------------------------

constexpr int kWg = 128;             // one warpgroup a block
constexpr int kT = 64;               // rows of a wgmma tile, columns of a tile
constexpr int kRowB = 128;           // a 64-column bf16 row: one swizzle atom
constexpr int kChunkB = kT * kRowB;  // a 64 x 64 bf16 tile, 8 KB
constexpr int kFrag = kWg * 32;      // f32 of a 64 x 64 tile in fragments

// shared-memory byte offset of 16-byte piece `pc` of row `r` in a swizzled
// run of 128-byte rows (TMA's 128-byte swizzle from a 1024-byte boundary)
__device__ __forceinline__ uint32_t sw_off(int r, int pc) {
  return (uint32_t)(r * kRowB + ((pc ^ (r & 7)) << 4));
}

// The block's tiles are in and visible to every thread and to wgmma;
// `phase` is the parity of the TMA barrier's phase.
__device__ __forceinline__ void tiles_ready(uint64_t* bar, uint32_t phase) {
  hopper::mbar_wait(bar, phase);
  __syncthreads();
}

// descriptor of k-step `ks` of a K-major tile (64 rows, 64-column chunks)
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int ks) {
  return hopper::wgmma_desc(base + (ks / 4) * kChunkB + (ks % 4) * 32, 16,
                            8 * kRowB, kRowB);
}
// descriptor of k-step `ks` of an MN-major tile of R rows (the rows are the
// reduction, 64 columns the output)
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int R, int ks) {
  return hopper::wgmma_desc(base + ks * 16 * kRowB, R * kRowB, 8 * kRowB,
                            kRowB);
}

// this thread's two steps 2 tid, 2 tid + 1 of a chunk's dt (zero past Q)
__device__ __forceinline__ float2 chunk_dt(const float* __restrict__ dt,
                                           size_t base, int stride, int Q) {
  const int j = 2 * threadIdx.x;
  return make_float2(j < Q ? dt[base + (size_t)j * stride] : 0.f,
                     j + 1 < Q ? dt[base + (size_t)(j + 1) * stride] : 0.f);
}

// dts[j] = dt_j and cum[j] = sum_{j' <= j} dt_j' * a for j < Q, zero past Q
// (256 entries each), from each thread's chunk_dt; `tot` holds 4 floats.
// 128 threads, two steps each.
__device__ void chunk_decay(float2 dtv, float a, float* dts, float* cum,
                            float* tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = 2 * tid;
  const float d0 = dtv.x, d1 = dtv.y;
  dts[j] = d0;
  dts[j + 1] = d1;
  const float x0 = d0 * a, x1 = d1 * a;
  float v = x0 + x1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  float off = 0.f;
  for (int w = 0; w < warp; ++w) off += tot[w];
  const float excl = off + v - (x0 + x1);
  cum[j] = excl + x0;
  cum[j + 1] = excl + x0 + x1;
  __syncthreads();
}

// accumulator element e of a 64 x 64 wgmma tile held by this thread: row
// 16 warp + lane/4 + 8 ((e/2) % 2), column 8 (e/4) + 2 (lane%4) + e%2.
// For e = 8 kk + 2 u + v that is element v of A-fragment register u of
// k-step kk of the same tile read as the A operand of a product: a
// thread's accumulator is its own A fragment.
__device__ __forceinline__ int acc_row(int e) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) +
         8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int e) {
  return 8 * (e >> 2) + 2 * (threadIdx.x & 3) + (e & 1);
}

struct Dims {
  int B, S, H, P, G, N, Q;
  int nc;              // chunks
  int nit;             // 64-row tiles of a chunk
  int npt, nnt;        // 64-column tiles of P and of N
  int n_cb;            // CB blocks of the first launch
};

// shared memory of ssd_state_cb: the x and B tiles of a chunk (256 rows
// each) or a CB block's C and B tiles; dt, cum, the scan's totals and the
// TMA barrier
constexpr int kScMain = 2 * 256 * kRowB;
constexpr int kScBar = kScMain + (2 * 256 + 4) * 4;
constexpr int kScSmem = kScBar + 8 + 1024;

__global__ void __launch_bounds__(kWg, 1)
    ssd_state_cb(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 float* __restrict__ cbf, __nv_bfloat16* __restrict__ states,
                 float* __restrict__ fin, Dims d) {
  extern __shared__ uint8_t smem_sc[];
  uint8_t* smem =
      smem_sc + ((1024 - (hopper::smem_u32(smem_sc) & 1023)) & 1023);
  float* dts = reinterpret_cast<float*>(smem + kScMain);
  float* cum = dts + 256;
  float* tot = cum + 256;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kScBar);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    hopper::prefetch_map(&tm_x);
    hopper::prefetch_map(&tm_b);
    hopper::prefetch_map(&tm_c);
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if ((int)blockIdx.x < d.n_cb) {
    // ---- CB = C_c B_c^T, one 64 x 64 tile at or below the diagonal ----
    int t = blockIdx.x;
    const int pairs = d.nit * (d.nit + 1) / 2;
    const int pr = t % pairs;
    t /= pairs;
    const int g = t % d.G;
    t /= d.G;
    const int c = t % d.nc, b = t / d.nc;
    int it = 0;
    while ((it + 1) * (it + 2) / 2 <= pr) ++it;
    const int jt = pr - it * (it + 1) / 2;
    const int nch = (d.N + kT - 1) / kT;
    uint8_t* ct = smem;
    uint8_t* bt = smem + 2 * kChunkB;
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(bar, 2 * nch * kChunkB);
      for (int ch = 0; ch < nch; ++ch) {
        hopper::tma_load_4d(ct + ch * kChunkB, &tm_c, bar, ch * kT, g,
                            c * d.Q + it * kT, b);
        hopper::tma_load_4d(bt + ch * kChunkB, &tm_b, bar, ch * kT, g,
                            c * d.Q + jt * kT, b);
      }
    }
    tiles_ready(bar, 0);
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    const uint32_t c_base = hopper::smem_u32(ct), b_base = hopper::smem_u32(bt);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    for (int ks = 0; ks < (d.N + 15) / 16; ++ks)
      hopper::wgmma_m64n64k16_ss(acc, desc_k(c_base, ks), desc_k(b_base, ks),
                                 ks > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    // in fragment order: ssd_out's thread `tid` reads its 32 values as 8
    // float4, each of them 512 contiguous bytes across a warp
    float4* dst = reinterpret_cast<float4*>(
        cbf + ((((size_t)b * d.nc + c) * d.G + g) * pairs + pr) * kFrag);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      dst[k * kWg + threadIdx.x] = make_float4(acc[4 * k], acc[4 * k + 1],
                                               acc[4 * k + 2], acc[4 * k + 3]);
    return;
  }

  // ---- chunk states and the inter-chunk recurrence, per (b, h, tiles) ----
  int t = blockIdx.x - d.n_cb;
  const int nt = t % d.nnt;
  t /= d.nnt;
  const int pt = t % d.npt;
  t /= d.npt;
  const int h = t % d.H, b = t / d.H;
  const int g = h / (d.H / d.G);
  const int p0 = pt * kT, n0 = nt * kT;
  const float a = A[h];
  const int R = (d.Q + kT - 1) / kT * kT;  // rows of the chunk's tiles
  uint8_t* xt = smem;                      // x_c [j][p0 .. p0+64), MN-major
  uint8_t* bt = smem + 256 * kRowB;        // B_c [j][n0 .. n0+64), MN-major
  const uint32_t x_base = hopper::smem_u32(xt);
  const uint32_t b_base = hopper::smem_u32(bt);

  float st[32];  // the state entering the chunk, rows p, columns n
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = 0.f;
  float2 dtv = chunk_dt(dt, (size_t)b * d.S * d.H + h, d.H, d.Q);

  for (int c = 0; c < d.nc; ++c) {
    const size_t s0 = (size_t)b * d.S + (size_t)c * d.Q;
    __syncthreads();  // every thread is done with the previous chunk's tiles
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(bar, 2 * R * kRowB);
      for (int r = 0; r < R; r += kT) {
        hopper::tma_load_4d(xt + r * kRowB, &tm_x, bar, p0, h, c * d.Q + r,
                            b);
        hopper::tma_load_4d(bt + r * kRowB, &tm_b, bar, n0, g, c * d.Q + r,
                            b);
      }
    }
    chunk_decay(dtv, a, dts, cum, tot);
    const float total = cum[d.Q - 1];
    // f_j = dt_j e^{total - cum_j}: the weight of step j in the chunk state
    for (int j = threadIdx.x; j < 256; j += kWg)
      dts[j] = j < d.Q ? dts[j] * expf(total - cum[j]) : 0.f;
    tiles_ready(bar, c & 1);
    if (c + 1 < d.nc)  // the next chunk's dt, read while this one computes
      dtv = chunk_dt(dt, (s0 + d.Q) * d.H + h, d.H, d.Q);

    // S_c = (x f)^T B: four k-steps of 16 steps j a batch of wgmma; the
    // next batch's A fragments are built while this one runs. A: rows
    // p = 16 warp + lane/4 (+8), columns j, from the x tile by a
    // transposing ldmatrix, scaled by f_j and split into bf16 hi + lo.
    auto fragments = [&](uint32_t (&ahi)[4][4], uint32_t (&alo)[4][4],
                         int k0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ks = k0 + kk;
        uint32_t raw[4];
        const int m = lane >> 3;
        const int j = 16 * ks + 8 * (m >> 1) + (lane & 7);
        hopper::ldmatrix_x4_trans(raw, x_base + sw_off(j, 2 * warp + (m & 1)));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw[u]));
          const int jj = 16 * ks + 8 * (u >> 1) + 2 * (lane & 3);
          hopper::split_bf16x2(xv.x * dts[jj], xv.y * dts[jj + 1],
                               ahi[kk][u], alo[kk][u]);
        }
      }
    };
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    uint32_t ahi[2][4][4], alo[2][4][4];
    fragments(ahi[0], alo[0], 0);
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) {  // R / 64 <= 4 batches
      if (grp < R / kT) {
        hopper::fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::fence_regs(ahi[grp & 1][kk]);
          hopper::fence_regs(alo[grp & 1][kk]);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ks = 4 * grp + kk;
          hopper::wgmma_rs_mn<64>(acc, ahi[grp & 1][kk],
                                  desc_mn(b_base, R, ks));
          hopper::wgmma_rs_mn<64>(acc, alo[grp & 1][kk],
                                  desc_mn(b_base, R, ks));
        }
        hopper::wgmma_commit();
        if (grp == 0 && c > 0) {
          // the state entering chunk c, as bf16 hi + lo (rows p, columns
          // n), stored while the products run
          __nv_bfloat16* hi =
              states + (((size_t)b * d.nc + c) * d.H + h) * 2 * d.P * d.N;
          __nv_bfloat16* lo = hi + (size_t)d.P * d.N;
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            const int p = p0 + acc_row(e), n = n0 + acc_col(e);
            if (p >= d.P || n >= d.N) continue;
            uint32_t sh, sl;
            hopper::split_bf16x2(st[e], st[e + 1], sh, sl);
            const size_t o = (size_t)p * d.N + n;
            if (n + 1 < d.N && d.N % 2 == 0) {
              *reinterpret_cast<uint32_t*>(hi + o) = sh;
              *reinterpret_cast<uint32_t*>(lo + o) = sl;
            } else {
              const __nv_bfloat162 h2 = *reinterpret_cast<__nv_bfloat162*>(&sh);
              const __nv_bfloat162 l2 = *reinterpret_cast<__nv_bfloat162*>(&sl);
              hi[o] = h2.x;
              lo[o] = l2.x;
              if (n + 1 < d.N) {
                hi[o + 1] = h2.y;
                lo[o + 1] = l2.y;
              }
            }
          }
        }
        if (grp + 1 < R / kT)
          fragments(ahi[(grp + 1) & 1], alo[(grp + 1) & 1], 4 * (grp + 1));
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::fence_regs(ahi[grp & 1][kk]);
          hopper::fence_regs(alo[grp & 1][kk]);
        }
      }
    }
    const float et = expf(total);
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = st[e] * et + acc[e];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int p = p0 + acc_row(e), n = n0 + acc_col(e);
    if (p < d.P && n < d.N)
      fin[(((size_t)b * d.H + h) * d.P + p) * d.N + n] = st[e];
  }
}

// shared memory of ssd_out: x rows [0, 256) of the P tile; the C tile and
// the state's hi and lo tiles (64 rows, N <= 128: two chunks each); dt,
// cum, the scan's totals, the decay factors f_j and the TMA barrier
constexpr int kOutX = 256 * kRowB;
constexpr int kOutC = kOutX;
constexpr int kOutHi = kOutC + 2 * kChunkB;
constexpr int kOutLo = kOutHi + 2 * kChunkB;
constexpr int kOutMain = kOutLo + 2 * kChunkB;
constexpr int kOutBar = kOutMain + (3 * 256 + 4) * 4;
constexpr int kOutSmem = kOutBar + 8 + 1024;

__global__ void __launch_bounds__(kWg)
    ssd_out(const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_c,
            const __grid_constant__ CUtensorMap tm_st,
            const float* __restrict__ dt, const float* __restrict__ A,
            const float* __restrict__ cbf, __nv_bfloat16* __restrict__ y,
            Dims d) {
  extern __shared__ uint8_t smem_out[];
  uint8_t* smem =
      smem_out + ((1024 - (hopper::smem_u32(smem_out) & 1023)) & 1023);
  float* dts = reinterpret_cast<float*>(smem + kOutMain);
  float* cum = dts + 256;
  float* tot = cum + 256;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kOutBar);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int it = blockIdx.x % d.nit, pt = blockIdx.x / d.nit;
  const int c = blockIdx.y % d.nc, h = blockIdx.y / d.nc;
  const int b = blockIdx.z;
  const int g = h / (d.H / d.G);
  const int i0 = it * kT, p0 = pt * kT;
  const int rows_x = i0 + kT;        // x rows [0, rows_x): j <= i
  const int nch = (d.N + kT - 1) / kT;
  const size_t s0 = (size_t)b * d.S + (size_t)c * d.Q;
  const size_t st_row = ((size_t)b * d.nc + c) * d.H + h;  // (b, c, h)

  // this thread's dt steps are read first, while thread 0 issues the tiles
  const float2 dtv = chunk_dt(dt, s0 * d.H + h, d.H, d.Q);
  if (threadIdx.x == 0) {
    hopper::prefetch_map(&tm_x);
    hopper::prefetch_map(&tm_c);
    hopper::prefetch_map(&tm_st);
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
    hopper::mbar_arrive_expect_tx(
        bar, (it + 1) * kChunkB + (c > 0 ? 3 * nch * kChunkB : 0));
    for (int r = 0; r <= it; ++r)
      hopper::tma_load_4d(smem + r * kChunkB, &tm_x, bar, p0, h,
                          c * d.Q + r * kT, b);
    if (c > 0)
      for (int ch = 0; ch < nch; ++ch) {
        hopper::tma_load_4d(smem + kOutC + ch * kChunkB, &tm_c, bar, ch * kT,
                            g, c * d.Q + i0, b);
        hopper::tma_load_4d(smem + kOutHi + ch * kChunkB, &tm_st, bar,
                            ch * kT, p0, 0, (int)st_row);
        hopper::tma_load_4d(smem + kOutLo + ch * kChunkB, &tm_st, bar,
                            ch * kT, p0, 1, (int)st_row);
      }
  }

  // C.B^T of tile (it, jt), a thread's 32 values in its fragment order,
  // read as 8 float4; the next tile's are read while the current tile's
  // products run
  const int pairs = d.nit * (d.nit + 1) / 2;
  const float4* cb_it = reinterpret_cast<const float4*>(
      cbf + ((((size_t)b * d.nc + c) * d.G + g) * pairs + it * (it + 1) / 2) *
                kFrag);
  auto load_cb = [&](float (&dst)[32], int jt) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 v = __ldg(cb_it + (size_t)jt * (kFrag / 4) + k * kWg +
                             threadIdx.x);
      dst[4 * k] = v.x;
      dst[4 * k + 1] = v.y;
      dst[4 * k + 2] = v.z;
      dst[4 * k + 3] = v.w;
    }
  };
  float acc[32], cur[32], nxt[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = nxt[e] = 0.f;
  load_cb(cur, 0);
  chunk_decay(dtv, A[h], dts, cum, tot);
  // Below the diagonal tile the decay factors through the j tile's last
  // cumsum c_ref: exp(cum_i - cum_j) = exp(cum_i - c_ref) exp(c_ref -
  // cum_j), both factors <= 1 (cum falls along the chunk), so neither
  // overflows; fj[j] = dt_j exp(c_ref - cum_j) holds the second factor.
  float* fj = tot + 4;  // [256]
  for (int j = threadIdx.x; j < 256; j += kWg) {
    const float cref = cum[min((j / kT + 1) * kT, d.Q) - 1];
    fj[j] = j < d.Q ? dts[j] * expf(cref - cum[j]) : 0.f;
  }
  tiles_ready(bar, 0);

  // y = W . x, W = CB o L o dt formed in registers a 64-column j tile (four
  // k-steps) at a time: rows i = i0 + 16 warp + lane/4 (+8), columns j
  const int ra = i0 + 16 * warp + (lane >> 2), rb = ra + 8;
  const float ca = cum[min(ra, 255)], cbv = cum[min(rb, 255)];
  const uint32_t x_base = hopper::smem_u32(smem);
  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) load_cb(nxt, jt + 1);
    uint32_t whi[4][4], wlo[4][4];
    if (jt < it) {  // below the diagonal: every i > j
      const float cref = cum[(jt + 1) * kT - 1];
      const float fa = ra < d.Q ? expf(ca - cref) : 0.f;
      const float fb = rb < d.Q ? expf(cbv - cref) : 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float fi = u & 1 ? fb : fa;
          const int j = jt * kT + 16 * kk + 8 * (u >> 1) + 2 * (lane & 3);
          hopper::split_bf16x2(cur[8 * kk + 2 * u] * fi * fj[j],
                               cur[8 * kk + 2 * u + 1] * fi * fj[j + 1],
                               whi[kk][u], wlo[kk][u]);
        }
    } else {  // the diagonal tile: the decay only where i >= j
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = u & 1 ? rb : ra;
          const float ci = u & 1 ? cbv : ca;
          const int j = jt * kT + 16 * kk + 8 * (u >> 1) + 2 * (lane & 3);
          float w[2];
#pragma unroll
          for (int v = 0; v < 2; ++v)
            w[v] = (i < d.Q && j + v <= i)
                       ? cur[8 * kk + 2 * u + v] * expf(ci - cum[j + v]) *
                             dts[j + v]
                       : 0.f;
          hopper::split_bf16x2(w[0], w[1], whi[kk][u], wlo[kk][u]);
        }
    }
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::fence_regs(whi[kk]);
      hopper::fence_regs(wlo[kk]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int ks = 4 * jt + kk;
      hopper::wgmma_rs_mn<64>(acc, whi[kk], desc_mn(x_base, rows_x, ks));
      hopper::wgmma_rs_mn<64>(acc, wlo[kk], desc_mn(x_base, rows_x, ks));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::fence_regs(whi[kk]);
      hopper::fence_regs(wlo[kk]);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) cur[e] = nxt[e];
  }

  if (c > 0) {
    // + e^{cum_i} C_i . state_in, the state as hi + lo
    float so[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) so[e] = 0.f;
    const uint32_t c_base = hopper::smem_u32(smem + kOutC);
    const uint32_t hi_base = hopper::smem_u32(smem + kOutHi);
    const uint32_t lo_base = hopper::smem_u32(smem + kOutLo);
    hopper::fence_regs(so);
    hopper::wgmma_fence();
    for (int ks = 0; ks < (d.N + 15) / 16; ++ks) {
      hopper::wgmma_m64n64k16_ss(so, desc_k(c_base, ks), desc_k(hi_base, ks),
                                 1);
      hopper::wgmma_m64n64k16_ss(so, desc_k(c_base, ks), desc_k(lo_base, ks),
                                 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(so);
    const float ea = expf(ca), eb = expf(cbv);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      acc[e] = fmaf((e >> 1) & 1 ? eb : ea, so[e], acc[e]);
  }

#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int i = i0 + acc_row(e), p = p0 + acc_col(e);
    if (i >= d.Q) continue;
    __nv_bfloat16* dst = y + ((s0 + i) * d.H + h) * d.P + p;
    if (p + 1 < d.P && d.P % 2 == 0) {
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[e], acc[e + 1]);
    } else {
      if (p < d.P) *dst = __float2bfloat16(acc[e]);
      if (p + 1 < d.P) dst[1] = __float2bfloat16(acc[e + 1]);
    }
  }
}

cudaError_t launch_f32(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, float* y, float* fin,
                       int Bsz, int S, int H, int P, int G, int N, int Q,
                       cudaStream_t stream) {
  static unsigned attr_set = 0;
  const size_t smem = smem_bytes(N);
  cudaError_t err = hopper::set_smem_once(ssd_fwd, (int)smem_bytes(kMaxN),
                                          attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kPT - 1) / kPT, H, Bsz);
  ssd_fwd<<<grid, kThreads, smem, stream>>>(x, dt, A, Bm, Cm, y, fin, S, H,
                                            P, G, N, Q);
  return cudaGetLastError();
}

// the two launches of the bf16 route; cbf (B x chunks x G x tile pairs x
// 128 x 32 f32: C.B^T in fragment order) and states (B x chunks x H x 2 x
// P x N bf16: hi, then lo) are the caller's scratch. P and N are multiples
// of 8 and x, B and C 16-byte aligned, as the tensor maps need.
cudaError_t launch_bf16(const __nv_bfloat16* x, const float* dt,
                        const float* A, const __nv_bfloat16* Bm,
                        const __nv_bfloat16* Cm, __nv_bfloat16* y, float* fin,
                        float* cbf, __nv_bfloat16* states, int Bsz, int S,
                        int H, int P, int G, int N, int Q,
                        cudaStream_t stream) {
  Dims d{Bsz, S, H, P, G, N, Q, S / Q, (Q + kT - 1) / kT, (P + kT - 1) / kT,
         (N + kT - 1) / kT, 0};
  d.n_cb = Bsz * d.nc * G * d.nit * (d.nit + 1) / 2;
  const long long n_state = (long long)Bsz * H * d.npt * d.nnt;
  if (d.n_cb + n_state > 0x7fffffffLL || (long long)d.nc * H > 65535 ||
      Bsz > 65535 || (long long)Bsz * d.nc * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // 64 x 64 boxes: x as (P, H, S, B), B and C as (N, G, S, B), the states
  // as (N, P, 2, B x chunks x H); a box past S, P or N is zero-filled
  CUtensorMap tm_x{}, tm_b{}, tm_c{}, tm_st{};
  const uint32_t box[4] = {kT, 1, kT, 1};
  const uint32_t box_st[4] = {kT, kT, 1, 1};
  const uint64_t dx[4] = {(uint64_t)P, (uint64_t)H, (uint64_t)S,
                          (uint64_t)Bsz};
  const uint64_t dbc[4] = {(uint64_t)N, (uint64_t)G, (uint64_t)S,
                           (uint64_t)Bsz};
  const uint64_t dst[4] = {(uint64_t)N, (uint64_t)P, 2,
                           (uint64_t)Bsz * d.nc * H};
  cudaError_t err = hopper::make_map_4d(&tm_x, x, dx, box, kRowB);
  if (err == cudaSuccess) err = hopper::make_map_4d(&tm_b, Bm, dbc, box, kRowB);
  if (err == cudaSuccess) err = hopper::make_map_4d(&tm_c, Cm, dbc, box, kRowB);
  if (err == cudaSuccess)
    err = hopper::make_map_4d(&tm_st, states, dst, box_st, kRowB);
  static unsigned attr_sc = 0, attr_out = 0;
  if (err == cudaSuccess)
    err = hopper::set_smem_once(ssd_state_cb, kScSmem, attr_sc);
  if (err == cudaSuccess)
    err = hopper::set_smem_once(ssd_out, kOutSmem, attr_out);
  if (err != cudaSuccess) return err;
  ssd_state_cb<<<(unsigned)(d.n_cb + n_state), kWg, kScSmem, stream>>>(
      tm_x, tm_b, tm_c, dt, A, cbf, states, fin, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_out<<<dim3(d.nit * d.npt, d.nc * H, Bsz), kWg, kOutSmem, stream>>>(
      tm_x, tm_c, tm_st, dt, A, cbf, y, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernels on `stream` (bf16: two launches, f32: one) and
// returns cudaGetLastError() after them (0 on success). All tensors are
// contiguous; `is_bf16` selects bf16 over f32 for x, B, C and y; dt, A and
// the final state are f32. For bf16, cb and states are scratch of
// B x (S/Q) x G x T(T+1)/2 x 4096 f32 (T = ceil(Q / 64)) and
// B x (S/Q) x H x 2 x P x N bf16; for f32 they are not read.
int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, void* y, void* fin,
                       void* cb, void* states, int Bsz, int S, int H, int P,
                       int G, int N, int Q, int is_bf16, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* finf = static_cast<float*>(fin);
  if (is_bf16)
    return (int)launch_bf16(
        static_cast<const __nv_bfloat16*>(x), dtf, Af,
        static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(Cm), static_cast<__nv_bfloat16*>(y),
        finf, static_cast<float*>(cb), static_cast<__nv_bfloat16*>(states),
        Bsz, S, H, P, G, N, Q, s);
  return (int)launch_f32(static_cast<const float*>(x), dtf, Af,
                         static_cast<const float*>(Bm),
                         static_cast<const float*>(Cm),
                         static_cast<float*>(y), finf, Bsz, S, H, P, G, N, Q,
                         s);
}

const char* repro_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
