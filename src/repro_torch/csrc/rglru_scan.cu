// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t (prefill) for NVIDIA
// Hopper, written by hand.
//
// Replaces the TPU kernel `rglru_scan` -> `_kernel` of
// src/repro/kernels/rglru_scan.py and computes the function its oracle
// `rglru_ref` defines: a, b (B,S,W) f32 -> h (B,S,W) f32, h_{-1} = 0.
//
// What bounds it on the H100: two flops per element against 12 bytes moved
// (a and b read, h written, 4 bytes each): the function is bound by bytes,
// 3 x S x W x 4 of them (50 MB at S = 1024, W = 4096, 15 us at 3.35 TB/s).
//
// What its design does about it. The TPU kernel rewrites each chunk in
// log space, exp(cum) * (h0 + cumsum(b * exp(-cum))) with a clamped at
// 1e-20, to suit its vector unit, and carries h across the ordered chunk
// axis of its grid in VMEM. exp(-cum) can overflow inside a chunk, and a
// CUDA grid has no order. This kernel computes the recurrence directly and
// reads a and b from device memory once and writes h once:
//   * a block owns one strip of 32 columns of one batch row (one 128-byte
//     line per row and array) and walks the whole sequence alone, in steps
//     of `tile` rows, carrying the state from one step to the next in
//     registers: at B = 1, W = 4096 that is 128 blocks, one an SM;
//   * a step's a and b tiles come by one TMA box per array into shared
//     memory against an mbarrier, in a ring of `stages` steps, so the next
//     steps' loads are in flight while this one is scanned; rows or columns
//     past the edge arrive as zeros;
//   * each of 8 warps scans its tile / 8 rows from h = 0 (lane = column:
//     no bank conflicts), keeping the product of a and the end value; after
//     one block barrier each warp chains the carry through the warps before
//     its own into its entering state (at most 7 FMAs a column), and through
//     all 8 into the next step's carry;
//   * each warp rescans its rows from shared memory, not from L2, and
//     writes h in 128-byte rows.
// A block takes up to 256 rows a step (a TMA box's limit). The tile and the
// ring's depth come from the wrapper (`kernel_tiles` in
// kernels/rglru_scan.py). TMA needs every row of a and b on 16 bytes: W a
// multiple of 4 and 16-byte aligned data, which the wrapper checks.
#include <limits.h>

#include "hopper.cuh"

namespace {

constexpr int kCols = 32;  // columns a block, one per lane
constexpr int kWarps = 8;  // sequence segments a tile, one per warp
constexpr int kThreads = kCols * kWarps;
constexpr int kMaxTile = 256;    // TMA box rows
constexpr int kMaxStages = 4;    // steps in flight a block
constexpr int kAlign = 128;      // TMA writes shared memory at 128 bytes
constexpr int kMaxSmem = 220 * 1024;  // dynamic shared memory a block takes

// bytes of dynamic shared memory for a ring of `stages` tiles of `tile`
// rows: a and b of each stage, and the slack that aligns them
constexpr int smem_bytes(int tile, int stages) {
  return stages * 2 * tile * kCols * (int)sizeof(float) + kAlign;
}

// one TMA box per array into `stage` (a, then b): rows [row0, + tile) of
// the strip's 32 columns from column col0, counted on `bar`
__device__ __forceinline__ void load_step(float* stage,
                                          const CUtensorMap* tm_a,
                                          const CUtensorMap* tm_b,
                                          uint64_t* bar, int col0, int row0,
                                          int batch, int tile) {
  hopper::mbar_arrive_expect_tx(bar,
                                (uint32_t)(2 * tile * kCols * sizeof(float)));
  hopper::tma_load_3d(stage, tm_a, bar, col0, row0, batch);
  hopper::tma_load_3d(stage + tile * kCols, tm_b, bar, col0, row0, batch);
}

__global__ void __launch_bounds__(kThreads)
    rglru_strip(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b,
                float* __restrict__ h, int S, int W, int tile, int stages) {
  extern __shared__ uint8_t smem_raw[];
  // stage s: a (tile rows x 32 columns) then b, from a 128-byte boundary
  float* tiles = reinterpret_cast<float*>(
      smem_raw +
      ((kAlign - (hopper::smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1)));
  __shared__ float warp_prod[kWarps][kCols];
  __shared__ float warp_end[kWarps][kCols];
  __shared__ __align__(8) uint64_t bar[kMaxStages];

  const int lane = threadIdx.x % kCols, warp = threadIdx.x / kCols;
  const int strips = (W + kCols - 1) / kCols;
  const int batch = blockIdx.x / strips;
  const int col0 = (blockIdx.x % strips) * kCols;
  const int steps = (S + tile - 1) / tile;
  const int per_warp = tile / kWarps;
  const int i0 = warp * per_warp;
  const int stage_floats = 2 * tile * kCols;

  if (threadIdx.x == 0) {
    hopper::prefetch_map(&tm_a);
    hopper::prefetch_map(&tm_b);
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&bar[s], 1);
    hopper::mbar_fence_init();
    for (int t = 0; t < stages && t < steps; ++t)
      load_step(tiles + t * stage_floats, &tm_a, &tm_b, &bar[t], col0,
                t * tile, batch, tile);
  }
  __syncthreads();  // the mbarriers are initialised before anyone waits

  const int col = col0 + lane;
  const bool live = col < W;
  float carry = 0.f;  // the state entering this step
  for (int t = 0; t < steps; ++t) {
    const int stage = t % stages;
    const float* ta = tiles + stage * stage_floats;
    const float* tb = ta + tile * kCols;
    hopper::mbar_wait(&bar[stage], (t / stages) & 1);
    // the warp's segment from h = 0: its product of a and its end value
    float prod = 1.f, end = 0.f;
#pragma unroll 4
    for (int i = i0; i < i0 + per_warp; ++i) {
      const float at = ta[i * kCols + lane];
      end = fmaf(at, end, tb[i * kCols + lane]);
      prod *= at;
    }
    warp_prod[warp][lane] = prod;
    warp_end[warp][lane] = end;
    __syncthreads();
    // the carry through the warps before this one, and through all of them
    float state = carry, hin = carry;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      if (u == warp) hin = state;
      state = fmaf(warp_prod[u][lane], state, warp_end[u][lane]);
    }
    carry = state;
    // rescan from shared memory and write h, one 128-byte row a step
    const int row0 = t * tile;
    float* out = h + ((size_t)batch * S + row0) * W + col;
    const int rows = min(i0 + per_warp, S - row0);
    float hh = hin;
#pragma unroll 4
    for (int i = i0; i < i0 + per_warp; ++i) {
      hh = fmaf(ta[i * kCols + lane], hh, tb[i * kCols + lane]);
      if (live && i < rows) out[(size_t)i * W] = hh;
    }
    __syncthreads();  // every warp is done with the stage and warp_prod
    if (threadIdx.x == 0 && t + stages < steps)
      load_step(tiles + stage * stage_floats, &tm_a, &tm_b, &bar[stage],
                col0, (t + stages) * tile, batch, tile);
  }
}

unsigned g_attr_set = 0;  // the shared memory limit, one bit per device

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 on success). a, b and h are contiguous f32 (B,S,W), W a
// multiple of 4, a and b 16-byte aligned; tiles of `tile` rows (a multiple
// of 8, at most 256) in a ring of `stages` (1-4, within 220 KB of shared
// memory).
int repro_rglru_scan_fwd(const void* a, const void* b, void* h, int B, int S,
                         int W, int tile, int stages, void* stream) {
  const long long blocks = (long long)B * ((W + kCols - 1) / kCols);
  if (B <= 0 || S <= 0 || W <= 0 || W % 4 != 0 || tile < kWarps ||
      tile > kMaxTile || tile % kWarps != 0 || stages < 1 ||
      stages > kMaxStages || smem_bytes(tile, stages) > kMaxSmem ||
      blocks > INT_MAX || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_a{}, tm_b{};
  const uint64_t dims[3] = {(uint64_t)W, (uint64_t)S, (uint64_t)B};
  const uint32_t box[3] = {(uint32_t)kCols, (uint32_t)tile, 1};
  cudaError_t err = hopper::make_map_f32_3d(&tm_a, a, dims, box);
  if (err == cudaSuccess) err = hopper::make_map_f32_3d(&tm_b, b, dims, box);
  if (err == cudaSuccess)
    err = hopper::set_smem_once(rglru_strip, kMaxSmem, g_attr_set);
  if (err != cudaSuccess) return (int)err;
  rglru_strip<<<(unsigned)blocks, kThreads, smem_bytes(tile, stages),
                static_cast<cudaStream_t>(stream)>>>(
      tm_a, tm_b, static_cast<float*>(h), S, W, tile, stages);
  return (int)cudaGetLastError();
}

const char* repro_rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
