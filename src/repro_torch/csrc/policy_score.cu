// FDN admission decision kernels for NVIDIA Hopper, written by hand: the
// SLO-composite filter cascade and argmin over F functions x P platforms.
//
// K1 `repro_fused_composite_decide` replaces the TPU kernel
// `fused_composite_decide_pallas` -> `_fused_composite_kernel` of
// src/repro/kernels/policy_score.py. From the raw estimator state it
// computes, per cell,
//   exec   = ewma_n >= 3 ? ewma_v : analytic
//   p90    = resp_n >= 10 ? resp_h2 : exec * 1.5
//   energy = (exec * nodes) * loaded_w
//   cost   = (exec + data) + w * energy
// then, per row, the utilization mask (alive & unloaded, degraded to alive
// when the row has none), the SLO mask (that & p90 <= slo, degraded to the
// utilization mask when the row has none), and the masked argmin.
// K2 `repro_composite_decide` replaces `composite_decide_pallas` ->
// `_composite_kernel`: the same cascade and argmin over prebuilt exec,
// data and p90 columns and wenergy = w * energy (multiplied by the
// wrapper), cost = (exec + data) + wenergy.
// Both return choice int32 (F,) and ok bool (F,).
//
// The contract is the one of `_masked_argmin` (policy_score.py of both
// packages) and of the NumPy path: a masked cost that is NaN or +-inf
// counts as +inf, choice is the LOWEST column index attaining the row's
// minimum, ok says whether the minimum is finite, and a row with no finite
// candidate returns choice 0. (The Pallas kernels differ from it on
// non-finite costs; see ROADMAP.md.)
//
// Arithmetic: every multiply and add is written with __fmul_rn/__fadd_rn
// in the reference's association, so nvcc cannot contract w * energy +
// (exec + data) into an FMA, which would round differently from the plain
// PyTorch version. The card check requires bit-equal choice and ok.
//
// What bounds it on the H100. On the FDN's own path the grid is tiny (F <=
// 10 functions x P = 5 platforms a decision): a launch costs a few
// microseconds, so launch latency and the way the inputs reach the card
// bound it, not the card. The admission path stages K1's eleven inputs and
// two outputs in one pinned host block mapped into the card's address
// space (`repro_host_block_alloc`): the kernel reads its inputs over PCIe
// and writes choice and ok back into the block, with no copy and no device
// allocation, and the host syncs once.
// At a registry-scale shape (F = 4096, P = 1024) it is bound by bytes: K1
// reads 25 bytes a cell (six 4-byte columns and the alive byte), 105 MB,
// about 31 us at 3.35 TB/s; it does 6 flops a cell.
//
// What the design does about it. The TPU kernel pads the grid to (8, 128)
// tiles (padding cells alive = 0, slo = -inf) and holds it all in VMEM,
// computing the masks as whole-array passes. Here one warp owns one
// function row; its lanes stride across the P columns (neighbouring lanes
// on neighbouring addresses, every load coalesced, ragged ends masked by
// the loop bound instead of padding) and every input is read once, in a
// single pass: the final mask is one of four candidates (alive, alive &
// unloaded, and each of them & meets-SLO), so each lane keeps a running
// (minimum, lowest column) for all four and the three row-wide "any" tests
// are taken with __any_sync after the pass. The chosen candidate's minimum
// is then reduced across the warp with __shfl_xor_sync, and the lowest
// column index that attains it with a second min-reduction over the lanes
// that hold it. Eight rows a block; at F = 4096 that is 512 blocks and
// every row's warp is resident at once (132 SMs x 64 warps).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // one warp per function row
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoColumn = 0x7fffffff;

struct Cell {
  bool alive;
  bool unloaded;
  bool meets_slo;
  float cost;
};

// K1's cell: estimator gates and prediction columns from the raw state.
struct FusedCells {
  const float* ewma_v;
  const int32_t* ewma_n;
  const float* analytic;
  const float* resp_h2;
  const int32_t* resp_n;
  const float* data;
  const float* nodes;
  const float* loaded_w;
  const uint8_t* alive;
  const uint8_t* unloaded;
  const float* slo;
  float w;

  __device__ __forceinline__ Cell operator()(int f, int j, size_t off) const {
    // every column is loaded before the gates select from them, so no
    // load waits on a count's load
    const float ev = ewma_v[off], an = analytic[off], rh = resp_h2[off];
    const int32_t en = ewma_n[off], rn = resp_n[off];
    const float exec = en >= 3 ? ev : an;
    const float p90 = rn >= 10 ? rh : __fmul_rn(exec, 1.5f);
    const float energy = __fmul_rn(__fmul_rn(exec, nodes[j]), loaded_w[j]);
    Cell c;
    c.alive = alive[off] != 0;
    c.unloaded = unloaded[j] != 0;
    c.meets_slo = p90 <= slo[f];
    c.cost = __fadd_rn(__fadd_rn(exec, data[off]), __fmul_rn(w, energy));
    return c;
  }
};

// K2's cell: prebuilt columns.
struct PrebuiltCells {
  const float* exec;
  const float* data;
  const float* p90;
  const float* wenergy;
  const uint8_t* alive;
  const uint8_t* unloaded;
  const float* slo;

  __device__ __forceinline__ Cell operator()(int f, int j, size_t off) const {
    Cell c;
    c.alive = alive[off] != 0;
    c.unloaded = unloaded[j] != 0;
    c.meets_slo = p90[off] <= slo[f];
    c.cost = __fadd_rn(__fadd_rn(exec[off], data[off]), wenergy[off]);
    return c;
  }
};

// A lane's running minimum of one candidate mask and the lowest of its
// columns that attains it. The lane visits its columns in increasing
// order, so a strict < keeps the lowest one; the first column always
// enters (v == inf == best.v, j < kNoColumn), so a lane whose candidates
// are all infinite still holds its lowest column.
struct Best {
  float v;
  int j;
};

__device__ __forceinline__ void offer(Best& b, bool in_mask, float cost,
                                      int j) {
  const float v = (in_mask && isfinite(cost)) ? cost : INFINITY;
  if (v < b.v || (v == b.v && j < b.j)) {
    b.v = v;
    b.j = j;
  }
}

template <class Cells>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
    composite_decide(Cells cells, int F, int P, int32_t* __restrict__ choice,
                     uint8_t* __restrict__ ok) {
  const int lane = threadIdx.x % kWarp;
  const int f = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (f >= F) return;  // the whole warp leaves together
  Best all{INFINITY, kNoColumn}, util = all, slo_all = all, slo_util = all;
  bool any_util = false, any_slo_all = false, any_slo_util = false;
#pragma unroll 4
  for (int j = lane; j < P; j += kWarp) {
    const Cell c = cells(f, j, (size_t)f * P + j);
    const bool u = c.alive && c.unloaded;
    const bool sa = c.alive && c.meets_slo;
    const bool su = u && c.meets_slo;
    any_util |= u;
    any_slo_all |= sa;
    any_slo_util |= su;
    offer(all, c.alive, c.cost, j);
    offer(util, u, c.cost, j);
    offer(slo_all, sa, c.cost, j);
    offer(slo_util, su, c.cost, j);
  }
  // the cascade's row-wide tests pick one of the four candidate masks
  any_util = __any_sync(kFull, any_util);
  any_slo_all = __any_sync(kFull, any_slo_all);
  any_slo_util = __any_sync(kFull, any_slo_util);
  const Best pick = any_util ? (any_slo_util ? slo_util : util)
                             : (any_slo_all ? slo_all : all);
  // masked row minimum
  float row_min = pick.v;
  for (int s = kWarp / 2; s > 0; s /= 2)
    row_min = fminf(row_min, __shfl_xor_sync(kFull, row_min, s));
  // the lowest column index that attains it
  int first = pick.v == row_min ? pick.j : kNoColumn;
  for (int s = kWarp / 2; s > 0; s /= 2)
    first = min(first, __shfl_xor_sync(kFull, first, s));
  if (lane == 0) {
    choice[f] = first;
    ok[f] = isfinite(row_min) ? 1 : 0;
  }
}

template <class Cells>
int launch(const Cells& cells, int F, int P, void* choice, void* ok,
           void* stream) {
  if (F <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (F + kRowsPerBlock - 1) / kRowsPerBlock;
  composite_decide<Cells><<<blocks, kRowsPerBlock * kWarp, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      cells, F, P, static_cast<int32_t*>(choice), static_cast<uint8_t*>(ok));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1. (F,P) f32 ewma_v, analytic, resp_h2, data; (F,P) int32 ewma_n,
// resp_n; (F,P) bool alive; (P,) f32 nodes, loaded_w; (P,) bool unloaded;
// (F,) f32 slo; all contiguous. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
int repro_fused_composite_decide(const void* ewma_v, const void* ewma_n,
                                 const void* analytic, const void* resp_h2,
                                 const void* resp_n, const void* data,
                                 const void* nodes, const void* loaded_w,
                                 const void* alive, const void* unloaded,
                                 const void* slo, float energy_weight, int F,
                                 int P, void* choice, void* ok, void* stream) {
  FusedCells cells{static_cast<const float*>(ewma_v),
                   static_cast<const int32_t*>(ewma_n),
                   static_cast<const float*>(analytic),
                   static_cast<const float*>(resp_h2),
                   static_cast<const int32_t*>(resp_n),
                   static_cast<const float*>(data),
                   static_cast<const float*>(nodes),
                   static_cast<const float*>(loaded_w),
                   static_cast<const uint8_t*>(alive),
                   static_cast<const uint8_t*>(unloaded),
                   static_cast<const float*>(slo),
                   energy_weight};
  return launch(cells, F, P, choice, ok, stream);
}

// K2. (F,P) f32 exec, data, p90, wenergy; (F,P) bool alive; (P,) bool
// unloaded; (F,) f32 slo; all contiguous.
int repro_composite_decide(const void* exec, const void* data,
                           const void* p90, const void* wenergy,
                           const void* alive, const void* unloaded,
                           const void* slo, int F, int P, void* choice,
                           void* ok, void* stream) {
  PrebuiltCells cells{static_cast<const float*>(exec),
                      static_cast<const float*>(data),
                      static_cast<const float*>(p90),
                      static_cast<const float*>(wenergy),
                      static_cast<const uint8_t*>(alive),
                      static_cast<const uint8_t*>(unloaded),
                      static_cast<const float*>(slo)};
  return launch(cells, F, P, choice, ok, stream);
}

// K1's staging block: `bytes` of pinned host memory, mapped into the
// address space of every device; *host is its host address and *dev the
// address a kernel on the current device reads it by. Returns a CUDA error
// (0 on success), with both addresses null on failure.
int repro_host_block_alloc(size_t bytes, void** host, void** dev) {
  *host = nullptr;
  *dev = nullptr;
  cudaError_t err =
      cudaHostAlloc(host, bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) {
    *host = nullptr;
    return (int)err;
  }
  err = cudaHostGetDevicePointer(dev, *host, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(*host);
    *host = nullptr;
    *dev = nullptr;
  }
  return (int)err;
}

int repro_host_block_free(void* host) { return (int)cudaFreeHost(host); }

const char* repro_policy_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
