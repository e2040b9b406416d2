// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t (prefill) for NVIDIA
// Hopper, written by hand.
//
// Replaces the TPU kernel `rglru_scan` -> `_kernel` of
// src/repro/kernels/rglru_scan.py and computes the function its oracle
// `rglru_ref` defines: a, b (B,S,W) f32 -> h (B,S,W) f32, h_{-1} = 0.
//
// What bounds it on the H100: two flops per element against 12 bytes moved
// (a and b read, h written, 4 bytes each): the function is bound by bytes,
// 3 x S x W x 4 of them (50 MB at S = 1024, W = 4096).
//
// What its design does about it. The TPU kernel rewrites each chunk in
// log space, exp(cum) * (h0 + cumsum(b * exp(-cum))) with a clamped at
// 1e-20, to suit its vector unit, and carries h across the ordered chunk
// axis of its grid in VMEM. exp(-cum) can overflow inside a chunk, and a
// CUDA grid has no order. This kernel computes the recurrence directly, in
// three phases inside one block, so nothing carries between blocks:
//   1. each warp takes one of 8 segments of the sequence and, per column,
//      scans it from h = 0, keeping the segment's product of a and its end
//      value;
//   2. one warp chains the 8 segments per column: the state entering
//      segment k is prod_a[k-1] * (state entering k-1) + end[k-1];
//   3. each warp scans its segment again from its entering state and writes
//      h.
// A block owns 32 neighbouring columns of one batch row, so every load and
// store of a warp is one 128-byte line; at B = 1, W = 4096 the grid has 128
// blocks of 8 warps. Phase 3 reads a and b a second time, mostly from L2
// (the block's 32 columns of a and b are 256 KB at S = 1024).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // columns per block, one per lane
constexpr int kSegs = 8;   // sequence segments per block, one per warp

__global__ void __launch_bounds__(kCols * kSegs)
    rglru_fwd(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ h, int S, int W) {
  __shared__ float seg_prod[kSegs][kCols];
  __shared__ float seg_end[kSegs][kCols];
  __shared__ float seg_in[kSegs][kCols];
  const int lane = threadIdx.x, seg = threadIdx.y;
  const int w = blockIdx.x * kCols + lane;
  const size_t row = (size_t)blockIdx.y * S;
  const int len = (S + kSegs - 1) / kSegs;
  const int t0 = min(seg * len, S), t1 = min(t0 + len, S);
  const bool live = w < W;

  float prod = 1.f, hh = 0.f;
  if (live) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const size_t off = (row + t) * W + w;
      const float at = a[off];
      hh = fmaf(at, hh, b[off]);
      prod *= at;
    }
  }
  seg_prod[seg][lane] = prod;
  seg_end[seg][lane] = hh;
  __syncthreads();
  if (seg == 0) {
    float carry = 0.f;
    for (int k = 0; k < kSegs; ++k) {
      seg_in[k][lane] = carry;
      carry = fmaf(seg_prod[k][lane], carry, seg_end[k][lane]);
    }
  }
  __syncthreads();
  if (live) {
    hh = seg_in[seg][lane];
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const size_t off = (row + t) * W + w;
      hh = fmaf(a[off], hh, b[off]);
      h[off] = hh;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 on success). a, b and h are contiguous f32 (B,S,W).
int repro_rglru_scan_fwd(const void* a, const void* b, void* h, int B, int S,
                         int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kCols - 1) / kCols, B);
  const dim3 block(kCols, kSegs);
  rglru_fwd<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return (int)cudaGetLastError();
}

const char* repro_rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
