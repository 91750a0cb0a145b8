// The auction's bid phase, for Hopper (sm_90a).
//
// auction_bids_launch replaces the Pallas TPU kernel
// src/repro/kernels/auction.py:auction_bids (_bid_kernel).  For every
// bidder row i of a (k, n) cost matrix, against the (n,) row of each
// worker's cheapest slot price:
//     value[i, j] = -cost[i, j] - min_price[j]
//     best_j[i]   = argmax_j value[i, j]     (the first of equal values)
//     w1          = value[i, best_j],  w2 = max(NEG, max_{j != best_j} value)
//     bid[i]      = (min_price[best_j] + (w1 - w2)) + eps,  NEG if assigned
// with w2 = w1 when n == 1 (bid = min_price[0] + eps).  It is one round's
// row-parallel half of the eps-scaled auction that stands for the paper's
// CUDA-parallel Hungarian; the slot matching that follows is PyTorch.
//
// What bounds it: at the paper's shapes (k = 256 .. 8,192 rows, n = 8 or
// 16 workers) the kernel moves k * n * 4 bytes of cost plus 9 bytes a row,
// at most 0.36 MB, a bound near 0.1 us at 3.35 TB/s, so launch latency
// bounds it, not bytes or arithmetic.  Design: one warp per bidder row,
// 8 rows to a 256-thread block; the block stages the price row in shared
// memory once; the lanes stride over the n columns, so a row of 8 f32 is
// one 32-byte read by 8 lanes.  The TPU kernel padded n to 128 lanes with
// cost and price 1e30; here nothing is padded: lanes past n take no
// column.
//
// Equality with the plain PyTorch version, bit for bit: every value is one
// IEEE subtraction (__fsub_rn), max and argmax are exact in any order (the
// shuffle reduction keeps the larger value and, on equal values, the
// smaller column, as argmax does), and the bid is two additions rounded
// apart (__fadd_rn) in the order written above; there is no multiply, so
// nothing can contract into an FMA.  NaN costs are not supported.
//
// eps is read from device memory, so that a CUDA graph of a round (the
// solver captures one per solve) serves every phase of the eps scaling.
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps = 8 bidder rows per block
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNeg = -1e30f;

__global__ void auction_bids_kernel(const float* __restrict__ cost,
                                    const float* __restrict__ min_price,
                                    const uint8_t* __restrict__ unassigned,
                                    const float* __restrict__ eps,
                                    int* __restrict__ best_j,
                                    float* __restrict__ bid, int k, int n) {
  extern __shared__ float price[];
  for (int j = threadIdx.x; j < n; j += blockDim.x) price[j] = min_price[j];
  __syncthreads();
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= k) return;                  // whole warps leave together
  const float* c = cost + row * n;

  // best value and its first column: each lane over its columns in order
  float v1 = -INFINITY;
  int j1 = INT_MAX;
  for (int j = lane; j < n; j += 32) {
    const float v = __fsub_rn(-c[j], price[j]);
    if (j1 == INT_MAX || v > v1) {
      v1 = v;
      j1 = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v1, off);
    const int oj = __shfl_xor_sync(kFullMask, j1, off);
    if (oj != INT_MAX && (j1 == INT_MAX || ov > v1 || (ov == v1 && oj < j1))) {
      v1 = ov;
      j1 = oj;
    }
  }

  // second best: the row's max with column j1 replaced by NEG
  float v2 = kNeg;
  for (int j = lane; j < n; j += 32) {
    if (j == j1) continue;
    const float v = __fsub_rn(-c[j], price[j]);
    if (v > v2) v2 = v;
  }
  for (int off = 16; off > 0; off >>= 1)
    v2 = fmaxf(v2, __shfl_xor_sync(kFullMask, v2, off));
  if (n == 1) v2 = v1;

  if (lane == 0) {
    best_j[row] = j1;
    bid[row] = unassigned[row]
                   ? __fadd_rn(__fadd_rn(price[j1], __fsub_rn(v1, v2)), *eps)
                   : kNeg;
  }
}

}  // namespace

extern "C" int auction_bids_launch(const float* cost, const float* min_price,
                                   const uint8_t* unassigned,
                                   const float* eps, int* best_j, float* bid,
                                   int k, int n,
                                   cudaStream_t stream) {
  const int rows_per_block = kThreads / 32;
  const int blocks = (k + rows_per_block - 1) / rows_per_block;
  auction_bids_kernel<<<blocks, kThreads, n * sizeof(float), stream>>>(
      cost, min_price, unassigned, eps, best_j, bid, k, n);
  return static_cast<int>(cudaGetLastError());
}
