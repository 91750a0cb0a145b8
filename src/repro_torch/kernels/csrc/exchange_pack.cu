// Row pack of the ragged exchange, for Hopper (sm_90a).
//
// gather_rows_launch replaces the Pallas TPU kernel
// src/repro/kernels/exchange_pack.py:gather_rows_pallas (_kernel):
//     out[s] = rows[slot_to_row[s]]  where slot_to_row[s] >= 0, else fill
// It builds a worker's (n * budget, F) send buffer from its (m, F) local
// rows: the sample ids (int32), the dense features and the labels (f32).
// It moves bytes and does no arithmetic, so device-memory bandwidth bounds
// it: at least S * F * 4 bytes written plus the rows read.  On the
// training step the rows are 296, 52 and 4 bytes wide, so one warp per
// slot is enough: 8 slots to a 256-thread block, neighbouring lanes on
// neighbouring 32-bit words.  Both dtypes copy as 32-bit words; the fill
// arrives as the 32-bit pattern of -1 in the row's own dtype (0xFFFFFFFF
// for int32, 0xBF800000 = -1.0f for f32), so PAD slots are written in the
// same pass with no separate memset.  An index past the rows clamps to the
// last row, as JAX's gathers clamp; no index is read out of range.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 256;   // 8 warps = 8 slots per block

__global__ void gather_rows_kernel(const uint32_t* __restrict__ rows,
                                   const int* __restrict__ slot_to_row,
                                   uint32_t* __restrict__ out, int S, int F,
                                   int m, uint32_t fill) {
  const int64_t slot =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (slot >= S) return;
  const int r = slot_to_row[slot];
  uint32_t* dst = out + slot * F;
  if (r < 0 || m == 0) {
    for (int e = lane; e < F; e += 32) dst[e] = fill;
  } else {
    const uint32_t* src = rows + static_cast<int64_t>(min(r, m - 1)) * F;
    for (int e = lane; e < F; e += 32) dst[e] = src[e];
  }
}

}  // namespace

extern "C" int gather_rows_launch(const void* rows, const void* slot_to_row,
                                  void* out, int S, int F, int m, int fill,
                                  void* stream) {
  if (S == 0 || F == 0) return 0;
  const int64_t threads = static_cast<int64_t>(S) * 32;
  const unsigned blocks =
      static_cast<unsigned>((threads + kPackThreads - 1) / kPackThreads);
  gather_rows_kernel<<<blocks, kPackThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows),
      static_cast<const int*>(slot_to_row), static_cast<uint32_t*>(out), S,
      F, m, static_cast<uint32_t>(fill));
  return static_cast<int>(cudaGetLastError());
}
