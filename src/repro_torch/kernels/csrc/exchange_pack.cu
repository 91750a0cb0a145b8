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
// gather_rows_quant_launch replaces the Pallas TPU kernel
// src/repro/kernels/exchange_pack.py:gather_rows_quant_pallas
// (_quant_kernel): the same gather fused with a per-group affine quantize,
//     zp = min(group), scale = (max - min) * (1 / levels), 1 if not > 0,
//     codes = clip(round((x - zp) / scale), 0, levels)
// over the slot's f32 row, in groups of B elements (the last group may be
// partial; G groups in all).  A PAD slot is a constant fill row: scale 1,
// zp = fill, codes 0, written in the same pass.  On the training step it
// packs the dense features: S = 256 slots of 13 f32, about 29 KB in all,
// so launch latency bounds it, not bytes.  Design: one warp per slot, as
// above.  The warp walks the groups in order; for each, the lanes stride
// its elements, reduce min and max with warp shuffles (exact in any
// order), and write the codes of the same elements.  The arithmetic takes
// the forms the JAX reference takes under jit: the reciprocal of levels is
// rounded to f32 once (by the caller), the scale is a product
// (__fmul_rn), the codes an IEEE division (__fdiv_rn: this file must not
// be built with --use_fast_math or -prec-div=false) rounded half to even
// (rintf), so the kernel matches its plain PyTorch version bit for bit.
//
// The launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 256;   // 8 warps = 8 slots per block
constexpr unsigned kFullMask = 0xffffffffu;

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

__global__ void gather_rows_quant_kernel(const float* __restrict__ rows,
                                         const int* __restrict__ slot_to_row,
                                         float* __restrict__ codes,
                                         float* __restrict__ scale,
                                         float* __restrict__ zp, int S,
                                         int F, int m, int B, int G,
                                         float levels, float inv_levels,
                                         float fill) {
  const int64_t slot =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (slot >= S) return;                 // whole warps leave together
  const int r = slot_to_row[slot];
  float* dst = codes + slot * F;
  float* sc_out = scale + slot * G;
  float* zp_out = zp + slot * G;
  if (r < 0 || m == 0) {
    for (int e = lane; e < F; e += 32) dst[e] = 0.f;
    for (int g = lane; g < G; g += 32) {
      sc_out[g] = 1.f;
      zp_out[g] = fill;
    }
    return;
  }
  const float* src = rows + static_cast<int64_t>(min(r, m - 1)) * F;
  for (int g = 0; g < G; ++g) {
    const int e0 = g * B;
    const int e1 = min(e0 + B, F);
    float lo = INFINITY, hi = -INFINITY;
    for (int e = e0 + lane; e < e1; e += 32) {
      const float v = src[e];
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(kFullMask, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(kFullMask, hi, off));
    }
    float sc = __fmul_rn(__fsub_rn(hi, lo), inv_levels);
    sc = sc > 0.f ? sc : 1.f;
    if (lane == 0) {
      sc_out[g] = sc;
      zp_out[g] = lo;
    }
    for (int e = e0 + lane; e < e1; e += 32) {
      const float q = rintf(__fdiv_rn(__fsub_rn(src[e], lo), sc));
      dst[e] = fminf(fmaxf(q, 0.f), levels);
    }
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

extern "C" int gather_rows_quant_launch(const void* rows,
                                        const void* slot_to_row, void* codes,
                                        void* scale, void* zp, int S, int F,
                                        int m, int B, int G, float levels,
                                        float inv_levels, float fill,
                                        void* stream) {
  if (S == 0 || F == 0) return 0;
  const int64_t threads = static_cast<int64_t>(S) * 32;
  const unsigned blocks =
      static_cast<unsigned>((threads + kPackThreads - 1) / kPackThreads);
  gather_rows_quant_kernel<<<blocks, kPackThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(slot_to_row),
      static_cast<float*>(codes), static_cast<float*>(scale),
      static_cast<float*>(zp), S, F, m, B, G, levels, inv_levels, fill);
  return static_cast<int>(cudaGetLastError());
}
