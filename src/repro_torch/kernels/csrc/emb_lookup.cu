// Embedding-row kernels of the serving path, of the training step's Alg. 1
// and of the quantized table, for Hopper (sm_90a).
//
// pooled_lookup_launch replaces the Pallas TPU kernel
// src/repro/kernels/emb_lookup.py:pooled_lookup (_kernel, _kernel_blocked):
//     out[b] = sum_f w[b,f] * table[ids[b,f]]
// A PAD id (< 0) reads row 0 with weight 0 and null weights are all ones,
// as the plain version's wrapper sets them up, here inside the kernel, so
// a call is one launch.  On the training step it prices Alg. 1: a compact
// (U, n) per-id cost table, n = 4 columns wide, pooled over 256 bags of
// 74 ids.  Two flops per element read, so bytes bound it (the distinct
// rows read, the ids and weights, the (B, E) output: 0.075 us at the
// decide shape); at E = 4 latency bounds it.  The sum runs over f in order, multiply and add rounded
// apart (__fmul_rn, __fadd_rn: no FMA contraction), so the plain PyTorch
// version (out = out + table[ids[:, f]] * w[:, f]) is matched bit for
// bit; no lookup is skipped: a zero weight adds what the plain sum adds.
// Two layouts, by row width:
//   - E <= 32 (the decide stage's E = 4): one warp per bag, two bags to a
//     block, so 256 bags make 128 blocks over the 132 SMs.  The lanes load
//     the bag's ids and weights and then its rows in parallel, a lookup a
//     lane (a row of E = 4 is one 16-byte load), and stage the products
//     in shared memory, up to 1,024 of them a pass; then E lanes add them
//     in f order.  Each lookup's two dependent loads overlap the others',
//     where a thread per (bag, column) walked its F id -> row loads one
//     after another (24.9 us at the decide shape, with the PAD rule then
//     applied by the wrapper in separate launches).
//   - wider rows: one thread per (bag, column), 256 threads to a block
//     (half a bag at E = 512), each walking f = 0..F-1 in order with its
//     sum in an f32 register; neighbouring threads read neighbouring
//     columns of a row.
//
// staged_gather_launch replaces the Pallas TPU kernel
// src/repro/kernels/emb_lookup.py:staged_gather (_kernel_staged):
//     out[s] = table[src[s]] if src[s] >= 0 else plane[s]
// It moves bytes and does no arithmetic, so device-memory bandwidth bounds
// it: at least 2*C*E*4 bytes (one row read and one row written per slot).
// Design: one warp per slot, 8 slots per 256-thread block.  The warp reads
// ONLY the selected source row (the TPU kernel DMA'd both candidate rows
// and selected in registers) and copies it with 16-byte float4 loads and
// stores when E % 4 == 0 and every base is 16-byte aligned, else with
// scalar loads; neighbouring lanes touch neighbouring addresses.
//
// pooled_lookup_staged_launch replaces the Pallas TPU kernel
// src/repro/kernels/emb_lookup.py:pooled_lookup_staged
// (_kernel_pooled_staged):
//     out[b] = sum_f w[b,f] * (plane[slots[b,f]] if slots[b,f] >= 0
//                              else table[ids[b,f]])
// with PAD ids (< 0) contributing nothing.  Two flops per element read, so
// bytes bound it too: the rows of the valid lookups plus the (B, E) output.
// Design: one block per (bag, 512-column chunk).  The block first stages
// the bag's F row pointers and weights in shared memory (a PAD lookup gets
// a null pointer and is skipped, never reading row 0); then each of the
// 128 threads owns 4 columns and walks f = 0..F-1 in order, accumulating
// in f32 registers.  That loop takes the place of the TPU's sequential
// grid axis; there are no atomics, so the result is deterministic.  The
// multiply and the add are rounded separately (no FMA contraction), in the
// same order as the plain PyTorch version, which the kernel then matches
// bit for bit.
//
// pooled_lookup_quant_launch replaces the Pallas TPU kernel
// src/repro/kernels/emb_lookup.py:pooled_lookup_quant (_kernel_quant):
//     out[b] = sum_f w[b,f] * (codes[id,e] * scale[id,g] + zp[id,g])
// the pooled bag over a table quantized per group of Bg columns (g =
// e / Bg), the dequant fused into the accumulate so the f32 table never
// exists.  The wrapper has already clamped PAD ids to row 0 with weight 0.
// It reads the distinct rows' codes (E f32-valued integers) and their G
// scale/zero-point pairs, three flops per element read: bytes bound it.
// Design: B1's wide-row layout, one thread per (bag, column), 256 threads
// to a block, walking f = 0..F-1 in order.  The dequant is one fused
// multiply-add (__fmaf_rn), the form the JAX reference takes under jit;
// the weight multiply and the accumulate are rounded apart (__fmul_rn,
// __fadd_rn), as in B1, so the plain PyTorch version (the dequant in f64,
// rounded once; then out = out + row * w[:, f]) is matched bit for bit.
//
// All launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.
// Row indices past the table's end are clamped to its last row, as JAX's
// gathers clamp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;   // 8 warps = 8 slots per block
constexpr int kPoolThreads = 128;
constexpr int kPoolCols = 4;          // columns per thread
constexpr int kPoolChunk = kPoolThreads * kPoolCols;
constexpr int kLookupThreads = 256;   // (bag, column) pairs per block
constexpr int kNarrowE = 32;          // widest row of the warp-per-bag layout

// B1's PAD rule, as its plain version applies it: a PAD id (< 0) reads
// row 0 with weight 0, no weights are all ones
__device__ __forceinline__ float pad_weight(int id,
                                            const float* __restrict__ weights,
                                            int64_t at) {
  return id < 0 ? 0.f : (weights != nullptr ? weights[at] : 1.f);
}
constexpr int kNarrowWarps = 2;       // bags per block
constexpr int kNarrowBuf = 1024;      // products a warp stages a pass

template <bool kVec4>
__global__ void pooled_lookup_narrow_kernel(const float* __restrict__ table,
                                            const int* __restrict__ ids,
                                            const float* __restrict__ weights,
                                            float* __restrict__ out,
                                            int B, int F, int E, int V) {
  __shared__ __align__(16) float prod[kNarrowWarps][kNarrowBuf];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kNarrowWarps + warp;
  if (b >= B) return;                    // whole warps leave together
  const int* bag = ids + b * F;
  float* buf = prod[warp];
  const int chunk = kNarrowBuf / E;      // lookups a pass, >= 32
  float acc = 0.f;
  for (int f0 = 0; f0 < F; f0 += chunk) {
    const int nf = min(chunk, F - f0);
#pragma unroll 4
    for (int f = lane; f < nf; f += 32) {
      const int raw = bag[f0 + f];
      const float wf = pad_weight(raw, weights, b * F + f0 + f);
      const float* row =
          table + static_cast<int64_t>(min(max(raw, 0), V - 1)) * E;
      float* dst = buf + f * E;
      if (kVec4) {
        for (int e = 0; e < E; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + e);
          *reinterpret_cast<float4*>(dst + e) =
              make_float4(__fmul_rn(v.x, wf), __fmul_rn(v.y, wf),
                          __fmul_rn(v.z, wf), __fmul_rn(v.w, wf));
        }
      } else {
        for (int e = 0; e < E; ++e) dst[e] = __fmul_rn(row[e], wf);
      }
    }
    __syncwarp();
    if (lane < E) {
#pragma unroll 8
      for (int f = 0; f < nf; ++f) acc = __fadd_rn(acc, buf[f * E + lane]);
    }
    __syncwarp();
  }
  if (lane < E) out[b * E + lane] = acc;
}

__global__ void pooled_lookup_kernel(const float* __restrict__ table,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ weights,
                                     float* __restrict__ out,
                                     int B, int F, int E, int V) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(B) * E) return;
  const int64_t b = t / E;
  const int e = static_cast<int>(t - b * E);
  const int* bag = ids + b * F;
  float acc = 0.f;
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const int raw = bag[f];
    const int id = min(max(raw, 0), V - 1);
    acc = __fadd_rn(acc, __fmul_rn(table[static_cast<int64_t>(id) * E + e],
                                   pad_weight(raw, weights, b * F + f)));
  }
  out[t] = acc;
}

__global__ void staged_gather_kernel(const float* __restrict__ plane,
                                     const float* __restrict__ table,
                                     const int* __restrict__ src,
                                     float* __restrict__ out,
                                     int C, int E, int V, int vec4) {
  const int64_t slot =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (slot >= C) return;
  const int s = src[slot];
  const float* row = s >= 0
      ? table + static_cast<int64_t>(min(s, V - 1)) * E
      : plane + slot * E;
  float* dst = out + slot * E;
  if (vec4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int e = lane; e < (E >> 2); e += 32) d4[e] = r4[e];
  } else {
    for (int e = lane; e < E; e += 32) dst[e] = row[e];
  }
}

__global__ void pooled_lookup_staged_kernel(const float* __restrict__ plane,
                                            const float* __restrict__ table,
                                            const int* __restrict__ slots,
                                            const int* __restrict__ ids,
                                            const float* __restrict__ weights,
                                            float* __restrict__ out,
                                            int F, int E, int C, int V,
                                            int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float** s_row = reinterpret_cast<const float**>(smem);
  float* s_w = reinterpret_cast<float*>(s_row + F);

  const int64_t b = blockIdx.x;
  const int64_t base = b * F;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const int id = ids[base + f];
    const int sl = slots[base + f];
    const float* row = nullptr;
    if (id >= 0) {
      row = (sl >= 0 && C > 0)
          ? plane + static_cast<int64_t>(min(sl, C - 1)) * E
          : table + static_cast<int64_t>(min(id, V - 1)) * E;
    }
    s_row[f] = row;
    s_w[f] = weights != nullptr ? weights[base + f] : 1.0f;
  }
  __syncthreads();

  const int col0 = blockIdx.y * kPoolChunk;
  float acc[kPoolCols] = {0.f, 0.f, 0.f, 0.f};
  if (vec4) {
    const int e = col0 + threadIdx.x * kPoolCols;   // E % 4 == 0 here
    if (e >= E) return;
    for (int f = 0; f < F; ++f) {
      const float* row = s_row[f];
      if (row == nullptr) continue;
      const float w = s_w[f];
      const float4 r = *reinterpret_cast<const float4*>(row + e);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(r.x, w));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(r.y, w));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(r.z, w));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(r.w, w));
    }
    *reinterpret_cast<float4*>(out + b * E + e) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    for (int f = 0; f < F; ++f) {
      const float* row = s_row[f];
      if (row == nullptr) continue;
      const float w = s_w[f];
#pragma unroll
      for (int k = 0; k < kPoolCols; ++k) {
        const int e = col0 + k * kPoolThreads + threadIdx.x;
        if (e < E) acc[k] = __fadd_rn(acc[k], __fmul_rn(row[e], w));
      }
    }
#pragma unroll
    for (int k = 0; k < kPoolCols; ++k) {
      const int e = col0 + k * kPoolThreads + threadIdx.x;
      if (e < E) out[b * E + e] = acc[k];
    }
  }
}

__global__ void pooled_lookup_quant_kernel(const float* __restrict__ codes,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ zp,
                                           const int* __restrict__ ids,
                                           const float* __restrict__ weights,
                                           float* __restrict__ out, int B,
                                           int F, int E, int V, int Bg,
                                           int G) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(B) * E) return;
  const int64_t b = t / E;
  const int e = static_cast<int>(t - b * E);
  const int g = e / Bg;
  const int* bag = ids + b * F;
  const float* w = weights + b * F;
  float acc = 0.f;
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const int64_t id = min(max(bag[f], 0), V - 1);
    const float x = __fmaf_rn(codes[id * E + e], scale[id * G + g],
                              zp[id * G + g]);
    acc = __fadd_rn(acc, __fmul_rn(x, w[f]));
  }
  out[t] = acc;
}

}  // namespace

extern "C" int pooled_lookup_launch(const void* table, const void* ids,
                                    const void* weights, void* out, int B,
                                    int F, int E, int V, void* stream) {
  if (B == 0 || E == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(ids);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  if (E <= kNarrowE) {
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<int64_t>(B) + kNarrowWarps - 1) / kNarrowWarps);
    if (E % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0)
      pooled_lookup_narrow_kernel<true>
          <<<blocks, kNarrowWarps * 32, 0, st>>>(t, i, w, o, B, F, E, V);
    else
      pooled_lookup_narrow_kernel<false>
          <<<blocks, kNarrowWarps * 32, 0, st>>>(t, i, w, o, B, F, E, V);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t threads = static_cast<int64_t>(B) * E;
  const unsigned blocks =
      static_cast<unsigned>((threads + kLookupThreads - 1) / kLookupThreads);
  pooled_lookup_kernel<<<blocks, kLookupThreads, 0, st>>>(t, i, w, o, B, F,
                                                          E, V);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int staged_gather_launch(const void* plane, const void* table,
                                    const void* src, void* out, int C, int E,
                                    int V, int vec4, void* stream) {
  if (C == 0 || E == 0) return 0;
  const int64_t threads = static_cast<int64_t>(C) * 32;
  const unsigned blocks =
      static_cast<unsigned>((threads + kGatherThreads - 1) / kGatherThreads);
  staged_gather_kernel<<<blocks, kGatherThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane), static_cast<const float*>(table),
      static_cast<const int*>(src), static_cast<float*>(out), C, E, V, vec4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pooled_lookup_staged_launch(const void* plane,
                                           const void* table,
                                           const void* slots,
                                           const void* ids,
                                           const void* weights, void* out,
                                           int B, int F, int E, int C, int V,
                                           int vec4, void* stream) {
  if (B == 0 || E == 0) return 0;
  const dim3 grid(static_cast<unsigned>(B),
                  static_cast<unsigned>((E + kPoolChunk - 1) / kPoolChunk));
  const size_t smem = static_cast<size_t>(F) * (sizeof(float*) + sizeof(float));
  pooled_lookup_staged_kernel<<<grid, kPoolThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(plane), static_cast<const float*>(table),
      static_cast<const int*>(slots), static_cast<const int*>(ids),
      static_cast<const float*>(weights), static_cast<float*>(out), F, E, C,
      V, vec4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pooled_lookup_quant_launch(const void* codes,
                                          const void* scale, const void* zp,
                                          const void* ids,
                                          const void* weights, void* out,
                                          int B, int F, int E, int V, int Bg,
                                          int G, void* stream) {
  if (B == 0 || E == 0) return 0;
  const int64_t threads = static_cast<int64_t>(B) * E;
  const unsigned blocks =
      static_cast<unsigned>((threads + kLookupThreads - 1) / kLookupThreads);
  pooled_lookup_quant_kernel<<<blocks, kLookupThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(codes), static_cast<const float*>(scale),
      static_cast<const float*>(zp), static_cast<const int*>(ids),
      static_cast<const float*>(weights), static_cast<float*>(out), B, F, E,
      V, Bg, G);
  return static_cast<int>(cudaGetLastError());
}
