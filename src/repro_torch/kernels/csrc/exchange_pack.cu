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
// zp = fill, codes 0, written in the same pass.  S = 256 slots of 13 f32
// are about 29 KB, so launch latency bounds it, not bytes.  Since the
// exchange's pack took the quantized payload in (below) it runs on no
// driver path.  Design: one warp per slot, as above.  The warp walks the
// groups in order; for each, the lanes stride its elements, reduce min
// and max with warp shuffles, and write the codes of the same elements
// (quantize_row).  The min is taken over order keys (a float's bits with
// the magnitude flipped below zero), so it is exact in any order and puts
// -0 below +0, as the reference's min does; the max is a float max (the
// sign of a zero max changes no output).  The arithmetic takes the forms
// the JAX reference takes under jit: the reciprocal of levels is rounded
// to f32 once (by the caller), the scale is a product (__fmul_rn), the
// codes an IEEE division (__fdiv_rn: this file must not be built with
// --use_fast_math or -prec-div=false) rounded half to even (rintf), so the
// kernel matches its plain PyTorch version bit for bit.
//
// pack_send_all_launch is the whole pack of a step's exchange in one
// launch, for every source worker and up to four payloads: the slot map
// that the port built per worker and payload in some 20 small launches
// (counts, a cumsum, a stable argsort, scatters), and the row pack above,
// replacing the same Pallas kernel (gather_rows_pallas) together with
// the slot-map code around it in src/repro/exchange/ragged.py:pack_send.
//     slot_to_row[i, d * budget + p] = the p-th row (in local order) of
//         source i assigned to destination d, for p < budget, else -1
//     out_q[i, s] = payload_q[i, slot_to_row[i, s]], or fill_q at -1
//     counts[i, d] = rows of source i assigned to d
//     overflow = sum over (i, d) of max(counts[i, d] - budget, 0)
// Rows past a destination's budget are left off the wire and counted in
// overflow.  On the training step (4 workers of 256 samples, ids 74
// int32, dense features 13 f32, labels 1 f32) it writes 90 KB, so launch
// latency bounds it, and the host's launches bounded what it replaces:
// 12 slot maps and 12 packs, some 360 launches a step.
// Design: a block per (source, tile of 32 send slots), 256 threads.  Each
// block rebuilds its source's slot map on its own, so nothing crosses
// blocks: over its rows, 256 a pass, a warp groups its lanes by
// destination (__match_any_sync), so a row's rank among its warp's rows of
// the same destination is a popcount; the per-warp counts are scanned in
// warp order per destination (a thread a destination), carried over the
// passes, and give each row its stable rank, as the stable argsort does.
// A row whose slot lies in the block's tile writes its index into the
// tile in shared memory.  Then the block writes the tile's slot_to_row
// and copies the tile for each payload, the (slot, word) pairs of the
// tile flattened so that neighbouring lanes write neighbouring 32-bit
// words, a PAD slot written as its payload's fill pattern in the same
// pass.  The first block also histograms every source's assignment in
// shared memory for counts and overflow, so the whole pack is one launch.
// Limits: at most 32 sources and 32 destinations (the scan's thread per
// destination, the (n_src, n_dst) histogram); m is taken in passes, up
// to 65,536 rows a source (each block reads its source's assignment
// whole, so the cost grows with m); an assignment outside [0, n_dst) is
// left off the wire and out of the counts.  The wrapper raises beyond
// these.
//
// pack_send_all_quant_launch is the same pack with payloads marked as
// quantized: the quantized wire's pack (B4) folded into the exchange's
// one launch, replacing gather_rows_quant_pallas with the slot-map code
// around it.  For a marked (n_src, m, F) f32 payload the blocks write,
// for each slot of their tile, what gather_rows_quant writes (codes
// (n_src, S, F) f32, scale and zp (n_src, S, G) f32), or for the fp16
// codec the row cast to halves (RNE, a PAD slot the fill) with scale 1
// and zp 0, from the same slot map in shared memory.  It replaced 4
// gather_rows_quant launches a step (one a source, after the pack) and
// their stack.  A row of at most kQuantHalfWarpMaxF = 16 floats (the
// training step's 13 dense features) is quantized by half a warp, 16
// slots to a pass of the block, its shuffles masked to the half and of
// width 16 (0.0112 ms at the training shape against a warp's 0.0127); a
// wider row by a warp (8 slots a pass), its groups in order.  fp16 has
// one group a slot (scale 1, zp 0); the launcher refuses another.  The
// exact payloads' copy and the slot map are the same code as
// pack_send_all_kernel's; the quantized payloads' side outputs and codec
// travel in a second parameter struct (Wire) that only this instance
// takes, so the exact launch's parameters stay as they were.
//
// The launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kPackThreads = 256;   // 8 warps = 8 slots per block
constexpr int kAllThreads = 256;    // pack_send_all: rows a pass
constexpr int kAllWarps = kAllThreads / 32;
constexpr int kAllTile = 32;        // send slots a block
constexpr int kAllMaxN = 32;        // sources, destinations
constexpr int kAllMaxPayloads = 4;
constexpr int kQuantHalfWarpMaxF = 16;  // rows this wide or less: half a warp

struct Payloads {
  const uint32_t* in[kAllMaxPayloads];    // (n_src, m, width) 32-bit words
  uint32_t* out[kAllMaxPayloads];         // (n_src, n_dst * budget, width)
  int width[kAllMaxPayloads];
  uint32_t fill[kAllMaxPayloads];
};
// the quantized payloads of pack_send_all_quant_launch and their codec
struct Wire {
  float* scale[kAllMaxPayloads];   // (n_src, S, groups); null: exact payload
  float* zp[kAllMaxPayloads];
  int group[kAllMaxPayloads];      // elements a scale group
  int groups[kAllMaxPayloads];
  float levels, inv_levels;
  int fp16;                        // codes as halves, scale 1, zp 0
};
struct NoWire {};                  // pack_send_all_launch: all exact
constexpr unsigned kFullMask = 0xffffffffu;

// a float's bits as an int that orders as the float does, -0 below +0;
// the map is its own inverse
__device__ __forceinline__ int order_key(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// One slot's row quantized by a team of L lanes (L = 16: half a warp,
// mask its lanes; L = 32: the warp), lane l of the team; src null is a
// PAD slot (codes 0, scale 1, zp fill).  Groups of B elements, G of them,
// in order: min (order keys) and max over the group's elements, reduced
// by shuffles within the team, then the codes.
template <int L>
__device__ __forceinline__ void quantize_row(
    const float* __restrict__ src, float* __restrict__ codes,
    float* __restrict__ sc_out, float* __restrict__ zp_out, int F, int B,
    int G, float levels, float inv_levels, float fill, int l,
    unsigned mask) {
  if (src == nullptr) {
    for (int e = l; e < F; e += L) codes[e] = 0.f;
    for (int g = l; g < G; g += L) {
      sc_out[g] = 1.f;
      zp_out[g] = fill;
    }
    return;
  }
  for (int g = 0; g < G; ++g) {
    const int e0 = g * B;
    const int e1 = min(e0 + B, F);
    int lo = INT_MAX;
    float hi = -INFINITY;
    for (int e = e0 + l; e < e1; e += L) {
      const float v = src[e];
      lo = min(lo, order_key(__float_as_int(v)));
      hi = fmaxf(hi, v);
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(mask, lo, off, L));
      hi = fmaxf(hi, __shfl_xor_sync(mask, hi, off, L));
    }
    const float zp = __int_as_float(order_key(lo));
    float sc = __fmul_rn(__fsub_rn(hi, zp), inv_levels);
    sc = sc > 0.f ? sc : 1.f;
    if (l == 0) {
      sc_out[g] = sc;
      zp_out[g] = zp;
    }
    for (int e = e0 + l; e < e1; e += L) {
      const float q = rintf(__fdiv_rn(__fsub_rn(src[e], zp), sc));
      codes[e] = fminf(fmaxf(q, 0.f), levels);
    }
  }
}

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
  quantize_row<32>(
      (r < 0 || m == 0) ? nullptr
                        : rows + static_cast<int64_t>(min(r, m - 1)) * F,
      codes + slot * F, scale + slot * G, zp + slot * G, F, B, G, levels,
      inv_levels, fill, lane, kFullMask);
}

// the quantized payload q of a pack_send_all tile: ns slots from slot0 on
// (global), their rows (local to source src, -1 = PAD) in tile
__device__ __forceinline__ void quantize_tile(const Payloads& p,
                                              const Wire& w, int q, int src,
                                              int m, int64_t slot0, int ns,
                                              const int* tile, int tid) {
  const int F = p.width[q];
  const int G = w.groups[q];
  const float* in = reinterpret_cast<const float*>(p.in[q]) +
                    static_cast<int64_t>(src) * m * F;
  const float fill = __uint_as_float(p.fill[q]);
  float* scale = w.scale[q] + slot0 * G;
  float* zp = w.zp[q] + slot0 * G;
  if (w.fp16) {
    __half* out = reinterpret_cast<__half*>(p.out[q]) + slot0 * F;
    for (int i = tid; i < ns * F; i += kAllThreads) {
      const int j = i / F;
      const int r = tile[j];
      out[i] = __float2half_rn(
          r >= 0 ? in[static_cast<int64_t>(r) * F + (i - j * F)] : fill);
    }
    for (int j = tid; j < ns; j += kAllThreads) {
      scale[j] = 1.f;
      zp[j] = 0.f;
    }
    return;
  }
  float* codes = reinterpret_cast<float*>(p.out[q]) + slot0 * F;
  const int B = w.group[q];
  if (F <= kQuantHalfWarpMaxF) {   // half a warp a slot, 16 slots a pass
    const int l = tid & 15;
    const unsigned mask = 0xffffu << (tid & 16);
    for (int j = tid >> 4; j < ns; j += kAllThreads / 16) {
      const int r = tile[j];
      quantize_row<16>(r >= 0 ? in + static_cast<int64_t>(r) * F : nullptr,
                       codes + static_cast<int64_t>(j) * F, scale + j * G,
                       zp + j * G, F, B, G, w.levels, w.inv_levels, fill, l,
                       mask);
    }
  } else {                         // a warp a slot, 8 slots a pass
    const int l = tid & 31;
    for (int j = tid >> 5; j < ns; j += kAllWarps) {
      const int r = tile[j];
      quantize_row<32>(r >= 0 ? in + static_cast<int64_t>(r) * F : nullptr,
                       codes + static_cast<int64_t>(j) * F, scale + j * G,
                       zp + j * G, F, B, G, w.levels, w.inv_levels, fill, l,
                       kFullMask);
    }
  }
}

template <class W>
__global__ void pack_send_all_kernel(const int* __restrict__ assign,
                                     Payloads p, W wire, int n_payloads,
                                     int* __restrict__ slot_to_row,
                                     int* __restrict__ counts,
                                     int* __restrict__ overflow, int n_src,
                                     int n_dst, int m, int budget) {
  constexpr bool kQuant = std::is_same<W, Wire>::value;
  __shared__ int s_run[kAllMaxN];               // rows so far, by destination
  __shared__ int s_warp[kAllWarps][kAllMaxN];   // a pass's counts, by warp
  __shared__ int s_tile[kAllTile];              // the tile's rows, -1 = PAD
  __shared__ int s_hist[kAllMaxN * kAllMaxN];   // first block: counts
  const int src = blockIdx.x;
  const int S = n_dst * budget;
  const int t0 = blockIdx.y * kAllTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool first = blockIdx.x == 0 && blockIdx.y == 0;
  for (int i = tid; i < kAllMaxN; i += blockDim.x) s_run[i] = 0;
  if (tid < kAllTile) s_tile[tid] = -1;
  if (first)
    for (int i = tid; i < n_src * n_dst; i += blockDim.x) s_hist[i] = 0;
  const int* a = assign + static_cast<int64_t>(src) * m;
  for (int r0 = 0; r0 < m; r0 += kAllThreads) {
    for (int i = tid; i < kAllWarps * kAllMaxN; i += blockDim.x)
      s_warp[i / kAllMaxN][i % kAllMaxN] = 0;
    __syncthreads();
    const int r = r0 + tid;
    const int d0 = r < m ? a[r] : -1;
    const int d = (d0 >= 0 && d0 < n_dst) ? d0 : -1;
    // the lanes of this warp with the same destination, and this row's
    // rank among them
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & below);
    if (d >= 0 && rank == 0) s_warp[warp][d] = __popc(peers);
    __syncthreads();
    if (tid < n_dst) {              // exclusive scan over the warps
      int run = s_run[tid];
      for (int w = 0; w < kAllWarps; ++w) {
        const int c = s_warp[w][tid];
        s_warp[w][tid] = run;
        run += c;
      }
      s_run[tid] = run;
    }
    __syncthreads();
    if (d >= 0) {
      const int pos = s_warp[warp][d] + rank;
      const int slot = d * budget + pos - t0;
      if (pos < budget && slot >= 0 && slot < kAllTile) s_tile[slot] = r;
    }
    __syncthreads();                // before the next pass clears s_warp
  }
  if (first) {                      // counts and overflow, all sources
    for (int i = tid; i < n_src * m; i += blockDim.x) {
      const int d = assign[i];
      if (d >= 0 && d < n_dst) atomicAdd(&s_hist[(i / m) * n_dst + d], 1);
    }
  }
  __syncthreads();
  if (first) {
    int over = 0;
    for (int i = tid; i < n_src * n_dst; i += blockDim.x) {
      counts[i] = s_hist[i];
      over += max(s_hist[i] - budget, 0);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      over += __shfl_xor_sync(kFullMask, over, off);
    if (lane == 0) s_warp[warp][0] = over;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int w = 0; w < kAllWarps; ++w) total += s_warp[w][0];
      *overflow = total;
    }
  }
  const int ns = min(kAllTile, S - t0);
  if (ns <= 0) return;
  const int64_t slot0 = static_cast<int64_t>(src) * S + t0;
  if (tid < ns) slot_to_row[slot0 + tid] = s_tile[tid];
  // unrolled, so that the payloads' fields are read at constant indices
  // from the parameter space, not copied to local memory
#pragma unroll
  for (int q = 0; q < kAllMaxPayloads; ++q) {
    if (q >= n_payloads) break;
    if constexpr (kQuant) {
      if (wire.scale[q] != nullptr) {
        quantize_tile(p, wire, q, src, m, slot0, ns, s_tile, tid);
        continue;
      }
    }
    const int F = p.width[q];
    const uint32_t* in = p.in[q] + static_cast<int64_t>(src) * m * F;
    uint32_t* out = p.out[q] + slot0 * F;
    const uint32_t fill = p.fill[q];
    for (int i = tid; i < ns * F; i += blockDim.x) {
      const int j = i / F;
      const int r = s_tile[j];
      out[i] = r >= 0 ? in[static_cast<int64_t>(r) * F + (i - j * F)] : fill;
    }
  }
}

template <class W>
int launch_pack(const void* assign, const void* const* ins,
                void* const* outs, const int* widths, const int* fills,
                int n_payloads, const W& wire, void* slot_to_row,
                void* counts, void* overflow, int n_src, int n_dst, int m,
                int budget, void* stream) {
  if (n_src < 1 || n_src > kAllMaxN || n_dst < 1 || n_dst > kAllMaxN ||
      m < 0 || budget < 0 || n_payloads < 0 ||
      n_payloads > kAllMaxPayloads)
    return static_cast<int>(cudaErrorInvalidValue);
  Payloads p{};
  for (int q = 0; q < n_payloads; ++q) {
    p.in[q] = static_cast<const uint32_t*>(ins[q]);
    p.out[q] = static_cast<uint32_t*>(outs[q]);
    p.width[q] = widths[q];
    p.fill[q] = static_cast<uint32_t>(fills[q]);
  }
  const int S = n_dst * budget;
  const dim3 grid(static_cast<unsigned>(n_src),
                  static_cast<unsigned>(S > 0 ? (S + kAllTile - 1) / kAllTile
                                              : 1));
  pack_send_all_kernel<W><<<grid, kAllThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(assign), p, wire, n_payloads,
      static_cast<int*>(slot_to_row), static_cast<int*>(counts),
      static_cast<int*>(overflow), n_src, n_dst, m, budget);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int pack_send_all_launch(const void* assign,
                                    const void* const* ins, void* const* outs,
                                    const int* widths, const int* fills,
                                    int n_payloads, void* slot_to_row,
                                    void* counts, void* overflow, int n_src,
                                    int n_dst, int m, int budget,
                                    void* stream) {
  return launch_pack(assign, ins, outs, widths, fills, n_payloads, NoWire{},
                     slot_to_row, counts, overflow, n_src, n_dst, m, budget,
                     stream);
}

extern "C" int pack_send_all_quant_launch(
    const void* assign, const void* const* ins, void* const* outs,
    const int* widths, const int* fills, int n_payloads,
    void* const* scales, void* const* zps, const int* groups,
    const int* n_groups, float levels, float inv_levels, int fp16,
    void* slot_to_row, void* counts, void* overflow, int n_src, int n_dst,
    int m, int budget, void* stream) {
  if (n_payloads < 0 || n_payloads > kAllMaxPayloads)
    return static_cast<int>(cudaErrorInvalidValue);
  Wire w{};
  for (int q = 0; q < n_payloads; ++q) {
    w.scale[q] = static_cast<float*>(scales[q]);
    w.zp[q] = static_cast<float*>(zps[q]);
    w.group[q] = groups[q];
    w.groups[q] = n_groups[q];
    if (w.scale[q] != nullptr && (w.zp[q] == nullptr || groups[q] < 1 ||
                                  n_groups[q] < 1 ||
                                  (fp16 && n_groups[q] != 1)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  w.levels = levels;
  w.inv_levels = inv_levels;
  w.fp16 = fp16;
  return launch_pack(assign, ins, outs, widths, fills, n_payloads, w,
                     slot_to_row, counts, overflow, n_src, n_dst, m, budget,
                     stream);
}
