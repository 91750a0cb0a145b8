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
// decide shape); at E = 4 latency bounds it.  The sum runs over f in
// order, multiply and add rounded apart (__fmul_rn, __fadd_rn: no FMA
// contraction), so the plain PyTorch
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
// with PAD ids (< 0) contributing nothing.  Two flops per element read.
// Its two shapes are bound by different things.  At the serving
// micro-batch (B = 16 bags of F = 48 history slots, about 12 of them
// valid, E = 512) the bytes take 0.07 us, and the time is latency: a
// thread that walks its bag loading one row and adding it before it asks
// for the next pays one memory round trip a lookup, about 12 in a row,
// and 16 blocks leave most of the 132 SMs idle.  At B = 4,096 the bytes
// bound it: 0.0094 ms of device-memory bytes (the distinct rows, the ids
// and the output), but the rows of repeated hot ids come again from L2,
// about 100 MB of L2 reads in all.
// Design: one warp per (bag, 128-column chunk), so B = 16 is 64 warps on
// 64 SMs; a block holds one warp while the grid is smaller than the card,
// four otherwise.
//   1. Compaction: the lanes read 64 of the bag's ids and slots at once
//      (two per lane), pick each valid lookup's row (the plane's where the
//      slot is live, clamped to C-1, else the table's, clamped to V-1; a
//      PAD is never read) and compact the row pointers and weights into
//      the warp's shared-memory list in f order (a ballot and a prefix
//      popcount), so no lane walks the PADs.
//   2. Loads in flight: the lanes take the list 8 lookups at a time and
//      issue all 8 loads (a float4 a lane when E % 4 == 0 and every base
//      is 16-byte aligned, else four strided scalars) before the first
//      add, so a bag of 12 lookups costs two round trips, not 12.  A
//      register batch was chosen over Hopper's bulk copies
//      (cp.async.bulk into a shared ring on an mbarrier): a lookup's
//      column chunk is 512 bytes, each lane consumes only its own 16, and
//      the batch needs no shared staging, no barrier and no second pass
//      through shared memory.  Eight, not 16: at 64 registers a thread
//      the SM holds 32 warps, where 16 loads took 96 registers and held
//      20, and B = 4,096 ran slower with them; B = 16 ran the same
//      (scripts/ab_staged.py --set kBagBatch=16 times the two).
//   3. The adds, per column, over the list in f order: multiply and add
//      rounded apart (__fmul_rn, __fadd_rn), as the plain PyTorch version
//      does them; it adds +-0 for a PAD, which changes no sum (an f32 sum
//      that starts at +0 is never -0), so the kernel matches it bit for
//      bit.  No atomics: the result is deterministic.
// The list holds 128 entries a warp; a bag with more valid lookups than
// fit is summed in several passes, in order.
//
// pooled_lookup_quant_launch replaces the Pallas TPU kernel
// src/repro/kernels/emb_lookup.py:pooled_lookup_quant (_kernel_quant):
//     out[b] = sum_f w[b,f] * (codes[id] * scale[id, g] + zp[id, g])
// B1 over a quantized table, the dequant fused into the accumulate (g the
// column's scale group of B_g columns; the last group may be partial, G
// in all); the codes are f32-valued, as the reference stores them.  The
// PAD rule is B1's (pad_weight), applied here, so a call is one launch.
// It is no kernel of its own: B1's narrow kernel and B6's bag kernel are
// written over a row policy (where a lookup's row lies, and what an
// element of it is worth), and B5 instantiates both with QuantRows.
// Each element read is a multiply-add, a multiply and an add; bytes bound
// it (the distinct code rows with their scale and zp, the ids, weights
// and output: 0.0038 ms at B = 256, F = 74, E = 512 on the wdl-s1 table),
// and at E = 4 latency does.  Each dequantized value is one rounding
// (__fmaf_rn: the plain version forms it in f64 and rounds once), its
// product with w another, the sum over f in order (__fadd_rn), so the
// plain version is matched bit for bit.  A thread per (bag, column) that
// walked its F lookups one dependent load chain after another took 34 us
// at E = 4 and 32 us at E = 512 (and the PAD rule took launches of its
// own); now B1's and B6's layouts:
//   - E <= 32: B1's warp per bag.  The lanes take a lookup each, load
//     its id, weight, its groups' scale and zp once each and its codes
//     (float4 where E and the group are multiples of 4 and the codes
//     16-byte aligned), and stage the weighted dequantized values in
//     shared memory; E lanes then add them in f order.
//   - E > 32: B6's warp per (bag, 128 columns): the bag's valid lookups
//     (ids clamped to V-1) compacted into the warp's list, 8 lookups'
//     codes in flight a lane.  Where a lane's columns lie in one group
//     (one group a row, or float4 columns and a group a multiple of 4)
//     its scale and zp are loaded once a lookup with the codes, else per
//     column.  A PAD lookup is skipped: it adds +-0, which changes no sum
//     that starts at +0.
//
// empty_launch launches a kernel that does nothing: the launch floor that
// the others' times are read against.
//
// All launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.
// Row indices past the table's end are clamped to its last row, as JAX's
// gathers clamp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;   // 8 warps = 8 slots per block
constexpr int kBagCols = 128;         // columns a warp: 4 a lane
constexpr int kBagList = 128;         // compacted lookups a warp holds
constexpr int kBagBatch = 8;          // row loads a lane has in flight
constexpr int kBagWarps = 4;          // warps a block on a large grid
constexpr int kSMs = 132;
constexpr int kLookupThreads = 256;   // (bag, column) pairs per block
constexpr int kNarrowE = 32;          // widest row of the warp-per-bag layout
constexpr int kNarrowWarps = 2;       // bags per block
constexpr int kNarrowBuf = 1024;      // products a warp stages a pass

// B1's PAD rule, as its plain version applies it: a PAD id (< 0) reads
// row 0 with weight 0, no weights are all ones
__device__ __forceinline__ float pad_weight(int id,
                                            const float* __restrict__ weights,
                                            int64_t at) {
  return id < 0 ? 0.f : (weights != nullptr ? weights[at] : 1.f);
}

// Row policies of the bag kernels.  Entry is what a warp's list holds of
// a valid lookup; pick forms it from the id (>= 0) and the lookup's aux
// word, loaded beside the id (B6's plane slot); row is its row; value is
// an element of the row as the sum takes it, given the affine of its
// scale group (group() elements a group, groups() of them).
struct Affine {
  float s, z;
};

// an f32 table (B1)
struct TableRows {
  using Entry = int;                    // the id, clamped to V-1
  const float* table;
  int E, V;
  __host__ __device__ int group() const { return E; }
  __device__ int groups() const { return 1; }
  __device__ int aux(int64_t) const { return -1; }
  __device__ Entry pick(int id, int) const { return min(id, V - 1); }
  __device__ const float* row(Entry id) const {
    return table + static_cast<int64_t>(id) * E;
  }
  __device__ Affine affine(Entry, int) const { return {0.f, 0.f}; }
  __device__ float value(float v, Affine) const { return v; }
};

// B6's rows: the staged plane's where the lookup's slot is live (clamped
// to C-1), else the table's (clamped to V-1)
struct StagedRows {
  using Entry = const float*;           // the row
  const float* plane;
  const float* table;
  const int* slots;
  int E, C, V;
  __host__ __device__ int group() const { return E; }
  __device__ int groups() const { return 1; }
  __device__ int aux(int64_t at) const { return slots[at]; }
  __device__ Entry pick(int id, int slot) const {
    return (slot >= 0 && C > 0)
        ? plane + static_cast<int64_t>(min(slot, C - 1)) * E
        : table + static_cast<int64_t>(min(id, V - 1)) * E;
  }
  __device__ const float* row(Entry r) const { return r; }
  __device__ Affine affine(Entry, int) const { return {0.f, 0.f}; }
  __device__ float value(float v, Affine) const { return v; }
};

// a quantized table (B5): f32-valued codes, a scale and zp a group of Bg
// columns, the value one rounding of codes * scale + zp
struct QuantRows {
  using Entry = int;                    // the id, clamped to V-1
  const float* codes;
  const float* scale;
  const float* zp;
  int E, V, Bg, G;
  __host__ __device__ int group() const { return Bg; }
  __device__ int groups() const { return G; }
  __device__ int aux(int64_t) const { return -1; }
  __device__ Entry pick(int id, int) const { return min(id, V - 1); }
  __device__ const float* row(Entry id) const {
    return codes + static_cast<int64_t>(id) * E;
  }
  __device__ Affine affine(Entry id, int g) const {
    const int64_t at = static_cast<int64_t>(id) * G + g;
    return {__ldg(scale + at), __ldg(zp + at)};
  }
  __device__ float value(float v, Affine a) const {
    return __fmaf_rn(v, a.s, a.z);
  }
};

// B1 and B5 at E <= 32: a warp per bag; kVec4: E and the group are
// multiples of 4 and the rows 16-byte aligned
template <class Rows, bool kVec4>
__global__ void pooled_lookup_narrow_kernel(Rows rows,
                                            const int* __restrict__ ids,
                                            const float* __restrict__ weights,
                                            float* __restrict__ out, int B,
                                            int F) {
  __shared__ __align__(16) float prod[kNarrowWarps][kNarrowBuf];
  const int E = rows.E;
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
      const typename Rows::Entry id = rows.pick(max(raw, 0), -1);
      const float* row = rows.row(id);
      float* dst = buf + f * E;
      for (int g = 0; g < rows.groups(); ++g) {
        const Affine a = rows.affine(id, g);
        const int e1 = min((g + 1) * rows.group(), E);
        if (kVec4) {
          for (int e = g * rows.group(); e < e1; e += 4) {
            const float4 v = *reinterpret_cast<const float4*>(row + e);
            *reinterpret_cast<float4*>(dst + e) = make_float4(
                __fmul_rn(rows.value(v.x, a), wf),
                __fmul_rn(rows.value(v.y, a), wf),
                __fmul_rn(rows.value(v.z, a), wf),
                __fmul_rn(rows.value(v.w, a), wf));
          }
        } else {
          for (int e = g * rows.group(); e < e1; ++e)
            dst[e] = __fmul_rn(rows.value(row[e], a), wf);
        }
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

// the valid lookups list[0, n) added into acc in order, 8 row loads in
// flight a lane; the scalar layout reads columns e, e+32, e+64, e+96.
// kOneGroup: the lane's columns lie in group g, whose affine loads with
// the row; else each column's loads before its add
template <class Rows, bool kVec4, bool kOneGroup>
__device__ __forceinline__ void add_rows(const Rows& rows,
                                         const typename Rows::Entry* list,
                                         const float* list_w, int n, int e,
                                         int g, float (&acc)[4]) {
  const int E = rows.E;
  for (int j0 = 0; j0 < n; j0 += kBagBatch) {
    const int nk = min(kBagBatch, n - j0);
    float4 r[kBagBatch];
    Affine a[kBagBatch];
#pragma unroll
    for (int k = 0; k < kBagBatch; ++k) {
      if (k < nk) {
        const float* row = rows.row(list[j0 + k]);
        if (kVec4) {
          r[k] = e < E ? __ldg(reinterpret_cast<const float4*>(row + e))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          r[k].x = e < E ? __ldg(row + e) : 0.f;
          r[k].y = e + 32 < E ? __ldg(row + e + 32) : 0.f;
          r[k].z = e + 64 < E ? __ldg(row + e + 64) : 0.f;
          r[k].w = e + 96 < E ? __ldg(row + e + 96) : 0.f;
        }
        if (kOneGroup)
          a[k] = e < E ? rows.affine(list[j0 + k], g) : Affine{0.f, 0.f};
      }
    }
#pragma unroll
    for (int k = 0; k < kBagBatch; ++k) {
      if (k < nk) {
        const float w = list_w[j0 + k];
        const float v[4] = {r[k].x, r[k].y, r[k].z, r[k].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Affine ac{0.f, 0.f};
          if (kOneGroup) {
            ac = a[k];
          } else {
            const int col = kVec4 ? e + c : e + 32 * c;
            if (col < E) ac = rows.affine(list[j0 + k], col / rows.group());
          }
          acc[c] = __fadd_rn(acc[c], __fmul_rn(rows.value(v[c], ac), w));
        }
      }
    }
  }
}

// B6 and B5 at E > 32: a warp per (bag, 128 columns)
template <class Rows, bool kVec4, bool kOneGroup>
__global__ void pooled_lookup_bag_kernel(Rows rows,
                                         const int* __restrict__ ids,
                                         const float* __restrict__ weights,
                                         float* __restrict__ out, int B,
                                         int F, int chunks) {
  __shared__ typename Rows::Entry s_list[kBagWarps][kBagList];
  __shared__ float s_w[kBagWarps][kBagList];
  const int E = rows.E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5)
                       + warp;
  if (unit >= static_cast<int64_t>(B) * chunks) return;   // whole warps
  const int64_t b = unit / chunks;
  const int col0 = static_cast<int>(unit - b * chunks) * kBagCols;
  // the lane's columns: 4 neighbours (float4), or 4 a warp-width apart
  const int e = col0 + (kVec4 ? lane * 4 : lane);
  const int g = kOneGroup && e < E ? e / rows.group() : 0;
  typename Rows::Entry* list = s_list[warp];
  float* list_w = s_w[warp];
  const int64_t base = b * F;
  const unsigned below = (1u << lane) - 1u;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int n = 0;
  for (int f0 = 0; f0 < F; f0 += 64) {
    // 64 lookups' ids, aux words and weights in flight, two a lane
    int id[2], ax[2];
    float w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + h * 32 + lane;
      id[h] = f < F ? ids[base + f] : -1;
      ax[h] = f < F ? rows.aux(base + f) : -1;
      w[h] = (f < F && weights != nullptr) ? weights[base + f] : 1.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = id[h] >= 0;
      const unsigned mask = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        const int at = n + __popc(mask & below);
        list[at] = rows.pick(id[h], ax[h]);
        list_w[at] = w[h];
      }
      n += __popc(mask);
    }
    __syncwarp();
    if (n > kBagList - 64 || f0 + 64 >= F) {     // the list is full or done
      add_rows<Rows, kVec4, kOneGroup>(rows, list, list_w, n, e, g, acc);
      n = 0;
      __syncwarp();
    }
  }
  float* o = out + b * E;
  if (kVec4) {
    if (e < E)
      *reinterpret_cast<float4*>(o + e) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e + 32 * k < E) o[e + 32 * k] = acc[k];
  }
}

__global__ void empty_kernel() {}

template <class Rows>
int launch_narrow(const Rows& rows, bool vec4, const int* ids,
                  const float* weights, float* out, int B, int F,
                  cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<int64_t>(B) + kNarrowWarps - 1) / kNarrowWarps);
  if (vec4)
    pooled_lookup_narrow_kernel<Rows, true>
        <<<blocks, kNarrowWarps * 32, 0, st>>>(rows, ids, weights, out, B, F);
  else
    pooled_lookup_narrow_kernel<Rows, false>
        <<<blocks, kNarrowWarps * 32, 0, st>>>(rows, ids, weights, out, B, F);
  return static_cast<int>(cudaGetLastError());
}

template <class Rows, bool kVec4, bool kOneGroup>
int launch_bags(const Rows& rows, const int* ids, const float* weights,
                float* out, int B, int F, cudaStream_t st) {
  const int chunks = (rows.E + kBagCols - 1) / kBagCols;
  const int64_t units = static_cast<int64_t>(B) * chunks;
  // a warp a block until the grid fills the card, then four
  const int warps = units < static_cast<int64_t>(kBagWarps) * kSMs
                        ? 1 : kBagWarps;
  const unsigned blocks = static_cast<unsigned>((units + warps - 1) / warps);
  pooled_lookup_bag_kernel<Rows, kVec4, kOneGroup>
      <<<blocks, warps * 32, 0, st>>>(rows, ids, weights, out, B, F, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pooled_lookup_launch(const void* table, const void* ids,
                                    const void* weights, void* out, int B,
                                    int F, int E, int V, void* stream) {
  if (B == 0 || E == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(ids);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  if (E <= kNarrowE)
    return launch_narrow(
        TableRows{t, E, V},
        E % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0, i, w, o, B,
        F, st);
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
  const StagedRows rows{static_cast<const float*>(plane),
                        static_cast<const float*>(table),
                        static_cast<const int*>(slots), E, C, V};
  const int* id = static_cast<const int*>(ids);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec4 ? launch_bags<StagedRows, true, true>(rows, id, w, o, B, F, st)
              : launch_bags<StagedRows, false, true>(rows, id, w, o, B, F,
                                                     st);
}

extern "C" int pooled_lookup_quant_launch(const void* codes,
                                          const void* scale, const void* zp,
                                          const void* ids,
                                          const void* weights, void* out,
                                          int B, int F, int E, int V, int Bg,
                                          int G, int vec4, void* stream) {
  if (B == 0 || E == 0) return 0;
  if (V < 1 || Bg < 1 || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const QuantRows rows{static_cast<const float*>(codes),
                       static_cast<const float*>(scale),
                       static_cast<const float*>(zp), E, V, Bg, G};
  const int* i = static_cast<const int*>(ids);
  const float* w = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4_groups = vec4 && Bg % 4 == 0;
  if (E <= kNarrowE)
    return launch_narrow(rows, vec4_groups, i, w, o, B, F, st);
  if (vec4) {
    return G == 1 || vec4_groups
        ? launch_bags<QuantRows, true, true>(rows, i, w, o, B, F, st)
        : launch_bags<QuantRows, true, false>(rows, i, w, o, B, F, st);
  }
  return G == 1
      ? launch_bags<QuantRows, false, true>(rows, i, w, o, B, F, st)
      : launch_bags<QuantRows, false, false>(rows, i, w, o, B, F, st);
}
