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
// scalar loads; neighbouring lanes touch neighbouring addresses.  It is
// the TPU function's own counterpart and stays out of place; no main path
// runs it since the in-place pulls below took over.
//
// staged_pull_launch and plane_refresh_launch replace the same Pallas TPU
// kernel (staged_gather) on the port's two paths, in place.  A TPU kernel
// writes a new array, so the TPU function copies all C rows of the plane
// to change a few: at the serving plane (C = 23,564, E = 512) 96.5 MB to
// refresh at most 64 rows.  Neither of these reads or writes a row it
// does not pull.
//   - staged_pull: rows[slot[r]] = table[src[r]] for r < n, src null
//     meaning src[r] = r.  A slot outside [0, C) (C marks none) is
//     skipped; an index outside the table clamps into it.  Slots are
//     distinct, so no two warps write one row and nothing is atomic.
//     Bytes bound it, n*E*4*2 + n*8; at the training prefetch shape (64
//     rows of 512) that is 0.26 MB, under the launch floor.  A warp per
//     two entries, both rows' loads (up to 512 columns each, float4 where
//     E % 4 == 0 and every base is 16-byte aligned) in flight before the
//     stores; a few warps a block, so a short list spreads over SMs.
//   - plane_refresh: the serving plane's TTL refresh, which the TPU
//     function leaves to XLA around B3 (src/repro/serve/plane.py:82
//     refresh_plane: compares, a stable argsort of every slot's key, a
//     rank scatter, B3, a sum).  due = ids >= 0 && expiry <= step; with a
//     budget K < C the due slots whose (key, slot) rank below K are kept,
//     key = due ? expiry : INT32_MAX, exactly the ranks of the stable
//     argsort.  The kept rows are pulled (ids clamped into the table),
//     their expiry set to step + ttl, and their count written to a 0-dim
//     int32 on the device.  With pull = 0 it writes the kept (slot, id)
//     list in slot order instead, padded to cap with (C, -1), and pulls
//     nothing: the codec path quantizes those rows and staged_pull writes
//     them.  Bytes bound it, C*8 (ids and expiry) + n*E*8 + n*4: 0.45 MB
//     at the serving plane, 0.00013 ms, so the launch floor (0.005 ms)
//     sets its floor.  Its cost is latency: one block does it all, so
//     nothing spins on another block.  The keys, as unsigned (key ^
//     2^31 keeps the order), are read with 16-byte loads and go into
//     shared memory when C*4 fits (kKeysSmem), else every later pass
//     reads them again from L2; the same pass counts the keys below
//     INT32_MAX and takes their min and max.  A radix select finds the
//     K-th smallest key T by 8-bit digits (a 256-bin histogram a pass; a
//     warp whose lanes share a digit adds once), starting at the first
//     byte in which that min and max differ: a cold plane's ties (one
//     expiry) need no pass, expiries within 256 steps one.  need = K -
//     #(key < T) slots whose key equals T are kept, in slot order.  Then
//     each thread walks its own run of consecutive slots (an odd length,
//     so a warp's reads of shared memory meet no bank twice): one block
//     scan gives each key-T slot its rank, a second the kept slots'
//     places in the list, so the list is in slot order and the tie-break
//     is the stable sort's.  When the budget holds every key below
//     INT32_MAX the select is skipped.  With a list of at most kBlockPull
//     rows the block's 32 warps pull it, two rows in flight a warp: one
//     launch a refresh.  A larger list (no budget: the seed) is written
//     out and staged_pull pulls it over the grid: two launches.  The
//     first design (four digit passes always, each warp's equal digits
//     found by __match_any_sync) took 0.043 ms at the serving shape on
//     an H100 (700 W), this one 0.017.
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
// alg1_cost_launch replaces no TPU kernel: it fuses the per-id pricing of
// src/repro/kernels/ops.py:44 (cost_matrix_pallas_sparse, the XLA around
// its pooled_lookup) into B1's pooling, for all n workers in one launch.
//     out[i, s, e] = sum over the kept slots f of bag (i, s), in f
//                    order, of (1 - lat[e,id]) T_e
//                              + (sum_j d[j,id] T_j - d[e,id] T_e)
// A slot is kept when its id is not PAD (-1) and no earlier slot of the
// bag holds it: the first occurrence the stable sort of dedup_mask keeps.
// An id outside [0, V) that is not PAD is priced as one no worker holds,
// as the compact route prices it.  The route it replaces built, per
// worker, the batch's sorted unique ids, a compact (U, n) table of
// per-id costs and the ids remapped into it, then pooled it on B1: about
// 80 small PyTorch ops a worker, 650 host calls a step at n = 8, at
// 25-40 us each on the card's host.  The work is small: at the training
// benchmark's decide shape (n 8, m 128, F 26) 26,624 slots, each reading
// 2n state bytes, plus the ids and the (n, m, n) output, 0.57 MB, 0.17 us
// of device-memory bytes; so the launch floor and latency bound it.
// Design: a warp a bag, 8 bags a block (1,024 bags, 128 blocks).  The
// lanes take the bag 32 slots at a time: each loads its id, finds by
// __match_any_sync whether an earlier lane holds it and by a broadcast
// walk whether an earlier chunk does, and for a kept slot loads its 2n
// state bytes (all in flight at once) into two bit masks and folds
// sum_j d[j,id] T_j over j in order.  Then
// the warp walks the kept slots in f order; each slot's masks and fold
// are broadcast and lane e < n adds its column's cost.  Every operation
// is the route's own, rounded apart (__fmul_rn, __fadd_rn, __fsub_rn: no
// FMA contraction), and a PAD or repeated slot, which the route adds as
// +0, is skipped, so the result is the route's bit for bit: tied auction
// costs break on the last bit.  n <= 32: a lane a column.  chip_smoke.py
// phase 3 times it beside the route at that shape and at 4 x 256 x 74.
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

#include <algorithm>

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
constexpr int kPullWarps = 4;         // staged_pull: warps a block
constexpr int kPullChunk = 4;         // float4s (or floats) a lane loads
                                      // of a row before its stores
constexpr int kRefreshThreads = 1024; // plane_refresh: its one block
constexpr int kBlockPull = 256;       // the longest list the block pulls
constexpr int kKeysSmem = 48 * 1024;  // keys kept in shared memory (192 KB)
constexpr int kRadixBins = 256;
constexpr int kAlg1Warps = 8;         // alg1_cost: bags a block
constexpr int kAlg1MaxN = 32;         // alg1_cost: workers, a lane each

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

// one warp copies the rows s0 -> d0 and s1 -> d1 (a null source skips its
// row), kPullChunk loads a lane of both rows in flight before the stores
__device__ __forceinline__ void copy_two_rows(float* d0, const float* s0,
                                              float* d1, const float* s1,
                                              int E, int vec4, int lane) {
  if (vec4) {
    const int E4 = E >> 2;
    const float4* a = reinterpret_cast<const float4*>(s0);
    const float4* b = reinterpret_cast<const float4*>(s1);
    for (int c0 = 0; c0 < E4; c0 += 32 * kPullChunk) {
      float4 va[kPullChunk], vb[kPullChunk];
#pragma unroll
      for (int k = 0; k < kPullChunk; ++k) {
        const int c = c0 + k * 32 + lane;
        if (c < E4) {
          if (a != nullptr) va[k] = __ldg(a + c);
          if (b != nullptr) vb[k] = __ldg(b + c);
        }
      }
#pragma unroll
      for (int k = 0; k < kPullChunk; ++k) {
        const int c = c0 + k * 32 + lane;
        if (c < E4) {
          if (a != nullptr) reinterpret_cast<float4*>(d0)[c] = va[k];
          if (b != nullptr) reinterpret_cast<float4*>(d1)[c] = vb[k];
        }
      }
    }
  } else {
    for (int c0 = 0; c0 < E; c0 += 32 * kPullChunk) {
      float va[kPullChunk], vb[kPullChunk];
#pragma unroll
      for (int k = 0; k < kPullChunk; ++k) {
        const int c = c0 + k * 32 + lane;
        if (c < E) {
          if (s0 != nullptr) va[k] = __ldg(s0 + c);
          if (s1 != nullptr) vb[k] = __ldg(s1 + c);
        }
      }
#pragma unroll
      for (int k = 0; k < kPullChunk; ++k) {
        const int c = c0 + k * 32 + lane;
        if (c < E) {
          if (s0 != nullptr) d0[c] = va[k];
          if (s1 != nullptr) d1[c] = vb[k];
        }
      }
    }
  }
}

// rows[slot[r]] = table[src[r]] (src null: r), a warp per two entries
__global__ void staged_pull_kernel(float* __restrict__ rows,
                                   const float* __restrict__ table,
                                   const int* __restrict__ slot,
                                   const int* __restrict__ src, int n, int C,
                                   int E, int V, int vec4) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t r = 2 * (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5)
                        + (threadIdx.x >> 5));
       r < n; r += 2 * warps) {
    float* d[2] = {nullptr, nullptr};
    const float* s[2] = {nullptr, nullptr};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t e = r + h;
      if (e < n) {
        const int sl = slot[e];
        if (sl >= 0 && sl < C) {
          const int at = src != nullptr ? src[e] : static_cast<int>(e);
          d[h] = rows + static_cast<int64_t>(sl) * E;
          s[h] = table + static_cast<int64_t>(min(max(at, 0), V - 1)) * E;
        }
      }
    }
    copy_two_rows(d[0], s[0], d[1], s[1], E, vec4, lane);
  }
}

// a slot's refresh key as an unsigned whose order is the int32 key's:
// expiry where the slot is due, INT32_MAX (0xffffffff here) elsewhere
__device__ __forceinline__ unsigned refresh_key(int id, int exp, int step) {
  const bool due = id >= 0 && exp <= step;
  return static_cast<unsigned>(due ? exp : 0x7fffffff) ^ 0x80000000u;
}

// exclusive prefix sum of v over the block's threads in thread order,
// *total the block's sum; every thread of the block calls it
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) s_warp[lane] = w;
  }
  __syncthreads();
  const int out = (warp ? s_warp[warp - 1] : 0) + x - v;
  *total = s_warp[nw - 1];
  __syncthreads();
  return out;
}

// the TTL refresh in one block (see the header); kSmem: the C keys are
// kept in dynamic shared memory
template <bool kSmem>
__global__ void __launch_bounds__(kRefreshThreads, 1)
plane_refresh_kernel(const int* __restrict__ ids, int* __restrict__ expiry,
                     float* __restrict__ rows,
                     const float* __restrict__ table,
                     int* __restrict__ list_slot, int* __restrict__ list_id,
                     int* __restrict__ count, int C, int E, int V, int step,
                     int ttl, int K, int cap, int pull, int vec4,
                     int keys4) {
  extern __shared__ unsigned s_keys[];
  __shared__ int s_hist[kRadixBins];
  __shared__ int s_warp[32];
  __shared__ int s_sel[kBlockPull];
  __shared__ int s_misc[3];             // keys below INT32_MAX; bin; rank
  __shared__ unsigned s_lohi[2];        // their min and max
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  auto key = [&](int i) -> unsigned {
    return kSmem ? s_keys[i] : refresh_key(ids[i], expiry[i], step);
  };

  // the keys, their count below INT32_MAX and that count's min and max
  if (tid == 0) {
    s_misc[0] = 0;
    s_lohi[0] = 0xffffffffu;
    s_lohi[1] = 0u;
  }
  __syncthreads();
  int below = 0;
  unsigned klo = 0xffffffffu, khi = 0u;
  auto take = [&](int i, int id, int ex) {
    const unsigned u = refresh_key(id, ex, step);
    if (kSmem) s_keys[i] = u;
    if (u != 0xffffffffu) {
      ++below;
      klo = min(klo, u);
      khi = max(khi, u);
    }
  };
  int done = 0;
  if (keys4) {                           // 16-byte loads, 8 in flight
    const int4* id4 = reinterpret_cast<const int4*>(ids);
    const int4* ex4 = reinterpret_cast<const int4*>(expiry);
    done = C & ~3;
#pragma unroll 4
    for (int j = tid; j < (C >> 2); j += nt) {
      const int4 a = id4[j], b = ex4[j];
      take(4 * j, a.x, b.x);
      take(4 * j + 1, a.y, b.y);
      take(4 * j + 2, a.z, b.z);
      take(4 * j + 3, a.w, b.w);
    }
  }
#pragma unroll 4
  for (int i = done + tid; i < C; i += nt) take(i, ids[i], expiry[i]);
  below = __reduce_add_sync(0xffffffffu, below);
  klo = __reduce_min_sync(0xffffffffu, klo);
  khi = __reduce_max_sync(0xffffffffu, khi);
  if (lane == 0) {
    atomicAdd(&s_misc[0], below);
    atomicMin(&s_lohi[0], klo);
    atomicMax(&s_lohi[1], khi);
  }
  __syncthreads();

  // the kept slots: key < T, and the first `need` with key == T in slot
  // order; every key lies in [klo, khi] or is INT32_MAX
  unsigned T;
  int need;
  below = s_misc[0];
  klo = s_lohi[0];
  khi = s_lohi[1];
  if (K >= C) {                        // every due slot ranks below K
    T = 0xffffffffu;
    need = C;
  } else if (K <= 0) {
    T = 0u;
    need = 0;
  } else if (below <= K) {             // every key below INT32_MAX
    T = 0xffffffffu;
    need = K - below;
  } else if (klo == khi) {               // the K-th key is the only one
    T = klo;
    need = K;
  } else {
    // radix select of the K-th key from the first byte in which klo and
    // khi differ: the bytes above it are every candidate's
    const int top = ((31 - __clz(klo ^ khi)) >> 3) << 3;
    unsigned mask = top == 24 ? 0u : 0xffffffffu << (top + 8);
    unsigned prefix = klo & mask;
    int k = K;
    for (int shift = top; shift >= 0; shift -= 8) {
      for (int b = tid; b < kRadixBins; b += nt) s_hist[b] = 0;
      __syncthreads();
      for (int base = 0; base < C; base += nt) {
        const int i = base + tid;
        unsigned d = kRadixBins;       // no bin
        if (i < C) {
          const unsigned u = key(i);
          if ((u & mask) == prefix) d = (u >> shift) & 0xffu;
        }
        // a warp whose lanes share one bin adds once; else each lane
        if (__all_sync(0xffffffffu, d == __shfl_sync(0xffffffffu, d, 0))) {
          if (lane == 0 && d < kRadixBins) atomicAdd(&s_hist[d], 32);
        } else if (d < kRadixBins) {
          atomicAdd(&s_hist[d], 1);
        }
      }
      __syncthreads();
      if (warp == 0) {                 // the bin that holds rank k
        int c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = s_hist[lane * 8 + j];
          sum += c[j];
        }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        const int excl = incl - sum;
        if (excl < k && k <= incl) {
          int acc = excl, bin = -1, left = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (bin < 0 && k <= acc + c[j]) {
              bin = j;
              left = k - acc;
            }
            acc += c[j];
          }
          s_misc[1] = lane * 8 + bin;
          s_misc[2] = left;
        }
      }
      __syncthreads();
      prefix |= static_cast<unsigned>(s_misc[1]) << shift;
      mask |= 0xffu << shift;
      k = s_misc[2];
      __syncthreads();
    }
    T = prefix;
    need = k;
  }

  // each thread's run of consecutive slots: ranks among the key-T slots,
  // then places in the list, both in slot order
  const bool step_max = step == 0x7fffffff;
  // an odd run length keeps a warp's 32 runs on 32 banks
  const int per = ((C + nt - 1) / nt) | 1;
  const int lo = min(tid * per, C), hi = min(lo + per, C);
  int n_eq = 0;
  for (int i = lo; i < hi; ++i) n_eq += key(i) == T;
  int total;
  const int eq0 = block_scan(n_eq, s_warp, &total);
  int n_keep = 0;
  for (int i = lo, r = eq0; i < hi; ++i) {
    const unsigned u = key(i);
    const bool due = u != 0xffffffffu || (step_max && ids[i] >= 0);
    n_keep += due && (u < T || (u == T && r < need));
    r += u == T;
  }
  int n_sel;
  int at = block_scan(n_keep, s_warp, &n_sel);
  const int stamp = static_cast<int>(static_cast<unsigned>(step) +
                                     static_cast<unsigned>(ttl));
  for (int i = lo, r = eq0; i < hi; ++i) {
    const unsigned u = key(i);
    const bool due = u != 0xffffffffu || (step_max && ids[i] >= 0);
    if (due && (u < T || (u == T && r < need)) && at < cap) {
      expiry[i] = stamp;
      if (pull) {
        s_sel[at] = i;
      } else {
        list_slot[at] = i;
        list_id[at] = ids[i];
      }
      ++at;
    }
    r += u == T;
  }
  if (tid == 0) *count = min(n_sel, cap);
  if (!pull) {
    for (int j = n_sel + tid; j < cap; j += nt) {
      list_slot[j] = C;
      list_id[j] = -1;
    }
    return;
  }
  __syncthreads();
  const int n = min(n_sel, cap);
  for (int r = 2 * warp; r < n; r += 2 * (nt >> 5)) {
    float* d[2] = {nullptr, nullptr};
    const float* s[2] = {nullptr, nullptr};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r + h < n) {
        const int sl = s_sel[r + h];
        d[h] = rows + static_cast<int64_t>(sl) * E;
        s[h] = table + static_cast<int64_t>(min(max(ids[sl], 0), V - 1)) * E;
      }
    }
    copy_two_rows(d[0], s[0], d[1], s[1], E, vec4, lane);
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

// Alg. 1 for every worker's bags: a warp per bag b (worker b / m's sample
// b % m), lane e < n its cost column
__global__ void __launch_bounds__(kAlg1Warps * 32)
alg1_cost_kernel(const int* __restrict__ samples,
                 const unsigned char* __restrict__ latest,
                 const unsigned char* __restrict__ dirty,
                 const float* __restrict__ t, float* __restrict__ out,
                 int B, int F, int n, int64_t V, int64_t lat_stride,
                 int64_t dirty_stride) {
  __shared__ float tt[kAlg1MaxN];
  if (threadIdx.x < n) tt[threadIdx.x] = t[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kAlg1Warps + warp;
  if (b >= B) return;                    // whole warps leave together
  const int* bag = samples + b * F;
  const float te = lane < n ? tt[lane] : 0.f;
  float acc = 0.f;
  for (int f0 = 0; f0 < F; f0 += 32) {
    const int id = f0 + lane < F ? __ldg(bag + f0 + lane) : -1;
    // kept: not PAD, and the first of its id in the bag
    const unsigned same = __match_any_sync(0xffffffffu, id);
    bool keep = id != -1 && (same & ((1u << lane) - 1u)) == 0u;
    for (int j = 0; keep && j < f0; ++j) keep = __ldg(bag + j) != id;
    unsigned lat = 0u, dty = 0u;
    float p = 0.f;
    if (keep) {
      if (id >= 0 && id < V) {
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          lat |= static_cast<unsigned>(latest[j * lat_stride + id] != 0) << j;
          dty |= static_cast<unsigned>(dirty[j * dirty_stride + id] != 0)
                 << j;
        }
      }
      // sum_j d[j,id] T_j, a left fold over j as the route folds it
      p = __fmul_rn(static_cast<float>(dty & 1u), tt[0]);
      for (int j = 1; j < n; ++j)
        p = __fadd_rn(p, __fmul_rn(static_cast<float>((dty >> j) & 1u),
                                   tt[j]));
    }
    unsigned kept = __ballot_sync(0xffffffffu, keep);
    while (kept) {
      const int src = __ffs(kept) - 1;
      kept &= kept - 1u;
      const unsigned l = __shfl_sync(0xffffffffu, lat, src);
      const unsigned d = __shfl_sync(0xffffffffu, dty, src);
      const float pf = __shfl_sync(0xffffffffu, p, src);
      if (lane < n) {
        const float miss = __fmul_rn(
            __fsub_rn(1.f, static_cast<float>((l >> lane) & 1u)), te);
        const float push = __fsub_rn(
            pf, __fmul_rn(static_cast<float>((d >> lane) & 1u), te));
        acc = __fadd_rn(acc, __fmul_rn(__fadd_rn(miss, push), 1.f));
      }
    }
  }
  if (lane < n) out[b * n + lane] = acc;
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

extern "C" int staged_pull_launch(void* rows, const void* table,
                                  const void* slot, const void* src, int n,
                                  int C, int E, int V, int vec4,
                                  void* stream) {
  if (n == 0 || C == 0 || E == 0) return 0;
  if (V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = std::min<int64_t>(
      ((static_cast<int64_t>(n) + 1) / 2 + kPullWarps - 1) / kPullWarps,
      static_cast<int64_t>(kSMs) * 16);
  staged_pull_kernel<<<static_cast<unsigned>(blocks), kPullWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(rows), static_cast<const float*>(table),
      static_cast<const int*>(slot), static_cast<const int*>(src), n, C, E, V,
      vec4);
  return static_cast<int>(cudaGetLastError());
}

// K: the budget, C or more for none; cap: the list's length (min(K, C));
// pull: the block pulls the kept rows (cap <= kBlockPull), else it writes
// the list
extern "C" int plane_refresh_launch(const void* ids, void* expiry,
                                    void* rows, const void* table,
                                    void* list_slot, void* list_id,
                                    void* count, int C, int E, int V,
                                    int step, int ttl, int K, int cap,
                                    int pull, int vec4, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) return static_cast<int>(cudaMemsetAsync(count, 0, 4, st));
  if ((pull && (cap > kBlockPull || V < 1)) || cap > C)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* i = static_cast<const int*>(ids);
  int* x = static_cast<int*>(expiry);
  float* r = static_cast<float*>(rows);
  const float* t = static_cast<const float*>(table);
  int* ls = static_cast<int*>(list_slot);
  int* li = static_cast<int*>(list_id);
  int* n = static_cast<int*>(count);
  const int keys4 = reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(expiry) % 16 == 0;
  if (C <= kKeysSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        plane_refresh_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kKeysSmem * sizeof(unsigned)));
    if (err != cudaSuccess) return static_cast<int>(err);
    plane_refresh_kernel<true>
        <<<1, kRefreshThreads, C * sizeof(unsigned), st>>>(
            i, x, r, t, ls, li, n, C, E, V, step, ttl, K, cap, pull, vec4,
            keys4);
  } else {
    plane_refresh_kernel<false><<<1, kRefreshThreads, 0, st>>>(
        i, x, r, t, ls, li, n, C, E, V, step, ttl, K, cap, pull, vec4,
        keys4);
  }
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

// B = n * m bags of F ids (samples (n, m, F) int32), latest and dirty (n,
// V) bytes (bool) with row strides, t (n,) f32 -> out (n, m, n) f32
extern "C" int alg1_cost_launch(const void* samples, const void* latest,
                                const void* dirty, const void* t, void* out,
                                int B, int F, int n, long long V,
                                long long lat_stride, long long dirty_stride,
                                void* stream) {
  if (B == 0 || n == 0) return 0;
  if (n > kAlg1MaxN) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<int64_t>(B) + kAlg1Warps - 1) / kAlg1Warps);
  alg1_cost_kernel<<<blocks, kAlg1Warps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(samples),
      static_cast<const unsigned char*>(latest),
      static_cast<const unsigned char*>(dirty), static_cast<const float*>(t),
      static_cast<float*>(out), B, F, n, V, lat_stride, dirty_stride);
  return static_cast<int>(cudaGetLastError());
}
