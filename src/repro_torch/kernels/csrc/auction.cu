// The auction's kernels, for Hopper (sm_90a).
//
// auction_solve_launch runs whole eps-scaled auctions, one thread block per
// independent auction.  It replaces the Pallas TPU kernel
// src/repro/kernels/auction.py:auction_bids (_bid_kernel) together with the
// loops the JAX package runs around it: the round (core/auction.py:
// _round_body, kernels/ops.py:_resolve), the phase's while_loop
// (core/auction.py:_auction_phase, kernels/ops.py:_phase) and the phase
// loop (core/dispatch_tpu.py:auction_fixed, core/auction.py:auction_solve).
// For each auction b over a (k, n) cost matrix with c slots a worker, and
// its P phase eps values, phase p > 0 first runs the eps-CS repair, then
// every phase runs rounds while a row of b is unassigned and fewer than
// max_rounds rounds of the phase have run: the reference's while_loop
// condition, tested before every round, so rounds and state equal the
// reference's exactly.  A round:
//   1. the bids of the unassigned rows (B7's arithmetic, group_bid below):
//        value[i, j] = -cost[i, j] - min_price[j]
//        best_j[i]   = argmax_j value[i, j]     (the first of equal values)
//        w1 = value[i, best_j],  w2 = max(NEG, max_{j != best_j} value)
//        bid[i]      = (min_price[best_j] + (w1 - w2)) + eps
//      with w2 = w1 when n == 1;
//   2. each worker's bidders in (bid descending, row ascending) order are
//      paired in rank with its slots in (price ascending, slot ascending)
//      order, the first min(k, c) of each; a pair matches where bid > price
//      and bid > NEG / 2, a prefix since bids fall and prices rise;
//   3. a matched slot's owner becomes unassigned, its bidder takes the slot
//      at its own bid.
// A row owns a slot exactly while it is assigned (every step keeps that),
// so within a round the displaced rows, the winners and the slots written
// are all distinct, and each match is applied by one thread with no order
// among them.
//
// What bounds it: not bytes (a round reads at most k * n * 4 bytes of cost)
// and not arithmetic, but the chain of dependent rounds and the barriers
// inside each.  The S1 simulator's cold first decision is a price war of
// 986,684 rounds (k 256, n 8, c 32) in which 128 rows bid in 61 % of the
// rounds and 32 in 23 % (the plain version on the CPU).  So the state
// (assign, slot prices, slot owners) lives in shared memory for the whole
// solve, the cost matrix too where it fits (else it is read through L2),
// a round is four barriers, and its work follows that round's bidders,
// not k:
//   1. the unassigned rows are compacted (warp ballots, a shared counter)
//      while the workers' cheapest prices are taken;
//   2. every warp bids, a group of lanes a bidder (as many as the columns
//      to a power of two: 4 rows at a time a warp at n = 8), each bid a
//      packed (worker, bid descending, row) key;
//   3. the bidders' ranks within their workers: with at most 256 bidders
//      a thread a bidder counts the keys below its own (O(nb^2) work over
//      nb threads, fine at 256, not at Table 2's first rounds of 8,192),
//      else a bitonic sort of the keys; and, a warp a worker with bidders,
//      its first min(bidders, c) slots in (price, slot) order: at c <= 64
//      a lane a slot counts the keys below its own, at most 16 ranks are
//      one warp min each, else a bitonic sort of all slots' keys;
//   4. the rank-r bidder of worker j meets j's r-th slot, a thread a pair.
// The repair reprices ownerless slots to zero, takes the cheapest prices,
// and unassigns each owner whose net value at its slot falls more than eps
// below its best alternative, a thread a slot.
//
// Equality with the plain PyTorch version, bit for bit: every value is one
// IEEE subtraction (__fsub_rn), max, min and argmax are exact in any order,
// the bid is two additions rounded apart (__fadd_rn) in the order written
// above, and the repair's tests are subtractions; there is no multiply, so
// nothing can contract into an FMA.  The sort keys map floats to unsigned
// integers in their order (zero taken as +0) and compare exactly.  NaN
// costs are not supported.  Rows, slots a worker and workers each take 16
// bits of a key: the wrapper raises beyond them.
//
// auction_bids_launch is B7's bid phase alone (one warp per bidder row, 8
// rows to a 256-thread block, the price row staged in shared memory, the
// lanes striding over the n columns), held against the plain version on
// the card; no driver path runs it.
//
// The launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() so a refused launch surfaces in the Python wrapper.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBidThreads = 256;   // 8 warps = 8 bidder rows per block
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNeg = -1e30f;
constexpr uint64_t kNoKey = ~0ull;
constexpr int kCountMax = 256;     // bidders ordered by a count, not a sort
constexpr int kCountSlots = 64;    // slots a worker ranked by a count
constexpr int kPickMax = 16;       // ranks a worker picks one min at a time

// One bidder row's best worker and bid, by a group of G lanes (G a power
// of two <= 32, groups aligned in the warp, every lane of the warp taking
// part); every lane of the group returns them.  c: the row's n costs;
// price: the n cheapest slot prices; sub: the lane's place in its group.
__device__ __forceinline__ void group_bid(const float* c, const float* price,
                                          int n, float eps, int sub, int G,
                                          int& best, float& bid) {
  // best value and its first column: each lane over its columns in order
  float v1 = -INFINITY;
  int j1 = INT_MAX;
  for (int j = sub; j < n; j += G) {
    const float v = __fsub_rn(-c[j], price[j]);
    if (j1 == INT_MAX || v > v1) {
      v1 = v;
      j1 = j;
    }
  }
  for (int off = G >> 1; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v1, off);
    const int oj = __shfl_xor_sync(kFullMask, j1, off);
    if (oj != INT_MAX && (j1 == INT_MAX || ov > v1 || (ov == v1 && oj < j1))) {
      v1 = ov;
      j1 = oj;
    }
  }
  // second best: the row's max with column j1 replaced by NEG
  float v2 = kNeg;
  for (int j = sub; j < n; j += G) {
    if (j == j1) continue;
    const float v = __fsub_rn(-c[j], price[j]);
    if (v > v2) v2 = v;
  }
  for (int off = G >> 1; off > 0; off >>= 1)
    v2 = fmaxf(v2, __shfl_xor_sync(kFullMask, v2, off));
  if (n == 1) v2 = v1;
  best = j1;
  bid = __fadd_rn(__fadd_rn(price[j1], __fsub_rn(v1, v2)), eps);
}

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
  int j1;
  float b;
  group_bid(cost + row * n, price, n, *eps, lane, 32, j1, b);
  if (lane == 0) {
    best_j[row] = j1;
    bid[row] = unassigned[row] ? b : kNeg;
  }
}

// ---------------------------------------------------------------------------
// auction_solve
// ---------------------------------------------------------------------------
__host__ __device__ inline size_t align8(size_t x) {
  return (x + 7) & ~static_cast<size_t>(7);
}

__host__ __device__ inline int pow2ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Byte offsets of one block's shared memory.  kernels/auction.py:
// solve_smem_bytes computes the same total; the launcher checks it.
struct SolveLayout {
  size_t bkeys, scratch, brank, prices, owners, assign, minp, cnt, seg, misc,
      cost, total;
};

__host__ __device__ inline SolveLayout solve_layout(int k, int n, int c,
                                                    int cost_in_smem) {
  SolveLayout L;
  const size_t nc = static_cast<size_t>(n) * c;
  size_t o = 0;
  L.bkeys = o;    o += 8 * static_cast<size_t>(pow2ceil(k));
  L.scratch = o;  // the bidder list, later the slot keys
  o += align8(4 * static_cast<size_t>(k) > 8 * static_cast<size_t>(pow2ceil(
                                                   static_cast<int>(nc)))
                  ? 4 * static_cast<size_t>(k)
                  : 8 * static_cast<size_t>(pow2ceil(static_cast<int>(nc))));
  L.brank = o;    o += 4 * kCountMax;
  L.prices = o;   o += align8(4 * nc);
  L.owners = o;   o += align8(4 * nc);
  L.assign = o;   o += align8(4 * static_cast<size_t>(k));
  L.minp = o;     o += align8(4 * static_cast<size_t>(n));
  L.cnt = o;      o += align8(4 * static_cast<size_t>(n));
  L.seg = o;      o += align8(4 * static_cast<size_t>(n));
  L.misc = o;     o += 16;
  L.cost = o;
  if (cost_in_smem) o += 4 * static_cast<size_t>(k) * n;
  L.total = o;
  return L;
}

// floats to unsigned integers in their order (-0 taken as +0)
__device__ __forceinline__ unsigned ord_f(float v) {
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord_f(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// (worker, bid descending, row ascending), ascending as integers
__device__ __forceinline__ uint64_t bid_key(int j, float bid, int row) {
  return (static_cast<uint64_t>(j) << 48) |
         (static_cast<uint64_t>(~ord_f(bid)) << 16) |
         static_cast<uint64_t>(row);
}

__device__ __forceinline__ float key_bid(uint64_t key) {
  return unord_f(~static_cast<unsigned>(key >> 16));
}

__device__ __forceinline__ uint64_t warp_min(uint64_t v) {
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(kFullMask, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// the workers' cheapest slot prices, a warp a worker
__device__ __forceinline__ void min_prices(const float* prices, float* minp,
                                           int n, int c, int warp, int W,
                                           int lane) {
  for (int j = warp; j < n; j += W) {
    float m = INFINITY;
    for (int s = lane; s < c; s += 32) m = fminf(m, prices[j * c + s]);
    for (int off = 16; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(kFullMask, m, off));
    if (lane == 0) minp[j] = m;
  }
}

// ascending bitonic sort of N (a power of two, >= 2) keys by the whole
// block; ends with a barrier
__device__ void bitonic_sort(uint64_t* keys, int N) {
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (N >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const uint64_t a = keys[i], b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(1024)
auction_solve_kernel(const float* __restrict__ cost_g,
                     const float* __restrict__ eps_tab,
                     int* __restrict__ assign_out,
                     float* __restrict__ price_out,
                     int* __restrict__ owner_out,
                     int* __restrict__ rounds_out, int k, int n, int c,
                     int P, int max_rounds, int cost_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SolveLayout L = solve_layout(k, n, c, cost_in_smem);
  uint64_t* bkeys = reinterpret_cast<uint64_t*>(smem + L.bkeys);
  int* list = reinterpret_cast<int*>(smem + L.scratch);
  uint64_t* skeys = reinterpret_cast<uint64_t*>(smem + L.scratch);
  int* brank = reinterpret_cast<int*>(smem + L.brank);
  float* prices = reinterpret_cast<float*>(smem + L.prices);
  int* owners = reinterpret_cast<int*>(smem + L.owners);
  int* assign = reinterpret_cast<int*>(smem + L.assign);
  float* minp = reinterpret_cast<float*>(smem + L.minp);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  int* seg = reinterpret_cast<int*>(smem + L.seg);
  int* misc = reinterpret_cast<int*>(smem + L.misc);   // bidder counters

  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  const int nc = n * c;
  // lanes a bidder: the columns, to a power of two, at most a warp
  const int G = n >= 32 ? 32 : pow2ceil(n);
  const int per = 32 / G, sub = lane & (G - 1), grp = lane / G;
  const float* cost_b = cost_g + static_cast<int64_t>(b) * k * n;
  const float* cost = cost_b;
  if (cost_in_smem) {
    float* cs = reinterpret_cast<float*>(smem + L.cost);
    for (int i = tid; i < k * n; i += T) cs[i] = cost_b[i];
    cost = cs;
  }
  for (int i = tid; i < k; i += T) assign[i] = -1;
  for (int s = tid; s < nc; s += T) {
    prices[s] = 0.f;
    owners[s] = -1;
  }
  if (tid < 2) misc[tid] = 0;
  __syncthreads();

  int it = 0;   // loop iterations, for the double-buffered bidder counter
  for (int p = 0; p < P; ++p) {
    const float eps = eps_tab[b * P + p];
    if (p > 0) {
      // eps-CS repair
      for (int s = tid; s < nc; s += T)
        if (owners[s] < 0) prices[s] = 0.f;
      __syncthreads();
      min_prices(prices, minp, n, c, warp, W, lane);
      __syncthreads();
      for (int s = tid; s < nc; s += T) {
        const int o = owners[s];
        if (o < 0) continue;
        const float* row = cost + static_cast<int64_t>(o) * n;
        float alt = -INFINITY;
        for (int j = 0; j < n; ++j)
          alt = fmaxf(alt, __fsub_rn(-row[j], minp[j]));
        const float net = __fsub_rn(-row[s / c], prices[s]);
        if (net < __fsub_rn(alt, eps)) {
          assign[o] = -1;
          owners[s] = -1;
          prices[s] = 0.f;
        }
      }
      __syncthreads();
    }
    int rounds = 0;
    while (rounds < max_rounds) {
      // the cheapest prices, and the unassigned rows compacted
      int* ctr = misc + (it & 1);
      min_prices(prices, minp, n, c, warp, W, lane);
      for (int j = tid; j < n; j += T) cnt[j] = 0;
      for (int base = warp * 32; base < k; base += T) {
        const int i = base + lane;
        const bool un = i < k && assign[i] < 0;
        const unsigned mask = __ballot_sync(kFullMask, un);
        if (mask) {
          int off = 0;
          if (lane == 0) off = atomicAdd(ctr, __popc(mask));
          off = __shfl_sync(kFullMask, off, 0);
          if (un) list[off + __popc(mask & ((1u << lane) - 1u))] = i;
        }
      }
      __syncthreads();
      const int nb = *ctr;
      if (tid == 0) misc[(it + 1) & 1] = 0;   // read last an iteration ago
      ++it;
      if (nb == 0) break;
      ++rounds;

      // bids, a group of G lanes a bidder, as packed keys; bidders per
      // worker
      for (int q0 = warp * per; q0 < nb; q0 += W * per) {
        const int q = q0 + grp;
        const int i = list[q < nb ? q : q0];
        int j1;
        float bid;
        group_bid(cost + static_cast<int64_t>(i) * n, minp, n, eps, sub, G,
                  j1, bid);
        if (sub == 0 && q < nb) {
          bkeys[q] = bid_key(j1, bid, i);
          atomicAdd(&cnt[j1], 1);
        }
      }
      __syncthreads();
      // the bidders' order: a rank within the worker by a count over the
      // others' keys, or a sort
      const bool counted = nb <= kCountMax;
      if (counted) {
        for (int q = tid; q < nb; q += T) {
          const uint64_t mine = bkeys[q];
          const uint64_t wmine = mine >> 48;
          int before = 0, lower = 0;   // keys below mine; of lower workers
          for (int t = 0; t < nb; ++t) {
            const uint64_t kt = bkeys[t];
            before += kt < mine;
            lower += (kt >> 48) < wmine;
          }
          brank[q] = before - lower;
        }
      } else {
        const int NB = pow2ceil(nb);
        for (int q = nb + tid; q < NB; q += T) bkeys[q] = kNoKey;
        __syncthreads();
        bitonic_sort(bkeys, NB);
        if (tid == 0) {
          int acc = 0;
          for (int j = 0; j < n; ++j) {
            seg[j] = acc;
            acc += cnt[j];
          }
        }
      }
      // each worker's first min(bidders, c) slots in (price, slot) order,
      // into skeys[j * c + r] (over the bidder list, read no more)
      int most = 0;
      for (int j = 0; j < n; ++j) most = max(most, min(cnt[j], c));
      if (c <= kCountSlots || most <= kPickMax) {
        for (int j = warp; j < n; j += W) {
          const int need = min(cnt[j], c);
          if (need == 0) continue;
          const float* pj = prices + j * c;
          if (c <= kCountSlots) {      // a rank by a count over c keys
            for (int s0 = lane; s0 < c; s0 += 32) {
              const uint64_t mine =
                  (static_cast<uint64_t>(ord_f(pj[s0])) << 32) | s0;
              int r = 0;
              for (int t = 0; t < c; ++t)
                r += ((static_cast<uint64_t>(ord_f(pj[t])) << 32) | t) < mine;
              if (r < need) skeys[j * c + r] = s0;
            }
          } else {                     // one warp min a rank
            uint64_t last = 0;
            for (int r = 0; r < need; ++r) {
              uint64_t best = kNoKey;
              for (int s0 = lane; s0 < c; s0 += 32) {
                const uint64_t sk =
                    (static_cast<uint64_t>(ord_f(pj[s0])) << 32) | s0;
                if ((r == 0 || sk > last) && sk < best) best = sk;
              }
              last = warp_min(best);
              if (lane == 0) skeys[j * c + r] = last & 0xffffffffu;
            }
          }
        }
      } else {
        const int NS = pow2ceil(nc);
        for (int s0 = tid; s0 < NS; s0 += T)
          skeys[s0] = s0 < nc ? (static_cast<uint64_t>(s0 / c) << 48) |
                                    (static_cast<uint64_t>(ord_f(prices[s0]))
                                     << 16) |
                                    static_cast<uint64_t>(s0 % c)
                              : kNoKey;
        __syncthreads();
        bitonic_sort(skeys, NS);
      }
      __syncthreads();
      // the rank-r bidder of worker j against its r-th slot
      for (int q = tid; q < nb; q += T) {
        const uint64_t key = bkeys[q];
        const int j = static_cast<int>(key >> 48);
        const int r = counted ? brank[q] : q - seg[j];
        if (r >= c) continue;
        const int slot = j * c + static_cast<int>(skeys[j * c + r] & 0xffffu);
        const float bid = key_bid(key);
        if (bid > prices[slot] && bid > kNeg * 0.5f) {
          const int row = static_cast<int>(key & 0xffffu);
          const int prev = owners[slot];
          if (prev >= 0) assign[prev] = -1;
          owners[slot] = row;
          prices[slot] = bid;
          assign[row] = j;
        }
      }
      __syncthreads();
    }
    if (tid == 0) rounds_out[b * P + p] = rounds;
  }
  __syncthreads();
  for (int i = tid; i < k; i += T)
    assign_out[static_cast<int64_t>(b) * k + i] = assign[i];
  for (int s = tid; s < nc; s += T) {
    price_out[static_cast<int64_t>(b) * nc + s] = prices[s];
    owner_out[static_cast<int64_t>(b) * nc + s] = owners[s];
  }
}

}  // namespace

extern "C" int auction_bids_launch(const float* cost, const float* min_price,
                                   const uint8_t* unassigned,
                                   const float* eps, int* best_j, float* bid,
                                   int k, int n,
                                   cudaStream_t stream) {
  const int rows_per_block = kBidThreads / 32;
  const int blocks = (k + rows_per_block - 1) / rows_per_block;
  auction_bids_kernel<<<blocks, kBidThreads, n * sizeof(float), stream>>>(
      cost, min_price, unassigned, eps, best_j, bid, k, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int auction_solve_launch(const float* cost, const float* eps,
                                    int* assign, float* prices, int* owners,
                                    int* rounds, int B, int k, int n, int c,
                                    int P, int max_rounds, int cost_in_smem,
                                    long long smem_bytes,
                                    cudaStream_t stream) {
  const SolveLayout L = solve_layout(k, n, c, cost_in_smem);
  if (static_cast<long long>(L.total) != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        auction_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // a thread per row or slot, whole warps, 64 to 1,024
  const int wide = k > n * c ? k : n * c;
  int threads = (wide + 31) / 32 * 32;
  threads = threads < 64 ? 64 : (threads > 1024 ? 1024 : threads);
  auction_solve_kernel<<<B, threads, static_cast<size_t>(smem_bytes),
                         stream>>>(cost, eps, assign, prices, owners, rounds,
                                   k, n, c, P, max_rounds, cost_in_smem);
  return static_cast<int>(cudaGetLastError());
}
