// The auction's kernels, for Hopper (sm_90a).
//
// auction_solve_launch and auction_solve_warp_launch run whole eps-scaled
// auctions, one launch for B independent auctions, on two routes (below).
// They replace the Pallas TPU kernel
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
// and not arithmetic, but the chain of dependent rounds: a round's latency
// is the solve's time over its rounds.  kernels/auction.py:solve_route
// picks the route from (k, n, c), the crossover measured on the card
// (PERF.md, B7):
//
// The warp route (auction_solve_warp_kernel), up to 256 rows, 8 workers
// and 32 slots a worker: one warp an auction, a block of 32 threads, so a
// round crosses no block barrier, only __syncwarp.  The benchmark cells'
// decide (8 auctions of 128 x 8, c 16), the S1 simulator's decisions and
// the serving simulator's lie here.  Its price wars are mostly
// rounds of one bidder (a displaced row bids next), then two.  State and
// costs live in shared memory; what a round branches on is the same on
// every lane and lives in registers: the unassigned rows (a ballot mask a
// row of each lane, updated from the round's match) and each worker's
// cheapest price and slot (kept current, so a bid needs no scan of the
// slots).  A round of one bidder is computed by every lane alike: its row's
// costs from shared memory, its bid (a tree over the columns), its
// worker's cheapest slot, and that worker's slot order moved by one rank
// count (a ballot of the slots below the new price); every lane writes the
// same values.  A round of more bidders compacts their rows by ballot
// prefix counts, bids a bidder a lane, ranks each against the keys of its
// own worker over the round's list (a rank of c or more matches nothing),
// matches a bidder a lane, and ranks the slots of the workers it matched
// again, a slot a lane, through shuffles, as many workers a pass as
// segments of c lanes fit in the warp.  Past c = 32 a slot rank is a loop
// over shared memory, and the block route is faster (the training
// decide's 256 x 4, c 64); at c 32 the warp route is (S1's 256 x 8, its
// price war too).
//
// The block route (auction_solve_kernel), every other shape: one thread
// block an auction.  The S1 simulator's cold first decision is a price war
// of 986,684 rounds (k 256, n 8, c 32) in which 128 rows bid in 61 % of
// the rounds and 32 in 23 % (the plain version on the CPU).  So the state
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
// below its best alternative, a thread a slot (a lane a row on the warp
// route).
//
// Equality with the plain PyTorch version, bit for bit, on both routes:
// every value is one IEEE subtraction (__fsub_rn), max, min and argmax are
// exact in any order,
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

// ---------------------------------------------------------------------------
// auction_solve, the warp route: one warp an auction
// ---------------------------------------------------------------------------
constexpr int kWarpMaxN = 8;      // workers' cheapest prices in registers
constexpr int kWarpMaxRows = 8;   // rows a lane in the ballot masks

// Byte offsets of one warp's shared memory.  kernels/auction.py:
// warp_smem_bytes computes the same total; the launcher checks it.
struct WarpLayout {
  size_t list, cost, prices, okeys, owners, order, rank, assign, rslot, brow,
      total;
};

__host__ __device__ inline WarpLayout warp_layout(int k, int n, int c) {
  WarpLayout L;
  const size_t nc = static_cast<size_t>(n) * c;
  size_t o = 0;
  L.list = o;    o += 8 * static_cast<size_t>(k);
  L.cost = o;    o += align8(4 * static_cast<size_t>(k) * n);
  L.prices = o;  o += align8(4 * nc);
  L.okeys = o;   o += align8(4 * nc);
  L.owners = o;  o += align8(4 * nc);
  L.order = o;   o += align8(4 * nc);
  L.rank = o;    o += align8(4 * nc);
  L.assign = o;  o += align8(4 * static_cast<size_t>(k));
  L.rslot = o;   o += align8(4 * static_cast<size_t>(k));
  L.brow = o;    o += align8(4 * static_cast<size_t>(k));
  L.total = o;
  return L;
}

// best and second-best value over a run of columns, the best's first
// column, and that worker's cheapest price and slot
struct Top2 {
  float v1, v2, p;
  int j, s;
};

// a's columns come before b's: b wins only by a greater value
__device__ __forceinline__ Top2 top2_merge(const Top2& a, const Top2& b) {
  Top2 o;
  if (b.v1 > a.v1) {
    o.v1 = b.v1;
    o.v2 = fmaxf(b.v2, a.v1);
    o.j = b.j;
    o.p = b.p;
    o.s = b.s;
  } else {
    o.v1 = a.v1;
    o.v2 = fmaxf(a.v2, b.v1);
    o.j = a.j;
    o.p = a.p;
    o.s = a.s;
  }
  return o;
}

// One bidder row's bid by one thread: its best worker, the cheapest price
// and slot there and the bid, as group_bid computes them (the best value
// and its first column, the second best over the other columns floored at
// NEG, both exact in any order: a tree of depth log2 N; the two additions
// rounded apart).
template <int N>
__device__ __forceinline__ float row_bid(const float (&cost)[N],
                                         const float (&price)[N],
                                         const int (&slot)[N], int n,
                                         float eps, int& best, float& pbest,
                                         int& sbest) {
  Top2 t[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    t[j] = {j < n ? __fsub_rn(-cost[j], price[j]) : -INFINITY, kNeg,
            price[j], j, slot[j]};
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int j = 0; j + w < N; j += 2 * w) t[j] = top2_merge(t[j], t[j + w]);
  const float v2 = n == 1 ? t[0].v1 : t[0].v2;
  best = t[0].j;
  pbest = t[0].p;
  sbest = t[0].s;
  return __fadd_rn(__fadd_rn(t[0].p, __fsub_rn(t[0].v1, v2)), eps);
}

// One pass of warp_rank_slots at c <= W <= 32: the warp in segments of W
// lanes, segment g ranking the slots of worker jl (-1: none), a slot a lane
// counting the keys below its own through shuffles within the segment.
template <int W>
__device__ __forceinline__ void rank_pass(const unsigned* okeys, int* order,
                                          int* rank, int jl, int c,
                                          int lane) {
  const int t0 = lane & (W - 1);
  const bool in = jl >= 0 && t0 < c;
  const unsigned mine = in ? okeys[jl * c + t0] : ~0u;
  int r4[4] = {0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const unsigned o = __shfl_sync(kFullMask, mine, t, W);
    r4[t & 3] += (t < c) & ((o < mine) | ((o == mine) & (t < t0)));
  }
  const int r = (r4[0] + r4[1]) + (r4[2] + r4[3]);
  if (in) {
    order[jl * c + r] = t0;
    rank[jl * c + t0] = r;
  }
}

template <int W>
__device__ __forceinline__ void rank_passes(const unsigned* okeys,
                                            int* order, int* rank,
                                            unsigned mask, int c, int lane) {
  while (mask) {
    int jl = -1;
#pragma unroll
    for (int g = 0; g < 32 / W; ++g) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      if (lane / W == g) jl = j;
    }
    rank_pass<W>(okeys, order, rank, jl, c, lane);
  }
}

// The workers of `mask` (the same set on every lane): each one's c slots
// ranked by (price, slot) into order[j * c + rank] = slot and rank[j * c +
// slot] = rank, a slot a lane counting the keys below its own: at c <= 32
// through shuffles, as many workers a pass as segments of c lanes (to a
// power of two) fit in the warp.
__device__ __forceinline__ void warp_rank_slots(const unsigned* okeys,
                                                int* order, int* rank,
                                                unsigned mask, int c,
                                                int lane) {
  if (c <= 1) {
    rank_passes<1>(okeys, order, rank, mask, c, lane);
  } else if (c <= 2) {
    rank_passes<2>(okeys, order, rank, mask, c, lane);
  } else if (c <= 4) {
    rank_passes<4>(okeys, order, rank, mask, c, lane);
  } else if (c <= 8) {
    rank_passes<8>(okeys, order, rank, mask, c, lane);
  } else if (c <= 16) {
    rank_passes<16>(okeys, order, rank, mask, c, lane);
  } else if (c <= 32) {
    rank_passes<32>(okeys, order, rank, mask, c, lane);
  } else {
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      const unsigned* kj = okeys + j * c;
      for (int s = lane; s < c; s += 32) {
        const unsigned mine = kj[s];
        int r = 0;
        for (int t = 0; t < c; ++t) {
          const unsigned o = kj[t];
          r += (o < mine) | ((o == mine) & (t < s));
        }
        order[j * c + r] = s;
        rank[j * c + s] = r;
      }
    }
  }
}

// The cheapest slot and price of each worker of `mask`, from order[].
__device__ __forceinline__ void warp_refresh(float (&mp)[kWarpMaxN],
                                             int (&ms)[kWarpMaxN],
                                             const int* order,
                                             const float* prices,
                                             unsigned mask, int c) {
#pragma unroll
  for (int j = 0; j < kWarpMaxN; ++j)
    if ((mask >> j) & 1u) {
      ms[j] = j * c + order[j * c];
      mp[j] = prices[ms[j]];
    }
}

// x[j] = v, as a select on every element: an index the compiler cannot
// see at compile time would put x in local memory
template <typename T>
__device__ __forceinline__ void set_at(T (&x)[kWarpMaxN], int j, T v) {
#pragma unroll
  for (int t = 0; t < kWarpMaxN; ++t) x[t] = t == j ? v : x[t];
}

// Row `row` takes slot s of worker j at its bid; the slot's owner, if any,
// becomes unassigned.
__device__ __forceinline__ void warp_take(float* prices, unsigned* okeys,
                                          int* owners, int* assign,
                                          int* rslot, int s, int prev,
                                          int row, int j, float bid) {
  if (prev >= 0) assign[prev] = -1;
  owners[s] = row;
  prices[s] = bid;
  okeys[s] = ord_f(bid);
  assign[row] = j;
  rslot[row] = s;
}

// R rows a lane in the ballots: rows lane, lane + 32, ..., lane + 32 (R -
// 1).  The round's control state is the same on every lane and lives in
// registers: the unassigned rows (a ballot mask a row of each lane) and
// each worker's cheapest price and slot.
template <int R>
__global__ void __launch_bounds__(32, 1)
auction_solve_warp_kernel(const float* __restrict__ cost_g,
                          const float* __restrict__ eps_tab,
                          int* __restrict__ assign_out,
                          float* __restrict__ price_out,
                          int* __restrict__ owner_out,
                          int* __restrict__ rounds_out, int k, int n, int c,
                          int P, int max_rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WarpLayout L = warp_layout(k, n, c);
  uint64_t* list = reinterpret_cast<uint64_t*>(smem + L.list);
  float* cost = reinterpret_cast<float*>(smem + L.cost);
  float* prices = reinterpret_cast<float*>(smem + L.prices);
  unsigned* okeys = reinterpret_cast<unsigned*>(smem + L.okeys);
  int* owners = reinterpret_cast<int*>(smem + L.owners);
  int* order = reinterpret_cast<int*>(smem + L.order);
  int* rank = reinterpret_cast<int*>(smem + L.rank);
  int* assign = reinterpret_cast<int*>(smem + L.assign);
  int* rslot = reinterpret_cast<int*>(smem + L.rslot);
  int* brow = reinterpret_cast<int*>(smem + L.brow);

  const int b = blockIdx.x, lane = threadIdx.x, nc = n * c;
  const unsigned all = (1u << n) - 1u;
  const unsigned zero_key = ord_f(0.f);
  const unsigned below_me = (1u << lane) - 1u;
  const float* cost_b = cost_g + static_cast<int64_t>(b) * k * n;
  for (int i = lane; i < k * n; i += 32) cost[i] = cost_b[i];
  for (int i = lane; i < k; i += 32) assign[i] = -1;
  for (int s = lane; s < nc; s += 32) {
    prices[s] = 0.f;
    okeys[s] = zero_key;
    owners[s] = -1;
    order[s] = s % c;
    rank[s] = s % c;
  }
  __syncwarp();
  unsigned un[R];
  float mp[kWarpMaxN];   // each worker's cheapest price
  int ms[kWarpMaxN];     // and its slot
#pragma unroll
  for (int r = 0; r < R; ++r)
    un[r] = __ballot_sync(kFullMask, r * 32 + lane < k);
#pragma unroll
  for (int j = 0; j < kWarpMaxN; ++j) {
    mp[j] = 0.f;
    ms[j] = j * c;
  }

  for (int p = 0; p < P; ++p) {
    const float eps = eps_tab[b * P + p];
    if (p > 0) {
      // eps-CS repair: ownerless slots to zero, the cheapest prices, then
      // each owned slot tested by a lane of its owner's row
      for (int s = lane; s < nc; s += 32)
        if (owners[s] < 0) {
          prices[s] = 0.f;
          okeys[s] = zero_key;
        }
      __syncwarp();
      warp_rank_slots(okeys, order, rank, all, c, lane);
      __syncwarp();
      warp_refresh(mp, ms, order, prices, all, c);
      for (int i = lane; i < k; i += 32) {
        const int j = assign[i];
        if (j < 0) continue;
        const int s = rslot[i];
        const float* row = cost + i * n;
        float alt = -INFINITY;
#pragma unroll
        for (int t = 0; t < kWarpMaxN; ++t)
          if (t < n) alt = fmaxf(alt, __fsub_rn(-row[t], mp[t]));
        if (__fsub_rn(-row[j], prices[s]) < __fsub_rn(alt, eps)) {
          assign[i] = -1;
          owners[s] = -1;
          prices[s] = 0.f;
          okeys[s] = zero_key;
        }
      }
      __syncwarp();
      warp_rank_slots(okeys, order, rank, all, c, lane);
      __syncwarp();
      warp_refresh(mp, ms, order, prices, all, c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * 32 + lane;
        un[r] = __ballot_sync(kFullMask, i < k && assign[i] < 0);
      }
    }
    int rounds = 0;
    while (rounds < max_rounds) {
      int nb = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) nb += __popc(un[r]);
      if (nb == 0) break;
      ++rounds;
      if (nb == 1) {
        // one bidder: every lane prices its row and meets its worker's
        // cheapest slot; the worker's slot order moves that slot to the
        // rank of its new price, a ballot deep; every lane writes the same
        // values
        int rb = 0;
        unsigned m = un[0];
#pragma unroll
        for (int r = 1; r < R; ++r)
          if (un[r]) {
            rb = r;
            m = un[r];
          }
        const int lb = __ffs(m) - 1, row = rb * 32 + lb;
        float rc[kWarpMaxN];
#pragma unroll
        for (int j = 0; j < kWarpMaxN; ++j)
          rc[j] = j < n ? cost[row * n + j] : 0.f;
        int j, s;
        float pj;
        const float bid = row_bid(rc, mp, ms, n, eps, j, pj, s);
        if (bid > pj && bid > kNeg * 0.5f) {
          const int s0 = s - j * c;
          const unsigned key = ord_f(bid);
          const int prev = owners[s];
          float np = bid;   // the worker's new cheapest price and slot
          int nsl = s;
          if (c <= 32) {
            const bool in = lane < c && lane != s0;
            const int sl = j * c + lane;
            const unsigned o = in ? okeys[sl] : 0u;
            const int rt = in ? rank[sl] : 0;
            const float pt = in ? prices[sl] : 0.f;
            const bool below = in && (o < key || (o == key && lane < s0));
            const int q = __popc(__ballot_sync(kFullMask, below));
            const unsigned one = __ballot_sync(kFullMask, in && rt == 1);
            const float p1 = __shfl_sync(kFullMask, pt, __ffs(one) - 1);
            if (q > 0) {
              np = p1;
              nsl = j * c + __ffs(one) - 1;
            }
            if (lane < c) {
              const int nr = lane == s0 ? q : (below ? rt - 1 : rt);
              order[j * c + nr] = lane;
              rank[sl] = nr;
            }
            __syncwarp();
            warp_take(prices, okeys, owners, assign, rslot, s, prev, row, j,
                      bid);
          } else {
            __syncwarp();
            warp_take(prices, okeys, owners, assign, rslot, s, prev, row, j,
                      bid);
            __syncwarp();
            warp_rank_slots(okeys, order, rank, 1u << j, c, lane);
            __syncwarp();
            nsl = j * c + order[j * c];
            np = prices[nsl];
          }
          set_at(mp, j, np);
          set_at(ms, j, nsl);
          const unsigned back = prev >= 0 ? 1u << (prev & 31) : 0u;
#pragma unroll
          for (int r = 0; r < R; ++r)
            un[r] = (un[r] & (r == rb ? ~(1u << lb) : ~0u)) |
                    (r == (prev >> 5) ? back : 0u);
        }
        __syncwarp();
      } else {
        // the bidders' rows in row order (ballot prefix counts), then a
        // bidder a lane: its bid from the shared costs, as a (worker, bid
        // descending, row) key
        int base = 0;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (un[r]) {
            if ((un[r] >> lane) & 1u)
              brow[base + __popc(un[r] & below_me)] = r * 32 + lane;
            base += __popc(un[r]);
          }
        __syncwarp();
        for (int q = lane; q < nb; q += 32) {
          const int i = brow[q];
          float rc[kWarpMaxN];
#pragma unroll
          for (int t = 0; t < kWarpMaxN; ++t)
            rc[t] = t < n ? cost[i * n + t] : 0.f;
          int j, s;
          float pj;
          const float bid = row_bid(rc, mp, ms, n, eps, j, pj, s);
          list[q] = bid_key(j, bid, i);
        }
        __syncwarp();
        // its rank among its worker's bidders, counted over the list; the
        // worker's rank-r slot against its bid
        unsigned moved = 0, won[R], lost[R];
#pragma unroll
        for (int r = 0; r < R; ++r) won[r] = lost[r] = 0u;
        for (int q0 = 0; q0 < nb; q0 += 32) {
          const int q = q0 + lane;
          const uint64_t key = q < nb ? list[q] : kNoKey;
          const uint64_t first = key & (~0ull << 48);
          int r4[4] = {0, 0, 0, 0};
          int t = 0;
          for (; t + 4 <= nb; t += 4) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const uint64_t kt = list[t + u];
              r4[u] += (kt >= first) & (kt < key);
            }
          }
          for (; t < nb; ++t) {
            const uint64_t kt = list[t];
            r4[0] += (kt >= first) & (kt < key);
          }
          const int rk = (r4[0] + r4[1]) + (r4[2] + r4[3]);
          if (q < nb && rk < c) {
            const int j = static_cast<int>(key >> 48);
            const int s = j * c + order[j * c + rk];
            const float bid = key_bid(key);
            if (bid > prices[s] && bid > kNeg * 0.5f) {
              const int row = static_cast<int>(key & 0xffffu);
              const int prev = owners[s];
              warp_take(prices, okeys, owners, assign, rslot, s, prev, row, j,
                        bid);
              moved |= 1u << j;
#pragma unroll
              for (int r = 0; r < R; ++r) {
                won[r] |= r == (row >> 5) ? 1u << (row & 31) : 0u;
                lost[r] |= prev >= 0 && r == (prev >> 5) ? 1u << (prev & 31)
                                                          : 0u;
              }
            }
          }
        }
        const unsigned changed = __reduce_or_sync(kFullMask, moved);
        __syncwarp();
        warp_rank_slots(okeys, order, rank, changed, c, lane);
        __syncwarp();
        warp_refresh(mp, ms, order, prices, changed, c);
        // the winners leave the unassigned rows, the displaced join them
#pragma unroll
        for (int r = 0; r < R; ++r)
          un[r] = (un[r] & ~__reduce_or_sync(kFullMask, won[r])) |
                  __reduce_or_sync(kFullMask, lost[r]);
      }
    }
    if (lane == 0) rounds_out[b * P + p] = rounds;
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32)
    assign_out[static_cast<int64_t>(b) * k + i] = assign[i];
  for (int s = lane; s < nc; s += 32) {
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


template <int R>
static int launch_warp(const float* cost, const float* eps, int* assign,
                       float* prices, int* owners, int* rounds, int B, int k,
                       int n, int c, int P, int max_rounds, size_t smem,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        auction_solve_warp_kernel<R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auction_solve_warp_kernel<R><<<B, 32, smem, stream>>>(
      cost, eps, assign, prices, owners, rounds, k, n, c, P, max_rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int auction_solve_warp_launch(const float* cost, const float* eps,
                                         int* assign, float* prices,
                                         int* owners, int* rounds, int B,
                                         int k, int n, int c, int P,
                                         int max_rounds, long long smem_bytes,
                                         cudaStream_t stream) {
  if (n < 1 || n > kWarpMaxN || c < 1 || k < 0 || k > 32 * kWarpMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const WarpLayout L = warp_layout(k, n, c);
  if (static_cast<long long>(L.total) != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (k <= 32 * 4)
    return launch_warp<4>(cost, eps, assign, prices, owners, rounds, B, k, n,
                          c, P, max_rounds, smem, stream);
  return launch_warp<kWarpMaxRows>(cost, eps, assign, prices, owners, rounds,
                                   B, k, n, c, P, max_rounds, smem, stream);
}
