// Blockwise GQA flash attention, backward, bf16, on Hopper's tensor cores
// (sm_90a): wgmma fed by TMA, warp-specialised, deterministic.
//
// flash_attention_bwd_sm90_launch computes, for bf16 inputs, the gradient
// of B8's forward (flash_attn_sm90.cu), which replaces the gradient of the
// Pallas TPU kernel src/repro/kernels/flash_attn.py:66 flash_attention:
// that kernel had no backward, JAX differentiates the jnp scan of
// src/repro/models/layers.py:attention_flash.  f32 inputs take
// flash_attn_bwd_tf32.cu.  From the saved q (B, Sq, KV, G,
// hd), k, v (B, Sk, KV, hd), out, lse (natural log, (B, KV, G, Sq)) and
// the incoming dout it computes, with f32 accumulators and positions
// 0 .. S-1 on both sides,
//     D  = rowsum(dO * O)
//     P  = exp(Q K^T * scale - lse)
//     dV = P^T dO,   dS = P * (dO V^T - D)
//     dQ = dS K * scale,   dK = dS^T Q * scale
// with P and dS rounded to bf16 as the tensor cores' operands (as SDPA's
// backward does), and writes dq, dk, dv contiguous in bf16.
//
// What bounds it: 10 hd operations per visible (row, key) pair (five
// products), 8.06e10 at the LM path's shape (smollm-360m: B = 4, S =
// 2048, 15 heads over 5 KV heads, hd = 64, causal): 0.0815 ms at the
// tensor cores' 989 TFLOP/s, against about 0.03 ms for its bytes.  So
// operations bound it, and only wgmma reaches that rate.
//
// Design: three launches, no atomics, every output element summed in one
// fixed order, so two calls give bitwise-equal gradients (remat and
// resume compare losses bit for bit).  Rows are the flattened (position,
// head) axis of one (b, kv) pair, cut into tiles of 64: P = 64 / G whole
// positions times G heads (for G > 64, one position times 64 heads, the
// heads in blocks).  Such a tile is one TMA box of a 5-d map over (hd, G,
// KV, S, B) whatever G is; when P G < 64 (G = 3: 63 rows) the rows past it
// stay zero in shared memory, which costs (64 - P G) / 64 of the products
// (1.6 % at G = 3) and no copy by threads.
//   (1) stats: D and lse * log2(e), one f32 pair a row, written in tile
//       order (b, kv, tile, row of the tile) into a scratch that the
//       wrapper allocates, with (+inf, 0) for rows past the end, so P and
//       dS vanish there without a mask.  A tile's statistics are then one
//       512-byte bulk copy.
//   (2) dK/dV: a block per (b, kv, 64 keys), 384 threads: a producer
//       warpgroup (its first thread issues every TMA) and two consumer
//       warpgroups, with setmaxnreg at 24 and 240 registers.  K and V are
//       loaded once.  The producer keeps Q, dO and the statistics of the
//       next row tiles in flight through a ring of 5 or 6 stages on
//       mbarriers.  The consumers take the tiles in turn and each holds
//       dK and dV of all 64 keys in registers, so the grid has a block
//       per 64 keys: 256 at B 1, KV 8, S 2,048, scheduled longest first,
//       where 128-key blocks would leave 128 blocks for 132 SMs with a
//       16:1 causal spread.  At the end each warpgroup hands the other
//       half its sums through shared memory (the first writes dK, the
//       second dV).  A row tile: S^T = K Q^T and dP^T = V dO^T as two
//       wgmma groups (both operands K-major from shared memory); P^T in
//       registers while dP^T runs; dV += P^T dO (P^T rounded to bf16 as
//       the register A operand, dO MN-major); dS^T = P^T (dP^T - D) while
//       dV runs; dK += dS^T Q, left running into the next tile, whose
//       first wait retires it and releases its stage.  Under causal a key
//       tile starts at the row tile of its first key, and only tiles that
//       cross the diagonal are masked, without a division: row j of a
//       tile at position s0 + j / Gb sees key t iff (t - s0) Gb <= j.
//   (3) dQ: a block per (b, kv, W row tiles), W consumer warpgroups (3
//       below hd 128, at 160 registers; 2 at hd 128, at 240) and the
//       producer; Q and dO loaded once, K and V streamed through a ring
//       of 64-key tiles by the forward's 4-d maps.  A tile: S = Q K^T and
//       dP = dO V^T as two groups, P while dP runs, dS in registers, dQ
//       += dS K (K MN-major) left running into the next tile.  Latest
//       rows first, so the causal tail is short.  This pass recomputes S
//       and dP: 7 products where 5 would do, the price of summing dQ
//       without atomics in a fixed order.
// (2) and (3) are launched as programmatic dependents: (2)'s blocks load
// K, V and the first tiles while (1) ends and wait for it only before the
// statistics; (3) reads only (1)'s output, so its blocks fill the SMs
// that (2)'s shortest blocks free, and each waits for (2) before it ends.
// Keys past Sk are zero-filled by TMA, and their dK, dV rows are not
// written: (2) masks only the causal diagonal, (3) the diagonal and the
// ragged end.  Exponentials are MUFU's ex2 of log2-scaled scores against
// lse log2(e); at hd 64 they, not the tensor cores, pace a tile's
// P phase (32 a thread, 8 cycles a warp each).
//
// The launcher builds the tensor maps on the host per call, runs on the
// caller's stream, allocates nothing, and returns a CUDA error code (or
// kEncodeFailed when the driver refuses a map) so that a refused launch
// surfaces in the wrapper.
#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kT = 64;                       // keys a tile, rows a tile
constexpr int kConsumers = 2;                // consumer warpgroups of (2)
constexpr int kProducer = 128 * kConsumers;  // the producer's first tid
constexpr int kThreads = kProducer + 128;    // + a producer warpgroup
constexpr int kStatThreads = 256;
// setmaxnreg acts on whole warpgroups, so the producer is one (its first
// thread issues every load, the others leave).  Each of an SM's four
// sub-partitions holds 512 registers a lane for its warps: two consumer
// warps at 240 and a producer warp at 24 make 504.  A second block would
// wait for registers that never come free; at least this much dynamic
// shared memory (of the SM's 228 KB) keeps it off the SM.
constexpr int kOneBlockSmem = 116 * 1024;
constexpr int one_block(int bytes) {
  return bytes > kOneBlockSmem ? bytes : kOneBlockSmem;
}

template <int HD>
struct Cfg {
  static constexpr int SW = HD >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int CE = SW / 2;               // elements of one span
  static constexpr int NC = HD / CE;              // spans across hd
  static constexpr int LAYOUT = SW == 128 ? 1 : 2; // wgmma: B128, B64
  static constexpr int TILE = kT * HD * 2;        // one bf16 tile, bytes
  static constexpr int STAT = kT * 8;             // a tile's (L, D)
  // (2): K, V, then a ring of (Q, dO) tiles, their statistics, barriers;
  // a consumer holds two stages (its tile and, until that tile's
  // products finish, the previous one), so 5 or 6 leave prefetch room
  static constexpr int A_STAGES = HD == 128 ? 5 : 6;
  static constexpr int SMEM_A =
      one_block(2 * TILE + A_STAGES * (2 * TILE + STAT) +
                (2 * A_STAGES + 1) * 8 + 1024);
  // (3): Q and dO of each consumer's tile, a ring of (K, V) tiles.
  // Below hd 128 its registers (dQ, S, dP, dS: about 140 a thread) let
  // three consumer warpgroups share a sub-partition's 512 with the
  // producer (3 x 160 + 24), hiding more of each one's latency
  static constexpr int DQ_WG = HD == 128 ? 2 : 3;
  static constexpr int DQ_REGS = HD == 128 ? 240 : 160;
  static constexpr int B_STAGES = HD == 128 ? 4 : 6;
  static constexpr int SMEM_B =
      one_block(2 * DQ_WG * TILE + B_STAGES * 2 * TILE +
                (2 * B_STAGES + 1) * 8 + 1024);
  // (2)'s warpgroups hand each other half their sums (dV one way, dK the
  // other) through the ring
  static_assert(2 * kT * HD * 4 <= A_STAGES * 2 * TILE, "reduction space");
};

struct Args {
  const float2* stats;   // (L * log2 e, D) a row: (b, kv, tile, 64)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, Sq, Sk, KV, G, causal;
  int P, Gb, HB, NT;     // positions and heads a tile, head blocks, tiles
  float scale, scale2;   // 1 / sqrt(hd), log2(e) / sqrt(hd)
};

struct StatArgs {
  const __nv_bfloat16* out;   // contiguous (B, Sq, KV, G, hd)
  const __nv_bfloat16* dout;
  const float* lse;
  float2* stats;
  int64_t ob, os, ok, og;     // dout's element strides
};

__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kProducer) : "memory");
}

// Programmatic dependent launch: a kernel lets the next one on the stream
// start its blocks (as SMs come free) before it ends; the next one waits
// for it, where it reads what it wrote, with grid_dep_wait
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the rows of each 64-row tile that TMA never writes (P G < 64) stay zero
template <int HD>
__device__ void zero_pad_rows(uint8_t* tiles, int n_tiles, int rows) {
  constexpr int SW = Cfg<HD>::SW, RB = SW / 16, NC = Cfg<HD>::NC;
  if (rows >= kT) return;
  const int per = (kT - rows) * RB;   // 16-byte chunks a (tile, span)
  for (int e = threadIdx.x; e < n_tiles * NC * per; e += blockDim.x) {
    const int blk = e / per, x = e % per;
    *reinterpret_cast<uint4*>(tiles + blk * kT * SW +
                              (rows + x / RB) * SW + (x % RB) * 16) =
        make_uint4(0, 0, 0, 0);
  }
}

// ---- (1) the statistics: hd / 8 threads a row, 16 bytes each
template <int HD>
__global__ void __launch_bounds__(kStatThreads)
flash_bwd_stats_kernel(const Args a, const StatArgs sa) {
  let_next_start();
  constexpr int TPR = HD / 8;
  const int64_t n = static_cast<int64_t>(a.B) * a.KV * a.NT * kT;
  const int64_t slot =
      (static_cast<int64_t>(blockIdx.x) * kStatThreads + threadIdx.x) / TPR;
  const int part = threadIdx.x % TPR;
  bool row = slot < n;
  int b = 0, h = 0, s = 0, g = 0;
  if (row) {
    const int64_t per = static_cast<int64_t>(a.NT) * kT;
    const int bh = static_cast<int>(slot / per);
    const int rem = static_cast<int>(slot % per);
    const int tile = rem / kT, j = rem % kT;
    b = bh / a.KV;
    h = bh % a.KV;
    s = tile / a.HB * a.P + j / a.Gb;
    g = tile % a.HB * a.Gb + j % a.Gb;
    row = j < a.P * a.Gb && s < a.Sq && g < a.G;
  }
  float acc = 0.f;
  if (row) {
    const uint4 o = *reinterpret_cast<const uint4*>(
        sa.out + (((static_cast<int64_t>(b) * a.Sq + s) * a.KV + h) * a.G +
                  g) * HD + part * 8);
    const uint4 d = *reinterpret_cast<const uint4*>(
        sa.dout + b * sa.ob + s * sa.os + h * sa.ok + g * sa.og + part * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 df = __bfloat1622float2(d2[e]);
      acc = fmaf(df.x, of.x, acc);
      acc = fmaf(df.y, of.y, acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && slot < n)
    sa.stats[slot] =
        row ? make_float2(sa.lse[((static_cast<int64_t>(b) * a.KV + h) * a.G +
                                  g) * a.Sq + s] * kLog2e,
                          acc)
            : make_float2(INFINITY, 0.f);
}

// ---- (2) dK, dV: a block per (b, kv, 64 keys)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = Cfg<HD>;
  constexpr int SW = C::SW, NC = C::NC, CE = C::CE, S = C::A_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = base;                      // [NC][kT][SW]
  uint8_t* sv = sk + C::TILE;
  uint8_t* ring = sv + C::TILE;            // [S][Q, dO][NC][kT][SW]
  float2* sstat = reinterpret_cast<float2*>(ring + S * 2 * C::TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sstat + S * kT);
  uint64_t* empty = full + S;
  uint64_t* kvbar = empty + S;

  const int tid = threadIdx.x;
  // a 1-d grid, key tile slowest: under causal the first key tiles meet
  // the most rows, and they start first
  const int bh = blockIdx.x % (a.B * a.KV);
  const int h = bh % a.KV, b = bh / a.KV;
  const int k0 = blockIdx.x / (a.B * a.KV) * kT;
  const int first = a.causal ? k0 / a.P * a.HB : 0;  // rows at or past k0
  const int n_tiles = max(a.NT - first, 0);
  const int rows = a.P * a.Gb;

  zero_pad_rows<HD>(ring, 2 * S, rows);
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);   // the four warps of the consuming group
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid >= kProducer) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kProducer) {
      mbar_expect_tx(kvbar, 2 * C::TILE);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(sk + c * kT * SW, &tk, kvbar, c * CE, k0, h, b);
        tma_load_4d(sv + c * kT * SW, &tv, kvbar, c * CE, k0, h, b);
      }
      // bytes of a stage: every box in full (the zero fill counts)
      const int tx = 4 * HD * rows + C::STAT;
      grid_dep_wait();    // the statistics are written
      let_next_start();   // so the dQ pass, which reads only them, may
                          // fill the SMs this pass frees
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % S;
        if (i >= S) mbar_wait(&empty[st], (i / S - 1) & 1);
        uint8_t* sq = ring + st * 2 * C::TILE;
        const int tile = first + i;
        const int s0 = tile / a.HB * a.P, g0 = tile % a.HB * a.Gb;
        mbar_expect_tx(&full[st], tx);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_5d(sq + c * kT * SW, &tq, &full[st], c * CE, g0, h, s0, b);
          tma_load_5d(sq + C::TILE + c * kT * SW, &tdo, &full[st], c * CE,
                      g0, h, s0, b);
        }
        bulk_load(sstat + st * kT,
                  a.stats + (static_cast<int64_t>(bh) * a.NT + tile) * kT,
                  C::STAT, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    // this thread's keys: k0 + m0 and k0 + m0 + 8
    const int m0 = warp * 16 + lane / 4;
    const uint32_t k_addr = smem_u32(sk), v_addr = smem_u32(sv);
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kvbar, 0);

    // P^T and dS^T as the A operands of dV and dK: alive until the next
    // tile's first wait retires those products, whose stage is then
    // released
    uint32_t pf[4][4], df[4][4];
    int pending = -1;
    for (int i = cw; i < n_tiles; i += kConsumers) {
      const int st = i % S;
      mbar_wait(&full[st], (i / S) & 1);
      const uint32_t q_addr = smem_u32(ring + st * 2 * C::TILE);
      const uint32_t o_addr = q_addr + C::TILE;
      const float2* stat = sstat + st * kT;
      const int s0 = (first + i) / a.HB * a.P;

      // S^T = K Q^T and dP^T = V dO^T, two groups: Q and dO K-major, a
      // k-step of 16 is 32 bytes into the swizzled span
      float s[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / (CE / 16), w = kk % (CE / 16);
        wgmma_ss(s,
                 gmma_desc(k_addr + c * kT * SW + w * 32, 16, 8 * SW,
                           C::LAYOUT),
                 gmma_desc(q_addr + c * kT * SW + w * 32, 16, 8 * SW,
                           C::LAYOUT),
                 kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / (CE / 16), w = kk % (CE / 16);
        wgmma_ss(dp,
                 gmma_desc(v_addr + c * kT * SW + w * 32, 16, 8 * SW,
                           C::LAYOUT),
                 gmma_desc(o_addr + c * kT * SW + w * 32, 16, 8 * SW,
                           C::LAYOUT),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();   // S^T, and the previous tile's dV and dK
      fence_regs(s);
      fence_regs(dk);
      fence_regs(dv);
      if (pending >= 0) {
        keep(pf);
        keep(df);
        release(&empty[pending]);
      }

      // P^T while dP^T runs; element e of s is key k0 + m0 (+ 8 if
      // e % 4 >= 2) and tile row j = 8 (e / 4) + 2 (lane % 4) + e % 2 at
      // position s0 + j / Gb, which sees the key iff (key - s0) Gb <= j
      const bool edge = a.causal && k0 + kT - 1 > s0;
      const int lim = (k0 + m0 - s0) * a.Gb;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        float p = ex2(fmaf(s[e], a.scale2, -stat[j].x));
        if (edge && lim + (e % 4 >= 2 ? 8 * a.Gb : 0) > j) p = 0.f;
        s[e] = p;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pf[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
      // dV += P^T dO: dO MN-major, 16 rows a k-step, the hd spans kT SW
      // apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dv, pf[kk],
                 gmma_desc(o_addr + kk * 16 * SW, kT * SW, 8 * SW, C::LAYOUT));
      wgmma_commit();
      wgmma_wait<1>();   // dP^T (dV may still run)
      fence_regs(dp);

      // dS^T = P^T (dP^T - D), then dK += dS^T Q, left running
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int e = 8 * kk + 2 * x;   // columns j and j + 1
          const float d0 = stat[8 * (e / 4) + 2 * (lane % 4)].y;
          const float d1 = stat[8 * (e / 4) + 2 * (lane % 4) + 1].y;
          df[kk][x] = pack_bf16(s[e] * (dp[e] - d0),
                                s[e + 1] * (dp[e + 1] - d1));
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dk, df[kk],
                 gmma_desc(q_addr + kk * 16 * SW, kT * SW, 8 * SW, C::LAYOUT));
      wgmma_commit();
      pending = st;
    }
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    if (pending >= 0) {
      keep(pf);
      keep(df);
      release(&empty[pending]);
    }

    // the two warpgroups' sums meet through the ring, which both are done
    // with: the first adds the second's dK to its own and writes dK, the
    // second adds the first's dV to its own and writes dV
    named_sync();
    float* red = reinterpret_cast<float*>(ring);
    const int t = tid % 128;
    auto finish = [&](float (&acc)[HD / 2], const float (&give)[HD / 2],
                      __nv_bfloat16* out, float scale) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        red[(cw * HD / 2 + i) * 128 + t] = give[i];
      named_sync();
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        acc[i] += red[((1 - cw) * HD / 2 + i) * 128 + t];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int key = k0 + m0 + 8 * x;
        if (key >= a.Sk) continue;
        __nv_bfloat16* row =
            out + ((static_cast<int64_t>(b) * a.Sk + key) * a.KV + h) * HD;
#pragma unroll
        for (int n8 = 0; n8 < HD / 8; ++n8)
          *reinterpret_cast<uint32_t*>(row + n8 * 8 + (lane % 4) * 2) =
              pack_bf16(acc[4 * n8 + 2 * x] * scale,
                        acc[4 * n8 + 2 * x + 1] * scale);
      }
    };
    if (cw == 0) finish(dk, dv, a.dk, a.scale);
    else finish(dv, dk, a.dv, 1.f);
  }
}

// ---- (3) dQ: a block per (b, kv, DQ_WG row tiles)
template <int HD>
__global__ void __launch_bounds__(128 * (Cfg<HD>::DQ_WG + 1), 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = Cfg<HD>;
  constexpr int SW = C::SW, NC = C::NC, CE = C::CE, S = C::B_STAGES;
  constexpr int W = C::DQ_WG, PRODUCER = 128 * W;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;                 // [W][NC][kT][SW]
  uint8_t* so = sq + W * C::TILE;     // dO, the same
  uint8_t* ring = so + W * C::TILE;   // [S][K, V][NC][kT][SW]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * 2 * C::TILE);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x % (a.B * a.KV);
  const int h = bh % a.KV, b = bh / a.KV;
  // a 1-d grid, row tiles slowest and the longest (latest) first
  const int n_blocks = (a.NT + W - 1) / W;
  const int tile0 = (n_blocks - 1 - blockIdx.x / (a.B * a.KV)) * W;
  const int rows = a.P * a.Gb;
  auto tile_keys = [&](int tile) {   // keys the rows of a tile see
    if (tile >= a.NT) return 0;
    return a.causal ? min(a.Sk, min(tile / a.HB * a.P + a.P, a.Sq)) : a.Sk;
  };
  int n_keys = 0;
  for (int w = 0; w < W; ++w) n_keys = max(n_keys, tile_keys(tile0 + w));
  const int n_tiles = (n_keys + kT - 1) / kT;

  zero_pad_rows<HD>(sq, 2 * W, rows);
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * W);   // every consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid >= PRODUCER) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == PRODUCER) {
      const int n_own = min(W, a.NT - tile0);
      mbar_expect_tx(qbar, n_own * 4 * HD * rows);
      for (int w = 0; w < n_own; ++w) {
        const int tile = tile0 + w;
        const int s0 = tile / a.HB * a.P, g0 = tile % a.HB * a.Gb;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_5d(sq + w * C::TILE + c * kT * SW, &tq, qbar, c * CE, g0,
                      h, s0, b);
          tma_load_5d(so + w * C::TILE + c * kT * SW, &tdo, qbar, c * CE, g0,
                      h, s0, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % S;
        if (j >= S) mbar_wait(&empty[st], (j / S - 1) & 1);
        uint8_t* kt = ring + st * 2 * C::TILE;
        mbar_expect_tx(&full[st], 2 * C::TILE);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(kt + c * kT * SW, &tk, &full[st], c * CE, j * kT, h, b);
          tma_load_4d(kt + C::TILE + c * kT * SW, &tv, &full[st], c * CE,
                      j * kT, h, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::DQ_REGS));
    const int cw = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int tile = tile0 + cw;
    const int wkeys = tile_keys(tile);
    const int s0 = tile / a.HB * a.P;
    // this thread's rows of the tile: jA and jA + 8, their positions and
    // statistics
    const int jA = warp * 16 + lane / 4;
    const int js[2] = {jA, jA + 8};
    float2 st2[2];
    int pos[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      st2[x] = tile < a.NT
                   ? a.stats[(static_cast<int64_t>(bh) * a.NT + tile) * kT +
                             js[x]]
                   : make_float2(INFINITY, 0.f);
      pos[x] = s0 + js[x] / a.Gb;
    }
    const uint32_t q_addr = smem_u32(sq + cw * C::TILE);
    const uint32_t o_addr = smem_u32(so + cw * C::TILE);
    if (tile < a.NT) mbar_wait(qbar, 0);
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

    // dS as the A operand of dQ: alive until the next tile's first wait
    // retires that product, whose stage is then released
    uint32_t df[4][4];
    int pending = -1;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S;
      // every consumer waits for every stage, so that none runs a phase
      // ahead on the empty barrier, and computes only up to its keys
      mbar_wait(&full[st], (j / S) & 1);
      const int t0 = j * kT;
      if (t0 >= wkeys) {
        wgmma_wait<0>();
        fence_regs(dq);
        if (pending >= 0) {
          keep(df);
          release(&empty[pending]);
        }
        pending = -1;
        release(&empty[st]);
        continue;
      }
      const uint32_t k_addr = smem_u32(ring + st * 2 * C::TILE);
      const uint32_t v_addr = k_addr + C::TILE;
      // S = Q K^T and dP = dO V^T, two groups, K and V K-major
      float s[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / (CE / 16), w = kk % (CE / 16);
        wgmma_ss(s,
                 gmma_desc(q_addr + c * kT * SW + w * 32, 16, 8 * SW,
                           C::LAYOUT),
                 gmma_desc(k_addr + c * kT * SW + w * 32, 16, 8 * SW,
                           C::LAYOUT),
                 kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / (CE / 16), w = kk % (CE / 16);
        wgmma_ss(dp,
                 gmma_desc(o_addr + c * kT * SW + w * 32, 16, 8 * SW,
                           C::LAYOUT),
                 gmma_desc(v_addr + c * kT * SW + w * 32, 16, 8 * SW,
                           C::LAYOUT),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();   // S, and the previous tile's dQ
      fence_regs(s);
      fence_regs(dq);
      if (pending >= 0) {
        keep(df);
        release(&empty[pending]);
      }

      // P while dP runs; element e: row js[e % 4 >= 2], key t0 + 8 (e /
      // 4) + 2 (lane % 4) + e % 2.  A zero-filled key past Sk adds
      // nothing to dQ, but its P = exp(-lse) could overflow: masked too.
      const bool edge = t0 + kT > a.Sk || (a.causal && t0 + kT - 1 > s0);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int x = e % 4 >= 2;
        const int t = t0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        float p = ex2(fmaf(s[e], a.scale2, -st2[x].x));
        if (edge && (t >= a.Sk || (a.causal && t > pos[x]))) p = 0.f;
        s[e] = p;
      }
      wgmma_wait<0>();   // dP
      fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int e = 8 * kk + 2 * x, r = x % 2;
          df[kk][x] = pack_bf16(s[e] * (dp[e] - st2[r].y),
                                s[e + 1] * (dp[e + 1] - st2[r].y));
        }
      // dQ += dS K: K MN-major, 16 keys a k-step; left running
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dq, df[kk],
                 gmma_desc(k_addr + kk * 16 * SW, kT * SW, 8 * SW,
                           C::LAYOUT));
      wgmma_commit();
      pending = st;
    }
    wgmma_wait<0>();
    fence_regs(dq);
    if (pending >= 0) {
      keep(df);
      release(&empty[pending]);
    }

    // this block ends after the dK/dV pass, so the stream's next work
    // sees dk and dv
    grid_dep_wait();
    if (tile < a.NT) {
      const int g0 = tile % a.HB * a.Gb;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int g = g0 + js[x] % a.Gb;
        if (js[x] >= rows || pos[x] >= a.Sq || g >= a.G) continue;
        __nv_bfloat16* row =
            a.dq + (((static_cast<int64_t>(b) * a.Sq + pos[x]) * a.KV + h) *
                        a.G + g) * HD;
#pragma unroll
        for (int n8 = 0; n8 < HD / 8; ++n8)
          *reinterpret_cast<uint32_t*>(row + n8 * 8 + (lane % 4) * 2) =
              pack_bf16(dq[4 * n8 + 2 * x] * a.scale,
                        dq[4 * n8 + 2 * x + 1] * a.scale);
      }
    }
  }
}

// a 5-d map over (hd, G, KV, S, B) of a bf16 q or dout with element
// strides (1, sg, sk, ss, sb), boxes of (CE, Gb, 1, P, 1): one row tile
template <int HD>
int encode_rows(CUtensorMap* map, const void* ptr, const Args& a,
                long long sb, long long ss, long long sk, long long sg) {
  using C = Cfg<HD>;
  const cuuint64_t dims[5] = {HD, static_cast<cuuint64_t>(a.G),
                              static_cast<cuuint64_t>(a.KV),
                              static_cast<cuuint64_t>(a.Sq),
                              static_cast<cuuint64_t>(a.B)};
  const long long strides[4] = {sg, sk, ss, sb};
  const cuuint32_t box[5] = {C::CE, static_cast<cuuint32_t>(a.Gb), 1,
                             static_cast<cuuint32_t>(a.P), 1};
  return encode_bf16(map, ptr, 5, dims, strides, box, C::SW);
}

template <int HD>
int launch(const Args& a, const StatArgs& sa, const void* q, const void* k,
           const void* v, const long long* st, cudaStream_t stream) {
  using C = Cfg<HD>;
  // st: q (b, s, kv, g), k (b, s, kv), v (b, s, kv), dout (b, s, kv, g)
  CUtensorMap tq, tdo, tk, tv;
  int rc = encode_rows<HD>(&tq, q, a, st[0], st[1], st[2], st[3]);
  if (rc == 0)
    rc = encode_rows<HD>(&tdo, sa.dout, a, st[10], st[11], st[12], st[13]);
  if (rc == 0)
    rc = encode_kv(&tk, k, HD, a.Sk, a.KV, a.B, st[5], st[6], st[4], C::CE,
                   kT, C::SW);
  if (rc == 0)
    rc = encode_kv(&tv, v, HD, a.Sk, a.KV, a.B, st[8], st[9], st[7], C::CE,
                   kT, C::SW);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_A);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_B);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned bh = static_cast<unsigned>(a.B) * a.KV;
  const int64_t threads =
      static_cast<int64_t>(bh) * a.NT * kT * (HD / 8);
  flash_bwd_stats_kernel<HD>
      <<<static_cast<unsigned>((threads + kStatThreads - 1) / kStatThreads),
         kStatThreads, 0, stream>>>(a, sa);
  // (2) and (3) may start while the kernel before them ends
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3((a.Sk + kT - 1) / kT * bh);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::SMEM_A;
  e = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_kernel<HD>, tq, tdo, tk, tv,
                         a);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3((a.NT + C::DQ_WG - 1) / C::DQ_WG * bh);
  cfg.blockDim = dim3(128 * (C::DQ_WG + 1));
  cfg.dynamicSmemBytes = C::SMEM_B;
  e = cudaLaunchKernelEx(&cfg, flash_bwd_dq_kernel<HD>, tq, tdo, tk, tv, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout: bf16 device pointers with a unit innermost stride, the
// other strides (in elements) multiples of 8, 16-byte aligned; out
// contiguous bf16 (B, Sq, KV, G, hd); lse contiguous f32 (B, KV, G, Sq);
// stats: f32 scratch of n_stats (L, D) pairs, n_stats = B KV NT 64 for
// the tiling below (the wrapper's flash_attn.stat_tiling); dq, dk, dv
// contiguous bf16 outputs.
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, void* stats, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int KV, int G, int hd, int causal,
    long long n_stats, long long qb, long long qs, long long qk,
    long long qg, long long kb, long long ks, long long kk, long long vb,
    long long vs, long long vk, long long ob, long long os, long long ok,
    long long og, cudaStream_t stream) {
  // a row tile: P whole positions of Gb heads; HB head blocks a position
  const int Gb = G <= kT ? G : kT;
  const int P = G <= kT ? kT / G : 1;
  const int HB = (G + Gb - 1) / Gb;
  const int NT = (Sq + P - 1) / P * HB;
  if (n_stats != static_cast<long long>(B) * KV * NT * kT)
    return static_cast<int>(cudaErrorInvalidValue);
  const double scale = 1.0 / sqrt(static_cast<double>(hd));
  const Args a{static_cast<const float2*>(stats),
               static_cast<__nv_bfloat16*>(dq),
               static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv), B, Sq, Sk, KV, G, causal, P,
               Gb, HB, NT, static_cast<float>(scale),
               static_cast<float>(scale * 1.4426950408889634)};
  const StatArgs sa{static_cast<const __nv_bfloat16*>(out),
                    static_cast<const __nv_bfloat16*>(dout), lse,
                    static_cast<float2*>(stats), ob, os, ok, og};
  const long long st[14] = {qb, qs, qk, qg, kb, ks, kk,
                            vb, vs, vk, ob, os, ok, og};
  switch (hd) {
    case 32: return launch<32>(a, sa, q, k, v, st, stream);
    case 64: return launch<64>(a, sa, q, k, v, st, stream);
    case 128: return launch<128>(a, sa, q, k, v, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
