// Blockwise GQA flash attention, backward, f32, on Hopper's tensor cores
// (sm_90a): split TF32 products ("3xTF32") by wgmma, fed by TMA,
// deterministic.
//
// flash_attention_bwd_tf32_launch computes, for f32 inputs, the gradient of
// B8's forward (flash_attn_tf32.cu), which replaces the gradient of the
// Pallas TPU kernel src/repro/kernels/flash_attn.py:66 flash_attention:
// that kernel had no backward, JAX differentiates the jnp scan of
// src/repro/models/layers.py:141 attention_flash.  bf16 inputs take
// flash_attn_bwd_sm90.cu.  From the saved q (B, Sq, KV, G, hd), k, v (B,
// Sk, KV, hd), out, lse (natural log, (B, KV, G, Sq)) and the incoming dout
// it computes, in f32 and with positions 0 .. S-1 on both sides,
//     D  = rowsum(dO * O)
//     P  = exp(Q K^T * scale - lse)
//     dV = P^T dO,   dS = P * (dO V^T - D)
//     dQ = dS K * scale,   dK = dS^T Q * scale
// and writes dq, dk, dv contiguous.  q, k, v and dout are read through any
// element strides.
//
// What bounds it: 10 hd operations per visible (row, key) pair (five
// products), 80.6 GFLOP of f32 work at the LM path's shape (smollm-360m: B
// = 4, S = 2048, 15 heads over 5 KV heads, hd = 64, causal): 1.203 ms on
// the CUDA cores (67 TFLOP/s), 0.489 ms as three TF32 products each on the
// tensor cores (495 TFLOP/s), against about 0.04 ms for its bytes.  So
// operations bound it, and only wgmma reaches the TF32 rate; every product
// is split (sm90_tf32.cuh), three TF32 products for each f32 one.
//
// Design: no atomics, every output element summed in one fixed order, so
// two calls give bitwise-equal gradients (remat and resume compare losses
// bit for bit).  Rows are the flattened (position, head) axis of one (b,
// kv) pair, r = s G + g, in tiles of consecutive rows: row r of a tile
// sees key t iff t G <= r, so the causal mask needs no division.
//   (1) split: four launches of tf32_split_kernel write into the scratch
//       q and dout as hi and lo rows (the B operands of S^T = K Q^T and
//       dP^T = V dO^T, the A operands of the dQ pass) and as transposed
//       tiles of R rows (the B operands of dK += dS^T Q and dV += P^T dO),
//       D and lse log2(e) a row in the same order, k as rows (the A
//       operand of S^T, the B operand of S = Q K^T) and as transposed
//       tiles of BQ keys (the B operand of dQ += dS K), v as rows.  That
//       is 4 x the bytes of q, dout and k and 2 x v's (0.3 GB at the LM
//       shape), written once a call.
//   (2) dK/dV: a block per (b, kv, 64 keys): a consumer warpgroup and a
//       producer warpgroup (its first thread issues every TMA).  K and V
//       (hi and lo) are loaded once; the producer keeps the next row tiles'
//       eight tiles (Q, dO, Q^T, dO^T, each hi and lo) and statistics in
//       flight through a ring of full/empty mbarriers.  A row tile: S^T
//       and dP^T as two wgmma groups of three products each, P^T in
//       registers while dP^T runs, dV += P^T dO (P^T split in registers as
//       the A operand), dS^T = P^T (dP^T - D) while dV runs, dK += dS^T Q.
//       Under causal a key tile starts at the row tile of its first key.
//   (3) dQ: a block per (b, kv, 64 W rows), W consumer warpgroups and the
//       producer; Q and dO (hi and lo) loaded once, K, V and K^T streamed
//       through a ring of BQ-key tiles.  A tile: S = Q K^T and dP = dO V^T
//       as two groups, P while dP runs, dS in registers, dQ += dS K.
//       Latest rows first, so the causal tail is short.  This pass
//       recomputes S and dP: 7 products where 5 would do, the price of
//       summing dQ without atomics in a fixed order.
// Every product of a row or key tile sums into a fresh accumulator, which
// one f32 add then takes into dK, dV or dQ (sm90_tf32.cuh, "Sums").
// Shared memory sets the tile sizes.  The dK/dV block keeps 4 tiles of 64
// keys (64 KB at hd 64) and a ring stage holds 8 tiles of R rows; the dQ
// block keeps 4 tiles of 64 rows a warpgroup and a stage holds 6 of BQ
// keys:
//     hd  32: R 32, 4 stages (160 KB); W 2, BQ 32, 4 stages (160 KB)
//     hd  64: R 32, 2 stages (192 KB); W 2, BQ 32, 2 stages (224 KB)
//     hd 128: R 16, 1 stage  (192 KB); W 1, BQ 16, 2 stages (224 KB)
// At hd 128 K and V alone take 128 KB of the dK/dV block, which leaves one
// stage of 16 rows: its loads are not hidden, the cost of keeping the 3
// products' operands whole in shared memory.  Exponentials are MUFU's ex2
// of log2-scaled scores against lse log2(e).
//
// The launcher builds the tensor maps on the host per call, runs on the
// caller's stream, allocates nothing (the wrapper passes the scratch that
// flash_attention_bwd_tf32_scratch sizes), and returns a CUDA error code
// (or kEncodeFailed when the driver refuses a map).
#include <math.h>

#include "sm90_tf32.cuh"

namespace {

using namespace sm90;

constexpr int kT = 64;    // keys a dK/dV block, rows a dQ warpgroup

template <int HD>
struct Cfg {
  static constexpr int NC = HD / 32;               // 128-byte spans of a row
  // (2): R rows a tile, A_ST stages; the transposed tiles' rows are R
  // floats, swizzled to SWR bytes
  static constexpr int R = HD == 128 ? 16 : 32;
  static constexpr int A_ST = HD == 32 ? 4 : HD == 64 ? 2 : 1;
  static constexpr int SWR = R * 4 < 128 ? R * 4 : 128;
  static constexpr int KV_TILE = kT * HD * 4;      // one of K, V; hi or lo
  static constexpr int R_TILE = R * HD * 4;        // one of eight a stage
  static constexpr int SMEM_A = 4 * KV_TILE + A_ST * 8 * R_TILE +
                                A_ST * R * 8 + (2 * A_ST + 1) * 8 + 1024;
  // (3): W consumer warpgroups, BQ keys a tile, B_ST stages; K^T's rows
  // are BQ floats, swizzled to SWQ bytes
  static constexpr int W = HD == 128 ? 1 : 2;
  static constexpr int BQ = HD == 128 ? 16 : 32;
  static constexpr int B_ST = HD == 32 ? 4 : 2;
  static constexpr int SWQ = BQ * 4 < 128 ? BQ * 4 : 128;
  static constexpr int Q_TILE = kT * HD * 4;       // one of Q, dO; hi or lo
  static constexpr int K_TILE = BQ * HD * 4;       // one of six a stage
  static constexpr int SMEM_B = 4 * W * Q_TILE + B_ST * 6 * K_TILE +
                                (2 * B_ST + 1) * 8 + 1024;
};

// the scratch, in floats: q and dout as rows and as transposed tiles (hi
// and lo each), k as rows and as transposed tiles, v as rows, the
// statistics
struct Scratch {
  float *qn, *qt, *on, *ot, *kn, *kt, *vn;
  float2* stats;
  long long NRpad, NKpad, floats;
  Scratch(float* base, int B, int Sq, int Sk, int KV, int G, int hd) {
    const long long bhn = static_cast<long long>(B) * KV;
    NRpad = pad64(static_cast<long long>(Sq) * G);
    NKpad = pad64(Sk);
    const long long rows = 2 * bhn * NRpad * hd, keys = 2 * bhn * NKpad * hd;
    floats = 4 * rows + 3 * keys + 2 * bhn * NRpad;
    qn = base;
    qt = qn + rows;
    on = qt + rows;
    ot = on + rows;
    kn = ot + rows;
    kt = kn + keys;
    vn = kt + keys;
    stats = reinterpret_cast<float2*>(vn + keys);
  }
};

struct Args {
  const float2* stats;   // (L log2 e, D) a row: (b, kv, NRpad)
  float* dq;
  float* dk;
  float* dv;
  int B, Sq, Sk, KV, G, causal;
  int NRpad, NKpad;
  float scale, scale2;   // 1 / sqrt(hd), log2(e) / sqrt(hd)
};

// ---- (2) dK, dV: a block per (b, kv, 64 keys)
template <int HD>
__global__ void __launch_bounds__(256, 1)
flash_bwd_tf32_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tqt,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tdot,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Args a) {
  using C = Cfg<HD>;
  constexpr int NC = C::NC, R = C::R, S = C::A_ST, SWR = C::SWR;
  constexpr int NCR = R * 4 / SWR;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* skv = base;                         // [Khi, Klo, Vhi, Vlo]
  uint8_t* ring = skv + 4 * C::KV_TILE;        // [S][Qhi, Qlo, Ohi, Olo,
                                               //     Qthi, Qtlo, Othi, Otlo]
  float2* sstat = reinterpret_cast<float2*>(ring + S * 8 * C::R_TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(sstat + S * R);
  uint64_t* empty = full + S;
  uint64_t* kvbar = empty + S;

  const int tid = threadIdx.x;
  const int bhn = a.B * a.KV;
  // a 1-d grid, key tile slowest: under causal the first key tiles meet
  // the most rows, and they start first
  const int bh = blockIdx.x % bhn;
  const int k0 = blockIdx.x / bhn * kT;
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.G;
  const int n_row_tiles = static_cast<int>((n_rows + R - 1) / R);
  const int first =
      a.causal ? static_cast<int>(min(static_cast<int64_t>(k0) * a.G, n_rows) / R)
               : 0;
  const int n_tiles = n_row_tiles - first;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);   // the consumer's four warps
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    if (tid == 128) {
      mbar_expect_tx(kvbar, 4 * C::KV_TILE);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = static_cast<int>(
            (x * static_cast<long long>(bhn) + bh) * a.NKpad + k0);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_2d(skv + x * C::KV_TILE + c * kT * 128, &tk, kvbar, c * 32,
                      row);
          tma_load_2d(skv + (2 + x) * C::KV_TILE + c * kT * 128, &tv, kvbar,
                      c * 32, row);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % S;
        if (i >= S) mbar_wait_or_trap(&empty[st], (i / S - 1) & 1);
        uint8_t* s = ring + st * 8 * C::R_TILE;
        const int tile = first + i;
        mbar_expect_tx(&full[st], 8 * C::R_TILE + R * 8);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = static_cast<int>(
              (x * static_cast<long long>(bhn) + bh) * a.NRpad + tile * R);
          const int trow = static_cast<int>(
              ((x * static_cast<long long>(bhn) + bh) * (a.NRpad / R) + tile) *
              HD);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            tma_load_2d(s + x * C::R_TILE + c * R * 128, &tq, &full[st],
                        c * 32, row);
            tma_load_2d(s + (2 + x) * C::R_TILE + c * R * 128, &tdo,
                        &full[st], c * 32, row);
          }
#pragma unroll
          for (int c = 0; c < NCR; ++c) {
            tma_load_2d(s + (4 + x) * C::R_TILE + c * HD * SWR, &tqt,
                        &full[st], c * 32, trow);
            tma_load_2d(s + (6 + x) * C::R_TILE + c * HD * SWR, &tdot,
                        &full[st], c * 32, trow);
          }
        }
        bulk_load(sstat + st * R,
                  a.stats + static_cast<int64_t>(bh) * a.NRpad + tile * R,
                  R * 8, &full[st]);
      }
    }
  } else {
    const int warp = tid / 32, lane = tid % 32;
    // this thread's keys: k0 + m0 and k0 + m0 + 8
    const int m0 = warp * 16 + lane / 4;
    const uint32_t kv_addr = smem_u32(skv);
    const uint32_t ka[2] = {kv_addr, kv_addr + C::KV_TILE};
    const uint32_t va[2] = {kv_addr + 2 * C::KV_TILE,
                            kv_addr + 3 * C::KV_TILE};
    float dk[HD / 2], dv[HD / 2], t[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = t[i] = 0.f;
    uint32_t ph[R / 8][4], pl[R / 8][4], dh[R / 8][4], dl[R / 8][4];
    mbar_wait_or_trap(kvbar, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % S;
      mbar_wait_or_trap(&full[st], (i / S) & 1);
      const uint32_t s_addr = smem_u32(ring + st * 8 * C::R_TILE);
      const float2* stat = sstat + st * R;
      const int r0 = (first + i) * R;

      // S^T = Klo Qhi^T + Khi Qlo^T + Khi Qhi^T and dP^T the same over V
      // and dO, two groups; a k-step of 8 is 32 bytes into a 128-byte span
      float s[R / 2], dp[R / 2];
#pragma unroll
      for (int e = 0; e < R / 2; ++e) s[e] = dp[e] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int y = 0; y < 2; ++y) {   // S^T, then dP^T
        const uint32_t* A = y == 0 ? ka : va;
        const uint32_t B0 = s_addr + 2 * y * C::R_TILE;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const int xa = p == 0 ? 1 : 0, xb = p == 1 ? 1 : 0;
#pragma unroll
          for (int kk = 0; kk < HD / 8; ++kk) {
            const int c = kk / 4, w = kk % 4;
            const uint64_t da =
                gmma_desc(A[xa] + c * kT * 128 + w * 32, 16, 1024, 1);
            const uint64_t db = gmma_desc(
                B0 + xb * C::R_TILE + c * R * 128 + w * 32, 16, 1024, 1);
            if (y == 0) tf32_ss(s, da, db, p > 0 || kk > 0);
            else tf32_ss(dp, da, db, p > 0 || kk > 0);
          }
        }
        wgmma_commit();
      }
      wgmma_wait<1>();   // S^T
      fence_regs(s);

      // P^T while dP^T runs; element e of s is key k0 + m0 (+ 8 if
      // e % 4 >= 2) and tile row j = 8 (e / 4) + 2 (lane % 4) + e % 2, row
      // r0 + j, which sees key t iff t G <= r0 + j.  Pad rows have lse
      // +inf, so P vanishes there.
      const bool edge =
          a.causal && static_cast<int64_t>(k0 + kT - 1) * a.G > r0;
      const int lim = (k0 + m0) * a.G - r0;
#pragma unroll
      for (int e = 0; e < R / 2; ++e) {
        const int j = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        float p = ex2(fmaf(s[e], a.scale2, -stat[j].x));
        if (edge && lim + (e % 4 >= 2 ? 8 * a.G : 0) > j) p = 0.f;
        s[e] = p;
      }
#pragma unroll
      for (int kk = 0; kk < R / 8; ++kk) tf32_frag(s + 4 * kk, ph[kk], pl[kk]);
      // dV += Plo^T dOthi + Phi^T dOtlo + Phi^T dOthi: dO^T K-major, 8
      // rows a k-step
      const uint32_t ot[2] = {s_addr + 6 * C::R_TILE, s_addr + 7 * C::R_TILE};
      // each product's tile sum goes to t, then into dV or dK by one f32
      // add rounded to nearest (sm90_tf32.cuh)
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) t[i] = 0.f;
      fence_regs(t);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int xb = p == 1 ? 1 : 0;
#pragma unroll
        for (int kk = 0; kk < R / 8; ++kk) {
          const int c = kk / (SWR / 32), w = kk % (SWR / 32);
          const uint64_t db = gmma_desc(ot[xb] + c * HD * SWR + w * 32, 16,
                                        8 * SWR, swizzle_layout(SWR));
          if (p == 0) tf32_rs(t, pl[kk], db);
          else tf32_rs(t, ph[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();   // dP^T (dV may still run)
      fence_regs(dp);

      // dS^T = P^T (dP^T - D), then dK += dS^T Q
#pragma unroll
      for (int e = 0; e < R / 2; ++e) {
        const int j = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        dp[e] = s[e] * (dp[e] - stat[j].y);
      }
#pragma unroll
      for (int kk = 0; kk < R / 8; ++kk)
        tf32_frag(dp + 4 * kk, dh[kk], dl[kk]);
      const uint32_t qt[2] = {s_addr + 4 * C::R_TILE, s_addr + 5 * C::R_TILE};
      wgmma_wait<0>();   // dV's tile sum
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        dv[i] += t[i];
        t[i] = 0.f;
      }
      fence_regs(t);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int xb = p == 1 ? 1 : 0;
#pragma unroll
        for (int kk = 0; kk < R / 8; ++kk) {
          const int c = kk / (SWR / 32), w = kk % (SWR / 32);
          const uint64_t db = gmma_desc(qt[xb] + c * HD * SWR + w * 32, 16,
                                        8 * SWR, swizzle_layout(SWR));
          if (p == 0) tf32_rs(t, dl[kk], db);
          else tf32_rs(t, dh[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dk[i] += t[i];
      keep(ph);
      keep(pl);
      keep(dh);
      keep(dl);
      release(&empty[st]);
    }

    // keys past Sk are not written
    const int b = bh / a.KV, h = bh % a.KV;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int key = k0 + m0 + 8 * x;
      if (key >= a.Sk) continue;
      const int64_t row = ((static_cast<int64_t>(b) * a.Sk + key) * a.KV + h) *
                          HD;
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        const int col = n8 * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(a.dk + row + col) =
            make_float2(dk[4 * n8 + 2 * x] * a.scale,
                        dk[4 * n8 + 2 * x + 1] * a.scale);
        *reinterpret_cast<float2*>(a.dv + row + col) =
            make_float2(dv[4 * n8 + 2 * x], dv[4 * n8 + 2 * x + 1]);
      }
    }
  }
}

// ---- (3) dQ: a block per (b, kv, 64 W rows)
template <int HD>
__global__ void __launch_bounds__(128 * (Cfg<HD>::W + 1), 1)
flash_bwd_tf32_dq_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tkt,
                         const Args a) {
  using C = Cfg<HD>;
  constexpr int NC = C::NC, W = C::W, BQ = C::BQ, S = C::B_ST;
  constexpr int SWQ = C::SWQ, NCQ = BQ * 4 / SWQ, PRODUCER = 128 * W;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;                        // [W][Qhi, Qlo, Ohi, Olo]
  uint8_t* ring = sq + 4 * W * C::Q_TILE;    // [S][Khi, Klo, Vhi, Vlo,
                                             //     Kthi, Ktlo]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * 6 * C::K_TILE);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int tid = threadIdx.x;
  const int bhn = a.B * a.KV;
  const int bh = blockIdx.x % bhn;
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.G;
  // a 1-d grid, row blocks slowest and the longest (latest) first
  const int64_t n_blocks = (n_rows + 64 * W - 1) / (64 * W);
  const int64_t row0 = (n_blocks - 1 - blockIdx.x / bhn) * 64 * W;
  auto row_keys = [&](int64_t r0) {   // keys rows r0 .. r0 + 63 see
    if (r0 >= n_rows) return 0;
    const int64_t last = min(r0 + 64, n_rows) - 1;
    return a.causal ? min(a.Sk, static_cast<int>(last / a.G) + 1) : a.Sk;
  };
  int n_keys = 0;
  for (int w = 0; w < W; ++w) n_keys = max(n_keys, row_keys(row0 + 64 * w));
  const int n_tiles = (n_keys + BQ - 1) / BQ;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * W);   // every consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= PRODUCER) {
    if constexpr (W > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == PRODUCER) {
      mbar_expect_tx(qbar, 4 * W * C::Q_TILE);
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = static_cast<int>(
              (x * static_cast<long long>(bhn) + bh) * a.NRpad + row0 +
              64 * w);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            tma_load_2d(sq + (4 * w + x) * C::Q_TILE + c * kT * 128, &tq,
                        qbar, c * 32, row);
            tma_load_2d(sq + (4 * w + 2 + x) * C::Q_TILE + c * kT * 128, &tdo,
                        qbar, c * 32, row);
          }
        }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % S;
        if (j >= S) mbar_wait_or_trap(&empty[st], (j / S - 1) & 1);
        uint8_t* s = ring + st * 6 * C::K_TILE;
        mbar_expect_tx(&full[st], 6 * C::K_TILE);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = static_cast<int>(
              (x * static_cast<long long>(bhn) + bh) * a.NKpad + j * BQ);
          const int trow = static_cast<int>(
              ((x * static_cast<long long>(bhn) + bh) * (a.NKpad / BQ) + j) *
              HD);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            tma_load_2d(s + x * C::K_TILE + c * BQ * 128, &tk, &full[st],
                        c * 32, row);
            tma_load_2d(s + (2 + x) * C::K_TILE + c * BQ * 128, &tv,
                        &full[st], c * 32, row);
          }
#pragma unroll
          for (int c = 0; c < NCQ; ++c)
            tma_load_2d(s + (4 + x) * C::K_TILE + c * HD * SWQ, &tkt,
                        &full[st], c * 32, trow);
        }
      }
    }
  } else {
    if constexpr (W > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int64_t wrow0 = row0 + 64 * cw;
    const int wkeys = row_keys(wrow0);
    // this thread's rows: rs[0] and rs[0] + 8, their positions and
    // statistics
    const int64_t rs[2] = {wrow0 + warp * 16 + lane / 4,
                           wrow0 + warp * 16 + lane / 4 + 8};
    float2 st2[2];
    int pos[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      st2[x] = rs[x] < a.NRpad ? a.stats[static_cast<int64_t>(bh) * a.NRpad +
                                         rs[x]]
                               : make_float2(INFINITY, 0.f);
      pos[x] = static_cast<int>(rs[x] / a.G);
    }
    const uint32_t q_addr = smem_u32(sq + 4 * cw * C::Q_TILE);
    const uint32_t qa[2] = {q_addr, q_addr + C::Q_TILE};
    const uint32_t oa[2] = {q_addr + 2 * C::Q_TILE, q_addr + 3 * C::Q_TILE};
    if (wkeys > 0) mbar_wait_or_trap(qbar, 0);
    float dq[HD / 2], t[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = t[i] = 0.f;
    uint32_t dh[BQ / 8][4], dl[BQ / 8][4];

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S;
      // every consumer waits for every stage, so that none runs a phase
      // ahead on the empty barrier, and computes only up to its keys
      mbar_wait_or_trap(&full[st], (j / S) & 1);
      const int t0 = j * BQ;
      if (t0 >= wkeys) {
        release(&empty[st]);
        continue;
      }
      const uint32_t s_addr = smem_u32(ring + st * 6 * C::K_TILE);
      // S = Q K^T and dP = dO V^T, two groups of three products
      float s[BQ / 2], dp[BQ / 2];
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) s[e] = dp[e] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int y = 0; y < 2; ++y) {   // S, then dP
        const uint32_t* A = y == 0 ? qa : oa;
        const uint32_t B0 = s_addr + 2 * y * C::K_TILE;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const int xa = p == 0 ? 1 : 0, xb = p == 1 ? 1 : 0;
#pragma unroll
          for (int kk = 0; kk < HD / 8; ++kk) {
            const int c = kk / 4, w = kk % 4;
            const uint64_t da =
                gmma_desc(A[xa] + c * kT * 128 + w * 32, 16, 1024, 1);
            const uint64_t db = gmma_desc(
                B0 + xb * C::K_TILE + c * BQ * 128 + w * 32, 16, 1024, 1);
            if (y == 0) tf32_ss(s, da, db, p > 0 || kk > 0);
            else tf32_ss(dp, da, db, p > 0 || kk > 0);
          }
        }
        wgmma_commit();
      }
      wgmma_wait<1>();   // S
      fence_regs(s);

      // P while dP runs; element e: row rs[e % 4 >= 2], key t0 + 8 (e /
      // 4) + 2 (lane % 4) + e % 2.  A zero-filled key past Sk adds nothing
      // to dQ, but its P = exp(-lse) could overflow: masked too.
      const bool edge = t0 + BQ > a.Sk || (a.causal && t0 + BQ - 1 > wrow0 / a.G);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int x = e % 4 >= 2;
        const int t = t0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
        float p = ex2(fmaf(s[e], a.scale2, -st2[x].x));
        if (edge && (t >= a.Sk || (a.causal && t > pos[x]))) p = 0.f;
        s[e] = p;
      }
      wgmma_wait<0>();   // dP
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e)
        dp[e] = s[e] * (dp[e] - st2[e % 4 >= 2].y);
#pragma unroll
      for (int kk = 0; kk < BQ / 8; ++kk)
        tf32_frag(dp + 4 * kk, dh[kk], dl[kk]);
      // dQ += dSlo Kthi + dShi Ktlo + dShi Kthi: K^T K-major, 8 keys a
      // k-step
      const uint32_t kt[2] = {s_addr + 4 * C::K_TILE, s_addr + 5 * C::K_TILE};
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) t[i] = 0.f;
      fence_regs(t);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int xb = p == 1 ? 1 : 0;
#pragma unroll
        for (int kk = 0; kk < BQ / 8; ++kk) {
          const int c = kk / (SWQ / 32), w = kk % (SWQ / 32);
          const uint64_t db = gmma_desc(kt[xb] + c * HD * SWQ + w * 32, 16,
                                        8 * SWQ, swizzle_layout(SWQ));
          if (p == 0) tf32_rs(t, dl[kk], db);
          else tf32_rs(t, dh[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dq[i] += t[i];
      keep(dh);
      keep(dl);
      release(&empty[st]);
    }

    const int b = bh / a.KV, h = bh % a.KV;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (rs[x] >= n_rows) continue;
      const int64_t g = rs[x] % a.G;
      float* row = a.dq + (((static_cast<int64_t>(b) * a.Sq + pos[x]) * a.KV +
                            h) * a.G + g) * HD;
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8)
        *reinterpret_cast<float2*>(row + n8 * 8 + (lane % 4) * 2) =
            make_float2(dq[4 * n8 + 2 * x] * a.scale,
                        dq[4 * n8 + 2 * x + 1] * a.scale);
    }
  }
}

template <int HD>
int launch(const Args& a0, const float* q, const float* k, const float* v,
           const float* out, const float* dout, const float* lse,
           float* scratch, const long long* st, cudaStream_t stream) {
  using C = Cfg<HD>;
  // st: q (b, s, kv, g, hd), k (b, s, kv, hd), v (b, s, kv, hd), dout
  // (b, s, kv, g, hd)
  const Scratch sc(scratch, a0.B, a0.Sq, a0.Sk, a0.KV, a0.G, HD);
  Args a = a0;
  a.stats = sc.stats;
  a.NRpad = static_cast<int>(sc.NRpad);
  a.NKpad = static_cast<int>(sc.NKpad);
  const long long bhn = static_cast<long long>(a.B) * a.KV;
  // TMA's coordinates are ints
  if (2 * bhn * (sc.NRpad > sc.NKpad ? sc.NRpad : sc.NKpad) * HD >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);

  const SplitArgs splits[4] = {
      {q, st[0], st[1], st[2], st[3], st[4], a.B, a.Sq, a.KV, a.G, a.NRpad,
       C::R, sc.qn, sc.qt, nullptr, nullptr, nullptr},
      {dout, st[13], st[14], st[15], st[16], st[17], a.B, a.Sq, a.KV, a.G,
       a.NRpad, C::R, sc.on, sc.ot, out, lse, sc.stats},
      {k, st[5], st[6], st[7], 0, st[8], a.B, a.Sk, a.KV, 1, a.NKpad, C::BQ,
       sc.kn, sc.kt, nullptr, nullptr, nullptr},
      {v, st[9], st[10], st[11], 0, st[12], a.B, a.Sk, a.KV, 1, a.NKpad,
       C::BQ, sc.vn, nullptr, nullptr, nullptr, nullptr}};
  for (const SplitArgs& s : splits) {
    const int rc = launch_split<HD>(s, stream);
    if (rc != 0) return rc;
  }

  const long long rows = 2 * bhn * sc.NRpad, keys = 2 * bhn * sc.NKpad;
  CUtensorMap tq, tqt, tdo, tdot, tk, tv, tq64, tdo64, tkq, tvq, tkt;
  int rc = 0;
  // (2): Q, dO as R-row boxes and their transposed tiles; K, V 64 keys
  if (rc == 0) rc = encode_f32_2d(&tq, sc.qn, HD, rows, 32, C::R);
  if (rc == 0) rc = encode_f32_2d(&tdo, sc.on, HD, rows, 32, C::R);
  if (rc == 0)
    rc = encode_f32_2d(&tqt, sc.qt, C::R, rows * HD / C::R, C::SWR / 4, HD);
  if (rc == 0)
    rc = encode_f32_2d(&tdot, sc.ot, C::R, rows * HD / C::R, C::SWR / 4, HD);
  if (rc == 0) rc = encode_f32_2d(&tk, sc.kn, HD, keys, 32, kT);
  if (rc == 0) rc = encode_f32_2d(&tv, sc.vn, HD, keys, 32, kT);
  // (3): Q, dO 64 rows; K, V BQ keys and K's transposed tiles
  if (rc == 0) rc = encode_f32_2d(&tq64, sc.qn, HD, rows, 32, kT);
  if (rc == 0) rc = encode_f32_2d(&tdo64, sc.on, HD, rows, 32, kT);
  if (rc == 0) rc = encode_f32_2d(&tkq, sc.kn, HD, keys, 32, C::BQ);
  if (rc == 0) rc = encode_f32_2d(&tvq, sc.vn, HD, keys, 32, C::BQ);
  if (rc == 0)
    rc = encode_f32_2d(&tkt, sc.kt, C::BQ, keys * HD / C::BQ, C::SWQ / 4, HD);
  if (rc != 0) return rc;

  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_tf32_dkdv_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_A);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_tf32_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_B);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_tf32_dkdv_kernel<HD>
      <<<static_cast<unsigned>(sc.NKpad / kT * bhn), 256, C::SMEM_A,
         stream>>>(tq, tqt, tdo, tdot, tk, tv, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_rows = static_cast<long long>(a.Sq) * a.G;
  flash_bwd_tf32_dq_kernel<HD>
      <<<static_cast<unsigned>((n_rows + 64 * C::W - 1) / (64 * C::W) * bhn),
         128 * (C::W + 1), C::SMEM_B, stream>>>(tq64, tdo64, tkq, tvq, tkt,
                                                a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 scratch (in floats) that flash_attention_bwd_tf32_launch needs
extern "C" long long flash_attention_bwd_tf32_scratch(int B, int Sq, int Sk,
                                                      int KV, int G, int hd) {
  if (hd != 32 && hd != 64 && hd != 128) return -1;
  const long long bhn = static_cast<long long>(B) * KV;
  return (2 * pad64(static_cast<long long>(Sq) * G) * (4 * hd + 1) +
          6 * pad64(Sk) * hd) * bhn;
}

// q, k, v, dout: f32 device pointers with any element strides; out
// contiguous f32 (B, Sq, KV, G, hd); lse contiguous f32 (B, KV, G, Sq);
// scratch: flash_attention_bwd_tf32_scratch floats, 16-byte aligned; dq,
// dk, dv contiguous f32 outputs.
extern "C" int flash_attention_bwd_tf32_launch(
    const float* q, const float* k, const float* v, const float* out,
    const float* dout, const float* lse, float* scratch, float* dq, float* dk,
    float* dv, int B, int Sq, int Sk, int KV, int G, int hd, int causal,
    long long qb, long long qs, long long qk, long long qg, long long qd,
    long long kb, long long ks, long long kk, long long kd, long long vb,
    long long vs, long long vk, long long vd, long long ob, long long os,
    long long ok, long long og, long long od, cudaStream_t stream) {
  const double scale = 1.0 / sqrt(static_cast<double>(hd));
  const Args a{nullptr, dq, dk, dv, B, Sq, Sk, KV, G, causal, 0, 0,
               static_cast<float>(scale),
               static_cast<float>(scale * 1.4426950408889634)};
  const long long st[18] = {qb, qs, qk, qg, qd, kb, ks, kk, kd,
                            vb, vs, vk, vd, ob, os, ok, og, od};
  switch (hd) {
    case 32: return launch<32>(a, q, k, v, out, dout, lse, scratch, st, stream);
    case 64: return launch<64>(a, q, k, v, out, dout, lse, scratch, st, stream);
    case 128:
      return launch<128>(a, q, k, v, out, dout, lse, scratch, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
