// Blockwise GQA flash attention, forward, f32, on Hopper's tensor cores
// (sm_90a): split TF32 products ("3xTF32") by wgmma, fed by TMA.
//
// flash_attention_tf32_launch replaces, for f32 inputs, the Pallas TPU
// kernel src/repro/kernels/flash_attn.py:66 flash_attention (_kernel); bf16
// inputs take flash_attn_sm90.cu.  It computes what that kernel computes:
// for q (B, Sq, KV, G, hd) and k, v (B, Sk, KV, hd), every query row (b, s,
// kv, g) is
//     out = softmax_t(q . k_t / sqrt(hd)) v_t   over t <= s (causal) or all t
//     lse = log sum_t exp(q . k_t / sqrt(hd))   (natural log)
// with out contiguous (B, Sq, KV, G, hd) and lse contiguous (B, KV, G, Sq),
// both f32; positions 0 .. S-1 on both sides, Sq != Sk allowed, q, k and v
// read through any element strides.
//
// What bounds it: at the LM path's shape (smollm-360m, B = 4, S = 2048, 15
// heads over 5 KV heads, hd = 64, causal) it needs 4 hd operations per
// (query row, visible key) pair, 32.2 GFLOP of f32 work.  On the CUDA cores
// (67 TFLOP/s) that is 0.481 ms; as three TF32 products on the tensor cores
// (495 TFLOP/s) 0.195 ms; its 63 MB at 3.35 TB/s take 0.019 ms.  So
// operations bound it, and only wgmma reaches the TF32 rate: a product
// that must stay f32-accurate is split (sm90_tf32.cuh), three TF32
// products for each f32 one.
//
// Design.  (1) tf32_split_kernel writes k's hi and lo as rows ("natural":
// the B operand of S = Q K^T) and v's transposed, 64 (hd 128: 32) keys a
// tile, key j of each 8 at column kpos(j) (the B operand of O += P V,
// whose register A operand P comes straight from S's accumulator): 4 x
// the bytes of k and v, written once a call.  (2) The attention: a block
// takes 64 W consecutive rows of the flattened (position, head) axis of
// one (b, kv) pair, 64 for each of its W consumer warpgroups, so all G
// query heads of a position share every K/V tile whatever G is; a
// producer warpgroup (setmaxnreg 24; its first thread issues every TMA, a
// whole warpgroup because setmaxnreg acts on warpgroups) streams K hi, K
// lo, V^T hi and V^T lo through a ring of full/empty mbarriers.  The
// consumers load their Q rows once by threads (any strides), split, into
// the 128-byte swizzled layout TMA would write.  A tile: S = Qlo Khi +
// Qhi Klo + Qhi Khi (wgmma.m64nBNk8, both operands from shared memory),
// the online softmax in f32 with exp2f of log2-scaled scores, P split in
// registers, the tile's P V = Plo Vthi + Phi Vtlo + Phi Vthi (P the
// register A operand) into a fresh accumulator, then O = O corr + P V in
// f32 (sm90_tf32.cuh, "Sums").  Causal: a block reads keys only up to its
// last row's position, a warpgroup computes only up to its own, and only
// tiles that cross its diagonal (or the ragged end) are masked.  Shared
// memory sets the tile sizes: Q's hi and lo are 32 KB a warpgroup at hd
// 64, a ring stage (K and V^T, hi and lo) 64 KB at 64 keys:
//     hd  32: W 2, 64 keys a tile, 4 stages: 160 KB
//     hd  64: W 2, 64 keys a tile, 2 stages: 192 KB
//     hd 128: W 1, 32 keys a tile, 2 stages: 192 KB (Q alone is 64 KB a
//             warpgroup; two would leave room for one stage, no prefetch)
// Three TF32 products for each f32 one are the price of the split; the
// scratch of (1) and the ring's fourfold tiles are the price of splitting
// once per call rather than once per tile and block.
//
// The launcher builds the tensor maps on the host per call
// (cuTensorMapEncodeTiled, fetched from the driver with dlsym), runs on the
// caller's stream, allocates nothing (the wrapper passes the scratch that
// flash_attention_tf32_scratch sizes), and returns a CUDA error code (or
// kEncodeFailed when the driver refuses a map).
#include <math.h>

#include "sm90_tf32.cuh"

namespace {

using namespace sm90;

constexpr float kLn2 = 0.69314718055994530942f;

template <int HD>
struct Cfg {
  static constexpr int W = HD == 128 ? 1 : 2;    // consumer warpgroups
  static constexpr int BN = HD == 128 ? 32 : 64;  // keys a tile
  static constexpr int ST = HD == 32 ? 4 : 2;     // ring stages
  static constexpr int NC = HD / 32;              // 128-byte spans of a row
  static constexpr int SWV = BN * 4 < 128 ? BN * 4 : 128;  // V^T's span
  static constexpr int NCV = BN * 4 / SWV;
  static constexpr int Q_TILE = 64 * HD * 4;      // one of Q hi, Q lo
  static constexpr int K_TILE = BN * HD * 4;      // one of K or V^T, hi or lo
  static constexpr int STAGE = 4 * K_TILE;
  static constexpr int SMEM = 2 * W * Q_TILE + ST * STAGE + 2 * ST * 8 + 1024;
  static constexpr int THREADS = 128 * (W + 1);
};

struct Args {
  const float* q;
  float* out;
  float* lse;
  int B, Sq, Sk, KV, G, causal;
  long long NKpad;       // padded keys of a (b, kv) pair in the scratch
  float scale2;          // log2(e) / sqrt(hd)
  int64_t qb, qs, qk, qg, qd;  // q's element strides
};

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tvt,
                            const Args a) {
  using C = Cfg<HD>;
  constexpr int W = C::W, BN = C::BN, ST = C::ST, NC = C::NC;
  constexpr int SWV = C::SWV, NCV = C::NCV, PRODUCER = 128 * W;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;                        // [W][hi, lo][NC][64][128]
  uint8_t* ring = sq + 2 * W * C::Q_TILE;    // [ST][Khi, Klo, Vthi, Vtlo]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * C::STAGE);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x;
  const int bhn = a.B * a.KV;
  const int bh = blockIdx.x % bhn;
  const int h = bh % a.KV, b = bh / a.KV;
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.G;
  // a 1-d grid, row tile slowest and the longest (latest) tiles first, so
  // that the causal tail is short
  const int64_t row0 = ((n_rows + 64 * W - 1) / (64 * W) - 1 -
                        blockIdx.x / bhn) * 64 * W;
  const int64_t last = min(row0 + 64 * W, n_rows) - 1;
  const int n_keys =
      a.causal ? min(a.Sk, static_cast<int>(last / a.G) + 1) : a.Sk;
  const int n_tiles = (n_keys + BN - 1) / BN;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * W);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= PRODUCER) {
    if constexpr (W > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == PRODUCER) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % ST;
        if (j >= ST) mbar_wait_or_trap(&empty[st], (j / ST - 1) & 1);
        uint8_t* s = ring + st * C::STAGE;
        mbar_expect_tx(&full[st], C::STAGE);
#pragma unroll
        for (int x = 0; x < 2; ++x) {   // hi, lo
          const int krow = static_cast<int>(
              (x * static_cast<long long>(bhn) + bh) * a.NKpad + j * BN);
          const int vrow = static_cast<int>(
              ((x * static_cast<long long>(bhn) + bh) * (a.NKpad / BN) + j) *
              HD);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_2d(s + x * C::K_TILE + c * BN * 128, &tk, &full[st],
                        c * 32, krow);
#pragma unroll
          for (int c = 0; c < NCV; ++c)
            tma_load_2d(s + (2 + x) * C::K_TILE + c * HD * SWV, &tvt,
                        &full[st], c * 32, vrow);
        }
      }
    }
  } else {
    if constexpr (W > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128, t = tid % 128;
    const int warp = t / 32, lane = t % 32;
    uint8_t* q_hi = sq + 2 * cw * C::Q_TILE;
    uint8_t* q_lo = q_hi + C::Q_TILE;
    const int64_t wrow0 = row0 + 64 * cw;

    // this warpgroup's Q rows by its threads, split, into TMA's swizzled
    // layout; rows past the end are zeros
    for (int e = t; e < 64 * HD; e += 128) {
      const int row = e / HD, d = e % HD;
      const int64_t r = wrow0 + row;
      float x = 0.f;
      if (r < n_rows) {
        const int64_t s = r / a.G, g = r % a.G;
        x = a.q[b * a.qb + s * a.qs + h * a.qk + g * a.qg + d * a.qd];
      }
      float hi, lo;
      tf32_split(x, hi, lo);
      const uint32_t off = (d / 32) * 64 * 128 +
                           swizzle<128>(row * 128 + (d % 32) * 4);
      *reinterpret_cast<float*>(q_hi + off) = hi;
      *reinterpret_cast<float*>(q_lo + off) = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + cw, 128);

    // a thread holds rows rA and rA + 8
    const bool has_rows = wrow0 < n_rows;
    const int64_t wlast = min(wrow0 + 64, n_rows) - 1;
    const int wkeys = !has_rows ? 0
                      : a.causal ? min(a.Sk, static_cast<int>(wlast / a.G) + 1)
                                 : a.Sk;
    const int wfirst = static_cast<int>(wrow0 / a.G);
    const int64_t rA = wrow0 + warp * 16 + lane / 4, rB = rA + 8;
    const int posA = static_cast<int>(rA / a.G);
    const int posB = static_cast<int>(rB / a.G);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;
    const uint32_t qa[2] = {smem_u32(q_hi), smem_u32(q_lo)};
    uint32_t ph[BN / 8][4], pl[BN / 8][4];

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % ST;
      // every consumer waits for every stage, so that none runs a phase
      // ahead on the empty barrier, and computes only up to its keys
      mbar_wait_or_trap(&full[st], (j / ST) & 1);
      const int k0 = j * BN;
      if (k0 >= wkeys) {
        release(&empty[st]);
        continue;
      }
      const uint32_t s_addr = smem_u32(ring + st * C::STAGE);
      const uint32_t ka[2] = {s_addr, s_addr + C::K_TILE};
      const uint32_t va[2] = {s_addr + 2 * C::K_TILE, s_addr + 3 * C::K_TILE};

      // S = Qlo Khi + Qhi Klo + Qhi Khi: a k-step of 8 is 32 bytes into a
      // 128-byte span
      float s[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int xq = p == 0 ? 1 : 0, xk = p == 1 ? 1 : 0;
#pragma unroll
        for (int kk = 0; kk < HD / 8; ++kk) {
          const int c = kk / 4, w = kk % 4;
          tf32_ss(s,
                  gmma_desc(qa[xq] + c * 64 * 128 + w * 32, 16, 1024, 1),
                  gmma_desc(ka[xk] + c * BN * 128 + w * 32, 16, 1024, 1),
                  p > 0 || kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // online softmax; element i of s is row rA (i % 4 < 2) or rB, key
      // k0 + 8 (i / 4) + 2 (lane % 4) + (i % 2)
      const bool edge = k0 + BN > a.Sk || (a.causal && k0 + BN - 1 > wfirst);
      float mxA = -INFINITY, mxB = -INFINITY;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = s[i] * a.scale2;
        if (edge) {
          const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
          const int pos = i % 4 < 2 ? posA : posB;
          if (col >= a.Sk || (a.causal && col > pos)) x = -INFINITY;
        }
        s[i] = x;
        if (i % 4 < 2) mxA = fmaxf(mxA, x);
        else mxB = fmaxf(mxB, x);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
        mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
      }
      const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
      // a row sees key 0 in its first tile, so mn is finite from then on
      const float refA = mnA == -INFINITY ? 0.f : mnA;
      const float refB = mnB == -INFINITY ? 0.f : mnB;
      const float corrA = exp2f(mA - refA), corrB = exp2f(mB - refB);
      float sumA = 0.f, sumB = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        if (i % 4 < 2) {
          s[i] = exp2f(s[i] - refA);
          sumA += s[i];
        } else {
          s[i] = exp2f(s[i] - refB);
          sumB += s[i];
        }
      }
      lA = lA * corrA + sumA;
      lB = lB * corrB + sumB;
      mA = mnA;
      mB = mnB;

      // P split, as the A fragments of the k-steps over the tile's keys
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) tf32_frag(s + 4 * kk, ph[kk], pl[kk]);
      // this tile's P V = Plo Vthi + Phi Vtlo + Phi Vthi: V^T K-major, 8
      // keys a k-step
      float pv[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) pv[i] = 0.f;
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int xv = p == 1 ? 1 : 0;
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
          const int c = kk / (SWV / 32), w = kk % (SWV / 32);
          const uint64_t dv = gmma_desc(va[xv] + c * HD * SWV + w * 32, 16,
                                        8 * SWV, swizzle_layout(SWV));
          if (p == 0) tf32_rs(pv, pl[kk], dv);
          else tf32_rs(pv, ph[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
      // the tensor core sums the tile's 3 BN / 8 k-steps; O takes that sum
      // in one f32 operation a tile, rounded to nearest (sm90_tf32.cuh)
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        o[i] = fmaf(o[i], i % 4 < 2 ? corrA : corrB, pv[i]);
      keep(ph);
      keep(pl);
      release(&empty[st]);
    }

    if (has_rows) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        lA += __shfl_xor_sync(0xffffffffu, lA, off);
        lB += __shfl_xor_sync(0xffffffffu, lB, off);
      }
      const float invA = 1.f / lA, invB = 1.f / lB;
      auto out_row = [&](int64_t r) {
        const int64_t s = r / a.G, g = r % a.G;
        return a.out +
               (((b * static_cast<int64_t>(a.Sq) + s) * a.KV + h) * a.G + g) *
                   HD;
      };
      float* oA = out_row(rA);
      float* oB = out_row(rB);
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        const int col = n8 * 8 + (lane % 4) * 2;
        if (rA < n_rows)
          *reinterpret_cast<float2*>(oA + col) =
              make_float2(o[4 * n8] * invA, o[4 * n8 + 1] * invA);
        if (rB < n_rows)
          *reinterpret_cast<float2*>(oB + col) =
              make_float2(o[4 * n8 + 2] * invB, o[4 * n8 + 3] * invB);
      }
      if (lane % 4 == 0) {
        const int64_t lse0 = (static_cast<int64_t>(b) * a.KV + h) * a.G;
        if (rA < n_rows)
          a.lse[(lse0 + rA % a.G) * a.Sq + posA] = (mA + log2f(lA)) * kLn2;
        if (rB < n_rows)
          a.lse[(lse0 + rB % a.G) * a.Sq + posB] = (mB + log2f(lB)) * kLn2;
      }
    }
  }
}

template <int HD>
long long scratch_floats(int B, int Sk, int KV) {
  // k's hi and lo as rows, v's as transposed tiles
  return 4LL * B * KV * pad64(Sk) * HD;
}

template <int HD>
int launch(const Args& a, const float* k, const float* v, float* scratch,
           const long long* ks, const long long* vs, cudaStream_t stream) {
  using C = Cfg<HD>;
  const long long bhn = static_cast<long long>(a.B) * a.KV;
  float* kn = scratch;
  float* vt = scratch + 2 * bhn * a.NKpad * HD;
  if (2 * bhn * a.NKpad * HD >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);  // TMA's int coordinates
  SplitArgs sk{k, ks[0], ks[1], ks[2], 0, ks[3], a.B, a.Sk, a.KV, 1,
               static_cast<int>(a.NKpad), C::BN, kn, nullptr, nullptr,
               nullptr, nullptr};
  int rc = launch_split<HD>(sk, stream);
  if (rc != 0) return rc;
  SplitArgs sv{v, vs[0], vs[1], vs[2], 0, vs[3], a.B, a.Sk, a.KV, 1,
               static_cast<int>(a.NKpad), C::BN, nullptr, vt, nullptr,
               nullptr, nullptr};
  rc = launch_split<HD>(sv, stream);
  if (rc != 0) return rc;

  CUtensorMap tk, tvt;
  rc = encode_f32_2d(&tk, kn, HD, 2 * bhn * a.NKpad, 32, C::BN);
  if (rc == 0)
    rc = encode_f32_2d(&tvt, vt, C::BN, 2 * bhn * a.NKpad * HD / C::BN,
                       C::SWV / 4, HD);
  if (rc != 0) return rc;
  auto kernel = flash_attention_tf32_kernel<HD>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.G;
  const unsigned grid =
      static_cast<unsigned>((n_rows + 64 * C::W - 1) / (64 * C::W)) * a.B *
      a.KV;
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(tk, tvt, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 scratch (in floats) that flash_attention_tf32_launch needs
extern "C" long long flash_attention_tf32_scratch(int B, int Sq, int Sk,
                                                  int KV, int G, int hd) {
  (void)Sq;
  (void)G;
  switch (hd) {
    case 32: return scratch_floats<32>(B, Sk, KV);
    case 64: return scratch_floats<64>(B, Sk, KV);
    case 128: return scratch_floats<128>(B, Sk, KV);
    default: return -1;
  }
}

// q, k, v: f32 device pointers with any element strides (q: b, s, kv, g,
// hd; k, v: b, s, kv, hd); out contiguous f32 (B, Sq, KV, G, hd); lse
// contiguous f32 (B, KV, G, Sq); scratch: flash_attention_tf32_scratch
// floats, 16-byte aligned.
extern "C" int flash_attention_tf32_launch(
    const float* q, const float* k, const float* v, float* out, float* lse,
    float* scratch, int B, int Sq, int Sk, int KV, int G, int hd, int causal,
    long long qb, long long qs, long long qk, long long qg, long long qd,
    long long kb, long long ks, long long kk, long long kd, long long vb,
    long long vs, long long vk, long long vd, cudaStream_t stream) {
  const Args a{q, out, lse, B, Sq, Sk, KV, G, causal, pad64(Sk),
               static_cast<float>(1.4426950408889634 /
                                  sqrt(static_cast<double>(hd))),
               qb, qs, qk, qg, qd};
  const long long kst[4] = {kb, ks, kk, kd};
  const long long vst[4] = {vb, vs, vk, vd};
  switch (hd) {
    case 32: return launch<32>(a, k, v, scratch, kst, vst, stream);
    case 64: return launch<64>(a, k, v, scratch, kst, vst, stream);
    case 128: return launch<128>(a, k, v, scratch, kst, vst, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
