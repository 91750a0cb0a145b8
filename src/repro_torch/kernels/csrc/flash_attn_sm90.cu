// Blockwise GQA flash attention, forward, bf16, on Hopper's tensor cores
// (sm_90a): wgmma fed by TMA.
//
// flash_attention_sm90_launch replaces, for bf16 inputs, the Pallas TPU
// kernel src/repro/kernels/flash_attn.py:flash_attention (_kernel); f32
// inputs take flash_attn_tf32.cu.  It computes what that
// kernel computes: for q (B, Sq, KV, G, hd) and k, v (B, Sk, KV, hd), every
// query row (b, s, kv, g) is
//     out = softmax_t(q . k_t / sqrt(hd)) v_t   over t <= s (causal) or all t
//     lse = log sum_t exp(q . k_t / sqrt(hd))   (f32, natural log)
// with out contiguous (B, Sq, KV, G, hd) in bf16 and lse contiguous
// (B, KV, G, Sq) in f32; positions 0 .. S-1 on both sides, Sq != Sk allowed.
//
// What bounds it: at the LM path's shape (smollm-360m, B = 4, S = 2048,
// 15 heads over 5 KV heads, hd = 64, causal) it needs 4 hd operations per
// (query row, visible key) pair, 32.2 GFLOP: 33 us at the tensor cores'
// 989 TFLOP/s in bf16, against 13 us for its 42 MB at 3.35 TB/s.  So
// operations bound it, and only wgmma reaches that rate.
//
// Design.  Rows: a block takes 128 consecutive rows of the flattened
// (position, head) axis of one (b, kv) pair, 64 for each of its two
// consumer warpgroups, so all G query heads of a position share every K/V
// tile whatever G is.  Such a Q tile is no regular TMA box when G does not
// divide 64, so the threads load it once, 16 bytes each, into the 128-byte
// (64 at hd = 32) swizzled layout that TMA would write.  K and V tiles of
// 64 keys stream through a ring of two stages by TMA
// (cp.async.bulk.tensor, 4-d maps over (hd, S, KV, B), so ragged ends are
// zero-filled per (b, kv)), completing on an mbarrier: thread 0 asks for
// tile j + 1 before the block scores tile j.  Scores: S = Q K^T by
// wgmma.m64n64k16 from shared memory (both K-major), f32 accumulators.
// Online softmax in registers: exp2f of log2-scaled scores, each row's
// max and sum over the quad of threads that hold it; l sums the f32 P.
// P V: P rounded to bf16 in registers is wgmma's register A operand (the
// accumulator's layout is the A fragment's), V the B operand from shared
// memory with the transpose bit (MN-major).  Causal: a block reads keys
// only up to its last row's position, and only the tiles that cross a
// warpgroup's diagonal (or the ragged end) are masked.  No warp
// specialisation or persistent grid yet: the two warpgroups of a block,
// and the two blocks an SM holds below hd 128, overlap each other's
// softmax and products.
//
// The launcher builds the tensor maps on the host per call
// (cuTensorMapEncodeTiled, fetched from the driver with dlsym so the
// library links against nothing but the runtime), runs on the caller's
// stream, allocates nothing, and returns a CUDA error code (or
// kEncodeFailed when the driver refuses a map) so that a refused launch
// surfaces in the wrapper.
#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kLn2 = 0.69314718055994530942f;
constexpr int kWarpgroups = 2;         // consumer warpgroups per block
constexpr int kRows = 64 * kWarpgroups;
constexpr int kStages = 2;             // K/V ring

template <int HD>
struct Cfg {
  static constexpr int SW = HD >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int CE = SW / 2;               // elements of one span
  static constexpr int NC = HD / CE;              // spans across hd
  static constexpr int BN = 64;                   // keys per tile
  // blocks an SM holds: two below hd 128 (fewer registers a thread,
  // measured faster than one block of 128-key tiles), one at hd 128
  static constexpr int MIN_BLOCKS = HD == 128 ? 1 : 2;
  static constexpr int Q_BYTES = kRows * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;    // one of K or V
  static constexpr int SMEM = Q_BYTES + 2 * kStages * KV_BYTES
                              + kStages * 8 + 1024;
  static constexpr int LAYOUT = SW == 128 ? 1 : 2; // wgmma: B128, B64
};

struct Args {
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  float* lse;
  int B, Sq, Sk, KV, G, causal;
  float scale2;  // log2(e) / sqrt(hd)
  int64_t qb, qs, qk, qg;  // q's element strides (hd's is 1)
};

template <int HD>
__global__ void __launch_bounds__(kRows * 2, Cfg<HD>::MIN_BLOCKS)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const Args a) {
  using C = Cfg<HD>;
  constexpr int BN = C::BN, SW = C::SW, NC = C::NC, CE = C::CE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = base;                     // [NC][kRows][SW]
  uint8_t* sk = sq + C::Q_BYTES;          // [kStages][NC][BN][SW]
  uint8_t* sv = sk + kStages * C::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + kStages * C::KV_BYTES);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.x % (a.B * a.KV);
  const int h = bh % a.KV, b = bh / a.KV;
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.G;
  // a 1-d grid, row tile slowest and the longest (latest) tiles first,
  // so that the causal tail is short
  const int64_t row0 =
      ((n_rows + kRows - 1) / kRows - 1 - blockIdx.x / (a.B * a.KV)) *
      kRows;
  const int64_t last = min(row0 + kRows, n_rows) - 1;
  const int n_keys =
      a.causal ? min(a.Sk, static_cast<int>(last / a.G) + 1) : a.Sk;
  const int n_tiles = (n_keys + BN - 1) / BN;

  auto issue = [&](int j) {
    const int st = j % kStages;
    mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load_4d(sk + st * C::KV_BYTES + c * BN * SW, &tk, &full[st],
                  c * CE, j * BN, h, b);
      tma_load_4d(sv + st * C::KV_BYTES + c * BN * SW, &tv, &full[st],
                  c * CE, j * BN, h, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue(0);
  }

  // Q by the threads, 16 bytes each, into TMA's swizzled layout; rows past
  // the end are zeros
  constexpr int CH = HD / 8;
  for (int e = tid; e < kRows * CH; e += blockDim.x) {
    const int row = e / CH, c16 = e % CH;
    const int64_t r = row0 + row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n_rows) {
      const int64_t s = r / a.G, g = r % a.G;
      val = *reinterpret_cast<const uint4*>(
          a.q + b * a.qb + s * a.qs + h * a.qk + g * a.qg + c16 * 8);
    }
    const int c = c16 / (SW / 16), cc = c16 % (SW / 16);
    *reinterpret_cast<uint4*>(sq + c * kRows * SW +
                              swizzle<SW>(row * SW + cc * 16)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // this warpgroup's 64 rows; a thread holds rows rA and rA + 8
  const int64_t wrow0 = row0 + wg * 64;
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
  const uint32_t q_addr = smem_u32(sq) + wg * 64 * SW;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    __syncthreads();          // tile j - 1 is consumed: its stage is free
    if (tid == 0 && j + 1 < n_tiles) issue(j + 1);
    const int k0 = j * BN;
    if (k0 >= wkeys) continue;  // past this warpgroup's diagonal
    mbar_wait(&full[st], (j / kStages) & 1);
    const uint32_t k_addr = smem_u32(sk + st * C::KV_BYTES);
    const uint32_t v_addr = smem_u32(sv + st * C::KV_BYTES);

    // S = Q K^T: both operands K-major; a k-step of 16 is 32 bytes into
    // the swizzled span
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk / (CE / 16), w = kk % (CE / 16);
      wgmma_ss(s,
               gmma_desc(q_addr + c * kRows * SW + w * 32, 16, 8 * SW,
                         C::LAYOUT),
               gmma_desc(k_addr + c * BN * SW + w * 32, 16, 8 * SW,
                         C::LAYOUT),
               kk > 0);
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
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= i % 4 < 2 ? corrA : corrB;

    // P in bf16 as the A fragments of the k-steps over the tile's keys
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // O += P V: V MN-major, 16 keys a k-step (16 swizzled rows), the hd
    // spans LBO apart
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(o, p[kk],
               gmma_desc(v_addr + kk * 16 * SW, BN * SW, 8 * SW, C::LAYOUT));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  if (!has_rows) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, off);
    lB += __shfl_xor_sync(0xffffffffu, lB, off);
  }
  const float invA = 1.f / lA, invB = 1.f / lB;
  auto out_row = [&](int64_t r) {
    const int64_t s = r / a.G, g = r % a.G;
    return a.out + (((b * static_cast<int64_t>(a.Sq) + s) * a.KV + h) * a.G
                    + g) * HD;
  };
  __nv_bfloat16* oA = out_row(rA);
  __nv_bfloat16* oB = out_row(rB);
#pragma unroll
  for (int n8 = 0; n8 < HD / 8; ++n8) {
    const int col = n8 * 8 + (lane % 4) * 2;
    if (rA < n_rows)
      *reinterpret_cast<uint32_t*>(oA + col) =
          pack_bf16(o[4 * n8] * invA, o[4 * n8 + 1] * invA);
    if (rB < n_rows)
      *reinterpret_cast<uint32_t*>(oB + col) =
          pack_bf16(o[4 * n8 + 2] * invB, o[4 * n8 + 3] * invB);
  }
  if (lane % 4 == 0) {
    const int64_t lse0 = (static_cast<int64_t>(b) * a.KV + h) * a.G;
    if (rA < n_rows)
      a.lse[(lse0 + rA % a.G) * a.Sq + posA] = (mA + log2f(lA)) * kLn2;
    if (rB < n_rows)
      a.lse[(lse0 + rB % a.G) * a.Sq + posB] = (mB + log2f(lB)) * kLn2;
  }
}

// a 4-d map over (hd, S, KV, B) of a bf16 k or v with element strides
// (1, ss, sk, sb), boxes of (CE, BN, 1, 1), swizzled as wgmma reads them
template <int HD>
int encode(CUtensorMap* map, const void* ptr, int S, int KV, int B,
           long long ss, long long sk, long long sb) {
  using C = Cfg<HD>;
  return encode_kv(map, ptr, HD, S, KV, B, ss, sk, sb, C::CE, C::BN, C::SW);
}

template <int HD>
int launch(const Args& a, const void* k, const void* v, long long kb,
           long long ks, long long kk, long long vb, long long vs,
           long long vk, cudaStream_t stream) {
  CUtensorMap tk, tv;
  int rc = encode<HD>(&tk, k, a.Sk, a.KV, a.B, ks, kk, kb);
  if (rc == 0) rc = encode<HD>(&tv, v, a.Sk, a.KV, a.B, vs, vk, vb);
  if (rc != 0) return rc;
  auto kernel = flash_attention_wgmma_kernel<HD>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<HD>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.G;
  const unsigned grid =
      static_cast<unsigned>((n_rows + kRows - 1) / kRows) * a.B * a.KV;
  kernel<<<grid, kRows * 2, Cfg<HD>::SMEM, stream>>>(tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 device pointers with a unit innermost stride and the
// other strides (in elements) multiples of 8, 16-byte aligned; out
// contiguous bf16 (B, Sq, KV, G, hd); lse contiguous f32 (B, KV, G, Sq).
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int Sq, int Sk, int KV, int G, int hd, int causal, long long qb,
    long long qs, long long qk, long long qg, long long kb, long long ks,
    long long kk, long long vb, long long vs, long long vk,
    cudaStream_t stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<__nv_bfloat16*>(out), lse, B, Sq, Sk, KV, G,
               causal,
               static_cast<float>(1.4426950408889634 /
                                  sqrt(static_cast<double>(hd))),
               qb, qs, qk, qg};
  switch (hd) {
    case 32: return launch<32>(a, k, v, kb, ks, kk, vb, vs, vk, stream);
    case 64: return launch<64>(a, k, v, kb, ks, kk, vb, vs, vk, stream);
    case 128: return launch<128>(a, k, v, kb, ks, kk, vb, vs, vk, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
