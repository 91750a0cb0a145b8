// Hopper (sm_90a) building blocks of B8's f32 route: f32 as split TF32
// products on the tensor cores ("3xTF32").  Included by flash_attn_tf32.cu
// (the forward) and flash_attn_bwd_tf32.cu (the backward), each built into
// a library of its own.
//
// The split.  Each f32 operand x becomes hi = rna(x) and lo = rna(x - hi),
// both exact TF32 values (cvt.rna.tf32.f32 with the low 13 bits cleared),
// so the tensor core reads them as they are whether it truncates or rounds
// what it is given.  A product a b is then lo_a hi_b + hi_a lo_b + hi_a
// hi_b, three wgmma.m64nNk8.f32.tf32 into one f32 accumulator (the small
// terms first); the dropped lo_a lo_b and lo's own rounding are near 2^-22
// of |a b|, f32's own rounding is 2^-24.
//
// Sums.  The tensor core adds each k-step's products into its accumulator
// with less care than an f32 add rounded to nearest: summed over a whole
// reduction (dK and dV over every row of a (b, kv) pair, dQ over every
// key) the error grows with the number of k-steps, and at the LM shape (B
// 4, S 2048, 5 x 3 heads, hd 64) on an H100 it took dK and dV past the
// 1e-4 the f32 route promises.  So a product sums one tile's k-steps (3 x
// 2 to 3 x 8) into a fresh accumulator, and the running sum takes each
// tile's with one f32 add: back within it, at the same speed.
//
// Operand majorness.  wgmma has no transpose bit for .tf32: both operands
// in shared memory are K-major.  A product that contracts over hd (S = Q
// K^T, dP = dO V^T) reads the rows as loaded; one that contracts over keys
// or rows (P V, P^T dO, dS^T Q, dS K) needs the other operand transposed.
// tf32_split_kernel writes, once per call and into scratch in device
// memory, each operand's hi and lo in either layout: "natural" (rows of
// hd) and "transposed" (tiles of X rows stored as hd rows of X).  The
// kernels then load every tile by TMA, swizzled, with no split work in
// their loops.
//
// P (and dS) as the register A operand.  An m64nNk8 .tf32 A fragment
// holds, per thread, columns t and t + 4 of its rows (t = lane % 4), while
// the accumulator that computed P holds columns 2t and 2t + 1.  The
// product's K order is free, so the transposed tiles store row (or key) j
// of each group of 8 at column kpos(j) = j / 2 + 4 (j % 2): column t then
// holds row 2t and column t + 4 row 2t + 1, which is what the accumulator
// gives each thread, and P feeds the next product with no shuffle.
#pragma once

#include "sm90.cuh"

namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;

// x rounded to the nearest TF32 (ties away from zero), as an f32 whose low
// 13 bits are zero
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y & 0xffffe000u);
}

__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// the A fragments (hi and lo) of one k-step of 8 from an accumulator's n8
// group e[0..3] = (row g, cols 2t, 2t + 1), (row g + 8, the same): a0 =
// (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4), columns
// t and t + 4 standing for 2t and 2t + 1 (kpos above)
__device__ __forceinline__ void tf32_frag(const float* e, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float x[4] = {e[0], e[2], e[1], e[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float h, l;
    tf32_split(x[i], h, l);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(l);
  }
}

// the row of a group of 8 that column p of a transposed tile holds
__host__ __device__ __forceinline__ int kpos_row(int p) {
  return p < 4 ? 2 * p : 2 * p - 7;
}

// wgmma swizzle layout type of a span of `bytes` (128, 64 or 32)
__host__ __device__ constexpr int swizzle_layout(int bytes) {
  return bytes == 128 ? 1 : bytes == 64 ? 2 : 3;
}

// mbar_wait that gives up: a phase that has not completed after 2^24
// tries (at least about half a second; a tile's wait is microseconds)
// means a fault in the pipeline, and the kernel traps, so that the launch
// fails with an error instead of holding the card forever
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) asm volatile("trap;");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// wgmma.m64nNk8, f32 += tf32 x tf32, overloaded on N by the size of the
// accumulator (N / 2 registers a thread).  tf32_ss: A and B from shared
// memory (N = 16, 32, 64), both K-major; tf32_rs: A from registers, B from
// shared memory K-major (N = hd: 32, 64, 128), always accumulating.
__device__ __forceinline__ void tf32_ss(float (&d)[8], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_ss(float (&d)[16], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_ss(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_rs(float (&d)[16],
                                        const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void tf32_rs(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void tf32_rs(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// a 2-d map over f32 scratch of `rows` rows of `inner` elements (a
// multiple of 4), boxes of (box0, box1) swizzled to box0 * 4 bytes (128, 64
// or 32), as wgmma reads a K-major tile of that span.  0, or kEncodeFailed
// + the driver's CUresult.
inline int encode_f32_2d(CUtensorMap* map, const float* ptr, long long inner,
                         long long rows, int box0, int box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeFailed + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(inner) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(box1)};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle sw = box0 == 32   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : box0 == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(ptr), dims, stride, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// ---- the split: one operand's rows into hi and lo, natural and transposed
//
// The rows of a (b, kv) pair are the flattened (position, head) axis, r =
// s G + g (G = 1 for k and v), padded with zeros to NRpad, a multiple of
// 64.  nat: (2, B KV, NRpad, HD), hi then lo.  tr: (2, B KV, NRpad / X,
// HD, X): tile T holds rows T X .. T X + X - 1 as HD rows of X, row j of
// each group of 8 at column kpos.  stats (dout only): (B KV, NRpad) pairs
// (lse log2(e), D = rowsum(dO * O)), (+inf, 0) past the last row.
struct SplitArgs {
  const float* src;
  long long sb, ss, sk, sg, sd;  // src's element strides (b, s, kv, g, hd)
  int B, S, KV, G, NRpad, X;
  float* nat;                    // or null
  float* tr;                     // or null
  const float* out;              // contiguous (B, S, KV, G, HD), for stats
  const float* lse;              // (B, KV, G, S)
  float2* stats;                 // or null
};

constexpr int kSplitThreads = 256;

template <int HD>
__global__ void __launch_bounds__(kSplitThreads)
tf32_split_kernel(const SplitArgs a) {
  __shared__ float tile[64][HD + 1];
  const int chunks = a.NRpad / 64;
  const int bh = blockIdx.x / chunks;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x % chunks) * 64;
  const int b = bh / a.KV, h = bh % a.KV;
  const int64_t n_rows = static_cast<int64_t>(a.S) * a.G;
  const int64_t half = static_cast<int64_t>(a.B) * a.KV * a.NRpad * HD;
  for (int e = threadIdx.x; e < 64 * HD; e += kSplitThreads) {
    const int row = e / HD, d = e % HD;
    const int64_t r = r0 + row;
    float x = 0.f;
    if (r < n_rows) {
      const int64_t s = r / a.G, g = r % a.G;
      x = a.src[b * a.sb + s * a.ss + h * a.sk + g * a.sg + d * a.sd];
    }
    tile[row][d] = x;
  }
  __syncthreads();
  if (a.nat != nullptr)
    for (int e = threadIdx.x; e < 64 * HD; e += kSplitThreads) {
      const int row = e / HD, d = e % HD;
      float hi, lo;
      tf32_split(tile[row][d], hi, lo);
      const int64_t off = (bh * static_cast<int64_t>(a.NRpad) + r0 + row) *
                          HD + d;
      a.nat[off] = hi;
      a.nat[half + off] = lo;
    }
  if (a.tr != nullptr)
    for (int e = threadIdx.x; e < 64 * HD; e += kSplitThreads) {
      const int sub = e / (HD * a.X), rem = e % (HD * a.X);
      const int d = rem / a.X, col = rem % a.X;
      const int j = (col & ~7) | kpos_row(col & 7);
      float hi, lo;
      tf32_split(tile[sub * a.X + j][d], hi, lo);
      const int64_t T = (bh * static_cast<int64_t>(a.NRpad) + r0) / a.X + sub;
      const int64_t off = (T * HD + d) * a.X + col;
      a.tr[off] = hi;
      a.tr[half + off] = lo;
    }
  if (a.stats != nullptr) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int row = warp; row < 64; row += kSplitThreads / 32) {
      const int64_t r = r0 + row;
      const bool real = r < n_rows;
      const int64_t s = real ? r / a.G : 0, g = real ? r % a.G : 0;
      float acc = 0.f;
      if (real) {
        const float* o =
            a.out + (((b * static_cast<int64_t>(a.S) + s) * a.KV + h) * a.G +
                     g) * HD;
        for (int d = lane; d < HD; d += 32) acc = fmaf(tile[row][d], o[d], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0)
        a.stats[bh * static_cast<int64_t>(a.NRpad) + r] =
            real ? make_float2(
                       a.lse[((static_cast<int64_t>(b) * a.KV + h) * a.G + g) *
                             a.S + s] * kLog2e,
                       acc)
                 : make_float2(INFINITY, 0.f);
    }
  }
}

template <int HD>
inline int launch_split(const SplitArgs& a, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>(a.B) * a.KV * static_cast<unsigned>(a.NRpad / 64);
  tf32_split_kernel<HD><<<blocks, kSplitThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// rows padded to whole 64-row chunks
inline long long pad64(long long n) { return (n + 63) / 64 * 64; }

}  // namespace sm90
