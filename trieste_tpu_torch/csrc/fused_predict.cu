// Fused exact-GP marginal prediction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel trieste_tpu/ops/fused_predict.py:_make_kernel
// (launched by pl.pallas_call at trieste_tpu/ops/fused_predict.py:336). For every
// candidate row i of xs (already divided by the lengthscales) against the C masked,
// scaled training rows of A it computes
//
//   r2[i,j]   = sum_d (xs[i,d] - A[j,d])^2        direct differences: no cancellation
//   K[i,j]    = kvar * k(r2)                       rbf, matern12, matern32 or matern52
//   mean[i,p] = sum_j K[i,j] * alpha[j,p] + m
//   v[i,:]    = K[i,:] @ LinvT                     LinvT = (L^-1)^T, upper triangular
//   var[i]    = max(kvar - sum_j v[i,j]^2, 1e-24)
//
// and the [N, C] cross-covariance K never reaches device memory.
//
// Precondition: LinvT is upper triangular (LinvT[k, j] = 0 for k > j) and zero on the
// rows and columns of padded training slots, where alpha is zero too. The kernel never
// reads the blocks of LinvT that lie wholly under the diagonal.
//
// Bound on an H100. The function needs N*C*(C + 1) + 2*N*C*(D + P + 1) FLOPs against
// 4*(N*(D + P + 1) + C*(C + D + P)) bytes: 0.140 TFLOP against 8.4 MB at the production
// shape (N = 131072, C = 1024, D = 6, P = 1), so operations bound it. At fp32-grade
// precision the tensor cores need three TF32 products per needed product (495 TFLOP/s
// dense, so 165 TFLOP/s effective): about 0.85 ms. The fp32 FMA pipes (67 TFLOP/s)
// would need about 2.1 ms.
//
// Design.
//   pack_kernel (once per call) splits LinvT into hi = tf32(x) and lo = tf32(x - hi),
//   both rounded to nearest, and writes them chunk by chunk in the order and layout the
//   main kernel consumes: for column panel p (BN = 128 columns) only the k tiles
//   (BK = 32 rows) with k < (p + 1)*BN, each tile laid out as the K-major, unswizzled
//   shared-memory image that the wgmma B descriptor reads, zero padded to whole tiles.
//   Each chunk also carries its 32 rows of alpha and of A, so one chunk is one contiguous
//   bulk copy.
//
//   fused_predict_kernel: a block owns BM = 128 candidate rows and has three
//   warpgroups. One thread of the producer warpgroup streams the chunks from L2 into a
//   ring of shared-memory stages with cp.async.bulk, completing on an mbarrier per
//   stage; it waits on the stage's "empty" mbarrier before refilling it. Each of the
//   two consumer warpgroups owns 64 rows. For every k step of 8 it evaluates its
//   m64k8 A fragment of K in registers (4 values a thread, from its two xs rows, held in
//   registers where D <= 8, and the stage's A rows in shared memory), splits it into hi
//   and lo, and starts
//   K_lo*L_hi + K_hi*L_lo + K_hi*L_hi as three wgmma.mma_async m64n128k8 TF32 products
//   (A from registers, B from the stage) into 64 fp32 accumulators a thread. The next
//   step's fragment is evaluated before the wait on those. The last panel's k loop
//   covers every k, and the mean is accumulated there in fp32 FMA from the same K
//   values. There is no __syncthreads() after the roles split.
//
//   The tensor cores add into their fp32 accumulator by truncation, so a chain of
//   3*C/8 additions loses about 2e-5 relative, all in one direction (measured: variance
//   errors of 4e-5 to 6e-5 with one chain per panel). The accumulators therefore start
//   from zero at every k tile (12 additions) and each tile's sum is added to the panel's
//   v in registers with rounding to nearest. That is 64 + 64 registers a thread, which
//   is why a panel has 128 columns and not 256. At the end of a panel v is squared into
//   two per-row sums, so v never leaves registers.
//
//   For D > 8 a block keeps its 128 rows of xs in shared memory beside the ring. Where D
//   is so large (beyond about 96) that the ring would no longer fit, neither xs nor A is staged:
//   the chunks carry no rows of A and the distances read both from global memory
//   through L1, so D has no limit.
//
//   A block fetches every chunk once: 144 chunks of 33.7 KB at C = 1024, D = 6, P = 1,
//   4.85 MB for 128 rows, so a call at N = 131072 reads about 5.0 GB from L2.
//
//   What holds it back (H100 80GB HBM3, 700 W, production shape, timed by
//   tools/kernel_ablation.py at the root of the repo): with the K evaluation removed the kernel takes 1.11 ms
//   (the tensor cores at 84% of their TF32 peak), with the wgmma removed 0.80 ms, with
//   both removed 0.49 ms (the chunk stream alone), and whole 2.07 ms. The fp32 work and
//   the TF32 wgmma do not overlap on this card: an independent FMA loop in otherwise
//   idle warps takes 1.43 ms alone and adds 1.07 ms to the wgmma-only variant.
//
// Left for later work: a 3-pass bf16 split (twice the tensor-core rate), clusters that
// share one chunk fetch by multicast, a persistent schedule.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;                   // LinvT columns per panel = wgmma N
constexpr int BK = 32;                    // LinvT rows per ring stage
constexpr int KSTEP = 8;                  // wgmma K for TF32
constexpr int STEPS = BK / KSTEP;         // wgmma k steps per stage
constexpr int WG_ROWS = 64;               // wgmma M: rows per consumer warpgroup
constexpr int CONSUMER_WGS = 2;
constexpr int BM = WG_ROWS * CONSUMER_WGS;          // candidate rows per block
constexpr int CONSUMER_THREADS = 128 * CONSUMER_WGS;
constexpr int CONSUMER_WARPS = CONSUMER_THREADS / 32;
constexpr int THREADS = CONSUMER_THREADS + 128;     // plus the producer warpgroup
constexpr int ACC = BN / 2;               // fp32 accumulators per thread
constexpr int TILE_FLOATS = BK * BN;      // one of the hi / lo tiles of a chunk
constexpr int STEP_BYTES = KSTEP * BN * 4;          // one k step of a tile
constexpr int CORE_BYTES = 128;           // 8 columns x 4 k: one wgmma core matrix
constexpr int PACK_THREADS = 256;
constexpr int MAX_P = 8;
constexpr int MAX_C = 1024;
constexpr int STAGES = 4;                 // ring depth: 4 chunks of at most 34 KB
constexpr int MAX_REG_DIM = 8;            // largest padded D whose xs rows live in registers
constexpr int SMEM_LIMIT = 232448;        // shared memory a block may use on sm_90
constexpr int BARRIER_BYTES = 2 * STAGES * 8;

static_assert(BN % 8 == 0 && BN <= 256, "wgmma N is a multiple of 8 up to 256");
static_assert(ACC == 64, "the wgmma wrapper below is written for m64n128k8");

enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

// ---- shapes shared by the host and both kernels --------------------------------------

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int padded_dim(int D) { return round_up(D, 2); }
__host__ __device__ inline int num_panels(int C) { return (C + BN - 1) / BN; }
// k tiles of panel p: rows k < min(Ck, (p + 1)*BN); LinvT is zero below them.
__host__ __device__ inline int panel_tiles(int C, int p) {
  const int Ck = round_up(C, BK);
  const int kend = (p + 1) * BN < Ck ? (p + 1) * BN : Ck;
  return kend / BK;
}
// Whether the rows the distances need are staged in shared memory: those of A in the
// chunks and, for D > MAX_REG_DIM, the block's rows of xs beside the ring. They are
// unless the ring would no longer fit; then the kernel reads both from global memory and
// the chunks are independent of D.
__host__ __device__ inline bool rows_staged(int D, int P) {
  const int Dp = padded_dim(D);
  return (size_t)4 * (STAGES * (2 * TILE_FLOATS + BK * Dp + BK * P) + BM * Dp) + BARRIER_BYTES <=
         (size_t)SMEM_LIMIT;
}
__host__ __device__ inline int chunk_a_floats(int D, int P) {
  return rows_staged(D, P) ? BK * padded_dim(D) : 0;
}
__host__ __device__ inline int chunk_floats(int D, int P) {
  return 2 * TILE_FLOATS + chunk_a_floats(D, P) + BK * P;
}
inline int total_chunks(int C) {
  int n = 0;
  for (int p = 0; p < num_panels(C); ++p) n += panel_tiles(C, p);
  return n;
}
// the ring, the barriers, then the block's rows of xs [BM][Dp] where they are staged
inline size_t smem_bytes(int D, int P) {
  const bool xs_rows = padded_dim(D) > MAX_REG_DIM && rows_staged(D, P);
  return (size_t)STAGES * chunk_floats(D, P) * 4 + BARRIER_BYTES +
         (xs_rows ? BM * padded_dim(D) * 4 : 0);
}

// ---- small device helpers ---------------------------------------------------------------

// sqrt to within 2^-23 relative (one MUFU instruction and a multiply); exact at 0.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int KIND>
__device__ __forceinline__ float stationary(float r2) {   // r2 >= 0: a sum of squares
  if constexpr (KIND == RBF) {
    return expf(-0.5f * r2);
  } else {
    const float r = sqrt_approx(r2);
    if constexpr (KIND == MATERN12) {
      return expf(-r);
    } else if constexpr (KIND == MATERN32) {
      const float z = 1.7320508075688772f * r;
      return (1.0f + z) * expf(-z);
    } else {
      const float z = 2.23606797749979f * r;
      return fmaf(z, fmaf(z, 0.3333333333333333f, 1.0f), 1.0f) * expf(-z);
    }
  }
}

// Round to nearest TF32 (10 mantissa bits); the tensor cores would truncate.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep a register alive (and in place) across an asynchronous wgmma that reads or
// writes it: the compiler does not know the instruction is still running.
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Shared-memory descriptor of one k step of a B tile: K-major, no swizzle. A core
// matrix is 8 columns x 4 k (128 contiguous bytes); the two core matrices of a k step
// follow each other (leading byte offset 128), column groups of 8 are 256 bytes apart
// (stride byte offset).
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(CORE_BYTES >> 4) << 16) |
         ((uint64_t)((2 * CORE_BYTES) >> 4) << 32);
}

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)

// d (+)= a * B for one m64n128k8 TF32 product: a is this thread's part of the A
// fragment, B the shared-memory tile behind `desc`; accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[ACC], const uint32_t (&a)[4],
                                                     uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : ACC16(0), ACC16(16), ACC16(32), ACC16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}

#undef ACC4
#undef ACC16

// ---- pack: LinvT split into TF32 hi / lo in the main kernel's chunk order ------------

// One block per chunk. Chunk (p, kt) holds, in floats:
//   [0, TILE)        hi of LinvT[kt*BK .. +BK, p*BN .. +BN] as [step][col/8][k half][col%8][k%4]
//   [TILE, 2*TILE)   lo, same layout
//   then, where rows_staged(D, P), A[kt*BK .. +BK, 0..Dp), and alpha[kt*BK .. +BK, 0..P),
//   zero outside [0, C) x [0, D).
__global__ void __launch_bounds__(PACK_THREADS)
pack_kernel(const float* __restrict__ A, const float* __restrict__ alpha,
            const float* __restrict__ linvt, float* __restrict__ packed, int C, int D, int P) {
  const int Dp = padded_dim(D);
  int kt = blockIdx.x;
  int p = 0;
  while (kt >= panel_tiles(C, p)) kt -= panel_tiles(C, p++);
  float* out = packed + (size_t)blockIdx.x * chunk_floats(D, P);

  for (int item = threadIdx.x; item < (BK / 4) * BN; item += PACK_THREADS) {
    const int kq = item / BN;   // which group of 4 k: step = kq / 2, k half = kq % 2
    const int jl = item % BN;
    const int j = p * BN + jl;
    float hi[4], lo[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = kt * BK + kq * 4 + c;
      const float x = (k < C && j < C) ? __ldg(linvt + (size_t)k * C + j) : 0.0f;
      hi[c] = __uint_as_float(to_tf32(x));
      lo[c] = __uint_as_float(to_tf32(x - hi[c]));
    }
    const int off = ((kq >> 1) * (BN / 8) + (jl >> 3)) * 64 + (kq & 1) * 32 + (jl & 7) * 4;
    *reinterpret_cast<float4*>(out + off) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(out + TILE_FLOATS + off) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
  float* outA = out + 2 * TILE_FLOATS;
  for (int e = threadIdx.x; e < chunk_a_floats(D, P); e += PACK_THREADS) {
    const int k = kt * BK + e / Dp;
    const int d = e % Dp;
    outA[e] = (k < C && d < D) ? __ldg(A + (size_t)k * D + d) : 0.0f;
  }
  float* outAlpha = outA + chunk_a_floats(D, P);
  for (int e = threadIdx.x; e < BK * P; e += PACK_THREADS) {
    const int k = kt * BK + e / P;
    outAlpha[e] = k < C ? __ldg(alpha + (size_t)k * P + e % P) : 0.0f;
  }
}

// ---- main kernel --------------------------------------------------------------------------

// One input dimension's part of the squared distances r = (a-t1, b-t1, a-t2, b-t2) of the
// candidate rows a and b to the training rows t1 and t2.
__device__ __forceinline__ void r2_step(float va, float vb, float a1, float a2, float (&r)[4]) {
  float df;
  df = va - a1; r[0] = fmaf(df, df, r[0]);
  df = vb - a1; r[1] = fmaf(df, df, r[1]);
  df = va - a2; r[2] = fmaf(df, df, r[2]);
  df = vb - a2; r[3] = fmaf(df, df, r[3]);
}

// The two candidate rows of a thread. Where the padded dimension 2*PAIRS is known at
// compile time they are PAIRS float2 each in registers, and the training rows come from
// the chunk in shared memory, padded likewise. For wider inputs both are read on every
// use: as float2 from shared memory where rows_staged() (PAIRS == 0, padded to Dp), else
// from global memory through L1 (PAIRS == -1), so D has no limit.
template <int PAIRS>
struct Rows {
  float2 a[PAIRS], b[PAIRS];
  __device__ __forceinline__ Rows(const float* xa, const float* xb, int D) {
#pragma unroll
    for (int d = 0; d < PAIRS; ++d) {
      a[d].x = 2 * d < D ? __ldg(xa + 2 * d) : 0.0f;
      b[d].x = 2 * d < D ? __ldg(xb + 2 * d) : 0.0f;
      a[d].y = 2 * d + 1 < D ? __ldg(xa + 2 * d + 1) : 0.0f;
      b[d].y = 2 * d + 1 < D ? __ldg(xb + 2 * d + 1) : 0.0f;
    }
  }
  __device__ __forceinline__ void r2(const float* t1, const float* t2, float (&r)[4]) const {
    const float2* p1 = reinterpret_cast<const float2*>(t1);
    const float2* p2 = reinterpret_cast<const float2*>(t2);
#pragma unroll
    for (int d = 0; d < PAIRS; ++d) {
      const float2 va = a[d], vb = b[d], a1 = p1[d], a2 = p2[d];
      r2_step(va.x, vb.x, a1.x, a2.x, r);
      r2_step(va.y, vb.y, a1.y, a2.y, r);
    }
  }
};
template <>
struct Rows<0> {
  const float2 *a, *b;
  int n;
  __device__ __forceinline__ Rows(const float* xa, const float* xb, int D)
      : a(reinterpret_cast<const float2*>(xa)), b(reinterpret_cast<const float2*>(xb)),
        n(padded_dim(D) / 2) {}
  __device__ __forceinline__ void r2(const float* t1, const float* t2, float (&r)[4]) const {
    const float2* p1 = reinterpret_cast<const float2*>(t1);
    const float2* p2 = reinterpret_cast<const float2*>(t2);
#pragma unroll 2
    for (int d = 0; d < n; ++d) {
      const float2 va = a[d], vb = b[d], a1 = p1[d], a2 = p2[d];
      r2_step(va.x, vb.x, a1.x, a2.x, r);
      r2_step(va.y, vb.y, a1.y, a2.y, r);
    }
  }
};
template <>
struct Rows<-1> {
  const float *a, *b;
  int D;
  __device__ __forceinline__ Rows(const float* xa, const float* xb, int D) : a(xa), b(xb), D(D) {}
  __device__ __forceinline__ void r2(const float* t1, const float* t2, float (&r)[4]) const {
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      r2_step(__ldg(a + d), __ldg(b + d), __ldg(t1 + d), __ldg(t2 + d), r);
    }
  }
};

// This thread's part of the m64k8 A fragment of K for one k step, split into TF32 hi and
// lo: elements (row ra, k1), (row rb, k1), (ra, k2), (rb, k2) with k2 = k1 + 4. t1 and t2
// are the training rows k1 and k2, al1 and al2 their rows of alpha. With `with_mean` the
// same K values feed the mean sums.
template <int KIND, int PAIRS>
__device__ __forceinline__ void k_fragment(const Rows<PAIRS>& rows, const float* __restrict__ t1,
                                           const float* __restrict__ t2,
                                           const float* __restrict__ al1,
                                           const float* __restrict__ al2, int P, float kvar,
                                           bool with_mean, uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           float (&mean_a)[MAX_P], float (&mean_b)[MAX_P]) {
  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  rows.r2(t1, t2, r);
  float kv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    kv[e] = kvar * stationary<KIND>(r[e]);
    hi[e] = to_tf32(kv[e]);
    lo[e] = to_tf32(kv[e] - __uint_as_float(hi[e]));
  }
  if (with_mean) {
#pragma unroll
    for (int p = 0; p < MAX_P; ++p) {
      if (p < P) {
        mean_a[p] = fmaf(kv[0], al1[p], mean_a[p]);
        mean_b[p] = fmaf(kv[1], al1[p], mean_b[p]);
        mean_a[p] = fmaf(kv[2], al2[p], mean_a[p]);
        mean_b[p] = fmaf(kv[3], al2[p], mean_b[p]);
      }
    }
  }
}

// PAIRS is half the padded dimension where that is at most 4 (D <= 8); else 0 where
// rows_staged(D, P) and -1 where not.
template <int KIND, int PAIRS>
__global__ void __launch_bounds__(THREADS, 1)
fused_predict_kernel(const float* __restrict__ xs, const float* __restrict__ A,
                     const float* __restrict__ packed, const float* __restrict__ scal,
                     float* __restrict__ mean, float* __restrict__ var, int N, int C, int D,
                     int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunk_bytes = chunk_floats(D, P) * 4;
  // full[STAGES], empty[STAGES]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)STAGES * chunk_bytes);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + STAGES);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int panels = num_panels(C);

  // where the candidate rows are read from, and their stride: xs, or (PAIRS == 0) the
  // block's zero-padded copy in shared memory; rows past N are evaluated on the last
  // row and never written
  const float* x_rows = xs + (size_t)row0 * D;
  int x_stride = D;
  int x_last = N - 1 - row0;
  if constexpr (PAIRS == 0) {
    const int Dp = padded_dim(D);
    float* xs_s = reinterpret_cast<float*>(bars + 2 * STAGES);   // [BM][Dp]
    for (int e = tid; e < BM * Dp; e += THREADS) {
      const int d = e % Dp;
      xs_s[e] = d < D ? __ldg(x_rows + (size_t)min(e / Dp, x_last) * D + d) : 0.0f;
    }
    x_rows = xs_s;
    x_stride = Dp;
    x_last = BM - 1;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                  // the producer's arrive, plus the bytes
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMER_THREADS) {
    // ---- producer warpgroup: one thread streams every chunk, in order -----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == CONSUMER_THREADS) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(packed);
      int stage = 0;
      uint32_t parity = 1;   // a fresh "empty" barrier counts as released
      for (int p = 0; p < panels; ++p) {
        const int tiles = panel_tiles(C, p);
        for (int kt = 0; kt < tiles; ++kt) {
          mbar_wait(empty0 + 8 * stage, parity);
          mbar_arrive_expect_tx(full0 + 8 * stage, chunk_bytes);
          bulk_copy(ring + stage * chunk_bytes, src, chunk_bytes, full0 + 8 * stage);
          src += chunk_bytes;
          if (++stage == STAGES) { stage = 0; parity ^= 1; }
        }
      }
    }
  } else {
    // ---- consumer warpgroups --------------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = tid & 31;
    const int t = lane & 3;
    // rows of this thread in the A fragment and in the accumulators: ra and ra + 8
    const int ra = (tid >> 5) * 16 + (lane >> 2);
    const Rows<PAIRS> rows(x_rows + (size_t)min(ra, x_last) * x_stride,
                           x_rows + (size_t)min(ra + 8, x_last) * x_stride, D);
    const float kvar = scal[0];
    const float mconst = scal[1];

    float acc[ACC];   // the tensor cores' sums over one k tile
    float v[ACC];     // v of this panel: the k tiles' sums, added with rounding to nearest
#pragma unroll
    for (int i = 0; i < ACC; ++i) v[i] = 0.0f;
    float quad_a = 0.0f, quad_b = 0.0f;
    float mean_a[MAX_P], mean_b[MAX_P];   // the mean sums, and their parts over one k tile
    float part_a[MAX_P], part_b[MAX_P];
#pragma unroll
    for (int p = 0; p < MAX_P; ++p) mean_a[p] = mean_b[p] = part_a[p] = part_b[p] = 0.0f;

    int stage = 0;
    uint32_t parity = 0;
    uint32_t hi[4], lo[4], hi_next[4], lo_next[4];
    for (int p = 0; p < panels; ++p) {
      const int tiles = panel_tiles(C, p);
      const bool with_mean = p == panels - 1;   // this panel's k loop covers every k
      // the fragment of K for k step `step` of k tile `tile`, whose chunk is in ring stage
      // `stg`: training rows k1 and k1 + 4 of the tile
      auto fragment = [&](int stg, int tile, int step, uint32_t(&h)[4], uint32_t(&l)[4]) {
        const float* rows_a =
            reinterpret_cast<const float*>(smem + (size_t)stg * chunk_bytes) + 2 * TILE_FLOATS;
        const int k1 = step * KSTEP + t;
        const float *t1, *t2, *rows_alpha;
        if constexpr (PAIRS >= 0) {
          const int Dp = PAIRS > 0 ? 2 * PAIRS : padded_dim(D);
          t1 = rows_a + k1 * Dp;
          t2 = t1 + 4 * Dp;
          rows_alpha = rows_a + BK * Dp;
        } else {   // rows past C meet zero rows of LinvT and alpha: any training row will do
          t1 = A + (size_t)min(tile * BK + k1, C - 1) * D;
          t2 = A + (size_t)min(tile * BK + k1 + 4, C - 1) * D;
          rows_alpha = rows_a;   // no rows of A in the chunks
        }
        k_fragment<KIND>(rows, t1, t2, rows_alpha + k1 * P, rows_alpha + (k1 + 4) * P, P, kvar,
                         with_mean, h, l, part_a, part_b);
      };
      mbar_wait(full0 + 8 * stage, parity);
      fragment(stage, 0, 0, hi, lo);
      for (int kt = 0; kt < tiles; ++kt) {
        const uint32_t tile_hi = ring + stage * chunk_bytes;
        const uint32_t tile_lo = tile_hi + TILE_FLOATS * 4;
        int next_stage = stage + 1;
        uint32_t next_parity = parity;
        if (next_stage == STAGES) { next_stage = 0; next_parity ^= 1; }
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          const uint64_t desc_hi = b_descriptor(tile_hi + s * STEP_BYTES);
          const uint64_t desc_lo = b_descriptor(tile_lo + s * STEP_BYTES);
          wgmma_fence();
          wgmma_m64n128k8_tf32(acc, lo, desc_hi, s != 0);   // small terms first
          wgmma_m64n128k8_tf32(acc, hi, desc_lo, 1);
          wgmma_m64n128k8_tf32(acc, hi, desc_hi, 1);
          wgmma_commit();
          // the next step's fragment, evaluated before the wait on this step's products
          if (s + 1 < STEPS) {
            fragment(stage, kt, s + 1, hi_next, lo_next);
          } else if (kt + 1 < tiles) {
            mbar_wait(full0 + 8 * next_stage, next_parity);
            fragment(next_stage, kt + 1, 0, hi_next, lo_next);
          }
          wgmma_wait_all();
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            keep(hi[e]);
            keep(lo[e]);
            hi[e] = hi_next[e];
            lo[e] = lo_next[e];
          }
        }
        // every wgmma that read this stage has completed: hand it back
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        stage = next_stage;
        parity = next_parity;
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          keep(acc[i]);
          v[i] += acc[i];
        }
        if (with_mean) {   // short chains of additions: 8 terms a tile, then the tiles
#pragma unroll
          for (int p = 0; p < MAX_P; ++p) {
            mean_a[p] += part_a[p];
            mean_b[p] += part_b[p];
            part_a[p] = part_b[p] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        if ((i >> 1) & 1) quad_b = fmaf(v[i], v[i], quad_b);
        else quad_a = fmaf(v[i], v[i], quad_a);
        v[i] = 0.0f;
      }
    }

    // The four threads of a quad hold the same two rows: reduce over them.
    quad_a += __shfl_xor_sync(0xffffffffu, quad_a, 1);
    quad_a += __shfl_xor_sync(0xffffffffu, quad_a, 2);
    quad_b += __shfl_xor_sync(0xffffffffu, quad_b, 1);
    quad_b += __shfl_xor_sync(0xffffffffu, quad_b, 2);
#pragma unroll
    for (int p = 0; p < MAX_P; ++p) {
      if (p < P) {
        mean_a[p] += __shfl_xor_sync(0xffffffffu, mean_a[p], 1);
        mean_a[p] += __shfl_xor_sync(0xffffffffu, mean_a[p], 2);
        mean_b[p] += __shfl_xor_sync(0xffffffffu, mean_b[p], 1);
        mean_b[p] += __shfl_xor_sync(0xffffffffu, mean_b[p], 2);
      }
    }
    if (t == 0) {
      const int ga = row0 + ra;
      const int gb = ga + 8;
      if (ga < N) var[ga] = fmaxf(kvar - quad_a, 1e-24f);
      if (gb < N) var[gb] = fmaxf(kvar - quad_b, 1e-24f);
#pragma unroll
      for (int p = 0; p < MAX_P; ++p) {
        if (p < P) {
          if (ga < N) mean[(size_t)ga * P + p] = mean_a[p] + mconst;
          if (gb < N) mean[(size_t)gb * P + p] = mean_b[p] + mconst;
        }
      }
    }
  }
}

bool sizes_ok(int C, int D, int P) {
  return C >= 1 && C <= MAX_C && D >= 1 && P >= 1 && P <= MAX_P;
}

template <int KIND, int PAIRS>
cudaError_t launch_pairs(const float* xs, const float* A, const float* packed, const float* scal,
                         float* mean, float* var, int N, int C, int D, int P,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes(D, P);
  cudaError_t err = cudaFuncSetAttribute(fused_predict_kernel<KIND, PAIRS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + BM - 1) / BM));
  fused_predict_kernel<KIND, PAIRS><<<grid, THREADS, smem, stream>>>(xs, A, packed, scal, mean,
                                                                     var, N, C, D, P);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch(const float* xs, const float* A, const float* packed, const float* scal,
                   float* mean, float* var, int N, int C, int D, int P, cudaStream_t stream) {
  static_assert(MAX_REG_DIM == 8, "one case below for each padded dimension up to MAX_REG_DIM");
  if (!rows_staged(D, P))
    return launch_pairs<KIND, -1>(xs, A, packed, scal, mean, var, N, C, D, P, stream);
  switch (padded_dim(D) / 2) {
    case 1: return launch_pairs<KIND, 1>(xs, A, packed, scal, mean, var, N, C, D, P, stream);
    case 2: return launch_pairs<KIND, 2>(xs, A, packed, scal, mean, var, N, C, D, P, stream);
    case 3: return launch_pairs<KIND, 3>(xs, A, packed, scal, mean, var, N, C, D, P, stream);
    case 4: return launch_pairs<KIND, 4>(xs, A, packed, scal, mean, var, N, C, D, P, stream);
    default: return launch_pairs<KIND, 0>(xs, A, packed, scal, mean, var, N, C, D, P, stream);
  }
}

}  // namespace

// Bytes of scratch that fused_predict_pack writes and fused_predict_launch reads for
// these sizes, or -1 where the kernel does not take them (C in [1, 1024], P in [1, 8],
// D >= 1).
extern "C" long long fused_predict_packed_bytes(int C, int D, int P) {
  if (!sizes_ok(C, D, P)) return -1;
  return (long long)total_chunks(C) * chunk_floats(D, P) * 4;
}

// Launch the pack kernel on `stream`: A [C, D], alpha [C, P], linvt [C, C] (upper
// triangular), all fp32 and contiguous on the current device; writes `packed`
// (fused_predict_packed_bytes bytes, 16-byte aligned). Returns the CUDA error.
extern "C" int fused_predict_pack(const float* A, const float* alpha, const float* linvt,
                                  float* packed, int C, int D, int P, void* stream) {
  if (!sizes_ok(C, D, P)) return cudaErrorInvalidValue;
  pack_kernel<<<total_chunks(C), PACK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A, alpha, linvt, packed, C, D, P);
  return cudaGetLastError();
}

// Launch the main kernel on `stream`: xs [N, D], A [C, D] and `packed` as
// fused_predict_pack wrote it from this A for the same C, D and P, scal [2] = (signal variance, mean constant); writes mean [N, P]
// and var [N]. Returns the CUDA error of the launch.
extern "C" int fused_predict_launch(int kind, const float* xs, const float* A,
                                    const float* packed, const float* scal, float* mean,
                                    float* var, int N, int C, int D, int P, void* stream) {
  if (N < 0 || !sizes_ok(C, D, P)) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case RBF: return launch<RBF>(xs, A, packed, scal, mean, var, N, C, D, P, s);
    case MATERN12: return launch<MATERN12>(xs, A, packed, scal, mean, var, N, C, D, P, s);
    case MATERN32: return launch<MATERN32>(xs, A, packed, scal, mean, var, N, C, D, P, s);
    case MATERN52: return launch<MATERN52>(xs, A, packed, scal, mean, var, N, C, D, P, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* fused_predict_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
