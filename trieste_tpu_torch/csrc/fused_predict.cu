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
//   v[i,:]    = K[i,:] @ LinvT                     LinvT = (L^-1)^T, zero on padded slots
//   var[i]    = max(kvar - sum_j v[i,j]^2, 1e-24)
//
// and the [N, C] cross-covariance K never reaches device memory.
//
// Bound on an H100. LinvT is upper triangular, so the function needs
// N*C*(C + 1) + 2*N*C*(D + P + 1) fp32 FLOPs against 4*(N*(D + P + 1) + C*(C + D + P))
// bytes of inputs and outputs. At the production shape (N = 131072, C = 1024, D = 6,
// P = 1) that is 0.140 TFLOP against 8.4 MB: about 16,600 FLOP per byte, so the card's
// fp32 rate outside the tensor cores (67 TFLOP/s) bounds it, at about 2.1 ms, and
// device memory (2.5 us) does not. This kernel executes the dense count,
// 2*N*C*(C + D + P) = 0.277 TFLOP (about 4.1 ms at that rate), because it multiplies
// the zero lower triangle of LinvT as well.
//
// Design: every product is an fp32 FMA (no TF32, whose 10-bit mantissa is coarser
// than the TPU kernel's 3-pass bf16 split). One block of 256 threads owns BM = 32
// candidate rows.
//   1. It writes K[BM, C] into dynamic shared memory (128 KB at C = 1024), then reduces
//      the mean rows from it, one warp per row.
//   2. It sweeps LinvT in column panels of BN = 512. Each panel streams from L2 (LinvT
//      is 4 MB and stays resident there) through two BK x BN shared-memory stages: the
//      next stage is fetched into registers while the current one is multiplied. Each
//      thread holds an 8 x 8 register tile of v and folds v^2 into per-row sums, so v
//      never leaves registers.
// Each LinvT element fetched from L2 feeds BM = 32 rows, and each k step loads 10 words
// of shared memory for 64 FMAs; both keep the FMA pipes, not L2 or shared memory, the
// intended limit. The kernel masks its own ragged N edge. Padded training slots stay
// inert because alpha and LinvT are zero there, and the zero-filled tail of K (columns
// C..Ck) meets zero rows of the staged LinvT.
//
// Left for later work: the tensor cores (3xTF32 or wgmma), TMA loads of the LinvT
// panels, and skipping the zero lower triangle of LinvT.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;        // candidate rows per block
constexpr int BN = 512;       // LinvT columns per panel
constexpr int BK = 8;         // LinvT rows per shared-memory stage
constexpr int THREADS = 256;
constexpr int TM = 8;         // rows of v per thread
constexpr int TN = 8;         // columns of v per thread
constexpr int COL_GROUPS = BN / TN;           // 64 threads share a row group
constexpr int ROW_GROUPS = BM / TM;           // 4
constexpr int STAGE = BK * BN;                // floats per shared-memory stage
constexpr int LOADS = STAGE / THREADS;        // floats each thread stages
constexpr int MAX_P = 8;
constexpr int MAX_C = 1024;
constexpr int WARPS = THREADS / 32;

static_assert(ROW_GROUPS * COL_GROUPS == THREADS, "thread tiling must cover the block");
static_assert(STAGE % THREADS == 0, "stage must split evenly over threads");
static_assert(COL_GROUPS % 32 == 0, "a warp must lie inside one row group");

enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

template <int KIND>
__device__ __forceinline__ float stationary(float r2) {
  if constexpr (KIND == RBF) {
    return expf(-0.5f * r2);
  } else {
    const float r = sqrtf(fmaxf(r2, 0.0f));
    if constexpr (KIND == MATERN12) {
      return expf(-r);
    } else if constexpr (KIND == MATERN32) {
      const float z = 1.7320508075688772f * r;
      return (1.0f + z) * expf(-z);
    } else {
      const float z = 2.23606797749979f * r;
      return (1.0f + z + z * z / 3.0f) * expf(-z);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows [k0, k0 + BK) x columns [j0, j0 + BN) of LinvT into registers, zero
// outside [0, C) x [0, C).
__device__ __forceinline__ void fetch_stage(const float* __restrict__ linvt, int C, int k0,
                                            int j0, float (&regs)[LOADS]) {
#pragma unroll
  for (int s = 0; s < LOADS; ++s) {
    const int e = threadIdx.x + s * THREADS;
    const int k = k0 + e / BN;
    const int j = j0 + e % BN;
    regs[s] = (k < C && j < C) ? __ldg(linvt + (size_t)k * C + j) : 0.0f;
  }
}

__device__ __forceinline__ void store_stage(float* __restrict__ stage,
                                            const float (&regs)[LOADS]) {
#pragma unroll
  for (int s = 0; s < LOADS; ++s) stage[threadIdx.x + s * THREADS] = regs[s];
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
fused_predict_kernel(const float* __restrict__ xs, const float* __restrict__ A,
                     const float* __restrict__ alpha, const float* __restrict__ linvt,
                     const float* __restrict__ scal, float* __restrict__ mean,
                     float* __restrict__ var, int N, int C, int D, int P, int Ck) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // [BM][Ck], columns C..Ck zero
  float* Ls = smem + BM * Ck;     // [2][BK][BN]
  __shared__ float row_sums[WARPS][TM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * BM;
  const float kvar = scal[0];
  const float mconst = scal[1];

  // Phase 1: K[BM, Ck] into shared memory.
  for (int j = tid; j < Ck; j += THREADS) {
    float r2[BM];
#pragma unroll
    for (int i = 0; i < BM; ++i) r2[i] = 0.0f;
    if (j < C) {
      for (int d = 0; d < D; ++d) {
        const float a = __ldg(A + (size_t)j * D + d);
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          const int gi = row0 + i;
          const float x = gi < N ? __ldg(xs + (size_t)gi * D + d) : 0.0f;
          const float diff = x - a;
          r2[i] = fmaf(diff, diff, r2[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BM; ++i) Ks[i * Ck + j] = j < C ? kvar * stationary<KIND>(r2[i]) : 0.0f;
  }
  __syncthreads();

  // Mean: one warp per row, lanes striding over the training slots.
  for (int i = warp; i < BM; i += WARPS) {
    float acc[MAX_P];
#pragma unroll
    for (int p = 0; p < MAX_P; ++p) acc[p] = 0.0f;
    for (int j = lane; j < C; j += 32) {
      const float k = Ks[i * Ck + j];
#pragma unroll
      for (int p = 0; p < MAX_P; ++p)
        if (p < P) acc[p] = fmaf(k, __ldg(alpha + (size_t)j * P + p), acc[p]);
    }
    const int gi = row0 + i;
#pragma unroll
    for (int p = 0; p < MAX_P; ++p) {
      if (p < P) {
        const float s = warp_sum(acc[p]);
        if (lane == 0 && gi < N) mean[(size_t)gi * P + p] = s + mconst;
      }
    }
  }

  // Phase 2: v = K @ LinvT panel by panel, folding v^2 into per-row sums.
  const int rg = tid / COL_GROUPS;
  const int cg = tid % COL_GROUPS;
  const float* Krows = Ks + rg * TM * Ck;
  float quad[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) quad[r] = 0.0f;

  float regs[LOADS];
  for (int j0 = 0; j0 < C; j0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;

    fetch_stage(linvt, C, 0, j0, regs);
    store_stage(Ls, regs);
    __syncthreads();
    for (int k0 = 0; k0 < Ck; k0 += BK) {
      const int buf = (k0 / BK) & 1;
      const bool more = k0 + BK < Ck;
      if (more) fetch_stage(linvt, C, k0 + BK, j0, regs);
      const float* stage = Ls + buf * STAGE;
#pragma unroll
      for (int kq = 0; kq < BK; kq += 4) {
        float4 a[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r)
          a[r] = *reinterpret_cast<const float4*>(Krows + r * Ck + k0 + kq);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float b[TN];
#pragma unroll
          for (int c = 0; c < TN; ++c) b[c] = stage[(kq + q) * BN + cg + c * COL_GROUPS];
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float ar = q == 0 ? a[r].x : q == 1 ? a[r].y : q == 2 ? a[r].z : a[r].w;
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(ar, b[c], acc[r][c]);
          }
        }
      }
      if (more) store_stage(Ls + (buf ^ 1) * STAGE, regs);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) quad[r] = fmaf(acc[r][c], acc[r][c], quad[r]);
  }

  // Reduce the per-row sums over the 64 threads of each row group (two warps).
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const float s = warp_sum(quad[r]);
    if (lane == 0) row_sums[warp][r] = s;
  }
  __syncthreads();
  if (tid < BM) {
    const int g = tid / TM;
    const int r = tid % TM;
    float q = 0.0f;
#pragma unroll
    for (int w = 0; w < COL_GROUPS / 32; ++w) q += row_sums[g * (COL_GROUPS / 32) + w][r];
    const int gi = row0 + tid;
    if (gi < N) var[gi] = fmaxf(kvar - q, 1e-24f);
  }
}

template <int KIND>
cudaError_t launch(const float* xs, const float* A, const float* alpha, const float* linvt,
                   const float* scal, float* mean, float* var, int N, int C, int D, int P,
                   cudaStream_t stream) {
  const int Ck = (C + BK - 1) / BK * BK;
  const size_t smem = sizeof(float) * ((size_t)BM * Ck + 2 * STAGE);
  cudaError_t err = cudaFuncSetAttribute(fused_predict_kernel<KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + BM - 1) / BM));
  fused_predict_kernel<KIND><<<grid, THREADS, smem, stream>>>(xs, A, alpha, linvt, scal, mean,
                                                              var, N, C, D, P, Ck);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`: xs [N, D], A [C, D], alpha [C, P], linvt [C, C], scal [2] =
// (signal variance, mean constant), all fp32 and contiguous on the current device;
// writes mean [N, P] and var [N]. Returns the CUDA error of the launch.
extern "C" int fused_predict_launch(int kind, const float* xs, const float* A,
                                    const float* alpha, const float* linvt, const float* scal,
                                    float* mean, float* var, int N, int C, int D, int P,
                                    void* stream) {
  if (N < 0 || C < 1 || C > MAX_C || D < 1 || P < 1 || P > MAX_P) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case RBF: return launch<RBF>(xs, A, alpha, linvt, scal, mean, var, N, C, D, P, s);
    case MATERN12: return launch<MATERN12>(xs, A, alpha, linvt, scal, mean, var, N, C, D, P, s);
    case MATERN32: return launch<MATERN32>(xs, A, alpha, linvt, scal, mean, var, N, C, D, P, s);
    case MATERN52: return launch<MATERN52>(xs, A, alpha, linvt, scal, mean, var, N, C, D, P, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* fused_predict_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
