// Batched small-SPD inverse and log-determinant for Hopper.
//
// Replaces the TPU kernel of the JAX package
//   * _chol_kernel  openmeasure_tpu/linalg/chol_pallas.py:85
//     (entry chol_inv_logdet_pallas, :118; pallas_call at :132)
// which the GP training loop calls once per Adam iteration for the whole
// batch of r per-mode kernel matrices, (14, 41, 41) fp32 on the main path.
//
// What it computes (the TPU kernel's arithmetic, without its padding to a
// multiple of 8 and its lane broadcast of logdet):
//   Schur:   for j < p:  d_j = A[j][j];  logdet += log(d_j)
//            A[i][k] -= (A[i][j] * rsqrt(d_j)) * (A[k][j] * rsqrt(d_j))
//                        for i, k > j          (the trailing Schur complement)
//            L[i][j] = A[i][j] * rsqrt(d_j)   for i > j,   L[j][j] = sqrt(d_j)
//   Forward: Y = L^-1 by forward substitution, row j scaled by rsqrt(d_j)
//   Gram:    K^-1 = Y^T Y, computed here, inside the kernel
// No guard against a non-SPD input, as on the TPU: a non-positive pivot
// gives NaN through log and rsqrt, and the NaN flows out.
//
// What bounds it.  Each input byte read once and each output byte written
// once: 2 B p^2 + B floats, 0.19 MB at (14, 41, 41), 0.056 us at 3.35 TB/s;
// about p^3 operations per matrix on the triangles (Schur, forward
// substitution and Gram, about p^3/3 each), 0.99 M at the main shape,
// 0.015 us at 67 TFLOP/s fp32.  Neither is what the kernel meets: it runs
// 2p + 3 dependent steps per matrix, each closed by a block barrier, so its
// time is latency, whatever B is, as long as B <= the SM count.  On an H100
// 80GB HBM3 at 700 W it takes 0.037 ms at the main shape (chip_smoke.py),
// about 430 ns a step.
//
// What the design does about it.  The simple, correct form first: one
// thread block per matrix, the matrix (A, then L in its lower triangle) and
// Y in dynamic shared memory, one barrier per Schur step and one per
// forward-substitution step; every read after the load and before the
// output is from shared memory.  B = 14 blocks fill 14 of the 132 SMs.  A
// warp per column, or registers in place of shared memory, is the next
// step.
//
// Rounding follows the plain version (linalg/chol.py, chol_inv_logdet_plain)
// term by term: separately rounded products and differences (the _rn
// intrinsics: no FMA contraction), the logdet summed sequentially over j,
// and the forward substitution's update order.  Only the Gram's sums run in
// another order than the plain version's batched matmul.
//
// Shared memory: 2 p ld floats with ld = p rounded up to odd (a column read
// across a warp then hits 32 different banks), 132 KB at p = 128, above
// the 48 KB a launch gets by default: the launch asks for it with
// cudaFuncSetAttribute first.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 128;  // the TPU kernel's unroll cap (_P_CAP)

__host__ __device__ __forceinline__ int odd_ld(int p) { return p | 1; }

__global__ void __launch_bounds__(kThreads)
chol_inv_logdet_kernel(const float* __restrict__ K, int p, float* __restrict__ kinv,
                       float* __restrict__ logdet) {
  extern __shared__ float smem[];
  const int ld = odd_ld(p);
  float* A = smem;           // p x ld: A, then L below the diagonal
  float* Y = smem + p * ld;  // p x ld: L^-1 (lower triangle)
  const int64_t off = static_cast<int64_t>(blockIdx.x) * p * p;
  const int tid = threadIdx.x;
  const int pp = p * p;

  for (int t = tid; t < pp; t += blockDim.x) {
    const int i = t / p, k = t - i * p;
    A[i * ld + k] = K[off + t];
    Y[i * ld + k] = (i == k) ? 1.f : 0.f;
  }
  __syncthreads();

  // Schur steps.  Step j reads column j and the pivot (both left untouched
  // by step j) and updates the trailing lower triangle i >= k > j; the
  // diagonal keeps each pivot d_j from its step on.
  for (int j = 0; j < p; ++j) {
    const float r = rsqrtf(A[j * ld + j]);
    const int m = p - 1 - j;
    for (int t = tid; t < m * m; t += blockDim.x) {
      const int i = j + 1 + t / m, k = j + 1 + t % m;
      if (k <= i) {
        const float li = __fmul_rn(A[i * ld + j], r);
        const float lk = __fmul_rn(A[k * ld + j], r);
        A[i * ld + k] = __fsub_rn(A[i * ld + k], __fmul_rn(li, lk));
      }
    }
    __syncthreads();
  }

  // L below the diagonal: L[i][j] = A[i][j] * rsqrt(d_j).
  for (int t = tid; t < pp; t += blockDim.x) {
    const int i = t / p, j = t - i * p;
    if (i > j) A[i * ld + j] = __fmul_rn(A[i * ld + j], rsqrtf(A[j * ld + j]));
  }
  __syncthreads();

  // Forward substitution L Y = I.  Step j takes row j as it stands (the
  // identity minus the earlier steps' updates), scales it by rsqrt(d_j) on
  // the fly, and updates the rows below; row j itself is scaled once all
  // steps are done, so step j writes nothing that step j reads.
  for (int j = 0; j < p; ++j) {
    const float r = rsqrtf(A[j * ld + j]);
    const int m = p - 1 - j, w = j + 1;  // rows j+1..p-1, columns 0..j
    for (int t = tid; t < m * w; t += blockDim.x) {
      const int i = j + 1 + t / w, c = t % w;
      const float y = __fmul_rn(Y[j * ld + c], r);
      Y[i * ld + c] = __fsub_rn(Y[i * ld + c], __fmul_rn(A[i * ld + j], y));
    }
    __syncthreads();
  }
  for (int t = tid; t < pp; t += blockDim.x) {
    const int j = t / p, c = t - j * p;
    if (c <= j) Y[j * ld + c] = __fmul_rn(Y[j * ld + c], rsqrtf(A[j * ld + j]));
  }
  __syncthreads();

  // K^-1 = Y^T Y: element (i, k) sums Y[j][i] Y[j][k] over j >= max(i, k)
  // (Y is lower triangular); consecutive threads take consecutive k.
  for (int t = tid; t < pp; t += blockDim.x) {
    const int i = t / p, k = t - i * p;
    float acc = 0.f;
    for (int j = i > k ? i : k; j < p; ++j)
      acc = __fadd_rn(acc, __fmul_rn(Y[j * ld + i], Y[j * ld + k]));
    kinv[off + t] = acc;
  }

  if (tid == 0) {
    float s = 0.f;
    for (int j = 0; j < p; ++j) s = __fadd_rn(s, logf(A[j * ld + j]));
    logdet[blockIdx.x] = s;
  }
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream` for `batch` contiguous (p, p) fp32
// matrices; writes kinv (batch, p, p) and logdet (batch,).  Returns the
// first non-zero CUDA error (0 when the launch was accepted).
int chol_inv_logdet_launch(const float* K, int batch, int p, float* kinv, float* logdet,
                           void* stream) {
  if (batch < 1 || p < 1 || p > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(p) * odd_ld(p);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(chol_inv_logdet_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chol_inv_logdet_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      K, p, kinv, logdet);
  err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // extern "C"
