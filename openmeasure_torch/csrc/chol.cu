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
//   Schur:   for j < p:  d_j = A[j][j];  r_j = rsqrt(d_j)
//            A[i][k] -= (A[i][j] * r_j) * (A[k][j] * r_j)
//                        for i >= k > j       (the trailing Schur complement)
//            L[i][j] = A[i][j] * r_j   for i > j
//   Forward: Y = L^-1 by forward substitution, row j scaled by r_j
//   Gram:    K^-1 = Y^T Y, computed here, inside the kernel
//   logdet:  sum of log(d_j), j ascending
// Only the lower triangle of K is read.  No guard against a non-SPD input,
// as on the TPU: a non-positive pivot gives NaN through log and rsqrt, and
// the NaN flows out.
//
// What bounds it.  Each input byte read once and each output byte written
// once: 2 B p^2 + B floats, 0.19 MB at (14, 41, 41), 0.056 us at 3.35 TB/s;
// about p^3 operations per matrix on the triangles, 0.99 M at the main
// shape, 0.015 us at 67 TFLOP/s fp32.  Neither is what the kernel meets:
// a matrix's factorization is a chain of p dependent Schur steps, then p
// dependent substitution steps per column, so its time is latency, whatever
// B is, as long as B <= the SM count.
//
// What the design does about it.  One thread block per matrix, and in each
// phase as little as possible on the chain of dependent steps:
//   * Schur, right-looking, one lower-triangle element per thread, held in
//     registers (up to S a thread: 861 elements, one each, at p = 41;
//     8256, at most 9 each, at p = 128).  Elements are numbered from the
//     last column to the first, so those still live at step j are a prefix
//     of the numbering and every thread owns its share of them; the
//     numbering is decoded once, before the loop.  At step j the owners of
//     column j have published its values in a double-buffered shared
//     column, and the owner of its diagonal r_j; each thread forms
//     li = col[i] r_j and lk = col[k] r_j and updates its register, the
//     owners of column j + 1 publish theirs into the other buffer, and one
//     barrier closes the step.  The owners of column j write L[:, j] and
//     d_j to shared memory for the later phases.
//   * Forward substitution, one warp per column c of Y (columns dealt to
//     the warps back and forth, so each warp's steps add up to about p),
//     R = ceil(p / 32) rows a lane in registers (a template parameter, so
//     no lane carries rows past p), no block barrier: at step j every lane
//     reads its L[i][j] first, the lane holding row j forms y_j = Y[j][c] r_j
//     and broadcasts it by a shuffle, and the lanes with rows i > j subtract
//     L[i][j] y_j (a select, no branch).  Row i's y_i r_i goes to Y in
//     shared memory once the column is done; one barrier ends the phase.
//   * Gram: each thread sums its lower-triangle elements of Y^T Y, j
//     ascending from max(i, k), and writes (i, k) and (k, i) from one sum.
//     Warp 0, whose elements have the shortest sums, first takes the logs
//     of the d_j in its lanes and sums them in order through shuffles.
//
// Where the time goes (profile_torch.py chol, from a build of this file
// with CHOL_STAMPS, whose stamps add barriers; on an NVIDIA H100 80GB HBM3
// at 700 W): at (14, 41, 41) the
// Schur steps take about two thirds of the kernel's cycles, some 460
// cycles a step -- the barrier, the shared-memory round trip of the
// published column and the pivot's rsqrt, all on the chain -- and the
// substitution about a fifth; see PERF.md for the measured split.
//
// Rounding follows the plain version (linalg/chol.py, chol_inv_logdet_plain)
// term by term: separately rounded products and differences (the _rn
// intrinsics: no FMA contraction), the Gram's and the logdet's sums
// sequential in j, the forward substitution's updates in j order.  The two
// agree bit for bit.
//
// Block size: one thread an element of the lower triangle, rounded up to a
// warp, at most 1024 (block_threads).  Shared memory: 2 p ld floats of
// dynamic shared memory for L and Y, with ld = p rounded up to odd (a
// column read across a warp then hits 32 different banks), 132 KB at
// p = 128, above the 48 KB a launch gets by default: the launch asks for
// it with cudaFuncSetAttribute first; plus 1.5 KB of static shared memory
// for the published columns and the r_j.

#include <cuda_runtime.h>

#include <cstdint>

// Phase stamps, compiled only with -DCHOL_STAMPS (linalg/chol_cuda.py,
// chol_phase_stamps; profile_torch.py chol): after a barrier, thread 0 of
// each block writes clock64() and the global timer (ns) at the end of
// phase n into stamps[16 b + 2 n], [16 b + 2 n + 1].  The six barriers are
// the stamped build's own, and the one after the logdet keeps it from
// overlapping the Gram: its phase times are those of a kernel with more
// barriers than the one built without the define.
#ifdef CHOL_STAMPS
__device__ long long* g_chol_stamps;
extern "C" int chol_set_stamps(long long* stamps) {
  return static_cast<int>(cudaMemcpyToSymbol(g_chol_stamps, &stamps, sizeof(stamps)));
}
#define CHOL_STAMP(n)                                                      \
  do {                                                                     \
    __syncthreads();                                                       \
    if (threadIdx.x == 0) {                                                \
      long long t;                                                         \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                \
      g_chol_stamps[blockIdx.x * 16 + 2 * (n)] = clock64();                \
      g_chol_stamps[blockIdx.x * 16 + 2 * (n) + 1] = t;                    \
    }                                                                      \
  } while (0)
#else
#define CHOL_STAMP(n) \
  do {                \
  } while (0)
#endif

namespace {

constexpr int kMaxP = 128;  // the TPU kernel's unroll cap (_P_CAP)
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kStaticSmem = 3 * kMaxP * sizeof(float);  // col[2][kMaxP], rs[kMaxP]

__host__ __device__ __forceinline__ int odd_ld(int p) { return p | 1; }

__host__ __device__ __forceinline__ int block_threads(int p) {
  const int t = (p * (p + 1) / 2 + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Element e of the lower triangle, numbered from the last column to the
// first and down each column: e = q (q + 1) / 2 + t with q = p - 1 - k and
// t = i - k in [0, q].  Returns (i, k).
__device__ __forceinline__ int2 trailing_element(int e, int p) {
  int q = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
  while (q * (q + 1) / 2 > e) --q;
  while ((q + 1) * (q + 2) / 2 <= e) ++q;
  const int k = p - 1 - q;
  return make_int2(k + e - q * (q + 1) / 2, k);
}

// R = ceil(p / 32): rows a lane holds in the substitution; S: trailing
// elements a thread holds, enough for the largest p of that R.
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
chol_inv_logdet_kernel(const float* __restrict__ K, int p, float* __restrict__ kinv,
                       float* __restrict__ logdet) {
  extern __shared__ float smem[];
  __shared__ float col[2][kMaxP];  // column j of the Schur complement at step j
  __shared__ float rs[kMaxP];      // r_j = rsqrt(d_j)
  const int ld = odd_ld(p);
  float* L = smem;           // p x ld: L below the diagonal, d_j on it
  float* Y = smem + p * ld;  // p x ld: Y = L^-1 in its lower triangle
  const int64_t off = static_cast<int64_t>(blockIdx.x) * p * p;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ne = p * (p + 1) / 2;
  constexpr int S = (32 * R * (32 * R + 1) / 2 + kMaxThreads - 1) / kMaxThreads;
  CHOL_STAMP(0);

  // This thread's elements e = tid + s nt, loaded from the lower triangle;
  // column 0 and r_0 published.
  float a[S];
  int ik[S];  // (i << 8) | k
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = tid + s * nt;
    a[s] = 0.f;
    ik[s] = 0;
    if (e < ne) {
      const int2 el = trailing_element(e, p);
      ik[s] = (el.x << 8) | el.y;
      a[s] = K[off + el.x * p + el.y];
      if (el.y == 0) {
        col[0][el.x] = a[s];
        if (el.x == 0) rs[0] = rsqrtf(a[s]);
      }
    }
  }
  __syncthreads();
  CHOL_STAMP(1);

  // Schur steps.  Columns j..p-1 are the elements e < m (m + 1) / 2 with
  // m = p - j: column j is written out to L, the rest updated.
  for (int j = 0; j < p; ++j) {
    const float* cj = col[j & 1];
    float* cn = col[(j + 1) & 1];
    const float r = rs[j];
    const int m = p - j;
    const int live = m * (m + 1) / 2;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (tid + s * nt >= live) break;
      const int i = ik[s] >> 8, k = ik[s] & 0xff;
      if (k == j) {
        L[i * ld + j] = i == j ? a[s] : __fmul_rn(a[s], r);
      } else {
        const float li = __fmul_rn(cj[i], r);
        const float lk = __fmul_rn(cj[k], r);
        a[s] = __fsub_rn(a[s], __fmul_rn(li, lk));
        if (k == j + 1) {
          cn[i] = a[s];
          if (i == k) rs[k] = rsqrtf(a[s]);
        }
      }
    }
    __syncthreads();
  }
  CHOL_STAMP(2);

  // Forward substitution L Y = I, one warp a column c, lane l holding rows
  // s * 32 + l; pass q deals columns q nw .. q nw + nw - 1 to the warps,
  // in reverse order on odd passes.
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  float rr[R];
  const float* lrow[R];  // row s * 32 + lane of L (the last row past p)
#pragma unroll
  for (int s = 0; s < R; ++s) {
    rr[s] = s * 32 + lane < p ? rs[s * 32 + lane] : 0.f;
    lrow[s] = L + min(s * 32 + lane, p - 1) * ld;
  }
  for (int q = 0;; ++q) {
    const int c = (q & 1) ? (q + 1) * nw - 1 - warp : q * nw + warp;
    if (c >= p) break;
    float y[R];
#pragma unroll
    for (int s = 0; s < R; ++s) y[s] = s * 32 + lane == c ? 1.f : 0.f;
#pragma unroll
    for (int sj = 0; sj < R; ++sj) {
      const int j1 = min(p, sj * 32 + 32);
      for (int j = max(c, sj * 32); j < j1; ++j) {
        // L[i][j] is read before the shuffle and every lane computes the
        // update; only rows i > j keep it (rows past p are never stored)
        float lij[R];
#pragma unroll
        for (int s = sj; s < R; ++s) lij[s] = lrow[s][j];
        const float yj = __shfl_sync(kFull, __fmul_rn(y[sj], rr[sj]), j - sj * 32);
#pragma unroll
        for (int s = sj; s < R; ++s) {
          const float t = __fsub_rn(y[s], __fmul_rn(lij[s], yj));
          if (s * 32 + lane > j) y[s] = t;
        }
      }
    }
    // Y[i][c] as row i broadcast it at step i (no later step changes y_i)
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int i = s * 32 + lane;
      if (i >= c && i < p) Y[i * ld + c] = __fmul_rn(y[s], rr[s]);
    }
  }
  __syncthreads();
  CHOL_STAMP(3);

  // logdet: the logs in parallel, their sum in order (warp 0).
  if (warp == 0) {
    float lg[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int i = s * 32 + lane;
      lg[s] = i < p ? logf(L[i * ld + i]) : 0.f;
    }
    float acc = 0.f;
#pragma unroll
    for (int sj = 0; sj < R; ++sj) {
#pragma unroll
      for (int jl = 0; jl < 32; ++jl) {
        const float t = __shfl_sync(kFull, lg[sj], jl);
        if (sj * 32 + jl < p) acc = __fadd_rn(acc, t);
      }
    }
    if (lane == 0) logdet[blockIdx.x] = acc;
  }
  CHOL_STAMP(4);

  // K^-1 = Y^T Y: element (i, k), i >= k, sums Y[j][i] Y[j][k] over j >= i.
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (tid + s * nt >= ne) break;
    const int i = ik[s] >> 8, k = ik[s] & 0xff;
    float acc = 0.f;
#pragma unroll 4
    for (int j = i; j < p; ++j) acc = __fadd_rn(acc, __fmul_rn(Y[j * ld + i], Y[j * ld + k]));
    kinv[off + i * p + k] = acc;
    if (i != k) kinv[off + k * p + i] = acc;
  }
  CHOL_STAMP(5);
}

template <int R>
cudaError_t launch(const float* K, int batch, int p, float* kinv, float* logdet,
                   cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(p) * odd_ld(p);
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(chol_inv_logdet_kernel<R>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chol_inv_logdet_kernel<R><<<batch, block_threads(p), smem, stream>>>(K, p, kinv, logdet);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream` for `batch` contiguous (p, p) fp32
// matrices; writes kinv (batch, p, p) and logdet (batch,).  Returns the
// first non-zero CUDA error (0 when the launch was accepted).
int chol_inv_logdet_launch(const float* K, int batch, int p, float* kinv, float* logdet,
                           void* stream) {
  if (batch < 1 || p < 1 || p > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((p + 31) / 32) {
    case 1: err = launch<1>(K, batch, p, kinv, logdet, st); break;
    case 2: err = launch<2>(K, batch, p, kinv, logdet, st); break;
    case 3: err = launch<3>(K, batch, p, kinv, logdet, st); break;
    default: err = launch<4>(K, batch, p, kinv, logdet, st); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
