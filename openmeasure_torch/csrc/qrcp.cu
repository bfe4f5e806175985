// Greedy column-pivoted QR pivots (read-only left-looking CGS2) for Hopper.
//
// Replaces both TPU kernels of the JAX package, which compute the same
// function and differ only in where the panel lives on the TPU:
//   * _qrcp_kernel          openmeasure_tpu/linalg/qrcp_pallas.py:66
//     (whole panel resident in VMEM; entry qrcp_pivots_pallas, :100)
//   * _qrcp_streamed_kernel openmeasure_tpu/linalg/qrcp_pallas.py:137
//     (panel re-streamed from HBM per step, optional in-kernel row scale;
//     entry qrcp_pivots_streamed, :219)
// Their split is an artefact of the TPU's 128 MB VMEM.  On Hopper no (r, n)
// panel of interest fits in one block's 227 KB of shared memory, so one
// kernel set serves both: every step is one pass over the panel, from L2
// when the panel fits the 50 MB L2 (flagship 14 x 165,258 fp32 = 9.25 MB)
// and from HBM when it does not (3D 14 x 1,723,599 fp32 = 96.5 MB).
//
// What it computes (exactly linalg/qrcp.py of the JAX package, on
// diag(row_scale) @ A):
//   norms[j] = sum_i (s_i A_ij)^2
//   for each step i < k:
//     j = argmax(norms), ties to the LOWEST index (LAPACK / jnp.argmax)
//     col = s * A[:, j];  two Gram-Schmidt passes against Q[:, :i]
//     q = col / sqrt(max(|col|^2, FLT_MIN));  Q[:, i] = q
//     norms -= (q^T (s * A))^2;  norms[j] = -inf;  pivots[i] = j
// The panel is never written, and no padded copy of it is made: the kernels
// read A through the strides they are given and mask the ragged edge.
//
// What bounds it.  By the rule "each input byte read once", the bound is
// the panel's bytes over the HBM rate (3.35 TB/s): 2.8 us at the flagship
// shape, 28.8 us at the 3D shape; the arithmetic (2 r n flops per step, in
// fp32 off the tensor cores) is smaller.  The algorithm itself re-reads the
// panel once per step: k + 1 passes, from L2 at the flagship shape and
// from HBM (about 1.45 GB, 430 us at 3D) when the panel exceeds L2.
//
// What the design does about it.  The simple, correct form first:
//   init     one grid-wide launch: norms and per-block (max, index) partials
//   select   one single-block launch per step: reduces the partials to j,
//            gathers and scales column j into Q[:, step], runs CGS2 there
//            against Q[:, :step] (global memory, r x k), normalises it in
//            place and writes pivots[step]
//   deflate  one grid-wide launch per step: q^T (s * A) per column,
//            downdates the norms, sets -inf at the pivot, writes the next
//            partials
// Rounding: every sum runs sequentially over its index in a fixed order,
// with separately rounded products and no FMA contraction (the _rn
// intrinsics), the same sequence as the plain version in linalg/qrcp.py of
// this package.  Late greedy steps compare deflated norms that are small
// differences of large ones, where round-off alone can decide the argmax
// (decades-spread row scales make this common); with the same rounding
// the kernel and its plain version agree bit for bit.
// No buffer is sized by r in shared memory: q, the row scale and the
// pivot column are read from global memory (q and the scale are the same
// address across a warp, served from L1), so any r < 2^31 is taken.
// Column indices run in 64 bits so the grid stride cannot overflow near
// n = 2^31.
// 1 + 2k launches on one stream, pivots stay on the device: no host
// synchronization per step.  The grid is sized to one resident wave so
// each thread walks several columns and the partials stay small.  Launch
// gaps, not bandwidth, dominate at the flagship shape; fusing the select
// into the deflate's last block, or one persistent cooperative launch, is
// the next step.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;        // init / deflate block size
constexpr int kSelectThreads = 256;  // select block size
constexpr int kMaxK = 128;           // pivot cap, as the TPU kernels
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

// (v1, i1) beats (v2, i2): larger value, equal values to the lower index.
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    if (better(v2, i2, v, i)) {
      v = v2;
      i = i2;
    }
  }
}

// Block-wide argmax of blockDim.x == kThreads threads; result in thread 0.
__device__ __forceinline__ void block_argmax(float& v, int& i) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : neg_inf();
    i = lane < kWarps ? si[lane] : INT_MAX;
    warp_argmax(v, i);
  }
}

// norms[j] = |s * A[:, j]|^2, and each block's (max, lowest index) partial.
__global__ void __launch_bounds__(kThreads)
qrcp_init_kernel(const float* __restrict__ A, int r, int n, int64_t sr, int64_t sc,
                 const float* __restrict__ scale, float* __restrict__ norms,
                 float* __restrict__ part_v, int* __restrict__ part_i) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  float best_v = neg_inf();
  int best_i = INT_MAX;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const float* a = A + j * sc;
    float s2 = 0.f;
    for (int i = 0; i < r; ++i) {
      const float x = __fmul_rn(a[i * sr], scale ? scale[i] : 1.f);
      s2 = __fadd_rn(s2, __fmul_rn(x, x));
    }
    norms[j] = s2;
    if (better(s2, static_cast<int>(j), best_v, best_i)) {
      best_v = s2;
      best_i = static_cast<int>(j);
    }
  }
  block_argmax(best_v, best_i);
  if (threadIdx.x == 0) {
    part_v[blockIdx.x] = best_v;
    part_i[blockIdx.x] = best_i;
  }
}

// One block: j = argmax of the partials; q = CGS2(s * A[:, j]) against
// Q[:, :step], built in place in Q[:, step]; Q[:, step] = q / |q|;
// pivots[step] = j.
__global__ void __launch_bounds__(kSelectThreads)
qrcp_select_kernel(const float* __restrict__ A, int r, int n, int64_t sr, int64_t sc,
                   const float* __restrict__ scale, const float* __restrict__ part_v,
                   const int* __restrict__ part_i, int nparts, int step,
                   float* __restrict__ Q, int* __restrict__ pivots) {
  __shared__ float coef[kMaxK];
  __shared__ int s_j;
  __shared__ float s_d;

  float v = neg_inf();
  int idx = INT_MAX;
  for (int b = threadIdx.x; b < nparts; b += blockDim.x) {
    if (better(part_v[b], part_i[b], v, idx)) {
      v = part_v[b];
      idx = part_i[b];
    }
  }
  block_argmax(v, idx);
  if (threadIdx.x == 0) {
    // only a panel with non-finite norms leaves no candidate; keep the
    // gather in bounds (the plain version's argmax would pick a NaN)
    if (idx < 0 || idx >= n) idx = 0;
    s_j = idx;
    pivots[step] = idx;
  }
  __syncthreads();
  const int64_t j = s_j;

  // the column is orthogonalised where q will live; each thread owns the
  // rows i it writes, and __syncthreads makes them visible to the block
  float* col = Q + static_cast<int64_t>(step) * r;
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const float x = A[i * sr + j * sc];
    col[i] = scale ? __fmul_rn(x, scale[i]) : x;
  }
  __syncthreads();

  // Two Gram-Schmidt passes against the accepted directions.  Each sum
  // runs sequentially in the plain version's order (rows for coef,
  // directions for the update) with separately rounded products, so the
  // kernel and the plain version produce the same q bit for bit.
  for (int pass = 0; pass < 2; ++pass) {
    for (int c = threadIdx.x; c < step; c += blockDim.x) {
      const float* qc = Q + static_cast<int64_t>(c) * r;
      float acc = 0.f;
      for (int i = 0; i < r; ++i) acc = __fadd_rn(acc, __fmul_rn(qc[i], col[i]));
      coef[c] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < r; i += blockDim.x) {
      float upd = 0.f;
      for (int c = 0; c < step; ++c)
        upd = __fadd_rn(upd, __fmul_rn(Q[static_cast<int64_t>(c) * r + i], coef[c]));
      col[i] = __fsub_rn(col[i], upd);
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    float ss = 0.f;
    for (int i = 0; i < r; ++i) ss = __fadd_rn(ss, __fmul_rn(col[i], col[i]));
    s_d = __fsqrt_rn(fmaxf(ss, FLT_MIN));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < r; i += blockDim.x) col[i] = __fdiv_rn(col[i], s_d);
}

// norms[j] -= (q^T (s * A[:, j]))^2, norms[pivot] = -inf, next partials.
__global__ void __launch_bounds__(kThreads)
qrcp_deflate_kernel(const float* __restrict__ A, int r, int n, int64_t sr, int64_t sc,
                    const float* __restrict__ scale, const float* __restrict__ Q,
                    const int* __restrict__ pivots, int step, float* __restrict__ norms,
                    float* __restrict__ part_v, int* __restrict__ part_i) {
  const float* q = Q + static_cast<int64_t>(step) * r;
  const int64_t jp = pivots[step];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  float best_v = neg_inf();
  int best_i = INT_MAX;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const float* a = A + j * sc;
    float p = 0.f;
    for (int i = 0; i < r; ++i)
      p = __fadd_rn(p, __fmul_rn(q[i], __fmul_rn(a[i * sr], scale ? scale[i] : 1.f)));
    const float nv = (j == jp) ? neg_inf() : __fsub_rn(norms[j], __fmul_rn(p, p));
    norms[j] = nv;
    if (better(nv, static_cast<int>(j), best_v, best_i)) {
      best_v = nv;
      best_i = static_cast<int>(j);
    }
  }
  block_argmax(best_v, best_i);
  if (threadIdx.x == 0) {
    part_v[blockIdx.x] = best_v;
    part_i[blockIdx.x] = best_i;
  }
}

}  // namespace

extern "C" {

int qrcp_threads() { return kThreads; }

// Enqueues the 1 + 2k launches on `stream`; returns the first non-zero
// cudaGetLastError() (0 when every launch was accepted).  Buffers are the
// caller's: pivots (k,) int32, norms (n,), part_v/part_i (nblocks,),
// Q (k * r).  `row_scale` may be null.
int qrcp_pivots_launch(const float* A, int r, int n, int64_t sr, int64_t sc,
                       const float* row_scale, int k, int nblocks, int* pivots,
                       float* norms, float* part_v, int* part_i, float* Q,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  qrcp_init_kernel<<<nblocks, kThreads, 0, s>>>(A, r, n, sr, sc, row_scale, norms,
                                                part_v, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int step = 0; step < k; ++step) {
    qrcp_select_kernel<<<1, kSelectThreads, 0, s>>>(A, r, n, sr, sc, row_scale, part_v,
                                                    part_i, nblocks, step, Q, pivots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    qrcp_deflate_kernel<<<nblocks, kThreads, 0, s>>>(A, r, n, sr, sc, row_scale, Q,
                                                     pivots, step, norms, part_v, part_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
