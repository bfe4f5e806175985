// Greedy column-pivoted QR pivots (read-only left-looking CGS2) for Hopper,
// in one persistent cooperative launch per call.
//
// Replaces both TPU kernels of the JAX package, which compute the same
// function and differ only in where the panel lives on the TPU:
//   * _qrcp_kernel          openmeasure_tpu/linalg/qrcp_pallas.py:66
//     (whole panel resident in VMEM; entry qrcp_pivots_pallas, :100)
//   * _qrcp_streamed_kernel openmeasure_tpu/linalg/qrcp_pallas.py:137
//     (panel re-streamed from HBM per step, optional in-kernel row scale;
//     entry qrcp_pivots_streamed, :219)
// Their split follows the TPU's 128 MB VMEM.  Hopper's counterpart of a
// panel held on chip for all k steps is the shared memory of all its SMs
// together (132 x 227 KB, about 30 MB): one kernel holds as much of the
// panel there as fits and reads the rest from global memory at each step.
// The flagship panel (14 x 165,258 fp32 = 9.25 MB) is held whole, the 3D
// panel (14 x 1,723,599 = 96.5 MB) 22.6 % of it.
//
// What it computes (exactly linalg/qrcp.py of the JAX package, on
// diag(row_scale) @ A):
//   norms[j] = sum_i (s_i A_ij)^2
//   for each step i < k:
//     j = argmax(norms), ties to the LOWEST index (LAPACK / jnp.argmax),
//         a NaN norm above every number (torch.argmax / jnp.argmax)
//     col = s * A[:, j];  two Gram-Schmidt passes against Q[:, :i]
//     q = col / sqrt(max(|col|^2, FLT_MIN));  Q[:, i] = q
//     norms -= (q^T (s * A))^2;  norms[j] = -inf;  pivots[i] = j
// k may exceed n: once every column is a pivot, all norms are -inf and each
// later step picks column 0, the lowest index, as the plain sweep does.
// The panel is never written, and no padded copy of it is made: the kernel
// reads A through the strides it is given and masks the ragged edge.
//
// What bounds it.  By the rule "each input byte read once", the bound is
// the panel's bytes over the HBM rate (3.35 TB/s): 2.8 us at the flagship
// shape, 28.8 us at the 3D shape; the arithmetic (2 r n flops per step, in
// fp32 off the tensor cores) is smaller.  The algorithm reads the panel
// once per step, k + 1 passes; and each step is a grid-wide argmax followed
// by a pivot column that every column's downdate needs, so it has 2k
// grid-wide dependencies whatever the bytes.  On an H100 80GB HBM3 at
// 700 W (profile_torch.py, device time) a step costs about 6.5 us of
// barriers and select however few the columns, 9.3 us at the flagship
// shape (0.136 ms a call) and 52 us at 3D, where the streamed columns are
// read at about 1.7 TB/s (0.78 ms a call).
//
// What the design does about it.
//   * One launch (cudaLaunchCooperativeKernel) of one block per SM, every
//     block co-resident, and grid barriers between the phases of a step in
//     place of launches: no launch gap and no host work per step.
//   * Block b owns one contiguous range of columns.  At the init pass it
//     copies as many of them as fit into its dynamic shared memory (up to
//     the opt-in limit), row scale applied, row-major (s[i * res + t]), so
//     that the per-row reads of a warp hit 32 different banks; the later k
//     passes read those columns from shared memory and only the rest from
//     global memory (L2 or HBM).  One code path serves all residencies:
//     all resident at the flagship shape, part at 3D, none for panels
//     taller than one block's shared memory (r > about 58,000).
//   * A column read from global memory is read by one lane through the
//     strides, kChunk rows at a time, so that the lane has that many loads
//     in flight.  On the main path's B.T a warp's load then touches 32
//     lines, and L1 serves the column's later rows: when columns are
//     streamed, the plan leaves 64 KB of the SM's shared memory to L1 (with
//     28 KB of L1 the reads ran at a third of the rate on an H100; a
//     coalesced warp read through a staging buffer in shared memory
//     measured no faster than this).
//   * Per step: grid barrier -> block 0 selects (argmax of the per-block
//     partials, gather and scale of the pivot column, CGS2 against Q,
//     normalise, Q[:, step] and pivots[step]) -> grid barrier -> every
//     block downdates its columns' norms with q and writes its partial.
//     When k r is small, every block keeps Q in shared memory (block 0
//     builds it there; the others copy q in at each step), so the select's
//     sequential sums run at shared-memory latency, not L2's.
// The launch plan (grid, columns per block, resident columns, staged Q,
// shared memory bytes) is computed by the wrapper (linalg/qrcp_cuda.py,
// _plan) and passed in; the grid never exceeds the co-resident count, and
// a refused cooperative launch is returned as its cudaError.
//
// Grid barriers are cooperative_groups' grid.sync(), which needs no
// relocatable device code with this toolkit, and whose fences order the
// writes before it with the reads after it across blocks: Q, the pivots
// and the partials, written by one block and read by others, are plain
// loads after a barrier.  The read-only path (__ldg) serves only the panel
// and the row scale, which nothing writes.
//
// Rounding: every sum runs sequentially over its index in a fixed order,
// with separately rounded products and no FMA contraction (the _rn
// intrinsics), the same sequence as the plain version in linalg/qrcp.py of
// this package.  Late greedy steps compare deflated norms that are small
// differences of large ones, where round-off alone can decide the argmax
// (decades-spread row scales make this common); with the same rounding
// the kernel and its plain version agree bit for bit, whether a column is
// read from shared or global memory.
// Column indices run in 64 bits so addresses cannot overflow near
// n = 2^31.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // one block per SM
constexpr int kMaxK = 128;      // pivot cap, as the TPU kernels
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;      // rows of a global column loaded at once

struct Args {
  const float* A;      // (r, n) panel, A[i * sr + j * sc]
  const float* scale;  // (r,) row scale, or null
  int64_t sr, sc;
  int r, n, k;
  int cols_per_block;  // block b owns [b * cols_per_block, ...) up to n
  int resident;        // leading columns of its range a block holds in smem
  int q_staged;        // 1: every block keeps Q (k * r) in shared memory
  int* pivots;         // (k,)
  float* norms;        // (n,)
  float* part_v;       // (gridDim.x,) per-block (max, lowest index)
  int* part_i;
  float* Q;            // (k * r), column i at Q + i * r
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

// (v1, i1) beats (v2, i2) in the order of torch.argmax and jnp.argmax:
// NaN above every number, then the larger value; equal values, and NaNs
// among themselves, to the lower index.
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  const bool nan1 = v1 != v1, nan2 = v2 != v2;  // IEEE: only NaN != itself
  if (nan1 || nan2) return nan1 && (!nan2 || i1 < i2);
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

// Block-wide argmax; result in thread 0.  Two calls are always separated
// by a barrier (block or grid) in this kernel, so sv/si are never
// overwritten while warp 0 reads them.
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
    v = sv[lane];
    i = si[lane];
    warp_argmax(v, i);
  }
}

// s_i A[i, j], read from global memory.
__device__ __forceinline__ float scaled(const Args& a, int64_t j, int i) {
  const float x = __ldg(a.A + i * a.sr + j * a.sc);
  return a.scale ? __fmul_rn(x, __ldg(a.scale + i)) : x;
}

// f(i, s_i A[i, j]) for i = 0 .. r - 1 in order, for this lane's column
// j = c0 + g0 + lane of the warp's group of `valid` <= 32 columns starting
// at c0 + g0 (lanes past `valid` load nothing and get zeros that they must
// not use).  Each lane reads its column through the strides, kChunk rows
// at a time, so that it has that many loads in flight.
template <class F>
__device__ __forceinline__ void for_column(const Args& a, int64_t c0, int g0, int valid, F&& f) {
  const int lane = threadIdx.x & 31;
  const int64_t j = c0 + g0 + lane;
  for (int i0 = 0; i0 < a.r; i0 += kChunk) {
    float x[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      x[u] = (lane < valid && i0 + u < a.r) ? scaled(a, j, i0 + u) : 0.f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (i0 + u < a.r) f(i0 + u, x[u]);
  }
}

// Init: norms of the block's columns, the resident ones copied (scaled) into
// shared memory on the way, and the block's (max, lowest index) partial.
// Columns go by warp groups: warp w takes 32 consecutive columns at a time.
__device__ __forceinline__ void init_pass(const Args& a, int64_t c0, int cnt, int res, float* sp) {
  const int lane = threadIdx.x & 31;
  float best_v = neg_inf();
  int best_i = INT_MAX;
  for (int g0 = threadIdx.x & ~31; g0 < cnt; g0 += kThreads) {
    const int t = g0 + lane;
    const int valid = min(32, cnt - g0);
    float s2 = 0.f;
    for_column(a, c0, g0, valid, [&](int i, float x) {
      s2 = __fadd_rn(s2, __fmul_rn(x, x));
      if (t < res) sp[i * res + t] = x;
    });
    if (lane < valid) {
      const int64_t j = c0 + t;
      a.norms[j] = s2;
      if (better(s2, static_cast<int>(j), best_v, best_i)) {
        best_v = s2;
        best_i = static_cast<int>(j);
      }
    }
  }
  block_argmax(best_v, best_i);
  if (threadIdx.x == 0) {
    a.part_v[blockIdx.x] = best_v;
    a.part_i[blockIdx.x] = best_i;
  }
}

// Block 0 only: j = argmax of the partials; q = CGS2(s * A[:, j]) against
// Q[:, :step], built in place in Q[:, step] of Qb (this block's copy of Q:
// its shared memory when Q is staged, else Q in global memory);
// Q[:, step] = q / |q|, also written to global memory for the other
// blocks; pivots[step] = j.
__device__ __forceinline__ void select_step(const Args& a, int step, float* Qb) {
  __shared__ float coef[kMaxK];
  __shared__ int s_j;
  __shared__ float s_d;

  float v = neg_inf();
  int idx = INT_MAX;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    const float vb = a.part_v[b];
    const int ib = a.part_i[b];
    if (better(vb, ib, v, idx)) {
      v = vb;
      idx = ib;
    }
  }
  block_argmax(v, idx);
  if (threadIdx.x == 0) {
    // every block owns a column and `better` ranks every value, NaN and
    // -inf included, so idx is a column of the panel
    s_j = idx;
    a.pivots[step] = idx;
  }
  __syncthreads();
  const int64_t j = s_j;
  const int r = a.r;

  // the column is orthogonalised where q will live; each thread owns the
  // rows i it writes, and __syncthreads makes them visible to the block
  float* col = Qb + static_cast<int64_t>(step) * r;
  for (int i = threadIdx.x; i < r; i += kThreads) col[i] = scaled(a, j, i);
  __syncthreads();

  // Two Gram-Schmidt passes against the accepted directions.  Each sum
  // runs sequentially in the plain version's order (rows for coef,
  // directions for the update) with separately rounded products, so the
  // kernel and the plain version produce the same q bit for bit.
  for (int pass = 0; pass < 2; ++pass) {
    for (int c = threadIdx.x; c < step; c += kThreads) {
      const float* qc = Qb + static_cast<int64_t>(c) * r;
      float acc = 0.f;
      for (int i = 0; i < r; ++i) acc = __fadd_rn(acc, __fmul_rn(qc[i], col[i]));
      coef[c] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < r; i += kThreads) {
      float upd = 0.f;
      for (int c = 0; c < step; ++c)
        upd = __fadd_rn(upd, __fmul_rn(Qb[static_cast<int64_t>(c) * r + i], coef[c]));
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
  float* qg = a.Q + static_cast<int64_t>(step) * r;
  for (int i = threadIdx.x; i < r; i += kThreads) {
    const float x = __fdiv_rn(col[i], s_d);
    col[i] = x;
    if (a.q_staged) qg[i] = x;
  }
}

// Every block: norms[j] -= (q^T (s * A[:, j]))^2 over its columns,
// norms[pivot] = -inf, and its next partial.  With Q staged, a block other
// than 0 first copies q into its own Qb.
__device__ __forceinline__ void deflate_step(const Args& a, int step, int64_t c0, int cnt, int res,
                                             const float* sp, float* Qb) {
  const int r = a.r;
  float* q = Qb + static_cast<int64_t>(step) * r;
  const int64_t jp = a.pivots[step];
  if (a.q_staged && blockIdx.x != 0) {
    const float* qg = a.Q + static_cast<int64_t>(step) * r;
    for (int i = threadIdx.x; i < r; i += kThreads) q[i] = qg[i];
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  float best_v = neg_inf();
  int best_i = INT_MAX;
  for (int g0 = threadIdx.x & ~31; g0 < cnt; g0 += kThreads) {
    const int t = g0 + lane;
    const int valid = min(32, cnt - g0);
    const int64_t j = c0 + t;
    // the norm is read before the column, so that the two reads overlap
    const float n_old = lane < valid ? a.norms[j] : 0.f;
    float p = 0.f;
    if (g0 + 32 <= res) {
      for (int i = 0; i < r; ++i) p = __fadd_rn(p, __fmul_rn(q[i], sp[i * res + t]));
    } else {  // a group not all resident is read from global memory
      for_column(a, c0, g0, valid,
                 [&](int i, float x) { p = __fadd_rn(p, __fmul_rn(q[i], x)); });
    }
    if (lane < valid) {
      const float nv = (j == jp) ? neg_inf() : __fsub_rn(n_old, __fmul_rn(p, p));
      a.norms[j] = nv;
      if (better(nv, static_cast<int>(j), best_v, best_i)) {
        best_v = nv;
        best_i = static_cast<int>(j);
      }
    }
  }
  block_argmax(best_v, best_i);
  if (threadIdx.x == 0) {
    a.part_v[blockIdx.x] = best_v;
    a.part_i[blockIdx.x] = best_i;
  }
}

// The whole call: init, then k x (barrier, select in block 0, barrier,
// deflate everywhere).  Dynamic shared memory: [Q: k * r when staged]
// [panel: res * r].
__global__ void __launch_bounds__(kThreads, 1) qrcp_kernel(const Args a) {
  extern __shared__ float smem[];
  float* Qb = a.q_staged ? smem : a.Q;
  float* sp = smem + (a.q_staged ? a.k * a.r : 0);
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * a.cols_per_block;
  const int64_t left = a.n - c0;
  const int cnt = left < a.cols_per_block ? static_cast<int>(left) : a.cols_per_block;
  const int res = a.resident < cnt ? a.resident : cnt;
  cg::grid_group grid = cg::this_grid();

  init_pass(a, c0, cnt, res, sp);
  for (int step = 0; step < a.k; ++step) {
    grid.sync();
    if (blockIdx.x == 0) select_step(a, step, Qb);
    grid.sync();
    deflate_step(a, step, c0, cnt, res, sp, Qb);
  }
}

}  // namespace

extern "C" {

int qrcp_threads() { return kThreads; }

// For the current device: its SM count, the dynamic shared memory one block
// of the kernel may take (the opt-in limit less the kernel's static shared
// memory; the kernel is allowed that much here), and how many blocks of
// the kernel an SM holds at that size.  Returns a cudaError (0 on success);
// cudaErrorNotSupported when the device cannot launch cooperatively.
int qrcp_device_info(int* sms, int* smem_dynamic, int* blocks_per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, qrcp_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_dynamic = optin - static_cast<int>(fa.sharedSizeBytes);
  err = cudaFuncSetAttribute(qrcp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem_dynamic);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, qrcp_kernel, kThreads, *smem_dynamic));
}

// Enqueues the one cooperative launch on `stream` with the wrapper's plan;
// returns its cudaError (0 when it was accepted).  Buffers are the
// caller's: pivots (k,) int32, norms (n,), part_v/part_i (grid,),
// Q (k * r).  `row_scale` may be null.  qrcp_device_info must have run on
// this device first (it allows the kernel its shared memory).
int qrcp_pivots_launch(const float* A, int r, int n, int64_t sr, int64_t sc,
                       const float* row_scale, int k, int grid, int cols_per_block,
                       int resident, int q_staged, int smem_bytes, int* pivots, float* norms,
                       float* part_v, int* part_i, float* Q, void* stream) {
  if (k < 1 || k > kMaxK || grid < 1 ||
      static_cast<int64_t>(grid) * cols_per_block < n ||
      static_cast<int64_t>(grid - 1) * cols_per_block >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{A, row_scale, sr, sc, r, n, k, cols_per_block, resident, q_staged,
         pivots, norms, part_v, part_i, Q};
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      (void*)qrcp_kernel, dim3(grid), dim3(kThreads), args,
      static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
