// The fixed-budget ADMM iteration of the box-constrained QP for Hopper.
//
// Replaces no TPU kernel.  The JAX package's ADMM
// (openmeasure_tpu/linalg/boxls.py, admm_box_qp, :295) is a lax.while_loop
// that XLA compiles into one program; eager PyTorch runs the same
// iteration (openmeasure_torch/linalg/boxls.py, _admm) as about seventy
// launches and forty passes over the (b, n) iterates.  These two kernels
// run it as two launches: the row pass and the r-step.
//
// One iteration, for every frame j of the batch that has not stopped
// (conv[j] == 0), from gn[j] (r,), the step's coefficients:
//   row pass, for each constraint row i:
//     Ag     = A[i,:] . gn[j,:]
//     rel    = alpha Ag + (1 - alpha) z
//     wt     = s[j] w                        (the lazy rescale of w)
//     z_n    = clamp(rel + wt, lo, hi)
//     w_n    = (wt + rel) - z_n              z, w <- z_n, w_n in place
//     sums over the block's rows: |Ag - z_n|^2, A^T(z_n - z), A^T z_n,
//     A^T w_n (fixed rho: A^T(z_n - w_n) alone)
//   r-step, one block a frame:
//     the block sums in block order; pri = |Ag - z_n| / sqrt(n_rows),
//     dua = rho |A^T(z_n - z)| / sqrt(r), stop when both are 0 (tol = 0),
//     rho_n = clamp(rho f, rho0 1e-6, rho0 1e6), f = 2, 1/2 or 1 by
//     residual balancing, s = rho / rho_n;  g <- gn;
//     gn <- (L L^T)^-1 (c + rho_n (A^T z_n - s A^T w_n)),
//     L = chol(H + rho_n AtA + 64 eps tr/r I)   (fixed rho: L given).
// w is kept unscaled: the frame's dual is s[j] w, so the rescale costs no
// pass.  A stopped frame's z, w, g, rho, pri, dua and k stay as they are.
//
// What bounds it.  An iteration at the main shape (b = 50, n = 165,258,
// r = 14) reads and writes z and w (4 x 33.05 MB) and reads A (9.25 MB)
// and the bounds (2 x 0.66 MB): 142.8 MB, 42.6 us at 3.35 TB/s.  The
// work, 4r fused multiply-adds an (frame, row), is 0.46 G, 14 us at
// 67 TFLOP/s: bytes bind.
//
// What the design does about it.
//   * Row pass: a block owns a strip of rows and stages its strip of A in
//     shared memory once, transposed (As[q * rows + t]: a lane's row is
//     one bank), zero-padded to R columns, for all its frames.  Each warp
//     walks the strip for one frame at a time, 32 consecutive rows a
//     step, kUnroll steps' loads of z, w, lo and hi in flight, so every
//     access to the (b, n) arrays is coalesced and each of z and w is
//     read and written once.  A warp keeps its frame's 3r + 1 partial
//     sums in registers over the whole strip and reduces them once, by
//     shuffles, into one slot a (block, frame) of `part` (laid out
//     [frame][sum][block], so the r-step reads each sum's slots
//     contiguously).  No float atomics: the sums are taken in one order,
//     and a batch served twice gives the same bits.  (Tried on the card
//     and slower: 16-byte accesses of 4 rows a lane, which spill at the
//     128 registers a 512-thread block allows; loads of the next step
//     issued before the current one's arithmetic; A row-major with
//     16-byte shared loads; a transposed warp reduction with the frames'
//     coefficients staged in shared memory; 17 warps of 3 frames.)
//   * r-step: one block a frame; warp 0 first fetches the frame's rho, c
//     and rows of H and AtA (or of Lfix), whose latency passes while the
//     warps sum the slots of one sum each in a fixed order; then warp 0
//     holds the (r, r) matrix a row a lane in registers, factors it
//     right-looking by shuffles and solves the two triangular systems by
//     the reciprocals of the diagonal.
//   * fp32 with FMA, no TF32, no lower precision.
//
// Template R: r rounded up to 4, 8, 16 or 32; padded columns of A are
// zero, padded rows of the (r, r) system are the identity.  ADAPT: the
// residual-balancing rho; without it the norms and the dual sums are not
// formed and the factor Lfix is the loop's, computed once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRMax = 32;
constexpr int kWarpsMax = 16;      // row-pass warps a block (WARPS_MAX)
constexpr int kUnroll = 4;         // 32-row steps a warp has in flight
constexpr int kStepThreads = 256;  // r-step block
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// One solve's arguments; linalg/admm_cuda.py's _Args mirrors it field for
// field.
struct AdmmArgs {
  const float* A;     // (n, r) row-major
  const float* lo;    // (n,) shared, or (b, n): frame j's at lo + j * lo_bs
  const float* hi;
  float* z;           // (b, n), updated in place
  float* w;           // (b, n), unscaled, updated in place
  const float* H;     // (r, r) at H + j * H_bs
  const float* c;     // (b, r)
  const float* AtA;   // (r, r) at AtA + j * AtA_bs
  const float* Lfix;  // (b, r, r) lower factor at the fixed rho
  float* g;           // (b, r) accepted iterate
  float* gn;          // (b, r) next step's coefficients
  float* rho;         // (b,)
  const float* rho0;  // (b,)
  float* s;           // (b,) lazy scale of w
  float* pri;         // (b,)
  float* dua;         // (b,)
  int* k;             // (b,) iterations taken
  int* conv;          // (b,) 1 once stopped
  float* part;        // (b, slot, grid) partial sums
  void* stream;
  long long lo_bs, hi_bs, H_bs, AtA_bs;
  int n, r, b, rows, grid, warps, adapt, smem;
  float alpha, beta, sqrt_n, sqrt_r, ridge;
};

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// torch.maximum / torch.minimum: NaN in either gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

template <int R, bool ADAPT>
__global__ void __launch_bounds__(kWarpsMax * 32) row_pass(const AdmmArgs a) {
  extern __shared__ float As[];  // As[q * rows + t] = A[i0 + t][q]
  const int r = a.r, rows = a.rows;
  const int i0 = blockIdx.x * rows;
  const int nrow = min(rows, a.n - i0);
  const float* Ab = a.A + static_cast<size_t>(i0) * r;
  for (int e = threadIdx.x; e < nrow * r; e += blockDim.x) {
    const int t = e / r;
    As[(e - t * r) * rows + t] = Ab[e];
  }
  for (int e = threadIdx.x; e < (R - r) * rows; e += blockDim.x) As[r * rows + e] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = ADAPT ? 3 * r + 1 : r;
  for (int j = warp; j < a.b; j += a.warps) {
    if (ADAPT && a.conv[j]) continue;  // stopped: frozen
    float gq[R];
#pragma unroll
    for (int q = 0; q < R; ++q) gq[q] = q < r ? a.gn[j * r + q] : 0.f;
    const float sj = ADAPT ? a.s[j] : 1.f;
    const size_t off = static_cast<size_t>(j) * a.n + i0;
    float* z = a.z + off;
    float* w = a.w + off;
    const float* lo = a.lo + j * a.lo_bs + i0;
    const float* hi = a.hi + j * a.hi_bs + i0;
    float ee = 0.f, s1[R], s2[R], s3[R];
#pragma unroll
    for (int q = 0; q < R; ++q) s1[q] = s2[q] = s3[q] = 0.f;
    for (int base = 0; base < nrow; base += 32 * kUnroll) {
      float zv[kUnroll], wv[kUnroll], lv[kUnroll], hv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + 32 * u + lane;
        if (t < nrow) { zv[u] = z[t]; wv[u] = w[t]; lv[u] = lo[t]; hv[u] = hi[t]; }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + 32 * u + lane;
        if (t < nrow) {
          float aq[R], ag = 0.f;
#pragma unroll
          for (int q = 0; q < R; ++q) {
            aq[q] = As[q * rows + t];
            ag = fmaf(aq[q], gq[q], ag);
          }
          const float rel = fmaf(a.alpha, ag, a.beta * zv[u]);
          const float wt = ADAPT ? sj * wv[u] : wv[u];
          float zn = rel + wt;  // clamp(x, lo, hi); a NaN x stays NaN
          zn = zn < lv[u] ? lv[u] : zn;
          zn = zn > hv[u] ? hv[u] : zn;
          const float wn = (wt + rel) - zn;
          z[t] = zn;
          w[t] = wn;
          if (ADAPT) {
            const float e = ag - zn, dz = zn - zv[u];
            ee = fmaf(e, e, ee);
#pragma unroll
            for (int q = 0; q < R; ++q) {
              s1[q] = fmaf(aq[q], dz, s1[q]);
              s2[q] = fmaf(aq[q], zn, s2[q]);
              s3[q] = fmaf(aq[q], wn, s3[q]);
            }
          } else {
            const float v = zn - wn;
#pragma unroll
            for (int q = 0; q < R; ++q) s1[q] = fmaf(aq[q], v, s1[q]);
          }
        }
      }
    }

    // one reduction a strip; lane 0 writes the frame's slots of this block
    float* out = a.part + static_cast<size_t>(j) * slot * a.grid + blockIdx.x;
    if (ADAPT) {
      ee = warp_sum(ee);
      if (lane == 0) out[0] = ee;
    }
    const int o1 = ADAPT ? 1 : 0;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (q < r) {
        const float v = warp_sum(s1[q]);
        if (lane == 0) out[static_cast<size_t>(o1 + q) * a.grid] = v;
        if (ADAPT) {
          const float v2 = warp_sum(s2[q]), v3 = warp_sum(s3[q]);
          if (lane == 0) {
            out[static_cast<size_t>(1 + r + q) * a.grid] = v2;
            out[static_cast<size_t>(1 + 2 * r + q) * a.grid] = v3;
          }
        }
      }
    }
  }
}

template <int R, bool ADAPT>
__global__ void __launch_bounds__(kStepThreads) r_step(const AdmmArgs a) {
  __shared__ float tot[3 * kRMax + 1];
  __shared__ float Ls[R][R + 1];
  const int j = blockIdx.x;
  const int r = a.r;
  const int slot = ADAPT ? 3 * r + 1 : r;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // warp 0 fetches the frame's own inputs first: their latency passes
  // while the block sums the slots
  float rho = 0.f, rho0 = 0.f, cj = 0.f, m[R], ga[R];
  int stopped = 0;
  if (warp == 0) {
    rho = a.rho[j];
    if (ADAPT) {
      rho0 = a.rho0[j];
      stopped = a.conv[j];
    }
    if (lane < r) {
      cj = a.c[j * r + lane];
      const float* src = ADAPT ? a.H + j * a.H_bs + lane * r
                               : a.Lfix + (static_cast<size_t>(j) * r + lane) * r;
#pragma unroll
      for (int q = 0; q < R; ++q) m[q] = q < r && (ADAPT || q <= lane) ? src[q] : 0.f;
      if (ADAPT) {
        const float* G = a.AtA + j * a.AtA_bs + lane * r;
#pragma unroll
        for (int q = 0; q < R; ++q) ga[q] = q < r ? G[q] : 0.f;
      }
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) m[q] = ga[q] = 0.f;
    }
  }

  // the block sums, each in block order within a lane and by one fixed
  // shuffle tree across the lanes (a stopped frame's slots are stale and
  // unused)
  for (int p = warp; p < slot; p += kStepThreads / 32) {
    const float* src = a.part + (static_cast<size_t>(j) * slot + p) * a.grid;
    float v = 0.f;
#pragma unroll 4
    for (int q = lane; q < a.grid; q += 32) v += src[q];
    v = warp_sum(v);
    if (lane == 0) tot[p] = v;
  }
  __syncthreads();
  if (warp != 0 || stopped) return;  // a stopped frame stays frozen

  float rhs = 0.f;
  if (ADAPT) {
    const float d = lane < r ? tot[1 + lane] : 0.f;
    const float dn = sqrtf(warp_sum(d * d));
    const float pri_n = sqrtf(tot[0]) / a.sqrt_n;
    const float dua_n = rho * dn / a.sqrt_r;
    const bool conv_n = pri_n <= 0.f && dua_n <= 0.f;
    const float f = pri_n > 10.f * dua_n ? 2.f : (dua_n > 10.f * pri_n ? 0.5f : 1.f);
    const float rho_n = nan_min(nan_max(rho * f, rho0 * 1e-6f), rho0 * 1e6f);
    const float s_n = rho / rho_n;
    if (lane == 0) {
      a.rho[j] = rho_n;
      a.pri[j] = pri_n;
      a.dua[j] = dua_n;
      a.k[j] += 1;
      a.s[j] = s_n;
      a.conv[j] = conv_n ? 1 : 0;
    }
    rho = rho_n;
    float diag = 0.f;
    if (lane < r) {
      rhs = fmaf(rho, fmaf(-s_n, tot[1 + 2 * r + lane], tot[1 + r + lane]), cj);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        m[q] = fmaf(rho, ga[q], m[q]);  // H + rho AtA
        if (q == lane) diag = m[q];
      }
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) m[q] = q == lane ? 1.f : 0.f;
    }
    const float shift = a.ridge * (warp_sum(diag) / static_cast<float>(r));
    if (lane < r) {
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (q == lane) m[q] += shift;
    }
    // right-looking Cholesky: at step q lane i >= q turns m[q] into
    // L[i][q] and updates its entries of the trailing columns
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float lqq = sqrtf(__shfl_sync(kFull, m[q], q));
      const float inv = 1.f / lqq;
      const float l = lane == q ? lqq : m[q] * inv;
      m[q] = l;
#pragma unroll
      for (int p = q + 1; p < R; ++p) m[p] = fmaf(-l, __shfl_sync(kFull, l, p), m[p]);
    }
  } else {
    if (lane < r) {
      rhs = fmaf(rho, tot[lane], cj);
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) m[q] = q == lane ? 1.f : 0.f;
    }
  }
  if (lane < r) a.g[j * r + lane] = a.gn[j * r + lane];  // accept the step

  // L y = rhs, then L^T x = y, by the reciprocal of each lane's diagonal;
  // lane i ends with x_i
  float diag_l = 1.f;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (lane < R) Ls[lane][q] = m[q];
    if (q == lane) diag_l = m[q];
  }
  const float dinv = 1.f / diag_l;
  __syncwarp();
  float acc = rhs, x = 0.f;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float t = __shfl_sync(kFull, acc * dinv, q);
    if (lane == q) x = t;
    if (lane > q) acc = fmaf(-m[q], t, acc);
  }
  acc = x;
#pragma unroll
  for (int q = R - 1; q >= 0; --q) {
    const float t = __shfl_sync(kFull, acc * dinv, q);
    if (lane == q) x = t;
    if (lane < q) acc = fmaf(-Ls[q][lane], t, acc);
  }
  if (lane < r) a.gn[j * r + lane] = x;
}

template <int R, bool ADAPT>
cudaError_t prepare(const AdmmArgs& a) {
  return cudaFuncSetAttribute(row_pass<R, ADAPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              a.smem);
}

template <int R, bool ADAPT>
cudaError_t launch_row(const AdmmArgs& a) {
  row_pass<R, ADAPT><<<a.grid, a.warps * 32, a.smem, static_cast<cudaStream_t>(a.stream)>>>(a);
  return cudaGetLastError();
}

template <int R, bool ADAPT>
cudaError_t launch_step(const AdmmArgs& a) {
  r_step<R, ADAPT><<<a.b, kStepThreads, 0, static_cast<cudaStream_t>(a.stream)>>>(a);
  return cudaGetLastError();
}

bool valid(const AdmmArgs& a) {
  return a.r >= 1 && a.r <= kRMax && a.b >= 1 && a.n >= 1 && a.rows >= 1 && a.grid >= 1 &&
         static_cast<long long>(a.grid) * a.rows >= a.n && a.warps >= 1 && a.warps <= kWarpsMax;
}

// the instantiation of `fn` for a's R and mode
template <template <int, bool> class F>
cudaError_t dispatch(const AdmmArgs& a) {
  if (!valid(a)) return cudaErrorInvalidValue;
  const bool ad = a.adapt != 0;
  if (a.r <= 4) return ad ? F<4, true>::run(a) : F<4, false>::run(a);
  if (a.r <= 8) return ad ? F<8, true>::run(a) : F<8, false>::run(a);
  if (a.r <= 16) return ad ? F<16, true>::run(a) : F<16, false>::run(a);
  return ad ? F<32, true>::run(a) : F<32, false>::run(a);
}

template <int R, bool ADAPT>
struct Prepare {
  static cudaError_t run(const AdmmArgs& a) { return prepare<R, ADAPT>(a); }
};
template <int R, bool ADAPT>
struct Row {
  static cudaError_t run(const AdmmArgs& a) { return launch_row<R, ADAPT>(a); }
};
template <int R, bool ADAPT>
struct Step {
  static cudaError_t run(const AdmmArgs& a) { return launch_step<R, ADAPT>(a); }
};

}  // namespace

extern "C" {

// Once a solve, before its launches: lets the row pass take a.smem bytes
// of dynamic shared memory.
int admm_prepare(const AdmmArgs* a) { return static_cast<int>(dispatch<Prepare>(*a)); }

// One row pass, one r-step: each enqueues one launch on a->stream and
// returns the launch's error (0 when accepted).
int admm_row_launch(const AdmmArgs* a) { return static_cast<int>(dispatch<Row>(*a)); }
int admm_step_launch(const AdmmArgs* a) { return static_cast<int>(dispatch<Step>(*a)); }

// The current device's SM count and the dynamic shared memory a block may
// opt in to.
int admm_device_info(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

int admm_r_max() { return kRMax; }
int admm_step_threads() { return kStepThreads; }

}  // extern "C"
