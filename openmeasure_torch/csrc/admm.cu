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
//     sums over a segment of rows: |Ag - z_n|^2, A^T(z_n - z), A^T z_n,
//     A^T w_n (fixed rho: A^T(z_n - w_n) alone)
//   r-step, one block a frame:
//     the segments' sums in slot order; pri = |Ag - z_n| / sqrt(n_rows),
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
//   * Row pass: one block an SM owns a strip of rows (strips of one wave,
//     or of the fewest equal waves where shared memory caps a strip).  Its
//     last warp, the producer, feeds the others through asynchronous bulk
//     copies (cp.async.bulk, completing on mbarriers with their byte
//     counts), one lane issuing every copy: first the strip's A for the
//     segments' first tile, with the strip of the bounds shared by every
//     frame, which lands before anything else goes out; then each consumer
//     warp's own ring of `depth` stages, each a tile of z and w rows of one
//     frame (with per-frame bounds, of lo and hi too), and A's further
//     tiles as the first warps reach them.  A consumer warp reads a tile
//     from shared memory, does the arithmetic above, stores z_n and w_n to
//     its rows coalesced and releases the stage on its `empty` barrier;
//     the producer refills it with that warp's next tile.  So the bytes in
//     flight an SM are the rings' (tens of KB, set by the plan) and not
//     what the consumers' registers can hold, and A arrives by bulk copy
//     in place of a serial prologue.  A warp meets every use of its own
//     stages in order, so each parity it waits on follows a phase it
//     consumed: with one ring shared by all warps, a warp could reach a
//     stage's next use while the previous one, another warp's, was still
//     in flight (copies land out of order), and its wait passed early.  At
//     the end the consumers meet at a named barrier and one thread
//     invalidates the mbarriers before the block's shared memory passes on.
//   * Layout: z and w are the solve's own (b, ld) buffers, ld = n rounded
//     up to 8 floats, per-frame bounds (b, ld) and A (R/4, ld, 4), its
//     columns in fours, zero-padded, all laid out once a solve
//     (linalg/admm_cuda.py).  Rows, segments and tiles are multiples of 8,
//     so every copy starts and ends on a 32-byte sector, as bulk copies
//     need (16 bytes).  In shared memory As[(q/4) 4 rows + 4 t + q % 4]:
//     one 16-byte load brings four columns of a row, a warp's 32 rows 512
//     contiguous bytes, with no bank conflict and R/4 address offsets a
//     row in place of R (112 instructions a row against 136).
//   * Work: consumer warp v takes the units v, v + warps, ... of the
//     block, a unit a frame's segment (a frame's whole strip when the
//     batch has as many frames as warps; fewer frames split their strips
//     into `splits` segments).  Which warp reads which stage of which tile
//     is fixed, never claimed at run time.  A warp keeps its unit's 3r + 1
//     partial sums in registers over its tiles and reduces them once into
//     one slot of `part` (laid out [frame][sum][slot], slot = block x
//     splits + segment, so the r-step reads each sum's slots
//     contiguously), through a scratch of its own: twelve sums a round,
//     the lanes store their partials, and lane l adds up sum l over the
//     lanes in order (the 3r + 1 shuffle trees took a sixth of a warp's
//     cycles, every warp of the SM on its shuffle unit at once).  No float
//     atomics: the sums are taken in one order, and a batch served twice
//     gives the same bits.
//   * Tried on the card and slower.  With loads through registers (the
//     first form): 16-byte accesses of 4 rows a lane, which spill at the 128
//     registers a 512-thread block allows; loads of the next step issued
//     before the current one's arithmetic; A row-major with 16-byte shared
//     loads; a transposed warp reduction with the frames' coefficients
//     staged in shared memory; 17 warps of 3 frames.  With the rings:
//     the producer reading each frame's stop flag an item (some 1,100
//     cycles an item; a stopped frame's tiles now come and go unread);
//     A's columns one a shared load (above); transposed butterfly
//     reductions in registers, into a 32-float array or in place (three
//     times the cycles); two adjacent rows a lane in 8-byte loads
//     (spills); z_n and w_n stored from the stage by a bulk copy, and L2
//     eviction hints (evict_last on A, evict_first on z and w): no steady
//     gain; tiles of 160 or 320 rows in place of about 420.
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
#include <stdint.h>

namespace {

constexpr int kRMax = 32;
constexpr int kConsumersMax = 15;  // consumer warps a row-pass block (CONSUMERS_MAX)
constexpr int kRowThreads = 32 * (kConsumersMax + 1);  // and the producer
constexpr int kStagesMax = 64;     // ring stages, all warps' (STAGES_MAX)
constexpr int kAlign = 8;          // floats: rows, segments, tiles and ld
constexpr int kRedSums = 12;       // sums a round of a warp's reduction
constexpr int kRedRow = 36;        // floats a row of its scratch: 32 lanes, 16-byte rows
constexpr int kRedFloats = kRedSums * kRedRow;  // a consumer warp's scratch (RED_FLOATS)
constexpr int kStepThreads = 256;  // r-step block
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// One solve's arguments; linalg/admm_cuda.py's _Args mirrors it field for
// field.
struct AdmmArgs {
  const float* At;    // (R/4, ld, 4): A's columns in fours, zero past n and r
  const float* lo;    // (ld,) shared, or (b, ld): frame j's at lo + j * bnd_bs
  const float* hi;
  float* z;           // (b, ld), updated in place
  float* w;           // (b, ld), unscaled, updated in place
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
  float* part;        // (b, slot, slots) partial sums
  void* stream;
  long long bnd_bs, H_bs, AtA_bs;
  int n, ld, r, b, rows, grid, warps, splits, seg, tile, depth, slots, adapt, smem;
  float alpha, beta, sqrt_n, sqrt_r, ridge;
};

// Once a solve, before the iterations: the padded layouts the row pass
// reads, in one launch (linalg/admm_cuda.py, _state).  A's columns in fours
// (R/4, ld, 4); z's rows at the leading dimension ld; w = 0; the bounds at
// ld, one row or, with per-frame bounds, a row a frame (a shared source row
// broadcast, lo_bs or hi_bs 0).  Padding is zero.
struct LayoutArgs {
  const float* A;   // (n, r) row-major
  const float* z;   // (b, n)
  const float* lo;  // frame j's row at lo + j * lo_bs
  const float* hi;
  float* At;        // (R/4, ld, 4)
  float* zp;        // (b, ld)
  float* w;         // (b, ld)
  float* lo_p;      // (ld,), or (b, ld) with bbat
  float* hi_p;
  void* stream;
  long long lo_bs, hi_bs;
  int n, r, R, b, ld, bbat;
};

// Measuring build only (-DADMM_STAMPS; linalg/admm_cuda.py,
// row_pass_stamps): each row-pass block writes kStampSlots clock64()
// readings of its last launch to g_admm_stamps[block * kStampSlots + i]:
//   0 entry, 1 the global timer (ns) at entry, 2 the producer's cycles
//   waiting for empty stages, 3 its last issue, 4 the arrival of A's
//   first tile (warp 0),
//   8 + v, 24 + v, 40 + v consumer v's cycles waiting for full stages, in
//   the rows' arithmetic and in the reductions, 56 + v its end.
// Without the define the stamps compile to nothing.
constexpr int kStampSlots = 72;
#ifdef ADMM_STAMPS
__device__ long long* g_admm_stamps;
extern "C" int admm_set_stamps(long long* stamps) {
  return static_cast<int>(cudaMemcpyToSymbol(g_admm_stamps, &stamps, sizeof(stamps)));
}
#endif

namespace {

struct Clock {
#ifdef ADMM_STAMPS
  long long t = 0;
  __device__ long long lap() {  // cycles since the last lap
    const long long now = clock64(), d = now - t;
    t = now;
    return d;
  }
  __device__ static void put(int i, long long v) {
    g_admm_stamps[blockIdx.x * kStampSlots + i] = v;
  }
  __device__ static long long now() { return clock64(); }
  __device__ static long long timer() {
    long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    return ns;
  }
#else
  __device__ long long lap() { return 0; }
  __device__ static void put(int, long long) {}
  __device__ static long long now() { return 0; }
  __device__ static long long timer() { return 0; }
#endif
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Row t of the strip's A (columns in fours, As's layout) into aq, and
// ag = aq . g in column order.
template <int R>
__device__ __forceinline__ void load_row(const float* As, int rows, int t, const float (&gq)[R],
                                         float (&aq)[R], float& ag) {
#pragma unroll
  for (int g = 0; g < R / 4; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(As + 4 * (g * rows + t));
    aq[4 * g] = v.x;
    aq[4 * g + 1] = v.y;
    aq[4 * g + 2] = v.z;
    aq[4 * g + 3] = v.w;
#pragma unroll
    for (int c = 0; c < 4; ++c) ag = fmaf(aq[4 * g + c], gq[4 * g + c], ag);
  }
}

// One row of one frame: from A's row aq and Ag = aq . g, the relaxation,
// the clamp and the dual update give z_n and w_n, and the row's terms go
// into the frame's sums (fixed rho: s1 += aq (z_n - w_n) alone).
template <int R, bool ADAPT>
__device__ __forceinline__ void row_update(const float (&aq)[R], float ag, float zv, float wv,
                                           float lv, float hv, float alpha, float beta, float sj,
                                           float& zn, float& wn, float& ee, float (&s1)[R],
                                           float (&s2)[R], float (&s3)[R]) {
  const float rel = fmaf(alpha, ag, beta * zv);
  const float wt = ADAPT ? sj * wv : wv;
  zn = rel + wt;  // clamp(x, lo, hi); a NaN x stays NaN
  zn = zn < lv ? lv : zn;
  zn = zn > hv ? hv : zn;
  wn = (wt + rel) - zn;
  if (ADAPT) {
    const float e = ag - zn, dz = zn - zv;
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

// A unit's sums reduced across the warp through its scratch `red` and
// written to their slots of `out` (stride `slots`): element e of (ee, s1,
// s2, s3) -- with fixed rho, of s1 -- for the r real columns.  Each round
// the lanes store 12 elements' partials, one row an element, and lane
// l < 12 adds up row l in lane order (16-byte loads).  A fixed order for
// every element: the same bits every run.
template <int R, bool ADAPT>
__device__ __forceinline__ void reduce_sums(float ee, const float (&s1)[R], const float (&s2)[R],
                                            const float (&s3)[R], int r, int lane, float* red,
                                            float* out, int slots) {
  constexpr int E = ADAPT ? 1 + 3 * R : R;  // elements
#pragma unroll
  for (int g = 0; g < (E + kRedSums - 1) / kRedSums; ++g) {
#pragma unroll
    for (int i = 0; i < kRedSums; ++i) {
      const int e = g * kRedSums + i;
      if (e < E) {
        const int b = ADAPT ? (e + R - 1) / R - 1 : 0, q = (ADAPT ? e + R - 1 : e) % R;
        red[i * kRedRow + lane] =
            !ADAPT ? s1[q] : e == 0 ? ee : b == 0 ? s1[q] : b == 1 ? s2[q] : s3[q];
      }
    }
    __syncwarp();
    const int e = g * kRedSums + lane;
    if (lane < kRedSums && e < E) {
      const float4* row = reinterpret_cast<const float4*>(red + lane * kRedRow);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 v = row[c];
        acc += v.x;
        acc += v.y;
        acc += v.z;
        acc += v.w;
      }
      const int q = (ADAPT ? e - 1 : e) % R;
      const int at = !ADAPT ? e : e == 0 ? 0 : 1 + (e - 1) / R * r + q;
      if ((!ADAPT && e < r) || (ADAPT && (e == 0 || (e >= 1 && q < r))))
        out[static_cast<size_t>(at) * slots] = acc;
    }
    __syncwarp();
  }
}

// torch.maximum / torch.minimum: NaN in either gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

// ---- mbarriers and bulk copies (PTX) ------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// ends the barrier's life: its shared memory may then serve another
// (the next block's init on a valid barrier is undefined)
__device__ __forceinline__ void bar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}
// arrive, and have the phase wait for `bytes` more of copies
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__host__ __device__ __forceinline__ int align_up(int x) {
  return (x + kAlign - 1) / kAlign * kAlign;
}
// bytes of the mbarriers at the head of the row pass's shared memory:
// full[S], empty[S] and one a tile of the strip's A, rounded up to 16
__host__ __device__ __forceinline__ int bar_bytes(int stages, int tiles) {
  return (8 * (2 * stages + tiles) + 15) / 16 * 16;
}

template <int R, bool ADAPT>
__global__ void __launch_bounds__(kRowThreads) row_pass(const AdmmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Clock clk;
  const int W = a.warps, D = a.depth, S = W * D, rows = a.rows, T = a.tile, K = a.splits;
  const int r = a.r, units = a.b * K, tiles = (a.seg + T - 1) / T;
  const bool bbat = a.bnd_bs != 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // full[v * D + d]: warp v's ring
  uint64_t* empty = full + S;
  uint64_t* abar = empty + S;  // abar[k]: the strip's rows of every segment's tile k
  // As[(q / 4) * 4 rows + 4 t + q % 4]: row t's columns in fours, one
  // 16-byte load each, a warp's 32 rows 512 contiguous bytes
  float* As = reinterpret_cast<float*>(smem + bar_bytes(S, tiles));
  float* Ls = As + R * rows;  // the shared bounds' strip
  float* Hs = Ls + rows;
  float* ring = bbat ? Ls : Hs + rows;
  const int sf = (bbat ? 4 : 2) * T;  // floats a stage: z, w (, lo, hi)

  const int i0 = blockIdx.x * rows;
  const int nrow = min(rows, a.n - i0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // rows of tile k of segment u, from strip row u * seg + k * T
  auto tile_rows = [&](int u, int k) {
    const int t0 = u * a.seg + k * T;
    return min(t0 + T, min((u + 1) * a.seg, nrow)) - t0;
  };

  if (threadIdx.x == 0) {
    for (int e = 0; e < 2 * S + tiles; ++e) bar_init(full + e, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    Clock::put(0, Clock::now());
    Clock::put(1, Clock::timer());
  }
  __syncthreads();

  // Unit m (frame m / K, segment m % K) belongs to warp m % W; its tile k
  // is that warp's item n = (m / W) tiles + k, in stage n % D of the warp's
  // ring, whose n / D-th use it is.  A warp meets every use of its stages
  // in order, so each parity it waits on follows a phase it consumed.
  if (warp == W) {  // the producer: one lane, groups of W units tile by tile
    if (lane != 0) return;
    long long waited = 0;
    for (int g0 = 0; g0 < units; g0 += W) {
      for (int k = 0; k < tiles; ++k) {
        if (g0 == 0) {  // A (and the shared bounds) just before the first tile k
          uint32_t bytes = 0;
          for (int u = 0; u < K; ++u) bytes += 4u * align_up(max(0, tile_rows(u, k)));
          bar_arrive_tx(abar + k, bytes * (R + (bbat ? 0 : 2)));
          // the segments' tiles k, adjacent ones (one tile a segment) in one copy
          for (int u = 0, t0 = k * T, t1 = t0; u < K; ++u) {
            const int tn = tile_rows(u, k), next = (u + 1) * a.seg + k * T;
            t1 += tn > 0 ? align_up(tn) : 0;
            if (u + 1 < K && t1 == next && tile_rows(u + 1, k) > 0) continue;
            if (t1 > t0) {
              const uint32_t tb = 4u * (t1 - t0);
              for (int g = 0; g < R / 4; ++g)  // A's columns 4g .. 4g + 3
                bulk_load(As + 4 * (g * rows + t0),
                          a.At + 4 * (static_cast<size_t>(g) * a.ld + i0 + t0), 4 * tb, abar + k);
              if (!bbat) {
                bulk_load(Ls + t0, a.lo + i0 + t0, tb, abar + k);
                bulk_load(Hs + t0, a.hi + i0 + t0, tb, abar + k);
              }
            }
            t0 = t1 = next;
          }
        }
        const int n = g0 / W * tiles + k, use = n / D;  // every warp's item in this round
        for (int m = g0, j = g0 / K, u = g0 - j * K; m < min(g0 + W, units); ++m) {
          const int st = (m - g0) * D + n - use * D;
          if (use > 0) {  // wait for the stage's previous use to be read
            clk.lap();
            bar_wait(empty + st, (use - 1) & 1);
            waited += clk.lap();
          }
          const int tn = tile_rows(u, k), t0 = u * a.seg + k * T;
          if (tn <= 0) {  // nothing to read: a bare phase
            bar_arrive(full + st);
          } else {  // a stopped frame's tiles come too, and go unread
            const uint32_t tb = 4u * align_up(tn);
            float* dst = ring + st * sf;
            const size_t off = static_cast<size_t>(j) * a.ld + i0 + t0;
            bar_arrive_tx(full + st, tb * (bbat ? 4 : 2));
            bulk_load(dst, a.z + off, tb, full + st);
            bulk_load(dst + T, a.w + off, tb, full + st);
            if (bbat) {
              bulk_load(dst + 2 * T, a.lo + off, tb, full + st);
              bulk_load(dst + 3 * T, a.hi + off, tb, full + st);
            }
          }
          if (++u == K) u = 0, ++j;
        }
        if (g0 == 0 && k == 0) bar_wait(abar, 0);  // A's first tile lands before the rest goes out
      }
    }
    Clock::put(2, waited);
    Clock::put(3, Clock::now());
    return;
  }

  // the consumers
  const int slot = ADAPT ? 3 * r + 1 : r;
  long long waited = 0, busy = 0, reducing = 0;
  clk.lap();
  for (int m = warp, n = 0; m < units; m += W) {
    const int j = m / K, u = m - j * K;
    const bool frozen = ADAPT && a.conv[j];
    float gq[R];
#pragma unroll
    for (int q = 0; q < R; ++q) gq[q] = q < r && !frozen ? a.gn[j * r + q] : 0.f;
    const float sj = ADAPT ? a.s[j] : 1.f;
    float* z = a.z + static_cast<size_t>(j) * a.ld + i0;
    float* w = a.w + static_cast<size_t>(j) * a.ld + i0;
    const int send = min((u + 1) * a.seg, nrow);  // the segment's end in the strip
    float ee = 0.f, s1[R], s2[R], s3[R];
#pragma unroll
    for (int q = 0; q < R; ++q) s1[q] = s2[q] = s3[q] = 0.f;
    for (int k = 0; k < tiles; ++k, ++n) {
      const int use = n / D, st = warp * D + n - use * D;
      const int t0 = u * a.seg + k * T;
      const int tn = min(T, send - t0);
      clk.lap();
      bar_wait(abar + k, 0);  // A's rows of tile k (at once after the first unit)
      if (warp == 0 && lane == 0 && m == 0 && k == 0) Clock::put(4, Clock::now());
      bar_wait(full + st, use & 1);
      waited += clk.lap();
      if (!frozen) {
        const float* zs = ring + st * sf;
        const float* ws = zs + T;
        const float* ls = bbat ? zs + 2 * T : Ls + t0;
        const float* hs = bbat ? zs + 3 * T : Hs + t0;
        const float* Aq = As + 4 * t0;
        for (int t = lane; t < tn; t += 32) {
          float aq[R], ag = 0.f;
          load_row<R>(Aq, rows, t, gq, aq, ag);
          float zn, wn;
          row_update<R, ADAPT>(aq, ag, zs[t], ws[t], ls[t], hs[t], a.alpha, a.beta, sj, zn, wn, ee,
                               s1, s2, s3);
          z[t0 + t] = zn;
          w[t0 + t] = wn;
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + st);  // the stage is free again
      busy += clk.lap();
    }
    if (frozen) continue;  // stopped: frozen, its slots unused

    // one reduction a unit, into the frame's slots of this segment
    reduce_sums<R, ADAPT>(ee, s1, s2, s3, r, lane, ring + S * sf + warp * kRedFloats,
                          a.part + static_cast<size_t>(j) * slot * a.slots + blockIdx.x * K + u,
                          a.slots);
    reducing += clk.lap();
  }
  // every consumer is done, and with them every copy and arrival: one
  // thread invalidates the barriers (consumer warps only: the producer
  // has left)
  asm volatile("bar.sync 1, %0;" ::"r"(32 * a.warps) : "memory");
  if (threadIdx.x == 0)
    for (int e = 0; e < 2 * S + tiles; ++e) bar_inval(full + e);
  if (lane == 0) {
    Clock::put(8 + warp, waited);
    Clock::put(24 + warp, busy);
    Clock::put(40 + warp, reducing);
    Clock::put(56 + warp, Clock::now());
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

  // the slots' sums, each in slot order within a lane and by one fixed
  // shuffle tree across the lanes (a stopped frame's slots are stale and
  // unused)
  for (int p = warp; p < slot; p += kStepThreads / 32) {
    const float* src = a.part + (static_cast<size_t>(j) * slot + p) * a.slots;
    float v = 0.f;
#pragma unroll 4
    for (int q = lane; q < a.slots; q += 32) v += src[q];
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

constexpr int kLayoutThreads = 256;

__global__ void __launch_bounds__(kLayoutThreads) layout(const LayoutArgs a) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long e = first; e < static_cast<long long>(a.R) * a.ld; e += step) {
    const long long gi = e >> 2;  // group g = gi / ld of A's columns, row i
    const long long g = gi / a.ld, i = gi - g * a.ld;
    const int q = static_cast<int>(4 * g + (e & 3));
    a.At[e] = i < a.n && q < a.r ? a.A[i * a.r + q] : 0.f;
  }
  const long long bounds_rows = a.bbat ? a.b : 1;
  for (long long e = first; e < static_cast<long long>(a.b) * a.ld; e += step) {
    const long long j = e / a.ld, i = e - j * a.ld;
    const bool in = i < a.n;
    a.zp[e] = in ? a.z[j * a.n + i] : 0.f;
    a.w[e] = 0.f;
    if (j < bounds_rows) {
      a.lo_p[e] = in ? a.lo[j * a.lo_bs + i] : 0.f;
      a.hi_p[e] = in ? a.hi[j * a.hi_bs + i] : 0.f;
    }
  }
}

template <int R, bool ADAPT>
cudaError_t prepare(const AdmmArgs& a) {
  return cudaFuncSetAttribute(row_pass<R, ADAPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              a.smem);
}

template <int R, bool ADAPT>
cudaError_t launch_row(const AdmmArgs& a) {
  row_pass<R, ADAPT><<<a.grid, 32 * (a.warps + 1), a.smem, static_cast<cudaStream_t>(a.stream)>>>(
      a);
  return cudaGetLastError();
}

template <int R, bool ADAPT>
cudaError_t launch_step(const AdmmArgs& a) {
  r_step<R, ADAPT><<<a.b, kStepThreads, 0, static_cast<cudaStream_t>(a.stream)>>>(a);
  return cudaGetLastError();
}

// The plan's invariants that the row pass relies on (linalg/admm_cuda.py,
// _plan, makes them hold).
bool valid(const AdmmArgs& a) {
  const int R = a.r <= 4 ? 4 : a.r <= 8 ? 8 : a.r <= 16 ? 16 : kRMax;
  const int bounds = a.bnd_bs ? 0 : 2 * a.rows;
  const int stage = (a.bnd_bs ? 4 : 2) * a.tile;
  return a.r >= 1 && a.r <= kRMax && a.b >= 1 && a.n >= 1 && a.ld >= a.n && a.ld % kAlign == 0 &&
         a.rows >= 1 && a.rows % kAlign == 0 && a.grid >= 1 &&
         static_cast<long long>(a.grid) * a.rows >= a.n && a.warps >= 1 &&
         a.warps <= kConsumersMax && a.splits >= 1 && a.seg >= 1 && a.seg % kAlign == 0 &&
         static_cast<long long>(a.seg) * a.splits >= a.rows && a.tile >= 1 &&
         a.tile % kAlign == 0 && a.depth >= 2 && a.warps * a.depth <= kStagesMax &&
         a.slots == a.grid * a.splits && (a.bnd_bs == 0 || a.bnd_bs == a.ld) &&
         a.smem == bar_bytes(a.warps * a.depth, (a.seg + a.tile - 1) / a.tile) +
                       4 * (R * a.rows + bounds + a.warps * (a.depth * stage + kRedFloats));
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

// The padded layouts of one solve (LayoutArgs): one launch on a->stream;
// returns its error (0 when accepted).
int admm_layout_launch(const LayoutArgs* a) {
  const LayoutArgs& l = *a;
  if (!(l.n >= 1 && l.r >= 1 && l.r <= l.R && l.R % 4 == 0 && l.R <= kRMax && l.b >= 1 &&
        l.ld >= l.n && l.ld % kAlign == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long work = static_cast<long long>(l.ld) * (l.R > l.b ? l.R : l.b);
  const long long need = (work + kLayoutThreads - 1) / kLayoutThreads;
  layout<<<static_cast<int>(need < 4096 ? need : 4096), kLayoutThreads, 0,
           static_cast<cudaStream_t>(l.stream)>>>(l);
  return static_cast<int>(cudaGetLastError());
}

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

// The constants that linalg/admm_cuda.py mirrors, in one call:
// {R_MAX, CONSUMERS_MAX, STAGES_MAX, ALIGN, STEP_THREADS, RED_FLOATS, stamp
// slots}.
void admm_constants(int* out) {
  const int c[] = {kRMax, kConsumersMax, kStagesMax, kAlign, kStepThreads, kRedFloats, kStampSlots};
  for (int i = 0; i < 7; ++i) out[i] = c[i];
}

}  // extern "C"
