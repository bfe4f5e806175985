// One Adam iteration of the batched single-task GP trainer, after its
// batched inverse, for Hopper.
//
// Replaces no TPU kernel.  The JAX package's trainer
// (openmeasure_tpu/gp/exact_gp.py, adam_early_stop, :175; its
// lax.while_loop, :264) is one program that XLA compiles around the Pallas
// _chol_kernel; eager PyTorch runs the closed-form oracle and Adam of one
// iteration (openmeasure_torch/gp/exact_gp.py,
// make_single_task_value_and_grad and adam_early_stop) as about 115 small
// kernels, 12 state copies and 2 fills beside the one launch of
// csrc/chol.cu.  This kernel runs all of them as one launch, so an
// iteration is two: csrc/chol.cu, then this.
//
// One block a model b (mode), from its kernel matrix's K^-1 and log|K|
// (csrc/chol.cu) and its state, updated in place:
//   alpha  = K^-1 resid;  lp = -1/2 resid.alpha - 1/2 logdet - p/2 log 2pi
//   loss   = -lp / p
//   M      = alpha alpha^T - K^-1   (never written to memory)
//   sums   t_l = sum M s g'(d2) D2_l   (each lengthscale l; s = 1 unscaled)
//          sum M g (ScaleKernel), tr M, sum alpha
//   grads  of loss by the raw parameters, the oracle's formulas with the
//          softplus chain factors sigmoid(raw):
//          lengthscale l  -1/p . 1/2 t_l (-2 / (ls_l^2 ls_l)) sig
//          outputscale    -1/p . 1/2 sum(M g) sig
//          noise          -1/(2p) tr M sig
//          constant mean  -1/p sum alpha
//   Adam   (optax's order): t += 1, c1 = 1 - 0.9^t, c2 = 1 - 0.999^t
//          taken in double and rounded to fp32 (the host's Python floats
//          of the eager loop); mu = 0.1 g + 0.9 mu, nu = 0.001 g^2 +
//          0.999 nu for every model; theta -= lr (mu/c1) / (sqrt(nu/c2) +
//          1e-8) where the model is not frozen
//   stop   e = |loss - loss_old|; a model not frozen takes loss_old = loss
//          and iters += 1; conv |= e <= rel_error
//   build  of the next iteration's input from the new parameters:
//          d2 = sum_l D2_l / ls_l^2, K = s g(d2) + (noise + 1e-4 floor) I,
//          then + jitter I; resid = y - constant
// With build_only set the launch only builds (once, before the loop).
// Frozen models step their moments and rebuild the same K, as the loop's
// masked substeps do.
//
// What bounds it.  Each input byte read once and each output byte written
// once: K^-1 and the next K, B p^2 floats each, the squared distances
// nls p^2 floats, and O(B (p + np)) more: 0.20 MB at (14, 41), nls = 1,
// 0.061 us at 3.35 TB/s.  The arithmetic, about 30 operations an (i, j)
// element for the sums, the profile and its derivative, and the build, is
// 0.71 M at (14, 41): 0.011 us at 67 TFLOP/s.  Neither is what the kernel
// meets: with one block a model its time is the latency of a chain of
// phases, each a few small dependent steps -- stage K^-1, alpha, the
// element pass and its reduction, Adam, the build -- whatever B is, as long
// as B <= the SM count.
//
// What the design does about it.  One block of 512 threads a model, in as
// few phases, joined by as few barriers, as the dependences allow:
//   * warp 0 holds the model's scalars and its parameters, one a lane with
//     its two moments, in registers, and sets the hyperparameters, while
//     the other warps stage K^-1 and the squared distances in shared
//     memory (D2 where it fits, always for one lengthscale), loads issued
//     four at a time;
//   * the other warps take alpha (one warp a row, a butterfly of shuffles)
//     and the element pass: M, g and g' formed in registers element by
//     element, (i, j) stepped without a division, the nls + 4 partial
//     sums reduced once by shuffles in each warp; meanwhile warp 0 takes
//     the double pow of the bias corrections (lanes 0 and 1 at once), off
//     the element pass's path;
//   * warp 0 sums the warps' partials in warp order, takes the loss, the
//     stop test, the gradient and Adam one lane a parameter, and the new
//     hyperparameters; then all warps build.
// One lengthscale (nls = 1, the main path) is its own instantiation, so the
// loops over lengthscales vanish there.  No float atomics and one fixed
// order for every sum: a replay gives the same bits twice.  fp32 with FMA,
// no TF32, no lower precision.  The kernel allocates nothing: the wrapper
// (openmeasure_torch/gp/gp_step.py) owns every buffer.  At (14, 41) a
// launch takes about 6.9 us on an NVIDIA H100 80GB HBM3 at 700 W, each
// phase one to two thousand cycles (PERF.md).
//
// Shared memory: K^-1 (p^2 floats) and, where (1 + nls) p^2 floats fit in
// 192 KB, the squared distances, as dynamic shared memory (above the 48 KB
// a launch gets by default the launch first asks for it with
// cudaFuncSetAttribute, as csrc/chol.cu's does); about 2.4 KB static.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxP = 128;     // csrc/chol.cu's cap
constexpr int kMaxLs = 16;     // lengthscales a model (ARD dimensions)
constexpr int kMaxNp = kMaxLs + 3;  // parameters a model, one a lane of warp 0
static_assert(kMaxNp + 1 <= 32, "warp 0 holds a model's parameters one a lane");
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// partial sums: t_l at [0, kMaxLs), then sum M g, tr M, sum alpha, resid.alpha
constexpr int kSg = kMaxLs, kTr = kMaxLs + 1, kSa = kMaxLs + 2, kRa = kMaxLs + 3;
constexpr int kAcc = kMaxLs + 4;
constexpr unsigned kFull = 0xffffffffu;
// static shared memory of a block: al, rs, red and the hyperparameters
constexpr size_t kStaticSmem = sizeof(float) * (2 * kMaxP + kWarps * kAcc + kMaxLs + 3);
// dynamic shared memory a block may take to stage the squared distances
// beside K^-1 (else it reads them from device memory)
constexpr size_t kStageBytes = 192 * 1024;

// the host's constants as the fp32 oracle rounds them
constexpr double kLog2Pi = 1.8378770664093453;
constexpr float kEps2 = 1.4210854715202004e-14f;  // finfo(float32).eps^2 = 2^-46
constexpr float kSqrt3 = static_cast<float>(1.7320508075688772);
constexpr float kSqrt5 = static_cast<float>(2.23606797749979);
constexpr float kFiveThirds = static_cast<float>(5.0 / 3.0);
constexpr float kFiveSixths = static_cast<float>(5.0 / 6.0);
constexpr float kNoiseFloor = 1e-4f;
constexpr double kB1 = 0.9, kB2 = 0.999;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - kB1);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - kB2);
constexpr float kAdamEps = 1e-8f;

enum Profile { kRbf = 0, kMatern05 = 1, kMatern15 = 2, kMatern25 = 3 };

}  // namespace

// Field for field the ctypes Structure of gp/gp_step.py.  The raw
// parameters of a model lie in theta's row in the order of the trainer's
// leaves: the nls lengthscales, the outputscale (scaled), the noise, the
// mean's constant (has_c).
struct GpStepArgs {
  const float* kinv;    // (B, p, p) K^-1 of the current K (csrc/chol.cu)
  const float* logdet;  // (B,)
  const float* y;       // (B, p) targets
  const float* d2s;     // (nls, p, p) squared distances by dimension
  float* kj;            // (B, p, p) out: the next jittered K
  float* resid;         // (B, p) the current K's residual; out: the next
  float* theta;         // (B, np) raw parameters
  float* mu;            // (B, np) Adam's moments
  float* nu;
  float* loss;          // (B,) last loss
  bool* conv;           // (B,) stopped
  int* iters;           // (B,) iterations taken
  int* count;           // (B,) Adam's step count
  void* stream;
  int batch, p, nls, scaled, has_c, profile, build_only;
  float lr, rel_error, jitter;
};

namespace {

__device__ __forceinline__ float softplus(float x) {
  // torch.logaddexp(x, 0)
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The kernel profile g(d2) and its derivative dg/dd2; the Matern ones
// guarded to (1, 0) where d2 <= eps^2, as the oracle's where-guard is.
template <int Prof>
__device__ __forceinline__ void profile(float d2, float& g, float& gp) {
  if (Prof == kRbf) {
    g = expf(-0.5f * d2);
    gp = -0.5f * g;
    return;
  }
  const bool safe = d2 > kEps2;
  const float r = sqrtf(safe ? d2 : 1.f);
  if (Prof == kMatern05) {
    const float e = expf(-r);
    g = safe ? e : 1.f;
    gp = safe ? -e / (2.f * r) : 0.f;
  } else if (Prof == kMatern15) {
    const float c = kSqrt3 * r;
    const float e = expf(-c);
    g = safe ? (1.f + c) * e : 1.f;
    gp = safe ? -1.5f * e : 0.f;
  } else {
    const float c = kSqrt5 * r;
    const float e = expf(-c);
    g = safe ? ((1.f + c) + kFiveThirds * d2) * e : 1.f;
    gp = safe ? (-kFiveSixths * (1.f + c)) * e : 0.f;
  }
}

// The model's hyperparameters: 1 / ls_l^2, the outputscale (1 when
// unscaled), the noise and the mean's constant (0 for a zero mean).
struct Hyper {
  float inv_ls2[kMaxLs];
  float s, noise, c;
};

// Warp 0 sets h from the raw parameters, lane q holding parameter q in x.
__device__ __forceinline__ void hyper(const GpStepArgs& a, int lane, float x, Hyper* h) {
  const int noise = a.nls + a.scaled;
  const float sp = softplus(x);
  const float s = __shfl_sync(kFull, sp, a.nls);
  const float nz = __shfl_sync(kFull, sp, noise);
  const float c = __shfl_sync(kFull, x, noise + 1);
  if (lane < a.nls) h->inv_ls2[lane] = 1.f / (sp * sp);
  if (lane == 0) {
    h->s = a.scaled ? s : 1.f;
    h->noise = nz + kNoiseFloor;
    h->c = a.has_c ? c : 0.f;
  }
}

// A barrier of warps 1 .. kWarps - 1 alone, while warp 0 keeps its pace.
__device__ __forceinline__ void sync_workers() {
  asm volatile("bar.sync 1, %0;" ::"r"(kThreads - 32) : "memory");
}

__device__ __forceinline__ float sqdist(const float* d2s, const Hyper& h, int nls, int pp, int e) {
  float d2 = 0.f;
#pragma unroll
  for (int l = 0; l < kMaxLs; ++l)
    if (l < nls) d2 = fmaf(h.inv_ls2[l], d2s[l * pp + e], d2);
  return d2;
}

// Warp 0 holds the model's scalars, one parameter and its moments a lane,
// and runs Adam; warps 1 .. kWarps - 1 take alpha and the element pass.
// The double pow of the bias corrections (lanes 0 and 1 of warp 0, both at
// once) so runs beside the element pass, off its path.  All warps build.
template <int Prof, bool Iso>
__global__ void __launch_bounds__(kThreads, 1) gp_step_kernel(GpStepArgs a, int stage_d2) {
  extern __shared__ float smem[];  // K^-1 (p x p), then D2 (nls x p x p) where staged
  __shared__ float al[kMaxP], rs[kMaxP];
  __shared__ float red[kWarps][kAcc];
  __shared__ Hyper h;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = a.p, pp = p * p, nls = Iso ? 1 : a.nls, noise = nls + a.scaled,
            np = noise + 1 + a.has_c;
  const int64_t mat = static_cast<int64_t>(b) * pp, vec = static_cast<int64_t>(b) * p;
  const bool scaled = a.scaled, step = !a.build_only;
  const float* d2s = step && stage_d2 ? smem + pp : a.d2s;

  float x = 0.f, mu = 0.f, nu = 0.f, loss_old = 0.f, ld = 0.f;
  int t = 0, it = 0;
  bool fz = false;
  if (warp == 0) {
    const int q = b * np + lane;
    if (lane < np) {
      x = a.theta[q];
      if (step) {
        mu = a.mu[q];
        nu = a.nu[q];
      }
    }
    if (step) {
      t = a.count[b] + 1;
      it = a.iters[b];
      fz = a.conv[b];
      loss_old = a.loss[b];
      ld = a.logdet[b];
    }
    hyper(a, lane, x, &h);
  } else if (step) {
    const int w = tid - 32, nw = kThreads - 32;
#pragma unroll 4
    for (int e = w; e < pp; e += nw) smem[e] = a.kinv[mat + e];
    if (stage_d2) {
#pragma unroll 4
      for (int e = w; e < nls * pp; e += nw) smem[pp + e] = a.d2s[e];
    }
    for (int i = w; i < p; i += nw) rs[i] = a.resid[vec + i];
  }
  __syncthreads();

  if (step) {
    float cb = 0.f;  // lane 0: c1 = 1 - 0.9^t, lane 1: c2 = 1 - 0.999^t
    if (warp == 0) {
      if (lane < 2) cb = static_cast<float>(1.0 - pow(lane ? kB2 : kB1, static_cast<double>(t)));
    } else {
      // alpha = K^-1 resid, one warp a row
      for (int i = warp - 1; i < p; i += kWarps - 1) {
        float acc = 0.f;
        for (int j = lane; j < p; j += 32) acc = fmaf(smem[i * p + j], rs[j], acc);
        acc = warp_sum(acc);
        if (lane == 0) al[i] = acc;
      }
      sync_workers();

      // the element pass: M, g, g' in registers, straight into the sums
      float acc[kAcc];
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
      const float* d2e = Iso ? smem + pp : d2s;  // staged for one lengthscale
      constexpr int nw = kThreads - 32;
      const int di = nw / p, dj = nw - di * p;
      int i = (tid - 32) / p, j = (tid - 32) - i * p;
      for (int e = tid - 32; e < pp; e += nw) {
        const float m = fmaf(al[i], al[j], -smem[e]);
        float g, gp;
        profile<Prof>(sqdist(d2e, h, nls, pp, e), g, gp);
        const float w = m * (scaled ? h.s * gp : gp);
#pragma unroll
        for (int l = 0; l < kMaxLs; ++l)
          if (l < nls) acc[l] = fmaf(w, d2e[l * pp + e], acc[l]);
        if (scaled) acc[kSg] = fmaf(m, g, acc[kSg]);
        if (i == j) acc[kTr] += m;
        i += di;
        j += dj;
        if (j >= p) {
          j -= p;
          ++i;
        }
      }
      for (int q = tid - 32; q < p; q += nw) {
        acc[kSa] += al[q];
        acc[kRa] = fmaf(rs[q], al[q], acc[kRa]);
      }
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        if (k < nls || k >= kMaxLs) {
          const float v = warp_sum(acc[k]);
          if (lane == 0) red[warp][k] = v;
        }
      }
    }
    __syncthreads();

    if (warp == 0) {
      // the sums over the warps in warp order, lane k holding sum k
      float tk = 0.f;
      if (lane < kAcc && (lane < nls || lane >= kMaxLs))
        for (int w = 1; w < kWarps; ++w) tk += red[w][lane];
      const float tl = __shfl_sync(kFull, tk, lane < nls ? lane : 0);
      const float sg = __shfl_sync(kFull, tk, kSg), tr = __shfl_sync(kFull, tk, kTr);
      const float sa = __shfl_sync(kFull, tk, kSa), ra = __shfl_sync(kFull, tk, kRa);
      const float c1 = __shfl_sync(kFull, cb, 0), c2 = __shfl_sync(kFull, cb, 1);

      // loss, stop test and counts
      const float lp = (-0.5f * ra - 0.5f * ld) - static_cast<float>(0.5 * p * kLog2Pi);
      const float loss = -lp / static_cast<float>(p);
      if (lane == 0) {
        const float err = fabsf(loss - loss_old);
        if (!fz) {
          a.loss[b] = loss;
          a.iters[b] = it + 1;
        }
        a.conv[b] = fz || err <= a.rel_error;
        a.count[b] = t;
      }

      // gradient and Adam, one lane a parameter
      if (lane < np) {
        const float coeff = static_cast<float>(-1.0 / p);
        float g;
        if (lane < nls) {
          const float ls = softplus(x);
          g = coeff * (((0.5f * tl) * ((-2.f * h.inv_ls2[lane]) / ls)) * sigmoid(x));
        } else if (lane < noise) {  // the outputscale
          g = coeff * ((0.5f * sg) * sigmoid(x));
        } else if (lane == noise) {
          g = (static_cast<float>(-0.5 / p) * tr) * sigmoid(x);
        } else {  // the constant
          g = coeff * sa;
        }
        const int q = b * np + lane;
        mu = fmaf(static_cast<float>(kB1), mu, kOneMinusB1 * g);
        nu = fmaf(static_cast<float>(kB2), nu, kOneMinusB2 * (g * g));
        a.mu[q] = mu;
        a.nu[q] = nu;
        const float upd = (mu / c1) / (sqrtf(nu / c2) + kAdamEps);
        if (!fz) {
          x = fmaf(-a.lr, upd, x);
          a.theta[q] = x;
        }
      }
      __syncwarp();
      hyper(a, lane, x, &h);
    }
    __syncthreads();
  }

  // the next iteration's K and residual
  const int di = kThreads / p, dj = kThreads - di * p;
  int i = tid / p, j = tid - i * p;
  for (int e = tid; e < pp; e += kThreads) {
    float g, gp;
    profile<Prof>(sqdist(d2s, h, nls, pp, e), g, gp);
    float k = scaled ? h.s * g : g;
    if (i == j) k = (k + h.noise) + a.jitter;
    a.kj[mat + e] = k;
    i += di;
    j += dj;
    if (j >= p) {
      j -= p;
      ++i;
    }
  }
  for (int q = tid; q < p; q += kThreads) a.resid[vec + q] = a.y[vec + q] - h.c;
}

template <int Prof, bool Iso>
cudaError_t launch(const GpStepArgs& a) {
  const size_t pp = static_cast<size_t>(a.p) * a.p;
  size_t smem = 0;
  int stage_d2 = 0;
  if (!a.build_only) {
    smem = sizeof(float) * pp;
    if (sizeof(float) * pp * (1 + a.nls) <= kStageBytes) {
      smem = sizeof(float) * pp * (1 + a.nls);
      stage_d2 = 1;
    }
  }
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(gp_step_kernel<Prof, Iso>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gp_step_kernel<Prof, Iso>
      <<<a.batch, kThreads, smem, static_cast<cudaStream_t>(a.stream)>>>(a, stage_d2);
  return cudaGetLastError();
}

template <int Prof>
cudaError_t launch_profile(const GpStepArgs& a) {
  return a.nls == 1 ? launch<Prof, true>(a) : launch<Prof, false>(a);
}

}  // namespace

extern "C" {

// Enqueues one launch on a->stream: an Adam iteration and the next build,
// or the build alone (a->build_only).  Returns cudaErrorInvalidValue for a
// shape or layout the kernel does not take, else the launch's error (0
// when accepted).
int gp_step_launch(const GpStepArgs* a) {
  if (a->batch < 1 || a->p < 1 || a->p > kMaxP || a->nls < 1 || a->nls > kMaxLs ||
      (a->scaled != 0 && a->scaled != 1) || (a->has_c != 0 && a->has_c != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a->profile) {
    case kRbf: return static_cast<int>(launch_profile<kRbf>(*a));
    case kMatern05: return static_cast<int>(launch_profile<kMatern05>(*a));
    case kMatern15: return static_cast<int>(launch_profile<kMatern15>(*a));
    case kMatern25: return static_cast<int>(launch_profile<kMatern25>(*a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int gp_step_ls_max() { return kMaxLs; }


}  // extern "C"
