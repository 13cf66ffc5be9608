// Hand-written Hopper (sm_90a) kernels for AIDW Stage 2.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  No
// --use_fast_math: flushing denormals to zero would change weights that
// underflow (the tiled kernel's lg2/ex2 are the non-.ftz MUFU forms for the
// same reason), and the accurate powf/cosf are what PyTorch's own CUDA
// kernels call, which the bitwise contracts below rest on.
//
// Every entry point takes device pointers, sizes and the CUDA stream, launches
// on that stream without synchronising, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEpsD2 = 1e-12f;        // repro.core.aidw.EPS_D2
constexpr float kMinSumW = 1e-30f;      // finish guard of the tiled kernel

// Eq. (6) levels and Eq. (5) constants, passed by value.  cos_scale is
// f32(pi / r_max), rounded on the host exactly as PyTorch rounds the scalar.
struct AlphaParams {
  float a[5];
  float r_min;
  float r_max;
  float cos_scale;
};

// Eqs. (2) -> (4) -> (5) -> (6) in the op order of
// repro_torch.core.aidw.adaptive_alpha.  Every multiply and add is an _rn
// intrinsic, so nvcc cannot contract a mul+add into an FMA: the result is
// bitwise what the separate PyTorch launches compute on the card.
__device__ __forceinline__ float adaptive_alpha(float r_obs, float n_points,
                                                float area,
                                                const AlphaParams& p) {
  const float r_exp = __fdiv_rn(
      1.0f, __fmul_rn(2.0f, __fsqrt_rn(__fdiv_rn(n_points, area))));
  const float r = __fdiv_rn(r_obs, r_exp);
  float mu = __fsub_rn(
      0.5f, __fmul_rn(0.5f, cosf(__fmul_rn(p.cos_scale, __fsub_rn(r, p.r_min)))));
  mu = (r <= p.r_min) ? 0.0f : ((r >= p.r_max) ? 1.0f : mu);
  // segment bounds: lo in f32, lo + 0.2 summed in double first (as Python does)
  const float lo[4] = {0.1f, 0.3f, 0.5f, 0.7f};
  const float hi[4] = {(float)(0.1 + 0.2), (float)(0.3 + 0.2),
                       (float)(0.5 + 0.2), (float)(0.7 + 0.2)};
  float out = (mu <= 0.1f) ? p.a[0] : 0.0f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float t = __fmul_rn(5.0f, __fsub_rn(mu, lo[s]));
    if (mu > lo[s] && mu <= hi[s]) {
      out = __fadd_rn(__fmul_rn(p.a[s], __fsub_rn(1.0f, t)),
                      __fmul_rn(p.a[s + 1], t));
    }
  }
  return (mu > 0.9f) ? p.a[4] : out;
}

// lg2.approx.f32 and ex2.approx.f32, the non-.ftz forms: one MUFU op each.
// Without .ftz, ptxas wraps each in a predicated scale so that a subnormal
// input or result keeps its value (a weight of ~1e-40 stays > 0) instead of
// flushing to zero.  Not volatile: the compiler may schedule and reuse them.
__device__ __forceinline__ float lg2_mufu(float x) {
  float y;
  asm("lg2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_mufu(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// aidw_tiled_kernel<Q, FUSED> replaces the TPU kernel
// repro/kernels/aidw/aidw_kernel.py::tiled_interpolate_kernel (_interp_kernel):
// global Eq. (1) over all m data points.
//
// Bound: operations, not bytes.  Each (query, point) pair costs two
// transcendentals and 8 FP32 instructions at the fewest while the data tile
// is read from shared memory; device memory sees only n*12 + m*12 bytes in
// and n*8 out.  The H100 issues 16 MUFU results a clock per SM against 128
// FP32 ones, so the two transcendentals are the bound (PERF.md §6), and the
// design puts each of them on the MUFU pipe as a single op.  The built loop
// issues ~16.8 instructions a pair (tools/sass_loop.py): 6 of them are the
// predicated scaling ptxas puts around the non-.ftz lg2 and ex2, so issue
// and MUFU bind together.
//
// * Weights: w = ex2(nha * lg2(max(d2, EPS_D2))) with nha = -alpha/2, which
//   is the reference's exp(nha * log(.)) (aidw_kernel.py:84) since
//   2^(nha log2 d2) = d2^nha = e^(nha ln d2): no ln 2 factors.  lg2.approx
//   is off by about 2^-22 absolute and ex2.approx by about 2^-22 relative
//   (PTX ISA), so a weight is off by about (|nha| ln 2 + 1) 2^-22 relative:
//   ~1e-6 at |alpha| <= 8, the order of the f32 rounding of nha * log(d2)
//   that the twin itself makes.  The value is a weighted mean, so its error
//   stays of that order times max|z - value|, against a contract of 2e-5.
//   Sentinels: a PAD_COORD point gives d2 = inf (f32 overflow), lg2(inf) =
//   inf, nha * inf = -inf and ex2(-inf) = +0, so a padded point weighs
//   exactly 0 and a tile of them adds +0 to the sums, which leaves them
//   bitwise as they were.  A far query whose weights all underflow gets
//   sum_w = 0, the 0.0 sentinel and a set mask; one whose weights are
//   subnormal (ex2 without .ftz) keeps sum_w > 0, as the twin does.  The
//   fused prologue keeps its accurate cosf and _rn arithmetic: it runs once
//   per query, and alpha stays within 1e-6 of the twin's.
// * Register blocking: a thread holds Q queries (Q = 1, 2 or 4, picked on
//   the host from tile_q: the most that keeps four warps a CTA), a CTA
//   tile_q / Q threads, so tile_q stays "queries per CTA".  The data tile is
//   staged in shared memory as float4 (x, y, z, 0), so ONE broadcast
//   LDS.128 gives a point's x, y and z and feeds Q pairs.
// * Summation order: each thread sums a tile's Q partials first and adds
//   them to its running sums, as the TPU kernel adds each tile's row sum
//   (aidw_kernel.py:85-86): one running f32 sum over all m terms drifts
//   ~1e-4 relative at m = 2^18.
// * Data-axis split: the grid is (n / tile_q) x splits.  CTA (qt, s) walks
//   the tiles [s*T/S, (s+1)*T/S) of the T = m / tile_d tiles, so a small
//   batch still fills the card.  With splits == 1 the CTA finishes its
//   queries itself; otherwise it writes its (sum_w, sum_wz) partials to
//   part[(0|1) * splits * n + s * n + i] and aidw_tiled_finish sums them in
//   split order 0..S-1: no atomics, the same bits on every run and on every
//   graph replay.
template <int Q, bool FUSED>
__global__ void aidw_tiled_kernel(const float* __restrict__ qx,
                                  const float* __restrict__ qy,
                                  const float* __restrict__ aux,
                                  const float* __restrict__ stats,
                                  const float* __restrict__ px,
                                  const float* __restrict__ py,
                                  const float* __restrict__ pz,
                                  float* __restrict__ out,
                                  float* __restrict__ sumw,
                                  float* __restrict__ part, int n, int m,
                                  int tile_d, int splits, AlphaParams p) {
  extern __shared__ float4 tile[];
  const int threads = blockDim.x;
  const int first = blockIdx.x * threads * Q + threadIdx.x;

  // query q of this thread is first + q * threads: coalesced loads/stores
  float x[Q], y[Q], nha[Q], sw[Q], swz[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = first + q * threads;
    x[q] = qx[i];
    y[q] = qy[i];
    const float alpha =
        FUSED ? adaptive_alpha(aux[i], stats[0], stats[1], p) : aux[i];
    nha[q] = -0.5f * alpha;
    sw[q] = 0.0f;
    swz[q] = 0.0f;
  }

  const int tiles = m / tile_d;
  const int s = blockIdx.y;
  const int t0 = static_cast<int>(static_cast<long long>(s) * tiles / splits);
  const int t1 =
      static_cast<int>(static_cast<long long>(s + 1) * tiles / splits);
  for (int t = t0; t < t1; ++t) {
    const int d0 = t * tile_d;
    __syncthreads();                       // previous tile fully consumed
    for (int j = threadIdx.x; j < tile_d; j += threads) {
      tile[j] = make_float4(px[d0 + j], py[d0 + j], pz[d0 + j], 0.0f);
    }
    __syncthreads();
    float tw[Q], twz[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      tw[q] = 0.0f;
      twz[q] = 0.0f;
    }
#pragma unroll 8
    for (int j = 0; j < tile_d; ++j) {
      const float4 pt = tile[j];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float dx = x[q] - pt.x;
        const float dy = y[q] - pt.y;
        const float d2 = fmaxf(dx * dx + dy * dy, kEpsD2);
        const float w = ex2_mufu(nha[q] * lg2_mufu(d2));
        tw[q] += w;
        twz[q] += w * pt.z;
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      sw[q] += tw[q];
      swz[q] += twz[q];
    }
  }

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = first + q * threads;
    if (splits == 1) {
      out[i] = swz[q] / fmaxf(sw[q], kMinSumW);
      sumw[i] = sw[q];
    } else {
      const size_t at = static_cast<size_t>(s) * n + i;
      part[at] = sw[q];
      part[static_cast<size_t>(splits) * n + at] = swz[q];
    }
  }
}

// The second pass of a split launch: per query, the splits' partial sums
// added in split order 0..S-1, then the max(sum_w, 1e-30) finish.
__global__ void aidw_tiled_finish(const float* __restrict__ part,
                                  float* __restrict__ out,
                                  float* __restrict__ sumw, int n,
                                  int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* pw = part;
  const float* pwz = part + static_cast<size_t>(splits) * n;
  float sw = pw[i];
  float swz = pwz[i];
  for (int s = 1; s < splits; ++s) {
    sw += pw[static_cast<size_t>(s) * n + i];
    swz += pwz[static_cast<size_t>(s) * n + i];
  }
  out[i] = swz / fmaxf(sw, kMinSumW);
  sumw[i] = sw;
}

// aidw_local_kernel<FUSED> replaces the TPU kernel
// repro/kernels/aidw/aidw_kernel.py::local_interpolate_kernel (_local_kernel):
// exact-k local Eq. (1) over each query's k Stage-1 neighbours.
//
// Design: one thread per query with the k loop in registers.  z is gathered
// from values[idx] in device memory.  There is no k padding to 128 lanes (a
// TPU layout artifact): the loop runs exactly k times.  The sums run left to
// right, w = powf(max(d2, EPS_D2), -alpha/2) as in idw_weights_sq, and every
// multiply and add is an _rn intrinsic, so no FMA contraction occurs and the
// result is bitwise the plain PyTorch path (separate pow, mul and add
// launches).  The first slot starts the sums (no 0 + w), as the reference
// does.  A query whose weight sum is 0 gets the 0.0 sentinel.
//
// Bound: bytes and gather latency.  Per query k*(4+4) bytes of d2/idx read
// once plus k random 4-byte reads of values; the arithmetic is k powf.
template <bool FUSED>
__global__ void aidw_local_kernel(const float* __restrict__ d2,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ aux,
                                  const float* __restrict__ stats,
                                  const float* __restrict__ pz,
                                  float* __restrict__ out,
                                  float* __restrict__ sumw, int n, int k,
                                  AlphaParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float alpha = FUSED ? adaptive_alpha(aux[i], stats[0], stats[1], p)
                            : aux[i];
  const float e = __fmul_rn(-0.5f, alpha);
  const float* dr = d2 + static_cast<size_t>(i) * k;
  const int* ir = idx + static_cast<size_t>(i) * k;

  float w = powf(fmaxf(dr[0], kEpsD2), e);
  float sw = w;
  float swz = __fmul_rn(w, pz[ir[0]]);
  for (int j = 1; j < k; ++j) {
    w = powf(fmaxf(dr[j], kEpsD2), e);
    swz = __fadd_rn(swz, __fmul_rn(w, pz[ir[j]]));
    sw = __fadd_rn(sw, w);
  }
  const bool zero = sw <= 0.0f;
  out[i] = zero ? 0.0f : __fdiv_rn(swz, sw);
  sumw[i] = sw;
}

AlphaParams make_params(const float* alphas, float r_min, float r_max,
                        float cos_scale) {
  AlphaParams p;
  for (int s = 0; s < 5; ++s) p.a[s] = alphas[s];
  p.r_min = r_min;
  p.r_max = r_max;
  p.cos_scale = cos_scale;
  return p;
}

// The instance of aidw_tiled_kernel for q queries a thread (1, 2 or 4);
// nullptr for any other q.
template <bool FUSED>
const void* tiled_instance(int q) {
  switch (q) {
    case 1: return reinterpret_cast<const void*>(aidw_tiled_kernel<1, FUSED>);
    case 2: return reinterpret_cast<const void*>(aidw_tiled_kernel<2, FUSED>);
    case 4: return reinterpret_cast<const void*>(aidw_tiled_kernel<4, FUSED>);
    default: return nullptr;
  }
}

const void* tiled_kernel(int q, bool fused) {
  return fused ? tiled_instance<true>(q) : tiled_instance<false>(q);
}

}  // namespace

extern "C" {

// n % tile_q == 0, m % tile_d == 0 (the ops layer pads), q (queries a
// thread) in {1, 2, 4} dividing tile_q, 1 <= splits <= m / tile_d; with
// splits > 1, part holds 2 * splits * n floats.  tile_d float4 of shared
// memory per CTA.
int aidw_tiled(const float* qx, const float* qy, const float* aux,
               const float* stats, const float* px, const float* py,
               const float* pz, float* out, float* sumw, float* part, int n,
               int m, int tile_q, int tile_d, int q, int splits, int fused,
               const float* alphas, float r_min, float r_max, float cos_scale,
               void* stream) {
  const void* fn = tiled_kernel(q, fused != 0);
  if (fn == nullptr || tile_q % q || splits < 1 ||
      (splits > 1 && (splits > m / tile_d || part == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AlphaParams p = make_params(alphas, r_min, r_max, cos_scale);
  const dim3 grid(n / tile_q, splits);
  const int threads = tile_q / q;
  const size_t smem = static_cast<size_t>(tile_d) * sizeof(float4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&qx, &qy, &aux, &stats, &px, &py, &pz, &out, &sumw, &part,
                  &n, &m, &tile_d, &splits, &p};
  cudaError_t err = cudaLaunchKernel(fn, grid, dim3(threads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    aidw_tiled_finish<<<(n + 255) / 256, 256, 0, s>>>(part, out, sumw, n,
                                                      splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs an SM holds of the tiled kernel at this shape (the occupancy
// the host's split planner reads); returns the CUDA error code.
int aidw_tiled_ctas_per_sm(int q, int threads, int tile_d, int fused,
                           int* ctas) {
  const void* fn = tiled_kernel(q, fused != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, fn, threads, static_cast<size_t>(tile_d) * sizeof(float4)));
}

int aidw_local(const float* d2, const int* idx, const float* aux,
               const float* stats, const float* pz, float* out, float* sumw,
               int n, int k, int tile_q, int fused, const float* alphas,
               float r_min, float r_max, float cos_scale, void* stream) {
  const AlphaParams p = make_params(alphas, r_min, r_max, cos_scale);
  const dim3 grid((n + tile_q - 1) / tile_q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused) {
    aidw_local_kernel<true><<<grid, tile_q, 0, s>>>(d2, idx, aux, stats, pz,
                                                    out, sumw, n, k, p);
  } else {
    aidw_local_kernel<false><<<grid, tile_q, 0, s>>>(d2, idx, aux, stats, pz,
                                                     out, sumw, n, k, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
