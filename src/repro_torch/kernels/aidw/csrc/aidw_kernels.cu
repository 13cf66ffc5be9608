// Hand-written Hopper (sm_90a) kernels for AIDW Stage 2.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  No
// --use_fast_math: flushing denormals to zero would change weights that
// underflow, and the accurate expf/logf/powf/cosf are what PyTorch's own
// CUDA kernels call, which the bitwise contracts below rest on.
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

// aidw_tiled_kernel<FUSED> replaces the TPU kernel
// repro/kernels/aidw/aidw_kernel.py::tiled_interpolate_kernel (_interp_kernel):
// global Eq. (1) over all m data points.
//
// Design: one thread per query, one CTA per blockDim.x (tile_q) queries.  The
// CTA walks the data in tiles of tile_d points staged through shared memory
// as px/py/pz SoA (the paper's own shared-memory tiling, §3.3); every thread
// reads the same shared element, a broadcast.  This in-CTA loop takes the
// place of the TPU's sequential "arbitrary" data-axis grid dimension: no sum
// crosses CTAs, so there are no atomics and no second pass.  sum_w and sum_wz
// stay in registers, summed per tile and then across tiles.  With FUSED,
// alpha comes from r_obs once per thread before the loop.
//
// Weights use the exp/log form of the TPU kernel (aidw_kernel.py:84),
// w = exp(-0.5 * alpha * log(max(d2, EPS_D2))), and the finish divides by
// max(sum_w, 1e-30) (aidw_kernel.py:93).  Data padded with 1e30 gives
// d2 = inf (f32 overflow), log = inf, exp(-inf) = 0: an exact zero weight.
//
// Bound: operations, not bytes.  Each (query, point) pair costs two
// transcendentals and ~10 FP32 ops while the data tile is read from shared
// memory; device memory sees only n*12 + m*12 bytes in and n*8 out.
template <bool FUSED>
__global__ void aidw_tiled_kernel(const float* __restrict__ qx,
                                  const float* __restrict__ qy,
                                  const float* __restrict__ aux,
                                  const float* __restrict__ stats,
                                  const float* __restrict__ px,
                                  const float* __restrict__ py,
                                  const float* __restrict__ pz,
                                  float* __restrict__ out,
                                  float* __restrict__ sumw, int n, int m,
                                  int tile_d, AlphaParams p) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + tile_d;
  float* sz = smem + 2 * tile_d;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float x = live ? qx[i] : 0.0f;
  const float y = live ? qy[i] : 0.0f;
  const float a = live ? aux[i] : 1.0f;
  const float alpha = FUSED ? adaptive_alpha(a, stats[0], stats[1], p) : a;
  const float nha = -0.5f * alpha;

  float sw = 0.0f;
  float swz = 0.0f;
  for (int d0 = 0; d0 < m; d0 += tile_d) {
    __syncthreads();                       // previous tile fully consumed
    for (int j = threadIdx.x; j < tile_d; j += blockDim.x) {
      sx[j] = px[d0 + j];
      sy[j] = py[d0 + j];
      sz[j] = pz[d0 + j];
    }
    __syncthreads();
    // the tile's partial sums first, then into the running sums, as the TPU
    // kernel adds each tile's row sum (aidw_kernel.py:85-86): one running
    // f32 sum over all m terms drifts ~1e-4 relative at m = 2^18
    float tw = 0.0f;
    float twz = 0.0f;
#pragma unroll 8
    for (int j = 0; j < tile_d; ++j) {
      const float dx = x - sx[j];
      const float dy = y - sy[j];
      const float d2 = dx * dx + dy * dy;
      const float w = expf(nha * logf(fmaxf(d2, kEpsD2)));
      tw += w;
      twz += w * sz[j];
    }
    sw += tw;
    swz += twz;
  }
  if (live) {
    out[i] = swz / fmaxf(sw, kMinSumW);
    sumw[i] = sw;
  }
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

}  // namespace

extern "C" {

// n % tile_q == 0 and m % tile_d == 0 (the ops layer pads); 3*tile_d floats
// of shared memory per CTA.
int aidw_tiled(const float* qx, const float* qy, const float* aux,
               const float* stats, const float* px, const float* py,
               const float* pz, float* out, float* sumw, int n, int m,
               int tile_q, int tile_d, int fused, const float* alphas,
               float r_min, float r_max, float cos_scale, void* stream) {
  const AlphaParams p = make_params(alphas, r_min, r_max, cos_scale);
  const dim3 grid((n + tile_q - 1) / tile_q);
  const size_t smem = 3 * static_cast<size_t>(tile_d) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused) {
    aidw_tiled_kernel<true><<<grid, tile_q, smem, s>>>(
        qx, qy, aux, stats, px, py, pz, out, sumw, n, m, tile_d, p);
  } else {
    aidw_tiled_kernel<false><<<grid, tile_q, smem, s>>>(
        qx, qy, aux, stats, px, py, pz, out, sumw, n, m, tile_d, p);
  }
  return static_cast<int>(cudaGetLastError());
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
