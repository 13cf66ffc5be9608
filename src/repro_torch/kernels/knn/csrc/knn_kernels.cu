// Hand-written Hopper (sm_90a) kernel for brute-force kNN: the hot loop of
// the paper's original AIDW algorithm (Mei et al. 2015, paper §3.1).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// entry point takes device pointers, sizes and the CUDA stream, launches on
// that stream without synchronising, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

// knn_brute_kernel<KMAX> replaces the TPU kernel
// repro/kernels/knn/knn_kernel.py::knn_kernel (_knn_kernel, _kpass_topk):
// each query's k smallest squared distances to the m data points, ascending,
// without indices.
//
// Design: one thread per query, blockDim.x (tile_q) queries per CTA.  The CTA
// walks the data in tiles of tile_d points staged through shared memory as
// float2 (8 bytes a point); every thread reads the same shared element, a
// broadcast.  Each thread keeps best[KMAX] ascending in registers, +inf at
// the start.  A point whose d2 is strictly below the current k-th best is
// inserted by compare-and-shift: slot by slot the smaller value stays and the
// larger moves on, so the largest falls off the end.  The loop is unrolled
// over KMAX with `s < k` guards, so best[] is never indexed at run time and
// stays in registers.  This is the original algorithm's own scheme, which the
// TPU kernel replaced by k passes of masked-min selection because per-lane
// insertion does not vectorise there; the two keep the same multiset,
// duplicates included (the comparison is strict, so equal distances stay
// separate entries).
//
// d2 = (qx - px)^2 + (qy - py)^2 with every operation an _rn intrinsic, so
// nvcc cannot contract a multiply and an add into an FMA: the result is
// bitwise what the separate PyTorch launches of the plain version compute.
// The kernel masks the ragged query and data edges itself and pads nothing.
// A data point at PAD_COORD = 1e30 gives d2 = inf, which is never inserted;
// when k > m the tail stays +inf.
//
// Bound: instruction issue, not bytes.  Device memory sees n*8 + m*8 bytes in
// and n*k*4 out; each (query, point) pair needs 7.5 instructions at the
// fewest (3 FADD, 2 FMUL, FSETP, BRA, and half an LDS.128: nvcc loads two
// points at once) at 128 a clock on each SM, and insertions are rare (about
// k*ln(m/k) a query for random data).  The built loop issues 11.5 a pair
// (tools/sass_loop.py): the divergent insertion branch adds a BSSY/BSYNC
// convergence-barrier pair to every point.
template <int KMAX>
__global__ void knn_brute_kernel(const float* __restrict__ qx,
                                 const float* __restrict__ qy,
                                 const float* __restrict__ px,
                                 const float* __restrict__ py,
                                 float* __restrict__ out, int n, int m, int k,
                                 int tile_d) {
  extern __shared__ float2 tile[];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float x = live ? qx[i] : 0.0f;
  const float y = live ? qy[i] : 0.0f;

  float best[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) best[s] = INFINITY;
  float worst = INFINITY;                  // best[k - 1]

  for (int d0 = 0; d0 < m; d0 += tile_d) {
    const int cnt = min(tile_d, m - d0);
    __syncthreads();                       // previous tile fully consumed
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      tile[j] = make_float2(px[d0 + j], py[d0 + j]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const float2 p = tile[j];
      const float dx = __fsub_rn(x, p.x);
      const float dy = __fsub_rn(y, p.y);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (d2 < worst) {
        float v = d2;
#pragma unroll
        for (int s = 0; s < KMAX; ++s) {
          if (s < k) {
            const float lo = fminf(best[s], v);
            v = fmaxf(best[s], v);
            best[s] = lo;
            if (s == k - 1) worst = lo;
          }
        }
      }
    }
  }
  if (live) {
    float* row = out + static_cast<size_t>(i) * k;
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < k) row[s] = best[s];
    }
  }
}

template <int KMAX>
void launch(const float* qx, const float* qy, const float* px,
            const float* py, float* out, int n, int m, int k, int tile_q,
            int tile_d, cudaStream_t s) {
  const dim3 grid((n + tile_q - 1) / tile_q);
  const size_t smem = static_cast<size_t>(tile_d) * sizeof(float2);
  knn_brute_kernel<KMAX><<<grid, tile_q, smem, s>>>(qx, qy, px, py, out, n, m,
                                                    k, tile_d);
}

}  // namespace

extern "C" {

// 1 <= k <= 64; tile_d * 8 bytes of shared memory per CTA.
int knn_brute(const float* qx, const float* qy, const float* px,
              const float* py, float* out, int n, int m, int k, int tile_q,
              int tile_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 16) {
    launch<16>(qx, qy, px, py, out, n, m, k, tile_q, tile_d, s);
  } else if (k <= 32) {
    launch<32>(qx, qy, px, py, out, n, m, k, tile_q, tile_d, s);
  } else {
    launch<64>(qx, qy, px, py, out, n, m, k, tile_q, tile_d, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
