// Batched f32 matrix inverse by Gauss-Jordan with partial pivoting.
//
// Replaces: tpusysbio/linalg/pallas_lu.py::_gj_batched_kernel (launched by
// _gj_inverse_f32), the TPU kernel behind every Newton factorization of
// I - cJ on the BDF main path.
//
// Bound on the H100: at the main path's shapes (B=256 matrices, n=22) the
// kernel reads 256*22*22*4 B = 0.5 MB and writes as much, and does about
// 2n^3 = 21k flops per matrix, 5.5 Mflop in all: well under a microsecond
// of either memory or f32 rate. What bounds it is latency: n sequential
// pivot steps, each a column reduction plus a row update with barriers,
// and the launch itself (one launch per factorization on the main path).
//
// Design: one thread block per matrix, grid = B. The augmented [A | I]
// block (n x 2n f32, <= 32 KB at n <= 64) lives in static shared memory
// for the whole elimination, so device memory is touched once on the way
// in and once on the way out. Per pivot step: warp 0 finds the first row
// reaching max |A[r,k]| for r >= k (lowest index on ties, as the
// reference's min-index tie-break), the rows are swapped, row k is divided
// by the pivot (a true division, as the reference), and every other row
// subtracts factor * row k. A zero pivot becomes +-1e-30, so a singular
// matrix yields a finite wrong answer; a NaN never wins the pivot search
// and propagates into the output, so NaN in gives non-finite out.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gj_inverse_f32_kernel(const float* __restrict__ a, float* __restrict__ out,
                      int n) {
  __shared__ float aug[kMaxN][2 * kMaxN + 1];
  __shared__ float fac[kMaxN];
  __shared__ int piv_row;

  const int tid = threadIdx.x;
  const int w = 2 * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const float* A = a + base;

  for (int e = tid; e < n * w; e += blockDim.x) {
    const int r = e / w;
    const int c = e - r * w;
    aug[r][c] = c < n ? A[r * n + c] : (c - n == r ? 1.f : 0.f);
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    if (tid < 32) {
      float best = -1.f;
      int best_row = k;
      // rows visited in increasing order: strict '>' keeps the lowest
      for (int r = k + tid; r < n; r += 32) {
        const float v = fabsf(aug[r][k]);
        if (v > best) {
          best = v;
          best_row = r;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int orow = __shfl_down_sync(0xffffffffu, best_row, off);
        if (ov > best || (ov == best && orow < best_row)) {
          best = ov;
          best_row = orow;
        }
      }
      if (tid == 0) piv_row = best_row;
    }
    __syncthreads();

    const int p = piv_row;
    if (p != k) {
      for (int c = tid; c < w; c += blockDim.x) {
        const float t = aug[k][c];
        aug[k][c] = aug[p][c];
        aug[p][c] = t;
      }
      __syncthreads();
    }

    float pivot = aug[k][k];
    if (!(fabsf(pivot) > 1e-30f)) pivot = pivot >= 0.f ? 1e-30f : -1e-30f;
    for (int r = tid; r < n; r += blockDim.x) {
      fac[r] = r == k ? 0.f : aug[r][k];
    }
    __syncthreads();

    for (int c = tid; c < w; c += blockDim.x) aug[k][c] = aug[k][c] / pivot;
    __syncthreads();

    for (int e = tid; e < n * w; e += blockDim.x) {
      const int r = e / w;
      const int c = e - r * w;
      if (r != k) aug[r][c] -= fac[r] * aug[k][c];
    }
    __syncthreads();
  }

  float* X = out + base;
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int r = e / n;
    const int c = e - r * n;
    X[e] = aug[r][n + c];
  }
}

}  // namespace

// a, out: (batch, n, n) row-major f32 on the device; 1 <= n <= 64.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tsb_gj_inverse_f32(const float* a, float* out, int batch,
                                  int n, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  gj_inverse_f32_kernel<<<batch, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a, out, n);
  return static_cast<int>(cudaGetLastError());
}
