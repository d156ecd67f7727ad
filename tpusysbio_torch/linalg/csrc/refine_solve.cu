// Batched f64 solve A y = b from an f32 inverse X, with iterative
// refinement.
//
// Replaces: tpusysbio/linalg/pallas_lu.py::_make_refine_kernel (launched by
// _refine_solve_f32pairs from _refine_solve), the TPU kernel behind every
// f64 state-column Newton solve on the BDF main path.
//
// It computes y = X fl32(b) with an f32 accumulator, then exactly
// kSteps = 3 rounds of r = b - A y and y += X fl32(r). The TPU has no
// native f64, so the reference formed r in double-float (hi, lo) f32 pairs
// with error-free transforms; the H100 has native FP64, so r is formed in
// plain double here. The contract is the solution's accuracy (relative
// error < 1e-9 on Newton matrices), with the requested step count acting
// as a minimum.
//
// Bound on the H100: at the main path's shapes (B=256, n=22) the kernel
// reads X (f32) and A (f64) once, 256*22*22*12 B = 1.5 MB, plus b, and
// writes y: about 0.45 us at 3.35 TB/s. Each round is a dependent
// mat-vec, so what bounds it is latency (four dependent mat-vecs with
// barriers) and the launch, one per Newton trip on the main path.
//
// Design: one thread block per member, one thread per row. X and A are
// staged into dynamic shared memory with coalesced loads (rows padded by
// one element), so each of the four mat-vecs reads shared memory only.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kSteps = 3;

__global__ void refine_solve_kernel(const float* __restrict__ x,
                                    const double* __restrict__ a,
                                    const double* __restrict__ b,
                                    double* __restrict__ y, int n) {
  extern __shared__ double smem[];
  const int ld = n + 1;
  double* sA = smem;                                   // n x ld f64
  float* sX = reinterpret_cast<float*>(sA + n * ld);   // n x ld f32
  __shared__ double sy[kMaxN];
  __shared__ float sv[kMaxN];

  const int tid = threadIdx.x;
  const size_t mat = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t vec = static_cast<size_t>(blockIdx.x) * n;
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int r = e / n;
    const int c = e - r * n;
    sA[r * ld + c] = a[mat + e];
    sX[r * ld + c] = x[mat + e];
  }
  double bi = 0.0;
  if (tid < n) {
    bi = b[vec + tid];
    sv[tid] = static_cast<float>(bi);
  }
  __syncthreads();

  // y = X fl32(b), f32 accumulation
  double yi = 0.0;
  if (tid < n) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc += sX[tid * ld + j] * sv[j];
    yi = static_cast<double>(acc);
    sy[tid] = yi;
  }
  __syncthreads();

  for (int s = 0; s < kSteps; ++s) {
    // r = b - A y in native FP64
    if (tid < n) {
      double acc = 0.0;
      for (int j = 0; j < n; ++j) acc += sA[tid * ld + j] * sy[j];
      sv[tid] = static_cast<float>(bi - acc);
    }
    __syncthreads();
    // y += X fl32(r)
    if (tid < n) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc += sX[tid * ld + j] * sv[j];
      yi += static_cast<double>(acc);
      sy[tid] = yi;
    }
    __syncthreads();
  }
  if (tid < n) y[vec + tid] = yi;
}

}  // namespace

// x: (batch, n, n) f32; a: (batch, n, n) f64; b, y: (batch, n) f64; all
// row-major on the device; 1 <= n <= 64. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int tsb_refine_solve(const float* x, const double* a,
                                const double* b, double* y, int batch, int n,
                                void* stream) {
  if (n < 1 || n > kMaxN || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int smem = n * (n + 1) * static_cast<int>(sizeof(double) +
                                                  sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        refine_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n <= 32 ? 32 : 64;
  refine_solve_kernel<<<batch, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(x, a, b, y, n);
  return static_cast<int>(cudaGetLastError());
}
