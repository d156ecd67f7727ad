// Batched f64 solve A y = b from an f32 inverse X, with iterative
// refinement.
//
// Replaces: tpusysbio/linalg/pallas_lu.py::_make_refine_kernel (launched by
// _refine_solve_f32pairs from _refine_solve), the TPU kernel behind every
// f64 state-column Newton solve on the BDF main path and in the fit's
// polish.
//
// It computes y = X fl32(b) with an f32 accumulator, then exactly
// kSteps = 3 rounds of r = b - A y and y += X fl32(r), every sum taken
// over j in increasing order with the multiply-add contracted (written out
// as fma, so the bits do not depend on the compiler). The TPU has no native
// f64, so the reference formed r in double-float (hi, lo) f32 pairs with
// error-free transforms; the H100 has native FP64, so r is formed in plain
// double here. The contract is the solution's accuracy (relative error
// < 1e-9 on Newton matrices), with the requested step count acting as a
// minimum.
//
// What bounds it on the H100. At the paths' shapes (B = 256 or 16, n = 22)
// the kernel reads X (f32) and A (f64) once, B*n*n*12 B = 1.5 MB at B = 256,
// plus b, and writes y: under half a microsecond at 3.35 TB/s, and the
// operations are fewer still. It cannot come near that bound: its time is
// the launch (an empty kernel through the same route takes 0.0019 ms,
// chip_smoke.py's [floor] line) plus the latency of seven DEPENDENT
// mat-vecs, each of which needs the whole vector the one before produced.
// So the design removes latency between the mat-vecs. Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, n = 22, from a queue
// of launches: 0.0045 ms at B = 16 and 64, 0.0047 ms at B = 256, 0.0061 ms
// at B = 1024 (the design before it, a 32-thread block per member staging
// X and A in shared memory with a barrier after each mat-vec: 0.0080,
// 0.0080, 0.0081, 0.0085 ms in the same process,
// linalg/compare_designs.py); at n = 64 the tile path takes 0.0189 ms at
// B = 256 (before: 0.0192 ms).
//
// Design. One warp per member, kWarpsPerBlock members per block, warps
// that never meet.
//  - n <= 32 (both main paths run n = 22): lane r holds row r of X (f32)
//    and row r of A (f64) in registers; the kernel is a template on the
//    padded width (8, 16, 24, 32) with every loop over columns fully
//    unrolled, so a row element is a register. The vector of a mat-vec
//    (fl32(b), y, fl32(r)) lives one element per lane and element j reaches
//    all lanes by __shfl_sync with a compile-time j: no shared memory, no
//    barrier and no staging pass between the seven mat-vecs. The shuffles
//    of a mat-vec go out together, ahead of its chain of multiply-adds.
//  - 32 < n <= 64: two f64 rows per lane do not fit in registers. A block
//    of 64 threads serves one member from a shared-memory tile (rows padded
//    by one element, staged row by row with neighbouring threads on
//    neighbouring addresses and no per-element division), thread r doing
//    row r, with a block barrier after each mat-vec.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kSteps = 3;
constexpr int kWarpsPerBlock = 2;
constexpr int kTileThreads = 64;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// sum over j < n, in increasing j, of row[j] * (the value `mine` of lane j),
// each multiply-add contracted. All shuffles first, then the arithmetic:
// with one loop ptxas pairs each shuffle with the multiply-add that consumes
// it, and the sum then waits for every shuffle's latency in turn.
template <int W, typename T>
__device__ __forceinline__ T dot_with_lanes(const T (&row)[W], T mine,
                                            int n) {
  T theirs[W];
#pragma unroll
  for (int j = 0; j < W; ++j) theirs[j] = __shfl_sync(kFullMask, mine, j);
  T acc = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j >= n) break;
    acc = fma_rn(row[j], theirs[j], acc);
  }
  return acc;
}

// n <= W <= 32: rows in registers, vectors by shuffle.
template <int W>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
refine_solve_rows_kernel(const float* __restrict__ x,
                         const double* __restrict__ a,
                         const double* __restrict__ b,
                         double* __restrict__ y, int batch, int n) {
  const int lane = threadIdx.x & 31;
  const long long m = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  // the whole warp leaves together, and nothing below waits for the block
  if (m >= batch) return;
  const size_t mat = static_cast<size_t>(m) * n * n;
  const size_t vec = static_cast<size_t>(m) * n;
  const bool live = lane < n;

  float xr[W];
  double ar[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const bool in = live && c < n;
    xr[c] = in ? x[mat + lane * n + c] : 0.f;
    ar[c] = in ? a[mat + lane * n + c] : 0.0;
  }
  const double bi = live ? b[vec + lane] : 0.0;

  // y = X fl32(b), f32 accumulation
  float v = static_cast<float>(bi);
  float acc = dot_with_lanes<W>(xr, v, n);
  double yi = static_cast<double>(acc);

#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    // r = b - A y in native FP64
    const double d = dot_with_lanes<W>(ar, yi, n);
    v = static_cast<float>(bi - d);
    // y += X fl32(r)
    acc = dot_with_lanes<W>(xr, v, n);
    yi += static_cast<double>(acc);
  }
  if (live) y[vec + lane] = yi;
}

// 32 < n <= 64: one member per block of kTileThreads, rows in shared memory.
__global__ void __launch_bounds__(kTileThreads)
refine_solve_tile_kernel(const float* __restrict__ x,
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
  const int lane = tid & 31;
  const size_t mat = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t vec = static_cast<size_t>(blockIdx.x) * n;
  for (int r = tid >> 5; r < n; r += kTileThreads / 32) {
    for (int c = lane; c < n; c += 32) {
      sA[r * ld + c] = a[mat + r * n + c];
      sX[r * ld + c] = x[mat + r * n + c];
    }
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
    for (int j = 0; j < n; ++j) acc = __fmaf_rn(sX[tid * ld + j], sv[j], acc);
    yi = static_cast<double>(acc);
    sy[tid] = yi;
  }
  __syncthreads();

  for (int s = 0; s < kSteps; ++s) {
    // r = b - A y in native FP64
    if (tid < n) {
      double d = 0.0;
      for (int j = 0; j < n; ++j) d = __fma_rn(sA[tid * ld + j], sy[j], d);
      sv[tid] = static_cast<float>(bi - d);
    }
    __syncthreads();
    // y += X fl32(r)
    if (tid < n) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) {
        acc = __fmaf_rn(sX[tid * ld + j], sv[j], acc);
      }
      yi += static_cast<double>(acc);
      sy[tid] = yi;
    }
    __syncthreads();
  }
  if (tid < n) y[vec + tid] = yi;
}

template <int W>
int launch_rows(const float* x, const double* a, const double* b, double* y,
                int batch, int n, cudaStream_t s) {
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  refine_solve_rows_kernel<W>
      <<<blocks, 32 * kWarpsPerBlock, 0, s>>>(x, a, b, y, batch, n);
  return static_cast<int>(cudaGetLastError());
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 8) return launch_rows<8>(x, a, b, y, batch, n, s);
  if (n <= 16) return launch_rows<16>(x, a, b, y, batch, n, s);
  if (n <= 24) return launch_rows<24>(x, a, b, y, batch, n, s);
  if (n <= 32) return launch_rows<32>(x, a, b, y, batch, n, s);
  const int smem = n * (n + 1) * static_cast<int>(sizeof(double) +
                                                  sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        refine_solve_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  refine_solve_tile_kernel<<<batch, kTileThreads, smem, s>>>(x, a, b, y, n);
  return static_cast<int>(cudaGetLastError());
}
