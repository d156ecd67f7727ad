// K5: the BDF stepper's dense output, folded into the t_eval accumulator at
// the grid points each member's step covers, and nowhere else.
//
// Replaces no TPU kernel: the JAX package evaluates each step's interpolant
// over the whole output grid and keeps the points of the step with a
// select, which XLA fuses into one pass. In eager PyTorch the same
// composition (tpusysbio_torch/solvers/bdf.py dense_fold_plain) makes
// about a dozen full-size tensors a trip: at B = 10,000 members, T = 41
// points and the 22 x 30 f32 sensitivity block each one is (B, T, 22, 30),
// 1.08 GB, and their passes take ~30 GB of device traffic a trip. Yet a
// step covers 0 or 1 grid point on almost every trip.
//
// Each member's warp
//  - returns unless its step was accepted, it is running and its step did
//    not underflow (the gate that the stepper's settle applied to the
//    accumulator before);
//  - reads its T output times (any strides: a shared grid is a stride-0
//    expansion) and keeps the points in (t_old, t_hi], 32 at a time by
//    ballot;
//  - for each such point forms the interpolant's weights once and writes
//    the point's n k values of every part (the f64 state column and the
//    f32 sensitivity block, or the one block), in place.
//
// The values are the plain twin's, bit for bit. The interpolant is
//   x_j  = (tv - (t_new - h j)) / (h (1 + j))     in the time dtype,
//   p_0  = x_0,  p_j = p_{j-1} x_j                 in the compute dtype,
//   p_j  = 0 where j + 1 > order,
//   corr = sum_j p_j D[j + 1], in order j = 0..4   in the compute dtype,
//   out  = D[0] + corr                             in the part's dtype,
// with every operation rounded to nearest on its own (the __*_rn
// intrinsics: nvcc contracts nothing into an FMA) and all five terms
// formed, the zeroed ones too, so that signed zeros and NaNs come out as
// the twin's. The compute dtype is f32 for an f32 part or under dense_f32,
// else f64.
//
// What bounds it on the H100. At B = 10,000 members of MAPK-22 every warp
// reads 3 flags and, past the gate, its step and 41 times; the members with
// a point in range (~16% a trip) read rows 0-5 of D, 22 x (8 + 30 x 4)
// bytes each, and write one point: ~30 MB, ~10 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxOrder = 5;
constexpr int kWarps = 8;   // members a block

// A part's storage and compute dtypes, as bdf.py codes them.
constexpr int kF64 = 0;     // f64, computed in f64
constexpr int kF64C32 = 1;  // f64, computed in f32 (dense_f32)
constexpr int kF32 = 2;     // f32
constexpr int kNone = -1;   // no second part

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

struct Part {
  int kind, k;
  const void* d;   // (B, d_rows, n, k), rows 0..kMaxOrder read
  void* acc;       // (B, T, n, k), written in place
};

struct Args {
  int batch, T, n, d_rows;
  const void* t_eval;
  long long te_sb, te_st;   // t_eval's strides, in elements
  const void *t_old, *t_hi, *t_new, *h_new;
  const long long* order;
  const bool *accept, *running, *too_small;
  Part part[2];
};

// One point of one part: the lanes over its n k values.
template <typename P, typename C, typename TT>
__device__ __forceinline__ void fold_part(const Part& pt, const Args& a,
                                          int b, int q, const TT* x,
                                          long long order, int lane) {
  C p[kMaxOrder];
  p[0] = static_cast<C>(x[0]);
#pragma unroll
  for (int j = 1; j < kMaxOrder; ++j)
    p[j] = mul_rn(p[j - 1], static_cast<C>(x[j]));
#pragma unroll
  for (int j = 0; j < kMaxOrder; ++j)
    if (j + 1 > order) p[j] = static_cast<C>(0);
  const long long nk = static_cast<long long>(a.n) * pt.k;
  const P* d = static_cast<const P*>(pt.d) + b * a.d_rows * nk;
  P* out = static_cast<P*>(pt.acc) +
           (static_cast<long long>(b) * a.T + q) * nk;
  for (long long e = lane; e < nk; e += 32) {
    C c = mul_rn(p[0], static_cast<C>(d[nk + e]));
#pragma unroll
    for (int j = 1; j < kMaxOrder; ++j)
      c = add_rn(c, mul_rn(p[j], static_cast<C>(d[(j + 1) * nk + e])));
    out[e] = add_rn(d[e], static_cast<P>(c));
  }
}

template <typename TT>
__device__ __forceinline__ void fold_point(const Part& pt, const Args& a,
                                           int b, int q, const TT* x,
                                           long long order, int lane) {
  switch (pt.kind) {
    case kF64:
      fold_part<double, double>(pt, a, b, q, x, order, lane);
      break;
    case kF64C32:
      fold_part<double, float>(pt, a, b, q, x, order, lane);
      break;
    case kF32:
      fold_part<float, float>(pt, a, b, q, x, order, lane);
      break;
    default:
      break;
  }
}

template <typename TT>
__global__ void __launch_bounds__(32 * kWarps)
    dense_fold_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long bl = static_cast<long long>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
  if (bl >= a.batch) return;
  const int b = static_cast<int>(bl);
  if (!a.accept[b] || !a.running[b] || a.too_small[b]) return;
  const TT lo = static_cast<const TT*>(a.t_old)[b];
  const TT hi = static_cast<const TT*>(a.t_hi)[b];
  const TT tn = static_cast<const TT*>(a.t_new)[b];
  const TT h = static_cast<const TT*>(a.h_new)[b];
  const long long order = a.order[b];
  const TT* tv = static_cast<const TT*>(a.t_eval) + b * a.te_sb;
  for (int base = 0; base < a.T; base += 32) {
    const int i = base + lane;
    TT t = 0;
    bool in = false;
    if (i < a.T) {
      t = tv[i * a.te_st];
      in = (t > lo) && (t <= hi);
    }
    unsigned hits = __ballot_sync(kFullMask, in);
    while (hits) {
      const int src = __ffs(hits) - 1;
      hits &= hits - 1;
      const TT tq = __shfl_sync(kFullMask, t, src);
      TT x[kMaxOrder];
#pragma unroll
      for (int j = 0; j < kMaxOrder; ++j) {
        const TT shift = sub_rn(tn, mul_rn(h, static_cast<TT>(j)));
        x[j] = div_rn(sub_rn(tq, shift), mul_rn(h, static_cast<TT>(1 + j)));
      }
      fold_point<TT>(a.part[0], a, b, base + src, x, order, lane);
      fold_point<TT>(a.part[1], a, b, base + src, x, order, lane);
    }
  }
}

template <typename TT>
int launch(const Args& a, cudaStream_t stream) {
  const int grid = (a.batch + kWarps - 1) / kWarps;
  dense_fold_kernel<TT><<<grid, 32 * kWarps, 0, stream>>>(a);
  return cudaGetLastError();
}

bool valid_kind(int kind) {
  return kind == kF64 || kind == kF64C32 || kind == kF32;
}

}  // namespace

// Returns a cudaError_t. Times in f64 (time_f64 1) or f32; part 1 may be
// absent (kind1 -1).
extern "C" int tsb_dense_fold(int time_f64, int batch, int T, int n,
                              const void* t_eval, long long te_sb,
                              long long te_st, const void* t_old,
                              const void* t_hi, const void* t_new,
                              const void* h_new, const void* order,
                              const void* accept, const void* running,
                              const void* too_small, int d_rows, int kind0,
                              int k0, const void* d0, void* acc0, int kind1,
                              int k1, const void* d1, void* acc1,
                              void* stream) {
  if (batch < 1 || T < 0 || n < 1 || d_rows < kMaxOrder + 1 ||
      !valid_kind(kind0) || !(kind1 == kNone || valid_kind(kind1)))
    return cudaErrorInvalidValue;
  Args a;
  a.batch = batch;
  a.T = T;
  a.n = n;
  a.d_rows = d_rows;
  a.t_eval = t_eval;
  a.te_sb = te_sb;
  a.te_st = te_st;
  a.t_old = t_old;
  a.t_hi = t_hi;
  a.t_new = t_new;
  a.h_new = h_new;
  a.order = static_cast<const long long*>(order);
  a.accept = static_cast<const bool*>(accept);
  a.running = static_cast<const bool*>(running);
  a.too_small = static_cast<const bool*>(too_small);
  a.part[0] = Part{kind0, k0, d0, acc0};
  a.part[1] = Part{kind1, k1, d1, acc1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return time_f64 ? launch<double>(a, s) : launch<float>(a, s);
}
