// K6: the BDF stepper's step controller, one launch a trip: the error test,
// the order and step choice, and the update of the difference array D.
//
// Replaces no TPU kernel: the JAX package's controller (the error norms, the
// accept/reject and adaptation logic, the 8 x 8 map W = T(h_factor) M(order)
// and the row mix D_new = W D + v d) is elementwise work over the members and
// one small batched product, which XLA fuses. In eager PyTorch the same
// composition (tpusysbio_torch/solvers/bdf.py step_control_plain) is ~210
// ops a trip that the host issues one at a time (2.5 ms of host time a trip
// at 256 members, 3.6 ms at 10,000), and the row mix alone makes 16
// full-size temporaries:
// at B = 10,000 members of MAPK-22 the f32 sensitivity part of D is
// (B, 8, 22, 30), 211 MB, and the mix with settle's gate moves ~9 GB a trip.
//
// What bounds it on the H100: bytes. Each element of D is read once and
// each element of D_new written once, with d read once: at B = 10,000 that
// is ~0.48 GB, 0.14 ms at 3.35 TB/s; the arithmetic (9 multiply-adds an
// output element) is far below the f32 and f64 peaks. The design:
//   - one block a member; up to a warp of lanes (more for long rows at a
//     small batch) reduces the member's three error norms, thread 0 takes
//     the decisions, a few threads build W and v in shared memory;
//   - then every thread streams positions of each part: it reads the 8 rows
//     of D and d at its position and writes the 8 mixed rows (coalesced,
//     each byte once), or copies the rows the attempt began with where the
//     gate is off (a member that is not running, or whose step underflowed:
//     the gate that settle applied to D before).
//
// The numbers follow the plain twin op by op, each operation rounded on its
// own (the __*_rn intrinsics: nvcc contracts nothing into an FMA):
//   - the error norms in part 0's dtype, each sqrt(sum(x^2) * (1/N)) with
//     the sum in the order of PyTorch's CUDA reduction of the row (see
//     sums_of_squares) and 1/N as its mean takes it;
//   - the decisions, the factors (pow) and R, P, W and v in the control
//     dtype; the products P = R(h) R(1), W = T M and v = T u summed from
//     zero in order k = 0, 1, ... (the twin's _ordered_bmm);
//   - the row mix in each part's dtype, with W and v cast to it, in the
//     twin's order: w_0 D_0, + w_1 D_1, ..., + w_7 D_7, then + v d.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxOrder = 5;
constexpr int kR = kMaxOrder + 1;     // rows and columns of R and P
constexpr int kRows = kMaxOrder + 3;  // rows of D (bdf.py D_ROWS)
constexpr int kW = kRows * kRows;     // W, then v, in one array
constexpr int kNewtonMaxiter = 4;
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 6;   // <= 80 registers a thread: no spills

// A dtype, as bdf.py codes it.
constexpr int kF64 = 0;
constexpr int kF32 = 1;
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
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float pow_ct(float a, float b) {
  return powf(a, b);
}
__device__ __forceinline__ double pow_ct(double a, double b) {
  return pow(a, b);
}
template <typename T>
__device__ __forceinline__ T eps_of();
template <>
__device__ __forceinline__ float eps_of<float>() {
  return FLT_EPSILON;
}
template <>
__device__ __forceinline__ double eps_of<double>() {
  return DBL_EPSILON;
}

// torch.clamp with one bound: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) {
  return isnan(x) ? x : (x > hi ? hi : x);
}

struct Part {
  int kind, k;
  const void* D;      // (B, kRows, n, k), as predicted from
  const void* D_old;  // (B, kRows, n, k), as the attempt began
  const void* d;      // (B, n, k)
  void* D_new;        // (B, kRows, n, k), written whole
};

struct Args {
  int batch, n, full;
  const void* Y0;  // (B, n, k_0): part 0 of the corrected block
  const long long* order;
  const int *n_iter, *n_equal;
  const bool *converged, *current_jac, *running, *too_small;
  const void *h_abs, *t, *t_new, *error_const;  // control dtype
  double rtol, atol, safety9, min_factor, max_factor;
  bool *accept, *reject, *lu_valid_new, *current_jac_new;
  long long* order_new;
  int* n_equal_new;
  void *h_new, *t_next;
  Part part[2];
};

template <typename CT>
struct Shared {
  CT Rf[kR][kR], R1[kR][kR], P[kR][kR];
  double wd[kW + kRows];  // W, then v, as f64 (a f64 part)
  float wf[kW + kRows];   // and as f32 (a f32 part)
  CT h_factor;
  int order, order_new;
  bool accept, change;
};

// PyTorch's last_pow2 (ATen/native/cuda/Reduce.cuh)
__device__ __forceinline__ int last_pow2(long long n) {
  int p = 1;
  while (2LL * p <= n) p *= 2;
  return p;
}

// Adds the square of element j's scaled error `which` (0: the order's own,
// 1: order - 1's, 2: order + 1's) to acc[i].
template <typename P0>
struct Squares {
  const P0 *y, *d, *Do, *Dp;
  long long step;
  P0 rtol, atol, ec_o, ec_m, ec_p;

  __device__ __forceinline__ void add(long long j, int which, P0 acc[4],
                                      int i) const {
    const long long e = j * step;
    const P0 scale = add_rn(mul_rn(abs_of(y[e]), rtol), atol);
    const P0 de = d[e];
    const P0 err = which == 0   ? mul_rn(ec_o, de)
                   : which == 1 ? mul_rn(ec_m, add_rn(Do[e], de))
                                : mul_rn(ec_p, sub_rn(de, Dp[e]));
    const P0 x = div_rn(err, scale);
    acc[i] = add_rn(acc[i], mul_rn(x, x));
  }
};

// Thread 0 gets the three sums of squares of the member's scaled errors
// (the order's own, and those of order - 1 and order + 1) over N values,
// each summed as PyTorch's CUDA reduction sums a row of a contiguous
// (batch, N) tensor (Reduce.cuh): `width` lanes a row as setReduceConfig
// gives them, rows of N >= 128 read as aligned vectors of 4 after a head
// that the row's offset leaves unaligned (the tensor's base is 512-byte
// aligned), four running sums a lane added in order, then halving strides
// across the lanes. Called by every thread. A row that PyTorch would split
// across warps (N >= 16 * width * min(height, 16)) or give more lanes than
// a block has is summed in this scheme all the same, in another order.
// The order is PyTorch 2.11's; the stepper needs none in particular. It is
// followed so that the card tests can hold h_new and D_new to 4 ulps of
// the twin's: one ulp of an f32 norm moves h_new by ~1e8 f64 ulps, one ulp
// of h_factor a row of D by up to 1.6e6. A PyTorch that sums otherwise
// fails those checks with no fault here.
template <typename P0>
__device__ __forceinline__ void sums_of_squares(const Args& a, int b,
                                                long long order, P0 ec_o,
                                                P0 ec_m, P0 ec_p, P0* red,
                                                P0 out[3]) {
  const int tid = threadIdx.x;
  const int k0 = a.part[0].k;
  const long long nk = static_cast<long long>(a.n) * k0;
  const long long N = a.full ? nk : a.n;
  const P0* D = static_cast<const P0*>(a.part[0].D) + b * kRows * nk;
  const Squares<P0> sq{static_cast<const P0*>(a.Y0) + b * nk,
                       static_cast<const P0*>(a.part[0].d) + b * nk,
                       D + order * nk, D + (order + 1) * nk,
                       a.full ? 1 : k0, static_cast<P0>(a.rtol),
                       static_cast<P0>(a.atol), ec_o, ec_m, ec_p};
  // setReduceConfig's block shape, at most 512 threads
  const bool vec = N >= 128;
  const long long dim0 = vec ? N / 4 : N;
  const int d0p = dim0 < 512 ? last_pow2(dim0) : 512;
  const int d1p = a.batch < 512 ? last_pow2(a.batch) : 512;
  const int height = min(d1p, 512 / min(d0p, 32));
  const int width = min(min(d0p, 512 / height), kThreads);
  const int shift = static_cast<int>((b * N) % 4);
  const long long head = vec && shift > 0 ? 4 - shift : 0;
  const long long end = N - head;
#pragma unroll 1
  for (int which = 0; which < 3; ++which) {
    P0 acc[4] = {0, 0, 0, 0};
    if (tid < width && !vec) {
      for (long long j0 = tid; j0 < N; j0 += 4 * width) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j0 + i * width < N) sq.add(j0 + i * width, which, acc, i);
      }
    } else if (tid < width) {
      if (head > 0 && tid >= shift && tid < 4)
        sq.add(tid - shift, which, acc, 0);
      for (long long q = tid; q * 4 + 3 < end; q += width) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sq.add(head + q * 4 + i, which, acc, i);
      }
      const long long tail = end - end % 4 + tid;
      if (tail < end) sq.add(head + tail, which, acc, 0);
    }
    P0 v = add_rn(add_rn(add_rn(acc[0], acc[1]), acc[2]), acc[3]);
    int lanes = width;
    if (lanes > 32) {
      red[tid] = v;
      __syncthreads();
      for (int off = lanes / 2; off >= 32; off /= 2) {
        if (tid < off) red[tid] = add_rn(red[tid], red[tid + off]);
        __syncthreads();
      }
      v = red[tid];
      __syncthreads();
      lanes = 32;
    }
    if (tid < 32) {
      for (int off = lanes / 2; off > 0; off /= 2)
        v = add_rn(v, __shfl_down_sync(kFullMask, v, off));
      // no index by `which`: the sums stay in registers
      out[0] = which == 0 ? v : out[0];
      out[1] = which == 1 ? v : out[1];
      out[2] = which == 2 ? v : out[2];
    }
  }
}

// Thread 0: the error test, the order and step choice; writes the
// member's scalar outputs and what the map needs into shared memory.
template <typename CT, typename P0>
__device__ __forceinline__ void decide(const Args& a, int b, long long o,
                                       const P0 sums[3], Shared<CT>& s) {
  const CT one = 1;
  const CT inf = static_cast<CT>(INFINITY);
  const P0 inv_n = div_rn(static_cast<P0>(1),
                          static_cast<P0>(a.full ? a.n * a.part[0].k : a.n));
  CT norm[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    norm[k] = static_cast<CT>(sqrt_rn(mul_rn(sums[k], inv_n)));
  // NaN compares false and would accept a garbage step
  const bool bad = !isfinite(norm[0]);
  const CT err = bad ? static_cast<CT>(2) : norm[0];
  const bool conv = a.converged[b];
  const bool cur_jac = a.current_jac[b];
  const bool reject = conv && (err > one || bad);
  const bool accept = conv && !reject;
  const bool case_b = !conv && !cur_jac;
  const bool case_c = !conv && cur_jac;
  const int n_equal_acc = a.n_equal[b] + 1;
  const bool do_adapt = accept && (n_equal_acc >= o + 1);

  const CT of = static_cast<CT>(o);
  const CT norms[3] = {o > 1 ? norm[1] : inf, err,
                       o < kMaxOrder ? norm[2] : inf};
  CT best_f = 0;
  int best = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // -1 / x is reciprocal(x) * -1 in PyTorch
    const CT expo = -div_rn(one, add_rn(of, static_cast<CT>(k)));
    const bool fin = isfinite(norms[k]);
    const CT safe = fin ? clamp_min(norms[k], eps_of<CT>()) : one;
    const CT f = fin ? pow_ct(safe, expo) : static_cast<CT>(0);
    if (k == 0 || f > best_f) {
      best_f = f;
      best = k;
    }
  }
  const CT safety = mul_rn(
      div_rn(one, add_rn(static_cast<CT>(2 * kNewtonMaxiter),
                         static_cast<CT>(a.n_iter[b]))),
      static_cast<CT>(a.safety9));
  const CT factor_adapt = clamp_max(mul_rn(safety, best_f),
                                    static_cast<CT>(a.max_factor));
  const CT factor_rej = clamp_min(
      mul_rn(safety, pow_ct(err, -div_rn(one, add_rn(of, one)))),
      static_cast<CT>(a.min_factor));
  const CT h_factor = case_c ? static_cast<CT>(0.5)
                      : reject ? factor_rej
                      : do_adapt ? factor_adapt : one;
  const bool change = case_c || reject || do_adapt;
  long long order_adapt = o + best - 1;
  order_adapt = order_adapt < 1 ? 1
                : order_adapt > kMaxOrder ? kMaxOrder : order_adapt;
  const long long order_new = do_adapt ? order_adapt : o;

  a.accept[b] = accept;
  a.reject[b] = reject;
  a.order_new[b] = order_new;
  static_cast<CT*>(a.h_new)[b] =
      mul_rn(static_cast<const CT*>(a.h_abs)[b], change ? h_factor : one);
  static_cast<CT*>(a.t_next)[b] = accept ? static_cast<const CT*>(a.t_new)[b]
                                         : static_cast<const CT*>(a.t)[b];
  a.n_equal_new[b] = accept && !do_adapt ? n_equal_acc : 0;
  // SciPy keeps the factorization across error-test rejections; only
  // Newton failure, a Jacobian refresh or adaptation drop it
  a.lu_valid_new[b] = !(case_b || case_c || do_adapt);
  a.current_jac_new[b] = case_b ? true : (accept ? false : cur_jac);

  s.h_factor = h_factor;
  s.order = static_cast<int>(o);
  s.order_new = static_cast<int>(order_new);
  s.accept = accept;
  s.change = change;
}

// change_D's map T[i][k]: (R(h_factor) R(1))^T on the leading
// (order_new + 1)^2 block where the step changes, identity elsewhere.
template <typename CT>
__device__ __forceinline__ CT transform(const Shared<CT>& s, int i, int k) {
  const int o = s.order_new;
  if (s.change && i <= o && k <= o) return s.P[k][i];
  return i == k ? static_cast<CT>(1) : static_cast<CT>(0);
}

// The accept update's map M[k][j] (identity on a rejected step): rows
// k <= order sum D[k..order], row order + 1 is empty (d alone), row
// order + 2 is -D[order + 1], the rows above are kept.
template <typename CT>
__device__ __forceinline__ CT accept_map(const Shared<CT>& s, int k, int j) {
  const int o = s.order;
  const CT one = 1, zero = 0;
  if (!s.accept) return k == j ? one : zero;
  if (k <= o) return j >= k && j <= o ? one : zero;
  if (k == o + 2) return j == o + 1 ? -one : -zero;
  return k == j && k > o + 2 ? one : zero;
}

// W = T M and v = T u (u: 1 on rows <= order + 2 of an accepted step), in
// the control dtype, then cast for the parts.
template <typename CT>
__device__ __forceinline__ void build_map(Shared<CT>& s) {
  const int tid = threadIdx.x;
  if (tid < 2 * kR * kR) {
    // the factors m[i][j] of R(h_factor), then of R(1)
    const int i = tid % (kR * kR) / kR, j = tid % kR;
    const CT f = tid < kR * kR ? s.h_factor : static_cast<CT>(1);
    CT m = 1;
    if (i > 0)
      m = j == 0 ? static_cast<CT>(0)
                 : div_rn(sub_rn(static_cast<CT>(i - 1),
                                 mul_rn(f, static_cast<CT>(j))),
                          static_cast<CT>(i));
    (tid < kR * kR ? s.Rf : s.R1)[i][j] = m;
  }
  __syncthreads();
  if (tid < 2 * kR) {
    // cumulative products down each column, from 1 * m[0][j]
    CT(*R)[kR] = tid < kR ? s.Rf : s.R1;
    const int j = tid % kR;
    CT acc = 1;
    for (int i = 0; i < kR; ++i) {
      acc = mul_rn(acc, R[i][j]);
      R[i][j] = acc;
    }
  }
  __syncthreads();
  if (tid < kR * kR) {
    const int i = tid / kR, j = tid % kR;
    CT acc = 0;
#pragma unroll
    for (int k = 0; k < kR; ++k)
      acc = add_rn(acc, mul_rn(s.Rf[i][k], s.R1[k][j]));
    s.P[i][j] = acc;
  }
  __syncthreads();
  if (tid < kW + kRows) {
    CT acc = 0;
    if (tid < kW) {
      const int i = tid / kRows, j = tid % kRows;
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        acc = add_rn(acc, mul_rn(transform(s, i, k), accept_map(s, k, j)));
    } else {
      const int i = tid - kW;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const CT u = s.accept && k <= s.order + 2 ? static_cast<CT>(1)
                                                  : static_cast<CT>(0);
        acc = add_rn(acc, mul_rn(transform(s, i, k), u));
      }
    }
    s.wd[tid] = static_cast<double>(acc);
    s.wf[tid] = static_cast<float>(acc);
  }
  __syncthreads();
}

// D_new of one part: each thread two positions of the member's n k values
// at a time, their 18 loads in flight together.
template <typename P>
__device__ __forceinline__ void mix_part(const Part& pt, int n, int b,
                                         bool gate, const P* w) {
  const long long E = static_cast<long long>(n) * pt.k;
  const P* D = static_cast<const P*>(gate ? pt.D : pt.D_old) + b * kRows * E;
  const P* d = static_cast<const P*>(pt.d) + b * E;
  P* out = static_cast<P*>(pt.D_new) + b * kRows * E;
  for (long long e0 = threadIdx.x; e0 < E; e0 += 2 * kThreads) {
    const long long e1 = e0 + kThreads;
    const bool two = e1 < E;
    P r0[kRows], r1[kRows], d0 = 0, d1 = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      r0[j] = D[j * E + e0];
      r1[j] = two ? D[j * E + e1] : static_cast<P>(0);
    }
    if (!gate) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        out[i * E + e0] = r0[i];
        if (two) out[i * E + e1] = r1[i];
      }
      continue;
    }
    d0 = d[e0];
    if (two) d1 = d[e1];
#pragma unroll 1
    for (int i = 0; i < kRows; ++i) {
      const P* wi = w + i * kRows;
      P a0 = mul_rn(wi[0], r0[0]), a1 = mul_rn(wi[0], r1[0]);
#pragma unroll
      for (int j = 1; j < kRows; ++j) {
        a0 = add_rn(a0, mul_rn(wi[j], r0[j]));
        a1 = add_rn(a1, mul_rn(wi[j], r1[j]));
      }
      out[i * E + e0] = add_rn(a0, mul_rn(w[kW + i], d0));
      if (two) out[i * E + e1] = add_rn(a1, mul_rn(w[kW + i], d1));
    }
  }
}

template <typename CT>
__device__ __forceinline__ void mix(const Part& pt, int n, int b, bool gate,
                                    const Shared<CT>& s) {
  switch (pt.kind) {
    case kF64:
      mix_part<double>(pt, n, b, gate, s.wd);
      break;
    case kF32:
      mix_part<float>(pt, n, b, gate, s.wf);
      break;
    default:
      break;
  }
}

template <typename CT, typename P0>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    step_control_kernel(const Args a) {
  __shared__ Shared<CT> s;
  __shared__ P0 red[kThreads];
  const int b = blockIdx.x;
  const long long order = a.order[b];
  // a member that is not running, or whose step underflowed, keeps the
  // rows it began the attempt with
  const bool gate = a.running[b] && !a.too_small[b];
  const CT* ec = static_cast<const CT*>(a.error_const);
  const long long om = order - 1 < 0 ? 0 : order - 1;
  const long long op = order + 1 > kMaxOrder ? kMaxOrder : order + 1;
  P0 sums[3] = {0, 0, 0};
  sums_of_squares<P0>(a, b, order, static_cast<P0>(ec[order]),
                      static_cast<P0>(ec[om]), static_cast<P0>(ec[op]), red,
                      sums);
  if (threadIdx.x == 0) decide<CT, P0>(a, b, order, sums, s);
  __syncthreads();
  build_map<CT>(s);
  mix<CT>(a.part[0], a.n, b, gate, s);
  mix<CT>(a.part[1], a.n, b, gate, s);
}

template <typename CT, typename P0>
int launch(const Args& a, cudaStream_t stream) {
  step_control_kernel<CT, P0><<<a.batch, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool valid_kind(int kind) { return kind == kF64 || kind == kF32; }

}  // namespace

// Returns a cudaError_t. The control dtype ct and the parts' kinds are
// kF64 or kF32, a part no wider than the control; part 1 may be absent
// (kind1 -1). full: the error norms over all of part 0, not its column 0.
extern "C" int tsb_step_control(
    int ct, int batch, int n, int full, const void* Y0, const void* order,
    const void* n_iter, const void* n_equal, const void* converged,
    const void* current_jac, const void* h_abs, const void* t,
    const void* t_new, const void* running, const void* too_small,
    const void* error_const, double rtol, double atol, double safety9,
    double min_factor, double max_factor, void* accept, void* reject,
    void* order_new, void* h_new, void* t_next, void* n_equal_new,
    void* lu_valid_new, void* current_jac_new, int kind0, int k0,
    const void* D0, const void* D_old0, const void* d0, void* D_new0,
    int kind1, int k1, const void* D1, const void* D_old1, const void* d1,
    void* D_new1, void* stream) {
  if (batch < 1 || n < 1 || k0 < 1 || !valid_kind(ct) ||
      !valid_kind(kind0) || !(kind1 == kNone || (valid_kind(kind1) && k1 >= 1))
      || (ct == kF32 && (kind0 == kF64 || kind1 == kF64)))
    return cudaErrorInvalidValue;
  Args a;
  a.batch = batch;
  a.n = n;
  a.full = full;
  a.Y0 = Y0;
  a.order = static_cast<const long long*>(order);
  a.n_iter = static_cast<const int*>(n_iter);
  a.n_equal = static_cast<const int*>(n_equal);
  a.converged = static_cast<const bool*>(converged);
  a.current_jac = static_cast<const bool*>(current_jac);
  a.running = static_cast<const bool*>(running);
  a.too_small = static_cast<const bool*>(too_small);
  a.h_abs = h_abs;
  a.t = t;
  a.t_new = t_new;
  a.error_const = error_const;
  a.rtol = rtol;
  a.atol = atol;
  a.safety9 = safety9;
  a.min_factor = min_factor;
  a.max_factor = max_factor;
  a.accept = static_cast<bool*>(accept);
  a.reject = static_cast<bool*>(reject);
  a.lu_valid_new = static_cast<bool*>(lu_valid_new);
  a.current_jac_new = static_cast<bool*>(current_jac_new);
  a.order_new = static_cast<long long*>(order_new);
  a.n_equal_new = static_cast<int*>(n_equal_new);
  a.h_new = h_new;
  a.t_next = t_next;
  a.part[0] = Part{kind0, k0, D0, D_old0, d0, D_new0};
  a.part[1] = Part{kind1, k1, D1, D_old1, d1, D_new1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ct == kF32) return launch<float, float>(a, s);
  return kind0 == kF64 ? launch<double, double>(a, s)
                       : launch<double, float>(a, s);
}
