// K4: the closed-form derivatives of a mass-action network, batched.
//
// Replaces no TPU kernel: the JAX package leaves these functions to XLA,
// which fuses them. In PyTorch, tpusysbio_torch/model/massaction.py builds
// the rate gradient M[b, j, i] = d rate_j / d y_i from about thirty eager
// ops a call (three nested where over a (B, rx, n) view for the monomials
// and their derivatives, two cumulative-product scans along the species
// axis for the exclusive product over the other species, a product, two
// batched matmuls), each reading and writing a (B, rx, n) tensor. This
// kernel computes each of its three consumers in one launch:
//
//   epilogue 0 (jac):      J     = S M                      (B, n, n)
//   epilogue 1 (sens):     dSens = S (M Sens + diag(mono))  (B, n, m), m = rx
//   epilogue 2 (sens_dir): dSens = S (M Sens + mono C)      (B, n, G)
//
// in the dtype of y (float for the split sensitivity block, double for the
// Jacobian), with no division: the exclusive product over the other
// reactant species is formed directly per (reaction, species), so it is
// exact at zero concentrations, and only the order of the products and
// sums differs from the plain twin in massaction.py.
//
// What bounds it on the H100. At B = 10,000 members of the 22-species,
// 30-reaction MAPK network the sens epilogue reads y, p and Sens and writes
// dSens: ~53 MB, 16 us at 3.35 TB/s. The network is sparse (two reactant
// species and three stoichiometric entries a reaction), so the arithmetic
// is ~4,000 multiply-adds a member, far below the bytes. The design keeps
// every intermediate out of device memory and reads and writes each
// member's tiles once.
//
// Design. The network's tables (a "plan" of int32 words, built once per
// network and device by massaction.py) list each reaction's reactant
// species with their exponents (1..3), each species' reactant entries by
// reaction, and the nonzeros of S by row and by column. One warp per
// member, up to 8 members a block; the block copies the plan and S's
// nonzeros into shared memory, each warp stages its member's y there.
// Then
//  - lanes over reactions: the monomial and each entry of M from the
//    reactant terms y^r and their derivatives, into shared memory;
//  - jac: lanes over the columns i of J, 32 at a time; lane i adds
//    S[:, j] M[j, i] for the reactions j that have species i as a
//    reactant, from S's nonzeros by column, into its column of an
//    n x 32 tile, then stores each row k of the tile with the lanes on
//    neighbouring addresses;
//  - sens, sens_dir: lanes over the columns c of Sens, 32 at a time; the
//    warp stages those columns of Sens, lane c forms column c of
//    inner = M Sens + epilogue (only lane c touches it), then dSens[k, c]
//    as the sum over row k's nonzeros of S.
// A member's shared memory thus grows with n + rx and never with n rx or
// the number of columns: the 99-species, 146-reaction network takes
// ~70 KB a member in double, which the block opts into (the H100 allows
// 227 KB a block). This file alone sizes the blocks (`pick_warps`).
//
// Non-finite values. The plain twin multiplies dense matrices, so a
// non-finite entry spreads through its zeros (0 * inf = nan): a non-finite
// M[j, i] poisons column i of J and all of dSens; a non-finite Sens[i, c]
// or inner[j, c] poisons column c of dSens. An entry M[j, i] with species
// i no reactant of reaction j is (p_j * 0) * (product of reaction j's
// terms): nan when p_j or the monomial is not finite, else 0. The kernel
// skips those zeros but keeps the same flags and writes nan to every
// output entry that the dense product makes non-finite, so the Newton
// loop's finiteness test sees the same members fail.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr size_t kDefaultSmem = 48 * 1024;   // a block's, without opting in
constexpr int kMaxDevices = 64;
constexpr int kJac = 0;
constexpr int kSens = 1;
constexpr int kSensDir = 2;
constexpr int kTooLarge = -1;   // a member's tiles do not fit a block

struct Dims {
  int n, rx, nnz_r, nnz_s, m, words;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Columns of the output a warp takes at once: lane c owns column c.
__host__ __device__ inline int tile_cols(int epi, const Dims& d) {
  const int cols = epi == kJac ? d.n : d.m;
  return cols < 32 ? cols : 32;
}

// Shared memory of a block, in this order, each part 16-byte aligned: the
// plan; S's nonzeros in the dtype (by column for jac, by row otherwise);
// per member y, the monomials, the entries of M, the tile (jac: n x W
// sums; sens: the n x W Sens columns and the rx x W inner columns), then
// one int flag a reaction.
template <typename T>
__host__ __device__ inline size_t fixed_bytes(const Dims& d) {
  return align16(4 * static_cast<size_t>(d.words)) +
         align16(sizeof(T) * static_cast<size_t>(d.nnz_s));
}
template <typename T>
__host__ __device__ inline size_t member_values(int epi, const Dims& d) {
  const size_t rows = epi == kJac ? d.n : d.n + d.rx;
  return static_cast<size_t>(d.n) + d.rx + d.nnz_r + rows * tile_cols(epi, d);
}
template <typename T>
__host__ __device__ inline size_t member_bytes(int epi, const Dims& d) {
  return align16(member_values<T>(epi, d) * sizeof(T) + 4 * size_t(d.rx));
}

// The plan's parts (int32 words): a header (n, rx, nnz_r, nnz_s), then
//   rptr[rx + 1], rent[nnz_r]    reaction j's entries rptr[j]..rptr[j+1],
//                                each species * 4 + exponent, by species;
//   cptr[n + 1], cj[nnz_r], ce[nnz_r]
//                                species i's reactant entries, by reaction:
//                                the reaction and the entry's index;
//   sptr[n + 1], sj[nnz_s], sv[nnz_s]
//                                row k of S: its reactions and values;
//   qptr[rx + 1], qk[nnz_s], qv[nnz_s]
//                                column j of S: its species and values.
struct Plan {
  const int *rptr, *rent, *cptr, *cj, *ce, *sptr, *sj, *sv, *qptr, *qk, *qv;
  __device__ Plan(const int* w, const Dims& d) {
    rptr = w + 4;
    rent = rptr + d.rx + 1;
    cptr = rent + d.nnz_r;
    cj = cptr + d.n + 1;
    ce = cj + d.nnz_r;
    sptr = ce + d.nnz_r;
    sj = sptr + d.n + 1;
    sv = sj + d.nnz_s;
    qptr = sv + d.nnz_s;
    qk = qptr + d.rx + 1;
    qv = qk + d.nnz_s;
  }
};

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
// false for nan and +-inf
__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= FLT_MAX; }
__device__ __forceinline__ bool finite(double x) { return fabs(x) <= DBL_MAX; }

// y^r and d/dy y^r of a reactant entry (species * 4 + r, r in 1..3), as the
// plain twin forms them
template <typename T>
__device__ __forceinline__ T term(int ent, const T* ys) {
  const T v = ys[ent >> 2];
  const int x = ent & 3;
  return x == 1 ? v : (x == 2 ? v * v : v * v * v);
}
template <typename T>
__device__ __forceinline__ T dterm(int ent, const T* ys) {
  const T v = ys[ent >> 2];
  const int x = ent & 3;
  return x == 1 ? T(1) : (x == 2 ? T(2) * v : T(3) * v * v);
}

// Columns c0 .. c0 + wc of the member's Sens block into its n x W tile.
template <typename T>
__device__ __forceinline__ void stage_cols(T* ts, const T* sb, int n, int m,
                                           int W, int c0, int lane) {
  const int wc = min(W, m - c0);
  if (wc == m) {
    for (int q = lane; q < n * m; q += 32) ts[q] = sb[q];
  } else {
    for (int q = lane; q < n * wc; q += 32) {
      const int i = q / wc, c = q - i * wc;
      ts[i * W + c] = sb[i * m + c0 + c];
    }
  }
}

template <typename T, int EPI>
__global__ void massaction_kernel(const int* __restrict__ plan, Dims d,
                                  const T* __restrict__ y,
                                  const T* __restrict__ p,
                                  const T* __restrict__ sens,
                                  const T* __restrict__ cmat,
                                  long long c_stride, T* __restrict__ out,
                                  int batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = d.n, rx = d.rx, m = d.m, W = tile_cols(EPI, d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the network: the plan, and S's nonzeros in the dtype, read from the
  // global plan so that one barrier serves both
  int* words = reinterpret_cast<int*>(smem);
  for (int w = threadIdx.x; w < d.words; w += blockDim.x) words[w] = plan[w];
  T* table = reinterpret_cast<T*>(smem + align16(4 * size_t(d.words)));
  {
    const Plan g(plan, d);
    const int* vals = EPI == kJac ? g.qv : g.sv;
    for (int q = threadIdx.x; q < d.nnz_s; q += blockDim.x)
      table[q] = static_cast<T>(vals[q]);
  }

  // this warp's member
  unsigned char* base =
      smem + fixed_bytes<T>(d) + warp * member_bytes<T>(EPI, d);
  T* ys = reinterpret_cast<T*>(base);
  T* mono = ys + n;
  T* mv = mono + rx;
  T* tile = mv + d.nnz_r;
  int* nr = reinterpret_cast<int*>(base + member_values<T>(EPI, d) *
                                              sizeof(T));
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const bool live = b < batch;
  const T* sb = EPI == kJac ? nullptr : sens + b * n * m;
  if (live) {
    for (int i = lane; i < n; i += 32) ys[i] = y[b * n + i];
    if (EPI != kJac) stage_cols(tile, sb, n, m, W, 0, lane);
  }
  __syncthreads();
  if (!live) return;
  const Plan P(words, d);

  // lanes over reactions: the monomial and the entries of M
  bool bad = false;
  for (int j = lane; j < rx; j += 32) {
    const int e0 = P.rptr[j], e1 = P.rptr[j + 1];
    const T pj = p[b * rx + j];
    T mo = T(1);
    for (int e = e0; e < e1; ++e) mo *= term(P.rent[e], ys);
    for (int e = e0; e < e1; ++e) {
      T exc = T(1);
      for (int r = e0; r < e1; ++r)
        if (r != e) exc *= term(P.rent[r], ys);
      const T val = (pj * dterm(P.rent[e], ys)) * exc;
      mv[e] = val;
      bad |= !finite(val);
    }
    // the entries of row j at species that are no reactant of j
    const int nrb = e1 - e0 < n && !(finite(pj) && finite(mo));
    mono[j] = mo;
    nr[j] = nrb;
    bad |= nrb;
  }
  const bool any_bad = __any_sync(kFullMask, bad);
  __syncwarp();

  if (EPI == kJac) {
    int nr_total = 0;
    for (int j = lane; j < rx; j += 32) nr_total += nr[j];
    nr_total = __reduce_add_sync(kFullMask, nr_total);
    T* ob = out + b * n * n;
    for (int c0 = 0; c0 < n; c0 += 32) {
      const int i = c0 + lane;
      if (i >= n) break;
      for (int k = 0; k < n; ++k) tile[k * W + lane] = T(0);
      int nr_here = 0;
      bool col_bad = false;
      for (int q = P.cptr[i]; q < P.cptr[i + 1]; ++q) {
        const int j = P.cj[q];
        const T v = mv[P.ce[q]];
        nr_here += nr[j];
        col_bad |= !finite(v);
        for (int s = P.qptr[j]; s < P.qptr[j + 1]; ++s) {
          T* a = tile + P.qk[s] * W + lane;
          *a = fma_rn(table[s], v, *a);
        }
      }
      // a flagged reaction that does not have i as a reactant
      col_bad |= nr_total > nr_here;
      for (int k = 0; k < n; ++k)
        ob[k * n + i] = col_bad ? quiet_nan<T>() : tile[k * W + lane];
    }
    return;
  }

  T* ts = tile;          // Sens columns, n x W
  T* ti = ts + n * W;    // inner columns, rx x W
  const T* cb = EPI == kSensDir ? cmat + b * c_stride : nullptr;
  T* ob = out + b * n * m;
  for (int c0 = 0; c0 < m; c0 += 32) {
    if (c0 > 0) {
      __syncwarp();
      stage_cols(ts, sb, n, m, W, c0, lane);
    }
    __syncwarp();
    const int c = c0 + lane;
    if (c >= m) continue;
    bool col_bad = any_bad;
    for (int i = 0; i < n; ++i) col_bad |= !finite(ts[i * W + lane]);
    for (int j = 0; j < rx; ++j) {
      T v = T(0);
      for (int e = P.rptr[j]; e < P.rptr[j + 1]; ++e)
        v = fma_rn(mv[e], ts[(P.rent[e] >> 2) * W + lane], v);
      if (EPI == kSens) {
        if (c == j) v += mono[j];
      } else {
        v += mono[j] * cb[j * m + c];
      }
      col_bad |= !finite(v);
      ti[j * W + lane] = v;
    }
    for (int k = 0; k < n; ++k) {
      T acc = T(0);
      for (int q = P.sptr[k]; q < P.sptr[k + 1]; ++q)
        acc = fma_rn(table[q], ti[P.sj[q] * W + lane], acc);
      ob[k * m + c] = col_bad ? quiet_nan<T>() : acc;
    }
  }
}

// The shared memory a block may opt into on the current device.
size_t optin_bytes() {
  static size_t cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return kDefaultSmem;
  if (!cached[dev]) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cached[dev] = v > 0 ? static_cast<size_t>(v) : kDefaultSmem;
  }
  return cached[dev];
}

// Members a block: as many as fit 48 KB, up to 8; a member larger than
// that gets a block of its own, opted into the size it needs; 0 where not
// even one fits the device's opt-in limit.
template <typename T>
int pick_warps(int epi, const Dims& d) {
  const size_t fixed = fixed_bytes<T>(d), member = member_bytes<T>(epi, d);
  if (fixed + member > optin_bytes()) return 0;
  if (fixed + member > kDefaultSmem) return 1;
  const size_t w = (kDefaultSmem - fixed) / member;
  return static_cast<int>(w < kMaxWarps ? w : kMaxWarps);
}

template <typename T, int EPI>
int launch(const int* plan, const Dims& d, const T* y, const T* p,
           const T* sens, const T* cmat, long long c_stride, T* out,
           int batch, cudaStream_t stream) {
  const int warps = pick_warps<T>(EPI, d);
  if (warps == 0) return kTooLarge;
  const size_t smem = fixed_bytes<T>(d) + warps * member_bytes<T>(EPI, d);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        massaction_kernel<T, EPI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int grid = (batch + warps - 1) / warps;
  massaction_kernel<T, EPI><<<grid, 32 * warps, smem, stream>>>(
      plan, d, y, p, sens, cmat, c_stride, out, batch);
  return cudaGetLastError();
}

template <typename T>
int run(int epi, const void* plan, int words, int n, int rx, int nnz_r,
        int nnz_s, const void* y, const void* p, const void* sens,
        const void* cmat, long long c_stride, void* out, int batch, int m,
        void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  const Dims d{n, rx, nnz_r, nnz_s, epi == kJac ? 0 : m, words};
  const int* pl = static_cast<const int*>(plan);
  const T* yt = static_cast<const T*>(y);
  const T* pt = static_cast<const T*>(p);
  const T* st = static_cast<const T*>(sens);
  const T* ct = static_cast<const T*>(cmat);
  T* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kJac:
      return launch<T, kJac>(pl, d, yt, pt, st, ct, 0, ot, batch, s);
    case kSens:
      return launch<T, kSens>(pl, d, yt, pt, st, ct, 0, ot, batch, s);
    case kSensDir:
      return launch<T, kSensDir>(pl, d, yt, pt, st, ct, c_stride, ot, batch,
                                 s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each returns a cudaError_t, or -1 where one member's tiles do not fit a
// block's shared memory on the current device.
extern "C" int tsb_massaction_f32(int epi, const void* plan, int words, int n,
                                  int rx, int nnz_r, int nnz_s,
                                  const void* y, const void* p,
                                  const void* sens, const void* cmat,
                                  long long c_stride, void* out, int batch,
                                  int m, void* stream) {
  return run<float>(epi, plan, words, n, rx, nnz_r, nnz_s, y, p, sens, cmat,
                    c_stride, out, batch, m, stream);
}

extern "C" int tsb_massaction_f64(int epi, const void* plan, int words, int n,
                                  int rx, int nnz_r, int nnz_s,
                                  const void* y, const void* p,
                                  const void* sens, const void* cmat,
                                  long long c_stride, void* out, int batch,
                                  int m, void* stream) {
  return run<double>(epi, plan, words, n, rx, nnz_r, nnz_s, y, p, sens, cmat,
                     c_stride, out, batch, m, stream);
}
