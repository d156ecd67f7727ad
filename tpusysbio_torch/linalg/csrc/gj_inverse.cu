// Batched f32 matrix inverse by Gauss-Jordan with partial pivoting: one
// warp per matrix, the matrix in the warp's registers.
//
// Replaces: tpusysbio/linalg/pallas_lu.py::_gj_batched_kernel (launched by
// _gj_inverse_f32), the TPU kernel behind every Newton factorization of
// I - cJ on the BDF main path and in both phases of the fit.
//
// What bounds it on the H100. At the paths' shapes (B = 256 or 16 matrices,
// n = 22) the kernel reads B*n*n*4 B and writes as much (0.5 MB each way at
// B = 256) and does about n^3 multiply-adds per matrix: by bytes or by
// operations that is well under a microsecond. It cannot come near that
// bound: the time of a kernel of this size is the launch (an empty kernel
// through the same route takes 0.0019 ms, chip_smoke.py's [floor] line) plus
// the latency of n dependent pivot steps (search, scale, eliminate; step
// k+1 cannot start before step k has written column k+1). So the design
// removes latency from a step, not bytes or flops. Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, n = 22, from a queue
// of launches: 0.0107 ms at B = 16 and 64, 0.0114 ms at B = 256, 0.0184 ms
// at B = 1024 (the design before it, a 256-thread block and five block
// barriers per step over [A | I] in shared memory: 0.0274, 0.0275, 0.0295,
// 0.0659 ms in the same process, linalg/compare_designs.py).
//
// Design. A warp owns a matrix for the whole elimination; a block holds
// kWarpsPerBlock warps that never meet, so there is no __syncthreads() and
// no shared memory at all. Lane r holds row r in registers (rows r and r+32
// for 32 < n <= 64). The kernel is a template on the padded width W (a
// multiple of 8) and on the rows per lane R, and every loop over columns is
// fully unrolled, so a row element is a register, never local memory
// (ptxas -v must report 0 bytes of spill for every instantiation). A step
// costs about 2W shuffles, so n = 22 runs at W = 24, and the block-Schur
// blocks of 64 and 33 at W = 64 and 40.
//
// The loop over pivot steps stays rolled (unrolled it took ptxas over a
// minute, and two rows of 64 spilled). To keep register indices constant
// all the same, the row ROTATES by one register per step: step k always
// works on register 0, and writes column c's result into register c - 1 and
// column k's (the finished inverse column) into register W - 1. After the n
// steps register i holds logical column (n + i) mod W, and W - n further
// rotations bring every column back to its own register before the store.
//
// The inverse is formed IN PLACE (n x n, not [A | I]): column k takes the
// inverse's column as soon as A's column k has become a unit vector. Rows
// are never moved between lanes. Each lane keeps the logical position
// `pos` of its row instead; a row exchange swaps two positions. In-place
// elimination inverts the row-permuted matrix, so the result needs its
// columns permuted back: logical column c belongs to the output column
// whose index is the physical row that holds logical row c, and the store
// applies both permutations in its addresses.
//
// One pivot step k, all in registers:
//  - search: each live row with pos >= k offers the bits of |row[0]| + 1
//    (0 for a NaN or a dead row); __reduce_max_sync finds the maximum and
//    __reduce_min_sync the lowest position holding it (the reference's
//    min-index tie-break) together with the lane that holds it. A NaN
//    never wins; if nothing wins, row k stays. Two warp reductions replace
//    a 5-stage shuffle butterfly (10 dependent shuffles) on (|value|, row),
//    and they start at the end of the step before, where they overlap
//    the elimination;
//  - the pivot lane's row is broadcast with one __shfl_sync per column;
//    lane c keeps element c, so the division of the pivot row (a true
//    division, one per element as in the reference) is done once, in
//    parallel across lanes, and a second shuffle per column hands the
//    scaled element to every lane;
//  - a pivot with !(|p| > 1e-30) becomes +-1e-30, so a singular matrix
//    yields a finite wrong answer;
//  - every other row does row[c] = fma(-f, pivrow[c], row[c]) with the
//    contraction written out, so that each output element goes through the
//    same roundings as in gj_inverse_major.cu whatever the compiler
//    chooses: the two kernels agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kWarpsPerBlock = 2;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;

// Every lane receives the row `own` of lane `src`; lane c keeps element c
// in `mine`. Element 0 is the pivot: it is returned, and 1 is kept in its
// place (the pivot's own column becomes the inverse's: 1 / pivot).
template <int W, int Q>
__device__ __forceinline__ float broadcast_row(const float (&own)[W],
                                               int src, int lane,
                                               float (&mine)[Q]) {
  float pivot = 0.f;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    float u = __shfl_sync(kFullMask, own[c], src);
    if (c == 0) {
      pivot = u;
      u = 1.f;
    }
    if (lane == (c & 31)) mine[c >> 5] = u;
  }
  return pivot;
}

// The pivot of step k: the lowest logical row, among the live rows at
// positions >= k, that reaches the maximum of |column k| (register 0). Each
// such row offers the bits of its |value| + 1 (0 for a NaN); the first
// reduction finds the maximum, the second the lowest position holding it,
// with the place of that row (slot, lane) in the low bits so that one
// reduction yields all three: returns pos << 6 | slot << 5 | lane. If
// nothing wins (all NaN), row k stays: the row at position k is returned.
template <int R, int W>
__device__ __forceinline__ unsigned find_pivot(const float (&row)[R][W],
                                               const int (&pos)[R], int k,
                                               int n, int lane) {
  unsigned key[R];
  unsigned my_key = 0u;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const unsigned bits = __float_as_uint(fabsf(row[i][0]));
    key[i] = (pos[i] >= k && pos[i] < n && bits <= kInfBits) ? bits + 1u : 0u;
    my_key = max(my_key, key[i]);
  }
  const unsigned best = __reduce_max_sync(kFullMask, my_key);
  unsigned cand = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool offers = best != 0u ? key[i] == best : pos[i] == k;
    if (offers) {
      cand = min(cand, static_cast<unsigned>(pos[i] << 6 | i << 5 | lane));
    }
  }
  return __reduce_min_sync(kFullMask, cand);
}

// W: padded width (n <= W); R: rows per lane (n <= 32 * R).
template <int W, int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
gj_inverse_f32_kernel(const float* __restrict__ a, float* __restrict__ out,
                      int batch, int n) {
  constexpr int Q = (W + 31) / 32;  // pivot-row elements a lane divides
  const int lane = threadIdx.x & 31;
  const long long m = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  // the whole warp leaves together, and nothing below waits for the block
  if (m >= batch) return;
  const size_t base = static_cast<size_t>(m) * n * n;
  const float* A = a + base;
  float* X = out + base;

  float row[R][W];
  int pos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = lane + 32 * i;
    pos[i] = r;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      row[i][c] = (r < n && c < n) ? A[r * n + c] : 0.f;
    }
  }

  // The search for step k + 1 starts at the end of step k, as soon as
  // the next pivot column is eliminated, so that its two reductions overlap
  // the rest of the elimination instead of heading the next step.
  unsigned won = find_pivot<R>(row, pos, 0, n, lane);
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const int p = static_cast<int>(won >> 6);
    const int slot = static_cast<int>(won >> 5) & 1;
    const int src = static_cast<int>(won & 31u);
    // exchange logical positions k and p
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (pos[i] == p) {
        pos[i] = k;
      } else if (pos[i] == k) {
        pos[i] = p;
      }
    }

    // pivot row to all lanes, scaled by a true division, one element a lane
    float mine[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) mine[j] = 0.f;
    float pivot;
    if (R == 2 && slot == 1) {
      pivot = broadcast_row<W, Q>(row[R - 1], src, lane, mine);
    } else {
      pivot = broadcast_row<W, Q>(row[0], src, lane, mine);
    }
    if (!(fabsf(pivot) > 1e-30f)) pivot = pivot >= 0.f ? 1e-30f : -1e-30f;
#pragma unroll
    for (int j = 0; j < Q; ++j) mine[j] = __fdiv_rn(mine[j], pivot);

    // the pivot row takes the scaled row, every other row eliminates;
    // results move down one register, column k's goes to the last
    bool is_pivot[R];
    float f[R];
    float done[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      is_pivot[i] = pos[i] == k;
      f[i] = row[i][0];
    }
    // all shuffles first, then the arithmetic: with one loop ptxas gives a
    // shuffle the register of the multiply-add that consumes it, and the
    // step then waits for W shuffle latencies one after the other
    float scaled[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      scaled[c] = __shfl_sync(kFullMask, mine[c >> 5], c & 31);
    }
#pragma unroll
    for (int c = 0; c < W; ++c) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float cur = c == 0 ? 0.f : row[i][c];
        const float val =
            is_pivot[i] ? scaled[c] : __fmaf_rn(-f[i], scaled[c], cur);
        if (c == 0) {
          done[i] = val;
        } else {
          row[i][c - 1] = val;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) row[i][W - 1] = done[i];
    won = find_pivot<R>(row, pos, k + 1, n, lane);
  }

  // register j holds logical column (n + j) mod W: W - n more rotations
  // (fewer than 8) bring column c back to register c
#pragma unroll 1
  for (int t = n; t < W; ++t) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float first = row[i][0];
#pragma unroll
      for (int c = 1; c < W; ++c) row[i][c - 1] = row[i][c];
      row[i][W - 1] = first;
    }
  }

  // logical row pos[i] goes to output row pos[i]; logical column c goes to
  // the output column numbered as the physical row that holds logical row c
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c >= n) break;
    const unsigned h0 = __ballot_sync(kFullMask, pos[0] == c);
    int d = __ffs(h0) - 1;
    if (R == 2) {
      const unsigned h1 = __ballot_sync(kFullMask, pos[R - 1] == c);
      if (h0 == 0u) d = 32 + __ffs(h1) - 1;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (pos[i] < n) X[pos[i] * n + d] = row[i][c];
    }
  }
}

template <int W, int R>
int launch(const float* a, float* out, int batch, int n, cudaStream_t s) {
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gj_inverse_f32_kernel<W, R>
      <<<blocks, 32 * kWarpsPerBlock, 0, s>>>(a, out, batch, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, out: (batch, n, n) row-major f32 on the device; 1 <= n <= 64.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tsb_gj_inverse_f32(const float* a, float* out, int batch,
                                  int n, void* stream) {
  if (n < 1 || n > kMaxN || batch < 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n + 7) / 8) {
    case 1: return launch<8, 1>(a, out, batch, n, s);
    case 2: return launch<16, 1>(a, out, batch, n, s);
    case 3: return launch<24, 1>(a, out, batch, n, s);
    case 4: return launch<32, 1>(a, out, batch, n, s);
    case 5: return launch<40, 2>(a, out, batch, n, s);
    case 6: return launch<48, 2>(a, out, batch, n, s);
    case 7: return launch<56, 2>(a, out, batch, n, s);
    default: return launch<64, 2>(a, out, batch, n, s);
  }
}
