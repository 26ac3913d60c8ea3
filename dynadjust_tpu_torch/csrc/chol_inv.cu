// Batched Cholesky factor + triangular inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dynadjust_tpu/ops/pallas_schur.py:93
// (_chol_inv_kernel, called from _chol_inverse_jit): for every block b of
// a (B, n, n) float32 SPD batch it computes L = chol(N_b) and writes
// Linv = L^-1 (lower triangle, exact zeros above) and an int32 status
// per block, set when a pivot is !(pivot > 0) (which catches NaN).  On
// the TPU one grid step held a whole block in VMEM (n <= 896); here the
// blocks reach n = 3,468 (48 MB each), so the work is tiled over device
// memory in T = 128 wide steps:
//
//   factor, step k = 0 .. nt-1, in groups of GROUP = 2 steps
//     diag_factor  tile (k,k) in shared memory: blocked Cholesky in
//                  16-wide panels (factor | TRSM | SYRK), then its
//                  inverse by recursive doubling; writes Linv(k,k) and
//                  flags bad pivots in status[b]
//     panel        A(i,k) <- A(i,k) Linv(k,k)^T        for i > k
//     update       A(i,j) -= sum_k A(i,k) A(j,k)^T     k in the group:
//                  inside the group step by step; beyond it once a
//                  group, at depth 256 (next group's columns, then the
//                  rest on a second stream)
//   inverse, levels s = 1, 2, 4, .. tiles (two launches a level)
//     for L = [[L11, 0], [L21, L22]] with X11 = L11^-1 and X22 = L22^-1
//     known from the level below (the diagonal tiles from diag_factor):
//     inv_t1       T1  = L21 X11      (zero tiles of X11 skipped)
//     inv_x21      X21 = -X22 T1      (zero tiles of X22 skipped)
//
// What bounds it: at the main path's shapes (B = 9, n = 3,468) the work
// is 2/3 n^3 flop per block (2.5e11 in all) against 0.87 GB of input and
// output: 3.7 ms at the H100's 67 TFLOP/s of CUDA-core float32, 0.26 ms
// of HBM time.  What the design does about it:
//   * the tile products (panel, update, inv_t1, inv_x21) run on the
//     tensor cores as 3xTF32: each operand x is split into big =
//     tf32(x) and small = x - big, and the product is small*big +
//     big*small + big*big through mma.sync m16n8k8, summed in float32
//     registers.  The dropped small*small term is below float32
//     rounding; the sums inside the tensor cores cost some accuracy,
//     which grows with the depth of a product and shows in the factor's
//     updates, so those stay at depth <= 256 (the float64 residual of
//     Linv N Linv^T - I stays within 2x that of float32 products).
//     Three TF32 products for each float32 one: 1.5 ms at the 495
//     TFLOP/s TF32 peak;
//   * each product is a 128 x 128 output tile per 8-warp block (two
//     blocks an SM), with its operands double-buffered in 32-deep chunks
//     in shared memory by cp.async (16 bytes a thread), so the next
//     chunk's loads overlap this chunk's products; 128-wide steps,
//     grouped in pairs, read and write the trailing matrix a quarter as
//     often as 64-wide steps;
//   * the factor's serial chain (diag_factor on 9 SMs, panel, the next
//     group's update) runs on a high-priority stream while the rest of
//     each group's update runs beside it on a lower-priority one;
//   * the triangular inverse is a recursion of log2(nt) levels of
//     parallel tile products instead of a serial block-row sweep; its
//     left half and the top level's T1 need only the first columns of L
//     and run on a third stream while the factor finishes;
//   * the diagonal tile, 28 times on the critical path, stays on float32
//     CUDA cores in shared memory with its serial chains in registers
//     (see diag_factor).
//
// The caller pads n to a multiple of T with an identity diagonal (as
// pallas_schur.py:157-160 does; only the lower triangle of A is read),
// passes A as scratch (it is overwritten: L in the lower tiles, the
// inverse's intermediate products in the upper ones), zeroes status, and
// gives the stream whose work the call follows and which follows the
// call; every element of Linv is written.  The entry point returns the
// first CUDA error of any launch (0 when all launched).

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int T = 128;            // step tile edge
constexpr int NTH = 256;          // threads per block: 8 warps
constexpr int KC = 32;            // depth of one staged chunk
constexpr int NST = 2;            // stages of the cp.async ring
constexpr int LDK = KC + 4;       // row stride of a [row][k] chunk
constexpr int LDN = T + 8;        // row stride of a [k][col] chunk
constexpr int CHUNK = T * LDK;    // floats of one staged operand chunk
static_assert(KC * LDN <= CHUNK, "a [k][col] chunk fits a chunk slot");
constexpr int PROD_SMEM = NST * 2 * CHUNK * 4;   // 73,728 bytes
constexpr int PB = 16;            // panel width inside diag_factor
constexpr int GROUP = 2;          // factor steps between bulk updates
constexpr int LDD = T + 1;        // diag_factor's shared row stride
constexpr int DIAG_SMEM = 2 * T * LDD * 4;       // 132,096 bytes
static_assert(T / PB == NTH / 32, "one warp per 16 x 16 diagonal block");

// ---------------------------------------------------------------------
// 3xTF32 tile products on the tensor cores

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small: big = x rounded to TF32, small = the rest, exact in
// float32; the tensor cores read small's leading 10 mantissa bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  small = __float_as_uint(x - __uint_as_float(big));
}

// four 8 x 4 float32 matrices from shared memory, one register each:
// lane l gets element (l / 4, l % 4) of matrix j in r[j]; lanes 8j .. 8j+7
// give the row addresses of matrix j (16-byte aligned)
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows 0..T-1, columns k0..k0+KC-1 of a tile -> s[row][k]
__device__ __forceinline__ void load_rows(float* s, const float* g, int n,
                                          int k0) {
#pragma unroll
  for (int i = 0; i < T * KC / 4 / NTH; ++i) {
    const int v = threadIdx.x + i * NTH;
    const int r = v / (KC / 4), c = (v % (KC / 4)) * 4;
    cp_async16(s + r * LDK + c, g + (size_t)r * n + k0 + c);
  }
}

// rows k0..k0+KC-1, columns 0..T-1 of a tile -> s[k][col]
__device__ __forceinline__ void load_krows(float* s, const float* g, int n,
                                           int k0) {
#pragma unroll
  for (int i = 0; i < T * KC / 4 / NTH; ++i) {
    const int v = threadIdx.x + i * NTH;
    const int r = v / (T / 4), c = (v % (T / 4)) * 4;
    cp_async16(s + r * LDN + c, g + (size_t)(k0 + r) * n + c);
  }
}

// acc += sum_p P_p Q_p over np tile pairs (P_p = pairs.a(p), Q_p =
// pairs.b(p), both T x T at row stride n); Q_p^T instead of Q_p unless
// NN.  Warp w owns rows 64 (w / 4) .. +64 and columns 32 (w % 4) .. +32
// of the 128 x 128 output: acc[i][j] is its m16n8 tile (i, j).
template <bool NN, class Pairs>
__device__ __forceinline__ void tile_product(float (&acc)[4][4][4],
                                             float* smem, const Pairs& pairs,
                                             int np, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int nchunk = np * (T / KC);
  auto fetch = [&](int c) {
    if (c < nchunk) {
      float* st = smem + (c % NST) * 2 * CHUNK;
      const int p = c / (T / KC), k0 = (c % (T / KC)) * KC;
      load_rows(st, pairs.a(p), n, k0);
      if constexpr (NN)
        load_krows(st + CHUNK, pairs.b(p), n, k0);
      else
        load_rows(st + CHUNK, pairs.b(p), n, k0);
    }
    cp_async_commit();
  };
  for (int c = 0; c < NST - 1; ++c) fetch(c);
  for (int c = 0; c < nchunk; ++c) {
    cp_async_wait<NST - 2>();   // chunk c has landed for this thread ...
    __syncthreads();            // ... and for all; chunk c-1 is consumed
    fetch(c + NST - 1);         // into the slot chunk c-1 used
    const float* As = smem + (c % NST) * 2 * CHUNK;
    const float* Bs = As + CHUNK;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float b0, b1;
        if constexpr (NN) {
          b0 = Bs[(kk + t) * LDN + wn + j * 8 + g];
          b1 = Bs[(kk + t + 4) * LDN + wn + j * 8 + g];
        } else {
          // matrices (tile j, k 0..3), (j, k 4..7), (j+1, ..), (j+1, ..)
          if (j % 2) continue;
          uint32_t r[4];
          ldmatrix_x4(r, Bs + (wn + (j + lane / 16) * 8 + lane % 8) * LDK +
                             kk + (lane / 8) % 2 * 4);
          split_tf32(__uint_as_float(r[2]), bb[j + 1][0], bs[j + 1][0]);
          split_tf32(__uint_as_float(r[3]), bb[j + 1][1], bs[j + 1][1]);
          b0 = __uint_as_float(r[0]);
          b1 = __uint_as_float(r[1]);
        }
        split_tf32(b0, bb[j][0], bs[j][0]);
        split_tf32(b1, bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // matrices (rows 0..7, k 0..3), (8..15, 0..3), (0..7, 4..7), (8..15,
        // 4..7) of the m16 tile: the a0..a3 fragment of mma m16n8k8
        uint32_t r[4], ab[4], as[4];
        ldmatrix_x4(r, As + (wm + i * 16 + (lane / 8) % 2 * 8 + lane % 8) *
                                LDK + kk + lane / 16 * 4);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_tf32(__uint_as_float(r[q]), ab[q], as[q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], as, bb[j]);
          mma_tf32(acc[i][j], ab, bs[j]);
          mma_tf32(acc[i][j], ab, bb[j]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// C = alpha acc, or C -= acc when SUB (C a T x T tile at row stride n)
template <bool SUB>
__device__ __forceinline__ void store_tile(float* C, int n,
                                           const float (&acc)[4][4][4],
                                           float alpha) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm + i * 16 + g, c = wn + j * 8 + 2 * t;
      float2* p0 = reinterpret_cast<float2*>(C + (size_t)r * n + c);
      float2* p1 = reinterpret_cast<float2*>(C + (size_t)(r + 8) * n + c);
      if constexpr (SUB) {
        float2 v0 = *p0, v1 = *p1;
        v0.x -= acc[i][j][0];
        v0.y -= acc[i][j][1];
        v1.x -= acc[i][j][2];
        v1.y -= acc[i][j][3];
        *p0 = v0;
        *p1 = v1;
      } else {
        *p0 = make_float2(alpha * acc[i][j][0], alpha * acc[i][j][1]);
        *p1 = make_float2(alpha * acc[i][j][2], alpha * acc[i][j][3]);
      }
    }
}

__device__ __forceinline__ float* tile(float* M, int n, int r, int c) {
  return M + (size_t)r * T * n + (size_t)c * T;
}

struct OnePair {
  const float* P;
  const float* Q;
  __device__ const float* a(int) const { return P; }
  __device__ const float* b(int) const { return Q; }
};

// A(i,k) <- A(i,k) Linv(k,k)^T for row tiles i = k+1+blockIdx.x; also
// zeroes Linv's upper tile (k, i), so that every upper tile is written
__global__ void __launch_bounds__(NTH, 2)
panel(float* A, float* Linv, int n, int k) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t bo = (size_t)blockIdx.y * n * n;
  const int i = k + 1 + blockIdx.x;
  float* P = tile(A + bo, n, i, k);
  float* Z = tile(Linv + bo, n, k, i);
  for (int e = threadIdx.x; e < T * T / 4; e += NTH)
    reinterpret_cast<float4*>(Z + (size_t)(e / (T / 4)) * n)[e % (T / 4)] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[4][4][4] = {};
  tile_product<false>(acc, smem, OnePair{P, tile(Linv + bo, n, k, k)}, 1,
                      n);
  store_tile<false>(P, n, acc, 1.f);
}

// The factor's steps go in groups of GROUP.  Inside a group only the
// group's own columns are updated step by step; the matrix beyond it
// takes the whole group's update at once, at depth 128 GROUP, which
// divides its read-modify-write passes by GROUP and keeps the products
// deep enough to overlap their loads.  That update is split in two: the
// next group's columns (near), which the next group's steps wait for,
// and the rest (far), which runs on a second stream of lower priority
// while the next group's serial chain (diag_factor, panel, near) runs.

struct GroupPairs {
  const float* A;
  int n, i, j, g0;
  __device__ const float* a(int p) const {
    return A + (size_t)i * T * n + (size_t)(g0 + p) * T;
  }
  __device__ const float* b(int p) const {
    return A + (size_t)j * T * n + (size_t)(g0 + p) * T;
  }
};

// A(i,j) -= sum_{k=g0}^{g1-1} A(i,k) A(j,k)^T over the lower tiles of
// the columns j0 <= j < j0 + (as many as the grid holds), rows j <= i <
// nt; blockIdx.x enumerates them column by column
__global__ void __launch_bounds__(NTH, 2)
update(float* A, int n, int nt, int g0, int g1, int j0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t bo = (size_t)blockIdx.y * n * n;
  int j = j0, p = blockIdx.x;
  while (p >= nt - j) p -= nt - j++;
  const int i = j + p;
  float acc[4][4][4] = {};
  tile_product<false>(acc, smem, GroupPairs{A + bo, n, i, j, g0}, g1 - g0,
                      n);
  store_tile<true>(tile(A + bo, n, i, j), n, acc, 0.f);
}

// One level s of the inverse over the tiles [base, end): pair q covers
// tiles [a0, a0 + 2s), a0 = base + 2 s q, with X11 = Linv[a0 .. a0+s) and
// X22 = Linv[a0+s .. a0+2s) already inverted.  T1(r, c) = L21 X11 lives
// in the (unused) upper tile (a0 + c, a0 + s + r) of A.
struct T1Pairs {
  const float* A;
  const float* X;
  int n, a0, s, r, c;
  // sum over j = c .. s-1 of L(a0+s+r, a0+j) X(a0+j, a0+c)
  __device__ const float* a(int p) const {
    return A + (size_t)(a0 + s + r) * T * n + (size_t)(a0 + c + p) * T;
  }
  __device__ const float* b(int p) const {
    return X + (size_t)(a0 + c + p) * T * n + (size_t)(a0 + c) * T;
  }
};

struct X21Pairs {
  const float* A;
  const float* X;
  int n, a0, s, r, c;
  // sum over j = 0 .. r of X(a0+s+r, a0+s+j) T1(j, c)
  __device__ const float* a(int p) const {
    return X + (size_t)(a0 + s + r) * T * n + (size_t)(a0 + s + p) * T;
  }
  __device__ const float* b(int p) const {
    return A + (size_t)(a0 + c) * T * n + (size_t)(a0 + s + p) * T;
  }
};

// blockIdx.x -> (c, q, r), the deepest sums (small c) first
__global__ void __launch_bounds__(NTH, 2)
inv_t1(float* A, float* Linv, int n, int base, int end, int s, int np) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int x = blockIdx.x;
  const int c = x / (np * s);
  x %= np * s;
  const int q = x / s, r = x % s, a0 = base + 2 * s * q;
  if (a0 + s + r >= end) return;
  const size_t bo = (size_t)blockIdx.y * n * n;
  float acc[4][4][4] = {};
  tile_product<true>(acc, smem, T1Pairs{A + bo, Linv + bo, n, a0, s, r, c},
                     s - c, n);
  store_tile<false>(tile(A + bo, n, a0 + c, a0 + s + r), n, acc, 1.f);
}

// blockIdx.x -> (r, q, c), the deepest sums (large r) first
__global__ void __launch_bounds__(NTH, 2)
inv_x21(float* A, float* Linv, int n, int base, int end, int s, int np) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int x = blockIdx.x;
  const int r = s - 1 - x / (np * s);
  x %= np * s;
  const int q = x / s, c = x % s, a0 = base + 2 * s * q;
  if (a0 + s + r >= end) return;
  const size_t bo = (size_t)blockIdx.y * n * n;
  float acc[4][4][4] = {};
  tile_product<true>(acc, smem, X21Pairs{A + bo, Linv + bo, n, a0, s, r, c},
                     r + 1, n);
  store_tile<false>(tile(Linv + bo, n, a0 + s + r, a0 + c), n, acc, -1.f);
}

// ---------------------------------------------------------------------
// the diagonal tile: float32 CUDA cores, shared memory
//
// Blocked right-looking Cholesky of the 128 x 128 tile in 16-wide
// panels: warp 0 factors the panel's 16 x 16 diagonal block in registers
// (shuffles carry the pivot column), one thread a row solves the rows
// below it (TRSM, in registers), and all threads update the trailing
// triangle (SYRK, 4 x 4 outputs a thread).  Then X = L^-1: each warp
// inverts one 16 x 16 diagonal block (one column a lane, in registers),
// and three doubling levels X21 = -X22 (L21 X11) join them, every thread
// on one micro-tile of each product.  The serial chains are the 128
// pivots and the 16-long substitutions; everything else is parallel.

constexpr unsigned FULL = 0xffffffffu;

// L of the 16 x 16 block at (o, o) of D and the reciprocals of its
// diagonal (rdiag[o .. o+15]), by one warp; lanes i and i + 16 both hold
// row i in registers and only lanes < 16 write
__device__ __forceinline__ void factor_leaf(float* D, float* rdiag, int o,
                                            int* bad) {
  const int lane = threadIdx.x & 31, i = lane & (PB - 1);
  float a[PB];
#pragma unroll
  for (int l = 0; l < PB; ++l)
    a[l] = (l <= i) ? D[(o + i) * LDD + o + l] : 0.f;
#pragma unroll
  for (int j = 0; j < PB; ++j) {
    const float piv = __shfl_sync(FULL, a[j], j);
    if (!(piv > 0.f) && lane == 0) *bad = 1;   // also catches NaN
    const float d = sqrtf(piv), rd = __frcp_rn(d);
    if (i == j) a[j] = d;
    if (i > j) a[j] *= rd;
#pragma unroll
    for (int l = j + 1; l < PB; ++l) {
      const float lj = __shfl_sync(FULL, a[j], l);
      if (l <= i) a[l] = fmaf(-a[j], lj, a[l]);
    }
  }
  if (lane < PB) {
#pragma unroll
    for (int l = 0; l < PB; ++l) D[(o + i) * LDD + o + l] = a[l];
    rdiag[o + i] = __frcp_rn(a[i]);
  }
}

// one doubling level: for each pair of S-blocks at a0 = 2 S q,
// T1 = L21 X11 (into D's unused upper triangle at (a0 + r, a0 + S + c)),
// then X21 = -X22 T1; each thread one RR x RC micro-tile of each product
template <int S>
__device__ __forceinline__ void doubling_level(float* D, float* X) {
  constexpr int RR = S >= 64 ? 4 : 2, RC = S / 4 / RR;
  constexpr int per = (S / RR) * (S / RC);
  static_assert((T / (2 * S)) * per == NTH, "one micro-tile a thread");
  const int q = threadIdx.x, a0 = 2 * S * (q / per);
  const int r0 = RR * ((q % per) / (S / RC)), c0 = RC * ((q % per) % (S / RC));
  float acc[RR][RC] = {};
  for (int j = c0; j < S; ++j) {           // X11[j][c] = 0 for j < c
    float l[RR], x[RC];
#pragma unroll
    for (int u = 0; u < RR; ++u) l[u] = D[(a0 + S + r0 + u) * LDD + a0 + j];
#pragma unroll
    for (int v = 0; v < RC; ++v) x[v] = X[(a0 + j) * LDD + a0 + c0 + v];
#pragma unroll
    for (int u = 0; u < RR; ++u)
#pragma unroll
      for (int v = 0; v < RC; ++v) acc[u][v] = fmaf(l[u], x[v], acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < RR; ++u)
#pragma unroll
    for (int v = 0; v < RC; ++v) {
      D[(a0 + r0 + u) * LDD + a0 + S + c0 + v] = acc[u][v];
      acc[u][v] = 0.f;
    }
  __syncthreads();
  for (int j = 0; j < r0 + RR; ++j) {      // X22[r][j] = 0 for j > r
    float x[RR], t[RC];
#pragma unroll
    for (int u = 0; u < RR; ++u) x[u] = X[(a0 + S + r0 + u) * LDD + a0 + S + j];
#pragma unroll
    for (int v = 0; v < RC; ++v) t[v] = D[(a0 + j) * LDD + a0 + S + c0 + v];
#pragma unroll
    for (int u = 0; u < RR; ++u)
#pragma unroll
      for (int v = 0; v < RC; ++v) acc[u][v] = fmaf(x[u], t[v], acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < RR; ++u)
#pragma unroll
    for (int v = 0; v < RC; ++v)
      X[(a0 + S + r0 + u) * LDD + a0 + c0 + v] = -acc[u][v];
  __syncthreads();
}

// tile (k,k): L_kk = chol(A(k,k)) in shared memory, Linv(k,k) = L_kk^-1
__global__ void __launch_bounds__(NTH)
diag_factor(const float* A, float* Linv, int* status, int n, int k) {
  extern __shared__ float4 smem4[];
  float* D = reinterpret_cast<float*>(smem4);   // the tile, then L
  float* X = D + T * LDD;                       // L^-1
  __shared__ float rdiag[T];
  __shared__ int bad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bo = (size_t)blockIdx.y * n * n;
  const float* Ag = A + bo + (size_t)k * T * n + (size_t)k * T;
  float* Xg = Linv + bo + (size_t)k * T * n + (size_t)k * T;
  for (int e = tid; e < T * T / 4; e += NTH) {
    const int r = e / (T / 4), c = (e % (T / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(Ag + (size_t)r * n + c);
    float* d = D + r * LDD + c;
    float* x = X + r * LDD + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
    x[0] = x[1] = x[2] = x[3] = 0.f;
  }
  if (tid == 0) bad = 0;
  __syncthreads();

  // only the lower triangle of D is read
  for (int o = 0; o < T; o += PB) {
    if (warp == 0) factor_leaf(D, rdiag, o, &bad);
    __syncthreads();
    const int m0 = o + PB;
    if (m0 == T) break;
    // TRSM: rows below the panel solve y L_oo^T = d
    for (int r = m0 + tid; r < T; r += NTH) {
      float y[PB];
#pragma unroll
      for (int c = 0; c < PB; ++c) y[c] = D[r * LDD + o + c];
#pragma unroll
      for (int c = 0; c < PB; ++c) {
        float acc = y[c];
#pragma unroll
        for (int m = 0; m < c; ++m)
          acc = fmaf(-y[m], D[(o + c) * LDD + o + m], acc);
        y[c] = acc * rdiag[o + c];
      }
#pragma unroll
      for (int c = 0; c < PB; ++c) D[r * LDD + o + c] = y[c];
    }
    __syncthreads();
    // SYRK: the lower trailing triangle, 4 x 4 outputs a thread
    const int mb = (T - m0) / 4, nblk = mb * (mb + 1) / 2;
    for (int p = tid; p < nblk; p += NTH) {
      int bi = (int)((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
      while (bi * (bi + 1) / 2 > p) --bi;
      while ((bi + 1) * (bi + 2) / 2 <= p) ++bi;
      const int i0 = m0 + 4 * bi, l0 = m0 + 4 * (p - bi * (bi + 1) / 2);
      float acc[4][4] = {};
#pragma unroll 4
      for (int m = o; m < o + PB; ++m) {
        float a[4], b[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          a[x] = D[(i0 + x) * LDD + m];
          b[x] = D[(l0 + x) * LDD + m];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) D[(i0 + x) * LDD + l0 + y] -= acc[x][y];
    }
    __syncthreads();
  }

  // inverses of the 16 x 16 diagonal blocks: warp w block w, lane c
  // column c, x[i] = (delta_ic - sum_{m<i} L[i][m] x[m]) / L[i][i]
  {
    const int o = warp * PB, c = lane;
    float x[PB];
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      float acc = (i == c) ? 1.f : 0.f;
#pragma unroll
      for (int m = 0; m < i; ++m)
        acc = fmaf(-D[(o + i) * LDD + o + m], x[m], acc);
      x[i] = acc * rdiag[o + i];
    }
    if (c < PB) {
#pragma unroll
      for (int i = 0; i < PB; ++i) X[(o + i) * LDD + o + c] = x[i];
    }
  }
  __syncthreads();
  doubling_level<16>(D, X);
  doubling_level<32>(D, X);
  doubling_level<64>(D, X);

  for (int e = tid; e < T * T / 4; e += NTH) {
    const int r = e / (T / 4), c = (e % (T / 4)) * 4;
    const float* x = X + r * LDD + c;
    *reinterpret_cast<float4*>(Xg + (size_t)r * n + c) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
  if (tid == 0 && bad) status[blockIdx.y] = 1;
}

// Per device, created once: dynamic shared memory above 48 KB for the
// kernels, and three streams with their events: the factor's serial
// chain and the end of the inverse (highest priority), the far updates
// (next), and the inverse's left part (lowest).
struct DeviceState {
  bool ready;
  cudaStream_t hi, lo, side;
  cudaEvent_t in, chain, far, lo_done, left, side_done, done;
};

cudaError_t device_state(DeviceState** out) {
  static DeviceState states[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  DeviceState& d = states[dev];
  *out = &d;
  if (d.ready) return cudaSuccess;
  const struct {
    const void* fn;
    int bytes;
  } want[] = {{(const void*)diag_factor, DIAG_SMEM},
              {(const void*)panel, PROD_SMEM},
              {(const void*)update, PROD_SMEM},
              {(const void*)inv_t1, PROD_SMEM},
              {(const void*)inv_x21, PROD_SMEM}};
  for (const auto& w : want) {
    err = cudaFuncSetAttribute(
        w.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, w.bytes);
    if (err != cudaSuccess) return err;
  }
  int least = 0, greatest = 0;
  if ((err = cudaDeviceGetStreamPriorityRange(&least, &greatest)) ||
      (err = cudaStreamCreateWithPriority(&d.hi, cudaStreamNonBlocking,
                                          greatest)) ||
      (err = cudaStreamCreateWithPriority(
           &d.lo, cudaStreamNonBlocking,
           greatest + 1 < least ? greatest + 1 : least)) ||
      (err = cudaStreamCreateWithPriority(&d.side, cudaStreamNonBlocking,
                                          least)))
    return err;
  for (cudaEvent_t* e : {&d.in, &d.chain, &d.far, &d.lo_done, &d.left,
                         &d.side_done, &d.done})
    if ((err = cudaEventCreateWithFlags(e, cudaEventDisableTiming)))
      return err;
  d.ready = true;
  return cudaSuccess;
}

// tiles in the columns [j0, j1) of the lower triangle, rows j .. nt-1
int column_tiles(int nt, int j0, int j1) {
  return (j1 - j0) * (2 * nt - j0 - j1 + 1) / 2;
}

// the levels s0 <= s < s1 (powers of two) of the inverse over the tiles
// [base, end) on stream st: their T1 launches, their X21 launches or both
cudaError_t inverse_levels(float* A, float* Linv, int B, int n, int base,
                           int end, int s0, int s1, bool t1, bool x21,
                           cudaStream_t st) {
  for (int s = s0; s < s1 && s < end - base; s *= 2) {
    const int np = (end - base - s + 2 * s - 1) / (2 * s);
    const dim3 grid(np * s * s, B);
    if (t1) {
      inv_t1<<<grid, NTH, PROD_SMEM, st>>>(A, Linv, n, base, end, s, np);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    if (x21) {
      inv_x21<<<grid, NTH, PROD_SMEM, st>>>(A, Linv, n, base, end, s, np);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int dta_chol_inv_tile() { return T; }

#define CHECK(call)                                \
  do {                                             \
    const cudaError_t e_ = (call);                 \
    if (e_ != cudaSuccess) return (int)e_;         \
  } while (0)
#define LAUNCHED() CHECK(cudaGetLastError())

// A: (B, n, n) SPD batch (lower triangle), used as scratch; Linv:
// (B, n, n) output; status: (B,) zeroed int32 flags.  The work follows
// what `stream` holds, and what `stream` is given next follows the work.
extern "C" int dta_chol_inv(void* A_, void* Linv_, void* status_, int B,
                            int n, void* stream_) {
  float* A = static_cast<float*>(A_);
  float* Linv = static_cast<float*>(Linv_);
  int* status = static_cast<int*>(status_);
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  if (B <= 0 || n <= 0 || n % T) return (int)cudaErrorInvalidValue;
  DeviceState* d = nullptr;
  CHECK(device_state(&d));
  const int nt = n / T;
  // the inverse's top level splits the tiles at top, the largest power of
  // two below nt: everything it needs of the left part [0, top) (that
  // part's own levels and the top level's T1 = L21 X11) runs on the side
  // stream as soon as the factor has passed column top - 1
  int top = 1;
  while (2 * top < nt) top *= 2;
  cudaStream_t hi = d->hi, lo = d->lo;
  CHECK(cudaEventRecord(d->in, st));
  CHECK(cudaStreamWaitEvent(hi, d->in, 0));
  CHECK(cudaStreamWaitEvent(lo, d->in, 0));
  for (int g0 = 0; g0 < nt; g0 += GROUP) {
    const int g1 = g0 + GROUP < nt ? g0 + GROUP : nt;
    const int g2 = g1 + GROUP < nt ? g1 + GROUP : nt;
    for (int k = g0; k < g1; ++k) {
      diag_factor<<<dim3(1, B), NTH, DIAG_SMEM, hi>>>(A, Linv, status, n, k);
      LAUNCHED();
      if (k + 1 == nt) break;
      panel<<<dim3(nt - k - 1, B), NTH, PROD_SMEM, hi>>>(A, Linv, n, k);
      LAUNCHED();
      if (k + 1 == top) {
        CHECK(cudaEventRecord(d->left, hi));
        CHECK(cudaStreamWaitEvent(d->side, d->left, 0));
        CHECK(inverse_levels(A, Linv, B, n, 0, top, 1, top, true, true,
                             d->side));
        CHECK(inverse_levels(A, Linv, B, n, 0, nt, top, 2 * top, true,
                             false, d->side));
        CHECK(cudaEventRecord(d->side_done, d->side));
      }
      if (k + 1 == g1) break;
      update<<<dim3(column_tiles(nt, k + 1, g1), B), NTH, PROD_SMEM, hi>>>(
          A, n, nt, k, k + 1, k + 1);
      LAUNCHED();
    }
    if (g1 == nt) break;
    // near: after the previous group's far update, which shares its tiles
    CHECK(cudaEventRecord(d->chain, hi));
    CHECK(cudaStreamWaitEvent(hi, d->far, 0));
    update<<<dim3(column_tiles(nt, g1, g2), B), NTH, PROD_SMEM, hi>>>(
        A, n, nt, g0, g1, g1);
    LAUNCHED();
    if (g2 == nt) continue;
    CHECK(cudaStreamWaitEvent(lo, d->chain, 0));
    update<<<dim3(column_tiles(nt, g2, nt), B), NTH, PROD_SMEM, lo>>>(
        A, n, nt, g0, g1, g2);
    LAUNCHED();
    CHECK(cudaEventRecord(d->far, lo));
  }
  CHECK(cudaEventRecord(d->lo_done, lo));
  CHECK(cudaStreamWaitEvent(hi, d->lo_done, 0));
  if (nt > 1) {
    // the right part's own levels, then the top level's X21 = -X22 T1
    CHECK(inverse_levels(A, Linv, B, n, top, nt, 1, top, true, true, hi));
    CHECK(cudaStreamWaitEvent(hi, d->side_done, 0));
    CHECK(inverse_levels(A, Linv, B, n, 0, nt, top, 2 * top, false, true,
                         hi));
  }
  CHECK(cudaEventRecord(d->done, hi));
  CHECK(cudaStreamWaitEvent(st, d->done, 0));
  return 0;
}
