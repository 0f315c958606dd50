// Per-stage dense algebra shared by the condense and Riccati kernels.
//
// Every routine is a __host__ __device__ template over the scalar type and
// the (static) matrix dims, the role static unrolling plays in the Pallas
// kernels of robotoc_tpu (ops/pallas_condense.py:62-135). A routine is
// cooperative: thread `tid` of `nt` handles output entries tid, tid + nt,
// ... of a row-major matrix, so one thread block works on one stage's
// matrices in shared memory. On the host the same code runs with tid = 0,
// nt = 1 (csrc/host_shim.cpp), which is how the CPU tests exercise the
// kernels' arithmetic without a card.
//
// Routines other than gauss_jordan do not synchronise: the caller puts a
// block barrier between a routine and any later reader of its output.
#pragma once

#if defined(__CUDACC__)
#define RTT_HD __host__ __device__ inline
#else
#define RTT_HD inline
#endif

namespace rtt {

RTT_HD void block_sync() {
#if defined(__CUDA_ARCH__)
  __syncthreads();
#endif
}

// Barrier of one warp: the team of the warp-per-stage kernels (Kc, K6).
RTT_HD void warp_sync() {
#if defined(__CUDA_ARCH__)
  __syncwarp();
#endif
}

// C[i,j] = D[i,j] + alpha * sum_k op(A)[i,k] op(B)[k,j]
// op(A) is M x K (A stored K x M when TA), op(B) is K x N (B stored N x K
// when TB). D may be nullptr (no addend) or alias C (in-place update: each
// entry is read and written by the same thread).
template <typename T, int M, int N, int K, bool TA, bool TB>
RTT_HD void gemm(T* C, int ldc, const T* A, int lda, const T* B, int ldb,
                 const T* D, int ldd, T alpha, int tid, int nt) {
  for (int e = tid; e < M * N; e += nt) {
    const int i = e / N, j = e % N;
    T acc = T(0);
    for (int k = 0; k < K; ++k) {
      const T a = TA ? A[k * lda + i] : A[i * lda + k];
      const T b = TB ? B[j * ldb + k] : B[k * ldb + j];
      acc += a * b;
    }
    const T prod = alpha * acc;
    C[i * ldc + j] = D ? D[i * ldd + j] + prod : prod;
  }
}

// y[i] = d[i] + alpha * sum_k op(A)[i,k] x[k]; op(A) is M x K (A stored
// K x M when TA). d may be nullptr or alias y.
template <typename T, int M, int K, bool TA>
RTT_HD void gemv(T* y, const T* A, int lda, const T* x, const T* d, T alpha,
                 int tid, int nt) {
  for (int i = tid; i < M; i += nt) {
    T acc = T(0);
    for (int k = 0; k < K; ++k)
      acc += (TA ? A[k * lda + i] : A[i * lda + k]) * x[k];
    const T prod = alpha * acc;
    y[i] = d ? d[i] + prod : prod;
  }
}

// In-place inverse of the N x N matrix A by Gauss-Jordan elimination
// WITHOUT pivoting (robotoc_tpu ops/pallas_condense.py:119-135): valid for
// SPD matrices and the symmetric quasi-definite contact KKT block. Per
// pivot k: rank-1 sweep of the entries outside row/column k, then
// row k <- row * (1/p), column k <- -column * (1/p), pivot <- 1/p.
// Synchronises internally and on return.
template <typename T, int N>
RTT_HD void gauss_jordan(T* A, int lda, int tid, int nt) {
  for (int k = 0; k < N; ++k) {
    const T rinv = T(1) / A[k * lda + k];
    for (int e = tid; e < N * N; e += nt) {
      const int i = e / N, j = e % N;
      if (i != k && j != k)
        A[i * lda + j] -= A[i * lda + k] * (A[k * lda + j] * rinv);
    }
    block_sync();
    for (int e = tid; e < 2 * N; e += nt) {
      if (e < N) {
        A[k * lda + e] = (e == k) ? rinv : A[k * lda + e] * rinv;
      } else if (e - N != k) {
        A[(e - N) * lda + k] = -A[(e - N) * lda + k] * rinv;
      }
    }
    block_sync();
  }
}

// The same inverse (N <= 32) by the 32 lanes of one warp, lane i holding
// row i in registers and reading the pivot row by shuffles: no shared
// memory traffic and no barrier inside; the warp synchronises on return.
// All 32 lanes call it (lane, nl: the lane and 32); on the host it is
// gauss_jordan with one thread.
template <typename T, int N>
RTT_HD void gauss_jordan_warp(T* A, int lda, int lane, int nl) {
#if defined(__CUDA_ARCH__)
  static_assert(N <= 32, "a row per lane");
  (void)nl;
  T row[N];
#pragma unroll
  for (int j = 0; j < N; ++j) row[j] = lane < N ? A[lane * lda + j] : T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T piv[N];
#pragma unroll
    for (int j = 0; j < N; ++j) piv[j] = __shfl_sync(0xffffffffu, row[j], k);
    const T rinv = T(1) / piv[k];
    if (lane == k) {
#pragma unroll
      for (int j = 0; j < N; ++j) row[j] = j == k ? rinv : row[j] * rinv;
    } else {
      const T aik = row[k];
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j != k) row[j] -= aik * (piv[j] * rinv);
      row[k] = -aik * rinv;
    }
  }
  if (lane < N) {
#pragma unroll
    for (int j = 0; j < N; ++j) A[lane * lda + j] = row[j];
  }
  __syncwarp();
#else
  gauss_jordan<T, N>(A, lda, lane, nl);
#endif
}

// The same product with each thread computing TM x TN tiles of C in
// registers (thread tid of nt takes tiles tid, tid + nt, ...): TM + TN
// loads per TM TN multiply-adds. D may alias C.
template <typename T, int M, int N, int K, int TM, int TN, bool TA, bool TB>
RTT_HD void gemm_tiled(T* C, int ldc, const T* A, int lda, const T* B,
                       int ldb, const T* D, int ldd, T alpha, int tid,
                       int nt) {
  static_assert(M % TM == 0 && N % TN == 0, "tile");
  constexpr int NTJ = N / TN, TILES = (M / TM) * NTJ;
  for (int t = tid; t < TILES; t += nt) {
    const int i0 = (t / NTJ) * TM, j0 = (t % NTJ) * TN;
    T acc[TM][TN];
    for (int i = 0; i < TM; ++i)
      for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
    for (int k = 0; k < K; ++k) {
      T a[TM], b[TN];
      for (int i = 0; i < TM; ++i)
        a[i] = TA ? A[k * lda + i0 + i] : A[(i0 + i) * lda + k];
      for (int j = 0; j < TN; ++j)
        b[j] = TB ? B[(j0 + j) * ldb + k] : B[k * ldb + j0 + j];
      for (int i = 0; i < TM; ++i)
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    for (int i = 0; i < TM; ++i)
      for (int j = 0; j < TN; ++j) {
        const T prod = alpha * acc[i][j];
        T* c = C + (i0 + i) * ldc + j0 + j;
        *c = D ? D[(i0 + i) * ldd + j0 + j] + prod : prod;
      }
  }
}

// Copy of a ROWS x COLS row-major matrix (leading dims LDS, LDD) from
// device memory into shared memory without waiting: cp.async, 16 bytes a
// copy where both sides and the rows allow it, else one element a copy.
// The host copies at once. Pair with async_wait_all() and a barrier.
template <typename T, int ROWS, int COLS, int LDD, int LDS>
RTT_HD void async_rows(T* dst, const T* src, int tid, int nt) {
#if defined(__CUDA_ARCH__)
  constexpr int V = 16 / sizeof(T);   // elements a 16-byte copy moves
  constexpr bool rows_ok = COLS % V == 0 && LDD % V == 0 && LDS % V == 0;
  const bool wide = rows_ok
                    && (reinterpret_cast<unsigned long long>(dst) % 16 == 0)
                    && (reinterpret_cast<unsigned long long>(src) % 16 == 0);
  if (wide) {
    constexpr int PER = COLS / V;
    for (int e = tid; e < ROWS * PER; e += nt) {
      const int r = e / PER, c = (e % PER) * V;
      const unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + r * LDD + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + r * LDS + c));
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += nt) {
      const int r = e / COLS, c = e % COLS;
      const unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + r * LDD + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                   "l"(src + r * LDS + c), "n"(sizeof(T)));
    }
  }
#else
  for (int e = tid; e < ROWS * COLS; e += nt)
    dst[(e / COLS) * LDD + e % COLS] = src[(e / COLS) * LDS + e % COLS];
#endif
}

// The copies async_rows issues on the card for such a matrix when both
// sides are 16-byte aligned: a caller starts its next copy on the threads
// these leave.
template <typename T, int ROWS, int COLS, int LDD, int LDS>
RTT_HD constexpr int async_copies() {
  constexpr int V = 16 / sizeof(T);
  return COLS % V == 0 && LDD % V == 0 && LDS % V == 0 ? ROWS * COLS / V
                                                       : ROWS * COLS;
}

// Close this thread's group of async_rows copies / wait for all of its
// groups (then a barrier makes every thread's copies visible).
RTT_HD void async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

RTT_HD void async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// n contiguous entries from device memory into shared memory without
// waiting: cp.async, 16 bytes a copy when both sides are 16-byte aligned
// and n fills whole copies, else one element a copy. The host copies at
// once. Pair with async_commit(), async_wait_all() and a barrier.
template <typename T>
RTT_HD void async_copy(T* dst, const T* src, int n, int tid, int nt) {
#if defined(__CUDA_ARCH__)
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0
      && ((reinterpret_cast<unsigned long long>(dst)
           | reinterpret_cast<unsigned long long>(src)) % 16) == 0) {
    for (int e = tid; e < n / V; e += nt) {
      const unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + e * V));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + e * V));
    }
  } else {
    for (int e = tid; e < n; e += nt) {
      const unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + e));
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                   "l"(src + e), "n"(sizeof(T)));
    }
  }
#else
  for (int e = tid; e < n; e += nt) dst[e] = src[e];
#endif
}

// dst[i] = src[i] for n contiguous entries, 16 bytes a store on the card
// when both sides are 16-byte aligned and n fills whole stores (a
// coalesced write of a block staged in shared memory).
template <typename T>
RTT_HD void store_wide(T* dst, const T* src, int n, int tid, int nt) {
#if defined(__CUDA_ARCH__)
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0
      && ((reinterpret_cast<unsigned long long>(dst)
           | reinterpret_cast<unsigned long long>(src)) % 16) == 0) {
    for (int e = tid; e < n / V; e += nt)
      reinterpret_cast<float4*>(dst)[e] =
          reinterpret_cast<const float4*>(src)[e];
    return;
  }
#endif
  for (int e = tid; e < n; e += nt) dst[e] = src[e];
}

// dst[i] = src[i] for n entries (a cooperative load or store).
template <typename T>
RTT_HD void copy(T* dst, const T* src, int n, int tid, int nt) {
  for (int e = tid; e < n; e += nt) dst[e] = src[e];
}

}  // namespace rtt
