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
// Routines other than gauss_jordan and gauss_jordan_rows do not
// synchronise: the caller puts a barrier of its team between a routine and
// any later reader of its output.
#pragma once

#if defined(__CUDACC__)
#define RTT_HD __host__ __device__ inline
#else
#define RTT_HD inline
#endif

// Full unrolling on the card (register arrays need constant indices);
// nothing on the host.
#if defined(__CUDA_ARCH__)
#define RTT_UNROLL _Pragma("unroll")
#else
#define RTT_UNROLL
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

// The thread index that puts item 0 of a cooperative loop on thread `off`:
// loops of one phase spread over the threads the others leave.
RTT_HD int rot(int tid, int off, int nt) { return (tid + nt - off % nt) % nt; }

// x[0..N) = p[0..N): 16 bytes a load on the card, where p is 16-byte
// aligned and N fills whole loads (the callers' layouts see to both).
template <typename T, int N>
RTT_HD void load_vec(T* x, const T* p) {
#if defined(__CUDA_ARCH__)
  static_assert(N * sizeof(T) % 16 == 0, "whole 16-byte loads");
  if constexpr (sizeof(T) == 4) {
    RTT_UNROLL
    for (int u = 0; u < N; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + u);
      x[u] = v.x, x[u + 1] = v.y, x[u + 2] = v.z, x[u + 3] = v.w;
    }
  } else {
    RTT_UNROLL
    for (int u = 0; u < N; u += 2) {
      const double2 v = *reinterpret_cast<const double2*>(p + u);
      x[u] = v.x, x[u + 1] = v.y;
    }
  }
#else
  for (int u = 0; u < N; ++u) x[u] = p[u];
#endif
}

// p[0..N) = x[0..N): 16 bytes a store on the card (as load_vec).
template <typename T, int N>
RTT_HD void store_vec(T* p, const T* x) {
#if defined(__CUDA_ARCH__)
  static_assert(N * sizeof(T) % 16 == 0, "whole 16-byte stores");
  if constexpr (sizeof(T) == 4) {
    RTT_UNROLL
    for (int u = 0; u < N; u += 4)
      *reinterpret_cast<float4*>(p + u) =
          make_float4(x[u], x[u + 1], x[u + 2], x[u + 3]);
  } else {
    RTT_UNROLL
    for (int u = 0; u < N; u += 2)
      *reinterpret_cast<double2*>(p + u) = make_double2(x[u], x[u + 1]);
  }
#else
  for (int u = 0; u < N; ++u) p[u] = x[u];
#endif
}

// One TM x TN tile of a product in registers, the k in order from 0 (the
// per-entry arithmetic of gemm): acc[m][n] = sum_k A[m lda + k] B[k ldb + n]
// (tile_nn, B's row runs in 16-byte loads) or sum_k A[k lda + m]
// B[k ldb + n] (tile_tn, A^T B, both row runs in 16-byte loads). A and B
// point at the tile's first row / column.
template <typename T, int K, int TM, int TN>
RTT_HD void tile_nn(T (&acc)[TM][TN], const T* A, int lda, const T* B,
                    int ldb) {
  RTT_UNROLL
  for (int m = 0; m < TM; ++m) {
    RTT_UNROLL
    for (int n = 0; n < TN; ++n) acc[m][n] = T(0);
  }
  RTT_UNROLL
  for (int k = 0; k < K; ++k) {
    T a[TM], b[TN];
    RTT_UNROLL
    for (int m = 0; m < TM; ++m) a[m] = A[m * lda + k];
    load_vec<T, TN>(b, B + k * ldb);
    RTT_UNROLL
    for (int m = 0; m < TM; ++m) {
      RTT_UNROLL
      for (int n = 0; n < TN; ++n) acc[m][n] += a[m] * b[n];
    }
  }
}

template <typename T, int K, int TM, int TN>
RTT_HD void tile_tn(T (&acc)[TM][TN], const T* A, int lda, const T* B,
                    int ldb) {
  RTT_UNROLL
  for (int m = 0; m < TM; ++m) {
    RTT_UNROLL
    for (int n = 0; n < TN; ++n) acc[m][n] = T(0);
  }
  RTT_UNROLL
  for (int k = 0; k < K; ++k) {
    T a[TM], b[TN];
    load_vec<T, TM>(a, A + k * lda);
    load_vec<T, TN>(b, B + k * ldb);
    RTT_UNROLL
    for (int m = 0; m < TM; ++m) {
      RTT_UNROLL
      for (int n = 0; n < TN; ++n) acc[m][n] += a[m] * b[n];
    }
  }
}

// C (M x N) = A (M x K) B (K x N), thread tid of nt forming TM x TN tiles
// tid, tid + nt, ... by tile_nn and storing each tile row in 16-byte
// stores (B's and C's rows 16-byte aligned, TN whole 16-byte runs).
template <typename T, int M, int N, int K, int TM, int TN>
RTT_HD void gemm_rows(T* C, int ldc, const T* A, int lda, const T* B,
                      int ldb, int tid, int nt) {
  static_assert(M % TM == 0 && N % TN == 0, "tile");
  constexpr int NTJ = N / TN, TILES = (M / TM) * NTJ;
  for (int t = tid; t < TILES; t += nt) {
    const int i0 = (t / NTJ) * TM, j0 = (t % NTJ) * TN;
    T acc[TM][TN];
    tile_nn<T, K, TM, TN>(acc, A + i0 * lda, lda, B + j0, ldb);
    RTT_UNROLL
    for (int m = 0; m < TM; ++m)
      store_vec<T, TN>(C + (i0 + m) * ldc + j0, acc[m]);
  }
}

// The inverse of gauss_jordan (N <= 32) by the 32 lanes of one warp, lane
// i holding row i in registers (lanes >= N a zero row): per pivot k, lane k
// scales its row and writes it to `pv` (two alternating buffers of up4(N)
// entries, 16-byte aligned, in shared memory), and every other lane reads
// it in 16-byte broadcasts and updates its row. One warp barrier a pivot,
// none of the block; gauss_jordan's per-entry arithmetic (the pivot row's
// A[k,j] / p formed once, by lane k). Card only: the host inverts with
// gauss_jordan.
#if defined(__CUDACC__)
template <typename T, int N>
__device__ void gauss_jordan_rows(T (&row)[N], T* pv, int lane) {
  static_assert(N <= 32, "a row per lane");
  constexpr int NP = (N + 3) / 4 * 4;
  RTT_UNROLL
  for (int k = 0; k < N; ++k) {
    T* buf = pv + (k & 1) * NP;
    if (lane == k) {
      const T rinv = T(1) / row[k];
      T out[NP];
      RTT_UNROLL
      for (int j = 0; j < NP; ++j)
        out[j] = j < N ? (j == k ? rinv : row[j] * rinv) : T(0);
      store_vec<T, NP>(buf, out);
      RTT_UNROLL
      for (int j = 0; j < N; ++j) row[j] = out[j];
    }
    warp_sync();   // a lane reaches pivot k + 2's writes only when every
                   // lane has read this buffer (it passes pivot k + 1's)
    if (lane != k) {
      T piv[NP];
      load_vec<T, NP>(piv, buf);
      const T aik = row[k];
      RTT_UNROLL
      for (int j = 0; j < N; ++j)
        if (j != k) row[j] -= aik * piv[j];
      row[k] = -aik * piv[k];
    }
  }
}
#endif

// C[i,j] = D[i,j] + alpha * sum_k op(A)[i,k] op(B)[k,j], each thread
// computing TM x TN tiles of C in registers (thread tid of nt takes tiles
// tid, tid + nt, ...): TM + TN loads per TM TN multiply-adds. op(A) is
// M x K (A stored K x M when TA), op(B) is K x N (B stored N x K when TB).
// D may be nullptr (no addend) or alias C.
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

// wait for all but this thread's newest group of copies
RTT_HD void async_wait_prior() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// A ROWS x COLS block from shared memory (row stride LDS) to ROWS * COLS
// contiguous entries of device memory: 16 bytes a store on the card, the
// lanes on neighbouring addresses, where dst is 16-byte aligned (src's
// rows are by the caller's layout).
template <typename T, int ROWS, int COLS, int LDS>
RTT_HD void store_rows(T* dst, const T* src, int tid, int nt) {
#if defined(__CUDA_ARCH__)
  constexpr int V = 16 / sizeof(T), PER = COLS / V;
  static_assert(COLS % V == 0 && LDS % V == 0, "whole 16-byte runs");
  if (reinterpret_cast<unsigned long long>(dst) % 16 == 0) {
    for (int e = tid; e < ROWS * PER; e += nt) {
      const int r = e / PER, c = (e % PER) * V;
      *reinterpret_cast<float4*>(dst + r * COLS + c) =
          *reinterpret_cast<const float4*>(src + r * LDS + c);
    }
    return;
  }
#endif
  for (int e = tid; e < ROWS * COLS; e += nt)
    dst[e] = src[(e / COLS) * LDS + e % COLS];
}

// dst[x] = f(x) for x < n, the lanes on neighbouring addresses: V = 16 /
// sizeof(T) consecutive entries a 16-byte store on the card where dst is
// 16-byte aligned and n fills whole stores.
template <typename T, typename F>
RTT_HD void store_each(T* dst, int n, const F& f, int tid, int nt) {
#if defined(__CUDA_ARCH__)
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0 && reinterpret_cast<unsigned long long>(dst) % 16 == 0) {
    for (int e = tid; e < n / V; e += nt) {
      T x[V];
      RTT_UNROLL
      for (int u = 0; u < V; ++u) x[u] = f(e * V + u);
      store_vec<T, V>(dst + e * V, x);
    }
    return;
  }
#endif
  for (int x = tid; x < n; x += nt) dst[x] = f(x);
}

// dst[i] = src[i] for n entries (a cooperative load or store).
template <typename T>
RTT_HD void copy(T* dst, const T* src, int n, int tid, int nt) {
  for (int e = tid; e < n; e += nt) dst[e] = src[e];
}

}  // namespace rtt
