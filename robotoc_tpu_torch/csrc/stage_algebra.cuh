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

// dst[i] = src[i] for n entries (a cooperative load or store).
template <typename T>
RTT_HD void copy(T* dst, const T* src, int n, int tid, int nt) {
  for (int e = tid; e < n; e += nt) dst[e] = src[e];
}

}  // namespace rtt
