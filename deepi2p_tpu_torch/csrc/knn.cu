// Exact k nearest neighbours for small databases, f32.
//
// Replaces: deepi2p_tpu/ops/knn_pallas.py::knn_pallas (`_kernel`, :39-57,
// wrapper :60-105).  Same function: direct (db - q)^2 distances summed over
// the D coordinates in order, the k smallest returned in increasing
// distance, ties to the lowest database index (as lax.top_k and a stable
// sort give them).
//
// What bounds it on the H100: per query it reads D floats and writes k
// (distance, index) pairs; per (query, database row) it does 3D-1 float
// operations plus one compare.  At the main path's largest call
// (B=32, N=20480, M=128, D=3, k=3) that is ~24 MB of traffic (~7 us at
// 3.35 TB/s) against ~0.76 GFLOP (~11 us at 67 TFLOP/s f32): operations
// bound, with the selection's compares on top.
//
// Design: one thread per query.  The block stages the whole database of
// its batch element (M <= 512 rows of D <= 8 floats, at most 16 KB) in
// shared memory once; every thread then scans it in increasing index and
// keeps its k best in registers by insertion (the list is fully unrolled
// over a compile-time capacity, so it never spills to local memory).
// Order is the lexicographic (distance, index) key with NaN after every
// number, which is exactly a stable ascending sort, so the result equals
// the plain version's `torch.sort(stable=True)` element for element.
// The list starts full of sentinels that every real row beats, and k <= M,
// so an index >= M is never written, NaN inputs included.
//
// The distances use __fsub_rn/__fmul_rn/__fadd_rn: never contracted into
// an FMA, so they round exactly as the plain version's separate ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 512;
constexpr int kMaxD = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ bool key_less(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return bn;          // any number sorts before NaN
  if (an) return ia < ib;           // both NaN: by index
  return a < b || (a == b && ia < ib);
}

template <int KCAP>
__global__ void knn_kernel(const float* __restrict__ q,
                           const float* __restrict__ db,
                           float* __restrict__ d2_out,
                           int32_t* __restrict__ idx_out,
                           int N, int M, int D, int k) {
  __shared__ float s_db[kMaxM * kMaxD];
  const int b = blockIdx.y;
  const float* dbb = db + (size_t)b * M * D;
  for (int t = threadIdx.x; t < M * D; t += blockDim.x) s_db[t] = dbb[t];
  __syncthreads();  // reached by every thread of the block

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* qn = q + ((size_t)b * N + n) * D;
  float qv[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) qv[d] = d < D ? qn[d] : 0.0f;

  float bd[KCAP];
  int bi[KCAP];
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    bd[j] = __int_as_float(0x7fc00000);  // NaN sentinel ...
    bi[j] = 0x7fffffff;                  // ... with the largest index
  }

  for (int m = 0; m < M; ++m) {
    const float* row = s_db + m * D;
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d < D) {
        const float df = __fsub_rn(row[d], qv[d]);
        const float sq = __fmul_rn(df, df);
        acc = d == 0 ? sq : __fadd_rn(acc, sq);
      }
    }
    // insertion: the candidate walks down the list, swapping into the
    // first slot it beats; the displaced entry carries on
    float cd = acc;
    int ci = m;
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      if (j < k && key_less(cd, ci, bd[j], bi[j])) {
        const float td = bd[j];
        const int ti = bi[j];
        bd[j] = cd;
        bi[j] = ci;
        cd = td;
        ci = ti;
      }
    }
  }

  float* d2n = d2_out + ((size_t)b * N + n) * k;
  int32_t* idn = idx_out + ((size_t)b * N + n) * k;
#pragma unroll
  for (int j = 0; j < KCAP; ++j) {
    if (j < k) {
      d2n[j] = bd[j];
      idn[j] = bi[j];
    }
  }
}

template <int KCAP>
void launch(const float* q, const float* db, float* d2, int32_t* idx, int B,
            int N, int M, int D, int k, cudaStream_t stream) {
  dim3 grid((N + kThreads - 1) / kThreads, B);
  knn_kernel<KCAP><<<grid, kThreads, 0, stream>>>(q, db, d2, idx, N, M, D, k);
}

}  // namespace

extern "C" {

// Returns cudaErrorInvalidValue for shapes outside the kernel's bounds
// (the Python wrapper checks them first), else cudaGetLastError().
int knn_f32(const void* q, const void* db, void* d2, void* idx, int B, int N,
            int M, int D, int k, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || M <= 0 || M > kMaxM || D <= 0 ||
      D > kMaxD || k <= 0 || k > 16 || k > M) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* dbf = static_cast<const float*>(db);
  float* d2f = static_cast<float*>(d2);
  int32_t* idxi = static_cast<int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the main path's k are 3 and 16
  if (k <= 4) {
    launch<4>(qf, dbf, d2f, idxi, B, N, M, D, k, s);
  } else {
    launch<16>(qf, dbf, d2f, idxi, B, N, M, D, k, s);
  }
  return (int)cudaGetLastError();
}

const char* deepi2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
