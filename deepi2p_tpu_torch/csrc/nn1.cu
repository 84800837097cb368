// Exact nearest neighbour (1-NN) against a large database, f32.
//
// Replaces: deepi2p_tpu/ops/knn_pallas.py::nn1_pallas (`_nn1_kernel`
// :111-131, wrapper :134-199), the inner search of the ICP loop
// (deepi2p_tpu/register/icp.py:108-122).  Same function: direct (db - q)^2
// distances summed over the D coordinates in order, the smallest one and
// its index, ties to the lowest database index (the Pallas kernel's strict
// `<` fold across chunks, jnp.argmin within one).  Any M.
//
// Q query sets per database: query (B*Q, N, D) is matched against database
// (B, M, D), query set s against database s / Q.  ICP runs all inits of a
// pair as the Q query sets of that pair's pseudo cloud, so the cloud is
// read from one place and never copied per init.
//
// NaN: distances are ordered as the kNN kernel orders them, by the key
// (distance, index) with NaN after every number.  A NaN distance (a NaN
// coordinate in the query or in a database row) therefore never beats a
// number; a query whose every distance is NaN gets d2 NaN and index 0.  The
// Pallas kernel can instead return an index of M or more there (its
// `d2 == min` test fails on NaN); this kernel never writes an index >= M.
//
// What bounds it on the H100: per (query, database row) 3D - 1 float
// operations for the distance and one compare, against D floats read per
// query and 8 bytes written.  At the ICP shape (512 query sets of 20480
// points against 5120 rows, D = 3) that is 4.8e11 operations (7.2 ms at
// 67 TFLOP/s f32) against 126 MB of traffic (0.04 ms at 3.35 TB/s):
// operations bound by two orders of magnitude.
//
// Design: one thread per query, 256 threads per block, one block row per
// query set.  The block walks the database in tiles of kTile rows staged in
// shared memory (all threads read the same row at once: a broadcast) and
// keeps the running (min, argmin) in registers.  Rows are visited in
// increasing index and a row replaces the running minimum only if it is
// strictly smaller (or the running one is NaN and it is not), which is the
// lexicographic key order above.  The distances use __fsub_rn / __fmul_rn /
// __fadd_rn, never contracted into an FMA, so they round exactly as the
// plain version's separate ops do and the indices match exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;      // database rows per shared-memory tile
constexpr int kMaxD = 8;

template <int D>
__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ q, const float* __restrict__ db,
           float* __restrict__ d2_out, int32_t* __restrict__ idx_out, int N,
           int M, int Q) {
  __shared__ float s_db[kTile * D];
  const int set = blockIdx.y;              // query set, database set / Q
  const float* dbb = db + (size_t)(set / Q) * M * D;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < N;
  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    qv[d] = live ? q[((size_t)set * N + n) * D + d] : 0.0f;

  float best = __int_as_float(0x7fc00000);   // NaN: every number beats it
  int best_i = 0;
  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int rows = min(kTile, M - m0);
    __syncthreads();                 // the previous tile is consumed
    for (int t = threadIdx.x; t < rows * D; t += kThreads)
      s_db[t] = dbb[(size_t)m0 * D + t];
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float* row = s_db + r * D;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float df = __fsub_rn(row[d], qv[d]);
        const float sq = __fmul_rn(df, df);
        acc = d == 0 ? sq : __fadd_rn(acc, sq);
      }
      if (acc < best || (best != best && acc == acc)) {
        best = acc;
        best_i = m0 + r;
      }
    }
  }
  if (live) {
    d2_out[(size_t)set * N + n] = best;
    idx_out[(size_t)set * N + n] = best_i;
  }
}

template <int D>
void launch(const float* q, const float* db, float* d2, int32_t* idx, int S,
            int N, int M, int Q, cudaStream_t stream) {
  dim3 grid((N + kThreads - 1) / kThreads, S);
  nn1_kernel<D><<<grid, kThreads, 0, stream>>>(q, db, d2, idx, N, M, Q);
}

}  // namespace

extern "C" {

// q (S, N, D), db (S / Q, M, D) -> d2 (S, N), idx (S, N).  Returns
// cudaErrorInvalidValue for shapes outside the kernel's bounds (the Python
// wrapper checks them first), else cudaGetLastError().
int nn1_f32(const void* q, const void* db, void* d2, void* idx, int S,
            int N, int M, int D, int Q, void* stream) {
  if (S <= 0 || S > 65535 || N <= 0 || M <= 0 || D <= 0 || D > kMaxD ||
      Q <= 0 || S % Q != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* dbf = static_cast<const float*>(db);
  float* d2f = static_cast<float*>(d2);
  int32_t* idxi = static_cast<int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: launch<1>(qf, dbf, d2f, idxi, S, N, M, Q, s); break;
    case 2: launch<2>(qf, dbf, d2f, idxi, S, N, M, Q, s); break;
    case 3: launch<3>(qf, dbf, d2f, idxi, S, N, M, Q, s); break;
    case 4: launch<4>(qf, dbf, d2f, idxi, S, N, M, Q, s); break;
    case 5: launch<5>(qf, dbf, d2f, idxi, S, N, M, Q, s); break;
    case 6: launch<6>(qf, dbf, d2f, idxi, S, N, M, Q, s); break;
    case 7: launch<7>(qf, dbf, d2f, idxi, S, N, M, Q, s); break;
    default: launch<8>(qf, dbf, d2f, idxi, S, N, M, Q, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
