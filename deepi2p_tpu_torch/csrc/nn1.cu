// Exact nearest neighbour (1-NN) against a large database, f32.
//
// Replaces: deepi2p_tpu/ops/knn_pallas.py::nn1_pallas (`_nn1_kernel`
// :111-131, wrapper :134-199), the inner search of the ICP loop
// (deepi2p_tpu/register/icp.py:108-122).  Same function: direct (db - q)^2
// distances summed over the D coordinates in order, the smallest one and
// its index, ties to the lowest database index (the Pallas kernel's strict
// `<` fold across chunks, jnp.argmin within one).  Any M, D <= 8.
//
// Q query sets per database: query (B*Q, N, D) is matched against database
// (B, M, D), query set s against database s / Q.  The Q sets of a database
// are contiguous, so they are one list of Q N queries here.  ICP runs all
// inits of a pair as the Q query sets of that pair's pseudo cloud.
//
// NaN: distances are ordered with NaN after every number.  A NaN distance
// (a NaN coordinate in the query or in a database row) therefore never
// beats a number; a query whose every distance is NaN gets d2 NaN and index
// 0.  The Pallas kernel can instead return an index of M or more there (its
// `d2 == min` test fails on NaN); this kernel never writes an index >= M.
//
// What bounds it on the H100: per (query, database row) 3D - 1 float
// operations for the distance and one compare, against D floats read per
// query and 8 bytes written.  At the ICP shape (512 query sets of 20480
// points against 5120 rows, D = 3) that is 4.8e11 operations (7.2 ms at
// 67 TFLOP/s f32) against 126 MB of traffic (0.04 ms at 3.35 TB/s):
// operations bound by two orders of magnitude.  The distance may not be
// contracted into FMAs (it must round as the plain version's separate ops
// do), so its 3 subtractions, 3 multiplies and 2 adds plus one min, 9
// instructions per (query, row) at D = 3, are the floor: ~2x that bound.
//
// Design.  The first design (one thread per query, three scalar LDS per
// row, a NaN-aware compare and two selects per (query, row), two barriers
// per 1024-row tile) issued ~19 instructions per (query, row).  Here:
// * each thread keeps QT queries (16 for D <= 4, 8 above; 128 threads per
//   block) and reads a row once, as one broadcast float4 (two for D > 4,
//   zero padded) from shared memory, for all of them: at D = 3 that is 64
//   independent distances in flight per unrolled step of 4 rows, which
//   measured faster than more warps of fewer queries each (PERF.md);
// * D = 3 (ICP) has its own instantiation; every other D runs the one of
//   its row width, 4 or 8 coordinates, with queries and rows padded by
//   zeros: a padded coordinate adds (0 - 0)^2 = +0 to a sum that is never
//   -0, which leaves every distance's bits as they are;
// * per (query, row) only the distance and best = fminf(best, d): fminf
//   drops a NaN operand, so it is exactly the NaN-last running minimum.
//   The index is not tracked per row.  The rows are walked in tiles of
//   kTrack in increasing index, and at the end of each tile a query
//   records the tile if its minimum fell there.  Its minimum falls for the
//   last time in the first tile that holds the final value, and that tile
//   is rescanned at the end for the lowest row whose distance equals it:
//   ties to the lowest index, whatever the tile boundaries.  A query that
//   never left NaN never recorded a tile and gets index 0.  Distances are
//   never -0 (sums of squares from +0), so equal values are equal bits;
//   the rescan repeats the distance's arithmetic exactly;
// * resident (the wrapper's choice, nn1_plan in ops/knn_cuda.py: the
//   database's rows fit one block's shared memory, 80 KB for the ICP's
//   5120 rows): a block stages its database once and then walks several
//   query chunks of it, chunk c, c + gridDim.x, ..., with no barrier after
//   the staging;
// * streamed (larger databases): one chunk per block; tiles of kTile rows
//   are double buffered in shared memory with cp.async, the next tile in
//   flight while the current one is scanned, and the rescan reads its tile
//   from device memory.
// The distances use __fsub_rn / __fmul_rn / __fadd_rn, never contracted
// into an FMA (the build also passes -fmad=false).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTrack = 64;        // rows per tracked tile (a power of 2)
constexpr int kTile = 1024;       // rows per streamed tile (a kTrack multiple)
constexpr int kMaxD = 8;

// The instantiation that serves D coordinates: its row width DV (3, 4 or
// 8), float4 rows per database row, queries per thread.
__host__ __device__ constexpr int width(int D) {
  return D == 3 ? 3 : (D <= 4 ? 4 : 8);
}
__host__ __device__ constexpr int rows_v(int DV) { return DV <= 4 ? 1 : 2; }
__host__ __device__ constexpr int queries_per_thread(int DV) {
  return DV <= 4 ? 16 : 8;
}

__device__ __forceinline__ float sq_diff(float a, float b) {
  const float d = __fsub_rn(a, b);
  return __fmul_rn(d, d);
}

template <int D>
__device__ __forceinline__ float dist2(const float (&r)[D],
                                       const float (&q)[D]) {
  float acc = sq_diff(r[0], q[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) acc = __fadd_rn(acc, sq_diff(r[d], q[d]));
  return acc;
}

// Row m of a shared-memory block of float4 rows.
template <int D>
__device__ __forceinline__ void smem_row(const float4* rows, int m,
                                         float (&r)[D]) {
  constexpr int V = rows_v(D);
  float e[4 * V];
#pragma unroll
  for (int h = 0; h < V; ++h) {
    const float4 a = rows[m * V + h];
    e[4 * h] = a.x;
    e[4 * h + 1] = a.y;
    e[4 * h + 2] = a.z;
    e[4 * h + 3] = a.w;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = e[d];
}

// Scan rows [0, n) of a block of float4 rows into the running minima.
template <int D, int QT>
__device__ __forceinline__ void scan_rows(const float4* rows, int n,
                                          const float (&qv)[QT][D],
                                          float (&best)[QT]) {
#pragma unroll 4
  for (int m = 0; m < n; ++m) {
    float r[D];
    smem_row<D>(rows, m, r);
#pragma unroll
    for (int j = 0; j < QT; ++j) best[j] = fminf(best[j], dist2<D>(r, qv[j]));
  }
}

// After the tile of rows starting at m0: record it for each query whose
// minimum fell in it.  A minimum only falls (NaN-last order), so one that
// is NaN now was NaN before the tile too.
template <int QT>
__device__ __forceinline__ void track(int m0, const float (&best)[QT],
                                      float (&prev)[QT], int (&at)[QT]) {
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    if (best[j] == best[j] && best[j] != prev[j]) {
      at[j] = m0;
      prev[j] = best[j];
    }
  }
}

// The lowest row of the tile at `at` whose distance to qv equals best
// (which a row of that tile has).  Lane l starts at row l mod kTrack, so
// that the lanes' shared-memory reads fall in different banks.  A streamed
// database's rows (D coordinates) are read from device memory and padded.
template <int D, bool RESIDENT>
__device__ __forceinline__ int rescan(const float4* s_rows,
                                      const float* __restrict__ dbb, int M,
                                      int Dn, int at, const float (&qv)[D],
                                      float best) {
  const int lane = threadIdx.x & 31;
  const int n = min(kTrack, M - at);
  int idx = M;
  for (int r = 0; r < kTrack; ++r) {
    const int rr = (r + lane) & (kTrack - 1);
    if (rr < n) {
      float row[D];
      if constexpr (RESIDENT) {
        smem_row<D>(s_rows, at + rr, row);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d)
          row[d] = d < Dn ? __ldg(dbb + (size_t)(at + rr) * Dn + d) : 0.0f;
      }
      if (dist2<D>(row, qv) == best) idx = min(idx, at + rr);
    }
  }
  return idx;
}

// Stage the database's M rows of Dn coordinates as float4 rows (zero
// padded).
template <int D>
__device__ __forceinline__ void stage_rows(const float* __restrict__ dbb,
                                           int M, int Dn, float4* s_rows) {
  constexpr int V = rows_v(D);
  for (int t = threadIdx.x; t < M * V; t += blockDim.x) {
    const int row = t / V, h = t - row * V;
    const float* src = dbb + (size_t)row * Dn + 4 * h;
    const int left = Dn - 4 * h;
    s_rows[t] = make_float4(left > 0 ? src[0] : 0.0f, left > 1 ? src[1] : 0.0f,
                            left > 2 ? src[2] : 0.0f,
                            left > 3 ? src[3] : 0.0f);
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Start copying rows [m0, m0 + n) into a streamed tile buffer: each float
// to its place in the float4 rows (the padding was zeroed once).
template <int D>
__device__ __forceinline__ void stage_async(const float* __restrict__ dbb,
                                            int Dn, int m0, int n,
                                            float4* buf) {
  constexpr int V = rows_v(D);
  float* f = reinterpret_cast<float*>(buf);
  const float* src = dbb + (size_t)m0 * Dn;
  for (int t = threadIdx.x; t < n * Dn; t += blockDim.x) {
    const int row = t / Dn, c = t - row * Dn;
    cp_async4(f + row * 4 * V + c, src + t);
  }
  cp_async_commit();
}

// Grid (blocks per database, databases).  RESIDENT: the database's M rows
// in dynamic shared memory, chunks blockIdx.x, blockIdx.x + gridDim.x, ...;
// else two tiles of kTile rows, one chunk per block.  Every barrier is
// reached by all threads: the loop bounds depend on the block only.  D is
// the row width (width(Dn)) of the Dn coordinates in q and db.
template <int D, bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ q, const float* __restrict__ db,
           float* __restrict__ d2_out, int32_t* __restrict__ idx_out,
           long long nq, int M, int Dn, int chunks) {
  constexpr int V = rows_v(D);
  constexpr int QT = queries_per_thread(D);
  if constexpr (D == 3) Dn = 3;
  extern __shared__ float4 s_rows[];
  const int b = blockIdx.y;
  const float* dbb = db + (size_t)b * M * Dn;
  const float* qb = q + (size_t)b * nq * Dn;
  if constexpr (RESIDENT) {
    stage_rows<D>(dbb, M, Dn, s_rows);
  } else {
    // zero the padding of both tile buffers once; cp.async fills the rest
    float* f = reinterpret_cast<float*>(s_rows);
    for (int t = threadIdx.x; t < 2 * kTile * 4 * V; t += blockDim.x) {
      if (t % (4 * V) >= Dn) f[t] = 0.0f;
    }
  }
  __syncthreads();

  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long n0 = (long long)c * kThreads * QT + threadIdx.x;
    float qv[QT][D], best[QT], prev[QT];
    int at[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const long long n = min(n0 + (long long)j * kThreads, nq - 1);
#pragma unroll
      for (int d = 0; d < D; ++d) qv[j][d] = d < Dn ? qb[n * Dn + d] : 0.0f;
      best[j] = prev[j] = __int_as_float(0x7fffffff);  // NaN
      at[j] = -1;
    }

    if constexpr (RESIDENT) {
      for (int m0 = 0; m0 < M; m0 += kTrack) {
        scan_rows<D, QT>(s_rows + m0 * V, min(kTrack, M - m0), qv, best);
        track<QT>(m0, best, prev, at);
      }
    } else {
      stage_async<D>(dbb, Dn, 0, min(kTile, M), s_rows);
      for (int t0 = 0, k = 0; t0 < M; t0 += kTile, k ^= 1) {
        const float4* cur = s_rows + k * kTile * V;
        if (t0 + kTile < M) {
          stage_async<D>(dbb, Dn, t0 + kTile, min(kTile, M - t0 - kTile),
                         s_rows + (k ^ 1) * kTile * V);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();                 // tile t0 is in cur
        const int rows = min(kTile, M - t0);
        for (int m0 = 0; m0 < rows; m0 += kTrack) {
          scan_rows<D, QT>(cur + m0 * V, min(kTrack, rows - m0), qv, best);
          track<QT>(t0 + m0, best, prev, at);
        }
        __syncthreads();                 // cur is consumed
      }
    }

#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const long long n = n0 + (long long)j * kThreads;
      const int idx = at[j] < 0 ? 0
                                : rescan<D, RESIDENT>(s_rows, dbb, M, Dn,
                                                      at[j], qv[j], best[j]);
      if (n < nq) {
        d2_out[(size_t)b * nq + n] = best[j];
        idx_out[(size_t)b * nq + n] = idx;
      }
    }
  }
}

// The kernel that serves D coordinates, resident or streamed.
using Nn1Kernel = void (*)(const float*, const float*, float*, int32_t*,
                           long long, int, int, int);
Nn1Kernel nn1_kernel_for(int D, bool resident) {
  switch (width(D)) {
    case 3: return resident ? nn1_kernel<3, true> : nn1_kernel<3, false>;
    case 4: return resident ? nn1_kernel<4, true> : nn1_kernel<4, false>;
    default: return resident ? nn1_kernel<8, true> : nn1_kernel<8, false>;
  }
}

}  // namespace

extern "C" {

// q (S, N, D), db (S / Q, M, D) -> d2 (S, N), idx (S, N).  The launch
// comes from the wrapper (ops/knn_cuda.py::nn1_plan), which owns it and
// which this function only checks: `qt` queries per thread (16 for
// D <= 4, else 8), `blocks` per database, and whether the database stays
// in shared memory (`resident`, which needs M * 16 bytes, 32 for D > 4,
// within what the card gives one block).
// Returns cudaErrorInvalidValue for shapes outside the kernel's bounds
// (the Python wrapper checks them first), else the launch's error.
int nn1_f32(const void* q, const void* db, void* d2, void* idx, int S,
            int N, int M, int D, int Q, int qt, int blocks, int resident,
            void* stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (S <= 0 || S > 65535 || N <= 0 || M <= 0 || D <= 0 || D > kMaxD ||
      Q <= 0 || S % Q != 0 || qt != queries_per_thread(width(D)) ||
      blocks <= 0 ||
      (resident && (long long)M * rows_v(width(D)) * 16 > max_smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nq = (long long)Q * N;
  const int chunk = kThreads * qt;
  const int chunks = (int)((nq + chunk - 1) / chunk);
  const size_t smem =
      (size_t)(resident ? M : 2 * kTile) * rows_v(width(D)) * 16;
  const Nn1Kernel kernel = nn1_kernel_for(D, resident != 0);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(blocks, S / Q), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(db),
      static_cast<float*>(d2), static_cast<int32_t*>(idx), nq, M, D, chunks);
  return (int)cudaGetLastError();
}

// What the wrapper's plan needs to know of the current card for a
// database of M rows of D coordinates, into out[0..2]: its SMs, the most
// shared memory one block may take, and how many blocks of the resident
// kernel one SM holds with the database in shared memory (0 where it does
// not fit a block).
int nn1_limits(int D, int M, void* out) {
  if (D <= 0 || D > kMaxD || M <= 0) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&o[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&o[1],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long smem = (long long)M * rows_v(width(D)) * 16;
  o[2] = 0;
  if (smem > o[1]) return 0;
  const Nn1Kernel kernel = nn1_kernel_for(D, true);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[2], kernel,
                                                        kThreads, smem);
  return (int)err;
}

}  // extern "C"
