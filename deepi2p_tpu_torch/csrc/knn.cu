// Exact k nearest neighbours for small databases, f32.
//
// Replaces: deepi2p_tpu/ops/knn_pallas.py::knn_pallas (`_kernel`, :39-57,
// wrapper :60-105).  Same function: direct (db - q)^2 distances summed over
// the D coordinates in order, the k smallest returned in increasing
// distance, ties to the lowest database index (as lax.top_k and a stable
// sort give them), NaN after every number, and no index >= M.
//
// What bounds it on the H100: per query it reads D floats and writes k
// (distance, index) pairs; per (query, database row) it does 3D-1 float
// operations plus one compare.  At the main path's largest call
// (B=32, N=20480, M=128, D=3, k=3) that is ~24 MB of traffic (~7 us at
// 3.35 TB/s) against ~0.76 GFLOP (~11 us at 67 TFLOP/s f32): operations
// bound.  The distance may not be contracted into FMAs (it must round as
// the plain version's separate ops do), so 8 instructions per (query, row)
// at D=3 are the floor, ~2x that bound.  What the first design added on
// top -- a NaN-aware (distance, index) compare and a runtime-bounded
// insertion over every row, ~50 instructions per (query, row) -- is what
// this design removes.  What remains above the floor in the rows path is
// the insertion: a lane's query takes a row only k (1 + ln(M / k)) times
// on random data, but a warp runs the insertion whenever any of its 32
// lanes does, which for k = 3 and M = 128 is most rows, ~10 more
// instructions per (query, row).
//
// Key: a distance is >= 0 or NaN, so its float bits order as unsigned
// ints; min(bits, kNanKey) sends every NaN to one value above +inf, so
// NaNs tie among themselves and fall back to index order.  Rows are
// visited in increasing index and a row enters a list only with a key
// strictly below the list's last one, which keeps ties in index order:
// the result is exactly a stable ascending sort, the plain version's
// `torch.sort(stable=True)`.  Lists start full of sentinels above every
// key, and k <= M, so an index >= M is never written.
//
// Two paths, picked by knn_f32 from the shapes:
// * rows (B*N > kWarpPathMaxQueries, the forward's point->node calls):
//   one thread per QPT queries (4 for k <= 3, else 2).  The block stages
//   its batch element's database in shared memory as 16-byte rows (D
//   padded to 4 with zeros; D in 5..8 as two 16-byte halves padded to 8),
//   so one broadcast LDS.128 serves a row for all QPT queries.  Per row
//   and query: the distance, one min, one compare against the list's last
//   key, and an insertion only on a hit.  Loops have compile-time bounds
//   (D = 3 or padded 8, the list capacity 3 or 16).
// * warp (small batches, the node->node calls at N=128): one warp per
//   query.  Lane l takes rows l, l+32, ...; each lane keeps its own best
//   min(KCAP, rows per lane) in a sorted list, and k rounds of a warp min
//   (__reduce_min_sync over the head keys, then over the head indices of
//   the lanes holding that key) pop the global (key, index) minimum, which
//   is exactly the stable order.  This puts 32x the threads on the card
//   where the rows path would leave most SMs idle.
//
// Zero padding is exact: a padded coordinate adds (0 - 0)^2 = +0 to a sum
// that is never -0, which leaves it unchanged.  The distances use
// __fsub_rn/__fmul_rn/__fadd_rn: never contracted into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 512;
constexpr int kMaxD = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kNanKey = 0x7f800001u;   // every NaN: just above +inf
constexpr unsigned kSentinel = 0xffffffffu;  // above every key
constexpr int kSentinelIdx = 0x7fffffff;
// batches of at most this many queries (B*N) take the warp path
constexpr long long kWarpPathMaxQueries = 65536;

__device__ __forceinline__ float sq_diff(float a, float b) {
  const float d = __fsub_rn(a, b);
  return __fmul_rn(d, d);
}

// Squared distance of a staged row to a query, coordinates in order.
// DP == 4: one float4, coordinates 0..2 (D == 3); DP == 8: two float4s,
// coordinates 0..7 with zero padding (any D <= 8).
template <int DP>
__device__ __forceinline__ float dist2(const float4* r, const float4* q) {
  float acc = sq_diff(r[0].x, q[0].x);
  acc = __fadd_rn(acc, sq_diff(r[0].y, q[0].y));
  acc = __fadd_rn(acc, sq_diff(r[0].z, q[0].z));
  if constexpr (DP == 8) {
    acc = __fadd_rn(acc, sq_diff(r[0].w, q[0].w));
    acc = __fadd_rn(acc, sq_diff(r[1].x, q[1].x));
    acc = __fadd_rn(acc, sq_diff(r[1].y, q[1].y));
    acc = __fadd_rn(acc, sq_diff(r[1].z, q[1].z));
    acc = __fadd_rn(acc, sq_diff(r[1].w, q[1].w));
  }
  return acc;
}

__device__ __forceinline__ unsigned key_of(float d2) {
  return min(__float_as_uint(d2), kNanKey);
}

__device__ __forceinline__ float dist_of(unsigned key) {
  return key == kNanKey ? __int_as_float(0x7fffffff) : __uint_as_float(key);
}

// Insert (key, m) into the ascending list; the caller has checked
// key < bk[KC-1].  m is above every index in the list, so it lands after
// every entry with an equal key.
template <int KC>
__device__ __forceinline__ void insert(unsigned (&bk)[KC], int (&bi)[KC],
                                       unsigned key, int m) {
#pragma unroll
  for (int j = KC - 1; j > 0; --j) {
    if (key < bk[j - 1]) {
      bk[j] = bk[j - 1];
      bi[j] = bi[j - 1];
    } else if (key < bk[j]) {
      bk[j] = key;
      bi[j] = m;
    }
  }
  if (key < bk[0]) {
    bk[0] = key;
    bi[0] = m;
  }
}

// Stage a database: DP floats per row, 4 (D == 3) or 8 (any D <= 8).
template <int DP>
__device__ __forceinline__ void stage_db(const float* __restrict__ dbb,
                                         int M, int D, float4* s_db) {
  constexpr int V = DP / 4;
  for (int t = threadIdx.x; t < M * V; t += blockDim.x) {
    const int row = t / V, h = t % V;
    const float* src = dbb + (size_t)row * D + 4 * h;
    const int left = D - 4 * h;
    float4 v;
    v.x = left > 0 ? src[0] : 0.0f;
    v.y = left > 1 ? src[1] : 0.0f;
    v.z = left > 2 ? src[2] : 0.0f;
    v.w = (DP == 8 && left > 3) ? src[3] : 0.0f;
    s_db[t] = v;
  }
}

template <int DP>
__device__ __forceinline__ void load_query(const float* __restrict__ qn,
                                           int D, float4 (&qv)[DP / 4]) {
  float c[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) c[d] = d < D ? qn[d] : 0.0f;
#pragma unroll
  for (int h = 0; h < DP / 4; ++h)
    qv[h] = make_float4(c[4 * h], c[4 * h + 1], c[4 * h + 2],
                        DP == 8 ? c[4 * h + 3] : 0.0f);
}

// The rows path: thread t of block x handles queries
// x * kThreads * QPT + t + j * kThreads, j < QPT.
template <int DP, int KCAP, int QPT>
__global__ void __launch_bounds__(kThreads)
knn_rows_kernel(const float* __restrict__ q, const float* __restrict__ db,
                float* __restrict__ d2_out, int32_t* __restrict__ idx_out,
                int N, int M, int D, int k) {
  constexpr int V = DP / 4;
  __shared__ float4 s_db[kMaxM * 2];
  const int b = blockIdx.y;
  stage_db<DP>(db + (size_t)b * M * D, M, D, s_db);
  __syncthreads();  // the block's only barrier, reached by every thread

  const int n0 = blockIdx.x * kThreads * QPT + threadIdx.x;
  float4 qv[QPT][V];
  unsigned bk[QPT][KCAP];
  int bi[QPT][KCAP];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int n = min(n0 + j * kThreads, N - 1);  // a tail thread's spare
    load_query<DP>(q + ((size_t)b * N + n) * D, D, qv[j]);
#pragma unroll
    for (int s = 0; s < KCAP; ++s) {
      bk[j][s] = kSentinel;
      bi[j][s] = kSentinelIdx;
    }
  }

#pragma unroll 2
  for (int m = 0; m < M; ++m) {
    float4 r[V];
#pragma unroll
    for (int h = 0; h < V; ++h) r[h] = s_db[m * V + h];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const unsigned key = key_of(dist2<DP>(r, qv[j]));
      if (key < bk[j][KCAP - 1]) insert<KCAP>(bk[j], bi[j], key, m);
    }
  }

#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int n = n0 + j * kThreads;
    if (n < N) {
      float* d2n = d2_out + ((size_t)b * N + n) * k;
      int32_t* idn = idx_out + ((size_t)b * N + n) * k;
#pragma unroll
      for (int s = 0; s < KCAP; ++s) {
        if (s < k) {
          d2n[s] = dist_of(bk[j][s]);
          idn[s] = bi[j][s];
        }
      }
    }
  }
}

// The warp path: warp w of block x handles query x * kWarps + w; lane l
// scans rows l + 32 r, r < RCAP (RCAP * 32 >= M).
template <int DP, int KCAP, int RCAP>
__global__ void __launch_bounds__(kThreads)
knn_warp_kernel(const float* __restrict__ q, const float* __restrict__ db,
                float* __restrict__ d2_out, int32_t* __restrict__ idx_out,
                int N, int M, int D, int k) {
  constexpr int V = DP / 4;
  constexpr int LC = KCAP < RCAP ? KCAP : RCAP;  // a lane's list
  __shared__ float4 s_db[kMaxM * 2];
  const int b = blockIdx.y;
  stage_db<DP>(db + (size_t)b * M * D, M, D, s_db);
  __syncthreads();  // the block's only barrier, reached by every thread

  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps leave together
  float4 qv[V];
  load_query<DP>(q + ((size_t)b * N + n) * D, D, qv);
  unsigned bk[LC];
  int bi[LC];
#pragma unroll
  for (int s = 0; s < LC; ++s) {
    bk[s] = kSentinel;
    bi[s] = kSentinelIdx;
  }
#pragma unroll
  for (int rr = 0; rr < RCAP; ++rr) {
    const int m = lane + 32 * rr;
    if (m < M) {
      const unsigned key = key_of(dist2<DP>(&s_db[m * V], qv));
      if (key < bk[LC - 1]) insert<LC>(bk, bi, key, m);
    }
  }

  // k rounds: the warp's least (key, index) head leaves its lane's list
  unsigned my_key = kSentinel;
  int my_idx = 0;
  for (int s = 0; s < k; ++s) {
    const unsigned mk = __reduce_min_sync(0xffffffffu, bk[0]);
    const unsigned mi = __reduce_min_sync(
        0xffffffffu, bk[0] == mk ? (unsigned)bi[0] : 0xffffffffu);
    if (lane == s) {
      my_key = mk;
      my_idx = (int)mi;
    }
    if (bk[0] == mk && (unsigned)bi[0] == mi) {
#pragma unroll
      for (int j = 0; j + 1 < LC; ++j) {
        bk[j] = bk[j + 1];
        bi[j] = bi[j + 1];
      }
      bk[LC - 1] = kSentinel;
      bi[LC - 1] = kSentinelIdx;
    }
  }
  if (lane < k) {
    d2_out[((size_t)b * N + n) * k + lane] = dist_of(my_key);
    idx_out[((size_t)b * N + n) * k + lane] = my_idx;
  }
}

template <int DP, int KCAP>
void launch(const float* q, const float* db, float* d2, int32_t* idx, int B,
            int N, int M, int D, int k, cudaStream_t stream) {
  if ((long long)B * N <= kWarpPathMaxQueries) {
    dim3 grid((N + kWarps - 1) / kWarps, B);
    if (M <= 4 * 32) {
      knn_warp_kernel<DP, KCAP, 4><<<grid, kThreads, 0, stream>>>(
          q, db, d2, idx, N, M, D, k);
    } else {
      knn_warp_kernel<DP, KCAP, kMaxM / 32><<<grid, kThreads, 0, stream>>>(
          q, db, d2, idx, N, M, D, k);
    }
  } else {
    constexpr int QPT = KCAP <= 3 ? 4 : 2;
    dim3 grid((N + kThreads * QPT - 1) / (kThreads * QPT), B);
    knn_rows_kernel<DP, KCAP, QPT><<<grid, kThreads, 0, stream>>>(
        q, db, d2, idx, N, M, D, k);
  }
}

template <int DP>
void launch_k(const float* q, const float* db, float* d2, int32_t* idx,
              int B, int N, int M, int D, int k, cudaStream_t stream) {
  // the main path's k are 3 and 16; a smaller k uses the first k slots
  if (k <= 3) {
    launch<DP, 3>(q, db, d2, idx, B, N, M, D, k, stream);
  } else {
    launch<DP, 16>(q, db, d2, idx, B, N, M, D, k, stream);
  }
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
  if (D == 3) {
    launch_k<4>(qf, dbf, d2f, idxi, B, N, M, D, k, s);
  } else {
    launch_k<8>(qf, dbf, d2f, idxi, B, N, M, D, k, s);
  }
  return (int)cudaGetLastError();
}

// Which path knn_f32 takes for these shapes: 0 rows, 1 warp.
int knn_path(int B, int N) {
  return (long long)B * N <= kWarpPathMaxQueries ? 1 : 0;
}

const char* deepi2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
