// ICP's iteration around the 1-NN on the card: the transform of every
// pair's source cloud by each init's pose, and the inlier moments with a
// 3x3 weighted Kabsch solve in float64.  Nothing here waits for the host.
//
// Replaces no TPU kernel: the JAX package's ICP update
// (deepi2p_tpu/register/icp.py) is XLA's.  On CUDA tensors it takes the
// place of the PyTorch chain of deepi2p_tpu_torch/register/icp.py
// (_transform's 18 elementwise launches and a stack; the weights, the
// gather of an expanded target, _kabsch's 377 MB outer product, a batched
// torch.linalg.svd whose info check makes the host wait, det, cat, the
// selects), which stays the CPU's code.
//
// Layout: B pairs of I inits, S = B I query sets, set s of pair s / I; N
// source and M target points a pair.  src (B, N, 3), tgt4 (B, M, 4): the
// target clouds with each point padded to 16 bytes (x, y, z, 0), made
// once a solve; moved (S, N, 3), d2 (S, N) f32, idx (S, N) int32
// (nn1_f32's outputs, read as they are), rt (S, 12) f32: a set's pose, R
// row-major, then t.
//
// What bounds it on the H100.  At the ICP shape (512 sets of 20480 points
// against 8 clouds of 5120) the transform writes 126 MB, 38 us at 3.35
// TB/s (0.05 ms measured); the update reads d2 and idx, 84 MB, 25 us, and
// clouds that stay in L2 (0.25 and 0.08 MB a pair), but its float64
// arithmetic bounds it (below).  The 1-NN between them takes 18 ms, so
// the design aims at no host sync, few launches and a fixed sum order,
// not at the last microsecond:
// * icp_transform: one thread per source point of a pair reads it once
//   and writes it moved by each of the pair's I poses, a pose's 12 floats
//   read as three broadcast float4s.  Per coordinate ((x R_k0 + y R_k1) +
//   z R_k2) + t_k, each operation rounded on its own (intrinsics; the
//   build passes -fmad=false), as _transform's PyTorch ops: bitwise the
//   same queries for the 1-NN.
// * icp_update: one block per set.  Each thread walks points threadIdx.x,
//   + kThreads, ... in order and sums, in float64, W, src, dst = tgt4[idx]
//   and src dst^T (kSums numbers).  A point's inputs are selected where
//   __fsqrt_rn(d2) < thr (the plain path's IEEE sqrt and predicate), else
//   +0, so a non-inlier adds +0 (never a multiple of a weight, and never a
//   NaN it holds).  Products of two f32 are exact in f64, so the uncentred
//   one-pass sums lose nothing against the plain path's centred f32 sums.
//   The loop's instructions bound it, not its bytes: at the ICP launch
//   (H100, 700 W) selects on the 16 terms took 0.154 ms, on the 7 inputs
//   0.105; dst as one 16-byte load (tgt4) beat three 4-byte loads (0.153)
//   and the target staged in shared memory (0.130); the solve takes ~0.01.
//   Then a butterfly in each warp and the warps in order: a fixed order,
//   no atomics, so a run repeats bit for bit.  Thread 0 solves (solve3,
//   below) and writes the pose where W >= kMinInliers.
// The card tests hold the solve's float64 R and t to icp._kabsch run in
// float64 on the same inliers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 16;      // W, sum src (3), sum dst (3), src dst^T (9)
constexpr int kStats = 28;     // the sums, then R (9) and t (3) in f64
constexpr int kSweeps = 12;    // Jacobi sweeps at most
constexpr int kMinInliers = 3;
constexpr double kWsumMin = 1e-6;
constexpr double kOrthoTol2 = 1e-30;
constexpr double kRankTol = 1e-12;

__global__ void __launch_bounds__(kThreads)
transform_kernel(const float* __restrict__ src, const float* __restrict__ rt,
                 float* __restrict__ moved, int I, int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const long long b = blockIdx.y;
  const float* p = src + (b * N + n) * 3;
  const float x = p[0], y = p[1], z = p[2];
  for (int i = 0; i < I; ++i) {
    const long long s = b * I + i;
    const float4* r4 = reinterpret_cast<const float4*>(rt + s * 12);
    const float4 a = __ldg(r4), c = __ldg(r4 + 1), d = __ldg(r4 + 2);
    // a = R00 R01 R02 R10, c = R11 R12 R20 R21, d = R22 t0 t1 t2
    float* o = moved + (s * N + n) * 3;
    o[0] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, a.x), __fmul_rn(y, a.y)),
                               __fmul_rn(z, a.z)), d.y);
    o[1] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, a.w), __fmul_rn(y, c.x)),
                               __fmul_rn(z, c.y)), d.z);
    o[2] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, c.z), __fmul_rn(y, c.w)),
                               __fmul_rn(z, d.x)), d.w);
  }
}

__device__ __forceinline__ double dot3(const double* a, const double* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const double* a, const double* b,
                                       double* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// v[k] by selects, so that v stays in registers
__device__ __forceinline__ double pick3(const double* v, int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ void swap_if(bool c, double& a, double& b, int& i,
                                        int& j) {
  if (c) {
    const double x = a; a = b; b = x;
    const int k = i; i = j; j = k;
  }
}

// R (row-major) and t from the moments m: S = C - mu_s
// (sum dst)^T; one-sided Jacobi on S's columns (A = S V), pairs (0,1),
// (0,2), (1,2), a pair rotated unless gamma^2 <= kOrthoTol2 alpha beta,
// until a sweep rotates none (at most kSweeps); sigma_j = |a_j|, ordered
// largest first, ties to the lower column; u1 = a1 / sigma1 (e_x where
// sigma1 = 0); u2 = a2 - (u1.a2) u1 normalised (where that is at most
// kRankTol sigma1: the axis least along u1, made orthogonal to it); u3 =
// u1 x u2; R = v1 u1^T + v2 u2^T + det(V) v3 u3^T; t = mu_d - R mu_s.
__device__ void solve3(const double* m, double* R, double* t) {
  const double wc = fmax(m[0], kWsumMin);
  double mu_s[3], mu_d[3], A[3][3], V[3][3];
  for (int a = 0; a < 3; ++a) {
    mu_s[a] = m[1 + a] / wc;
    mu_d[a] = m[4 + a] / wc;
  }
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) {
      A[a][c] = m[7 + 3 * a + c] - mu_s[a] * m[4 + c];
      V[a][c] = a == c ? 1.0 : 0.0;
    }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      const double alpha =
          (A[0][p] * A[0][p] + A[1][p] * A[1][p]) + A[2][p] * A[2][p];
      const double beta =
          (A[0][q] * A[0][q] + A[1][q] * A[1][q]) + A[2][q] * A[2][q];
      const double gamma =
          (A[0][p] * A[0][q] + A[1][p] * A[1][q]) + A[2][p] * A[2][q];
      if (!(gamma * gamma > kOrthoTol2 * alpha * beta)) continue;
      rotated = true;
      const double zeta = (beta - alpha) / (2.0 * gamma);
      const double tt =
          copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + tt * tt);
      const double s = c * tt;
      for (int a = 0; a < 3; ++a) {
        const double ap = A[a][p], aq = A[a][q];
        A[a][p] = c * ap - s * aq;
        A[a][q] = s * ap + c * aq;
        const double vp = V[a][p], vq = V[a][q];
        V[a][p] = c * vp - s * vq;
        V[a][q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
  double sig[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    sig[c] = sqrt((A[0][c] * A[0][c] + A[1][c] * A[1][c]) + A[2][c] * A[2][c]);
  // a stable sort, largest first: s1 >= s2 >= s3 of columns o1, o2, o3
  double s1 = sig[0], s2 = sig[1], s3 = sig[2];
  int o1 = 0, o2 = 1, o3 = 2;
  swap_if(s2 > s1, s1, s2, o1, o2);
  swap_if(s3 > s2, s2, s3, o2, o3);
  swap_if(s2 > s1, s1, s2, o1, o2);
  double u1[3], u2[3], u3[3], a2[3], v[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    u1[a] = s1 > 0.0 ? pick3(A[a], o1) / s1 : (a == 0 ? 1.0 : 0.0);
    a2[a] = pick3(A[a], o2);
    v[0][a] = pick3(V[a], o1);
    v[1][a] = pick3(V[a], o2);
    v[2][a] = pick3(V[a], o3);
  }
  const double k2 = dot3(u1, a2);
  double r[3];
  for (int a = 0; a < 3; ++a) r[a] = a2[a] - k2 * u1[a];
  const double rho = sqrt(dot3(r, r));
  if (rho > kRankTol * s1) {
    for (int a = 0; a < 3; ++a) u2[a] = r[a] / rho;
  } else {
    int ax = 0;
    double least = fabs(u1[0]);
#pragma unroll
    for (int a = 1; a < 3; ++a)
      if (fabs(u1[a]) < least) {
        ax = a;
        least = fabs(u1[a]);
      }
    const double ua = pick3(u1, ax);
    double f[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) f[a] = (a == ax ? 1.0 : 0.0) - ua * u1[a];
    const double fn = sqrt(dot3(f, f));
    for (int a = 0; a < 3; ++a) u2[a] = f[a] / fn;
  }
  cross3(u1, u2, u3);
  double c23[3];
  cross3(v[1], v[2], c23);
  const double det = dot3(v[0], c23);
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c)
      R[3 * a + c] = (v[0][a] * u1[c] + v[1][a] * u2[c]) +
                     (det * v[2][a]) * u3[c];
  for (int a = 0; a < 3; ++a)
    t[a] = mu_d[a] - ((R[3 * a] * mu_s[0] + R[3 * a + 1] * mu_s[1]) +
                      R[3 * a + 2] * mu_s[2]);
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const float* __restrict__ src, const float4* __restrict__ tgt4,
              const float* __restrict__ d2, const int32_t* __restrict__ idx,
              float* __restrict__ rt, double* __restrict__ stats, int I,
              int N, int M, float thr) {
  __shared__ double red[kWarps][kSums];
  const long long s = blockIdx.x;
  const long long b = s / I;
  const float* sp = src + b * N * 3;
  const float4* tp = tgt4 + b * M;
  const float* dp = d2 + s * N;
  const int32_t* ip = idx + s * N;
  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
#pragma unroll 4
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const int j = ip[n];
    const bool in = __fsqrt_rn(dp[n]) < thr && j >= 0 && j < M;
    const int jj = in ? j : 0;
    // a non-inlier's inputs are selected to +0, so its terms are +0
    const double sv[3] = {in ? sp[3 * n] : 0.f, in ? sp[3 * n + 1] : 0.f,
                          in ? sp[3 * n + 2] : 0.f};
    const float4 q = __ldg(tp + jj);
    const double dv[3] = {in ? q.x : 0.f, in ? q.y : 0.f, in ? q.z : 0.f};
    acc[0] += in ? 1.0 : 0.0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      acc[1 + a] += sv[a];
      acc[4 + a] += dv[a];
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[7 + 3 * a + c] += sv[a] * dv[c];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < kSums; ++k)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < kSums; ++k) red[warp][k] = acc[k];
  __syncthreads();
  if (threadIdx.x != 0) return;
  double m[kSums];
  for (int k = 0; k < kSums; ++k) {
    double v = red[0][k];
    for (int w = 1; w < kWarps; ++w) v += red[w][k];
    m[k] = v;
  }
  double R[9], t[3];
  solve3(m, R, t);
  if (stats) {
    double* st = stats + s * kStats;
    for (int k = 0; k < kSums; ++k) st[k] = m[k];
    for (int k = 0; k < 9; ++k) st[kSums + k] = R[k];
    for (int k = 0; k < 3; ++k) st[kSums + 9 + k] = t[k];
  }
  if (m[0] >= kMinInliers) {
    float* o = rt + s * 12;
    for (int k = 0; k < 9; ++k) o[k] = __double2float_rn(R[k]);
    for (int k = 0; k < 3; ++k) o[9 + k] = __double2float_rn(t[k]);
  }
}

}  // namespace

extern "C" {

// src (B, N, 3), rt (B I, 12) -> moved (B I, N, 3), all f32; rt 16-byte
// aligned (the wrapper checks).  cudaErrorInvalidValue for shapes outside
// the kernel's bounds, else the launch's error.
int icp_transform_f32(const void* src, const void* rt, void* moved, int B,
                      int I, int N, void* stream) {
  if (B <= 0 || B > 65535 || I <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  transform_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(rt),
      static_cast<float*>(moved), I, N);
  return (int)cudaGetLastError();
}

// One ICP update of the B I sets, in place on rt (B I, 12): src (B, N, 3),
// tgt4 (B, M, 4), d2 (B I, N) f32, idx (B I, N) int32, inliers sqrt(d2) <
// thr.  stats (B I, kStats) f64 or null: the moments and the f64 R, t.
int icp_update_f32(const void* src, const void* tgt4, const void* d2,
                   const void* idx, void* rt, void* stats, int B, int I,
                   int N, int M, float thr, void* stream) {
  if (B <= 0 || I <= 0 || N <= 0 || M <= 0 ||
      (long long)B * I > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  update_kernel<<<B * I, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float4*>(tgt4),
      static_cast<const float*>(d2), static_cast<const int32_t*>(idx),
      static_cast<float*>(rt), static_cast<double*>(stats), I, N, M, thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
