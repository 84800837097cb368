// Whole multi-init Levenberg-Marquardt solve of the frustum registration
// cost, 2-D mode (theta = [ry, tx, ty, tz], P = 4), f32.
//
// Replaces: deepi2p_tpu/register/frustum_pallas.py::lm_solve_pallas
// (`_kernel` :240-330 with `_tile_terms` :65-143 and `_chol_solve`
// :207-237; wrapper :336-401) in its P=4 mode.  Same iterates: theta0 box-
// clipped, lambda from 1e-3, one sweep over the points per iteration at the
// proposal accumulating the upper-triangular normal matrix H (weights
// w = val / (1 + |r|^2)), the gradient g and the cost
// sum 0.5 log1p(|r|^2) val; damped Cholesky with A_ii (1 + lambda) + 1e-9
// and sqrt clamped at 1e-20; a step is taken only if the cost drops
// strictly, else the carried H and g stay; lambda /3 or *3 within
// [1e-9, 1e9]; translation box-clipped after each step.  The Pallas
// kernel's zero-padded point tail (N not a multiple of 1024) has no
// counterpart here: the loop visits exactly N points, which is what the
// XLA solver (`frustum_fast.lm_solve_fast`) computes as well.
//
// What bounds it on the H100: the points of one pair (N x 5 floats, at
// most a few hundred KB) are read once per sweep by every init of that
// pair and stay in L2, so device memory moves only ~5N floats per pair.
// The work is ~150 f32 operations per point per init per sweep (see
// LM_OPS_PER_POINT in register/frustum_cuda.py), (max_iter + 1) sweeps:
// operations bound by a wide margin.
//
// Design: one block of 256 threads per (pair, init), B*I blocks.  Threads
// stride over the points and keep the 15 sums (10 H terms, 4 g terms, the
// cost) in registers; a warp-shuffle butterfly and a shared-memory pass
// over the 8 warps combine them.  Thread 0 holds the LM state, does the
// 4x4 Cholesky, the accept/reject and the lambda update, and broadcasts
// the next proposal through shared memory.  Loop counts are fixed
// (max_iter) and every __syncthreads() sits outside any branch, so all
// threads reach each one.  The order of every sum is fixed as well, and
// the plain PyTorch version (`lm_solve_plain`) repeats it; with FMA
// contraction off (the build's -fmad=false) the two agree to rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 15;  // H00 H01 H02 H03 H11 H12 H13 H22 H23 H33 g0..g3 cost

struct Cam {
  float fx, fy, cx, cy, H1, W1;
};

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// max and clip that keep a NaN, as jnp.maximum / jnp.clip and
// torch.maximum / torch.clamp do (fmaxf would drop it: a NaN proposal then
// scores residual 0 and can be accepted)
__device__ __forceinline__ float maxn(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clipn(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// The 15 per-point contributions at theta (c = cos ry, s = sin ry).
__device__ __forceinline__ void point_terms(const float th[4], float c,
                                            float s, float x, float y,
                                            float z, float lab, float val,
                                            const Cam& k, float out[kQ]) {
  const float tx = th[1], ty = th[2], tz = th[3];
  const float p0 = c * x + s * z + tx;
  const float p1 = y + ty;
  const float p2 = (-s) * x + c * z + tz;
  const float inv_z = 1.0f / p2;
  const float px = k.fx * p0 * inv_z + k.cx;
  const float py = k.fy * p1 * inv_z + k.cy;
  const float a = k.fx * inv_z;
  const float b = k.fy * inv_z;
  const float u = p0 * inv_z;
  const float v = p1 * inv_z;
  const float dry0 = p2 - tz;
  const float dry2 = -(p0 - tx);
  const float dpx0 = a * (dry0 - u * dry2);
  const float dpx3 = (-a) * u;
  const float dpy0 = b * ((-v) * dry2);
  const float dpy3 = (-b) * v;

  const float r0_in = maxn(-px, 0.0f) + maxn(px - k.W1, 0.0f);
  const float s0 = (px < 0.0f ? -1.0f : 0.0f) + (px > k.W1 ? 1.0f : 0.0f);
  const float r1_in = maxn(-py, 0.0f) + maxn(py - k.H1, 0.0f);
  const float s1 = (py < 0.0f ? -1.0f : 0.0f) + (py > k.H1 ? 1.0f : 0.0f);
  const float r2_in = maxn(-p2, 0.0f) * 100.0f;
  const float s2 = p2 < 0.0f ? -100.0f : 0.0f;

  const float hw = k.W1 * 0.5f, hh = k.H1 * 0.5f;
  const float xd = hw - fabsf(px - hw);
  const float yd = hh - fabsf(py - hh);
  const float gate = (p2 > 0.0f && xd > 0.0f && yd > 0.0f) ? 1.0f : 0.0f;
  const float r_out = (xd + yd) * gate;
  const float sxd = (-sgn(px - hw)) * gate;
  const float syd = (-sgn(py - hh)) * gate;

  const bool in = lab > 0.5f;
  const float r0 = in ? r0_in : r_out;
  const float r1 = in ? r1_in : 0.0f;
  const float r2 = in ? r2_in : 0.0f;

  const float J00 = in ? s0 * dpx0 : sxd * dpx0 + syd * dpy0;
  const float J01 = in ? s0 * a : sxd * a;
  const float J02 = in ? 0.0f : syd * b;
  const float J03 = in ? s0 * dpx3 : sxd * dpx3 + syd * dpy3;
  const float J10 = in ? s1 * dpy0 : 0.0f;
  const float J12 = in ? s1 * b : 0.0f;
  const float J13 = in ? s1 * dpy3 : 0.0f;
  const float J20 = in ? s2 * dry2 : 0.0f;
  const float J23 = in ? s2 : 0.0f;

  const float sb = r0 * r0 + r1 * r1 + r2 * r2;
  const float w = val / (1.0f + sb);
  out[0] = w * (J00 * J00 + J10 * J10 + J20 * J20);
  out[1] = w * (J00 * J01);
  out[2] = w * (J00 * J02 + J10 * J12);
  out[3] = w * (J00 * J03 + J10 * J13 + J20 * J23);
  out[4] = w * (J01 * J01);
  out[5] = w * (J01 * J02);
  out[6] = w * (J01 * J03);
  out[7] = w * (J02 * J02 + J12 * J12);
  out[8] = w * (J02 * J03 + J12 * J13);
  out[9] = w * (J03 * J03 + J13 * J13 + J23 * J23);
  out[10] = w * (J00 * r0 + J10 * r1 + J20 * r2);
  out[11] = w * (J01 * r0);
  out[12] = w * (J02 * r0 + J12 * r1);
  out[13] = w * (J03 * r0 + J13 * r1 + J23 * r2);
  out[14] = 0.5f * log1pf(sb) * val;
}

// One sweep at the theta in shared memory; thread 0 gets the 15 totals.
// Contains one __syncthreads(), reached by all threads.
__device__ void sweep(const float* __restrict__ pts,
                      const float* __restrict__ lab,
                      const float* __restrict__ val, int N, const Cam& k,
                      const float* s_theta, float (*s_part)[kQ],
                      float tot[kQ]) {
  const float th[4] = {s_theta[0], s_theta[1], s_theta[2], s_theta[3]};
  const float c = cosf(th[0]), s = sinf(th[0]);
  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.0f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float t[kQ];
    point_terms(th, c, s, pts[3 * n], pts[3 * n + 1], pts[3 * n + 2], lab[n],
                val[n], k, t);
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[q] = acc[q] + t[q];
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      acc[q] = acc[q] + __shfl_xor_sync(0xffffffffu, acc[q], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) s_part[warp][q] = acc[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      float v = s_part[0][q];
      for (int w = 1; w < kWarps; ++w) v = v + s_part[w][q];
      tot[q] = v;
    }
  }
}

// Index of the upper-triangular term (i, j), i <= j, in the order H00 H01
// H02 H03 H11 H12 H13 H22 H23 H33.
__device__ __forceinline__ constexpr int U(int i, int j) {
  return i * 4 - i * (i - 1) / 2 + (j - i);
}

// Damped Cholesky solve of (H + damping) x = g; H as the 10 upper terms.
__device__ __forceinline__ void chol_solve(const float* H, const float* g,
                                           float lam, float x[4]) {
  float A[10];
#pragma unroll
  for (int q = 0; q < 10; ++q) A[q] = H[q];
#pragma unroll
  for (int i = 0; i < 4; ++i) A[U(i, i)] = A[U(i, i)] * (1.0f + lam) + 1e-9f;
  float L[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[U(j, i)];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(maxn(s, 1e-20f)) : s / L[j][j];
    }
  }
  float yv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * yv[k];
    yv[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    float s = yv[i];
#pragma unroll
    for (int k = i + 1; k < 4; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

__global__ void __launch_bounds__(kThreads)
lm_p4_kernel(const float* __restrict__ pts, const float* __restrict__ labels,
             const float* __restrict__ valid,
             const float* __restrict__ kparams,
             const float* __restrict__ theta0, float* __restrict__ theta_out,
             float* __restrict__ cost_out, int N, int I, int max_iter,
             float H1, float W1, float lb0, float lb1, float lb2, float ub0,
             float ub1, float ub2) {
  __shared__ float s_theta[4];
  __shared__ float s_part[kWarps][kQ];
  const int i = blockIdx.x, b = blockIdx.y;
  const float* P = pts + (size_t)b * N * 3;
  const float* lab = labels + (size_t)b * N;
  const float* val = valid + (size_t)b * N;
  const Cam k{kparams[4 * b + 0], kparams[4 * b + 1], kparams[4 * b + 2],
              kparams[4 * b + 3], H1, W1};
  const float lb[3] = {lb0, lb1, lb2}, ub[3] = {ub0, ub1, ub2};

  // LM state, meaningful in thread 0 only
  float theta[4], Hm[10], g[4], cost = 0.0f, lam = 1e-3f;
  float tot[kQ];
  if (threadIdx.x == 0) {
    const float* t0 = theta0 + ((size_t)b * I + i) * 4;
    theta[0] = t0[0];
    for (int q = 0; q < 3; ++q) theta[1 + q] = clipn(t0[1 + q], lb[q], ub[q]);
    for (int q = 0; q < 4; ++q) s_theta[q] = theta[q];
  }
  __syncthreads();
  sweep(P, lab, val, N, k, s_theta, s_part, tot);
  if (threadIdx.x == 0) {
    for (int q = 0; q < 10; ++q) Hm[q] = tot[q];
    for (int q = 0; q < 4; ++q) g[q] = tot[10 + q];
    cost = tot[14];
  }

  for (int it = 0; it < max_iter; ++it) {
    float prop[4];
    if (threadIdx.x == 0) {
      float delta[4];
      chol_solve(Hm, g, lam, delta);
      prop[0] = theta[0] - delta[0];
      for (int q = 0; q < 3; ++q)
        prop[1 + q] = clipn(theta[1 + q] - delta[1 + q], lb[q], ub[q]);
      for (int q = 0; q < 4; ++q) s_theta[q] = prop[q];
    }
    __syncthreads();
    sweep(P, lab, val, N, k, s_theta, s_part, tot);
    if (threadIdx.x == 0) {
      const bool accept = tot[14] < cost;
      if (accept) {
        for (int q = 0; q < 4; ++q) theta[q] = prop[q];
        for (int q = 0; q < 10; ++q) Hm[q] = tot[q];
        for (int q = 0; q < 4; ++q) g[q] = tot[10 + q];
        cost = tot[14];
      }
      lam = fminf(fmaxf(accept ? lam / 3.0f : lam * 3.0f, 1e-9f), 1e9f);
    }
  }
  if (threadIdx.x == 0) {
    float* to = theta_out + ((size_t)b * I + i) * 4;
    for (int q = 0; q < 4; ++q) to[q] = theta[q];
    cost_out[(size_t)b * I + i] = cost;
  }
}

}  // namespace

extern "C" int lm_solve_p4_f32(const void* pts, const void* labels,
                               const void* valid, const void* kparams,
                               const void* theta0, void* theta_out,
                               void* cost_out, int B, int N, int I,
                               int max_iter, float H1, float W1, float lb0,
                               float lb1, float lb2, float ub0, float ub1,
                               float ub2, void* stream) {
  if (B <= 0 || N <= 0 || I <= 0 || B > 65535 || max_iter < 0) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(I, B);
  lm_p4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(labels),
      static_cast<const float*>(valid), static_cast<const float*>(kparams),
      static_cast<const float*>(theta0), static_cast<float*>(theta_out),
      static_cast<float*>(cost_out), N, I, max_iter, H1, W1, lb0, lb1, lb2,
      ub0, ub1, ub2);
  return (int)cudaGetLastError();
}
