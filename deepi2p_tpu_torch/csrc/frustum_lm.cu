// Whole multi-init Levenberg-Marquardt solve of the frustum registration
// cost, f32, in two modes: 2-D (theta = [ry, tx, ty, tz], P = 4) and 6-DoF
// (theta = [rx, ry, rz, tx, ty, tz], angle-axis, P = 6).
//
// Replaces: deepi2p_tpu/register/frustum_pallas.py::lm_solve_pallas
// (`_kernel` :240-330 with `_tile_terms` :65-143, `_tile_terms_3d`
// :170-200, `_rot_entries` :144-167, `_residual_rows` :39-62 and
// `_chol_solve` :207-237; wrapper :336-401) in both its modes.  Same iterates: theta0 box-
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
// The 6-DoF mode follows the Pallas 6-DoF path: the residual rows carry
// the point's valid factor, and the Jacobian, which the Pallas kernel gets
// from jax.linearize, is derived by hand (register/frustum_cuda.py's
// docstring has the derivation): R and the three dR/dr_j depend on theta
// only, so thread 0 computes them once per (init, sweep) into shared
// memory (rot6), and each point needs dp/dr_j = (dR/dr_j) x and
// dp/dt_j = e_j.
//
// What bounds it on the H100: the points of one pair (N x 5 floats, at
// most a few hundred KB) are read once per sweep by every init of that
// pair and stay in L2, so device memory moves only ~5N floats per pair.
// The work is ~150 (P = 4) or ~430 (P = 6) f32 operations per point per
// init per sweep (LM_OPS_PER_POINT and LM6_OPS_PER_POINT in
// register/frustum_cuda.py), (max_iter + 1) sweeps: operations bound by a
// wide margin.
//
// Design: one block of 256 threads per (pair, init), B*I blocks.  Threads
// stride over the points and keep the P(P+1)/2 + P + 1 sums (H terms, g
// terms, the cost: 15 or 28) in registers; a warp-shuffle butterfly and a
// shared-memory pass over the 8 warps combine them.  Thread 0 holds the LM
// state, does the PxP Cholesky, the accept/reject and the lambda update,
// and broadcasts the next proposal through shared memory.  Loop counts are fixed
// (max_iter) and every __syncthreads() sits outside any branch, so all
// threads reach each one.  The order of every sum is fixed as well, and
// the plain PyTorch version (`lm_solve_plain`) repeats it; with FMA
// contraction off (the build's -fmad=false) the two agree to rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// number of sums of a sweep: the upper H terms (row by row, H00 H01 ...),
// the g terms, the cost
template <int P>
__host__ __device__ constexpr int num_terms() {
  return P * (P + 1) / 2 + P + 1;
}
constexpr int kRot = 36;  // P = 6: R (9, row-major), then dR/dr_j (3 x 9)

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

// The 15 per-point contributions at theta, 2-D mode (c = cos ry,
// s = sin ry).
__device__ __forceinline__ void point_terms4(const float th[4], float c,
                                             float s, float x, float y,
                                             float z, float lab, float val,
                                             const Cam& k, float out[15]) {
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
  const bool on = p2 > 0.0f && xd > 0.0f && yd > 0.0f;
  const float gate = on ? 1.0f : 0.0f;
  const float r_out = on ? xd + yd : 0.0f;  // a select: 0, not NaN, at p2 = 0
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

// Residual hinges, their signs and the outside gate of a projected point
// (6-DoF mode; the 2-D mode has the same expressions inline above).
struct Parts {
  float r0_in, s0, r1_in, s1, r2_in, s2, r_out, sxd, syd;
  bool on;  // the outside gate
};

__device__ __forceinline__ Parts residual_parts(float px, float py, float p2,
                                                const Cam& k) {
  Parts q;
  q.r0_in = maxn(-px, 0.0f) + maxn(px - k.W1, 0.0f);
  q.s0 = (px < 0.0f ? -1.0f : 0.0f) + (px > k.W1 ? 1.0f : 0.0f);
  q.r1_in = maxn(-py, 0.0f) + maxn(py - k.H1, 0.0f);
  q.s1 = (py < 0.0f ? -1.0f : 0.0f) + (py > k.H1 ? 1.0f : 0.0f);
  q.r2_in = maxn(-p2, 0.0f) * 100.0f;
  q.s2 = p2 < 0.0f ? -100.0f : 0.0f;
  const float hw = k.W1 * 0.5f, hh = k.H1 * 0.5f;
  const float xd = hw - fabsf(px - hw);
  const float yd = hh - fabsf(py - hh);
  q.on = p2 > 0.0f && xd > 0.0f && yd > 0.0f;
  const float gate = q.on ? 1.0f : 0.0f;
  q.r_out = q.on ? xd + yd : 0.0f;
  q.sxd = (-sgn(px - hw)) * gate;
  q.syd = (-sgn(py - hh)) * gate;
  return q;
}

// Entry (a, b) of [v]x.
__device__ __forceinline__ float skew(const float v[3], int a, int b) {
  if (a == 0) return b == 1 ? -v[2] : v[1];
  if (a == 1) return b == 0 ? v[2] : -v[0];
  return b == 0 ? -v[1] : v[0];
}

// R (row-major) and dR/dr_j (j = 0..2) of the angle-axis r, into out[36]:
// the arithmetic of the plain version's _rot6, expression for expression.
__device__ void rot6(const float r[3], float* out) {
  const float t2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const float th = sqrtf(t2 + 1e-24f);
  const float s = sinf(th), c = cosf(th);
  const float k[3] = {r[0] / th, r[1] / th, r[2] / th};
  const float oc = 1.0f - c;
  const bool big = t2 > 1e-16f;
  const float Rb[9] = {c + k[0] * k[0] * oc, k[0] * k[1] * oc - k[2] * s,
                       k[0] * k[2] * oc + k[1] * s,
                       k[1] * k[0] * oc + k[2] * s, c + k[1] * k[1] * oc,
                       k[1] * k[2] * oc - k[0] * s,
                       k[2] * k[0] * oc - k[1] * s,
                       k[2] * k[1] * oc + k[0] * s, c + k[2] * k[2] * oc};
  const float Rs[9] = {1.0f, -r[2], r[1], r[2], 1.0f, -r[0],
                       -r[1], r[0], 1.0f};
  for (int q = 0; q < 9; ++q) out[q] = big ? Rb[q] : Rs[q];
  for (int j = 0; j < 3; ++j) {
    const float dth = r[j] / th;
    float dk[3];
    for (int i = 0; i < 3; ++i)
      dk[i] = ((i == j ? 1.0f : 0.0f) - k[i] * k[j]) / th;
    const float dc = -(s * dth);
    const float doc = s * dth;
    const float ds = c * dth;
    float ej[3] = {0.0f, 0.0f, 0.0f};
    ej[j] = 1.0f;
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) {
        float v = doc * (k[a] * k[b]) + oc * (dk[a] * k[b] + k[a] * dk[b]);
        float small;
        if (a == b) {
          v = dc + v;
          small = 0.0f;
        } else {
          v = v + (ds * skew(k, a, b) + s * skew(dk, a, b));
          small = skew(ej, a, b);
        }
        out[9 + 9 * j + 3 * a + b] = big ? v : small;
      }
    }
  }
}

// The 28 per-point contributions at theta, 6-DoF mode; rot holds R and
// dR/dr_j of theta's rotation, t its translation.
__device__ __forceinline__ void point_terms6(const float* rot,
                                             const float t[3], float x,
                                             float y, float z, float lab,
                                             float val, const Cam& k,
                                             float out[28]) {
  const float* R = rot;
  const float p0 = R[0] * x + R[1] * y + R[2] * z + t[0];
  const float p1 = R[3] * x + R[4] * y + R[5] * z + t[1];
  const float p2 = R[6] * x + R[7] * y + R[8] * z + t[2];
  const float inv_z = 1.0f / p2;
  const float px = k.fx * p0 * inv_z + k.cx;
  const float py = k.fy * p1 * inv_z + k.cy;
  const float a = k.fx * inv_z;
  const float b = k.fy * inv_z;
  const float u = p0 * inv_z;
  const float v = p1 * inv_z;
  float dpx[6], dpy[6], dz[6];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* D = rot + 9 + 9 * j;
    const float q0 = D[0] * x + D[1] * y + D[2] * z;
    const float q1 = D[3] * x + D[4] * y + D[5] * z;
    const float q2 = D[6] * x + D[7] * y + D[8] * z;
    dpx[j] = a * (q0 - u * q2);
    dpy[j] = b * (q1 - v * q2);
    dz[j] = q2;
  }
  dpx[3] = a;
  dpy[3] = 0.0f;
  dz[3] = 0.0f;
  dpx[4] = 0.0f;
  dpy[4] = b;
  dz[4] = 0.0f;
  dpx[5] = (-a) * u;
  dpy[5] = (-b) * v;
  dz[5] = 1.0f;

  const Parts q = residual_parts(px, py, p2, k);
  const bool in = lab > 0.5f;
  const float r0 = (in ? q.r0_in : q.r_out) * val;
  const float r1 = (in ? q.r1_in : 0.0f) * val;
  const float r2 = (in ? q.r2_in : 0.0f) * val;
  float J0[6], J1[6], J2[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    J0[j] = (in ? q.s0 * dpx[j]
                : (q.on ? q.sxd * dpx[j] + q.syd * dpy[j] : 0.0f)) * val;
    J1[j] = (in ? q.s1 * dpy[j] : 0.0f) * val;
    J2[j] = (in ? q.s2 * dz[j] : 0.0f) * val;
  }
  const float sb = r0 * r0 + r1 * r1 + r2 * r2;
  const float w = val / (1.0f + sb);
  int o = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j)
      out[o++] = w * (J0[i] * J0[j] + J1[i] * J1[j] + J2[i] * J2[j]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    out[21 + i] = w * (J0[i] * r0 + J1[i] * r1 + J2[i] * r2);
  out[27] = 0.5f * log1pf(sb) * val;
}

// One sweep at the theta in shared memory (and, for P = 6, its rotation
// in s_rot); thread 0 gets the totals.  Contains one __syncthreads(),
// reached by all threads.
template <int P>
__device__ void sweep(const float* __restrict__ pts,
                      const float* __restrict__ lab,
                      const float* __restrict__ val, int N, const Cam& k,
                      const float* s_theta, const float* s_rot,
                      float (*s_part)[num_terms<P>()],
                      float tot[num_terms<P>()]) {
  constexpr int kQ = num_terms<P>();
  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.0f;
  if constexpr (P == 4) {
    const float th[4] = {s_theta[0], s_theta[1], s_theta[2], s_theta[3]};
    const float c = cosf(th[0]), s = sinf(th[0]);
    for (int n = threadIdx.x; n < N; n += kThreads) {
      float t[kQ];
      point_terms4(th, c, s, pts[3 * n], pts[3 * n + 1], pts[3 * n + 2],
                   lab[n], val[n], k, t);
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[q] = acc[q] + t[q];
    }
  } else {
    float rot[kRot];
#pragma unroll
    for (int q = 0; q < kRot; ++q) rot[q] = s_rot[q];
    const float tr[3] = {s_theta[3], s_theta[4], s_theta[5]};
    for (int n = threadIdx.x; n < N; n += kThreads) {
      float t[kQ];
      point_terms6(rot, tr, pts[3 * n], pts[3 * n + 1], pts[3 * n + 2],
                   lab[n], val[n], k, t);
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[q] = acc[q] + t[q];
    }
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

// Index of the upper-triangular term (i, j), i <= j, row by row (H00 H01
// ... H0P H11 ...).
template <int P>
__device__ __forceinline__ constexpr int U(int i, int j) {
  return i * P - i * (i - 1) / 2 + (j - i);
}

// Damped Cholesky solve of (H + damping) x = g; H as the upper terms.
template <int P>
__device__ __forceinline__ void chol_solve(const float* H, const float* g,
                                           float lam, float x[P]) {
  constexpr int kH = P * (P + 1) / 2;
  float A[kH];
#pragma unroll
  for (int q = 0; q < kH; ++q) A[q] = H[q];
#pragma unroll
  for (int i = 0; i < P; ++i)
    A[U<P>(i, i)] = A[U<P>(i, i)] * (1.0f + lam) + 1e-9f;
  float L[P][P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[U<P>(j, i)];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(maxn(s, 1e-20f)) : s / L[j][j];
    }
  }
  float yv[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * yv[k];
    yv[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    float s = yv[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
lm_kernel(const float* __restrict__ pts, const float* __restrict__ labels,
          const float* __restrict__ valid, const float* __restrict__ kparams,
          const float* __restrict__ theta0, float* __restrict__ theta_out,
          float* __restrict__ cost_out, int N, int I, int max_iter, float H1,
          float W1, float lb0, float lb1, float lb2, float ub0, float ub1,
          float ub2) {
  constexpr int kQ = num_terms<P>();
  constexpr int kH = P * (P + 1) / 2;
  constexpr int t_off = P - 3;
  __shared__ float s_theta[P];
  __shared__ float s_rot[kRot];
  __shared__ float s_part[kWarps][kQ];
  const int i = blockIdx.x, b = blockIdx.y;
  const float* Pp = pts + (size_t)b * N * 3;
  const float* lab = labels + (size_t)b * N;
  const float* val = valid + (size_t)b * N;
  const Cam k{kparams[4 * b + 0], kparams[4 * b + 1], kparams[4 * b + 2],
              kparams[4 * b + 3], H1, W1};
  const float lb[3] = {lb0, lb1, lb2}, ub[3] = {ub0, ub1, ub2};

  // LM state, meaningful in thread 0 only
  float theta[P], Hm[kH], g[P], cost = 0.0f, lam = 1e-3f;
  float tot[kQ];
  if (threadIdx.x == 0) {
    const float* t0 = theta0 + ((size_t)b * I + i) * P;
    for (int q = 0; q < t_off; ++q) theta[q] = t0[q];
    for (int q = 0; q < 3; ++q)
      theta[t_off + q] = clipn(t0[t_off + q], lb[q], ub[q]);
    for (int q = 0; q < P; ++q) s_theta[q] = theta[q];
    if constexpr (P == 6) rot6(theta, s_rot);
  }
  __syncthreads();
  sweep<P>(Pp, lab, val, N, k, s_theta, s_rot, s_part, tot);
  if (threadIdx.x == 0) {
    for (int q = 0; q < kH; ++q) Hm[q] = tot[q];
    for (int q = 0; q < P; ++q) g[q] = tot[kH + q];
    cost = tot[kQ - 1];
  }

  for (int it = 0; it < max_iter; ++it) {
    float prop[P];
    if (threadIdx.x == 0) {
      float delta[P];
      chol_solve<P>(Hm, g, lam, delta);
      for (int q = 0; q < t_off; ++q) prop[q] = theta[q] - delta[q];
      for (int q = 0; q < 3; ++q)
        prop[t_off + q] =
            clipn(theta[t_off + q] - delta[t_off + q], lb[q], ub[q]);
      for (int q = 0; q < P; ++q) s_theta[q] = prop[q];
      if constexpr (P == 6) rot6(prop, s_rot);
    }
    __syncthreads();
    sweep<P>(Pp, lab, val, N, k, s_theta, s_rot, s_part, tot);
    if (threadIdx.x == 0) {
      const bool accept = tot[kQ - 1] < cost;
      if (accept) {
        for (int q = 0; q < P; ++q) theta[q] = prop[q];
        for (int q = 0; q < kH; ++q) Hm[q] = tot[q];
        for (int q = 0; q < P; ++q) g[q] = tot[kH + q];
        cost = tot[kQ - 1];
      }
      lam = fminf(fmaxf(accept ? lam / 3.0f : lam * 3.0f, 1e-9f), 1e9f);
    }
  }
  if (threadIdx.x == 0) {
    float* to = theta_out + ((size_t)b * I + i) * P;
    for (int q = 0; q < P; ++q) to[q] = theta[q];
    cost_out[(size_t)b * I + i] = cost;
  }
}

template <int P>
int launch_lm(const void* pts, const void* labels, const void* valid,
              const void* kparams, const void* theta0, void* theta_out,
              void* cost_out, int B, int N, int I, int max_iter, float H1,
              float W1, float lb0, float lb1, float lb2, float ub0, float ub1,
              float ub2, void* stream) {
  if (B <= 0 || N <= 0 || I <= 0 || B > 65535 || max_iter < 0) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(I, B);
  lm_kernel<P><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(labels),
      static_cast<const float*>(valid), static_cast<const float*>(kparams),
      static_cast<const float*>(theta0), static_cast<float*>(theta_out),
      static_cast<float*>(cost_out), N, I, max_iter, H1, W1, lb0, lb1, lb2,
      ub0, ub1, ub2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lm_solve_p4_f32(const void* pts, const void* labels,
                               const void* valid, const void* kparams,
                               const void* theta0, void* theta_out,
                               void* cost_out, int B, int N, int I,
                               int max_iter, float H1, float W1, float lb0,
                               float lb1, float lb2, float ub0, float ub1,
                               float ub2, void* stream) {
  return launch_lm<4>(pts, labels, valid, kparams, theta0, theta_out,
                      cost_out, B, N, I, max_iter, H1, W1, lb0, lb1, lb2,
                      ub0, ub1, ub2, stream);
}

extern "C" int lm_solve_p6_f32(const void* pts, const void* labels,
                               const void* valid, const void* kparams,
                               const void* theta0, void* theta_out,
                               void* cost_out, int B, int N, int I,
                               int max_iter, float H1, float W1, float lb0,
                               float lb1, float lb2, float ub0, float ub1,
                               float ub2, void* stream) {
  return launch_lm<6>(pts, labels, valid, kparams, theta0, theta_out,
                      cost_out, B, N, I, max_iter, H1, W1, lb0, lb1, lb2,
                      ub0, ub1, ub2, stream);
}
