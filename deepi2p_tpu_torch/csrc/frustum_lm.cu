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
// most a few hundred KB) are needed once per sweep by every init of that
// pair, so device memory moves only ~5N floats per pair.  The work is ~150
// (P = 4) or ~430 (P = 6) f32 operations per point per init per sweep
// (LM_OPS_PER_POINT and LM6_OPS_PER_POINT in register/frustum_cuda.py),
// (max_iter + 1) sweeps: operations bound by a wide margin.  With
// contraction off (the build's -fmad=false, which lets the plain version
// repeat the rounding) every operation is one instruction, so ~2x the
// bound, which counts an FMA as two, is the floor of this arithmetic.
//
// Design, P = 4 (lm_p4_kernel, the main path's mode): one thread-block
// cluster per (pair, group of G <= 8 inits), C blocks of G x W warps.
// The first design (one 256-thread block per (pair, init)) streamed every
// point from L2 once per init and sweep as 12-byte AoS loads, evaluated
// both labels' rows for every point, and idled 255 threads while thread 0
// combined the warps and ran the Cholesky.  Here:
// * each block copies its points into shared memory once per launch, each
//   warp's slice with its inside-labelled points first, so that a warp
//   evaluates only one label's rows (point_terms4<1> or <0>), about 190
//   instructions per point instead of 260;
// * each init's points are cut into C W virtual slices, one per warp of
//   the init in the cluster, and the partial sums meet through
//   distributed shared memory after one cluster barrier per sweep; every
//   warp then runs its init's Cholesky in all its lanes;
// * the wrapper picks C, G and W (lm_p4_plan) for an even spread, and the
//   slice size S and the residency (lm_p4_layout), which this file only
//   checks: the H100 places clusters of 4 or 8 blocks on only 124 of its
//   132 SMs, and the per-sweep barrier makes every cluster wait for its
//   busiest SM, so the main path's refine runs one 16-warp block per SM
//   in clusters of 2;
// * the last sweep of a solve sums the cost alone: no step uses its H and
//   g.
// The sum order: each lane's points of its slice in turn, the butterfly
// over the 32 lanes, then the C W slices in order; the plain version
// repeats it, the label partition included.
//
// Design, P = 6 (lm_p6_kernel): one block of 256 threads per (pair, init),
// B*I blocks.  Threads stride over the points and keep the 28 sums (H
// terms, g terms, the cost) in registers; a warp-shuffle butterfly and a
// shared-memory pass over the 8 warps combine them.  Thread 0 holds the LM
// state, does the 6x6 Cholesky, the accept/reject and the lambda update,
// and broadcasts the next proposal through shared memory.  Loop counts are
// fixed (max_iter) and every __syncthreads() sits outside any branch, so
// all threads reach each one.  The order of every sum is fixed as well, and
// the plain PyTorch version (`lm_solve_plain`) repeats it; with FMA
// contraction off the two agree to rounding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the 6-DoF sweep's sums: the 21 upper H terms (row by row, H00 H01 ...),
// the 6 g terms, the cost
constexpr int kH6 = 21;
constexpr int kQ6 = kH6 + 6 + 1;
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
// max(x, 0) that keeps a NaN (as NaN), in one instruction (sm_80 and up)
__device__ __forceinline__ float relu_n(float x) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float clipn(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// The 15 per-point contributions at theta, 2-D mode (c = cos ry,
// s = sin ry), for a point whose label is known to be inside (LAB = 1) or
// outside (LAB = 0), or is read at run time (LAB = 2).  LAB = 1 is the
// general expression with `in` fixed, so the compiler drops the outside
// rows and nothing else.  LAB = 0 writes the outside rows out: the rows r1,
// r2 and J1., J2. are exactly 0 there, so every product with them is +0,
// and the terms leave out those "+ 0"s.  That can only turn a -0 term into
// +0 or back, which no sum notices: the sums start at +0 and are never -0,
// and x + (+0) = x + (-0) = x for every such x (NaN and inf included).  So
// the sums over points are bitwise those of the general expression, which
// the plain version evaluates.
template <int LAB>
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

  const float hw = k.W1 * 0.5f, hh = k.H1 * 0.5f;
  if constexpr (LAB == 0) {
    const float xd = hw - fabsf(px - hw);
    const float yd = hh - fabsf(py - hh);
    const bool on = p2 > 0.0f && xd > 0.0f && yd > 0.0f;
    const float gate = on ? 1.0f : 0.0f;
    const float r0 = on ? xd + yd : 0.0f;  // a select: 0, not NaN, at p2 = 0
    const float sxd = (-sgn(px - hw)) * gate;
    const float syd = (-sgn(py - hh)) * gate;
    const float J00 = sxd * dpx0 + syd * dpy0;
    const float J01 = sxd * a;
    const float J02 = syd * b;
    const float J03 = sxd * dpx3 + syd * dpy3;
    const float sb = r0 * r0;
    const float w = val / (1.0f + sb);
    out[0] = w * (J00 * J00);
    out[1] = w * (J00 * J01);
    out[2] = w * (J00 * J02);
    out[3] = w * (J00 * J03);
    out[4] = w * (J01 * J01);
    out[5] = w * (J01 * J02);
    out[6] = w * (J01 * J03);
    out[7] = w * (J02 * J02);
    out[8] = w * (J02 * J03);
    out[9] = w * (J03 * J03);
    out[10] = w * (J00 * r0);
    out[11] = w * (J01 * r0);
    out[12] = w * (J02 * r0);
    out[13] = w * (J03 * r0);
    out[14] = 0.5f * log1pf(sb) * val;
  } else {
    // the signs as (x > hi) - (x < 0): each +-1 or +0, the same values as
    // the plain version's (x < 0 ? -1 : 0) + (x > hi ? 1 : 0)
    const float r0_in = relu_n(-px) + relu_n(px - k.W1);
    const float s0 = (px > k.W1 ? 1.0f : 0.0f) - (px < 0.0f ? 1.0f : 0.0f);
    const float r1_in = relu_n(-py) + relu_n(py - k.H1);
    const float s1 = (py > k.H1 ? 1.0f : 0.0f) - (py < 0.0f ? 1.0f : 0.0f);
    const float r2_in = relu_n(-p2) * 100.0f;
    const float s2 = p2 < 0.0f ? -100.0f : 0.0f;

    float r_out = 0.0f, sxd = 0.0f, syd = 0.0f;
    if constexpr (LAB == 2) {
      const float xd = hw - fabsf(px - hw);
      const float yd = hh - fabsf(py - hh);
      const bool on = p2 > 0.0f && xd > 0.0f && yd > 0.0f;
      const float gate = on ? 1.0f : 0.0f;
      r_out = on ? xd + yd : 0.0f;  // a select: 0, not NaN, at p2 = 0
      sxd = (-sgn(px - hw)) * gate;
      syd = (-sgn(py - hh)) * gate;
    }

    const bool in = LAB == 1 || lab > 0.5f;
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
}

// The cost term alone (out[14] of point_terms4<LAB>, the same arithmetic):
// the last sweep of a solve needs no H and g, since no step follows it.
template <int LAB>
__device__ __forceinline__ float point_cost4(const float th[4], float c,
                                             float s, float x, float y,
                                             float z, float lab, float val,
                                             const Cam& k) {
  const float p0 = c * x + s * z + th[1];
  const float p1 = y + th[2];
  const float p2 = (-s) * x + c * z + th[3];
  const float inv_z = 1.0f / p2;
  const float px = k.fx * p0 * inv_z + k.cx;
  const float py = k.fy * p1 * inv_z + k.cy;
  float sb;
  const bool in = LAB == 1 || (LAB == 2 && lab > 0.5f);
  if (in) {
    const float r0 = relu_n(-px) + relu_n(px - k.W1);
    const float r1 = relu_n(-py) + relu_n(py - k.H1);
    const float r2 = relu_n(-p2) * 100.0f;
    sb = r0 * r0 + r1 * r1 + r2 * r2;
  } else {
    const float hw = k.W1 * 0.5f, hh = k.H1 * 0.5f;
    const float xd = hw - fabsf(px - hw);
    const float yd = hh - fabsf(py - hh);
    const bool on = p2 > 0.0f && xd > 0.0f && yd > 0.0f;
    const float r0 = on ? xd + yd : 0.0f;
    sb = r0 * r0;  // the general sum's "+ 0 * 0 + 0 * 0" leaves it as is
  }
  return 0.5f * log1pf(sb) * val;
}

// Add one point to the sweep's sums: all 15 (FULL) or the cost alone.
template <int LAB, bool FULL>
__device__ __forceinline__ void add_point4(const float th[4], float c,
                                           float s, float x, float y,
                                           float z, float lab, float val,
                                           const Cam& k, float acc[15]) {
  if constexpr (FULL) {
    float t[15];
    point_terms4<LAB>(th, c, s, x, y, z, lab, val, k, t);
#pragma unroll
    for (int q = 0; q < 15; ++q) acc[q] = acc[q] + t[q];
  } else {
    acc[14] = acc[14] + point_cost4<LAB>(th, c, s, x, y, z, lab, val, k);
  }
}

// A warp's points of one sweep: from shared memory, each slice's
// inside-labelled points first (RESIDENT), two of the lane's points per
// step so that their work overlaps (added in index order); or from device
// memory in index order.
template <bool RESIDENT, bool FULL>
__device__ __forceinline__ void sweep_points4(
    const float th[4], float c, float s, const Cam& k, int lane, int len,
    const float4* my_pts, const float* my_lab, const float* Pp,
    const float* lab, const float* val, int v0, float acc[15]) {
  if constexpr (RESIDENT) {
    int p = lane;
    for (; p + 32 < len; p += 64) {
      const float4 r1 = my_pts[p], r2 = my_pts[p + 32];
      if (my_lab[p] > 0.5f) {
        add_point4<1, FULL>(th, c, s, r1.x, r1.y, r1.z, 1.0f, r1.w, k, acc);
      } else {
        add_point4<0, FULL>(th, c, s, r1.x, r1.y, r1.z, 0.0f, r1.w, k, acc);
      }
      if (my_lab[p + 32] > 0.5f) {
        add_point4<1, FULL>(th, c, s, r2.x, r2.y, r2.z, 1.0f, r2.w, k, acc);
      } else {
        add_point4<0, FULL>(th, c, s, r2.x, r2.y, r2.z, 0.0f, r2.w, k, acc);
      }
    }
    for (; p < len; p += 32) {
      const float4 r = my_pts[p];
      if (my_lab[p] > 0.5f) {
        add_point4<1, FULL>(th, c, s, r.x, r.y, r.z, 1.0f, r.w, k, acc);
      } else {
        add_point4<0, FULL>(th, c, s, r.x, r.y, r.z, 0.0f, r.w, k, acc);
      }
    }
  } else {
    for (int p = v0 + lane; p < v0 + len; p += 32) {
      add_point4<2, FULL>(th, c, s, Pp[3 * p], Pp[3 * p + 1], Pp[3 * p + 2],
                          lab[p], val[p], k, acc);
    }
  }
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

// One 6-DoF sweep at the theta in shared memory and its rotation in
// s_rot; thread 0 gets the totals.  Contains one __syncthreads(), reached
// by all threads.
__device__ void sweep6(const float* __restrict__ pts,
                       const float* __restrict__ lab,
                       const float* __restrict__ val, int N, const Cam& k,
                       const float* s_theta, const float* s_rot,
                       float (*s_part)[kQ6], float tot[kQ6]) {
  float acc[kQ6];
#pragma unroll
  for (int q = 0; q < kQ6; ++q) acc[q] = 0.0f;
  float rot[kRot];
#pragma unroll
  for (int q = 0; q < kRot; ++q) rot[q] = s_rot[q];
  const float tr[3] = {s_theta[3], s_theta[4], s_theta[5]};
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float t[kQ6];
    point_terms6(rot, tr, pts[3 * n], pts[3 * n + 1], pts[3 * n + 2],
                 lab[n], val[n], k, t);
#pragma unroll
    for (int q = 0; q < kQ6; ++q) acc[q] = acc[q] + t[q];
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
    for (int q = 0; q < kQ6; ++q)
      acc[q] = acc[q] + __shfl_xor_sync(0xffffffffu, acc[q], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kQ6; ++q) s_part[warp][q] = acc[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < kQ6; ++q) {
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

__global__ void __launch_bounds__(kThreads)
lm_p6_kernel(const float* __restrict__ pts, const float* __restrict__ labels,
             const float* __restrict__ valid,
             const float* __restrict__ kparams,
             const float* __restrict__ theta0, float* __restrict__ theta_out,
             float* __restrict__ cost_out, int N, int I, int max_iter,
             float H1, float W1, float lb0, float lb1, float lb2, float ub0,
             float ub1, float ub2) {
  __shared__ float s_theta[6];
  __shared__ float s_rot[kRot];
  __shared__ float s_part[kWarps][kQ6];
  const int i = blockIdx.x, b = blockIdx.y;
  const float* Pp = pts + (size_t)b * N * 3;
  const float* lab = labels + (size_t)b * N;
  const float* val = valid + (size_t)b * N;
  const Cam k{kparams[4 * b + 0], kparams[4 * b + 1], kparams[4 * b + 2],
              kparams[4 * b + 3], H1, W1};
  const float lb[3] = {lb0, lb1, lb2}, ub[3] = {ub0, ub1, ub2};

  // LM state, meaningful in thread 0 only; theta = [r (3), t (3)]
  float theta[6], Hm[kH6], g[6], cost = 0.0f, lam = 1e-3f;
  float tot[kQ6];
  if (threadIdx.x == 0) {
    const float* t0 = theta0 + ((size_t)b * I + i) * 6;
    for (int q = 0; q < 3; ++q) theta[q] = t0[q];
    for (int q = 0; q < 3; ++q) theta[3 + q] = clipn(t0[3 + q], lb[q], ub[q]);
    for (int q = 0; q < 6; ++q) s_theta[q] = theta[q];
    rot6(theta, s_rot);
  }
  __syncthreads();
  sweep6(Pp, lab, val, N, k, s_theta, s_rot, s_part, tot);
  if (threadIdx.x == 0) {
    for (int q = 0; q < kH6; ++q) Hm[q] = tot[q];
    for (int q = 0; q < 6; ++q) g[q] = tot[kH6 + q];
    cost = tot[kQ6 - 1];
  }

  for (int it = 0; it < max_iter; ++it) {
    float prop[6];
    if (threadIdx.x == 0) {
      float delta[6];
      chol_solve<6>(Hm, g, lam, delta);
      for (int q = 0; q < 3; ++q) prop[q] = theta[q] - delta[q];
      for (int q = 0; q < 3; ++q)
        prop[3 + q] = clipn(theta[3 + q] - delta[3 + q], lb[q], ub[q]);
      for (int q = 0; q < 6; ++q) s_theta[q] = prop[q];
      rot6(prop, s_rot);
    }
    __syncthreads();
    sweep6(Pp, lab, val, N, k, s_theta, s_rot, s_part, tot);
    if (threadIdx.x == 0) {
      const bool accept = tot[kQ6 - 1] < cost;
      if (accept) {
        for (int q = 0; q < 6; ++q) theta[q] = prop[q];
        for (int q = 0; q < kH6; ++q) Hm[q] = tot[q];
        for (int q = 0; q < 6; ++q) g[q] = tot[kH6 + q];
        cost = tot[kQ6 - 1];
      }
      lam = fminf(fmaxf(accept ? lam / 3.0f : lam * 3.0f, 1e-9f), 1e9f);
    }
  }
  if (threadIdx.x == 0) {
    float* to = theta_out + ((size_t)b * I + i) * 6;
    for (int q = 0; q < 6; ++q) to[q] = theta[q];
    cost_out[(size_t)b * I + i] = cost;
  }
}

// ---------------------------------------------------------------------------
// The 2-D mode (P = 4).  Warp (g, w) of block r of a cluster sweeps virtual
// slice r W + w (S points; the last slices short or empty) for init
// group * G + g.  Each warp's butterfly leaves its 15 partial sums in
// shared memory; after one cluster barrier every warp sums the C W
// partials of its init in slice order (its own block's through shared
// memory, the others' through distributed shared memory), so all warps of
// an init hold the same totals and compute the same proposal.  The
// partials are double buffered by sweep parity, so one barrier per sweep
// suffices: a block writes a buffer again two sweeps later, after the
// barrier that every block reaches only once it has read that buffer.
// RESIDENT (the wrapper's choice; a block's W S points then fit
// kP4MaxTile): the points live in shared memory as float4 rows (x, y, z, valid) beside the labels, each
// slice partitioned by label; otherwise the warps read them from device
// memory in index order and evaluate the label at run time.
constexpr int kP4MaxWarps = 16;     // G x W per block
constexpr int kP4MaxCluster = 8;    // blocks per cluster (portable limit)
constexpr int kP4MaxTile = 5120;    // most points a block keeps in shared memory
constexpr int kQ4 = 15;
constexpr int kP4RowBytes = 20;     // float4 row + label

// One warp copies points [off, off + n) into s_pts / s_lab, inside-labelled
// points first, each group in index order.
__device__ __forceinline__ void stage_partitioned(
    const float* __restrict__ Pp, const float* __restrict__ lab,
    const float* __restrict__ val, int off, int n, float4* s_pts,
    float* s_lab) {
  const int lane = threadIdx.x & 31;
  int n_in = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int t = c0 + lane;
    n_in += __popc(__ballot_sync(0xffffffffu, t < n && lab[off + t] > 0.5f));
  }
  int next_in = 0, next_out = n_in;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int t = c0 + lane;
    const bool live = t < n;
    const float l = live ? lab[off + t] : 0.0f;
    const bool in = live && l > 0.5f;
    const unsigned ball = __ballot_sync(0xffffffffu, in);
    const int before = __popc(ball & ((1u << lane) - 1u));
    if (live) {
      const int q = in ? next_in + before : next_out + (lane - before);
      const int pnt = off + t;
      s_pts[q] = make_float4(Pp[3 * pnt], Pp[3 * pnt + 1], Pp[3 * pnt + 2],
                             val[pnt]);
      s_lab[q] = l;
    }
    const int k_in = __popc(ball);
    next_in += k_in;
    next_out += min(32, n - c0) - k_in;
  }
}

template <bool RESIDENT>
__global__ void __launch_bounds__(kP4MaxWarps * 32)
lm_p4_kernel(const float* __restrict__ pts, const float* __restrict__ labels,
             const float* __restrict__ valid,
             const float* __restrict__ kparams,
             const float* __restrict__ theta0, float* __restrict__ theta_out,
             float* __restrict__ cost_out, int N, int I, int max_iter,
             float H1, float W1, float lb0, float lb1, float lb2, float ub0,
             float ub1, float ub2, int C, int G, int W, int S) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 s_pts[];                 // W S rows, W S labels
  __shared__ float s_part[2][kP4MaxWarps][16];      // 15 used
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / C, b = blockIdx.y;
  const int x = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = x / W, w = x - g * W;
  const int i_own = group * G + g;                  // >= I: a spare warp
  const int i = min(i_own, I - 1);
  const float* Pp = pts + (size_t)b * N * 3;
  const float* lab = labels + (size_t)b * N;
  const float* val = valid + (size_t)b * N;
  const Cam k{kparams[4 * b + 0], kparams[4 * b + 1], kparams[4 * b + 2],
              kparams[4 * b + 3], H1, W1};
  const float lb[3] = {lb0, lb1, lb2}, ub[3] = {ub0, ub1, ub2};
  // this warp's virtual slice
  const int v0 = min((rank * W + w) * S, N);
  const int len = min(v0 + S, N) - v0;
  float* s_lab = reinterpret_cast<float*>(s_pts + W * S);
  const float4* my_pts = s_pts + w * S;
  const float* my_lab = s_lab + w * S;
  if constexpr (RESIDENT) {
    if (x < W) {
      const int o = min((rank * W + x) * S, N);
      stage_partitioned(Pp, lab, val, o, min(o + S, N) - o, s_pts + x * S,
                        s_lab + x * S);
    }
    __syncthreads();
  }

  int buf = 0;
  float theta[4], Hm[10], g4[4], cost, lam = 1e-3f, tot[kQ4];
  const float* t0 = theta0 + ((size_t)b * I + i) * 4;
  theta[0] = t0[0];
#pragma unroll
  for (int q = 0; q < 3; ++q) theta[1 + q] = clipn(t0[1 + q], lb[q], ub[q]);
  float prop[4] = {theta[0], theta[1], theta[2], theta[3]};

  // sweep 0 at theta, then one sweep per iteration at the proposal (the
  // last one sums the cost alone: no step uses its H and g); every
  // barrier is reached by all threads of the cluster (the loop bounds
  // depend on the block only)
  for (int it = 0; it <= max_iter; ++it) {
    float acc[kQ4];
#pragma unroll
    for (int q = 0; q < kQ4; ++q) acc[q] = 0.0f;
    const float c = cosf(prop[0]), s = sinf(prop[0]);
    if (it < max_iter) {
      sweep_points4<RESIDENT, true>(prop, c, s, k, lane, len, my_pts,
                                    my_lab, Pp, lab, val, v0, acc);
    } else {
      sweep_points4<RESIDENT, false>(prop, c, s, k, lane, len, my_pts,
                                     my_lab, Pp, lab, val, v0, acc);
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
      for (int q = 0; q < kQ4; ++q)
        acc[q] = acc[q] + __shfl_xor_sync(0xffffffffu, acc[q], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kQ4; ++q) s_part[buf][x][q] = acc[q];
    }
    cluster.sync();
    float sum = 0.0f;
    if (lane < kQ4) {
      for (int rr = 0; rr < C; ++rr) {
        const float* part =
            cluster.map_shared_rank(&s_part[buf][g * W][0], rr);
        for (int ww = 0; ww < W; ++ww) {
          const float pv = part[16 * ww + lane];
          sum = (rr == 0 && ww == 0) ? pv : sum + pv;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQ4; ++q) tot[q] = __shfl_sync(0xffffffffu, sum, q);
    buf ^= 1;

    if (it == 0) {
#pragma unroll
      for (int q = 0; q < 10; ++q) Hm[q] = tot[q];
#pragma unroll
      for (int q = 0; q < 4; ++q) g4[q] = tot[10 + q];
      cost = tot[14];
    } else {
      const bool accept = tot[14] < cost;
      if (accept) {
#pragma unroll
        for (int q = 0; q < 4; ++q) theta[q] = prop[q];
#pragma unroll
        for (int q = 0; q < 10; ++q) Hm[q] = tot[q];
#pragma unroll
        for (int q = 0; q < 4; ++q) g4[q] = tot[10 + q];
        cost = tot[14];
      }
      lam = fminf(fmaxf(accept ? lam / 3.0f : lam * 3.0f, 1e-9f), 1e9f);
    }
    if (it < max_iter) {
      float delta[4];
      chol_solve<4>(Hm, g4, lam, delta);
      prop[0] = theta[0] - delta[0];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        prop[1 + q] = clipn(theta[1 + q] - delta[1 + q], lb[q], ub[q]);
    }
  }
  if (lane == 0 && rank == 0 && w == 0 && i_own < I) {
    float* to = theta_out + ((size_t)b * I + i_own) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) to[q] = theta[q];
    cost_out[(size_t)b * I + i_own] = cost;
  }
  cluster.sync();  // no block leaves while another may read its partials
}

template <bool RESIDENT>
int launch_lm_p4(const float* pts, const float* labels, const float* valid,
                 const float* kparams, const float* theta0, float* theta_out,
                 float* cost_out, int B, int N, int I, int max_iter,
                 float H1, float W1, float lb0, float lb1, float lb2,
                 float ub0, float ub1, float ub2, int C, int G, int W, int S,
                 cudaStream_t stream) {
  const size_t smem = RESIDENT ? (size_t)W * S * kP4RowBytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      lm_p4_kernel<RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kP4MaxTile * kP4RowBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((I + G - 1) / G * C, B, 1);
  cfg.blockDim = dim3(32 * G * W, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lm_p4_kernel<RESIDENT>, pts, labels, valid,
                           kparams, theta0, theta_out, cost_out, N, I,
                           max_iter, H1, W1, lb0, lb1, lb2, ub0, ub1, ub2, C,
                           G, W, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The launch's layout comes from the wrapper
// (register/frustum_cuda.py::lm_p4_plan and lm_p4_layout), which owns it:
// C blocks per cluster, G inits per block, W warps per init, S points per
// virtual slice, and whether a block keeps its W S points in shared memory
// (resident).  The sum order depends on C W, S and resident, and the plain
// version repeats it from the same layout; here they are only checked.
extern "C" int lm_solve_p4_f32(const void* pts, const void* labels,
                               const void* valid, const void* kparams,
                               const void* theta0, void* theta_out,
                               void* cost_out, int B, int N, int I,
                               int max_iter, float H1, float W1, float lb0,
                               float lb1, float lb2, float ub0, float ub1,
                               float ub2, int C, int G, int W, int S,
                               int resident, void* stream) {
  if (B <= 0 || N <= 0 || I <= 0 || B > 65535 || max_iter < 0 || C < 1 ||
      C > kP4MaxCluster || G < 1 || W < 1 || G * W > kP4MaxWarps ||
      S < 32 || S % 32 != 0 || (long long)S * C * W < N ||
      (resident && W * S > kP4MaxTile)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* P = static_cast<const float*>(pts);
  const float* L = static_cast<const float*>(labels);
  const float* V = static_cast<const float*>(valid);
  const float* Kp = static_cast<const float*>(kparams);
  const float* T0 = static_cast<const float*>(theta0);
  float* TO = static_cast<float*>(theta_out);
  float* CO = static_cast<float*>(cost_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (resident) {
    return launch_lm_p4<true>(P, L, V, Kp, T0, TO, CO, B, N, I, max_iter, H1,
                              W1, lb0, lb1, lb2, ub0, ub1, ub2, C, G, W, S,
                              st);
  }
  return launch_lm_p4<false>(P, L, V, Kp, T0, TO, CO, B, N, I, max_iter, H1,
                             W1, lb0, lb1, lb2, ub0, ub1, ub2, C, G, W, S,
                             st);
}

// The resident P = 4 kernel's registers per thread, static shared memory,
// local (spill) memory per thread in bytes and the most threads per block,
// into out[0..3].
extern "C" int lm_p4_func_attrs(void* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, lm_p4_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  int* o = static_cast<int*>(out);
  o[0] = a.numRegs;
  o[1] = (int)a.sharedSizeBytes;
  o[2] = (int)a.localSizeBytes;
  o[3] = a.maxThreadsPerBlock;
  return 0;
}

extern "C" int lm_solve_p6_f32(const void* pts, const void* labels,
                               const void* valid, const void* kparams,
                               const void* theta0, void* theta_out,
                               void* cost_out, int B, int N, int I,
                               int max_iter, float H1, float W1, float lb0,
                               float lb1, float lb2, float ub0, float ub1,
                               float ub2, void* stream) {
  if (B <= 0 || N <= 0 || I <= 0 || B > 65535 || max_iter < 0) {
    return (int)cudaErrorInvalidValue;
  }
  lm_p6_kernel<<<dim3(I, B), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(labels),
      static_cast<const float*>(valid), static_cast<const float*>(kparams),
      static_cast<const float*>(theta0), static_cast<float*>(theta_out),
      static_cast<float*>(cost_out), N, I, max_iter, H1, W1, lb0, lb1, lb2,
      ub0, ub1, ub2);
  return (int)cudaGetLastError();
}
