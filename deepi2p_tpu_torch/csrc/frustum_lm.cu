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
// [1e-9, 1e9]; translation box-clipped after each step.  One departure: a
// theta that is not finite costs NaN here, so such a step is never taken;
// the Pallas kernel takes a NaN step (from a NaN H: an outside-labelled
// point at exactly p2 = 0) where no point of the launch is labelled
// inside, since every residual at it is then 0.  The Pallas
// kernel's zero-padded point tail (N not a multiple of 1024) has no
// counterpart here: the loop visits exactly N points, which is what the
// XLA solver (`frustum_fast.lm_solve_fast`) computes as well.
//
// The 6-DoF mode follows the Pallas 6-DoF path: the residual rows carry
// the point's valid factor, and the Jacobian, which the Pallas kernel gets
// from jax.linearize, is derived by hand (register/frustum_cuda.py's
// docstring has the derivation): R and the three dR/dr_j depend on theta
// only, so they are computed once per (init, sweep) (rot6), and each point
// needs dp/dr_j = (dR/dr_j) x and dp/dt_j = e_j.
//
// What bounds it on the H100: the points of one pair (N x 5 floats, at
// most a few hundred KB) are needed once per sweep by every init of that
// pair, so device memory moves only ~5N floats per pair.  The work per
// point, init and sweep is 134 (P = 4) or 350 (P = 6) f32 operations for
// an inside-labelled point, 102 or 222 for an outside one, and 30-47 in
// the cost-only last sweep (LM_OPS in register/frustum_cuda.py), over
// max_iter + 1 sweeps: operations bound by a wide margin.  With
// contraction off (the build's -fmad=false, which lets the plain version
// repeat the rounding) every operation is one instruction, so ~2x the
// bound, which counts an FMA as two, is the floor of this arithmetic.
//
// Design, both modes (one kernel body, lm_kernel<P>): one thread-block
// cluster per (pair, group of G <= 8 inits), C blocks of G x W warps.
// The first design (one 256-thread block per (pair, init)) streamed every
// point from L2 once per init and sweep as 12-byte AoS loads, evaluated
// both labels' rows for every point, and idled 255 threads while thread 0
// combined the warps, ran the rotation (P = 6) and the Cholesky.  Here:
// * each block copies its points into shared memory once per launch, each
//   warp's slice with its inside-labelled points first, so that a warp
//   evaluates only one label's rows (point_terms4<1> or <0>,
//   add_point6<1> or <0>): an outside-labelled point has one residual row,
//   so in the 6-DoF mode its H terms are single products;
// * each init's points are cut into C W virtual slices, one per warp of
//   the init in the cluster, and the partial sums meet through
//   distributed shared memory after one cluster barrier per sweep
//   (cluster_sum); every warp then runs its init's rotation and Cholesky
//   in all its lanes;
// * the wrapper picks C, G and W (lm_plan) for an even spread, and the
//   slice size S and the residency (lm_layout), which this file only
//   checks: the H100 places clusters of 4 or 8 blocks on only 124 of its
//   132 SMs, and the per-sweep barrier makes every cluster wait for its
//   busiest SM, so the main path's launches run in clusters of 2.  A
//   6-DoF lane holds 28 running sums and the rotation's 36 terms, so its
//   blocks have at most 8 warps (the 2-D mode's 16);
// * the last sweep of a solve sums the cost alone: no step uses its H and
//   g;
// * the H and g of the last accepted sweep stay in registers (P = 4) or
//   in the warp's row of shared memory (P = 6, Carried<P>).
// The sum order: each lane's points of its slice in turn, the butterfly
// over the 32 lanes, then the C W slices in order; the plain version
// repeats it, the label partition included.  The order of every sum is
// fixed, loop counts are fixed (max_iter), and every barrier is reached
// by all threads of the cluster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

namespace cg = cooperative_groups;

// Both modes: clusters of at most kLmMaxCluster blocks (the portable
// limit); a block keeps at most kLmMaxTile points in shared memory, as
// float4 rows (x, y, z, valid) beside the labels.
constexpr int kLmMaxCluster = 8;
constexpr int kLmMaxTile = 5120;
constexpr int kLmRowBytes = 20;
constexpr int kP4MaxWarps = 16;     // G x W per block, P = 4
constexpr int kQ4 = 15;             // the 2-D sweep's sums
constexpr int kP6MaxWarps = 8;      // G x W per block, P = 6
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
// neither NaN nor +-inf
__device__ __forceinline__ bool finite_f32(float x) {
  return fabsf(x) <= 3.402823466e38f;
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

// Entry (a, b) of [v]x.
__device__ __forceinline__ float skew(const float v[3], int a, int b) {
  if (a == 0) return b == 1 ? -v[2] : v[1];
  if (a == 1) return b == 0 ? v[2] : -v[0];
  return b == 0 ? -v[1] : v[0];
}

// R (row-major) and dR/dr_j (j = 0..2) of the angle-axis r: the
// arithmetic of the plain version's _rot6, expression for expression.
__device__ __forceinline__ void rot6(const float r[3], float (&out)[kRot]) {
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
#pragma unroll
  for (int q = 0; q < 9; ++q) out[q] = big ? Rb[q] : Rs[q];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float dth = r[j] / th;
    float dk[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      dk[i] = ((i == j ? 1.0f : 0.0f) - k[i] * k[j]) / th;
    const float dc = -(s * dth);
    const float doc = s * dth;
    const float ds = c * dth;
    float ej[3] = {0.0f, 0.0f, 0.0f};
    ej[j] = 1.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
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

// Add one point to the 6-DoF sweep's 28 sums (FULL) or to the cost alone,
// for a point labelled inside (LAB = 1) or outside (LAB = 0); rot holds R
// and dR/dr_j of theta's rotation, t its translation.  LAB = 1 is the
// general expression with the label fixed (no product is left out: a
// structural zero such as dpx[4] may meet an inf at p2 = 0, and the NaN
// that gives must stay).  LAB = 0 has one residual row, r0 = r_out val:
// the outside rows r1, r2 and J1., J2. are exactly 0 (the plain version
// makes them so), so the H terms are w J0i J0j and the g terms w J0i r0;
// J0_3 and J0_4 leave out the products with dpy[3] = 0 and dpx[4] = 0 of
// finite signs.  What is left out is a +-0 term, which can only turn a -0
// point term into +0 or back; the sums start at +0 and are never -0, and
// x + (+0) = x + (-0) = x for every other x (NaN and inf included), so
// the sums are bitwise those of the general expression.
template <int LAB, bool FULL>
__device__ __forceinline__ void add_point6(const float (&rot)[kRot],
                                           const float (&t)[3], float x,
                                           float y, float z, float val,
                                           const Cam& k, float (&acc)[kQ6]) {
  const float p0 = rot[0] * x + rot[1] * y + rot[2] * z + t[0];
  const float p1 = rot[3] * x + rot[4] * y + rot[5] * z + t[1];
  const float p2 = rot[6] * x + rot[7] * y + rot[8] * z + t[2];
  const float inv_z = 1.0f / p2;
  const float px = k.fx * p0 * inv_z + k.cx;
  const float py = k.fy * p1 * inv_z + k.cy;
  float sb;
  if constexpr (LAB == 1) {
    const float r0 = (relu_n(-px) + relu_n(px - k.W1)) * val;
    const float r1 = (relu_n(-py) + relu_n(py - k.H1)) * val;
    const float r2 = (relu_n(-p2) * 100.0f) * val;
    sb = r0 * r0 + r1 * r1 + r2 * r2;
    if constexpr (FULL) {
      const float s0 = (px < 0.0f ? -1.0f : 0.0f) + (px > k.W1 ? 1.0f : 0.0f);
      const float s1 = (py < 0.0f ? -1.0f : 0.0f) + (py > k.H1 ? 1.0f : 0.0f);
      const float s2 = p2 < 0.0f ? -100.0f : 0.0f;
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
      float J0[6], J1[6], J2[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        J0[j] = (s0 * dpx[j]) * val;
        J1[j] = (s1 * dpy[j]) * val;
        J2[j] = (s2 * dz[j]) * val;
      }
      const float w = val / (1.0f + sb);
      int o = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j, ++o)
          acc[o] = acc[o] + w * (J0[i] * J0[j] + J1[i] * J1[j] + J2[i] * J2[j]);
      }
#pragma unroll
      for (int i = 0; i < 6; ++i)
        acc[kH6 + i] = acc[kH6 + i] + w * (J0[i] * r0 + J1[i] * r1 + J2[i] * r2);
    }
  } else {
    const float hw = k.W1 * 0.5f, hh = k.H1 * 0.5f;
    const float xd = hw - fabsf(px - hw);
    const float yd = hh - fabsf(py - hh);
    const bool on = p2 > 0.0f && xd > 0.0f && yd > 0.0f;
    const float r0 = (on ? xd + yd : 0.0f) * val;  // a select: 0 at p2 = 0
    sb = r0 * r0;
    if constexpr (FULL) {
      // the gate is 1 wherever these are used
      const float sxd = -sgn(px - hw), syd = -sgn(py - hh);
      const float a = k.fx * inv_z;
      const float b = k.fy * inv_z;
      const float u = p0 * inv_z;
      const float v = p1 * inv_z;
      float J0[6];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float* D = rot + 9 + 9 * j;
        const float q0 = D[0] * x + D[1] * y + D[2] * z;
        const float q1 = D[3] * x + D[4] * y + D[5] * z;
        const float q2 = D[6] * x + D[7] * y + D[8] * z;
        const float dpx = a * (q0 - u * q2);
        const float dpy = b * (q1 - v * q2);
        J0[j] = (on ? sxd * dpx + syd * dpy : 0.0f) * val;
      }
      J0[3] = (on ? sxd * a : 0.0f) * val;
      J0[4] = (on ? syd * b : 0.0f) * val;
      J0[5] = (on ? sxd * ((-a) * u) + syd * ((-b) * v) : 0.0f) * val;
      const float w = val / (1.0f + sb);
      int o = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j, ++o) acc[o] = acc[o] + w * (J0[i] * J0[j]);
      }
#pragma unroll
      for (int i = 0; i < 6; ++i)
        acc[kH6 + i] = acc[kH6 + i] + w * (J0[i] * r0);
    }
  }
  acc[kQ6 - 1] = acc[kQ6 - 1] + 0.5f * log1pf(sb) * val;
}

// A warp's points of one 6-DoF sweep: from shared memory, where its slice
// holds the inside-labelled points first, so that one loop runs the
// inside terms and a second the outside ones, each lane's points still in
// index order; or from device memory in index order, the label read per
// point.
template <bool RESIDENT, bool FULL>
__device__ __forceinline__ void sweep_points6(
    const float (&rot)[kRot], const float (&t)[3], const Cam& k, int lane,
    int len, const float4* my_pts, const float* my_lab, const float* Pp,
    const float* lab, const float* val, int v0, float (&acc)[kQ6]) {
  if constexpr (RESIDENT) {
    int p = lane;
    for (; p < len && my_lab[p] > 0.5f; p += 32) {
      const float4 r = my_pts[p];
      add_point6<1, FULL>(rot, t, r.x, r.y, r.z, r.w, k, acc);
    }
    for (; p < len; p += 32) {
      const float4 r = my_pts[p];
      add_point6<0, FULL>(rot, t, r.x, r.y, r.z, r.w, k, acc);
    }
  } else {
    for (int p = v0 + lane; p < v0 + len; p += 32) {
      const float x = Pp[3 * p], y = Pp[3 * p + 1], z = Pp[3 * p + 2];
      if (lab[p] > 0.5f) {
        add_point6<1, FULL>(rot, t, x, y, z, val[p], k, acc);
      } else {
        add_point6<0, FULL>(rot, t, x, y, z, val[p], k, acc);
      }
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

// ---------------------------------------------------------------------------
// The cluster layout, both modes.  Warp (g, w) of block r of a cluster
// sweeps virtual slice r W + w (S points; the last slices short or empty)
// for init group * G + g.  Each warp's butterfly leaves its partial sums in
// shared memory; after one cluster barrier every warp sums the C W
// partials of its init in slice order (its own block's through shared
// memory, the others' through distributed shared memory), so all warps of
// an init hold the same totals and compute the same proposal.  The
// partials are double buffered by sweep parity, so one barrier per sweep
// suffices: a block writes a buffer again two sweeps later, after the
// barrier that every block reaches only once it has read that buffer.
// RESIDENT (the wrapper's choice; a block's W S points then fit
// kLmMaxTile): the points live in shared memory as float4 rows (x, y, z,
// valid) beside the labels, each slice partitioned by label; otherwise the
// warps read them from device memory in index order and evaluate the label
// at run time.

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

// The butterfly of a warp's KQ partial sums over its lanes into row x of
// this sweep's partials (rows of STRIDE floats), one cluster barrier, then
// the sums of rows first .. first + W - 1 of every block of the cluster in
// slice order: lane q < KQ returns term q's total over the init's C W
// slices (the other lanes 0).
template <int KQ, int STRIDE>
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* part, int x, int first,
                                             int C, int W, int lane,
                                             float (&acc)[KQ]) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
    for (int q = 0; q < KQ; ++q)
      acc[q] = acc[q] + __shfl_xor_sync(0xffffffffu, acc[q], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < KQ; ++q) part[STRIDE * x + q] = acc[q];
  }
  cluster.sync();
  float sum = 0.0f;
  if (lane < KQ) {
    for (int rr = 0; rr < C; ++rr) {
      const float* pr = cluster.map_shared_rank(part + STRIDE * first, rr);
      for (int ww = 0; ww < W; ++ww) {
        const float pv = pr[STRIDE * ww + lane];
        sum = (rr == 0 && ww == 0) ? pv : sum + pv;
      }
    }
  }
  return sum;
}

// The mode's sums: the upper H terms, then the P g terms and the cost.
// A block has at most kMaxWarps warps; kStride is the row stride of the
// warps' partial sums in shared memory.
template <int P>
struct Mode;
template <>
struct Mode<4> {
  static constexpr int kH = 10, kQ = kQ4, kMaxWarps = kP4MaxWarps,
                       kStride = 16;
};
template <>
struct Mode<6> {
  static constexpr int kH = kH6, kQ = kQ6, kMaxWarps = kP6MaxWarps,
                       kStride = 32;
};

// The H and g of the last accepted sweep, which the damped solves after
// a rejected step reuse.  P = 4: in registers.  P = 6: in this warp's row
// of shared memory, since a 6-DoF lane already holds the 28 running sums
// and the rotation's 36 terms.  Every lane of the warp calls keep() (the
// accept is the same in all of them); lane q holds term q's total.
template <int P>
struct Carried;
template <>
struct Carried<4> {
  float hg[kQ4 - 1];
  __device__ explicit Carried(float*) {}
  __device__ __forceinline__ void keep(float sum, int) {
#pragma unroll
    for (int q = 0; q < kQ4 - 1; ++q) hg[q] = __shfl_sync(0xffffffffu, sum, q);
  }
  __device__ __forceinline__ const float* H() const { return hg; }
};
template <>
struct Carried<6> {
  float* hg;
  __device__ explicit Carried(float* row) : hg(row) {}
  __device__ __forceinline__ void keep(float sum, int lane) {
    if (lane < kQ6 - 1) hg[lane] = sum;
    __syncwarp();
  }
  __device__ __forceinline__ const float* H() const { return hg; }
};

// One sweep of mode P at theta: the rotation's terms (cos and sin of ry,
// or R and dR/dr_j), then the warp's points into acc (all sums, or the
// cost alone).
template <int P, bool RESIDENT, bool FULL>
__device__ __forceinline__ void sweep(const float (&th)[P], const Cam& k,
                                      int lane, int len, const float4* my_pts,
                                      const float* my_lab, const float* Pp,
                                      const float* lab, const float* val,
                                      int v0, float (&acc)[Mode<P>::kQ]) {
  if constexpr (P == 4) {
    const float c = cosf(th[0]), s = sinf(th[0]);
    sweep_points4<RESIDENT, FULL>(th, c, s, k, lane, len, my_pts, my_lab, Pp,
                                  lab, val, v0, acc);
  } else {
    float rot[kRot];
    rot6(th, rot);
    const float t[3] = {th[3], th[4], th[5]};
    sweep_points6<RESIDENT, FULL>(rot, t, k, lane, len, my_pts, my_lab, Pp,
                                  lab, val, v0, acc);
  }
}

// The solve of mode P: theta = [ry, t] (P = 4) or [r, t] (P = 6), the
// translation box-clipped.
template <int P, bool RESIDENT>
__global__ void __launch_bounds__(Mode<P>::kMaxWarps * 32)
lm_kernel(const float* __restrict__ pts, const float* __restrict__ labels,
          const float* __restrict__ valid, const float* __restrict__ kparams,
          const float* __restrict__ theta0, float* __restrict__ theta_out,
          float* __restrict__ cost_out, int N, int I, int max_iter, float H1,
          float W1, float lb0, float lb1, float lb2, float ub0, float ub1,
          float ub2, int C, int G, int W, int S) {
  using M = Mode<P>;
  constexpr int R = P - 3;  // rotation parameters
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 s_pts[];                 // W S rows, W S labels
  __shared__ float s_part[2][M::kMaxWarps][M::kStride];
  __shared__ float s_hg[P == 6 ? M::kMaxWarps : 1][32];  // Carried<6>
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
  float theta[P], prop[P], cost = 0.0f, lam = 1e-3f;
  Carried<P> carried(s_hg[P == 6 ? x : 0]);
  const float* t0 = theta0 + ((size_t)b * I + i) * P;
#pragma unroll
  for (int q = 0; q < R; ++q) theta[q] = t0[q];
#pragma unroll
  for (int q = 0; q < 3; ++q) theta[R + q] = clipn(t0[R + q], lb[q], ub[q]);
#pragma unroll
  for (int q = 0; q < P; ++q) prop[q] = theta[q];

  // sweep 0 at theta, then one sweep per iteration at the proposal (the
  // last one sums the cost alone: no step uses its H and g); every
  // barrier is reached by all threads of the cluster (the loop bounds
  // depend on the block only)
  for (int it = 0; it <= max_iter; ++it) {
    float acc[M::kQ];
#pragma unroll
    for (int q = 0; q < M::kQ; ++q) acc[q] = 0.0f;
    if (it < max_iter) {
      sweep<P, RESIDENT, true>(prop, k, lane, len, my_pts, my_lab, Pp, lab,
                               val, v0, acc);
    } else {
      sweep<P, RESIDENT, false>(prop, k, lane, len, my_pts, my_lab, Pp, lab,
                                val, v0, acc);
    }
    const float sum = cluster_sum<M::kQ, M::kStride>(
        cluster, &s_part[buf][0][0], x, g * W, C, W, lane, acc);
    buf ^= 1;
    // the cost of a theta that is not finite is NaN, so such a step is
    // never taken: where every point of the launch is labelled outside,
    // its residuals would all be 0 and it would score 0
    bool prop_finite = true;
#pragma unroll
    for (int q = 0; q < P; ++q)
      prop_finite = prop_finite && finite_f32(prop[q]);
    const float c_sum = __shfl_sync(0xffffffffu, sum, M::kQ - 1);
    const float c_new = prop_finite ? c_sum : __int_as_float(0x7fc00000);
    const bool accept = it == 0 || c_new < cost;
    if (it > 0)
      lam = fminf(fmaxf(accept ? lam / 3.0f : lam * 3.0f, 1e-9f), 1e9f);
    if (accept) {
#pragma unroll
      for (int q = 0; q < P; ++q) theta[q] = prop[q];
      cost = c_new;
      carried.keep(sum, lane);
    }
    if (it < max_iter) {
      float delta[P];
      chol_solve<P>(carried.H(), carried.H() + M::kH, lam, delta);
#pragma unroll
      for (int q = 0; q < R; ++q) prop[q] = theta[q] - delta[q];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        prop[R + q] = clipn(theta[R + q] - delta[R + q], lb[q], ub[q]);
    }
  }
  if (lane == 0 && rank == 0 && w == 0 && i_own < I) {
    float* to = theta_out + ((size_t)b * I + i_own) * P;
#pragma unroll
    for (int q = 0; q < P; ++q) to[q] = theta[q];
    cost_out[(size_t)b * I + i_own] = cost;
  }
  cluster.sync();  // no block leaves while another may read its partials
}

// Launch a cluster kernel of either mode: (ceil(I / G) C, B) blocks of
// 32 G W threads in clusters of C, `smem` bytes of dynamic shared memory.
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kernel)(KArgs...), int B, int I, int C, int G,
                    int W, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLmMaxTile * kLmRowBytes);
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The mode's kernel (P = 4 or 6) for resident or streamed points.
using LmKernel = void (*)(const float*, const float*, const float*,
                          const float*, const float*, float*, float*, int,
                          int, int, float, float, float, float, float, float,
                          float, float, int, int, int, int);

LmKernel lm_kernel_for(int P, bool resident) {
  if (P == 4) return resident ? lm_kernel<4, true> : lm_kernel<4, false>;
  return resident ? lm_kernel<6, true> : lm_kernel<6, false>;
}

}  // namespace

// The launch's layout comes from the wrapper
// (register/frustum_cuda.py::lm_plan and lm_layout), which owns it: C
// blocks per cluster, G inits per block, W warps per init, S points per
// virtual slice, and whether a block keeps its W S points in shared memory
// (resident).  The sum order depends on C W, S and resident, and the plain
// version repeats it from the same layout; here they are only checked.
// theta0 and theta_out are (B, I, P).
extern "C" int lm_solve_f32(const void* pts, const void* labels,
                            const void* valid, const void* kparams,
                            const void* theta0, void* theta_out,
                            void* cost_out, int B, int N, int I, int max_iter,
                            float H1, float W1, float lb0, float lb1,
                            float lb2, float ub0, float ub1, float ub2, int P,
                            int C, int G, int W, int S, int resident,
                            void* stream) {
  const int max_warps =
      P == 4 ? Mode<4>::kMaxWarps : Mode<6>::kMaxWarps;
  if (B <= 0 || N <= 0 || I <= 0 || B > 65535 || max_iter < 0 ||
      (P != 4 && P != 6) || C < 1 || C > kLmMaxCluster || G < 1 || W < 1 ||
      G * W > max_warps || S < 32 || S % 32 != 0 ||
      (long long)S * C * W < N || (resident && W * S > kLmMaxTile)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = resident ? (size_t)W * S * kLmRowBytes : 0;
  return launch_clusters(
      lm_kernel_for(P, resident != 0), B, I, C, G, W, smem,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(pts),
      static_cast<const float*>(labels), static_cast<const float*>(valid),
      static_cast<const float*>(kparams), static_cast<const float*>(theta0),
      static_cast<float*>(theta_out), static_cast<float*>(cost_out), N, I,
      max_iter, H1, W1, lb0, lb1, lb2, ub0, ub1, ub2, C, G, W, S);
}

// The resident kernel of mode P: registers per thread, static shared
// memory, local (spill) memory per thread in bytes and the most threads per
// block, into out[0..3].
extern "C" int lm_func_attrs(int P, void* out) {
  if (P != 4 && P != 6) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, lm_kernel_for(P, true));
  if (err != cudaSuccess) return (int)err;
  int* o = static_cast<int*>(out);
  o[0] = a.numRegs;
  o[1] = (int)a.sharedSizeBytes;
  o[2] = (int)a.localSizeBytes;
  o[3] = a.maxThreadsPerBlock;
  return 0;
}
