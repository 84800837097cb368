// Batch and instance normalisation, optionally followed by a ReLU: the
// forward (train and eval mode) but for its two reductions, and the whole
// backward, in the element type of the activations (bf16, f32 or f64)
// with per-channel numbers and sums in f32 (f64 for f64).
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA, which
// fuses them.  Eager PyTorch does not: `models/layers.py::Norm` written as
// tensor code widens, squares, reduces twice, then normalises with a
// subtract, a multiply, an add and a cast, each a pass over the tensor,
// the ReLU another, and autograd runs an f32 chain of some twenty passes
// backward and keeps f32 copies for it.
//
// What bounds it on the H100: bytes.  Per element a few float operations
// against 2 bytes read or written per pass, far below the card's ~20
// operations per byte of f32 throughput, so each pass streams its tensors
// once with 16-byte loads and stores and keeps nothing else in memory.
//
// The forward's two reductions stay PyTorch's own (`Norm.moments`, the
// mean and E[x^2] of the f32 input): a bf16 network's training diverges
// from any other rounding of them within a few steps (a sum order of its
// own moved the benchmark's first loss by 4e-4 and the median parameter
// change's direction by 0.24), so the statistics are the reference's bit
// for bit.  Everything around those two reductions is here.
//
// One view for every caller (`ops/norm_cuda.py::norm_view`): the tensor is
// (G, O, C, I) contiguous, statistics per (g, c) over (o, i).  Batch norm
// has G = 1, instance norm G = the batch.  I == 1 (channel-last points,
// and NCHW maps that lie channels-last in memory) takes the rows kernel:
// a thread owns VEC neighbouring channels and walks rows.  I > 1 (NCHW
// maps) takes the planes kernel: a block owns one (g, c) and walks its O
// planes of I elements.
//
// Passes, each one launch:
// * forward, train mode: widen_square (x in f32 and its square, the
//   tensors PyTorch then reduces to the mean and E[x^2], as `Norm.moments`
//   does for `Norm.plain`), then channel_stats (var, the clamp, the
//   running statistics, rstd and mul per channel); eval mode channel_stats
//   alone, on the running statistics.
// * kApply: y = (x - mean) * mul + b in the accumulator type, each
//   operation rounded on its own as PyTorch's separate kernels round
//   them, rounded to the element type, then the ReLU: `Norm.plain`'s y
//   bit for bit.  Eval mode takes the running statistics the same way.
// * backward: kGradSums (recompute the forward's rounded y bit for bit for
//   the ReLU's mask; partial sums of dy' and dy' * xhat, xhat = (x - mean)
//   rstd), finalize_bwd (the partials summed in a fixed order: the sums,
//   which are dbias and dweight, and their means), kGrad (dx = mul (dy' -
//   mean(dy') - xhat * mean(dy' * xhat)), the last term dropped where the
//   forward clamped the variance, as autograd of the clamp does).
// No float atomics anywhere: two calls on the same inputs are bitwise
// equal.  With -fmad=false every product and sum rounds on its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalizeThreads = 128;
constexpr int kUnroll = 4;       // loads a thread has in flight

enum Pass { kApply = 0, kGradSums = 1, kGrad = 2 };

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename T>
__device__ __forceinline__ T narrow(typename AccOf<T>::type v);
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ double narrow<double>(double v) {
  return v;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename A>
struct Params {
  const void* x;
  const void* dy;
  void* out;          // y (kApply) or dx (kGrad)
  const A* stats;     // [3][G C]: mean, rstd, mul
  const A* b;         // [C]
  const A* coef;      // [2][G C]: mean(dy'), mean(dy' xhat); null: zeros
  A* partials;        // [2][G C][P]
  int relu;
  long long O, I;
  int G, C, P;
};

// One channel's constants.
template <typename A>
struct Chan {
  A mean, rstd, mul, bias, ma, mb;
};

template <typename A>
__device__ __forceinline__ Chan<A> load_chan(const Params<A>& p, int g,
                                             int c) {
  const int GC = p.G * p.C, gc = g * p.C + c;
  Chan<A> k;
  k.mean = p.stats[gc];
  k.rstd = p.stats[GC + gc];
  k.mul = p.stats[2 * GC + gc];
  k.bias = p.b[c];
  k.ma = p.coef ? p.coef[gc] : A(0);
  k.mb = p.coef ? p.coef[GC + gc] : A(0);
  return k;
}

// One element of a pass: the sums into s0, s1 (kGradSums), or the element
// written to *out (kApply, kGrad).
template <int PASS, typename T, typename A>
__device__ __forceinline__ void visit(T xv, T dyv, T* out, const Chan<A>& k,
                                      int relu, A& s0, A& s1) {
  const A x = widen(xv);
  // y as the forward rounds it, before the ReLU
  const T yt = narrow<T>((x - k.mean) * k.mul + k.bias);
  if constexpr (PASS == kApply) {
    // max(y, 0): a NaN stays NaN
    *out = (relu && widen(yt) <= A(0)) ? narrow<T>(A(0)) : yt;
  } else {
    // the ReLU's gradient is 0 where its output is <= 0
    const A g = (relu && widen(yt) <= A(0)) ? A(0) : widen(dyv);
    const A xhat = (x - k.mean) * k.rstd;
    if constexpr (PASS == kGradSums) {
      s0 += g;
      s1 += g * xhat;
    } else {
      *out = narrow<T>(k.mul * (g - k.ma - xhat * k.mb));
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}

// The rows kernel (I == 1): block (TX, TY), grid (P, chunks, G).  Thread x
// of chunk y owns channels [VEC (y TX + x), +VEC); the block's TY thread
// rows walk its slab of the O rows, kUnroll rows a step.
template <int PASS, typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rows_kernel(Params<typename AccOf<T>::type> p) {
  using A = typename AccOf<T>::type;
  constexpr bool kSums = PASS == kGradSums;
  constexpr bool kDy = PASS != kApply;
  const int TX = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int g = blockIdx.z;
  const int c0 = (blockIdx.y * TX + tx) * VEC;
  const bool on = c0 < p.C;
  const long long per = (p.O + p.P - 1) / p.P;
  const long long r0 = blockIdx.x * per;
  const long long r1 = min(p.O, r0 + per);
  const size_t base = (size_t)g * p.O * p.C + c0;
  const T* __restrict__ x = static_cast<const T*>(p.x) + base;
  const T* __restrict__ dy =
      kDy ? static_cast<const T*>(p.dy) + base : nullptr;
  T* __restrict__ out =
      kSums ? nullptr : static_cast<T*>(p.out) + base;

  Chan<A> k[VEC];
  A s0[VEC], s1[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s0[j] = A(0);
    s1[j] = A(0);
    if (on) k[j] = load_chan(p, g, c0 + j);
  }
  if (on) {
    for (long long r = r0 + ty; r < r1; r += (long long)kUnroll * TY) {
      Vec<T, VEC> xv[kUnroll], dv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + (long long)u * TY;
        if (ru < r1) {
          xv[u] = load_vec<T, VEC>(x + ru * p.C);
          if constexpr (kDy) dv[u] = load_vec<T, VEC>(dy + ru * p.C);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + (long long)u * TY;
        if (ru < r1) {
          Vec<T, VEC> ov;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            visit<PASS, T, A>(xv[u].v[j], kDy ? dv[u].v[j] : xv[u].v[j],
                              &ov.v[j], k[j], p.relu, s0[j], s1[j]);
          }
          if constexpr (!kSums) {
            *reinterpret_cast<Vec<T, VEC>*>(out + ru * p.C) = ov;
          }
        }
      }
    }
  }
  if constexpr (kSums) {
    // the TY thread rows' sums, a tree over rows in a fixed order
    __shared__ A red[2][kThreads * VEC];
    const int t = (ty * TX + tx) * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[0][t + j] = s0[j];
      red[1][t + j] = s1[j];
    }
    __syncthreads();
    int h = 1;
    while (h < TY) h <<= 1;
    for (int s = h >> 1; s > 0; s >>= 1) {
      if (ty < s && ty + s < TY) {
        const int o = t + s * TX * VEC;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          red[0][t + j] += red[0][o + j];
          red[1][t + j] += red[1][o + j];
        }
      }
      __syncthreads();
    }
    if (ty == 0 && on) {
      const size_t GCP = (size_t)p.G * p.C * p.P;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const size_t i = ((size_t)g * p.C + c0 + j) * p.P + blockIdx.x;
        p.partials[i] = red[0][t + j];
        p.partials[GCP + i] = red[1][t + j];
      }
    }
  }
}

// The planes kernel (I > 1): block kThreads, grid (P, C, G).  Block (x, c,
// g) walks slab x of the O I / VEC vectors of channel c of group g.
template <int PASS, typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
planes_kernel(Params<typename AccOf<T>::type> p) {
  using A = typename AccOf<T>::type;
  constexpr bool kSums = PASS == kGradSums;
  constexpr bool kDy = PASS != kApply;
  const int c = blockIdx.y, g = blockIdx.z;
  const unsigned iv = (unsigned)(p.I / VEC);      // vectors of a plane
  const long long n = p.O * iv;
  const long long per = (n + p.P - 1) / p.P;
  const long long j0 = blockIdx.x * per;
  const long long j1 = min(n, j0 + per);
  const size_t base = ((size_t)g * p.O * p.C + c) * p.I;
  const size_t plane = (size_t)p.C * p.I;         // from one o to the next
  const T* __restrict__ x = static_cast<const T*>(p.x) + base;
  const T* __restrict__ dy =
      kDy ? static_cast<const T*>(p.dy) + base : nullptr;
  T* __restrict__ out =
      kSums ? nullptr : static_cast<T*>(p.out) + base;

  const Chan<A> k = load_chan(p, g, c);
  A s0 = A(0), s1 = A(0);
  for (long long j = j0 + threadIdx.x; j < j1;
       j += (long long)kUnroll * kThreads) {
    Vec<T, VEC> xv[kUnroll], dv[kUnroll];
    size_t off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ju = j + (long long)u * kThreads;
      if (ju < j1) {
        const unsigned o = (unsigned)ju / iv;     // n < 2^31, checked
        off[u] = (size_t)o * plane + ((unsigned)ju - o * iv) * VEC;
        xv[u] = load_vec<T, VEC>(x + off[u]);
        if constexpr (kDy) dv[u] = load_vec<T, VEC>(dy + off[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + (long long)u * kThreads < j1) {
        Vec<T, VEC> ov;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          visit<PASS, T, A>(xv[u].v[e], kDy ? dv[u].v[e] : xv[u].v[e],
                            &ov.v[e], k, p.relu, s0, s1);
        }
        if constexpr (!kSums) {
          *reinterpret_cast<Vec<T, VEC>*>(out + off[u]) = ov;
        }
      }
    }
  }
  if constexpr (kSums) {
    // warps by shuffles, then warp 0 over the warps in order
    __shared__ A red[2][kThreads / 32];
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_down_sync(0xffffffffu, s0, o);
      s1 += __shfl_down_sync(0xffffffffu, s1, o);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      red[0][warp] = s0;
      red[1][warp] = s1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      A a = red[0][0], b = red[1][0];
      for (int w = 1; w < kThreads / 32; ++w) {
        a += red[0][w];
        b += red[1][w];
      }
      const size_t GCP = (size_t)p.G * p.C * p.P;
      const size_t i = ((size_t)g * p.C + c) * p.P + blockIdx.x;
      p.partials[i] = a;
      p.partials[GCP + i] = b;
    }
  }
}

// Block gc sums row gc of both [2][GC][P] partial arrays: thread t takes
// p = t, t + kFinalizeThreads, ... in order, then shuffles within warps
// and thread 0 over the warps in order.
template <typename A>
__device__ __forceinline__ bool block_sums(const A* part, int P, int GC,
                                           A& a, A& b) {
  __shared__ A red[2][kFinalizeThreads / 32];
  const int gc = blockIdx.x;
  const A* pa = part + (size_t)gc * P;
  const A* pb = part + (size_t)GC * P + (size_t)gc * P;
  a = A(0);
  b = A(0);
#pragma unroll 4
  for (int i = threadIdx.x; i < P; i += kFinalizeThreads) {
    a += pa[i];
    b += pb[i];
  }
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  if (threadIdx.x != 0) return false;
  for (int w = 1; w < kFinalizeThreads / 32; ++w) {
    a += red[0][w];
    b += red[1][w];
  }
  return true;
}

// Backward: the sums of dy' and dy' xhat to sums [2][GC] (when given) and
// their means to coef [2][GC] (when given), the second 0 where keep is.
template <typename A>
__global__ void __launch_bounds__(kFinalizeThreads)
finalize_bwd(const A* part, int P, int GC, A count, const A* keep, A* sums,
             A* coef) {
  const int gc = blockIdx.x;
  A a, b;
  if (!block_sums(part, P, GC, a, b)) return;
  if (sums) {
    sums[gc] = a;
    sums[GC + gc] = b;
  }
  if (coef) {
    coef[gc] = a / count;
    coef[GC + gc] = keep[gc] != A(0) ? b / count : A(0);
  }
}

// x widened to the accumulator type, and its square, over n elements in
// memory order (the three tensors share their strides): xf only where the
// element type is narrower (bf16), else x serves as xf.  VEC elements a
// thread a step where 16-byte loads are aligned, else 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
widen_square_kernel(const T* __restrict__ x, typename AccOf<T>::type* xf,
                    typename AccOf<T>::type* __restrict__ xsq, long long n) {
  using A = typename AccOf<T>::type;
  const long long step = (long long)gridDim.x * kThreads * VEC;
  for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
       i < n; i += step) {
    const Vec<T, VEC> v = load_vec<T, VEC>(x + i);
    Vec<A, VEC> f, q;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      f.v[j] = widen(v.v[j]);
      q.v[j] = f.v[j] * f.v[j];
    }
    if (xf) *reinterpret_cast<Vec<A, VEC>*>(xf + i) = f;
    *reinterpret_cast<Vec<A, VEC>*>(xsq + i) = q;
  }
}

__device__ __forceinline__ float rsqrt_of(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_of(double v) { return rsqrt(v); }

// The forward's per-channel numbers from the moments PyTorch reduced, one
// thread a (g, c), each operation as `Norm.statistics` and `Norm.plain`
// take it: train mode var = max(0, ex2 - mean^2), keep = 1 where that was
// not clamped, the running statistics (when given; G == 1) moved by
// decay; eval mode ex2 is the running variance, taken as it is.  Then
// rstd = rsqrt(var + eps) and mul = rstd w.  stats [4][G C]: mean, rstd,
// mul, keep.
template <typename A>
__global__ void __launch_bounds__(kThreads)
channel_stats_kernel(const A* mean, const A* ex2, const A* w, A* rmean,
                     A* rvar, A* stats, int G, int C, A eps, A decay,
                     A batch_w, int train) {
  const int GC = G * C;
  const int gc = blockIdx.x * kThreads + threadIdx.x;
  if (gc >= GC) return;
  const int c = gc % C;
  const A m = mean[gc];
  A var = ex2[gc], keep = A(1);
  if (train) {
    const A raw = var - m * m;
    var = raw < A(0) ? A(0) : raw;       // clamp: a NaN stays NaN
    keep = raw >= A(0) ? A(1) : A(0);    // the clamp's gradient
    if (rmean) {
      rmean[c] = decay * rmean[c] + batch_w * m;
      rvar[c] = decay * rvar[c] + batch_w * var;
    }
  }
  const A rstd = rsqrt_of(var + eps);
  stats[gc] = m;
  stats[GC + gc] = rstd;
  stats[2 * GC + gc] = rstd * w[c];
  stats[3 * GC + gc] = keep;
}

template <int PASS, typename T, int VEC>
void launch_pass(const Params<typename AccOf<T>::type>& p, int tx,
                 cudaStream_t stream) {
  if (p.I == 1) {
    const int ty = kThreads / tx;
    const int chunks = (p.C / VEC + tx - 1) / tx;
    rows_kernel<PASS, T, VEC>
        <<<dim3(p.P, chunks, p.G), dim3(tx, ty), 0, stream>>>(p);
  } else {
    planes_kernel<PASS, T, VEC>
        <<<dim3(p.P, p.C, p.G), kThreads, 0, stream>>>(p);
  }
}

template <typename T, int VEC>
void launch_vec(int pass, const Params<typename AccOf<T>::type>& p, int tx,
                cudaStream_t stream) {
  switch (pass) {
    case kApply: launch_pass<kApply, T, VEC>(p, tx, stream); break;
    case kGradSums: launch_pass<kGradSums, T, VEC>(p, tx, stream); break;
    default: launch_pass<kGrad, T, VEC>(p, tx, stream); break;
  }
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T>
int run_pass(int pass, const void* x, const void* dy, void* out,
             const void* stats, const void* b, const void* coef,
             void* partials, int relu, int G, long long O, int C, long long I,
             int P, int vec, int tx, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  constexpr int kVec = 16 / sizeof(T);
  const long long width = I == 1 ? C : I;
  const bool sums = pass == kGradSums;
  if (G <= 0 || G > 65535 || O <= 0 || C <= 0 || I <= 0 || P <= 0 ||
      (vec != 1 && vec != kVec) || width % vec != 0 ||
      (vec > 1 && !(aligned16(x) && aligned16(dy) && aligned16(out))) ||
      (I == 1 && (tx <= 0 || tx > kThreads || tx > C / vec)) ||
      (I > 1 && (C > 65535 || O * (I / vec) >= (1LL << 31))) ||
      x == nullptr || stats == nullptr || b == nullptr ||
      (pass != kApply && dy == nullptr) ||
      (sums ? partials == nullptr : out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Params<A> p;
  p.x = x;
  p.dy = dy;
  p.out = out;
  p.stats = static_cast<const A*>(stats);
  p.b = static_cast<const A*>(b);
  p.coef = static_cast<const A*>(coef);
  p.partials = static_cast<A*>(partials);
  p.relu = relu;
  p.O = O;
  p.I = I;
  p.G = G;
  p.C = C;
  p.P = P;
  if (vec == kVec) {
    launch_vec<T, kVec>(pass, p, tx, stream);
  } else {
    launch_vec<T, 1>(pass, p, tx, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One element pass over x (G, O, C, I) of dtype 0 bf16, 1 f32, 2 f64:
// pass 0 kApply, 1 kGradSums, 2 kGrad (see the head of this file).
// Per-channel arrays are in the accumulator type (f32, f64 for f64):
// stats [3][G C] (mean, rstd, mul), b [C].  The launch comes from the
// wrapper (ops/norm_cuda.py::norm_plan): `vec` elements per load (1, or
// 16 bytes' worth where the channel (I == 1) or plane (I > 1) width
// divides and the pointers are 16-byte aligned), `tx` threads across the
// channels (rows kernel), P slabs.  Returns cudaErrorInvalidValue for
// arguments outside the kernel's bounds, else the launch's error.
int norm_pass(int pass, int dtype, const void* x, const void* dy, void* out,
              const void* stats, const void* b, const void* coef,
              void* partials, int relu, int G, long long O, int C,
              long long I, int P, int vec, int tx, void* stream) {
  if (pass < kApply || pass > kGrad) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run_pass<__nv_bfloat16>(pass, x, dy, out, stats, b, coef,
                                     partials, relu, G, O, C, I, P, vec, tx,
                                     s);
    case 1:
      return run_pass<float>(pass, x, dy, out, stats, b, coef, partials,
                             relu, G, O, C, I, P, vec, tx, s);
    case 2:
      return run_pass<double>(pass, x, dy, out, stats, b, coef, partials,
                              relu, G, O, C, I, P, vec, tx, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward's finalize over partials [2][GC][P] of the accumulator type
// of dtype (f32 for 0 and 1, f64 for 2); see finalize_bwd.  `keep` (1
// where the forward did not clamp the variance) is read only when coef is
// given.
int norm_finalize_bwd(int dtype, const void* part, int P, int GC,
                      double count, const void* keep, void* sums, void* coef,
                      void* stream) {
  if (P <= 0 || GC <= 0 || (sums == nullptr && coef == nullptr) ||
      (coef != nullptr && keep == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0 || dtype == 1) {
    finalize_bwd<float><<<GC, kFinalizeThreads, 0, s>>>(
        static_cast<const float*>(part), P, GC, (float)count,
        static_cast<const float*>(keep), static_cast<float*>(sums),
        static_cast<float*>(coef));
  } else if (dtype == 2) {
    finalize_bwd<double><<<GC, kFinalizeThreads, 0, s>>>(
        static_cast<const double*>(part), P, GC, count,
        static_cast<const double*>(keep), static_cast<double*>(sums),
        static_cast<double*>(coef));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (n elements of dtype 0 bf16, 1 f32, 2 f64, dense) -> xf (nullable for
// f32 and f64: x is its own widening) and xsq in the accumulator type;
// see widen_square_kernel.  `vec` 1, or 16 bytes' worth where n divides
// and the pointers are aligned.
int norm_widen_square(int dtype, const void* x, void* xf, void* xsq,
                      long long n, int vec, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kv = dtype == 0 ? 8 : dtype == 1 ? 4 : 2;
  if (n <= 0 || blocks <= 0 || x == nullptr || xsq == nullptr ||
      (dtype == 0) != (xf != nullptr) || (vec != 1 && vec != kv) ||
      n % vec != 0 ||
      (vec > 1 && !(aligned16(x) && aligned16(xf) && aligned16(xsq)))) {
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      if (vec > 1) {
        widen_square_kernel<__nv_bfloat16, 8><<<blocks, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<float*>(xf),
            static_cast<float*>(xsq), n);
      } else {
        widen_square_kernel<__nv_bfloat16, 1><<<blocks, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<float*>(xf),
            static_cast<float*>(xsq), n);
      }
      break;
    case 1:
      if (vec > 1) {
        widen_square_kernel<float, 4><<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(x), nullptr, static_cast<float*>(xsq),
            n);
      } else {
        widen_square_kernel<float, 1><<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(x), nullptr, static_cast<float*>(xsq),
            n);
      }
      break;
    case 2:
      if (vec > 1) {
        widen_square_kernel<double, 2><<<blocks, kThreads, 0, s>>>(
            static_cast<const double*>(x), nullptr,
            static_cast<double*>(xsq), n);
      } else {
        widen_square_kernel<double, 1><<<blocks, kThreads, 0, s>>>(
            static_cast<const double*>(x), nullptr,
            static_cast<double*>(xsq), n);
      }
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The forward's per-channel numbers; see channel_stats_kernel.  mean, ex2
// [G C] (ex2: the running variance where train is 0), w [C], the running
// statistics [C] (both or neither; only with G == 1), stats [4][G C], all
// in the accumulator type of dtype.
int norm_channel_stats(int dtype, const void* mean, const void* ex2,
                       const void* w, void* rmean, void* rvar, void* stats,
                       int G, int C, double eps, double decay, int train,
                       void* stream) {
  if (G <= 0 || C <= 0 || mean == nullptr || ex2 == nullptr ||
      w == nullptr || stats == nullptr || (rmean == nullptr) != (rvar == nullptr) ||
      (rmean != nullptr && (G != 1 || !train))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (G * C + kThreads - 1) / kThreads;
  if (dtype == 0 || dtype == 1) {
    channel_stats_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(mean), static_cast<const float*>(ex2),
        static_cast<const float*>(w), static_cast<float*>(rmean),
        static_cast<float*>(rvar), static_cast<float*>(stats), G, C,
        (float)eps, (float)decay, (float)(1.0 - decay), train);
  } else if (dtype == 2) {
    channel_stats_kernel<double><<<blocks, kThreads, 0, s>>>(
        static_cast<const double*>(mean), static_cast<const double*>(ex2),
        static_cast<const double*>(w), static_cast<double*>(rmean),
        static_cast<double*>(rvar), static_cast<double*>(stats), G, C, eps,
        decay, 1.0 - decay, train);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
