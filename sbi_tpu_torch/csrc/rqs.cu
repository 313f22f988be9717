// Rational-quadratic spline with linear tails (Durkan et al. 2019), both
// directions and their gradients, for Hopper (sm_90a).
//
// rqs_kernel replaces the TPU kernel sbi_tpu/ops/rqs_pallas.py::_rqs_kernel
// (launched by _rqs_pallas_raw). It computes the same function as the plain
// version in sbi_tpu_torch/ops/rqs.py (a line-for-line port of
// sbi_tpu/neural_nets/estimators/flows.py::rational_quadratic_spline).
// rqs_backward_kernel computes what _bwd in rqs_pallas.py takes from jax.vjp
// of that reference: d/d(x, widths, heights, derivatives) given the upstream
// gradients of y and log|det|. Its plain version is
// rational_quadratic_spline_vjp_plain in ops/rqs.py.
//
// What bounds them: memory. Per element the forward reads x (4 B) and 3K-1
// spline parameters (4 B each) and writes y and log|det| (8 B): 128 B at
// K = 10, against about 2K exponentials, two softplus, two logs, a square
// root and some 20K float operations. The backward reads x, the parameters
// and the two upstream gradients and writes 3K gradients: 248 B at K = 10,
// against the forward's work twice over.
//
// Design: a block owns a tile of T elements (one thread each) and copies
// the tile's parameters into shared memory with cp.async, neighbouring lanes
// on neighbouring addresses; then each thread computes its element from its
// row there.
// - Where the widths, heights and derivatives are slices of one row
//   (h = w + K, d = w + 2K, all row strides 3K-1: the conditioners' layout)
//   the tile is one contiguous span of T(3K-1) floats. It is copied in 16 B
//   pieces, with 4 B pieces for the unaligned head and tail; the shared
//   buffer is offset so that it has the span's alignment modulo 16 B. The
//   row pitch is 3K-1, odd at K = 10, so one-row-per-lane reads hit 32
//   distinct banks.
// - Any other layout goes through a strided tile load (one warp per row,
//   4 B pieces) into rows of an odd pitch >= 3K-1. Same kernel, same math.
// - Blocks are persistent: at most one wave of them, each looping over the
//   tiles. Each holds one tile buffer, so several blocks fit on an SM and
//   one block's copy overlaps another's compute. (A second buffer per
//   block, the next tile's copy in flight during this one's compute,
//   halves the blocks per SM and measured slower: PERF.md.) T is 128 and
//   shrinks until the tiles cover every SM twice (the sampling batches are
//   only 20,000-30,000 elements) and until the buffer fits in shared
//   memory (K up to kMaxBins).
// - Each exponential is computed once: the K width and K height numerators
//   stay in registers (K = 10, a template instance) or overwrite the
//   thread's own row in shared memory (any other K). Only the two
//   derivatives at the chosen bin's knots go through softplus.
// - The backward recomputes the forward from the same tile and runs its
//   reverse mode by hand, in registers: the selected bin's rational
//   quadratic (or, inverse, the closed-form root), the softplus of its two
//   knot derivatives, and, for every bin, the adjoint of the softmax, the
//   min-bin map and the cumulative knots (a reverse cumulative sum, which
//   is a constant before the chosen bin). The thread writes its gradient
//   row over its parameter row; the block then stores the tile's rows with
//   coalesced writes.
// Max, sums and knots run in bin order with IEEE division, and the sums
// are compensated (Kahan): the float64 stress checks of chip_smoke.py leave
// little room for more rounding, and the result does not depend on the
// launch shape. Offsets are 64-bit. The
// kernels allocate nothing and do not synchronise with the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kMaxBins = 256;           // also MAX_BINS in ops/rqs.py
constexpr int kMaxTile = 128;           // threads (= elements) per block
constexpr int kMinTile = 32;
constexpr int kMaxSmem = 232448;        // bytes a block may use on sm_90

struct Params {
  const float* x;
  const float* w;
  const float* h;
  const float* d;
  float* y;
  float* ld;
  int64_t n, stride_w, stride_h, stride_d;
  int num_bins;
  int contiguous;    // w, h, d are slices of one row of pitch 3K-1
  int pitch;         // floats per row in shared memory
  float tail_bound, min_bin_width, min_bin_height, min_derivative;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of the parameters of elements [i0, i0 + rows) into `buf`
// and returns the offset of row 0 there; row r starts at offset + r * pitch.
__device__ __forceinline__ int load_tile(const Params& p, float* buf, int64_t i0, int rows) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  if (p.contiguous) {
    const float* src = p.w + i0 * p.stride_w;
    const int len = rows * p.pitch;
    // Floats past the last 16 B boundary; buf + off has src's alignment.
    const int off = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    float* dst = buf + off;
    const int head = min((4 - off) & 3, len);
    const int body_end = head + ((len - head) & ~3);
    for (int j = head + 4 * tid; j < body_end; j += 4 * nthr) cp_async16(dst + j, src + j);
    if (tid < head) cp_async4(dst + tid, src + tid);
    if (tid < len - body_end) cp_async4(dst + body_end + tid, src + body_end + tid);
    return off;
  }
  // One warp per row; lane c copies column c: w at [0, K), h at [K, 2K),
  // d at [2K, 3K-1).
  const int K = p.num_bins, P = 3 * K - 1;
  const int lane = tid & 31;
  for (int r = tid >> 5; r < rows; r += nthr >> 5) {
    const int64_t i = i0 + r;
    float* dst = buf + r * p.pitch;
    for (int c = lane; c < P; c += 32) {
      const float* src = c < K       ? p.w + i * p.stride_w + c
                         : c < 2 * K ? p.h + i * p.stride_h + (c - K)
                                     : p.d + i * p.stride_d + (c - 2 * K);
      cp_async4(dst + c, src);
    }
  }
  return 0;
}

__device__ __forceinline__ float softplus(float v) {
  // Stable softplus, as jax.nn.softplus: max(v, 0) + log1p(exp(-|v|)).
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// acc += v with Kahan's compensation: the sums over the bins (softmax
// denominators, cumulative knots) stay within a few ulp at any K, where a
// plain running sum drifts by ~K ulp; the gradient of log|det| magnifies a
// knot's error by 1 / (bin width)^2.
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float v) {
  const float y = v - comp;
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

// One element from its row of parameters in shared memory. KT > 0: K = KT,
// numerators in registers; KT = 0: K at run time, numerators written over
// the row, which belongs to this thread alone.
template <bool INVERSE, int KT>
__device__ __forceinline__ void spline_element(const Params& p, float* row, float xi, float& y_out,
                                               float& ld_out) {
  const int K = KT > 0 ? KT : p.num_bins;
  const float B = p.tail_bound;
  const float scale_w = 1.0f - p.min_bin_width * K;
  const float scale_h = 1.0f - p.min_bin_height * K;
  const float* dr = row + 2 * K;

  // Softmax numerators and denominators of the widths and heights.
  float ew[KT > 0 ? KT : 1], eh[KT > 0 ? KT : 1];
  float w_max = row[0], h_max = row[K];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    w_max = fmaxf(w_max, row[k]);
    h_max = fmaxf(h_max, row[K + k]);
  }
  float w_sum = 0.0f, h_sum = 0.0f, w_sum_c = 0.0f, h_sum_c = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float ewk = expf(row[k] - w_max);
    const float ehk = expf(row[K + k] - h_max);
    kahan_add(w_sum, w_sum_c, ewk);
    kahan_add(h_sum, h_sum_c, ehk);
    if constexpr (KT > 0) {
      ew[k] = ewk;
      eh[k] = ehk;
    } else {
      row[k] = ewk;
      row[K + k] = ehk;
    }
  }

  const bool inside = (xi >= -B) && (xi <= B);
  const float xc = fminf(fmaxf(xi, -B), B);

  // Running pass over the bins: cumulative knots on [-B, B]; keep the last
  // bin whose lower knot (width knots forward, height knots inverse) is
  // <= x. Bin 0 is taken unconditionally, as the reference clips the bin
  // index at 0.
  float cw_acc = 0.0f, ch_acc = 0.0f, cw_c = 0.0f, ch_c = 0.0f;
  float cw_prev = -B, ch_prev = -B;
  float cw_lo = -B, cw_hi = -B, ch_lo = -B, ch_hi = -B;
  int bin = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float ewk, ehk;
    if constexpr (KT > 0) {
      ewk = ew[k];
      ehk = eh[k];
    } else {
      ewk = row[k];
      ehk = row[K + k];
    }
    kahan_add(cw_acc, cw_c, p.min_bin_width + scale_w * (ewk / w_sum));
    kahan_add(ch_acc, ch_c, p.min_bin_height + scale_h * (ehk / h_sum));
    const float cw_next = (cw_acc * 2.0f - 1.0f) * B;
    const float ch_next = (ch_acc * 2.0f - 1.0f) * B;
    const float ref_lo = INVERSE ? ch_prev : cw_prev;
    if (k == 0 || xc >= ref_lo) {
      cw_lo = cw_prev;
      cw_hi = cw_next;
      ch_lo = ch_prev;
      ch_hi = ch_next;
      bin = k;
    }
    cw_prev = cw_next;
    ch_prev = ch_next;
  }
  // Derivatives at the bin's knots; 1 at the outer knots (linear tails).
  const float d_lo = bin > 0 ? p.min_derivative + softplus(dr[bin - 1]) : 1.0f;
  const float d_hi = bin < K - 1 ? p.min_derivative + softplus(dr[bin]) : 1.0f;

  const float in_w = cw_hi - cw_lo;
  const float in_h = ch_hi - ch_lo;
  const float s = in_h / in_w;
  const float dsum = d_hi + d_lo - 2.0f * s;
  float theta, out;
  if (!INVERSE) {
    theta = fminf(fmaxf((xc - cw_lo) / in_w, 0.0f), 1.0f);
    const float tt = theta * (1.0f - theta);
    const float numerator = in_h * (s * theta * theta + d_lo * tt);
    const float denominator = s + dsum * tt;
    out = ch_lo + numerator / denominator;
  } else {
    const float y_rel = xc - ch_lo;
    const float a = in_h * (s - d_lo) + y_rel * dsum;
    const float b = in_h * d_lo - y_rel * dsum;
    const float c = -s * y_rel;
    const float disc = fmaxf(b * b - 4.0f * a * c, 0.0f);
    theta = fminf(fmaxf(2.0f * c / (-b - sqrtf(disc)), 0.0f), 1.0f);
    out = theta * in_w + cw_lo;
  }
  const float tt = theta * (1.0f - theta);
  const float denominator = s + dsum * tt;
  const float one_m = 1.0f - theta;
  const float deriv_num = s * s * (d_hi * theta * theta + 2.0f * s * tt + d_lo * one_m * one_m);
  float logdet = logf(deriv_num) - 2.0f * logf(denominator);
  if (INVERSE) logdet = -logdet;

  y_out = inside ? out : xi;
  ld_out = inside ? logdet : 0.0f;
}

// The register cap of ten resident blocks (48 registers at K = 10) and the
// copy of the next tile issued right after the trailing barrier read
// 21 us at n = 300,000 with cold L2, against 22.5 us for other orders and
// caps (PERF.md).
template <bool INVERSE, int KT>
__global__ void __launch_bounds__(kMaxTile, 10) rqs_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int64_t num_tiles = (p.n + T - 1) / T;
  auto rows_of = [&](int64_t t) {
    const int64_t left = p.n - t * T;
    return static_cast<int>(left < T ? left : T);
  };

  int64_t tile = blockIdx.x;
  int off = 0;
  if (tile < num_tiles) off = load_tile(p, smem, tile * T, rows_of(tile));
  cp_async_commit();
  for (; tile < num_tiles; tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    const int64_t i = tile * T + threadIdx.x;
    const float xi = i < p.n ? p.x[i] : 0.0f;
    cp_async_wait<0>();
    __syncthreads();
    if (i < p.n) {
      float yv, lv;
      spline_element<INVERSE, KT>(p, smem + off + threadIdx.x * p.pitch, xi, yv, lv);
      p.y[i] = yv;
      p.ld[i] = lv;
    }
    __syncthreads();  // the buffer just read is refilled next
    if (next < num_tiles) {
      off = load_tile(p, smem, next * T, rows_of(next));
      cp_async_commit();
    }
  }
}

__device__ __forceinline__ float clip_grad(float a, float lo, float hi) {
  // d clip(a, lo, hi) / da with the ties of jnp.clip: half at either bound.
  return (a > lo && a < hi) ? 1.0f : ((a == lo || a == hi) ? 0.5f : 0.0f);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }


// Gradient of one element, given the upstream gradients gy (of y) and gl
// (of log|det|): writes d/d(widths, heights, derivatives) over the element's
// row of parameters (same layout) and returns d/dx. The forward is
// recomputed as spline_element computes it; the reverse mode follows
// rational_quadratic_spline_vjp_plain in ops/rqs.py line by line.
template <bool INVERSE, int KT>
__device__ __forceinline__ float spline_element_backward(const Params& p, float* row, float xi,
                                                         float gy, float gl) {
  const int K = KT > 0 ? KT : p.num_bins;
  const float B = p.tail_bound;
  float* dr = row + 2 * K;
  if (!((xi >= -B) && (xi <= B))) {
    // Outside the bounds the spline is the identity.
    for (int k = 0; k < 3 * K - 1; ++k) row[k] = 0.0f;
    return gy;
  }
  const float scale_w = 1.0f - p.min_bin_width * K;
  const float scale_h = 1.0f - p.min_bin_height * K;

  float ew[KT > 0 ? KT : 1], eh[KT > 0 ? KT : 1];
  float w_max = row[0], h_max = row[K];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    w_max = fmaxf(w_max, row[k]);
    h_max = fmaxf(h_max, row[K + k]);
  }
  float w_sum = 0.0f, h_sum = 0.0f, w_sum_c = 0.0f, h_sum_c = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float ewk = expf(row[k] - w_max);
    const float ehk = expf(row[K + k] - h_max);
    kahan_add(w_sum, w_sum_c, ewk);
    kahan_add(h_sum, h_sum_c, ehk);
    if constexpr (KT > 0) {
      ew[k] = ewk;
      eh[k] = ehk;
    } else {
      row[k] = ewk;
      row[K + k] = ehk;
    }
  }
  const float xc = fminf(fmaxf(xi, -B), B);

  // The forward's running pass; it also keeps the softmax mass below the
  // chosen bin and the chosen bin's own, for the softmax's adjoint.
  float cw_acc = 0.0f, ch_acc = 0.0f, cw_c = 0.0f, ch_c = 0.0f, run_w_c = 0.0f, run_h_c = 0.0f;
  float cw_prev = -B, ch_prev = -B;
  float cw_lo = -B, cw_hi = -B, ch_lo = -B, ch_hi = -B;
  float run_w = 0.0f, run_h = 0.0f, pre_w = 0.0f, pre_h = 0.0f, sw_bin = 0.0f, sh_bin = 0.0f;
  int bin = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float ewk, ehk;
    if constexpr (KT > 0) {
      ewk = ew[k];
      ehk = eh[k];
    } else {
      ewk = row[k];
      ehk = row[K + k];
    }
    const float swk = ewk / w_sum;
    const float shk = ehk / h_sum;
    kahan_add(cw_acc, cw_c, p.min_bin_width + scale_w * swk);
    kahan_add(ch_acc, ch_c, p.min_bin_height + scale_h * shk);
    const float cw_next = (cw_acc * 2.0f - 1.0f) * B;
    const float ch_next = (ch_acc * 2.0f - 1.0f) * B;
    const float ref_lo = INVERSE ? ch_prev : cw_prev;
    if (k == 0 || xc >= ref_lo) {
      cw_lo = cw_prev;
      cw_hi = cw_next;
      ch_lo = ch_prev;
      ch_hi = ch_next;
      bin = k;
      pre_w = run_w;
      pre_h = run_h;
      sw_bin = swk;
      sh_bin = shk;
    }
    kahan_add(run_w, run_w_c, swk);
    kahan_add(run_h, run_h_c, shk);
    cw_prev = cw_next;
    ch_prev = ch_next;
  }
  const float u_lo = bin > 0 ? dr[bin - 1] : 0.0f;
  const float u_hi = bin < K - 1 ? dr[bin] : 0.0f;
  const float d_lo = bin > 0 ? p.min_derivative + softplus(u_lo) : 1.0f;
  const float d_hi = bin < K - 1 ? p.min_derivative + softplus(u_hi) : 1.0f;

  const float in_w = cw_hi - cw_lo;
  const float in_h = ch_hi - ch_lo;
  const float s = in_h / in_w;
  const float dsum = d_hi + d_lo - 2.0f * s;
  float raw, y_rel = 0.0f, a = 0.0f, b = 0.0f, c = 0.0f, disc = 0.0f, root = 0.0f, e = 0.0f;
  if (!INVERSE) {
    raw = (xc - cw_lo) / in_w;
  } else {
    y_rel = xc - ch_lo;
    a = in_h * (s - d_lo) + y_rel * dsum;
    b = in_h * d_lo - y_rel * dsum;
    c = -s * y_rel;
    disc = b * b - 4.0f * a * c;
    root = sqrtf(fmaxf(disc, 0.0f));
    e = -b - root;
    raw = 2.0f * c / e;
  }
  const float theta = fminf(fmaxf(raw, 0.0f), 1.0f);
  const float one_m = 1.0f - theta;
  const float tt = theta * one_m;
  const float q = d_hi * theta * theta + 2.0f * s * tt + d_lo * one_m * one_m;
  const float den = s + dsum * tt;

  // Reverse mode. Forward: y = ch_lo + numerator / den, log|det| =
  // log(s^2 q) - 2 log(den). Inverse: y = theta in_w + cw_lo, log|det| =
  // -(log(s^2 q) - 2 log(den)).
  float g_theta, g_in_w, g_in_h, g_cw_lo, g_ch_lo, g_s, g_dlo, g_tt, g_den, g_dnum, g_x;
  if (!INVERSE) {
    const float shape = s * theta * theta + d_lo * tt;
    const float numerator = in_h * shape;
    const float g_num = gy / den;
    g_den = -gy * numerator / (den * den) - 2.0f * gl / den;
    g_dnum = gl / (s * s * q);
    g_ch_lo = gy;
    g_in_h = g_num * shape;
    g_s = g_num * in_h * theta * theta;
    g_theta = g_num * in_h * 2.0f * s * theta;
    g_dlo = g_num * in_h * tt;
    g_tt = g_num * in_h * d_lo;
    g_in_w = 0.0f;
    g_cw_lo = 0.0f;
  } else {
    g_theta = gy * in_w;
    g_in_w = gy * theta;
    g_cw_lo = gy;
    g_den = 2.0f * gl / den;
    g_dnum = -gl / (s * s * q);
    g_ch_lo = 0.0f;
    g_in_h = 0.0f;
    g_s = 0.0f;
    g_dlo = 0.0f;
    g_tt = 0.0f;
  }
  // den = s + dsum tt
  g_s += g_den;
  float g_dsum = g_den * tt;
  g_tt += g_den * dsum;
  // s^2 q, q = d_hi theta^2 + 2 s tt + d_lo (1 - theta)^2
  g_s += g_dnum * 2.0f * s * q;
  const float g_q = g_dnum * s * s;
  float g_dhi = g_q * theta * theta;
  g_theta += g_q * (2.0f * d_hi * theta - 2.0f * d_lo * one_m);
  g_s += g_q * 2.0f * tt;
  g_tt += g_q * 2.0f * s;
  g_dlo += g_q * one_m * one_m;
  // tt = theta (1 - theta); theta = clip(raw, 0, 1)
  g_theta += g_tt * (1.0f - 2.0f * theta);
  const float g_raw = g_theta * clip_grad(raw, 0.0f, 1.0f);
  if (!INVERSE) {
    // raw = (x - cw_lo) / in_w
    g_x = g_raw / in_w;
    g_cw_lo = -g_x;
    g_in_w = -g_x * raw;
  } else {
    // raw = 2c / e, e = -b - sqrt(max(disc, 0)), disc = b^2 - 4ac
    float g_c = g_raw * 2.0f / e;
    const float g_e = -g_raw * raw / e;
    float g_b = -g_e;
    const float g_disc =
        (disc > 0.0f ? 1.0f : (disc == 0.0f ? 0.5f : 0.0f)) * (-g_e / (2.0f * root));
    g_b += g_disc * 2.0f * b;
    const float g_a = -4.0f * c * g_disc;
    g_c -= 4.0f * a * g_disc;
    // c = -s y_rel; b = in_h d_lo - y_rel dsum; a = in_h (s - d_lo) + y_rel dsum
    g_s = g_s - g_c * y_rel + g_a * in_h;
    const float g_yrel = -g_c * s - g_b * dsum + g_a * dsum;
    g_in_h = g_b * d_lo + g_a * (s - d_lo);
    g_dlo = g_dlo + g_b * in_h - g_a * in_h;
    g_dsum = g_dsum - g_b * y_rel + g_a * y_rel;
    // y_rel = x - ch_lo
    g_x = g_yrel;
    g_ch_lo = -g_yrel;
  }
  // dsum = d_hi + d_lo - 2 s
  g_dhi += g_dsum;
  g_dlo += g_dsum;
  g_s -= 2.0f * g_dsum;
  // s = in_h / in_w
  g_in_h += g_s / in_w;
  g_in_w -= g_s * s / in_w;

  // The chosen bin's knots, through the map onto [-B, B]: in_w = cw_hi -
  // cw_lo, in_h = ch_hi - ch_lo. The cumulative sum's adjoint gives every
  // bin size below the chosen bin the gradient of both knots, the chosen
  // bin's size that of the upper knot, and the sizes above it nothing.
  const float gw_hi = 2.0f * B * g_in_w;
  const float gw_below = 2.0f * B * (g_cw_lo - g_in_w) + gw_hi;
  const float gh_hi = 2.0f * B * g_in_h;
  const float gh_below = 2.0f * B * (g_ch_lo - g_in_h) + gh_hi;
  // Softmax adjoint: soft_k (g_k - sum_j soft_j g_j), g = scale * (bin size grads).
  const float dot_w = scale_w * (gw_below * pre_w + gw_hi * sw_bin);
  const float dot_h = scale_h * (gh_below * pre_h + gh_hi * sh_bin);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float ewk, ehk;
    if constexpr (KT > 0) {
      ewk = ew[k];
      ehk = eh[k];
    } else {
      ewk = row[k];
      ehk = row[K + k];
    }
    const float gwk = k < bin ? gw_below : (k == bin ? gw_hi : 0.0f);
    const float ghk = k < bin ? gh_below : (k == bin ? gh_hi : 0.0f);
    row[k] = (ewk / w_sum) * (scale_w * gwk - dot_w);
    row[K + k] = (ehk / h_sum) * (scale_h * ghk - dot_h);
  }
  // d softplus / du = sigmoid(u); the outer knots' derivatives are constants.
  for (int k = 0; k < K - 1; ++k) dr[k] = 0.0f;
  if (bin > 0) dr[bin - 1] = g_dlo * sigmoid(u_lo);
  if (bin < K - 1) dr[bin] = g_dhi * sigmoid(u_hi);
  return g_x * clip_grad(xi, -B, B);
}

struct GradParams {
  Params p;           // x, w, h, d as the forward reads them; y, ld unused
  const float* gy;    // upstream gradients, contiguous (n,)
  const float* gl;
  float* gx;          // outputs, contiguous (n,), (n, K), (n, K), (n, K-1);
  float* gw;          // a null pointer skips that output
  float* gh;
  float* gd;
};

// Copies columns [col0, col0 + cols) of the tile's `rows` rows (row r at
// buf + r * pitch) to dst, a contiguous (rows, cols) block, neighbouring
// lanes on neighbouring addresses.
__device__ __forceinline__ void store_tile(float* dst, const float* buf, int pitch, int col0,
                                           int cols, int rows) {
  const int len = rows * cols;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const int r = j / cols;
    dst[j] = buf[r * pitch + col0 + (j - r * cols)];
  }
}

// The forward kernel's loop, with the element's gradient written over its
// row and the tile's rows stored after a barrier.
template <bool INVERSE, int KT>
__global__ void __launch_bounds__(kMaxTile) rqs_backward_kernel(const GradParams g) {
  extern __shared__ __align__(16) float smem[];
  const Params& p = g.p;
  const int T = blockDim.x;
  const int K = KT > 0 ? KT : p.num_bins;
  const int64_t num_tiles = (p.n + T - 1) / T;
  auto rows_of = [&](int64_t t) {
    const int64_t left = p.n - t * T;
    return static_cast<int>(left < T ? left : T);
  };

  int64_t tile = blockIdx.x;
  int off = 0;
  if (tile < num_tiles) off = load_tile(p, smem, tile * T, rows_of(tile));
  cp_async_commit();
  for (; tile < num_tiles; tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    const int64_t i0 = tile * T;
    const int64_t i = i0 + threadIdx.x;
    float xi = 0.0f, gyi = 0.0f, gli = 0.0f;
    if (i < p.n) {
      xi = p.x[i];
      gyi = g.gy[i];
      gli = g.gl[i];
    }
    cp_async_wait<0>();
    __syncthreads();
    if (i < p.n) {
      const float gxi = spline_element_backward<INVERSE, KT>(
          p, smem + off + threadIdx.x * p.pitch, xi, gyi, gli);
      if (g.gx != nullptr) g.gx[i] = gxi;
    }
    __syncthreads();  // every gradient row of the tile is in the buffer
    const int rows = rows_of(tile);
    if (g.gw != nullptr) store_tile(g.gw + i0 * K, smem + off, p.pitch, 0, K, rows);
    if (g.gh != nullptr) store_tile(g.gh + i0 * K, smem + off, p.pitch, K, K, rows);
    if (g.gd != nullptr) store_tile(g.gd + i0 * (K - 1), smem + off, p.pitch, 2 * K, K - 1, rows);
    __syncthreads();  // the buffer just read is refilled next
    if (next < num_tiles) {
      off = load_tile(p, smem, next * T, rows_of(next));
      cp_async_commit();
    }
  }
}

// Blocks of kernel `fn` that one SM of device `dev` holds at this size,
// times the device's SM count: one wave. Cached per device and kernel; sets
// the kernel's shared-memory limit on each device at first use there.
template <typename Fn>
int64_t wave_blocks(int dev, Fn fn, int threads, int smem) {
  struct Entry {
    int dev;
    const void* fn;
    int threads, smem, wave;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;
  const void* key = reinterpret_cast<const void*>(fn);
  std::lock_guard<std::mutex> lock(mu);
  for (int e = 0; e < used; ++e)
    if (cache[e].dev == dev && cache[e].fn == key && cache[e].threads == threads &&
        cache[e].smem == smem)
      return cache[e].wave;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  int blocks = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int wave = (blocks < 1 ? 1 : blocks) * (sms < 1 ? 1 : sms);
  if (used < 64) cache[used++] = {dev, key, threads, smem, wave};
  return wave;
}

// SMs of device `dev`, cached; the tile size is chosen before the kernel is.
int sm_count(int dev) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> counts[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return 1;
  int sms = counts[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
    counts[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

Params make_params(const void* x, const void* w, const void* h, const void* d, int64_t n,
                   int64_t stride_w, int64_t stride_h, int64_t stride_d, int num_bins,
                   float tail_bound, float min_bin_width, float min_bin_height,
                   float min_derivative) {
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.h = static_cast<const float*>(h);
  p.d = static_cast<const float*>(d);
  p.y = nullptr;
  p.ld = nullptr;
  p.n = n;
  p.stride_w = stride_w;
  p.stride_h = stride_h;
  p.stride_d = stride_d;
  p.num_bins = num_bins;
  const int K = num_bins, P = 3 * K - 1;
  p.contiguous = p.h == p.w + K && p.d == p.w + 2 * K &&
                 (n == 1 || (stride_w == P && stride_h == P && stride_d == P));
  p.pitch = p.contiguous ? P : (P | 1);
  p.tail_bound = tail_bound;
  p.min_bin_width = min_bin_width;
  p.min_bin_height = min_bin_height;
  p.min_derivative = min_derivative;
  return p;
}

// One tile buffer, plus up to 3 floats of alignment offset.
int smem_bytes(const Params& p, int t) {
  return (t * p.pitch + 3) * static_cast<int>(sizeof(float));
}

// Elements per block: 128, halved until the tiles cover each SM twice and
// the buffer fits in shared memory; 0 where even kMinTile does not fit.
int tile_size(const Params& p, int sms) {
  int T = kMaxTile;
  while (T > kMinTile && (p.n + T - 1) / T < 2 * static_cast<int64_t>(sms)) T >>= 1;
  while (T > kMinTile && smem_bytes(p, T) > kMaxSmem) T >>= 1;
  return smem_bytes(p, T) > kMaxSmem ? 0 : T;
}

// Launches `fn(arg)` over p's tiles, at most one wave of persistent blocks.
template <typename Fn, typename Arg>
int launch(Fn fn, const Arg& arg, const Params& p, int dev, void* stream) {
  const int T = tile_size(p, sm_count(dev));
  if (T == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(p, T);
  const int64_t num_tiles = (p.n + T - 1) / T;
  const int64_t wave = wave_blocks(dev, fn, T, smem);
  const int64_t blocks = num_tiles < wave ? num_tiles : wave;
  fn<<<static_cast<unsigned>(blocks), T, smem, static_cast<cudaStream_t>(stream)>>>(arg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers; x,
// y and ld are contiguous (n,); w, h and d have unit stride along the bins
// and the given row strides (in elements). Each returns cudaGetLastError()
// after the launch on `stream`, or cudaErrorInvalidValue for a K it cannot
// take.
extern "C" int sbi_rqs_spline(const void* x, const void* w, const void* h, const void* d, void* y,
                              void* ld, int64_t n, int64_t stride_w, int64_t stride_h,
                              int64_t stride_d, int num_bins, int inverse, float tail_bound,
                              float min_bin_width, float min_bin_height, float min_derivative,
                              void* stream) {
  if (num_bins < 2 || num_bins > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  Params p = make_params(x, w, h, d, n, stride_w, stride_h, stride_d, num_bins, tail_bound,
                         min_bin_width, min_bin_height, min_derivative);
  p.y = static_cast<float*>(y);
  p.ld = static_cast<float*>(ld);
  const bool k10 = num_bins == 10;
  if (inverse) return launch(k10 ? rqs_kernel<true, 10> : rqs_kernel<true, 0>, p, p, dev, stream);
  return launch(k10 ? rqs_kernel<false, 10> : rqs_kernel<false, 0>, p, p, dev, stream);
}

// The gradients of sbi_rqs_spline's (y, ld) in the same direction: gy and
// gl are contiguous (n,); gx (n,), gw and gh (n, K) and gd (n, K-1) are
// contiguous outputs, and a null pointer skips that output.
extern "C" int sbi_rqs_spline_backward(const void* x, const void* w, const void* h, const void* d,
                                       const void* gy, const void* gl, void* gx, void* gw,
                                       void* gh, void* gd, int64_t n, int64_t stride_w,
                                       int64_t stride_h, int64_t stride_d, int num_bins,
                                       int inverse, float tail_bound, float min_bin_width,
                                       float min_bin_height, float min_derivative, void* stream) {
  if (num_bins < 2 || num_bins > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  GradParams g;
  g.p = make_params(x, w, h, d, n, stride_w, stride_h, stride_d, num_bins, tail_bound,
                    min_bin_width, min_bin_height, min_derivative);
  g.gy = static_cast<const float*>(gy);
  g.gl = static_cast<const float*>(gl);
  g.gx = static_cast<float*>(gx);
  g.gw = static_cast<float*>(gw);
  g.gh = static_cast<float*>(gh);
  g.gd = static_cast<float*>(gd);
  const bool k10 = num_bins == 10;
  if (inverse)
    return launch(k10 ? rqs_backward_kernel<true, 10> : rqs_backward_kernel<true, 0>, g, g.p, dev,
                  stream);
  return launch(k10 ? rqs_backward_kernel<false, 10> : rqs_backward_kernel<false, 0>, g, g.p, dev,
                stream);
}
