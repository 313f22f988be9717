// Rational-quadratic spline with linear tails (Durkan et al. 2019), both
// directions, for Hopper (sm_90a).
//
// Replaces the TPU kernel sbi_tpu/ops/rqs_pallas.py::_rqs_kernel (launched
// by _rqs_pallas_raw). It computes the same function as the plain version in
// sbi_tpu_torch/ops/rqs.py (a line-for-line port of
// sbi_tpu/neural_nets/estimators/flows.py::rational_quadratic_spline).
//
// What bounds it: memory. Per element it reads x (4 B) and 3K-1 spline
// parameters (4 B each) and writes y and log|det| (8 B): 128 B at K = 10,
// against about 60 transcendental operations (2 exp per softmax entry, one
// exp and one log1p per derivative, two logs, one sqrt).
//
// Design: one thread per element, grid-stride loop. The TPU kernel needed
// the parameters transposed to a (K, N) layout padded to 1024-lane blocks;
// here each thread reads its own K widths, K heights and K-1 derivatives
// straight from its row through a row stride, so the widths, heights and
// derivatives may be strided slices of one (rows, 3K-1) conditioner output
// and the caller copies nothing. The row is read twice (max pass, then the
// running knot pass); the second read hits L1. No local array is indexed
// dynamically: the softmax sums are accumulated first, then one running pass
// accumulates the knots and keeps the last bin whose lower knot is <= x.
// Offsets are 64-bit. The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float softplus(float v) {
  // Stable softplus, as jax.nn.softplus: max(v, 0) + log1p(exp(-|v|)).
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

template <bool INVERSE>
__global__ void rqs_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ h,
                           const float* __restrict__ d,
                           float* __restrict__ y,
                           float* __restrict__ ld,
                           int64_t n, int64_t stride_w, int64_t stride_h,
                           int64_t stride_d, int num_bins, float tail_bound,
                           float min_bin_width, float min_bin_height,
                           float min_derivative) {
  const int K = num_bins;
  const float B = tail_bound;
  const float scale_w = 1.0f - min_bin_width * K;
  const float scale_h = 1.0f - min_bin_height * K;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;

  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const float xi = x[i];
    const float* wr = w + i * stride_w;
    const float* hr = h + i * stride_h;
    const float* dr = d + i * stride_d;

    // Softmax denominators of the widths and heights.
    float w_max = wr[0], h_max = hr[0];
    for (int k = 1; k < K; ++k) {
      w_max = fmaxf(w_max, wr[k]);
      h_max = fmaxf(h_max, hr[k]);
    }
    float w_sum = 0.0f, h_sum = 0.0f;
    for (int k = 0; k < K; ++k) {
      w_sum += expf(wr[k] - w_max);
      h_sum += expf(hr[k] - h_max);
    }

    const bool inside = (xi >= -B) && (xi <= B);
    const float xc = fminf(fmaxf(xi, -B), B);

    // Running pass over the bins: cumulative knots on [-B, B]; keep the
    // last bin whose lower knot (width knots forward, height knots
    // inverse) is <= x. Bin 0 is taken unconditionally, as the reference
    // clips the bin index at 0.
    float cw_acc = 0.0f, ch_acc = 0.0f;
    float cw_prev = -B, ch_prev = -B, d_prev = 1.0f;
    float cw_lo = -B, cw_hi = -B, ch_lo = -B, ch_hi = -B;
    float d_lo = 1.0f, d_hi = 1.0f;
    for (int k = 0; k < K; ++k) {
      cw_acc += min_bin_width + scale_w * (expf(wr[k] - w_max) / w_sum);
      ch_acc += min_bin_height + scale_h * (expf(hr[k] - h_max) / h_sum);
      const float cw_next = (cw_acc * 2.0f - 1.0f) * B;
      const float ch_next = (ch_acc * 2.0f - 1.0f) * B;
      const float d_next =
          (k < K - 1) ? min_derivative + softplus(dr[k]) : 1.0f;
      const float ref_lo = INVERSE ? ch_prev : cw_prev;
      if (k == 0 || xc >= ref_lo) {
        cw_lo = cw_prev;
        cw_hi = cw_next;
        ch_lo = ch_prev;
        ch_hi = ch_next;
        d_lo = d_prev;
        d_hi = d_next;
      }
      cw_prev = cw_next;
      ch_prev = ch_next;
      d_prev = d_next;
    }

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
    const float deriv_num =
        s * s * (d_hi * theta * theta + 2.0f * s * tt + d_lo * one_m * one_m);
    float logdet = logf(deriv_num) - 2.0f * logf(denominator);
    if (INVERSE) logdet = -logdet;

    y[i] = inside ? out : xi;
    ld[i] = inside ? logdet : 0.0f;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; x,
// y and ld are contiguous (n,); w, h and d have unit stride along the bins
// and the given row strides (in elements). Returns cudaGetLastError() after
// the launch on `stream`.
extern "C" int sbi_rqs_spline(const void* x, const void* w, const void* h,
                              const void* d, void* y, void* ld, int64_t n,
                              int64_t stride_w, int64_t stride_h,
                              int64_t stride_d, int num_bins, int inverse,
                              float tail_bound, float min_bin_width,
                              float min_bin_height, float min_derivative,
                              void* stream) {
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (sm_count <= 0) sm_count = 1;
  }
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t max_blocks = (int64_t)sm_count * 8;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* hp = static_cast<const float*>(h);
  const float* dp = static_cast<const float*>(d);
  float* yp = static_cast<float*>(y);
  float* lp = static_cast<float*>(ld);
  if (inverse) {
    rqs_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
        xp, wp, hp, dp, yp, lp, n, stride_w, stride_h, stride_d, num_bins,
        tail_bound, min_bin_width, min_bin_height, min_derivative);
  } else {
    rqs_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
        xp, wp, hp, dp, yp, lp, n, stride_w, stride_h, stride_d, num_bins,
        tail_bound, min_bin_width, min_bin_height, min_derivative);
  }
  return (int)cudaGetLastError();
}
