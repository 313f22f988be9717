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
// against about 2K exponentials, two softplus, two logs, a square root and
// some 20K float operations.
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
// Max, sums and knots run in bin order with IEEE division: the float64
// stress check of chip_smoke.py leaves little room for more rounding, and
// the result does not depend on the launch shape. Offsets are 64-bit. The
// kernel allocates nothing and does not synchronise with the host.

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
  float w_sum = 0.0f, h_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float ewk = expf(row[k] - w_max);
    const float ehk = expf(row[K + k] - h_max);
    w_sum += ewk;
    h_sum += ehk;
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
  float cw_acc = 0.0f, ch_acc = 0.0f;
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
    cw_acc += p.min_bin_width + scale_w * (ewk / w_sum);
    ch_acc += p.min_bin_height + scale_h * (ehk / h_sum);
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

using KernelFn = void (*)(Params);

// Blocks of `fn` that one SM of device `dev` holds at this size, times the
// device's SM count: one wave. Cached per device; sets the kernel's
// shared-memory limit on each device at first use there.
int64_t wave_blocks(int dev, KernelFn fn, int threads, int smem) {
  struct Entry {
    int dev;
    KernelFn fn;
    int threads, smem, wave;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int e = 0; e < used; ++e)
    if (cache[e].dev == dev && cache[e].fn == fn && cache[e].threads == threads &&
        cache[e].smem == smem)
      return cache[e].wave;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  int blocks = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int wave = (blocks < 1 ? 1 : blocks) * (sms < 1 ? 1 : sms);
  if (used < 64) cache[used++] = {dev, fn, threads, smem, wave};
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

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; x,
// y and ld are contiguous (n,); w, h and d have unit stride along the bins
// and the given row strides (in elements). Returns cudaGetLastError() after
// the launch on `stream`, or cudaErrorInvalidValue for a K it cannot take.
extern "C" int sbi_rqs_spline(const void* x, const void* w, const void* h, const void* d, void* y,
                              void* ld, int64_t n, int64_t stride_w, int64_t stride_h,
                              int64_t stride_d, int num_bins, int inverse, float tail_bound,
                              float min_bin_width, float min_bin_height, float min_derivative,
                              void* stream) {
  if (num_bins < 2 || num_bins > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  const int sms = sm_count(dev);
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.h = static_cast<const float*>(h);
  p.d = static_cast<const float*>(d);
  p.y = static_cast<float*>(y);
  p.ld = static_cast<float*>(ld);
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

  // One tile buffer, plus up to 3 floats of alignment offset.
  auto smem_bytes = [&](int t) { return (t * p.pitch + 3) * static_cast<int>(sizeof(float)); };
  int T = kMaxTile;
  while (T > kMinTile && (n + T - 1) / T < 2 * static_cast<int64_t>(sms)) T >>= 1;
  while (T > kMinTile && smem_bytes(T) > kMaxSmem) T >>= 1;
  if (smem_bytes(T) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);

  KernelFn fn = inverse ? (K == 10 ? rqs_kernel<true, 10> : rqs_kernel<true, 0>)
                        : (K == 10 ? rqs_kernel<false, 10> : rqs_kernel<false, 0>);
  const int smem = smem_bytes(T);
  const int64_t num_tiles = (n + T - 1) / T;
  const int64_t wave = wave_blocks(dev, fn, T, smem);
  const int64_t blocks = num_tiles < wave ? num_tiles : wave;
  fn<<<static_cast<unsigned>(blocks), T, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
