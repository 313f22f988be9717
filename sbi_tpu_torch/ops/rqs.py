"""Rational-quadratic spline: plain PyTorch versions, CUDA kernels and wrapper.

The hand-written kernels are in ``sbi_tpu_torch/csrc/rqs.cu``.

- ``rqs_kernel`` replaces the TPU kernel
  ``sbi_tpu/ops/rqs_pallas.py::_rqs_kernel`` (launched by
  ``_rqs_pallas_raw``) and computes, per element, the same monotone spline
  with linear tails as ``rational_quadratic_spline_plain`` below, a
  line-for-line port of ``sbi_tpu/neural_nets/estimators/flows.py:91-157``.
- ``rqs_backward_kernel`` computes what ``_bwd`` in ``rqs_pallas.py`` takes
  from ``jax.vjp`` of that reference: the gradients with respect to x and
  the unnormalized widths, heights and derivatives, given the upstream
  gradients of y and log|det|. Its plain version is
  ``rational_quadratic_spline_vjp_plain``: the same closed-form adjoint,
  written in torch operations rather than taken from autograd.

What bounds the kernels on the card: memory. Per element the forward reads
4 + 4·(3K−1) bytes and writes 8 (128 B at K = 10); the backward reads 12 +
4·(3K−1) and writes 4·3K (248 B at K = 10). Each does about 2K exponentials
and a few logs against that. A block copies a tile of elements' parameters
into shared memory with coalesced ``cp.async`` copies (16 B pieces where the
widths, heights and derivatives are slices of one row, as the conditioners
give them; a strided tile load otherwise), then each thread computes one
element from there; the backward writes its gradient rows back through the
same buffer, so that its stores are coalesced too. The wrapper copies
nothing and the TPU's (K, N) transpose and 1024-lane padding are gone. K
runs from 2 to ``MAX_BINS``.

``rational_quadratic_spline`` is the entry point. On a CPU tensor it runs
the plain versions; on a CUDA tensor it launches the kernels or raises.
Where a gradient is wanted it goes through an ``autograd.Function`` whose
backward launches the backward kernel (CUDA) or runs the plain VJP (CPU).
The kernels are built with ``nvcc`` at first use into
``sbi_tpu_torch/_build/`` and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import torch

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3
MAX_BINS = 256  # kMaxBins in csrc/rqs.cu

# Kernel launches: the spline by direction, and its backward by the
# direction it differentiates (``backward_launches`` the forward spline's,
# ``backward_inverse_launches`` the inverse spline's). Incremented where a
# kernel is launched and nowhere else; callers reset them to 0 to count the
# launches of one run.
forward_launches = 0
inverse_launches = 0
backward_launches = 0
backward_inverse_launches = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "rqs.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_lib = None
build_log = ""  # the compiler's output of the last build in this process


def _clip(a: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, so a value exactly at a bound gets
    half the gradient, as in JAX (``Tensor.clamp`` would give all of it)."""
    return torch.minimum(torch.maximum(a, a.new_full((), lo)), a.new_full((), hi))


def _clip_grad(a: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """d ``_clip(a, lo, hi)`` / da: 1 strictly inside, 1/2 at either bound
    (the split tie of ``jnp.clip``), 0 outside."""
    return ((a > lo) & (a < hi)).to(a.dtype) + 0.5 * ((a == lo) | (a == hi)).to(a.dtype)


def _softplus(a: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (no threshold, unlike ``F.softplus``). max(a, 0)
    is written (a + |a|) / 2, the same value, so that autograd gives the
    derivative sigmoid(a) also at a = 0 (1/2, as jax's logaddexp);
    ``clamp(min=0)`` would give 1 there."""
    return 0.5 * (a + a.abs()) + torch.log1p(torch.exp(-a.abs()))


def _knots(unnormalized: torch.Tensor, min_bin: float, tail_bound: float):
    """Softmax of the unnormalized bin sizes and the K+1 cumulative knots
    on [-tail_bound, tail_bound]."""
    K = unnormalized.shape[-1]
    soft = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1 - min_bin * K) * soft
    knots = torch.cumsum(sizes, dim=-1)
    knots = torch.cat([torch.zeros_like(knots[..., :1]), knots], -1)
    return soft, (knots * 2 - 1) * tail_bound  # map [0,1] -> [-B, B]


def _derivatives(unnormalized_derivatives: torch.Tensor, min_derivative: float) -> torch.Tensor:
    """The K+1 knot derivatives: 1 at the outer knots, so that the spline
    matches its linear tails, min_derivative + softplus inside."""
    inner = min_derivative + _softplus(unnormalized_derivatives)
    ones = torch.ones_like(inner[..., :1])
    return torch.cat([ones, inner, ones], dim=-1)


def _bin(x: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """The last bin whose lower knot is <= x, clipped to [0, K-1]."""
    K = knots.shape[-1] - 1
    idx = (x[..., None] >= knots[..., :-1]).to(torch.int64).sum(-1) - 1
    return idx.clamp(0, K - 1)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, i[..., None])[..., 0]


def rational_quadratic_spline_plain(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 3.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise monotone RQ spline with linear tails, in plain PyTorch.

    inputs (...,); unnormalized widths/heights (..., K), derivatives
    (..., K-1). Returns (outputs, log|d outputs / d inputs|), each (...,).
    Outside [-tail_bound, tail_bound] (bounds inclusive) it is the identity
    with log-det 0.
    """
    _, cumwidths = _knots(unnormalized_widths, min_bin_width, tail_bound)
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]
    _, cumheights = _knots(unnormalized_heights, min_bin_height, tail_bound)
    heights = cumheights[..., 1:] - cumheights[..., :-1]
    derivatives = _derivatives(unnormalized_derivatives, min_derivative)  # (..., K+1)

    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    # Clamp for safe gather math; outside values are passed through below.
    x = _clip(inputs, -tail_bound, tail_bound)
    idx = _bin(x, cumheights if inverse else cumwidths)

    in_w = _take(widths, idx)
    in_cw = _take(cumwidths[..., :-1], idx)
    in_h = _take(heights, idx)
    in_ch = _take(cumheights[..., :-1], idx)
    d_k = _take(derivatives[..., :-1], idx)
    d_k1 = _take(derivatives[..., 1:], idx)
    s = in_h / in_w  # bin slope

    if not inverse:
        theta = (x - in_cw) / in_w
        theta = _clip(theta, 0.0, 1.0)
        tt = theta * (1 - theta)
        numerator = in_h * (s * theta**2 + d_k * tt)
        denominator = s + (d_k1 + d_k - 2 * s) * tt
        outputs = in_ch + numerator / denominator
        deriv_num = s**2 * (d_k1 * theta**2 + 2 * s * tt + d_k * (1 - theta) ** 2)
        logabsdet = torch.log(deriv_num) - 2 * torch.log(denominator)
    else:
        y_rel = x - in_ch
        a = in_h * (s - d_k) + y_rel * (d_k1 + d_k - 2 * s)
        b = in_h * d_k - y_rel * (d_k1 + d_k - 2 * s)
        c = -s * y_rel
        disc = b**2 - 4 * a * c
        disc = torch.maximum(disc, torch.zeros_like(disc))
        # Numerically stable quadratic root in [0, 1].
        theta = 2 * c / (-b - torch.sqrt(disc))
        theta = _clip(theta, 0.0, 1.0)
        outputs = theta * in_w + in_cw
        tt = theta * (1 - theta)
        denominator = s + (d_k1 + d_k - 2 * s) * tt
        deriv_num = s**2 * (d_k1 * theta**2 + 2 * s * tt + d_k * (1 - theta) ** 2)
        logabsdet = -(torch.log(deriv_num) - 2 * torch.log(denominator))

    outputs = torch.where(inside, outputs, inputs)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return outputs, logabsdet


def _knot_grad(idx, g_lo, g_hi, soft, min_bin, tail_bound):
    """Gradient of the unnormalized bin sizes, given the gradients of the
    chosen bin's lower and upper knots (``g_lo``, ``g_hi``, shaped like
    ``idx``): through the map onto [-B, B], the cumulative sum (its adjoint
    is a reverse cumulative sum; the constant first knot takes nothing),
    the min-bin map and the softmax."""
    K = soft.shape[-1]
    g = torch.zeros(idx.shape + (K + 1,), dtype=soft.dtype, device=soft.device)
    g.scatter_(-1, idx[..., None], (2 * tail_bound * g_lo)[..., None])
    g.scatter_add_(-1, idx[..., None] + 1, (2 * tail_bound * g_hi)[..., None])
    g_sizes = torch.flip(torch.cumsum(torch.flip(g[..., 1:], [-1]), -1), [-1])
    g_soft = (1 - min_bin * K) * g_sizes
    return soft * (g_soft - (soft * g_soft).sum(-1, keepdim=True))


def rational_quadratic_spline_vjp_plain(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    grad_outputs: torch.Tensor,
    grad_logabsdet: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 3.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vector-Jacobian product of ``rational_quadratic_spline_plain``.

    Given the upstream gradients of (outputs, logabsdet), returns the
    gradients of (inputs, unnormalized widths, heights, derivatives), each
    shaped like its input. It is the reverse mode of the forward's chain of
    expressions written out by hand (no autograd), with the tie rules of
    ``jnp.clip`` and ``jnp.maximum``: half the gradient at x = +-B, at theta
    = 0 or 1, and at a zero discriminant. Outside the bounds the spline is
    the identity: the input takes the output's gradient, the parameters
    nothing. This is the plain version of the CUDA backward kernel.
    """
    B = tail_bound
    soft_w, cumwidths = _knots(unnormalized_widths, min_bin_width, B)
    soft_h, cumheights = _knots(unnormalized_heights, min_bin_height, B)
    derivatives = _derivatives(unnormalized_derivatives, min_derivative)

    inside = (inputs >= -B) & (inputs <= B)
    x = _clip(inputs, -B, B)
    idx = _bin(x, cumheights if inverse else cumwidths)
    cw_lo, cw_hi = _take(cumwidths, idx), _take(cumwidths, idx + 1)
    ch_lo, ch_hi = _take(cumheights, idx), _take(cumheights, idx + 1)
    d_k = _take(derivatives, idx)
    d_k1 = _take(derivatives, idx + 1)
    in_w, in_h = cw_hi - cw_lo, ch_hi - ch_lo
    s = in_h / in_w
    dsum = d_k1 + d_k - 2 * s

    zero = torch.zeros_like(inputs)
    g_y = torch.where(inside, grad_outputs, zero)
    g_l = torch.where(inside, grad_logabsdet, zero)
    if not inverse:
        raw = (x - cw_lo) / in_w
        theta = _clip(raw, 0.0, 1.0)
        tt = theta * (1 - theta)
        q = d_k1 * theta**2 + 2 * s * tt + d_k * (1 - theta) ** 2
        numerator = in_h * (s * theta**2 + d_k * tt)
        denominator = s + dsum * tt
        # outputs = ch_lo + numerator / denominator;
        # logabsdet = log(s^2 q) - 2 log(denominator).
        g_num = g_y / denominator
        g_den = -g_y * numerator / denominator**2 - 2 * g_l / denominator
        g_dnum = g_l / (s**2 * q)
        g_ch_lo = g_y
        g_in_h = g_num * (s * theta**2 + d_k * tt)
        g_s = g_num * in_h * theta**2
        g_theta = g_num * in_h * 2 * s * theta
        g_dk = g_num * in_h * tt
        g_tt = g_num * in_h * d_k
        g_in_w = torch.zeros_like(inputs)
        g_cw_lo = torch.zeros_like(inputs)
    else:
        y_rel = x - ch_lo
        a = in_h * (s - d_k) + y_rel * dsum
        b = in_h * d_k - y_rel * dsum
        c = -s * y_rel
        disc = b**2 - 4 * a * c
        root = torch.sqrt(torch.clamp(disc, min=0))
        e = -b - root
        raw = 2 * c / e
        theta = _clip(raw, 0.0, 1.0)
        tt = theta * (1 - theta)
        q = d_k1 * theta**2 + 2 * s * tt + d_k * (1 - theta) ** 2
        denominator = s + dsum * tt
        # outputs = theta * in_w + cw_lo;
        # logabsdet = -(log(s^2 q) - 2 log(denominator)).
        g_theta = g_y * in_w
        g_in_w = g_y * theta
        g_cw_lo = g_y
        g_den = 2 * g_l / denominator
        g_dnum = -g_l / (s**2 * q)
        g_ch_lo = torch.zeros_like(inputs)
        g_in_h = torch.zeros_like(inputs)
        g_s = torch.zeros_like(inputs)
        g_dk = torch.zeros_like(inputs)
        g_tt = torch.zeros_like(inputs)
    # denominator = s + dsum * tt
    g_s = g_s + g_den
    g_dsum = g_den * tt
    g_tt = g_tt + g_den * dsum
    # s^2 q, q = d_k1 theta^2 + 2 s tt + d_k (1 - theta)^2
    g_s = g_s + g_dnum * 2 * s * q
    g_q = g_dnum * s**2
    g_dk1 = g_q * theta**2
    g_theta = g_theta + g_q * (2 * d_k1 * theta - 2 * d_k * (1 - theta))
    g_s = g_s + g_q * 2 * tt
    g_tt = g_tt + g_q * 2 * s
    g_dk = g_dk + g_q * (1 - theta) ** 2
    # tt = theta (1 - theta); theta = clip(raw, 0, 1)
    g_theta = g_theta + g_tt * (1 - 2 * theta)
    g_raw = g_theta * _clip_grad(raw, 0.0, 1.0)
    if not inverse:
        # raw = (x - cw_lo) / in_w
        g_x = g_raw / in_w
        g_cw_lo = -g_x
        g_in_w = -g_x * raw
    else:
        # raw = 2c / e, e = -b - sqrt(max(disc, 0)), disc = b^2 - 4ac
        g_c = g_raw * 2 / e
        g_e = -g_raw * raw / e
        g_b = -g_e
        # max(disc, 0) passes all of the gradient above 0, half at 0.
        g_disc = ((disc > 0) + 0.5 * (disc == 0)).to(disc.dtype) * (-g_e / (2 * root))
        g_b = g_b + g_disc * 2 * b
        g_a = -4 * c * g_disc
        g_c = g_c - 4 * a * g_disc
        # c = -s y_rel; b = in_h d_k - y_rel dsum; a = in_h (s - d_k) + y_rel dsum
        g_s = g_s - g_c * y_rel + g_a * in_h
        g_yrel = -g_c * s - g_b * dsum + g_a * dsum
        g_in_h = g_b * d_k + g_a * (s - d_k)
        g_dk = g_dk + g_b * in_h - g_a * in_h
        g_dsum = g_dsum - g_b * y_rel + g_a * y_rel
        # y_rel = x - ch_lo
        g_x = g_yrel
        g_ch_lo = -g_yrel
    # dsum = d_k1 + d_k - 2 s
    g_dk1 = g_dk1 + g_dsum
    g_dk = g_dk + g_dsum
    g_s = g_s - 2 * g_dsum
    # s = in_h / in_w
    g_in_h = g_in_h + g_s / in_w
    g_in_w = g_in_w - g_s * s / in_w

    # in_w = cw_hi - cw_lo and in_h = ch_hi - ch_lo, knots of the chosen bin.
    g_uw = _knot_grad(idx, g_cw_lo - g_in_w, g_in_w, soft_w, min_bin_width, B)
    g_uh = _knot_grad(idx, g_ch_lo - g_in_h, g_in_h, soft_h, min_bin_height, B)
    K = unnormalized_widths.shape[-1]
    g_deriv = torch.zeros(idx.shape + (K + 1,), dtype=inputs.dtype, device=inputs.device)
    g_deriv.scatter_(-1, idx[..., None], g_dk[..., None])
    g_deriv.scatter_add_(-1, idx[..., None] + 1, g_dk1[..., None])
    # d softplus / du = sigmoid(u); the outer knots' derivatives are constants.
    g_ud = g_deriv[..., 1:K] * torch.sigmoid(unnormalized_derivatives)
    g_inputs = torch.where(inside, g_x * _clip_grad(inputs, -B, B), grad_outputs)
    return g_inputs, g_uw, g_uh, g_ud


# ---------------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------


def build() -> Path:
    """Compile ``csrc/rqs.cu`` (both kernels) for sm_90a into ``_build/``
    (once per source hash) and return the shared library's path. Needs
    ``nvcc``."""
    global build_log
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"librqs_{digest}.so"
    if lib_path.exists():
        return lib_path
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)
    return lib_path


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.sbi_rqs_spline
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int64] * 4
            + [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_float] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        bwd = lib.sbi_rqs_spline_backward
        bwd.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int64] * 4
            + [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_float] * 4
            + [ctypes.c_void_p]
        )
        bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _call(fn, index, args):
    """Call a launcher on the current stream of CUDA device ``index``."""
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"rqs kernel launch failed: CUDA error {err}")


def _launch(x, w, h, d, inverse, tail_bound, mbw, mbh, mdr):
    global forward_launches, inverse_launches
    K = w.shape[-1]
    if not x.is_contiguous():
        x = x.contiguous()
    # Outputs in x's shape, so that no view is needed on the way out.
    y = torch.empty_like(x)
    ld = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y, ld
    # (N, K) views wherever the leading axes merge, as the conditioner's
    # slices do; unit stride along the bins is checked by _check.
    w2, h2, d2 = w.reshape(-1, K), h.reshape(-1, K), d.reshape(-1, K - 1)
    args = (x.data_ptr(), w2.data_ptr(), h2.data_ptr(), d2.data_ptr(),
            y.data_ptr(), ld.data_ptr(), n, w2.stride(0), h2.stride(0),
            d2.stride(0), K, inverse, tail_bound, mbw, mbh, mdr)
    _call((_lib or _library()).sbi_rqs_spline, x.get_device(), args)
    if inverse:
        inverse_launches += 1
    else:
        forward_launches += 1
    return y, ld


def _launch_backward(x, w, h, d, grad_y, grad_ld, needs, inverse, tail_bound, mbw, mbh, mdr):
    """The backward kernel: gradients of x, w, h, d (each contiguous, in its
    input's shape), with None where ``needs`` does not ask for one."""
    global backward_launches, backward_inverse_launches
    K = w.shape[-1]
    x = x.contiguous()
    grad_y = grad_y.contiguous()
    grad_ld = grad_ld.contiguous()
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) if need else None
            for t, need in zip((x, w, h, d), needs)]
    n = x.numel()
    if n == 0 or not any(needs):
        return outs
    w2, h2, d2 = w.reshape(-1, K), h.reshape(-1, K), d.reshape(-1, K - 1)
    ptrs = [0 if g is None else g.data_ptr() for g in outs]
    args = (x.data_ptr(), w2.data_ptr(), h2.data_ptr(), d2.data_ptr(),
            grad_y.data_ptr(), grad_ld.data_ptr(), *ptrs, n, w2.stride(0),
            h2.stride(0), d2.stride(0), K, inverse, tail_bound, mbw, mbh, mdr)
    _call((_lib or _library()).sbi_rqs_spline_backward, x.get_device(), args)
    if inverse:
        backward_inverse_launches += 1
    else:
        backward_launches += 1
    return outs


def _check(x, w, h, d):
    ws, ds = w.shape, d.shape
    K = ws[-1]
    if not 2 <= K <= MAX_BINS:
        raise ValueError(f"num_bins must be in [2, {MAX_BINS}], got {K}")
    if h.shape != ws or ws[:-1] != x.shape or ds[:-1] != x.shape or ds[-1] != K - 1:
        raise ValueError(
            f"spline shapes: widths {tuple(ws)}, heights {tuple(h.shape)}, derivatives "
            f"{tuple(ds)}; expected {tuple(x.shape) + (K,)} twice and {tuple(x.shape) + (K - 1,)}"
        )
    f32 = torch.float32
    if x.dtype != f32 or w.dtype != f32 or h.dtype != f32 or d.dtype != f32:
        raise TypeError(f"spline needs float32 tensors, got {x.dtype}, {w.dtype}, {h.dtype}, {d.dtype}")
    dev = x.device
    if w.device != dev or h.device != dev or d.device != dev:
        raise ValueError("spline tensors must lie on one device")
    if w.stride(-1) != 1 or h.stride(-1) != 1 or d.stride(-1) != 1:
        raise ValueError("spline parameters must be contiguous along the bins")


def _forward(x, w, h, d, inverse, tail_bound, mbw, mbh, mdr):
    if x.is_cuda:
        return _launch(x, w, h, d, inverse, tail_bound, mbw, mbh, mdr)
    if x.device.type != "cpu":
        raise ValueError(f"no spline kernel for device {x.device}")
    return rational_quadratic_spline_plain(x, w, h, d, inverse, tail_bound, mbw, mbh, mdr)


def tile_load(w: torch.Tensor, h: torch.Tensor, d: torch.Tensor) -> str:
    """Which tile load the kernels take for these parameters, as the
    launcher's ``make_params`` decides: ``"one_span"`` (16 B copies) where
    w, h and d are slices of one row of pitch 3K-1, ``"strided"`` otherwise."""
    K = w.shape[-1]
    P = 3 * K - 1
    w2, h2, d2 = w.reshape(-1, K), h.reshape(-1, K), d.reshape(-1, K - 1)
    one_row = (h2.data_ptr() == w2.data_ptr() + 4 * K and d2.data_ptr() == w2.data_ptr() + 8 * K)
    pitch = w2.shape[0] == 1 or w2.stride(0) == h2.stride(0) == d2.stride(0) == P
    return "one_span" if one_row and pitch else "strided"


def _merge(batch_size, in_dims, tensors):
    """A vmap rule's merge: each batched tensor with its vmapped dimension
    moved to the front (a view), each unbatched one broadcast to the batch
    size by ``expand`` (a view), as ``_rule`` in ``rqs_pallas.py`` does."""
    return [t.expand((batch_size,) + tuple(t.shape)) if dim is None else t.movedim(dim, 0)
            for t, dim in zip(tensors, in_dims)]


class _RQSpline(torch.autograd.Function):
    """The spline as an autograd Function that ``torch.func`` can transform.

    Its ``vmap`` rule is the counterpart of ``_rqs_flat_fn``
    (``sbi_tpu/ops/rqs_pallas.py:180``), the TPU kernel's ``custom_vmap``:
    the spline is elementwise over the leading axes, so a vmapped call
    merges the batch axis into the element axis and launches the kernel
    once, not once per batch element. Under nested ``vmap`` the rule runs
    level by level, still one launch per call. Inside ``torch.func.grad``
    the backward is ``_RQSplineBackward``, which has a rule of its own, so
    ``vmap(grad(...))`` launches one backward kernel per spline call."""

    @staticmethod
    def forward(x, w, h, d, inverse, tail_bound, mbw, mbh, mdr):
        return _forward(x, w, h, d, inverse, tail_bound, mbw, mbh, mdr)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:4])
        ctx.consts = inputs[4:]

    @staticmethod
    def backward(ctx, grad_y, grad_ld):
        x, w, h, d = ctx.saved_tensors
        grads = _RQSplineBackward.apply(x, w, h, d, grad_y, grad_ld,
                                        tuple(ctx.needs_input_grad[:4]), *ctx.consts)
        return (*grads, None, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, w, h, d, *consts):
        merged = _merge(info.batch_size, in_dims[:4], (x, w, h, d))
        return _RQSpline.apply(*merged, *consts), (0, 0)


class _RQSplineBackward(torch.autograd.Function):
    """The spline's VJP: the backward kernel on CUDA tensors, the plain VJP
    on CPU ones; None for the gradients that ``needs`` does not ask for.
    Its ``vmap`` rule merges the batch axis as ``_RQSpline``'s does. No
    second derivative."""

    @staticmethod
    def forward(x, w, h, d, grad_y, grad_ld, needs, inverse, tail_bound, mbw, mbh, mdr):
        consts = (inverse, tail_bound, mbw, mbh, mdr)
        if x.is_cuda:
            return tuple(_launch_backward(x, w, h, d, grad_y, grad_ld, needs, *consts))
        if x.device.type != "cpu":
            raise ValueError(f"no spline kernel for device {x.device}")
        grads = rational_quadratic_spline_vjp_plain(x, w, h, d, grad_y, grad_ld, *consts)
        return tuple(g if need else None for g, need in zip(grads, needs))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the RQ spline's gradient is not differentiable here")

    @staticmethod
    def vmap(info, in_dims, x, w, h, d, grad_y, grad_ld, needs, *consts):
        merged = _merge(info.batch_size, in_dims[:6], (x, w, h, d, grad_y, grad_ld))
        grads = _RQSplineBackward.apply(*merged, needs, *consts)
        return grads, tuple(None if g is None else 0 for g in grads)


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 3.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spline of ``rational_quadratic_spline_plain``, differentiable.

    A CUDA tensor goes through the kernel (one launch for all leading axes)
    and its gradient through the backward kernel (one launch), a CPU tensor
    through the plain version and its VJP. float32 only; the parameters
    must have unit stride along the bins; 2 <= K <= ``MAX_BINS``. Under
    ``torch.func`` transforms (``vmap``, ``grad``) it always goes through
    the ``autograd.Function``, whose rules unwrap the transformed tensors:
    one launch per call, whatever the vmapped batch. Without a transform
    and without a gradient to record (``no_grad``, or no input that
    requires one) the ``autograd.Function`` is skipped.
    """
    x, w, h, d = inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives
    _check(x, w, h, d)
    consts = (bool(inverse), float(tail_bound), float(min_bin_width),
              float(min_bin_height), float(min_derivative))
    if torch._C._are_functorch_transforms_active() or (torch.is_grad_enabled() and (
        x.requires_grad or w.requires_grad or h.requires_grad or d.requires_grad
    )):
        return _RQSpline.apply(x, w, h, d, *consts)
    return _forward(x, w, h, d, *consts)
