"""Rational-quadratic spline: plain PyTorch version, CUDA kernel and wrapper.

The hand-written kernel is ``sbi_tpu_torch/csrc/rqs.cu``. It replaces the
TPU kernel ``sbi_tpu/ops/rqs_pallas.py::_rqs_kernel`` (launched by
``_rqs_pallas_raw``) and computes, per element, the same monotone spline with
linear tails as ``rational_quadratic_spline_plain`` below, which is a
line-for-line port of ``sbi_tpu/neural_nets/estimators/flows.py:91-157``.

What bounds the kernel on the card: memory. Per element it reads
4 + 4·(3K−1) bytes and writes 8 (128 B at K = 10) against about 2K
exponentials, two softplus and two logs. A block copies a tile of elements'
parameters into shared memory with coalesced ``cp.async`` copies (16 B
pieces where the widths, heights and derivatives are slices of one row, as
the conditioners give them; a strided tile load otherwise), then each thread
computes one element from there. The wrapper copies nothing and the TPU's
(K, N) transpose and 1024-lane padding are gone. K runs from 2 to
``MAX_BINS``.

``rational_quadratic_spline`` is the entry point. On a CPU tensor it runs the
plain version; on a CUDA tensor it launches the kernel or raises. Where a
gradient is wanted it goes through an ``autograd.Function`` whose backward
recomputes through the plain version (as ``_bwd`` in ``rqs_pallas.py``
takes the VJP of the jnp reference); there is no backward kernel. The kernel
is built with ``nvcc`` at first use into ``sbi_tpu_torch/_build/`` and
bound with ``ctypes``.
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

# Kernel launches, by direction. Incremented where the kernel is launched and
# nowhere else; callers reset them to 0 to count the launches of one run.
forward_launches = 0
inverse_launches = 0

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


def _softplus(a: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (no threshold, unlike ``F.softplus``)."""
    return a.clamp(min=0) + torch.log1p(torch.exp(-a.abs()))


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
    K = unnormalized_widths.shape[-1]
    widths = torch.softmax(unnormalized_widths, dim=-1)
    widths = min_bin_width + (1 - min_bin_width * K) * widths
    cumwidths = torch.cumsum(widths, dim=-1)
    cumwidths = torch.cat([torch.zeros_like(cumwidths[..., :1]), cumwidths], -1)
    cumwidths = (cumwidths * 2 - 1) * tail_bound  # map [0,1] -> [-B, B]
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]

    heights = torch.softmax(unnormalized_heights, dim=-1)
    heights = min_bin_height + (1 - min_bin_height * K) * heights
    cumheights = torch.cumsum(heights, dim=-1)
    cumheights = torch.cat([torch.zeros_like(cumheights[..., :1]), cumheights], -1)
    cumheights = (cumheights * 2 - 1) * tail_bound
    heights = cumheights[..., 1:] - cumheights[..., :-1]

    derivs_inner = min_derivative + _softplus(unnormalized_derivatives)
    # Boundary derivatives = 1 so the spline matches linear tails.
    ones = torch.ones_like(derivs_inner[..., :1])
    derivatives = torch.cat([ones, derivs_inner, ones], dim=-1)  # (..., K+1)

    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    # Clamp for safe gather math; outside values are passed through below.
    x = _clip(inputs, -tail_bound, tail_bound)

    # Bin index: the last bin whose lower knot is <= x.
    ref = cumheights if inverse else cumwidths
    idx = (x[..., None] >= ref[..., :-1]).to(torch.int64).sum(-1) - 1
    idx = idx.clamp(0, K - 1)

    def take(a, i):
        return torch.gather(a, -1, i[..., None])[..., 0]

    in_w = take(widths, idx)
    in_cw = take(cumwidths[..., :-1], idx)
    in_h = take(heights, idx)
    in_ch = take(cumheights[..., :-1], idx)
    d_k = take(derivatives[..., :-1], idx)
    d_k1 = take(derivatives[..., 1:], idx)
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


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


def build() -> Path:
    """Compile ``csrc/rqs.cu`` for sm_90a into ``_build/`` (once per source
    hash) and return the shared library's path. Needs ``nvcc``."""
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
        _lib = lib
    return _lib


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
    fn = (_lib or _library()).sbi_rqs_spline
    index = x.get_device()
    args = (x.data_ptr(), w2.data_ptr(), h2.data_ptr(), d2.data_ptr(),
            y.data_ptr(), ld.data_ptr(), n, w2.stride(0), h2.stride(0),
            d2.stride(0), K, inverse, tail_bound, mbw, mbh, mdr)
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"rqs kernel launch failed: CUDA error {err}")
    if inverse:
        inverse_launches += 1
    else:
        forward_launches += 1
    return y, ld


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


class _RQSpline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, h, d, inverse, tail_bound, mbw, mbh, mdr):
        ctx.save_for_backward(x, w, h, d)
        ctx.consts = (inverse, tail_bound, mbw, mbh, mdr)
        return _forward(x, w, h, d, inverse, tail_bound, mbw, mbh, mdr)

    @staticmethod
    def backward(ctx, grad_y, grad_ld):
        # Exact gradients through the plain version's autograd graph.
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, ld = rational_quadratic_spline_plain(*leaves, *ctx.consts)
            grads = torch.autograd.grad((y, ld), leaves, (grad_y, grad_ld), allow_unused=True)
        return (*grads, None, None, None, None, None)


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

    A CUDA tensor goes through the kernel (one launch for all leading axes),
    a CPU tensor through the plain version. float32 only; the parameters
    must have unit stride along the bins; 2 <= K <= ``MAX_BINS``. Without a
    gradient to record (``no_grad``, or no input that requires one) the
    ``autograd.Function`` is skipped.
    """
    x, w, h, d = inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives
    _check(x, w, h, d)
    consts = (bool(inverse), float(tail_bound), float(min_bin_width),
              float(min_bin_height), float(min_derivative))
    if torch.is_grad_enabled() and (
        x.requires_grad or w.requires_grad or h.requires_grad or d.requires_grad
    ):
        return _RQSpline.apply(x, w, h, d, *consts)
    return _forward(x, w, h, d, *consts)
