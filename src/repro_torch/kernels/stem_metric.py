"""Metric downsampling of the one-shot Stem prefill (port of
``repro/kernels/stem_metric.py``).

Two hand-written CUDA kernels for ``sm_90a`` (``csrc/stem_metric.cu``)
replace the two Pallas TPU kernels:

* ``antidiag_pool`` replaces ``_pool_kernel``
  (``src/repro/kernels/stem_metric.py:27``): per block of ``block_size``
  tokens, the mean over the ``block_size / stride`` rows of each residue
  ``u mod stride`` — ``(..., n, d) -> (..., n / block_size, stride, d)``.
* ``value_magnitude`` replaces ``_vmag_kernel``
  (``src/repro/kernels/stem_metric.py:57``): per block, the max over tokens
  of ``log(max(||v_j||_2, 1e-20))`` — ``(..., n, d) -> (..., n / block_size)``
  float32.

Both read each element once: bytes-bound on the H100.  A pool thread
sums a strip of 16 bytes (8 bf16 or 4 fp32 columns) over the block's
groups where ``x`` and ``out`` are 16-byte aligned and a row is a whole
number of 16-byte strips, and the same kernel runs on scalar loads
otherwise (``pool_vector_width``).  A vmag thread likewise owns a 16-byte
strip of a row, the row's threads summing its squared norm with shuffles;
it takes the scalar loads where ``v`` is misaligned or a row is not a
power-of-two number of strips, at most 64 (``vmag_vector_width``).  Both
take any head_dim, block size and stride.  The pool's output dtype is an
argument: float32 as the reference wrapper writes it, or the input dtype
where the port replaces ``metric.antidiag_pool``, whose mean keeps q's
dtype (sum in fp32, then rounded).

Beside each kernel sits its plain PyTorch version and a plain-int launch
counter in ``LAUNCHES``.  A wrapper takes the plain version only for
tensors on the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

# Kernel launches, counted where each wrapper launches its CUDA kernel and
# nowhere else (the CPU plain path does not count).
LAUNCHES = {"antidiag_pool": 0, "value_magnitude": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("stem_metric")
    if not getattr(lib, "_stem_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.stem_antidiag_pool.argtypes = [p, p, i, i, i, i, i, i, i, i, p]
        lib.stem_antidiag_pool.restype = i
        lib.stem_value_magnitude.argtypes = [p, p, i, i, i, i, i, i, p]
        lib.stem_value_magnitude.restype = i
        lib._stem_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_input(name: str, x: torch.Tensor, block_size: int) -> int:
    """Checks shared by both kernels; returns the flattened lead size."""
    _check(x.device.type == "cuda", f"{name}: unsupported device {x.device}")
    _check(x.dtype in _DTYPES, f"{name}: dtype must be float32 or bfloat16")
    _check(x.dim() >= 2 and x.is_contiguous(), f"{name}: input must be contiguous (..., n, d)")
    _check(x.shape[-2] % block_size == 0,
           f"{name}: length {x.shape[-2]} is not a multiple of {block_size}")
    bh = math.prod(x.shape[:-2])
    _check(bh > 0, f"{name}: empty input")
    return bh


def pool_vector_width(x: torch.Tensor, out: torch.Tensor) -> int:
    """Elements a pool-kernel thread loads at once: 16 bytes' worth when
    ``x`` and ``out`` are 16-byte aligned and a row of ``x`` is a whole
    number of 16-byte strips, else 1 (the scalar-load variant)."""
    elt = x.element_size()
    wide = (x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
            and (x.shape[-1] * elt) % 16 == 0)
    return 16 // elt if wide else 1


def vmag_vector_width(v: torch.Tensor) -> int:
    """Elements a vmag-kernel thread loads at once: 16 bytes' worth when
    ``v`` is 16-byte aligned and a row of it is a power-of-two number of
    16-byte strips, at most 64 (head_dims 8-256), else 1 (the scalar-load
    variant)."""
    elt = v.element_size()
    strips, rem = divmod(v.shape[-1] * elt, 16)
    wide = (v.data_ptr() % 16 == 0 and rem == 0 and 0 < strips <= 64
            and strips & (strips - 1) == 0)
    return 16 // elt if wide else 1


def antidiag_pool_plain(x: torch.Tensor, *, block_size: int, stride: int,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: fp32 group means, cast to ``out_dtype``."""
    *lead, n, d = x.shape
    xb = x.reshape(*lead, n // block_size, block_size // stride, stride, d)
    return xb.float().mean(dim=-3).to(out_dtype)


def antidiag_pool(x: torch.Tensor, *, block_size: int = 128, stride: int = 16,
                  out_dtype=torch.float32) -> torch.Tensor:
    """(..., n, d) -> (..., n / block_size, stride, d) group means in
    ``out_dtype``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if x.device.type == "cpu":
        return antidiag_pool_plain(x, block_size=block_size, stride=stride,
                                   out_dtype=out_dtype)
    bh = _check_input("antidiag_pool", x, block_size)
    _check(out_dtype in _DTYPES, "antidiag_pool: out_dtype must be float32 or bfloat16")
    _check(block_size % stride == 0, "antidiag_pool: stride must divide block_size")
    *lead, n, d = x.shape
    out = torch.empty((*lead, n // block_size, stride, d), dtype=out_dtype,
                      device=x.device)
    err = _lib().stem_antidiag_pool(
        x.data_ptr(), out.data_ptr(), bh, n, d, block_size, stride,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        pool_vector_width(x, out), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem_antidiag_pool launch failed: cudaError {err}")
    LAUNCHES["antidiag_pool"] += 1
    return out


def value_magnitude_plain(v: torch.Tensor, *, block_size: int) -> torch.Tensor:
    """Plain version: block max of log(max(||v_j||_2, 1e-20)), float32."""
    *lead, n, _ = v.shape
    norms = torch.linalg.vector_norm(v.float(), dim=-1)
    log_norms = torch.log(torch.clamp(norms, min=1e-20))
    return log_norms.reshape(*lead, n // block_size, block_size).amax(dim=-1)


def value_magnitude(v: torch.Tensor, *, block_size: int = 128) -> torch.Tensor:
    """(..., n, d) -> (..., n / block_size) float32.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if v.device.type == "cpu":
        return value_magnitude_plain(v, block_size=block_size)
    bh = _check_input("value_magnitude", v, block_size)
    *lead, n, d = v.shape
    out = torch.empty((*lead, n // block_size), dtype=torch.float32, device=v.device)
    err = _lib().stem_value_magnitude(
        v.data_ptr(), out.data_ptr(), bh, n, d, block_size,
        int(v.dtype == torch.bfloat16), vmag_vector_width(v),
        torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem_value_magnitude launch failed: cudaError {err}")
    LAUNCHES["value_magnitude"] += 1
    return out
