"""Dense causal flash attention with GQA: the dense arm of the one-shot Stem
prefill (port of ``repro/kernels/flash_attention.py``).

``flash_attention`` launches a hand-written CUDA kernel for ``sm_90a``
(``csrc/flash_attention.cu``) that replaces the Pallas TPU kernel
``_flash_kernel`` (``src/repro/kernels/flash_attention.py:34``): key blocks
above the diagonal skipped, the diagonal masked exactly, KV head = query
head // group, fp32 accumulation, output in q's dtype.  Compute-bound on the
H100 (2 * (d + dv) flops per causal pair): bf16 at q/k = v head_dim 128
runs on the tensor cores (TMA + wgmma, P rounded to bf16 before P.V as
SDPA's kernels do); fp32, and bf16 at the other (q/k, v) head_dim pairs of
``HEAD_DIM_PAIRS`` (8-256, and MLA's v narrower than q/k), on the fp32 CUDA
cores (bf16 loaded and stored, the math in fp32).

Beside the kernel sits its plain PyTorch version (``flash_attention_plain``)
and a plain-int launch counter in ``LAUNCHES``.  The wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check_head_dim_pair

NEG_INF = -1e30

LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_stem_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.stem_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f, p]
        lib.stem_flash_attention.restype = i
        lib.stem_wgmma_tile_products.argtypes = [p] * 7
        lib.stem_wgmma_tile_products.restype = i
        lib._stem_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale=None) -> torch.Tensor:
    """Plain version: causal masked softmax in fp32, GQA, streamed over
    query-row chunks (each sees keys up to its last row).
    q: (b, hq, n, d); k: (b, hk, n, d); v: (b, hk, n, dv) -> (b, hq, n, dv)
    in q's dtype."""
    b, hq, n, d = q.shape
    hk = k.shape[1]
    group = hq // hk
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, n, v.shape[-1]), dtype=q.dtype, device=q.device)
    kf, vf = k.float(), v.float()
    step = max(1, (1 << 28) // (b * hq * n))     # ~2^28 scores per step
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        qg = q[:, :, r0:r1].float().reshape(b, hk, group, r1 - r0, d)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf[:, :, :r1]) * scale
        keep = (torch.arange(r1, device=q.device)[None, :]
                <= torch.arange(r0, r1, device=q.device)[:, None])
        p = torch.softmax(torch.where(keep, s, NEG_INF), dim=-1)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf[:, :, :r1])
        out[:, :, r0:r1] = o.reshape(b, hq, r1 - r0, -1).to(q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale=None) -> torch.Tensor:
    """Causal flash attention.  q: (b, hq, n, d); k: (b, hk, n, d); v:
    (b, hk, n, dv) -> (b, hq, n, dv).  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale)
    _check(q.device.type == "cuda", f"flash_attention: unsupported device {q.device}")
    b, hq, n, d = q.shape
    hk, dv = k.shape[1], v.shape[-1]
    _check(k.device == q.device and v.device == q.device,
           "flash_attention: all tensors must be on one device")
    _check(q.dtype in (torch.float32, torch.bfloat16)
           and k.dtype == q.dtype and v.dtype == q.dtype,
           "flash_attention: q/k/v must share a float32 or bfloat16 dtype")
    _check(all(t.is_contiguous() for t in (q, k, v)),
           "flash_attention: inputs must be contiguous")
    _check(tuple(k.shape) == (b, hk, n, d) and tuple(v.shape) == (b, hk, n, dv),
           "flash_attention: needs seq_q == seq_k, equal q/k head dims and v "
           "of shape (b, hk, n, dv)")
    check_head_dim_pair("flash_attention", d, dv)
    _check(hk > 0 and hq % hk == 0, "flash_attention: kv heads must divide q heads")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
           "flash_attention: inputs must be 16-byte aligned (TMA, 16-byte loads)")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, n, dv), dtype=q.dtype, device=q.device)
    err = _lib().stem_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hk, n,
        d, dv, int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem_flash_attention launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out


def wgmma_tile_products(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor,
                        v: torch.Tensor) -> tuple:
    """The bf16 tensor-core tile's two products on one 128 x 128 tile, for
    testing its shared-memory layouts: (a @ b.T, p @ v) in fp32, computed
    as the tile computes Q.K^T and P.V.  a, b, p, v: (128, 128) bf16
    tensors on one CUDA device."""
    _check(all(t.device.type == "cuda" and t.device == a.device
               and t.dtype == torch.bfloat16 and tuple(t.shape) == (128, 128)
               and t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (a, b, p, v)),
           "wgmma_tile_products: needs four contiguous (128, 128) bf16 CUDA tensors")
    s = torch.empty((128, 128), dtype=torch.float32, device=a.device)
    o = torch.empty_like(s)
    err = _lib().stem_wgmma_tile_products(
        a.data_ptr(), b.data_ptr(), p.data_ptr(), v.data_ptr(), s.data_ptr(),
        o.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem_wgmma_tile_products launch failed: cudaError {err}")
    return s, o
