"""Dense causal flash attention with GQA: the dense arm of the one-shot Stem
prefill (port of ``repro/kernels/flash_attention.py``).

``flash_attention`` launches a hand-written CUDA kernel for ``sm_90a``
(``csrc/flash_attention.cu``) that replaces the Pallas TPU kernel
``_flash_kernel`` (``src/repro/kernels/flash_attention.py:34``): key blocks
above the diagonal skipped, the diagonal masked exactly, KV head = query
head // group, fp32 accumulation, output in q's dtype.  Compute-bound on the
H100 (2 * (d + dv) flops per causal pair).  ``forward_route`` picks the
tile: bf16 at a (q/k, v) pair of ``WGMMA_PAIRS`` ((64, 64), (128, 128),
MLA's (192, 128) and (192, 192), (256, 256)) runs on the tensor cores (TMA
+ wgmma, P rounded to bf16 before P.V as SDPA's kernels do); fp32, and
bf16 at the narrow pairs of ``HEAD_DIM_PAIRS`` (8-32, MLA's reduced (24,
16) / (24, 24)), on the fp32 CUDA cores (bf16 loaded and stored, the math
in fp32).

Beside the kernel sits its plain PyTorch version (``flash_attention_plain``)
and plain-int launch counters in ``LAUNCHES``: every forward launch, and
one per tensor-core instance (``wgmma_counter``).  The wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises; for ``meta`` tensors (the dry run) it returns outputs of
the right shape and dtype and reports the call's work to
``kernels.cost`` (the formulas ``PERF.md`` bounds the kernel with),
building and loading nothing.

With ``return_lse`` the forward also returns each row's natural-log
log-sum-exp (b, hq, n) fp32, written by the kernel's epilogue (serving asks
for none and pays nothing).

The gradient (``flash_attention_bwd``, the training path's): the TPU kernel
has none, as the reference trains through XLA's autodiff of its jnp dense
attention, so the port's counterpart is a hand-written backward
(``stem_flash_attention_bwd``: dq, then dk and dv, no atomics) that reads
the forward's lse.  ``backward_route`` picks its kernels, the forward's
table: bf16 at ``WGMMA_PAIRS`` on the tensor cores
(``csrc/attn_bwd_wgmma.cuh``: TMA + wgmma, P and dS rounded to bf16 as
SDPA's backward does, one instance per pair), every other shape on the
fp32 CUDA cores (``csrc/attn_bwd.cuh``).  Beside them sit the plain
version, the analytic backward ``dS = P * (dP - delta)``
(``flash_attention_bwd_plain``, P in fp32), and counters of all backward
launches, of the tensor-core route's and of each of its instances
(``wgmma_counter("flash_attention_bwd", d, dv)``).  ``attention`` is the
differentiable call
(``torch.autograd.Function``): forward and backward both kernels on a CUDA
tensor, both plain versions on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (WGMMA_PAIRS, backward_route, check_head_dim_pair,
                                 forward_route, split_scratch, wgmma_counter)
from repro_torch.kernels import cost

NEG_INF = -1e30

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
            **{wgmma_counter(k, d, dv): 0 for k in ("flash_attention", "flash_attention_bwd")
               for d, dv in WGMMA_PAIRS}}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_stem_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.stem_flash_attention.argtypes = [p] * 5 + [i] * 7 + [f, p]
        lib.stem_flash_attention.restype = i
        lib.stem_flash_attention_bwd.argtypes = [p] * 11 + [i] * 8 + [f, p, i]
        lib.stem_flash_attention_bwd.restype = i
        lib.stem_flash_attention_bwd_split.argtypes = [i] * 6
        lib.stem_flash_attention_bwd_split.restype = i
        lib.stem_wgmma_tile_products.argtypes = [p] * 7
        lib.stem_wgmma_tile_products.restype = i
        lib._stem_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale=None, return_lse: bool = False):
    """Plain version: causal masked softmax in fp32, GQA, streamed over
    query-row chunks (each sees keys up to its last row).
    q: (b, hq, n, d); k: (b, hk, n, d); v: (b, hk, n, dv) -> (b, hq, n, dv)
    in q's dtype; with ``return_lse`` also each row's log-sum-exp of its
    scaled scores (b, hq, n) fp32."""
    b, hq, n, d = q.shape
    hk = k.shape[1]
    group = hq // hk
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, n, v.shape[-1]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, n), dtype=torch.float32, device=q.device)
    kf, vf = k.float(), v.float()
    step = max(1, (1 << 28) // (b * hq * n))     # ~2^28 scores per step
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        qg = q[:, :, r0:r1].float().reshape(b, hk, group, r1 - r0, d)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf[:, :, :r1]) * scale
        keep = (torch.arange(r1, device=q.device)[None, :]
                <= torch.arange(r0, r1, device=q.device)[:, None])
        s = torch.where(keep, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf[:, :, :r1])
        out[:, :, r0:r1] = o.reshape(b, hq, r1 - r0, -1).to(q.dtype)
        if return_lse:
            lse[:, :, r0:r1] = torch.logsumexp(s, dim=-1).reshape(b, hq, r1 - r0)
    return (out, lse) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale=None, return_lse: bool = False):
    """Causal flash attention.  q: (b, hq, n, d); k: (b, hk, n, d); v:
    (b, hk, n, dv) -> (b, hq, n, dv); with ``return_lse`` the pair (out,
    lse), lse (b, hq, n) fp32 each row's natural-log log-sum-exp (the
    backward's input).  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, return_lse=return_lse)
    if q.device.type == "meta":
        b, hq, n, _ = q.shape
        out = torch.empty((b, hq, n, v.shape[-1]), dtype=q.dtype, device=q.device)
        cost.note_kernel("flash_attention", *cost.flash_bytes_flops(q, k, v), like=q)
        if not return_lse:
            return out
        return out, torch.empty((b, hq, n), dtype=torch.float32, device=q.device)
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
    lse = (torch.empty((b, hq, n), dtype=torch.float32, device=q.device) if return_lse
           else None)
    err = _lib().stem_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, hq, hk, n, d, dv,
        int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem_flash_attention launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    if forward_route(q.dtype, d, dv) == "wgmma":
        LAUNCHES[wgmma_counter("flash_attention", d, dv)] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, o, do, *, scale=None) -> tuple:
    """Plain version of the backward: with S = scale * q.k^T (causal), P =
    softmax(S), delta = rowsum(do * o), dP = do.v^T and dS = P * (dP -
    delta): dq = scale * dS.k, dk = scale * dS^T.q, dv = P^T.do, summed over
    each KV head's query heads, in fp32, streamed over query-row chunks.
    P is recomputed, so it takes no lse.  Returns (dq, dk, dv) in the
    inputs' dtype."""
    b, hq, n, d = q.shape
    hk, dv_dim = k.shape[1], v.shape[-1]
    group = hq // hk
    scale = d ** -0.5 if scale is None else scale
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(q)
    dk = torch.zeros((b, hk, n, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, hk, n, dv_dim), dtype=torch.float32, device=q.device)
    step = max(1, (1 << 26) // (b * hq * n))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        qg = q[:, :, r0:r1].float().reshape(b, hk, group, r1 - r0, d)
        og = o[:, :, r0:r1].float().reshape(b, hk, group, r1 - r0, dv_dim)
        dog = do[:, :, r0:r1].float().reshape(b, hk, group, r1 - r0, dv_dim)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf[:, :, :r1]) * scale
        keep = (torch.arange(r1, device=q.device)[None, :]
                <= torch.arange(r0, r1, device=q.device)[:, None])
        p = torch.softmax(torch.where(keep, s, NEG_INF), dim=-1)
        delta = (dog * og).sum(dim=-1, keepdim=True)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf[:, :, :r1])
        ds = p * (dp - delta)
        dq[:, :, r0:r1] = (torch.einsum("bhgqk,bhkd->bhgqd", ds, kf[:, :, :r1])
                           * scale).reshape(b, hq, r1 - r0, d).to(q.dtype)
        dk[:, :, :r1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
        dv[:, :, :r1] += torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, do, *, scale=None, lse=None) -> tuple:
    """The gradient of ``flash_attention``: (dq, dk, dv) for its inputs
    q, k, v, its output o, o's gradient do and the forward's ``lse``
    (``return_lse``; required on a CUDA tensor).  CPU tensors take the
    plain version; CUDA tensors launch the kernels of ``backward_route``
    (two launches, one count, and on the wgmma route one more and one of
    its instance's)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, scale=scale)
    if q.device.type == "meta":
        b, hq, n, _ = q.shape
        cost.note_kernel("flash_attention_bwd", *cost.bwd_bytes_flops(
            q, k, v, b * hq * n * (n + 1) / 2), like=q)
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return _bwd_launch(q, k, v, o, do, scale, lse, None)


def _bwd_launch(q, k, v, o, do, scale, lse, route) -> tuple:
    """``flash_attention_bwd`` on the card, on ``route``: None for
    ``backward_route``'s, or "cuda_core" for the CUDA-core kernels at any
    shape (the route the tensor-core kernels replaced; chip_smoke.py times
    and checks it beside them)."""
    _check(q.device.type == "cuda", f"flash_attention_bwd: unsupported device {q.device}")
    b, hq, n, d = q.shape
    hk, dv_dim = k.shape[1], v.shape[-1]
    _check(lse is not None and lse.dtype == torch.float32
           and tuple(lse.shape) == (b, hq, n) and lse.is_contiguous(),
           "flash_attention_bwd: needs the forward's lse, (b, hq, n) contiguous fp32")
    _check(all(t.device == q.device for t in (k, v, o, do, lse)),
           "flash_attention_bwd: all tensors must be on one device")
    _check(q.dtype in (torch.float32, torch.bfloat16)
           and all(t.dtype == q.dtype for t in (k, v, o, do)),
           "flash_attention_bwd: q/k/v/o/do must share a float32 or bfloat16 dtype")
    _check(all(t.is_contiguous() for t in (q, k, v, o, do)),
           "flash_attention_bwd: inputs must be contiguous")
    _check(tuple(k.shape) == (b, hk, n, d) and tuple(v.shape) == (b, hk, n, dv_dim)
           and tuple(o.shape) == (b, hq, n, dv_dim) and do.shape == o.shape,
           "flash_attention_bwd: needs seq_q == seq_k, equal q/k head dims, v of "
           "shape (b, hk, n, dv) and o, do of shape (b, hq, n, dv)")
    check_head_dim_pair("flash_attention_bwd", d, dv_dim)
    _check(hk > 0 and hq % hk == 0, "flash_attention_bwd: kv heads must divide q heads")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, o, do)),
           "flash_attention_bwd: inputs must be 16-byte aligned (TMA, 16-byte loads)")
    scale = d ** -0.5 if scale is None else scale
    _check(route in (None, "cuda_core"), f"flash_attention_bwd: unknown route {route!r}")
    route = route or backward_route(q.dtype, d, dv_dim)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    part = split_scratch(_lib().stem_flash_attention_bwd_split, route, q, k, v)
    err = _lib().stem_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        part.data_ptr() if part is not None else None, b, hq, hk, n, d, dv_dim,
        int(q.dtype == torch.bfloat16), int(route == "wgmma"),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream, q.device.index)
    if err != 0:
        raise RuntimeError(f"stem_flash_attention_bwd launch failed ({route}): "
                           f"cudaError {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    if route == "wgmma":
        LAUNCHES["flash_attention_bwd_wgmma"] += 1
        LAUNCHES[wgmma_counter("flash_attention_bwd", d, dv_dim)] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Causal flash attention with its hand-written gradient.  The forward
    runs ``flash_attention`` with ``return_lse`` and saves q, k, v, the
    output and the row log-sum-exp; the backward hands them with do to
    ``flash_attention_bwd``, which on the card routes bf16 at
    ``WGMMA_PAIRS`` to the wgmma kernels and every other shape to the CUDA-core ones
    (neither recomputes the lse).  On the CPU both are plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention(q, k, v, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), scale=ctx.scale,
                                         lse=lse)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale=None) -> torch.Tensor:
    """Differentiable causal flash attention: ``flash_attention`` forward,
    ``flash_attention_bwd`` backward (kernels on a CUDA tensor, the plain
    versions on the CPU).  A call that needs no gradient (serving, or
    under ``torch.no_grad``) is the plain forward call: no lse is stored."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return flash_attention(q, k, v, scale=scale)
    return _Attention.apply(q, k, v, scale)


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
