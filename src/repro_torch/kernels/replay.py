"""Record the kernel calls a run makes and hold each against its plain
version, at the shapes and on the data the run gave the kernels.

    with replay.Recorder() as rec:
        engine.run(requests)
    report = rec.check()     # raises unless every recorded call matches

Inside the block the six kernel wrappers (``score_pages``,
``attend_pages``, ``block_sparse_attention``, ``flash_attention``,
``antidiag_pool``, ``value_magnitude``) and the two attention backward
wrappers (``flash_attention_bwd``, ``block_sparse_attention_bwd``) are
replaced by module attribute, so calls from the runtime and from autograd
reach the recording versions.  A recorded call clones its tensor arguments
before the wrapper runs and its output (each tensor of a tuple) after.
A kernel (a paged kernel with its lane) keeps up to ``KEEP`` calls:
each call with a set of argument shapes not seen before, and the 1st,
2nd, 4th, 8th, ... call, so that early and late steps of a run are held.
Cloning launches no kernel of the port, so the launch counters read after
the block count the run alone.  ``check`` runs each plain version on the
recorded arguments and compares it with the recorded output under
``tolerance`` (a backward's dq, dk, dv under ``grad_tolerance``; a
forward's saved lse by ``check_lse``).
"""
from __future__ import annotations

import inspect

import torch

from repro_torch.kernels import backward_route, forward_route
from repro_torch.kernels import block_sparse_attn as bsa_kern
from repro_torch.kernels import flash_attention as flash_kern
from repro_torch.kernels import paged_attn as paged_kern
from repro_torch.kernels import stem_metric as metric_kern


def tolerance(want: torch.Tensor, dtype, p_bf16: bool = False):
    """The limit of |kernel - plain| per element (want in fp32): 1e-4 for
    fp32 outputs; for bf16 outputs 2 bf16 ulps of the plain value plus a
    floor of 1e-3 * the max|plain| of its row (the last axis), for values
    near 0.  The floor is per row because an attention row over m keys has
    outputs of about sqrt(e / m): a floor over the whole tensor would be as
    large as a long row's values.  p_bf16: the bf16 attention kernels on
    the tensor-core tile (flash and block-sparse where ``forward_route``
    says "wgmma", the paged chunk lane at head_dim and page size 128) round the probabilities P to bf16 before
    P.V (as SDPA's and flex_attention's kernels do) while the plain version
    keeps P in fp32, so their row floor is 1e-2 * max|plain| in place of
    1e-3."""
    if dtype == torch.float32:
        return 1e-4
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    floor = (1e-2 if p_bf16 else 1e-3) * want.abs().amax(dim=-1, keepdim=True)
    return 2 * ulp + floor


def grad_tolerance(want: torch.Tensor, dtype, p_bf16: bool = False):
    """The limit of |kernel - plain| per element of an attention gradient
    (dq, dk or dv; want in fp32): ``tolerance`` plus, in bf16, 1e-4 * the
    tensor's max|plain|.  That floor covers rows whose gradient cancels: a
    query row that sees one key has dS = dP - delta = 0 up to the fp32 sums'
    rounding, taken in other orders by the kernel and the plain version, so
    such a row is ~1e-7 of the tensor's scale in one and ~0 in the other.
    p_bf16: the tensor-core backward (``backward_route`` "wgmma") rounds P
    and dS to bf16 before its products, as SDPA's backward does, while the
    plain version keeps them in fp32; the CUDA-core backward keeps them in
    fp32 and is held at the 1e-3 row floor.  In fp32 the limit is 1e-4 *
    min(1, max|plain|): ``tolerance``'s 1e-4 for gradients of order 1, and
    1e-4 of the tensor's scale below it (a loss's mean over many tokens
    gives gradients far below 1, where an absolute 1e-4 would pass zeros);
    1e-30 at least, for a tensor that is all zeros."""
    if dtype == torch.float32:
        return 1e-4 * want.abs().max().clamp(min=1e-26, max=1.0)
    return tolerance(want, dtype, p_bf16) + 1e-4 * want.abs().max()


def check_lse(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple:
    """A forward kernel's saved log-sum-exp against the plain forward's
    (fp32 in every dtype): +inf in the same rows (no key seen), elsewhere
    within 1e-5 of the largest |plain| (the same fp32 row sums taken in
    another order).  Raises AssertionError where they disagree; returns
    (max |kernel - plain|, its limit, the rows that saw no key)."""
    got, want = got.float(), want.float()
    inf = torch.isinf(want)
    if not torch.equal(torch.isinf(got), inf) or not bool((got[inf] > 0).all()):
        raise AssertionError(f"{name}: the saved lse's +inf rows differ")
    if not bool(torch.isfinite(got[~inf]).all()):
        raise AssertionError(f"{name}: the saved lse is not finite")
    if bool(inf.all()):
        return 0.0, 0.0, int(inf.sum())
    err = float((got - want)[~inf].abs().max())
    limit = 1e-5 * float(want[~inf].abs().max())
    if not err <= limit:
        raise AssertionError(f"{name}: the saved lse disagrees with the plain "
                             f"forward's: max |kernel - plain| = {err}, limit {limit}")
    return err, limit, int(inf.sum())


def _live_counts(a):
    if a["live_counts"] is not None:
        return a["live_counts"]
    return a["slot_mask"].sum(dim=-1, dtype=torch.int32)


# name -> (module, plain version of the bound arguments, does the kernel
# round P to bf16 on the tensor-core tile for these arguments)
KERNELS = {
    "score_pages": (
        paged_kern,
        lambda a: paged_kern.score_pages_plain(
            a["qp"], a["kg_pool"], a["page_table"], group=a["group"],
            scale=a["scale"], pair=a["pair"]),
        lambda a: False),
    "attend_pages": (
        paged_kern,
        lambda a: paged_kern.attend_pages_plain(
            a["q"], a["k_pool"], a["v_pool"], a["gp"], a["idx"], a["cnt"], a["pos"],
            block_size=a["block_size"], causal=a["causal"]),
        lambda a: (a["q"].dtype == torch.bfloat16 and a["causal"]
                   and a["q"].shape[-1] == a["q"].shape[-2] == a["block_size"] == 128)),
    "block_sparse_attention": (
        bsa_kern,
        lambda a: bsa_kern.block_sparse_attention_plain(
            a["q"], a["k"], a["v"], a["indices"], _live_counts(a),
            block_size=a["block_size"], scale=a["scale"],
            group_dedup=a["group_dedup"], return_lse=a["return_lse"]),
        lambda a: forward_route(a["q"].dtype, a["q"].shape[-1], a["v"].shape[-1],
                                a["block_size"]) == "wgmma"),
    "flash_attention": (
        flash_kern,
        lambda a: flash_kern.flash_attention_plain(a["q"], a["k"], a["v"],
                                                   scale=a["scale"],
                                                   return_lse=a["return_lse"]),
        lambda a: forward_route(a["q"].dtype, a["q"].shape[-1],
                                a["v"].shape[-1]) == "wgmma"),
    "flash_attention_bwd": (
        flash_kern,
        lambda a: flash_kern.flash_attention_bwd_plain(
            a["q"], a["k"], a["v"], a["o"], a["do"], scale=a["scale"]),
        lambda a: backward_route(a["q"].dtype, a["q"].shape[-1],
                                 a["v"].shape[-1]) == "wgmma"),
    "block_sparse_attention_bwd": (
        bsa_kern,
        lambda a: bsa_kern.block_sparse_attention_bwd_plain(
            a["q"], a["k"], a["v"], a["o"], a["do"], a["indices"], a["live_counts"],
            block_size=a["block_size"], scale=a["scale"], group_dedup=a["group_dedup"]),
        lambda a: backward_route(a["q"].dtype, a["q"].shape[-1], a["v"].shape[-1],
                                 a["block_size"]) == "wgmma"),
    "antidiag_pool": (
        metric_kern,
        lambda a: metric_kern.antidiag_pool_plain(
            a["x"], block_size=a["block_size"], stride=a["stride"],
            out_dtype=a["out_dtype"]),
        lambda a: False),
    "value_magnitude": (
        metric_kern,
        lambda a: metric_kern.value_magnitude_plain(a["v"], block_size=a["block_size"]),
        lambda a: False),
}


KEEP = 8          # recorded calls a kernel (and lane) at most


def _clone(x):
    if isinstance(x, tuple):
        return tuple(_clone(t) for t in x)
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def _parts(key: str, out) -> list:
    """(part name, tensor, its limit rule) of a recorded output: a
    backward's dq, dk, dv; a forward's output and, with ``return_lse``,
    its lse; else the one output."""
    if key.endswith("_bwd"):
        return list(zip(("dq", "dk", "dv"), out, ("grad",) * 3))
    if isinstance(out, tuple):
        return [("out", out[0], "out"), ("lse", out[1], "lse")]
    return [("out", out, "out")]


class Recorder:
    """Context manager: records kernel calls (see the module docstring);
    ``calls`` maps a key ("score_pages/chunk", "flash_attention", ...) to
    its recorded (bound arguments, output) pairs, ``seen`` to the number
    of calls the run made."""

    def __init__(self):
        self.calls: dict = {}
        self.seen: dict = {}
        self._shapes: dict = {}
        self._saved: list = []

    def _wrap(self, name, fn):
        sig = inspect.signature(fn)

        def recording(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = dict(bound.arguments)
            key = name + (f"/{a['lane']}" if "lane" in a else "")
            self.seen[key] = self.seen.get(key, 0) + 1
            n = self.seen[key]
            shapes = tuple(tuple(x.shape) for x in a.values()
                           if isinstance(x, torch.Tensor))
            known = self._shapes.setdefault(key, set())
            keep = (len(self.calls.get(key, ())) < KEEP
                    and (shapes not in known or n & (n - 1) == 0))
            if keep:
                known.add(shapes)
                a = {k: _clone(x) for k, x in a.items()}
            out = fn(*args, **kwargs)
            if keep:
                self.calls.setdefault(key, []).append((a, _clone(out)))
            return out
        return recording

    def __enter__(self):
        for name, (mod, _, _) in KERNELS.items():
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved.clear()
        return False

    def check(self) -> dict:
        """Each recorded call's output against its plain version on the
        recorded arguments; raises AssertionError on the first output that
        is not finite or is over its limit.  Returns, by key, the number of
        calls checked, their shapes and the largest |kernel - plain| as a
        share of its limit."""
        report = {}
        for key, calls in self.calls.items():
            _, plain, p_bf16 = KERNELS[key.split("/")[0]]
            worst = 0.0
            for a, out in calls:
                for (part, got, rule), (_, want, _) in zip(_parts(key, out),
                                                           _parts(key, plain(a))):
                    if rule == "lse":
                        err, limit, _ = check_lse(f"{key}/{part}", got, want)
                        worst = max(worst, err / limit if limit else 0.0)
                        continue
                    dtype, got, want = got.dtype, got.float(), want.float()
                    if rule == "grad":
                        limit = grad_tolerance(want, dtype, p_bf16(a))
                    else:
                        limit = tolerance(want, dtype, p_bf16(a))
                    if not bool(torch.isfinite(got).all()):
                        raise AssertionError(f"{key}/{part}: kernel output not finite")
                    over = float(((got - want).abs() / limit).max()) if got.numel() else 0.0
                    if not over <= 1:
                        raise AssertionError(
                            f"{key}/{part} at {tuple(got.shape)} {dtype}: max |kernel - "
                            f"plain| = {float((got - want).abs().max())}, {over:.2f}x "
                            "its limit")
                    worst = max(worst, over)
            report[key] = dict(checked=len(calls), of=self.seen[key],
                               shapes=[tuple(_parts(key, g)[0][1].shape) for _, g in calls],
                               share_of_limit=worst)
        return report
