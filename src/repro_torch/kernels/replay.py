"""Record the kernel calls a run makes and hold each against its plain
version, at the shapes and on the data the run gave the kernels.

    with replay.Recorder() as rec:
        engine.run(requests)
    report = rec.check()     # raises unless every recorded call matches

Inside the block the six kernel wrappers (``score_pages``,
``attend_pages``, ``block_sparse_attention``, ``flash_attention``,
``antidiag_pool``, ``value_magnitude``) are replaced by module attribute,
so calls from the runtime reach the recording versions.  A recorded call
clones its tensor arguments before the wrapper runs and its output after.
A kernel (a paged kernel with its lane) keeps up to ``KEEP`` calls:
each call with a set of argument shapes not seen before, and the 1st,
2nd, 4th, 8th, ... call, so that early and late steps of a run are held.
Cloning launches no kernel of the port, so the launch counters read after
the block count the run alone.  ``check`` runs each plain version on the
recorded arguments and compares it with the recorded output under
``tolerance``.
"""
from __future__ import annotations

import inspect

import torch

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
    the tensor-core tile (flash, block-sparse, the paged chunk lane at
    head_dim and page size 128) round the probabilities P to bf16 before
    P.V (as SDPA's and flex_attention's kernels do) while the plain version
    keeps P in fp32, so their row floor is 1e-2 * max|plain| in place of
    1e-3."""
    if dtype == torch.float32:
        return 1e-4
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    floor = (1e-2 if p_bf16 else 1e-3) * want.abs().amax(dim=-1, keepdim=True)
    return 2 * ulp + floor


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
            group_dedup=a["group_dedup"]),
        lambda a: (a["q"].dtype == torch.bfloat16 and a["q"].shape[-1] == 128
                   and a["block_size"] % 128 == 0)),
    "flash_attention": (
        flash_kern,
        lambda a: flash_kern.flash_attention_plain(a["q"], a["k"], a["v"],
                                                   scale=a["scale"]),
        lambda a: a["q"].dtype == torch.bfloat16 and a["q"].shape[-1] == 128),
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
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


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
            for a, got in calls:
                want = plain(a).float()
                dtype = got.dtype
                got = got.float()
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{key}: kernel output not finite")
                over = float(((got - want).abs()
                              / tolerance(want, dtype, p_bf16(a))).max())
                if not over <= 1:
                    raise AssertionError(
                        f"{key} at {tuple(got.shape)} {dtype}: max |kernel - plain| "
                        f"= {float((got - want).abs().max())}, {over:.2f}x its limit")
                worst = max(worst, over)
            report[key] = dict(checked=len(calls), of=self.seen[key],
                               shapes=[tuple(g.shape) for _, g in calls],
                               share_of_limit=worst)
        return report
