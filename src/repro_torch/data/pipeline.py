"""Deterministic, seekable synthetic data pipeline (port of
``repro/data/pipeline.py``).

``SyntheticLMData`` is numpy only and copies the reference's: a batch is a
pure function of (seed, step) through a Philox generator seeked to the step
(O(1) skip-ahead, so a restarted job resumes the exact token stream), with
Zipf tokens, planted copied motifs and the ``vlm`` / ``encdec`` stub
inputs, bitwise the reference's batches.  ``make_global_batch`` is the
reference's sharded feed: the host batch as tensors on one device, or, over
a training mesh, each array's blocks on their coordinates' devices (each
data coordinate gets ``batch[index]``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 32
    kind: str = "lm"              # lm | vlm | encdec
    d_model: int = 0              # for stub embeddings (vlm/encdec)
    frames: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        # Philox is counter-based: O(1) seek to any step.
        return np.random.Generator(np.random.Philox(key=self.seed, counter=step))

    def batch_at(self, step: int) -> dict:
        rng = self._rng(step)
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        if self.kind == "vlm":
            s_img = s // 4
            s_tok = s - s_img
        else:
            s_tok = s
        # Zipf-distributed tokens (clipped to vocab).
        toks = rng.zipf(self.zipf_a, size=(b, s_tok + 1)).astype(np.int64)
        toks = (toks - 1) % v
        # Plant copied motifs: a motif early in the sequence reappears later.
        m = min(self.motif_len, s_tok // 4)
        if m > 1:
            src = rng.integers(0, s_tok // 2 - m, size=b)
            dst = rng.integers(s_tok // 2, s_tok - m, size=b)
            for i in range(b):
                toks[i, dst[i]: dst[i] + m] = toks[i, src[i]: src[i] + m]
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.kind == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (b, s_img, self.d_model), dtype=np.float32)
        if self.kind == "encdec":
            batch["frames"] = rng.standard_normal(
                (b, self.frames, self.d_model), dtype=np.float32)
        return batch


def make_global_batch(batch: dict, mesh="cuda", shardings=None) -> dict:
    """Host batch -> tensors on the device ``mesh``; or, with
    ``shardings`` (a ``NamedSharding`` a name, ``sharding.rules.
    batch_sharding``), ``ShardedArray``s over the mesh."""
    tensors = {name: torch.from_numpy(np.ascontiguousarray(arr))
               for name, arr in batch.items()}
    if shardings is None:
        return {name: t.to(mesh) for name, t in tensors.items()}
    from repro_torch.sharding import arrays
    return {name: arrays.place(t, shardings[name], copy=False)
            for name, t in tensors.items()}
