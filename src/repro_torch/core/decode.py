"""Policy-driven sparse decode stages shared by the paged executors (port of
``repro/core/decode.py``).

  ``decode_block_metric``  — policy metric of the query vs every cache block;
  ``select_decode_blocks`` — policy budget + validity + forced floors;
  ``attend_selected``      — exact masked attention over gathered blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import policy as policy_lib
from repro_torch.core.selection import NEG_INF, DecodeSelection

# Default decode sparsity of every decode entry point: dense (1.0).  Sparse
# serving passes its fraction explicitly (``EngineConfig.budget_frac``).
DEFAULT_BUDGET_FRAC = 1.0
# The v_mag of an all-zero block (log of the norm floor); fresh pages start
# at it so incremental appends reproduce the batch summary exactly.
V_MAG_FLOOR = float(np.log(1e-20))


def decode_block_metric(q: torch.Tensor, k_groups: torch.Tensor,
                        v_mag: torch.Tensor, cfg) -> torch.Tensor:
    """q: (b, hq, 1, d); k_groups: (b, hk, n, stride, d); v_mag: (b, hk, n).
    Returns (b, hk, group, n) float32."""
    return policy_lib.as_policy(cfg).decode_scores(q, k_groups, v_mag)


def select_decode_blocks(m: torch.Tensor, cache_lens: torch.Tensor, cfg,
                         budget_frac: float = DEFAULT_BUDGET_FRAC) -> DecodeSelection:
    """Policy budget + forced floors + validity, vectorized per row."""
    return policy_lib.as_policy(cfg).decode_select(
        m, cache_lens, budget_frac=budget_frac)


def attend_selected(
    q: torch.Tensor,            # (b, hq, 1, d)
    gk: torch.Tensor,           # (b, hk, g, k_max, bs, d) gathered key blocks
    gv: torch.Tensor,           # (b, hk, g, k_max, bs, dv)
    sel: DecodeSelection,
    cache_lens: torch.Tensor,   # (b,)
    block_size: int,
) -> torch.Tensor:
    """Masked softmax over the selected blocks only.  Returns (b, hq, 1, dv).

    Zero-live-row contract: a row with no live slot (``cache_lens == 0``
    trash slots) softmaxes an all-NEG_INF row, whose uniform probabilities
    the ``keep`` mask then zeroes — the row returns an exact zero vector.
    The fused kernel honours the same contract."""
    b, hq, _, d = q.shape
    hk = gk.shape[1]
    group = hq // hk
    bs = block_size
    lens = torch.as_tensor(cache_lens, dtype=torch.int32,
                           device=q.device).expand(b)
    qg = q.reshape(b, hk, group, 1, d).float()
    s = torch.einsum("bhgqd,bhgnkd->bhgqnk", qg, gk.float())
    s = s * (d ** -0.5)                                    # (b,hk,g,1,kmax,bs)
    tok_pos = sel.indices[..., None] * bs + torch.arange(bs, device=q.device)
    keep = (tok_pos < lens[:, None, None, None, None]) & sel.live[..., None]
    s = torch.where(keep[:, :, :, None], s, NEG_INF)
    p = torch.softmax(s.reshape(b, hk, group, 1, -1), dim=-1).reshape(s.shape)
    p = torch.where(keep[:, :, :, None], p, 0.0)
    o = torch.einsum("bhgqnk,bhgnkd->bhgqd", p, gv.float())
    return o.reshape(b, hq, 1, gv.shape[-1]).to(q.dtype)
