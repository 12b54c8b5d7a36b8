"""One train step of every other model family in the port against the
reference's ``make_train_step``, on the CPU: the reduced arctic-480b (MoE),
deepseek-v3-671b (MLA + MTP), mamba2-370m (SSD), recurrentgemma-2b (RG-LRU +
local attention), whisper-medium (encoder-decoder) and pixtral-12b (VLM
stub), fp32 at seq 64, under Stem where the family has attention, remat on.
The comparison and its tolerances are ``test_torch_train.check_train_step``'s
(metrics rtol 1e-5; mu and nu within 1e-4 of each leaf's max, which after
one step with fp32 gradients is every gradient leaf within 1e-4 of its
max|g|; master within 5% of the step's learning rate)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import registry as j_registry

from repro_torch import configs as t_configs
from repro_torch.models import registry as t_registry
from test_torch_train import check_train_step

torch.set_num_threads(1)


@pytest.mark.parametrize("arch,stem", [
    ("arctic-480b", True), ("deepseek-v3-671b", True), ("mamba2-370m", False),
    ("recurrentgemma-2b", False), ("whisper-medium", True), ("pixtral-12b", True)])
def test_train_step_matches_reference(arch, stem):
    check_train_step(arch, stem, 1, True, None, 1)


def _dense_layers_only(cfg):
    """A MoE config cut to its first_k_dense layers: one dense-FFN layer and
    no MoE layer (phase 15's depth cut of deepseek-v3-671b)."""
    return cfg.replace(num_layers=1, moe=dataclasses.replace(cfg.moe, first_k_dense=1))


def test_depth_cut_to_dense_layers_matches_reference():
    """deepseek-v3-671b cut to one dense-FFN MLA layer plus its MTP head:
    the MoE segment holds no layer, its leaves empty (0, ...) stacks of the
    reference's shapes, and a train step under Stem equals the
    reference's."""
    jcfg = _dense_layers_only(j_configs.reduced(j_configs.get_config("deepseek-v3-671b")))
    tcfg = _dense_layers_only(t_configs.reduced(t_configs.get_config("deepseek-v3-671b")))
    jp = jax.eval_shape(j_registry.build(jcfg).init_params, jax.random.PRNGKey(0))
    tp = t_registry.build(tcfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    want = [x.shape for x in jax.tree_util.tree_leaves(jp["segment1"])]
    got = [tuple(x.shape) for x in jax.tree_util.tree_leaves(
        tp["segment1"], is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert got == want and all(s[0] == 0 for s in got) and got
    assert np.isfinite(float(tp["segment0"]["sub0"]["norm1"].sum()))
    check_train_step("deepseek-v3-671b", True, 1, True, None, 1, cut=_dense_layers_only)
