"""One train step of every other model family in the port against the
reference's ``make_train_step``, on the CPU: the reduced arctic-480b (MoE),
deepseek-v3-671b (MLA + MTP), mamba2-370m (SSD), recurrentgemma-2b (RG-LRU +
local attention), whisper-medium (encoder-decoder) and pixtral-12b (VLM
stub), fp32 at seq 64, under Stem where the family has attention, remat on.
The comparison and its tolerances are ``test_torch_train.check_train_step``'s
(metrics rtol 1e-5; mu and nu within 1e-4 of each leaf's max, which after
one step with fp32 gradients is every gradient leaf within 1e-4 of its
max|g|; master within 5% of the step's learning rate)."""
import pytest
import torch

from test_torch_train import check_train_step

torch.set_num_threads(1)


@pytest.mark.parametrize("arch,stem", [
    ("arctic-480b", True), ("deepseek-v3-671b", True), ("mamba2-370m", False),
    ("recurrentgemma-2b", False), ("whisper-medium", True), ("pixtral-12b", True)])
def test_train_step_matches_reference(arch, stem):
    check_train_step(arch, stem, 1, True, None, 1)
