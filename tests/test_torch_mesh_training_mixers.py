"""Mesh training of the SSD and RG-LRU configs against the reference.

The reduced fp32 mamba2-370m (SSD) and recurrentgemma-2b (RG-LRU + local
attention) on the meshes (1, 1), (2, 1), (4, 1), (2, 4), (1, 2), (1, 4),
(2, 2) with microbatches 1 and 2, against the reference's sharded
``make_train_step``, under the rules of
``tests/test_torch_mesh_training.py`` (its subprocess, run for these
configs in a file of its own, so that a run split by file runs it on
another worker).  Where the model axis is above 1 the SSD computes by
heads (its packed ``w_in`` / conv blocks cut inside the segments: the
reduced ``w_in``'s 296 columns every 74 at model 4), the RG-LRU by its
``rnn`` channels, the windowed attention by heads (the reduced config's 4
heads; its one KV head stays whole), the MLPs by ``mlp``, the embedding,
logits and CE by ``vocab``: loss, grad norm, every master leaf and every
ZeRO-1 block match.
"""
import pytest
import torch

from test_torch_mesh_training import MESHES, MICROBATCHES, check_against_reference, run_reference

torch.set_num_threads(1)

ARCHS = ("mamba2-370m", "recurrentgemma-2b")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(ARCHS, tmp_path_factory)


CASES = [(a, s, mb) for a in ARCHS for s in MESHES for mb in MICROBATCHES]


@pytest.mark.parametrize("arch,shape,mb", CASES, ids=lambda x: str(x))
def test_mesh_step_matches_reference(arch, shape, mb, ref):
    check_against_reference(arch, shape, mb, ref)
