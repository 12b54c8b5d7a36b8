"""The mesh fixed-batch prefill and serve steps of the reduced
deepseek-v3-671b (MLA: its bf16 latent cache split by sequence over the
model axis, the absorbed decode's partial softmaxes combined across the
shards; MoE experts and FSDP parameters) against the reference's sharded
steps.  The checks and the reference's subprocess are
``tests/test_torch_mesh_prefill.py``'s."""
import pytest

from test_torch_mesh_prefill import cases, check_case, run_reference

ARCHS = ("deepseek-v3-671b",)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(ARCHS, tmp_path_factory)


@pytest.mark.parametrize("arch,shape,arm", cases(ARCHS), ids=lambda x: str(x))
def test_mesh_prefill_serve_matches_reference(arch, shape, arm, ref):
    check_case(arch, shape, arm, ref)
