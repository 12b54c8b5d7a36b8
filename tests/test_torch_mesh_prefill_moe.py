"""The mesh fixed-batch prefill and serve steps of the reduced arctic-480b
(MoE experts by model shard, FSDP parameters, 1 KV head: its cache split
by sequence) against the reference's sharded steps.  The checks and the
reference's subprocess are ``tests/test_torch_mesh_prefill.py``'s."""
import pytest

from test_torch_mesh_prefill import cases, check_case, run_reference

ARCHS = ("arctic-480b",)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(ARCHS, tmp_path_factory)


@pytest.mark.parametrize("arch,shape,arm", cases(ARCHS), ids=lambda x: str(x))
def test_mesh_prefill_serve_matches_reference(arch, shape, arm, ref):
    check_case(arch, shape, arm, ref)
