"""The mesh fixed-batch prefill and serve steps of the SSD and RG-LRU
configs against the reference's sharded steps: the reduced mamba2-370m
(the SSD state split by heads, its conv tail by even blocks of the packed
``x | B | C`` columns) and recurrentgemma-2b (the RG-LRU state and conv
tail by channels; its local attention's ring cache, one KV head, split by
slots).  The checks and the reference's subprocess are
``tests/test_torch_mesh_prefill.py``'s."""
import pytest

from test_torch_mesh_prefill import cases, check_case, run_reference

ARCHS = ("mamba2-370m", "recurrentgemma-2b")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(ARCHS, tmp_path_factory)


@pytest.mark.parametrize("arch,shape,arm", cases(ARCHS), ids=lambda x: str(x))
def test_mesh_prefill_serve_matches_reference(arch, shape, arm, ref):
    check_case(arch, shape, arm, ref)
