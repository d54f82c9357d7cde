"""The CUDA apply kernel's launch geometry and its wrapper's refusals.

Runs on the CPU: the kernel itself runs only on the card, where
chip_smoke.py holds it against its plain version. Here the pure Python
side is checked: ``launch_geometry`` for every S the kernel takes, and
that ``launch`` raises (and counts no launch) on what the kernel does not
take.
"""

import pytest
import torch

from fluidframework_tpu_torch.ops import cuda_apply
from fluidframework_tpu_torch.ops.doc_state import DocState

SHARED_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90


def _check_geometry(S):
    spt, warps, docs, smem = cuda_apply.launch_geometry(S)
    assert spt in (1, 2, 4, 8)
    assert 32 * spt * warps >= S  # every slot has a lane
    assert 32 * warps * docs <= min(1024, cuda_apply.MAX_THREADS)
    assert smem <= SHARED_LIMIT
    assert (warps == 1) == (S <= 256)  # one warp per doc exactly then
    assert warps == 1 or docs == 1  # a multi-warp doc has its own CTA
    return spt, warps, docs, smem


def test_geometry_for_every_slot_count():
    for S in range(1, cuda_apply.MAX_SLOTS + 1):
        _check_geometry(S)


@pytest.mark.parametrize("S", [1, 2, 31, 32, 33, 64, 65, 128, 129, 200,
                               255, 256, 257, 288, 512, 513, 640, 1000,
                               1024])
def test_geometry_at(S):
    spt, warps, docs, smem = _check_geometry(S)
    if S <= 256:  # the fewest slots a lane that cover S
        assert spt == 1 or 16 * spt < S
        assert docs == cuda_apply.DOCS_PER_CTA
    else:
        assert (spt, warps) == (8, -(-S // 256))
    # each of the doc's 32 * spt * warps slots has a row of 2P prop
    # entries, a text_start and flags; each warp stages 16 op rows of 12
    slots = 32 * spt * warps
    P = cuda_apply.KERNEL_PROPS
    assert smem >= 4 * docs * (slots * (2 * P + 2) + warps * 16 * 12)


def test_geometry_refuses_what_does_not_fit():
    for S in (0, -1, cuda_apply.MAX_SLOTS + 1):
        with pytest.raises(ValueError, match="max_slots"):
            cuda_apply.launch_geometry(S)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_apply.launch_geometry(1024, P=64)


def _ops(D, K=4):
    return torch.zeros((D, K, 12), dtype=torch.int32)


@pytest.mark.parametrize("S", [16, 300])
def test_launch_refuses_cpu_tensors(S):
    before = cuda_apply.LAUNCHES
    with pytest.raises(ValueError, match="no kernel"):
        cuda_apply.launch(DocState.empty(2, S, device="cpu"), _ops(2))
    assert cuda_apply.LAUNCHES == before


@pytest.mark.parametrize("P", [4, 16])
def test_launch_refuses_other_prop_capacity(P):
    before = cuda_apply.LAUNCHES
    state = DocState.empty(2, 16, max_props=P, device="cpu")
    with pytest.raises(ValueError, match="max_props"):
        cuda_apply.launch(state, _ops(2))
    assert cuda_apply.LAUNCHES == before


def test_launch_refuses_malformed_ops():
    state = DocState.empty(2, 16, device="cpu")
    for ops in (_ops(2).to(torch.int64), _ops(3), torch.zeros((2, 4, 11),
                                                              dtype=torch.int32)):
        with pytest.raises(ValueError, match="ops must be"):
            cuda_apply.launch(state, ops)
