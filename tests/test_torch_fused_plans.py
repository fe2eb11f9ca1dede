"""Launch plans of kernels K4 (``ops/split.gate_split_plan``) and K5
(``ops/split.brick_split_plan``) as pure functions of the shapes, the dtype
and the shared memory a block may opt in to, on the CPU: one 512-thread block
per element, K1's placements of theta and the chain's rows on theta [2chi,
2chi], the theta build's slabs over the rows, and the global scratch each
element needs. The kernels refuse a launch whose shared memory is below what
the C side computes for the same plan, which the card tests check
(``tests/test_torch_cuda.py``)."""

import pytest
import torch

from qml_cutensornet_tpu_torch.ops import _block, split

H100_OPTIN = 232448  # bytes of shared memory a block may opt in to on an H100
C64, C128 = torch.complex64, torch.complex128


@pytest.mark.parametrize("B,chi,nc,dtype,want", [
    # the fused-gate route's stages (chi 16 to 64) and the brick route's
    # (chi 16 to 128), nc = chi and the oversampled nc = chi + 16
    (32, 16, 16, C64, (True, True, False, 19008, 0)),
    (408, 16, 32, C64, (True, True, False, 29504, 0)),
    (32, 32, 32, C64, (True, True, False, 70720, 0)),
    (32, 32, 48, C64, (True, True, False, 89408, 0)),
    (32, 64, 64, C64, (True, True, True, 206400, 0)),
    (32, 64, 80, C64, (False, True, False, 175424, 16384)),
    (408, 128, 128, C64, (False, False, False, 65856, 131328)),
    # complex128
    (32, 16, 16, C128, (True, True, False, 38016, 0)),
    (32, 32, 32, C128, (True, True, False, 141440, 0)),
    (32, 64, 64, C128, (False, True, True, 148608, 16384)),
    (408, 128, 128, C128, (False, False, False, 131712, 131328)),
])
def test_gate_and_brick_plans_are_pure_functions_of_the_shapes(B, chi, nc, dtype, want):
    """K4 on theta built in place, K5 on its weighted theta: placements,
    shared-memory bytes and per-element scratch (K5 adds its unweighted
    theta, [2chi][2chi], always in scratch)."""
    plan = split.gate_split_plan(B, chi, nc, dtype, H100_OPTIN)
    assert (plan.threads, plan.grid) == (512, B)
    assert (plan.theta_smem, plan.rows_smem, plan.inplace, plan.smem_bytes,
            plan.scratch_cx) == want
    assert plan.smem_bytes + _block.static_smem_bytes(dtype) <= H100_OPTIN
    assert plan.smem_bytes >= _block.build_stage_bytes(chi, dtype)
    assert split.gate_split_plan(B, chi, nc, dtype, H100_OPTIN) == plan
    brick = split.brick_split_plan(B, chi, nc, dtype, H100_OPTIN)
    assert brick.scratch_cx == plan.scratch_cx + 4 * chi * chi
    assert (brick.theta_smem, brick.rows_smem, brick.inplace, brick.smem_bytes) == want[:4]
    for fn in (split.gate_split_plan, split.brick_split_plan):
        with pytest.raises(ValueError, match="no launch plan"):
            fn(B, chi, nc, dtype, 1024)


@pytest.mark.parametrize("chi", [32, 64])
def test_gate_plan_is_k1_plan_on_the_main_path(chi):
    """At the fused-gate route's stages (complex64) K4 places theta and the
    rows as K1 does on the same theta, in the same bytes: the build's slabs
    fit in the space of the rows."""
    m = 2 * chi
    gate = split.gate_split_plan(32, chi, chi, C64, H100_OPTIN)
    assert gate == split.split_plan(32, m, m, chi, C64, H100_OPTIN)


def test_stage_extends_the_request_only_where_larger():
    """Everything in global memory at chi 128: K1's request is the staged
    products' two slab buffers (2 x 16 x (64 + 1 + 128 + 1) complex64), which
    share the space of the orthonormalizer's work (16448 bytes); K5's is the
    theta build's larger slabs (2 x 16 x 257 complex64 and 16 partial sums)."""
    k1 = split.split_plan(408, 256, 256, 128, C64, H100_OPTIN)
    k5 = split.brick_split_plan(408, 128, 128, C64, H100_OPTIN)
    assert _block.orth_work_bytes(128, C64) == 16448
    assert k1.smem_bytes == _block.staged_slab_bytes(256, C64) == 2 * 16 * 194 * 8
    assert k5.smem_bytes == _block.build_stage_bytes(128, C64) == 2 * 16 * 257 * 8 + 16 * 4
    assert _block.build_stage_bytes(128, C128) == 2 * 16 * 257 * 16 + 16 * 8
    # a narrow output: 8 lanes a row of warps, so a pass is 256 rows by 32 columns
    assert _block.staged_slab_bytes(32, C64) == 2 * 16 * (256 + 1 + 32 + 1) * 8
