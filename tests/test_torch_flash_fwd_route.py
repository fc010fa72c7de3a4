"""K4's forward route, on the CPU.

``ops/flash_attn.py:fwd_route`` chooses the kernel of the forward from
the shapes alone: the wgmma kernel (``csrc/flash_fwd_wgmma.cu``) for bf16
at the widths it is built for, where it was measured faster than the
mma.sync kernel, the mma.sync kernel at D = 128, the CUDA-core kernel for
f32.  Nothing here
needs a card: the kernels themselves, their shared memory and occupancy
are held in tests/test_torch_kernels_cuda.py and chip_smoke.py phase 3.
"""

import itertools

import pytest
import torch

from nano_tpu_torch.ops import flash_attn as tfa
from nano_tpu_torch.ops import launches

BF16, F32 = torch.bfloat16, torch.float32

# (B, Sq, Skv, offset, H, KV, D, dtype) -> (kernel, hpb): phase 10d's two
# ranks of {"seq": 2} (Nano-168M, batch 8, 512 positions), the training
# shapes of Nano-168M (D = 48) and Nano-56M (D = 32), the Qwen3 head width,
# f32, an odd rep; 10d's rank at D = 32, 16 and 64, the calculator's
# whole sequence (D = 16), a whole sequence at D = 64, D = 16 and 64 at
# other offsets
ROUTES = [
    ((8, 256, 512, 256, 16, 8, 48, BF16), ("wgmma", 2)),
    ((8, 256, 512, 0, 16, 8, 48, BF16), ("wgmma", 2)),
    ((64, 512, 512, 0, 16, 8, 48, BF16), ("wgmma", 2)),
    ((64, 512, 512, 0, 16, 8, 32, BF16), ("wgmma", 1)),
    ((1, 256, 512, 256, 16, 8, 128, BF16), ("mma", 1)),
    ((8, 256, 512, 256, 16, 8, 48, F32), ("simt", 1)),
    ((2, 64, 128, 64, 3, 1, 48, BF16), ("wgmma", 1)),
    ((8, 256, 512, 256, 16, 8, 32, BF16), ("wgmma", 2)),
    ((8, 256, 512, 256, 16, 8, 16, BF16), ("wgmma", 2)),
    ((64, 64, 64, 0, 8, 4, 16, BF16), ("wgmma", 2)),
    ((4, 60, 60, 0, 4, 1, 16, BF16), ("wgmma", 2)),
    ((2, 37, 200, 5, 4, 1, 16, BF16), ("wgmma", 2)),
    ((8, 256, 512, 256, 16, 8, 64, BF16), ("wgmma", 2)),
    ((64, 512, 512, 0, 16, 8, 64, BF16), ("wgmma", 2)),
    ((2, 64, 256, 192, 8, 2, 64, BF16), ("wgmma", 2)),
    ((2, 100, 300, 37, 8, 8, 64, BF16), ("wgmma", 1)),
    ((2, 512, 512, 0, 16, 8, 128, F32), ("simt", 1)),
]


@pytest.mark.parametrize("shape,want", ROUTES)
def test_route_picks_the_kernel_from_the_shapes(shape, want):
    route = tfa.fwd_route(*shape)
    assert (route.kernel, route.hpb) == want
    assert tfa.fwd_route(*shape) == route      # a function of the shapes


@pytest.mark.parametrize("D", tfa.HEAD_DIMS)
def test_route_never_sends_a_width_or_type_the_kernels_refuse(D):
    for rep, offset, dtype, Sq in itertools.product(
            (1, 2, 3, 4, 8), (0, 5, 64), (BF16, F32), (1, 63, 64, 65)):
        KV = 2
        route = tfa.fwd_route(2, Sq, Sq + offset, offset, KV * rep, KV, D,
                              dtype)
        if dtype == F32:
            assert route == tfa.FwdRoute("simt")
        elif route.kernel == "wgmma":
            assert D in tfa.WGMMA_HEAD_DIMS and rep % route.hpb == 0
            assert route.hpb in (1, 2)
        else:
            # the mma.sync kernel at the width the wgmma kernel lacks
            assert route == tfa.FwdRoute("mma")
            assert D not in tfa.WGMMA_HEAD_DIMS


def test_spread_of_the_forward_grid():
    # phase 10d's rank: 4 query tiles x 64 (head pair, batch row) pairs,
    # two blocks an SM on 132 SMs: one wave, the longest tiles first
    assert tfa.wgmma_spread(4, 8 * 8, 2 * 132) == 64
    # the training shape: 8 x 512 pairs, many waves
    assert tfa.wgmma_spread(8, 8 * 64, 2 * 132) == 1


@pytest.mark.parametrize("route,dtype,D,rep", [
    (tfa.FwdRoute("wgmma"), F32, 48, 2),
    (tfa.FwdRoute("mma"), F32, 48, 2),
    (tfa.FwdRoute("simt"), BF16, 48, 2),
    (tfa.FwdRoute("wgmma"), BF16, 128, 2),
    (tfa.FwdRoute("wgmma", 2), BF16, 48, 1),
    (tfa.FwdRoute("wgmma", 2), BF16, 48, 3),
    (tfa.FwdRoute("wgmma", 4), BF16, 48, 4),
    (tfa.FwdRoute("mma", 2), BF16, 48, 2),
    (tfa.FwdRoute("simt", 2), F32, 48, 2),
    (tfa.FwdRoute("tiles"), BF16, 48, 2),
])
def test_a_route_the_kernels_do_not_take_raises(route, dtype, D, rep):
    """Refused before anything is built or launched: no quiet fallback."""
    B, S, KV = 1, 8, 1
    q = torch.zeros(B, S, KV * rep, D, dtype=dtype)
    k = v = torch.zeros(B, S, KV, D, dtype=dtype)
    n0 = (tfa.flash_attention.launches,
          tfa.flash_attention.forward_wgmma_launches)
    with pytest.raises(ValueError, match="no route"):
        tfa.flash_attn_fwd(q, k, v, route=route)
    assert (tfa.flash_attention.launches,
            tfa.flash_attention.forward_wgmma_launches) == n0


def test_the_forward_wgmma_counter_is_kept_and_reset_with_the_others():
    key = ("flash_attention", "forward_wgmma_launches")
    assert (tfa, *key) in launches.COUNTERS
    saved = launches.counts()
    try:
        launches.add({key: 3, ("flash_attention", "launches"): 3}, times=2)
        got = launches.counts()
        assert got[key] == saved[key] + 6
        assert got[("flash_attention", "launches")] == \
            saved[("flash_attention", "launches")] + 6
        launches.restore({k: 0 for k in saved})
        assert tfa.flash_attention.forward_wgmma_launches == 0
    finally:
        launches.restore(saved)
    assert launches.counts() == saved
