"""K4's backward route, on the CPU.

``ops/flash_attn.py:bwd_route`` chooses the kernels of the backward from
the shapes alone: the wgmma passes (``csrc/flash_bwd_wgmma.cu``) for bf16
where they are measured faster than the mma.sync passes, the mma.sync
passes elsewhere and at D = 128, the CUDA-core kernels for f32;
``wgmma_spread`` orders the wgmma passes' grids.  Nothing here needs a
card: the kernels themselves, their shared memory and occupancy are held
in tests/test_torch_kernels_cuda.py and chip_smoke.py phase 3.
"""

import itertools

import pytest
import torch

from nano_tpu_torch.ops import flash_attn as tfa
from nano_tpu_torch.ops import launches

BF16, F32 = torch.bfloat16, torch.float32

# (B, Sq, Skv, offset, H, KV, D, dtype) -> (passes, hpb): phase 10d's two
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
    ((8, 256, 512, 256, 16, 8, 32, BF16), ("wgmma", 1)),
    ((8, 256, 512, 256, 16, 8, 16, BF16), ("wgmma", 1)),
    ((64, 64, 64, 0, 8, 4, 16, BF16), ("mma", 1)),
    ((4, 60, 60, 0, 4, 1, 16, BF16), ("mma", 1)),
    ((2, 37, 200, 5, 4, 1, 16, BF16), ("wgmma", 1)),
    ((8, 256, 512, 256, 16, 8, 64, BF16), ("wgmma", 2)),
    ((64, 512, 512, 0, 16, 8, 64, BF16), ("wgmma", 2)),
    ((2, 64, 256, 192, 8, 2, 64, BF16), ("wgmma", 2)),
    ((2, 100, 300, 37, 8, 8, 64, BF16), ("wgmma", 1)),
]


@pytest.mark.parametrize("shape,want", ROUTES)
def test_route_picks_the_passes_from_the_shapes(shape, want):
    route = tfa.bwd_route(*shape)
    assert (route.passes, route.hpb) == want
    assert tfa.bwd_route(*shape) == route      # a function of the shapes


@pytest.mark.parametrize("D", tfa.HEAD_DIMS)
def test_route_never_sends_a_width_or_type_the_kernels_refuse(D):
    for rep, offset, dtype in itertools.product((1, 2, 3, 4, 8), (0, 5, 64),
                                                (BF16, F32)):
        KV = 2
        route = tfa.bwd_route(2, 64, 64 + offset, offset, KV * rep, KV, D,
                              dtype)
        if dtype == F32:
            assert route.passes == "simt"
        elif route.passes == "wgmma":
            assert D in tfa.WGMMA_HEAD_DIMS and rep % route.hpb == 0
        else:
            assert route.passes == "mma" and route.hpb == 1
            # the mma.sync passes where the wgmma passes were not faster
            assert D not in tfa.WGMMA_HEAD_DIMS or (D == 16 and offset == 0)


def test_spread_only_where_the_grid_fits_two_waves():
    # phase 10d's dk/dv grid: 8 key tiles x 64 (KV head, batch row) pairs,
    # three blocks an SM on 132 SMs
    assert tfa.wgmma_spread(8, 64, 3 * 132) == 64
    # the training shape: 8 x 512 pairs
    assert tfa.wgmma_spread(8, 512, 3 * 132) == 1


@pytest.mark.parametrize("route,dtype,D,rep", [
    (tfa.BwdRoute("wgmma"), F32, 48, 2),
    (tfa.BwdRoute("mma"), F32, 48, 2),
    (tfa.BwdRoute("simt"), BF16, 48, 2),
    (tfa.BwdRoute("wgmma"), BF16, 128, 2),
    (tfa.BwdRoute("wgmma", 2), BF16, 48, 1),
    (tfa.BwdRoute("wgmma", 4), BF16, 48, 4),
    (tfa.BwdRoute("tiles"), BF16, 48, 2),
])
def test_a_route_the_kernels_do_not_take_raises(route, dtype, D, rep):
    """Refused before anything is built or launched: no quiet fallback."""
    B, S, KV = 1, 8, 1
    q = torch.zeros(B, S, KV * rep, D, dtype=dtype)
    k = v = torch.zeros(B, S, KV, D, dtype=dtype)
    out, lse = tfa.flash_attn_fwd_plain(q, k, v)
    n0 = tfa.flash_attention.backward_launches
    with pytest.raises(ValueError, match="no route"):
        tfa.flash_attn_bwd(q, k, v, out, lse, torch.zeros_like(out),
                           route=route)
    assert tfa.flash_attention.backward_launches == n0


def test_the_wgmma_counter_is_kept_with_the_others():
    assert (tfa, "flash_attention", "wgmma_launches") in launches.COUNTERS
    assert ("flash_attention", "wgmma_launches") in launches.counts()
