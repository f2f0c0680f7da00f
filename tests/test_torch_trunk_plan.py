"""The trunk kernels' launch plan (``ops/trunk_cuda.py::plan``), on the CPU.

The wrapper cuts each batch into conv-block sample ranges and split-K ranges
and sizes the kernels' workspace; the CUDA launchers cut the same way from
the numbers it passes and refuse a workspace that is too small.  These tests
hold the cuts to covering every sample and every k index exactly once and
the workspace to covering what each pass writes, at the batches the paths
use (1; stage 1: the rollout's 768, acting's 3,072, PPO's 32,768; stage 2:
704 and 8,192; the circle fine-tune: 800 and 10,240; the circle eval: 50
and 1,600) and a ragged one.
"""
import pytest

from rl_collision_avoidance_torch.ops import trunk_cuda as tc

BATCHES = [1, 37, 50, 704, 768, 800, 1600, 3072, 8192, 10240, 32768]
FRAMES, BEAMS, NFLAT, H = 3, 512, 4096, 256


def _covers_once(n, cuts):
    seen = [0] * n
    for lo, hi in cuts:
        assert lo < hi, "an empty range"
        for i in range(lo, hi):
            seen[i] += 1
    return all(c == 1 for c in seen)


@pytest.mark.parametrize("batch", BATCHES)
def test_conv_blocks_cover_every_sample_once(batch):
    pl = tc.plan(batch, FRAMES, BEAMS)
    blocks = tc.conv_ranges(batch, pl.conv_blocks)
    assert len(blocks) == pl.conv_blocks <= tc.H100_SMS
    assert _covers_once(batch, blocks)
    # ranges that differ by at most one group, each a whole number of groups
    sizes = [-(-(hi - lo) // tc.FWD_GROUP) for lo, hi in blocks]
    assert max(sizes) - min(sizes) <= 1
    assert all(lo % tc.FWD_GROUP == 0 for lo, _ in blocks)
    # the forward conv pass walks each block two samples at a time
    steps = [(b, min(b + tc.FWD_GROUP, hi)) for lo, hi in blocks
             for b in range(lo, hi, tc.FWD_GROUP)]
    assert _covers_once(batch, steps)


@pytest.mark.parametrize("batch", BATCHES)
def test_k_splits_cover_every_k_index_once(batch):
    pl = tc.plan(batch, FRAMES, BEAMS)
    for k, splits, chunk in ((NFLAT, pl.fc1_splits, pl.fc1_kchunk),
                             (batch, pl.dwf_splits, pl.dwf_kchunk)):
        ktiles = -(-k // tc.GEMM_K_TILE)
        tile_ranges = tc.ranges(ktiles, chunk)
        assert len(tile_ranges) == splits <= tc.MAX_SPLITS
        cuts = [(lo * tc.GEMM_K_TILE, min(hi * tc.GEMM_K_TILE, k))
                for lo, hi in tile_ranges]
        assert _covers_once(k, cuts)


@pytest.mark.parametrize("batch", BATCHES)
def test_workspace_covers_what_the_plan_writes(batch):
    pl = tc.plan(batch, FRAMES, BEAMS)
    psize = 32 * FRAMES * 5 + 32 + 32 * 32 * 3 + 32

    def part(m, n, splits):  # blockIdx.z * m * n + m' * n + n', z < 2 splits
        return 2 * splits * m * n if splits > 1 else 0

    for regions, total, writes in (
            (pl.fwd_regions(), pl.fwd_workspace,
             {"flat": 2 * batch * NFLAT,
              "fc1_part": part(batch, H, pl.fc1_splits)}),
            (pl.bwd_regions(), pl.bwd_workspace,
             {"flat": 2 * batch * NFLAT, "g1": 2 * batch * H,
              "conv_part": 2 * pl.conv_blocks * psize,
              "k_part": max(part(batch, H, pl.fc1_splits),
                            part(H, NFLAT, pl.dwf_splits))})):
        assert set(regions) == set(writes)
        at = 0
        for name, (offset, size) in regions.items():
            assert offset == at and size >= writes[name], name
            at = offset + size
        assert total == at


@pytest.mark.parametrize("batch", BATCHES)
def test_plan_fills_the_card(batch):
    """Two blocks an SM: the conv passes run ~one block per SM and trunk,
    and each product's split count keeps its waves at least 90% as full as
    the best count up to MAX_SPLITS would."""
    pl = tc.plan(batch, FRAMES, BEAMS)
    slots = tc.BLOCKS_PER_SM * tc.H100_SMS
    per_block = max(hi - lo for lo, hi in tc.conv_ranges(batch,
                                                          pl.conv_blocks))
    assert per_block <= tc.FWD_GROUP or \
        pl.conv_blocks >= 0.9 * tc.H100_SMS
    fill = lambda blocks: blocks / (-(-blocks // slots) * slots)
    for tiles, ktiles, splits in (
            (2 * -(-batch // tc.GEMM_TILE) * (H // tc.GEMM_TILE),
             NFLAT // tc.GEMM_K_TILE, pl.fc1_splits),
            (2 * (H // tc.GEMM_TILE) * (NFLAT // tc.GEMM_TILE),
             -(-batch // tc.GEMM_K_TILE), pl.dwf_splits)):
        best = max(fill(tiles * s)
                   for s in range(1, min(tc.MAX_SPLITS, ktiles) + 1))
        assert fill(tiles * splits) >= 0.9 * best


def test_kernel_shapes():
    assert tc.kernel_shapes_ok(3, 512) and tc.kernel_shapes_ok(6, 64)
    assert not tc.kernel_shapes_ok(7, 512)
    assert not tc.kernel_shapes_ok(3, 500)
    assert not tc.kernel_shapes_ok(0, 512)
