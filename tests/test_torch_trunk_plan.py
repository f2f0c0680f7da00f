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
import collections

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


# ---------------------------------------------------------------------------
# bf16 mode: the tensor-core product core (32-deep k tiles), the bf16
# workspace and dflat's db2 segment sums (csrc/trunk_mma.cuh)
# ---------------------------------------------------------------------------

BF16_BATCHES = [1, 33, 768, 1000, 3072, 8192, 10240, 32768]


@pytest.mark.parametrize("batch", BF16_BATCHES)
def test_bf16_products_cover_every_tile_and_k_index_once(batch):
    """fc1, g1, dWf and dflat on the grid the kernels launch: (N tiles, M
    tiles, 2 x splits), split s summing k tiles [s chunk, (s + 1) chunk);
    every output element in one tile and every k index in one split range,
    none empty."""
    pl = tc.plan(batch, FRAMES, BEAMS, precision="bf16")
    assert pl.k_tile == 32
    products = pl.products()
    assert set(products) == {"fc1", "g1", "dWf", "dflat"}
    assert products["fc1"] == products["g1"]  # the recompute's mask is fc1's
    assert products["dflat"][3] == 1          # its epilogue sums db2
    for name, (m, n, k, splits, chunk) in products.items():
        for size in (m, n):
            assert _covers_once(size, tc.ranges(size, tc.GEMM_TILE)), name
        ktiles = -(-k // pl.k_tile)
        tile_ranges = tc.ranges(ktiles, chunk)
        assert len(tile_ranges) == splits <= tc.MAX_SPLITS, name
        cuts = [(lo * pl.k_tile, min(hi * pl.k_tile, k))
                for lo, hi in tile_ranges]
        assert _covers_once(k, cuts), name


@pytest.mark.parametrize("batch", BF16_BATCHES)
def test_bf16_workspace_regions_are_disjoint_and_sized(batch):
    """The bf16 workspaces hold the flat features (g2 later) and g1 as bf16,
    the fc1 weight as bf16, the conv blocks' partials, dflat's column sums
    for db2, dbf's row-range sums and the split-K partials, back to back, each
    on a 16-byte boundary; the float32 mode's are as before."""
    pl = tc.plan(batch, FRAMES, BEAMS, precision="bf16")
    psize = 32 * FRAMES * 5 + 32 + 32 * 32 * 3 + 32
    mtiles = -(-batch // tc.GEMM_TILE)      # dflat's M tiles

    def part(m, n, splits):
        return 2 * splits * m * n if splits > 1 else 0

    bf16 = lambda elements: elements // 2     # floats that hold them
    for regions, total, writes in (
            (pl.fwd_regions(), pl.fwd_workspace,
             {"flat": bf16(2 * batch * NFLAT), "wf16": bf16(2 * H * NFLAT),
              "fc1_part": part(batch, H, pl.fc1_splits)}),
            (pl.bwd_regions(), pl.bwd_workspace,
             {"flat": bf16(2 * batch * NFLAT), "g1": bf16(2 * batch * H),
              "wf16": bf16(2 * H * NFLAT),
              "conv_part": 2 * pl.conv_blocks * psize,
              "db2_part": 2 * mtiles * NFLAT,
              "bias_part": 2 * tc.BIAS_RANGES * H,
              "k_part": max(part(batch, H, pl.fc1_splits),
                            part(H, NFLAT, pl.dwf_splits))})):
        assert list(regions) == list(writes)
        at = 0
        for name, (offset, size) in regions.items():
            assert offset == at and size >= writes[name], name
            assert offset % 4 == 0, name      # 16-byte aligned
            at = offset + size
        assert total == at
    if batch == 32768:     # bytes, against the float32 mode's
        f32 = tc.plan(batch, FRAMES, BEAMS)
        assert 4 * pl.bwd_workspace <= 0.65e9
        assert 4 * f32.bwd_workspace == 1161446400


@pytest.mark.parametrize("beams", [64, 512, 720])
def test_db2_segments_each_written_by_one_tile(beams):
    """db2's partials are dflat's per-block column sums, one float per
    (trunk, M tile, flat column): on dflat's grid every such slot is
    written by exactly one block, and the channels' column ranges, which
    the db2 reduce sums over every M tile, cover the columns once, also
    where a 128-wide N tile spans channels (64 beams) or straddles them
    (720)."""
    batch = 300
    pl = tc.plan(batch, FRAMES, beams, precision="bf16")
    nflat, l2 = pl.nflat, pl.l2
    m, n, _, splits, _ = pl.products()["dflat"]
    assert (m, n, splits) == (batch, nflat, 1)
    assert nflat % tc.GEMM_TILE == 0          # whole N tiles, as the kernel
    mtiles = -(-batch // tc.GEMM_TILE)
    written = collections.Counter()
    for mt in range(mtiles):
        for n0 in range(0, nflat, tc.GEMM_TILE):   # one dflat block each
            written.update((mt, col) for col in range(n0, n0 + tc.GEMM_TILE))
    assert set(written) == {(mt, col) for mt in range(mtiles)
                            for col in range(nflat)}
    assert set(written.values()) == {1}
    assert _covers_once(nflat, [(c * l2, (c + 1) * l2) for c in range(32)])
    offset, size = pl.bwd_regions()["db2_part"]
    assert size == 2 * mtiles * nflat
