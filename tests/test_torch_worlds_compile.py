"""The port's world compiler (worlds/png.py, worlds/compile.py,
worlds/spec.py::compile_world) against PIL and the JAX package's compiler:
the decoded bitmaps, every compile step and the compiled worlds exactly
equal (no tolerance: the segment tables are data the env reads bit for
bit)."""
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from rl_collision_avoidance_tpu.worlds import compile as jcompile
from rl_collision_avoidance_tpu.worlds import spec as jspec

from rl_collision_avoidance_torch.worlds import compile as tcompile
from rl_collision_avoidance_torch.worlds import compile_world, get_world, png
from rl_collision_avoidance_torch.worlds import spec as tspec

ROOT = Path(__file__).resolve().parents[1]
ASSETS = ROOT / "rl_collision_avoidance_torch" / "worlds" / "assets"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(pixels, colour, depth=8, interlace=0):
    """A PNG of (H, W, C) uint8 ``pixels`` whose row y uses filter y % 5,
    so every filter appears (an encoder of the spec's section 9, here only
    to make test files)."""
    h, w, c = pixels.shape
    flat = pixels.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        kind, x = y % 5, flat[y]
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        pc = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        pred = [0, a, prior, (a + prior) // 2, _paeth(a, prior, pc)][kind]
        raw += bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()
        prior = x
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["rink.png", "testenv.png"])
def test_assets_decode_as_pil_converts_them(name):
    """The port's copies of the two world bitmaps (mode L 805 x 805, RGBA
    1000 x 800, the latter with Sub, Up and Paeth rows) are the JAX
    package's files, and read_grey equals PIL's convert("L") pixel for
    pixel."""
    path = ASSETS / name
    ref_file = ROOT / "rl_collision_avoidance_tpu" / "worlds" / "assets" / name
    assert path.read_bytes() == ref_file.read_bytes()
    with Image.open(path) as im:
        want = np.asarray(im.convert("L"))
    got = png.read_grey(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("colour", [0, 2, 4, 6])
def test_all_filters_and_colour_types(tmp_path, colour):
    """Seeded pixels of each colour type through all five filters: the
    decoder gives the pixels back, and its grey is PIL's, also at the
    luma's rounding points (greys near 128 from mixed channels)."""
    rng = np.random.default_rng(colour)
    pixels = rng.integers(0, 256, (23, 31, CHANNELS[colour]), np.uint8)
    pixels[:5] = rng.integers(120, 137, (5, 31, CHANNELS[colour]), np.uint8)
    path = tmp_path / f"c{colour}.png"
    path.write_bytes(_encode(pixels, colour))
    np.testing.assert_array_equal(png.read_png(path), pixels)
    with Image.open(path) as im:
        want = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(png.read_grey(path), want)


def test_luma_matches_pil_on_every_grey_boundary():
    """to_grey on colours chosen around each luma step against PIL's
    convert("L") of the same RGB and RGBA images."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (64, 64, 3), np.uint8)
    rgb[0, :, :] = np.arange(64)[:, None] * 4
    for mode, pixels in (("RGB", rgb),
                         ("RGBA", np.concatenate(
                             [rgb, rng.integers(0, 256, (64, 64, 1),
                                                np.uint8)], -1))):
        want = np.asarray(Image.fromarray(pixels, mode).convert("L"))
        np.testing.assert_array_equal(png.to_grey(pixels), want)


def _palette(tmp_path):
    path = tmp_path / "p.png"
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path)
    return path


def _sixteen_bit(tmp_path):
    path = tmp_path / "i16.png"
    path.write_bytes(_encode(np.zeros((4, 4, 1), np.uint8), 0, depth=16))
    return path


def _interlaced(tmp_path):
    path = tmp_path / "adam7.png"
    path.write_bytes(_encode(np.zeros((4, 4, 1), np.uint8), 0, interlace=1))
    return path


def _bad_crc(tmp_path):
    data = bytearray(_encode(np.zeros((4, 4, 3), np.uint8), 2))
    data[40] ^= 0xFF                                   # inside the IDAT
    path = tmp_path / "crc.png"
    path.write_bytes(bytes(data))
    return path


def _truncated(tmp_path):
    path = tmp_path / "cut.png"
    path.write_bytes(_encode(np.zeros((4, 4, 3), np.uint8), 2)[:-20])
    return path


def _not_png(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"GIF89a" + bytes(40))
    return path


@pytest.mark.parametrize("make,reason", [
    (_palette, "colour type 3"), (_sixteen_bit, "bit depth 16"),
    (_interlaced, "interlaced"), (_bad_crc, "CRC"),
    (_truncated, "truncated"), (_not_png, "not a PNG")])
def test_unsupported_or_broken_files_raise(tmp_path, make, reason):
    with pytest.raises(ValueError, match=reason):
        png.read_png(make(tmp_path))


def test_compile_steps_match_jax():
    """load_occupancy, fill_unreachable, occupancy_to_segments,
    simplify_segments and segments_from_bitmap on the stage-1 rink, with and
    without reach seeds and simplification, equal to the JAX functions'."""
    rink = str(ASSETS / "rink.png")
    grid = tcompile.load_occupancy(rink, (20.0, 20.0), 0.2)
    np.testing.assert_array_equal(
        grid, jcompile.load_occupancy(rink, (20.0, 20.0), 0.2))
    filled = tcompile.fill_unreachable(grid, (20.0, 20.0), [(0.0, 0.0)])
    np.testing.assert_array_equal(
        filled, jcompile.fill_unreachable(grid, (20.0, 20.0), [(0.0, 0.0)]))
    raw = tcompile.occupancy_to_segments(filled, (20.0, 20.0))
    assert raw == jcompile.occupancy_to_segments(filled, (20.0, 20.0))
    assert (tcompile.simplify_segments(raw, 0.2)
            == jcompile.simplify_segments(raw, 0.2))
    for tol, seeds in ((0.0, None), (0.2, [(0.0, 0.0)]), (0.5, [(3.0, -2.0)])):
        assert (tcompile.segments_from_bitmap(rink, (20.0, 20.0), 0.2, tol,
                                              seeds)
                == jcompile.segments_from_bitmap(rink, (20.0, 20.0), 0.2,
                                                 tol, seeds)), (tol, seeds)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_grids_match_jax(seed):
    """Seeded random occupancy grids (as test_worlds.py's square, with
    holes, islands and touching corners) through the boundary, the flood
    fill and the simplification: the same segments in the same order."""
    rng = np.random.default_rng(seed)
    grid = rng.random((13, 9)) < 0.35
    size = (4.5, 6.5)
    segs = tcompile.occupancy_to_segments(grid, size)
    assert segs == jcompile.occupancy_to_segments(grid, size)
    seeds = [tuple(rng.uniform(-2.0, 2.0, 2)) for _ in range(2)]
    filled = tcompile.fill_unreachable(grid, size, seeds)
    np.testing.assert_array_equal(
        filled, jcompile.fill_unreachable(grid, size, seeds))
    for tol in (0.3, 0.7):
        for g in (grid, filled):
            s = tcompile.occupancy_to_segments(g, size)
            assert (tcompile.simplify_segments(s, tol)
                    == jcompile.simplify_segments(s, tol))


def test_polygons_boundary_and_packing_match_jax():
    """The stage-2 polygon obstacles, the border walls and the packed
    tables equal the JAX functions' (also random polygons)."""
    assert (tspec._stage2_obstacle_segments()
            == jspec._stage2_obstacle_segments())
    rng = np.random.default_rng(3)
    for _ in range(3):
        pts = [tuple(p) for p in rng.uniform(-3, 3, (7, 2))]
        size, center = tuple(rng.uniform(0.2, 2, 2)), tuple(rng.uniform(-9, 9, 2))
        assert (tcompile.polygon_segments(pts, size, center)
                == jcompile.polygon_segments(pts, size, center))
    assert (tcompile.boundary_segments(20.0, 12.0)
            == jcompile.boundary_segments(20.0, 12.0))
    segs = tspec._stage2_obstacle_segments() * 20
    for mine, ref in zip(tcompile.pack_segments(segs, 64),
                         jcompile.pack_segments(segs, 64)):
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)
    # one copy of the packers: spec.py imports them from compile.py
    assert tspec.pack_segments is tcompile.pack_segments
    assert tspec.boundary_segments is tcompile.boundary_segments


@pytest.mark.parametrize("world", ["stage1", "stage2", "circle"])
def test_compiled_worlds_are_the_committed_tables(world):
    """compile_world rebuilds each world's geometry from the port's assets:
    the same seg_p, seg_e and seg_valid, dtype and bits, as the committed
    table (the world the port runs) and as the JAX package's build."""
    mine, table, ref = (compile_world(world), get_world(world),
                        jspec.get_world(world))
    for name in ("seg_p", "seg_e", "seg_valid"):
        a, b, c = (getattr(s, name) for s in (mine, table, ref))
        assert a.dtype == b.dtype == c.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=name)
    assert mine.n_robots == table.n_robots and mine.name == world
