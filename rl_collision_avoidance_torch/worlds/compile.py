"""Host-side world compilation: Stage bitmaps and polygons -> wall segments.

The port's own copy of ``rl_collision_avoidance_tpu/worlds/compile.py``.
The reference's simulator (libstage) rasterizes world bitmaps into an
occupancy matrix at ``resolution`` meters (``worlds/stage1.world:3``) and
raytraces that raster.  Here the raster's *boundary* is extracted instead,
as axis-aligned line segments (an exact representation of the same
geometry), optionally simplified, and the engine intersects rays with
segments.  The bitmap is read by :mod:`.png` (no image library), and the
boundary comes from numpy alone.  The segment order is the JAX module's, so
the tables this compiles are the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np

from .png import read_grey


def load_occupancy(png_path: str, size_m: tuple[float, float], resolution: float) -> np.ndarray:
    """Load a Stage world bitmap and rasterize to a coarse occupancy grid.

    Dark pixels (<128) are occupied, matching Stage's bitmap loader.  A coarse
    cell is occupied if *any* covered pixel is occupied (conservative, like
    Stage's rendering of bitmap rectangles into its matrix).

    Returns a bool grid with index [iy, ix], iy=0 at the bitmap top (+y).
    """
    img = read_grey(png_path)
    occ = img < 128
    h, w = occ.shape
    gx = max(1, int(round(size_m[0] / resolution)))
    gy = max(1, int(round(size_m[1] / resolution)))
    # Block-reduce with edge padding so h, w need not divide evenly.
    ys = (np.arange(h) * gy) // h
    xs = (np.arange(w) * gx) // w
    grid = np.zeros((gy, gx), dtype=bool)
    np.logical_or.at(grid, (ys[:, None], xs[None, :]), occ)
    return grid


def _merge_runs(edges: np.ndarray) -> list[tuple[float, float, float, float]]:
    """Merge unit edges at integer coordinates into maximal runs.

    ``edges`` is an (M, 3) int array of (level, start, axis) unit edges where
    axis=0 means a horizontal edge y=level spanning x in [start, start+1],
    axis=1 a vertical edge x=level spanning y in [start, start+1].
    Returns segments in grid coordinates.
    """
    out = []
    for axis in (0, 1):
        e = edges[edges[:, 2] == axis]
        if e.size == 0:
            continue
        order = np.lexsort((e[:, 1], e[:, 0]))
        e = e[order]
        level, start = e[0, 0], e[0, 1]
        end = start + 1
        for lv, st, _ in e[1:]:
            if lv == level and st == end:
                end = st + 1
            else:
                out.append((level, start, end, axis))
                level, start, end = lv, st, st + 1
        out.append((level, start, end, axis))
    segs = []
    for level, start, end, axis in out:
        if axis == 0:
            segs.append(((float(start), float(level)), (float(end), float(level))))
        else:
            segs.append(((float(level), float(start)), (float(level), float(end))))
    return segs


def occupancy_to_segments(grid: np.ndarray, size_m: tuple[float, float]):
    """Extract the occupied/free boundary of a grid as world-frame segments.

    Grid row 0 is the bitmap top, i.e. maximal world y.  World frame is
    centered at the origin, x right, y up, spanning ``size_m``.
    """
    segs_grid = _merge_runs(_boundary_edges_np(grid))
    gy, gx = grid.shape
    cx, cy = size_m[0] / gx, size_m[1] / gy
    segs = []
    for (x0, y0), (x1, y1) in segs_grid:
        # grid y grows downward from the top row; flip into world y.
        p0 = (x0 * cx - size_m[0] / 2.0, size_m[1] / 2.0 - y0 * cy)
        p1 = (x1 * cx - size_m[0] / 2.0, size_m[1] / 2.0 - y1 * cy)
        segs.append((p0, p1))
    return segs


def _boundary_edges_np(grid: np.ndarray) -> np.ndarray:
    """Unit edges (level, start, axis) between occupied and free cells,
    the grid padded with free cells (see :func:`_merge_runs`)."""
    gy, gx = grid.shape
    padded = np.zeros((gy + 2, gx + 2), dtype=bool)
    padded[1:-1, 1:-1] = grid
    edges = []
    # Horizontal edges: between cell (iy, ix) and (iy-1, ix) when occupancy
    # differs.  Edge at grid line y=iy spanning x in [ix, ix+1].
    diff = padded[1:, 1:-1] != padded[:-1, 1:-1]  # (gy+1, gx)
    ys, xs = np.nonzero(diff)
    for y, x in zip(ys.tolist(), xs.tolist()):
        edges.append((y, x, 0))
    # Vertical edges.
    diff = padded[1:-1, 1:] != padded[1:-1, :-1]  # (gy, gx+1)
    ys, xs = np.nonzero(diff)
    for y, x in zip(ys.tolist(), xs.tolist()):
        edges.append((x, y, 1))
    return np.asarray(edges, dtype=np.int64).reshape(-1, 3)


def _chain_loops(segs):
    """Chain axis-aligned boundary segments into closed loops (each raster
    boundary vertex has exactly two incident edges)."""
    from collections import defaultdict

    adj = defaultdict(list)
    for i, (p0, p1) in enumerate(segs):
        adj[p0].append((i, p1))
        adj[p1].append((i, p0))
    used = [False] * len(segs)
    loops = []
    for start_i, (p0, p1) in enumerate(segs):
        if used[start_i]:
            continue
        loop = [p0, p1]
        used[start_i] = True
        cur = p1
        while True:
            nxt = None
            for i, other in adj[cur]:
                if not used[i]:
                    nxt = (i, other)
                    break
            if nxt is None:
                break
            used[nxt[0]] = True
            cur = nxt[1]
            if cur == loop[0]:
                break
            loop.append(cur)
        loops.append(loop)
    return loops


def _douglas_peucker(pts: np.ndarray, tol: float) -> np.ndarray:
    """Iterative DP polyline simplification (open chain)."""
    n = len(pts)
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        a, b = stack.pop()
        if b <= a + 1:
            continue
        seg = pts[b] - pts[a]
        length = np.hypot(*seg)
        if length < 1e-12:
            d = np.linalg.norm(pts[a + 1:b] - pts[a], axis=1)
        else:
            rel = pts[a + 1:b] - pts[a]
            d = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / length
        i = int(np.argmax(d))
        if d[i] > tol:
            keep[a + 1 + i] = True
            stack.append((a, a + 1 + i))
            stack.append((a + 1 + i, b))
    return pts[keep]


def simplify_segments(segs, tol: float):
    """Simplify raster boundary loops with Douglas-Peucker.

    ``tol`` bounds the geometric deviation; at half the raster resolution the
    simplified contour stays within the discretization error of the raster
    itself while collapsing staircase corners into a few chords — the lidar
    kernel's per-robot candidate count drops several-fold.
    """
    if tol <= 0:
        return segs
    out = []
    for loop in _chain_loops(segs):
        closed = loop[0] == loop[-1] or (len(loop) > 2 and np.allclose(loop[0], loop[-1]))
        pts = np.asarray(loop, dtype=np.float64)
        if closed and not np.allclose(pts[0], pts[-1]):
            pts = np.concatenate([pts, pts[:1]], axis=0)
        simp = _douglas_peucker(pts, tol)
        for i in range(len(simp) - 1):
            out.append((tuple(simp[i]), tuple(simp[i + 1])))
    return out


def fill_unreachable(grid: np.ndarray, size_m: tuple[float, float],
                     seeds_world) -> np.ndarray:
    """Mark every cell not in the free component(s) of the seed points as
    occupied.  Exact for any robot inside those components: geometry it can
    never reach or see (outer contours, enclosed voids) merges into solid
    blocks whose internal boundaries vanish, shrinking the segment set."""
    gy, gx = grid.shape
    free = ~grid
    reach = np.zeros_like(free)
    for wx, wy in seeds_world:
        ix = int(np.clip((wx + size_m[0] / 2) / size_m[0] * gx, 0, gx - 1))
        iy = int(np.clip((size_m[1] / 2 - wy) / size_m[1] * gy, 0, gy - 1))
        reach[iy, ix] = free[iy, ix]
    while True:
        grown = reach.copy()
        grown[1:] |= reach[:-1]
        grown[:-1] |= reach[1:]
        grown[:, 1:] |= reach[:, :-1]
        grown[:, :-1] |= reach[:, 1:]
        grown &= free
        if (grown == reach).all():
            return ~reach
        reach = grown


def segments_from_bitmap(png_path: str, size_m: tuple[float, float],
                         resolution: float, simplify_tol: float = 0.0,
                         reach_seeds=None):
    grid = load_occupancy(png_path, size_m, resolution)
    if reach_seeds is not None:
        grid = fill_unreachable(grid, size_m, reach_seeds)
    segs = occupancy_to_segments(grid, size_m)
    return simplify_segments(segs, simplify_tol)


def boundary_segments(sx: float, sy: float):
    """Four border walls (floorplan ``boundary 1``, worlds/stage1.world:27)."""
    hx, hy = sx / 2.0, sy / 2.0
    c = [(-hx, -hy), (hx, -hy), (hx, hy), (-hx, hy)]
    return [(c[i], c[(i + 1) % 4]) for i in range(4)]


def polygon_segments(points, size: tuple[float, float], center: tuple[float, float]):
    """Stage block semantics: normalize points to their bbox, scale to ``size``,
    center at ``center`` (see worlds/stage2.world:168-296 obstacle blocks)."""
    pts = np.asarray(points, dtype=np.float64)
    mn, mx = pts.min(axis=0), pts.max(axis=0)
    span = np.where(mx - mn > 0, mx - mn, 1.0)
    norm = (pts - mn) / span - 0.5
    world = norm * np.asarray(size) + np.asarray(center)
    n = len(world)
    return [(tuple(world[i]), tuple(world[(i + 1) % n])) for i in range(n)]


def pack_segments(segs, pad_to: int = 128):
    """Pack a segment list into padded (seg_p, seg_e, valid) arrays.

    Padding to a multiple of ``pad_to`` keeps the segment tables' shapes
    fixed for a world, as the JAX package's are.
    """
    n = len(segs)
    total = max(pad_to, ((n + pad_to - 1) // pad_to) * pad_to)
    seg_p = np.zeros((total, 2), dtype=np.float32)
    seg_e = np.zeros((total, 2), dtype=np.float32)
    valid = np.zeros((total,), dtype=bool)
    for i, (p0, p1) in enumerate(segs):
        seg_p[i] = p0
        seg_e[i] = (p1[0] - p0[0], p1[1] - p0[1])
        valid[i] = True
    return seg_p, seg_e, valid
