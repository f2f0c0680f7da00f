"""512-beam lidar, plain PyTorch: dense and culled ray/segment, ray/disc
and ray/box intersection.

Counterpart of ``rl_collision_avoidance_tpu/engine/lidar.py``.  These are
the plain versions: :func:`raycast_culled` with its exact disc silhouettes
is what the hand-written lidar kernel (``ops/csrc/lidar.cu``) computes and
is held against, :func:`raycast_walls` what its walls-only mode computes,
and the dense :func:`scan` is the reference both are tested with.  The
other robots' silhouettes are discs of ``radius`` or, with ``rect``,
Stage's oriented 0.44 x 0.38 m boxes (:func:`raycast_boxes`), optionally
culled to the ``disc_k`` nearest robots.  All geometry stays float32;
nothing here goes through a matrix unit, so no TF32 setting can reach it.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8
BIG = 1e9


def sparse_beam_index(raw: int, sparse: int) -> np.ndarray:
    """The reference's left/right two-pointer lidar resample as a static
    index table (``stage_world1.py:122-140``): the left half walks indices
    ``int(k * raw / sparse)`` up from beam 0, the right half walks down from
    beam ``raw - 1``, and the two meet in the middle.  For ``sparse == raw``
    it is the identity."""
    step = float(raw) / float(sparse)
    # Accumulate as the reference loop does: its running float index drifts
    # (6 * (512 / 24) accumulates to 127.999... -> 127, not 128), and the
    # drift is part of the observed behavior.
    left, index = [], 0.0
    for _ in range(sparse // 2):
        left.append(int(index))
        index += step
    right, index = [], raw - 1.0
    for _ in range(sparse // 2):
        right.append(int(index))
        index -= step
    return np.asarray(left + right[::-1], np.int32)


def beam_directions_local(n_beams: int, fov: float) -> np.ndarray:
    """(B, 2) unit beam directions in the robot body frame; beam 0 points to
    angle -fov/2 (the robot's right for fov = pi)."""
    ang = np.linspace(-fov / 2.0, fov / 2.0, n_beams)
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def rotate_beams(heading: torch.Tensor, local_dirs: torch.Tensor):
    """(..., N) heading x (B, 2) local dirs -> world-frame (dx, dy), each
    (..., N, B)."""
    c, s = torch.cos(heading)[..., None], torch.sin(heading)[..., None]
    lx, ly = local_dirs[:, 0], local_dirs[:, 1]
    return c * lx - s * ly, s * lx + c * ly


def raycast_segments(origins, dx, dy, seg_p, seg_e, seg_valid):
    """Min hit distance of rays against static segments (BIG where none).

    origins (N, 2); dx/dy (N, B); seg_p/seg_e (S, 2); seg_valid (S,).
    Ray o + t d vs segment p + u e with cross(a, b) = ax by - ay bx:
    t = cross(p - o, e) / cross(d, e), u = cross(p - o, d) / cross(d, e),
    hit iff t > 0 and u in [0, 1].
    """
    po = seg_p[None, :, :] - origins[:, None, :]                 # (N, S, 2)
    ex, ey = seg_e[:, 0], seg_e[:, 1]
    denom = dx[..., None] * ey - dy[..., None] * ex              # (N, B, S)
    t_num = po[..., 0] * ey - po[..., 1] * ex                    # (N, S)
    u_num = (po[:, None, :, 0] * dy[..., None]
             - po[:, None, :, 1] * dx[..., None])                # (N, B, S)
    ok = denom.abs() > EPS
    safe = torch.where(ok, denom, torch.full_like(denom, EPS))
    t = t_num[:, None, :] / safe
    u = u_num / safe
    hit = ok & (t > EPS) & (u >= 0.0) & (u <= 1.0) & seg_valid
    return torch.where(hit, t, torch.full_like(t, BIG)).amin(dim=-1)


def raycast_discs(origins, dx, dy, radius: float):
    """Min hit distance of each robot's rays against the other robots'
    discs (self excluded).  origins (N, 2); dx/dy (N, B) -> (N, B).
    Ray-circle: t = b - sqrt(b^2 - c) with b = d.(c - o), c = |c - o|^2 - r^2.
    """
    n = origins.shape[0]
    oc = origins[None, :, :] - origins[:, None, :]               # (N, M, 2)
    b = dx[..., None] * oc[:, None, :, 0] + dy[..., None] * oc[:, None, :, 1]
    c2 = (oc * oc).sum(-1) - radius * radius                     # (N, M)
    disc = b * b - c2[:, None, :]
    t = b - torch.sqrt(disc.clamp_min(0.0))
    not_self = ~torch.eye(n, dtype=torch.bool, device=origins.device)
    hit = (disc > 0.0) & (t > EPS) & not_self[:, None, :]
    return torch.where(hit, t, torch.full_like(t, BIG)).amin(dim=-1)


def _box_slab_min(px, py, cj, sj, dx, dy, half_len: float,
                  half_wid: float, hit_mask=None):
    """Slab core of the oriented-box raycast.

    px/py (..., N, M): ray origins in each target box's body frame; cj/sj
    (..., N, M): the target box's heading cos/sin; dx/dy (..., N, B):
    world-frame beam components; hit_mask: an optional (..., N, 1, M)
    extra hit condition.  Returns (..., N, B) min entry distances (BIG
    where none).  t_near = max over the axes of min(t0, t1), with t0/t1 =
    (-h - p) / q and (h - p) / q in the box frame; a hit needs t_near <=
    t_far and t_near > EPS, so a ray that starts inside a box reports no
    hit, as on the disc path.
    """
    cjb, sjb = cj[..., None, :], sj[..., None, :]
    qx = dx[..., None] * cjb + dy[..., None] * sjb                 # (..., N, B, M)
    qy = -dx[..., None] * sjb + dy[..., None] * cjb

    def slab(p, q, h):
        # a sign-preserving guard: q = 0 with p inside the slab gives
        # (-BIG, +BIG); outside it, both bounds land on the same side
        q_safe = torch.where(q >= 0.0, q.clamp_min(EPS), q.clamp_max(-EPS))
        r = 1.0 / q_safe
        t0 = (-h - p) * r
        t1 = (h - p) * r
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    tx0, tx1 = slab(px[..., None, :], qx, half_len)
    ty0, ty1 = slab(py[..., None, :], qy, half_wid)
    t_near = torch.maximum(tx0, ty0)
    t_far = torch.minimum(tx1, ty1)
    hit = (t_near <= t_far) & (t_near > EPS)
    if hit_mask is not None:
        hit = hit & hit_mask
    return torch.where(hit, t_near, BIG).amin(dim=-1)


def _box_frame(ocx, ocy, cj, sj):
    """The ray origin o in the frame of box j, from oc = c_j - o."""
    return -(ocx * cj + ocy * sj), -(-ocx * sj + ocy * cj)


def raycast_boxes(pose, dx, dy, half_len: float, half_wid: float):
    """Min hit distance of each robot's rays against the other robots'
    oriented boxes of half-dims (``half_len``, ``half_wid``): Stage
    ray-traces the actual 0.44 x 0.38 m footprint (worlds/stage1.world:83).

    pose (..., N, 3); dx/dy (..., N, B).  Returns (..., N, B) (BIG where
    no hit), self excluded.  Dense O(N^2 B): every robot tests every other
    box; :func:`raycast_boxes_culled` caps the boxes at k.
    """
    n = pose.shape[-2]
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])       # (..., N)
    oc = pose[..., None, :, :2] - pose[..., :, None, :2]          # (..., N, M, 2)
    ocx, ocy = oc[..., 0], oc[..., 1]
    cj, sj = c[..., None, :].expand_as(ocx), s[..., None, :].expand_as(ocx)
    px, py = _box_frame(ocx, ocy, cj, sj)
    eye = torch.eye(n, dtype=torch.bool, device=pose.device)
    return _box_slab_min(px, py, cj, sj, dx, dy, half_len, half_wid,
                         ~eye[:, None, :])


def nearest(key, k: int):
    """(..., N, k) indices of the k smallest entries of ``key`` (..., N, M)
    along its last axis, ties to the lower index, as JAX's ``top_k`` of
    ``-key`` picks them; 0 < k <= M - 1, so that the robot itself, whose
    entry the callers set to BIG, is left out."""
    if not 0 < k <= key.shape[-1] - 1:
        raise ValueError(f"cull k = {k} must lie in [1, {key.shape[-1] - 1}]"
                         f": it leaves out at least the robot itself")
    return torch.sort(key, dim=-1, stable=True).indices[..., :k]


def _offsets(pose, radius: float = 0.0):
    """(..., N, M, 2) offsets c_j - o_i and (..., N, M) |c_j - o_i|^2 -
    radius^2, BIG for the robot itself."""
    oc = pose[..., None, :, :2] - pose[..., :, None, :2]          # (..., N, M, 2)
    c2 = (oc * oc).sum(-1) - radius * radius
    eye = torch.eye(pose.shape[-2], dtype=torch.bool, device=pose.device)
    return oc, torch.where(eye, torch.full_like(c2, BIG), c2)


def raycast_boxes_culled(pose, dx, dy, half_len: float, half_wid: float,
                         k: int):
    """:func:`raycast_boxes` against only each robot's ``k`` nearest other
    robots (top-k on centre distance, 0 < k <= N - 1).  Exact whenever at
    most k other robots lie within max_range plus the box's circumradius of
    the sensor; in denser pileups a beam may keep a slightly far reading
    where a farther (usually occluded) box would have been hit, the
    approximation of the disc path's ``disc_k``.  The boxes' cos and sin
    are gathered, not recomputed, so k = N - 1 gives the dense result to
    the last bit."""
    oc, d2 = _offsets(pose)
    idx = nearest(d2, k)
    take = lambda v: torch.gather(v, -1, idx)
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    cj = take(c[..., None, :].expand_as(d2))
    sj = take(s[..., None, :].expand_as(d2))
    px, py = _box_frame(take(oc[..., 0]), take(oc[..., 1]), cj, sj)
    return _box_slab_min(px, py, cj, sj, dx, dy, half_len, half_wid)


def raycast_walls(pose, dx, dy, culled):
    """Min hit distance (BIG where none) of each robot's rays against its
    candidate segments, with the lidar kernel's 13-op segment test.

    pose (A, N, 3); dx/dy (A, N, B) world-frame beam components; culled
    (A, N, K, 4) [px, py, ex, ey] per-robot candidate segments from the
    cell table.  With w = cross(d, e) and c0 = cross(p0 - o, d) = u w, the
    window test u in [0, 1] is the sign test c0 (w - c0) >= 0, and t =
    cross(p0 - o, e) / w.
    """
    x, y = pose[..., 0:1], pose[..., 1:2]
    px = culled[..., 0] - x                                       # (A, N, K)
    py = culled[..., 1] - y
    ex, ey = culled[..., 2], culled[..., 3]
    w = dx[..., None] * ey[..., None, :] - dy[..., None] * ex[..., None, :]
    c0 = px[..., None, :] * dy[..., None] - py[..., None, :] * dx[..., None]
    t_num = (px * ey - py * ex)[..., None, :]                     # (A, N, 1, K)
    win = c0 * (w - c0)
    t = t_num / torch.where(w == 0.0, torch.full_like(w, EPS), w)
    hit = (win >= 0.0) & (t > EPS)
    return torch.where(hit, t, torch.full_like(t, BIG)).amin(dim=-1)


def raycast_robots(pose, dx, dy, radius: float, disc_k: int | None = None,
                   rect=None):
    """Min hit distance (BIG where none) of each robot's rays against the
    other robots of its arena: discs of ``radius`` or, with ``rect`` =
    (half_len, half_wid), oriented boxes; with ``disc_k`` < N only the
    disc_k nearest (:func:`raycast_boxes_culled`; for discs the same
    top-k, on c2, which orders by distance).  pose (A, N, 3); dx/dy
    (A, N, B)."""
    n = pose.shape[-2]
    culled = disc_k is not None and disc_k < n
    if rect is not None:
        if culled:
            return raycast_boxes_culled(pose, dx, dy, rect[0], rect[1],
                                        min(disc_k, n - 1))
        return raycast_boxes(pose, dx, dy, rect[0], rect[1])
    oc, c2 = _offsets(pose, radius)                               # (A, N, M)
    ocx, ocy = oc[..., 0], oc[..., 1]
    if culled:
        # c2 orders the discs by distance
        idx = nearest(c2, min(disc_k, n - 1))
        c2, ocx, ocy = (torch.gather(v, -1, idx) for v in (c2, ocx, ocy))
    b = dx[..., None] * ocx[..., None, :] + dy[..., None] * ocy[..., None, :]
    disc = b * b - c2[..., None, :]                               # (A, N, B, M)
    td = b - torch.sqrt(disc.clamp_min(0.0))
    hitd = (disc > 0.0) & (td > EPS)
    return torch.where(hitd, td, torch.full_like(td, BIG)).amin(dim=-1)


def raycast_culled(pose, local_dirs, culled, radius: float, max_range: float,
                   disc_k: int | None = None, rect=None):
    """Culled raycast batched over arenas: :func:`raycast_walls` and
    :func:`raycast_robots`, clipped to ``max_range``.

    pose (A, N, 3); local_dirs (B, 2); culled (A, N, K, 4) [px, py, ex, ey]
    per-robot candidate segments from the cell table.  Returns (A, N, B)
    ranges, the robots of the same arena included: discs of ``radius``
    (exact unless ``disc_k`` < N), or oriented boxes with ``rect`` =
    (half_len, half_wid).
    """
    dx, dy = rotate_beams(pose[..., 2], local_dirs)               # (A, N, B)
    d_seg = raycast_walls(pose, dx, dy, culled)
    d_rob = raycast_robots(pose, dx, dy, radius, disc_k, rect)
    return torch.minimum(d_seg, d_rob).clamp_max(max_range)


def scan(pose, local_dirs, seg_p, seg_e, seg_valid, robot_radius: float,
         max_range: float, rect=None):
    """Dense lidar scan of one arena against every segment.

    pose (N, 3) [x, y, theta] -> ranges (N, B) clipped to ``max_range``;
    ``rect`` = (half_len, half_wid): the other robots as oriented boxes
    (:func:`raycast_boxes`) instead of discs.
    """
    origins = pose[:, :2]
    dx, dy = rotate_beams(pose[:, 2], local_dirs)
    d_seg = raycast_segments(origins, dx, dy, seg_p, seg_e, seg_valid)
    if rect is not None:
        d_rob = raycast_boxes(pose, dx, dy, rect[0], rect[1])
    else:
        d_rob = raycast_discs(origins, dx, dy, robot_radius)
    return torch.minimum(d_seg, d_rob).clamp_max(max_range)
