"""
kraken_tpu_torch.lib.polygonization
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Baseline → bounding-polygon computation: for every baseline a region of
interest is found by casting perpendicular rays against adjacent lines and
hard boundaries, then a minimum-energy seam is carved through the gradient
feature map above and below the (offset) baseline and both seams are fused
into the bounding polygon.

Functional equivalent of the reference's calculate_polygonal_environment
stack (kraken/lib/segmentation.py:560-843) built without shapely/skimage:
polygon boolean operations run as rasterized mask ops (everything is in
pixel space), line offsets as direct normal-vector shifts, and rotations via
cv2 affine warps.

A copy of the JAX package's ``lib/polygonization.py``. The seam DPs run
on the host (native C++ or numpy) or, with ``seam_carver='device'`` (the
segmenter's ``device_vectorize``), all of a page's in one launch of the
seam kernel (``ops/seam.py``, ``csrc/seam.cu``).
"""
import logging
from functools import partial
from typing import Optional, Sequence

import cv2
import numpy as np

from kraken_tpu_torch.lib.fastfilters import gaussian_filter

from kraken_tpu_torch.lib.geometry import douglas_peucker, polyline_dists

logger = logging.getLogger(__name__)

__all__ = ['calculate_polygonal_environment']

_MASK_VAL = 99999.0


def sobel_magnitude(im: np.ndarray) -> np.ndarray:
    """
    Gradient magnitude with 3x3 Sobel kernels normalized like
    skimage.filters.sobel (kernel weights /4, magnitude /sqrt(2), input
    scaled to [0, 1]).
    """
    img = im.astype(np.float32)
    if img.max() > 1:
        img = img / 255.0
    gx = cv2.Sobel(img, cv2.CV_32F, 1, 0, ksize=3) / 4.0
    gy = cv2.Sobel(img, cv2.CV_32F, 0, 1, ksize=3) / 4.0
    return np.sqrt(gx ** 2 + gy ** 2) / np.sqrt(2)


def gradient_feature_map(im: np.ndarray) -> np.ndarray:
    """Default seam-carve energy map: gaussian_filter(sobel(im), 0.5)."""
    return gaussian_filter(sobel_magnitude(im), 0.5)


def _interpolate_polyline(line: np.ndarray, step: float = 10.0) -> np.ndarray:
    """Resamples a polyline at fixed arc-length steps, keeping endpoints."""
    dists = polyline_dists(line)
    total = dists[-1]
    targets = np.arange(step, total, step)
    segs = np.clip(np.searchsorted(dists, targets), 1, len(line) - 1)
    denom = dists[segs] - dists[segs - 1]
    frac = np.where(denom > 0, (targets - dists[segs - 1]) / np.where(denom > 0, denom, 1), 0)
    mids = line[segs - 1] + frac[:, None] * (line[segs] - line[segs - 1])
    return np.concatenate([line[:1], mids, line[-1:]])


def _offset_polyline(line: np.ndarray, offset: float, side: str) -> np.ndarray:
    """
    Shifts a polyline along its per-vertex normals. side='left' offsets
    against the direction of travel's left (matching shapely's
    parallel_offset convention in image coordinates).
    """
    if offset == 0:
        return line.copy()
    diffs = np.diff(line, axis=0)
    norms = np.linalg.norm(diffs, axis=1, keepdims=True)
    norms[norms == 0] = 1
    tangents = diffs / norms
    # per-vertex tangent: average of adjacent segment tangents
    vt = np.vstack([tangents[:1], (tangents[:-1] + tangents[1:]) / 2, tangents[-1:]])
    vt /= np.maximum(np.linalg.norm(vt, axis=1, keepdims=True), 1e-9)
    # shapely parallel_offset convention: the 'right' side of direction
    # (dx, dy) is (dy, -dx) — upward in image coordinates for a left-to-right
    # line (y axis points down)
    normal = np.stack([vt[:, 1], -vt[:, 0]], axis=1)
    if side == 'left':
        normal = -normal
    return line + offset * normal


def _calc_roi(line: np.ndarray, bounds: np.ndarray,
              neighbors: list[np.ndarray], p_dir: np.ndarray):
    """
    Computes the upper/lower envelope of a baseline's region of interest:
    perpendicular rays from interpolated baseline points, clipped at the
    nearest adjacent line (or hard boundary) on each side.
    """
    ip_line = _interpolate_polyline(line)
    # perpendiculars to the average direction vector
    up_dir = np.array([p_dir[1], -p_dir[0]])
    down_dir = -up_dir
    # reference orientation: 'up' rays use (p_dir * (-1, 1))[::-1]
    up_dir = (p_dir * (-1, 1))[::-1]
    down_dir = (p_dir * (1, -1))[::-1]

    seg_starts = []
    seg_ends = []
    for n in neighbors:
        n = np.asarray(n, float)
        if len(n) >= 2:
            seg_starts.append(n[:-1])
            seg_ends.append(n[1:])
    if seg_starts:
        seg_starts = np.concatenate(seg_starts)
        seg_ends = np.concatenate(seg_ends)
    else:
        seg_starts = np.zeros((0, 2))
        seg_ends = np.zeros((0, 2))

    def _env(direction: np.ndarray) -> np.ndarray:
        # ray/AABB exit distance for every interpolated point at once
        # (candidate selection of the reference's _ray_intersect_boundaries,
        # segmentation.py:540-558)
        frac = np.where(direction == 0.0, np.inf,
                        np.divide(1.0, np.where(direction == 0, 1, direction)))
        t1 = (-ip_line[:, 0]) * frac[0]
        t2 = (bounds[0] + 1 - ip_line[:, 0]) * frac[0]
        t3 = (-ip_line[:, 1]) * frac[1]
        t4 = (bounds[1] + 1 - ip_line[:, 1]) * frac[1]
        tmin = np.maximum(np.minimum(t1, t2), np.minimum(t3, t4))
        tmax = np.minimum(np.maximum(t1, t2), np.maximum(t3, t4))
        cands = np.stack([tmin, tmax])
        nonneg = cands >= 0
        if not nonneg.any(axis=0).all():
            raise ValueError('Ray misses the image bounds')
        tt = np.where(nonneg, cands, np.inf).min(axis=0)
        bound_pts = ip_line + direction * tt[:, None]
        if not len(seg_starts):
            return bound_pts
        # AABB prune: a valid hit lies on both the ray span and the segment,
        # so any segment whose bounding box misses the ray fan's bounding box
        # cannot contribute — exact, only removes provably-missing segments
        fan_min = np.minimum(ip_line.min(0), bound_pts.min(0))
        fan_max = np.maximum(ip_line.max(0), bound_pts.max(0))
        s_min = np.minimum(seg_starts, seg_ends)
        s_max = np.maximum(seg_starts, seg_ends)
        near = ((s_min <= fan_max) & (s_max >= fan_min)).all(axis=1)
        if not near.all():
            seg_starts_f, seg_ends_f = seg_starts[near], seg_ends[near]
        else:
            seg_starts_f, seg_ends_f = seg_starts, seg_ends
        if not len(seg_starts_f):
            return bound_pts
        # segment intersections, batched (P points × S neighbor segments)
        r = bound_pts - ip_line                                   # (P, 2)
        s = seg_ends_f - seg_starts_f                             # (S, 2)
        denom = r[:, 0, None] * s[None, :, 1] - r[:, 1, None] * s[None, :, 0]
        ok = np.abs(denom) > 1e-12
        diff = seg_starts_f[None, :, :] - ip_line[:, None, :]     # (P, S, 2)
        with np.errstate(divide='ignore', invalid='ignore'):
            t = (diff[..., 0] * s[None, :, 1] - diff[..., 1] * s[None, :, 0]) / denom
            u = (diff[..., 0] * r[:, 1, None] - diff[..., 1] * r[:, 0, None]) / denom
            valid = ok & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
        # hit distance along the ray is t·|r| with |r| constant per point,
        # so the nearest hit is simply the minimum valid t — no need to
        # materialize the (P, S, 2) hit coordinates
        t_min = np.where(valid, t, np.inf).min(axis=1)
        has_hit = np.isfinite(t_min)
        nearest = ip_line + np.where(has_hit, t_min, 0.0)[:, None] * r
        # 1px pull-back towards the baseline (reference buffers adjacent
        # lines by 1)
        vec = nearest - ip_line
        vlen = np.linalg.norm(vec, axis=1)
        pull = vlen > 1
        scale = np.where(pull, (vlen - 1) / np.where(vlen > 0, vlen, 1), 1.0)
        nearest = np.where(pull[:, None], ip_line + vec * scale[:, None], nearest)
        return np.where(has_hit[:, None], nearest, bound_pts)

    return (_env(up_dir).astype('int').clip(0),
            _env(down_dir).astype('int').clip(0))


def _rasterize_polygon(polygon: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    mask = np.zeros(shape, np.uint8)
    cv2.fillPoly(mask, [np.round(polygon).astype(np.int32)], 1)
    return mask


def _rotation_transform(shape: tuple[int, int], angle: float, scale: float):
    """
    Forward/backward affine maps for rotating an image patch to the
    rectified (baseline-level) frame, expanding the canvas (same transform
    geometry as geometry._rotate_image, returned as matrices for coordinate
    mapping).
    """
    rows, cols = shape
    c, s = np.cos(angle), np.sin(angle)
    fwd = np.array([[c / scale, s / scale], [-s, c]])  # input -> output (scale x)
    # build from the reference's AffineTransform(rotation, scale=(1/scale, 1))
    fwd = np.array([[c, -s], [s, c]]) @ np.diag([1 / scale, 1])
    inv = np.linalg.inv(fwd)
    corners = np.array([[0, 0], [0, rows - 1], [cols - 1, rows - 1], [cols - 1, 0]], float)
    mapped = corners @ inv.T
    mins = mapped.min(axis=0)
    maxs = mapped.max(axis=0)
    out_shape = (int(np.around(maxs[1] - mins[1] + 1)), int(np.around(maxs[0] - mins[0] + 1)))

    def to_rot(pts):
        return np.atleast_2d(pts) @ inv.T - mins

    def from_rot(pts):
        return (np.atleast_2d(pts) + mins) @ fwd.T

    return to_rot, from_rot, out_shape, fwd, mins


def _rotate_patch(patch: np.ndarray, angle: float, scale: float, cval: float):
    to_rot, from_rot, out_shape, fwd, mins = _rotation_transform(patch.shape, angle, scale)
    # cv2.warpAffine with WARP_INVERSE_MAP takes the output→input map in
    # (x, y) order: src_xy = fwd @ (dst_xy + mins) — from_rot as a matrix.
    m = np.concatenate([fwd, (fwd @ mins)[:, None]], axis=1)
    rotated = cv2.warpAffine(np.ascontiguousarray(patch, np.float32), m,
                             (out_shape[1], out_shape[0]),
                             flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                             borderMode=cv2.BORDER_CONSTANT, borderValue=cval)
    return rotated, to_rot, from_rot


def _carve_seam(rotated: np.ndarray) -> np.ndarray:
    """
    Vertical-position seam through a rotated (roughly level) energy patch:
    standard 8-connected dynamic program left→right, returning one row per
    column. Runs in the native C++ library when available.
    """
    from kraken_tpu_torch import native
    patch = np.pad(rotated, ((1, 1), (0, 0)), mode='constant', constant_values=np.inf)
    rows = native.carve_seam_native(patch)
    if rows is not None:
        return rows - 1
    r, c = patch.shape
    cost = patch.copy()
    backtrack = np.zeros((r - 2, c), np.int32)
    rows = np.arange(1, r - 1)
    for j in range(1, c):
        prev = np.stack([cost[0:r - 2, j - 1], cost[1:r - 1, j - 1], cost[2:r, j - 1]])
        arg = np.argmin(prev, axis=0)
        backtrack[:, j] = rows + arg - 1
        cost[1:r - 1, j] += prev[arg, np.arange(r - 2)]
    seam = np.zeros(c, np.int32)
    seam[-1] = np.argmin(cost[1:r - 1, -1]) + 1
    for j in range(c - 2, -1, -1):
        seam[j] = backtrack[seam[j + 1] - 1, j + 1]
    return seam - 1  # remove pad offset


def _seam_prepare(baseline: np.ndarray, polygon: np.ndarray, angle: float,
                  im_feats: np.ndarray, bias: int = 150):
    """
    First half of :func:`_calc_seam`: builds the biased/masked energy patch,
    rotates it level, and crops to the baseline span. Returns
    (cropped rotated patch, finish(seam_rows) -> seam points).
    """
    polygon = np.asarray(polygon)
    c_min, c_max = int(polygon[:, 0].min()), int(polygon[:, 0].max())
    r_min, r_max = int(polygon[:, 1].min()), int(polygon[:, 1].max())
    patch = im_feats[r_min:r_max + 2, c_min:c_max + 2].astype(np.float32).copy()
    if patch.size == 0:
        # negative/out-of-image ROI coordinates flip the window into an
        # empty slice (same failure mode as the reference's unclipped
        # window, kraken/lib/segmentation.py:569-571); fail with a clear
        # per-line error instead of tripping asserts in cv2
        raise ValueError(f'empty ROI patch (rows {r_min}:{r_max + 2}, cols '
                         f'{c_min}:{c_max + 2} of {im_feats.shape}) — '
                         'line ROI outside the image?')
    # distance-from-baseline bias
    mask = np.ones_like(patch, np.uint8)
    bl = np.round(np.asarray(baseline) - (c_min, r_min)).astype(np.int32)
    cv2.polylines(mask, [bl.reshape(-1, 1, 2)], False, 0, 1)
    # chessboard (Chebyshev) distance from the rasterized baseline; the
    # 3x3-mask DIST_C chamfer is exact for this metric
    dist_bias = cv2.distanceTransform(mask, cv2.DIST_C, 3)
    # mask outside ROI polygon. The valid region is dilated by 2px
    # (4-connected, matching the reference's binary_erosion of the outside
    # mask with border_value=True, segmentation.py:583-584) so that thin
    # ROIs survive rotation aliasing instead of vanishing entirely.
    roi_mask = _rasterize_polygon(polygon - (c_min, r_min), patch.shape)
    cross = cv2.getStructuringElement(cv2.MORPH_CROSS, (3, 3))
    roi_mask = cv2.dilate(roi_mask, cross, iterations=2,
                          borderType=cv2.BORDER_CONSTANT, borderValue=0)
    outside = roi_mask == 0
    patch[outside] = _MASK_VAL
    valid_mean = patch[~outside].mean() if (~outside).any() else 1.0
    patch += dist_bias * (valid_mean / bias)

    extrema = np.asarray(baseline)[(0, -1), :] - (c_min, r_min)
    scale = min(1.0, 600 / max(c_max - c_min, 1))
    rotated, to_rot, from_rot = _rotate_patch(patch, angle, scale, _MASK_VAL)
    x_range = np.sort(np.around(to_rot(extrema.astype(float))[:, 0]).astype(int))
    x0 = max(0, x_range[0])
    x1 = min(rotated.shape[1] - 1, x_range[1])
    if x1 <= x0:
        raise ValueError('Degenerate rotated patch for seam carving')

    def finish(seam_rows: np.ndarray) -> np.ndarray:
        seam = np.stack([np.arange(x0, x1 + 1), seam_rows], axis=1).astype(float)
        mean, std = seam[:, 1].mean(), seam[:, 1].std()
        seam[:, 1] = np.clip(seam[:, 1], mean - std, mean + std)
        seam = from_rot(seam).astype(int)
        # filter points outside the patch or in the masked region
        keep = (seam[:, 0] >= 0) & (seam[:, 1] >= 0) & \
               (seam[:, 0] < outside.shape[1]) & (seam[:, 1] < outside.shape[0])
        seam = seam[keep]
        seam = seam[~outside[seam[:, 1], seam[:, 0]]]
        if len(seam) < 2:
            raise ValueError('Seam carving produced no valid points')
        return seam + (c_min, r_min)

    return rotated[:, x0:x1 + 1], finish


def _calc_seam(baseline: np.ndarray, polygon: np.ndarray, angle: float,
               im_feats: np.ndarray, bias: int = 150) -> np.ndarray:
    """
    Carves the minimum-energy seam between a baseline and its ROI boundary:
    the energy patch is masked outside the ROI polygon, biased by distance
    from the baseline, rotated level, carved, smoothed, and mapped back.
    """
    cropped, finish = _seam_prepare(baseline, polygon, angle, im_feats, bias)
    return finish(_carve_seam(cropped))


def _prepare_seams(env_up: np.ndarray, env_bottom: np.ndarray,
                   baseline: np.ndarray, offset_baseline: np.ndarray,
                   end_points, topline: Optional[bool], offset: int,
                   im_feats: np.ndarray):
    """
    Builds the two seam-carve energy patches for a line and returns
    ``(upper patch, bottom patch, complete)`` where ``complete(rows_u,
    rows_b)`` turns the carved seam rows into the final bounding polygon.
    Splitting preparation from carving lets a caller batch the DP across
    all of a page's patches.
    """
    upper_polygon = np.concatenate((baseline, env_up[::-1]))
    bottom_polygon = np.concatenate((baseline, env_bottom[::-1]))
    upper_offset_polygon = np.concatenate((offset_baseline, env_up[::-1]))
    bottom_offset_polygon = np.concatenate((offset_baseline, env_bottom[::-1]))

    diffs = np.diff(baseline, axis=0).astype(float)
    lengths = np.linalg.norm(diffs, axis=1)
    p_dir = (diffs * (lengths / lengths.sum())[:, None]).sum(0)
    p_dir /= np.linalg.norm(p_dir)
    angle = np.arctan2(p_dir[1], p_dir[0])

    if topline:
        patch_u, finish_u = _seam_prepare(baseline, upper_polygon, angle, im_feats)
        patch_b, finish_b = _seam_prepare(offset_baseline, bottom_offset_polygon, angle, im_feats)
    else:
        patch_u, finish_u = _seam_prepare(offset_baseline, upper_offset_polygon, angle, im_feats)
        patch_b, finish_b = _seam_prepare(baseline, bottom_polygon, angle, im_feats)

    def complete(rows_u: np.ndarray, rows_b: np.ndarray) -> np.ndarray:
        upper_seam = douglas_peucker(finish_u(rows_u).astype(float), 5).astype(int)
        bottom_seam = douglas_peucker(finish_b(rows_b).astype(float), 5).astype(int)
        if offset:
            upper_seam = np.round(_offset_polyline(upper_seam.astype(float), offset // 2, 'right')).astype(int)[::1]
            bottom_seam = np.round(_offset_polyline(bottom_seam.astype(float), offset // 2, 'left')).astype(int)

        polygon = np.concatenate(([end_points[0]], upper_seam, [end_points[-1]], bottom_seam[::-1]))
        # clip to ROI: rasterize candidate polygon and ROI union, intersect, trace
        all_pts = np.concatenate([polygon, upper_polygon, bottom_polygon])
        c0, r0 = np.floor(all_pts.min(0)).astype(int) - 1
        c1, r1 = np.ceil(all_pts.max(0)).astype(int) + 2
        shape = (r1 - r0, c1 - c0)
        roi = _rasterize_polygon(upper_polygon - (c0, r0), shape) | \
            _rasterize_polygon(bottom_polygon - (c0, r0), shape)
        cand = _rasterize_polygon(polygon - (c0, r0), shape)
        inter = (roi & cand).astype(np.uint8)
        contours, _ = cv2.findContours(inter, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        if not contours:
            raise ValueError('Empty ROI/seam polygon intersection')
        boundary = max(contours, key=cv2.contourArea).squeeze(1)
        if boundary.ndim != 2 or len(boundary) < 3:
            raise ValueError('Degenerate bounding polygon')
        return (boundary + (c0, r0)).astype(int)

    return patch_u, patch_b, complete


def _fuse_polygon(env_up: np.ndarray, env_bottom: np.ndarray,
                  baseline: np.ndarray, offset_baseline: np.ndarray,
                  end_points, topline: Optional[bool], offset: int,
                  im_feats: np.ndarray) -> np.ndarray:
    """
    Builds the final bounding polygon from the two carved seams, clipped to
    the ROI (rasterized boolean intersection instead of shapely ops).
    """
    patch_u, patch_b, complete = _prepare_seams(env_up, env_bottom, baseline,
                                                offset_baseline, end_points,
                                                topline, offset, im_feats)
    return complete(_carve_seam(patch_u), _carve_seam(patch_b))


def _prepare_line(line, neighbors: list, bounds: np.ndarray,
                  topline: Optional[bool], im_feats: np.ndarray):
    """ROI + seam-patch preparation for one baseline against its neighbor
    polylines; returns (patch_u, patch_b, complete)."""
    line_arr = np.array(line, float)
    end_points = (line_arr[0].astype(int), line_arr[-1].astype(int))
    offset = 8 if topline is not None else 0
    offset_line = _offset_polyline(line_arr, offset, 'left' if topline else 'right')
    diffs = np.diff(line_arr, axis=0)
    lengths = np.linalg.norm(diffs, axis=1)
    p_dir = (diffs * (lengths / lengths.sum())[:, None]).sum(0)
    p_dir /= np.linalg.norm(p_dir)
    env_up, env_bottom = _calc_roi(line_arr, bounds, neighbors, p_dir)
    return _prepare_seams(env_up, env_bottom,
                          line_arr.astype(int), offset_line.astype(int),
                          end_points, topline, offset, im_feats)


def _carve_rows_device(patches: list, device='cuda') -> list:
    """The seam DP of a list of (h, w) float32 patches on `device`, each
    carved as it is with an +inf row above and below it (the host DP's
    pad): :func:`kraken_tpu_torch.ops.seam.carve_seams_ragged` packs them
    column-major into one buffer, with no common shape, and carves them in
    one launch. Returns each patch's seam rows with the pad offset
    removed."""
    from kraken_tpu_torch.ops.seam import carve_seams_ragged
    return carve_seams_ragged(patches, device)


def polygonize_page(jobs: Sequence, im_feats: np.ndarray,
                    topline: Optional[bool] = False,
                    raise_on_error: bool = False,
                    seam_carver: str = 'host',
                    device='cuda') -> list:
    """
    Page-level polygonization: every entry of `jobs` is a
    ``(baseline, suppl_obj)`` pair with its own boundary set (the other
    lines plus any containing regions, as vec_lines builds them).
    Preparation and completion run in the native C++ polygonizer when
    available (kraken_tpu_torch/native/polygonize.cpp — one call for the
    whole page), else per line in numpy/OpenCV; the seam DPs run either
    on the host too (``seam_carver='host'``, the default: the native DP or
    numpy) or all of the page's in one launch of the seam kernel on
    `device` (``seam_carver='device'``, ``ops/seam.py``; ``device='cpu'``
    runs its plain version). Both carvers give the same polygons. The
    JAX package defaults to its device carver; the port keeps the host
    one, which needs no device.
    """
    carve_rows = partial(_carve_rows_device, device=device) if seam_carver == 'device' else None
    if not raise_on_error:
        from kraken_tpu_torch import native
        if native.available():
            out = native.polygonize_page_native(
                [j[0] for j in jobs], [j[1] for j in jobs], im_feats, topline,
                carve_rows=carve_rows)
            if out is not None:
                for idx, pol in enumerate(out):
                    if pol is None:
                        logger.warning(f'Polygonization failed for line {idx}')
                return out

    bounds = np.array(im_feats.shape[::-1], dtype=float) - 1

    def prepare_one(idx, line):
        neighbors = [np.asarray(o, float) for o in jobs[idx][1]]
        return _prepare_line(line, neighbors, bounds, topline, im_feats)

    if seam_carver == 'device':
        return _polygonize_batched([j[0] for j in jobs], prepare_one, raise_on_error, device)

    def _one(idx, line):
        try:
            patch_u, patch_b, complete = prepare_one(idx, line)
            return complete(_carve_seam(patch_u), _carve_seam(patch_b)).tolist()
        except Exception as e:
            if raise_on_error:
                raise
            logger.warning(f'Polygonization failed for line {idx}: {e}')
            return None
    return [_one(i, j[0]) for i, j in enumerate(jobs)]


def _polygonize_batched(baselines, prepare_one, raise_on_error: bool, device='cuda') -> list:
    """
    Batched polygonization: prepares every line's two seam patches on the
    host, carves all seams in one launch of the seam kernel on `device`
    (:func:`_carve_rows_device`), then completes each polygon. Each patch
    is carved over its own rows and columns, with the host DP's +inf pad
    rows, so the results are those of the per-line host DP.
    """
    preps = []
    for idx, line in enumerate(baselines):
        try:
            preps.append(prepare_one(idx, line))
        except Exception as e:
            if raise_on_error:
                raise
            logger.warning(f'Polygonization failed for line {idx}: {e}')
            preps.append(None)

    patches = [p for pr in preps if pr is not None for p in pr[:2]]
    if not patches:
        return [None] * len(preps)
    rows = _carve_rows_device(patches, device)

    polygons = []
    k = 0
    for idx, pr in enumerate(preps):
        if pr is None:
            polygons.append(None)
            continue
        rows_u, rows_b = rows[k], rows[k + 1]
        k += 2
        try:
            polygons.append(pr[2](rows_u, rows_b).tolist())
        except Exception as e:
            if raise_on_error:
                raise
            logger.warning(f'Polygonization failed for line {idx}: {e}')
            polygons.append(None)
    return polygons


def calculate_polygonal_environment(im=None,
                                    baselines: Sequence = None,
                                    suppl_obj: Sequence = None,
                                    im_feats: np.ndarray = None,
                                    scale: tuple[int, int] = None,
                                    topline: Optional[bool] = False,
                                    raise_on_error: bool = False,
                                    seam_carver: str = 'host',
                                    device='cuda') -> list:
    """
    Computes a bounding polygon for every baseline.

    Args:
        im: grayscale PIL input image (ignored when im_feats given).
        baselines: list of [(x, y), ...] baselines.
        suppl_obj: additional polylines treated as hard boundaries.
        im_feats: precomputed seam-carve energy map.
        scale: optional (h, w) processing scale (0 = proportional).
        topline: baseline position: False = bottom, True = top,
                 None = centerline (no offset).
        raise_on_error: raise instead of emitting None for failed lines.
        seam_carver: 'host' runs the per-line seam DP on the host (native
                 C++ / numpy); 'device' carves every patch of the call in
                 one launch of the seam kernel on `device` (``ops/seam.py``;
                 ``device='cpu'`` its plain version): the same polygons.

    Returns:
        One polygon (list of (x, y)) or None per baseline.
    """
    if scale is not None and (scale[0] > 0 or scale[1] > 0):
        w, h = im.size
        oh, ow = scale
        if oh == 0:
            oh = int(h * ow / w)
        elif ow == 0:
            ow = int(w * oh / h)
        im = im.resize((ow, oh))
        scale_f = np.array((ow / w, oh / h))
        baselines = [(np.array(bl) * scale_f).astype('int').tolist() for bl in baselines]
        if suppl_obj is not None:
            suppl_obj = [(np.array(o) * scale_f).astype('int').tolist() for o in suppl_obj]
    else:
        scale_f = None

    if im_feats is None:
        bounds = np.array(im.size, dtype=float) - 1
        im_feats = gradient_feature_map(np.asarray(im.convert('L')))
    else:
        bounds = np.array(im_feats.shape[::-1], dtype=float) - 1

    suppl_obj = list(suppl_obj) if suppl_obj is not None else []

    from kraken_tpu_torch import native
    if not raise_on_error and native.available():
        # native page polygonizer: ROI + patches + DP + completion in one
        # C++ call (the cv2/numpy code below remains the documented
        # fallback; boundary rasterization may differ by single pixels)
        polygons = native.polygonize_page_native(
            baselines, [suppl_obj] * len(baselines), im_feats, topline,
            carve_rows=partial(_carve_rows_device, device=device)
            if seam_carver == 'device' else None)
        if polygons is not None:
            for idx, pol in enumerate(polygons):
                if pol is None:
                    logger.warning(f'Polygonization failed for line {idx}')
            if scale_f is not None:
                polygons = [(np.array(p) / scale_f).astype('uint').tolist()
                            if p is not None else None for p in polygons]
            return polygons

    def _prepare_one(idx: int, line):
        """ROI + seam-patch preparation; returns (patch_u, patch_b, complete)."""
        neighbors = [np.asarray(b, float) for b in baselines[:idx] + baselines[idx + 1:]] + \
                    [np.asarray(o, float) for o in suppl_obj]
        return _prepare_line(line, neighbors, bounds, topline, im_feats)

    def _polygonize_one(idx: int, line):
        try:
            patch_u, patch_b, complete = _prepare_one(idx, line)
            return complete(_carve_seam(patch_u), _carve_seam(patch_b)).tolist()
        except Exception as e:
            if raise_on_error:
                raise
            logger.warning(f'Polygonization failed for line {idx}: {e}')
            return None

    if seam_carver == 'device':
        polygons = _polygonize_batched(baselines, _prepare_one, raise_on_error, device)
    else:
        # lines are independent; scipy/cv2 release the GIL so a thread pool
        # scales the per-line rotation + seam DP across cores
        import os
        from concurrent.futures import ThreadPoolExecutor
        n_workers = min(len(baselines), max(1, (os.cpu_count() or 2) - 1))
        if n_workers > 1 and len(baselines) > 1 and not raise_on_error:
            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                polygons = list(pool.map(_polygonize_one, range(len(baselines)), baselines))
        else:
            polygons = [_polygonize_one(i, line) for i, line in enumerate(baselines)]

    if scale_f is not None:
        polygons = [(np.array(p) / scale_f).astype('uint').tolist() if p is not None else None
                    for p in polygons]
    return polygons
