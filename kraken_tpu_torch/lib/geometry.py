"""
kraken_tpu_torch.lib.geometry
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Host-side polygon/baseline geometry: polygon sections for per-character
cuts, polygonal line-image extraction (straight-line rotation fast path,
piecewise mesh warp, legacy Delaunay warp), point/polygon predicates,
heuristic and neural reading order and coordinate scaling. A copy of the
matching part of the JAX package's ``lib/geometry.py`` (the port imports
nothing of that package), on numpy/PIL/OpenCV/scipy, and torch for the
forward of a reading-order model. PIL, OpenCV and torch are imported where
they are used, so the module imports without them.
"""
import logging
from typing import TYPE_CHECKING, Literal, Optional, Sequence, Union

import numpy as np

if TYPE_CHECKING:
    from PIL import Image

logger = logging.getLogger(__name__)

__all__ = ['compute_polygon_section', 'precompute_polygon_sections',
           'extract_polygons', 'reading_order', 'topsort',
           'polygonal_reading_order', 'neural_reading_order', 'pair_probabilities',
           'greedy_order_decode', 'is_in_region', 'point_in_polygon',
           'points_in_polygon', 'line_midpoint', 'scale_regions',
           'scale_polygonal_lines']

_EPS = np.finfo(float).eps

try:
    import cv2 as _cv2
except ImportError:  # pragma: no cover
    _cv2 = None


# ----------------------------------------------------------- polyline utils
def polyline_dists(pts: np.ndarray) -> np.ndarray:
    """Cumulative arc length at each vertex of a polyline."""
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    out = np.empty(len(seg) + 1)
    out[0] = 0
    np.cumsum(seg, out=out[1:])
    return out


def douglas_peucker(pts: np.ndarray, tolerance: float) -> np.ndarray:
    """
    Polyline simplification (replacement for skimage approximate_polygon).

    Runs on cv2.approxPolyDP (C++ RDP, ~40x the numpy stack loop below)
    whenever cv2 is importable — which the segmentation stack requires
    anyway — so one algorithm decides for every environment; the numpy
    implementation below is the documented fallback for cv2-less installs
    and may keep slightly different vertex subsets in tie cases.
    """
    pts = np.asarray(pts, float)
    n = len(pts)
    if n < 3:
        return pts
    if _cv2 is not None:
        simplified = _cv2.approxPolyDP(
            np.ascontiguousarray(pts, np.float32), float(tolerance), False)[:, 0, :]
        if len(simplified) < 2:
            # coincident endpoints collapse to one point under cv2; keep
            # the both-endpoints contract of the fallback
            return pts[[0, -1]].astype(float)
        return simplified.astype(float)
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        lo, hi = stack.pop()
        if hi <= lo + 1:
            continue
        seg = pts[hi] - pts[lo]
        seg_len = np.hypot(*seg)
        if seg_len < _EPS:
            d = np.linalg.norm(pts[lo + 1:hi] - pts[lo], axis=1)
        else:
            rel = pts[lo + 1:hi] - pts[lo]
            d = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / seg_len
        imax = int(np.argmax(d))
        if d[imax] > tolerance:
            keep[lo + 1 + imax] = True
            stack.append((lo, lo + 1 + imax))
            stack.append((lo + 1 + imax, hi))
    return pts[keep]


def chaikin_subdivide(pts: np.ndarray) -> np.ndarray:
    """
    One Chaikin (degree-2 B-spline) corner-cutting step with preserved
    endpoints (replacement for skimage subdivide_polygon(degree=2,
    preserve_ends=True)).
    """
    pts = np.asarray(pts, float)
    if len(pts) < 3:
        return pts
    q = 0.75 * pts[:-1] + 0.25 * pts[1:]
    r = 0.25 * pts[:-1] + 0.75 * pts[1:]
    mids = np.empty((2 * len(q), 2))
    mids[0::2] = q
    mids[1::2] = r
    return np.concatenate([pts[:1], mids, pts[-1:]])


# -------------------------------------------------- point/polygon predicates
def point_in_polygon(point, polygon) -> bool:
    """
    Strict interior test by ray casting; boundary points count as outside.
    """
    x, y = float(point[0]), float(point[1])
    poly = np.asarray(polygon, float)
    xi, yi = poly[:, 0], poly[:, 1]
    xj, yj = np.roll(xi, 1), np.roll(yi, 1)
    # boundary check: collinear and within segment bbox
    within = (np.minimum(yi, yj) <= y) & (y <= np.maximum(yi, yj)) & \
             (np.minimum(xi, xj) <= x) & (x <= np.maximum(xi, xj))
    cross = np.abs((xj - xi) * (y - yi) - (yj - yi) * (x - xi))
    if np.any(within & (cross < 1e-10)):
        return False
    crossings = ((yi > y) != (yj > y)) & \
                (x < (xj - xi) * (y - yi) / (yj - yi + _EPS) + xi)
    return bool(np.count_nonzero(crossings) % 2)


def points_in_polygon(points, polygon) -> np.ndarray:
    """
    Strict interior test of a (P, 2) point array by ray casting (boundary
    points count as outside), one crossing test per (point, edge) pair.
    """
    pts = np.atleast_2d(np.asarray(points, float))
    poly = np.asarray(polygon, float)
    xi, yi = poly[:, 0], poly[:, 1]
    xj, yj = np.roll(xi, 1), np.roll(yi, 1)
    x = pts[:, 0][:, None]
    y = pts[:, 1][:, None]
    within = (np.minimum(yi, yj) <= y) & (y <= np.maximum(yi, yj)) & \
             (np.minimum(xi, xj) <= x) & (x <= np.maximum(xi, xj))
    cross = np.abs((xj - xi) * (y - yi) - (yj - yi) * (x - xi))
    on_boundary = (within & (cross < 1e-10)).any(axis=1)
    crossings = ((yi > y) != (yj > y)) & \
                (x < (xj - xi) * (y - yi) / (yj - yi + _EPS) + xi)
    inside = (np.count_nonzero(crossings, axis=1) % 2).astype(bool)
    return inside & ~on_boundary


def line_midpoint(line) -> np.ndarray:
    """Midpoint of a polyline by arc length (a 1-point line is its own
    midpoint)."""
    arr = np.asarray(line, float)
    if len(arr) < 2:
        return arr[0].copy()
    dists = polyline_dists(arr)
    target = dists[-1] / 2
    idx = int(np.searchsorted(dists, target))
    idx = max(1, min(idx, len(arr) - 1))
    seg_len = dists[idx] - dists[idx - 1]
    t = (target - dists[idx - 1]) / seg_len if seg_len > _EPS else 0
    return arr[idx - 1] + t * (arr[idx] - arr[idx - 1])


def ray_polygon_intersection(origin, direction, polygon) -> Optional[np.ndarray]:
    """Closest intersection of a ray with the polygon's edges, or None."""
    poly = np.asarray(polygon, float)
    p1 = poly
    p2 = np.roll(poly, -1, axis=0)
    edge = p2 - p1
    d = np.asarray(direction, float)
    denom = d[0] * edge[:, 1] - d[1] * edge[:, 0]
    ok = np.abs(denom) > _EPS
    diff = p1 - np.asarray(origin, float)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = (diff[:, 0] * edge[:, 1] - diff[:, 1] * edge[:, 0]) / denom
        u = (diff[:, 0] * d[1] - diff[:, 1] * d[0]) / denom
    valid = ok & (t >= 0) & (u >= 0) & (u <= 1)
    if not np.any(valid):
        return None
    tmin = np.min(t[valid])
    return np.asarray(origin, float) + tmin * d


def _batch_ray_polygon(origins: np.ndarray, directions: np.ndarray,
                       polygon: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """
    Vectorized :func:`ray_polygon_intersection` over K (origin, direction)
    pairs: one (K x edges) broadcast. Returns (hits (K, 2), valid (K,));
    rows with no intersection are flagged False.
    """
    poly = np.asarray(polygon, float)
    p1 = poly
    edge = np.roll(poly, -1, axis=0) - p1                       # (E, 2)
    o = np.asarray(origins, float)                              # (K, 2)
    d = np.asarray(directions, float)                           # (K, 2)
    denom = d[:, 0, None] * edge[:, 1] - d[:, 1, None] * edge[:, 0]
    ok = np.abs(denom) > _EPS
    diff = p1[None, :, :] - o[:, None, :]                       # (K, E, 2)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = (diff[..., 0] * edge[:, 1] - diff[..., 1] * edge[:, 0]) / denom
        u = (diff[..., 0] * d[:, 1, None] - diff[..., 1] * d[:, 0, None]) / denom
    valid = ok & (t >= 0) & (u >= 0) & (u <= 1)
    has_hit = valid.any(axis=1)
    tmin = np.where(valid, t, np.inf).min(axis=1)
    hits = o + np.where(has_hit, tmin, 0)[:, None] * d
    return hits, has_hit


def nearest_point_on_polygon(point, polygon) -> np.ndarray:
    """Closest point on the polygon boundary to `point`."""
    poly = np.asarray(polygon, float)
    a = poly
    b = np.roll(poly, -1, axis=0)
    ab = b - a
    denom = np.einsum('ij,ij->i', ab, ab)
    t = np.clip(np.einsum('ij,ij->i', np.asarray(point, float) - a, ab) / (denom + _EPS), 0, 1)
    proj = a + t[:, None] * ab
    d = np.linalg.norm(proj - np.asarray(point, float), axis=1)
    return proj[np.argmin(d)]


def perpendicular_cuts(point: np.ndarray, unit_vec: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """
    Intersects the line through `point` perpendicular to `unit_vec` with the
    polygon boundary, returning the flattened nearest hit in each
    perpendicular direction as [x+, y+, x-, y-].

    Raises:
        ValueError: when either side has no intersection.
    """
    perp = np.array([unit_vec[1], -unit_vec[0]])
    points = []
    for d in (perp, -perp):
        hit = ray_polygon_intersection(point, d, polygon)
        if hit is None:
            raise ValueError('No intersection with polygon')
        points.extend(hit)
    return np.array(points)


# ------------------------------------------------------------ char sections
def _extend_baseline_to_boundary(baseline, boundary) -> np.ndarray:
    """
    Extends both baseline endpoints outward to the bounding polygon edge when
    they lie strictly inside it (reference: segmentation.py:1190-1210).
    """
    bl = np.array(baseline)
    inside = points_in_polygon(bl[[0, -1]].astype(float), boundary)
    for pos, (idx, ref) in enumerate(((0, 1), (-1, -2))):
        if inside[pos]:
            direction = bl[idx].astype(float) - bl[ref].astype(float)
            hit = ray_polygon_intersection(bl[idx].astype(float), direction, boundary)
            if hit is None:
                hit = nearest_point_on_polygon(bl[idx], boundary)
            bl[idx] = np.asarray(hit, 'int')
    return bl


def compute_polygon_section(baseline: Sequence[tuple[int, int]],
                            boundary: Sequence[tuple[int, int]],
                            dist1: float,
                            dist2: float) -> tuple:
    """
    Returns the quadrilateral cut out of `boundary` by the two lines
    perpendicular to `baseline` at arc lengths dist1/dist2 (used for
    per-character bounding polygons).
    """
    dist1 = dist1 if dist1 != 0 else _EPS
    dist2 = dist2 if dist2 != 0 else _EPS
    bl = _extend_baseline_to_boundary(baseline, boundary)
    dists = polyline_dists(bl)
    bl_length = dists[-1]
    dist1 = min(bl_length - _EPS, dist1)
    dist2 = min(bl_length - _EPS, dist2)
    bounds = np.array(boundary)

    def _seg_point_and_unit(d):
        seg_idx = int(np.searchsorted(dists, d))
        seg_start, seg_end = bl[seg_idx - 1].astype(float), bl[seg_idx].astype(float)
        seg_vec = seg_end - seg_start
        seg_len = np.linalg.norm(seg_vec)
        unit = seg_vec / seg_len if seg_len > _EPS else seg_vec
        return seg_start + (d - dists[seg_idx - 1]) * unit, unit

    cut_points = []
    seg_points = []
    for d in (dist1, dist2):
        pt, unit = _seg_point_and_unit(d)
        seg_points.append(pt)
        try:
            cut_points.append(perpendicular_cuts(pt, unit, bounds).round())
        except ValueError:
            logger.debug('Cut ray does not intersect the line polygon (degenerate polygon?)')
            cut_points.append(None)
    if any(p is None for p in cut_points):
        # degenerate polygon: fall back to the raw baseline points
        return np.asarray(seg_points).astype('int').tolist()
    o = np.int_(cut_points[0]).reshape(-1, 2).tolist()
    o.extend(np.int_(np.roll(cut_points[1], 2)).reshape(-1, 2).tolist())
    return tuple(o)


def precompute_polygon_sections(baseline: Sequence[tuple[int, int]],
                                boundary: Sequence[tuple[int, int]],
                                cut_pairs: list[tuple[float, float]]) -> tuple[list, dict, float]:
    """
    Batch variant of :func:`compute_polygon_section`: extends the baseline and
    computes cumulative distances once, caches perpendicular intersections per
    unique distance, and assembles one quadrilateral per (dist1, dist2) pair.

    Returns:
        (char_polygons, intersection_cache, baseline_length)
    """
    if not cut_pairs:
        return [], {}, 0.0
    bl = _extend_baseline_to_boundary(baseline, boundary)
    dists = polyline_dists(bl)
    bl_length = float(dists[-1])
    bounds = np.array(boundary)

    def _clamp(d):
        return min(bl_length - _EPS, d if d != 0 else _EPS)

    unique = sorted({_clamp(d) for pair in cut_pairs for d in pair})
    # all perpendicular ray casts of the line batched into one
    # (2K casts x E edges) broadcast instead of 2K scalar calls
    u_arr = np.asarray(unique, float)
    seg_idx = np.clip(np.searchsorted(dists, u_arr), 1, len(bl) - 1)
    seg_start = bl[seg_idx - 1].astype(float)
    seg_vec = bl[seg_idx].astype(float) - seg_start
    seg_len = np.linalg.norm(seg_vec, axis=1)
    units = np.where(seg_len[:, None] > _EPS,
                     seg_vec / np.where(seg_len > _EPS, seg_len, 1)[:, None],
                     seg_vec)
    pts = seg_start + (u_arr - dists[seg_idx - 1])[:, None] * units
    perp = np.stack([units[:, 1], -units[:, 0]], axis=1)
    origins = np.concatenate([pts, pts])
    directions = np.concatenate([perp, -perp])
    hits, hit_ok = _batch_ray_polygon(origins, directions, bounds)
    k = len(u_arr)
    cache: dict[float, Optional[np.ndarray]] = {}
    # per-distance python-int point pairs, computed once (assembling each
    # pair's quad from tiny numpy temporaries dominated record decode)
    pts_cache: dict[float, Optional[list]] = {}
    hits_int = np.rint(hits).astype(np.int64)
    for i, d in enumerate(unique):
        if hit_ok[i] and hit_ok[k + i]:
            cache[d] = np.concatenate([hits[i], hits[k + i]]).round()
            pts_cache[d] = [[int(hits_int[i, 0]), int(hits_int[i, 1])],
                            [int(hits_int[k + i, 0]), int(hits_int[k + i, 1])]]
        else:
            cache[d] = None
            pts_cache[d] = None

    polygons = []
    for d1, d2 in cut_pairs:
        c1, c2 = pts_cache[_clamp(d1)], pts_cache[_clamp(d2)]
        if c1 is not None and c2 is not None:
            # quad order matches np.roll(p2, 2): (p1+, p1-, p2-, p2+)
            polygons.append((c1[0], c1[1], c2[1], c2[0]))
        else:
            polygons.append(compute_polygon_section(baseline, boundary, d1, d2))
    return polygons, cache, bl_length


# ------------------------------------------------------------ line warping
def make_polygonal_mask(polygon: np.ndarray, shape: tuple[int, int]) -> 'Image.Image':
    """Renders a filled polygon mask of PIL size `shape` = (w, h)."""
    from PIL import Image, ImageDraw
    mask = Image.new('L', shape, 0)
    ImageDraw.Draw(mask).polygon([tuple(p) for p in polygon.astype(int).tolist()], fill=255, width=2)
    return mask


def apply_polygonal_mask(img: 'Image.Image', polygon: np.ndarray, cval: int = 0) -> 'Image.Image':
    """Blanks everything outside `polygon` with `cval`."""
    from PIL import Image
    mask = make_polygonal_mask(polygon, img.size)
    out = Image.new(img.mode, (img.width, img.height), cval)
    out.paste(img, mask=mask)
    return out


def _resample(order: int):
    """PIL resampling filter of a scipy-style spline order."""
    from PIL import Image
    return {0: Image.Resampling.NEAREST, 1: Image.Resampling.BILINEAR,
            2: Image.Resampling.BICUBIC, 3: Image.Resampling.BICUBIC}.get(
                order, Image.Resampling.NEAREST)


def _rotate_image(img: 'Image.Image', angle: float, cval: int = 0,
                  order: int = 1) -> 'Image.Image':
    """
    Rotates a PIL image by `angle` radians around the origin, expanding the
    canvas to fit, via a single affine transform (cv2.warpAffine with the
    inverse map — 4x faster than PIL's AFFINE transform and byte-identical
    at angle 0; PIL fallback for exotic modes).
    """
    rows, cols = img.height, img.width
    c, s = np.cos(angle), np.sin(angle)
    # rotation by -angle maps the image into the rectified frame; find the
    # output canvas by mapping the input corners
    corners = np.array([[0, 0], [0, rows - 1], [cols - 1, rows - 1], [cols - 1, 0]], float)
    mapped = corners @ np.array([[c, s], [-s, c]]).T  # input -> output
    minc, minr = mapped[:, 0].min(), mapped[:, 1].min()
    maxc, maxr = mapped[:, 0].max(), mapped[:, 1].max()
    out_w = int(np.around(maxc - minc + 1))
    out_h = int(np.around(maxr - minr + 1))
    # output coords -> input coords:
    # x_in = c*(x_out+minc) - s*(y_out+minr); y_in = s*(x_out+minc) + c*(y_out+minr)
    from PIL import Image
    if img.mode in ('L', 'RGB', 'RGBA'):
        import cv2
        # PIL's AFFINE samples at M*(x+0.5, y+0.5) (pixel-center convention);
        # cv2 maps integer centers directly — fold the half-pixel shift into
        # the translation so both paths agree (and angle 0 stays byte-exact:
        # the correction cancels for the identity rotation)
        inv = np.array([[c, -s, c * (minc + .5) - s * (minr + .5) - .5],
                        [s, c, s * (minc + .5) + c * (minr + .5) - .5]], float)
        interp = cv2.INTER_LINEAR if order else cv2.INTER_NEAREST
        warped = cv2.warpAffine(np.asarray(img), inv, (out_w, out_h),
                                flags=interp | cv2.WARP_INVERSE_MAP,
                                borderMode=cv2.BORDER_CONSTANT, borderValue=cval)
        return Image.fromarray(warped)
    data = [c, -s, c * minc - s * minr, s, c, s * minc + c * minr]
    return img.transform((out_w, out_h), Image.Transform.AFFINE, data=data,
                         resample=_resample(order),
                         fillcolor=cval)


def _straighten_baseline(polygon: np.ndarray, baseline: np.ndarray):
    """
    Rectifies an arbitrary polyline baseline: computes, for every polygon
    point, its arc-length position along the baseline and signed
    perpendicular distance, yielding destination points in a straightened
    coordinate frame (vectorized; reference: segmentation.py:1573-1601).
    """
    diff_bl = np.diff(baseline, axis=0)
    diff_bl_norms = np.linalg.norm(diff_bl, axis=1)
    diff_bl_normed = diff_bl / diff_bl_norms[:, None]
    n_poly = len(polygon)
    cum_lens = np.cumsum([0] + diff_bl_norms.tolist())
    # projections of polygon points onto each baseline segment
    diff = polygon[None, :] - baseline[:-1, None]
    local_x = np.einsum('kpm,km->kp', diff, diff_bl_normed)
    seg_dist = np.maximum(-local_x, local_x - diff_bl_norms[:, None])
    closest = np.argmin(seg_dist, axis=0)
    idx = np.arange(n_poly)
    local_x = local_x[closest, idx]
    diff = diff[closest, idx]
    normed = diff_bl_normed[closest]
    local_y = normed[:, 0] * diff[:, 1] - normed[:, 1] * diff[:, 0]
    dst = np.array([cum_lens[closest] + local_x, local_y]).T + baseline[:1]
    return dst, cum_lens, diff_bl_normed


def _mesh_envelope(baseline: np.ndarray, bl_start: tuple[float, float],
                   output_shape: tuple[int, int]):
    """
    Builds matched source/target point columns along the baseline for a
    piecewise-quad mesh warp, bevelling corners with a quadratic blend so
    adjacent quads don't fold over (reference: _bevelled_warping_envelope,
    segmentation.py:1334-1395).
    """
    def _ints(p):
        return tuple(int(v) for v in p)

    dy = [-bl_start[1], output_shape[0] - bl_start[1]]
    diff_bl = np.diff(baseline, axis=0)
    normed = diff_bl / np.linalg.norm(diff_bl, axis=1)[:, None]
    cum_lens = np.cumsum([0] + np.linalg.norm(diff_bl, axis=1).tolist())
    normals = np.array([-normed[:, 1], normed[:, 0]]).T
    start = baseline[0] - normed[0] * bl_start[0]
    src = [_ints(start + dy[0] * normals[0]), _ints(start + dy[1] * normals[0])]
    dst = [(0, 0), (0, output_shape[0])]
    max_bevel = output_shape[0] / 3
    step = max_bevel / 2
    for k in range(len(baseline) - 2):
        pt = baseline[k + 1]
        seg_prev = baseline[k] - pt
        seg_next = baseline[k + 2] - pt
        bev_prev = seg_prev / max(2.0, np.linalg.norm(seg_prev) / max_bevel)
        bev_next = seg_next / max(2.0, np.linalg.norm(seg_next) / max_bevel)
        nsteps = max(1, np.round((np.linalg.norm(bev_prev) + np.linalg.norm(bev_next)) / step))
        l_prev, l_next = np.linalg.norm(bev_prev), np.linalg.norm(bev_next)
        for i in range(int(nsteps) + 1):
            t = i / nsteps
            tpt = pt + (1 - t) ** 2 * bev_prev + t ** 2 * bev_next
            tx = bl_start[0] + cum_lens[k + 1] - (1 - t) ** 2 * l_prev + t ** 2 * l_next
            tn = (1 - t) * normals[k] + t * normals[k + 1]
            tn /= np.linalg.norm(tn)
            sp = [_ints(tpt + dy[0] * tn), _ints(tpt + dy[1] * tn)]
            tp = [(int(tx), 0), (int(tx), output_shape[0])]
            if sp[0] == src[-2] or sp[1] == src[-1] or tp[0] == dst[-2]:
                continue
            src += sp
            dst += tp
    end = baseline[-1] + normed[-1] * (output_shape[1] - cum_lens[-1] - bl_start[0])
    src += [end + dy[0] * normals[-1], end + dy[1] * normals[-1]]
    dst += [(output_shape[1], 0), (output_shape[1], output_shape[0])]
    return src, dst


def _piecewise_affine_warp(patch: np.ndarray, src_pts: np.ndarray,
                           dst_pts: np.ndarray, output_shape: tuple[int, int],
                           order: int) -> np.ndarray:
    """
    Legacy warp: Delaunay-triangulated piecewise affine transform from
    destination space back into source space, sampled with cv2.remap
    (replacement for skimage PiecewiseAffineTransform + warp; SIMD
    sampling is ~20x scipy map_coordinates on these patch sizes).
    """
    import cv2
    from scipy.spatial import Delaunay, QhullError

    try:
        tess = Delaunay(dst_pts)
    except QhullError:
        return patch
    n_tri = len(tess.simplices)
    affines = np.zeros((n_tri, 2, 3))
    for i, simplex in enumerate(tess.simplices):
        d = dst_pts[simplex]
        s = src_pts[simplex]
        A = np.column_stack([d, np.ones(3)])
        try:
            sol = np.linalg.solve(A, s)
        except np.linalg.LinAlgError:
            continue
        affines[i] = sol.T
    h, w = output_shape
    # per-pixel containing triangle via cv2 index rasterization (replaces
    # Delaunay.find_simplex — ~20x faster at page-line sizes; pixels on
    # shared edges land in either adjacent triangle, whose affines agree
    # there up to rounding)
    simplex = np.full((h, w), -1, np.int32)
    tri_pts = dst_pts[tess.simplices].astype(np.int32)
    for i in range(n_tri):
        cv2.fillConvexPoly(simplex, tri_pts[i], int(i))
    simplex = simplex.ravel()
    valid = simplex >= 0
    A = affines.astype(np.float32)[simplex]
    yy, xx = np.divmod(np.arange(h * w, dtype=np.float32), np.float32(w))
    mapped_x = A[:, 0, 0] * xx + A[:, 0, 1] * yy + A[:, 0, 2]
    mapped_y = A[:, 1, 0] * xx + A[:, 1, 1] * yy + A[:, 1, 2]
    mapped_x[~valid] = -1
    mapped_y[~valid] = -1
    map_x = mapped_x.reshape(h, w)
    map_y = mapped_y.reshape(h, w)
    interp = cv2.INTER_LINEAR if order else cv2.INTER_NEAREST
    return cv2.remap(patch, map_x, map_y, interp,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=0)


def _extract_straight_line(page: np.ndarray, pl: np.ndarray,
                           baseline: np.ndarray, c_min: int, c_max: int,
                           r_min: int, r_max: int, order: int) -> np.ndarray:
    """
    Array-level straight-baseline extraction: polygon mask (cv2.fillPoly)
    + derotation (the exact warp of :func:`_rotate_image`) + content-bbox
    crop, avoiding the per-line PIL Image round-trips. Mask semantics match
    apply_polygonal_mask up to the rasterizer's boundary pixels
    (ImageDraw.polygon vs cv2.fillPoly); decoded text is pinned by the
    golden tests.
    """
    import cv2
    patch = page[r_min:r_max + 1, c_min:c_max + 1]
    mask = np.zeros(patch.shape, np.uint8)
    cv2.fillPoly(mask, [(pl - (c_min, r_min)).astype(np.int32)], 1)
    masked = patch * mask

    direction = baseline[1] - baseline[0]
    angle = np.arctan2(direction[1], direction[0])
    rows, cols = masked.shape
    c, s = np.cos(angle), np.sin(angle)
    corners = np.array([[0, 0], [0, rows - 1], [cols - 1, rows - 1],
                        [cols - 1, 0]], float)
    mapped = corners @ np.array([[c, s], [-s, c]]).T
    minc, minr = mapped[:, 0].min(), mapped[:, 1].min()
    out_w = int(np.around(mapped[:, 0].max() - minc + 1))
    out_h = int(np.around(mapped[:, 1].max() - minr + 1))
    inv = np.array([[c, -s, c * (minc + .5) - s * (minr + .5) - .5],
                    [s, c, s * (minc + .5) + c * (minr + .5) - .5]], float)
    interp = cv2.INTER_LINEAR if order else cv2.INTER_NEAREST
    warped = cv2.warpAffine(masked, inv, (out_w, out_h),
                            flags=interp | cv2.WARP_INVERSE_MAP,
                            borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    # PIL getbbox analog: crop zero borders; an all-zero warp returns the
    # full patch like Image.crop(None) does (downstream emits an empty
    # record either way via the max==min check)
    nz_rows = np.flatnonzero(warped.any(axis=1))
    if not len(nz_rows):
        return warped
    nz_cols = np.flatnonzero(warped.any(axis=0))
    return np.ascontiguousarray(warped[nz_rows[0]:nz_rows[-1] + 1,
                                       nz_cols[0]:nz_cols[-1] + 1])


def extract_polygons(im: 'Image.Image', bounds, legacy: bool = False):
    """
    Yields the sub-images of `im` for every line in the segmentation,
    dewarped to a straight baseline, preserving order.

    For two-point (straight) baselines only a rotation is needed; arbitrary
    polylines go through a piecewise mesh warp (new path) or a Delaunay
    piecewise-affine warp (legacy path, matching models trained with the old
    extractor).

    Raises:
        ValueError: for missing boundaries, degenerate baselines, or
                    geometry extending beyond the image.
    """
    from PIL import Image
    if bounds.type == 'baselines':
        if im.mode == '1':
            order = 0
            im = im.convert('L')
        else:
            order = 1
        for line in bounds.lines:
            if line.boundary is None:
                raise ValueError('Line record lacks a boundary polygon')
            baseline = np.array(line.baseline)
            if len(baseline) < 2 or polyline_dists(baseline)[-1] < 5:
                raise ValueError('Baseline shorter than the 5px minimum')
            pl = np.array(line.boundary)
            c_min, c_max = int(pl[:, 0].min()), int(pl[:, 0].max())
            r_min, r_max = int(pl[:, 1].min()), int(pl[:, 1].max())
            imshape = np.array([im.height, im.width])
            if (pl < 0).any() or (pl.max(axis=0)[::-1] >= imshape).any():
                raise ValueError('Line boundary lies outside the page image')
            if (baseline < 0).any() or (baseline.max(axis=0)[::-1] >= imshape).any():
                raise ValueError('Baseline lies outside the page image')

            if len(baseline) == 2:
                # straight line: mask + rotate. On grayscale pages the whole
                # chain runs on arrays (cv2 fill/warp + numpy bbox) over a
                # per-page cached array — the PIL crop/draw/paste/Image
                # round-trips cost more than the warp itself. The PIL path
                # below remains for other modes and may differ in single
                # mask-boundary pixels.
                if im.mode == 'L':
                    # per-page array cache (predictions treat the input
                    # image as immutable, like the reference; the size
                    # guard catches at least resized/replaced content)
                    page_arr = getattr(im, '_kraken_page_array', None)
                    if page_arr is None or page_arr.shape != (im.height, im.width):
                        page_arr = np.asarray(im)
                        try:
                            im._kraken_page_array = page_arr
                        except Exception:
                            pass
                    out = _extract_straight_line(page_arr, pl,
                                                 baseline.astype(float),
                                                 c_min, c_max, r_min, r_max,
                                                 order)
                    yield Image.fromarray(out, 'L'), line
                    continue
                baseline = baseline.astype(float)
                direction = baseline[1] - baseline[0]
                angle = np.arctan2(direction[1], direction[0])
                patch = im.crop((c_min, r_min, c_max + 1, r_max + 1))
                offset_polygon = pl - (c_min, r_min)
                patch = apply_polygonal_mask(patch, offset_polygon, cval=0)
                i = _rotate_image(patch, angle, cval=0, order=order)
            else:
                if len(pl) > 50:
                    pl = douglas_peucker(pl, 2)
                full_polygon = chaikin_subdivide(pl)
                baseline = baseline.astype(float)
                dst_pts, cum_lens, _ = _straighten_baseline(full_polygon, baseline)
                bl_dst = baseline[0] + np.column_stack([cum_lens, np.zeros_like(cum_lens)])
                c_dst_min, c_dst_max = int(dst_pts[:, 0].min()), int(dst_pts[:, 0].max())
                r_dst_min, r_dst_max = int(dst_pts[:, 1].min()), int(dst_pts[:, 1].max())
                output_shape = (r_dst_max - r_dst_min + 1, c_dst_max - c_dst_min + 1)
                patch = im.crop((c_min, r_min, c_max + 1, r_max + 1))
                offset_polygon = full_polygon - (c_min, r_min)
                offset_baseline = baseline - (c_min, r_min)
                offset_bl_dst = bl_dst - (c_dst_min, r_dst_min)
                patch = apply_polygonal_mask(patch, offset_polygon, cval=0)
                if legacy:
                    offset_dst_pts = dst_pts - (c_dst_min, r_dst_min)
                    src = np.concatenate([offset_baseline, offset_polygon])
                    dst = np.concatenate([offset_bl_dst, offset_dst_pts])
                    arr = np.asarray(patch)
                    warped = _piecewise_affine_warp(arr, src, dst, output_shape, order)
                    i = Image.fromarray(warped.astype('uint8'))
                else:
                    src_env, dst_env = _mesh_envelope(offset_baseline, offset_bl_dst[0], output_shape)
                    mesh = [((*dst_env[k], *dst_env[k + 3]),
                             (*src_env[k], *src_env[k + 1], *src_env[k + 3], *src_env[k + 2]))
                            for k in range(0, len(src_env) - 3, 2)]
                    i = patch.transform((output_shape[1], output_shape[0]), Image.MESH,
                                        data=mesh, resample=_resample(order))
            yield i.crop(i.getbbox()), line
    else:
        angle = 90 if bounds.text_direction.startswith('vertical') else 0
        for line in bounds.lines:
            box = list(line.bbox) if isinstance(line.bbox, tuple) else line.bbox
            if (box < [0, 0, 0, 0] or box[::2] >= [im.size[0], im.size[0]]
                    or box[1::2] >= [im.size[1], im.size[1]]):
                logger.error(f'bbox {box} is outside of image bounds {im.size}')
                raise ValueError('Line lies outside the page image')
            yield im.crop(box).rotate(angle, expand=True), line


# ---------------------------------------------------------- reading order
def _partial_order(extents: Sequence[tuple[slice, slice]],
                   text_direction: Literal['lr', 'rl'] = 'lr') -> np.ndarray:
    """
    Binary partial-order matrix over (row-slice, col-slice) extents:
    order[i, j] = 1 iff element i reads before element j (column-aware
    topological heuristic; reference: _reading_order, segmentation.py:85).
    """
    n = len(extents)
    if n == 0:
        return np.zeros((0, 0), 'B')
    # vectorized over (i, j) pairs with one pass per separator candidate:
    # the scalar triple loop was O(n^3) python calls and dominated busy
    # pages (252 boxes -> 4.4 s; this form is ~30 ms)
    r0 = np.array([e[0].start for e in extents], float)
    r1 = np.array([e[0].stop for e in extents], float)
    c0 = np.array([e[1].start for e in extents], float)
    c1 = np.array([e[1].stop for e in extents], float)

    x_overlaps = (c0[:, None] < c1[None, :]) & (c1[:, None] > c0[None, :])
    above = r0[:, None] < r0[None, :]
    left_of = c1[:, None] < c0[None, :]
    horizontal = left_of if text_direction != 'rl' else ~left_of

    min_r0 = np.minimum(r0[:, None], r0[None, :])
    max_r1 = np.maximum(r1[:, None], r1[None, :])
    separated = np.zeros((n, n), bool)
    for w in range(n):
        # `w == u or w == v` in the scalar form compared extents by VALUE,
        # so any element with identical coordinates is excluded too
        eq_w = (r0 == r0[w]) & (r1 == r1[w]) & (c0 == c0[w]) & (c1 == c1[w])
        sep = ((r1[w] >= min_r0) & (r0[w] <= max_r1)
               & (c0[w] < c1[:, None]) & (c1[w] > c0[None, :]))
        sep &= ~eq_w[:, None] & ~eq_w[None, :]
        separated |= sep
    order = np.where(x_overlaps, above, ~separated & horizontal)
    return order.astype('B')


def topsort(order: np.ndarray) -> list[int]:
    """Topological sort of a binary partial-order matrix (iterative DFS)."""
    n = len(order)
    visited = np.zeros(n, bool)
    result: list[int] = []
    for start in range(n):
        if visited[start]:
            continue
        stack = [(start, iter(np.nonzero(order[:, start])[0]))]
        visited[start] = True
        while stack:
            node, it = stack[-1]
            advanced = False
            for pred in it:
                if not visited[pred]:
                    visited[pred] = True
                    stack.append((int(pred), iter(np.nonzero(order[:, pred])[0])))
                    advanced = True
                    break
            if not advanced:
                result.append(node)
                stack.pop()
    return result


def reading_order(lines: Sequence, text_direction: Literal['lr', 'rl'] = 'lr',
                  regions=None) -> Sequence[int]:
    """Reading order over BBoxLine objects."""
    extents = [(slice(line.bbox[1], line.bbox[3]),
                slice(line.bbox[0], line.bbox[2])) for line in lines]
    return topsort(_partial_order(extents, text_direction))


def _baseline_bounds(baseline) -> tuple[slice, slice]:
    arr = np.asarray(baseline)
    return (slice(arr[:, 1].min(), arr[:, 1].max()),
            slice(arr[:, 0].min(), arr[:, 0].max()))


def is_in_region(line, region_boundary) -> bool:
    """
    True if the midpoint (by arc length) of `line` lies inside the region
    polygon.
    """
    return point_in_polygon(line_midpoint(line), region_boundary)


def polygonal_reading_order(lines: Sequence, text_direction: Literal['lr', 'rl'] = 'lr',
                            regions: Optional[Sequence] = None) -> Sequence[int]:
    """
    Reading order over baseline lines with region awareness: lines are
    first grouped into the regions containing their midpoint, regions and
    stray lines are ordered together, and lines are ordered within each
    region.
    """
    if regions is None:
        regions = []
    region_lines: list[list] = [[] for _ in regions]
    bounds = []
    indices = {}
    # batched midpoint-in-region tests (one crossing test per region over
    # all line midpoints; the scalar per-(line, region) loop dominated the
    # reading-order stage) — first containing region wins, as before
    if regions and len(lines):
        mids = np.array([line_midpoint(line.baseline) for line in lines])
        hits = np.stack([points_in_polygon(mids, reg.boundary)
                         for reg in regions])          # (R, L)
    else:
        hits = np.zeros((len(regions), len(lines)), bool)
    for line_idx, line in enumerate(lines):
        reg_hit = np.flatnonzero(hits[:, line_idx])
        if len(reg_hit):
            region_lines[int(reg_hit[0])].append(
                (line_idx, _baseline_bounds(line.baseline)))
        else:
            bounds.append(_baseline_bounds(line.baseline))
            indices[line_idx] = ('line', line_idx)
    intra = [[] for _ in regions]
    next_key = len(lines)
    for reg_idx, region in enumerate(regions):
        if region_lines[reg_idx]:
            order = _partial_order([x[1] for x in region_lines[reg_idx]], text_direction)
            intra[reg_idx] = [region_lines[reg_idx][i][0] for i in topsort(order)]
            arr = np.asarray(region.boundary)
            bounds.append((slice(arr[:, 1].min(), arr[:, 1].max()),
                           slice(arr[:, 0].min(), arr[:, 0].max())))
            indices[next_key + reg_idx] = ('region', reg_idx)
    order = _partial_order(bounds, text_direction)
    lsort = topsort(order)
    keys = sorted(indices.keys())
    out = []
    for i in [keys[i] for i in lsort]:
        kind, val = indices[i]
        if kind == 'line':
            out.append(val)
        else:
            out.extend(intra[val])
    return out


def pair_probabilities(lines: Sequence, im_size: tuple[int, int], model,
                       class_mapping: Optional[dict[str, int]] = None) -> np.ndarray:
    """
    The order probabilities a reading-order model (ROMLP) gives every
    ordered pair (i, j), i != j, of `lines` (in row-major order): spatial
    features on the host, the model's forward on its device (float32, no
    TF32), the sigmoid on the host.
    """
    import torch
    from kraken_tpu_torch.inference.recognition import _precise_fp32
    from kraken_tpu_torch.ro.features import element_features

    if class_mapping is None:
        class_mapping = {}
    num_classes = (max(0, *class_mapping.values()) + 1) if class_mapping else 1
    feats = [element_features(el, im_size, class_mapping, num_classes)[1] for el in lines]
    pairs = []
    n = len(lines)
    for i in range(n):
        for j in range(n):
            if i == j and n != 1:
                continue
            pairs.append(np.concatenate([feats[i], feats[j]]))
    with torch.inference_mode(), _precise_fp32(torch.float32):
        logits = model.forward(np.stack(pairs)).cpu().numpy()
    return (1 / (1 + np.exp(-logits))).ravel()


def neural_reading_order(lines: Sequence, text_direction: str = 'lr',
                         regions: Optional[Sequence] = None,
                         im_size: tuple[int, int] = None,
                         model=None,
                         class_mapping: dict[str, int] = None) -> Optional[Sequence[int]]:
    """
    Orders lines with a trained pairwise order-relation model (ROMLP): builds
    per-element spatial features, scores all ordered pairs, and greedily
    decodes the order-relation matrix.
    """
    if len(lines) == 0:
        return None
    if len(lines) == 1:
        return [0]
    n = len(lines)
    order = np.zeros((n, n))
    order[~np.eye(n, dtype=bool)] = pair_probabilities(lines, im_size, model, class_mapping)
    return greedy_order_decode(order)


def greedy_order_decode(P: np.ndarray) -> list[int]:
    """
    Greedy decode of a pairwise order-relation probability matrix: at each
    step pick the element maximizing the joint log-probability of preceding
    all remaining elements.
    """
    A = P + _EPS
    A = (A + (1 - A).T) / 2
    np.fill_diagonal(A, _EPS)
    lP = np.log(A)
    np.fill_diagonal(lP, 0)
    n = P.shape[0]
    path: list[int] = []
    for _ in range(n):
        for _ in range(n):
            idx = int(np.argmax(lP.sum(axis=1)))
            if idx not in path:
                path.append(idx)
                lP[idx, :] = lP[:, idx]
                lP[:, idx] = 0
                break
    return path


# ------------------------------------------------------------------ scaling
def scale_regions(regions: Sequence, scale: Union[float, tuple[float, float]]) -> Sequence:
    """Scales region polygon coordinates."""
    if isinstance(scale, float):
        scale = (scale, scale)
    return [(np.array(region) * scale).astype('uint').tolist() for region in regions]


def scale_polygonal_lines(lines: Sequence, scale: Union[float, tuple[float, float]]) -> Sequence:
    """Scales (baseline, boundary) tuples."""
    if isinstance(scale, float):
        scale = (scale, scale)
    out = []
    for bl, pl in lines:
        out.append(((np.array(bl) * scale).astype('int').tolist(),
                    (np.array(pl) * scale).astype('int').tolist()))
    return out
