"""
kraken_tpu_torch.inference.extraction
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Device line extraction for recognition inference, the port of the JAX
package's ``inference/extraction.py``.

The host route (lib/geometry.extract_polygons + dataset.transforms) cuts
every line out of the page, dewarps it to a straight baseline, resizes it
to the network height and uploads the resulting pixel tensors; the warps
take the pipeline's host thread. This module moves the *pixel* work onto
the device while keeping the *geometry* on the host:

  host:   per line, compose the full extraction map
          (polygon mask ∘ dewarp ∘ content-crop ∘ resize-to-height)
          into a compact per-column sampling grid — M knot columns ×
          3 rows of source coordinates (the map is piecewise-bilinear,
          so columns interpolate linearly and rows linearly with one
          optional knee at the baseline), plus a polygon mask as
          per-column top/bottom row envelopes. ~3 KB per line.
  upload: the page's bytes once (a buffer resident on the device, cached
          by the recognition engine), and per batch the grids, masks and
          meta rows, plus the native-resolution strips (axis-aligned bbox
          crops, no resampling) of lines that do not gather from the
          resident page, packed into one flat uint8 atlas.
  device: the gather-warp (:func:`kraken_tpu_torch.ops.extract.
          extract_batch`, the kernel of ``csrc/extract.cu`` on the card)
          rebuilds the padded (n, 1, H, W) batch: supersampled bilinear
          sampling through the per-line grids, envelope masking, white
          padding and ink inversion, then the network's forward.

The device route composes the same maps the host applies in sequence, so
its line images differ from the host's only by resampling order (one fused
bilinear pass with 2x2 supersampling against warp-then-Lanczos) and the
content-crop bound (from the warped polygon instead of the warped
pixels); the records are held to the JAX package's device route by
``tests/test_torch_extraction.py``.
"""
import logging
from typing import Optional

import numpy as np

from kraken_tpu_torch.ops.extract import M_GRID, M_MASK, extract_batch, extract_batch_reference

logger = logging.getLogger(__name__)

__all__ = ['DeviceLine', 'baseline_line_desc', 'bbox_line_desc', 'host_line_desc', 'masked_blank',
           'build_extract_payload', 'extract_batch', 'extract_batch_reference',
           'supports_device_extraction', 'M_GRID', 'M_MASK', 'ATLAS_BUCKET_BASE',
           'ATLAS_BUCKET_GROWTH', 'PAGE_BUCKET_BASE', 'PAGE_BUCKET_GROWTH']

# flat-atlas length ladder (bounds the shapes a batch takes; see
# width_bucket). Page-resident batches carry only straggler strips, so the
# floor is small
ATLAS_BUCKET_BASE = 1 << 14
ATLAS_BUCKET_GROWTH = 1.6
# resident-page buffer ladder: tight growth, since the padding is uploaded
# zeros; corpora are usually uniform page sizes and land in one bucket
PAGE_BUCKET_BASE = 1 << 18
PAGE_BUCKET_GROWTH = 1.08


class DeviceLine:
    """Pixel-free line descriptor: an axis-aligned native-resolution strip
    view plus the composed sampling grid. Duck-types the two attributes the
    decode stage reads from host entries: ``shape`` (the transformed tensor
    shape, for net_scale) and ``width`` (the dewarped content width, for
    in_scale).

    The grid carries, per knot column, THREE row knots as (x, y, r)
    triples: source coordinates plus the output-row position the map was
    evaluated at. Affine and mesh warps are linear in the output row, so
    r = {0, mid, H-1} represents them exactly; the legacy Delaunay warp is
    only defined inside the triangulation hull and changes slope at the
    baseline, so its knots sit at (envelope top, baseline row, envelope
    bottom) per column — the two linear pieces the triangulation produces
    along a vertical line through a quadrilateral line polygon."""
    __slots__ = ('strip', 'grid', 'mask', 'W_l', 'seq_len', 'width', 'shape',
                 'page_off', 'scale_y', 'page', 'pad', 'ss_on')

    def __init__(self, strip, grid, mask, W_l, seq_len, width, height,
                 page_off=-1, scale_y=1.0, ss_on=0):
        self.page = None            # page array the line gathers from (set
                                    # by the producer when page-resident)
        self.pad = 0                # horizontal padding the device adds
                                    # (0 when the strip is already padded)
        self.strip = strip          # (h, w) uint8 view into the page array
        self.grid = grid            # (M_GRID, 3, 3) float32 (x, y, row)
        self.mask = mask            # (M_MASK, 2) float32 top/bottom rows
        self.W_l = W_l              # unpadded final width
        self.seq_len = seq_len      # final width incl. horizontal padding
        self.width = width          # content width in dewarped source px
        self.shape = (1, height, seq_len)
        self.page_off = page_off    # flat offset of the strip window in the
                                    # page buffer (-1: not page-addressable)
        self.scale_y = scale_y      # source rows per output row (downscale
                                    # factor; heavy downscale rides the host)
        self.ss_on = ss_on          # 1: supersample (downscaled lines, where
                                    # the host Lanczos anti-aliases); 0:
                                    # sample at exact centers (upscale /
                                    # identity pass-through — bit-exact)


def supports_device_extraction(model, config, segmentation_type: str) -> bool:
    """Device extraction covers the mainline recognition configuration:
    fixed-height single-channel models over baseline segmentations (plain
    resize, no centerline normalization). Everything else falls back to the
    host extractor. (The JAX package's predicate, without its mesh term:
    the port's recognition runs on one device.)"""
    batch, channels, height, width = model.input
    return (getattr(config, 'line_extraction', 'host') == 'device'
            and segmentation_type == 'baselines'
            and channels == 1 and height > 1 and width == 0
            and not getattr(config, 'return_line_image', False)
            and not getattr(config, 'force_binarization', False))


# --------------------------------------------------------------- host side

def _polygon_column_envelopes(poly: np.ndarray, xs: np.ndarray):
    """Intersects vertical lines x=xs with the polygon's edges and returns
    (ymin, ymax) per column — the mask envelope in dewarped space. Columns
    that miss the polygon get an empty (inf, -inf) interval."""
    a = poly
    b = np.roll(poly, -1, axis=0)
    dx = b[:, 0] - a[:, 0]
    # edge k crosses column x when x lies between its endpoints
    lo = np.minimum(a[:, 0], b[:, 0])
    hi = np.maximum(a[:, 0], b[:, 0])
    xs_col = xs[:, None]
    hit = (xs_col >= lo[None, :]) & (xs_col <= hi[None, :])
    with np.errstate(divide='ignore', invalid='ignore'):
        t = np.where(np.abs(dx) > 1e-9, (xs_col - a[None, :, 0]) / dx[None, :], 0.0)
    y = a[None, :, 1] + t * (b[:, 1] - a[:, 1])[None, :]
    # vertical edges contribute both endpoints
    vert = np.abs(dx) < 1e-9
    y_lo = np.where(hit, np.where(vert[None, :], np.minimum(a[:, 1], b[:, 1])[None, :], y), np.inf)
    y_hi = np.where(hit, np.where(vert[None, :], np.maximum(a[:, 1], b[:, 1])[None, :], y), -np.inf)
    return y_lo.min(axis=1), y_hi.max(axis=1)


def _quad_eval(quads_tx: np.ndarray, quads_c: np.ndarray, out_h: int,
               x_d: np.ndarray, y_d: np.ndarray) -> np.ndarray:
    """Evaluates the piecewise PIL-QUAD mesh (lib/geometry.extract_polygons'
    Image.MESH path) at continuous dewarped positions. quads_tx: (K+1,)
    quad x-boundaries; quads_c: (K, 4, 2) source corners (nw, sw, se, ne).
    PIL convention (probe-verified): u=(x+0.5-x0)/w, src = bilerp - 0.5."""
    k = np.clip(np.searchsorted(quads_tx, x_d + 0.5, side='right') - 1,
                0, len(quads_tx) - 2)
    x0 = quads_tx[k]
    w = np.maximum(quads_tx[k + 1] - x0, 1e-9)
    u = (x_d + 0.5 - x0) / w
    v = (y_d + 0.5) / max(out_h, 1e-9)
    nw, sw, se, ne = (quads_c[k, 0], quads_c[k, 1], quads_c[k, 2], quads_c[k, 3])
    src = (nw + u[..., None] * (ne - nw) + v[..., None] * (sw - nw)
           + (u * v)[..., None] * (se - sw - ne + nw))
    return src - 0.5


def _content_bbox(poly: np.ndarray, canvas_h: int, canvas_w: int):
    """Approximates PIL's getbbox() content crop of the warped+masked line
    with the warped polygon's bounds (the mask zeroes everything outside the
    polygon, so its bbox bounds the content to within rasterization)."""
    bx0 = int(np.clip(np.floor(poly[:, 0].min()), 0, canvas_w - 1))
    by0 = int(np.clip(np.floor(poly[:, 1].min()), 0, canvas_h - 1))
    bx1 = int(np.clip(np.ceil(poly[:, 0].max()), bx0, canvas_w - 1))
    by1 = int(np.clip(np.ceil(poly[:, 1].max()), by0, canvas_h - 1))
    return bx0, by0, bx1, by1


def masked_blank(strip: np.ndarray, boundary, padded: bool = True) -> bool:
    """
    Whether the host route finds a baseline line empty, judged on its strip
    (the axis-aligned box of its polygon): the host masks the line with its
    polygon (``cv2.fillPoly``, the pixels outside set to 0), crops it to
    the rows and columns the mask leaves non-zero and finds it empty when
    the line tensor is uniform, which with white side padding (`padded`)
    needs a white crop. So a blank polygon whose box takes in a
    neighbour's ink is empty here as on the host, where the strip alone is
    not uniform. A crop the mask leaves all zero is not called blank: the
    host pads it white and recognises it.
    """
    import cv2
    pl = np.asarray(boundary)
    mask = np.zeros(strip.shape, np.uint8)
    cv2.fillPoly(mask, [(pl - (int(pl[:, 0].min()), int(pl[:, 1].min()))).astype(np.int32)], 1)
    masked = strip * mask
    rows = np.flatnonzero(masked.any(axis=1))
    if not len(rows):
        return False
    cols = np.flatnonzero(masked.any(axis=0))
    crop = masked[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
    low, high = crop.min(), crop.max()
    return bool(low == high and (high == 255 or not padded))


def baseline_line_desc(page_arr: np.ndarray, line, height: int, pad: int,
                       legacy: bool = False) -> Optional[DeviceLine]:
    """
    Composes the full host extraction map of one baseline line
    (lib/geometry.extract_polygons ∘ transforms resize/pad) into a
    :class:`DeviceLine`. Returns None when the line fails the same
    validations the host extractor raises on (caller emits an empty
    record, matching the host engine's behavior).
    """
    from kraken_tpu_torch.lib.geometry import (_mesh_envelope, _straighten_baseline,
                                               chaikin_subdivide, douglas_peucker,
                                               polyline_dists)
    if line.boundary is None:
        return None
    baseline = np.array(line.baseline, float)
    if len(baseline) < 2 or polyline_dists(baseline)[-1] < 5:
        return None
    pl_ = np.array(line.boundary, float)
    im_h, im_w = page_arr.shape[:2]
    if (pl_ < 0).any() or pl_[:, 0].max() >= im_w or pl_[:, 1].max() >= im_h:
        return None
    if (baseline < 0).any() or baseline[:, 0].max() >= im_w or baseline[:, 1].max() >= im_h:
        return None
    c_min, c_max = int(pl_[:, 0].min()), int(pl_[:, 0].max())
    r_min, r_max = int(pl_[:, 1].min()), int(pl_[:, 1].max())
    strip = page_arr[r_min:r_max + 1, c_min:c_max + 1]
    if strip.size == 0:
        return None

    rknee = None
    if len(baseline) == 2:
        # straight baseline: the host chain is mask + derotation
        # (_extract_straight_line) — an exact affine, evaluated in the
        # cv2.warpAffine inverse-map convention it uses
        direction = baseline[1] - baseline[0]
        angle = float(np.arctan2(direction[1], direction[0]))
        rows, cols = strip.shape
        c, s = np.cos(angle), np.sin(angle)
        corners = np.array([[0, 0], [0, rows - 1], [cols - 1, rows - 1],
                            [cols - 1, 0]], float)
        mapped = corners @ np.array([[c, s], [-s, c]]).T
        minc, minr = mapped[:, 0].min(), mapped[:, 1].min()
        out_w = int(np.around(mapped[:, 0].max() - minc + 1))
        out_h = int(np.around(mapped[:, 1].max() - minr + 1))
        t = np.array([c * (minc + .5) - s * (minr + .5) - .5,
                      s * (minc + .5) + c * (minr + .5) - .5])
        A = np.array([[c, -s], [s, c]])          # out -> in

        def map_fn(x_d, y_d):
            pts = np.stack([x_d, y_d], axis=-1)
            return pts @ A.T + t

        poly_patch = pl_ - (c_min, r_min)
        poly_out = (poly_patch - t) @ np.linalg.inv(A).T
        canvas_h, canvas_w = out_h, out_w
    else:
        if len(pl_) > 50:
            pl_ = douglas_peucker(pl_, 2)
        full_polygon = chaikin_subdivide(pl_)
        dst_pts, cum_lens, _ = _straighten_baseline(full_polygon, baseline)
        bl_dst = baseline[0] + np.column_stack([cum_lens, np.zeros_like(cum_lens)])
        c_dst_min, c_dst_max = int(dst_pts[:, 0].min()), int(dst_pts[:, 0].max())
        r_dst_min, r_dst_max = int(dst_pts[:, 1].min()), int(dst_pts[:, 1].max())
        output_shape = (r_dst_max - r_dst_min + 1, c_dst_max - c_dst_min + 1)
        offset_polygon = full_polygon - (c_min, r_min)
        offset_baseline = baseline - (c_min, r_min)
        offset_bl_dst = bl_dst - (c_dst_min, r_dst_min)
        poly_out = dst_pts - (c_dst_min, r_dst_min)
        canvas_h, canvas_w = output_shape
        if legacy:
            # Delaunay piecewise-affine (geometry._piecewise_affine_warp):
            # per-point containing triangle + its dst->src affine; the row
            # interpolation gets a knee at the (horizontal) baseline row
            from scipy.spatial import Delaunay, QhullError
            offset_dst_pts = poly_out
            src = np.concatenate([offset_baseline, offset_polygon])
            dst = np.concatenate([offset_bl_dst, offset_dst_pts])
            try:
                tess = Delaunay(dst)
            except QhullError:
                return None
            affines = np.zeros((len(tess.simplices), 2, 3))
            ok = np.zeros(len(tess.simplices), bool)
            for i, simplex in enumerate(tess.simplices):
                Amat = np.column_stack([dst[simplex], np.ones(3)])
                try:
                    affines[i] = np.linalg.solve(Amat, src[simplex]).T
                    ok[i] = True
                except np.linalg.LinAlgError:
                    continue

            def map_fn(x_d, y_d):
                pts = np.stack([x_d, y_d], axis=-1)
                flat = pts.reshape(-1, 2)
                simp = tess.find_simplex(flat)
                inside = (simp >= 0) & ok[np.clip(simp, 0, None)]
                Asel = affines[np.clip(simp, 0, None)]
                xy1 = np.concatenate([flat, np.ones((len(flat), 1))], axis=1)
                out = np.einsum('kij,kj->ki', Asel, xy1)
                out[~inside] = -1e6          # masked by the envelope anyway
                return out.reshape(pts.shape)

            rknee = float(offset_bl_dst[0][1])
        else:
            src_env, dst_env = _mesh_envelope(offset_baseline,
                                              offset_bl_dst[0], output_shape)
            src_env = np.asarray(src_env, float)
            # quads: dst columns [tx_k, tx_{k+1}] x [0, H]; src corners
            # (nw, sw, se, ne) exactly as extract_polygons builds the mesh
            tx = np.asarray([d[0] for d in dst_env[::2]], float)
            quads_c, quads_tx = [], [tx[0]]
            for k in range(0, len(src_env) - 3, 2):
                if tx[k // 2 + 1] <= quads_tx[-1]:
                    continue
                quads_tx.append(tx[k // 2 + 1])
                quads_c.append([src_env[k], src_env[k + 1],
                                src_env[k + 3], src_env[k + 2]])
            if not quads_c:
                return None
            quads_tx = np.asarray(quads_tx, float)
            quads_c = np.asarray(quads_c, float)
            oh = output_shape[0]

            def map_fn(x_d, y_d):
                return _quad_eval(quads_tx, quads_c, oh, np.asarray(x_d, float),
                                  np.asarray(y_d, float))

    bx0, by0, bx1, by1 = _content_bbox(poly_out, canvas_h, canvas_w)
    cw = bx1 - bx0 + 1
    ch = by1 - by0 + 1
    if cw < 2 or ch < 2:
        return None
    W_l = max(1, int(cw * height / ch))
    sx = cw / W_l
    sy = ch / height
    if rknee is None:
        rk = (height - 1) / 2.0           # exact for linear-in-row maps
    else:
        rk = (rknee + 0.5 - by0) / sy - 0.5
        rk = float(np.clip(rk, 0.75, height - 1.75))

    # warp grid: M knot columns x 3 row knots, in final output units
    cg = np.linspace(0.0, max(W_l - 1, 1), M_GRID)
    x_d = (cg + 0.5) * sx - 0.5 + bx0
    if rknee is None:
        # affine / mesh maps are linear in the output row everywhere:
        # constant knot rows {0, rk, H-1} represent them exactly
        rows_g = np.broadcast_to(np.array([0.0, rk, height - 1.0]),
                                 (M_GRID, 3)).copy()
    else:
        # legacy Delaunay map: only defined inside the triangulation hull
        # and piecewise linear with a slope change at the baseline row —
        # evaluate at (envelope top, baseline, envelope bottom) per column,
        # nudged half a canvas pixel inward so find_simplex hits the hull
        y_lo_g, y_hi_g = _polygon_column_envelopes(poly_out, x_d)
        r_lo_g = (np.where(np.isfinite(y_lo_g), y_lo_g, by0) + 0.5 - by0) / sy - 0.5
        r_hi_g = (np.where(np.isfinite(y_hi_g), y_hi_g, by1) + 0.5 - by0) / sy - 0.5
        half = 0.5 / sy
        r_top = np.minimum(r_lo_g + half, rk - 0.25)
        r_bot = np.maximum(r_hi_g - half, rk + 0.25)
        rows_g = np.stack([r_top, np.full(M_GRID, rk), r_bot], axis=1)
    y_d = (rows_g + 0.5) * sy - 0.5 + by0
    xx = np.broadcast_to(x_d[:, None], (M_GRID, 3))
    coords = map_fn(xx, y_d).astype(np.float32)       # (M, 3, 2)

    # repair knots the map could not evaluate (legacy: outside the hull):
    # interpolate from valid knots along the column axis per row line
    bad = coords[:, :, 0] < -1e5
    if bad.any():
        if bad[:, 1].all():
            return None                   # knee row entirely unmapped
        ii = np.arange(M_GRID, dtype=float)
        for r in range(3):
            good = ~bad[:, r]
            if not good.any():
                coords[:, r] = coords[:, 1]           # masked-out anyway
                rows_g[:, r] = rows_g[:, 1]
                continue
            if good.all():
                continue
            for c in range(2):
                coords[:, r, c] = np.interp(ii, ii[good], coords[good, r, c])

    grid = np.concatenate([coords, rows_g[:, :, None].astype(np.float32)],
                          axis=2)                     # (M, 3, 3)

    # mask envelopes at M_MASK knot columns, converted to final row units
    xm = (np.linspace(0.0, max(W_l - 1, 1), M_MASK) + 0.5) * sx - 0.5 + bx0
    y_lo, y_hi = _polygon_column_envelopes(poly_out, xm)
    r_lo = (y_lo + 0.5 - by0) / sy - 0.5
    r_hi = (y_hi + 0.5 - by0) / sy - 0.5
    mask = np.stack([r_lo, r_hi], axis=1).astype(np.float32)

    d = DeviceLine(strip=strip, grid=grid,
                   mask=mask, W_l=W_l, seq_len=W_l + 2 * pad, width=cw,
                   height=height, page_off=r_min * im_w + c_min,
                   scale_y=sy, ss_on=int(max(sx, sy) > 1.0))
    d.pad = pad
    return d


def bbox_line_desc(page_arr: np.ndarray, line, height: int,
                   pad: int) -> Optional[DeviceLine]:
    """Axis-aligned bbox line (legacy box segmentation, models without
    centerline normalization): a pure crop + resize, expressed on the same
    grid contract."""
    box = line.bbox
    im_h, im_w = page_arr.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in box)
    if x0 < 0 or y0 < 0 or x1 > im_w or y1 > im_h or x1 <= x0 or y1 <= y0:
        return None
    strip = page_arr[y0:y1, x0:x1]
    ch, cw = strip.shape
    W_l = max(1, int(cw * height / ch))
    sx = cw / W_l
    sy = ch / height
    cg = np.linspace(0.0, max(W_l - 1, 1), M_GRID)
    x_d = (cg + 0.5) * sx - 0.5
    rows = np.array([0.0, (height - 1) / 2.0, height - 1.0])
    y_d = (rows + 0.5) * sy - 0.5
    grid = np.stack(np.broadcast_arrays(x_d[:, None], y_d[None, :],
                                        rows[None, :]),
                    axis=-1).astype(np.float32)
    mask = np.stack([np.full(M_MASK, -1.0), np.full(M_MASK, height + 1.0)],
                    axis=1).astype(np.float32)
    d = DeviceLine(strip=strip, grid=grid,
                   mask=mask, W_l=W_l, seq_len=W_l + 2 * pad, width=cw,
                   height=height, page_off=y0 * im_w + x0, scale_y=sy,
                   ss_on=int(max(sx, sy) > 1.0))
    d.pad = pad
    return d


def host_line_desc(tensor: np.ndarray, width, height: int,
                   pad: int) -> 'DeviceLine':
    """Wraps a host-extracted, already-transformed line tensor ((1, H, W)
    float, ink-inverted, values in [0, 1]) as an identity-grid DeviceLine:
    the strip carries the re-quantized uint8 pixels and the device samples
    them at exact integer positions, so the pass-through is bit-identical
    to the 'uint8' input-transfer path. Used for lines whose regime the
    gather-warp does not cover (heavy downscale, where the host's Lanczos
    anti-aliasing matters)."""
    t = np.asarray(tensor)[0]
    h, w = t.shape
    strip = np.round((1.0 - t) * 255.0).astype(np.uint8)
    cols = np.linspace(0.0, max(w - 1, 1), M_GRID)
    rows = np.array([0.0, (h - 1) / 2.0, h - 1.0])
    grid = np.stack(np.broadcast_arrays(cols[:, None], rows[None, :],
                                        rows[None, :]),
                    axis=-1).astype(np.float32)
    mask = np.stack([np.full(M_MASK, -1.0), np.full(M_MASK, h + 1.0)],
                    axis=1).astype(np.float32)
    return DeviceLine(strip=strip, grid=grid, mask=mask, W_l=w,
                      seq_len=w, width=width, height=height)


def build_extract_payload(entries: list, max_w: int, n: int, pad: int,
                          page_len: int = 0, page_width: int = 0,
                          page_offs=None):
    """Packs a batch of DeviceLines into the flat strip atlas + coefficient
    arrays the gather-warp consumes. Returns numpy arrays
    (atlas, grid, mask, meta).

    With ``page_len``/``page_width``/``page_offs`` given, entry ``i`` whose
    ``page_offs[i]`` is non-negative is NOT packed: its pixels are read
    from the device-resident page buffer that the caller prepends to the
    atlas (only coordinates are uploaded for those lines); offsets of packed strips
    are shifted by ``page_len`` to address the concatenated buffer.
    """
    from kraken_tpu_torch.inference.recognition import width_bucket
    if page_offs is None:
        page_offs = [-1] * len(entries)
    total = int(np.sum([d.strip.size for d, po in zip(entries, page_offs)
                        if po < 0])) if entries else 0
    atlas_len = width_bucket(max(total, 1), base=ATLAS_BUCKET_BASE,
                             growth=ATLAS_BUCKET_GROWTH)
    atlas = np.zeros(atlas_len, np.uint8)
    grid = np.zeros((n, M_GRID, 3, 3), np.float32)
    grid[:, :, 1, 2] = 1.0        # keep row knots strictly increasing
    grid[:, :, 2, 2] = 2.0        # for batch-pad rows
    mask = np.zeros((n, M_MASK, 2), np.float32)
    meta = np.zeros((n, 8), np.int32)
    meta[:, 1] = 1          # w
    meta[:, 2] = 1          # h
    meta[:, 4] = max_w      # seq_len of batch-pad rows
    meta[:, 6] = 1          # stride
    off = 0
    for i, (d, po) in enumerate(zip(entries, page_offs)):
        h, w = d.strip.shape
        if po >= 0:
            meta[i] = (po, w, h, d.W_l, d.seq_len, d.pad, page_width, d.ss_on)
        else:
            atlas[off:off + h * w] = d.strip.reshape(-1)
            meta[i] = (page_len + off, w, h, d.W_l, d.seq_len, d.pad, w,
                       d.ss_on)
            off += h * w
        grid[i] = d.grid
        mask[i] = d.mask
    return atlas, grid, mask, meta
