"""
kraken_tpu_torch.native
~~~~~~~~~~~~~~~~~~~~~~~

Native (C++) host-side accelerators for the irregular hot loops of the
segmentation pipeline, bound via ctypes: a copy of the JAX package's
``native`` package (the port imports nothing of that package). The C++
sources beside this file are compiled with ``g++`` at first use into
``kraken_tpu_torch/_build/_native.so`` (rebuilt when a source is newer);
every entry point degrades to the pure-numpy implementation of its caller
when no compiler is available. ``available()`` says whether the library
loaded.
"""
import ctypes
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ['skeletonize_native', 'endpoints_native', 'link_paths_native', 'bilinear_diag_native', 'label4_native', 'find_objects_native',
           'resize_lanczos_native', 'polygonize_page_native', 'available', 'BUILD_DIR']

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parent / '_build'


def _build_lib() -> Optional[Path]:
    srcs = [SOURCE_DIR / f'{name}.cpp'
            for name in ('skeletonize', 'polygonize', 'lineest', 'morphology')]
    out = BUILD_DIR / '_native.so'
    if out.exists() and all(out.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for compiler in ('g++', 'c++', 'clang++'):
        # build beside the target and rename into place, so that a process
        # never loads a library another process is still writing
        fd, tmp_path = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        try:
            result = subprocess.run([compiler, '-O3', '-march=native', '-shared',
                                     '-fPIC', '-o', tmp_path] + [str(s) for s in srcs],
                                    capture_output=True, timeout=120)
            if result.returncode == 0:
                os.replace(tmp_path, out)
                return out
            logger.debug(f'{compiler} failed: {result.stderr.decode()[:500]}')
        except (OSError, subprocess.TimeoutExpired):
            continue
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = _build_lib()
        if path is None:
            logger.info('No C++ compiler available; using numpy fallbacks.')
            return None
        lib = ctypes.CDLL(str(path))
        lib.zhang_suen_thin.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                        ctypes.c_int, ctypes.c_int]
        lib.zhang_suen_thin.restype = ctypes.c_int
        lib.skeleton_endpoints.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int32),
                                           ctypes.c_int]
        lib.skeleton_endpoints.restype = ctypes.c_int
        lib.carve_seam.argtypes = [ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int32)]
        lib.carve_seam.restype = None
        lib.line_seeds.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_float,
                                   ctypes.POINTER(ctypes.c_uint8)]
        lib.line_seeds.restype = None
        lib.link_endpoint_paths.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int32),
                                            ctypes.c_int, ctypes.c_double,
                                            ctypes.POINTER(ctypes.c_int32),
                                            ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int32),
                                            ctypes.c_int]
        lib.link_endpoint_paths.restype = ctypes.c_int
        lib.resize_lanczos_u8.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_uint8),
                                          ctypes.c_int, ctypes.c_int]
        lib.resize_lanczos_u8.restype = ctypes.c_int
        lib.polyg_prepare.argtypes = [ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_double),
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.c_int]
        lib.polyg_prepare.restype = ctypes.c_void_p
        lib.polyg_n_patches.argtypes = [ctypes.c_void_p]
        lib.polyg_n_patches.restype = ctypes.c_int
        lib.polyg_patch_dims.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int32)]
        lib.polyg_patch_dims.restype = None
        lib.polyg_copy_patch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_float)]
        lib.polyg_copy_patch.restype = None
        lib.polyg_set_rows.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int32)]
        lib.polyg_set_rows.restype = None
        lib.polyg_carve.argtypes = [ctypes.c_void_p]
        lib.polyg_carve.restype = None
        lib.polyg_complete.argtypes = [ctypes.c_void_p]
        lib.polyg_complete.restype = ctypes.c_int
        lib.polyg_result_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.polyg_result_len.restype = ctypes.c_int
        lib.polyg_result.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.polyg_result.restype = None
        lib.polyg_free.argtypes = [ctypes.c_void_p]
        lib.polyg_free.restype = None
        lib.sliding_percentile_f64.argtypes = [ctypes.POINTER(ctypes.c_double),
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_double,
                                               ctypes.POINTER(ctypes.c_double)]
        lib.sliding_percentile_f64.restype = None
        lib.bilinear_diag_f64.argtypes = [ctypes.POINTER(ctypes.c_double),
                                          ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_double,
                                          ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_double,
                                          ctypes.POINTER(ctypes.c_double)]
        lib.bilinear_diag_f64.restype = None
        lib.label4_u8.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int32)]
        lib.label4_u8.restype = ctypes.c_int64
        lib.find_objects_i32.argtypes = [ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64,
                                         ctypes.POINTER(ctypes.c_int64)]
        lib.find_objects_i32.restype = None
        _LIB = lib
    except Exception as e:
        logger.warning(f'Failed to build/load native helpers: {e}')
    return _LIB


def available() -> bool:
    return _load() is not None


def skeletonize_native(mask: np.ndarray) -> Optional[np.ndarray]:
    """
    Zhang-Suen thinning via the native library. Returns None when the
    library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    padded = np.pad(mask.astype(np.uint8), 1)
    buf = np.ascontiguousarray(padded)
    lib.zhang_suen_thin(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        buf.shape[0], buf.shape[1])
    return buf[1:-1, 1:-1].astype(bool)


def carve_seam_native(padded: np.ndarray) -> Optional[np.ndarray]:
    """
    Minimum-energy seam row per column over a float32 patch whose first and
    last rows are +inf padding. Returns row indices (including the padding
    offset) or None when the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    buf = np.ascontiguousarray(padded, np.float32)
    out = np.zeros(buf.shape[1], np.int32)
    lib.carve_seam(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   buf.shape[0], buf.shape[1],
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def line_seeds_native(bmarked: np.ndarray, tmarked: np.ndarray,
                      delta: int, limit: float) -> Optional[np.ndarray]:
    """
    Seed bands between matched baseline/topline transition marks (the
    per-column loop of pageseg.compute_line_seeds). Returns an int32 seed
    map or None when the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    bm = np.ascontiguousarray(bmarked != 0, np.uint8)
    tm = np.ascontiguousarray(tmarked != 0, np.uint8)
    out = np.zeros(bm.shape, np.uint8)
    lib.line_seeds(bm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                   tm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                   bm.shape[0], bm.shape[1], int(delta), float(limit),
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype('i')


def endpoints_native(skel: np.ndarray, max_pts: int = 100000) -> Optional[np.ndarray]:
    """Skeleton endpoints as an (N, 2) array of (row, col), or None."""
    lib = _load()
    if lib is None:
        return None
    padded = np.ascontiguousarray(np.pad(skel.astype(np.uint8), 1))
    out = np.zeros((max_pts, 2), np.int32)
    n = lib.skeleton_endpoints(padded.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               padded.shape[0], padded.shape[1],
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                               max_pts)
    return out[:n] - 1


def link_paths_native(skel: np.ndarray, extrema: np.ndarray,
                      limit: float = 3.0) -> Optional[list]:
    """
    Minimum-cost endpoint-pair paths through a skeleton + 1px halo (the
    native counterpart of lib/vectorization._link_endpoints: identical
    cost model and pair semantics; see skeletonize.cpp). Returns a list of
    (N, 2) int arrays or None when the library is unavailable or the
    preallocated output is exceeded (caller falls back to the scipy path).
    """
    lib = _load()
    if lib is None:
        return None
    sk = np.ascontiguousarray(skel != 0, np.uint8)
    eps = np.ascontiguousarray(extrema, np.int32)
    if eps.size == 0:
        return []
    max_paths = len(eps) * (len(eps) - 1) // 2 + 1
    cap = 2 * int(sk.sum() * 9 + 16) * min(len(eps), 8)
    out_pts = np.empty(cap, np.int32)
    out_lens = np.empty(max_paths, np.int32)
    n = lib.link_endpoint_paths(
        sk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sk.shape[0], sk.shape[1],
        eps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(eps), float(limit),
        out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_paths)
    if n < 0:
        return None
    paths = []
    off = 0
    # int64, matching the scipy path's `nodes` dtype (downstream geometry
    # is dtype-sensitive: int32 coordinates changed seam-patch rounding)
    pts = out_pts.reshape(-1, 2).astype(np.int64)
    for k in range(n):
        ln = int(out_lens[k])
        paths.append(pts[off:off + ln])
        off += ln
    return paths


_RESIZE_VERIFIED: Optional[bool] = None


def _verify_resize(lib) -> bool:
    """One-time byte-exactness check of the native Lanczos against PIL
    (random up/down-scale shapes). Any mismatch permanently disables the
    native path — the line-normalization contract is exact PIL output."""
    from PIL import Image
    rng = np.random.RandomState(12345)
    for (h, w, oh, ow, c) in ((93, 411, 120, 530, 1), (150, 1800, 120, 1440, 1),
                              (64, 64, 64, 97, 1), (40, 333, 120, 999, 3),
                              (200, 120, 120, 72, 3), (1800, 1200, 1200, 800, 1)):
        shape = (h, w) if c == 1 else (h, w, c)
        a = rng.randint(0, 256, shape, dtype=np.uint8)
        want = np.asarray(Image.fromarray(a, 'L' if c == 1 else 'RGB').resize(
            (ow, oh), Image.Resampling.LANCZOS))
        out = np.empty((oh, ow) if c == 1 else (oh, ow, c), np.uint8)
        rc = lib.resize_lanczos_u8(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), oh, ow)
        if rc != 0 or not np.array_equal(out, want):
            logger.warning('native Lanczos does not match PIL byte-for-byte '
                           'on this platform; falling back to PIL resize')
            return False
    return True


def polygonize_page_native(baselines: list,
                           extras_per_line: list,
                           im_feats: np.ndarray,
                           topline: Optional[bool],
                           carve_rows=None) -> Optional[list]:
    """
    Native page polygonization (polygonize.cpp): every baseline's ROI ray
    casting, energy-patch preparation, seam carving, and polygon completion
    run in one C++ call. Mirrors lib/polygonization's per-line pipeline
    (ROI semantics of _calc_roi, seam semantics of _seam_prepare/_carve_seam,
    completion of _prepare_seams.complete); rasterization may differ from
    the cv2 fallback by single boundary pixels.

    Args:
        baselines: [[(x, y), ...], ...] baselines to polygonize. For line i
            the boundary set is every other baseline plus its extras.
        extras_per_line: per-line list of extra boundary polylines
            ([(x, y), ...] each) — e.g. the containing regions.
        im_feats: (H, W) float32 energy map.
        topline: False = baseline, True = topline, None = centerline.
        carve_rows: None runs the native seam DP. Otherwise a callable
            ``f(patches) -> rows`` receiving the list of (h, w) float32
            patches and returning per-patch int32 seam-row arrays (pad
            offset removed) — the hook for the batched device DP.

    Returns:
        One polygon ([[x, y], ...]) or None per baseline; None overall when
        the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n_bl = len(baselines)
    if n_bl == 0:
        return []
    # polyline soup: baselines first, then the (deduplicated) extras. An
    # extra that IS one of the baseline objects maps to the baseline's own
    # index; the C++ side already includes every other baseline in each
    # line's boundary set and skips such extras, so callers passing "the
    # other baselines + regions" (vec_lines) don't double the segment soup
    polys = [np.asarray(b, np.float64).reshape(-1, 2) for b in baselines]
    extra_idx: list[int] = []
    extra_off = np.zeros(n_bl + 1, np.int64)
    seen: dict[int, int] = {id(b): i for i, b in enumerate(baselines)}
    for i, extras in enumerate(extras_per_line):
        for obj in extras or ():
            key = id(obj)
            idx = seen.get(key)
            if idx is None:
                idx = len(polys)
                polys.append(np.asarray(obj, np.float64).reshape(-1, 2))
                seen[key] = idx
            extra_idx.append(idx)
        extra_off[i + 1] = len(extra_idx)
    pts = np.concatenate(polys, axis=0) if polys else np.zeros((0, 2))
    pts = np.ascontiguousarray(pts, np.float64)
    poly_off = np.zeros(len(polys) + 1, np.int64)
    np.cumsum([len(p) for p in polys], out=poly_off[1:])
    eidx = np.ascontiguousarray(extra_idx or [0], np.int32)
    feats = np.ascontiguousarray(im_feats, np.float32)
    tl = -1 if topline is None else (1 if topline else 0)

    ctx = lib.polyg_prepare(
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        feats.shape[0], feats.shape[1],
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        poly_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(polys), n_bl,
        eidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        extra_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        tl)
    if not ctx:
        return None
    try:
        if carve_rows is None:
            lib.polyg_carve(ctx)
        else:
            n_patches = lib.polyg_n_patches(ctx)
            dims = np.zeros((n_patches, 2), np.int32)
            if n_patches:
                lib.polyg_patch_dims(ctx, dims.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int32)))
            patches = []
            for k in range(n_patches):
                p = np.empty((int(dims[k, 0]), int(dims[k, 1])), np.float32)
                lib.polyg_copy_patch(ctx, k, p.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)))
                patches.append(p)
            for k, rows in enumerate(carve_rows(patches)):
                r = np.ascontiguousarray(rows, np.int32)
                lib.polyg_set_rows(ctx, k, r.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int32)))
        lib.polyg_complete(ctx)
        out = []
        for i in range(n_bl):
            n = lib.polyg_result_len(ctx, i)
            if n < 0:
                out.append(None)
                continue
            buf = np.empty((n, 2), np.int32)
            lib.polyg_result(ctx, i, buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)))
            out.append(buf.tolist())
        return out
    finally:
        lib.polyg_free(ctx)


def sliding_percentile_native(arr: np.ndarray, q: float,
                              window: tuple) -> Optional[np.ndarray]:
    """
    Same-size 2-D sliding-window percentile with symmetric padding
    (sliding_percentile_f64 in skeletonize.cpp) — bit-identical to
    np.percentile('linear') over the window stack, ~5x numpy's blocked
    partition for the small nlbin windows. Returns None when the library
    is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(arr, np.float64)
    out = np.empty_like(src)
    lib.sliding_percentile_f64(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        src.shape[0], src.shape[1], int(window[0]), int(window[1]),
        float(q), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def resize_lanczos_native(img: np.ndarray, oh: int, ow: int) -> Optional[np.ndarray]:
    """
    Byte-exact PIL-Lanczos resize of a 2-D (or HxWxC, C<=4) uint8 array via the native
    library (see resize_lanczos_u8 in skeletonize.cpp). Returns None when
    the library is unavailable or failed the load-time PIL-equivalence
    self-check (callers then use PIL directly).
    """
    global _RESIZE_VERIFIED
    lib = _load()
    if lib is None:
        return None
    if _RESIZE_VERIFIED is None:
        _RESIZE_VERIFIED = _verify_resize(lib)
    if not _RESIZE_VERIFIED:
        return None
    src = np.ascontiguousarray(img, np.uint8)
    c = 1 if src.ndim == 2 else src.shape[2]
    if src.ndim > 3 or c > 4:
        return None
    out = np.empty((int(oh), int(ow)) if c == 1 else (int(oh), int(ow), c),
                   np.uint8)
    rc = lib.resize_lanczos_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.shape[0], src.shape[1], c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(oh), int(ow))
    if rc != 0:
        return None
    return out


def bilinear_diag_native(img: np.ndarray, inv_scale: float,
                         out_shape, cval: float) -> Optional[np.ndarray]:
    """
    Bit-exact native evaluation of lib/lineest._bilinear_diag (the diagonal
    order-1 affine transform of the CenterNormalizer dewarp path): the C++
    kernel evaluates the identical IEEE double expression tree, so outputs
    match the numpy implementation bit for bit
    (tests/test_lineest.py pins this). Returns None without a compiler.
    """
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(img, np.float64)
    if src.ndim != 2:
        return None
    oh, ow = int(out_shape[0]), int(out_shape[1])
    out = np.empty((oh, ow), np.float64)
    lib.bilinear_diag_f64(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        src.shape[0], src.shape[1], float(inv_scale), oh, ow, float(cval),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def label4_native(image: np.ndarray):
    """
    4-connectivity connected-component labeling identical to
    scipy.ndimage.label's default (cross structure): labels numbered 1..n
    in raster order of each component's first pixel. Returns
    (labels int32 array, n) or None without a compiler.
    """
    lib = _load()
    if lib is None or image.ndim != 2:
        return None
    src = np.ascontiguousarray(image != 0, np.uint8) \
        if image.dtype != np.uint8 else np.ascontiguousarray(image)
    out = np.empty(src.shape, np.int32)
    n = lib.label4_u8(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      src.shape[0], src.shape[1],
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, int(n)


def find_objects_native(labels: np.ndarray, max_label: int = 0):
    """
    scipy.ndimage.find_objects equivalent for 2-D int32 label arrays:
    a list of (row slice, col slice) per label 1..max_label (or
    labels.max()), None entries for absent labels. Returns None without a
    compiler or for unsupported inputs.
    """
    lib = _load()
    if lib is None or labels.ndim != 2:
        return None
    src = np.ascontiguousarray(labels, np.int32)
    n = int(max_label) if max_label else (int(src.max()) if src.size else 0)
    if n <= 0:
        return []
    boxes = np.empty((n, 4), np.int64)
    lib.find_objects_i32(src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         src.shape[0], src.shape[1], n,
                         boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return [None if b[0] < 0 else
            (slice(int(b[0]), int(b[1])), slice(int(b[2]), int(b[3])))
            for b in boxes]
