"""
kraken_tpu_torch.dataset.augmentation
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Data augmentation for recognition/segmentation training (reference:
DefaultAugmenter/SegmentationAugmenter in kraken/lib/dataset/*.py, built on
torchvision v2), a copy of the JAX package's ``dataset/augmentation.py`` on
numpy/OpenCV over CHW float arrays: random blur, perspective/rotation/affine
warps, random erasing, and color jitter; geometric warps transform images
and segmentation targets consistently. Each augmenter draws from its own
``numpy.random.RandomState(seed)``, so a seed replays its draws. Evaluation
runs with augmentation off.
"""
import numpy as np
import cv2

__all__ = ['DefaultAugmenter', 'SegmentationAugmenter']


def _chw_to_hwc(arr):
    return arr.transpose(1, 2, 0)


def _hwc_to_chw(arr):
    return arr.transpose(2, 0, 1)


def _warp(arr_chw: np.ndarray, matrix: np.ndarray, size) -> np.ndarray:
    out = cv2.warpAffine(_chw_to_hwc(arr_chw), matrix, size,
                         flags=cv2.INTER_LINEAR, borderValue=0.0)
    if out.ndim == 2:
        out = out[:, :, None]
    return _hwc_to_chw(out)


def _perspective(arr_chw: np.ndarray, matrix: np.ndarray, size) -> np.ndarray:
    out = cv2.warpPerspective(_chw_to_hwc(arr_chw), matrix, size,
                              flags=cv2.INTER_LINEAR, borderValue=0.0)
    if out.ndim == 2:
        out = out[:, :, None]
    return _hwc_to_chw(out)


def _random_affine_matrix(rng, w, h, degrees=0.0, translate=(0, 0),
                          scale=(1.0, 1.0), shear=0.0):
    angle = rng.uniform(-degrees, degrees)
    tx = rng.uniform(-translate[0], translate[0]) * w
    ty = rng.uniform(-translate[1], translate[1]) * h
    s = rng.uniform(*scale)
    sh = np.radians(rng.uniform(-shear, shear))
    center = (w / 2, h / 2)
    m = cv2.getRotationMatrix2D(center, angle, s)
    # add shear along x
    shear_m = np.array([[1, np.tan(sh), 0], [0, 1, 0]], np.float32)
    m3 = np.vstack([m, [0, 0, 1]]) @ np.vstack([shear_m, [0, 0, 1]])
    m3[0, 2] += tx
    m3[1, 2] += ty
    return m3[:2]


def _random_perspective_matrix(rng, w, h, distortion=0.2):
    dx = distortion * w / 2
    dy = distortion * h / 2
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = src + rng.uniform(-1, 1, (4, 2)).astype(np.float32) * [dx, dy]
    return cv2.getPerspectiveTransform(src, dst.astype(np.float32))


class DefaultAugmenter:
    """
    Line-image augmentation: with p=0.5 applies a random subset of erasing
    (p=.2), blur (p=.2), and geometric deformation (p=.2).
    """

    def __init__(self, seed=None):
        self.rng = np.random.RandomState(seed)

    def __call__(self, image: np.ndarray, index: int = 0) -> np.ndarray:
        rng = self.rng
        if rng.rand() >= 0.5:
            return image
        out = image.astype(np.float32)
        c, h, w = out.shape
        if rng.rand() < 0.2:
            # random erasing of a ~20% area patch
            eh = max(1, int(np.sqrt(0.2 * h * w / (w / h))))
            ew = max(1, int(0.2 * h * w / eh))
            eh, ew = min(eh, h), min(ew, w)
            y = rng.randint(0, max(1, h - eh + 1))
            x = rng.randint(0, max(1, w - ew + 1))
            out[:, y:y + eh, x:x + ew] = 0.0
        if rng.rand() < 0.2:
            sigma = rng.uniform(0.1, 2.0)
            hwc = _chw_to_hwc(out)
            blurred = cv2.GaussianBlur(hwc, (5, 5), sigma)
            if blurred.ndim == 2:
                blurred = blurred[:, :, None]
            out = _hwc_to_chw(blurred)
        if rng.rand() < 0.2:
            choice = rng.randint(3)
            if choice == 0:
                m = _random_perspective_matrix(rng, w, h, 0.2)
                out = _perspective(out, m, (w, h))
            elif choice == 1:
                m = _random_affine_matrix(rng, w, h, degrees=3)
                out = _warp(out, m, (w, h))
            else:
                m = _random_affine_matrix(rng, w, h, translate=(0.04, 0.04),
                                          scale=(0.9, 1.1), shear=3.0)
                out = _warp(out, m, (w, h))
        return np.clip(out, 0.0, 1.0)


class SegmentationAugmenter:
    """
    Page-image augmentation applying consistent geometric warps to image and
    target heatmap stack plus photometric jitter on the image only.
    """

    def __init__(self, seed=None):
        self.rng = np.random.RandomState(seed)

    def __call__(self, image: np.ndarray, target: np.ndarray):
        rng = self.rng
        if rng.rand() >= 0.5:
            return image, target
        img = image.astype(np.float32)
        tgt = target.astype(np.float32)
        c, h, w = img.shape
        if rng.rand() < 0.2:
            sigma = rng.uniform(0.1, 2.0)
            hwc = _chw_to_hwc(img)
            blurred = cv2.GaussianBlur(hwc, (5, 5), sigma)
            if blurred.ndim == 2:
                blurred = blurred[:, :, None]
            img = _hwc_to_chw(blurred)
        if rng.rand() < 0.2:
            m = _random_affine_matrix(rng, w, h, degrees=45,
                                      translate=(0.0625, 0.0625),
                                      scale=(0.8, 1.2), shear=5.0)
            img = _warp(img, m, (w, h))
            tgt = _warp(tgt, m, (w, h))
        if rng.rand() < 0.2:
            m = _random_perspective_matrix(rng, w, h, 0.2)
            img = _perspective(img, m, (w, h))
            tgt = _perspective(tgt, m, (w, h))
        if rng.rand() < 0.3:
            img = img * rng.uniform(0.9, 1.1) + rng.uniform(-0.1, 0.1)
        return np.clip(img, 0.0, 1.0), np.clip(tgt, 0.0, 1.0)
