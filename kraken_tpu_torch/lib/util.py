"""
kraken_tpu_torch.lib.util
~~~~~~~~~~~~~~~~~~~~~~~~~

PIL/numpy helpers (reference: kraken/lib/util.py), copied from the JAX
package's ``lib/util.py``. PIL is imported where it is used.
"""
from pathlib import Path
from typing import TYPE_CHECKING, Union

import numpy as np

if TYPE_CHECKING:
    from PIL import Image

__all__ = ['pil2array', 'array2pil', 'is_bitonal', 'get_im_str',
           'default_segmentation_model']


def default_segmentation_model() -> Path:
    """The packaged default baseline-segmentation weights: the port's own
    copy of the bundled safetensors model, with a CoreML ``blla.mlmodel``
    taking precedence when a user installs one next to the package (the
    reference's packaged-model location, kraken/kraken.py:43)."""
    pkg = Path(__file__).resolve().parent.parent
    coreml = pkg / 'blla.mlmodel'
    return coreml if coreml.exists() else pkg / 'blla.safetensors'


def get_im_str(im: 'Image.Image') -> str:
    return f'{im.filename if hasattr(im, "filename") else im}'


def pil2array(im: 'Image.Image', alpha: int = 0) -> np.ndarray:
    """Converts a PIL image to a numpy array, mapping mode '1' to uint8."""
    if im.mode == '1':
        return np.array(im.convert('L'))
    return np.array(im)


def array2pil(arr: np.ndarray) -> 'Image.Image':
    """Converts a numpy array back to a PIL image."""
    from PIL import Image
    if arr.dtype == np.dtype('B'):
        if arr.ndim == 2:
            return Image.frombytes('L', (arr.shape[1], arr.shape[0]), arr.tobytes())
        if arr.ndim == 3:
            return Image.frombytes('RGB', (arr.shape[1], arr.shape[0]), arr.tobytes())
        raise Exception('bad image rank')
    if arr.dtype == np.dtype('float32'):
        return Image.frombytes('F', (arr.shape[1], arr.shape[0]), arr.tobytes())
    raise Exception(f'unknown image type: {arr.dtype}')


def is_bitonal(im: Union['Image.Image', np.ndarray]) -> bool:
    """True if an image (or array) contains only two intensity values."""
    if isinstance(im, np.ndarray):
        return len(np.unique(im)) == 2
    return im.getcolors(2) is not None and len(im.getcolors(2)) == 2
