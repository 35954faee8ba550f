"""
kraken_tpu_torch.dataset.transforms
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Image input transforms of recognition and segmentation networks (reference:
kraken/lib/dataset/utils.py ImageInputTransforms), a copy of the JAX
package's ``dataset/transforms.py`` for inference. Maps PIL images to
normalized float32 CHW numpy arrays:

    mode conversion → centerline dewarp | resize → pad → to-array →
    scale to [0,1] → invert → permute

Transform selection by the VGSL input spec (batch, height, width, channels)
follows the reference's rules: a 1-high input with >3 "channels" means a
legacy channels-as-height line network with optional centerline
normalization; fixed height ⇒ proportional Lanczos resize; fixed
height+width ⇒ exact resize, no padding.
"""
import numbers
from typing import TYPE_CHECKING, Union

import numpy as np

from kraken_tpu_torch.exceptions import KrakenInputException
from kraken_tpu_torch.lib.lineest import CenterNormalizer, dewarp

if TYPE_CHECKING:
    from PIL import Image

__all__ = ['ImageInputTransforms']


def _fixed_resize(img: 'Image.Image', scale: tuple[int, int]) -> 'Image.Image':
    """
    Resizes to (height, width) with PIL's Lanczos filter, inferring a
    0-valued dimension proportionally. The JAX package's native resize is a
    byte-exact copy of this PIL call, and trained models are sensitive to
    the resampling spectrum of their inputs, so the filter is fixed.
    """
    from PIL import Image
    w, h = img.size
    oh, ow = scale
    if oh == 0:
        oh = max(1, int(h * ow / w))
    elif ow == 0:
        ow = max(1, int(w * oh / h))
    return img.resize((ow, oh), Image.Resampling.LANCZOS)


class ImageInputTransforms:
    def __init__(self,
                 batch: int,
                 height: int,
                 width: int,
                 channels: int,
                 pad: Union[int, tuple[int, int], tuple[int, int, int, int]],
                 valid_norm: bool = True) -> None:
        """
        Args:
            batch: mini-batch size (kept for spec compatibility)
            height: desired height (0 = variable)
            width: desired width (0 = variable)
            channels: color channels; >3 with height 1 means
                      channels-as-height line input
            pad: horizontal padding (int = left/right, 2-tuple = (l/r, t/b),
                 4-tuple = (l, t, r, b))
            valid_norm: allow centerline normalization where applicable
        """
        self._spec = (batch, height, width, channels, pad)
        self._configure(valid_norm)

    def _configure(self, valid_norm: bool) -> None:
        batch, height, width, channels, pad = self._spec
        self._batch = batch
        self._scale = (height, width)
        self._channels = channels
        self._pad = pad
        self._valid_norm = valid_norm
        self._center_norm = False
        self._mode = 'RGB' if channels == 3 else 'L'
        if height == 1 and width == 0 and channels > 3:
            self._perm = (1, 0, 2)
            self._scale = (channels, 0)
            self._channels = 1
            self._center_norm = valid_norm
            self._mode = 'L'
        elif height > 1 and width == 0 and channels in (1, 3):
            self._perm = (0, 1, 2)
            self._center_norm = valid_norm and channels == 1
        elif height == 0 and width > 1 and channels in (1, 3):
            self._perm = (0, 1, 2)
        elif height > 0 and width > 0 and channels in (1, 3):
            self._perm = (0, 1, 2)
            self._pad = 0
        elif height == 0 and width == 0 and channels in (1, 3):
            self._perm = (0, 1, 2)
            self._pad = 0
        else:
            raise KrakenInputException(
                f'Invalid input spec {batch}, {height}, {width}, {channels}, {pad}.')
        self._lnorm = CenterNormalizer(self._scale[0]) if self._center_norm else None

    @property
    def valid_norm(self) -> bool:
        """Whether centerline normalization may apply (bbox lines)."""
        return self._valid_norm

    @valid_norm.setter
    def valid_norm(self, valid_norm: bool) -> None:
        self._configure(valid_norm)

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def scale(self) -> tuple[int, int]:
        """The (height, width) the input is resized to (0 = proportional)."""
        return self._scale

    def __call__(self, im: 'Image.Image') -> np.ndarray:
        im = im.convert(self._mode)
        if self._scale != (0, 0):
            if self._center_norm:
                im = dewarp(self._lnorm, im)
                im = im.convert(self._mode)
            else:
                im = _fixed_resize(im, self._scale)
        return self.tail(im)

    def tail(self, im: 'Image.Image') -> np.ndarray:
        """Pad/to-array/normalize stages of an already resized image."""
        from PIL import Image
        if self._pad:
            pad = self._pad
            if isinstance(pad, numbers.Number):
                l = t = r = b = int(pad)
            elif len(pad) == 2:
                l = r = int(pad[0])
                t = b = int(pad[1])
            else:
                l, t, r, b = (int(x) for x in pad)
            padded = Image.new(im.mode, (im.width + l + r, im.height + t + b),
                               255 if im.mode != 'RGB' else (255, 255, 255))
            padded.paste(im, (l, t))
            im = padded
        arr = np.asarray(im)
        if arr.ndim == 2:
            arr = arr[None, :, :]
        else:
            arr = arr.transpose(2, 0, 1)
        arr = arr.astype(np.float32) / 255.0
        arr = arr.max() - arr
        return np.transpose(arr, self._perm)
