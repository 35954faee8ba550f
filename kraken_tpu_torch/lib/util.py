"""
kraken_tpu_torch.lib.util
~~~~~~~~~~~~~~~~~~~~~~~~~

PIL/numpy helpers (reference: kraken/lib/util.py), copied from the JAX
package's ``lib/util.py``. PIL is imported where it is used.
"""
import unicodedata
from os import PathLike
from pathlib import Path
from typing import TYPE_CHECKING, Union

import numpy as np

if TYPE_CHECKING:
    from PIL import Image

__all__ = ['pil2array', 'array2pil', 'is_bitonal', 'open_image', 'get_im_str',
           'is_printable', 'make_printable', 'default_segmentation_model', 'parse_gt_path']


def default_segmentation_model() -> Path:
    """The packaged default baseline-segmentation weights: the port's own
    copy of the bundled safetensors model, with a CoreML ``blla.mlmodel``
    taking precedence when a user installs one next to the package (the
    reference's packaged-model location, kraken/kraken.py:43)."""
    pkg = Path(__file__).resolve().parent.parent
    coreml = pkg / 'blla.mlmodel'
    return coreml if coreml.exists() else pkg / 'blla.safetensors'


def open_image(fname: Union[str, PathLike], mode=None) -> 'Image.Image':
    """Opens an image file applying EXIF orientation."""
    from PIL import Image, ImageOps
    im = Image.open(fname)
    im = ImageOps.exif_transpose(im)
    if mode:
        im = im.convert(mode)
    return im


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


def is_printable(char: str) -> bool:
    """
    True when a code point renders on its own: control, combining-mark and
    separator characters (which `kraken show` lists by Unicode name
    instead) are not printable. Reference: kraken/lib/util.py:57. The space
    is a separator too, as upstream has it: the JAX package calls it
    printable, so its `kraken show` lists a space grapheme as a blank.
    """
    if not char:
        return False
    return unicodedata.category(char)[0] not in ('C', 'M', 'Z')


def make_printable(char: str) -> str:
    """
    Returns a printable representation of a code point: control, combining
    and separator characters are replaced by their Unicode names (``' '``
    by ``'SPACE'``).
    """
    if not char:
        return ''
    if len(char) > 1:
        return ''.join(make_printable(c) for c in char)
    if not is_printable(char):
        try:
            return unicodedata.name(char)
        except ValueError:
            return f'U+{ord(char):04X}'
    return char


def parse_gt_path(path: Union[str, PathLike],
                  suffix: str = '.gt.txt',
                  split=None,
                  skip_empty_lines: bool = True,
                  base_dir=None,
                  text_direction: str = 'horizontal-lr'):
    """
    Parses an image + `.gt.txt` transcription pair into a BBoxLine covering
    the whole image (reference: lib/util.py:120).
    """
    from PIL import Image
    from kraken_tpu_torch.containers import BBoxLine

    path = Path(path)
    if split is None:
        base = path
        while base.suffixes:
            base = base.with_suffix('')
        gt_path = Path(str(base) + suffix)
    else:
        gt_path = Path(split(path) + suffix)
    try:
        with Image.open(path) as im:
            w, h = im.size
    except Exception as e:
        raise ValueError(f'Could not open image {path}: {e}') from e
    if not gt_path.is_file():
        raise ValueError(f'No transcription file {gt_path} for image {path}')
    text = gt_path.read_text(encoding='utf-8').strip('\n\r')
    if not text and skip_empty_lines:
        raise ValueError(f'Ground truth line has no transcription: {gt_path}')
    return BBoxLine(id=f'_{path.name}',
                    bbox=(0, 0, w, h),
                    text=text,
                    base_dir=base_dir,
                    imagename=path,
                    text_direction=text_direction)
