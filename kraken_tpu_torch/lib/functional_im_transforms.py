"""
Named functional transforms (reference: kraken/lib/functional_im_transforms.py),
the counterpart of the JAX package's module: module-level functions, so
that transforms built from them pickle into data-loader worker processes.
The array variants take CHW numpy arrays.
"""
import unicodedata
from pathlib import Path
from typing import Any, Literal, Optional, Union

import numpy as np
import regex
from PIL import Image

from kraken_tpu_torch.lib.bidi import get_display
from kraken_tpu_torch.lib.lineest import CenterNormalizer, dewarp

__all__ = ['pil_to_mode', 'pil_to_bin', 'pil_dewarp', 'pil_fixed_resize',
           'array_invert', 'array_permute', 'text_normalize',
           'text_whitespace_normalize', 'text_reorder', 'default_split',
           'suffix_split', 'dummy']


def pil_to_mode(im: Image.Image, mode: str) -> Image.Image:
    return im.convert(mode)


def pil_to_bin(im: Image.Image) -> Image.Image:
    from kraken_tpu_torch.binarization import nlbin
    return nlbin(im)


def dummy(x: Any) -> Any:
    return x


def pil_dewarp(im: Image.Image, lnorm: CenterNormalizer) -> Image.Image:
    return dewarp(lnorm, im)


def pil_fixed_resize(im: Image.Image, scale: tuple[int, int]) -> Image.Image:
    from kraken_tpu_torch.dataset.transforms import _fixed_resize
    return _fixed_resize(im, scale)


def array_invert(arr: np.ndarray) -> np.ndarray:
    return arr.max() - arr


def array_permute(arr: np.ndarray, perm: tuple[int, ...]) -> np.ndarray:
    return np.transpose(arr, perm)


def text_normalize(text: str, normalization: Literal['NFD', 'NFC', 'NFKD', 'NFKC']) -> str:
    return unicodedata.normalize(normalization, text)


def text_whitespace_normalize(text: str) -> str:
    return regex.sub(r'\s', ' ', text).strip()


def text_reorder(text: str, base_dir: Optional[Literal['L', 'R']] = None) -> str:
    return get_display(text, base_dir=base_dir)


def default_split(x: Union[Path, str]) -> str:
    x = Path(x)
    while x.suffixes:
        x = x.with_suffix('')
    return str(x)


def suffix_split(x: Union[Path, str], split=default_split, suffix: str = '') -> str:
    return split(x) + suffix
