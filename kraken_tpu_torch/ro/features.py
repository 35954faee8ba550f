"""
Spatial feature extraction for neural reading order (reference:
_extract_element_features, kraken/lib/segmentation.py:925-960), a copy of
the JAX package's ``ro/features.py``: one-hot type class plus normalized
center/start/end coordinates.
"""
import numpy as np

from kraken_tpu_torch.rpred import _get_type

__all__ = ['element_features']


def element_features(element, image_size, class_mapping: dict, num_classes: int):
    """
    Returns (tag, feature vector) for a BaselineLine or Region.
    """
    w, h = image_size
    tag = _get_type(getattr(element, 'tags', None))
    cls = np.zeros(num_classes, np.float32)
    cls[class_mapping.get(tag, 0)] = 1
    if getattr(element, 'baseline', None) is not None:
        coords = np.array(element.baseline) / (w, h)
        center = coords.mean(axis=0)
        start = coords[0]
        end = coords[-1]
    elif getattr(element, 'boundary', None) is not None:
        boundary = np.array(element.boundary)
        center = boundary.mean(axis=0) / (w, h)
        start = np.array([boundary[:, 0].min(), boundary[:, 1].min()]) / (w, h)
        end = np.array([boundary[:, 0].max(), boundary[:, 1].max()]) / (w, h)
    else:
        raise ValueError('Neural reading order needs baseline lines or polygon regions.')
    return tag, np.concatenate([cls, center, start, end]).astype(np.float32)
