"""
The port's host registries and helpers against the JAX package's on the
CPU: ``registry.load_model`` wraps a file's models in the task models
(tests/test_plugins.py:37 on the port) and the four choice lists equal the
JAX package's; ``lib.exceptions`` re-exports the port's exceptions;
``lib.functional_im_transforms`` gives the JAX module's results on the same
inputs (images bit for bit, text equal) and its transforms pickle.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import functools
import pickle
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

RESOURCES = Path(__file__).resolve().parent / 'resources'
LINE = RESOURCES / 'merge_tests' / '0006.jpg'


@pytest.mark.parametrize('fixture, task, cls', [
    ('overfit.mlmodel', 'recognition', 'RecognitionTaskModel'),
    ('blla_small.safetensors', 'segmentation', 'SegmentationTaskModel')])
def test_registry_load_model_wraps_tasks(fixture, task, cls):
    from kraken_tpu_torch import tasks
    from kraken_tpu_torch.registry import load_model
    wrapped = load_model(RESOURCES / fixture)
    assert list(wrapped) == [task]
    assert isinstance(wrapped[task], getattr(tasks, cls))
    assert load_model(RESOURCES / fixture, tasks=['reading_order']) == {}


def test_registry_lists_equal_jax():
    from kraken_tpu import registry as jax_registry
    from kraken_tpu_torch import registry
    for name in ('OPTIMIZERS', 'SCHEDULERS', 'STOPPERS', 'PRECISIONS'):
        assert getattr(registry, name) == getattr(jax_registry, name)


def test_lib_exceptions_reexports_the_port():
    from kraken_tpu_torch import exceptions
    from kraken_tpu_torch.lib import exceptions as lib_exceptions
    assert lib_exceptions.__all__ == exceptions.__all__
    for name in exceptions.__all__:
        assert getattr(lib_exceptions, name) is getattr(exceptions, name)


def _both(name):
    from kraken_tpu.lib import functional_im_transforms as jax_f
    from kraken_tpu_torch.lib import functional_im_transforms as f
    return getattr(f, name), getattr(jax_f, name)


def _line():
    return Image.open(LINE)


@pytest.mark.parametrize('name, args', [
    ('pil_to_mode', ('L',)), ('pil_to_mode', ('1',)), ('pil_to_bin', ()),
    ('pil_fixed_resize', ((48, 0),)), ('pil_fixed_resize', ((40, 300),)), ('dummy', ())])
def test_image_transforms_equal_jax(name, args):
    ours, theirs = _both(name)
    got, want = ours(_line(), *args), theirs(_line(), *args)
    assert got.mode == want.mode and got.size == want.size
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_pil_dewarp_equals_jax():
    from kraken_tpu.lib.lineest import CenterNormalizer as JaxNormalizer
    from kraken_tpu_torch.lib.lineest import CenterNormalizer
    ours, theirs = _both('pil_dewarp')
    im = _line().convert('L')
    got, want = ours(im, CenterNormalizer()), theirs(im, JaxNormalizer())
    assert got.size == want.size
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize('name, args', [('array_invert', ()), ('array_permute', ((1, 2, 0),))])
def test_array_transforms_equal_jax(name, args):
    arr = np.random.RandomState(0).rand(3, 5, 7).astype(np.float32)
    ours, theirs = _both(name)
    assert np.array_equal(ours(arr, *args), theirs(arr, *args))


@pytest.mark.parametrize('name, args', [
    ('text_normalize', ('é ﬁ', 'NFKC')), ('text_normalize', ('é', 'NFD')),
    ('text_whitespace_normalize', (' a\tb  c\n',)),
    ('text_reorder', ('abc אבג 1 2',)), ('text_reorder', ('abc אב', 'R')),
    ('default_split', ('dir/line.bin.gt.txt',)),
    ('suffix_split', ('dir/line.png',)), ('suffix_split', (Path('a/b.x.y'),))])
def test_text_and_path_transforms_equal_jax(name, args):
    ours, theirs = _both(name)
    assert ours(*args) == theirs(*args)
    if name == 'suffix_split':
        assert ours(*args, suffix='.gt.txt') == theirs(*args, suffix='.gt.txt')


def test_transforms_pickle():
    from kraken_tpu_torch.lib import functional_im_transforms as f
    for fn in (functools.partial(f.pil_to_mode, mode='L'), f.pil_to_bin,
               functools.partial(f.text_normalize, normalization='NFD'),
               functools.partial(f.suffix_split, split=f.default_split, suffix='.gt.txt')):
        back = pickle.loads(pickle.dumps(fn))
        assert pickle.dumps(back) == pickle.dumps(fn)
    assert pickle.loads(pickle.dumps(functools.partial(f.suffix_split, suffix='.gt.txt')))(
        'x/y.png') == 'x/y.gt.txt'
