"""
nlbin on the device (kraken_tpu_torch.ops.binarize) against the JAX
package's (kraken_tpu.ops.binarize), on the CPU, where the percentile
wrapper runs its plain version.

- The plain sliding-window percentile against ``_window_percentile``
  within 1e-6 (odd, even and narrower-than-pad maps; ranges 1, 7, 20 and
  33; both window shapes). Not bit for bit: XLA on the CPU turns the
  ``/ 100`` of ``jnp.percentile`` into a product by 0.01 and contracts the
  lerp into an FMA, which moves a result by up to 4.8e-7; the port computes
  the lerp as the JAX source writes it, products and sum each rounded once,
  and so does the kernel (``csrc/percentile.cu``), bit for bit.
- The zoom and the zoom back against ``jax.image.resize`` within 1e-6;
  the rectangular dilation exactly (windows of 4 and 50); the masked
  percentile within 1e-6 (an empty mask gives NaN in both); the Gaussians
  within 1e-6.
- ``nlbin_device`` and ``nlbin_batch`` against the JAX functions: the
  bitonal maps are equal but at pixels whose flattened value lies within
  1e-5 of the threshold (counted); the JAX test_ops cases themselves (over
  99% agreement with the host nlbin, the batch of two pages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from kraken_tpu.ops import binarize as jax_binarize
from kraken_tpu_torch.ops import binarize

TOL = 1e-6
NEAR = 1e-5


@pytest.mark.parametrize('shape', [(7, 5), (13, 22), (30, 31), (1, 9), (4, 1), (40, 64)],
                         ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('r', [1, 7, 20, 33])
def test_plain_percentile_equals_jax(shape, r):
    rng = np.random.RandomState(shape[0] * 100 + r)
    x = rng.rand(*shape).astype(np.float32)
    x.flat[::3] = x.flat[0]  # ties
    for size in ((r, 2), (2, r)):
        want = np.asarray(jax_binarize._window_percentile(jnp.asarray(x), 80, size))
        got = binarize.window_percentile_reference(torch.from_numpy(x)[None], 80, size)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_percentile_batch_and_other_percentiles():
    """A batch of maps is each map on its own; the ranks and weights follow
    ``jnp.percentile`` at other percentiles too."""
    rng = np.random.RandomState(5)
    x = rng.rand(3, 11, 17).astype(np.float32)
    for perc in (0, 5, 50, 80, 90, 100):
        got = binarize.window_percentile(torch.from_numpy(x), perc, (7, 2)).numpy()
        for n in range(3):
            want = np.asarray(jax_binarize._window_percentile(jnp.asarray(x[n]), perc, (7, 2)))
            np.testing.assert_allclose(got[n], want, rtol=0, atol=TOL)


def test_ranks_follow_the_jax_formula():
    """lo, hi and the weights of n = 40 at 80: q = 0.8 * 39 = 31.2 in fp32."""
    lo, hi, w_lo, w_hi = binarize._ranks(80, 40)
    q = np.float32(np.float32(0.8) * np.float32(39))
    assert (lo, hi) == (31, 32)
    assert w_hi == np.float32(q - 31) and w_lo == np.float32(1 - np.float32(q - 31))
    assert binarize._ranks(100, 40)[:2] == (39, 39) and binarize._ranks(0, 1) == (0, 0, 1.0, 0.0)


@pytest.mark.parametrize('bad', ['dims', 'dtype', 'window', 'perc', 'nan'])
def test_percentile_wrapper_refuses(bad):
    x = torch.rand(2, 9, 8)
    size, perc = (20, 2), 80
    if bad == 'dims':
        x = x[0]
    elif bad == 'dtype':
        x = x.double()
    elif bad == 'window':
        size = (0, 2)
    elif bad == 'perc':
        perc = 101
    else:
        x[1, 3, 4] = float('nan')
    before = binarize.window_percentile.launches
    with pytest.raises((TypeError, ValueError)):
        binarize.window_percentile(x, perc, size)
    assert binarize.window_percentile.launches == before


def test_percentile_wrapper_runs_the_plain_version_on_the_cpu():
    x = torch.rand(2, 19, 13)
    before = binarize.window_percentile.launches
    assert torch.equal(binarize.window_percentile(x, 80, (2, 33)),
                       binarize.window_percentile_reference(x, 80, (2, 33)))
    assert binarize.window_percentile.launches == before


@pytest.mark.parametrize('shape, zoom', [((64, 96), 0.5), ((2184, 1456), 0.5),
                                         ((37, 23), 0.5), ((50, 40), 0.33), ((20, 30), 1.0)],
                         ids=lambda v: str(v))
def test_resize_pair_equals_jax(shape, zoom):
    rng = np.random.RandomState(shape[0])
    x = rng.rand(*shape).astype(np.float32)
    h, w = shape
    small = (max(1, int(h * zoom)), max(1, int(w * zoom)))
    want = np.asarray(jax.image.resize(jnp.asarray(x), small, 'bilinear'))
    got = binarize._resize(torch.from_numpy(x)[None], small)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    back = np.asarray(jax.image.resize(jnp.asarray(want), shape, 'bilinear'))
    got_back = binarize._resize(torch.from_numpy(np.array(want))[None], shape)[0].numpy()
    np.testing.assert_allclose(got_back, back, rtol=0, atol=TOL)


@pytest.mark.parametrize('size', [(4, 1), (1, 4), (50, 1), (1, 50), (3, 3)])
def test_binary_dilation_equals_jax(size):
    rng = np.random.RandomState(sum(size))
    mask = rng.rand(2, 60, 70) < 0.02
    got = binarize._binary_dilation_rect(torch.from_numpy(mask), size).numpy()
    for n in range(2):
        want = np.asarray(jax_binarize._binary_dilation_rect(jnp.asarray(mask[n]), size))
        assert np.array_equal(got[n], want)


@pytest.mark.parametrize('frac', [0.0, 0.001, 0.3, 1.0])
def test_masked_percentile_equals_jax(frac):
    rng = np.random.RandomState(int(frac * 1000))
    values = rng.rand(2, 40, 50).astype(np.float32)
    mask = rng.rand(2, 40, 50) < frac
    for q in (5, 90):
        got = binarize._masked_percentile(torch.from_numpy(values), torch.from_numpy(mask),
                                          q).numpy()
        want = [float(jax_binarize._masked_percentile(jnp.asarray(values[n]),
                                                      jnp.asarray(mask[n]), q))
                for n in range(2)]
        if frac == 0.0:
            assert np.isnan(got).all() and np.isnan(want).all()
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize('shape', [(64, 96), (40, 30), (300, 200)])
def test_gaussian_filter_equals_jax(shape):
    """Sigma 20 (radius 80), so the reflect padding of the narrow maps
    reflects more than once."""
    x = np.random.RandomState(shape[1]).rand(*shape).astype(np.float32)
    got = binarize._gaussian_filter(torch.from_numpy(x)[None], 20.0)[0].numpy()
    want = np.asarray(jax_binarize._gaussian_filter(jnp.asarray(x), 20.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def port_nlbin(pages: np.ndarray, threshold: float = 0.5,
               **kwargs) -> tuple[np.ndarray, np.ndarray]:
    """The port's bitonal maps of (N, H, W) pages in [0, 1] on the CPU, and
    the flattened values the threshold compares."""
    flat = binarize._nlbin_flat(torch.from_numpy(pages.astype(np.float32)), **kwargs)
    return (flat > threshold).numpy(), flat.numpy()


def assert_equal_but_near_threshold(got, want, flat, threshold=0.5) -> int:
    """Equal maps but at pixels within 1e-5 of the threshold; their count."""
    near = np.abs(flat - threshold) <= NEAR
    assert not ((got != want) & ~near).any()
    return int(near.sum())


@pytest.fixture(scope='module')
def input_page(resources):
    arr = np.asarray(Image.open(resources / 'input.jpg').convert('L'))
    return arr, jax_binarize.nlbin_device(arr)


def test_nlbin_device_equals_jax(input_page):
    arr, want = input_page
    got = binarize.nlbin_device(arr, device='cpu')
    assert got.dtype == torch.bool and got.device.type == 'cpu' and got.shape == arr.shape
    _, flat = port_nlbin(arr[None] / np.float32(255.0))
    near = assert_equal_but_near_threshold(got.numpy(), want, flat[0])
    print(f'nlbin_device on input.jpg: {near} pixels within {NEAR} of the threshold')
    assert near < 100


def test_nlbin_device_agreement(resources, input_page):
    """tests/test_ops.py:test_nlbin_device_agreement on the port."""
    from kraken_tpu_torch.binarization import nlbin
    arr, _ = input_page
    host = np.asarray(nlbin(Image.open(resources / 'input.jpg').convert('L'))) > 128
    dev = binarize.nlbin_device(arr, device='cpu').numpy()
    assert (host == dev).mean() > 0.99


def test_nlbin_device_input_rule():
    """uint8 or above 1.5: divided by 255; floats in [0, 1] as they are."""
    rng = np.random.RandomState(2)
    page = np.clip(rng.rand(64, 96) * 0.3 + 0.6, 0, 1).astype(np.float32)
    page[20:30, 10:80] = 0.1
    as_bytes = np.round(page * 255).astype(np.uint8)
    a = binarize.nlbin_device(page, device='cpu')
    b = binarize.nlbin_device(as_bytes, device='cpu')
    c = binarize.nlbin_device(torch.from_numpy(as_bytes), device='cpu')
    assert torch.equal(b, c)
    assert np.array_equal(a.numpy(), np.asarray(jax_binarize.nlbin_device(page)))
    assert np.array_equal(b.numpy(), np.asarray(jax_binarize.nlbin_device(as_bytes)))


def ops_pages() -> np.ndarray:
    rng = np.random.RandomState(0)
    pages = np.clip(rng.rand(2, 64, 96) * 0.3 + 0.6, 0, 1)
    pages[:, 20:30, 10:80] = 0.1  # text band
    return pages


def test_nlbin_batch():
    """tests/test_ops.py:test_nlbin_batch on the port, and the same maps as
    the JAX batch."""
    pages = ops_pages()
    out = binarize.nlbin_batch(pages, device='cpu').numpy()
    assert out.shape == (2, 64, 96)
    assert out.dtype == bool
    # text darker than background -> text pixels False, paper True
    assert out[:, 25, 40].sum() == 0
    assert out[:, 5, 40].sum() == 2
    _, flat = port_nlbin(pages)
    assert_equal_but_near_threshold(out, np.asarray(jax_binarize.nlbin_batch(pages)), flat)


@pytest.mark.parametrize('kwargs', [{'range_': 7}, {'range_': 33, 'perc': 50},
                                    {'zoom': 0.33, 'escale': 0.5, 'border': 0.05},
                                    {'threshold': 0.3, 'low': 10, 'high': 80}],
                         ids=['range7', 'range33', 'zoom_escale', 'thresholds'])
def test_nlbin_batch_options_equal_jax(kwargs):
    rng = np.random.RandomState(9)
    pages = np.clip(rng.rand(2, 96, 128) * 0.4 + 0.5, 0, 1)
    pages[0, 30:40, 10:100] = 0.1
    pages[1, 50:58, 20:120] = 0.2
    got, flat = port_nlbin(pages, **kwargs)
    want = np.asarray(jax_binarize.nlbin_batch(pages, **kwargs))
    assert_equal_but_near_threshold(got, want, flat, kwargs.get('threshold', 0.5))


def test_nlbin_device_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        binarize.nlbin_device(np.zeros((8, 8), np.uint8))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        binarize.nlbin_batch(np.zeros((1, 8, 8), np.float32))
