"""
The port's page pipeline (kraken_tpu_torch.pipeline.process_pages) against
the JAX package's on the CPU, with the same models: the shipped BLLA
segmenter and the overfit baseline recognizer, on two pages.

- Records are equal to JAX's (predictions, cuts, lines; confidences within
  1e-5) through the streaming branch, through ``stream_batches=False`` and
  with ``seg_batch=2`` and ``segmentation_pred_batch``.
- A prepared model takes the streaming branch (``recognition_stream``, which
  a spy counts); ``stream_batches=False`` and a model without the port's
  prepared state take the page-at-a-time branch.
- A page whose segmenter raises is skipped, or raises with
  ``raise_on_error``.
"""
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import kraken_tpu_torch.inference.recognition as torch_recognition

RESOURCES = Path(__file__).resolve().parent / 'resources'
PAGE = RESOURCES / '170025120000003,0074.jpg'
REC = RESOURCES / 'overfit_bl.safetensors'
SEG = RESOURCES / 'blla_small.safetensors'


def pages() -> list:
    """Two pages: the fixture page at half size and its top 60%."""
    with Image.open(PAGE) as im:
        half = im.resize((im.width // 2, im.height // 2))
    half.load()
    return [half, half.crop((0, 0, half.width, int(half.height * 0.6)))]


def jax_models():
    from kraken_tpu.configs import RecognitionInferenceConfig, SegmentationInferenceConfig
    from kraken_tpu.inference.segmentation import prepare_segmentation
    from kraken_tpu.models import load_models
    seg = load_models(SEG)[0]
    prepare_segmentation(seg, SegmentationInferenceConfig())
    rec = load_models(REC)[0]
    rec.prepare_for_inference(RecognitionInferenceConfig(batch_size=8, num_line_workers=0))
    return seg, rec


def torch_models():
    from kraken_tpu_torch.configs import RecognitionInferenceConfig, SegmentationInferenceConfig
    from kraken_tpu_torch.models import load_models
    seg = load_models(SEG)[0]
    seg.prepare_for_inference(SegmentationInferenceConfig(device='cpu'))
    rec = load_models(REC)[0]
    rec.prepare_for_inference(RecognitionInferenceConfig(batch_size=8, num_line_workers=0,
                                                         device='cpu'))
    return seg, rec


def run(package: str, **kwargs) -> list:
    """process_pages of one package on the two pages, as (segmentation,
    records) pairs."""
    if package == 'jax':
        from kraken_tpu.inference.segmentation import segmentation_pred, segmentation_pred_batch
        from kraken_tpu.pipeline import process_pages
        seg, rec = jax_models()
    else:
        from kraken_tpu_torch.inference.segmentation import (segmentation_pred,
                                                             segmentation_pred_batch)
        from kraken_tpu_torch.pipeline import process_pages
        seg, rec = torch_models()
    if kwargs.pop('batched', False):
        kwargs.update(segmenter_batch=lambda ps: segmentation_pred_batch(seg, ps), seg_batch=2)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        out = list(process_pages(pages(), rec, lambda im: segmentation_pred(seg, im), **kwargs))
    return [(s, records) for _, s, records in out]


def assert_same_pages(port: list, jax: list) -> None:
    assert len(port) == len(jax) == 2
    for (tseg, trecs), (jseg, jrecs) in zip(port, jax):
        assert len(trecs) == len(jrecs) == len(jseg.lines) > 5
        assert [line.baseline for line in tseg.lines] == [line.baseline for line in jseg.lines]
        for a, b in zip(trecs, jrecs):
            assert a.prediction == b.prediction
            assert a.cuts == b.cuts
            np.testing.assert_allclose(a.confidences, b.confidences, atol=1e-5)


@pytest.fixture
def stream_spy(monkeypatch):
    """Counts the calls of the port's recognition_stream."""
    calls = []
    original = torch_recognition.recognition_stream

    def spy(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)
    monkeypatch.setattr(torch_recognition, 'recognition_stream', spy)
    return calls


@pytest.fixture(scope='module')
def jax_pages():
    return {'stream': run('jax'), 'batched': run('jax', batched=True)}


def test_streaming_branch_equals_jax(jax_pages, stream_spy):
    assert_same_pages(run('torch'), jax_pages['stream'])
    assert stream_spy == [1]


def test_page_at_a_time_equals_jax(jax_pages, stream_spy):
    assert_same_pages(run('torch', stream_batches=False), jax_pages['stream'])
    assert stream_spy == []


def test_batched_segmentation_equals_jax(jax_pages, stream_spy):
    assert_same_pages(run('torch', batched=True), jax_pages['batched'])
    assert stream_spy == [1]


def test_a_model_not_prepared_goes_page_at_a_time(stream_spy):
    from kraken_tpu_torch.containers import BaselineLine, Segmentation
    from kraken_tpu_torch.pipeline import process_pages

    class PageModel:
        def predict(self, im, seg):
            return [line.id for line in seg.lines]

    seg = Segmentation(type='baselines', imagename='x.png', text_direction='horizontal-lr',
                       script_detection=False,
                       lines=[BaselineLine(id='a', baseline=[[0, 5], [9, 5]],
                                           boundary=[[0, 0], [9, 0], [9, 9], [0, 9]])])
    out = list(process_pages(['p0', 'p1', 'p2'], PageModel(), lambda im: seg))
    assert [(im, records) for im, _, records in out] == [('p0', ['a']), ('p1', ['a']),
                                                        ('p2', ['a'])]
    assert stream_spy == []


@pytest.mark.parametrize('stream_batches', [True, False])
def test_a_failing_segmenter_skips_or_raises(stream_batches):
    from kraken_tpu_torch.inference.segmentation import segmentation_pred
    from kraken_tpu_torch.pipeline import process_pages
    seg, rec = torch_models()
    ims = pages()

    def segmenter(im):
        if im is ims[0]:
            raise RuntimeError('boom')
        return segmentation_pred(seg, im)

    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        out = list(process_pages(ims, rec, segmenter, stream_batches=stream_batches))
        assert [im for im, _, _ in out] == [ims[1]]
        with pytest.raises(RuntimeError, match='boom'):
            list(process_pages(ims, rec, segmenter, raise_on_error=True,
                               stream_batches=stream_batches))
