"""
Recognition end to end through the port (kraken_tpu_torch) on the CPU: the
golden records of the overfit model through rpred, mm_rpred and the batched
engine, the port's safetensors reader, and records equal to the JAX
engine's on the same lines and weights.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import warnings
from collections import defaultdict

import jax
import numpy as np
import pytest
from PIL import Image

from kraken_tpu.configs import RecognitionInferenceConfig as JaxConfig
from kraken_tpu.containers import BaselineLine as JaxBaselineLine
from kraken_tpu.containers import Segmentation as JaxSegmentation
from kraken_tpu.inference.recognition import width_bucket as jax_width_bucket
from kraken_tpu.models import load_models as jax_load_models
from kraken_tpu.vgsl import VGSLModel as JaxVGSLModel
from kraken_tpu_torch.codec import Codec
from kraken_tpu_torch.configs import RecognitionInferenceConfig
from kraken_tpu_torch.containers import BaselineLine, BBoxLine, Segmentation
from kraken_tpu_torch.inference.recognition import width_bucket
from kraken_tpu_torch.lib.models import load_any
from kraken_tpu_torch.models import load_models
from kraken_tpu_torch.models._safetensors import read_safetensors
from kraken_tpu_torch.rpred import mm_rpred, rpred
from kraken_tpu_torch.tasks import RecognitionTaskModel
from kraken_tpu_torch.vgsl import VGSLModel

BBOX_GOLD = 'ܡ ܘܡ ܗ ܡܕܐ ܐ ܐܐ ܡ ܗܗܐܐܐܕ'
BL_GOLD = '.ܗ ܣܗܐ  ܕ ܣ   ܗ ܕܗܗ ܟܕܗܣ    ܠ  ܐ .ܣܕܐܣ. ܗ '
BL_GOLD_NOBIDI = 'ܕܗ .ܣܐܗܗ.ܐ ܗܣ ܕ   ܗܣ ܗ.ܗܝܣܗ ܣ ܗܢ ܪܗܗܕ ܐ   ܗܠ'
# line ends of a multi-line baseline segmentation of 000236.png
LINE_ENDS = (2543, 1800, 1200, 900, 2543)


@pytest.fixture(scope='module', autouse=True)
def quiet():
    warnings.filterwarnings('ignore', category=DeprecationWarning)
    warnings.filterwarnings('ignore', category=UserWarning)


@pytest.fixture(scope='module')
def line_im(resources):
    return Image.open(resources / '000236.png')


@pytest.fixture(scope='module')
def recognizer(resources):
    return load_any(resources / 'overfit.mlmodel', device='cpu')


@pytest.fixture
def box_seg(resources):
    return Segmentation(type='bbox', imagename=resources / 'bw.png',
                        text_direction='horizontal-lr', script_detection=False,
                        lines=[BBoxLine(id='foo', bbox=[0, 0, 2544, 156])])


def _bl_seg(resources, ends=(2543,), seg_cls=Segmentation, line_cls=BaselineLine):
    return seg_cls(type='baselines', imagename=resources / 'bw.png',
                   text_direction='horizontal-lr', script_detection=False,
                   lines=[line_cls(id=f'l{i}', baseline=[[0, 10], [x1, 10]],
                                   boundary=[[0, 0], [x1, 0], [x1, 155], [0, 155]])
                          for i, x1 in enumerate(ends)])


@pytest.fixture
def bl_seg(resources):
    return _bl_seg(resources)


def _config(**kwargs):
    return RecognitionInferenceConfig(device='cpu', **kwargs)


# the goldens were made with pad=True (1 px), the no-BiDi one with the default
@pytest.mark.parametrize('seg, gold, pad, bidi', [('box', BBOX_GOLD, True, True),
                                                  ('bl', BL_GOLD, True, True),
                                                  ('bl', BL_GOLD_NOBIDI, 16, False)])
def test_rpred_goldens(recognizer, line_im, box_seg, bl_seg, seg, gold, pad, bidi):
    record = next(rpred(recognizer, line_im, box_seg if seg == 'box' else bl_seg, pad,
                        bidi_reordering=bidi))
    assert record.prediction == gold


def test_mm_rpred_tags(recognizer, line_im, resources):
    seg = Segmentation(type='bbox', imagename=resources / 'bw.png',
                       text_direction='horizontal-lr', script_detection=True,
                       lines=[BBoxLine(id='foo', bbox=[0, 0, 2544, 156],
                                       tags={'type': [{'type': 'foobar'}]}),
                              BBoxLine(id='bar', bbox=[0, 0, 2544, 156],
                                       tags={'type': [{'type': 'default'}]})])
    pred = mm_rpred({'default': recognizer}, line_im, seg, True, tags_ignore=['foobar'])
    assert [r.prediction for r in pred] == ['', BBOX_GOLD]
    pred = mm_rpred(defaultdict(lambda: recognizer), line_im, seg, True)
    assert [r.prediction for r in pred] == [BBOX_GOLD, BBOX_GOLD]


@pytest.mark.parametrize('kind', ['bbox', 'baselines', 'multiline'])
def test_batched_engine_goldens(resources, line_im, box_seg, kind):
    vmodel = load_models(resources / 'overfit.mlmodel')[0]
    vmodel.prepare_for_inference(_config(batch_size=3, num_line_workers=2, padding=1))
    if kind == 'bbox':
        seg, gold = box_seg, [BBOX_GOLD]
    else:
        n = 1 if kind == 'baselines' else 3
        seg, gold = _bl_seg(resources, (2543,) * n), [BL_GOLD] * n
    assert [r.prediction for r in vmodel.predict(line_im, seg)] == gold


def test_task_model_goldens(resources, line_im, box_seg):
    task = RecognitionTaskModel.load_model(resources / 'overfit.mlmodel')
    records = list(task.predict(line_im, box_seg, _config(batch_size=2, padding=1)))
    assert [r.prediction for r in records] == [BBOX_GOLD]


def test_safetensors_reader_matches_package(resources):
    from safetensors import safe_open
    from safetensors.numpy import load_file
    path = resources / 'overfit_bl_newpoly.safetensors'
    metadata, tensors = read_safetensors(path)
    with safe_open(path, framework='np') as f:
        assert metadata == f.metadata()
    expected = load_file(path)
    assert set(tensors) == set(expected)
    for k, v in expected.items():
        assert tensors[k].dtype == v.dtype and np.array_equal(tensors[k], v), k


def _records_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.prediction == b.prediction
        assert a.cuts == b.cuts
        np.testing.assert_allclose(a.confidences, b.confidences, atol=1e-5)


def test_safetensors_model_matches_jax_engine(resources, line_im):
    path = resources / 'overfit_bl_newpoly.safetensors'
    vmodel = load_models(path)[0]
    jmodel = jax_load_models(path)[0]
    assert len(vmodel.codec.c2l) == len(jmodel.codec.c2l)
    vmodel.prepare_for_inference(_config(batch_size=4, num_line_workers=0))
    jmodel.prepare_for_inference(JaxConfig(batch_size=4, num_line_workers=0, device='cpu'))
    ours = list(vmodel.predict(line_im, _bl_seg(resources, LINE_ENDS)))
    theirs = list(jmodel.predict(line_im, _bl_seg(resources, LINE_ENDS, JaxSegmentation,
                                                  JaxBaselineLine)))
    _records_equal(ours, theirs)


def test_lstm_engine_matches_jax_engine(resources, line_im):
    """A reduced LSTM recognizer with shared random weights gives the JAX
    engine's records on a multi-line baseline segmentation: same batches
    (bucketed widths, padded counts), same predictions and cuts."""
    spec = '[1,48,0,1 Cr3,13,8 Mp2,2 Cr3,9,16 Mp2,2 S1(1x0)1,3 Lbx16 Lbx16 O1c20]'
    charset = 'ܐܒܓܕܗܘܙܚܛܝܟܠܡܢܣܥܦܨܩ'
    jmodel = JaxVGSLModel(vgsl=spec, rng=jax.random.PRNGKey(3))
    vmodel = VGSLModel(spec, codec=Codec(charset[:19]))
    vmodel.from_jax_state_dict(jmodel.state_dict())
    from kraken_tpu.codec import Codec as JaxCodec
    jmodel.add_codec(JaxCodec(charset[:19]))
    for m in (jmodel, vmodel):
        m.model_type = ['recognition']
        m.seg_type = 'baselines'
        m.use_legacy_polygons = False
    vmodel.prepare_for_inference(_config(batch_size=4, num_line_workers=0))
    jmodel.prepare_for_inference(JaxConfig(batch_size=4, num_line_workers=0, device='cpu'))
    ours = list(vmodel.predict(line_im, _bl_seg(resources, LINE_ENDS)))
    theirs = list(jmodel.predict(line_im, _bl_seg(resources, LINE_ENDS, JaxSegmentation,
                                                  JaxBaselineLine)))
    assert sum(len(r.prediction) for r in ours) > 0
    _records_equal(ours, theirs)


def test_width_bucket_matches_jax():
    for w in range(1, 6000, 13):
        assert width_bucket(w) == jax_width_bucket(w)


def test_recognition_stream_matches_per_page(resources, line_im):
    """Cross-page streaming gives the per-page engine's records, with line
    batches spanning page boundaries."""
    from kraken_tpu_torch.inference.recognition import recognition_stream
    vmodel = load_models(resources / 'overfit_bl_newpoly.safetensors')[0]
    vmodel.prepare_for_inference(_config(batch_size=4, num_line_workers=0))
    pages = [(line_im, _bl_seg(resources, LINE_ENDS[:n])) for n in (3, 5, 2)]
    ref = [list(vmodel.predict(im, seg)) for im, seg in pages]
    out = list(recognition_stream(vmodel, pages))
    assert [seg for _, seg, _ in out] == [seg for _, seg in pages]
    for (_, _, records), ref_records in zip(out, ref):
        assert [r.prediction for r in records] == [r.prediction for r in ref_records]
        assert [r.cuts for r in records] == [r.cuts for r in ref_records]
        for a, b in zip(records, ref_records):
            np.testing.assert_allclose(a.confidences, b.confidences, atol=1e-5)


@pytest.mark.parametrize('fname', ['overfit.mlmodel', 'overfit_newpoly.mlmodel',
                                   'model_small.safetensors', 'model_small_fp16.safetensors',
                                   'model_small_mixed.safetensors', 'overfit_bl.safetensors'])
def test_loaders_match_jax_on_fixtures(resources, fname):
    """The port's loaders (its own safetensors reader, the CoreML reader
    walking its modules) give the JAX loaders' weights and metadata."""
    ours, theirs = load_models(resources / fname), jax_load_models(resources / fname)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.spec == b.spec and a.model_type == b.model_type and a.seg_type == b.seg_type
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        for k in sb:
            assert np.array_equal(sa[k].numpy(), sb[k]), k


@pytest.mark.parametrize('fmt', ['safetensors', 'coreml'])
def test_loaders_match_jax_on_lstm_models(tmp_path, fmt):
    """LSTM weights (bidirectional, unidirectional, y-axis) through both file
    formats, as written by the JAX package's writers."""
    from kraken_tpu.codec import Codec as JaxCodec
    from kraken_tpu.models import write_models
    spec = '[1,16,0,1 Cr3,3,4 Lbys3 S1(1x0)1,3 Lbx5 Lfx4 O1c6]'
    jmodel = JaxVGSLModel(vgsl=spec, rng=jax.random.PRNGKey(5), codec=JaxCodec('abcde'))
    jmodel.model_type = ['recognition']
    path = tmp_path / f'lstm.{fmt}'
    write_models([jmodel], path, format=fmt)
    (ours,), (theirs,) = load_models(path), jax_load_models(path)
    sa, sb = ours.state_dict(), theirs.state_dict()
    assert set(sa) == set(sb) and any('_reverse' in k for k in sb)
    for k in sb:
        np.testing.assert_array_equal(sa[k].numpy(), sb[k], err_msg=k)
    assert ours.codec.c2l == theirs.codec.c2l
