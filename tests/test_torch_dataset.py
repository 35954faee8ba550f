"""
The port's evaluation data and metrics (kraken_tpu_torch.dataset,
.train.metrics, .lib.segmentation_metrics) against the JAX package on the
CPU, on the same inputs:

- metrics: ``levenshtein``, ``CharErrorRate``/``WordErrorRate``,
  ``global_align``/``compute_confusions`` on seeded strings (empty lines,
  right-to-left text and combining marks among them), the multilabel pixel
  metrics on seeded maps and the baseline detection metrics on seeded
  polylines: equal to JAX's (floats bit for bit: the same numpy code);
- collation and loading: ``collate_sequences``, ``bucket_collate`` and the
  threaded ``DataLoader`` give JAX's batches;
- datasets: the path, XML and binary recognition datasets give JAX's
  lines, images (bit for bit) and targets; ``BaselineSet`` gives JAX's
  page tensor, target stack and baselines;
- Arrow: ``build_binary_dataset`` writes JAX's rows and metadata (path and
  XML input), and each package's file loads in the other's
  ``ArrowIPCRecognitionDataset`` with equal rows;
- augmentation: the augmenters replay the JAX augmenters' draws from the
  same seed (both take a seed; their outputs are equal).
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import json
from pathlib import Path

import numpy as np
import pytest

RESOURCES = Path(__file__).resolve().parent / 'resources'
PAGE_XML = RESOURCES / '170025120000003,0074.xml'
MERGE = RESOURCES / 'merge_tests'
PATH_LINES = [MERGE / f'{n}.jpg' for n in ('0006', '0007', '0008', '0021')]
# an alphabet with Latin, Hebrew and Arabic letters, combining marks,
# spaces and digits
ALPHABET = list('abcXYZ 019') + list('אבגש') + \
    list('الم') + ['́', '̈', 'ָ']


def seeded_strings(seed: int, n: int) -> list[str]:
    rng = np.random.RandomState(seed)
    out = ['']
    for _ in range(n - 1):
        out.append(''.join(rng.choice(ALPHABET, rng.randint(0, 25))))
    return out


@pytest.mark.parametrize('seed', range(4))
def test_error_rates_equal_jax(seed):
    from kraken_tpu.train import metrics as jm
    from kraken_tpu_torch.train import metrics as tm
    preds, targets = seeded_strings(seed, 30), seeded_strings(seed + 100, 30)
    ours = [tm.CharErrorRate(), tm.WordErrorRate()]
    theirs = [jm.CharErrorRate(), jm.WordErrorRate()]
    for p, t in zip(preds, targets):
        assert tm.levenshtein(p, t) == jm.levenshtein(p, t)
        assert tm.levenshtein(p.split(), t.split()) == jm.levenshtein(p.split(), t.split())
        for a, b in zip(ours, theirs):
            a.update(p, t)
            b.update(p, t)
    for a, b in zip(ours, theirs):
        assert (a.errors, a.total, a.compute()) == (b.errors, b.total, b.compute())
        a.reset()
        assert a.compute() == 0.0


@pytest.mark.parametrize('seed', range(4))
def test_alignment_and_confusions_equal_jax(seed):
    from kraken_tpu.dataset import utils as ju
    from kraken_tpu_torch.dataset import utils as tu
    for p, t in zip(seeded_strings(seed, 25), seeded_strings(seed + 50, 25)):
        ours, theirs = tu.global_align(t, p), ju.global_align(t, p)
        assert ours == theirs
        assert tu.compute_confusions(*ours[1:]) == ju.compute_confusions(*theirs[1:])


def test_script_attribution_equals_jax():
    from kraken_tpu.dataset import utils as ju
    from kraken_tpu_torch.dataset import utils as tu
    chars = ALPHABET + [chr(c) for c in range(0, 0x3000, 7)] + ['\U0001F600', '￿']
    assert [tu._get_script(c) for c in chars] == [ju._get_script(c) for c in chars]
    tags = [None, {}, {'type': [{'type': 'x'}]}, {'type': [{'type': None}]}, {'other': 1}]
    assert [tu._get_type(t) for t in tags] == [ju._get_type(t) for t in tags]


@pytest.mark.parametrize('seed', range(3))
def test_pixel_metrics_equal_jax(seed):
    from kraken_tpu.train import metrics as jm
    from kraken_tpu_torch.train import metrics as tm
    rng = np.random.RandomState(seed)
    ours = [tm.MultilabelAccuracy(), tm.MultilabelJaccard()]
    theirs = [jm.MultilabelAccuracy(), jm.MultilabelJaccard()]
    for _ in range(3):
        probs = rng.rand(1, 5, 40, 30).astype(np.float32)
        target = (rng.rand(1, 5, 40, 30) > 0.7).astype(np.float32)
        target[:, 4] = 0
        for a, b in zip(ours, theirs):
            a.update(probs, target)
            b.update(probs, target)
    assert [a.compute() for a in ours] == [b.compute() for b in theirs]


def seeded_polylines(rng, n: int) -> list:
    lines = []
    for _ in range(n):
        k = rng.randint(1, 6)
        x = np.sort(rng.rand(k) * 500)
        lines.append(np.stack([x, 100 + rng.rand(k) * 300 + x * 0.05], 1))
    return lines


@pytest.mark.parametrize('seed', range(4))
def test_detection_metrics_equal_jax(seed):
    from kraken_tpu.lib import segmentation_metrics as jm
    from kraken_tpu_torch.lib import segmentation_metrics as tm
    rng = np.random.RandomState(seed)
    pages = []
    for n_pred, n_gt in ((6, 5), (0, 3), (4, 0), (0, 0), (9, 9)):
        pred, gt = seeded_polylines(rng, n_pred), seeded_polylines(rng, n_gt)
        for pl in pred + gt:
            assert np.array_equal(tm.interpolate_polyline(pl), jm.interpolate_polyline(pl))
        pred = [tm.interpolate_polyline(p) for p in pred]
        gt = [tm.interpolate_polyline(g) for g in gt]
        ours = tm.compute_detection_metrics(pred, gt, 25.0)
        assert ours == jm.compute_detection_metrics(pred, gt, 25.0)
        pages.append(ours)
    assert tm.aggregate_detection_metrics(pages) == jm.aggregate_detection_metrics(pages)
    assert tm.aggregate_detection_metrics([]) == jm.aggregate_detection_metrics([])


def seeded_samples(seed: int, n: int, strings: bool) -> list[dict]:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        w = rng.randint(1, 300)
        target = ''.join(rng.choice(ALPHABET, rng.randint(0, 9))) if strings \
            else rng.randint(1, 40, rng.randint(0, 40))
        out.append({'image': rng.rand(1, 12, w).astype(np.float32), 'target': target})
    return out


def assert_same_batch(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize('strings', [False, True])
def test_collation_equals_jax(strings):
    from kraken_tpu.dataset import loader as jl, utils as ju
    from kraken_tpu_torch.dataset import loader as tl, utils as tu
    batch = seeded_samples(7, 9, strings)
    assert_same_batch(tu.collate_sequences(batch), ju.collate_sequences(batch))
    assert_same_batch(tl.bucket_collate(batch), jl.bucket_collate(batch))


@pytest.mark.parametrize('workers, shuffle, drop_last', [(0, False, False), (3, False, False),
                                                         (2, True, True)])
def test_loader_equals_jax(workers, shuffle, drop_last):
    from kraken_tpu.dataset import loader as jl
    from kraken_tpu_torch.dataset import loader as tl
    data = seeded_samples(3, 23, False)
    kwargs = dict(batch_size=5, shuffle=shuffle, drop_last=drop_last, num_workers=workers, seed=4)
    ours = list(tl.DataLoader(data, collate_fn=tl.bucket_collate, **kwargs))
    theirs = list(jl.DataLoader(data, collate_fn=jl.bucket_collate, **kwargs))
    assert len(ours) == len(theirs) == len(tl.DataLoader(data, **kwargs))
    for a, b in zip(ours, theirs):
        assert_same_batch(a, b)


def recognition_datasets(kind: str, jax_items, port_items, spec=(1, 1, 48, 0), pad=16):
    """The same recognition dataset in both packages: filled with each
    package's items (files, lines or pages), encoded with a codec of its
    alphabet and given the transforms of `spec` (batch, channels, height,
    width)."""
    from kraken_tpu import codec as jc
    from kraken_tpu.dataset import recognition as jr, transforms as jt
    from kraken_tpu_torch import codec as tc
    from kraken_tpu_torch.dataset import recognition as tr, transforms as tt
    cls = {'path': 'GroundTruthDataset', 'xml': 'PolygonGTDataset',
           'binary': 'ArrowIPCRecognitionDataset'}[kind]
    out = []
    for rec, trans, codec, items in ((jr, jt, jc, jax_items), (tr, tt, tc, port_items)):
        ds = getattr(rec, cls)()
        for item in items:
            if kind == 'binary':
                ds.add(item)
            elif kind == 'xml':
                ds.add(page=item)
            else:
                ds.add(line=item)
        batch, channels, height, width = spec
        ds.transforms = trans.ImageInputTransforms(batch, height, width, channels, (pad, 0),
                                                   valid_norm=kind != 'xml')
        ds.encode(codec.Codec(''.join(sorted(ds.alphabet))))
        out.append(ds)
    return out


def assert_same_dataset(jax_ds, port_ds, step=1):
    """Equal lengths, alphabets, codecs, im modes, and line tensors (bit
    for bit) and targets at every `step`-th line."""
    assert len(jax_ds) == len(port_ds) > 0
    assert dict(jax_ds.alphabet) == dict(port_ds.alphabet)
    assert jax_ds.codec.c2l == port_ds.codec.c2l
    for i in range(0, len(jax_ds), step):
        a, b = jax_ds[i], port_ds[i]
        assert a['image'].dtype == b['image'].dtype and np.array_equal(a['image'], b['image']), i
        assert np.array_equal(a['target'], b['target']), i
    assert not jax_ds.failed_samples and not port_ds.failed_samples
    assert jax_ds.im_mode == port_ds.im_mode


def test_path_dataset_equals_jax():
    from kraken_tpu.lib.util import parse_gt_path as jax_parse
    from kraken_tpu_torch.lib.util import parse_gt_path
    ours, theirs = [parse_gt_path(p) for p in PATH_LINES], [jax_parse(p) for p in PATH_LINES]
    for a, b in zip(ours, theirs):
        assert (a.id, a.bbox, a.text, a.imagename, a.text_direction) == \
            (b.id, b.bbox, b.text, b.imagename, b.text_direction)
    assert_same_dataset(*recognition_datasets('path', theirs, ours))


@pytest.fixture(scope='module')
def xml_pages():
    from kraken_tpu.xml import XMLPage as JaxXMLPage
    from kraken_tpu_torch.xml import XMLPage
    return JaxXMLPage(PAGE_XML).to_container(), XMLPage(PAGE_XML).to_container()


def test_threaded_loader_dewarps_each_line_by_its_own_centerline(xml_pages):
    """The loader's threads share the dataset's transforms, and with them one
    CenterNormalizer; each line is measured into a copy of it, so 4 threads
    give the batches of none and substitute no sample (sharing the measured
    centerline, a line was dewarped by another line's or failed, and the
    dataset put a random line in its place)."""
    import itertools
    from kraken_tpu_torch import codec as tc
    from kraken_tpu_torch.dataset import recognition as tr, transforms as tt
    from kraken_tpu_torch.dataset.loader import DataLoader, bucket_collate
    batches = []
    for workers in (4, 0):
        ds = tr.PolygonGTDataset()
        ds.add(page=xml_pages[1])
        ds.transforms = tt.ImageInputTransforms(1, 48, 0, 1, (16, 0), valid_norm=True)
        ds.encode(tc.Codec(''.join(sorted(ds.alphabet))))
        loader = DataLoader(ds, batch_size=8, collate_fn=bucket_collate, num_workers=workers)
        batches.append(list(itertools.islice(iter(loader), 3)))
        assert not ds.failed_samples
    for a, b in zip(*batches):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_xml_dataset_equals_jax(xml_pages):
    """The fixture page's 44 transcribed lines, dewarped: the same texts, the same
    line tensors and targets."""
    jax_ds, port_ds = recognition_datasets('xml', [xml_pages[0]], [xml_pages[1]])
    assert port_ds._gt == jax_ds._gt and len(port_ds) == 44  # two lines have no text
    assert_same_dataset(jax_ds, port_ds)


@pytest.mark.parametrize('arrow', ['base.arrow', 'merger.arrow'])
def test_binary_dataset_equals_jax(arrow):
    jax_ds, port_ds = recognition_datasets('binary', [MERGE / arrow], [MERGE / arrow])
    assert jax_ds.seg_type == port_ds.seg_type
    assert jax_ds.legacy_polygons_status == port_ds.legacy_polygons_status
    assert_same_dataset(jax_ds, port_ds)


def arrow_rows(path) -> tuple[dict, list]:
    import pyarrow as pa
    with pa.memory_map(str(path), 'rb') as source:
        table = pa.ipc.open_file(source).read_all()
    meta = json.loads(table.schema.metadata[b'lines'])
    return meta, table.to_pylist()


@pytest.mark.parametrize('fmt', ['xml', 'path'])
def test_compiled_arrow_equals_jax(fmt, tmp_path):
    """The port's ``build_binary_dataset`` writes the JAX compiler's rows
    (texts, PNG bytes, split columns) and metadata; each file loads in the
    other package's dataset with equal lines and targets."""
    from kraken_tpu.dataset.arrow import build_binary_dataset as jax_build
    from kraken_tpu_torch.dataset.arrow import build_binary_dataset
    files = [PAGE_XML] if fmt == 'xml' else PATH_LINES
    build_binary_dataset(files=[str(f) for f in files], output_file=tmp_path / 'port.arrow',
                         format_type=fmt)
    jax_build(files=[str(f) for f in files], output_file=tmp_path / 'jax.arrow', format_type=fmt)
    assert arrow_rows(tmp_path / 'port.arrow') == arrow_rows(tmp_path / 'jax.arrow')
    assert len(arrow_rows(tmp_path / 'port.arrow')[1]) == (44 if fmt == 'xml' else 4)
    for ours, theirs in (('port.arrow', 'jax.arrow'), ('jax.arrow', 'port.arrow')):
        assert_same_dataset(*recognition_datasets('binary', [tmp_path / ours],
                                                  [tmp_path / theirs]), step=5)


def test_random_split_metadata_equals_jax(tmp_path):
    from kraken_tpu.dataset.arrow import build_binary_dataset as jax_build
    from kraken_tpu_torch.dataset.arrow import build_binary_dataset
    for name, build in (('port', build_binary_dataset), ('jax', jax_build)):
        np.random.seed(5)
        build(files=[str(f) for f in PATH_LINES * 3], output_file=tmp_path / f'{name}.arrow',
              format_type='path', random_split=(0.5, 0.25, 0.25))
    assert arrow_rows(tmp_path / 'port.arrow') == arrow_rows(tmp_path / 'jax.arrow')


def test_baselineset_equals_jax(xml_pages):
    from kraken_tpu.dataset import transforms as jt
    from kraken_tpu.dataset.segmentation import BaselineSet as JaxSet
    from kraken_tpu_torch.dataset import transforms as tt
    from kraken_tpu_torch.dataset.segmentation import BaselineSet
    cm = {'aux': {'_start_separator': 0, '_end_separator': 1},
          'baselines': {'$pac': 2, '$par': 3, '$tip': 4},
          'regions': {'$pac': 5, '$tip': 6, 'text': 7}}
    out = []
    for cls, trans, page in ((JaxSet, jt, xml_pages[0]), (BaselineSet, tt, xml_pages[1])):
        ds = cls(class_mapping=cm, padding=(3, 5))
        ds.add(page)
        ds.transforms = trans.ImageInputTransforms(1, 256, 0, 3, 0, valid_norm=False)
        out.append(ds)
    a, b = out[0][0], out[1][0]
    assert np.array_equal(a['image'], b['image']) and np.array_equal(a['target'], b['target'])
    assert a['baselines'] == b['baselines']
    assert {k: dict(v) for k, v in out[0].class_stats.items()} == \
        {k: dict(v) for k, v in out[1].class_stats.items()}
    assert out[0].num_classes == out[1].num_classes
    assert out[0].canonical_class_mapping == out[1].canonical_class_mapping
    assert out[0].merged_classes == out[1].merged_classes


@pytest.mark.parametrize('seed', range(3))
def test_augmenters_replay_jax_draws(seed):
    from kraken_tpu.dataset import augmentation as ja
    from kraken_tpu_torch.dataset import augmentation as ta
    rng = np.random.RandomState(seed)
    line_ours, line_theirs = ta.DefaultAugmenter(seed), ja.DefaultAugmenter(seed)
    page_ours, page_theirs = ta.SegmentationAugmenter(seed), ja.SegmentationAugmenter(seed)
    for _ in range(12):
        im = rng.rand(1, 32, 90).astype(np.float32)
        assert np.array_equal(line_ours(im), line_theirs(im))
        page, target = rng.rand(3, 40, 30).astype(np.float32), rng.rand(4, 40, 30) > 0.8
        for x, y in zip(page_ours(page, target), page_theirs(page, target)):
            assert np.array_equal(x, y)
