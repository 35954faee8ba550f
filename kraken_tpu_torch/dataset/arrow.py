"""
kraken_tpu_torch.dataset.arrow
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Arrow IPC binary dataset compiler (reference: kraken/lib/arrow_dataset.py),
a copy of the JAX package's ``dataset/arrow.py`` with the same schema and
metadata, so a file either package writes loads in the other:
extracts (optionally polygon-dewarped) line images from XML/path/Segmentation
inputs into PNG-encoded rows of an Arrow file with schema metadata (dataset
type, alphabet counts, splits, legacy_polygons flag). Line extraction is
parallelized over a process pool. ``pyarrow`` is imported only inside
:func:`build_binary_dataset`, ``lxml`` only where XML is read.
"""
import io
import json
import logging
import tempfile
from collections import Counter
from functools import partial
from multiprocessing import Pool
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Literal, Optional, Union

import numpy as np
from PIL import Image, UnidentifiedImageError

from kraken_tpu_torch.containers import Segmentation
from kraken_tpu_torch.exceptions import KrakenInputException
from kraken_tpu_torch.lib.geometry import extract_polygons
from kraken_tpu_torch.lib.util import is_bitonal, make_printable, open_image

if TYPE_CHECKING:
    from os import PathLike

logger = logging.getLogger(__name__)

__all__ = ['build_binary_dataset', 'parse_path']


def parse_path(path: Union[str, 'PathLike'],
               suffix: str = '.gt.txt',
               split=None,
               skip_empty_lines: bool = True) -> dict:
    """Reads an image + transcription file pair."""
    base = Path(path)
    while base.suffixes:
        base = base.with_suffix('')
    gt_path = Path(str(base) + suffix)
    gt = gt_path.read_text(encoding='utf-8').strip('\n\r')
    if not gt and skip_empty_lines:
        raise KrakenInputException(f'Ground truth line has no transcription: {path}.')
    return {'image': path, 'lines': [{'text': gt}]}


def _extract_line(record: Segmentation, skip_empty_lines: bool = True,
                  legacy_polygons: bool = False):
    lines = []
    try:
        im = open_image(record.imagename)
        if is_bitonal(im):
            im = im.convert('1')
    except (OSError, FileNotFoundError, UnidentifiedImageError) as err:
        logger.warning(f'Error loading image {record.imagename}: {err}')
        return lines, None
    # the straight-line extractor's page array, read once for the record's lines
    page_array = np.asarray(im) if im.mode == 'L' else None
    for idx, rec in enumerate(record.lines):
        seg = Segmentation(text_direction='horizontal-lr', imagename=record.imagename,
                           type=record.type, lines=[rec], regions=None,
                           script_detection=False, line_orders=[])
        try:
            line_im, line = next(extract_polygons(im, seg, legacy=legacy_polygons,
                                                  page_array=page_array))
        except (KrakenInputException, ValueError):
            logger.warning(f'Invalid line {idx} in {record.imagename}')
            continue
        except Exception as e:
            logger.warning(f'Unexpected exception {e} from line {idx} in {record.imagename}')
            continue
        if not line.text and skip_empty_lines:
            continue
        fp = io.BytesIO()
        line_im.save(fp, format='png')
        lines.append({'text': line.text, 'im': fp.getvalue(), 'language': line.language})
    return lines, im.mode


def _extract_path_line(record: dict, skip_empty_lines: bool = True):
    try:
        im = open_image(record['image'])
    except (FileNotFoundError, UnidentifiedImageError) as err:
        logger.warning(f'Error loading image {record["image"]}: {err}')
        return [], None
    if not record['lines'][0]['text'] and skip_empty_lines:
        return [], None
    if is_bitonal(im):
        im = im.convert('1')
    fp = io.BytesIO()
    im.save(fp, format='png')
    return [{'text': record['lines'][0]['text'], 'im': fp.getvalue(),
             'language': None}], im.mode


def build_binary_dataset(files=None,
                         output_file: Union[str, 'PathLike'] = None,
                         format_type: Literal['xml', 'alto', 'page', 'path', None] = 'xml',
                         num_workers: int = 0,
                         ignore_splits: bool = True,
                         random_split: Optional[tuple[float, float, float]] = None,
                         linetype: Optional[Literal['baselines', 'bbox']] = None,
                         force_type: Optional[str] = None,
                         recordbatch_size: int = 100,
                         skip_empty_lines: bool = True,
                         callback: Callable[[int, int], None] = lambda chunk, lines: None,
                         legacy_polygons: bool = False) -> None:
    """
    Compiles XML/path/Segmentation inputs into an Arrow IPC recognition
    dataset with per-line PNG images, split masks, and schema metadata.

    Args:
        files: XML file paths, path-pair files, or Segmentation objects.
        output_file: destination path.
        format_type: 'xml'/'alto'/'page'/'path' or None for pre-parsed input.
        num_workers: process-pool workers for line extraction.
        ignore_splits: drop explicit source splits.
        random_split: random (train, val, test) proportions.
        linetype: extract dewarped 'baselines' (default) or 'bbox' crops.
        force_type: override the recorded dataset type.
        recordbatch_size: rows per flushed RecordBatch.
        skip_empty_lines: drop lines without text.
        callback: progress hook (chunk, total).
        legacy_polygons: use the legacy polygon extractor.
    """
    import pyarrow as pa

    extract_fn = partial(_extract_line, skip_empty_lines=skip_empty_lines,
                         legacy_polygons=legacy_polygons)
    parse_fn = None
    effective_linetype = None
    if format_type in ('xml', 'alto', 'page'):
        from kraken_tpu_torch.xml import XMLPage
        effective_linetype = linetype or 'baselines'
        parse_fn = partial(XMLPage, linetype=effective_linetype)
    elif format_type == 'path':
        if not ignore_splits:
            logger.warning('Split serialization is unsupported for path-format input; ignoring splits.')
        parse_fn = partial(parse_path, skip_empty_lines=skip_empty_lines)
        extract_fn = partial(_extract_path_line, skip_empty_lines=skip_empty_lines)
    elif format_type is not None:
        raise ValueError(f'invalid format {format_type} (expected one of xml, alto, page, path)')

    if force_type and force_type not in ('kraken_recognition_baseline', 'kraken_recognition_bbox'):
        raise ValueError(f'Unsupported force_type value {force_type}')

    docs = []
    if parse_fn:
        for doc in files:
            try:
                data = parse_fn(doc)
                if format_type in ('xml', 'alto', 'page'):
                    data = data.to_container()
            except (FileNotFoundError, KrakenInputException, ValueError):
                logger.warning(f'Invalid input file {doc}')
                continue
            imagename = data.imagename if format_type in ('xml', 'alto', 'page') else data['image']
            try:
                with open(imagename, 'rb') as fp:
                    Image.open(fp)
            except (FileNotFoundError, UnidentifiedImageError) as e:
                logger.warning(f'Could not open file {e} in {doc}')
                continue
            docs.append(data)
        logger.info(f'Parsed {len(docs)} files.')
    else:
        docs = list(files)
        logger.info(f'Got {len(docs)} preparsed files.')

    alphabet = Counter()
    num_lines = 0
    for doc in docs:
        lines = doc.lines if format_type != 'path' else doc['lines']
        for line in lines:
            num_lines += 1
            alphabet.update(line.text if format_type != 'path' else line['text'])
    callback(0, num_lines)
    for k, v in sorted(alphabet.items(), key=lambda x: x[1], reverse=True):
        char = make_printable(k)
        if char == k:
            char = '\t' + char
        logger.info(f'{char}\t{v}')

    if format_type == 'path':
        natural_type = 'kraken_recognition_bbox'
    elif format_type in ('xml', 'alto', 'page'):
        natural_type = ('kraken_recognition_baseline' if effective_linetype == 'baselines'
                        else 'kraken_recognition_bbox')
    else:
        natural_type = 'kraken_recognition_baseline'
    if force_type and force_type != natural_type:
        logger.warning(f'Forcing dataset type to {force_type} while the extracted line '
                       f'data is of type {natural_type}.')
    ds_type = force_type or natural_type

    metadata = {'lines': {'type': ds_type,
                          'alphabet': alphabet,
                          'text_type': 'raw',
                          'image_type': 'raw',
                          'splits': ['train', 'eval', 'test'],
                          'im_mode': '1',
                          'legacy_polygons': legacy_polygons,
                          'languages': Counter(),
                          'counts': Counter({'all': 0, 'train': 0,
                                             'validation': 0, 'test': 0})}}

    ty = pa.struct([('text', pa.string()), ('im', pa.binary()),
                    ('language', pa.list_(pa.string()))])
    schema = pa.schema([('lines', ty), ('train', pa.bool_()),
                        ('validation', pa.bool_()), ('test', pa.bool_())])

    def _make_batch(cache):
        for line in cache:
            if line.get('language'):
                metadata['lines']['languages'].update(line['language'])
        ar = pa.array(cache, type=ty)
        if random_split:
            indices = np.random.choice(4, len(cache), p=(0.0,) + tuple(random_split))
        else:
            indices = np.zeros(len(cache))
        masks = [pa.array(indices == i) for i in (1, 2, 3)]
        batch = pa.RecordBatch.from_arrays([ar, *masks], schema=schema)
        return batch, (len(cache), int((indices == 1).sum()),
                       int((indices == 2).sum()), int((indices == 3).sum()))

    def _flush(writer, cache):
        batch, counts = _make_batch(cache)
        metadata['lines']['counts'].update({'all': counts[0], 'train': counts[1],
                                            'validation': counts[2], 'test': counts[3]})
        writer.write(batch)
        callback(len(cache), num_lines)

    cache = []
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp_file = tmp_dir + '/dataset.arrow'
        with pa.OSFile(tmp_file, 'wb') as sink, pa.ipc.new_file(sink, schema) as writer:
            if num_workers and num_workers > 1:
                with Pool(num_workers) as pool:
                    results = pool.imap_unordered(extract_fn, docs)
                    for page_lines, im_mode in results:
                        if page_lines:
                            cache.extend(page_lines)
                            if im_mode and im_mode > metadata['lines']['im_mode']:
                                metadata['lines']['im_mode'] = im_mode
                        if len(cache) >= recordbatch_size:
                            _flush(writer, cache)
                            cache = []
            else:
                for page_lines, im_mode in map(extract_fn, docs):
                    if page_lines:
                        cache.extend(page_lines)
                        if im_mode and im_mode > metadata['lines']['im_mode']:
                            metadata['lines']['im_mode'] = im_mode
                    if len(cache) >= recordbatch_size:
                        _flush(writer, cache)
                        cache = []
            if cache:
                _flush(writer, cache)

        with pa.memory_map(tmp_file, 'rb') as source:
            ds = pa.ipc.open_file(source).read_all()
            metadata['lines']['counts'] = dict(metadata['lines']['counts'])
            metadata['lines'] = json.dumps(metadata['lines'])
            schema = schema.with_metadata(metadata)
            with pa.OSFile(str(output_file), 'wb') as sink, pa.ipc.new_file(sink, schema) as writer:
                writer.write(ds)
