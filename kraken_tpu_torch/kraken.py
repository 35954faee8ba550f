"""
kraken_tpu_torch.kraken
~~~~~~~~~~~~~~~~~~~~~~~

Command line driver for inference, the counterpart of the JAX package's
``kraken.py``: a chainable ``binarize segment ocr`` pipeline over
input/output file pairs, glob batches or the pages of PDF files, with
ALTO/PageXML/hOCR/abbyyXML serialization (reference: kraken/kraken.py). Run
it as ``python -m kraken_tpu_torch.kraken`` or as the ``kraken-torch``
script.

It runs on the card: ``--device`` defaults to ``cuda`` and a run without a
card stops with a usage error unless it asks for ``--device cpu``
(``binarize`` on the host, its default, needs no card but the check is the
same for every run). ``ocr --transfer bytes`` uploads line batches as a
dense byte atlas (``input_transfer='packed'``); ``segment --transfer
bytes`` uploads the page as bytes and lets a one-off upload probe pick the
heatmap download (``input_transfer='uint8'``, ``heatmap_precision=
'auto'``), and ``segment --device-vectorize`` carves a page's seams in one
launch on the card. ``segment --devices N`` and ``ocr --devices N`` shard
page and line batches over N cards in one process (``cuda:0`` to
``cuda:N-1``; N CPU shards with ``--device cpu``). ``show`` prints a local
model file's metadata or fetches a record of the model repository;
``list`` and ``get`` list and download its models. The three repository
paths go through the optional ``htrmopo`` package (``repo.py``) and exit 1
with its message when it is missing.
"""
import dataclasses
import logging
import os
import uuid
import warnings
from functools import partial
from pathlib import Path
from typing import Any, Callable, IO, cast

import click

from kraken_tpu_torch import __version__
from kraken_tpu_torch.lib import log
from kraken_tpu_torch.lib.util import default_segmentation_model

warnings.simplefilter('ignore', UserWarning)
logging.captureWarnings(True)
logger = logging.getLogger('kraken')

SEGMENTATION_DEFAULT_MODEL = default_segmentation_model()


def message(msg: str, **styles) -> None:
    if logger.getEffectiveLevel() >= 30:
        click.secho(msg, **styles)


def get_input_parser(type_str: str) -> Callable[[str], dict[str, Any]]:
    from kraken_tpu_torch.xml import XMLPage
    if type_str in ('alto', 'page', 'xml'):
        return partial(XMLPage, filetype=type_str)
    raise ValueError(f'Unknown input parser {type_str}')


# ------------------------------------------------------------ stage drivers
def binarizer(threshold, zoom, escale, border, perc, range, low, high, accel,
              input, output) -> None:
    import numpy as np
    from PIL import Image
    from kraken_tpu_torch.binarization import nlbin

    ctx = click.get_current_context()
    if ctx.meta['first_process']:
        if ctx.meta['input_format_type'] != 'image':
            input = get_input_parser(ctx.meta['input_format_type'])(input).imagename
        ctx.meta['first_process'] = False
    else:
        raise click.UsageError('binarize must be the first stage of the pipeline.')
    try:
        im = Image.open(input)
        if accel == 'device':
            from kraken_tpu_torch.ops.binarize import nlbin_device
            bw = nlbin_device(np.asarray(im.convert('L')), threshold, zoom, escale, border,
                              perc, range, low, high, device=ctx.meta['device'])
            res = Image.fromarray(bw.cpu().numpy().astype(np.uint8) * 255).convert('1')
        else:
            res = nlbin(im, threshold, zoom, escale, border, perc, range, low, high)
        form = None
        ext = os.path.splitext(output)[1]
        if ext in ('.jpg', '.jpeg', '.JPG', '.JPEG', ''):
            form = 'png'
            if ext:
                logger.warning('JPEG cannot store 1bpp output; writing PNG instead.')
        res.save(f'{output}', format=form)
        ctx.meta['base_image'] = output
    except Exception:
        if ctx.meta['raise_failed']:
            raise
        message('✗', fg='red')
        ctx.exit(1)
    message('✓', fg='green')


def segmenter(legacy, model, config, input, output) -> None:
    import json
    from PIL import Image

    ctx = click.get_current_context()
    if ctx.meta['first_process']:
        if ctx.meta['input_format_type'] != 'image':
            input = get_input_parser(ctx.meta['input_format_type'])(input).imagename
        ctx.meta['first_process'] = False
    if 'base_image' not in ctx.meta:
        ctx.meta['base_image'] = input
    try:
        im = Image.open(input)
    except IOError as e:
        raise click.BadParameter(str(e))
    message(f'Segmenting\t{input}\t', nl=False)
    try:
        if legacy:
            from kraken_tpu_torch.pageseg import segment as legacy_segment
            res = legacy_segment(im,
                                 text_direction=config.text_direction,
                                 scale=config.legacy_scale,
                                 maxcolseps=config.legacy_maxcolseps,
                                 black_colseps=config.legacy_black_colseps,
                                 no_hlines=config.legacy_no_hlines,
                                 pad=config.bbox_line_padding,
                                 reading_order_fn=config.bbox_ro_fn)
        else:
            res = model.predict(im=im, config=config)
    except Exception:
        if ctx.meta['raise_failed']:
            raise
        message('✗', fg='red')
        ctx.exit(1)
    with click.open_file(output, 'w', encoding='utf-8') as fp:
        fp = cast('IO[Any]', fp)
        json.dump(dataclasses.asdict(res), fp, default=str)
    message('✓', fg='green')


def recognizer(model, no_segmentation, config, linetype, input, output) -> None:
    import json
    from PIL import Image
    from kraken_tpu_torch.containers import BBoxLine, Segmentation

    ctx = click.get_current_context()
    bounds = None
    if 'base_image' not in ctx.meta:
        ctx.meta['base_image'] = input
    if ctx.meta['first_process']:
        if ctx.meta['input_format_type'] != 'image' and not no_segmentation:
            doc = get_input_parser(ctx.meta['input_format_type'])(
                input, linetype=linetype or 'baselines')
            ctx.meta['base_image'] = doc.imagename
            bounds = doc.to_container()
    try:
        im = Image.open(ctx.meta['base_image'])
    except IOError as e:
        raise click.BadParameter(str(e))
    if not bounds and ctx.meta['base_image'] != input:
        with click.open_file(input, 'r') as fp:
            try:
                fp = cast('IO[Any]', fp)
                bounds = Segmentation(**json.load(fp))
            except ValueError as e:
                raise click.UsageError(f'{input} invalid segmentation: {e}')
    elif not bounds:
        if no_segmentation:
            bounds = Segmentation(type='bbox',
                                  text_direction='horizontal-lr',
                                  imagename=ctx.meta['base_image'],
                                  script_detection=False,
                                  regions={},
                                  lines=[BBoxLine(id=f'_{uuid.uuid4()}',
                                                  bbox=(0, 0, *im.size))])
        else:
            raise click.UsageError('No OCR script segmentation given. '
                                   'Add one with the input or run `segment` first.')
    elif no_segmentation:
        logger.warning('--no-segmentation given but the input already carries '
                       'a segmentation; ignoring the flag.')
    message(f'Processing\t{input}\t', nl=False)
    try:
        records = list(model.predict(im=im, segmentation=bounds, config=config))
    except Exception:
        if ctx.meta['raise_failed']:
            raise
        message('✗', fg='red')
        ctx.exit(1)
    results = dataclasses.replace(bounds, lines=records, imagename=ctx.meta['base_image'])

    ctx.meta['steps'].append({'category': 'processing',
                              'description': 'Text line recognition',
                              'settings': {'text_direction': config.text_direction,
                                           'models': str(getattr(model, 'net', model)),
                                           'pad': config.padding,
                                           'bidi_reordering': config.bidi_reordering}})
    if ctx.meta['output_mode'] != 'native':
        # lxml is imported here only: native text needs none of it
        from kraken_tpu_torch import serialization
        from kraken_tpu_torch.containers import ProcessingStep
        with click.open_file(output, 'w', encoding='utf-8') as fp:
            fp = cast('IO[Any]', fp)
            steps = [ProcessingStep(id=f'_{i}', **step)
                     for i, step in enumerate(ctx.meta['steps'])]
            fp.write(serialization.serialize(
                results,
                image_size=im.size,
                writing_mode=ctx.meta['text_direction'],
                scripts=None,
                template=ctx.meta['output_mode'] if ctx.meta['output_mode'] != 'hocr' else 'hocr',
                template_source='custom' if ctx.meta['output_template'] else 'native',
                processing_steps=steps,
                sub_line_segmentation=ctx.meta['subline_segmentation']))
    else:
        with click.open_file(output, 'w', encoding='utf-8') as fp:
            fp = cast('IO[Any]', fp)
            for record in records:
                fp.write(record.prediction + '\n')
    message('✓', fg='green')


def _resolve_device(device: str) -> str:
    """The torch device a run asks for; a CUDA device without a card is a
    usage error, since the port never falls back to the CPU."""
    import torch
    try:
        dev = torch.device(device)
    except RuntimeError as e:
        raise click.BadParameter(f'{device!r} is not a torch device ({e}); '
                                 'use cuda, cuda:N or cpu', param_hint='--device')
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise click.UsageError(f'--device {device} asks for a CUDA card and none is available; '
                               'pass --device cpu to run on the CPU.')
    return device


# ------------------------------------------------------------------- group
@click.group(chain=True, context_settings=dict(show_default=True,
                                               help_option_names=['--help']))
@click.version_option(version=__version__, prog_name='kraken')
@click.option('-i', '--input', type=(click.Path(exists=True, dir_okay=False, path_type=Path),
                                     click.Path(writable=True, dir_okay=False, path_type=Path)),
              multiple=True, help='Input-output file pairs.')
@click.option('-I', '--batch-input', multiple=True,
              help='Glob expression to add multiple files at once.')
@click.option('-o', '--suffix', default='',
              help='Suffix for output files from batch and PDF inputs.')
@click.option('-v', '--verbose', default=0, count=True)
@click.option('-f', '--format-type', type=click.Choice(['image', 'alto', 'page', 'pdf', 'xml']),
              default='image', help='Sets the default input type.')
@click.option('-p', '--pdf-format', default='{src}_{idx:06d}',
              help='Format for output of PDF files.')
@click.option('-h', '--hocr', 'serializer', flag_value='hocr',
              help='Serializer switch (hOCR/ALTO/abbyyXML/PageXML/native).')
@click.option('-a', '--alto', 'serializer', flag_value='alto')
@click.option('-y', '--abbyy', 'serializer', flag_value='abbyyxml')
@click.option('-x', '--pagexml', 'serializer', flag_value='pagexml')
@click.option('-n', '--native', 'serializer', flag_value='native', default=True)
@click.option('--layout', 'serializer', flag_value='layout',
              help='Serialize as a self-contained HTML proofing view '
                   '(facsimile overlay + editable transcription).')
@click.option('-t', '--template', type=click.Path(exists=True, dir_okay=False),
              help='Custom serialization template.')
@click.option('-d', '--device', default='cuda',
              help='Select device to use (cuda, cuda:0, ..., cpu).')
@click.option('--precision', type=click.Choice(['64', '32', 'bf16', '16']), default='32',
              help='Numerical precision for inference.')
@click.option('-r', '--raise-on-error/--no-raise-on-error', default=False,
              help='Raise processing exceptions instead of skipping files.')
@click.option('--threads', 'num_threads', type=click.IntRange(1), default=1,
              help='Maximum size of host thread pools.')
@click.option('--subline-segmentation/--no-subline-segmentation', default=True,
              help='Enable/disable subline segmentation in serialized output.')
def cli(input, batch_input, suffix, verbose, format_type, pdf_format, serializer, template,
        device, precision, raise_on_error, num_threads, subline_segmentation):
    """
    Base command for recognition functionality.

    Subcommands are chainable sequences of processing steps applied to every
    input file in order: binarize segment ocr.
    """
    ctx = click.get_current_context()
    ctx.meta['device'] = _resolve_device(device)
    ctx.meta['precision'] = {'64': '64-true', '32': '32-true',
                             'bf16': 'bf16-true', '16': '16-true'}[precision]
    ctx.meta['input_format_type'] = format_type if format_type != 'pdf' else 'image'
    ctx.meta['raise_failed'] = raise_on_error
    ctx.meta['output_mode'] = serializer if not template else template
    ctx.meta['output_template'] = template
    ctx.meta['verbose'] = verbose
    ctx.meta['steps'] = []
    ctx.meta['num_threads'] = num_threads
    ctx.meta['subline_segmentation'] = subline_segmentation
    log.set_logger(logger, level=30 - min(10 * verbose, 20))


@cli.result_callback()
def process_pipeline(subcommands, input, batch_input, suffix, verbose, format_type,
                     pdf_format, **args):
    """
    Executes the pipeline for every input file.
    """
    import glob
    import tempfile

    ctx = click.get_current_context()
    # cap host-side compute threads (reference caps BLAS via threadpool_limits,
    # kraken.py:421; here the heavy host math is OpenCV's)
    try:
        import cv2
        cv2.setNumThreads(ctx.meta.get('num_threads', 1))
    except ImportError:
        pass
    input = list(input)
    # expand batch inputs
    if batch_input and suffix:
        for batch_expr in batch_input:
            for in_file in glob.glob(str(Path(batch_expr).expanduser()), recursive=True):
                input.append((Path(in_file), Path(in_file).with_suffix(suffix)))

    # PDF page extraction
    if format_type == 'pdf':
        if not suffix:
            raise click.UsageError('PDF inputs require a suffix (-o).')
        new_input = []
        for (fpath, _) in input:
            doc = _pdf_pages(fpath)
            for idx, page in enumerate(doc):
                dest = Path(pdf_format.format(src=fpath.with_suffix(''),
                                              idx=idx)).with_suffix(suffix)
                tmp = tempfile.NamedTemporaryFile(suffix='.png', delete=False)
                page.save(tmp.name)
                ctx.meta['tmp_files'] = ctx.meta.get('tmp_files', []) + [tmp.name]
                new_input.append((Path(tmp.name), dest))
        input = new_input

    for io_pair in input:
        ctx.meta['first_process'] = True
        ctx.meta.pop('base_image', None)
        try:
            tmps = [tempfile.mkstemp()[1] for _ in subcommands[1:]]
            for tmp in tmps:
                os.unlink(tmp)
            fc = [str(io_pair[0])] + tmps + [str(io_pair[1])]
            for task, input_pth, output_pth in zip(subcommands, fc, fc[1:]):
                task(input=input_pth, output=output_pth)
        except Exception as e:
            logger.error(f'Failed processing {io_pair[0]}: {e}')
            if ctx.meta['raise_failed']:
                raise
        finally:
            for tmp in tmps:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    for tmp in ctx.meta.get('tmp_files', []):
        if os.path.exists(tmp):
            os.unlink(tmp)


def _pdf_pages(path):
    """Returns PDF pages as images.

    Prefers a real rasterizer (pyvips, as the reference uses at
    kraken/kraken.py:363-399, then PyMuPDF); without one, takes the
    dependency-free scanned-PDF extractor (`kraken_tpu_torch.lib.pdf`),
    which pulls the embedded page images out of the container at native
    resolution. Every route returns PIL images.
    """
    import io as _io
    from PIL import Image
    try:
        import pyvips
        n = pyvips.Image.new_from_file(str(path), n=-1).get('n-pages')
        return [Image.open(_io.BytesIO(
                    pyvips.Image.new_from_file(str(path), page=i, dpi=300).write_to_buffer('.png')))
                for i in range(n)]
    except ImportError:
        pass
    try:
        import fitz  # PyMuPDF
        return [Image.open(_io.BytesIO(page.get_pixmap(dpi=300).tobytes('png')))
                for page in fitz.open(str(path))]
    except ImportError:
        pass
    from kraken_tpu_torch.lib.pdf import PDFError, extract_page_images
    try:
        return list(extract_page_images(path))
    except PDFError as e:
        raise click.UsageError(
            f'{e} (the built-in extractor handles scanned PDFs only; '
            'install pyvips or PyMuPDF for full rasterization)')


# -------------------------------------------------------------- subcommands
@cli.command('binarize')
@click.pass_context
@click.option('--threshold', default=0.5, type=click.FLOAT)
@click.option('--zoom', default=0.5, type=click.FLOAT)
@click.option('--escale', default=1.0, type=click.FLOAT)
@click.option('--border', default=0.1, type=click.FLOAT)
@click.option('--perc', default=80, type=click.IntRange(1, 100))
@click.option('--range', default=20, type=click.IntRange(1),
              help='Side of the percentile windows (range x 2, then 2 x range).')
@click.option('--low', default=5, type=click.IntRange(1, 100))
@click.option('--high', default=90, type=click.IntRange(1, 100))
@click.option('--accel', type=click.Choice(['host', 'device']), default='host',
              help='Run nlbin on the host (OpenCV and the native percentile) or on the '
                   '--device (the card by default).')
def binarize(ctx, threshold, zoom, escale, border, perc, range, low, high, accel):
    """
    Binarizes page images.
    """
    ctx.meta['steps'].append({'category': 'preprocessing',
                              'description': 'Image binarization',
                              'settings': {'threshold': threshold, 'zoom': zoom,
                                           'escale': escale, 'border': border,
                                           'perc': perc, 'range': range,
                                           'low': low, 'high': high}})
    return partial(binarizer, threshold, zoom, escale, border, perc, range, low,
                   high, accel)


@cli.command('segment')
@click.pass_context
@click.option('-i', '--model', type=str, help='Baseline/region detection model(s) to use',
              multiple=True)
@click.option('-x/-bl', '--boxes/--baseline', default=True,
              help='Switch between legacy box segmenter and neural baseline segmenter')
@click.option('-d', '--text-direction', default='horizontal-lr',
              type=click.Choice(['horizontal-lr', 'horizontal-rl', 'vertical-lr', 'vertical-rl']),
              help='Sets principal text direction')
@click.option('--scale', 'legacy_scale', type=float, default=None)
@click.option('-m', '--maxcolseps', 'legacy_maxcolseps', type=int, default=2)
@click.option('-b/-w', '--black-colseps/--white-colseps',
              '--black_colseps/--white_colseps',  # reference spelling
              'legacy_black_colseps', default=False)
@click.option('-r/-l', '--remove-hlines/--hlines', 'legacy_no_hlines', default=True)
@click.option('-p', '--pad', 'bbox_line_padding', type=int, default=0,
              help='Left and right padding around lines (bbox segmenter only).')
@click.option('--input-pad', 'input_padding', type=int, default=0,
              help='Padding to add around the input image.')
@click.option('--device-vectorize/--host-vectorize', default=False,
              help='Carve all seams of a page in one launch on the device instead '
                   'of the host DP (identical results).')
@click.option('--transfer', default='float', type=click.Choice(['float', 'bytes']),
              help='Device-link payload format: "bytes" uploads the page as uint8 '
                   'and picks the heatmap download from a one-off measure of the '
                   'upload rate (bit-packed masks on a slow link, quantized heatmaps '
                   'otherwise).')
@click.option('--devices', default=1, type=int,
              help='Number of devices to shard page batches over (one process; '
                   'cuda:0 to cuda:N-1, or N shards with --device cpu).')
def segment(ctx, model, boxes, text_direction, legacy_scale, legacy_maxcolseps,
            legacy_black_colseps, legacy_no_hlines, bbox_line_padding, input_padding,
            device_vectorize, transfer, devices):
    """
    Segments page images into text lines.
    """
    from kraken_tpu_torch.configs import SegmentationInferenceConfig

    config = SegmentationInferenceConfig(text_direction=text_direction,
                                         devices=devices,
                                         legacy_scale=legacy_scale,
                                         legacy_maxcolseps=legacy_maxcolseps,
                                         legacy_black_colseps=legacy_black_colseps,
                                         legacy_no_hlines=legacy_no_hlines,
                                         bbox_line_padding=bbox_line_padding,
                                         input_padding=input_padding,
                                         device_vectorize=device_vectorize,
                                         input_transfer='uint8' if transfer == 'bytes' else 'float',
                                         heatmap_precision='auto' if transfer == 'bytes'
                                         else 'float32',
                                         device=ctx.meta['device'],
                                         precision=ctx.meta['precision'],
                                         raise_on_error=ctx.meta['raise_failed'])
    task_model = None
    if not boxes:
        from kraken_tpu_torch.tasks import SegmentationTaskModel
        if not model and not SEGMENTATION_DEFAULT_MODEL.exists():
            raise click.UsageError(
                'No segmentation model given (-i) and no packaged default '
                '(blla.safetensors / blla.mlmodel) found in this build.')
        paths = list(model) or [SEGMENTATION_DEFAULT_MODEL]
        models = []
        from kraken_tpu_torch.models import load_models
        for p in paths:
            message(f'Loading ANN {p}\t', nl=False)
            try:
                models.extend(load_models(p))
            except Exception:
                if ctx.meta['raise_failed']:
                    raise
                message('✗', fg='red')
                ctx.exit(1)
            message('✓', fg='green')
        task_model = SegmentationTaskModel(models)
        ctx.meta['steps'].append({'category': 'processing',
                                  'description': 'Baseline and region segmentation',
                                  'settings': {'model': [str(p) for p in paths],
                                               'text_direction': text_direction}})
    else:
        ctx.meta['steps'].append({'category': 'processing',
                                  'description': 'bounding box segmentation',
                                  'settings': {'text_direction': text_direction,
                                               'scale': legacy_scale,
                                               'maxcolseps': legacy_maxcolseps,
                                               'black_colseps': legacy_black_colseps}})
    ctx.meta['text_direction'] = ('horizontal-tb' if text_direction.startswith('horizontal')
                                  else 'vertical-lr')
    return partial(segmenter, boxes, task_model, config)


@cli.command('ocr')
@click.pass_context
@click.option('-m', '--model', default='', show_default=True,
              help='Path to recognition model weights.')
@click.option('-B', '--batch-size', default=1, type=int,
              help='Number of lines per forward pass batch.')
@click.option('-p', '--pad', default=16, type=int,
              help='Left and right padding around lines')
@click.option('-t', '--temperature', default=1.0, type=float,
              help='Softmax temperature')
@click.option('--num-line-workers', default=2, type=int,
              help='Number of line extraction workers. 0 for in-process extraction.')
@click.option('--devices', default=1, type=int,
              help='Number of devices to shard line batches over (one process; '
                   'cuda:0 to cuda:N-1, or N shards with --device cpu).')
@click.option('-n', '--reorder/--no-reorder', default=True,
              help='Reorder code points to logical order in output.')
@click.option('--base-dir', default='auto', type=click.Choice(['L', 'R', 'auto']),
              help='Set base text direction for BiDi reordering.')
@click.option('-s', '--no-segmentation', default=False, is_flag=True,
              help='Treat each input image as a whole line.')
@click.option('-d', '--text-direction', default='horizontal-tb',
              type=click.Choice(['horizontal-tb', 'vertical-lr', 'vertical-rl']),
              help='Principal text direction in serialization output')
@click.option('--no-legacy-polygons', is_flag=True, default=False,
              help='Force disable the legacy polygon extractor')
@click.option('--linetype', default=None, type=click.Choice(['baselines', 'bbox']),
              help='Forces the line type used when parsing XML input.')
@click.option('--decoder', default='greedy', type=click.Choice(['greedy', 'beam']),
              help='CTC decoding strategy.')
@click.option('--beam-size', default=3, type=int,
              help='Beam width for the beam decoder.')
@click.option('--transfer', default='float', type=click.Choice(['float', 'bytes']),
              help='Upload format of line batches: "bytes" uploads them as one dense '
                   'uint8 atlas that the packed gather pads back on the device '
                   '(identical activations to a byte upload of the padded batch).')
def ocr(ctx, model, batch_size, pad, temperature, num_line_workers, devices, reorder, base_dir,
        no_segmentation, text_direction, no_legacy_polygons, linetype, decoder, beam_size,
        transfer):
    """
    Recognizes text in line images.
    """
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.tasks import RecognitionTaskModel

    if not model:
        raise click.UsageError('No model given for recognition (-m).')
    message(f'Loading ANN {model}\t', nl=False)
    try:
        task_model = RecognitionTaskModel.load_model(model)
    except Exception:
        if ctx.meta['raise_failed']:
            raise
        message('✗', fg='red')
        ctx.exit(1)
    message('✓', fg='green')

    # the serializers' writing mode: the segmenter's when `segment` ran
    # before, else this option (the JAX CLI sets it in `segment` only, so
    # its `-f xml ... ocr` to a serialized format fails on the missing key)
    ctx.meta.setdefault('text_direction', text_direction)
    bidi = (base_dir if base_dir != 'auto' else True) if reorder else False
    decoder_kwargs = {}
    if decoder == 'beam':
        from kraken_tpu_torch.ops.ctc import beam_decoder
        decoder_kwargs['decoder'] = partial(beam_decoder, beam_size=beam_size)
    config = RecognitionInferenceConfig(**decoder_kwargs,
                                        batch_size=batch_size,
                                        padding=pad,
                                        temperature=temperature,
                                        num_line_workers=num_line_workers,
                                        devices=devices,
                                        bidi_reordering=bidi,
                                        text_direction=text_direction,
                                        no_legacy_polygons=no_legacy_polygons,
                                        input_transfer='packed' if transfer == 'bytes' else 'float',
                                        device=ctx.meta['device'],
                                        precision=ctx.meta['precision'],
                                        raise_on_error=ctx.meta['raise_failed'])
    return partial(recognizer, task_model, no_segmentation, config, linetype)


# ---------------------------------------------------------- repo commands
@cli.command('show')
@click.pass_context
@click.option('-V', '--metadata-version', default='highest',
              help='Version of metadata to fetch if multiple exist in repository.')
@click.argument('model_id')
def show(ctx, metadata_version, model_id):
    """
    Retrieves model metadata from the repository, or, when the argument is
    a local model file, displays its embedded metadata directly.
    """
    if not os.path.isfile(model_id):
        from kraken_tpu_torch import repo
        from kraken_tpu_torch.exceptions import KrakenRepoException
        try:
            desc = repo.get_description(model_id,
                                        version=metadata_version if metadata_version != 'highest' else None)
        except KrakenRepoException as e:
            message(str(e), fg='red')
            ctx.exit(1)
        _render_remote_description(desc)
        return
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.lib.util import make_printable
    for m in load_models(model_id):
        message(f'model class: {type(m).__name__}')
        message(f'model type: {", ".join(m.model_type or ["unknown"])}')
        if hasattr(m, 'spec'):
            message(f'spec: {m.spec}')
        else:
            # a reading-order model has no VGSL spec (the JAX CLI stops on it)
            message(f'level: {m.level}')
            message('class mapping: ' + ' '.join(f'{k}={v}' for k, v in m.class_mapping.items()))
        if getattr(m, 'seg_type', None):
            message(f'segmentation type: {m.seg_type}')
        if getattr(m, 'one_channel_mode', None):
            message(f'one channel mode: {m.one_channel_mode}')
        if getattr(m, 'codec', None) is not None:
            chars = sorted(m.codec.c2l)
            message('alphabet: ' + ' '.join(make_printable(c) for c in chars))
        metrics = m.user_metadata.get('accuracy') or m.user_metadata.get('metrics')
        if metrics:
            last = metrics[-1]
            message(f'metrics (epoch {last[0]}): ' +
                    ' '.join(f'{k}={v:.4f}' for k, v in last[1].items()
                             if isinstance(v, (int, float))))


def _render_remote_description(desc: dict) -> None:
    """
    Renders a remote metadata record as the reference does
    (kraken/kraken.py:651-724): a rich key/value table titled with the
    record summary, script codes resolved to ISO 15924 names, language
    codes to ISO 639-3 names, creators with ORCID/affiliation, metrics
    formatted per line; v0 records show the alphabet split into printable
    and non-printable characters (the latter, a space among them, by
    name), v1 records the dataset/base-model/software fields with a
    Markdown description.
    """
    from rich.console import Console, Group
    from rich.markdown import Markdown
    from rich.table import Table

    from kraken_tpu_torch.lib.iso_names import iso15924_to_name, iso639_3_to_name
    from kraken_tpu_torch.lib.util import is_printable, make_printable

    def _creators(creators):
        out = []
        for creator in creators or []:
            if not isinstance(creator, dict):
                out.append(str(creator))
                continue
            text = creator.get('name', '')
            if creator.get('orcid'):
                text += f' ({creator["orcid"]})'
            if creator.get('affiliation'):
                text += f' ({creator["affiliation"]})'
            out.append(text)
        return out

    def _metrics(metrics):
        return [f'{k}: {v:.2f}' for k, v in (metrics or {}).items()]

    pub = desc.get('publication_date')
    pub = pub.isoformat() if hasattr(pub, 'isoformat') else str(pub or '')
    version = desc.get('version') or ('v1' if 'language' in desc else 'v0')

    table = Table(title=desc.get('summary', ''), show_header=False)
    table.add_column('key', justify='left', no_wrap=True)
    table.add_column('value', justify='left', no_wrap=False)
    table.add_row('DOI', desc.get('doi', ''))
    table.add_row('concept DOI', desc.get('concept_doi', ''))
    table.add_row('publication date', pub)
    table.add_row('model type', Group(*(desc.get('model_type') or [])))
    if version == 'v0':
        chars, combining = [], []
        for char in sorted(desc.get('graphemes') or []):
            (chars if is_printable(char) else combining).append(make_printable(char))
        table.add_row('script', Group(*[iso15924_to_name(s)
                                        for s in desc.get('script') or []]))
        table.add_row('alphabet', Group(' '.join(chars), ', '.join(combining)))
        table.add_row('keywords', Group(*(desc.get('keywords') or [])))
        table.add_row('metrics', Group(*_metrics(desc.get('metrics'))))
        table.add_row('license', desc.get('license', ''))
        table.add_row('creators', Group(*_creators(desc.get('creators'))))
        table.add_row('description', desc.get('description', ''))
    else:
        table.add_row('language', Group(*[iso639_3_to_name(lang)
                                          for lang in desc.get('language') or []]))
        table.add_row('script', Group(*[iso15924_to_name(s)
                                        for s in desc.get('script') or []]))
        table.add_row('keywords', Group(*(desc.get('keywords') or [])))
        table.add_row('datasets', Group(*(desc.get('datasets') or [])))
        table.add_row('metrics', Group(*_metrics(desc.get('metrics'))))
        table.add_row('base model', Group(*(desc.get('base_model') or [])))
        table.add_row('software', desc.get('software_name', ''))
        table.add_row('software_hints', Group(*(desc.get('software_hints') or [])))
        table.add_row('license', desc.get('license', ''))
        table.add_row('creators', Group(*_creators(desc.get('creators'))))
        table.add_row('description', Markdown(desc.get('description') or ''))
    Console().print(table)


@cli.command('list')
@click.option('--all', 'model_type', flag_value='all', default=True)
@click.option('--recognition', 'model_type', flag_value='recognition')
@click.option('--segmentation', 'model_type', flag_value='segmentation')
@click.option('--reading-order', 'model_type', flag_value='reading_order')
@click.option('-l', '--language', default=None, multiple=True)
@click.option('-s', '--script', default=None, multiple=True)
@click.option('-k', '--keyword', default=None, multiple=True)
@click.pass_context
def list_models(ctx, model_type, language, script, keyword):
    """
    Lists models in the repository.
    """
    from kraken_tpu_torch import repo
    from kraken_tpu_torch.exceptions import KrakenRepoException
    try:
        listing = repo.get_listing_versions(model_type=model_type,
                                            language=language,
                                            script=script,
                                            keyword=keyword)
    except KrakenRepoException as e:
        message(str(e), fg='red')
        ctx.exit(1)
    # reference rendering (kraken/kraken.py:774-788): one row per concept
    # DOI with a tree of its deposits and grouped summary/type/keywords
    from rich.console import Console, Group
    from rich.table import Table
    from rich.tree import Tree

    table = Table(show_header=True)
    table.add_column('DOI', justify='left', no_wrap=True)
    table.add_column('summary', justify='left', no_wrap=False)
    table.add_column('model type', justify='left', no_wrap=False)
    table.add_column('keywords', justify='left', no_wrap=False)
    for concept_id, versions in listing.items():
        tree = Tree(concept_id)
        for v in versions:
            tree.add(v.get('doi', ''))
        table.add_row(tree,
                      Group(*[''] + [v.get('summary', '') for v in versions]),
                      Group(*[''] + ['; '.join(v.get('model_type') or [])
                                     for v in versions]),
                      Group(*[''] + ['; '.join(v.get('keywords') or [])
                                     for v in versions]))
    Console().print(table)


@cli.command('get')
@click.pass_context
@click.argument('model_id')
def get(ctx, model_id):
    """
    Retrieves a model from the repository.
    """
    from kraken_tpu_torch import repo
    from kraken_tpu_torch.exceptions import KrakenRepoException
    try:
        path = repo.get_model(model_id)
    except KrakenRepoException as e:
        message(str(e), fg='red')
        ctx.exit(1)
    message(f'Model dir: {path}')


if __name__ == '__main__':
    cli()
