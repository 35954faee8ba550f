"""
kraken_tpu_torch.inference.recognition
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Batched text recognition inference, the counterpart of the JAX package's
``inference/recognition.py``:

  host: polygonal line extraction (thread pool) → input transforms →
        queueing
  device: bucketed padded batch → CNN+BiLSTM forward (the LSTM recurrence
        in the port's CUDA kernel) → temperature softmax → per-frame
        argmax/max
  host: run-length grouping → codec decode → record assembly → BiDi

Line widths are padded up to the JAX package's geometric bucket ladder and
the line count up to powers of two, so both packages see identically shaped
batches and cuDNN sees few shapes. Only the (N, W) labels/confidences come
back to the host unless the decoder or ``return_logits`` needs the full
posteriors.
"""
import contextlib
import dataclasses
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING

import numpy as np
import torch

from kraken_tpu_torch.containers import BaselineOCRRecord, BBoxOCRRecord
from kraken_tpu_torch.dataset import ImageInputTransforms
from kraken_tpu_torch.lib.geometry import extract_polygons

if TYPE_CHECKING:
    from PIL import Image
    from kraken_tpu_torch.containers import Segmentation
    from kraken_tpu_torch.vgsl import VGSLModel

logger = logging.getLogger(__name__)

__all__ = ['recognition_pred', 'recognition_stream', 'prepare_recognition',
           'resolve_device', 'width_bucket']

_PRECISION_DTYPES = {
    '32-true': torch.float32, '32': torch.float32,
    'bf16-true': torch.bfloat16, 'bf16-mixed': torch.bfloat16, 'bf16': torch.bfloat16,
    '16-true': torch.float16, '16-mixed': torch.float16, '16': torch.float16,
    '64-true': torch.float64, '64': torch.float64,
}


# dispatched batches not yet decoded before the engine waits for the oldest:
# one batch computes on the card while the one before it decodes on the host
_PIPELINE_DEPTH = 1


def width_bucket(w: int, base: int = 128, growth: float = 1.25) -> int:
    """
    Rounds a width up to a geometric bucket ladder (base, base*growth, ...)
    to bound the number of distinct batch shapes.
    """
    b = base
    while b < w:
        b = int(np.ceil(b * growth / 16) * 16)
    return b


def resolve_device(device) -> torch.device:
    """
    The torch device named by a config. A CUDA device with no card present
    raises: the port never carries on on the CPU unless asked to.
    """
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device!r} requested but no CUDA device is available; '
                           "pass device='cpu' to run on the CPU")
    return dev


# _precise_fp32 holds the process-wide TF32 flags off while any thread is
# inside it (the page pipeline segments on its prefetch threads while the
# recognition dispatcher runs): the first to enter saves and clears them,
# the last to leave restores them
_TF32_LOCK = threading.Lock()
_TF32_HOLDERS = 0
_TF32_SAVED = (False, False)


@contextlib.contextmanager
def _precise_fp32(dtype: torch.dtype):
    """Keeps float32 convolutions (cuDNN's default) and matmuls (after a
    caller's ``torch.set_float32_matmul_precision('high')``) out of TF32,
    so an fp32 forward matches the JAX package's fp32 forward; both flags
    are restored on exit."""
    global _TF32_HOLDERS, _TF32_SAVED
    if dtype != torch.float32:
        yield
        return
    backends = torch.backends
    with _TF32_LOCK:
        if _TF32_HOLDERS == 0:
            _TF32_SAVED = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
            backends.cuda.matmul.allow_tf32 = False
            backends.cudnn.allow_tf32 = False
        _TF32_HOLDERS += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_HOLDERS -= 1
            if _TF32_HOLDERS == 0:
                backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = _TF32_SAVED


def prepare_recognition(model: 'VGSLModel', config) -> None:
    """
    Configures a recognition model for inference: resolves the device
    (raising when a CUDA device is asked for and there is none), casts the
    parameters to the precision's type and moves them there.
    """
    device = resolve_device(config.device)
    dtype = _PRECISION_DTYPES.get(config.precision, torch.float32)
    model.net.to(device=device, dtype=dtype)
    model.net.eval()
    model._inf_config = config
    model._device = device
    model._m_dtype = dtype


def _forward(model: 'VGSLModel', x: torch.Tensor, seq_lens: torch.Tensor, temperature: float,
             probs: bool = True):
    """Network forward plus the softmax/argmax/max tail (``csrc/tail.cu`` on
    the card), on the model's device; the (N, C, W) posteriors are None
    unless `probs` asks for them."""
    from kraken_tpu_torch.ops.tail import recognition_tail
    with torch.inference_mode(), _precise_fp32(model._m_dtype):
        logits, olens = model.net(x, seq_lens)
        p, labels, confs = recognition_tail(logits, temperature, probs=probs)
    return p, labels, confs, olens


def _extract_line(im, segmentation, line_idx: int, legacy: bool):
    line = segmentation.lines[line_idx]
    seg = dataclasses.replace(segmentation, lines=[line])
    try:
        sub_im, _ = next(extract_polygons(im, seg, legacy=legacy))
        return sub_im, line_idx
    except ValueError as e:
        logger.warning(f'Line extraction failed for line {line_idx}: {e}')
        return None, line_idx


def _produce_entries(model: 'VGSLModel', im: 'Image.Image',
                     segmentation: 'Segmentation'):
    """
    Per-page line producer shared by the single-page and streaming engines:
    extracts (thread pool), transforms, and yields either
    ``('empty', line_idx, record)`` for unrecognizable lines or
    ``('line', line_idx, (ts_im, line_im, line_idx, segmentation))``.
    """
    config = model._inf_config
    n_lines = len(segmentation.lines)
    if segmentation.type == 'baselines':
        valid_norm = False
        empty_cls = BaselineOCRRecord
    else:
        valid_norm = True
        empty_cls = BBoxOCRRecord

    batch, channels, height, width = model.input
    transforms = ImageInputTransforms(batch, height, width, channels,
                                      (config.padding, 0), valid_norm)
    if transforms.mode == 'L' and im.mode == 'RGB':
        # single-channel models: convert the page once instead of every
        # warped line patch (the JAX package's order, which deviates from
        # the reference's per-line convert-after-extraction within one
        # gray level); cached on the image for repeated predictions
        gray = getattr(im, '_kraken_gray', None)
        if gray is None or gray.size != im.size:
            gray = im.convert('L')
            try:
                im._kraken_gray = gray
            except AttributeError:
                pass
        im = gray

    legacy = False
    if model.use_legacy_polygons and segmentation.type == 'baselines':
        if config.no_legacy_polygons:
            logger.warning('Enforcing the new polygon extractor for a model trained '
                           'with the legacy method; accuracy may be affected.')
        else:
            logger.info('Using legacy polygon extractor (model trained with old method).')
            legacy = True

    if config.num_line_workers and config.num_line_workers > 0 and n_lines > 1:
        im.load()  # force decode before sharing across extraction threads
        pool = ThreadPoolExecutor(max_workers=config.num_line_workers)
        extraction = pool.map(lambda i: _extract_line(im, segmentation, i, legacy), range(n_lines))
    else:
        pool = None
        extraction = (_extract_line(im, segmentation, i, legacy) for i in range(n_lines))

    try:
        for line_im, line_idx in extraction:
            if line_im is None or 0 in line_im.size:
                yield 'empty', line_idx, empty_cls('', [], [], segmentation.lines[line_idx])
                continue
            try:
                ts_im = transforms(line_im)
            except Exception:
                logger.warning(f'Line tensor conversion failed for line {line_idx}.', exc_info=True)
                yield 'empty', line_idx, empty_cls('', [], [], segmentation.lines[line_idx])
                continue
            if ts_im.max() == ts_im.min():
                yield 'empty', line_idx, empty_cls('', [], [], segmentation.lines[line_idx])
            else:
                yield 'line', line_idx, (ts_im, line_im, line_idx, segmentation)
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def recognition_pred(model: 'VGSLModel', im: 'Image.Image',
                     segmentation: 'Segmentation'):
    """
    Generator yielding one OCR record per line of `segmentation`, in order.
    """
    config = model._inf_config
    n_lines = len(segmentation.lines)
    results: list = [None] * n_lines
    queue: list = []
    next_emit = 0

    # batches are dispatched on one background worker, so the host-to-device
    # copy and the (asynchronous) launches overlap the extraction of the next
    # lines; the newest batch computes while the previous one decodes
    pending: list = []
    dispatcher = ThreadPoolExecutor(max_workers=1)

    def _flush(drain: bool = False):
        if queue:
            pending.append(dispatcher.submit(_dispatch_batch, model, list(queue)))
            queue.clear()
        while pending and (drain or len(pending) > _PIPELINE_DEPTH):
            outputs, lines = pending.pop(0).result()
            for rec, idx in _decode_batch_results(model, outputs, lines):
                results[idx] = rec

    try:
        for kind, line_idx, payload in _produce_entries(model, im, segmentation):
            if kind == 'empty':
                results[line_idx] = payload
            else:
                queue.append(payload)
                if len(queue) == config.batch_size:
                    _flush()
            while next_emit < n_lines and results[next_emit] is not None:
                yield results[next_emit]
                next_emit += 1
        _flush(drain=True)
        while next_emit < n_lines and results[next_emit] is not None:
            yield results[next_emit]
            next_emit += 1
    finally:
        dispatcher.shutdown(wait=False)


def recognition_stream(model: 'VGSLModel', pages, raise_on_error: bool = False):
    """
    Cross-page streaming recognition: line batches are filled across page
    boundaries, so partial pages share dispatches and the device pipeline
    never drains between pages. Yields ``(im, segmentation, records)`` in
    page order with records in line order: the predictions and cuts of
    per-page :func:`recognition_pred`, confidences to float tolerance.

    Args:
        pages: iterable of (PIL image, Segmentation) pairs.
        raise_on_error: raise instead of dropping pages whose production,
            dispatch, or decode fails. With False (default) a failing page
            — or, for a failed batch, every page with lines in that batch —
            is skipped and the stream continues.
    """
    from collections import deque
    config = model._inf_config
    queue: list = []        # line payloads awaiting dispatch
    qstates: list = []      # page state per queued payload (parallel)
    pending: list = []      # [(future, states), ...]
    order: deque = deque()  # page states in arrival order

    dispatcher = ThreadPoolExecutor(max_workers=1)

    def _decode_ready(drain: bool = False):
        while pending and (drain or len(pending) > _PIPELINE_DEPTH):
            future, states = pending.pop(0)
            try:
                outputs, lines = future.result()
                for (rec, line_idx), st in zip(_decode_batch_results(model, outputs, lines),
                                               states):
                    st['results'][line_idx] = rec
                    st['done'] += 1
            except Exception:
                if raise_on_error:
                    raise
                logger.warning('Recognition batch dispatch/decode failed; '
                               'dropping affected pages.', exc_info=True)
                for st in states:
                    st['failed'] = True

    def _flush(drain: bool = False):
        if queue:
            pending.append((dispatcher.submit(_dispatch_batch, model, list(queue)),
                            list(qstates)))
            queue.clear()
            qstates.clear()
        _decode_ready(drain)

    def _completed():
        while order and (order[0]['failed'] or order[0]['done'] == order[0]['n']):
            st = order.popleft()
            if not st['failed']:
                yield st['im'], st['seg'], st['results']

    try:
        for im, seg in pages:
            st = {'im': im, 'seg': seg, 'n': len(seg.lines),
                  'results': [None] * len(seg.lines), 'done': 0, 'failed': False}
            order.append(st)
            try:
                for kind, line_idx, payload in _produce_entries(model, im, seg):
                    if kind == 'empty':
                        st['results'][line_idx] = payload
                        st['done'] += 1
                    else:
                        queue.append(payload)
                        qstates.append(st)
                        if len(queue) == config.batch_size:
                            _flush()
            except Exception:
                if raise_on_error:
                    raise
                logger.warning('Skipping failed page.', exc_info=True)
                st['failed'] = True
            yield from _completed()
        _flush(drain=True)
        yield from _completed()
    finally:
        dispatcher.shutdown(wait=False)


def _dispatch_batch(model: 'VGSLModel', lines: list):
    """
    Pads queued lines to a common bucketed width, copies the batch to the
    model's device and launches the forward there without waiting for it;
    returns (device outputs, line meta). Runs on the dispatcher thread, so
    the kernels launch on that thread's current stream.
    """
    config = model._inf_config
    widths = [ts.shape[2] for ts, *_ in lines]
    max_w = width_bucket(max(widths))
    c, h = lines[0][0].shape[0], lines[0][0].shape[1]
    n = len(lines)
    # pad the batch count onto a power-of-two ladder so ragged final batches
    # reuse batch shapes; decode ignores the tail since it only walks `lines`
    n = min(1 << (n - 1).bit_length() if n > 1 else 1, config.batch_size) \
        if config.batch_size > 1 else n
    n = max(n, len(lines))
    batch = np.zeros((n, c, h, max_w), np.float32)
    for i, (ts, *_) in enumerate(lines):
        batch[i, :, :, :ts.shape[2]] = ts
    seq_lens = np.full((n,), max_w, np.int32)
    seq_lens[:len(widths)] = widths
    device = model._device
    x = torch.from_numpy(batch).to(device=device, dtype=model._m_dtype)
    lens = torch.from_numpy(seq_lens).to(device)
    from kraken_tpu_torch.ops.ctc import greedy_decoder
    probs = config.return_logits or config.decoder is not greedy_decoder
    return _forward(model, x, lens, config.temperature, probs=probs), lines


def _decode_batch_results(model: 'VGSLModel', outputs, lines: list):
    """
    Copies a dispatched batch's outputs to the host, decodes, and yields
    (record, line_index) pairs. Each line entry carries its own
    Segmentation so a batch may mix lines of different pages.
    """
    config = model._inf_config
    probs, labels, confs, olens = outputs
    labels = labels.cpu().numpy()
    confs = confs.cpu().numpy()
    olens = olens.cpu().numpy()

    from kraken_tpu_torch.ops.ctc import _group_runs, greedy_decoder
    use_fast_path = config.decoder is greedy_decoder
    # the full (N, C, W) posteriors only leave the device when something
    # consumes them: a custom decoder or return_logits
    if config.return_logits or not use_fast_path:
        model.outputs = probs.cpu().numpy()
    else:
        model.outputs = None

    for idx, (ts_im, line_im, line_idx, segmentation) in enumerate(lines):
        olen = int(olens[idx])
        if use_fast_path:
            locs = _group_runs(labels[idx, :olen], confs[idx, :olen])
        else:
            locs = config.decoder(model.outputs[idx:idx + 1], seq_lens=[olen])[0]
        pred = model.codec.decode(locs)
        net_scale = ts_im.shape[2] / olen
        in_scale = line_im.width / (ts_im.shape[2] - 2 * config.padding)

        def scale_val(val, min_val, max_val):
            return int(round(min(max(((val * net_scale) - config.padding) * in_scale, min_val),
                                 max_val - 1)))

        pred_str = ''.join(x[0] for x in pred)
        pos = []
        conf = []
        if segmentation.type == 'baselines':
            for _, start, end, c_ in pred:
                pos.append([scale_val(start, 0, line_im.width),
                            scale_val(end, 0, line_im.width)])
                conf.append(c_)
            rec = BaselineOCRRecord(pred_str, pos, conf,
                                    segmentation.lines[line_idx],
                                    logits=model.outputs[idx, ..., :olen].copy() if config.return_logits else None,
                                    image=line_im if config.return_line_image else None)
        else:
            line_obj = segmentation.lines[line_idx]
            for _, start, end, c_ in pred:
                if segmentation.text_direction.startswith('horizontal'):
                    x, ymin, _, ymax = line_obj.bbox
                    xmin = x + scale_val(start, 0, line_im.width)
                    xmax = x + scale_val(end, 0, line_im.width)
                    pos.append([[xmin, ymin], [xmin, ymax], [xmax, ymax], [xmax, ymin]])
                else:
                    xmin, y, xmax, _ = line_obj.bbox
                    ymin = y + scale_val(start, 0, line_im.height)
                    ymax = y + scale_val(end, 0, line_im.height)
                    pos.append([[xmin, ymin], [xmax, ymin], [xmax, ymax], [xmin, ymax]])
                conf.append(c_)
            rec = BBoxOCRRecord(pred_str, pos, conf,
                                segmentation.lines[line_idx],
                                logits=model.outputs[idx, ..., :olen].copy() if config.return_logits else None,
                                image=line_im if config.return_line_image else None)
        if config.bidi_reordering:
            yield rec.logical_order(base_dir=config.bidi_reordering
                                    if config.bidi_reordering in ('L', 'R') else None), line_idx
        else:
            yield rec.display_order(None), line_idx
