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

The batch reaches the device by one of the JAX package's input routes:
float line tensors (``input_transfer='float'``); their bytes, divided by
255 on the device (``'uint8'``); or one dense byte atlas of the lines that
the packed gather of ``csrc/extract.cu`` pads back (``'packed'``). With
``line_extraction='device'`` the host computes only each line's sampling
grid, the page's bytes stay resident on the device, and the gather-warp of
``csrc/extract.cu`` cuts, dewarps and resizes the lines there
(:mod:`kraken_tpu_torch.inference.extraction`).

Line widths are padded up to the JAX package's geometric bucket ladder and
the line count up to powers of two, so both packages see identically shaped
batches and cuDNN sees few shapes. Only the (N, W) labels/confidences come
back to the host unless the decoder or ``return_logits`` needs the full
posteriors.

With ``devices=N`` every batch is padded to a multiple of N and split into
N contiguous shards, each built by the batch's input route and forwarded on
its own device by its replica of the network (the JAX package's 1-D mesh,
in one process; :mod:`kraken_tpu_torch.parallel.mesh`); the decode gathers
the shards in order.

The page's pixels are read anew in every ``predict`` call: nothing is
cached on the image, so an image changed in place between two calls is
recognised from its new pixels (the JAX package keys its caches on the
image size alone and recognises the old ones).
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
from kraken_tpu_torch.lib import telemetry
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
    parameters to the precision's type and moves them there, and empties
    the cache of page buffers resident on the device. With ``devices > 1``
    it keeps a replica of the network on each of the shards' devices.
    """
    from collections import OrderedDict
    from kraken_tpu_torch.parallel.mesh import inference_devices, replicas
    device = resolve_device(config.device)
    dtype = _PRECISION_DTYPES.get(config.precision, torch.float32)
    model.net.to(device=device, dtype=dtype)
    model.net.eval()
    model._inf_config = config
    model._device = device
    model._m_dtype = dtype
    model._page_buf_cache = OrderedDict()
    shards = inference_devices(config.devices, device)
    model._shard_devices = shards if len(shards) > 1 else None
    model._replicas = replicas(model.net, shards) if len(shards) > 1 else None


def _forward(net: torch.nn.Module, dtype: torch.dtype, x: torch.Tensor, seq_lens: torch.Tensor,
             temperature: float, probs: bool = True):
    """Network forward plus the softmax/argmax/max tail (``csrc/tail.cu`` on
    the card), on the device of `x`; the (N, C, W) posteriors are None
    unless `probs` asks for them."""
    from kraken_tpu_torch.ops.tail import recognition_tail
    with torch.inference_mode(), _precise_fp32(dtype):
        logits, olens = net(x, seq_lens)
        p, labels, confs = recognition_tail(logits, temperature, probs=probs)
    return p, labels, confs, olens


def _extract_line(im, segmentation, line_idx: int, legacy: bool, page_array=None):
    line = segmentation.lines[line_idx]
    seg = dataclasses.replace(segmentation, lines=[line])
    try:
        sub_im, _ = next(extract_polygons(im, seg, legacy=legacy, page_array=page_array))
        return sub_im, line_idx
    except ValueError as e:
        logger.warning(f'Line extraction failed for line {line_idx}: {e}')
        return None, line_idx


# the gather-warp resamples bilinearly with 2x2 supersampling, adequate
# through mild downscale; past this factor the host's Lanczos anti-aliasing
# differs materially, so those lines are extracted on the host and ride the
# same batch as identity-grid pass-throughs (bit-identical to the 'uint8'
# upload)
DEVICE_DOWNSCALE_LIMIT = 2.0


def _produce_entries_device(model: 'VGSLModel', im: 'Image.Image',
                            segmentation: 'Segmentation'):
    """
    Pixel-free line producer of device line extraction: computes each
    line's composed sampling grid (inference.extraction) over the page
    array, read once a call; no warping, resizing or masking on the host,
    and the page's pixels are uploaded once a page instead of once a line.
    Yields the ('empty' | 'line') protocol of :func:`_produce_entries`;
    'line' payloads carry a DeviceLine in both tensor slots (it duck-types
    the shape and width the decode reads). A line is empty when the host
    route would find it empty: its strip, masked by its polygon and cropped
    to what the mask leaves, is uniform (:func:`extraction.masked_blank`).
    """
    from kraken_tpu_torch.inference.extraction import (baseline_line_desc, host_line_desc,
                                                       masked_blank)
    config = model._inf_config
    batch, channels, height, width = model.input
    # bitonal pages resample with order 0 on the host (extract_polygons
    # converts '1' to 'L' with nearest interpolation); the gather-warp is
    # bilinear, so those pages ride the pass-through
    force_host = im.mode == '1'
    if im.mode != 'L':
        im = im.convert('L')
    page_arr = np.asarray(im)

    legacy = False
    if model.use_legacy_polygons:
        if config.no_legacy_polygons:
            logger.warning('Enforcing the new polygon extractor for a model trained '
                           'with the legacy method; accuracy may be affected.')
        else:
            logger.info('Using legacy polygon extractor (model trained with old method).')
            legacy = True

    transforms = None
    for line_idx, line in enumerate(segmentation.lines):
        try:
            desc = baseline_line_desc(page_arr, line, height, config.padding, legacy=legacy)
        except Exception as e:
            logger.warning(f'Line geometry failed for line {line_idx}: {e}')
            desc = None
        if desc is not None and (force_host or desc.scale_y > DEVICE_DOWNSCALE_LIMIT):
            line_im, _ = _extract_line(im, segmentation, line_idx, legacy, page_arr)
            if line_im is None or 0 in line_im.size:
                desc = None
            else:
                if transforms is None:
                    transforms = ImageInputTransforms(batch, height, width, channels,
                                                      (config.padding, 0), False)
                try:
                    ts = transforms(line_im)
                    desc = (None if ts.max() == ts.min() else
                            host_line_desc(ts, line_im.width, height, config.padding))
                except Exception:
                    logger.warning(f'Line tensor conversion failed for line {line_idx}.',
                                   exc_info=True)
                    desc = None
        elif desc is not None:
            desc.page = page_arr
            if masked_blank(desc.strip, line.boundary, config.padding > 0):
                desc = None
        if desc is None or desc.strip.size == 0 or desc.strip.max() == desc.strip.min():
            yield 'empty', line_idx, BaselineOCRRecord('', [], [], segmentation.lines[line_idx])
        else:
            yield 'line', line_idx, (desc, desc, line_idx, segmentation)


def _produce_entries(model: 'VGSLModel', im: 'Image.Image',
                     segmentation: 'Segmentation'):
    """
    Per-page line producer shared by the single-page and streaming engines:
    extracts (thread pool), transforms, and yields either
    ``('empty', line_idx, record)`` for unrecognizable lines or
    ``('line', line_idx, (ts_im, line_im, line_idx, segmentation))``.

    With ``config.line_extraction='device'`` (and a model and segmentation
    the gather-warp covers) it produces coordinate descriptors instead
    (:func:`_produce_entries_device`).
    """
    config = model._inf_config
    from kraken_tpu_torch.inference.extraction import supports_device_extraction
    if supports_device_extraction(model, config, segmentation.type):
        yield from _produce_entries_device(model, im, segmentation)
        return
    n_lines = len(segmentation.lines)
    if segmentation.type == 'baselines':
        valid_norm = False
        empty_cls = BaselineOCRRecord
    else:
        valid_norm = True
        empty_cls = BBoxOCRRecord

    batch, channels, height, width = model.input
    # byte uploads: the transforms give the uint8 line tensors directly
    transfer_u8 = config.input_transfer in ('uint8', 'packed')
    transforms = ImageInputTransforms(batch, height, width, channels,
                                      (config.padding, 0), valid_norm,
                                      dtype=np.uint8 if transfer_u8 else np.float32)
    if transforms.mode == 'L' and im.mode == 'RGB':
        # single-channel models: convert the page once a call instead of
        # every warped line patch (the JAX package's order, which deviates
        # from the reference's per-line convert-after-extraction within one
        # gray level)
        im = im.convert('L')
    # the straight-line extractor's page array, read once a call
    page_arr = np.asarray(im) if im.mode == 'L' else None

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
        extraction = pool.map(lambda i: _extract_line(im, segmentation, i, legacy, page_arr),
                              range(n_lines))
    else:
        pool = None
        extraction = (_extract_line(im, segmentation, i, legacy, page_arr)
                      for i in range(n_lines))

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
    Pads queued lines to a common bucketed width, brings the batch to the
    model's device by the configured input route and launches the forward
    there without waiting for it; returns (device outputs, line meta). Runs
    on the dispatcher thread, so the kernels launch on that thread's
    current stream. With several shard devices the batch is padded to a
    multiple of their count and each contiguous shard is built and
    forwarded on its own device by its replica; the outputs are then a
    list, one a shard. Shards of padding rows alone, which the decode
    never reads, are not forwarded.
    """
    from kraken_tpu_torch.ops.ctc import greedy_decoder
    config = model._inf_config
    max_w = width_bucket(max(ts.shape[2] for ts, *_ in lines))
    n = len(lines)
    # pad the batch count onto a power-of-two ladder so ragged final batches
    # reuse batch shapes; decode ignores the tail since it only walks `lines`
    n = min(1 << (n - 1).bit_length() if n > 1 else 1, config.batch_size) \
        if config.batch_size > 1 else n
    n = max(n, len(lines))
    probs = config.return_logits or config.decoder is not greedy_decoder
    dtype = model._m_dtype
    shards = model._shard_devices
    if not shards:
        x, lens = _batch_input(model, lines, max_w, n, model._device)
        return _forward(model.net, dtype, x, lens, config.temperature, probs=probs), lines
    from kraken_tpu_torch.parallel.mesh import shard_rows
    n = -(-n // len(shards)) * len(shards)
    outputs = []
    for dev, rows in zip(shards, shard_rows(n, len(shards))):
        part = lines[rows]
        if not part:
            break
        x, lens = _batch_input(model, part, max_w, rows.stop - rows.start, dev)
        outputs.append(_forward(model._replicas[dev], dtype, x, lens, config.temperature,
                                probs=probs))
    return outputs, lines


def _batch_input(model: 'VGSLModel', lines: list, max_w: int, n: int, device):
    """
    The (n, c, h, max_w) input batch of `lines` and its sequence lengths on
    `device`, by the batch's input route: DeviceLine entries (device line
    extraction) go through the gather-warp; uint8 lines with
    ``input_transfer='packed'`` travel as one dense (c, h, sum W) atlas
    plus (3, n) offsets, widths and sequence lengths, padded back by the
    packed gather (the zero padding never leaves the host); otherwise the
    padded batch is uploaded, uint8 lines as bytes divided by 255 on the
    device.
    """
    from kraken_tpu_torch.inference.extraction import DeviceLine
    from kraken_tpu_torch.ops.extract import dequantize, packed_gather
    config, dtype = model._inf_config, model._m_dtype
    widths = [ts.shape[2] for ts, *_ in lines]
    c, h = lines[0][0].shape[0], lines[0][0].shape[1]
    first = lines[0][0]
    if isinstance(first, DeviceLine):
        return _extract_on_device(model, lines, max_w, n, device)
    if first.dtype == np.uint8 and config.input_transfer == 'packed':
        # dense atlas: real pixels only, one geometric width bucket at the end
        atlas = np.zeros((c, h, width_bucket(sum(widths), base=1024)), np.uint8)
        aux = np.zeros((3, n), np.int32)
        pos = 0
        for i, (ts, *_) in enumerate(lines):
            w = ts.shape[2]
            atlas[:, :, pos:pos + w] = ts
            aux[0, i] = pos
            aux[1, i] = w
            pos += w
        aux[2] = max_w          # seq_len of batch-pad rows (as the padded path)
        aux[2, :len(widths)] = widths
        telemetry.record_up(atlas.nbytes + aux.nbytes)
        aux_d = torch.from_numpy(aux).to(device)
        return packed_gather(torch.from_numpy(atlas).to(device), aux_d, max_w, dtype), aux_d[2]
    # the padded batch: the 'uint8' route's bytes, or float lines
    batch = np.zeros((n, c, h, max_w), first.dtype)
    for i, (ts, *_) in enumerate(lines):
        batch[i, :, :, :ts.shape[2]] = ts
    seq_lens = np.full((n,), max_w, np.int32)
    seq_lens[:len(widths)] = widths
    if batch.dtype == np.uint8:
        # divided as the packed gather divides, bit for bit
        x = dequantize(torch.from_numpy(batch).to(device), dtype)
        telemetry.record_up(batch.nbytes + seq_lens.nbytes)
    else:
        x = torch.from_numpy(batch).to(device=device, dtype=dtype)
        telemetry.record_up(x.nbytes + seq_lens.nbytes)
    return x, torch.from_numpy(seq_lens).to(device)


def _extract_on_device(model: 'VGSLModel', lines: list, max_w: int, n: int, device):
    """
    The batch of DeviceLine entries, built on `device` by the gather-warp:
    the page's bytes live in a buffer resident on the device (an LRU cache
    of 4 page buffers on the model, keyed by the page array and the device,
    each padded onto the page bucket ladder); a batch uploads only its
    lines' grids, masks and meta rows, and the strips of lines that do not
    gather from that page (host pass-throughs, lines of another page in a
    cross-page batch). Returns (batch, sequence lengths) on the device.
    """
    from kraken_tpu_torch.inference.extraction import (PAGE_BUCKET_BASE, PAGE_BUCKET_GROWTH,
                                                       build_extract_payload, extract_batch)
    config = model._inf_config
    cache = model._page_buf_cache
    page_arr = next((e[0].page for e in lines if e[0].page is not None), None)
    page_buf, page_len, page_w, page_offs = None, 0, 0, None
    if page_arr is not None:
        key = (id(page_arr), str(device))
        if key not in cache:
            flat = page_arr.reshape(-1)
            buf = np.zeros(width_bucket(flat.size, base=PAGE_BUCKET_BASE,
                                        growth=PAGE_BUCKET_GROWTH), np.uint8)
            buf[:flat.size] = flat
            telemetry.record_up(buf.nbytes)
            # the source array stays referenced, so its id stays unique
            cache[key] = (page_arr, torch.from_numpy(buf).to(device))
            while len(cache) > 4:
                cache.popitem(last=False)
        else:
            cache.move_to_end(key)
        page_buf = cache[key][1]
        page_len, page_w = page_buf.numel(), page_arr.shape[1]
        # a batch may mix pages: lines of other pages pack their strips
        page_offs = [e[0].page_off if e[0].page is page_arr else -1 for e in lines]
    atlas, grid, mask, meta = build_extract_payload(
        [entry[0] for entry in lines], max_w, n, config.padding, page_len, page_w, page_offs)
    telemetry.record_up(atlas.nbytes + grid.nbytes + mask.nbytes + meta.nbytes)
    atlas_d = torch.from_numpy(atlas).to(device)
    meta_d = torch.from_numpy(meta).to(device)
    # the kernel reads the resident page and the atlas where they lie
    page_d, atlas_d = (atlas_d, None) if page_buf is None else (page_buf, atlas_d)
    x = extract_batch(page_d, torch.from_numpy(grid).to(device), torch.from_numpy(mask).to(device),
                      meta_d, max_w, model.input[2], dtype=model._m_dtype, atlas=atlas_d)
    return x, meta_d[:, 4].contiguous()


def _decode_batch_results(model: 'VGSLModel', outputs, lines: list):
    """
    Copies a dispatched batch's outputs to the host, decodes, and yields
    (record, line_index) pairs. Each line entry carries its own
    Segmentation so a batch may mix lines of different pages.
    """
    config = model._inf_config
    shards = outputs if isinstance(outputs, list) else [outputs]
    labels, confs, olens = (np.concatenate([out[k].cpu().numpy() for out in shards])
                            for k in (1, 2, 3))
    probs = None if shards[0][0] is None else torch.cat([out[0].cpu() for out in shards])
    telemetry.record_down(labels.nbytes + confs.nbytes + olens.nbytes)

    from kraken_tpu_torch.ops.ctc import _group_runs, greedy_decoder
    use_fast_path = config.decoder is greedy_decoder
    # the full (N, C, W) posteriors only leave the device when something
    # consumes them: a custom decoder or return_logits
    if config.return_logits or not use_fast_path:
        model.outputs = probs.cpu().numpy()
        telemetry.record_down(model.outputs.nbytes)
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
