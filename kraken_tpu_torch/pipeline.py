"""
kraken_tpu_torch.pipeline
~~~~~~~~~~~~~~~~~~~~~~~~~

Streaming multi-page processing: host-side segmentation of upcoming pages
runs in a prefetch thread pool while the device recognizes the current
page's line batch, so steady-state throughput approaches the slower *stage*
instead of the sum of stages (SURVEY §7 build plan step 5 — the reference
has no equivalent; it processes files strictly serially through temp files,
kraken/kraken.py:341-433).
"""
import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional

logger = logging.getLogger(__name__)

__all__ = ['process_pages']


def process_pages(images: Iterable,
                  model,
                  segmenter: Callable,
                  prefetch: int = 2,
                  raise_on_error: bool = False,
                  stream_batches: bool = True,
                  segmenter_batch: Optional[Callable] = None,
                  seg_batch: int = 1):
    """
    Generator yielding (image, segmentation, records) per page.

    Args:
        images: iterable of PIL images (or callables returning one, for lazy
                page decoding).
        model: a recognition model prepared with prepare_for_inference.
        segmenter: im -> Segmentation (host stage, runs in the prefetch pool).
        prefetch: number of pages (or page groups) segmented ahead of
                recognition.
        raise_on_error: raise instead of skipping failed pages.
        stream_batches: fill recognition batches across page boundaries
                (inference.recognition.recognition_stream) so partial pages
                share device dispatches and the one-deep device pipeline
                never drains between pages. Predictions/cuts are identical
                to per-page prediction (confidences to float tolerance);
                set False to force the page-at-a-time engine (e.g. for
                models without a prepared recognition forward).
        segmenter_batch: [im, ...] -> [Segmentation, ...] — batched
                segmentation (e.g. inference.segmentation's
                segmentation_pred_batch: one network dispatch per page
                group, amortizing per-dispatch latency on remote links).
        seg_batch: pages per batched segmentation call (used with
                segmenter_batch; 1 keeps the per-page path).
    """
    def _segment(items):
        ims = []
        for item in items:
            im = item() if callable(item) else item
            getattr(im, 'load', lambda: None)()
            ims.append(im)
        if segmenter_batch is not None and len(ims) > 1:
            return list(zip(ims, segmenter_batch(ims)))
        return [(im, segmenter(im)) for im in ims]

    group_n = max(1, seg_batch) if segmenter_batch is not None else 1
    pool = ThreadPoolExecutor(max_workers=max(1, prefetch))
    try:
        queue = deque()
        iterator = iter(images)

        def _next_group():
            group = []
            for item in iterator:
                group.append(item)
                if len(group) == group_n:
                    break
            return group or None

        while len(queue) < max(1, prefetch):
            group = _next_group()
            if group is None:
                break
            queue.append(pool.submit(_segment, group))

        def _pages():
            while queue:
                future = queue.popleft()
                nxt = _next_group()
                if nxt is not None:
                    queue.append(pool.submit(_segment, nxt))
                try:
                    yield from future.result()
                except Exception:
                    if raise_on_error:
                        raise
                    logger.warning('Skipping failed page group.', exc_info=True)

        # a model prepared by inference.recognition.prepare_recognition
        # carries its config; only then can the streaming engine drive it
        if stream_batches and getattr(model, '_inf_config', None) is not None:
            from kraken_tpu_torch.inference.recognition import recognition_stream
            yield from recognition_stream(model, _pages(),
                                          raise_on_error=raise_on_error)
        else:
            for im, seg in _pages():
                try:
                    records = list(model.predict(im, seg))
                except Exception:
                    if raise_on_error:
                        raise
                    logger.warning('Skipping failed page.', exc_info=True)
                    continue
                yield im, seg, records
    finally:
        pool.shutdown(wait=False)
