"""
kraken_tpu_torch.tasks.align
~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Forced alignment task wrapper (reference: kraken/tasks/align.py), the
counterpart of the JAX package's ``tasks/align.py``: runs recognition with
logits/line-image capture and aligns the existing transcription of every
line to the network output. The trellises of all lines of a page are built
in one launch of the kernel of ``csrc/trellis.cu`` on the model's device
(its plain version on the CPU); the backtrack runs on the host.
"""
import logging
from dataclasses import replace
from typing import TYPE_CHECKING, Union

from kraken_tpu_torch.align import backtrack, get_trellis_batch, merge_repeats, prepare_line
from kraken_tpu_torch.containers import BaselineOCRRecord
from kraken_tpu_torch.models import load_models
from kraken_tpu_torch.vgsl import VGSLModel

if TYPE_CHECKING:
    from os import PathLike
    from PIL import Image
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.containers import Segmentation

logger = logging.getLogger(__name__)

__all__ = ['ForcedAlignmentTaskModel']


class ForcedAlignmentTaskModel:
    """
    Aligns page transcriptions to recognition model activations. Code points
    not in the model's character set are silently dropped; lines whose
    output is too short produce empty records.
    """

    def __init__(self, models: list):
        models = [net for net in models if 'recognition' in net.model_type]
        if not models:
            raise ValueError(f'Model list contains no recognition model: {models}.')
        if len(models) > 1:
            logger.warning('Multiple recognition models supplied; only the first is used.')
        if not isinstance(models[0], VGSLModel):
            raise ValueError('Forced alignment is only supported by VGSL networks.')
        self.net = models[0]
        self.one_channel_mode = self.net.one_channel_mode
        self.seg_type = self.net.seg_type

    def predict(self, im: 'Image.Image', segmentation: 'Segmentation',
                config: 'RecognitionInferenceConfig') -> 'Segmentation':
        """
        Returns a Segmentation whose lines are aligned OCR records, on the
        device of `config` (the card unless it says 'cpu').
        """
        if not config.return_logits:
            logger.info('Enabling logits in output records (required for forced alignment).')
            config.return_logits = True
        if not config.return_line_image:
            logger.info('Enabling line images in output records (required for forced alignment).')
            config.return_line_image = True
        self.net.prepare_for_inference(config)

        base_dir = config.bidi_reordering if config.bidi_reordering in ('L', 'R') else None
        records = []
        # (record index, recognition record, display text, labels, emission)
        pending = []
        n_text_lines = 0
        n_unencodable = 0
        for idx, record in enumerate(self.net.predict(im, segmentation)):
            line = segmentation.lines[idx]
            records.append(record.__class__('', [], [], line))
            if record.logits is None or not line.text:
                continue
            n_text_lines += 1
            if len(self.net.codec.encode(line.text)) == 0:
                # single unencodable lines (page numbers, tags) degrade to
                # empty records; a codec that can't encode ANY line is a
                # hard error (reference: tasks/align.py backtrack
                # 'Failed to align')
                n_unencodable += 1
                logger.warning(f'Line {idx} transcription {line.text!r} shares '
                               f'no code points with the model codec.')
                continue
            prepared = prepare_line(record.logits, self.net.codec, line.text, base_dir)
            if prepared is None:
                logger.warning(f'Could not align line {idx}: output too short for '
                               f'transcription "{line.text}".')
                continue
            pending.append((idx, record, *prepared))
        if n_text_lines and n_unencodable == n_text_lines:
            raise ValueError('Failed to align: no transcription shares any '
                             'code points with the model codec.')

        trellises = get_trellis_batch([p[4] for p in pending], [p[3] for p in pending],
                                      device=self.net.device)
        for (idx, record, do_text, labels, emission), trellis in zip(pending, trellises):
            segments = merge_repeats(backtrack(trellis, emission, labels), do_text)
            olen = record.logits.shape[-1]
            net_scale = (record.image.width + 2 * config.padding) / olen
            in_scale = 1.0

            def scale_val(val, min_val, max_val):
                return int(round(min(max(((val * net_scale) - config.padding) * in_scale,
                                         min_val), max_val - 1)))

            pred = ''.join(seg.label for seg in segments)
            pos = [(scale_val(seg.start, 0, record.image.width),
                    scale_val(seg.end, 0, record.image.width)) for seg in segments]
            conf = [seg.score for seg in segments]
            # aligned records are emitted in display order — the reference
            # computes logical_order() but discards the result
            # (kraken/tasks/align.py:134-138), and its test suite pins the
            # display-order output
            records[idx] = BaselineOCRRecord(pred, pos, conf, segmentation.lines[idx],
                                             display_order=True)
        return replace(segmentation, lines=records)

    @classmethod
    def load_model(cls, path: Union[str, 'PathLike']) -> 'ForcedAlignmentTaskModel':
        return cls(load_models(path))
