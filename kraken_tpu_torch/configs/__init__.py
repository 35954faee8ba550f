"""
kraken_tpu_torch.configs
~~~~~~~~~~~~~~~~~~~~~~~~

Configuration objects of the recognition path (counterparts of the JAX
package's ``configs/base.py``). Each config consumes its keyword arguments
and passes the rest up. Inference configs carry injectable function members
(the CTC decoder) like the reference.

``device`` names a torch device and defaults to ``'cuda'``: the port runs
on the card unless the caller asks for ``'cpu'``. The JAX package's TPU
knobs (byte or packed input transfer, device line extraction, conv/pool
fusion, the LSTM backend switch, multi-device meshes) have no counterpart:
on CUDA the recurrence always runs in the port's kernel.
"""

__all__ = ['Config', 'RecognitionInferenceConfig']


class Config:
    """
    Base configuration.

    Args:
        precision: numerical precision for inference ('32-true',
                   'bf16-true', 'bf16-mixed', '16-true', ...)
        device: torch device to run on ('cuda', 'cuda:N' or 'cpu')
        batch_size: batch size for all operations
    """

    def __init__(self, **kwargs):
        self.precision = kwargs.pop('precision', '32-true')
        self.device = kwargs.pop('device', 'cuda')
        self.batch_size = kwargs.pop('batch_size', 1)
        if kwargs:
            import logging
            logging.getLogger(__name__).warning(f'Ignoring unknown configuration parameters: {sorted(kwargs)}')

    def __repr__(self):
        return f'{type(self).__name__}({vars(self)})'


class RecognitionInferenceConfig(Config):
    """
    Text recognition inference configuration.

    Args:
        temperature: softmax temperature applied to logits
        return_logits: attach raw logits to emitted records
        return_line_image: attach the extracted line image to records
        padding: horizontal padding added around extracted lines
        num_line_workers: host workers for parallel line extraction
        no_legacy_polygons: force the new polygon extractor
        decoder: CTC decoding function (softmax outputs → label runs)
        bidi_reordering: reorder output into logical order via UAX #9;
                         'L'/'R' force a base direction
        text_direction: principal text direction for serialization
    """

    def __init__(self, **kwargs):
        from kraken_tpu_torch.ops import ctc
        self.temperature = kwargs.pop('temperature', 1.0)
        self.return_logits = kwargs.pop('return_logits', False)
        self.return_line_image = kwargs.pop('return_line_image', False)
        self.padding = kwargs.pop('padding', 16)
        self.num_line_workers = kwargs.pop('num_line_workers', 2)
        self.no_legacy_polygons = kwargs.pop('no_legacy_polygons', False)
        self.decoder = kwargs.pop('decoder', ctc.greedy_decoder)
        self.bidi_reordering = kwargs.pop('bidi_reordering', True)
        self.text_direction = kwargs.pop('text_direction', 'horizontal-tb')
        super().__init__(**kwargs)
