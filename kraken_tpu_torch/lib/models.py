"""
kraken_tpu_torch.lib.models
~~~~~~~~~~~~~~~~~~~~~~~~~~~

Legacy recognizer wrapper API (reference: kraken/lib/models.py):
`SeqRecognizer` wraps a VGSL recognition model with forward/predict helpers
operating on single padded batches, and `load_any` loads any supported model
file into one. Kept for compatibility; new code should use
kraken_tpu_torch.tasks.RecognitionTaskModel.
"""
import logging
from os import PathLike
from typing import Optional, Union

import numpy as np
import torch

from kraken_tpu_torch.codec import Codec
from kraken_tpu_torch.exceptions import KrakenInvalidModelException
from kraken_tpu_torch.ops.ctc import greedy_decoder

logger = logging.getLogger(__name__)

__all__ = ['SeqRecognizer', 'TorchSeqRecognizer', 'load_any']


class SeqRecognizer:
    """
    A wrapper for a VGSL recognition network turning padded line batches into
    decoded label sequences. The network runs in float32 on `device`, the
    card unless the caller asks for 'cpu'.
    """

    def __init__(self, nn, decoder=greedy_decoder, train: bool = False,
                 device: str = 'cuda'):
        from kraken_tpu_torch.inference.recognition import resolve_device
        self.nn = nn
        self.kind = 'vgsl'
        self.train = train
        self.decoder = decoder
        self.codec: Optional[Codec] = getattr(nn, 'codec', None)
        self.outputs: Optional[np.ndarray] = None
        self.seq_lens: Optional[np.ndarray] = None
        if 'recognition' not in nn.model_type and nn.model_type:
            raise ValueError(f'Model {nn} is of type {nn.model_type} but a `recognition` model is required.')
        if not train and self.codec is None:
            raise ValueError('Non-trainable model set but no codec given.')
        self.seg_type = nn.seg_type
        self.one_channel_mode = nn.one_channel_mode
        self.device = resolve_device(device)
        nn.net.to(device=self.device, dtype=torch.float32)

    def forward(self, line, lens=None) -> tuple[np.ndarray, np.ndarray]:
        """
        Runs a NCHW line batch through the network, returning (N, C, W)
        softmax outputs and output sequence lengths as numpy arrays.
        """
        from kraken_tpu_torch.inference.recognition import _precise_fp32
        x = torch.as_tensor(np.asarray(line, np.float32), device=self.device)
        lens_t = torch.as_tensor(np.asarray(lens), dtype=torch.int32, device=self.device) \
            if lens is not None else None
        with torch.inference_mode(), _precise_fp32(torch.float32):
            logits, olens = self.nn.net(x, lens_t)
            probs = torch.softmax(logits.to(torch.float32), dim=1)
        o = probs.cpu().numpy().squeeze(2)
        if olens is not None:
            olens = olens.cpu().numpy()
        else:
            olens = np.full(o.shape[0], o.shape[2], np.int32)
        self.outputs = o
        self.seq_lens = olens
        return o, olens

    def predict(self, line, lens=None) -> list[list[tuple[str, int, int, float]]]:
        """
        Forward pass + decoding into (code point, start, end, confidence)
        tuples via the codec.
        """
        o, olens = self.forward(line, lens)
        return [self.codec.decode(seq) for seq in self.decoder(o, seq_lens=olens)]

    def predict_string(self, line, lens=None) -> list[str]:
        """Forward pass + decoding into plain strings."""
        return [''.join(x[0] for x in seq) for seq in self.predict(line, lens)]

    def predict_labels(self, line, lens=None) -> list[list[tuple[int, int, int, float]]]:
        """Forward pass + decoding into raw label runs."""
        o, olens = self.forward(line, lens)
        return self.decoder(o, seq_lens=olens)


# name kept for drop-in compatibility with the reference API
TorchSeqRecognizer = SeqRecognizer


def load_any(fname: Union[str, 'PathLike'],
             train: bool = False,
             device: str = 'cuda') -> SeqRecognizer:
    """
    Loads the first recognition model in `fname` (safetensors or CoreML)
    into a SeqRecognizer on `device`.
    """
    from kraken_tpu_torch.models import load_models
    try:
        models = load_models(fname)
    except ValueError as e:
        raise KrakenInvalidModelException(str(e)) from e
    for model in models:
        if 'recognition' in getattr(model, 'model_type', []):
            return SeqRecognizer(model, train=train, device=device)
    raise KrakenInvalidModelException(f'No recognition model found in {fname}')
