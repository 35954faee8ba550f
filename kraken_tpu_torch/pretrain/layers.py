"""
kraken_tpu_torch.pretrain.layers
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

The wav2vec2-style masking layer of the ``W`` VGSL block, the counterpart of
the JAX package's ``pretrain/layers.py``: placed between the feature
extractor and the recurrent context encoder, it passes its input through in
evaluation mode; in training mode it replaces random spans of the (N, C, 1,
W) feature map by a learned mask embedding and returns the masked features
with the projected unmasked targets in a dict. Its parameters keep the JAX
names (``mask_emb.weight`` (1, C), ``project_q.weight`` (F, C),
``project_q.bias`` (F,)), so model files hold them under the same keys.
"""
from typing import Optional

import torch

from kraken_tpu_torch.nn.layers import Layer, _Params, _xavier_uniform

__all__ = ['Wav2Vec2Mask', 'compute_mask_indices', 'span_mask']


def span_mask(starts: torch.Tensor, mask_width: int) -> torch.Tensor:
    """(N, W) span starts dilated to spans of `mask_width` steps along W, as
    the JAX package dilates them: by rolling, so a span that starts in the
    last ``mask_width - 1`` steps wraps round to the first."""
    mask = starts.clone()
    for off in range(1, mask_width):
        mask |= torch.roll(starts, off, dims=1)
    return mask


def compute_mask_indices(shape: tuple[int, int], mask_prob: float, mask_width: int,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> torch.Tensor:
    """
    (N, W) bool span masks: each step starts a span with probability
    ``mask_prob / mask_width`` (uniform draws from `generator` on `device`)
    and spans last `mask_width` steps (:func:`span_mask`).
    """
    starts = torch.rand(shape, generator=generator, device=device) < (mask_prob / mask_width)
    return span_mask(starts, mask_width)


class Wav2Vec2Mask(Layer):
    """
    Wav2Vec2 masking of an (N, C, 1, W) feature map: in training mode
    ``forward`` returns ``({'output', 'unmasked_features', 'mask',
    'seq_len', 'num_negatives'}, seq_len)`` with the masks drawn from
    ``generator`` (or given as `mask`); in evaluation mode ``(x, seq_len)``.
    """

    model_type = ('pretrain',)
    _kraken_min_version = '5.0.0'

    def __init__(self, context_encoder_input_dim: int, final_dim: int, mask_width: int,
                 mask_prob: float, num_negatives: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.context_encoder_input_dim = context_encoder_input_dim
        self.final_dim = final_dim
        self.mask_width = mask_width
        self.mask_prob = mask_prob
        self.num_negatives = num_negatives
        C, F = context_encoder_input_dim, final_dim
        self.mask_emb = _Params(weight=torch.randn((1, C), generator=generator) * 0.02)
        self.project_q = _Params(weight=_xavier_uniform((F, C), generator),
                                 bias=torch.zeros(F))
        # source of the training-mode masks (the default generator when None)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x, seq_len=None, output_shape=None, mask: Optional[torch.Tensor] = None):
        if not self.training:
            return x, seq_len
        N, C, H, W = x.shape
        if H != 1:
            raise ValueError(f'Height has to be 1, not {H} for the wav2vec2-style masking layer.')
        feats = x.permute(0, 3, 2, 1).reshape(N, W, C)
        if mask is None:
            mask = compute_mask_indices((N, W), self.mask_prob, self.mask_width,
                                        self.generator, x.device)
        masked = torch.where(mask[..., None], self.mask_emb.weight[0].to(x.dtype), feats)
        projected = feats @ self.project_q.weight.t().to(x.dtype) + self.project_q.bias.to(x.dtype)
        return {'output': masked.transpose(1, 2)[:, :, None, :],
                'unmasked_features': projected,
                'mask': mask,
                'seq_len': seq_len,
                'num_negatives': self.num_negatives}, seq_len

    def get_spec(self, name: str) -> str:
        return (f'[1,{self.final_dim},0,{self.context_encoder_input_dim} '
                f'W{{{name}}}{self.final_dim},{self.mask_width},{self.mask_prob},'
                f'{self.num_negatives}]')
