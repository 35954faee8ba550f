"""
kraken_tpu_torch.pretrain.model
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Wav2Vec2-style masked contrastive pretraining of recognition backbones, the
counterpart of the JAX package's ``pretrain/model.py`` (reference:
kraken/lib/pretrain/model.py): the network is split into a feature
extractor (the layers before the first recurrent layer) and a context
encoder (the recurrent stack); spans of the features are replaced by a
learned mask embedding, and the encoder output at each span start is
scored against the projected unmasked features there and at other span
starts of the same line (the negatives) with a cosine-similarity cross
entropy.

As in the JAX package, each line gets a fixed number of spans, K =
``max(1, int(mask_prob * W / mask_width))`` for the padded feature width
W, their starts drawn uniformly and folded into the line's valid frames;
the negatives are drawn among the other K - 1 starts. The draws come from
the trainer's generator on the module's device (:meth:`draw_indices`), and
:meth:`loss_fn` takes them as an argument too, so that the JAX package's
draws can be fed in.

A step runs the network in float32 on ``config.device``: on the card the
recurrent layers run the LSTM kernel in its saving mode and its backward
kernel (``ops/lstm.py``); the loss is torch ops (the JAX package computes it
with XLA ops, no Pallas kernel). The cosine similarities of a line's K
positions against its K targets are one batched product, from which the
positive and the negatives are gathered: the (1 + negatives, N, K, C)
candidates are never formed.
"""
import json
import logging
import re

import numpy as np
import torch
from torch import nn

from kraken_tpu_torch.train.recognition import RecognitionDataModule
from kraken_tpu_torch.train.trainer import TrainingModule

logger = logging.getLogger(__name__)

__all__ = ['PretrainDataModule', 'RecognitionPretrainModel']

# the key prefix of the pretraining parameters in checkpoints, the JAX
# package's parameter subtree
PRETRAIN_PREFIX = 'nn.__pretrain__.'


class PretrainDataModule(RecognitionDataModule):
    """A recognition data module whose lines need no transcription: a set
    with text is encoded with a one-glyph codec, one without is left
    unencoded (``ketos pretrain``'s data)."""

    def setup(self, stage=None):
        from kraken_tpu_torch.codec import Codec
        super().setup(stage)
        for subset in (self.train_set, self.val_set):
            if subset is None:
                continue
            if subset.dataset.alphabet:
                subset.dataset.encode(Codec(' '))
            else:
                subset.dataset.no_encode()


class RecognitionPretrainModel(TrainingModule):
    """Unsupervised pretraining module for recognition backbones."""

    def __init__(self, config, net=None):
        self.config = config
        self.net = net
        self.trainer = None
        self.pretrain = None

    @classmethod
    def load_from_weights(cls, config, path):
        from kraken_tpu_torch.models import load_models
        models = [m for m in load_models(path) if 'recognition' in m.model_type]
        if not models:
            raise ValueError(f'No recognition model found in {path}')
        return cls(config, net=models[0])

    def setup(self, stage, datamodule=None):
        """Builds the network from ``config.spec`` without its ``W`` block
        (or keeps the loaded one), appends a 2-class output layer and a
        one-glyph codec where it has none, splits it at the first recurrent
        layer, wires the datasets' transforms and places the network and
        the pretraining parameters for training."""
        from kraken_tpu_torch.codec import Codec
        from kraken_tpu_torch.nn import layers as L
        cfg = self.config
        if self.net is None:
            from kraken_tpu_torch.models import create_model
            # the masking is done here: an explicit W block goes
            spec = re.sub(r'\s*W\{?\w*\}?[\d.,]+', '', cfg.spec.strip())
            self.net = create_model('TorchVGSLModel', model_type=['recognition'], vgsl=spec)
        # a linear output layer and a one-glyph codec, so that fine-tuning
        # with --resize union/new can negotiate against them (reference:
        # lib/pretrain/model.py:104,260-261)
        if not isinstance(self.net.net.layers[-1], L.LinSoftmax):
            self.net.append(len(self.net.net.layers), '[O1c2]')
        if self.net.codec is None:
            self.net.add_codec(Codec(' '))
        names, layers = self.net.net.names, self.net.net.layers
        split = next((i for i, layer in enumerate(layers)
                      if isinstance(layer, L.TransposedSummarizingRNN)), None)
        if split is None:
            raise ValueError('Pretraining requires a network with at least one recurrent layer.')
        self._features = L.Series(layers=layers[:split], names=names[:split])
        self._encoder = L.Series(layers=layers[split:-1], names=names[split:-1])
        # the masked sequence flattens channels x height at the RNN
        # boundary, so the mask embedding and the projection take C*H
        feat_shape = self._features.get_shape(self.net.input)
        feat_dim = feat_shape[1] * max(1, feat_shape[2])
        enc_out_dim = self._encoder.get_shape(feat_shape)[1]

        if datamodule is not None:
            from kraken_tpu_torch.dataset import ImageInputTransforms
            batch, channels, height, width = self.net.input
            transforms = ImageInputTransforms(batch, height, width, channels, pad=(16, 0),
                                              valid_norm=False)
            for subset in (datamodule.train_set, datamodule.val_set):
                if subset is not None:
                    getattr(subset, 'dataset', subset).transforms = transforms

        self._place_for_training()
        from kraken_tpu_torch.nn.layers import _Params, _xavier_uniform
        gen = torch.Generator().manual_seed(0)
        pretrain = nn.Module()
        pretrain.mask_emb = nn.Parameter(torch.randn(feat_dim, generator=gen) * 0.02)
        pretrain.project_q = _Params(weight=_xavier_uniform((enc_out_dim, feat_dim), gen),
                                     bias=torch.zeros(enc_out_dim))
        self.pretrain = pretrain.to(self._device).requires_grad_(True)

    def parameters(self) -> list[torch.Tensor]:
        """The network's parameters, then ``mask_emb``, ``project_q.weight``
        and ``project_q.bias`` (the global-norm clip covers them all)."""
        return super().parameters() + list(self.pretrain.parameters())

    # ------------------------------------------------------------- the loss
    def draw_indices(self, N: int, W: int, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        """
        The loss's random draws for N lines of W feature frames: the span
        starts (N, K) in ``[0, max(1, W - mask_width))`` and the negatives'
        indices (num_negatives, N, K) in ``[0, max(1, K - 1))``, from
        `generator` (the trainer's when None) on the module's device.
        """
        cfg = self.config
        K = max(1, int(cfg.mask_prob * W / cfg.mask_width))
        generator = self.generator if generator is None else generator
        starts = torch.randint(0, max(1, W - cfg.mask_width), (N, K), generator=generator,
                               device=self._device)
        neg_idx = torch.randint(0, max(1, K - 1), (cfg.num_negatives, N, K),
                                generator=generator, device=self._device)
        return starts, neg_idx

    def loss_fn(self, batch: dict, indices=None, generator=None) -> torch.Tensor:
        """The batch's contrastive loss through the network on its device,
        with the draws `indices` (``(starts, neg_idx)`` of
        :meth:`draw_indices`) or new ones from `generator`."""
        x = torch.from_numpy(np.ascontiguousarray(batch['image'])).to(self._device, torch.float32)
        lens = torch.from_numpy(np.asarray(batch['seq_lens'], np.int32)).to(self._device)
        return self._run(self._loss, x, lens, indices, generator)

    def _loss(self, x, lens, indices, generator):
        feats, lens = self._features(x, lens)
        N, C, H, W = feats.shape
        seq = feats.reshape(N, C * H, W).transpose(1, 2)  # (N, W, C*H)
        starts, neg_idx = self.draw_indices(N, W, generator) if indices is None else indices
        starts, masked = self.mask(seq, lens, starts)
        enc_out, _ = self._encoder(masked.transpose(1, 2).reshape(N, C, H, W), lens)
        return self.contrastive_loss(seq, enc_out, starts, neg_idx)

    def mask(self, seq: torch.Tensor, lens, starts: torch.Tensor):
        """The span starts folded into each line's valid frames (`lens`, the
        features' widths) and the (N, W, C) features with the spans of
        ``mask_width`` frames from them replaced by ``mask_emb``."""
        mw = self.config.mask_width
        if lens is not None:
            # spans stay inside each line's valid frames: a span over padding
            # has exact-zero encoder outputs and carries no signal
            starts = starts % torch.clamp(lens - mw, min=1)[:, None].to(starts.dtype)
        # spans of mw frames from each start, cut at W
        offset = torch.arange(seq.shape[1], device=seq.device)[None, None, :] - starts[..., None]
        spans = ((offset >= 0) & (offset < mw)).any(1)
        return starts, torch.where(spans[..., None], self.pretrain.mask_emb.to(seq.dtype), seq)

    def contrastive_loss(self, seq: torch.Tensor, enc_out: torch.Tensor, starts: torch.Tensor,
                         neg_idx: torch.Tensor) -> torch.Tensor:
        """The cross entropy of each span start's encoder output (`enc_out`,
        (N, C', 1, W)) against its projected unmasked features (`seq`, (N,
        W, C)) and those of the starts `neg_idx` names, by cosine
        similarity over ``logit_temp``."""
        N, K = starts.shape
        Ce, We = enc_out.shape[1], enc_out.shape[3]
        enc_seq = enc_out.permute(0, 3, 2, 1).reshape(N, We, Ce)
        at = starts[..., None]
        # targets: the projected unmasked features at the span starts;
        # predictions: the encoder outputs there (the recurrent stack keeps W)
        q = self.pretrain.project_q
        y = torch.gather(seq, 1, at.expand(N, K, seq.shape[2])) @ q.weight.t() + q.bias
        pred = torch.gather(enc_seq, 1, at.expand(N, K, Ce))
        # norms as x * rsqrt(sum x^2 + eps): the gradient of a plain norm
        # is NaN at a zero vector
        pred = pred * torch.rsqrt((pred * pred).sum(-1, keepdim=True) + 1e-12)
        y = y * torch.rsqrt((y * y).sum(-1, keepdim=True) + 1e-12)
        sims = torch.bmm(pred, y.transpose(1, 2))  # (N, K, K): position k against target j
        # a negative is another start of the same line (itself at K = 1)
        k = torch.arange(K, device=neg_idx.device)
        neg = torch.where(neg_idx >= k, neg_idx + 1, neg_idx) % K  # (neg, N, K)
        flat = (k * K + neg).permute(1, 0, 2).reshape(N, -1)
        negatives = sims.reshape(N, K * K).gather(1, flat).reshape(N, -1, K).transpose(0, 1)
        logits = torch.cat([sims.diagonal(dim1=1, dim2=2)[None], negatives]) / self.config.logit_temp
        return -torch.log_softmax(logits, dim=0)[0].mean()

    # -------------------------------------------------------- evaluation
    def validate(self, datamodule) -> dict:
        """The mean loss over the validation set (dropout off; each batch
        draws from a generator seeded 0, as the JAX package draws each from
        the key 0)."""
        from kraken_tpu_torch.inference.recognition import _precise_fp32
        losses = []
        generator = torch.Generator(device=self._device)
        with torch.no_grad(), _precise_fp32(torch.float32):
            for batch in datamodule.val_dataloader():
                losses.append(float(self.loss_fn(batch, generator=generator.manual_seed(0))))
        ce = float(np.mean(losses)) if losses else 0.0
        return {'val_ce': ce, 'val_metric': -ce}

    def test(self, datamodule) -> dict:
        return self.validate(datamodule)

    def checkpoint_extras(self) -> dict:
        return {'pretrain': True}

    def checkpoint_tensors(self) -> dict:
        """The pretraining parameters for checkpoints, under the JAX
        package's keys (``nn.__pretrain__.mask_emb``, ...)."""
        return {PRETRAIN_PREFIX + k: v.detach().cpu().numpy()
                for k, v in self.pretrain.named_parameters()}

    def load_checkpoint_tensors(self, path) -> None:
        """Restores the pretraining parameters from the checkpoint at
        `path` (``--resume``); a checkpoint without them leaves them."""
        from kraken_tpu_torch.models._safetensors import read_safetensors
        metadata, tensors = read_safetensors(path)
        prefix = json.loads(metadata.get('training_meta', '{}')).get('prefix')
        own = dict(self.pretrain.named_parameters())
        found = {k: tensors.get(f'{prefix}.{PRETRAIN_PREFIX}{k}') for k in own}
        if any(v is None for v in found.values()):
            logger.warning(f'No pretraining parameters in {path}; keeping fresh ones.')
            return
        with torch.no_grad():
            for k, v in found.items():
                own[k].copy_(torch.from_numpy(np.array(v)))
