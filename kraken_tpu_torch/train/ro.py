"""
kraken_tpu_torch.train.ro
~~~~~~~~~~~~~~~~~~~~~~~~~

Reading-order model training, the counterpart of the JAX package's
``train/ro.py`` (the reference's ROModel, kraken/lib/ro/model.py): BCE on
the pairwise order logits of the ROMLP, validation by greedy order decoding
and the normalised Spearman footrule distance. Torch ops (two linear
layers), on ``config.device`` in float32.
"""
import logging
from typing import Optional

import numpy as np
import torch

from kraken_tpu_torch.dataset.loader import DataLoader
from kraken_tpu_torch.dataset.ro import PageWiseROSet, PairWiseROSet
from kraken_tpu_torch.lib.geometry import greedy_order_decode
from kraken_tpu_torch.ro.layers import ROMLP
from kraken_tpu_torch.train.losses import bce_logits_loss
from kraken_tpu_torch.train.trainer import TrainingModule

logger = logging.getLogger(__name__)

__all__ = ['ROModel', 'RODataModule']


def _ro_collate(batch):
    return {'sample': np.stack([b['sample'] for b in batch]).astype(np.float32),
            'target': np.stack([b['target'] for b in batch]).astype(np.float32)}


class RODataModule:
    """Pairwise reading-order training data over XML pages (or
    Segmentations)."""

    def __init__(self, config, class_mapping: dict[str, int], level: str = 'baselines'):
        self.config = config
        self.class_mapping = class_mapping
        self.level = level
        self.train_set = None
        self.val_set = None

    def setup(self, stage: Optional[str] = None):
        cfg = self.config
        if stage not in (None, 'fit'):
            return
        if cfg.evaluation_data:
            train_files, val_files = cfg.training_data, cfg.evaluation_data
        else:
            files = list(cfg.training_data)
            cut = max(1, int(len(files) * cfg.partition))
            train_files, val_files = files[:cut], files[cut:] or files[:1]
        mode = getattr(cfg, 'format_type', 'xml') or 'xml'
        ro_id = getattr(cfg, 'reading_order', None)
        self.train_set = PairWiseROSet(train_files, class_mapping=self.class_mapping, mode=mode,
                                       level=self.level, ro_id=ro_id)
        self.val_set = PageWiseROSet(val_files, class_mapping=self.class_mapping, mode=mode,
                                     level=self.level, ro_id=ro_id)
        if not len(self.train_set):
            raise ValueError('No valid training data provided.')

    def train_dataloader(self):
        batch_size = min(self.config.batch_size, max(1, len(self.train_set)))
        if batch_size < self.config.batch_size:
            logger.warning(f'Batch size {self.config.batch_size} exceeds training '
                           f'set size {len(self.train_set)}; clamping.')
        return DataLoader(self.train_set, batch_size=batch_size, shuffle=True, drop_last=True,
                          collate_fn=_ro_collate, seed=int(np.random.randint(0, 2**31 - 1)))

    def val_dataloader(self):
        return DataLoader(self.val_set, batch_size=1, collate_fn=lambda b: b[0])


class ROModel(TrainingModule):
    """Pairwise reading-order MLP training module."""

    def __init__(self, config, net: Optional[ROMLP] = None,
                 class_mapping: Optional[dict] = None, level: str = 'baselines'):
        self.config = config
        self.level = level
        self.class_mapping = class_mapping
        self.net = net
        self.trainer = None

    @classmethod
    def load_from_weights(cls, config, path, level: str = 'baselines'):
        """Warm start from a weights file holding an ROMLP (reference:
        --load/-i of rotrain)."""
        from kraken_tpu_torch.models import load_models
        nets = [m for m in load_models(path) if isinstance(m, ROMLP)
                or 'reading_order' in getattr(m, 'model_type', [])]
        if not nets:
            raise ValueError(f'No reading-order model found in {path}.')
        return cls(config, net=nets[0], class_mapping=nets[0].class_mapping, level=level)

    def setup(self, stage, datamodule):
        if self.net is None:
            self.net = ROMLP(class_mapping=datamodule.class_mapping, level=self.level)
        self._place_for_training()

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """Mean BCE of the pairs' order logits."""
        logits = self.net(torch.from_numpy(batch['sample'])).squeeze(-1)
        return bce_logits_loss(logits, torch.from_numpy(batch['target']).to(logits.device))

    def validate(self, datamodule) -> dict:
        """Greedy-decodes each validation page's order and scores it by the
        normalised Spearman footrule distance to the true order."""
        from kraken_tpu_torch.inference.recognition import _precise_fp32
        distances = []
        losses = []
        for page in datamodule.val_dataloader():
            y = np.asarray(page['target'], np.float32)
            with torch.inference_mode(), _precise_fp32(torch.float32):
                logits = self.net(page['sample']).squeeze(-1).cpu().numpy()
            losses.append(float(np.mean(np.maximum(logits, 0) - logits * y
                                        + np.log1p(np.exp(-np.abs(logits))))))
            n = page['num_lines']
            probs = 1 / (1 + np.exp(-logits))
            order_mat = np.zeros((n, n))
            k = 0
            for i in range(n):
                for j in range(n):
                    if i == j and n != 1:
                        continue
                    order_mat[i, j] = probs[k]
                    k += 1
            path = greedy_order_decode(order_mat)
            d = sum(abs(pos - true) for true, pos in enumerate(path))
            worst = (n * n - (n % 2)) / 2 or 1
            distances.append(1 - d / worst)
        score = float(np.mean(distances)) if distances else 0.0
        return {'val_spearman': score,
                'val_loss': float(np.mean(losses)) if losses else 0.0,
                'val_metric': score}

    def test(self, datamodule) -> dict:
        return self.validate(datamodule)

    def checkpoint_extras(self) -> dict:
        return {'level': self.level}
