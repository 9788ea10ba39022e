"""Pixel-space IADB/BNDM training configuration.

Counterpart of ``bndm_tpu/train/pixel.py``. The serving slice needs only
``TrainConfig`` (the CLI's ``build`` derives ``two_head`` from it); the train
step, its optimizers and the trainer come with the training slice
(ROADMAP.md, queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors the iadb_bn argparse surface."""

    nb_steps: int = 1000
    noise_type: str = "gaussianBN"
    scheduler_alpha: str = "linear"
    alpha_param: float = 0.02
    scheduler_gamma: str = "sigmoid"
    gamma_defaults: Tuple[float, float, float] = (0.02, 0.0, 3.0)
    optimize_scheduler_param: bool = False
    out_channel: int = 6
    data_channels: int = 3
    lr: float = 1e-4
    sched_lr: float = 1e-3
    optimizer_type: str = "adamw"
    grad_clip: Optional[float] = None
    remap: bool = False
    conditional: bool = False  # superres: concat conditioning (in_channels 6)
    # "xla" and "auto" take the unfused noise path (K1 on CUDA); the fused
    # kernel K2 that "auto" selects on the TPU comes with training
    noise_engine: str = "auto"
    remat: bool = False

    @property
    def two_head(self):
        return (
            self.noise_type in ("gaussianBN", "gaussianRN")
            and self.out_channel == 2 * self.data_channels
        )
