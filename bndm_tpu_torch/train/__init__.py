from bndm_tpu_torch.train.ema import EmaState, ema_init, ema_update
from bndm_tpu_torch.train.pixel import TrainConfig

__all__ = ["TrainConfig", "EmaState", "ema_init", "ema_update"]
