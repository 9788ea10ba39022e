from bndm_tpu_torch.train.pixel import TrainConfig

__all__ = ["TrainConfig"]
