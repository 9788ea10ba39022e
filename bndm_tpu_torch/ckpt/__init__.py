from bndm_tpu_torch.ckpt.manager import CheckpointManager

__all__ = ["CheckpointManager"]
