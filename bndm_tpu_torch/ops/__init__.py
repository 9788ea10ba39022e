from bndm_tpu_torch.ops.schedules import alpha_schedule, gamma_schedule
from bndm_tpu_torch.ops.noise import get_noise, get_noise_v2, noise_padding, NoiseResult
from bndm_tpu_torch.ops.cov import load_cov_L, make_cov_L, radial_spectrum_profile
from bndm_tpu_torch.ops.cuda_bluenoise import apply_L, tri_matmul, tri_matmul_plain

__all__ = [
    "alpha_schedule",
    "gamma_schedule",
    "get_noise",
    "get_noise_v2",
    "noise_padding",
    "NoiseResult",
    "load_cov_L",
    "make_cov_L",
    "radial_spectrum_profile",
    "apply_L",
    "tri_matmul",
    "tri_matmul_plain",
]
