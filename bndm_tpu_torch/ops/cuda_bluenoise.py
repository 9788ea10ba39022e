"""The blue-noise correlation matmul: ``noise_bn = L @ white``.

PyTorch counterpart of ``bndm_tpu/ops/pallas_bluenoise.py`` (``_pallas_matmul``
and ``apply_L``). L is the dense lower-triangular (4096, 4096) covariance
factor and white the flattened noise folded to (4096, B*C). On a CUDA tensor
the product runs in the hand-written kernel ``csrc/tri_matmul.cu`` (K1),
which skips the column tiles above the diagonal and sums in fp32; on a CPU
tensor it runs in the plain fp32 version below. There is no fallback from one
to the other: a CUDA call launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch


def tri_matmul_plain(L, W):
    """Plain fp32 ``L @ W`` (the einsum ``apply_L`` uses off the TPU)."""
    return torch.einsum("pq,qm->pm", L.float(), W.float())


def _check(L, W):
    if L.dim() != 2 or L.shape[0] != L.shape[1]:
        raise ValueError(f"L must be square 2-D, got {tuple(L.shape)}")
    if W.dim() != 2 or W.shape[0] != L.shape[0]:
        raise ValueError(f"W must be ({L.shape[0]}, M), got {tuple(W.shape)}")
    if L.dtype != torch.float32 or W.dtype != torch.float32:
        raise TypeError(f"tri_matmul takes float32, got {L.dtype} and {W.dtype}")
    if L.device != W.device:
        raise ValueError(f"L is on {L.device} but W is on {W.device}")
    if not (L.is_contiguous() and W.is_contiguous()):
        raise ValueError("tri_matmul takes contiguous row-major L and W")
    if L.shape[0] == 0 or W.shape[1] == 0:
        raise ValueError(f"empty product {tuple(L.shape)} @ {tuple(W.shape)}")
    if L.shape[0] * max(L.shape[0], W.shape[1]) >= 2**31:
        raise ValueError("tri_matmul indexes with 32-bit rows and columns")


def _kernel():
    from bndm_tpu_torch.ops import _build

    lib = _build.load("tri_matmul")
    fn = lib.bndm_tri_matmul_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tri_matmul(L, W):
    """``out = L @ W`` for a LOWER-TRIANGULAR fp32 L (n, n) and W (n, M).

    The CUDA kernel reads only the lower triangle of L (it multiplies through
    the zeros of the diagonal tiles and skips the tiles above them), so an L
    with nonzeros above the diagonal gives a wrong result there. CPU tensors
    go to :func:`tri_matmul_plain`; ``tri_matmul.launches`` counts kernel
    launches.
    """
    _check(L, W)
    if L.device.type == "cpu":
        return tri_matmul_plain(L, W)
    if L.device.type != "cuda":
        raise ValueError(f"tri_matmul runs on cuda or cpu, not {L.device}")
    n, m = W.shape
    out = torch.empty((n, m), device=W.device, dtype=torch.float32)
    fn = _kernel()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = fn(L.data_ptr(), W.data_ptr(), out.data_ptr(), n, m, stream)
    if err != 0:
        raise RuntimeError(f"tri_matmul kernel launch failed with CUDA error {err}")
    tri_matmul.launches += 1
    return out


tri_matmul.launches = 0


def apply_L(L, wf):
    """Batched correlation: (B, HW, C) white noise -> (B, HW, C) correlated.

    ``out[b] = L @ wf[b]``, with batch and channel folded into one column
    dimension (HW, B*C) for a single :func:`tri_matmul` (``apply_L`` of the
    JAX package, bndm_tpu/ops/pallas_bluenoise.py:292-304).
    """
    b, hw, c = wf.shape
    n = L.shape[0]
    if hw != n:
        raise ValueError(f"L is {tuple(L.shape)} but noise has {hw} pixels")
    w2 = wf.permute(1, 0, 2).reshape(n, b * c).float().contiguous()
    out = tri_matmul(L.float().contiguous(), w2)
    return out.reshape(n, b, c).permute(1, 0, 2).to(wf.dtype)
