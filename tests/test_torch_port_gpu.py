"""The port's CUDA kernels on the card (marked ``gpu``; they skip elsewhere).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py
"""

import pytest
import torch

from bndm_tpu_torch.ops.cuda_bluenoise import tri_matmul, tri_matmul_plain


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 7, 12, 16, 17, 100, 1500])
def test_tri_matmul_kernel_matches_fp64_and_plain(m):
    """K1 on the card within 2e-5 of fp64 and of the plain version, one
    counted launch per call, across the narrow (M <= 16) and wide tiles and
    their ragged edges."""
    _cuda_or_skip()
    g = torch.Generator().manual_seed(m)
    L = torch.tril(torch.randn(4096, 4096, generator=g) * 0.02)
    L.fill_diagonal_(1.0)
    L = L.cuda()
    w = torch.randn(4096, m, generator=g).cuda()
    before = tri_matmul.launches
    got = tri_matmul(L, w)
    torch.cuda.synchronize()
    assert tri_matmul.launches == before + 1
    torch.testing.assert_close(got.double(), L.double() @ w.double(), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, tri_matmul_plain(L, w), rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_tri_matmul_small_and_odd_n():
    """n that is not a multiple of any tile: rows, K and columns all masked."""
    _cuda_or_skip()
    g = torch.Generator().manual_seed(0)
    for n, m in [(1, 1), (33, 5), (100, 70), (257, 16)]:
        L = torch.tril(torch.randn(n, n, generator=g)).cuda()
        w = torch.randn(n, m, generator=g).cuda()
        torch.testing.assert_close(tri_matmul(L, w).double(), L.double() @ w.double(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_tri_matmul_rejects_mixed_devices():
    _cuda_or_skip()
    with pytest.raises(ValueError):
        tri_matmul(torch.eye(8).cuda(), torch.ones(8, 2))
