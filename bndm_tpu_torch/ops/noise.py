"""The BNDM noise engine: time-varying white -> blue/red Gaussian noise.

PyTorch counterpart of ``bndm_tpu/ops/noise.py`` (the reference's
``get_noise_v2``), with every quirk of the reference kept:

  * the *transposed* quadrant layout of ``noise_padding``: tile 2 lands
    *below* tile 1;
  * the res-128 white-noise "scramble": ``noise_wn`` reinterprets the
    (H*W, C)-contiguous buffer as (C, H, W);
  * the res-128 ``gaussian`` *test*-time reshuffle that pushes the caller's
    noise through the same split/flatten/reassemble path;
  * the res-32 path that tiles the input 2x2 up to 64, correlates, and crops;
  * the mix ``noise = noise_bn*(1-gamma) + noise_wn*gamma`` with no variance
    renormalization;
  * ``uniform`` returning its noise three times.

Random draws take an explicit ``torch.Generator`` on the tensor's device, or
the caller's own draw (``white``, ``seeds``). The correlation matmul goes
through :func:`apply_L`, which launches the hand-written kernel K1 on CUDA
tensors; a fresh res-64 draw on CUDA goes through the fused kernel K2
(:func:`fused_bluenoise`) under ``engine="fused"`` or ``"auto"``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from bndm_tpu_torch.ops.cuda_bluenoise import apply_L, fused_bluenoise

NOISE_TYPES = ("gaussian", "uniform", "gaussianBN", "gaussianRN", "GBN")
ENGINES = ("xla", "auto", "fused")


class NoiseResult(NamedTuple):
    """(noise, noise_bn, noise_wn): training losses need all three."""

    noise: torch.Tensor
    noise_bn: torch.Tensor
    noise_wn: torch.Tensor


def noise_padding(tiles):
    """Stitch four 64x64 tiles into one 128x128 image, transposed layout.

    ``tiles``: (B, 4, C, 64, 64). Tiles 1,2 are concatenated along H to form
    the "top row", tiles 3,4 likewise, then the two along W: out[:64,:64]=t1,
    out[64:,:64]=t2, out[:64,64:]=t3, out[64:,64:]=t4. Checkpoints were
    trained against this layout; do not "fix" it.
    """
    t1, t2, t3, t4 = tiles[:, 0], tiles[:, 1], tiles[:, 2], tiles[:, 3]
    left = torch.cat([t1, t2], dim=-2)
    right = torch.cat([t3, t4], dim=-2)
    return torch.cat([left, right], dim=-1)


def _split_quadrants(x):
    """(B, C, 128, 128) -> (B*4, C, 64, 64) in t1..t4 (TL, TR, BL, BR) order,
    stacked tile-major."""
    t1 = x[:, :, 0:64, 0:64]
    t2 = x[:, :, 0:64, 64:128]
    t3 = x[:, :, 64:128, 0:64]
    t4 = x[:, :, 64:128, 64:128]
    return torch.cat([t1, t2, t3, t4], dim=0)


def _flatten_pix(x):
    """(B, C, H, W) -> (B, H*W, C)."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h * w).permute(0, 2, 1)


def _unflatten_pix(xf, h, w):
    """(B, H*W, C) -> (B, C, H, W)."""
    b, hw, c = xf.shape
    return xf.permute(0, 2, 1).reshape(b, c, h, w)


def _scramble_view(xf, h, w):
    """``(B, HW, C).contiguous().view(B, C, H, W)``: a raw buffer
    reinterpretation, NOT a transpose."""
    b, hw, c = xf.shape
    return xf.contiguous().view(b, c, h, w)


def _mix(noise_bn, noise_wn, gamma_t, noise_type):
    g = gamma_t.reshape(-1, *([1] * (noise_bn.dim() - 1)))
    if noise_type in ("gaussianBN", "gaussianRN"):
        return noise_bn * (1.0 - g) + noise_wn * g
    # GBN: pure blue noise at every step
    return noise_bn


def _fresh(shape, like, generator, white):
    """The fresh white draw of ``shape``: the caller's ``white`` when given,
    else standard normal from ``generator``."""
    if white is None:
        return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)
    if tuple(white.shape) != tuple(shape):
        raise ValueError(f"white noise must be {tuple(shape)}, got {tuple(white.shape)}")
    return white.to(like.device, like.dtype)


def fresh_shape(shape, noise_type):
    """Shape of the white noise :func:`get_noise` draws fresh for an input of
    ``shape`` (B, C, H, W): the res-32 correlated path draws at 64, the
    res-128 one four 64-tiles per sample."""
    b, c, h, w = shape
    if noise_type in ("gaussianBN", "gaussianRN", "GBN"):
        if w == 32:
            return (b, c, 64, 64)
        if w == 128:
            return (b * 4, c, 64, 64)
    return tuple(shape)


def takes_fused(x, noise_type, inplace, engine):
    """Whether :func:`get_noise` draws through K2: a fresh res-64 correlated
    draw of a CUDA tensor under ``engine`` "fused" or "auto" (the JAX
    package's rule, with CUDA in place of the TPU)."""
    return (engine in ("fused", "auto") and not inplace and x.device.type == "cuda"
            and x.shape[-1] == 64 and noise_type in ("gaussianBN", "gaussianRN", "GBN"))


def draw_seeds(generator):
    """K2's two seeds as host ints, from a generator on the CPU (one on the
    card would have to be read back, a host sync)."""
    if generator is None or generator.device.type != "cpu":
        raise ValueError("the fused engine takes its seeds from a CPU generator")
    return tuple(torch.randint(0, 2**31 - 1, (2,), generator=generator).tolist())


def get_noise(
    x,
    L,
    gamma_t,
    *,
    noise_type="gaussian",
    train=True,
    inplace=False,
    generator: Optional[torch.Generator] = None,
    engine: str = "xla",
    white: Optional[torch.Tensor] = None,
    seeds: Optional[Tuple[int, int]] = None,
) -> NoiseResult:
    """Generate per-timestep noise of the 5 reference types.

    ``inplace=True`` means "use the caller's tensor ``x`` as the white-noise
    source" (the reference does so at test time, so that saved initial noise
    drives all methods identically); otherwise fresh noise is drawn from
    ``generator``, or taken from ``white``: the caller's own draw, in
    :func:`fresh_shape` (standard normal; uniform on [0, 1) for
    ``uniform``, which always draws fresh). On the fused path, ``seeds`` are
    K2's two host ints, else drawn from ``generator`` (on the CPU).

    Shapes: x (B, C, H, W) with H == W in {32, 64, 128} for the correlated
    types. L is the (4096, 4096) res-64 covariance factor on x's device.
    gamma_t is (B,). Returns ``NoiseResult(noise, noise_bn, noise_wn)``.

    ``engine``: "xla" takes the unfused path through :func:`apply_L` (K1
    on CUDA). "fused" and "auto" take K2, the in-kernel RNG + matmul + mix
    kernel, where :func:`takes_fused` says so (its white noise is a
    different stream from ``torch.randn``'s), and the unfused path
    elsewhere, the CPU included.
    """
    if noise_type not in NOISE_TYPES:
        raise NotImplementedError(f"noise_type {noise_type!r}")
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} is not one of {ENGINES}")
    b, c, h, w = x.shape
    res = w

    if takes_fused(x, noise_type, inplace, engine):
        n, bn, wn = fused_bluenoise(seeds or draw_seeds(generator), b, c, L, gamma_t,
                                    gbn_only=(noise_type == "GBN"))
        return NoiseResult(n.to(x.dtype), bn.to(x.dtype), wn.to(x.dtype))

    # 'uniform' always draws fresh (the reference's rand() ignores inplace)
    if generator is None and white is None and (not inplace or noise_type == "uniform"):
        raise ValueError("generator is required when inplace=False and no white noise "
                         "is given (and always for noise_type='uniform', which draws "
                         "fresh noise)")

    if noise_type == "gaussian":
        if res == 128:
            noise = x if inplace else _fresh(x.shape, x, generator, white)
            if not train:
                # RNG-fairness reshuffle: split x into quadrants, flatten to
                # (HW, C), reinterpret the buffer as (C, H, W) tiles, stitch
                # with the transposed padding, as gaussianBN does to its
                # white noise
                tiles = _split_quadrants(x)
                tiles_f = _flatten_pix(tiles)
                tiles_s = _scramble_view(tiles_f, 64, 64)
                noise = noise_padding(tiles_s.reshape(b, 4, c, 64, 64))
        else:
            noise = x if inplace else _fresh(x.shape, x, generator, white)
        return NoiseResult(noise, noise, noise)

    if noise_type == "uniform":
        # the reference leaves noise_bn/noise_wn unbound on this branch; the
        # noise is returned for all three
        if white is None:
            u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        else:
            u = _fresh(x.shape, x, None, white)
        noise = (u * 2.0 - 1.0) * math.sqrt(3.0)
        return NoiseResult(noise, noise, noise)

    # correlated types: gaussianBN / gaussianRN / GBN
    if res == 32:
        # tile 2x2 up to 64, correlate, crop back
        x64 = torch.cat([x, x], dim=-2)
        x64 = torch.cat([x64, x64], dim=-1)
        noise = x64 if inplace else _fresh(x64.shape, x, generator, white)
        noise_wn = noise
        nf = _flatten_pix(noise)
        noise_bn = _unflatten_pix(apply_L(L, nf), 64, 64)
        noise = _mix(noise_bn, noise_wn, gamma_t, noise_type)
        return NoiseResult(
            noise[:, :, 0:32, 0:32], noise_bn[:, :, 0:32, 0:32], noise_wn[:, :, 0:32, 0:32]
        )

    if res == 64:
        noise = x if inplace else _fresh(x.shape, x, generator, white)
        noise_wn = noise
        nf = _flatten_pix(noise)
        noise_bn = _unflatten_pix(apply_L(L, nf), 64, 64)
        noise = _mix(noise_bn, noise_wn, gamma_t, noise_type)
        return NoiseResult(noise, noise_bn, noise_wn)

    if res == 128:
        # four independent 64-tiles through one batched matmul, then the
        # transposed stitch
        if inplace:
            tiles = _split_quadrants(x)
        else:
            tiles = _fresh((b * 4, c, 64, 64), x, generator, white)
        tiles_f = _flatten_pix(tiles)
        noise_wn = noise_padding(_scramble_view(tiles_f, 64, 64).reshape(b, 4, c, 64, 64))
        bn_tiles = _unflatten_pix(apply_L(L, tiles_f), 64, 64)
        noise_bn = noise_padding(bn_tiles.reshape(b, 4, c, 64, 64))
        noise = _mix(noise_bn, noise_wn, gamma_t, noise_type)
        return NoiseResult(noise, noise_bn, noise_wn)

    raise NotImplementedError(f"resolution {res} for noise_type {noise_type!r}")


def get_noise_v2(
    device,
    x,
    cov_mat_L,
    alpha_t,
    time_step,
    noise_type="gaussian",
    train_or_test="train",
    inplace=False,
    generator: Optional[torch.Generator] = None,
):
    """Signature-compatible adapter for reference callers. ``device`` and
    ``time_step`` are accepted and ignored (the tensors carry their device;
    time only enters through the pre-computed gamma). ``alpha_t`` is the
    gamma mix factor, as at every reference call site. Returns a tuple."""
    del device, time_step
    r = get_noise(
        x,
        cov_mat_L,
        alpha_t,
        noise_type=noise_type,
        train=(train_or_test == "train"),
        inplace=inplace,
        generator=generator,
    )
    return r.noise, r.noise_bn, r.noise_wn
