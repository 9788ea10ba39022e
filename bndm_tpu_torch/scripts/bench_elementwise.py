"""The GroupNorm/SiLU elementwise wall of a sampling step, case by case.

Counterpart of ``scripts/bench_elementwise_tpu.py``: each candidate
elementwise pass over the UNet's largest activation, NHWC bf16
(500, 64, 64, 128), timed alone on the card, so that a later kernel for
GroupNorm, SiLU or a layout is chosen on evidence. The cases and their
names are the JAX script's; the JAX side left them to XLA, so these are
PyTorch ops, except the last, which is P3 (a Triton kernel) where the JAX
script has its Pallas copy. "flax GroupNorm" is the port's own
``models/unet2d.py::GroupNorm`` with compute dtype bf16, 32 groups and eps
1e-5, as the JAX script's ``nn.GroupNorm(32, epsilon=1e-5,
dtype=jnp.bfloat16)``. A first case, "copy(+1) fp32", asks whether the bf16
packing matters.

Each case is ``inner`` chained passes between two CUDA events after one
warm-up loop, reported as one JSON line: ms per pass, GB/s of reads plus
writes as if the pass read and wrote the tensor once each (twice the bytes
for the fp32 copy), and the share of the H100 SXM data sheet's 3.35 TB/s.

    python -m bndm_tpu_torch.scripts.bench_elementwise

It runs on CUDA; ``main(device="cpu")`` runs on the CPU (for tests, at a
small shape). A case that fails raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bndm_tpu_torch.scripts.bench_stream import report


def _channels_first(fn):
    """Apply an NCHW module to an NHWC tensor: the permuted view has
    channels_last strides, the same bytes, and the result is permuted back
    to NHWC."""
    return lambda y: fn(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def cases(channels, device):
    """(name, fn) for every case over an NHWC bf16 tensor of ``channels``
    channels, in the JAX script's order."""
    from bndm_tpu_torch.models.unet2d import GroupNorm
    from bndm_tpu_torch.ops.stream_probes import nhwc_add_one

    scale = torch.ones(channels, device=device)
    bias = torch.zeros(channels, device=device)
    gn = _channels_first(GroupNorm(32, channels, 1e-5, torch.bfloat16).to(device))

    def stats_only(y):
        yf = y.float()
        s1 = yf.sum(dim=(1, 2))
        s2 = (yf * yf).sum(dim=(1, 2))
        return y + (s1[:, None, None, :] * 0 + s2[:, None, None, :] * 0).to(y.dtype)

    return [
        ("copy(+1)", lambda y: y + 1),
        ("affine(scale,bias)", lambda y: y * scale.to(y.dtype) + bias.to(y.dtype)),
        ("silu bf16", F.silu),
        ("silu fp32", lambda y: F.silu(y.float()).to(torch.bfloat16)),
        ("sigmoid", torch.sigmoid),
        ("tanh", torch.tanh),
        ("exp", torch.exp),
        ("gn_stats_vpu(fp32 sums)", stats_only),
        ("flax GroupNorm", gn),
        ("flax GroupNorm+silu", lambda y: F.silu(gn(y))),
        ("triton copy(+1)", nhwc_add_one),
    ]


@torch.no_grad()
def main(shape=(500, 64, 64, 128), inner=20, device="cuda"):
    from bndm_tpu_torch.cli.common import resolve_device
    from bndm_tpu_torch.utils.timing import pass_ms

    device = resolve_device(device)
    g = torch.Generator(device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    moved = 2 * x.numel() * x.element_size()
    rows = [report("copy(+1) fp32", pass_ms(lambda y: y + 1.0, x.float(), inner, device),
                   2 * moved, device)]
    rows += [report(name, pass_ms(fn, x, inner, device), moved, device)
             for name, fn in cases(shape[-1], device)]
    return rows


if __name__ == "__main__":
    main()
