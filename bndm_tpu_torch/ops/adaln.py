"""The DiT's adaLN sub-layer as one fused pass forward and one backward.

A DiT block normalises its float32 residual stream twice and the final layer
once, each time modulated by the conditioning (``models/dit.py``); each
residual update ``x + gate * branch`` comes just before the next of these
LayerNorms. One fused unit does both:

    x' = x + gate * y                      (y the branch output; absent in
                                            block 0's first sub-layer: x' = x)
    z  = LN(x') * (1 + scale) + shift      (LayerNorm without an affine)

``x`` and ``x'`` are float32 (B, N, D); ``y`` and ``z`` the compute dtype;
``gate``, ``shift`` and ``scale`` (B, 1, D) rows of the adaLN modulation.
Statistics and arithmetic are float32, rounded once, at the store of ``z``
(the unfused torch sequence rounds the normalised row, the modulation and
the gate product to the compute dtype each). The backward takes ``dz`` and
the stream's incoming gradient ``dx'`` and gives

    dx     = dx' + LN-modulate backward     (float32; dx' absent: 0)
    dy     = gate * dx                      (compute dtype)
    dscale = sum_n dz * xhat,  dshift = sum_n dz,  dgate = sum_n dx * y

the column sums per sample, accumulated in float32.

No TPU kernel precedes these: the JAX package leaves the adaLN sub-layer to
XLA, which fuses it. On the card the unfused torch sequence passes over a
(B, N, D) tensor some dozen times a sub-layer; the fused unit moves the
least bytes its data allows: x and y read and x' and z written forward
(12 B a row element at a bf16 y and z), dz, dx', x' and y read and dx and dy
written backward (18 B). Bytes bound it; it does ~20 operations an element.

Design (Triton): a program takes ``block_n`` whole rows of one sample, so it
loads the sample's modulation rows once; a row of D sits in registers as a
masked block of the next power of two, ``rows`` rows an iteration. The
backward keeps each program's column sums in registers and stores them as
float32 partials per (sample, token block); a second small kernel sums the
partials of each sample in a fixed order and rounds them to the modulation's
dtype. No atomics, so the bits repeat run to run. Each kernel's name holds
``bndm_adaln`` (``perfbench/metrics/adaln_roofline.py`` reads them so).

:func:`adaln` is the differentiable unit: on CUDA tensors its forward and
backward launch :func:`adaln_forward` and :func:`adaln_backward`, which raise
on any other device; on CPU tensors it runs their plain twins
:func:`adaln_forward_plain` and :func:`adaln_backward_plain`, torch ops with
the kernels' formula, which the tests hold the kernels against.
``adaln_forward.launches`` and ``adaln_backward.launches`` count calls on
the card.
"""

from __future__ import annotations

import functools

import torch

# float32 elements a program holds per tensor in one iteration; the token
# rows a program takes and the elements a thread holds, forward and backward
# (the best of a sweep at the DiT-XL/2 cell's shape on an H100: PERF.md)
_ELEMS = 4096
_BLOCK_N = {False: 32, True: 64}
_PER_THREAD = {False: 16, True: 32}


def _cdiv(a, b):
    return -(-a // b)


def _pow2(n):
    return 1 << max(n - 1, 0).bit_length()


def tiling(d, backward=False):
    """(block_d, rows, block_n, warps) of the forward or the backward
    kernel at width ``d``: a row as a masked block of the next power of two,
    as many rows an iteration as fill :data:`_ELEMS`, ``block_n`` rows a
    program, as many warps as give each thread its share of elements."""
    block_d = _pow2(d)
    block_n = _BLOCK_N[backward]
    rows = max(1, min(block_n, _ELEMS // block_d))
    warps = max(1, min(8, block_d * rows // (32 * _PER_THREAD[backward])))
    return block_d, rows, block_n, warps


# ------------------------------ plain twins ----------------------------------


def adaln_forward_plain(x, shift, scale, eps, y=None, gate=None):
    """The fused forward in torch ops: ``(x', z, mean, rstd)``, statistics
    and arithmetic in ``x``'s dtype, ``z`` rounded once to ``shift``'s."""
    acc = x.dtype
    xs = x if y is None else x + gate.to(acc) * y.to(acc)
    mean = xs.mean(-1)
    xc = xs - mean[..., None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + eps)
    z = xc * rstd[..., None] * (1 + scale.to(acc)) + shift.to(acc)
    return xs, z.to(shift.dtype), mean, rstd


def adaln_backward_plain(dz, dxs, xs, mean, rstd, scale, y=None, gate=None):
    """The fused backward in torch ops: ``(dx, dshift, dscale, dy, dgate)``
    (``dy`` and ``dgate`` None without ``y``); ``dxs`` None is a zero
    incoming stream gradient. The column sums are over the tokens, each
    sample apart, in ``xs``'s dtype, rounded to the modulation's."""
    acc = xs.dtype
    xhat = (xs - mean[..., None]) * rstd[..., None]
    dz = dz.to(acc)
    dxhat = dz * (1 + scale.to(acc))
    dx = rstd[..., None] * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True)
                            - dxhat.mean(-1, keepdim=True))
    if dxs is not None:
        dx = dx + dxs
    dshift = dz.sum(1, keepdim=True).to(scale.dtype)
    dscale = (dz * xhat).sum(1, keepdim=True).to(scale.dtype)
    if y is None:
        return dx, dshift, dscale, None, None
    dy = (gate.to(acc) * dx).to(y.dtype)
    dgate = (dx * y.to(acc)).sum(1, keepdim=True).to(gate.dtype)
    return dx, dshift, dscale, dy, dgate


# -------------------------------- kernels ------------------------------------


@functools.cache
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def bndm_adaln_fwd(x_ptr, y_ptr, xs_ptr, z_ptr, gate_ptr, shift_ptr, scale_ptr,
                       mean_ptr, rstd_ptr, N, D, eps, mod_stride, gate_stride,
                       HAS_Y: tl.constexpr, BLOCK_D: tl.constexpr, ROWS: tl.constexpr,
                       BLOCK_N: tl.constexpr):
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < D
        mod = b.to(tl.int64) * mod_stride + cols
        shift = tl.load(shift_ptr + mod, mask=cmask, other=0.0).to(tl.float32)
        scale1 = 1.0 + tl.load(scale_ptr + mod, mask=cmask, other=0.0).to(tl.float32)
        if HAS_Y:
            gate = tl.load(gate_ptr + b.to(tl.int64) * gate_stride + cols, mask=cmask,
                           other=0.0).to(tl.float32)
        for i in range(0, BLOCK_N, ROWS):
            n = tl.program_id(0) * BLOCK_N + i + tl.arange(0, ROWS)
            rmask = n < N
            row = b.to(tl.int64) * N + n
            offs = row[:, None] * D + cols[None, :]
            m = rmask[:, None] & cmask[None, :]
            x = tl.load(x_ptr + offs, mask=m, other=0.0, eviction_policy="evict_first")
            if HAS_Y:
                y = tl.load(y_ptr + offs, mask=m, other=0.0,
                            eviction_policy="evict_first").to(tl.float32)
                x = x + gate[None, :] * y
                tl.store(xs_ptr + offs, x, mask=m)
            mean = tl.sum(x, axis=1) / D
            xc = tl.where(m, x - mean[:, None], 0.0)
            rstd = tl.rsqrt(tl.sum(xc * xc, axis=1) / D + eps)
            z = xc * rstd[:, None] * scale1[None, :] + shift[None, :]
            tl.store(z_ptr + offs, z.to(z_ptr.dtype.element_ty), mask=m)
            tl.store(mean_ptr + row, mean, mask=rmask)
            tl.store(rstd_ptr + row, rstd, mask=rmask)

    @triton.jit
    def bndm_adaln_bwd(dz_ptr, dxs_ptr, xs_ptr, y_ptr, mean_ptr, rstd_ptr, gate_ptr,
                       scale_ptr, dx_ptr, dy_ptr, part_ptr, N, D, mod_stride, gate_stride,
                       HAS_Y: tl.constexpr, HAS_DXS: tl.constexpr, BLOCK_D: tl.constexpr,
                       ROWS: tl.constexpr, BLOCK_N: tl.constexpr):
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < D
        mod = b.to(tl.int64) * mod_stride + cols
        scale1 = 1.0 + tl.load(scale_ptr + mod, mask=cmask, other=0.0).to(tl.float32)
        if HAS_Y:
            gate = tl.load(gate_ptr + b.to(tl.int64) * gate_stride + cols, mask=cmask,
                           other=0.0).to(tl.float32)
        acc_shift = tl.zeros((BLOCK_D,), tl.float32)
        acc_scale = tl.zeros((BLOCK_D,), tl.float32)
        acc_gate = tl.zeros((BLOCK_D,), tl.float32)
        for i in range(0, BLOCK_N, ROWS):
            n = tl.program_id(0) * BLOCK_N + i + tl.arange(0, ROWS)
            rmask = n < N
            row = b.to(tl.int64) * N + n
            offs = row[:, None] * D + cols[None, :]
            m = rmask[:, None] & cmask[None, :]
            mean = tl.load(mean_ptr + row, mask=rmask, other=0.0)
            rstd = tl.load(rstd_ptr + row, mask=rmask, other=0.0)
            xs = tl.load(xs_ptr + offs, mask=m, other=0.0, eviction_policy="evict_first")
            xhat = tl.where(m, (xs - mean[:, None]) * rstd[:, None], 0.0)
            dz = tl.load(dz_ptr + offs, mask=m, other=0.0,
                         eviction_policy="evict_first").to(tl.float32)
            dxhat = dz * scale1[None, :]
            c1 = tl.sum(dxhat * xhat, axis=1) / D
            c2 = tl.sum(dxhat, axis=1) / D
            dx = rstd[:, None] * (dxhat - xhat * c1[:, None] - c2[:, None])
            if HAS_DXS:
                dx += tl.load(dxs_ptr + offs, mask=m, other=0.0, eviction_policy="evict_first")
            tl.store(dx_ptr + offs, dx, mask=m)
            acc_shift += tl.sum(dz, axis=0)
            acc_scale += tl.sum(dz * xhat, axis=0)
            if HAS_Y:
                y = tl.load(y_ptr + offs, mask=m, other=0.0,
                            eviction_policy="evict_first").to(tl.float32)
                tl.store(dy_ptr + offs, (gate[None, :] * dx).to(dy_ptr.dtype.element_ty),
                         mask=m)
                acc_gate += tl.sum(dx * y, axis=0)
        # partials (B, token blocks, 3, D): shift, scale, gate
        part = (b.to(tl.int64) * tl.num_programs(0) + tl.program_id(0)) * 3 * D + cols
        tl.store(part_ptr + part, acc_shift, mask=cmask)
        tl.store(part_ptr + part + D, acc_scale, mask=cmask)
        if HAS_Y:
            tl.store(part_ptr + part + 2 * D, acc_gate, mask=cmask)

    @triton.jit
    def bndm_adaln_colsum(part_ptr, out_ptr, B, NB, D, K: tl.constexpr, NB_P2: tl.constexpr,
                          BLOCK: tl.constexpr):
        # out (K, B, D): sample b's partials over its NB token blocks, loaded
        # together and summed by one fixed reduction tree
        b = tl.program_id(1)
        cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        j = tl.arange(0, NB_P2)
        m = (j[:, None] < NB) & (cols[None, :] < D)
        for k in tl.static_range(K):
            offs = ((b.to(tl.int64) * NB + j[:, None]) * 3 + k) * D + cols[None, :]
            acc = tl.sum(tl.load(part_ptr + offs, mask=m, other=0.0), axis=0)
            tl.store(out_ptr + (k * B + b.to(tl.int64)) * D + cols,
                     acc.to(out_ptr.dtype.element_ty), mask=cols < D)

    return bndm_adaln_fwd, bndm_adaln_bwd, bndm_adaln_colsum


_COLSUM_BLOCK = 128


def _check(x, shift, scale, y, gate, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel: it takes CUDA tensors, not {x.device}")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous float32 (B, N, D) stream, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, _, d = x.shape
    if scale.stride(0) != shift.stride(0):
        raise ValueError(f"{name} takes shift and scale rows of one stride")
    for t in [shift, scale] + ([] if y is None else [gate]):
        if t.shape != (b, 1, d) or t.stride(2) != 1:
            raise ValueError(f"{name} takes (B, 1, D) modulation rows, got {tuple(t.shape)} "
                             f"{t.stride()}")
        if t.dtype != shift.dtype or t.device != x.device:
            raise ValueError(f"{name} takes the modulation rows in one dtype on x's device")
    if y is not None and (y.shape != x.shape or not y.is_contiguous() or y.device != x.device):
        raise ValueError(f"{name} takes a contiguous branch output of the stream's shape")


def adaln_forward(x, shift, scale, eps, y=None, gate=None):
    """The fused forward on the card: ``(x', z, mean, rstd)`` with ``x'``
    float32 (``x`` itself without ``y``), ``z`` in ``shift``'s dtype and
    the float32 row statistics (B, N). Raises on a tensor off CUDA."""
    _check(x, shift, scale, y, gate, "adaln_forward")
    b, n, d = x.shape
    block_d, rows, block_n, warps = tiling(d)
    xs = x if y is None else torch.empty_like(x)
    z = torch.empty(x.shape, dtype=shift.dtype, device=x.device)
    mean = torch.empty((b, n), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        _kernels()[0][(_cdiv(n, block_n), b)](
            x, x if y is None else y, xs, z, shift if gate is None else gate, shift, scale,
            mean, rstd, n, d, float(eps), shift.stride(0),
            shift.stride(0) if gate is None else gate.stride(0), HAS_Y=y is not None,
            BLOCK_D=block_d, ROWS=rows, BLOCK_N=block_n, num_warps=warps, num_stages=1)
    adaln_forward.launches += 1
    return xs, z, mean, rstd


adaln_forward.launches = 0


def adaln_backward(dz, dxs, xs, mean, rstd, scale, y=None, gate=None):
    """The fused backward on the card: ``(dx, dshift, dscale, dy, dgate)``,
    as :func:`adaln_backward_plain`; two kernels (the rows, then the column
    sums' second pass), one counted call. Raises on a tensor off CUDA."""
    _check(xs, scale, scale, y, gate, "adaln_backward")
    if dz.shape != xs.shape or (dxs is not None and dxs.shape != xs.shape):
        raise ValueError("adaln_backward takes gradients of the stream's shape")
    b, n, d = xs.shape
    block_d, rows, block_n, warps = tiling(d, True)
    _, bwd, colsum = _kernels()
    dz = dz.contiguous()
    dxs = None if dxs is None else dxs.contiguous()
    nb = _cdiv(n, block_n)
    k = 2 if y is None else 3
    dx = torch.empty_like(xs)
    dy = None if y is None else torch.empty_like(y)
    part = torch.empty((b, nb, 3, d), dtype=torch.float32, device=xs.device)
    sums = torch.empty((k, b, 1, d), dtype=scale.dtype, device=xs.device)
    with torch.cuda.device(xs.device):
        bwd[(nb, b)](dz, xs if dxs is None else dxs, xs, xs if y is None else y, mean, rstd,
                     scale if gate is None else gate, scale, dx, dx if dy is None else dy,
                     part, n, d, scale.stride(0),
                     scale.stride(0) if gate is None else gate.stride(0), HAS_Y=y is not None,
                     HAS_DXS=dxs is not None, BLOCK_D=block_d, ROWS=rows, BLOCK_N=block_n,
                     num_warps=warps, num_stages=1)
        colsum[(_cdiv(d, _COLSUM_BLOCK), b)](part, sums, b, nb, d, K=k, NB_P2=_pow2(nb),
                                             BLOCK=_COLSUM_BLOCK, num_warps=4)
    adaln_backward.launches += 1
    return dx, sums[0], sums[1], dy, None if y is None else sums[2]


adaln_backward.launches = 0


# ------------------------------ the unit -------------------------------------


class AdaLN(torch.autograd.Function):
    """``(x', z)`` of one fused unit, differentiable in ``x``, the
    modulation rows and ``y``: the kernels on CUDA tensors, the plain twins
    on the CPU. Without ``y``, ``x'`` is ``x`` (returned as a view), so the
    stream's gradient from the next unit enters this unit's backward rather
    than a separate sum."""

    @staticmethod
    def forward(ctx, x, shift, scale, eps, y, gate):
        ctx.set_materialize_grads(False)
        fwd = adaln_forward if x.is_cuda else adaln_forward_plain
        # the embedding's stream comes transposed: rows made whole once
        xs, z, mean, rstd = fwd(x.contiguous(), shift, scale, eps, y, gate)
        ctx.save_for_backward(xs, mean, rstd, scale, y, gate)
        return xs, z

    @staticmethod
    def backward(ctx, dxs, dz):
        xs, mean, rstd, scale, y, gate = ctx.saved_tensors
        if dz is None:  # a caller that uses x' alone (gradcheck takes each output apart)
            dz = torch.zeros(xs.shape, dtype=scale.dtype, device=xs.device)
        bwd = adaln_backward if xs.is_cuda else adaln_backward_plain
        dx, dshift, dscale, dy, dgate = bwd(dz, dxs, xs, mean, rstd, scale, y, gate)
        return dx, dshift, dscale, None, dy, dgate


def adaln(x, shift, scale, eps, y=None, gate=None):
    """One fused unit: ``x' = x + gate * y`` (``x`` without ``y``) and
    ``z = LN(x') (1 + scale) + shift``, returned as ``(x', z)``."""
    return AdaLN.apply(x, shift, scale, eps, y, gate)
