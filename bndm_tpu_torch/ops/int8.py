"""int8 (W8A8) convolution for the sampling path.

Counterpart of ``bndm_tpu/ops/int8.py``. Symmetric quantization:

  * weights:     per-output-channel scale ``s_w[o] = max|W[o]| / 127``
  * activations: a per-sample scale ``s_x = max|x| / 127`` computed on each
    call (dynamic), or one constant scale recorded by an exact fp32
    trajectory (``calibrate_sampling`` on an IADB trajectory,
    ``calibrate_sampling_ddim`` on a DDIM one; static)
  * ``y = conv(x_q, w_q)`` accumulated in int32, dequantized by
    ``s_x * s_w[o]``, bias added in fp32, cast to the compute dtype.

The JAX package leaves the int8 product to XLA (int8 operands, int32
accumulation); the port leaves it to PyTorch's own int8 product,
``torch._int_mm``, on an im2col of the quantized activations
(:func:`int8_conv_accum`). The sums are exact integers: they reach
127^2 * 4608 ~ 7.4e7 at a 512-channel 3x3 site, past fp32's 2^24, so an
fp32 product of the integer values could not stand in for it.
``torch._int_mm`` takes more than 16 rows and inner and outer sizes that
are multiples of 8 on CUDA; the operands are padded with zero rows and
columns to fit, which leaves the integer sums unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# im2col elements gathered at once: the batch is split so that one chunk's
# columns stay within this (256 MB in int8, 1 GB in calibration's fp32)
_UNFOLD_BUDGET = 1 << 28


def quantize_symmetric(x, dims, eps=1e-12):
    """(x_q int8, scale) with x ~= x_q * scale; scale reduced over ``dims``
    (kept as size-1 dimensions). Round half to even, as XLA's round."""
    amax = torch.amax(torch.abs(x), dim=dims, keepdim=True)
    scale = torch.clamp_min(amax, eps) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_static(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _pad_to(t, dim, multiple, least=0):
    """Zero-pad ``t`` along ``dim`` to a multiple of ``multiple`` and to more
    than ``least`` entries."""
    n = t.shape[dim]
    want = max(-(-n // multiple) * multiple, least + 1 if n <= least else 0)
    if want == n:
        return t
    pad = list(t.shape)
    pad[dim] = want - n
    return torch.cat([t, t.new_zeros(pad)], dim=dim)


def _im2col(xq, kh, kw, stride, padding):
    """(B, C, H, W) -> (B * Ho * Wo, C * kh * kw), row-major, the columns
    in ``F.unfold``'s order (channel, then kernel row and column): the
    padded input seen through two ``unfold`` windows, gathered in one copy
    (in the input's dtype: int8 for the int8 product)."""
    b, c = xq.shape[:2]
    if padding:
        xq = F.pad(xq, (padding,) * 4)
    win = xq.unfold(2, kh, stride).unfold(3, kw, stride)  # (B, C, Ho, Wo, kh, kw)
    ho, wo = win.shape[2:4]
    return win.permute(0, 2, 3, 1, 4, 5).reshape(b * ho * wo, c * kh * kw)


def _conv_by_rows(x, kh, kw, stride, padding, product):
    """conv2d as im2col rows times a weight matrix: ``product(cols)`` maps
    each chunk's (rows, C * kh * kw) columns to (rows, O); the result is
    NCHW (a channels-last view). Batch chunks of at most ``_UNFOLD_BUDGET``
    column elements."""
    b, c, h, w = x.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    per = max(1, _UNFOLD_BUDGET // max(1, ho * wo * c * kh * kw))
    out = [product(_im2col(x[s:s + per], kh, kw, stride, padding)) for s in range(0, b, per)]
    out = out[0] if len(out) == 1 else torch.cat(out)
    return out.view(b, ho, wo, -1).permute(0, 3, 1, 2)


def int8_conv_accum(xq, wq, stride=1, padding=1):
    """The int32 accumulators of ``conv2d(xq, wq)``: NCHW int8 activations,
    OIHW int8 weights -> NCHW int32 (a channels-last view), by
    ``torch._int_mm`` on the im2col rows."""
    o, ci, kh, kw = wq.shape
    if ci != xq.shape[1]:
        raise ValueError(f"conv input has {xq.shape[1]} channels, the weight {ci}")
    # (N, K) row-major, seen as a column-major (K, N): the layout cuBLASLt's
    # int8 product takes
    wmat = _pad_to(_pad_to(wq.reshape(o, -1), 1, 8), 0, 8).t()

    def product(cols):
        acc = torch._int_mm(_pad_to(_pad_to(cols, 1, 8), 0, 1, least=16), wmat)
        return acc[:cols.shape[0], :o]

    return _conv_by_rows(xq, kh, kw, stride, padding, product)


class _Int8ConvSTE(torch.autograd.Function):
    """Dynamic W8A8 conv whose backward is the exact fp32 conv's
    (straight-through estimator): round() alone has zero gradient, so with
    the STE a ``conv_int8`` model under a train step is quantization-aware
    training."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        xq, sx = quantize_symmetric(x.float(), dims=(1, 2, 3))
        wq, sw = quantize_symmetric(w.float(), dims=(1, 2, 3))
        acc = int8_conv_accum(xq, wq, stride, padding)
        return acc.float() * (sx * sw.reshape(1, -1, 1, 1))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, wf = x.float(), w.float()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(xf.shape, wf, g, ctx.stride, ctx.padding)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(xf, wf.shape, g, ctx.stride, ctx.padding)
        return (None if gx is None else gx.to(x.dtype),
                None if gw is None else gw.to(w.dtype), None, None)


def int8_conv(x, w, stride=1, padding=1):
    """NCHW x OIHW -> NCHW fp32: both operands quantized on the fly (a
    per-sample activation scale, per-output-channel weight scales), int32
    accumulation, dequantized. Differentiable through the STE."""
    return _Int8ConvSTE.apply(x, w, stride, padding)


def int8_conv_static(x, w, act_scale, stride=1, padding=1, wq_sw=None):
    """W8A8 conv with a calibrated constant activation scale (per tensor).
    ``wq_sw``: the weight's (int8, scale) pair when already quantized."""
    xq = _quantize_static(x.float(), act_scale)
    wq, sw = wq_sw if wq_sw is not None else quantize_symmetric(w.float(), dims=(1, 2, 3))
    acc = int8_conv_accum(xq, wq, stride, padding)
    return acc.float() * (act_scale * sw.reshape(1, -1, 1, 1))


class Int8Conv2d(nn.Conv2d):
    """Drop-in for the UNet's conv sites: the same parameters as
    ``nn.Conv2d`` (fp32 ``weight`` OIHW + ``bias``, kept fp32: the weight
    scales come from them), int8 execution, output in ``compute_dtype``.

    Modes:
      dynamic   -- per-call activation scale (QAT-capable through the STE)
      calibrate -- the exact fp32 conv, recording the running activation
                   amax into the ``act_amax`` buffer
      static    -- activations quantized with the scale ``act_amax`` holds
    ``act_amax`` is a buffer outside the state_dict: ``calibrate_sampling``
    fills it, ``UNet2D.load_quant`` sets it.
    """

    MODES = ("dynamic", "calibrate", "static")

    def __init__(self, in_channels, out_channels, kernel_size, compute_dtype, mode="dynamic",
                 stride=1, padding=1):
        if mode not in self.MODES:
            raise ValueError(f"unknown int8 mode {mode!r}")
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = compute_dtype
        self.mode = mode
        self.register_buffer("act_amax", torch.zeros((), dtype=torch.float32), persistent=False)
        self._wq = None  # (version key, (w_q, s_w)) of the weight last quantized

    def _weight_q(self):
        """The weight's int8 values and scales, quantized once per weight
        version (the JAX package hoists the same work out of its scan)."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device, w.dtype)
        if self._wq is None or self._wq[0] != key:
            with torch.no_grad():
                self._wq = (key, quantize_symmetric(w.float(), dims=(1, 2, 3)))
        return self._wq[1]

    def forward(self, x):
        s, p = self.stride[0], self.padding[0]
        if self.mode == "dynamic":
            y = int8_conv(x, self.weight, s, p)
        elif self.mode == "calibrate":
            xf = x.float()
            with torch.no_grad():
                torch.maximum(self.act_amax, torch.amax(torch.abs(xf)), out=self.act_amax)
            # fp32 rows times the weight, not cuDNN: without TF32 its
            # heuristics take FFT algorithms at some of the UNet's shapes
            # (2 x 256 x 128^2 -> 128: ~200 ms a call on an H100)
            wmat = self.weight.float().reshape(self.out_channels, -1).t()
            kh, kw = self.kernel_size
            y = _conv_by_rows(xf, kh, kw, s, p, lambda cols: cols @ wmat)
        else:
            scale = torch.clamp_min(self.act_amax, 1e-12) / 127.0
            y = int8_conv_static(x, self.weight, scale, s, p, wq_sw=self._weight_q())
        return (y + self.bias.float()[:, None, None]).to(self.compute_dtype)


@torch.no_grad()
def calibrate_sampling(model, x0, nb_steps, *, scheduler_alpha="linear", alpha_param=0.02,
                       scheduler_gamma="linear", gamma_params=(1.0, 0.0, 3.0), two_head=False,
                       x_c=None):
    """Record the static serving constants on one exact reverse IADB
    trajectory and return them (``model.quant_state()``, cloned).

    ``model`` is a UNet2D built with ``int8_mode='calibrate'`` (each int8
    site records its running activation amax) and/or
    ``gn_mode='calibrate'`` (each GroupNorm site records its batch-mean
    mean/var per step). Its buffers start from zero. ``x_c``: the super-res
    conditioning, seen as ``cat([x, x_c], 1)`` as in ``sample_iadb``.
    """
    from bndm_tpu_torch.samplers.iadb import sample_iadb

    for buf in model.quant_state().values():
        buf.zero_()
    sample_iadb(model, x0, nb_steps=nb_steps, scheduler_alpha=scheduler_alpha,
                alpha_param=alpha_param, scheduler_gamma=scheduler_gamma,
                gamma_params=gamma_params, two_head=two_head, x_c=x_c)
    return {k: v.clone() for k, v in model.quant_state().items()}


@torch.no_grad()
def calibrate_sampling_ddim(model, x0, scheduler, num_inference_steps):
    """The DDIM-trajectory variant of :func:`calibrate_sampling`: one exact
    (fp32-conv) DDIM reverse loop through the calibrate-mode ``model``
    records each int8 site's running activation amax and, with
    ``gn_mode='calibrate'``, the per-(site, step) GroupNorm statistics keyed
    on the scan position (``sample_ddim(..., pass_step_idx=True)``). Returns
    the constants (``model.quant_state()``, cloned)."""
    from bndm_tpu_torch.samplers.ddim import sample_ddim

    for buf in model.quant_state().values():
        buf.zero_()
    sample_ddim(model, x0, scheduler=scheduler, num_inference_steps=num_inference_steps,
                pass_step_idx=True)
    return {k: v.clone() for k, v in model.quant_state().items()}
