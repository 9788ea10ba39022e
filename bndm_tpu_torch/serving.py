"""Serving API: the sampling tiers of the IADB sampler in one call.

Counterpart of ``bndm_tpu/serving.py``. The tiers, each a relaxation of the
exact bf16 chain that must be gated on the weights it serves:

  int8-static   conv sites in W8A8 with activation scales calibrated on one
                exact trajectory (ops/int8.py)
  static-GN     GroupNorm statistics calibrated per (site, step)
                (ops/static_norm.py, linear alpha only)
  GN carry      the cached group's full step records each sample's
                GroupNorm statistics, its shallow steps reuse them; "drift"
                shifts them per step with the calibrated tables
  bf16 softmax  the attention softmax in bf16 (serving model only)
  cached        feature reuse: every ``cache_interval``-th step runs the
                full UNet, the others only the outer ``cache_depth`` shell
                (samplers/iadb.py::sample_iadb_cached)
  microbatched  an effective batch denoised one microbatch at a time

``make_serving_sampler`` builds the calibration and serving models,
calibrates lazily on the first ``sample()`` and routes to the plain, cached
or microbatched sampler; ``make_serving_sampler_ddim`` does the same for
the DDIM baseline. ``make_validated_serving_sampler`` probes the
ladder of tier stacks, fastest first, and serves the first that passes
SSIM >= 0.99 and PSNR >= 35 dB against the plain path on the same x0.

Models are built from an fp32 state_dict on ``device`` (CUDA unless the
caller asks for the CPU); calibration draws from an explicit
``torch.Generator`` or takes ``x_cal``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from bndm_tpu_torch.models.dit import DiT, DiTConfig
from bndm_tpu_torch.models.unet2d import UNet2D
from bndm_tpu_torch.ops.int8 import calibrate_sampling, calibrate_sampling_ddim
from bndm_tpu_torch.ops.static_norm import drift_correct_gnstats, gn_step_index, smooth_gn_tables
from bndm_tpu_torch.samplers.iadb import (sample_iadb, sample_iadb_cached,
                                          sample_iadb_microbatched)


def build_model(cfg, state_dict, device):
    """The model of ``cfg`` (a ``UNet2D``, or a ``DiT`` for a ``DiTConfig``)
    on ``device`` with ``state_dict`` loaded strictly, cast for serving
    (``cast_params_``) and in eval mode."""
    model = (DiT if isinstance(cfg, DiTConfig) else UNet2D)(cfg, device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.cast_params_().eval()


def serving_model_pair(cfg, state_dict, *, device="cuda", conv_int8: Optional[bool] = None,
                       int8_static=False, static_gn=False, gn_steps: Optional[int] = None,
                       relax_kw: Optional[dict] = None):
    """Build the (calibration, serving) UNet pair of the serving tiers.

    ``conv_int8`` forces the flag into both configs (None leaves
    ``cfg.conv_int8`` as it is). ``relax_kw`` holds serving-only
    relaxations (``attn_softmax_dtype``): calibration stays on the exact
    path. Returns ``(m_cal, m_serve)``; ``m_cal`` is None when no tier
    needs a calibration trajectory.
    """
    cal_kw, sta_kw = {}, {}
    if conv_int8:
        cal_kw.update(conv_int8=True)
        sta_kw.update(conv_int8=True)
    if int8_static:
        cal_kw.update(int8_mode="calibrate")
        sta_kw.update(int8_mode="static")
    if static_gn:
        if gn_steps is None:
            raise ValueError("static_gn requires gn_steps")
        cal_kw.update(gn_mode="calibrate", gn_steps=gn_steps)
        sta_kw.update(gn_mode="static", gn_steps=gn_steps)
    if relax_kw:
        sta_kw.update(relax_kw)
    m_serve = build_model(dataclasses.replace(cfg, **sta_kw), state_dict, device)
    needs_cal = int8_static or static_gn
    m_cal = build_model(dataclasses.replace(cfg, **cal_kw), state_dict, device) \
        if needs_cal else None
    return m_cal, m_serve


def carry_models(model, state_dict):
    """The GN-stats carry's pair beside ``model``: the same config with
    ``gn_mode='record'`` (the group's full step) and ``'reuse'`` (its
    shallow steps), the same weights."""
    dev = next(model.parameters()).device
    return tuple(build_model(dataclasses.replace(model.cfg, gn_mode=mode), state_dict, dev)
                 for mode in ("record", "reuse"))


def cached_forwards(model, *, carry=None, nb_steps=None, quant=None):
    """``(apply_full, apply_shallow)`` of the cached chain.

    ``carry=None``: ``model``'s full forward returning its trunk output and
    its shallow forward. ``carry="carry"`` or ``"drift"``: ``model`` is the
    ``(m_rec, m_reu)`` pair of :func:`carry_models`; the full step's
    per-sample GroupNorm statistics ride with the trunk output to the
    shallow steps, shifted per step by ``quant``'s calibrated tables under
    "drift" (which indexes them by the linear alpha's step, ``nb_steps``).
    """
    if carry is None:
        return (lambda x, t: model(x, t, return_deep=True),
                lambda x, t, deep: model(x, t, deep_feature=deep))
    m_rec, m_reu = model

    def apply_full(x, t):
        d, deep = m_rec(x, t, return_deep=True)
        stats = m_rec.gnstats()
        return d, (deep, stats, gn_step_index(t, nb_steps) if carry == "drift" else None)

    def apply_shallow(x, t, pack):
        deep, stats, idx_ref = pack
        if carry == "drift":
            stats = drift_correct_gnstats(stats, quant, gn_step_index(t, nb_steps), idx_ref)
        return m_reu.load_gnstats(stats)(x, t, deep_feature=deep)

    return apply_full, apply_shallow


def make_serving_sampler(
    cfg,
    state_dict,
    nb_steps,
    *,
    device="cuda",
    conv_int8: bool = True,
    static_gn: bool = True,
    microbatch: Optional[int] = None,
    calib_batch: int = 8,
    generator: Optional[torch.Generator] = None,
    x_cal: Optional[torch.Tensor] = None,
    scheduler_alpha: str = "linear",
    alpha_param: float = 0.02,
    scheduler_gamma: str = "linear",
    gamma_params=(1.0, 0.0, 3.0),
    two_head: Optional[bool] = None,
    attn_softmax_dtype: Optional[str] = None,
    cache_interval: Optional[int] = None,
    x_c: Optional[torch.Tensor] = None,
    gn_carry=False,
):
    """Calibrate once, then serve. Returns ``sample(x0) -> x``.

    ``cfg``: a UNet2DConfig; ``state_dict``: its fp32 weights. The first
    ``sample()`` calibrates (when a tier needs it) on ``x_cal``, or on
    ``min(calib_batch, B)`` normal draws from ``generator`` (seeded 0 on
    ``device`` by default), through the exact model. A static int8 tier is
    sensitive to its scales' last bits: a scale 1e-6 apart moves every
    activation that close to a rounding boundary by one step.

    ``static_gn`` requires the linear alpha schedule. ``attn_softmax_dtype``
    relaxes the serving model's softmax. ``cache_interval`` (> 1) selects
    the cached chain at ``cfg.cache_depth``. ``x_c``: super-res
    conditioning, batch-aligned with x0 (calibration takes its leading
    rows); not with ``microbatch``. ``microbatch``: batches larger than it
    run microbatch by microbatch (and must divide by it). ``gn_carry``:
    False; True or "carry" (record/reuse statistics over a cached group:
    needs ``cache_interval > 1``, excludes ``static_gn``); "drift" (the
    carried statistics shifted per step by calibrated tables: linear alpha).
    """
    if static_gn and scheduler_alpha != "linear":
        raise ValueError("static_gn requires the linear alpha schedule")
    if x_c is not None and microbatch:
        raise ValueError("x_c conditioning is not supported with microbatch "
                         "(the conditional workloads fit in one batch)")
    carry_mode = {False: None, True: "carry"}.get(gn_carry, gn_carry)
    if carry_mode not in (None, "carry", "drift"):
        raise ValueError(f"gn_carry must be False/True/'carry'/'drift', got {gn_carry!r}")
    if carry_mode and static_gn:
        raise ValueError("gn_carry and static_gn both replace GroupNorm — pick one")
    if carry_mode and not (cache_interval is not None and cache_interval > 1):
        raise ValueError("gn_carry reuses stats across a cached group — it "
                         "requires cache_interval > 1")
    if carry_mode == "drift" and scheduler_alpha != "linear":
        raise ValueError("gn_carry='drift' indexes the calibrated GN tables "
                         "by step — it requires the linear alpha schedule")
    if two_head is None:
        two_head = cfg.out_channels == 2 * cfg.in_channels
    device = torch.device(device)

    m_cal, model = serving_model_pair(
        cfg, state_dict, device=device, conv_int8=True if conv_int8 else None,
        int8_static=conv_int8,
        # the drift carry calibrates the GN tables for its correction but
        # serves record/reuse GroupNorm
        static_gn=static_gn or carry_mode == "drift", gn_steps=nb_steps,
        relax_kw={"attn_softmax_dtype": attn_softmax_dtype}
        if attn_softmax_dtype is not None else None)
    pair = carry_models(model, state_dict) if carry_mode else ()
    sched = dict(nb_steps=nb_steps, scheduler_alpha=scheduler_alpha, alpha_param=alpha_param,
                 scheduler_gamma=scheduler_gamma, gamma_params=gamma_params, two_head=two_head)
    caching = cache_interval is not None and cache_interval > 1
    quant = None

    def _calibrate(x_like):
        nonlocal quant, m_cal
        xc = x_cal
        if xc is None:
            gen = generator if generator is not None else \
                torch.Generator(device=device).manual_seed(0)
            xc = torch.randn((min(calib_batch, x_like.shape[0]),) + tuple(x_like.shape[1:]),
                             generator=gen, device=device, dtype=torch.float32)
        quant = calibrate_sampling(m_cal, xc, x_c=None if x_c is None else x_c[:xc.shape[0]],
                                   **sched)
        m_cal = None  # its weights are not needed again
        for m in (model,) + pair:
            m.load_quant(quant)

    def sample(x0):
        """Denoise x0 (N, C, H, W) with the serving configuration."""
        if m_cal is not None and quant is None:
            _calibrate(x0)
        if caching:
            full, shallow = cached_forwards(pair or model, carry=carry_mode,
                                            nb_steps=nb_steps, quant=quant)
        # a batch above the microbatch never falls back to the full batch
        if microbatch and x0.shape[0] > microbatch:
            return sample_iadb_microbatched(
                full if caching else model, x0, microbatch=microbatch,
                apply_shallow=shallow if caching else None,
                cache_interval=cache_interval if caching else None, **sched)
        if caching:
            return sample_iadb_cached(full, shallow, x0, cache_interval=cache_interval,
                                      x_c=x_c, **sched)
        return sample_iadb(model, x0, x_c=x_c, **sched)[0]

    return sample


def make_serving_sampler_ddim(
    cfg,
    state_dict,
    scheduler,
    num_inference_steps,
    *,
    device="cuda",
    conv_int8: bool = True,
    int8_mode: str = "static",
    static_gn: bool = False,
    calib_batch: int = 8,
    generator: Optional[torch.Generator] = None,
    attn_softmax_dtype: Optional[str] = None,
    relax_kw: Optional[dict] = None,
    cache_interval: Optional[int] = None,
    gn_smooth_window: Optional[int] = None,
    verbose: bool = False,
):
    """The DDIM baseline's counterpart of :func:`make_serving_sampler`:
    calibrate once on a DDIM trajectory (``calibrate_sampling_ddim``), then
    serve. The static-GN tables are keyed on the sampler's scan position
    (DDIM's integer timesteps carry no index), so sampling runs with
    ``pass_step_idx``. ``static_gn`` is off by default here, as in the JAX
    package, whose DDIM static-GN tier failed its fidelity gate.
    ``conv_int8`` with ``int8_mode`` "static" calibrates the activation
    scales; "dynamic" serves dynamic int8. ``relax_kw``: serving-only
    config relaxations (``cli/common.py::serving_relax_kw``);
    ``attn_softmax_dtype`` is one of them. ``cache_interval`` (> 1): the
    feature-reuse chain (``sample_ddim_cached``; calibration runs the full
    model). ``gn_smooth_window``: with ``static_gn``, smooth the calibrated
    tables along the step axis (``smooth_gn_tables``). Calibration draws
    ``min(calib_batch, B)`` normal samples from ``generator`` (seeded 0 on
    ``device`` by default) at the first call, or at ``sample.calibrate(shape)``
    before it; ``verbose`` prints its seconds. Returns
    ``sample(x0, collect_frames=False) -> x``, or ``(x, frames)`` with
    ``collect_frames`` (None under the cached chain, which keeps none)."""
    from bndm_tpu_torch.samplers.ddim import sample_ddim, sample_ddim_cached

    device = torch.device(device)
    relax = dict(relax_kw or {})
    if attn_softmax_dtype is not None:
        relax["attn_softmax_dtype"] = attn_softmax_dtype
    m_cal, model = serving_model_pair(
        cfg, state_dict, device=device, conv_int8=True if conv_int8 else None,
        int8_static=conv_int8 and int8_mode == "static", static_gn=static_gn,
        gn_steps=num_inference_steps, relax_kw=relax or None)
    caching = cache_interval is not None and cache_interval > 1

    def calibrate(shape):
        """Run the pending calibration for batches of ``shape``, if any."""
        nonlocal m_cal
        if m_cal is None:
            return
        t0 = time.time()
        gen = generator if generator is not None else \
            torch.Generator(device=device).manual_seed(0)
        x_cal = torch.randn((min(calib_batch, shape[0]),) + tuple(shape[1:]),
                            generator=gen, device=device, dtype=torch.float32)
        quant = calibrate_sampling_ddim(m_cal, x_cal, scheduler, num_inference_steps)
        if static_gn and gn_smooth_window:
            quant = smooth_gn_tables(quant, gn_smooth_window)
        model.load_quant(quant)
        m_cal = None  # its weights are not needed again
        if verbose:
            print(f"serving calibration: {time.time() - t0:.1f}s ({len(quant)} calibrated sites)")

    def sample(x0, collect_frames=False):
        """Denoise x0 (N, C, H, W) with the DDIM serving configuration."""
        calibrate(x0.shape)
        if caching:
            out = sample_ddim_cached(
                lambda x, t, step_idx=None: model(x, t, step_idx=step_idx, return_deep=True),
                lambda x, t, deep, step_idx=None: model(x, t, step_idx=step_idx,
                                                        deep_feature=deep),
                x0, scheduler=scheduler, num_inference_steps=num_inference_steps,
                cache_interval=cache_interval, pass_step_idx=static_gn)
            return (out, None) if collect_frames else out
        out, frames = sample_ddim(model, x0, scheduler=scheduler,
                                  num_inference_steps=num_inference_steps,
                                  collect_frames=collect_frames, pass_step_idx=static_gn)
        return (out, frames) if collect_frames else out

    sample.calibrate = calibrate
    return sample


def make_validated_serving_sampler(
    cfg,
    state_dict,
    nb_steps,
    res,
    *,
    device="cuda",
    probe_batch: int = 8,
    gate_ssim: float = 0.99,
    gate_psnr_db: float = 35.0,
    cache_interval: int = 12,
    microbatch: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    verbose: bool = True,
    _candidates=None,
    **sched_kw,
):
    """Probe the ladder of tier stacks and serve the fastest that passes on
    these weights. Returns ``(sample, report)``.

    The ladder, fastest first, each probed end to end on ``probe_batch``
    samples against the plain path (``cfg``'s own dtype, no tier) on the
    same x0:

      1. int8-static + static-GN + bf16 softmax + cached(cache_interval)
      2. int8-static + drift-corrected GN carry + bf16 softmax + cached
      3. int8-static + GN carry + bf16 softmax + cached(cache_interval)
      4. int8-static + bf16 softmax + cached(cache_interval)
      5. int8-static + bf16 softmax + cached(max(2, cache_interval // 2))
      6. cached(max(2, cache_interval // 2))
      7. the plain path itself, never rejected

    A tier passes at mean SSIM >= ``gate_ssim`` and mean PSNR >=
    ``gate_psnr_db`` on [0, 1] images. ``res``: the probe's spatial size.
    The probe x0 and the calibration batch are drawn from ``generator``
    (seeded 0 on ``device`` by default); every tier calibrates on the same
    batch. ``sched_kw`` goes to :func:`make_serving_sampler`.
    ``_candidates``: a list of (name, kwargs) in place of the ladder.
    """
    from bndm_tpu_torch.utils.metrics import psnr, ssim

    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    half = max(2, cache_interval // 2)
    candidates = _candidates if _candidates is not None else [
        ("int8+staticGN+bf16sm+cached(i=%d)" % cache_interval,
         dict(conv_int8=True, static_gn=True, attn_softmax_dtype="bfloat16",
              cache_interval=cache_interval)),
        ("int8+gndrift+bf16sm+cached(i=%d)" % cache_interval,
         dict(conv_int8=True, static_gn=False, gn_carry="drift",
              attn_softmax_dtype="bfloat16", cache_interval=cache_interval)),
        ("int8+gncarry+bf16sm+cached(i=%d)" % cache_interval,
         dict(conv_int8=True, static_gn=False, gn_carry=True,
              attn_softmax_dtype="bfloat16", cache_interval=cache_interval)),
        ("int8+bf16sm+cached(i=%d)" % cache_interval,
         dict(conv_int8=True, static_gn=False, attn_softmax_dtype="bfloat16",
              cache_interval=cache_interval)),
        ("int8+bf16sm+cached(i=%d)" % half,
         dict(conv_int8=True, static_gn=False, attn_softmax_dtype="bfloat16",
              cache_interval=half)),
        ("bf16+cached(i=%d)" % half,
         dict(conv_int8=False, static_gn=False, cache_interval=half)),
    ]

    shape = (probe_batch, cfg.in_channels, res, res)
    x_probe = torch.randn(shape, generator=generator, device=device)
    x_cal = torch.randn((min(sched_kw.get("calib_batch", 8), probe_batch),) + shape[1:],
                        generator=generator, device=device)

    def build(kw):
        return make_serving_sampler(cfg, state_dict, nb_steps, device=device, x_cal=x_cal,
                                    microbatch=microbatch, **kw, **sched_kw)

    def to01(x):
        return torch.clamp((x + 1) / 2, 0, 1)

    sample_plain = build(dict(conv_int8=False, static_gn=False))
    ref = to01(sample_plain(x_probe))

    report = []
    for name, kw in candidates:
        sample = build(kw)
        out = to01(sample(x_probe))
        s = float(torch.mean(ssim(out, ref)))
        p = float(torch.mean(psnr(out, ref)))
        ok = s >= gate_ssim and p >= gate_psnr_db
        report.append({"tier": name, "ssim": round(s, 4), "psnr_db": round(p, 2),
                       "gate": "pass" if ok else "fail"})
        if verbose:
            print(f"serving probe {name}: SSIM {s:.4f} PSNR {p:.1f} dB "
                  f"{'PASS' if ok else 'fail'}", flush=True)
        if ok:
            report.append({"chosen": name})
            return sample, report
    report.append({"chosen": "bf16 parity path"})
    return sample_plain, report
