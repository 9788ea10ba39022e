"""Paper-figure reproduction CLI in PyTorch (noise only, no model weights).

Counterpart of ``bndm_tpu/cli/figs.py`` (the reference's
``scripts/fig_main_3_4_inset_10_supp_1_2.py``), with the same files:

  * fig 3/4: Gaussian blue noise and its |FFT| spectrum at t in {0, 500, 999};
  * inset:   the gamma sigmoid curves for tau in {0.1, 0.2, 0.5, 1.0, 1000};
  * fig 10:  Gaussian red noise and its spectrum at t = 0;
  * supp 1/2: the |FFT| of 128^2 blue noise averaged over 100 realisations,
    repetitive tiles against independent ones (the artifact against the
    clean stitch), as EXR where a codec is available, else .npy, plus a PNG.

On CUDA the 64^2 draws launch K1 (``tri_matmul``) at M = 3, four times, and
each supplementary setting draws its realisations through one batched
``get_noise`` call: K1 once at M = realisations x 4 tiles x 3 channels.

Usage:
    python -m bndm_tpu_torch.cli.figs --output_dir scripts/results [--realizations 100]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from bndm_tpu_torch.ops.noise import get_noise
from bndm_tpu_torch.ops.schedules import gamma_schedule
from bndm_tpu_torch.utils.spectrum import compute_fft

NB_STEPS = 1000
SCHED = "sigmoid"
SCHED_PARAMS = (1000.0, 0.0, 3.0)


def _save_png(arr_chw, path):
    from PIL import Image

    a = np.transpose(np.asarray(arr_chw), (1, 2, 0))
    Image.fromarray((np.clip(a, 0, 1) * 255).astype(np.uint8)).save(path)


def _save_exr_or_npy(img2d, path_base):
    """EXR through OpenCV or imageio where either writes it (as the
    reference does), else ``.npy``; returns the path written."""
    img2d = np.asarray(img2d, dtype=np.float32)
    try:
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        import cv2

        if cv2.imwrite(path_base + ".exr", img2d):
            return path_base + ".exr"
    except Exception:  # noqa: BLE001 -- no cv2, or no EXR codec in it
        pass
    try:
        import imageio.v3 as iio

        iio.imwrite(path_base + ".exr", img2d)
        return path_base + ".exr"
    except Exception:  # noqa: BLE001 -- no imageio, or no EXR plugin
        np.save(path_base + ".npy", img2d)
        return path_base + ".npy"


def _gamma_at(t_step, device):
    t = torch.full((1,), float(t_step), dtype=torch.float32)
    return gamma_schedule(t, NB_STEPS, SCHED, SCHED_PARAMS).to(device)


def noise_and_spectrum(L, white, t_step, noise_type="gaussianBN"):
    """The noise of ``white`` (B, 3, res, res) at ``t_step`` (used in place,
    as the reference's test-time draw is) and its |FFT|."""
    r = get_noise(white, L, _gamma_at(t_step, white.device), noise_type=noise_type,
                  train=False, inplace=True)
    return r.noise, torch.abs(compute_fft(r.noise))


def batch_tiles(white):
    """The input whose res-128 draw gives each realisation of ``white`` (R,
    C, 128, 128) its own four tiles. The noise engine takes the quadrants of
    a batch in tile-major order and regroups them four by four (the
    reference's layout, exact at one sample); this places realisation j's
    quadrant k where that regrouping reads sample j's tile k, so one batched
    call equals R calls of one sample."""
    b, c = white.shape[:2]
    quads = torch.stack([white[:, :, :64, :64], white[:, :, :64, 64:],
                         white[:, :, 64:, :64], white[:, :, 64:, 64:]], dim=1)
    q = quads.reshape(4, b, c, 64, 64)  # entry (q, s) = flat tile q*b + s
    top = torch.cat([q[0], q[1]], dim=-1)
    bottom = torch.cat([q[2], q[3]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def supp_spectrum(L, white, repetitive):
    """Supplementary figures 1/2: the mean |FFT| over the realisations
    ``white`` (R, 3, 128, 128) and the last realisation's noise, through
    one batched draw. ``repetitive`` repeats each realisation's top-left
    64^2 tile over its four quadrants."""
    if repetitive:
        white = white[:, :, :64, :64].repeat(1, 1, 2, 2)
    noise, mags = noise_and_spectrum(L, batch_tiles(white), 0)
    return mags.mean(dim=0), noise[-1]


def _normalized(a):
    a = a.detach().cpu().numpy()
    return (a - a.min()) / (a.max() - a.min())


def _white(shape, device, *seeds):
    from bndm_tpu_torch.cli.common import make_generator

    return torch.randn(shape, generator=make_generator(device, *seeds), device=device)


def fig_main_3_4(L, outdir, seed):
    for i, cur_step in enumerate([0, 500, 999]):
        noise, fft_mag = noise_and_spectrum(L, _white((1, 3, 64, 64), L.device, seed, 1, i),
                                            cur_step)
        _save_png(_normalized(noise[0]), f"{outdir}/gaussianBN_res64_{cur_step}.png")
        f = fft_mag[0, 0].cpu().numpy()
        _save_png(np.repeat((f / f.max())[None], 3, 0),
                  f"{outdir}/gaussianBN_res64_spectrum_{cur_step}.png")


def fig_main_10(L_rn, outdir, seed):
    noise, fft_mag = noise_and_spectrum(L_rn, _white((1, 3, 64, 64), L_rn.device, seed, 2), 0)
    _save_png(_normalized(noise[0]), f"{outdir}/gaussianRN_res64_0.png")
    f = fft_mag[0, 0].cpu().numpy()
    _save_png(np.repeat((f / f.max())[None], 3, 0), f"{outdir}/gaussianRN_res64_spectrum_0.png")


def fig_main_inset(outdir):
    """gamma_t over t/T for tau in {0.1, 0.2, 0.5, 1.0, 1000}, drawn with
    PIL as the port's other curves are (utils/logging.py)."""
    from bndm_tpu_torch.utils.logging import plot_series

    x = torch.linspace(0, NB_STEPS, NB_STEPS, dtype=torch.float64)
    plot_series([gamma_schedule(x, NB_STEPS, "sigmoid", (tau, 0.0, 3.0)).numpy()
                 for tau in (0.1, 0.2, 0.5, 1.0, 1000.0)], f"{outdir}/inset.png")


def fig_supp_1_2(L, outdir, seed, realizations=100):
    """Repetitive tiles show grid artifacts in the averaged spectrum;
    independently stitched tiles do not. Returns the two normalized
    spectra by ``repetitive``."""
    spectra = {}
    for repetitive in (True, False):
        white = _white((realizations, 3, 128, 128), L.device, seed, 3, int(repetitive))
        avg_fft, last_noise = supp_spectrum(L, white, repetitive)
        _save_png(_normalized(last_noise),
                  f"{outdir}/gaussianBN_res128_repetitive_{repetitive}_noise.png")
        spec = avg_fft[0].cpu().numpy()
        spec = spec / spec.max()
        path = _save_exr_or_npy(spec, f"{outdir}/gaussianBN_res128_repetitive_{repetitive}_spectrum")
        _save_png(np.repeat(spec[None], 3, 0),
                  f"{outdir}/gaussianBN_res128_repetitive_{repetitive}_spectrum.png")
        print(f"supp fig (repetitive={repetitive}): spectrum -> {path}")
        spectra[repetitive] = spec
    return spectra


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", type=str, default="scripts/results")
    p.add_argument("--realizations", type=int, default=100)
    p.add_argument("--bluenoise_dir", type=str, default="bluenoise",
                   help="directory with the reference L-matrix .npz artifacts; generated "
                        "if absent")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the CPU runs only when asked for")
    return p.parse_args(argv)


def main(argv=None):
    from bndm_tpu_torch.cli.common import disable_tf32, resolve_device
    from bndm_tpu_torch.ops.cov import load_cov_L

    args = parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    os.makedirs(args.output_dir, exist_ok=True)
    L, L_rn = (torch.from_numpy(load_cov_L(res=64, kind=kind,
                                           search_dirs=(".", args.bluenoise_dir),
                                           cache_dir=args.bluenoise_dir)).to(device)
               for kind in ("blue", "red"))
    fig_main_3_4(L, args.output_dir, args.seed)
    fig_main_inset(args.output_dir)
    fig_main_10(L_rn, args.output_dir, args.seed)
    spectra = fig_supp_1_2(L, args.output_dir, args.seed, args.realizations)
    print(f"figures written to {args.output_dir}")
    return spectra


if __name__ == "__main__":
    main()
