"""The controls of the cells' comparisons: what a step down in precision
reads on the numbers each cell compares.

* Training cells: the reference computed with every operand of a
  convolution and a linear layer rounded to float8 e4m3 (the step below the
  configuration's bfloat16) in the program's place, against the float32
  reference, over the checked steps. Beside it the faults a train step can
  have, planted in the reference put in the program's place: half of each
  batch left out (the loss of the rest scaled to the batch's), the first
  leaf's update doubled, the state left unchanged.
* The sampling cell: the program with its own int8-static serving path
  switched on (``serving_model_pair(..., int8_static=True)``, calibrated on
  one exact trajectory as the latent CLI does), at the inputs the bf16 chain
  reached on a batch of the cell's size, against the reference UNet; and,
  for the decode, which has no lower path in the program, the reference
  decode with its operands rounded to float8 e4m3 in the program's place,
  of that chain's final latents. The program's readings at the same inputs
  beside them.

    python3 -m perfbench.control --workload <cell> --seeds 1 2 3

prints one JSON line a seed (run on the card, from the checkout's root).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def train_control(ctx, driver):
    from perfbench.drivers import _train
    from perfbench.reference import nets

    ctx.inputs = driver.inputs(ctx)
    n = ctx.traffic["checked_steps"]
    ref = _train.reference_steps(ctx, n)
    half = _train.reference_steps(ctx, n, keep=ctx.traffic["batch_size"] // 2)
    losses, grad1, delta = ref
    first = next(iter(delta))
    doubled = dict(delta, **{first: 2.0 * delta[first]})
    return {"control": _train.compare(_train.reference_steps(ctx, n, nets.fp8), ref),
            "faults": {"half_batch": _train.compare(half, ref),
                       "doubled_update": _train.compare((losses, grad1, doubled), ref),
                       "unchanged_state": _train.compare(
                           (losses, dict.fromkeys(grad1, 0.0), dict.fromkeys(delta, 0.0)),
                           ref)}}


def sample_control(ctx, driver):
    from bndm_tpu_torch.ops.int8 import calibrate_sampling
    from bndm_tpu_torch.samplers.iadb import sample_iadb
    from bndm_tpu_torch.serving import serving_model_pair

    from perfbench import datagen, weights
    from perfbench.drivers import _port
    from perfbench.reference import nets, sample

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    u_spec = nets.unet_spec(cfg["unet"])
    dt = getattr(torch, cfg["weights_dtype"])
    init = weights.make(u_spec, ctx.seed, dev, dt)
    mcfg = _port.unet_config(cfg["port"])
    _, plain = serving_model_pair(mcfg, init, device=dev)
    m_cal, int8 = serving_model_pair(mcfg, init, device=dev, conv_int8=True, int8_static=True)
    res, bs, steps = cfg["unet"]["sample_size"], tr["batch_size"], tr["steps"]
    x_cal = datagen.normal(ctx.seed, 3, (min(4, bs), cfg["unet"]["in_channels"], res, res), dev)
    int8.load_quant(calibrate_sampling(m_cal, x_cal, steps, two_head=True))
    del m_cal
    keep = driver._picks(ctx.seed, steps, tr["checked_steps"])
    rec = driver._Recorder(plain, set(keep))
    x0 = datagen.normal(ctx.seed, 2, (1, bs, cfg["unet"]["in_channels"], res, res), dev)[0]
    z, _ = sample_iadb(rec, x0, nb_steps=steps, two_head=True)
    P_u = driver.unet_weights(ctx, u_spec)
    unet_ctl = max(driver.unet_gaps(P_u, cfg["unet"], rec.kept, int8))
    unet_prog = max(driver.unet_gaps(P_u, cfg["unet"], rec.kept))
    del plain, int8, rec
    _, decode = driver.build_program(ctx)
    imgs = sample.to_uint8(decode(z))
    P_v = driver.vae_weights(ctx)
    rows = tr["reference_rows"]
    return {"control": {"unet_gap": unet_ctl,
                        "decode_gap": driver.decode_gap(P_v, cfg["vae"], z, imgs, rows, nets.fp8)},
            "program": {"unet_gap": unet_prog,
                        "decode_gap": driver.decode_gap(P_v, cfg["vae"], z, imgs, rows)}}


def control(workload, seed, device="cuda", config=None, traffic=None):
    from perfbench import run

    ctx, driver = run.make_ctx(workload, seed, 0.0, 0, device, config, traffic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if ctx.traffic["driver"] == "sample_latent":
        return sample_control(ctx, driver)
    return train_control(ctx, driver)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        out = control(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
