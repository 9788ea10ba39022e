"""Shared CLI plumbing: devices, run-folder naming, L loading, weights IO.

Counterpart of ``bndm_tpu/cli/common.py``. The reference encodes run
identity in the output directory name computed from flag values and *finds*
checkpoints at test time by recomputing that name; the convention is
reproduced exactly, so the JAX CLI and this one share run folders.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from bndm_tpu_torch.ops.cov import load_cov_L


def resolve_device(name="cuda"):
    """The torch device an entry point runs on. CUDA unless the caller asks
    for the CPU; raises when CUDA was asked for and is missing, rather than
    carrying on quietly on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            "--device=cpu to run on the CPU")
    return dev


def start_distributed(opt, device):
    """Join the multi-process run the launch flags ask for
    (``--coordinator_address``, ``--num_processes``, ``--process_id``, as
    the JAX CLIs take them; NCCL on CUDA, gloo on the CPU) and return this
    rank's device; ``device`` as it is for a single process."""
    if opt.coordinator_address or (opt.num_processes or 0) > 1:
        from bndm_tpu_torch.parallel.distributed import init_distributed

        return init_distributed(opt.coordinator_address, opt.num_processes, opt.process_id,
                                device=device)
    return device


def is_main_process():
    """Rank 0 (or the only process): the one that writes files."""
    from bndm_tpu_torch.parallel.distributed import host_shard_info

    return host_shard_info()[0] == 0


def rows_of(mesh, x0):
    """This rank's block of the batch ``x0`` (which every rank holds), and
    the function that gathers the ranks' results back into the batch; the
    whole ``x0`` and the identity without a mesh or where the rows do not
    divide across the ranks (the JAX CLIs shard only a divisible batch)."""
    from bndm_tpu_torch.parallel.mesh import gather_batch, shard_batch

    if mesh is None or x0.shape[0] % mesh.size():
        return x0, lambda y: y
    return shard_batch(mesh, x0), lambda y: gather_batch(mesh, y)


def disable_tf32():
    """Full fp32 for float32 matmuls and convolutions. cuDNN runs fp32
    convolutions in TF32 by default (10-bit mantissa); the JAX reference's
    fp32 path does not."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def make_generator(device, *seeds):
    """A ``torch.Generator`` on ``device`` seeded from a path of integers
    (e.g. (seed, batch index)): distinct paths give independent streams."""
    s = int(np.random.SeedSequence([int(v) for v in seeds]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def output_folder_name(opt):
    """Reference run-folder naming."""
    outer = (
        f"results_gaussianBN_{opt.conditional_type}" if opt.is_conditional else "results_gaussianBN"
    )
    if opt.scheduler_gamma == "linear" or opt.optimize_scheduler_param:
        name = f"{opt.dataset}_{opt.noise_type}_{opt.scheduler_gamma}_outc{opt.out_channel}_seed{opt.seed}"
    else:
        remap = "_remap" if opt.remap else ""
        name = (
            f"{opt.dataset}_{opt.noise_type}_{opt.scheduler_gamma}_{opt.scheduler_param}"
            f"_{opt.scheduler_param_s}_{opt.scheduler_param_e}_outc{opt.out_channel}{remap}_seed{opt.seed}"
        )
    return os.path.join(outer, name)


def noise_folder_name(noise_type):
    return {
        "gaussianBN": "gwn2gbn",
        "gaussian": "gwn",
        "gaussianRN": "gwn2grn",
        "GBN": "gbn",
    }[noise_type]


def serving_relax_kw(args):
    """Serving-only relaxations of the model config asked for on the CLI, as
    keyword arguments of ``dataclasses.replace`` on the serving model's
    config; calibration keeps the exact model (fp32 softmax)."""
    kw = {}
    dt = getattr(args, "attn_softmax_dtype", "float32")
    if dt != "float32":
        kw["attn_softmax_dtype"] = dt
    return kw


def load_L_for(noise_type, bluenoise_dir="bluenoise"):
    kind = "red" if noise_type == "gaussianRN" else "blue"
    return load_cov_L(res=64, dimension=3, kind=kind,
                      search_dirs=(".", bluenoise_dir), cache_dir=bluenoise_dir)


def save_params(path, tree):
    """A flax-style params tree of numpy arrays -> the flat ``.npz`` the JAX
    package's ``save_params`` writes (keys 'params/a/b/leaf')."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(tree.get("params", tree), ("params",))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_params(path):
    """A flat ``.npz`` params file (as the JAX package's ``save_params``
    writes it, keys 'params/a/b/leaf') -> nested dict of numpy arrays."""
    tree = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def load_pixel_unet_params(out_dir):
    """Weights for the pixel CLI's test path, as a torch state_dict on the
    CPU: the JAX package's ``model.npz`` first (carried across by
    ``state_dict_from_flax``), else the reference's torch ``model.ckpt`` at
    the same path."""
    from bndm_tpu_torch.models.convert import (canonical_state_dict,
                                               load_torch_checkpoint,
                                               state_dict_from_flax)

    npz = os.path.join(out_dir, "model.npz")
    if os.path.exists(npz):
        return state_dict_from_flax(load_params(npz))
    ckpt = os.path.join(out_dir, "model.ckpt")
    if os.path.exists(ckpt):
        print(f"loading reference torch checkpoint: {ckpt}")
        return canonical_state_dict(load_torch_checkpoint(ckpt))
    raise FileNotFoundError(f"no model.npz or model.ckpt in {out_dir}")


def load_tree_unet_params(out_dir):
    """Weights for the diffusers-tree pipelines (DDIM, latent), as a torch
    state_dict on the CPU: ``unet/model.npz`` first (the JAX package's
    layout), else the ``save_pretrained`` tree (config.json +
    diffusion_pytorch_model.safetensors/.bin), as
    ``UNet2DModel.from_pretrained(output_dir + "/unet")``. Returns
    (state_dict, UNet2DConfig | None): the config comes from
    unet/config.json when present, so the published architecture wins over
    the flags."""
    from bndm_tpu_torch.models.convert import (load_pretrained_unet, state_dict_from_flax,
                                               unet_config_from_diffusers)

    unet_dir = os.path.join(out_dir, "unet")
    cfg = None
    cfg_path = os.path.join(unet_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = unet_config_from_diffusers(json.load(f))
    npz = os.path.join(unet_dir, "model.npz")
    if os.path.exists(npz):
        return state_dict_from_flax(load_params(npz)), cfg
    print(f"loading diffusers save_pretrained tree: {unet_dir}")
    sd, tree_cfg = load_pretrained_unet(unet_dir)
    return sd, (tree_cfg or cfg)


def hf_train_loop(args, state, train_step, epoch_batches, out_dir, save_eval, *, device,
                  steps_per_epoch, loss_fmt, mesh=None):
    """The train loop of the DDIM and latent CLIs, as the JAX CLIs run it:
    ``--resume_from_checkpoint`` ("latest" or checkpoint-N) restores the
    whole state on every rank and continues its step count (the epochs
    start again from 0), then rank 0's state is broadcast (``replicate``);
    one ``train_step(state, batch, (seed, step))`` per batch of
    ``epoch_batches(epoch)`` (this rank's rows); a checkpoint every
    ``--checkpointing_steps`` and at the end; the losses read back once per
    epoch and logged; ``save_eval(state)``, losses.txt and losses.png after
    every ``--save_model_epochs``-th epoch and the last; ``--max_steps``
    caps the steps. Only rank 0 writes, and every rank waits for its
    writes."""
    from bndm_tpu_torch.ckpt.manager import CheckpointManager
    from bndm_tpu_torch.parallel.distributed import barrier
    from bndm_tpu_torch.parallel.mesh import replicate
    from bndm_tpu_torch.utils.logging import MetricLogger, save_loss_curve

    main = is_main_process()
    mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"),
                            max_to_keep=args.checkpoints_total_limit or 3)
    step = 0
    if args.resume_from_checkpoint:
        want = None if args.resume_from_checkpoint == "latest" else int(
            args.resume_from_checkpoint.split("-")[-1])
        known = want is None or want in mgr.all_steps()
        if known and mgr.restore(state, step=want) is not None:
            step = state.step
            print(f"Resuming from checkpoint step {step}")
        else:
            print(f"Checkpoint '{args.resume_from_checkpoint}' does not exist. "
                  "Starting a new training run.")
    replicate(mesh, state)

    def save(step):
        if main:
            mgr.save(step, state)
        barrier()

    logger = MetricLogger(os.path.join(out_dir, args.logging_dir)) if main else None
    losses = []
    for epoch in range(args.num_epochs):
        epoch_metrics = []
        for batch in epoch_batches(epoch):
            batch = torch.from_numpy(np.asarray(batch)).to(device, non_blocking=True)
            epoch_metrics.append(train_step(state, batch, (args.seed, step))["loss"])
            step += 1
            if step % args.checkpointing_steps == 0:
                save(step)
            if args.max_steps and step >= args.max_steps:
                break
        fetched = torch.stack(epoch_metrics).cpu().numpy() if epoch_metrics else []
        losses.extend(float(loss) for loss in fetched)
        if main:
            for off, loss in enumerate(fetched):
                logger.log({"loss": float(loss)}, step - len(fetched) + off)
            print(f"epoch {epoch}: mean loss {np.mean(losses[-steps_per_epoch:]):{loss_fmt}}")
            if epoch % args.save_model_epochs == 0 or epoch == args.num_epochs - 1:
                save_eval(state)
                np.savetxt(os.path.join(out_dir, "losses.txt"), np.asarray(losses))
                save_loss_curve(losses, os.path.join(out_dir, "losses.png"))
        barrier()
        if args.max_steps and step >= args.max_steps:
            break
    save(step)
    mgr.wait()
    mgr.close()
    if main:
        logger.close()


def _to_numpy(arr):
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().cpu().numpy()
    return np.asarray(arr)


def save_image_grid(arr_nchw, path):
    """Write each image of a [-1, 1] NCHW batch to ``path.format(i)``."""
    from PIL import Image

    a = _to_numpy(arr_nchw)
    a = np.clip((a + 1.0) / 2.0, 0.0, 1.0)
    a = (np.transpose(a, (0, 2, 3, 1)) * 255).astype(np.uint8)
    for i, img in enumerate(a):
        Image.fromarray(img).save(path.format(i))


class AsyncImageWriter:
    """Background PNG encoder for gallery-scale eval.

    Encoding on a daemon thread overlaps PIL with the next batch's sampling.
    A bounded queue applies back-pressure so at most ``max_queue`` batches of
    pixels are in flight. Encode errors are captured and re-raised on the
    next submit()/close(), never silently dropped.
    """

    def __init__(self, max_queue: int = 4):
        import queue
        import threading

        self._q = queue.Queue(maxsize=max_queue)
        self._err = None
        self._n = 0
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                arr, path = item
                save_image_grid(arr, path)
                self._n += arr.shape[0]
            except Exception as e:  # noqa: BLE001 — surfaced on submit/close
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, arr_nchw, path):
        if self._err:
            raise self._err
        self._q.put((_to_numpy(arr_nchw), path))

    def close(self):
        """Drain the queue, stop the thread, re-raise any encode error.
        Returns the number of images written."""
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err
        return self._n
