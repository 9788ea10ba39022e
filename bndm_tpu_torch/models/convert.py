"""Weight carry between the PyTorch UNet and the JAX package's layout.

The port's own copy of the JAX package's converter
(``bndm_tpu/models/convert.py``): ``state_dict_from_flax`` carries a flax
params tree of numpy arrays into a diffusers-named state_dict of torch
tensors (``convert_flax_params``), ``flax_from_state_dict`` carries it back
(``torch_key_to_flax_path`` + ``convert_torch_state_dict``), so a model
trained by the port is written in the ``model.npz`` layout the JAX package
reads.

Layout rules (flax -> torch; the reverse inverts them):
  conv kernel (kh, kw, I, O)  -> weight (O, I, kh, kw)
  dense kernel (I, O)         -> weight (O, I)
  norm scale/bias             -> weight/bias
  path ("down_blocks_0", "resnets_1") -> "down_blocks.0.resnets.1"

The serving tiers' state outside the params (the flax ``quant`` and
``gnstats`` collections: int8 activation amax, calibrated GroupNorm
tables, carried per-sample statistics) crosses by the same path rule
through ``collection_from_flax`` into the flat names
``UNet2D.quant_state`` / ``UNet2D.gnstats`` use.

The diffusers ``save_pretrained`` trees the DDIM and latent pipelines write
and read (``unet/config.json`` + ``diffusion_pytorch_model.safetensors``,
``scheduler/scheduler_config.json``, ``model_index.json``) go through the
port's own minimal ``.safetensors`` reader and writer, a copy of the JAX
package's, so either package reads the trees the other writes.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

_LIST_NAMES = ("down_blocks", "up_blocks", "resnets", "attentions",
               "downsamplers", "upsamplers", "to_out")

# pre-0.14 diffusers AttentionBlock names -> the current ones
_LEGACY_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v",
                "proj_attn": "to_out.0"}


def _torch_name(module_path):
    """('down_blocks_0', 'resnets_1', 'conv1') -> 'down_blocks.0.resnets.1.conv1'.
    Digits split off only for list children ('linear_1' stays a name)."""
    parts = []
    for p in module_path:
        head, _, tail = p.rpartition("_")
        if tail.isdigit() and head in _LIST_NAMES:
            parts += [head, tail]
        else:
            parts.append(p)
    return ".".join(parts)


def state_dict_from_flax(params):
    """flax params tree (numpy leaves) -> diffusers-named torch state_dict."""
    flat = {}

    def walk(node, prefix):
        for name, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + (name,))
            else:
                flat[prefix + (name,)] = np.asarray(val)

    walk(params.get("params", params), ())

    sd = {}
    for path, arr in flat.items():
        module, leaf = path[:-1], path[-1]
        base = _torch_name(module)
        if leaf == "kernel":
            arr = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr.T
            sd[f"{base}.weight"] = arr
        elif leaf == "scale":
            sd[f"{base}.weight"] = arr
        elif leaf == "bias":
            sd[f"{base}.bias"] = arr
        else:
            raise ValueError(f"unexpected leaf {leaf} at {base}")
    # np.array copies: the leaves may be read-only views (np.load, jax)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def collection_from_flax(tree):
    """A flax variable collection other than params (``quant``,
    ``gnstats``; numpy or jax leaves) -> ``{"<module>.<leaf>": tensor}``
    in the port's module names, e.g. ("down_blocks_0", "resnets_0",
    "conv1", "act_amax") -> "down_blocks.0.resnets.0.conv1.act_amax".
    Leaves keep their layout: the collections hold only per-site scalars
    and per-group (T, G) / (B, G) tables."""
    out = {}

    def walk(node, prefix):
        for name, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + (name,))
            else:
                out[f"{_torch_name(prefix)}.{name}"] = torch.from_numpy(np.array(val))

    walk(tree, ())
    return out


def canonical_state_dict(sd):
    """Rename legacy attention keys (query/key/value/proj_attn) and drop
    non-parameter buffers, so a reference checkpoint loads strictly."""
    out = {}
    for key, val in sd.items():
        *module, leaf = key.split(".")
        if leaf not in ("weight", "bias"):
            continue  # e.g. num_batches_tracked
        module = [_LEGACY_ATTN.get(p, p) for p in module]
        out[".".join(module + [leaf])] = val
    return out


def load_torch_checkpoint(path):
    """Load a torch .ckpt/.pt state_dict on the CPU (weights only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def torch_key_to_flax_path(key):
    """'down_blocks.0.resnets.1.conv1.weight' ->
    ('down_blocks_0', 'resnets_1', 'conv1', 'weight')."""
    merged = []
    for p in key.split("."):
        if p.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    return tuple(merged)


def flax_from_state_dict(sd):
    """torch-style flat state_dict (torch tensors or numpy) -> flax params
    tree ``{"params": ...}`` of fp32 numpy arrays. Legacy attention names are
    renamed and non-parameter buffers skipped first
    (:func:`canonical_state_dict`)."""
    params = {}
    for key, val in canonical_state_dict(sd).items():
        arr = val.detach().float().cpu().numpy() if isinstance(val, torch.Tensor) \
            else np.asarray(val, np.float32)
        *module, leaf = torch_key_to_flax_path(key)
        if leaf == "weight":
            if arr.ndim == 4:
                name, arr = "kernel", np.transpose(arr, (2, 3, 1, 0))
            elif arr.ndim == 2:
                name, arr = "kernel", arr.T
            elif arr.ndim == 1:  # norm scale
                name = "scale"
            else:
                raise ValueError(f"unexpected weight ndim for {key}: {arr.shape}")
        else:
            name = "bias"
        node = params
        for p in module:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return {"params": params}


def export_torch_ckpt(model, path):
    """The model's weights as a reference ``model.ckpt``: an fp32 state_dict
    with the diffusers keys, loadable by the reference's
    ``model.load_state_dict(torch.load(...))``."""
    torch.save({k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()},
               path)


# ----------------------------- safetensors -----------------------------------

_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}
_SAFETENSORS_TAGS = {"float32": "F32", "float16": "F16", "float64": "F64", "int64": "I64",
                     "int32": "I32", "uint8": "U8", "bool": "BOOL"}


def load_safetensors(path):
    """Minimal ``.safetensors`` reader -> dict[str, np.ndarray] (BF16 widened
    to fp32)."""
    out = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        data_start = 8 + hlen
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            begin, end = meta["data_offsets"]
            f.seek(data_start + begin)
            raw = f.read(end - begin)
            if meta["dtype"] == "BF16":
                arr = (np.frombuffer(raw, np.uint16).astype(np.uint32) << 16).view(np.float32)
            else:
                arr = np.frombuffer(raw, _SAFETENSORS_DTYPES[meta["dtype"]])
            out[name] = arr.reshape(meta["shape"]).copy()
    return out


def save_safetensors(tensors, path, metadata=None):
    """Minimal ``.safetensors`` writer (numpy arrays or torch tensors), a
    file torch/diffusers and the JAX package read."""
    header = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name, arr in tensors.items():
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        arr = np.ascontiguousarray(arr)
        if str(arr.dtype) not in _SAFETENSORS_TAGS:
            raise ValueError(f"unsupported export dtype {arr.dtype} for {name}; "
                             "cast (e.g. bf16 -> f32) before export")
        raw = arr.tobytes()
        header[name] = {"dtype": _SAFETENSORS_TAGS[str(arr.dtype)], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


def load_state_dict_file(path):
    """A reference state_dict file (``.safetensors``, or a torch
    ``.ckpt``/``.pt``/``.bin``) -> canonical torch state_dict."""
    if str(path).endswith(".safetensors"):
        return canonical_state_dict({k: torch.from_numpy(v)
                                     for k, v in load_safetensors(path).items()})
    return canonical_state_dict(load_torch_checkpoint(path))


def load_reference_unet(path):
    """Reference UNet weights (``.ckpt`` or ``.safetensors``) as a canonical
    torch state_dict, the counterpart of the JAX package's
    ``load_reference_unet`` (which returns flax params)."""
    return load_state_dict_file(path)


def export_reference_unet(model_or_state_dict, path):
    """The weights (a module, or its state_dict) as a diffusers-style fp32
    ``.safetensors`` state dict on disk."""
    sd = model_or_state_dict.state_dict() if isinstance(model_or_state_dict, torch.nn.Module) \
        else model_or_state_dict
    save_safetensors({k: v.detach().float().cpu() for k, v in canonical_state_dict(sd).items()},
                     path, metadata={"format": "pt"})


# ------------------ diffusers ``save_pretrained`` trees ----------------------

_DIFFUSERS_VERSION = "0.27.0"
UNET_WEIGHTS_NAME = "diffusion_pytorch_model.safetensors"
UNET_WEIGHTS_NAME_BIN = "diffusion_pytorch_model.bin"


def diffusers_unet_config(cfg, sample_size=None):
    """UNet2DConfig -> diffusers ``UNet2DModel`` config.json dict."""
    return {
        "_class_name": "UNet2DModel",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "act_fn": cfg.act_fn,
        "add_attention": cfg.add_attention,
        "attention_head_dim": cfg.attention_head_dim,
        "attn_norm_num_groups": None,
        "block_out_channels": list(cfg.block_out_channels),
        "center_input_sample": False,
        "class_embed_type": None,
        "down_block_types": list(cfg.down_block_types),
        "downsample_padding": 1,
        "downsample_type": "conv",
        "dropout": cfg.dropout,
        "flip_sin_to_cos": cfg.flip_sin_to_cos,
        "freq_shift": int(cfg.freq_shift),
        "in_channels": cfg.in_channels,
        "layers_per_block": cfg.layers_per_block,
        "mid_block_scale_factor": 1,
        "norm_eps": cfg.norm_eps,
        "norm_num_groups": cfg.norm_num_groups,
        "num_class_embeds": None,
        "num_train_timesteps": None,
        "out_channels": cfg.out_channels,
        "resnet_time_scale_shift": "default",
        "sample_size": sample_size,
        "time_embedding_type": "positional",
        "up_block_types": list(cfg.up_block_types),
        "upsample_type": "conv",
    }


def unet_config_from_diffusers(d):
    """diffusers config.json dict -> UNet2DConfig (the subset implemented;
    the JAX package's reading, ``dropout`` included in neither)."""
    from bndm_tpu_torch.models.unet2d import UNet2DConfig

    unsupported = {
        "center_input_sample": False,
        "class_embed_type": None,
        "num_class_embeds": None,
        "resnet_time_scale_shift": "default",
        "time_embedding_type": "positional",
        "downsample_type": "conv",
        "upsample_type": "conv",
    }
    for k, v in unsupported.items():
        if d.get(k, v) != v:
            raise NotImplementedError(f"diffusers UNet2DModel config {k}={d[k]!r} "
                                      "is outside the subset the port implements")
    return UNet2DConfig(
        in_channels=d.get("in_channels", 3),
        out_channels=d.get("out_channels", 3),
        block_out_channels=tuple(d["block_out_channels"]),
        down_block_types=tuple(d["down_block_types"]),
        up_block_types=tuple(d["up_block_types"]),
        layers_per_block=d.get("layers_per_block", 2),
        act_fn=d.get("act_fn", "silu"),
        attention_head_dim=d.get("attention_head_dim") or 8,
        norm_num_groups=d.get("norm_num_groups", 32),
        norm_eps=d.get("norm_eps", 1e-5),
        add_attention=d.get("add_attention", True),
        flip_sin_to_cos=d.get("flip_sin_to_cos", True),
        freq_shift=d.get("freq_shift", 0) or 0,
    )


def export_pretrained_unet(dirpath, state_dict, cfg, sample_size=None):
    """Write a diffusers ``UNet2DModel.save_pretrained``-style directory from
    a torch state_dict (fp32 on disk)."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(diffusers_unet_config(cfg, sample_size), f, indent=2, sort_keys=True)
    save_safetensors({k: v.detach().float() for k, v in state_dict.items()},
                     os.path.join(dirpath, UNET_WEIGHTS_NAME), metadata={"format": "pt"})


def load_pretrained_unet(dirpath):
    """Read a diffusers UNet2DModel directory -> (torch state_dict,
    UNet2DConfig | None): safetensors or legacy torch-pickle ``.bin``
    weights, the config when ``config.json`` is present."""
    cfg = None
    cfg_path = os.path.join(dirpath, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = unet_config_from_diffusers(json.load(f))
    for name in (UNET_WEIGHTS_NAME, UNET_WEIGHTS_NAME_BIN):
        path = os.path.join(dirpath, name)
        if os.path.exists(path):
            return load_state_dict_file(path), cfg
    raise FileNotFoundError(f"no {UNET_WEIGHTS_NAME} or {UNET_WEIGHTS_NAME_BIN} in {dirpath}")


def ddim_scheduler_config(num_train_timesteps=1000, beta_schedule="linear",
                          prediction_type="epsilon", beta_start=1e-4, beta_end=0.02,
                          clip_sample=True, set_alpha_to_one=True, steps_offset=0,
                          timestep_spacing="leading"):
    """diffusers ``DDIMScheduler`` scheduler_config.json dict."""
    return {
        "_class_name": "DDIMScheduler",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "beta_end": beta_end,
        "beta_schedule": beta_schedule,
        "beta_start": beta_start,
        "clip_sample": clip_sample,
        "clip_sample_range": 1.0,
        "dynamic_thresholding_ratio": 0.995,
        "num_train_timesteps": num_train_timesteps,
        "prediction_type": prediction_type,
        "rescale_betas_zero_snr": False,
        "sample_max_value": 1.0,
        "set_alpha_to_one": set_alpha_to_one,
        "steps_offset": steps_offset,
        "thresholding": False,
        "timestep_spacing": timestep_spacing,
        "trained_betas": None,
    }


def iadb_scheduler_config(num_train_timesteps=1000):
    """The config the reference's custom IADBScheduler writes through
    ``IADBPipeline.save_pretrained``."""
    return {
        "_class_name": "IADBScheduler",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "num_train_timesteps": num_train_timesteps,
    }


def export_pipeline_tree(out_dir, state_dict, cfg, sample_size, scheduler_config,
                         pipeline_class="DDIMPipeline"):
    """Write the ``pipeline.save_pretrained`` tree: unet/ + scheduler/ +
    model_index.json."""
    export_pretrained_unet(os.path.join(out_dir, "unet"), state_dict, cfg, sample_size)
    sched_dir = os.path.join(out_dir, "scheduler")
    os.makedirs(sched_dir, exist_ok=True)
    with open(os.path.join(sched_dir, "scheduler_config.json"), "w") as f:
        json.dump(scheduler_config, f, indent=2, sort_keys=True)
    sched_cls = scheduler_config.get("_class_name", "DDIMScheduler")
    index = {
        "_class_name": pipeline_class,
        "_diffusers_version": _DIFFUSERS_VERSION,
        "scheduler": ["diffusers", sched_cls] if sched_cls == "DDIMScheduler"
        else ["__main__", sched_cls],
        "unet": ["diffusers", "UNet2DModel"],
    }
    with open(os.path.join(out_dir, "model_index.json"), "w") as f:
        json.dump(index, f, indent=2, sort_keys=True)
