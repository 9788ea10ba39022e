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
"""

from __future__ import annotations

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
