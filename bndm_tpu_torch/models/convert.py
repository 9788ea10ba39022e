"""Weight carry into the PyTorch UNet.

The port's own copy of the JAX package's converter
(``bndm_tpu/models/convert.py::convert_flax_params``): a flax params tree of
numpy arrays becomes a diffusers-named state_dict of torch tensors.

Layout rules (flax -> torch):
  conv kernel (kh, kw, I, O)  -> weight (O, I, kh, kw)
  dense kernel (I, O)         -> weight (O, I)
  norm scale/bias             -> weight/bias
  path ("down_blocks_0", "resnets_1") -> "down_blocks.0.resnets.1"
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
