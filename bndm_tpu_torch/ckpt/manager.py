"""Checkpoint / resume of the full train state, keep-N, "latest" by default.

Counterpart of ``bndm_tpu/ckpt/manager.py`` (which is built on Orbax) with
the same interface, written with ``torch.save``. A checkpoint holds a
complete train state, whatever its kind: the manager saves
``state.state_dict()`` and restores through ``state.load_state_dict()``
(the pixel pipeline's :class:`~bndm_tpu_torch.train.pixel.TrainState`:
weights, both optimizers, the learnable schedule params and the step; the
HF pipelines' :class:`~bndm_tpu_torch.train.ddim.HFTrainState`: weights,
AdamW with its accumulation buffers and schedule count, the EMA and the
step), in ``<directory>/<step>/state.pt``. A save is written to a temporary
file and renamed, so a directory seen by ``latest_step`` is whole. Saves are
synchronous: ``wait`` and ``close`` have nothing to wait for.
"""

from __future__ import annotations

import os
import shutil

import torch

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory, max_to_keep=3, save_interval_steps=1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d, _FILE)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step, state, wait=False):
        """Save ``state`` (anything with ``state_dict()``) as ``step``;
        ``wait`` is accepted for the interface's sake, every save is
        synchronous."""
        del wait
        step = int(step)
        if self.latest_step() == step or step % self.save_interval_steps:
            return  # already saved this step, or not a step to save
        d = os.path.join(self.directory, str(step))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, _FILE + ".tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, os.path.join(d, _FILE))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, state, step=None):
        """Load the checkpoint of ``step`` (the latest by default) into
        ``state`` in place and return it; None when there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        # onto the CPU: load_state_dict moves each tensor to its parameter's
        # device, and keeps the optimizers' step counts on the host
        state.load_state_dict(torch.load(os.path.join(self.directory, str(int(step)), _FILE),
                                         map_location="cpu", weights_only=True))
        return state

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    def close(self):
        """Nothing is held open between saves."""
