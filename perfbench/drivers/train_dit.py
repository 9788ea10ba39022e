"""DiT-XL/2 latent BNDM training: the latent cell's loop, cache feed, noise
(K1) and reference check (``train_latent``, ``_train``) with the program's
``DiT`` (``bndm_tpu_torch.models.dit``) of the configuration's ``port``
entry as the model, and the program's attention counter beside K1's."""

from __future__ import annotations

from perfbench import weights
from perfbench.drivers import _train, train_latent
from perfbench.drivers.train_latent import inputs  # noqa: F401 (the control's)


def dit_model(ctx, init):
    """The program's ``DiT`` of the configuration's ``port.dit_config`` on
    the run's device, loaded with ``init``."""
    from bndm_tpu_torch.models.dit import DiT, dit_config

    fields = dict(ctx.config["port"]["dit_config"])
    model = DiT(dit_config(fields.pop("preset"), **fields), device=ctx.device)
    model.load_state_dict(init, strict=True)
    return model


class _Program(train_latent._Program):
    def counters(self):
        from bndm_tpu_torch.models.dit import attention

        return dict(super().counters(), attn=attention.calls)


def run(ctx):
    # a program without the DiT fails here, before set-up draws anything
    import bndm_tpu_torch.models.dit  # noqa: F401

    inp = ctx.inputs = inputs(ctx)
    return _train.run(ctx, lambda: _Program(
        ctx, inp.latents, inp.L, dit_model(ctx, weights.make(inp.spec, ctx.seed, ctx.device))))
