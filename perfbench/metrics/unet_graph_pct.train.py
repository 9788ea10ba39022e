"""Percent of the traced steps whose UNet ran as replayed CUDA graphs: the
main thread's ``train.unet_graph`` spans over its ``train.step`` spans, in
the device-only pass (``perfbench/spans.py``). None without program spans,
and for a program whose pixel train step has no such graphs
(``bndm_tpu_torch.train.pixel.UNetGraphs``)."""

import sys

from perfbench import spans


def read(rec):
    names = [s.name for s in spans.of(rec) if s.main]
    steps = names.count("bndm.train.step")
    if not steps or not hasattr(sys.modules.get("bndm_tpu_torch.train.pixel"), "UNetGraphs"):
        return None
    return 100.0 * names.count("bndm.train.unet_graph") / steps
