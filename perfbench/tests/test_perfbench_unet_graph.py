"""``unet_graph_pct.train`` on synthetic records: the share of the traced
steps that replayed the UNet's graphs, and None without program spans or
where the program has no such graphs."""

import pytest

from bndm_tpu_torch.train import pixel
from perfbench.tests.test_perfbench_spans import _read, _span, _step

METRIC = "unet_graph_pct.train"


def _graphed(t):
    return _step(t, 4) + [_span("train.unet_graph", t + 22, 5, 5, parent="bndm.train.forward")]


def _record(program_spans):
    return {"trace": {"items": 2, "kernels": [["k", 0.0, 1.0]], "program_spans": program_spans}}


@pytest.mark.parametrize("steps,value", [
    ((_graphed(0), _graphed(100)), 100.0),
    ((_graphed(0), _step(100, 6)), 50.0),
    ((_step(0, 4), _step(100, 6)), 0.0),
])
def test_unet_graph_pct_reads_the_steps_that_replay(steps, value):
    assert _read(METRIC, _record(steps[0] + steps[1])) == pytest.approx(value)


def test_unet_graph_pct_is_none_without_spans_or_graphs(monkeypatch):
    assert _read(METRIC, _record([])) is None
    assert _read(METRIC, {"trace": None}) is None
    monkeypatch.delattr(pixel, "UNetGraphs")
    assert _read(METRIC, _record(_step(0, 4) + _step(100, 6))) is None
