"""The metrics that read the program's spans (``perfbench/spans.py``), on
synthetic records: each one's value, and None where the record has no
program spans; the spans kept from the device-only pass."""

import importlib.util
import os

import pytest

from bndm_tpu_torch.utils import timing
from bndm_tpu_torch.utils.timing import SpanRecord
from perfbench import spans
from perfbench.tests.tiny import ROOT

MS = 1_000_000


def _read(metric, rec):
    path = os.path.join(ROOT, "perfbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("m_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def _span(name, start_ms, wall_ms, cpu_ms, main=True, parent=None):
    return SpanRecord("bndm." + name, parent, 1 if main else 2, main, start_ms * MS,
                      (start_ms + wall_ms) * MS, cpu_ms * MS)


def _step(t, feed):
    """One traced step at ``t`` ms: the feed's wait, then the step's
    phases (wall, cpu)."""
    s = "bndm.train.step"
    return [_span("data.next", t, feed, 0.5),
            _span("train.draw", t + 10, 2, 1, parent=s),
            _span("train.zero_grad", t + 12, 8, 1, parent=s),
            _span("train.noise", t + 21, 1, 1, parent="bndm.train.forward"),
            _span("train.forward", t + 20, 30, 20, parent=s),
            _span("train.backward", t + 50, 40, 5, parent=s),
            _span("train.optimizer", t + 90, 10, 6, parent=s),
            _span("train.step", t + 10, 91, 34),
            _span("data.decode", t, 12 + t / 50, 11, main=False)]


def _record(items=2):
    return {"trace": {"items": items, "kernels": [["k", 0.0, 1.0]],
                      "program_spans": _step(0, 4) + _step(100, 6)}}


@pytest.mark.parametrize("metric,value", [
    ("feed_wait_ms.train", 5.0),  # (4 + 6) / 2
    ("loader_batch_ms.train", 13.0),  # the producer's spans: 12 and 14
    ("forward_ms.train", 30.0),
    ("backward_ms.train", 40.0),
    ("optimizer_ms.train", 10.0),
    ("main_offcpu_ms.train", 22.0),  # (2-1) + (8-1) + (30-20) + (10-6); noise inside forward
    ("noise_ms.train", 1.0),
    ("span_coverage_pct.train", 100.0 * (4 + 91 + 6 + 91) / 201),  # main thread: 0 to 201 ms
])
def test_each_metric_reads_its_spans(metric, value):
    assert _read(metric, _record()) == pytest.approx(value)
    empty = {"trace": {"items": 2, "kernels": [["k", 0.0, 1.0]], "program_spans": []}}
    assert _read(metric, empty) is None
    assert _read(metric, {"trace": None}) is None


def test_the_device_only_pass_is_taken_from_the_program_once(monkeypatch):
    """Spans that started before the first pass's last kernel ended are
    its; later ones are the second pass's. The record keeps them; a
    program without spans gives none."""
    early, late = _span("data.next", 1, 1, 0), _span("data.next", 9, 1, 0)
    calls = []
    monkeypatch.setattr(timing, "take_spans", lambda: calls.append(1) or [early, late])
    rec = {"trace": {"items": 1, "kernels": [["k", 0.0, 5e3]]}}  # in us: ends at 5 ms
    assert spans.of(rec) == [early] and spans.of(rec) == [early] and calls == [1]
    assert rec["trace"]["program_spans"] == [early]
    assert spans.of({"trace": {"items": 1, "kernels": []}}) == []
    monkeypatch.delattr(timing, "take_spans")
    assert spans.of({"trace": {"items": 1, "kernels": [["k", 0.0, 5e3]]}}) == []
