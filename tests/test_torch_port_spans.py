"""The port's spans (``bndm_tpu_torch/utils/timing.py``) on the CPU: off
outside a torch.profiler profile and on while one records, their records
(parents, threads, CPU time, the profiler's clock, the cap), and where the
program opens them: the train steps, the data feeds, the sampler's chain
and the decode; a step leaves the same weights with spans on or off."""

import contextlib
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bndm_tpu_torch.data import imagefolder as tdata
from bndm_tpu_torch.data.latent_cache import LatentCacheDataset, LatentCacheWriter
from bndm_tpu_torch.models import unet2d as P
from bndm_tpu_torch.models.vae import make_decoder
from bndm_tpu_torch.samplers import iadb
from bndm_tpu_torch.train import ddim as TD
from bndm_tpu_torch.train import latent as TL
from bndm_tpu_torch.train import pixel as TP
from bndm_tpu_torch.train.schedules_lr import HFAdamW
from bndm_tpu_torch.utils import timing
from test_torch_port_serving_tiers import _one_torch_thread  # noqa: F401 (autouse fixture)

PLAIN = dict(block_out_channels=(8, 16), down_block_types=("DownBlock2D", "DownBlock2D"),
             up_block_types=("UpBlock2D", "UpBlock2D"), attention_head_dim=4, norm_num_groups=4)


@pytest.fixture(autouse=True)
def _fresh_spans():
    timing.take_spans()
    yield
    timing.take_spans()


def _recording():
    """A CPU profile: spans record while it does."""
    return profile(activities=[ProfilerActivity.CPU])


def _cpu_tick_ns():
    """The step of the thread's CPU clock: about 1 us on most hosts, 10 ms
    on a host that counts a thread's time in scheduler ticks."""
    steps = []
    while len(steps) < 3:
        a = time.thread_time_ns()
        while (b := time.thread_time_ns()) == a:
            pass
        steps.append(b - a)
    return max(steps)


def _program_events(prof):
    return {e.name(): e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(timing.PREFIX)}


@pytest.mark.parametrize("mode", ["default, no profile", "after a profile"])
def test_spans_off_are_one_no_op_and_leave_nothing(mode):
    def work():
        assert timing.span("a") is timing.span("b")
        with timing.span("a"):
            torch.ones(4).add_(1)

    if mode == "after a profile":
        with _recording() as prof:
            torch.ones(4).add_(1)
        work()
        assert not _program_events(prof)
    else:
        work()
    assert timing.take_spans() == []


def test_spans_follow_the_profiler_by_default():
    with _recording() as prof:
        with timing.span("a"):
            torch.ones(4).add_(1)
    with timing.span("b"):
        pass
    assert [s.name for s in timing.take_spans()] == ["bndm.a"]
    assert list(_program_events(prof)) == ["bndm.a"]


def test_records_nest_per_thread_and_share_the_profilers_clock():
    """Parents on the span's own thread, CPU time within wall time, and
    each main-thread span inside its record_function range in the
    profiler's own events, on the same clock: its ends lie within what
    entering and leaving the range cost (30-100 us each on a CPU host under
    load; held to 1 ms), where another clock would sit seconds off. The
    CPU time is held to the wall time give or take one step of the thread's
    CPU clock."""

    def side():
        with timing.span("side"):
            time.sleep(0.001)

    with _recording() as prof:
        with timing.span("warm"):  # the profiler's first range on a thread sets it up
            pass
        with timing.span("outer"):
            with timing.span("inner"):
                time.sleep(0.002)
                sum(range(20000))
            th = threading.Thread(target=side)
            th.start()
            th.join(timeout=10)
    assert not th.is_alive()
    recs = {s.name: s for s in timing.take_spans()}
    assert list(recs) == ["bndm.warm", "bndm.inner", "bndm.side", "bndm.outer"]
    assert recs["bndm.inner"].parent == "bndm.outer" and recs["bndm.outer"].parent is None
    assert recs["bndm.side"].parent is None and not recs["bndm.side"].main
    assert recs["bndm.side"].thread != recs["bndm.outer"].thread == threading.get_ident()
    assert recs["bndm.outer"].main and recs["bndm.inner"].main
    tick = _cpu_tick_ns()
    for s in recs.values():
        assert 0 <= s.cpu_ns <= s.end_ns - s.start_ns + tick, s.name
    events = _program_events(prof)
    for name in ("bndm.outer", "bndm.inner"):
        e, s = events[name], recs[name]
        # -5 us: the profiler converts its cycle counter to this clock
        assert -5_000 <= s.start_ns - e.start_ns() <= 1_000_000, name
        assert -5_000 <= e.start_ns() + e.duration_ns() - s.end_ns <= 1_000_000, name


def test_records_past_the_cap_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(timing, "MAX_SPANS", 3)
    was = timing.spans_dropped()
    with _recording():
        for i in range(5):
            with timing.span(f"s{i}"):
                pass
    assert [s.name for s in timing.take_spans()] == ["bndm.s0", "bndm.s1", "bndm.s2"]
    assert timing.spans_dropped() == was + 2
    with _recording():
        with timing.span("s5"):
            pass
    assert [s.name for s in timing.take_spans()] == ["bndm.s5"]


def _pixel_trainer():
    torch.manual_seed(0)
    cfg = TP.TrainConfig(nb_steps=100, noise_type="gaussian", scheduler_gamma="sigmoid",
                         out_channel=3, grad_clip=1.0)
    return TP.PixelTrainer(P.UNet2D(P.UNet2DConfig(**PLAIN)), cfg, torch.eye(4))


def _hf_opt(params):
    return HFAdamW(params, lr=1e-3, betas=(0.95, 0.999), eps=1e-8, weight_decay=1e-6,
                   schedule=lambda n: 1e-3)


def _pixel_step():
    tr = _pixel_trainer()
    return lambda: tr.step(torch.full((2, 3, 16, 16), 0.5), (0, 0))


def _latent_step():
    torch.manual_seed(0)
    step, init = TL.make_latent_train_step(
        TL.LatentTrainConfig(noise_type="gaussian", out_channels=4), torch.eye(4), _hf_opt)
    state = init(P.UNet2D(P.UNet2DConfig(**PLAIN, in_channels=4, out_channels=4)).train())
    return lambda: step(state, torch.zeros(2, 4, 8, 8), (0, 0))


def _ddim_step():
    torch.manual_seed(0)
    step, init = TD.make_ddim_train_step(TD.DDIMTrainConfig(), _hf_opt)
    state = init(P.UNet2D(P.UNet2DConfig(**PLAIN)).train())
    return lambda: step(state, torch.full((2, 3, 16, 16), 0.5), (0, 0))


@pytest.mark.parametrize("make,noise", [(_pixel_step, True), (_latent_step, True),
                                        (_ddim_step, False)])
def test_a_train_step_is_one_span_with_its_phases_in_order(make, noise):
    step = make()
    with _recording():
        step()
    recs = timing.take_spans()
    assert [s.name for s in recs if s.parent is None] == ["bndm.train.step"]
    phases = sorted((s for s in recs if s.parent == "bndm.train.step"), key=lambda s: s.start_ns)
    assert [s.name[len("bndm.train."):] for s in phases] == [
        "draw", "zero_grad", "forward", "backward", "optimizer"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    inner = [(s.name, s.parent) for s in recs if s.parent not in (None, "bndm.train.step")]
    assert inner == ([("bndm.train.noise", "bndm.train.forward")] if noise else [])


def test_a_pixel_step_leaves_the_same_weights_with_spans_on_and_off():
    out = []
    for on in (True, False):
        tr = _pixel_trainer()
        with _recording() if on else contextlib.nullcontext():
            for k in range(2):
                tr.step(torch.full((2, 3, 16, 16), 0.25 + 0.5 * k), (0, k))
        assert bool(timing.take_spans()) == on
        out.append([p.detach().clone() for p in tr.model.parameters()]
                   + [tr.state.sched_params.detach().clone()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("cached", [False, True])
def test_the_sampler_chain_has_one_step_span_per_model_call(cached):
    x0, k = torch.ones(2, 3, 4, 4), 5
    with _recording():
        if cached:
            iadb.sample_iadb_cached(lambda x, t: (0.1 * x, None), lambda x, t, deep: 0.1 * x,
                                    x0, nb_steps=k, cache_interval=2)
        else:
            iadb.sample_iadb(lambda x, t: 0.1 * x, x0, nb_steps=k)
    recs = timing.take_spans()
    assert [(s.name, s.parent) for s in recs] == (
        [("bndm.sample.step", "bndm.sample.chain")] * k + [("bndm.sample.chain", None)])


@pytest.mark.parametrize("microbatch,chunks", [(None, 1), (2, 3)])
def test_the_decoder_has_one_span_per_chunk(microbatch, chunks):
    vae = types.SimpleNamespace(decode=lambda z: 2.0 * z)
    with _recording():
        out = make_decoder(vae, microbatch)(torch.ones(5, 4, 2, 2))
    assert torch.equal(out, torch.full((5, 4, 2, 2), 2.0))
    assert [s.name for s in timing.take_spans()] == ["bndm.vae.decode"] * chunks


def test_the_loader_spans_the_wait_and_the_decode(tmp_path):
    tdata.make_synthetic_folder(str(tmp_path), n=8, res=16)
    loader = tdata.BatchLoader(tdata.ImageFolderDataset(str(tmp_path), 16), 4, num_threads=2)
    with _recording():
        assert len(list(loader.epoch(0))) == 2
    recs = timing.take_spans()
    waits = [s for s in recs if s.name == "bndm.data.next"]
    decodes = [s for s in recs if s.name == "bndm.data.decode"]
    assert len(waits) == 3 and all(s.main for s in waits)  # two batches, then the end
    assert len(decodes) == 2 and not any(s.main for s in decodes)
    assert {s.name for s in recs} == {"bndm.data.next", "bndm.data.decode"}


def test_the_latent_cache_spans_each_gather(tmp_path):
    writer = LatentCacheWriter(str(tmp_path), (4, 2, 2))
    for i in range(8):
        writer.add(np.full((4, 2, 2), i, np.float16))
    writer.finalize()
    with _recording():
        batches = list(LatentCacheDataset(str(tmp_path)).batches(4, seed=(0, 0)))
    assert len(batches) == 2 and batches[0].dtype == np.float32
    recs = timing.take_spans()
    assert [s.name for s in recs] == ["bndm.data.next"] * 2 and all(s.main for s in recs)
