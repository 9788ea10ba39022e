"""The fused adaLN unit (``bndm_tpu_torch/ops/adaln.py``) on the CPU, where it
runs its plain twins: their gradients by ``torch.autograd.gradcheck`` in
float64 and against autograd of the unfused formula (``F.layer_norm``, the
modulation, the gated residual), with and without the residual input, at a
width that is not a power of two (72) and a token count that is not a
multiple of the kernels' token block; the launchers refuse CPU tensors and
their counters stay 0; the DiT's fused wiring (each block's MLP update carried
into the next block's attention LayerNorm, the last into the final layer's)
equals the plain forward and backward and is no less precise in bf16; the
bytes of one step's units, counted from the wiring, are ``perfbench/adaln.py``'s;
``adaln_roofline`` reads the kernels named ``bndm_adaln``. The kernels
themselves are held to the twins on the card (``tests/test_torch_port_gpu.py``).
"""

import importlib.util
import os

import pytest
import torch
import torch.nn.functional as F

from bndm_tpu_torch.models import dit as D
from bndm_tpu_torch.ops import adaln as A
from perfbench import adaln as PA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _leaves(b, n, d, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)

    def leaf(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, dtype=dtype) * std).requires_grad_()

    # gate, shift, scale as chunks of one modulation row, as the DiT cuts them
    return leaf(b, n, d), leaf(b, n, d), leaf(b, 1, 3 * d, std=0.3)


def _unit(x, y, mod, residual):
    gate, shift, scale = mod.chunk(3, dim=2)
    if residual:
        return A.adaln(x, shift, scale, 1e-6, y, gate)
    return A.adaln(x, shift, scale, 1e-6)


def _unfused(x, y, mod, residual):
    """The model's sequence, in one dtype: the gated residual, LayerNorm,
    the modulation."""
    gate, shift, scale = mod.chunk(3, dim=2)
    xs = x + gate * y if residual else x
    return xs, F.layer_norm(xs, (x.shape[2],), eps=1e-6) * (1 + scale) + shift


@pytest.mark.parametrize("residual", [True, False])
def test_the_plain_twins_pass_gradcheck(residual):
    x, y, mod = _leaves(2, 3, 5, 0)
    assert torch.autograd.gradcheck(lambda *a: _unit(*a, residual), (x, y, mod))


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("n", [37, 64])
def test_the_plain_twins_pass_gradcheck_at_width_72(residual, n):
    """D = 72 (not a power of two) and N = 37 (not a multiple of a token
    block) or 64 (two whole blocks of the forward), in gradcheck's fast
    mode (random projections of the Jacobian)."""
    x, y, mod = _leaves(2, n, 72, 1)
    assert torch.autograd.gradcheck(lambda *a: _unit(*a, residual), (x, y, mod),
                                    fast_mode=True)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("n", [37, 64])
def test_the_unit_equals_autograd_of_the_unfused_formula(residual, n):
    """Outputs and every input's gradient to float64 noise (1e-12), with
    gradients arriving at both outputs: z feeds the branch, x' the next
    unit."""
    x, y, mod = _leaves(3, n, 72, 2)
    g = torch.Generator().manual_seed(3)
    dxs, dz = (torch.randn(3, n, 72, generator=g, dtype=torch.float64) for _ in range(2))
    got = _unit(x, y, mod, residual)
    grads = torch.autograd.grad(got, (x, y, mod), (dxs, dz), allow_unused=True)
    want = _unfused(x, y, mod, residual)
    want_grads = torch.autograd.grad(want, (x, y, mod), (dxs, dz), allow_unused=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    for a, b in zip(grads, want_grads):
        if b is None:  # y without the residual
            assert a is None
            continue
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_the_stream_gradient_enters_the_unit_without_residual():
    """Without y, x' is x itself (a view), and the gradient reaching it
    comes back through the unit's own backward, added to the LayerNorm's."""
    x, _, mod = _leaves(2, 4, 8, 4)
    xs, z = _unit(x, None, mod, False)
    assert xs.grad_fn is not None and xs.data_ptr() == x.data_ptr()
    g = torch.Generator().manual_seed(5)
    dxs = torch.randn(2, 4, 8, generator=g, dtype=torch.float64)
    (only_ln,) = torch.autograd.grad(z, x, torch.ones_like(z), retain_graph=True)
    (both,) = torch.autograd.grad((xs, z), x, (dxs, torch.ones_like(z)))
    torch.testing.assert_close(both, only_ln + dxs, rtol=1e-12, atol=1e-12)


def test_the_launchers_refuse_cpu_tensors():
    x, y, mod = (t.detach().float() for t in _leaves(2, 4, 8, 6))
    gate, shift, scale = mod.chunk(3, dim=2)
    f0, b0 = A.adaln_forward.launches, A.adaln_backward.launches
    with pytest.raises(ValueError, match="CUDA"):
        A.adaln_forward(x, shift, scale, 1e-6, y, gate)
    xs, _, mean, rstd = A.adaln_forward_plain(x, shift, scale, 1e-6, y, gate)
    with pytest.raises(ValueError, match="CUDA"):
        A.adaln_backward(torch.ones_like(x), None, xs, mean, rstd, scale, y, gate)
    assert (A.adaln_forward.launches, A.adaln_backward.launches) == (f0, b0)


@pytest.mark.parametrize("d", [1, 2, 8, 64, 72, 1152, 4096, 5000])
@pytest.mark.parametrize("backward", [False, True])
def test_the_tiling_covers_a_row_in_one_block(d, backward):
    block_d, rows, block_n, warps = A.tiling(d, backward)
    assert block_d >= d and block_d & (block_d - 1) == 0 and block_d < 2 * max(d, 1)
    assert rows & (rows - 1) == 0 and block_n % rows == 0 and rows * block_d <= max(
        A._ELEMS, block_d)
    assert warps in (1, 2, 4, 8)


def _tiny_dit(dtype, seed):
    cfg = D.dit_config("tiny", input_size=8, dtype=dtype)
    torch.manual_seed(seed)
    m = D.DiT(cfg)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0, 0.1)
    return m


def _run(m, x, t):
    out = m(x, t)
    return out.detach(), torch.autograd.grad(out.square().sum(), list(m.parameters()))


def test_the_cpu_forward_takes_the_plain_sequence(monkeypatch):
    """On the CPU the DiT runs its plain code: no unit, no launch."""
    m = _tiny_dit("float32", 0)
    assert not D.fuses_adaln(torch.zeros(1, 4, 8))
    calls = []
    was = A.AdaLN.apply
    monkeypatch.setattr(A.AdaLN, "apply", lambda *a: calls.append(1) or was(*a))
    f0, b0 = A.adaln_forward.launches, A.adaln_backward.launches
    _run(m, torch.randn(2, 4, 8, 8), torch.rand(2))
    assert calls == []
    assert (A.adaln_forward.launches, A.adaln_backward.launches) == (f0, b0)


def test_the_fused_wiring_equals_the_plain_forward_and_backward(monkeypatch):
    """The fused units through the plain twins (forced on the CPU) against
    the plain DiT in float32: the output and every parameter's gradient
    to float32 noise; the same spans and attention calls."""
    from torch.profiler import ProfilerActivity, profile

    from bndm_tpu_torch.utils.timing import take_spans

    m = _tiny_dit("float32", 1)
    x, t = torch.randn(3, 4, 8, 8), torch.rand(3)
    seen = {}
    for fused in (False, True):
        monkeypatch.setattr(D, "fuses_adaln", lambda h, fused=fused: fused)
        calls = D.attention.calls
        take_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            seen[fused] = _run(m, x, t)
        names = [s.name for s in take_spans() if s.name.startswith("bndm.dit.")]
        assert names == ["bndm.dit.embed"] + m.cfg.depth * ["bndm.dit.block"] + ["bndm.dit.final"]
        assert D.attention.calls - calls == m.cfg.depth
    (out, grads), (ref, ref_grads) = seen[True], seen[False]
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-5
    for a, b in zip(grads, ref_grads):
        assert float((a - b).norm() / b.norm()) < 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_the_fused_wiring_is_no_less_precise_in_bf16(monkeypatch, seed):
    """In bf16 the units round once where the plain sequence rounds at each
    step, so against the float32 model their output and gradients are no
    farther than the plain bf16 sequence's (measured 8-15 % nearer)."""
    m = _tiny_dit("bfloat16", seed)
    m32 = D.DiT(D.dit_config("tiny", input_size=8))
    m32.load_state_dict(m.state_dict())
    x, t = torch.randn(3, 4, 8, 8), torch.rand(3)
    ref, ref_grads = _run(m32, x, t)

    def gaps(fused):
        monkeypatch.setattr(D, "fuses_adaln", lambda h: fused)
        out, grads = _run(m, x, t)
        num = torch.stack([(a - b).norm() for a, b in zip(grads, ref_grads)]).norm()
        den = torch.stack([b.norm() for b in ref_grads]).norm()
        return float((out - ref).norm() / ref.norm()), float(num / den)

    fused, plain = gaps(True), gaps(False)
    assert fused[0] <= plain[0] and fused[1] <= plain[1]


def test_the_step_bytes_are_the_wiring_s(monkeypatch):
    """Counting, in a tiny fused DiT's forward and backward, each (B, N, D)
    tensor every unit reads or writes (bf16 branch and modulation, float32
    stream) gives perfbench/adaln.py's bytes a step: 30 a unit, 20 for the
    first (no update before it, the stream's gradient coming in), 26 for
    the last (no stream gradient coming in)."""
    m = _tiny_dit("bfloat16", 2)
    monkeypatch.setattr(D, "fuses_adaln", lambda h: True)
    b, n, d = 3, 16, m.cfg.hidden_size
    moved = []

    def size(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None and t.dim() == 3
                   and t.shape[1] == n)

    fwd, bwd = A.adaln_forward_plain, A.adaln_backward_plain

    def counted_fwd(x, shift, scale, eps, y=None, gate=None):
        out = fwd(x, shift, scale, eps, y, gate)
        moved.append(size(x, y, out[1], None if y is None else out[0]))
        return out

    def counted_bwd(dz, dxs, xs, mean, rstd, scale, y=None, gate=None):
        out = bwd(dz, dxs, xs, mean, rstd, scale, y, gate)
        moved.append(size(dz, dxs, xs, y, out[0], out[3]))
        return out

    monkeypatch.setattr(A, "adaln_forward_plain", counted_fwd)
    monkeypatch.setattr(A, "adaln_backward_plain", counted_bwd)
    _run(m, torch.randn(b, 4, 8, 8), torch.rand(b))
    assert len(moved) == 2 * (2 * m.cfg.depth + 1)
    assert sum(moved) == PA.step_bytes(b, n, d, m.cfg.depth)


def test_the_step_bound_at_the_cell():
    assert PA.step_bytes(128, 256, 1152, 28) == 1696 * 128 * 256 * 1152
    assert PA.bound_s(128, 256, 1152, 28) == pytest.approx(19.111e-3, rel=1e-4)


def _read_roofline(rec):
    path = os.path.join(ROOT, "perfbench", "metrics", "adaln_roofline.py")
    spec = importlib.util.spec_from_file_location("m_adaln_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def test_adaln_roofline_reads_its_kernels():
    """Two traced steps whose bndm_adaln kernels take 4x the bound read
    25 %; a trace without them (the program before the kernels) reads
    nothing, as does a run without a trace or a configuration without a DiT."""
    config = {"dit": {"input_size": 32, "patch_size": 2, "hidden_size": 1152, "depth": 28}}
    per = 4 * PA.bound_s(128, 256, 1152, 28) * 1e6 / 3
    kernels, t = [["nvjet_gemm", 0.0, 1e3]], 1e3
    for _ in range(2):
        for name in ("bndm_adaln_fwd", "bndm_adaln_bwd", "bndm_adaln_colsum"):
            kernels.append([name, t, t + per])
            t += per
    rec = {"trace": {"items": 2, "kernels": kernels}, "config": config,
           "traffic": {"batch_size": 128}}
    assert _read_roofline(rec) == pytest.approx(25.0)
    rec["trace"]["kernels"] = kernels[:1]
    assert _read_roofline(rec) is None
    assert _read_roofline(dict(rec, trace=None)) is None
    assert _read_roofline(dict(rec, config={"unet": {}})) is None
