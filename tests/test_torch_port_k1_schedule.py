"""K1's work schedules, the Python half of ``csrc/tri_matmul.cu``, on the CPU.

The kernels run only on the card; what Python computes for them runs here:
the skinny design's pairs of row blocks (``skinny_pairs``) and the wide
core's work list (``wide_schedule``, shared by K1's wide design and K2's
product). The tests check that each covers every tile of the lower triangle
exactly once, that the wide one balances its blocks at both column tiles,
and that walking either schedule with torch ops, partial sums added in the
kernel's fixed order, gives the JAX package's ``apply_L``; the wide walk
also in a torch emulation of the core's 3xTF32 arithmetic, with K2's
epilogue.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu.ops.pallas_bluenoise import apply_L as jax_apply_L
from bndm_tpu_torch.ops.cuda_bluenoise import (SKINNY_BM, SKINNY_LIMIT_M, WIDE_BK, WIDE_TILE,
                                               WIDE_TILE_NS, skinny_pairs, white_noise_plain,
                                               wide_schedule, wide_tile_n)

SMS = 132  # an H100 SXM's SMs: the wide grid's size on the card
SHAPES = [(n, m) for n in (4096, 1000) for m in (1, 12, 768, 1500)]


def _cdiv(a, b):
    return -(-a // b)


def _skinny_segments(n):
    """Per block: [(row block, triangular K end)], short first."""
    return [[(rb, min(n, SKINNY_BM * (rb + 1))) for rb in pair if rb >= 0]
            for pair in skinny_pairs(n).tolist()]


@pytest.mark.parametrize("n,m", SHAPES)
def test_skinny_pairs_cover_the_triangle_once_and_level(n, m):
    """Every (row block, 16-wide K tile) on or below the diagonal is read by
    exactly one block, and every block reads the same L elements to within
    one row block's share (the pairing does not depend on M)."""
    nb = _cdiv(n, SKINNY_BM)
    seen = collections.Counter()
    reads = []  # columns of 16 rows each pair reads
    blocks = _skinny_segments(n)
    for segments in blocks:
        assert 1 <= len(segments) <= 2
        for rb, end in segments:
            seen.update((rb, kt) for kt in range(_cdiv(end, SKINNY_BM)))
        if len(segments) == 2:
            reads.append(sum(end for _, end in segments))
    assert seen == collections.Counter({(rb, kt): 1 for rb in range(nb) for kt in range(rb + 1)})
    assert len(blocks) == _cdiv(nb, 2) and len(reads) == nb // 2  # an odd nb's middle is alone
    # a pair (i, nb-1-i) reads (nb+1) * 16 columns, less where n cuts the last block
    assert max(reads) - min(reads) < SKINNY_BM
    if n == 4096:
        assert len(reads) == 128 and len(set(reads)) == 1  # 128 of the 132 SMs, level


def _steps(n, ti):
    return _cdiv(min(n, WIDE_TILE * (ti + 1)), WIDE_BK)


@pytest.mark.parametrize("tile_n", WIDE_TILE_NS)
@pytest.mark.parametrize("n,m", SHAPES)
def test_wide_schedule_covers_the_triangle_once(n, m, tile_n):
    """The units of all blocks cover each output tile's K steps (up to the
    triangular bound) exactly once, at either column tile; a tile cut between
    blocks has scratch slots in order and one fixup that adds them; blocks
    own contiguous runs."""
    units, starts, fixups, n_slots = wide_schedule(n, m, SMS, tile_n)
    units, starts, fixups = units.tolist(), starts.tolist(), fixups.tolist()
    n_ti, n_tj = _cdiv(n, WIDE_TILE), _cdiv(m, tile_n)
    total = sum(_steps(n, ti) for ti in range(n_ti)) * n_tj
    assert len(starts) == min(SMS, total) + 1 and starts[0] == 0 and starts[-1] == len(units)
    assert all(a < b for a, b in zip(starts, starts[1:]))  # no block is idle
    seen = collections.Counter()
    pieces = collections.defaultdict(list)
    for ti, tj, k_lo, k_hi, slot in units:
        assert k_lo % WIDE_BK == 0 and k_lo < k_hi <= min(n, WIDE_TILE * (ti + 1))
        seen.update((ti, tj, s) for s in range(k_lo // WIDE_BK, _cdiv(k_hi, WIDE_BK)))
        pieces[ti, tj].append(slot)
    assert seen == collections.Counter({(ti, tj, s): 1 for ti in range(n_ti)
                                        for tj in range(n_tj) for s in range(_steps(n, ti))})
    fix = {(ti, tj): (first, count) for ti, tj, first, count in fixups}
    for tile, slots in pieces.items():
        if len(slots) == 1:
            assert slots == [-1] and tile not in fix
        else:
            first, count = fix[tile]
            assert slots == list(range(first, first + count))
    assert n_slots == sum(c for _, c in fix.values()) == len({s for s in sum(pieces.values(), [])
                                                               if s >= 0})


@pytest.mark.parametrize("m,tile_n", [(768, 128), (1500, 128), (192, 64), (48, 64)])
def test_wide_schedule_balances_the_blocks(m, tile_n):
    """At the res-128 train step's M = 768, the gallery's M = 1500, K2's
    train step M = 192 and M = 48, each at the column tile the wrapper picks
    there, the busiest block's multiply-adds are within 10 % of the mean (a
    plain grid of tiles gives the last row tile 32 times the first one's
    work)."""
    assert wide_tile_n(m) == tile_n
    units, starts, _, _ = wide_schedule(4096, m, SMS, tile_n)
    macs = []
    for b in range(len(starts) - 1):
        steps = sum(_cdiv(k_hi - k_lo, WIDE_BK) for _, _, k_lo, k_hi, _ in
                    units[starts[b]:starts[b + 1]].tolist())
        macs.append(steps * WIDE_TILE * tile_n * WIDE_BK)
    assert len(macs) == SMS
    assert max(macs) <= 1.1 * (sum(macs) / len(macs))


@pytest.mark.parametrize("m,tile_n", [(1, 64), (12, 64), (64, 64), (65, 128), (96, 128),
                                      (128, 128), (129, 64), (192, 64), (768, 128),
                                      (1500, 128)])
def test_wide_tile_n_pads_the_columns_least(m, tile_n):
    """The wrapper's column tile: 64 where 128-wide tiles would pad M by a
    further 64 columns (M = 192 is three 64-wide tiles), else 128."""
    assert wide_tile_n(m) == tile_n
    pad = {t: _cdiv(m, t) * t for t in WIDE_TILE_NS}
    assert pad[tile_n] == min(pad.values())


def test_wide_schedule_refuses_other_column_tiles():
    with pytest.raises(ValueError, match="column tiles"):
        wide_schedule(256, 12, 4, 32)


# ----------------- the schedules walked in the kernels' order ----------------


def _skinny_geometry(m):
    """(K per item, K slices per warp) of the skinny kernel for this M, as
    csrc/tri_matmul.cu's dispatch_skinny picks them."""
    if m <= 16:
        return 256, 4
    return (256, 2) if m <= 32 else (128, 2)


def _run_skinny(L, W):
    """out = L @ W as the skinny kernel sums it: per row, one partial per
    (warp, K slice) over the block's items in order, then the partials added
    in (warp, slice) order."""
    n, m = W.shape
    kc, ks = _skinny_geometry(m)
    ksub = kc // 8 // ks
    out = torch.zeros(n, m)
    for segments in _skinny_segments(n):
        for rb, end in segments:
            rows = slice(SKINNY_BM * rb, min(n, SKINNY_BM * (rb + 1)))
            parts = torch.zeros(8 * ks, rows.stop - rows.start, m)
            for k0 in range(0, end, kc):
                for p in range(8 * ks):
                    lo = k0 + (p // ks) * (kc // 8) + (p % ks) * ksub
                    hi = min(lo + ksub, end)
                    if lo < hi:
                        parts[p] += L[rows, lo:hi] @ W[lo:hi]
            total = parts[0]
            for p in range(1, 8 * ks):
                total = total + parts[p]
            out[rows] = total
    return out


def _tile_of(n, m, tile_n):
    def tile(ti, tj):
        r = slice(ti * WIDE_TILE, min(n, (ti + 1) * WIDE_TILE))
        c = slice(tj * tile_n, min(m, (tj + 1) * tile_n))
        return r, c
    return tile


def _run_wide(L, W, blocks, tile_n=WIDE_TILE):
    """out = L @ W as the wide kernels sum it: each unit's product over its K
    range, to the output or a scratch slot; cut tiles added in slot order."""
    n, m = W.shape
    units, _, fixups, n_slots = wide_schedule(n, m, blocks, tile_n)
    out = torch.zeros(n, m)
    ws = torch.zeros(n_slots, WIDE_TILE, tile_n)
    tile = _tile_of(n, m, tile_n)
    for ti, tj, k_lo, k_hi, slot in units.tolist():
        r, c = tile(ti, tj)
        part = L[r, k_lo:k_hi] @ W[k_lo:k_hi, c]
        if slot < 0:
            out[r, c] = part
        else:
            ws[slot, :part.shape[0], :part.shape[1]] = part
    for ti, tj, first, count in fixups.tolist():
        r, c = tile(ti, tj)
        total = ws[first]
        for q in range(1, count):
            total = total + ws[first + q]
        out[r, c] = total[:r.stop - r.start, :c.stop - c.start]
    return out


@pytest.mark.parametrize("regime,m,blocks,tile_n", [
    ("skinny", 12, None, None), ("skinny", 40, None, None), ("wide", 300, 5, 128),
    ("wide", 12, 7, 128), ("wide", 192, 5, 64), ("wide", 12, 7, 64)])
def test_schedules_reproduce_jax_apply_L(regime, m, blocks, tile_n):
    """At n = 256 (a lower-triangular L, 0.02 N(0,1) off a unit diagonal),
    each schedule walked with torch ops equals the JAX package's apply_L at
    float32 matmul precision within 2e-5; the wide grid is cut small so that
    tiles are split between blocks and added back by their fixups."""
    assert regime == "wide" or m <= SKINNY_LIMIT_M
    rng = np.random.default_rng(m)
    n = 256
    L = np.tril(rng.standard_normal((n, n)).astype(np.float32) * 0.02)
    np.fill_diagonal(L, 1.0)
    c = 3 if m % 3 == 0 else 1
    wf = rng.standard_normal((m // c, n, c)).astype(np.float32)  # (B, HW, C)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax_apply_L(jnp.asarray(L), jnp.asarray(wf)))
    want = want.transpose(1, 0, 2).reshape(n, m)  # batch and channel as columns
    W = torch.from_numpy(np.ascontiguousarray(wf.transpose(1, 0, 2).reshape(n, m)))
    Lt = torch.from_numpy(L)
    got = _run_skinny(Lt, W) if regime == "skinny" else _run_wide(Lt, W, blocks, tile_n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# ------------- the core's 3xTF32 arithmetic, emulated with torch -------------


def _tf32(x):
    """fp32 -> the nearest TF32 (10 mantissa bits), ties away from zero: the
    core's cvt.rna.tf32.f32. Adding half of the dropped 13 bits to the
    magnitude's bits and clearing them rounds the magnitude half up."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)  # x - hi is exact


def _run_3xtf32(L, W, gamma, blocks, tile_n):
    """K2's product and epilogue as the core computes them: per K step of
    WIDE_BK, lo*hi + hi*lo + hi*hi of the split operands summed apart (a
    fresh fragment) and added to the unit's running sum; cut tiles added in
    slot order; every finished tile through the epilogue (bn, then the mix).
    The tensor cores' own summation order inside a step is not emulated."""
    n, m = W.shape
    units, _, fixups, n_slots = wide_schedule(n, m, blocks, tile_n)
    (l_hi, l_lo), (w_hi, w_lo) = _split(L), _split(W)
    bn, noise = torch.full((n, m), float("nan")), torch.full((n, m), float("nan"))
    ws = torch.zeros(n_slots, WIDE_TILE, tile_n)
    tile = _tile_of(n, m, tile_n)

    def epilogue(r, c, b):
        assert bool(torch.isnan(bn[r, c]).all())  # each element finished once
        g = gamma[c][None, :]
        bn[r, c] = b
        noise[r, c] = b * (1.0 - g) + W[r, c] * g

    for ti, tj, k_lo, k_hi, slot in units.tolist():
        r, c = tile(ti, tj)
        acc = torch.zeros(r.stop - r.start, c.stop - c.start)
        for k in range(k_lo, k_hi, WIDE_BK):
            ks = slice(k, min(k + WIDE_BK, k_hi))
            part = l_lo[r, ks] @ w_hi[ks, c] + l_hi[r, ks] @ w_lo[ks, c]
            acc = acc + (part + l_hi[r, ks] @ w_hi[ks, c])
        if slot < 0:
            epilogue(r, c, acc)
        else:
            ws[slot, :acc.shape[0], :acc.shape[1]] = acc
    for ti, tj, first, count in fixups.tolist():
        r, c = tile(ti, tj)
        total = ws[first]
        for q in range(1, count):
            total = total + ws[first + q]
        epilogue(r, c, total[:r.stop - r.start, :c.stop - c.start])
    return noise, bn


def test_3xtf32_emulation_meets_k2s_contract_at_the_train_step():
    """The TPU kernel test's L (tests/test_fused_noise_tpu.py) at n = 4096
    and K2's train-step width M = 192 (batch 64 x 3 channels), walked over
    the card's schedule (132 blocks, 64-wide column tiles, so tiles are cut
    and fixed up): the split arithmetic with its blocked sum gives bn within
    the TPU kernel's 1e-5 of the JAX package's apply_L (einsum at HIGHEST
    precision) on K2's own white noise, and the mix exactly. The card's test
    checks the tensor cores' own accumulation."""
    n, m = 4096, 192
    rng = np.random.default_rng(0)
    L = np.tril(rng.standard_normal((n, n)).astype(np.float32) * 0.02)
    np.fill_diagonal(L, 1.0)
    wn = white_noise_plain(n, m, (64, 3))
    gamma = torch.from_numpy(rng.uniform(size=m).astype(np.float32))
    noise, bn = _run_3xtf32(torch.from_numpy(L), wn, gamma, SMS, wide_tile_n(m))
    wf = wn.numpy().reshape(n, m // 3, 3).transpose(1, 0, 2)  # (B, HW, C)
    want = np.asarray(jax_apply_L(jnp.asarray(L), jnp.asarray(wf)))
    want = want.transpose(1, 0, 2).reshape(n, m)
    assert np.abs(bn.numpy() - want).max() < 1e-5
    assert torch.equal(noise, bn * (1.0 - gamma[None, :]) + wn * gamma[None, :])
