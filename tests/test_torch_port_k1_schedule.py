"""K1's work schedules, the Python half of ``csrc/tri_matmul.cu``, on the CPU.

The kernels run only on the card; what Python computes for them runs here:
the skinny design's pairs of row blocks (``skinny_pairs``) and the wide
design's work list (``wide_schedule``). The tests check that each covers
every tile of the lower triangle exactly once, that the wide one balances
its blocks, and that walking either schedule with torch ops, partial sums
added in the kernel's fixed order, gives the JAX package's ``apply_L``.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bndm_tpu.ops.pallas_bluenoise import apply_L as jax_apply_L
from bndm_tpu_torch.ops.cuda_bluenoise import (SKINNY_BM, SKINNY_MAX_M, WIDE_BK, WIDE_TILE,
                                               skinny_pairs, wide_schedule)

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


@pytest.mark.parametrize("n,m", SHAPES)
def test_wide_schedule_covers_the_triangle_once(n, m):
    """The units of all blocks cover each output tile's K steps (up to the
    triangular bound) exactly once; a tile cut between blocks has scratch
    slots in order and one fixup that adds them; blocks own contiguous runs."""
    units, starts, fixups, n_slots = wide_schedule(n, m, SMS)
    units, starts, fixups = units.tolist(), starts.tolist(), fixups.tolist()
    n_ti, n_tj = _cdiv(n, WIDE_TILE), _cdiv(m, WIDE_TILE)
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


@pytest.mark.parametrize("m", [768, 1500])
def test_wide_schedule_balances_the_blocks(m):
    """At the res-128 train step's M = 768 and the gallery's M = 1500, the
    busiest block's multiply-adds are within 10 % of the mean (a plain grid
    of tiles gives the last row tile 32 times the first one's work)."""
    units, starts, _, _ = wide_schedule(4096, m, SMS)
    macs = []
    for b in range(len(starts) - 1):
        steps = sum(_cdiv(k_hi - k_lo, WIDE_BK) for _, _, k_lo, k_hi, _ in
                    units[starts[b]:starts[b + 1]].tolist())
        macs.append(steps * WIDE_TILE * WIDE_TILE * WIDE_BK)
    assert len(macs) == SMS
    assert max(macs) <= 1.1 * (sum(macs) / len(macs))


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


def _run_wide(L, W, blocks):
    """out = L @ W as the wide kernels sum it: each unit's product over its K
    range, to the output or a scratch slot; cut tiles added in slot order."""
    n, m = W.shape
    units, _, fixups, n_slots = wide_schedule(n, m, blocks)
    out = torch.zeros(n, m)
    ws = torch.zeros(n_slots, WIDE_TILE, WIDE_TILE)

    def tile(ti, tj):
        r = slice(ti * WIDE_TILE, min(n, (ti + 1) * WIDE_TILE))
        c = slice(tj * WIDE_TILE, min(m, (tj + 1) * WIDE_TILE))
        return r, c

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


@pytest.mark.parametrize("regime,m,blocks", [("skinny", 12, None), ("skinny", 40, None),
                                             ("wide", 300, 5), ("wide", 12, 7)])
def test_schedules_reproduce_jax_apply_L(regime, m, blocks):
    """At n = 256 (a lower-triangular L, 0.02 N(0,1) off a unit diagonal),
    each schedule walked with torch ops equals the JAX package's apply_L at
    float32 matmul precision within 2e-5; the wide grid is cut small so that
    tiles are split between blocks and added back by their fixups."""
    assert regime == "wide" or m <= SKINNY_MAX_M
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
    got = _run_skinny(Lt, W) if regime == "skinny" else _run_wide(Lt, W, blocks)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
