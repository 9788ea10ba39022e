"""The benchmark's fixed arithmetic: the card's peaks, roofline bounds, the
bytes and operations of the two blue-noise kernels, and the union of kernel
intervals.

Frozen copies of the repository's smoke script's ``roofline``,
``k1_bounds``, ``k2_bounds`` and ``_busy_us``, except that a kernel's
operation bound is taken at the fastest rate the card takes fp32 inputs at
(TF32 on the tensor cores), so that the bound holds whatever
implementation runs the product.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM5 data sheet, dense rates, at the full 700 W power limit
PEAK_HBM_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_TF32_FLOP_S = 495e12


def roofline(nbytes, flops, peak_bytes, peak_flops):
    """(least seconds, what bounds it) for ``nbytes`` moved once and
    ``flops`` at ``peak_flops``."""
    t_b, t_o = nbytes / peak_bytes, flops / peak_flops
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def tri_product_flops(n, m):
    """Operations of a lower-triangular (n, n) by (n, m) product: n(n+1)/2
    multiply-adds per column, two operations each."""
    return n * (n + 1) * m


def k1_bytes(n, m):
    """K1, ``L @ W`` with L lower-triangular: the triangle of L, W and the
    output each move once, fp32."""
    return 4 * (n * (n + 1) // 2 + 2 * n * m)


def k2_bytes(n, m):
    """K2, RNG -> L-matmul -> mix: the triangle of L and gamma read once;
    noise, bn and wn written once, fp32 (the mix's three operations an
    element and the generator's integer work are not counted)."""
    return 4 * (n * (n + 1) // 2 + m + 3 * n * m)


def kernel_bound_s(kernel, n, m):
    """Least seconds of one call of ``kernel`` ("k1" or "k2") at (n, m) on
    the card: its bytes at the HBM peak, its product at the TF32 peak."""
    nbytes = {"k1": k1_bytes, "k2": k2_bytes}[kernel](n, m)
    return roofline(nbytes, tri_product_flops(n, m), PEAK_HBM_BYTES_S, PEAK_TF32_FLOP_S)


def busy(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) gaps inside [lo, hi] between the union of
    ``intervals``."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]
