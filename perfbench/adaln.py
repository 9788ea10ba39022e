"""Bytes of the DiT's adaLN sub-layers in one train step, and their least
time on the card: the fixed arithmetic of ``adaln_roofline``.

A fused unit is a residual update and the LayerNorm and modulation after it,
``x' = x + gate * y`` then ``z = LN(x') (1 + scale) + shift``, over B N
tokens of width D: the stream ``x``, ``x'`` and its gradients float32 (4 B),
the branch output ``y``, ``z`` and their gradients bf16 (2 B). Each tensor is
counted once, read or written; the row statistics and the (B, D) modulation
rows are left out (under 0.1 %). Per element:

* an interior unit (2 depth - 1 of them: each block's attention update with
  its MLP LayerNorm, each block's MLP update with the next block's attention
  LayerNorm): forward reads x, y and writes x', z (12 B); backward reads dz,
  dx', x', y and writes dx, dy (18 B): 30 B;
* block 0's first LayerNorm, with no update before it: forward reads x and
  writes z (6 B); backward reads dz, dx', x and writes dx (14 B): 20 B;
* the final layer's LayerNorm with the last block's MLP update: 12 B forward;
  backward reads dz, x', y and writes dx, dy, with no stream gradient coming
  in (14 B): 26 B.
"""

from __future__ import annotations

from perfbench.yardstick import PEAK_HBM_BYTES_S

INTERIOR, FIRST, FINAL = 30, 20, 26  # bytes an element of (B, N, D)


def step_bytes(b, n, d, depth):
    """Least bytes the adaLN units of one forward and backward move."""
    return ((2 * depth - 1) * INTERIOR + FIRST + FINAL) * b * n * d


def bound_s(b, n, d, depth):
    """Least seconds of one step's adaLN units on the card: bytes bound them."""
    return step_bytes(b, n, d, depth) / PEAK_HBM_BYTES_S
