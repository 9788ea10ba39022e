"""Operations and bytes of one attention call of a train step, forward and
backward, and its least time on the card: the fixed arithmetic of
``attn_roofline``.

One call is softmax(q k^T / sqrt(d)) v over B sequences of N tokens at the
model width D (all heads together), bf16 operands. Forward: the two products,
4 B N^2 D operations; q, k, v read and o written once, 4 B N D x 2 bytes.
Backward: its four products (dv, dp, dq, dk), 8 B N^2 D operations, no
recomputation counted; q, k, v, o and do read and dq, dk, dv written once,
8 B N D x 2 bytes. Each pass is bounded by the larger of its operations at
the dense bf16 peak and its bytes at the HBM peak.
"""

from __future__ import annotations

from perfbench.yardstick import PEAK_BF16_FLOP_S, PEAK_HBM_BYTES_S, roofline

BYTES_BF16 = 2


def forward_flops(b, n, d):
    return 4 * b * n * n * d


def forward_bytes(b, n, d):
    return 4 * b * n * d * BYTES_BF16


def backward_flops(b, n, d):
    return 8 * b * n * n * d


def backward_bytes(b, n, d):
    return 8 * b * n * d * BYTES_BF16


def bound_s(b, n, d):
    """Least seconds of one call's forward plus backward on the card."""
    fwd = roofline(forward_bytes(b, n, d), forward_flops(b, n, d), PEAK_HBM_BYTES_S,
                   PEAK_BF16_FLOP_S)[0]
    bwd = roofline(backward_bytes(b, n, d), backward_flops(b, n, d), PEAK_HBM_BYTES_S,
                   PEAK_BF16_FLOP_S)[0]
    return fwd + bwd
