"""The blue-noise kernels: ``noise_bn = L @ white``, alone and fused.

PyTorch counterpart of ``bndm_tpu/ops/pallas_bluenoise.py``. L is the dense
lower-triangular (4096, 4096) covariance factor and white the flattened noise
folded to (4096, B*C), batch and channel as columns.

  * K1, :func:`tri_matmul` (``_pallas_matmul`` / ``apply_L``): the product
    alone, in ``csrc/tri_matmul.cu``.
  * K2, :func:`fused_bluenoise_flat` (``_fused_bluenoise_flat``): white noise
    from a counter-based generator, then the product with the gamma mix in
    its epilogue, two kernels in one call, ``csrc/fused_bluenoise.cu``. K3,
    :class:`FusedBlueNoise` (the custom JVP ``_fused_flat_diff``), carries
    the gradient to gamma.

K1's wide design and K2's product share one 3xTF32 tensor-core core,
``csrc/tri_mma.cuh``, driven by the work list of :func:`wide_schedule`.

On a CUDA tensor each wrapper launches its hand-written kernel; on a CPU
tensor it runs the plain PyTorch version beside it. There is no fallback from
one to the other: a CUDA call launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch


def tri_matmul_plain(L, W):
    """Plain fp32 ``L @ W`` (the einsum ``apply_L`` uses off the TPU)."""
    return torch.einsum("pq,qm->pm", L.float(), W.float())


def _check(L, W):
    if L.dim() != 2 or L.shape[0] != L.shape[1]:
        raise ValueError(f"L must be square 2-D, got {tuple(L.shape)}")
    if W.dim() != 2 or W.shape[0] != L.shape[0]:
        raise ValueError(f"W must be ({L.shape[0]}, M), got {tuple(W.shape)}")
    if L.dtype != torch.float32 or W.dtype != torch.float32:
        raise TypeError(f"tri_matmul takes float32, got {L.dtype} and {W.dtype}")
    if L.device != W.device:
        raise ValueError(f"L is on {L.device} but W is on {W.device}")
    if not (L.is_contiguous() and W.is_contiguous()):
        raise ValueError("tri_matmul takes contiguous row-major L and W")
    if L.shape[0] == 0 or W.shape[1] == 0:
        raise ValueError(f"empty product {tuple(L.shape)} @ {tuple(W.shape)}")
    if L.shape[0] * max(L.shape[0], W.shape[1]) >= 2**31:
        raise ValueError("tri_matmul indexes with 32-bit rows and columns")


# K1 has two designs (csrc/tri_matmul.cu): "skinny", fp32 FMAs bound by L's
# bytes, for M <= SKINNY_MAX_M, and "wide", the 3xTF32 tensor-core core,
# above. The skinny kernel takes M up to SKINNY_LIMIT_M; the sweep of
# chip_smoke.py phase 3 on an H100 found the wide design faster from M = 24
# on and the skinny one at M <= 16 (PERF.md).
SKINNY_MAX_M = 16
SKINNY_LIMIT_M = 64
SKINNY_BM = 16  # rows of a skinny row block; a block takes a pair of them
WIDE_TILE = 128  # rows of a wide output tile (tri_mma::BM), and its widest columns
WIDE_TILE_NS = (64, 128)  # the core's column tiles
WIDE_BK = 32  # K per step of the core (tri_mma::BK): the unit of its schedule


def wide_tile_n(m):
    """The core's column tile for M columns: 64 where 128-wide tiles would
    leave half a tile idle (M = 192 is 3 x 64: a quarter of the work), else
    128, whose larger warp tiles read less shared memory per product."""
    return 64 if -(-m // 64) % 2 else 128


def skinny_pairs(n):
    """(P, 2) int32: the row blocks (short, long) = (i, nb-1-i) of
    :data:`SKINNY_BM` rows that skinny block i takes, nb = ceil(n / 16).
    Row block i reads (i+1) * 16 columns of L, so every pair reads about
    (nb+1) * 16: the triangle is spread evenly. The middle block of an odd
    nb is alone (short = -1)."""
    nb = -(-n // SKINNY_BM)
    return torch.tensor([(i if i != nb - 1 - i else -1, nb - 1 - i)
                         for i in range(-(-nb // 2))], dtype=torch.int32)


def wide_schedule(n, m, blocks, tile_n=WIDE_TILE):
    """The wide core's work list for a persistent grid of ``blocks``.

    Every output tile (row tile ti of 128 rows, column tile tj of ``tile_n``
    columns) needs ceil(min(n, 128 (ti+1)) / 32) K steps (the triangular
    bound). The tiles' steps, ti-major, are laid end to end and cut into
    ``G = min(blocks, total)`` contiguous ranges of equal length (+-1 step):
    block b's share. Returns int32 tensors

      * ``units`` (U, 5): (ti, tj, k_lo, k_hi, slot), a block's piece of one
        tile; slot -1 if the piece is the whole tile (written to the output),
        else its partial's scratch slot;
      * ``block_start`` (G + 1,): block b walks units[block_start[b] :
        block_start[b+1]];
      * ``fixups`` (F, 4): (ti, tj, first slot, count) for every tile cut
        between blocks, whose partials are added in slot order;

    and the number of slots.
    """
    if tile_n not in WIDE_TILE_NS:
        raise ValueError(f"the wide core has column tiles {WIDE_TILE_NS}, not {tile_n}")
    steps = [(ti, tj, -(-min(n, WIDE_TILE * (ti + 1)) // WIDE_BK))
             for ti in range(-(-n // WIDE_TILE)) for tj in range(-(-m // tile_n))]
    total = sum(s for _, _, s in steps)
    g = max(1, min(blocks, total))
    cuts = [b * total // g for b in range(g + 1)]
    units, fixups, block_start = [], [], [0]
    b = pos = n_slots = 0  # pos: the first step of the current tile
    for ti, tj, s in steps:
        lo, pieces = pos, []
        while lo < pos + s:
            while cuts[b + 1] <= lo:  # block b is full: the next starts here
                b += 1
                block_start.append(len(units) + len(pieces))
            hi = min(pos + s, cuts[b + 1])
            pieces.append((lo - pos, hi - pos))
            lo = hi
        split = len(pieces) > 1
        for i, (a, z) in enumerate(pieces):
            units.append((ti, tj, a * WIDE_BK, min(n, z * WIDE_BK), n_slots + i if split else -1))
        if split:
            fixups.append((ti, tj, n_slots, len(pieces)))
            n_slots += len(pieces)
        pos += s
    block_start += [len(units)] * (g + 1 - len(block_start))

    def int32(rows, width):
        return torch.tensor(rows, dtype=torch.int32).reshape(-1, width)

    return int32(units, 5), torch.tensor(block_start, dtype=torch.int32), int32(fixups, 4), n_slots


@functools.cache
def _schedule_on(device, n, m, regime):
    """The schedule tensors of one shape, made once and kept on ``device``:
    the skinny pairs, or the wide work list with its slot count and column
    tile."""
    if regime == "skinny":
        return (skinny_pairs(n).to(device),)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tile_n = wide_tile_n(m)
    units, starts, fixups, n_slots = wide_schedule(n, m, sms, tile_n)
    return units.to(device), starts.to(device), fixups.to(device), n_slots, tile_n


def _wide_args(device, n, m):
    """The wide core's schedule arguments for one call, in the C entry
    points' order (units, block_start, n_blocks, fixups, n_fixups, tile_n),
    and a fresh scratch of one 128 x tile_n tile per slot."""
    units, starts, fixups, n_slots, tile_n = _schedule_on(device, n, m, "wide")
    ws = torch.empty((max(n_slots, 1), WIDE_TILE * tile_n), device=device, dtype=torch.float32)
    return (units.data_ptr(), starts.data_ptr(), starts.shape[0] - 1, fixups.data_ptr(),
            fixups.shape[0], tile_n), ws


@functools.cache
def _kernels():
    from bndm_tpu_torch.ops import _build

    lib = _build.load("tri_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    skinny, wide = lib.bndm_tri_matmul_skinny_f32, lib.bndm_tri_matmul_wide_f32
    skinny.argtypes = [p, p, p, p, i, i, i, p]
    wide.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, p]
    skinny.restype = wide.restype = ctypes.c_int
    return skinny, wide


def _launch(L, W, regime):
    """One K1 call on the card in the named design ("skinny", for M <=
    :data:`SKINNY_LIMIT_M`, or "wide"), uncounted: :func:`tri_matmul` chooses
    and counts; chip_smoke.py times both designs across the sweep through
    this."""
    n, m = W.shape
    if regime not in ("skinny", "wide") or (regime == "skinny" and m > SKINNY_LIMIT_M):
        raise ValueError(f"no {regime!r} design of K1 for M = {m}")
    out = torch.empty((n, m), device=W.device, dtype=torch.float32)
    skinny, wide = _kernels()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        if regime == "skinny":
            (pairs,) = _schedule_on(W.device, n, m, regime)
            err = skinny(L.data_ptr(), W.data_ptr(), out.data_ptr(), pairs.data_ptr(),
                         pairs.shape[0], n, m, stream)
        else:
            sched, ws = _wide_args(W.device, n, m)
            err = wide(L.data_ptr(), W.data_ptr(), out.data_ptr(), ws.data_ptr(), *sched, n, m,
                       stream)
    if err != 0:
        raise RuntimeError(f"tri_matmul ({regime}) kernel launch failed with CUDA error {err}")
    return out


def tri_matmul(L, W):
    """``out = L @ W`` for a LOWER-TRIANGULAR fp32 L (n, n) and W (n, M).

    The CUDA kernels read only the lower triangle of L (they multiply through
    the zeros of the diagonal tiles and skip the tiles above them), so an L
    with nonzeros above the diagonal gives a wrong result there. M <=
    :data:`SKINNY_MAX_M` takes the skinny design, wider M the wide one; both
    give the same bits run to run. CPU tensors go to
    :func:`tri_matmul_plain`; ``tri_matmul.launches`` counts calls on the
    card (one each, whatever kernels the call launches) and
    ``tri_matmul.launches_by_m`` the same calls by M.
    """
    _check(L, W)
    if L.device.type == "cpu":
        return tri_matmul_plain(L, W)
    if L.device.type != "cuda":
        raise ValueError(f"tri_matmul runs on cuda or cpu, not {L.device}")
    out = _launch(L, W, "skinny" if W.shape[1] <= SKINNY_MAX_M else "wide")
    tri_matmul.launches += 1
    tri_matmul.launches_by_m[W.shape[1]] += 1
    return out


tri_matmul.launches = 0
tri_matmul.launches_by_m = collections.Counter()


def apply_L(L, wf):
    """Batched correlation: (B, HW, C) white noise -> (B, HW, C) correlated.

    ``out[b] = L @ wf[b]``, with batch and channel folded into one column
    dimension (HW, B*C) for a single :func:`tri_matmul` (``apply_L`` of the
    JAX package, bndm_tpu/ops/pallas_bluenoise.py:292-304).
    """
    b, hw, c = wf.shape
    n = L.shape[0]
    if hw != n:
        raise ValueError(f"L is {tuple(L.shape)} but noise has {hw} pixels")
    w2 = wf.permute(1, 0, 2).reshape(n, b * c).float().contiguous()
    out = tri_matmul(L.float().contiguous(), w2)
    return out.reshape(n, b, c).permute(1, 0, 2).to(wf.dtype)


# ------------------- K2: fused RNG -> L-matmul -> mix ------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a, b):
    """(high, low) 32-bit words of ``a * b`` for a 32-bit constant ``a`` and
    an int64 tensor ``b`` of uint32 values. ``b`` is split at 16 bits, so no
    partial product leaves int64."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    return (p_hi + (p_lo >> 16)) >> 16, (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's ``philox4x32``).

    ``counter``: four broadcastable int64 tensors holding uint32 words;
    ``key``: two ints. Returns the four output words as int64 tensors.
    """
    c0, c1, c2, c3 = counter
    k0, k1 = (int(k) & _MASK32 for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def _bits_to_unit(bits):
    """uint32 word -> float32 in (0, 1): top 24 bits * 2^-24 + 2^-25 (the
    rule of ``_bits_to_unit`` in the JAX package)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def white_noise_plain(n, m, seeds, device=None):
    """K2's white noise, (n, m) fp32: Philox4x32-10 at counter (row, column,
    0, 0) with key ``seeds``, words 0 and 1 as u1 and u2, then
    ``sqrt(-2 ln u1) * cos(2 pi u2)``."""
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(m, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w0, w1, _, _ = philox4x32_10((rows, cols, zero, zero), seeds)
    u1, u2 = _bits_to_unit(w0), _bits_to_unit(w1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def fused_bluenoise_flat_plain(L, gamma_cols, seeds, gbn_only=False):
    """K2 in plain PyTorch: the same generator bits, the same uniform and
    Box-Muller, ``L @ wn`` in fp32, then the mix. Returns (noise, bn, wn)."""
    wn = white_noise_plain(L.shape[0], gamma_cols.shape[0], seeds, L.device)
    bn = tri_matmul_plain(L, wn)
    if gbn_only:
        return bn.clone(), bn, wn
    g = gamma_cols.float()[None, :]
    return bn * (1.0 - g) + wn * g, bn, wn


def _check_fused(L, gamma_cols, seeds):
    if L.dim() != 2 or L.shape[0] != L.shape[1] or L.shape[0] == 0:
        raise ValueError(f"L must be square 2-D, got {tuple(L.shape)}")
    if gamma_cols.dim() != 1 or gamma_cols.shape[0] == 0:
        raise ValueError(f"gamma_cols must be (M,), got {tuple(gamma_cols.shape)}")
    if L.dtype != torch.float32 or gamma_cols.dtype != torch.float32:
        raise TypeError(f"fused_bluenoise takes float32, got {L.dtype} and {gamma_cols.dtype}")
    if L.device != gamma_cols.device:
        raise ValueError(f"L is on {L.device} but gamma_cols is on {gamma_cols.device}")
    if not (L.is_contiguous() and gamma_cols.is_contiguous()):
        raise ValueError("fused_bluenoise takes contiguous L and gamma_cols")
    if L.shape[0] * max(L.shape[0], gamma_cols.shape[0]) >= 2**31:
        raise ValueError("fused_bluenoise indexes with 32-bit rows and columns")
    if len(seeds) != 2 or not all(isinstance(s, int) and 0 <= s <= _MASK32 for s in seeds):
        raise ValueError(f"seeds must be two host ints in [0, 2**32), got {seeds!r}")


@functools.cache
def _fused_kernel():
    from bndm_tpu_torch.ops import _build

    lib = _build.load("fused_bluenoise")
    fn = lib.bndm_fused_bluenoise_f32
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    fn.argtypes = [p] * 7 + [p, i, p, i, i, i, i, u, u, i, p]
    fn.restype = ctypes.c_int
    return fn


def fused_bluenoise_flat(L, gamma_cols, seeds, gbn_only=False):
    """(noise, bn, wn), each (n, M) fp32, for a LOWER-TRIANGULAR fp32 L (n, n),
    gamma per column (M,) and two host-int ``seeds``, passed to the kernels by
    value. ``wn`` is white noise, ``bn = L @ wn``, ``noise = bn*(1-gamma) +
    wn*gamma`` (``bn`` for GBN). CPU tensors go to
    :func:`fused_bluenoise_flat_plain`; ``fused_bluenoise_flat.launches``
    counts calls on the card (one each: the generator, the product and, where
    the schedule cuts tiles, their fix-up are launched by one C call)."""
    _check_fused(L, gamma_cols, seeds)
    if L.device.type == "cpu":
        return fused_bluenoise_flat_plain(L, gamma_cols, seeds, gbn_only)
    if L.device.type != "cuda":
        raise ValueError(f"fused_bluenoise runs on cuda or cpu, not {L.device}")
    n, m = L.shape[0], gamma_cols.shape[0]
    if gamma_cols.data_ptr() % 16:  # the epilogue reads gamma 4 columns at a time
        gamma_cols = gamma_cols.clone()
    noise, bn, wn = (torch.empty((n, m), device=L.device, dtype=torch.float32)
                     for _ in range(3))
    fn = _fused_kernel()
    with torch.cuda.device(L.device):
        sched, ws = _wide_args(L.device, n, m)
        stream = torch.cuda.current_stream(L.device).cuda_stream
        err = fn(L.data_ptr(), gamma_cols.data_ptr(), noise.data_ptr(), bn.data_ptr(),
                 wn.data_ptr(), ws.data_ptr(), *sched, n, m, seeds[0], seeds[1], int(gbn_only),
                 stream)
    if err != 0:
        raise RuntimeError(f"fused_bluenoise kernel launch failed with CUDA error {err}")
    fused_bluenoise_flat.launches += 1
    return noise, bn, wn


fused_bluenoise_flat.launches = 0


class FusedBlueNoise(torch.autograd.Function):
    """K3: K2 with its gradient to gamma (the JAX package's custom JVP
    ``_fused_flat_diff``). bn and wn do not depend on gamma, and the mix is
    ``bn*(1-g) + wn*g``, so d noise / d g = wn - bn, from K2's own outputs;
    GBN's noise is bn and has none. L (a fixed covariance factor) and the
    seeds get no gradient; bn and wn are not differentiable.
    ``FusedBlueNoise.launches`` counts backward passes on the card (the
    backward is torch ops, no kernel of its own, as the JAX JVP is jnp)."""

    launches = 0

    @staticmethod
    def forward(ctx, L, gamma_cols, seeds, gbn_only):
        noise, bn, wn = fused_bluenoise_flat(L, gamma_cols, seeds, gbn_only)
        ctx.mark_non_differentiable(bn, wn)
        ctx.save_for_backward(bn, wn)
        ctx.gbn_only = gbn_only
        return noise, bn, wn

    @staticmethod
    def backward(ctx, grad_noise, grad_bn, grad_wn):
        bn, wn = ctx.saved_tensors
        if ctx.gbn_only:
            grad_gamma = torch.zeros(bn.shape[1], dtype=bn.dtype, device=bn.device)
        else:
            grad_gamma = (grad_noise * (wn - bn)).sum(dim=0)
        if bn.is_cuda:
            FusedBlueNoise.launches += 1
        return None, grad_gamma, None, None


def fused_bluenoise(seeds, batch, channels, L, gamma, *, gbn_only=False, res=64):
    """Fused [RNG -> L-matmul -> mix] for the res-64 path: (noise, noise_bn,
    noise_wn), each (B, C, 64, 64), the contract of the unfused engine with
    the white noise drawn by K2's generator from ``seeds``. Differentiable
    with respect to ``gamma`` (B,) through :class:`FusedBlueNoise`; the sum
    over a sample's C columns is ``repeat_interleave``'s own backward."""
    if res != 64:
        raise ValueError(f"the fused path is the res-64 path, not res {res}")
    n = L.shape[0]
    gamma_cols = gamma.float().repeat_interleave(channels)
    noise, bn, wn = FusedBlueNoise.apply(L.float().contiguous(), gamma_cols, tuple(seeds),
                                         gbn_only)

    def to_img(x):  # flat (N, M) columns are (b, c); rows are pixels
        return x.reshape(n, batch, channels).permute(1, 2, 0).reshape(batch, channels, 64, 64)

    return to_img(noise), to_img(bn), to_img(wn)
