"""The HBM-streaming probes: ``y + 1`` in bf16, three ways.

PyTorch counterparts of the three Pallas kernels of the repository's bench
scripts, which measure how fast a hand-written kernel streams bytes:

  * P1, :func:`stream_add_one` (``variant(rows_per_block, semantics).f``,
    scripts/bench_pallas_stream.py:35-51): row blocks of a 2-D tensor, a
    Triton kernel. ``schedule="parallel"`` is one program per block;
    ``"persistent"`` (the TPU's sequential "arbitrary" grid, which has no
    order on the card) is one program per SM taking blocks grid-stride.
  * P2, :func:`dma_add_one` (``manual_dma(rows_per_chunk).f``, :55-108):
    a copy pipeline managed by hand, in CUDA C++ (``csrc/stream_dma.cu``):
    one persistent block per SM, a ring of shared-memory stages filled by
    1-D bulk TMA copies that complete on mbarriers, and bulk stores.
  * P3, :func:`nhwc_add_one` (``pallas_copy``,
    scripts/bench_elementwise_tpu.py:69-87): an NHWC (B, H, W, C) tensor, a
    Triton kernel. The TPU kernel's unit, 2 whole images (2 MiB) a program,
    split 250 programs unevenly over 132 SMs and left each program's loads
    and stores in turn; the card's design is an oversubscribed grid of one
    small tile a program with streaming cache hints (:data:`P3_SWEEP`).

Bound, the same for all three: the function reads its input once and
writes its output once, so at the benches' full shape (256000 x 1024 or
500 x 64 x 64 x 128 bf16, 524,288,000 B each way) it moves 2 x 524,288,000 B,
0.3130 ms at the H100 SXM data sheet's 3.35 TB/s. It does one add per
element, nothing against 989 TFLOP/s: bytes bound it. Each design keeps 16
bytes per access on neighbouring addresses and enough bytes in flight per
SM, and nothing else: there is no reuse to exploit.

The add is done in float32 and rounded to nearest-even bf16 (Triton), or by
the native bf16 add (CUDA); both give the correctly rounded ``y + 1``, so
each kernel equals :func:`add_one_plain` bit for bit.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs :func:`add_one_plain`. Nothing falls back. ``.launches`` on
each wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_ALIGN = 16  # bytes: bulk copies and 16-byte vector accesses need it
MAX_COLS = 16384  # P1's sub-tile is (BLOCK_R, next power of 2 >= n_cols)
_TILE_ELEMS = 16384  # elements per P1 sub-tile: 64 a thread at 8 warps
_WARPS = 8


def add_one_plain(y):
    """Plain ``y + 1`` in bf16 (one ``torch.add``): the probes' plain
    version and their library yardstick."""
    return torch.add(y, 1)


def _check(y, rank, name):
    if not isinstance(y, torch.Tensor):
        raise TypeError(f"{name} takes a tensor, got {type(y).__name__}")
    if y.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bfloat16, got {y.dtype}")
    if y.dim() != rank:
        raise ValueError(f"{name} takes a {rank}-D tensor, got shape {tuple(y.shape)}")
    if y.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {y.device}")
    if not y.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if y.numel() == 0:
        raise ValueError(f"{name} takes a non-empty tensor")
    if y.data_ptr() % _ALIGN:
        raise ValueError(f"{name} needs a {_ALIGN}-byte aligned data pointer")


# ------------------------- P1: row blocks, Triton ----------------------------


@functools.cache
def _p1_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def p1_add_one(x_ptr, y_ptr, n_rows, n_cols, rows_per_block, n_blocks,
                   BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        r = tl.arange(0, BLOCK_R)[:, None]
        c = tl.arange(0, BLOCK_C)[None, :]
        # grid-stride over blocks: once per program when the grid is n_blocks
        for blk in range(tl.program_id(0), n_blocks, tl.num_programs(0)):
            row0 = blk * rows_per_block
            row_end = tl.minimum(row0 + rows_per_block, n_rows)
            for r0 in range(row0, row_end, BLOCK_R):  # register-sized sub-tiles
                rows = r0 + r
                mask = (rows < row_end) & (c < n_cols)
                offs = rows.to(tl.int64) * n_cols + c
                x = tl.load(x_ptr + offs, mask=mask)
                tl.store(y_ptr + offs, (x.to(tl.float32) + 1.0).to(tl.bfloat16), mask=mask)

    return triton, p1_add_one


def stream_add_one(y, rows_per_block=256, schedule="parallel"):
    """P1: ``y + 1`` for a contiguous 2-D bf16 ``y`` of at most
    :data:`MAX_COLS` columns, in blocks of ``rows_per_block`` rows.
    ``schedule`` is "parallel" (one program per block) or "persistent" (one
    program per SM, blocks taken grid-stride)."""
    _check(y, 2, "stream_add_one")
    if rows_per_block < 1:
        raise ValueError(f"rows_per_block must be >= 1, got {rows_per_block}")
    if schedule not in ("parallel", "persistent"):
        raise ValueError(f"schedule is 'parallel' or 'persistent', not {schedule!r}")
    n_rows, n_cols = y.shape
    if n_cols > MAX_COLS:
        raise ValueError(f"stream_add_one takes at most {MAX_COLS} columns, got {n_cols}")
    if y.device.type == "cpu":
        return add_one_plain(y)
    triton, kernel = _p1_kernel()
    block_c = triton.next_power_of_2(n_cols)
    block_r = max(1, _TILE_ELEMS // block_c)
    n_blocks = -(-n_rows // rows_per_block)
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        sms = torch.cuda.get_device_properties(y.device).multi_processor_count
        grid = n_blocks if schedule == "parallel" else min(n_blocks, sms)
        kernel[(grid,)](y, out, n_rows, n_cols, rows_per_block, n_blocks,
                        BLOCK_R=block_r, BLOCK_C=block_c, num_warps=_WARPS)
    stream_add_one.launches += 1
    return out


stream_add_one.launches = 0


# ---------------------- P3: NHWC image blocks, Triton ------------------------


@functools.cache
def _p3_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def p3_add_one(x_ptr, y_ptr, n, BLOCK: tl.constexpr, STREAMING: tl.constexpr):
        # one tile of the flat tensor a program; NHWC is contiguous
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        if STREAMING:  # nothing is read twice: do not keep it in L2
            x = tl.load(x_ptr + offs, mask=mask, eviction_policy="evict_first")
            tl.store(y_ptr + offs, (x.to(tl.float32) + 1.0).to(tl.bfloat16), mask=mask,
                     cache_modifier=".cs")
        else:
            x = tl.load(x_ptr + offs, mask=mask)
            tl.store(y_ptr + offs, (x.to(tl.float32) + 1.0).to(tl.bfloat16), mask=mask)

    return p3_add_one


# P3's sweep (chip_smoke.py phase 5): (tile KiB, warps, streaming hints). At
# 4 warps a thread loads 16 B x 2 (4 KiB), x 4 (8 KiB) or x 8 (16 KiB).
P3_SWEEP = ((4, 4, True), (2, 4, True), (8, 4, True), (4, 4, False))
P3_DEFAULT = (4, 4, True)


def nhwc_add_one(y, tile_kib=P3_DEFAULT[0], warps=P3_DEFAULT[1], streaming=P3_DEFAULT[2]):
    """P3: ``y + 1`` for a contiguous NHWC (B, H, W, C) bf16 ``y``: one
    program per ``tile_kib`` KiB of the flat tensor, ``warps`` warps each;
    ``streaming`` marks the loads evict-first and the stores streaming
    (``.cs``). The grid oversubscribes the SMs, so while one program waits
    on its loads another's stores drain."""
    _check(y, 4, "nhwc_add_one")
    if tile_kib < 1 or tile_kib & (tile_kib - 1):
        raise ValueError(f"tile_kib must be a power of 2, got {tile_kib}")
    if warps not in (1, 2, 4, 8, 16):
        raise ValueError(f"warps is a power of 2 up to 16, not {warps}")
    if y.device.type == "cpu":
        return add_one_plain(y)
    kernel = _p3_kernel()
    block = tile_kib * 1024 // y.element_size()
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        kernel[(-(-y.numel() // block),)](y, out, y.numel(), BLOCK=block,
                                          STREAMING=bool(streaming), num_warps=warps)
    nhwc_add_one.launches += 1
    return out


nhwc_add_one.launches = 0


# ------------------ P2: bulk-TMA copy pipeline, CUDA C++ ---------------------

DMA_STAGES = (2, 3, 4)


def _dma_kernel():
    from bndm_tpu_torch.ops import _build

    fn = _build.load("stream_dma").bndm_stream_add_one_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dma_add_one(y, chunk_bytes=32768, stages=2):
    """P2: ``y + 1`` for a contiguous 2-D bf16 ``y`` through a hand-managed
    pipeline: chunks of ``chunk_bytes`` (a multiple of 16) of the flat
    tensor, a ring of ``stages`` (2, 3 or 4) input and output buffers in
    each block's shared memory, which must hold 2 x stages x chunk_bytes."""
    _check(y, 2, "dma_add_one")
    if chunk_bytes < _ALIGN or chunk_bytes % _ALIGN:
        raise ValueError(f"chunk_bytes must be a positive multiple of {_ALIGN}, "
                         f"got {chunk_bytes}")
    if stages not in DMA_STAGES:
        raise ValueError(f"stages is one of {DMA_STAGES}, not {stages}")
    if y.device.type == "cpu":
        return add_one_plain(y)
    out = torch.empty_like(y)
    fn = _dma_kernel()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), out.data_ptr(), y.numel(), chunk_bytes, stages, stream)
    if err != 0:
        raise RuntimeError(f"dma_add_one kernel launch failed with CUDA error {err} "
                           f"(chunk_bytes={chunk_bytes}, stages={stages})")
    dma_add_one.launches += 1
    return out


dma_add_one.launches = 0
