"""The HBM-streaming probes: ``y + 1`` in bf16, three ways.

PyTorch counterparts of the three Pallas kernels of the repository's bench
scripts, which measure how fast a hand-written kernel streams bytes:

  * P1, :func:`stream_add_one` (``variant(rows_per_block, semantics).f``,
    scripts/bench_pallas_stream.py:35-51): row blocks of a 2-D tensor, a
    Triton kernel. A block is cut into flat 4 KiB tiles in address order,
    P3's unit. ``schedule="parallel"`` is one program per tile;
    ``"persistent"`` (the TPU's sequential "arbitrary" grid, which has no
    order on the card) is as many programs as the SMs hold at once, each
    walking the tiles grid-stride and loading its next tile before it
    stores the one it holds.
  * P2, :func:`dma_add_one` (``manual_dma(rows_per_chunk).f``, :55-108):
    a copy pipeline managed by hand, in CUDA C++ (``csrc/stream_dma.cu``):
    as many persistent blocks as shared memory allows, each a producer
    thread that claims chunks from a counter and keeps 1-D bulk TMA loads
    of them in flight into one ring of stages (they complete on
    mbarriers), and bulk-stores each stage once consumer warps have added
    1 to it in place.
  * P3, :func:`nhwc_add_one` (``pallas_copy``,
    scripts/bench_elementwise_tpu.py:69-87): an NHWC (B, H, W, C) tensor, a
    Triton kernel. The TPU kernel's unit, 2 whole images (2 MiB) a program,
    split 250 programs unevenly over 132 SMs and left each program's loads
    and stores in turn; the card's design is an oversubscribed grid of one
    small tile a program with streaming cache hints (:data:`P3_SWEEP`).

A persistent grid that splits the work into equal shares up front waits
for its slowest SM at the end (PERF.md has the sweeps). P2 claims its
chunks from a counter instead, so the SMs that stream fastest take more;
the counters (:func:`_claims`) are set back to 0 by the last block of each
launch, so no launch is added to clear them. A Triton program cannot claim
that cheaply (every thread waits on a scalar atomic's result, once a
tile), so P1's default is the parallel schedule: one tile a program, which
the hardware hands out to whichever SM is free.

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
MAX_COLS = 16384  # the widest row P1 takes (a TPU variant's block holds whole rows)


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
    def tile_at(t, n_elems, block_elems, tiles_per_block, TILE: tl.constexpr):
        # tile t is the (t % tiles_per_block)-th TILE of row block
        # t // tiles_per_block, masked at the block's end
        blk = t // tiles_per_block
        start = blk.to(tl.int64) * block_elems
        offs = start + (t - blk * tiles_per_block).to(tl.int64) * TILE + tl.arange(0, TILE)
        return offs, offs < tl.minimum(start + block_elems, n_elems)

    @triton.jit
    def p1_add_one(x_ptr, y_ptr, n_elems, block_elems, tiles_per_block, n_tiles,
                   TILE: tl.constexpr, PERSISTENT: tl.constexpr):
        t = tl.program_id(0)
        offs, mask = tile_at(t, n_elems, block_elems, tiles_per_block, TILE)
        x = tl.load(x_ptr + offs, mask=mask, eviction_policy="evict_first")
        if PERSISTENT:
            # walk tiles t, t + step, ...: load the next tile before
            # storing this one
            step = tl.num_programs(0)
            for cur in range(t, n_tiles - step, step):
                n_offs, n_mask = tile_at(cur + step, n_elems, block_elems, tiles_per_block, TILE)
                nxt = tl.load(x_ptr + n_offs, mask=n_mask, eviction_policy="evict_first")
                c_offs, c_mask = tile_at(cur, n_elems, block_elems, tiles_per_block, TILE)
                tl.store(y_ptr + c_offs, (x.to(tl.float32) + 1.0).to(tl.bfloat16),
                         mask=c_mask, cache_modifier=".cs")
                x = nxt
            last = t + (n_tiles - 1 - t) // step * step
            offs, mask = tile_at(last, n_elems, block_elems, tiles_per_block, TILE)
        tl.store(y_ptr + offs, (x.to(tl.float32) + 1.0).to(tl.bfloat16), mask=mask,
                 cache_modifier=".cs")

    return p1_add_one


def resident_programs(warps, regs_per_thread, threads_per_sm, regs_per_sm=65536,
                      blocks_per_sm=32):
    """Programs of ``warps`` warps, ``regs_per_thread`` registers a thread,
    that one SM holds at once: the fewest its thread slots, its registers
    (given out 256 a warp) and its block slots allow (H100: 2048 threads,
    65,536 registers, 32 blocks)."""
    regs_per_warp = -(-regs_per_thread * 32 // 256) * 256
    return max(1, min(threads_per_sm // (32 * warps), regs_per_sm // (regs_per_warp * warps),
                      blocks_per_sm))


# P1's unit of work (P3's default): one flat tile of 4 KiB, 4 warps, 16
# bytes a thread twice over; the row block is the unit the schedule names
P1_TILE_KIB, P1_WARPS = 4, 4
P1_DEFAULT = (256, "parallel")
p1_resident = {}  # device index -> programs per SM of the persistent grid


def _p1_programs_per_sm(kernel, args, meta, device):
    """Reckoned once per device from the compiled kernel's registers."""
    if device.index not in p1_resident:
        compiled = kernel.warmup(*args, grid=(1,), **meta)
        compiled._init_handles()  # loads the binary, which reports its registers
        threads = torch.cuda.get_device_properties(device).max_threads_per_multi_processor
        p1_resident[device.index] = resident_programs(P1_WARPS, compiled.n_regs, threads)
    return p1_resident[device.index]


def stream_add_one(y, rows_per_block=P1_DEFAULT[0], schedule=P1_DEFAULT[1]):
    """P1: ``y + 1`` for a contiguous 2-D bf16 ``y`` of at most
    :data:`MAX_COLS` columns, in blocks of ``rows_per_block`` rows, each cut
    into flat tiles of :data:`P1_TILE_KIB` KiB in address order.
    ``schedule`` is "parallel" (one program per tile) or "persistent" (as
    many programs as the SMs hold at once, each walking the tiles
    grid-stride)."""
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
    kernel = _p1_kernel()
    tile = P1_TILE_KIB * 1024 // y.element_size()
    block_elems = min(rows_per_block, n_rows) * n_cols
    tiles_per_block = -(-block_elems // tile)
    n_tiles = -(-n_rows // rows_per_block) * tiles_per_block
    out = torch.empty_like(y)
    persistent = schedule == "persistent"
    meta = dict(TILE=tile, PERSISTENT=persistent, num_warps=P1_WARPS,
                num_stages=1)  # the loop is pipelined by hand
    with torch.cuda.device(y.device):
        args = (y, out, y.numel(), block_elems, tiles_per_block, n_tiles)
        grid = n_tiles
        if persistent:
            sms = torch.cuda.get_device_properties(y.device).multi_processor_count
            grid = min(n_tiles, sms * _p1_programs_per_sm(kernel, args, meta, y.device))
        kernel[(grid,)](*args, **meta)
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

DMA_STAGES = tuple(range(2, 9))  # MAX_STAGES in csrc/stream_dma.cu
_CLAIMS = {}


def _claims(device):
    """P2's claim counters (next chunk, blocks done, int64) for the current
    stream of ``device``: zeroed once, and each launch leaves them at 0
    again. One pair per stream, so that launches on two streams never
    share them."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _CLAIMS:
        _CLAIMS[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _CLAIMS[key]


def _dma_kernel():
    from bndm_tpu_torch.ops import _build

    fn = _build.load("stream_dma").bndm_stream_add_one_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


P2_DEFAULT = (16384, 8)


def dma_add_one(y, chunk_bytes=P2_DEFAULT[0], stages=P2_DEFAULT[1]):
    """P2: ``y + 1`` for a contiguous 2-D bf16 ``y`` through a hand-managed
    pipeline: chunks of ``chunk_bytes`` (a multiple of 16) of the flat
    tensor, added in place in a ring of ``stages`` (2 to 8) buffers in each
    block's shared memory, which must hold stages x chunk_bytes; as many
    blocks as the SMs hold at once, each claiming chunks in turn."""
    _check(y, 2, "dma_add_one")
    if chunk_bytes < _ALIGN or chunk_bytes % _ALIGN:
        raise ValueError(f"chunk_bytes must be a positive multiple of {_ALIGN}, "
                         f"got {chunk_bytes}")
    if stages not in DMA_STAGES:
        raise ValueError(f"stages is 2 to 8, not {stages}")
    if y.device.type == "cpu":
        return add_one_plain(y)
    out = torch.empty_like(y)
    fn = _dma_kernel()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), out.data_ptr(), y.numel(), chunk_bytes, stages,
                 _claims(y.device).data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dma_add_one kernel launch failed with CUDA error {err} "
                           f"(chunk_bytes={chunk_bytes}, stages={stages})")
    dma_add_one.launches += 1
    return out


dma_add_one.launches = 0
