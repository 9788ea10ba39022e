"""How fast can a hand-written kernel stream bytes on the card?

Counterpart of ``scripts/bench_pallas_stream.py``: ``y + 1`` over a bf16
(256000, 1024) tensor (the payload of one (500, 64, 64, 128) activation,
524,288,000 B) through

  * P1 (Triton) in row blocks of 256, 512 and 1024 rows, each with one
    program per SM taking blocks in turn ("persistent", the TPU's
    sequential "arbitrary" grid) and with one program per block
    ("parallel");
  * P2 (CUDA C++, bulk TMA and mbarriers) over a sweep of chunk sizes and
    ring depths;
  * the library's own ``y + 1`` ("torch add same shape").

Each case is ``inner`` chained passes between two CUDA events after one
warm-up loop, reported as one JSON line: ms per pass, GB/s of reads plus
writes, and the share of the H100 SXM data sheet's 3.35 TB/s.

    python -m bndm_tpu_torch.scripts.bench_stream

It runs on CUDA; ``main(device="cpu")`` runs the plain versions on the CPU
(for tests, at a small shape). A case that fails raises.
"""

from __future__ import annotations

import json

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
ROWS_PER_BLOCK = (256, 512, 1024)
SCHEDULES = ("persistent", "parallel")
DMA_SWEEP = ((16384, 2), (32768, 2), (49152, 2), (16384, 3), (32768, 3), (16384, 4))


def report(name, ms, moved_bytes, device):
    """Print and return one case's JSON line."""
    gb_s = moved_bytes / 1e9 / (ms / 1e3)
    on_card = torch.device(device).type == "cuda"
    row = {"case": name, "ms": ms, "gb_s": gb_s,
           "peak_share": gb_s * 1e9 / HBM_BYTES_PER_S if on_card else None,
           "device": torch.cuda.get_device_name(device) if on_card else "cpu"}
    print(json.dumps(row), flush=True)
    return row


def cases(n_cols):
    """(name, fn) for every case, in the JAX script's order."""
    from bndm_tpu_torch.ops.stream_probes import (add_one_plain, dma_add_one,
                                                  stream_add_one)

    out = []
    for rpb in ROWS_PER_BLOCK:
        for sched in SCHEDULES:
            out.append((f"auto blk ({rpb * n_cols * 2 / 2**20:g}MiB) {sched}",
                        lambda y, rpb=rpb, sched=sched: stream_add_one(y, rpb, sched)))
    for chunk, stages in DMA_SWEEP:
        out.append((f"manual dma ({chunk // 1024}KiB chunks, {stages} stages)",
                    lambda y, chunk=chunk, stages=stages: dma_add_one(y, chunk, stages)))
    out.append(("torch add same shape", add_one_plain))
    return out


def main(shape=(500 * 64 * 64 // 8, 8 * 128), inner=20, device="cuda"):
    from bndm_tpu_torch.cli.common import resolve_device
    from bndm_tpu_torch.utils.timing import pass_ms

    device = resolve_device(device)
    g = torch.Generator(device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    moved = 2 * x.numel() * x.element_size()  # read once, written once
    return [report(name, pass_ms(fn, x, inner, device), moved, device)
            for name, fn in cases(shape[1])]


if __name__ == "__main__":
    main()
