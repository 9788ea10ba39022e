"""The control of each cell's comparison: a step below the configuration's
precision. At a tiny size on the CPU it reads far above a sound run of the
program at that size; marked ``gpu``, at the cells' own sizes on the card,
it reads above a limit of the cell, so it comes out as not correct:

    python -m pytest -p no:cacheprovider perfbench/tests/test_perfbench_control.py
"""

import pytest
import torch

from perfbench import control, run
from perfbench.tests.tiny import tiny

CELLS = ["cat64_bndm.train", "celeba256_latent.train", "celeba256_latent.sample",
         "celeba256_latent.sample_cached"]


def _fails_a_limit(workload, readings):
    limits = run.cell_files(run.load_bench(), workload)[2]["limits"]
    return any(v > limits[k] for k, v in readings["control"].items() if k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program_at_a_tiny_size(cell):
    torch.set_num_threads(1)
    config, traffic = tiny(cell)
    seed = 2**31 + 99
    out = control.control(cell, seed, "cpu", config, traffic)
    result, _ = run.run_cell(cell, seed, 0.1, 0, device="cpu", config=config, traffic=traffic)
    sound = max(v["value"] for v in result["checks"].values())
    assert max(out["control"].values()) > max(10 * sound, 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_fails_at_the_cells_size(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cells' sizes run on the card)")
    assert _fails_a_limit(cell, control.control(cell, seed))
