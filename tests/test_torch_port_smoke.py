"""chip_smoke.py stays runnable: it runs only on the card, so a package edit
that breaks one of its imports or its option parsing would otherwise show
only there."""

import ast
import importlib
import importlib.util
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "chip_smoke.py"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _repo_imports():
    """(module, name or None) of every import of ``bndm_tpu_torch`` or
    ``perfbench`` anywhere in the script, those inside functions too."""
    out = []
    for node in ast.walk(ast.parse(SCRIPT.read_text(), str(SCRIPT))):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            out += [(node.module, a.name) for a in node.names]
        elif isinstance(node, ast.Import):
            out += [(a.name, None) for a in node.names]
    return [(m, n) for m, n in out if m.split(".")[0] in ("bndm_tpu_torch", "perfbench")]


def test_every_name_the_smoke_imports_exists():
    """Each module the script imports from the port or the benchmark
    imports on the CPU, and has each name the script takes from it (an
    attribute or a submodule)."""
    found = _repo_imports()
    missing = []
    for module, name in found:
        mod = importlib.import_module(module)
        if name is not None and not (hasattr(mod, name)
                                     or importlib.util.find_spec(f"{module}.{name}")):
            missing.append(f"{module}.{name}")
    assert not missing
    # the walk reaches the imports inside the phases
    assert ("perfbench.yardstick", "roofline") in found
    assert ("bndm_tpu_torch.ops.cuda_bluenoise", "SKINNY_LIMIT_M") in found
    assert ("bndm_tpu_torch.cli.demo", None) in found


def test_main_refuses_unknown_options_and_needs_cuda():
    """An unknown option exits 2 before anything runs; without CUDA the
    full run exits 1 before its first phase (not tried on a card, where it
    would start the whole run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.main(["--bogus"]) == 2
    assert smoke.main(["--kernels", "--train"]) == 2
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: main([]) would start the whole run")
    assert smoke.main([]) == 1
