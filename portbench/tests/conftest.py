"""The benchmark's tests: `python -m pytest portbench/tests -q` on the
CPU; the tests marked `cuda` run where a card is, and skip elsewhere."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a test of the benchmark on the card")
    return "cuda"


@pytest.fixture(scope="session")
def cornell_film(tmp_path_factory):
    """The Cornell box under the `film` mix, the cheapest film scene, as a
    cell of the CPU tests: BENCHMARK.json with the cell added, beside the
    benchmark's own files."""
    from portbench.harness import Cell
    root = tmp_path_factory.mktemp("bench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "cornell-box.film",
                               "config": "cornell-box", "traffic": "film",
                               "chips": 1, "why": "the CPU tests' film cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench").symlink_to(ROOT / "portbench")
    return Cell("cornell-box.film", root=root)


def tiny(width=24, per_region=32):
    """A `shrink` for run_cell and control: the film `width` pixels wide,
    the check on 4 x 4 regions of `per_region` pixels."""
    def shrink(scene, check_cfg):
        scene.height = max(width * scene.height // scene.width, 4)
        scene.width = width
        check_cfg["regions"] = [4, 4]
        check_cfg["pixels_per_region"] = per_region
    return shrink
