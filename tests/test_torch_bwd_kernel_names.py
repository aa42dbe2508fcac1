"""PyTorch port, on the CPU (no compiler needed): the benchmark's
`flash_bwd.roofline.train` metric times the attention backward by kernel
name, so every `__global__` function of `csrc/flash_bwd.cu` and of the
headers it includes has to match the metric's `KERNELS` pattern (read from
the metric's file); a backward kernel the pattern missed would leave its
time out and read the share above its roofline."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "transfusion_tpu_torch" / "csrc"
METRIC = ROOT / "portbench" / "layer_metrics" / "flash_bwd.roofline.train.py"


def kernels_pattern() -> str:
    """The metric file's KERNELS, without importing it."""
    for node in ast.parse(METRIC.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "KERNELS"
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no KERNELS in {METRIC}")


def sources(name: str = "flash_bwd.cu") -> list:
    """name and every file it includes with #include "..." from csrc/, transitively."""
    seen, todo = [], [CSRC / name]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc for inc in re.findall(r'#include\s+"([^"]+)"', path.read_text())]
    return seen


def global_functions(path: Path) -> list:
    """The names of the __global__ functions defined in path (comments removed)."""
    text = re.sub(r"/\*.*?\*/", "", re.sub(r"//[^\n]*", "", path.read_text()), flags=re.S)
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^()]*\)\s*)?(\w+)\s*\(",
                      text)


def test_every_backward_kernel_is_named_as_the_metric_times():
    names = [name for path in sources() for name in global_functions(path)]
    assert {"flash_bwd_dkv_tc", "flash_bwd_dq_store", "row_ends", "v_norm_max",
            "cancel_bounds", "flash_bwd_dkv", "flash_bwd_dq"} <= set(names)
    pattern = kernels_pattern()
    assert [n for n in names if not re.search(pattern, n)] == []


def test_the_backward_includes_the_warpgroup_helpers():
    assert {p.name for p in sources()} >= {"flash_bwd.cu", "attn_tile.cuh", "mma_tile.cuh",
                                           "wgmma_tile.cuh"}


@pytest.mark.parametrize("name, times", [
    ("void (anonymous namespace)::wg::flash_bwd_dkv_tc<64, 64, true>(...)", True),
    ("void (anonymous namespace)::tc::flash_bwd_dkv_tc<64, true>(...)", True),
    ("void (anonymous namespace)::tc::flash_bwd_dq_store<192, false>(...)", True),
    ("void (anonymous namespace)::wg::flash_bwd_dkv_wg<64, 64, true>(...)", False),
    ("void (anonymous namespace)::tc::flash_fwd_tc<64, false, false>(...)", False),
])
def test_the_pattern_reads_profiler_names(name, times):
    """The pattern matches the demangled names the profiler reports for the
    backward's kernels, and not a renamed or a forward kernel."""
    assert bool(re.search(kernels_pattern(), name)) is times
