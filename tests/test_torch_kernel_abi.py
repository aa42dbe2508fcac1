"""PyTorch port: each CUDA library's C entry point and the argument types
its ctypes binding declares agree, on the CPU (no compiler needed): the
same number of parameters, each a pointer, an int or a float where the
binding says so. ctypes checks a call against the binding only, so on the
card a mismatch would hand the kernels their arguments in the wrong slots."""

import ctypes
import re
from pathlib import Path

import pytest

from transfusion_tpu_torch.ops import decode_attn, flash_attn

CSRC = Path(flash_attn.__file__).resolve().parents[1] / "csrc"


def c_parameters(name: str) -> list:
    """The ctypes type of each parameter of `extern "C" int name(...)` in
    csrc/name.cu."""
    src = (CSRC / f"{name}.cu").read_text()
    match = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    assert match, f"no C entry point {name} in {name}.cu"
    kinds = []
    for param in (" ".join(p.split()) for p in match.group(1).split(",")):
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        elif param.startswith("int "):
            kinds.append(ctypes.c_int)
        elif param.startswith("float "):
            kinds.append(ctypes.c_float)
        else:
            raise AssertionError(f"{name}: parameter of unknown kind: {param}")
    return kinds


@pytest.mark.parametrize("name, argtypes", [
    ("flash_fwd", flash_attn._FWD_ARGTYPES),
    ("flash_bwd", flash_attn._BWD_ARGTYPES),
    ("decode_attn", decode_attn._ARGTYPES),
])
def test_binding_matches_c_entry_point(name, argtypes):
    assert c_parameters(name) == list(argtypes)


def c_parameter_names(name: str) -> list:
    """The name of each parameter of `extern "C" int name(...)`."""
    src = (CSRC / f"{name}.cu").read_text()
    match = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    return [p.split()[-1].lstrip("*") for p in match.group(1).split(",")]


@pytest.mark.parametrize("name, argtypes", [
    ("flash_fwd", flash_attn._FWD_ARGTYPES),
    ("flash_bwd", flash_attn._BWD_ARGTYPES),
])
def test_flash_entry_points_take_the_value_width_after_the_head_dim(name, argtypes):
    """The flash kernels take the q k width `d` and the value width `d_v`
    as two ints, in that order, where the wrappers pass them."""
    names = c_parameter_names(name)
    i = names.index("d")
    assert names[i + 1] == "d_v"
    assert argtypes[i] == argtypes[i + 1] == ctypes.c_int
    assert names[i - 2:i] == ["nq", "nkv"] and names[i + 2] == "q_off"
