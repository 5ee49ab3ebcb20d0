"""Import and device guards of the PyTorch port.

* No module of deepspeed_tpu_torch/ and not chip_smoke.py imports ``jax`` or
  the JAX package (an AST scan of every import statement), and importing
  the port leaves ``jax`` out of ``sys.modules`` (a fresh interpreter).
* Entry points default to the CUDA card: with no card, ``init_inference()``
  without a device raises instead of carrying on on the CPU.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.accelerator import DeviceUnavailableError, get_accelerator
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu", "flax", "optax")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, deepspeed_tpu_torch, deepspeed_tpu_torch.serving, "
            "deepspeed_tpu_torch.inference; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert get_accelerator().device().type == "cuda"
        return
    with pytest.raises(DeviceUnavailableError):
        deepspeed_tpu_torch.init_inference(LlamaModel(LlamaConfig.tiny()))
    with pytest.raises(DeviceUnavailableError):
        get_accelerator("cuda")
    assert get_accelerator("cpu").device().type == "cpu"
