"""Import and device guards of the PyTorch port.

* No module of deepspeed_tpu_torch/ and not chip_smoke.py imports ``jax``,
  the JAX package or ``ml_dtypes`` (an AST scan of every import
  statement), and importing the port leaves them out of ``sys.modules``
  (a fresh interpreter). bf16 arrays cross numpy as uint16 bits.
* The model, op, serving, inference, elasticity and testing layers import
  nothing of the training engine (their shared errors live in
  ``errors.py``). Five
  runtime modules that the reference's models, inference engine and
  elasticity import too are open to them — activation checkpointing, the
  chunked loss and random-LTD's token routing (models), the checkpoint
  format (inference) and the config base class (elasticity) — and those
  import nothing else of the runtime.
* Entry points default to the CUDA card: with no card, ``init_inference()``
  and ``initialize()`` without a device raise instead of carrying on on the
  CPU.
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
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu", "flax", "optax", "ml_dtypes")
# runtime modules a lower layer may import (as the reference's do)
OPEN_TO = {
    "models": ("deepspeed_tpu_torch.runtime.activation_checkpointing",
               "deepspeed_tpu_torch.runtime.zero.tiling",
               "deepspeed_tpu_torch.runtime.data_pipeline.random_ltd"),
    "inference": ("deepspeed_tpu_torch.runtime.checkpoint_engine",),
    # the elasticity config builds on the config base class, as the
    # reference's does; the fault seams take an engine and import none
    "elasticity": ("deepspeed_tpu_torch.runtime.config_utils",),
}


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


@pytest.mark.parametrize("layer", ["models", "ops", "serving", "inference",
                                   "elasticity", "testing"])
def test_lower_layers_do_not_import_the_training_runtime(layer):
    open_to = OPEN_TO.get(layer, ())
    for path in sorted((ROOT / "deepspeed_tpu_torch" / layer).rglob("*.py")):
        for name in _imported_roots(path):
            if open_to and name.startswith(open_to):
                continue
            assert not name.startswith("deepspeed_tpu_torch.runtime"), \
                f"{path.relative_to(ROOT)} imports {name}"


@pytest.mark.parametrize("module", sorted({m for ms in OPEN_TO.values()
                                           for m in ms}))
def test_runtime_modules_open_to_lower_layers_import_no_more_runtime(module):
    """What a lower layer may import of the runtime pulls in nothing else of
    it (the engine, its config), except the configuration class that
    ``activation_checkpointing.configure`` builds when given no config."""
    base = ROOT / module.replace(".", "/")
    files = sorted(base.rglob("*.py")) if base.is_dir() else [
        base.with_suffix(".py")]
    allowed = (module, "deepspeed_tpu_torch.runtime.config")
    for path in files:
        for name in _imported_roots(path):
            if name.startswith("deepspeed_tpu_torch.runtime"):
                assert name.startswith(allowed), \
                    f"{path.relative_to(ROOT)} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, deepspeed_tpu_torch, deepspeed_tpu_torch.serving, "
            "deepspeed_tpu_torch.inference, deepspeed_tpu_torch.runtime.engine, "
            "deepspeed_tpu_torch.runtime.dataloader, "
            "deepspeed_tpu_torch.models.gpt2, deepspeed_tpu_torch.ops.adam, "
            "deepspeed_tpu_torch.ops.flash_attention, "
            "deepspeed_tpu_torch.ops.sparse_attention, "
            "deepspeed_tpu_torch.ops.registry, "
            "deepspeed_tpu_torch.runtime.sentinel, "
            "deepspeed_tpu_torch.elasticity, deepspeed_tpu_torch.testing; "
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
        deepspeed_tpu_torch.initialize(
            model=deepspeed_tpu_torch.GPT2Model(deepspeed_tpu_torch.GPT2Config.tiny()),
            config={"train_batch_size": 2})
    with pytest.raises(DeviceUnavailableError):
        get_accelerator("cuda")
    assert get_accelerator("cpu").device().type == "cpu"
