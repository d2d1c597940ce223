"""Rules the PyTorch port keeps: no JAX, nothing of nos_tpu, no silent CPU.

- No module of nos_tpu_torch/, and not chip_smoke.py, imports jax or
  anything of nos_tpu (an AST scan of every import statement).
- Importing the port's serving and training stacks leaves jax,
  nos_tpu.* and transformers out of sys.modules (a fresh interpreter;
  the card's machine may lack transformers, and models/convert.py
  reads a model instance the caller built).
- With no CUDA device, an entry point called without ``device`` raises;
  it never falls back to the CPU on its own.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "nos_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    files = sorted((ROOT / "nos_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_port_file_imports_jax_or_the_reference():
    files = _port_files()
    names = {str(path.relative_to(ROOT)) for path in files}
    # the scan walks the package: every module of the serving extensions
    # is in it
    assert {
        "nos_tpu_torch/models/quantize.py", "nos_tpu_torch/models/lora.py",
        "nos_tpu_torch/models/speculative.py", "nos_tpu_torch/serve/spec_engine.py",
        "nos_tpu_torch/models/moe.py", "nos_tpu_torch/models/convert.py",
    } <= names, names
    assert len(files) >= 16, files
    bad = [
        f"{path.relative_to(ROOT)}: {mod}"
        for path in files for mod in _imports(path) if _forbidden(mod)
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import nos_tpu_torch.serve, nos_tpu_torch.bridge\n"
        "import nos_tpu_torch.models.generate, nos_tpu_torch.ops.flash_attention\n"
        "import nos_tpu_torch.parallel.train, nos_tpu_torch.data\n"
        "import nos_tpu_torch.models.quantize, nos_tpu_torch.models.lora\n"
        "import nos_tpu_torch.models.speculative, nos_tpu_torch.serve.spec_engine\n"
        "import nos_tpu_torch.models.moe, nos_tpu_torch.models.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'nos_tpu', 'transformers'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_when_there_is_no_gpu(no_cuda):
    from nos_tpu_torch import _resolve_device
    from nos_tpu_torch.bridge import params_from_numpy
    from nos_tpu_torch.data import prefetch_to_device
    from nos_tpu_torch.models.generate import init_kv_cache
    from nos_tpu_torch.models.llama import init_llama_params, tiny_config
    from nos_tpu_torch.parallel import make_train_step

    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_llama_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"embed": None, "final_norm": None, "layers": []}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(None, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_to_device(iter([])))
    # asked for by name, the CPU is fine
    assert _resolve_device("cpu") == torch.device("cpu")
    params = init_llama_params(cfg, 0, device="cpu")
    assert params["embed"].device.type == "cpu"


def test_init_is_seeded_and_lands_in_the_model_dtype():
    from nos_tpu_torch.models.llama import init_llama_params, tiny_config

    cfg = tiny_config()
    a = init_llama_params(cfg, 5, device="cpu")
    b = init_llama_params(cfg, 5, device="cpu")
    c = init_llama_params(cfg, 6, device="cpu")
    assert a["layers"][1]["w_up"].dtype == torch.bfloat16
    assert torch.equal(a["layers"][1]["w_up"], b["layers"][1]["w_up"])
    assert not torch.equal(a["layers"][1]["w_up"], c["layers"][1]["w_up"])


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """No card: non-zero exit and no result line. Alone in a directory
    (no checkout beside it) it refuses the same way."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
