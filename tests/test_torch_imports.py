"""The PyTorch/CUDA port stands alone: no JAX, nothing of the JAX package.

Every module of ``src/repro_torch`` and the repository's ``chip_smoke.py``
is imported in a fresh interpreter, which must then hold neither ``jax``
nor any ``repro.`` module. The entry points run on the card by default
and must refuse — not fall back to the CPU — when CUDA is absent.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = REPO / "src"


def _port_modules():
    mods = []
    for py in sorted((SRC / "repro_torch").rglob("*.py")):
        rel = py.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    mods = _port_modules()
    assert "repro_torch.serving.engine" in mods and len(mods) > 20
    assert {"repro_torch.core.attention", "repro_torch.kernels.flash_prefill",
            "repro_torch.models.rglru",
            "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.models.moe", "repro_torch.serving.globalpool",
            "repro_torch.serving.sharded_step",
            "repro_torch.configs.qwen2_moe_a2_7b",
            "repro_torch.configs.kimi_k2_1t_a32b"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(SRC)!r}, {str(REPO)!r}]\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_never_name_jax_or_the_reference():
    """A static guard beside the runtime one: no import line of the
    port, of chip_smoke.py or of the port's scripts names jax or the
    ``repro`` package."""
    files = list((SRC / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"] + list((REPO / "scripts").glob("*.py"))
    assert REPO / "scripts" / "pool_mode_ab.py" in files
    bad = []
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                if mod.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{f.name}:{i}: {s}")
    assert not bad, bad


def test_entry_points_default_to_cuda_and_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import (Cluster, InstanceEngine, LLMServer,
                                     ServingConfig)
    hybrid = get_smoke_config("recurrentgemma-9b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(hybrid)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMServer(init_params(hybrid, device="cpu"), hybrid,
                  ServingConfig.smoke())
    cfg = get_smoke_config("olmo-1b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMServer(params, cfg, ServingConfig.smoke())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Cluster(params, cfg, ServingConfig.smoke())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InstanceEngine(params, cfg, max_local_len=64, block_size=8)
    # Asked for the CPU explicitly, the same calls work.
    assert LLMServer(params, cfg, ServingConfig.smoke(),
                     device="cpu").cluster.device.type == "cpu"


def test_chip_smoke_refuses_without_cuda_or_outside_the_repo(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line when it
    has no card, and when it stands alone in a directory."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script in (REPO / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=240,
                             env=env, cwd=str(script.parent))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
