"""The PyTorch port's import rules and default-device rule.

``horovod_tpu_torch`` imports torch and numpy only: importing it loads
neither jax, triton, the JAX package, yaml nor mpi4py (which the MPI
bootstrap imports only behind its launcher gate), no module of it (nor
chip_smoke.py, nor the examples of ``examples/torch_port/``) names jax,
ml_dtypes, horovod_tpu or yaml in an import,
and its entry points raise — never fall back to the CPU — when no device
is given and there is no CUDA. Every kernel source is listed in
``ops/_build.py``, and importing the port builds nothing.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "horovod_tpu_torch").rglob("*.py")) + sorted(
    (REPO / "examples" / "torch_port").glob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "ml_dtypes", "horovod_tpu", "bench", "yaml")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_triton_or_reference_package():
    # Diff sys.modules around the import, so modules an interpreter
    # preloads at start-up cannot be blamed on the port.
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import horovod_tpu_torch\n"
        "import horovod_tpu_torch.models.generate\n"
        "import horovod_tpu_torch.models.bert\n"
        "import horovod_tpu_torch.ops.grouped_moe\n"
        "import horovod_tpu_torch.models.convert\n"
        "import horovod_tpu_torch.serving.engine\n"
        "import horovod_tpu_torch.parallel.train_step\n"
        "import horovod_tpu_torch.parallel.zero\n"
        "import horovod_tpu_torch.parallel.fusion\n"
        "import horovod_tpu_torch.torch.fused_optimizer\n"
        "import horovod_tpu_torch.parallel.precision\n"
        "import horovod_tpu_torch.ops.adam\n"
        "import horovod_tpu_torch.models.resnet\n"
        "import horovod_tpu_torch.models.mlp\n"
        "import horovod_tpu_torch.parallel.ring_attention\n"
        "import horovod_tpu_torch.parallel.ulysses\n"
        "import horovod_tpu_torch.torch\n"
        "import horovod_tpu_torch.telemetry.debug_server\n"
        "import horovod_tpu_torch.common.response_cache\n"
        "import horovod_tpu_torch.common.timeline\n"
        "import horovod_tpu_torch.torch.elastic\n"
        "import horovod_tpu_torch.checkpoint\n"
        "import horovod_tpu_torch.runner.elastic.rendezvous\n"
        "import horovod_tpu_torch.runner.elastic.worker\n"
        "import horovod_tpu_torch.runner.elastic.driver\n"
        "import horovod_tpu_torch.runner.elastic.discovery\n"
        "import horovod_tpu_torch.runner.launch\n"
        "import horovod_tpu_torch.runner.mpi_run\n"
        "import horovod_tpu_torch.runner.js_run\n"
        "import horovod_tpu_torch.runner.task_service\n"
        "import horovod_tpu_torch.common.mpi_bootstrap\n"
        "import horovod_tpu_torch.common.capabilities\n"
        "import horovod_tpu_torch.data\n"
        "import horovod_tpu_torch.models\n"
        "import horovod_tpu_torch.parallel\n"
        "import horovod_tpu_torch.serving\n"
        "import horovod_tpu_torch.runner.elastic\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'ml_dtypes', 'horovod_tpu', 'yaml',\n"
        " 'mpi4py'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                found.append(node.module)
    assert not found, f"{path.name} imports {found}"


def test_build_lists_every_kernel_source():
    from horovod_tpu_torch.ops import _build

    sources = sorted(p.stem for p in (REPO / "horovod_tpu_torch" / "csrc")
                     .glob("*.cu"))
    assert sorted(_build.SOURCES) == sources
    assert {"grouped_mm", "flash_fwd_wgmma", "grouped_mm_wgmma",
            "flash_bwd_wgmma", "flash_bwd_dq_wgmma",
            "decode_attention_wgmma"} <= set(_build.SOURCES)


def test_import_builds_nothing():
    """Importing every module starts no compiler and loads no library:
    kernels build at their first launch, on the card."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a build started at import')\n"
        "subprocess.Popen = refuse\n"
        "import horovod_tpu_torch.models.generate\n"
        "import horovod_tpu_torch.models.bert\n"
        "import horovod_tpu_torch.ops.grouped_moe\n"
        "import horovod_tpu_torch.serving.engine\n"
        "import horovod_tpu_torch.parallel.train_step\n"
        "import horovod_tpu_torch.parallel.zero\n"
        "import horovod_tpu_torch.parallel.fusion\n"
        "import horovod_tpu_torch.torch.fused_optimizer\n"
        "import horovod_tpu_torch.parallel.ring_attention\n"
        "import horovod_tpu_torch.parallel.ulysses\n"
        "import horovod_tpu_torch.torch\n"
        "import horovod_tpu_torch.telemetry.debug_server\n"
        "import horovod_tpu_torch.common.response_cache\n"
        "import horovod_tpu_torch.common.timeline\n"
        "import horovod_tpu_torch.torch.elastic\n"
        "import horovod_tpu_torch.checkpoint\n"
        "import horovod_tpu_torch.runner.elastic.rendezvous\n"
        "import horovod_tpu_torch.runner.elastic.worker\n"
        "import horovod_tpu_torch.runner.elastic.driver\n"
        "import horovod_tpu_torch.runner.elastic.discovery\n"
        "import horovod_tpu_torch.runner.launch\n"
        "import horovod_tpu_torch.runner.mpi_run\n"
        "import horovod_tpu_torch.runner.js_run\n"
        "import horovod_tpu_torch.runner.task_service\n"
        "import horovod_tpu_torch.common.mpi_bootstrap\n"
        "import horovod_tpu_torch.common.capabilities\n"
        "import horovod_tpu_torch.data\n"
        "import horovod_tpu_torch.models\n"
        "import horovod_tpu_torch.parallel\n"
        "import horovod_tpu_torch.serving\n"
        "import horovod_tpu_torch.runner.elastic\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "from horovod_tpu_torch.ops import _build\n"
        "assert _build._libs == {}, _build._libs\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _entry_points():
    from horovod_tpu_torch.models.bert import (
        BertConfig,
        bert_forward,
        bert_init,
        bert_mlm_loss,
    )
    from horovod_tpu_torch.models.convert import (
        from_jax_opt_state,
        from_jax_params,
    )
    from horovod_tpu_torch.models.generate import (
        llama_decode_step,
        llama_generate,
        llama_prefill,
    )
    from horovod_tpu_torch.models.llama import (
        LlamaConfig,
        llama_forward,
        llama_init,
        llama_loss,
    )
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.precision import FusedAdamState
    from horovod_tpu_torch.serving.engine import DecodeEngine
    import horovod_tpu_torch.torch as hvd

    cfg = LlamaConfig.tiny(dtype="float32")
    params = llama_init(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    cache = torch.zeros((cfg.n_layers, 1, cfg.n_kv_heads, 8,
                         cfg.head_dim))
    bcfg = BertConfig.tiny(dtype="float32")
    bparams = bert_init(bcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    mlm = np.ones((1, 4), np.float32)
    return {
        "llama_init": lambda: llama_init(cfg, torch.Generator()),
        "from_jax_params": lambda: from_jax_params(
            {"w": np.zeros(2, np.float32)}),
        "llama_generate": lambda: llama_generate(params, prompt, cfg, 2),
        "llama_prefill": lambda: llama_prefill(params, prompt, cfg),
        "llama_decode_step": lambda: llama_decode_step(
            params, np.zeros(1, np.int32), cache, cache,
            np.zeros(1, np.int32), cfg),
        "DecodeEngine": lambda: DecodeEngine(params, cfg),
        "llama_forward": lambda: llama_forward(params, prompt, cfg),
        "llama_loss": lambda: llama_loss(
            params, {"tokens": prompt, "targets": prompt}, cfg),
        "from_jax_opt_state": lambda: from_jax_opt_state(FusedAdamState(
            count=np.zeros((), np.int32), mu={}, nu={})),
        "hvd.init": hvd.init,
        "bert_init": lambda: bert_init(bcfg, torch.Generator()),
        "bert_forward": lambda: bert_forward(bparams, prompt, bcfg),
        "bert_mlm_loss": lambda: bert_mlm_loss(
            bparams, {"tokens": prompt, "targets": prompt, "mlm_mask": mlm},
            bcfg),
        "create_mesh": lambda: create_mesh(seq=1),
    }


@pytest.mark.parametrize("name", ["llama_init", "from_jax_params",
                                  "llama_generate", "llama_prefill",
                                  "llama_decode_step", "DecodeEngine",
                                  "llama_forward", "llama_loss",
                                  "from_jax_opt_state", "hvd.init",
                                  "bert_init", "bert_forward",
                                  "bert_mlm_loss", "create_mesh"])
def test_entry_point_without_device_raises_without_cuda(name,
                                                        monkeypatch):
    calls = _entry_points()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()

