"""The reference's torch examples on the port (``examples/torch_port/``).

Each script runs to its end under the port's launcher (``python -m
horovod_tpu_torch.runner.launch -np 2 ... --no-cuda``, gloo) at a small
size, through a wrapper that records every optimizer the script makes
and, at ``hvd.shutdown()``, saves the params those optimizers hold: the
ranks end with the same params, bit for bit (the averaged gradients are
the same bits on every rank). ``pytorch_mnist.py`` at 2 ranks also
equals a 1-rank run on the joined batches (twice the batch, the same
``lr x size``): the same SGD steps on the same mean gradients, summed in
another order, so within 1e-5 of the params' largest magnitude (f32).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_mp import REPO_ROOT

EXAMPLES = os.path.join(REPO_ROOT, "examples", "torch_port")

_WRAPPER = """
import os, runpy, sys
import numpy as np
import torch
import horovod_tpu_torch.torch as hvd

out, script = sys.argv[1], sys.argv[2]
optimizers = []
_init = torch.optim.Optimizer.__init__


def _record(self, *args, **kwargs):
    _init(self, *args, **kwargs)
    optimizers.append(self)


torch.optim.Optimizer.__init__ = _record
_shutdown = hvd.shutdown


def _dump():
    seen, params = set(), []
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                if id(p) not in seen:
                    seen.add(id(p))
                    params.append(p.detach().float().cpu().numpy())
    np.savez(os.path.join(out, f"rank{hvd.rank()}.npz"), *params)
    _shutdown()


hvd.shutdown = _dump
sys.argv = [script] + sys.argv[3:]
runpy.run_path(script, run_name="__main__")
"""

CASES = {
    "pytorch_mnist.py": ["--epochs", "1"],
    "pytorch_synthetic_benchmark.py": [
        "--batch-size", "2", "--num-warmup-batches", "1",
        "--num-batches-per-iter", "1", "--num-iters", "2"],
    "pytorch_bert_finetune.py": ["--hidden", "32", "--layers", "1",
                                 "--seq-len", "16", "--batch-size", "4",
                                 "--steps", "3"],
    "torch_resnet50.py": ["--depth", "18", "--batch-size", "2",
                          "--image-size", "32", "--steps", "2"],
}


def _launch(tmp_path, script, args, np_):
    out = tmp_path / f"{script}.{np_}"
    out.mkdir()
    wrapper = tmp_path / "wrapper.py"
    wrapper.write_text(_WRAPPER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = REPO_ROOT
    # The ranks share the machine's cores with the other test workers.
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(np_), sys.executable, str(wrapper), str(out),
         os.path.join(EXAMPLES, script), *args, "--no-cuda"],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO_ROOT)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    ranks = []
    for r in range(np_):
        with np.load(out / f"rank{r}.npz") as f:
            ranks.append([f[k] for k in sorted(f.files,
                                               key=lambda k: int(k[4:]))])
    return proc, ranks


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_runs_on_two_ranks_and_the_ranks_agree(tmp_path, script):
    proc, ranks = _launch(tmp_path, script, CASES[script], 2)
    assert ranks[0], "the wrapper recorded no optimizer's params"
    assert len(ranks[0]) == len(ranks[1])
    for a, b in zip(*ranks):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert "loss" in proc.stdout or "img/sec" in proc.stdout


def test_mnist_two_ranks_equal_one_rank_on_the_joined_batches(tmp_path):
    _, two = _launch(tmp_path, "pytorch_mnist.py",
                     ["--epochs", "1", "--batch-size", "64", "--lr",
                      "0.01"], 2)
    _, one = _launch(tmp_path, "pytorch_mnist.py",
                     ["--epochs", "1", "--batch-size", "128", "--lr",
                      "0.02"], 1)
    for a, b in zip(two[0], one[0]):
        scale = max(1.0, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= 1e-5 * scale


def test_examples_without_a_card_raise_unless_asked_for_the_cpu(tmp_path):
    """No silent fallback: without ``--no-cuda`` on a machine with no
    card, ``hvd.init()`` raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = REPO_ROOT
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "pytorch_mnist.py"),
         "--epochs", "1"], capture_output=True, text=True, timeout=120,
        env=env, cwd=REPO_ROOT)
    assert proc.returncode != 0
    assert "no CUDA device available" in proc.stderr
