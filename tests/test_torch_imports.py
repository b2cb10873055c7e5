"""Import hygiene of the PyTorch port: ``kubetpu_torch`` loads neither JAX
nor any ``kubetpu`` module, and its entry points refuse to run without a
device rather than drop to the CPU on their own."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import kubetpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "kubetpu_torch")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        kubetpu_torch.__path__, prefix="kubetpu_torch."))


def test_fresh_import_loads_no_jax_and_no_kubetpu():
    """Every module of the port, imported in a fresh interpreter (this
    process already holds jax through conftest), leaves jax and kubetpu
    out of sys.modules."""
    mods = _all_modules()
    for name in ("jobs.paged", "jobs.train", "jobs.data", "jobs.convert",
                 "ops.paged_attention", "ops.flash_attention"):
        assert f"kubetpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'kubetpu' "
        "or m.startswith('kubetpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_neither_jax_nor_kubetpu():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+kubetpu(\.|\s|$)|"
        r"from\s+kubetpu(\.|\s))", re.M)
    scanned = 0
    for root, _dirs, files in os.walk(PKG_DIR):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                src = f.read()
            scanned += 1
            hit = pattern.search(src)
            assert hit is None, f"{name}: {hit.group(0)!r}"
    assert scanned >= 10


def test_entry_points_default_to_the_card_and_raise_without_it():
    """No device and no CUDA: model construction, the servers, the train
    entry points and the flash wrappers raise, never continue silently on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    from kubetpu_torch.jobs.model import ModelConfig, init_params
    from kubetpu_torch.jobs.paged import PagedDecodeServer, init_page_pool
    from kubetpu_torch.jobs.serving import SlotServerBase
    from kubetpu_torch.jobs.train import (init_state, make_eval_step,
                                          make_train_step)
    from kubetpu_torch.ops import flash_attention as fa

    cfg = ModelConfig(vocab=32, d_model=16, n_layers=1, n_heads=2, d_ff=32)
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedDecodeServer(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_page_pool(cfg, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedDecodeServer(cfg, model, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlotServerBase(cfg, model, n_slots=2, max_seq=16, max_new_tokens=4,
                       eos_id=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(cfg)
    # the flash wrappers follow their tensors: the plain version on the
    # CPU, the kernel on the card, and anything else raises
    meta = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_forward(meta, meta, meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(meta, meta, meta)
