"""Import hygiene of the PyTorch port: ``kubetpu_torch`` and
``chip_smoke.py`` load neither JAX nor any ``kubetpu`` module (a port
replica serves a generate with neither in the process), and the port's
entry points refuse to run without a device rather than drop to the CPU on
their own."""

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
                 "jobs.decode", "jobs.serving", "jobs.speculative",
                 "jobs.spec_serving", "jobs.lora", "jobs.multi_lora",
                 "jobs.prefix_cache", "ops.paged_attention",
                 "ops.flash_attention", "obs", "obs.registry", "obs.events",
                 "obs.trace", "core", "core.metrics", "api", "api.utils",
                 "wire", "wire.httpcommon", "wire.faults", "router",
                 "router.migration", "router.replica", "router.adapters",
                 "router.hashring", "router.pool", "router.server",
                 "router.autoscaler", "obs.slo", "obs.profile",
                 "obs.exporter", "jobs.quant", "jobs.sampling", "entry",
                 "jobs.native_data", "jobs.tokenizer", "jobs.checkpoint",
                 "jobs.hf_import", "jobs.distill"):
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
    """Every source of the port and ``chip_smoke.py``, indented (lazy)
    imports included."""
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+kubetpu(\.|\s|$)|"
        r"from\s+kubetpu(\.|\s))", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG_DIR):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            src = f.read()
        hit = pattern.search(src)
        assert hit is None, f"{path}: {hit.group(0)!r}"
    assert len(paths) >= 20
    assert any("router" in p and p.endswith("replica.py") for p in paths)


# what the card machine does not have: the lifecycle modules (tokenizer,
# importer, checkpoint) must not reach for it
FOREIGN = ("jax", "kubetpu", "transformers", "safetensors", "orbax", "regex")


def test_lifecycle_modules_load_nothing_foreign_in_a_fresh_interpreter():
    """The text, checkpoint, importer and distillation modules, imported
    and exercised in a fresh interpreter (the BPE fixture loaded and
    encoded through the stdlib ``re``, a checkpoint written and restored,
    a namespace config imported, one distill step), leave jax, kubetpu,
    transformers, safetensors, orbax and regex out of sys.modules."""
    fixture = os.path.join(REPO, "tests", "fixtures", "tiny_tokenizer.json")
    code = (
        "import os, sys, tempfile, types, torch\n"
        "torch.set_num_threads(1)\n"
        "from kubetpu_torch.jobs import (checkpoint, data, distill, "
        "hf_import, native_data, tokenizer, train)\n"
        "from kubetpu_torch.jobs.model import ModelConfig\n"
        f"tok = tokenizer.load_hf_tokenizer({fixture!r})\n"
        "assert tok.decode(tok.encode('Héllo 123 wörld')) == "
        "'Héllo 123 wörld'\n"
        "cfg = ModelConfig(vocab=32, d_model=16, n_layers=1, n_heads=2, "
        "d_ff=32)\n"
        "st, opt = train.init_state(torch.Generator().manual_seed(0), cfg, "
        "device='cpu')\n"
        "d = tempfile.mkdtemp()\n"
        "checkpoint.save_checkpoint(d + '/1', st)\n"
        "checkpoint.restore_checkpoint(d + '/1', st)\n"
        "ns = types.SimpleNamespace(vocab_size=32, hidden_size=16, "
        "num_hidden_layers=1, num_attention_heads=2, intermediate_size=32, "
        "max_position_embeddings=64)\n"
        "assert hf_import.config_from_hf(ns).d_model == 16\n"
        "step, _ = distill.make_distill_step(cfg, cfg, device='cpu')\n"
        "import numpy as np\n"
        "x = np.zeros((1, 8), np.int64)\n"
        "step(distill.init_draft_state(torch.Generator().manual_seed(1), "
        "cfg, opt, device='cpu'), st.params, x, x)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FOREIGN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_nothing_the_card_lacks():
    """No source of the port, nor ``chip_smoke.py``, imports
    transformers, safetensors, orbax or regex (lazy imports included)."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(transformers|safetensors|orbax|regex)\b",
        re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG_DIR):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            hit = pattern.search(f.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


# the router side holds no model: these files import no torch of their own
# (the replica's codec and the adapter registry do, for bf16)
TORCH_FREE = ("router/hashring.py", "router/pool.py", "router/server.py",
              "router/autoscaler.py", "obs/slo.py", "obs/profile.py",
              "obs/exporter.py", "obs/registry.py", "obs/events.py",
              "obs/trace.py", "wire/httpcommon.py", "wire/faults.py")


def test_router_and_obs_sources_import_no_torch():
    """No import of torch (lazy ones included) in the router's and obs's
    model-free files."""
    pattern = re.compile(r"^\s*(import\s+torch\b|from\s+torch\b)", re.M)
    for rel in TORCH_FREE:
        with open(os.path.join(PKG_DIR, rel)) as f:
            hit = pattern.search(f.read())
        assert hit is None, f"{rel}: {hit.group(0)!r}"


def test_port_replica_serves_with_neither_jax_nor_kubetpu_loaded():
    """A port ReplicaServer in a fresh interpreter serves a generate over
    HTTP, directly and behind the port's RouterServer, migrates a stream
    to a second replica, and leaves jax and kubetpu out of sys.modules."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from kubetpu_torch.jobs.model import ModelConfig, init_params\n"
        "from kubetpu_torch.jobs.paged import PagedDecodeServer\n"
        "from kubetpu_torch.router import ReplicaServer\n"
        "from kubetpu_torch.wire.httpcommon import request_json\n"
        "cfg = ModelConfig(vocab=32, d_model=16, n_layers=1, n_heads=2, "
        "d_ff=32)\n"
        "m = init_params(torch.Generator().manual_seed(0), cfg, "
        "device='cpu')\n"
        "from kubetpu_torch.router import RouterServer\n"
        "reps = [ReplicaServer(PagedDecodeServer(cfg, m, n_slots=2, "
        "max_seq=32, max_new_tokens=4, page_size=4, device='cpu'), "
        "f'r{i}') for i in range(2)]\n"
        "urls = [r.start() for r in reps]\n"
        "body = request_json(urls[0] + '/generate', "
        "{'prompt': [1, 2, 3, 4, 5]}, timeout=60)\n"
        "assert len(body['emitted']) == 4, body\n"
        "router = RouterServer()\n"
        "rurl = router.start()\n"
        "for u in urls: router.register_replica(u)\n"
        "body = request_json(rurl + '/generate', "
        "{'prompt': [1, 2, 3, 4, 5]}, timeout=60)\n"
        "assert len(body['emitted']) == 4 and body['replica'], body\n"
        "router.shutdown()\n"
        "with reps[0]._cv:\n"
        "    rid = reps[0].server.enqueue([3, 1, 2])\n"
        "    while not reps[0].server.migratable_rids():\n"
        "        reps[0].server.step()\n"
        "    assert reps[0].migrate_rid(rid, urls[1])\n"
        "for r in reps: r.shutdown(graceful=False)\n"
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


def test_entry_points_default_to_the_card_and_raise_without_it():
    """No device and no CUDA: model construction, the servers (plain,
    dense, speculative and multi-LoRA), the caches, the train and LoRA
    entry points and the flash wrappers raise, never continue silently on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    from kubetpu_torch.jobs.model import ModelConfig, init_params
    from kubetpu_torch.jobs.paged import PagedDecodeServer, init_page_pool
    from kubetpu_torch.jobs.decode import init_kv_cache
    from kubetpu_torch.jobs.serving import DecodeServer, SlotServerBase
    from kubetpu_torch.jobs.spec_serving import (
        PagedSpeculativeDecodeServer, SpeculativeDecodeServer)
    from kubetpu_torch.jobs.convert import lora_from_numpy, lora_to_numpy
    from kubetpu_torch.jobs.lora import (LoraConfig, init_lora_params,
                                         init_lora_state,
                                         make_lora_train_step)
    from kubetpu_torch.jobs.multi_lora import (MultiLoraDecodeServer,
                                               PagedMultiLoraDecodeServer,
                                               SpecMultiLoraDecodeServer,
                                               stack_adapters)
    from kubetpu_torch.jobs.train import (init_state, make_eval_step,
                                          make_train_step)
    from kubetpu_torch.ops import flash_attention as fa

    from kubetpu_torch.entry import entry
    from kubetpu_torch.jobs.decode import init_ring_cache
    from kubetpu_torch.jobs.quant import quantize_params

    cfg = ModelConfig(vocab=32, d_model=16, n_layers=1, n_heads=2, d_ff=32)
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedDecodeServer(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedDecodeServer(cfg, quantize_params(model))
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_ring_cache(ModelConfig(window=4), 1)
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
        DecodeServer(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpeculativeDecodeServer(cfg, cfg, model, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedSpeculativeDecodeServer(cfg, cfg, model, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_kv_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(cfg)
    # LoRA and the multi-LoRA servers
    lcfg = LoraConfig(rank=2)
    adapter = init_lora_params(torch.Generator().manual_seed(1), cfg, lcfg,
                               device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lora_params(torch.Generator().manual_seed(1), cfg, lcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lora_state(torch.Generator().manual_seed(1), cfg, lcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_lora_train_step(cfg, lcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedMultiLoraDecodeServer(cfg, model, lcfg, [adapter])
    with pytest.raises(RuntimeError, match="CUDA"):
        SpecMultiLoraDecodeServer(cfg, cfg, model, model, lcfg, [adapter])
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiLoraDecodeServer(cfg, model, lcfg,
                              stack_adapters(lcfg, [adapter]))
    with pytest.raises(RuntimeError, match="CUDA"):
        lora_from_numpy(lora_to_numpy(adapter))
    # the lifecycle entry points: the importer and distillation
    import types

    from kubetpu_torch.jobs import distill, hf_import

    with pytest.raises(RuntimeError, match="CUDA"):
        hf_import.params_from_hf({}, cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        hf_import.params_from_hf(types.SimpleNamespace(
            config=types.SimpleNamespace(
                vocab_size=32, hidden_size=16, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=32,
                max_position_embeddings=64),
            state_dict=dict))
    with pytest.raises(RuntimeError, match="CUDA"):
        distill.make_distill_step(cfg, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        distill.init_draft_state(torch.Generator().manual_seed(0), cfg,
                                 distill.make_optimizer())
    # the flash wrappers follow their tensors: the plain version on the
    # CPU, the kernel on the card, and anything else raises
    meta = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_forward(meta, meta, meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(meta, meta, meta)
