"""The port's multi-LoRA servers against the JAX package's on
``trained_small`` (split from ``test_torch_multi_lora.py`` to keep each file
short): greedy tokens of ``MultiLoraDecodeServer``, of
``PagedMultiLoraDecodeServer`` over the matrix {monolithic, chunked} x
{f32, int8} and of ``SpecMultiLoraDecodeServer`` equal the JAX servers'
with the same adapters carried across (``lora_from_numpy``), and each
tenant's merged single-tenant decode. The JAX servers run their gather
core, and in the chunked f32 case their Pallas paged kernel in interpret
mode."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs import init_params as jax_init_params
from kubetpu.jobs import lora as jlora
from kubetpu.jobs import multi_lora as jml
from kubetpu_torch.jobs.convert import lora_from_numpy, params_from_numpy
from kubetpu_torch.jobs.lora import merge_lora
from kubetpu_torch.jobs.multi_lora import (MultiLoraDecodeServer,
                                           SpecMultiLoraDecodeServer,
                                           stack_adapters)
from kubetpu_torch.jobs.serving import DecodeServer
from test_torch_multi_lora import (JLCFG, LCFG, PS, merged_ref, paged_multi,
                                   port_cfg)

torch.set_num_threads(1)


def jax_adapter(seed, jcfg):
    """A JAX adapter with a real effect: B drawn N(0, 0.05)."""
    lora = jlora.init_lora_params(jax.random.PRNGKey(seed), jcfg, JLCFG)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), 4)
    for i, t in enumerate(JLCFG.targets):
        b = lora["blocks"][f"{t}_b"]
        lora["blocks"][f"{t}_b"] = (
            jax.random.normal(keys[i], b.shape, b.dtype) * 0.05)
    return lora


def both(jparams, jadapters, cfg):
    """The base and adapters in the port's form, on the CPU."""
    base = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    ads = [lora_from_numpy(jax.tree.map(np.asarray, a), device="cpu")
           for a in jadapters]
    return base, ads


@pytest.fixture(scope="module")
def trained(trained_small):
    """``trained_small`` with three adapters and a seed-7 draft, in both
    packages."""
    jcfg, jparams, _data = trained_small
    jads = [jax_adapter(s, jcfg) for s in (1, 2, 3)]
    cfg = port_cfg(jcfg)
    base, ads = both(jparams, jads, cfg)
    jdcfg = dataclasses.replace(jcfg, d_model=32, n_layers=1, n_heads=2,
                                d_ff=64)
    jdraft = jax_init_params(jax.random.PRNGKey(7), jdcfg)
    dcfg = port_cfg(jdcfg)
    draft = params_from_numpy(jax.tree.map(np.asarray, jdraft), dcfg,
                              device="cpu")
    return {"jax": (jcfg, jparams, jads, jdcfg, jdraft),
            "cfg": cfg, "base": base, "ads": ads, "dcfg": dcfg,
            "draft": draft}


def staggered(server, prompts, picks, submit=True):
    """Two requests admitted at once, a third after a step: (results in
    order), the server drained."""
    put = server.submit if submit else server.enqueue
    rids = [put(p, adapter=a) for p, a in zip(prompts[:2], picks[:2])]
    server.step()
    rids.append(put(prompts[2], adapter=picks[2]))
    assert None not in rids
    server.drain()
    return [server.result(r) for r in rids]


TRAINED_PROMPTS = [[5, 6, 7, 9, 11], list(range(1, 2 * PS + 2)), [9, 10]]
TRAINED_PICKS = [0, 2, 1]


def test_dense_server_equals_the_jax_server(trained):
    jcfg, jparams, jads, _, _ = trained["jax"]
    kw = dict(n_slots=3, max_seq=64, max_new_tokens=8)
    want = staggered(jml.MultiLoraDecodeServer(
        jcfg, jparams, JLCFG, jml.stack_adapters(JLCFG, jads), **kw),
        TRAINED_PROMPTS, TRAINED_PICKS)
    server = MultiLoraDecodeServer(trained["cfg"], trained["base"], LCFG,
                                   stack_adapters(LCFG, trained["ads"]),
                                   device="cpu", **kw)
    assert staggered(server, TRAINED_PROMPTS, TRAINED_PICKS) == want
    # the same prompt under two adapters, through the queue and one slot
    one = MultiLoraDecodeServer(trained["cfg"], trained["base"], LCFG,
                                stack_adapters(LCFG, trained["ads"]),
                                n_slots=1, max_seq=64, max_new_tokens=6,
                                device="cpu")
    r0 = one.enqueue([5, 6, 7], adapter=0)
    r1 = one.enqueue([5, 6, 7], adapter=1)
    one.drain()
    refs = []
    for a in (0, 1):
        s = DecodeServer(trained["cfg"], merge_lora(trained["base"],
                                                    trained["ads"][a], LCFG),
                         n_slots=1, max_seq=64, max_new_tokens=6,
                         device="cpu")
        r = s.submit([5, 6, 7])
        s.drain()
        refs.append(s.result(r))
    assert [one.result(r0), one.result(r1)] == refs
    assert refs[0] != refs[1]        # the adapters steer the output
    assert one._rid_adapter == {0: 0, 1: 1}


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("chunked", [False, True], ids=["mono", "chunked"])
def test_paged_matrix_equals_the_jax_server(trained, chunked, kv_int8):
    """{monolithic, chunked} x {f32, int8}: a packed mixed-tenant batch
    gives the JAX server's greedy tokens, which equal each tenant's merged
    single-tenant decode. The chunked f32 case runs the JAX server on its
    Pallas paged kernel in interpret mode, the others on its gather
    core."""
    jcfg, jparams, jads, _, _ = trained["jax"]
    kw = dict(n_slots=3, max_seq=64, max_new_tokens=8, page_size=PS,
              kv_int8=kv_int8, prefill_budget=PS if chunked else 0)
    kernel = (dict(use_kernel=True, interpret=True)
              if chunked and not kv_int8 else {})
    want = staggered(jml.PagedMultiLoraDecodeServer(jcfg, jparams, JLCFG,
                                                    jads, **kw, **kernel),
                     TRAINED_PROMPTS, TRAINED_PICKS, submit=False)
    server = paged_multi(trained["base"], trained["ads"], trained["cfg"],
                         **kw)
    got = staggered(server, TRAINED_PROMPTS, TRAINED_PICKS, submit=False)
    assert got == want
    server.check_invariants()
    for out, prompt, a in zip(got, TRAINED_PROMPTS, TRAINED_PICKS):
        assert out == merged_ref(trained["base"], trained["ads"][a], prompt,
                                 trained["cfg"], **{
                                     k: v for k, v in kw.items()
                                     if k != "n_slots"})


def test_spec_equals_the_jax_server_and_the_packed_one(trained):
    """The draft runs without adapters, the verify chunk applies each
    slot's: the JAX server's tokens, and the packed server's."""
    jcfg, jparams, jads, jdcfg, jdraft = trained["jax"]
    kw = dict(n_slots=3, max_seq=64, max_new_tokens=8, page_size=PS,
              gamma_max=2)
    want = staggered(jml.SpecMultiLoraDecodeServer(
        jcfg, jdcfg, jparams, jdraft, JLCFG, jads, **kw),
        TRAINED_PROMPTS, TRAINED_PICKS)
    server = SpecMultiLoraDecodeServer(
        trained["cfg"], trained["dcfg"], trained["base"], trained["draft"],
        LCFG, trained["ads"], device="cpu", **kw)
    got = staggered(server, TRAINED_PROMPTS, TRAINED_PICKS)
    assert got == want
    server.check_invariants()
    kw.pop("gamma_max")
    assert got == staggered(paged_multi(trained["base"], trained["ads"],
                                        trained["cfg"], **kw),
                            TRAINED_PROMPTS, TRAINED_PICKS)
