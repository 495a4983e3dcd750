"""The port's twins of the serving examples (``examples/quickstart_torch.py``,
``examples/serve_quantized_torch.py``, ``examples/serve_zoo_torch.py``)
against the JAX examples on the CPU, on the same inputs and bridged
parameters.

quickstart: the fp-vs-int8 logits rel-err within 2e-3 of the JAX
example's (the w8a8 logits' limit of ``tests/test_torch_example.py``) and
the greedy tokens equal.  serve_quantized and serve_zoo: every finished
request's tokens equal to the JAX ``Scheduler``'s on the example's own
trace, for each default arch.  ``--mesh 2`` raises (mesh serving is ROADMAP
queue 1, item 13).
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.quantize_params import quantize_model_params as jax_qparams
from repro.models.transformer import apply_model as jax_apply_model
from repro.models.transformer import init_model as jax_init_model
from repro.serving.cache import CacheConfig as JaxCacheConfig
from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.engine import greedy_decode as jax_greedy_decode
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from test_torch_bridge import numpy_tree

ROOT = Path(__file__).resolve().parent.parent


def _example(name):
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drive_jax(sched, trace):
    """The JAX examples' loop: arrivals by tick, step until drained."""
    tick, pending = 0, sorted(trace, key=lambda r: r[0])
    while pending or sched.queue or sched.n_active:
        while pending and pending[0][0] <= tick:
            _, prompt, budget = pending.pop(0)
            sched.submit(prompt, budget)
        sched.step()
        tick += 1
    return sched.finished


def _same_finished(port, jax_finished):
    assert port.keys() == jax_finished.keys()
    for rid, toks in jax_finished.items():
        np.testing.assert_array_equal(port[rid], np.asarray(toks),
                                      err_msg=f"request {rid}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quickstart_twin_matches_the_jax_example(dtype):
    """At the example's own bf16 config the greedy tokens are equal (XLA
    and PyTorch round bf16 in other places, so the rel-errs agree only to
    bf16's noise); in f32 the rel-err is within the w8a8 logits' limit
    too."""
    cfg = jax_smoke_config("qwen2_5_3b").replace(dtype=dtype)
    params = jax_init_model(jax.random.PRNGKey(0), cfg)
    qparams = jax_qparams(params)
    qcfg = cfg.replace(quant_proj="w8a8")
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                cfg.vocab_size)
    fp_logits, _, _ = jax_apply_model(params, tokens, cfg)
    q_logits, _, _ = jax_apply_model(qparams, tokens, qcfg)
    rel_jax = float(np.linalg.norm(np.asarray(q_logits - fp_logits,
                                              np.float32))
                    / np.linalg.norm(np.asarray(fp_logits, np.float32)))
    cache = jax_init_cache(qcfg, batch=2, max_len=32)
    out_jax, _ = jax_greedy_decode(qparams, cache, tokens[:, :1], 0, 8, qcfg)

    tcfg = get_smoke_config("qwen2_5_3b").replace(dtype=dtype)
    model = params_from_numpy(numpy_tree(params), tcfg, device="cpu")
    got = _example("quickstart").main(
        ["--device", "cpu"], model=model,
        tokens=torch.from_numpy(np.array(tokens)).long(), cfg=tcfg)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(out_jax))
    assert 0 < got["rel"] < 0.05 and 0 < rel_jax < 0.05    # near-lossless
    if dtype == "float32":
        assert abs(got["rel"] - rel_jax) <= 2e-3


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serve_quantized_twin_matches_the_jax_scheduler(dtype):
    """The example's trace through the JAX Scheduler and the twin, same
    w8a8 weights.  In f32 (where the two packages' logits agree within
    2e-3, ``tests/test_torch_model.py``) every finished request's tokens are
    equal; at the example's own bf16 config XLA and PyTorch round bf16 in
    other places and the greedy tokens of this random model part at near
    ties, so there the twin must serve every request its budget, share the
    prefixed prompts' pages and peak as the JAX run does."""
    mod = _example("serve_quantized")
    args = mod.parser().parse_args([])
    jcfg = jax_smoke_config(args.arch).replace(quant_proj="w8a8",
                                               dtype=dtype)
    params = jax_qparams(jax_init_model(jax.random.PRNGKey(0),
                                        jcfg.replace(quant_proj="none")))
    trace = mod.make_trace(args, jcfg.vocab_size)
    jax_sched = JaxScheduler(
        params, jcfg, slots=args.slots, max_len=args.max_len, bucket=8,
        config=JaxCacheConfig(layout="paged", alloc="dynamic",
                              page_size=args.page_size))
    jax_finished = _drive_jax(jax_sched, trace)

    tcfg = get_smoke_config(args.arch).replace(quant_proj="w8a8",
                                               dtype=dtype)
    model = params_from_numpy(numpy_tree(params), tcfg, device="cpu")
    sched = mod.main(["--device", "cpu"], model=model, cfg=tcfg)
    assert len(sched.finished) == args.requests
    if dtype == "float32":
        _same_finished(sched.finished, jax_finished)
    else:
        assert sched.finished.keys() == jax_finished.keys()
        for rid, toks in jax_finished.items():
            assert len(sched.finished[rid]) == len(toks)
        assert max(sched.occupancy_log) == max(jax_sched.occupancy_log)


def test_serve_quantized_twin_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="item 13"):
        _example("serve_quantized").main(["--device", "cpu", "--mesh", "2"])


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "mamba2_370m",
                                  "granite_moe_3b_a800m"])
def test_serve_zoo_twin_matches_the_jax_scheduler(arch):
    mod = _example("serve_zoo")
    assert arch in mod.ZOO
    jcfg = jax_smoke_config(arch).replace(quant_proj="none",
                                          dtype="float32")
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    trace = mod.make_trace(5, 8, jcfg.vocab_size)
    jax_finished = _drive_jax(JaxScheduler(params, jcfg, slots=3,
                                           max_len=64, bucket=8), trace)

    model = params_from_numpy(numpy_tree(params), mod.smoke_cfg(arch),
                              device="cpu")
    scheds = mod.main(["--device", "cpu", "--archs", arch],
                      models={arch: model})
    _same_finished(scheds[arch].finished, jax_finished)
    assert len(scheds[arch].finished) == 5
