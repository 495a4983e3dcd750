"""Port's SSM (mamba2) and hybrid (zamba2) families vs the JAX package, f32,
smoke configs, on weights initialised by the JAX package and carried over
through numpy: the Mamba2 block's pieces (``_segsum``, both convs,
``ssd_chunked``, ``ssm_step``) and its three modes, the whole model, the
dense-slot cache, prefill (one pass and chunked) and greedy decode, the
state handlers and the Scheduler.  Mirrors the SSM cases of
``tests/test_serving.py``, ``tests/test_state_registry.py``,
``tests/test_spec_decode.py`` and ``tests/test_kv_quant.py``.

Tolerances: rel-err (max |port - jax| / max |jax|) 1e-5 in f32 wherever
no int8 rounding sits between the two (``none``, ``w8``; the frameworks'
cumsums, matmuls and reductions differ in the last bits); the model under
``w8a8`` at ``test_torch_model.TOL``; tokens and handler state exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import ssm as jax_ssm
from repro.models.transformer import apply_model as jax_apply_model
from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.engine import greedy_decode as jax_greedy_decode
from repro.serving.engine import prefill as jax_prefill
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.core.quantize_params import quantize_model_params
from repro_torch.models import ssm
from repro_torch.models.transformer import (Model, SSMBlock, apply_model,
                                            init_model)
from repro_torch.serving.cache import (CacheConfig, init_cache,
                                       n_shared_sites)
from repro_torch.serving.engine import (cache_capacity, greedy_decode,
                                        prefill, prefill_step, serve_step,
                                        validate_decode_cache)
from repro_torch.serving.scheduler import Scheduler, SpecConfig
from repro_torch.serving.state import (SLOT_STATE_KEYS, HybridHandler,
                                       PagedKVHandler, SlotStateHandler,
                                       default_serving_config, state_handler)
from test_torch_bridge import numpy_tree, paired_models, rel_err
from test_torch_model import TOL
from test_torch_moe import _cross_family_trace, _drive

SSM_ARCHS = ["mamba2_370m", "zamba2_7b"]
SSM_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def ssm_models(arch, **overrides):
    """``paired_models`` (f32 unless overridden), cached: callers must not
    change what they are given."""
    overrides.setdefault("dtype", "float32")
    return paired_models(arch, **overrides)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(shape, seed, scale=1.0):
    return (_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _mamba_pair(arch, mode="none", i=0):
    jcfg, params, tcfg, model = ssm_models(arch, quant_proj=mode)
    jp = jax.tree.map(lambda a: a[i], params["layers"]["mamba"])
    return jcfg, jp, tcfg, model.layers[i].mamba


# ---------------------------------------------------------------------------
# the Mamba2 block's pieces
# ---------------------------------------------------------------------------
def test_segsum_matches_jax():
    a = _normal((2, 3, 16), 0)
    got = ssm._segsum(_t(a)).numpy()
    want = np.asarray(jax_ssm._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert rel_err(got[fin], want[fin]) <= SSM_TOL


@pytest.mark.parametrize("decode", [False, True])
def test_causal_conv_matches_jax(decode):
    x = _normal((2, 1 if decode else 9, 12), 1)
    w = _normal((4, 12), 2)
    st = _normal((2, 3, 12), 3) if decode else None
    y, tail = ssm._causal_conv(_t(x), _t(w), None if st is None else _t(st))
    yj, tj = jax_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if st is None else jnp.asarray(st))
    assert rel_err(y.numpy(), yj) <= SSM_TOL
    if decode:
        assert tail.dtype == torch.float32
        np.testing.assert_array_equal(tail.numpy(), np.asarray(tj))
    else:
        assert tail is None and tj is None


def test_conv_prefill_matches_jax():
    """Tails at each row's own n_valid, n_valid = 0 keeping the tail."""
    x = _normal((3, 10, 12), 4)
    w = _normal((4, 12), 5)
    prev = _normal((3, 3, 12), 6)
    nv = np.array([10, 4, 0], np.int32)
    y, tail = ssm._conv_prefill(_t(x), _t(w), _t(prev), _t(nv))
    yj, tj = jax_ssm._conv_prefill(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(prev), jnp.asarray(nv))
    assert rel_err(y.numpy(), yj) <= SSM_TOL
    np.testing.assert_array_equal(tail.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(tail[2].numpy(), prev[2])


def _ssd_inputs(b, l, h, p, n, seed):
    x = _normal((b, l, h, p), seed)
    dt = np.log1p(np.exp(_normal((b, l, h), seed + 1)))       # softplus
    a_dt = -dt * np.linspace(1.0, 16.0, h, dtype=np.float32)
    return (x, a_dt.astype(np.float32), _normal((b, l, n), seed + 2),
            _normal((b, l, n), seed + 3))


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_jax(chunk, init):
    b, l, h, p, n = 2, 32, 3, 4, 5
    args = _ssd_inputs(b, l, h, p, n, 7)
    h0 = _normal((b, h, p, n), 11) if init else None
    y, final = ssm.ssd_chunked(*map(_t, args), chunk,
                               None if h0 is None else _t(h0))
    yj, fj = jax_ssm.ssd_chunked(*map(jnp.asarray, args), chunk,
                                 None if h0 is None else jnp.asarray(h0))
    assert y.shape == (b, l, h, p) and final.dtype == torch.float32
    assert rel_err(y.numpy(), yj) <= SSM_TOL
    assert rel_err(final.numpy(), fj) <= SSM_TOL


def test_ssd_chunked_refuses_ragged_length():
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssd_chunked(*map(_t, _ssd_inputs(1, 10, 2, 2, 2, 0)), 4)


def test_ssd_chunked_equals_stepwise():
    """The chunked scan's outputs and final state are the token-by-token
    recurrence's (``ssm_step``), the ground truth of decode."""
    b, l, h, p, n = 2, 24, 3, 4, 5
    x, a_dt, bm, cm = map(_t, _ssd_inputs(b, l, h, p, n, 13))
    h0 = _t(_normal((b, h, p, n), 17))
    y, final = ssm.ssd_chunked(x, a_dt, bm, cm, 8, h0)
    state, ys = h0, []
    for t in range(l):
        state, yt = ssm.ssm_step(state, x[:, t], torch.exp(a_dt[:, t]),
                                 bm[:, t], cm[:, t])
        ys.append(yt)
    assert rel_err(y.numpy(), torch.stack(ys, 1).numpy()) <= SSM_TOL
    assert rel_err(final.numpy(), state.numpy()) <= SSM_TOL


def test_ssm_step_matches_jax():
    b, h, p, n = 3, 4, 5, 6
    h0, x, da = (_normal((b, h, p, n), 1), _normal((b, h, p), 2),
                 np.exp(-np.abs(_normal((b, h), 3))))
    br, cr = _normal((b, n), 4), _normal((b, n), 5)
    hn, y = ssm.ssm_step(*map(_t, (h0, x, da, br, cr)))
    hj, yj = jax_ssm.ssm_step(*map(jnp.asarray, (h0, x, da, br, cr)))
    assert rel_err(hn.numpy(), hj) <= SSM_TOL
    assert rel_err(y.numpy(), yj) <= SSM_TOL


# ---------------------------------------------------------------------------
# apply_mamba2 in its three modes
# ---------------------------------------------------------------------------
def _state(cfg, b, seed):
    k = cfg.ssm_conv - 1
    return {"h": _normal((b, cfg.ssm_n_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), seed, 0.3),
            "conv_x": _normal((b, k, cfg.d_inner), seed + 1),
            "conv_B": _normal((b, k, cfg.ssm_state), seed + 2),
            "conv_C": _normal((b, k, cfg.ssm_state), seed + 3)}


def _state_err(new, jnew):
    return max(rel_err(new[k].numpy(), jnew[k]) for k in new)


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("mode", ["none", "w8"])
@pytest.mark.parametrize("l", [8, 32])
def test_apply_mamba2_cacheless_matches_jax(arch, mode, l):
    jcfg, jp, tcfg, block = _mamba_pair(arch, mode)
    x = _normal((2, l, tcfg.d_model), 20)
    y, st = ssm.apply_mamba2(block, _t(x), tcfg)
    yj, stj = jax_ssm.apply_mamba2(jp, jnp.asarray(x), jcfg)
    assert st is None and stj is None and y.shape == x.shape
    assert rel_err(y.numpy(), yj) <= TOL[mode]


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("mode", ["none", "w8"])
def test_apply_mamba2_decode_matches_jax(arch, mode):
    jcfg, jp, tcfg, block = _mamba_pair(arch, mode, i=1)
    x = _normal((3, 1, tcfg.d_model), 21)
    state = _state(tcfg, 3, 30)
    y, new = ssm.apply_mamba2(block, _t(x), tcfg,
                              state={k: _t(v) for k, v in state.items()})
    yj, jnew = jax_ssm.apply_mamba2(
        jp, jnp.asarray(x), jcfg,
        state={k: jnp.asarray(v) for k, v in state.items()})
    assert rel_err(y.numpy(), yj) <= TOL[mode]
    assert _state_err(new, jnew) <= SSM_TOL
    assert all(v.dtype == torch.float32 for v in new.values())


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("mode", ["none", "w8"])
@pytest.mark.parametrize("n_valid", [None, (13, 5, 0)])
def test_apply_mamba2_prefill_commit_matches_jax(arch, mode, n_valid):
    """L = 13 is no multiple of the chunk (16): padded to it; rows commit
    13, 5 and 0 tokens."""
    jcfg, jp, tcfg, block = _mamba_pair(arch, mode, i=2)
    x = _normal((3, 13, tcfg.d_model), 22)
    state = _state(tcfg, 3, 40)
    nv = None if n_valid is None else np.array(n_valid, np.int32)
    y, new = ssm.apply_mamba2(block, _t(x), tcfg,
                              state={k: _t(v) for k, v in state.items()},
                              n_valid=None if nv is None else _t(nv))
    yj, jnew = jax_ssm.apply_mamba2(
        jp, jnp.asarray(x), jcfg,
        state={k: jnp.asarray(v) for k, v in state.items()},
        n_valid=None if nv is None else jnp.asarray(nv))
    assert rel_err(y.numpy(), yj) <= TOL[mode]
    assert _state_err(new, jnew) <= SSM_TOL
    if nv is not None:                    # a row committing 0 tokens
        for k, name in (("h", "h"), ("conv_x", "conv_x")):
            np.testing.assert_array_equal(new[name][2].numpy(), state[k][2])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
def test_apply_model_matches_jax(arch, mode):
    jcfg, params, tcfg, model = ssm_models(arch, quant_proj=mode)
    toks = _rng(12).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    logits, cache, aux = apply_model(model, _t(toks), tcfg)
    ref, _, _ = jax_apply_model(params, jnp.asarray(toks), jcfg)
    assert cache is None and logits.shape == (2, 32, jcfg.vocab_size)
    assert rel_err(logits.numpy(), ref) <= TOL[mode]
    assert float(aux["load_balance_loss"]) == 0.0


def test_prefill_step_through_flash_matches_jax():
    """zamba2's shared block at S >= blockwise_attn_threshold (64 at smoke
    size) attends through ``flash_attention`` (K5's plain version here)."""
    jcfg, params, tcfg, model = ssm_models("zamba2_7b", quant_proj="none")
    toks = _rng(13).integers(0, jcfg.vocab_size, (1, 96)).astype(np.int32)
    logits, _ = prefill_step(model, _t(toks), tcfg)
    ref, _, _ = jax_apply_model(params, jnp.asarray(toks), jcfg)
    assert rel_err(logits.numpy(), ref) <= SSM_TOL


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_bridge_copies_every_leaf(arch, quant):
    _, params, tcfg, model = ssm_models(arch, quant_proj=quant)
    tree = numpy_tree(params)
    layers = tree["layers"]
    for i, layer in enumerate(model.layers):
        assert isinstance(layer, SSMBlock)
        m, jm = layer.mamba, layers["mamba"]
        np.testing.assert_array_equal(layer.norm.w.numpy(),
                                      layers["norm"]["w"][i])
        for name in ssm.IN_PROJ + ("out_proj",):
            lin, node = getattr(m, name), jm[name]
            if quant == "none":
                np.testing.assert_array_equal(lin.w.numpy(), node["w"][i])
            else:
                assert lin.w is None
                np.testing.assert_array_equal(lin.w_q.values.numpy(),
                                              node["w_q"]["values"][i])
                np.testing.assert_array_equal(lin.w_q.scale.numpy(),
                                              node["w_q"]["scale"][i])
        for name in ("conv_x", "conv_B", "conv_C"):
            np.testing.assert_array_equal(getattr(m, name).w.numpy(),
                                          jm[name]["w"][i])
        for name in ("A_log", "D", "dt_bias"):
            np.testing.assert_array_equal(getattr(m.ssm, name).numpy(),
                                          jm["ssm"][name][i])
        np.testing.assert_array_equal(m.norm.w.numpy(), jm["norm"]["w"][i])
    if arch == "zamba2_7b":
        sa, block = tree["shared_attn"], model.shared_attn
        for lin, node in ((block.attn.wq, sa["attn"]["wq"]),
                          (block.ffn.down, sa["ffn"]["down"])):
            if quant == "none":
                np.testing.assert_array_equal(lin.w.numpy(), node["w"])
            else:
                np.testing.assert_array_equal(lin.w_q.values.numpy(),
                                              node["w_q"]["values"])
                np.testing.assert_array_equal(lin.w_q.scale.numpy(),
                                              node["w_q"]["scale"])
        np.testing.assert_array_equal(block.norm_ffn.w.numpy(),
                                      sa["norm_ffn"]["w"])
    else:
        assert model.shared_attn is None


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_quantize_model_params_reaches_mamba_and_shared_block(arch):
    """The walk quantizes the five in-projections, out_proj and the shared
    block's projections, leaves convs, SSM parameters and norms in f32,
    and quantizing block by block as drawn gives the same model."""
    cfg = get_smoke_config(arch)
    master = init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    whole = quantize_model_params(master)
    for layer in whole.layers:
        for name in ssm.IN_PROJ + ("out_proj",):
            lin = getattr(layer.mamba, name)
            assert lin.w is None and lin.w_q.values.dtype == torch.int8
            assert lin.w_q.values.t().is_contiguous()          # K-major
        assert layer.mamba.conv_x.w.dtype == torch.float32
        assert layer.mamba.ssm.A_log.dtype == torch.float32
    if arch == "zamba2_7b":
        sa = whole.shared_attn
        assert sa.attn.wq.w is None and sa.ffn.down.w_q is not None
    assert master.layers[0].mamba.in_x.w is not None    # input untouched
    each = init_model(torch.Generator().manual_seed(3), cfg, device="cpu",
                      each_block=quantize_model_params)
    b1, b2 = dict(whole.named_buffers()), dict(each.named_buffers())
    assert b1.keys() == b2.keys()
    for name in b1:
        assert torch.equal(b1[name], b2[name]), name


# ---------------------------------------------------------------------------
# the dense-slot cache and the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_state_stays_f32(arch):
    """The KV dtype applies to the shared block's KV only: ``ssm_h`` and
    the conv tails accumulate across steps and stay f32."""
    cfg = get_smoke_config(arch)
    for dtype in (torch.bfloat16, torch.float32):
        cache = init_cache(cfg, 2, 16, dtype, device="cpu")
        for key in SLOT_STATE_KEYS:
            assert cache[key].dtype == torch.float32, (key, dtype)
        if "shared_k" in cache:
            assert cache["shared_k"].dtype == dtype


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_cache_matches_jax_layout(arch):
    tcfg = get_smoke_config(arch)
    jcfg = jax_configs.get_smoke_config(arch)
    cache = init_cache(tcfg, 3, 20, torch.float32, device="cpu")
    jcache = jax_init_cache(jcfg, 3, max_len=20, dtype=jnp.float32)
    assert cache.keys() == jcache.keys()
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        assert not cache[key].any()
    sites = n_shared_sites(tcfg)
    assert sites == (2 if arch == "zamba2_7b" else 0)
    with pytest.raises(ValueError, match="paged"):
        init_cache(tcfg, 2, 16, device="cpu",
                   config=CacheConfig(layout="paged"))


def test_cache_capacity_and_family_check():
    hcfg = get_smoke_config("zamba2_7b").replace(quant_proj="none",
                                                 dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), hcfg, device="cpu")
    cache = init_cache(hcfg, 2, 8, torch.float32, device="cpu")
    assert "shared_k" in cache and "k" not in cache
    assert cache_capacity(cache) == 8
    toks = torch.from_numpy(_rng(0).integers(0, hcfg.vocab_size, (2, 12)))
    with pytest.raises(ValueError, match="capacity"):
        prefill(model, cache, toks, torch.tensor([12, 12]), hcfg)
    mcfg = get_smoke_config("mamba2_370m")
    assert cache_capacity(init_cache(mcfg, 2, 4, device="cpu")) is None
    qcfg = get_smoke_config("qwen2_5_3b")
    with pytest.raises(ValueError, match="family"):
        validate_decode_cache(cache, qcfg)
    with pytest.raises(ValueError, match="family"):
        validate_decode_cache(init_cache(qcfg, 2, 8, device="cpu"), hcfg)


def _padded_prompts(vocab, lens, width, seed=7):
    prompts = np.zeros((len(lens), width), np.int32)
    rng = _rng(seed)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(3, vocab, n)
    return prompts


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_matches_full_forward(arch):
    """Token-by-token ``serve_step`` (decode mode at every layer, the shared
    block over its dense KV) equals the cache-less forward, as
    ``tests/test_decode.py`` holds the reference."""
    cfg = get_smoke_config(arch).replace(quant_proj="none", dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(_rng(1).integers(0, cfg.vocab_size, (2, 12)))
    full, _, _ = apply_model(model, tokens, cfg)
    cache = init_cache(cfg, 2, 16, torch.float32, device="cpu")
    outs = []
    for t in range(12):
        lg, cache = serve_step(model, cache, tokens[:, t:t + 1], t, cfg)
        outs.append(lg)
    assert rel_err(torch.cat(outs, 1).numpy(), full.numpy()) < 5e-5
    assert cache["seq_lens"].tolist() == [12, 12]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_prefill_matches_stepwise(arch):
    """Padded prefill-commit (one pass and chunked) advances the state as
    feeding each prompt token by token does, and right-padding is
    invisible: mixed-length rows continue as isolated exact-width runs
    (tokens equal), as the JAX package's test of the same name holds."""
    cfg = get_smoke_config(arch).replace(quant_proj="none", dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    lens = [7, 13, 4]
    prompts = torch.from_numpy(_padded_prompts(cfg.vocab_size, lens, 16))
    refs = []
    for i, n in enumerate(lens):
        cache = init_cache(cfg, 1, 32, torch.float32, device="cpu")
        for t in range(n):
            lg, cache = serve_step(model, cache, prompts[i:i + 1, t:t + 1],
                                   torch.tensor([t]), cfg)
        toks = [int(torch.argmax(lg[0, -1]))]
        for _ in range(3):
            lg, cache = serve_step(model, cache, torch.tensor([[toks[-1]]]),
                                   None, cfg)
            toks.append(int(torch.argmax(lg[0, -1])))
        refs.append(toks)
    for chunk in (None, 8):
        cache = init_cache(cfg, 3, 32, torch.float32, device="cpu")
        nl, cache = prefill(model, cache, prompts, torch.tensor(lens), cfg,
                            chunk=chunk)
        assert cache["seq_lens"].tolist() == lens
        first = torch.argmax(nl, -1)[:, None]
        out, _ = greedy_decode(model, cache, first, None, 3, cfg)
        assert out.tolist() == refs, chunk


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("mode", ["none", "w8a8"])
@pytest.mark.parametrize("chunk", [None, 8])
def test_greedy_tokens_equal_jax_engine(arch, mode, chunk):
    """prefill (one pass or chunked, mixed prompt lengths) → greedy_decode
    on the dense cache: tokens equal the JAX engine's, first logits and
    the committed state within 1e-5 (``none``)."""
    jcfg, params, tcfg, model = ssm_models(arch, quant_proj=mode)
    lens = np.array([7, 13, 4], np.int32)
    prompts = _padded_prompts(tcfg.vocab_size, lens, 16)
    cache = init_cache(tcfg, 3, 32, torch.float32, device="cpu")
    nl, cache = prefill(model, cache, _t(prompts), _t(lens), tcfg,
                        chunk=chunk)
    jcache = jax_init_cache(jcfg, 3, max_len=32, dtype=jnp.float32)
    jnl, jcache = jax_prefill(params, jcache, jnp.asarray(prompts),
                              jnp.asarray(lens), jcfg, chunk=chunk)
    if mode == "none":
        assert rel_err(nl.numpy(), jnl) <= SSM_TOL
        for key in cache:
            if key != "seq_lens":
                assert rel_err(cache[key].numpy(), jcache[key]) <= SSM_TOL
    assert cache["seq_lens"].tolist() == lens.tolist()
    first = torch.argmax(nl, -1)[:, None]
    toks, cache = greedy_decode(model, cache, first, None, 5, tcfg)
    jfirst = jnp.argmax(jnl, -1)[:, None].astype(jnp.int32)
    jtoks, _ = jax_greedy_decode(params, jcache, jfirst, None, 5, jcfg)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert cache["seq_lens"].tolist() == (lens + 5).tolist()


# ---------------------------------------------------------------------------
# the state handlers (tests/test_state_registry.py's cases)
# ---------------------------------------------------------------------------
PAGED = CacheConfig(layout="paged", alloc="dynamic", page_size=8)


def _cfgs():
    return {a: get_smoke_config(a) for a in
            ("qwen2_5_3b", "mamba2_370m", "zamba2_7b",
             "granite_moe_3b_a800m")}


def test_registry_selects_by_family():
    c = _cfgs()
    assert isinstance(state_handler(c["qwen2_5_3b"]), PagedKVHandler)
    assert isinstance(state_handler(c["granite_moe_3b_a800m"]),
                      PagedKVHandler)
    assert type(state_handler(c["mamba2_370m"])) is SlotStateHandler
    assert isinstance(state_handler(c["zamba2_7b"]), HybridHandler)
    assert [state_handler(c[a]).name for a in
            ("qwen2_5_3b", "mamba2_370m", "zamba2_7b")] == [
        "paged_kv", "ssm_slot", "hybrid"]
    for a in ("mamba2_370m", "zamba2_7b"):
        h = state_handler(c[a])
        assert not h.supports_speculative and not h.supports_prefix_sharing


def test_default_serving_config_per_family():
    c = _cfgs()
    pc = default_serving_config(c["qwen2_5_3b"])
    assert (pc.layout, pc.alloc, pc.page_size) == ("paged", "dynamic", 16)
    assert default_serving_config(c["mamba2_370m"]) == CacheConfig()
    assert default_serving_config(c["zamba2_7b"]).layout == "dense"


def test_scheduler_config_gate():
    c = _cfgs()
    with pytest.raises(ValueError, match="dynamic"):
        state_handler(c["qwen2_5_3b"], CacheConfig(
            layout="paged", alloc="striped")).require_scheduler_config()
    with pytest.raises(ValueError, match="dense"):
        state_handler(c["mamba2_370m"], CacheConfig(layout="paged")
                      ).require_scheduler_config()
    state_handler(c["qwen2_5_3b"], PAGED).require_scheduler_config()
    state_handler(c["zamba2_7b"], CacheConfig()).require_scheduler_config()


def test_capacity_per_family():
    c = _cfgs()
    paged = init_cache(c["qwen2_5_3b"], 2, 32, config=PAGED, device="cpu")
    assert state_handler(c["qwen2_5_3b"]).capacity(paged) == 32
    ssm_cache = init_cache(c["mamba2_370m"], 2, 32, device="cpu")
    assert state_handler(c["mamba2_370m"]).capacity(ssm_cache) is None
    hyb = init_cache(c["zamba2_7b"], 2, 32, device="cpu")
    assert state_handler(c["zamba2_7b"]).capacity(hyb) == 32


def test_slot_admit_free_and_occupancy():
    cfg = get_smoke_config("mamba2_370m")
    h = state_handler(cfg)
    cache = init_cache(cfg, 3, 16, device="cpu")
    assert h.occupancy(cache) == (0, 3, ((0, 3),))
    cache["ssm_h"][:, 1] = 2.5                         # a dirty slot
    cache["conv_B"][:, 1] = 1.5
    cache["seq_lens"][:] = torch.tensor([4, 9, 0], dtype=torch.int32)
    cache, ok = h.admit(cache, 1, n_tokens=10 ** 9)   # no positional bound
    assert ok
    for key in SLOT_STATE_KEYS:
        assert float(cache[key][:, 1].abs().max()) == 0.0
    assert cache["seq_lens"].tolist() == [4, 0, 0]
    assert h.occupancy(cache) == (1, 3, ((1, 3),))
    cache = h.free(cache, 0)
    assert h.occupancy(cache)[0] == 0
    _, ok = h.fork(cache, 0, 2, 4, 8)                 # slot families: no
    assert not ok


def test_reset_rows_per_family():
    """reset_rows zeroes a slot's state and length (slot families), or
    points a row's table at the scratch page (paged_kv)."""
    from repro_torch.serving import allocator as al
    c = _cfgs()
    cache = init_cache(c["qwen2_5_3b"], 2, 32, config=PAGED, device="cpu")
    h = state_handler(c["qwen2_5_3b"], PAGED)
    cache, ok = h.admit(cache, 1, 20)
    cache["seq_lens"][1] = 20
    assert ok and int(cache["page_table"][1, 0]) != al.SCRATCH_PAGE
    cache = h.reset_rows(cache, 1)
    assert int(cache["page_table"][1].max()) == al.SCRATCH_PAGE
    assert cache["seq_lens"].tolist() == [0, 0]
    cache = init_cache(c["zamba2_7b"], 2, 16, device="cpu")
    for key in SLOT_STATE_KEYS:
        cache[key] += 1.0
    cache["seq_lens"][:] = 3
    cache = state_handler(c["zamba2_7b"]).reset_rows(cache, 1)
    for key in SLOT_STATE_KEYS:
        assert float(cache[key][:, 1].abs().max()) == 0.0
        assert float(cache[key][:, 0].min()) == 1.0
    assert cache["seq_lens"].tolist() == [3, 0]


def test_advance_rezeros_idle_rows():
    cfg = get_smoke_config("mamba2_370m")
    h = state_handler(cfg)
    cache = init_cache(cfg, 3, 16, device="cpu")
    cache["seq_lens"][:] = torch.tensor([5, 1, 7], dtype=torch.int32)
    cache = h.advance(cache, torch.tensor([True, False, True]))
    assert cache["seq_lens"].tolist() == [5, 0, 7]
    assert cache["seq_lens"].dtype == torch.int32


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_slot_view_merge_roundtrip(arch):
    """slot_view slices exactly row b as views of the cache (a prefill
    writes them in place); merge_slot folds the length back, and no other
    row changes."""
    cfg = get_smoke_config(arch)
    h = state_handler(cfg)
    cache = init_cache(cfg, 3, 16, device="cpu")
    cache["ssm_h"][:, 2] = 7.0                        # sentinel row
    view = h.slot_view(cache, 1)
    assert view["ssm_h"].shape[1] == 1 and view["seq_lens"].shape == (1,)
    view["conv_x"] += 2.0                             # written in place
    assert float(cache["conv_x"][:, 1].min()) == 2.0
    if arch == "zamba2_7b":
        assert view["shared_k"].shape[1] == 1
        view["shared_k"] += 1.0                       # written in place
    view["ssm_h"].copy_(view["ssm_h"] + 3.0)          # as _ssm_stack does
    view["seq_lens"] = torch.tensor([6], dtype=torch.int32)
    cache = h.merge_slot(cache, view, 1)
    assert float(cache["ssm_h"][:, 1].min()) == 3.0
    assert float(cache["ssm_h"][:, 0].abs().max()) == 0.0
    assert float(cache["ssm_h"][:, 2].min()) == 7.0
    assert cache["seq_lens"].tolist() == [0, 6, 0]
    if arch == "zamba2_7b":
        assert float(cache["shared_k"][:, 1].min()) == 1.0
        assert float(cache["shared_k"][:, 0].abs().max()) == 0.0


def test_hybrid_admission_keeps_shared_kv():
    """Admission zeroes the slot's recurrent state, not its shared-KV rows:
    seq_lens governs what is attended."""
    cfg = get_smoke_config("zamba2_7b")
    h = state_handler(cfg)
    cache = init_cache(cfg, 2, 16, device="cpu")
    cache["shared_k"][:, 0] = 4.0
    cache["ssm_h"][:, 0] = 4.0
    cache, ok = h.admit(cache, 0, 8)
    assert ok and float(cache["ssm_h"][:, 0].abs().max()) == 0.0
    assert float(cache["shared_k"][:, 0].min()) == 4.0


def test_state_handler_free_clears_slot_state():
    """A retired slot does not leak its recurrence into the next occupant."""
    cfg = get_smoke_config("zamba2_7b")
    cache = init_cache(cfg, 2, 16, device="cpu")
    handler = state_handler(cfg)
    for key in SLOT_STATE_KEYS:
        cache[key] += 1.0
    cache["seq_lens"][:] = torch.tensor([5, 7], dtype=torch.int32)
    cache = handler.free(cache, 0)
    for key in SLOT_STATE_KEYS:
        assert float(cache[key][:, 0].abs().max()) == 0.0
        assert float(cache[key][:, 1].abs().min()) == 1.0   # row 1 intact
    assert cache["seq_lens"].tolist() == [0, 7]


# ---------------------------------------------------------------------------
# the Scheduler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_scheduler_cross_family_matches_isolated(arch):
    """A mixed-arrival trace through the Scheduler gives, per request, the
    isolated prefill → greedy_decode tokens, and the JAX Scheduler's; the
    request log has one tick per token and every slot is recycled."""
    jcfg, params, tcfg, model = ssm_models(arch)
    prompts, budgets = _cross_family_trace(tcfg.vocab_size)
    sched = Scheduler(model, tcfg, slots=2, max_len=64, bucket=8,
                      dtype=torch.float32, device="cpu")
    rids, out = _drive(sched, prompts, budgets)
    jrids, jout = _drive(JaxScheduler(params, jcfg, slots=2, max_len=64,
                                      bucket=8, dtype=jnp.float32),
                         prompts, budgets)
    for rid, jrid, p, m in zip(rids, jrids, prompts, budgets):
        cache = init_cache(tcfg, 1, 64, torch.float32, device="cpu")
        padded = np.pad(p, (0, -p.size % 8))     # the scheduler's bucket
        nl, cache = prefill(model, cache, _t(padded[None]),
                            torch.tensor([p.size]), tcfg)
        first = torch.argmax(nl, -1)[:, None]
        toks, _ = greedy_decode(model, cache, first, None, m - 1, tcfg)
        np.testing.assert_array_equal(out[rid], toks[0].numpy())
        np.testing.assert_array_equal(out[rid], jout[jrid])
        log = sched.request_log[rid]
        assert log["submitted"] <= log["admitted"]
        assert len(log["token_ticks"]) == m
    assert sched.pool_occupancy().used == 0


def test_scheduler_slot_admission_ssm_and_hybrid():
    """Hybrid capacity is the shared KV's S_max (refused at submit, in
    tokens); pure SSM has no positional bound; slot starvation queues
    requests until a retire frees a row; occupancy counts slots."""
    _, _, hcfg, hmodel = ssm_models("zamba2_7b")
    sched = Scheduler(hmodel, hcfg, slots=2, max_len=32, bucket=8,
                      dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="tokens"):
        sched.submit(np.arange(3, 13), max_new_tokens=40)
    assert not sched.queue
    _, _, mcfg, mmodel = ssm_models("mamba2_370m")
    msched = Scheduler(mmodel, mcfg, slots=2, max_len=32, bucket=8,
                       dtype=torch.float32, device="cpu")
    msched.submit(np.arange(3, 7), max_new_tokens=10 ** 6)   # no bound
    msched.queue.clear()
    rng = _rng(2)
    rids = [msched.submit(rng.integers(3, mcfg.vocab_size, 4), 3)
            for _ in range(3)]
    msched.step()
    assert msched.n_active == 2 and len(msched.queue) == 1
    occ = msched.pool_occupancy()
    assert (occ.used, occ.total) == (2, 2)
    out = msched.run(max_ticks=60)
    assert set(out) == set(rids)
    assert all(len(v) == 3 for v in out.values())
    assert msched.pool_occupancy().used == 0


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_family_degrades_to_plain_decode(arch):
    """SSM slot state cannot rewind: a spec request warns and serves the
    plain 1-token path with the same tokens."""
    _, _, cfg, model = ssm_models(arch, quant_proj="none")
    draft = Model(model.embed, model.final_norm, list(model.layers[:1]),
                  model.lm_head, model.shared_attn)
    prompt = np.arange(3, 9)

    def serve(spec):
        sched = Scheduler(model, cfg, slots=2, max_len=32, bucket=8,
                          spec=spec, device="cpu")
        sched.submit(prompt, 4)
        sched.run(max_ticks=50)
        return sched

    plain = serve(None)
    with pytest.warns(UserWarning, match="degrading to 1-token decode"):
        spec = serve(SpecConfig(draft, cfg.replace(n_layers=1), n_draft=3))
    assert spec.spec is None and spec.draft_cache is None
    for rid in plain.finished:
        np.testing.assert_array_equal(plain.finished[rid],
                                      spec.finished[rid])


def test_other_families_still_raise():
    """The vision and encoder-decoder configs, carried over field for
    field, build attention models with a dense KV cache, not slot state;
    a slot family's cache refuses them and theirs refuses a slot family."""
    from repro_torch.models.config import ModelConfig
    zamba = get_smoke_config("zamba2_7b")
    zamba_cache = init_cache(zamba, 2, 8, torch.float32, device="cpu")
    for arch in ("seamless_m4t_medium", "phi3_vision_4_2b"):
        cfg = ModelConfig(**dataclasses.asdict(
            jax_configs.get_smoke_config(arch)))
        model = init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        assert not any(isinstance(layer, SSMBlock) for layer in model.layers)
        cache = init_cache(cfg, 2, 8, torch.float32, device="cpu")
        assert "ssm_h" not in cache and "k" in cache
        with pytest.raises(ValueError, match="SSM slot state"):
            validate_decode_cache(zamba_cache, cfg)
        with pytest.raises(ValueError, match="attention KV"):
            validate_decode_cache(cache, zamba)
