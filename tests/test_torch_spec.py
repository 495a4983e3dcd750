"""Port's speculative draft-and-verify decode vs the JAX package: K4's
verify mode (``new_lens``) in its plain version, rollback over every page
array, ``spec_step`` against JAX's ``_spec_run`` from the same cache
state, and the Scheduler's speculative serve against its plain serve and
the JAX Scheduler.  Mirrors ``tests/test_spec_decode.py``."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    paged_decode_attention as jax_paged_decode_attention
from repro.models.transformer import init_model as jax_init_model
from repro.serving import allocator as jal
from repro.serving.cache import CacheConfig as JaxCacheConfig
from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.engine import spec_step as jax_spec_step
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro.serving.scheduler import SpecConfig as JaxSpecConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention.ops import paged_decode_attention
from repro_torch.models.transformer import Model, apply_model, init_model
from repro_torch.serving import allocator as al
from repro_torch.serving.cache import (PAGE_STATE_KEYS, CacheConfig,
                                       init_cache, invalidate_token_rows)
from repro_torch.serving.engine import prefill, spec_step
from repro_torch.serving.scheduler import Scheduler, SpecConfig
from test_torch_bridge import numpy_tree, paired_models
from test_torch_paged import paged_inputs, to_torch

RNG = np.random.default_rng(0)


# ---------------------------------------------------------------------------
# K4's verify mode, plain version
# ---------------------------------------------------------------------------
def _verify_n1_case(g, window, page, lens):
    """new_lens of all ones is bitwise the plain 1-row launch."""
    h, kh, d = 4, 4 // g, 16
    q, kp, vp, table, lens = to_torch(*paged_inputs(
        len(lens), 64, h, kh, d, page, lens, seed=page + g))
    ones = torch.ones(len(lens), dtype=torch.int32)
    plain = paged_decode_attention(q, kp, vp, table, lens, window=window)
    verify = paged_decode_attention(q, kp, vp, table, lens, window=window,
                                    new_lens=ones)
    assert torch.equal(plain, verify)


def test_verify_n1_bitwise():
    _verify_n1_case(2, None, 8, [33, 17])
    _verify_n1_case(2, 12, 8, [33, 17])


@pytest.mark.parametrize(
    "g,window,page,lens",
    list(itertools.product([1, 4], [None, 24], [8, 16],
                           [[64, 64], [37, 5], [64, 1], [48, 23]])))
def test_verify_n1_bitwise_sweep(g, window, page, lens):
    """{GQA} × {window} × {page size} × {mixed/non-multiple lens}."""
    _verify_n1_case(g, window, page, lens)


def test_verify_variable_rows():
    """Dead rows are exact zeros; live rows match an exact-width launch
    per sequence within the reference's limits."""
    s = 4
    q, kp, vp, table, _ = to_torch(*paged_inputs(2, 64, 4, 2, 16, 8,
                                                 [39, 21], qs=s, seed=3))
    lens = torch.tensor([39, 21], dtype=torch.int32)   # committed + live
    new_lens = torch.tensor([3, 1], dtype=torch.int32)
    out = paged_decode_attention(q, kp, vp, table, lens, new_lens=new_lens)
    for b, nl in enumerate([3, 1]):
        assert torch.equal(out[b, nl:], torch.zeros_like(out[b, nl:]))
        want = paged_decode_attention(q[b:b + 1, :nl], kp, vp,
                                      table[b:b + 1], lens[b:b + 1])
        torch.testing.assert_close(out[b, :nl], want[0], atol=5e-6,
                                   rtol=1e-5)
    # an idle slot (no live row) gives zeros
    idle = paged_decode_attention(q, kp, vp, table, lens * 0,
                                  new_lens=new_lens * 0)
    assert not idle.any()


# b, t, h, kh, d, page, lens, new_lens, options
VERIFY_CASES = {
    "gqa": (2, 64, 4, 2, 16, 8, [39, 21], [3, 1], {}),
    "all_live": (2, 64, 8, 2, 32, 16, [60, 40], [5, 5], {}),
    "window": (3, 64, 4, 1, 16, 8, [50, 12, 33], [2, 5, 0],
               dict(window=12)),
    "softcap": (2, 128, 4, 4, 32, 16, [100, 7], [4, 2],
                dict(softcap=30.0)),
}


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_verify_plain_version_matches_jax(case, kv):
    """The plain version's verify mode against the JAX package's oracle
    (``paged_attention_ref(new_lens=)``) and its interpreted kernel."""
    from repro.core.quantization import quantize_kv as jax_quantize_kv
    b, t, h, kh, d, page, lens, new_lens, opts = VERIFY_CASES[case]
    q, kp, vp, table, lens = paged_inputs(b, t, h, kh, d, page, lens,
                                          qs=5, seed=len(case))
    new_lens = np.asarray(new_lens, np.int32)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lens)]
    scales = {}
    if kv == "int8":
        (jargs[1], ks), (jargs[2], vs) = (jax_quantize_kv(jargs[1]),
                                          jax_quantize_kv(jargs[2]))
        kp, vp = np.asarray(jargs[1]), np.asarray(jargs[2])
        scales = dict(k_scales=np.asarray(ks), v_scales=np.asarray(vs))
    out = paged_decode_attention(
        *to_torch(q, kp, vp, table, lens),
        new_lens=torch.from_numpy(new_lens),
        **{k: torch.from_numpy(np.array(v)) for k, v in scales.items()},
        **opts)
    for mode in ("ref", "pallas_interpret"):
        want = jax_paged_decode_attention(
            *jargs, new_lens=jnp.asarray(new_lens), mode=mode,
            **{k: jnp.asarray(v) for k, v in scales.items()}, **opts)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=5e-6,
                                   rtol=1e-5, err_msg=mode)
    for bb, nl in enumerate(new_lens):
        assert not out[bb, nl:].any()


# ---------------------------------------------------------------------------
# rollback, and the static-table hazard
# ---------------------------------------------------------------------------
def test_rewind_invalidates_all_page_state():
    """Speculative rollback: each live row's verify rows past its ``m``
    are zeroed in every ``PAGE_STATE_KEYS`` array (an int8 pool's scale
    rows with its values), ``seq_lens`` rewinds to ``c + m``; committed
    rows, rows past the verify pass, the page table and an idle row's
    pages are untouched."""
    cfg = get_smoke_config("qwen2_5_3b").replace(quant_proj="none",
                                                 dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    dcfg = cfg.replace(n_layers=1)
    draft = Model(model.embed, model.final_norm, list(model.layers[:1]),
                  model.lm_head)
    config = CacheConfig(layout="paged", alloc="dynamic", page_size=4,
                         pool_pages=30, kv_quant="int8")
    cache = init_cache(cfg, 3, 16, torch.float32, config, device="cpu")
    for b in range(3):
        cache, ok = al.admit_sequence(cache, b, 16)
        assert bool(ok)
    for key in PAGE_STATE_KEYS:
        cache[key].fill_(1)
    c, live, n_draft = [6, 0, 9], [True, False, True], 3
    cache["seq_lens"][:] = torch.tensor(c, dtype=torch.int32)
    table = cache["page_table"].clone()
    dense = init_cache(dcfg, 3, 16, torch.float32, device="cpu")
    _, m, _, cache, _ = spec_step(
        model, draft, cache, dense, torch.tensor([[3], [0], [9]]),
        torch.tensor([8, 0, 8]), torch.tensor(live), cfg, dcfg,
        n_draft=n_draft)
    m = m.tolist()
    assert m[1] == 0 and all(1 <= m[b] <= n_draft for b in (0, 2))
    assert cache["seq_lens"].tolist() == [c[0] + m[0], 0, c[2] + m[2]]
    assert torch.equal(cache["page_table"], table)           # pages never move
    page = config.page_size
    for key in PAGE_STATE_KEYS:
        for b in range(3):
            for tok in range(16):
                got = cache[key][:, int(table[b, tok // page]), tok % page]
                verify = live[b] and c[b] <= tok <= c[b] + n_draft
                if not verify:
                    assert (got == 1).all(), (key, b, tok)
                elif tok >= c[b] + m[b]:
                    assert (got == 0).all(), (key, b, tok)


def test_invalidate_token_rows_equals_jax():
    """Selected rows zeroed in every page array, deselected ones and rows
    past the table's reach sent to the scratch page, as in JAX."""
    from repro.serving.cache import invalidate_token_rows as jax_invalidate
    cfg = get_smoke_config("qwen2_5_3b")
    from repro.configs import get_smoke_config as jax_get_smoke_config
    kw = dict(layout="paged", alloc="dynamic", page_size=4, pool_pages=12,
              kv_quant="int8")
    cache = init_cache(cfg, 2, 16, torch.float32, CacheConfig(**kw),
                       device="cpu")
    jcache = jax_init_cache(jax_get_smoke_config("qwen2_5_3b"), 2, 16,
                            dtype=jnp.float32, config=JaxCacheConfig(**kw))
    for slot, n in ((0, 9), (1, 16)):
        cache, _ = al.admit_sequence(cache, slot, n)
        jcache, _ = jal.admit_sequence(jcache, slot, n)
    for key in PAGE_STATE_KEYS:
        cache[key] = torch.from_numpy(RNG.integers(
            1, 100, cache[key].shape)).to(cache[key].dtype)
        jcache[key] = jnp.asarray(cache[key].numpy())
    tok = np.asarray([[6, 7, 8, 9, 10], [12, 13, 14, 15, 16]], np.int32)
    inv = np.asarray([[0, 1, 1, 1, 1], [1, 0, 1, 1, 1]], bool)
    invalidate_token_rows(cache, torch.from_numpy(tok), torch.from_numpy(inv))
    jcache = jax_invalidate(jcache, jnp.asarray(tok), jnp.asarray(inv))
    for key in PAGE_STATE_KEYS:
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jcache[key]), err_msg=key)


def test_static_table_hazard_raises():
    """The port refuses a masked write to page 0 unless the allocator
    reserves it: on a static table page 0 is sequence 0's first page
    (the JAX package's invalidate_token_rows writes there unasked)."""
    cfg = get_smoke_config("qwen2_5_3b").replace(quant_proj="none",
                                                 dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    for alloc in ("contiguous", "striped"):
        cache = init_cache(cfg, 2, 16, torch.float32, CacheConfig(
            layout="paged", page_size=4, alloc=alloc), device="cpu")
        assert int(cache["page_table"][0, 0]) == 0      # a live page
        tok = torch.zeros((2, 3), dtype=torch.long)
        with pytest.raises(ValueError, match="alloc='dynamic'"):
            invalidate_token_rows(cache, tok, tok == 0)
        with pytest.raises(ValueError, match="alloc='dynamic'"):
            apply_model(model, tok, cfg, cache=cache, cache_pos=0,
                        n_valid=torch.ones(2, dtype=torch.int32))
        dense = init_cache(cfg, 2, 16, torch.float32, device="cpu")
        with pytest.raises(ValueError, match="alloc='dynamic'"):
            spec_step(model, model, cache, dense, tok[:, :1],
                      torch.ones(2), torch.ones(2, dtype=torch.bool), cfg,
                      cfg, n_draft=2)
    with pytest.raises(NotImplementedError, match="paged"):
        apply_model(model, tok, cfg, cache=dense, cache_pos=0,
                    n_valid=torch.ones(2, dtype=torch.int32))


def test_verify_rows_past_the_table_go_to_scratch():
    """A verify pass whose rows run past the table's reach (a nearly full
    reservation) writes them to the scratch page, never past the table."""
    cfg = get_smoke_config("qwen2_5_3b").replace(quant_proj="none",
                                                 dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = init_cache(cfg, 1, 8, torch.float32, CacheConfig(
        layout="paged", page_size=4, alloc="dynamic", pool_pages=4),
        device="cpu")
    cache, ok = al.admit_sequence(cache, 0, 8)
    assert bool(ok)
    _, cache = prefill(model, cache, torch.arange(6)[None],
                       torch.tensor([6]), cfg)
    before = {key: cache[key][:, 1:].clone() for key in ("k_pages",
                                                         "v_pages")}
    logits, cache, _ = apply_model(model, torch.arange(5)[None], cfg,
                                   cache=cache, cache_pos=cache["seq_lens"],
                                   n_valid=torch.tensor([5], dtype=torch.int32))
    assert bool(torch.isfinite(logits).all())
    assert cache["seq_lens"].tolist() == [11]
    # rows 6 and 7 landed in the row's second page, rows 8..10 in scratch
    page1 = int(cache["page_table"][0, 1])
    for key, was in before.items():
        changed = (cache[key][:, 1:] != was).flatten(2).any(-1).any(0)
        assert changed.nonzero().flatten().tolist() == [page1 - 1]


# ---------------------------------------------------------------------------
# spec_step against JAX's, from the same cache state
# ---------------------------------------------------------------------------
def _to_jax_cache(cache):
    return {k: jnp.asarray(v.numpy()) for k, v in cache.items()}


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_spec_step_equals_jax(kv_quant):
    jcfg, params, tcfg, model = paired_models("qwen2_5_3b", quant_proj="none",
                                              dtype="float32")
    jdraft = dict(params)
    jdraft["layers"] = jax.tree.map(lambda x: x[:1], params["layers"])
    dcfg = tcfg.replace(n_layers=1)
    draft = Model(model.embed, model.final_norm, list(model.layers[:1]),
                  model.lm_head)
    config = CacheConfig(layout="paged", alloc="dynamic", page_size=4,
                         pool_pages=30, kv_quant=kv_quant)
    cache = init_cache(tcfg, 3, 32, torch.float32, config, device="cpu")
    dense = init_cache(dcfg, 3, 36, torch.float32, device="cpu")
    prompts = torch.from_numpy(RNG.integers(0, tcfg.vocab_size, (3, 9)))
    lens = torch.tensor([9, 5, 7])
    for b in range(3):
        cache, _ = al.admit_sequence(cache, b, 24)
    _, cache = prefill(model, cache, prompts, lens, tcfg)
    _, dense = prefill(draft, dense, prompts, lens, dcfg)
    active = torch.tensor([True, False, True])
    cache["seq_lens"] = torch.where(active, cache["seq_lens"], 0).int()
    jcache, jdense = _to_jax_cache(cache), _to_jax_cache(dense)
    tok = torch.tensor([[3], [0], [9]])
    budget = torch.tensor([4, 0, 2])
    pred, m, acc, cache, dense = spec_step(
        model, draft, cache, dense, tok, budget, active, tcfg, dcfg,
        n_draft=3, eos_id=11)
    jpred, jm, jacc, jcache, _ = jax_spec_step(
        params, jdraft, jcache, jdense, jnp.asarray(tok.numpy(), jnp.int32),
        jnp.asarray(budget.numpy(), jnp.int32), jnp.asarray(active.numpy()),
        jcfg, jcfg.replace(n_layers=1), n_draft=3, eos_id=11)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(cache["seq_lens"].numpy(),
                                  np.asarray(jcache["seq_lens"]))
    # committed rows agree; rejected rows are zero in both
    for key in PAGE_STATE_KEYS:
        if key in cache:
            np.testing.assert_allclose(cache[key].float().numpy()[:, 1:],
                                       np.asarray(jcache[key],
                                                  np.float32)[:, 1:],
                                       atol=2e-6, rtol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# the scheduler's speculative serve
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """Target, the two drafts of the reference's tests (an independent
    1-layer model, the target's first layer with its embed and head), in
    both packages with the same weights."""
    jcfg, params, tcfg, model = paired_models("qwen2_5_3b", quant_proj="none",
                                              dtype="float32")
    jdcfg, tdcfg = jcfg.replace(n_layers=1), tcfg.replace(n_layers=1)
    jind = jax_init_model(jax.random.PRNGKey(7), jdcfg)
    jtrunc = dict(params)
    jtrunc["layers"] = jax.tree.map(lambda x: x[:1], params["layers"])
    drafts = {
        "independent": (JaxSpecConfig(jind, jdcfg, n_draft=3), SpecConfig(
            params_from_numpy(numpy_tree(jind), tdcfg, device="cpu"), tdcfg,
            n_draft=3)),
        "self_trunc": (JaxSpecConfig(jtrunc, jdcfg, n_draft=3), SpecConfig(
            Model(model.embed, model.final_norm, list(model.layers[:1]),
                  model.lm_head), tdcfg, n_draft=3)),
    }
    return jcfg, params, tcfg, model, drafts


def _spec_trace():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, 6).astype(np.int32)
    reqs = []
    for i in range(6):
        if i % 3 == 2:     # shared prefixes: fork, then reject
            prompt = np.concatenate(
                [base, rng.integers(0, 256, 1 + i).astype(np.int32)])
        else:
            prompt = rng.integers(0, 256, int(rng.integers(3, 9)))
        reqs.append((prompt.astype(np.int32), int(rng.integers(2, 9))))
    return reqs, [0, 1, 1, 3, 5, 6]


def _serve(sched):
    reqs, arrivals = _spec_trace()
    i = 0
    while i < len(reqs) or sched.queue or sched.n_active:
        while i < len(reqs) and arrivals[i] <= sched._ticks:
            sched.submit(*reqs[i])
            i += 1
        sched.step()
        assert sched._ticks < 500
    return sched


def _config(kv_quant, cls):
    return cls(layout="paged", alloc="dynamic", page_size=4, pool_pages=30,
               kv_quant=kv_quant)


def _port(tcfg, model, spec, kv_quant):
    return _serve(Scheduler(model, tcfg, slots=3, max_len=64, bucket=8,
                            config=_config(kv_quant, CacheConfig), eos_id=5,
                            spec=spec, device="cpu"))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("draft", ["independent", "self_trunc"])
def test_spec_serving_bitwise_parity(models, draft, kv_quant):
    """Speculative greedy tokens are bitwise the plain 1-token decode's on
    a mixed-arrival prefix-sharing trace with EOS and budget caps, and
    equal the JAX Scheduler's speculative serve tick for tick."""
    jcfg, params, tcfg, model, drafts = models
    jspec, tspec = drafts[draft]
    plain = _port(tcfg, model, None, kv_quant)
    spec = _port(tcfg, model, tspec, kv_quant)
    assert plain.finished.keys() == spec.finished.keys()
    for rid in plain.finished:
        np.testing.assert_array_equal(plain.finished[rid],
                                      spec.finished[rid])
    st = spec.spec_stats
    assert st["emitted"] == (sum(len(v) for v in spec.finished.values())
                             - len(spec.finished))
    assert 0 <= st["accepted"] <= st["proposed"]
    jax_spec = _serve(JaxScheduler(params, jcfg, slots=3, max_len=64,
                                   bucket=8, eos_id=5, spec=jspec,
                                   config=_config(kv_quant, JaxCacheConfig)))
    for rid in jax_spec.finished:
        np.testing.assert_array_equal(spec.finished[rid],
                                      jax_spec.finished[rid])
    assert spec.spec_stats == jax_spec.spec_stats
    assert spec.occupancy_log == jax_spec.occupancy_log
    if draft == "self_trunc":
        # a correlated draft multi-accepts; on this trace the arrivals, not
        # the decode, set the tick count, so spec and plain tie (the JAX
        # package's own test asks for fewer ticks, which this trace cannot
        # show: it gives 8 and 8 there too)
        assert st["accepted"] > 0
        jax_plain = _serve(JaxScheduler(
            params, jcfg, slots=3, max_len=64, bucket=8, eos_id=5,
            config=_config(kv_quant, JaxCacheConfig)))
        assert (plain._ticks, spec._ticks) == (jax_plain._ticks,
                                               jax_spec._ticks)


def test_spec_event_log_one_tick_per_token(models):
    """A multi-accept tick logs one ``token_tick`` per emitted token."""
    _, _, tcfg, model, drafts = models
    sched = _port(tcfg, model, drafts["self_trunc"][1], "none")
    multi = 0
    for rid, log in sched.request_log.items():
        tt = log["token_ticks"]
        assert len(tt) == len(sched.finished[rid])
        assert tt == sorted(tt)
        assert log["submitted"] <= log["admitted"] <= tt[0]
        multi = max(multi, max(tt.count(t) for t in set(tt)))
    assert multi > 1


def test_self_full_draft_accepts_every_tick(models):
    """The target as its own draft: every tick of a live row emits
    ``n_draft`` tokens (or what its budget or EOS leaves), tokens still
    bitwise the plain serve's."""
    _, _, tcfg, model, _ = models
    plain = _port(tcfg, model, None, "none")
    spec = _port(tcfg, model, SpecConfig(model, tcfg, n_draft=3), "none")
    for rid in plain.finished:
        np.testing.assert_array_equal(plain.finished[rid],
                                      spec.finished[rid])
    st = spec.spec_stats
    assert st["accepted"] == st["emitted"] > 0
