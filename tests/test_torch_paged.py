"""Port's paged KV path vs the JAX package on the same inputs: the plain
version of kernel K4 (against JAX's Pallas kernel in interpret mode and
its oracle), the decode schedule, page tables, the paged cache, and the
paged serving engine (prefill → greedy_decode reading ``seq_lens``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.decode import (
    flash_decode_schedule as jax_flash_decode_schedule)
from repro.kernels.flash_attention.decode import \
    _page_bounds as jax_page_bounds
from repro.kernels.flash_attention.decode import \
    pages_touched as jax_pages_touched
from repro.kernels.flash_attention.ops import \
    paged_decode_attention as jax_paged_decode_attention
from repro.serving.cache import CacheConfig as JaxCacheConfig
from repro.serving.cache import default_page_table as jax_default_page_table
from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.engine import greedy_decode as jax_greedy_decode
from repro.serving.engine import prefill as jax_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention.decode import (flash_decode_schedule,
                                                        pages_touched,
                                                        split_bounds,
                                                        split_plan)
from repro_torch.kernels.flash_attention.ops import paged_decode_attention
from repro_torch.kernels.flash_attention.ref import paged_gather
from repro_torch.models.transformer import init_model
from repro_torch.serving.cache import (CacheConfig, default_page_table,
                                       init_cache)
from repro_torch.serving.engine import greedy_decode, prefill, serve_step
from test_torch_bridge import paired_models

PAGED = dict(layout="paged", page_size=4, alloc="striped")


def pools_from_history(hist, page, table):
    """Scatter a dense (B, T, KH, D) numpy history into (P, page, KH, D)
    pools through ``table``."""
    b, t, kh, d = hist.shape
    pool = np.zeros((b * (t // page), page, kh, d), hist.dtype)
    for bb in range(b):
        for j in range(t // page):
            pool[int(table[bb, j])] = hist[bb, j * page:(j + 1) * page]
    return pool


def paged_inputs(b, t, h, kh, d, page, lens, *, qs=1, seed=0,
                 alloc="striped"):
    """(q (B, qs, H, D), k pool, v pool, table, lengths) as numpy."""
    rng = np.random.default_rng(seed)
    table = np.asarray(jax_default_page_table(b, t // page, alloc))
    hist_k = rng.normal(size=(b, t, kh, d)).astype(np.float32)
    hist_v = rng.normal(size=(b, t, kh, d)).astype(np.float32)
    q = rng.normal(size=(b, qs, h, d)).astype(np.float32)
    return (q, pools_from_history(hist_k, page, table),
            pools_from_history(hist_v, page, table), table,
            np.asarray(lens, np.int32))


def to_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# b, t, h, kh, d, page, lens, options — the cases of the JAX package's own
# paged-decode tests, plus a multi-block q and a one-head-per-KV-head case
CASES = {
    "mixed_lengths_gqa": (3, 128, 8, 2, 64, 16, [37, 5, 128], {}),
    "window_softcap": (2, 128, 4, 1, 64, 16, [100, 23],
                       dict(window=20, softcap=30.0)),
    "q_len3": (2, 64, 4, 2, 64, 8, [33, 17], dict(qs=3)),
    "q_len3_window": (2, 64, 4, 2, 64, 8, [33, 17], dict(qs=3, window=12)),
    "mha": (2, 64, 4, 4, 32, 8, [64, 9], {}),
    "q_blocks": (2, 64, 4, 2, 32, 8, [40, 20], dict(qs=20, q_chunk=8)),
}


@pytest.mark.parametrize("jax_mode", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_paged_attention_matches_jax(case, jax_mode):
    b, t, h, kh, d, page, lens, opts = CASES[case]
    opts = dict(opts)
    qs = opts.pop("qs", 1)
    q, kp, vp, table, lens = paged_inputs(b, t, h, kh, d, page, lens, qs=qs,
                                          seed=len(case))
    out = paged_decode_attention(*to_torch(q, kp, vp, table, lens), **opts)
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), mode=jax_mode, **opts)
    assert out.shape == (b, qs, h, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=5e-6,
                               rtol=1e-5)


def test_plain_version_on_the_cpu_counts_no_launch():
    q, kp, vp, table, lens = paged_inputs(2, 32, 4, 2, 16, 8, [20, 9])
    reset_launch_counts()
    paged_decode_attention(*to_torch(q, kp, vp, table, lens))
    assert launch_counts()["paged_decode"] == 0


def test_allocation_indistinguishable_through_table():
    outs = []
    for alloc in ("contiguous", "striped"):
        arrays = paged_inputs(2, 64, 4, 2, 32, 8, [50, 21], alloc=alloc)
        outs.append(paged_decode_attention(*to_torch(*arrays)))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_paged_gather_roundtrip():
    table = np.asarray(jax_default_page_table(2, 4, "striped"))
    hist = np.random.default_rng(1).normal(size=(2, 32, 2, 8)).astype(
        np.float32)
    pool = pools_from_history(hist, 8, table)
    got = paged_gather(*to_torch(pool, table))
    np.testing.assert_array_equal(got.numpy(), hist)


# ---------------------------------------------------------------------------
# schedule and page tables: exact
# ---------------------------------------------------------------------------
SCHEDULES = [(64, 16, 1, None, None), (64, 16, 1, 20, None),
             (2, 16, 1, 4096, None), (8, 16, 1, None, None),
             (8, 16, 1, 20, None), (16, 4, 26, None, 8), (16, 4, 26, 5, 8),
             (40, 16, 200, None, 128), (40, 16, 200, 33, 128),
             (8, 8, 3, 12, None)]


@pytest.mark.parametrize("max_pages,page,q_len,window,q_chunk", SCHEDULES)
def test_schedule_and_pages_touched_equal_jax(max_pages, page, q_len, window,
                                              q_chunk):
    sched = flash_decode_schedule(max_pages, page, q_len=q_len, window=window,
                                  q_chunk=q_chunk)
    jsched = jax_flash_decode_schedule(max_pages, page, q_len=q_len,
                                       window=window, q_chunk=q_chunk)
    assert dataclasses.asdict(sched) == dataclasses.asdict(jsched)
    cap = max_pages * page
    for lens in ([q_len] * 3, [cap, q_len, cap // 2 + q_len],
                 [37, 5, 128], [min(cap, q_len + 63)]):
        lens = [min(max(n, q_len), cap) for n in lens]
        assert pages_touched(lens, sched) == jax_pages_touched(lens, jsched)


# batch, KV heads, group, then SCHEDULES' max_pages, page, q_len, window,
# q_chunk: the served verify and the Scheduler's decode (qwen2.5-3b's
# heads), ~4096-token contexts in pages of 16 and 64, a window, chunked
# prefill, pages of 4
SPLITS = [(4, 2, 8, 36, 16, 5, None, None), (4, 2, 8, 32, 16, 1, None, None),
          (2, 2, 8, 256, 16, 1, None, None), (2, 2, 8, 64, 64, 5, None, None),
          (8, 12, 1, 64, 64, 1, None, None), (2, 2, 8, 64, 16, 3, 100, None),
          (2, 12, 1, 13, 16, 200, None, 128), (3, 4, 2, 16, 4, 26, 5, 8),
          (1, 1, 1, 1, 16, 1, None, None)]


@pytest.mark.parametrize("b,kh,g,max_pages,page,q_len,window,q_chunk",
                         SPLITS)
def test_split_plan_covers_each_walk_once(b, kh, g, max_pages, page, q_len,
                                          window, q_chunk):
    """K4's split of each q block's walk: the splits' pages are the JAX
    schedule's [j_lo, j_hi], each page once and in order, for every
    context and q block; the plan comes from the shapes alone."""
    sched = flash_decode_schedule(max_pages, page, q_len=q_len,
                                  window=window, q_chunk=q_chunk)
    plan = split_plan(b, kh, g, sched)
    assert plan.pages_per_split >= 1
    assert ((plan.n_splits - 1) * plan.pages_per_split < sched.max_steps
            <= plan.n_splits * plan.pages_per_split)
    for ctx in range(q_len, max_pages * page + 1):
        for i in range(sched.num_q_blocks):
            j_lo, j_hi = jax_page_bounds(ctx, i, q_len=q_len,
                                         q_chunk=sched.q_chunk,
                                         page_size=page, window=window,
                                         _min=min, _max=max)
            walked = []
            for split in range(plan.n_splits):
                lo, hi = split_bounds(j_lo, j_hi, split, plan)
                assert hi - lo + 1 <= plan.pages_per_split
                walked += range(lo, hi + 1)
            assert walked == list(range(j_lo, j_hi + 1))


@pytest.mark.parametrize("max_pages,page,window", [(36, 16, None),
                                                   (256, 16, None),
                                                   (64, 64, 20)])
def test_split_plan_equal_for_plain_and_one_row_verify(max_pages, page,
                                                       window):
    """A one-row verify launch (new_lens = 1) is the plain launch of one
    row: the same plan, and for every context the same pages per split
    (the verify rows' base, lengths - new_lens, is the plain one,
    lengths - q_len)."""
    sched = flash_decode_schedule(max_pages, page, q_len=1, window=window)
    plan = split_plan(4, 2, 8, sched)
    assert plan == split_plan(4, 2, 8, flash_decode_schedule(
        max_pages, page, q_len=1, window=window, q_chunk=1))
    for ctx in range(1, max_pages * page + 1):
        plain = jax_page_bounds(ctx, 0, q_len=1, q_chunk=1, page_size=page,
                                window=window, _min=min, _max=max)
        n_live = 1
        verify = jax_page_bounds(ctx, 0, q_len=n_live, q_chunk=1,
                                 page_size=page, window=window, _min=min,
                                 _max=max)
        assert [split_bounds(*plain, s, plan) for s in range(plan.n_splits)] \
            == [split_bounds(*verify, s, plan)
                for s in range(plan.n_splits)]


def test_split_plan_at_the_served_shapes():
    """The plans the card runs: the served verify (4 x 5 rows, H16/KH2,
    36 pages of 16), the Scheduler's decode (32 pages of 16), distilbert's
    first decode step (6 pages of 16), a 4096-token context in pages of 64,
    and a prefill whose row tiles alone fill the card (one split, no
    combine)."""
    def plan(b, kh, g, max_pages, page, q_len):
        p = split_plan(b, kh, g, flash_decode_schedule(max_pages, page,
                                                       q_len=q_len))
        return p.pages_per_split, p.n_splits

    assert plan(4, 2, 8, 36, 16, 5) == (4, 9)
    assert plan(4, 2, 8, 32, 16, 1) == (4, 8)
    assert plan(4, 12, 1, 6, 16, 1) == (3, 2)
    assert plan(8, 12, 1, 64, 64, 1) == (4, 16)
    assert plan(1, 2, 8, 32, 16, 304) == (16, 2)
    assert plan(4, 12, 1, 6, 16, 512) == (6, 1)


def test_pages_touched_counts():
    sched = flash_decode_schedule(8, 16, q_len=1)
    assert pages_touched([37, 5, 128], sched) == 3 + 1 + 8
    windowed = flash_decode_schedule(8, 16, q_len=1, window=20)
    assert pages_touched([37, 5, 128], windowed) == 2 + 1 + 2


@pytest.mark.parametrize("alloc", ["contiguous", "striped"])
@pytest.mark.parametrize("batch,max_pages", [(3, 5), (1, 7), (4, 1)])
def test_default_page_table_equals_jax(alloc, batch, max_pages):
    table = default_page_table(batch, max_pages, alloc)
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(
        table.numpy(), np.asarray(jax_default_page_table(batch, max_pages,
                                                         alloc)))
    assert len(set(table.flatten().tolist())) == batch * max_pages


def test_init_cache_paged_equals_jax():
    tcfg = get_smoke_config("qwen2_5_3b")
    from repro.configs import get_smoke_config as jax_get_smoke_config
    jcfg = jax_get_smoke_config("qwen2_5_3b")
    cache = init_cache(tcfg, 2, 40, torch.bfloat16,
                       CacheConfig(layout="paged", page_size=16),
                       device="cpu")
    jcache = jax_init_cache(jcfg, 2, max_len=40, dtype=jnp.bfloat16,
                            config=JaxCacheConfig(layout="paged",
                                                  page_size=16))
    assert set(cache) == set(jcache)
    for key, val in cache.items():
        assert tuple(val.shape) == jcache[key].shape, key
        assert str(val.dtype).split(".")[-1] == str(jcache[key].dtype), key
        if key != "page_table":
            assert not val.any()
    assert cache["k_pages"].shape == (tcfg.n_layers, 6, 16, tcfg.n_kv_heads,
                                      tcfg.head_dim)
    np.testing.assert_array_equal(cache["page_table"].numpy(),
                                  np.asarray(jcache["page_table"]))


def test_init_cache_errors():
    cfg = get_smoke_config("qwen2_5_3b")
    with pytest.raises(ValueError, match="layout"):
        init_cache(cfg, 2, 40, config=CacheConfig(layout="ragged"),
                   device="cpu")
    with pytest.raises(ValueError, match="allocation"):
        init_cache(cfg, 2, 40, config=CacheConfig(layout="paged",
                                                  alloc="buddy"),
                   device="cpu")


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
LENS = np.array([10, 4, 7], np.int32)
N_STEPS = 4
MAX_LEN = 20


def _prompts(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (len(LENS), int(LENS.max()))).astype(
        np.int32)


def jax_paged_serve(jcfg, params, prompts, **config):
    cache = jax_init_cache(jcfg, len(LENS), MAX_LEN, dtype=jnp.float32,
                           config=JaxCacheConfig(**config))
    nl, cache = jax_prefill(params, cache, jnp.asarray(prompts),
                            jnp.asarray(LENS), jcfg)
    first = jnp.argmax(nl, -1)[:, None].astype(jnp.int32)
    toks, _ = jax_greedy_decode(params, cache, first, None, N_STEPS, jcfg)
    return np.asarray(toks)


def port_serve(tcfg, model, prompts, config=None, chunk=None):
    """prefill → greedy_decode on the CPU; the paged cache starts from its
    seq_lens, the dense one from the prompt lengths."""
    cache = init_cache(tcfg, len(LENS), MAX_LEN, torch.float32, config,
                       device="cpu")
    lens = torch.from_numpy(LENS)
    nl, cache = prefill(model, cache, torch.from_numpy(prompts), lens, tcfg,
                        chunk=chunk)
    first = torch.argmax(nl, -1)[:, None]
    start = None if config is not None else lens
    toks, cache = greedy_decode(model, cache, first, start, N_STEPS, tcfg)
    return nl, toks, cache


@pytest.mark.parametrize("arch", ["distilbert_paper", "qwen2_5_3b",
                                  "gemma2_27b"])
@pytest.mark.parametrize("mode", ["w8a8", "none"])
def test_paged_greedy_tokens_equal_jax_engine(arch, mode):
    jcfg, params, tcfg, model = paired_models(arch, quant_proj=mode,
                                              dtype="float32")
    prompts = _prompts(jcfg.vocab_size)
    want = jax_paged_serve(jcfg, params, prompts, **PAGED)
    _, toks, cache = port_serve(tcfg, model, prompts, CacheConfig(**PAGED))
    np.testing.assert_array_equal(toks.numpy(), want)
    assert cache["seq_lens"].tolist() == (LENS + N_STEPS).tolist()
    # the port's own dense serve gives the same tokens
    _, dense_toks, _ = port_serve(tcfg, model, prompts)
    np.testing.assert_array_equal(toks.numpy(), dense_toks.numpy())


def test_paged_rows_land_at_their_table_slots():
    """Layer 0's committed rows, gathered through the table, equal the
    dense cache's rows (same inputs, same projections)."""
    cfg = get_smoke_config("qwen2_5_3b").replace(dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    _, _, paged = port_serve(cfg, model, prompts, CacheConfig(**PAGED))
    _, _, dense = port_serve(cfg, model, prompts)
    for name in ("k", "v"):
        rows = paged_gather(paged[f"{name}_pages"][0], paged["page_table"])
        for b, n in enumerate(LENS):
            torch.testing.assert_close(rows[b, :n], dense[name][0, b, :n],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [7, 8])
def test_chunked_prefill_matches_one_pass(chunk):
    cfg = get_smoke_config("qwen2_5_3b").replace(quant_proj="none",
                                                 dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(2)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 26)))
    lens = torch.tensor([26, 11, 19])
    results = []
    for c in (None, chunk):
        cache = init_cache(cfg, 3, 40, torch.float32,
                           CacheConfig(**PAGED), device="cpu")
        nl, cache = prefill(model, cache, prompts, lens, cfg, chunk=c)
        assert cache["seq_lens"].tolist() == lens.tolist()
        toks, _ = greedy_decode(model, cache, torch.argmax(nl, -1)[:, None],
                                None, 3, cfg)
        results.append((nl, toks))
    torch.testing.assert_close(results[1][0], results[0][0], atol=2e-4,
                               rtol=2e-4)
    torch.testing.assert_close(results[1][1], results[0][1], rtol=0, atol=0)


def test_serve_step_reads_seq_lens_and_needs_them():
    cfg = get_smoke_config("qwen2_5_3b").replace(dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = torch.from_numpy(_prompts(cfg.vocab_size))
    lens = torch.from_numpy(LENS)
    steps = []
    for pos in (None, lens):
        cache = init_cache(cfg, 3, MAX_LEN, torch.float32,
                           CacheConfig(**PAGED), device="cpu")
        _, cache = prefill(model, cache, prompts, lens, cfg)
        logits, cache = serve_step(model, cache, prompts[:, :1], pos, cfg)
        assert cache["seq_lens"].tolist() == (LENS + 1).tolist()
        steps.append(logits)
    torch.testing.assert_close(steps[0], steps[1], rtol=0, atol=0)
    dense = init_cache(cfg, 3, MAX_LEN, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="seq_lens"):
        serve_step(model, dense, prompts[:, :1], None, cfg)
    with pytest.raises(ValueError, match="seq_lens"):
        greedy_decode(model, dense, prompts[:, :1], None, 2, cfg)


def test_decode_past_capacity_raises():
    cfg = get_smoke_config("distilbert_paper").replace(dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = init_cache(cfg, 2, 8, torch.float32, CacheConfig(**PAGED),
                       device="cpu")
    prompts = torch.zeros((2, 6), dtype=torch.long)
    nl, cache = prefill(model, cache, prompts, torch.tensor([6, 6]), cfg)
    with pytest.raises(ValueError, match="capacity"):
        greedy_decode(model, cache, nl.argmax(-1)[:, None], None, 3, cfg)
    with pytest.raises(ValueError, match="capacity"):
        serve_step(model, cache, nl.argmax(-1)[:, None], 8, cfg)
    with pytest.raises(ValueError, match="capacity"):
        prefill(model, cache, torch.zeros((2, 12), dtype=torch.long),
                torch.tensor([12, 12]), cfg)


def test_paged_cache_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_smoke_config("distilbert_paper")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_cache(cfg, 2, 8, config=CacheConfig(**PAGED))
