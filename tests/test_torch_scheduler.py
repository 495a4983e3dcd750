"""Port's continuous-batching stack vs the JAX package on the same inputs:
the dynamic page allocator (free stack, refcounts, fork with copy-on-write),
the dynamic paged cache, suffix prefill onto a committed prefix, the
``paged_kv`` state handler and the ``Scheduler``.  Mirrors
``tests/test_serving.py``; the SSM and hybrid handlers' cases are in
``tests/test_torch_ssm.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import allocator as jal
from repro.serving.cache import CacheConfig as JaxCacheConfig
from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.engine import prefill as jax_prefill
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention.ops import paged_decode_attention
from repro_torch.models.transformer import init_model
from repro_torch.serving import allocator as al
from repro_torch.serving.cache import (CacheConfig, default_page_table,
                                       init_cache, page_nbytes)
from repro_torch.serving.engine import greedy_decode, prefill
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.state import (PagedKVHandler, SlotStateHandler,
                                       default_serving_config, state_handler)
from test_torch_bridge import paired_models, rel_err

RNG = np.random.default_rng(0)


def _dyn(batch=3, max_len=64, page=8, pool=None, kv_quant="none"):
    """The same dynamic paged cache from both packages."""
    tcfg = get_smoke_config("qwen2_5_3b")
    from repro.configs import get_smoke_config as jax_get_smoke_config
    jcfg = jax_get_smoke_config("qwen2_5_3b")
    kw = dict(layout="paged", page_size=page, alloc="dynamic",
              pool_pages=pool, kv_quant=kv_quant)
    return (init_cache(tcfg, batch, max_len, torch.float32, CacheConfig(**kw),
                       device="cpu"),
            jax_init_cache(jcfg, batch, max_len=max_len, dtype=jnp.float32,
                           config=JaxCacheConfig(**kw)))


def _assert_same(cache, jcache, keys=al.ALLOC_KEYS + ("page_table",
                                                      "seq_lens")):
    for key in keys:
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jcache[key]), err_msg=key)


def _flat_alloc(cache):
    top = int(cache["alloc_top"].sum())
    return (cache["alloc_ref"].reshape(-1).numpy(), top,
            cache["alloc_free"][0, :top].numpy())


def _check_invariants(cache, mirror):
    """Allocator state vs a host mirror {page: refcount}."""
    n = cache["alloc_ref"].numel()
    ref, top, free = _flat_alloc(cache)
    want = np.zeros(n, np.int32)
    want[al.SCRATCH_PAGE] = 1
    for p, c in mirror.items():
        want[p] += c
    np.testing.assert_array_equal(ref, want)
    assert len(set(free.tolist())) == top, "free stack holds duplicates"
    assert set(free.tolist()).isdisjoint(np.flatnonzero(ref).tolist())
    assert top + int((ref > 0).sum()) == n


def test_init_cache_dynamic_equals_jax():
    cache, jcache = _dyn(batch=2, max_len=40, page=16, pool=7)
    assert set(cache) == set(jcache)
    for key, val in cache.items():
        assert tuple(val.shape) == jcache[key].shape, key
        np.testing.assert_array_equal(val.numpy(), np.asarray(jcache[key]),
                                      err_msg=key)
    assert int(cache["page_table"].max()) == al.SCRATCH_PAGE
    int8, jint8 = _dyn(batch=2, max_len=40, page=16, pool=7,
                       kv_quant="int8")
    assert set(int8) == set(jint8) and int8["k_scales"].shape == (3, 7, 16, 2)
    from repro.serving.cache import page_nbytes as jax_page_nbytes
    for c, jc in ((cache, jcache), (int8, jint8)):
        assert page_nbytes(c) == jax_page_nbytes(jc)
    # int8 values and their f32 scale rows: 2·L·page·KH·(hd + 4) bytes
    assert page_nbytes(int8) == 2 * 3 * 16 * 2 * (16 + 4)
    # static tables cannot oversubscribe the pool; shards must divide it
    cfg = get_smoke_config("qwen2_5_3b")
    with pytest.raises(ValueError, match="dynamic"):
        init_cache(cfg, 2, 40, config=CacheConfig(
            layout="paged", page_size=16, pool_pages=3), device="cpu")
    assert al.init_allocator(8, shards=2)["free"].shape == (2, 4)
    with pytest.raises(ValueError, match="split"):
        al.init_allocator(8, shards=3)


@pytest.mark.parametrize("seed", range(6))
def test_allocator_sweep_equals_jax(seed):
    """Random admit/free/fork sequences, applied to both packages: the
    allocator state and tables equal after every operation, and the
    refcount / free-list invariants hold against a host mirror."""
    rng = np.random.default_rng(seed)
    batch, page, pool = 4, 8, 24
    cache, jcache = _dyn(batch=batch, page=page, pool=pool)
    live: dict[int, list[int]] = {}
    mirror: dict[int, int] = {}
    for _ in range(12):
        op = rng.integers(0, 3)
        free_slots = [b for b in range(batch) if b not in live]
        if op == 0 and free_slots:                  # admit
            b = int(rng.choice(free_slots))
            n_tok = int(rng.integers(1, 5 * page))
            cache, ok = al.admit_sequence(cache, b, n_tok)
            jcache, jok = jal.admit_sequence(jcache, b, n_tok)
            need = -(-n_tok // page)
            assert bool(ok) == bool(jok) == (need <= pool - 1 - len(mirror))
            if bool(ok):
                live[b] = cache["page_table"][b, :need].tolist()
                for p in live[b]:
                    mirror[p] = mirror.get(p, 0) + 1
        elif op == 1 and live:                      # free
            b = int(rng.choice(list(live)))
            cache = al.free_sequence(cache, b)
            jcache = jal.free_sequence(jcache, b)
            for p in live.pop(b):
                mirror[p] -= 1
                if mirror[p] == 0:
                    del mirror[p]
        elif op == 2 and live and free_slots:       # fork
            parent = int(rng.choice(list(live)))
            child = int(rng.choice(free_slots))
            prefix = int(rng.integers(1, len(live[parent]) * page + 1))
            total_tok = int(rng.integers(prefix, 6 * page))
            cache, ok = al.fork_sequence(cache, parent, child, prefix,
                                         total_tok)
            jcache, jok = jal.fork_sequence(jcache, parent, child, prefix,
                                            total_tok)
            assert bool(ok) == bool(jok)
            if bool(ok):
                total = -(-total_tok // page)
                row = cache["page_table"][child, :total].tolist()
                live[child] = row
                for p in row:
                    mirror[p] = mirror.get(p, 0) + 1
                full = prefix // page
                assert row[:full] == live[parent][:full]
        _assert_same(cache, jcache)
        _check_invariants(cache, mirror)


def test_allocator_admission_control():
    """A request the free list cannot cover is refused atomically."""
    cache, _ = _dyn(batch=3, page=8, pool=10)       # 9 usable pages
    assert al.pool_occupancy(cache) == (1, 10)      # the scratch page
    cache, ok = al.admit_sequence(cache, 0, 40)     # 5 pages
    assert bool(ok) and al.pool_occupancy(cache) == (6, 10)
    snap = {k: cache[k].clone() for k in al.ALLOC_KEYS + ("page_table",)}
    cache, ok = al.admit_sequence(cache, 1, 48)     # 6 pages > 4 free
    assert not bool(ok)
    for k, v in snap.items():
        assert torch.equal(cache[k], v), k
    cache, ok = al.admit_sequence(cache, 1, 30)     # 4 pages: exact fit
    assert bool(ok) and al.pool_occupancy(cache) == (10, 10)
    cache = al.free_sequence(cache, 0)
    cache, ok = al.admit_sequence(cache, 2, 40)
    assert bool(ok)


def test_refcount_shared_page_survives_parent_free():
    cache, _ = _dyn(batch=3, page=8, pool=16)
    cache, _ = al.admit_sequence(cache, 0, 24)          # 3 pages
    cache, ok = al.fork_sequence(cache, 0, 1, 16, 32)   # share 2 full pages
    assert bool(ok)
    shared = cache["page_table"][0, :2].clone()
    assert torch.equal(cache["page_table"][1, :2], shared)
    ref, _, _ = _flat_alloc(cache)
    assert all(int(ref[p]) == 2 for p in shared)
    cache = al.free_sequence(cache, 0)
    ref, _, free = _flat_alloc(cache)
    assert all(int(ref[p]) == 1 for p in shared)
    assert set(shared.tolist()).isdisjoint(free.tolist())
    cache = al.free_sequence(cache, 1)
    assert al.pool_occupancy(cache) == (1, 16)          # scratch only


def test_fork_copies_boundary_page_in_every_page_array():
    """The copy-on-write of the boundary page moves the int8 pools' scale
    rows with their values, as the JAX package's fork does."""
    cache, jcache = _dyn(batch=2, max_len=32, page=4, pool=20,
                         kv_quant="int8")
    cache, _ = al.admit_sequence(cache, 0, 14)
    jcache, _ = jal.admit_sequence(jcache, 0, 14)
    for key in al.PAGE_STATE_KEYS:
        vals = RNG.integers(-100, 100, cache[key].shape)
        cache[key] = torch.from_numpy(vals).to(cache[key].dtype)
        jcache[key] = jnp.asarray(cache[key].numpy())
    cache, ok = al.fork_sequence(cache, 0, 1, 10, 20)
    jcache, jok = jal.fork_sequence(jcache, 0, 1, 10, 20)
    assert bool(ok) and bool(jok)
    _assert_same(cache, jcache, al.ALLOC_KEYS + ("page_table", "seq_lens")
                 + al.PAGE_STATE_KEYS)
    boundary = int(cache["page_table"][1, 2])
    assert boundary != int(cache["page_table"][0, 2])
    for key in al.PAGE_STATE_KEYS:
        assert torch.equal(cache[key][:, boundary],
                           cache[key][:, int(cache["page_table"][0, 2])])


def _scatter(pool_shape, row, hist, page):
    kp = torch.zeros(pool_shape)
    for j in range(hist.shape[0] // page):
        kp[int(row[j])] = hist[j * page:(j + 1) * page]
    return kp


def test_dynamic_table_bitwise_matches_contiguous():
    """Decode through an allocator-churned table is bitwise the decode
    through a fresh contiguous table."""
    t, kh, d, page = 64, 2, 64, 8
    cache, _ = _dyn(batch=3, max_len=t, page=page, pool=3 * t // page + 1)
    cache, _ = al.admit_sequence(cache, 0, 24)
    cache, _ = al.admit_sequence(cache, 1, 40)
    cache = al.free_sequence(cache, 0)
    cache, _ = al.admit_sequence(cache, 2, t)
    row = cache["page_table"][2]
    assert sorted(row[:t // page].tolist()) != row[:t // page].tolist()
    hist_k = torch.from_numpy(RNG.normal(size=(t, kh, d)).astype(np.float32))
    hist_v = torch.from_numpy(RNG.normal(size=(t, kh, d)).astype(np.float32))
    q = torch.from_numpy(RNG.normal(size=(1, 1, 4, d)).astype(np.float32))
    pool_shape = (cache["k_pages"].shape[1], page, kh, d)
    outs = []
    for table in (row[None], default_page_table(1, t // page)):
        outs.append(paged_decode_attention(
            q, _scatter(pool_shape, table[0], hist_k, page),
            _scatter(pool_shape, table[0], hist_v, page), table.int(),
            torch.tensor([50], dtype=torch.int32)))
    assert torch.equal(outs[0], outs[1])


def test_prefix_shared_decode_bitwise_matches_disjoint():
    """Two sequences sharing a prefix's pages decode bitwise as with
    disjoint copies of them (``fork_sequence(copy=True)``)."""
    cfg = get_smoke_config("qwen2_5_3b").replace(quant_proj="none",
                                                 dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    handler = state_handler(cfg)
    page, prefix, total = 4, 10, 14
    prompt = torch.from_numpy(RNG.integers(0, cfg.vocab_size, total))
    prompt2 = torch.cat([prompt[:prefix], torch.from_numpy(
        RNG.integers(0, cfg.vocab_size, total - prefix))])
    outs = []
    for copy in (False, True):
        cache = init_cache(cfg, 2, 32, torch.float32, CacheConfig(
            layout="paged", page_size=page, alloc="dynamic", pool_pages=20),
            device="cpu")
        cache, ok = al.admit_sequence(cache, 0, total + 6)
        assert bool(ok)
        nl0, view = prefill(model, handler.slot_view(cache, 0),
                            prompt[None], torch.tensor([total]), cfg)
        handler.merge_slot(cache, view, 0)
        cache, ok = al.fork_sequence(cache, 0, 1, prefix, total + 6,
                                     copy=copy)
        assert bool(ok)
        rows = [set(cache["page_table"][b].tolist()) for b in (0, 1)]
        assert (rows[0] & rows[1] <= {al.SCRATCH_PAGE}) == copy
        nl1, view = prefill(model, handler.slot_view(cache, 1),
                            prompt2[None, prefix:], torch.tensor([total]),
                            cfg, start_pos=prefix)
        handler.merge_slot(cache, view, 1)
        first = torch.argmax(torch.cat([nl0, nl1]), -1)[:, None]
        toks, cache = greedy_decode(model, cache, first, None, 4, cfg)
        outs.append((toks, cache["k_pages"][0, cache["page_table"][1].long()]))
    assert torch.equal(outs[0][0], outs[1][0])          # tokens
    assert torch.equal(outs[0][1], outs[1][1])          # the child's KV


@pytest.mark.parametrize("chunk", [3, 4])
def test_chunked_suffix_prefill_equals_jax(chunk):
    """``prefill(chunk=, start_pos=)`` onto a committed prefix finds each
    sequence's last prompt token in its chunk (here rows of 21 and 15
    tokens over a 10-token prefix): first logits and committed pages as
    the JAX package's on the same weights (f32, rel-err 1e-5)."""
    jcfg, params, tcfg, model = paired_models("qwen2_5_3b",
                                              quant_proj="none",
                                              dtype="float32")
    prefix, lens = 10, np.array([21, 15], np.int32)
    prompts = RNG.integers(0, tcfg.vocab_size, (2, 21)).astype(np.int32)
    kw = dict(layout="paged", page_size=4, alloc="striped")
    cache = init_cache(tcfg, 2, 32, torch.float32, CacheConfig(**kw),
                       device="cpu")
    jcache = jax_init_cache(jcfg, 2, max_len=32, dtype=jnp.float32,
                            config=JaxCacheConfig(**kw))
    head, tail = prompts[:, :prefix], prompts[:, prefix:]
    _, cache = prefill(model, cache, torch.from_numpy(head),
                       torch.tensor([prefix] * 2), tcfg)
    nl, cache = prefill(model, cache, torch.from_numpy(tail),
                        torch.from_numpy(lens), tcfg, chunk=chunk,
                        start_pos=prefix)
    _, jcache = jax_prefill(params, jcache, jnp.asarray(head),
                            jnp.asarray([prefix] * 2), jcfg)
    jnl, jcache = jax_prefill(params, jcache, jnp.asarray(tail),
                              jnp.asarray(lens), jcfg, chunk=chunk,
                              start_pos=prefix)
    assert cache["seq_lens"].tolist() == lens.tolist()
    assert rel_err(nl.numpy(), jnl) <= 1e-5
    assert torch.argmax(nl, -1).tolist() == np.argmax(jnl, -1).tolist()
    assert rel_err(cache["k_pages"].numpy(), jcache["k_pages"]) <= 1e-5


def test_state_handler_registry_and_gate():
    cfg = get_smoke_config("qwen2_5_3b")
    handler = state_handler(cfg)
    assert isinstance(handler, PagedKVHandler) and handler.name == "paged_kv"
    assert default_serving_config(cfg) == CacheConfig(
        layout="paged", alloc="dynamic", page_size=16)
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    for config in (CacheConfig(layout="paged", alloc="striped"),
                   CacheConfig()):
        with pytest.raises(ValueError, match="dynamic"):
            Scheduler(model, cfg, config=config, device="cpu")
    assert type(state_handler(cfg.replace(family="ssm"))) is \
        SlotStateHandler
    cache, _ = _dyn(batch=3, page=8, pool=12)
    cache, _ = handler.admit(cache, 1, 20)
    cache["seq_lens"][:] = torch.tensor([5, 9, 4], dtype=torch.int32)
    handler.advance(cache, torch.tensor([False, True, False]))
    assert cache["seq_lens"].tolist() == [0, 9, 0]
    assert handler.occupancy(cache) == (4, 12, ((4, 12),))
    handler.free(cache, 1)
    assert cache["seq_lens"][1] == 0 and handler.occupancy(cache)[0] == 1
    assert int(cache["page_table"][1].max()) == al.SCRATCH_PAGE


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------
def _standalone(model, cfg, prompt, n_new):
    cache = init_cache(cfg, 1, 64, torch.float32, CacheConfig(
        layout="paged", page_size=4, alloc="striped"), device="cpu")
    nl, cache = prefill(model, cache, torch.from_numpy(prompt[None]),
                        torch.tensor([len(prompt)]), cfg)
    first = torch.argmax(nl, -1)[:, None]
    if n_new == 1:
        return first[0].numpy()
    out, _ = greedy_decode(model, cache, first, None, n_new - 1, cfg)
    return out[0].numpy()


@pytest.fixture(scope="module")
def smoke_model():
    cfg = get_smoke_config("qwen2_5_3b").replace(quant_proj="none",
                                                 dtype="float32")
    return cfg, init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")


def test_scheduler_matches_isolated_requests(smoke_model):
    """Mixed arrivals through the scheduler give each request exactly the
    tokens of its isolated prefill → greedy_decode, with a prefix-shared
    admission in the mix and pages recycling through the pool."""
    cfg, model = smoke_model
    rng = np.random.default_rng(3)
    base = rng.integers(0, cfg.vocab_size, 13)
    prompts = [rng.integers(0, cfg.vocab_size, 9), base.copy(),
               np.concatenate([base[:11], rng.integers(0, cfg.vocab_size, 4)]),
               rng.integers(0, cfg.vocab_size, 5)]
    budgets = [4, 5, 3, 4]
    sched = Scheduler(model, cfg, slots=3, max_len=64, bucket=4,
                      config=CacheConfig(layout="paged", alloc="dynamic",
                                         page_size=4, pool_pages=24),
                      device="cpu")
    rids = [sched.submit(prompts[0], budgets[0]),
            sched.submit(prompts[1], budgets[1])]
    sched.step()
    rids.append(sched.submit(prompts[2], budgets[2]))
    sched.step()
    # the third request forked the second's 11-token prefix
    assert int(sched.cache["alloc_ref"].max()) == 2
    rids.append(sched.submit(prompts[3], budgets[3]))
    out = sched.run(max_ticks=100)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(
            out[rid], _standalone(model, cfg, prompts[i], budgets[i]))
    occ = sched.pool_occupancy()
    assert (occ.used, occ.total) == (1, 24)
    assert sum(u for u, _ in occ.per_shard) == occ.used
    assert max(sched.occupancy_log) > 1


def test_scheduler_admission_waits_for_pages(smoke_model):
    cfg, model = smoke_model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(2)]
    sched = Scheduler(model, cfg, slots=2, max_len=32, bucket=4,
                      share_prefix=False,
                      config=CacheConfig(layout="paged", alloc="dynamic",
                                         page_size=4, pool_pages=5),
                      device="cpu")
    r0 = sched.submit(prompts[0], 3)     # needs 3 pages of the 4 usable
    r1 = sched.submit(prompts[1], 3)
    sched.step()
    assert sched.n_active == 1 and len(sched.queue) == 1
    out = sched.run(max_ticks=50)
    for rid, prompt in ((r0, prompts[0]), (r1, prompts[1])):
        np.testing.assert_array_equal(out[rid],
                                      _standalone(model, cfg, prompt, 3))


def test_scheduler_rejects_impossible_request(smoke_model):
    cfg, model = smoke_model
    sched = Scheduler(model, cfg, slots=2, max_len=32,
                      config=CacheConfig(layout="paged", alloc="dynamic",
                                         page_size=8), device="cpu")
    with pytest.raises(ValueError, match="pages"):
        sched.submit(np.arange(10), max_new_tokens=40)
    assert not sched.queue
    empty = Scheduler(model, cfg, slots=2, max_len=64, device="cpu",
                      config=CacheConfig(layout="paged", alloc="dynamic",
                                         page_size=8, pool_pages=3))
    empty.submit(np.arange(10), max_new_tokens=20)  # 4 pages > 2 usable
    with pytest.raises(RuntimeError, match="empty pool"):
        empty.step()


def _trace(vocab):
    """8 requests with a shared 10-token prefix among three, arriving over
    6 ticks, with EOS in reach."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, vocab, 10)
    reqs = []
    for i in range(8):
        if i % 3 == 1:
            prompt = np.concatenate([base, rng.integers(0, vocab, 2 + i)])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(3, 20)))
        reqs.append((prompt, int(rng.integers(2, 10))))
    return reqs, [0, 0, 1, 2, 2, 4, 5, 6]


def _drive(sched, reqs, arrivals):
    i = 0
    while i < len(reqs) or sched.queue or sched.n_active:
        while i < len(reqs) and arrivals[i] <= sched._ticks:
            sched.submit(*reqs[i])
            i += 1
        sched.step()
        assert sched._ticks < 200
    return sched


@pytest.mark.parametrize("quant_proj,kv_quant", [("none", "none"),
                                                 ("none", "int8"),
                                                 ("w8a8", "none")])
def test_scheduler_equals_jax_scheduler(quant_proj, kv_quant):
    """One trace through the JAX Scheduler and the port's, same weights:
    finished tokens, ticks, per-tick occupancy and pages_peak equal."""
    jcfg, params, tcfg, model = paired_models(
        "qwen2_5_3b", quant_proj=quant_proj, dtype="float32")
    reqs, arrivals = _trace(tcfg.vocab_size)
    kw = dict(layout="paged", alloc="dynamic", page_size=4, pool_pages=18,
              kv_quant=kv_quant)
    jax_s = _drive(JaxScheduler(params, jcfg, slots=3, max_len=48, bucket=8,
                                eos_id=7, config=JaxCacheConfig(**kw)),
                   [(p.astype(np.int32), n) for p, n in reqs], arrivals)
    port = _drive(Scheduler(model, tcfg, slots=3, max_len=48, bucket=8,
                            eos_id=7, config=CacheConfig(**kw),
                            device="cpu"), reqs, arrivals)
    assert port.finished.keys() == jax_s.finished.keys()
    for rid in jax_s.finished:
        np.testing.assert_array_equal(port.finished[rid],
                                      jax_s.finished[rid])
    assert port._ticks == jax_s._ticks
    assert port.occupancy_log == jax_s.occupancy_log
    assert max(port.occupancy_log) == max(jax_s.occupancy_log)   # pages_peak
    # the pool was oversubscribed: some request waited for pages
    assert any(log["admitted"] > log["submitted"]
               for log in port.request_log.values())
    assert port.request_log == jax_s.request_log


def test_scheduler_raises_without_a_card(smoke_model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg, model = smoke_model
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Scheduler(model, cfg)
