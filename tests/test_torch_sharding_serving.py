"""Mesh-sharded serving in the port against the JAX package, on the CPU.

  * ``CacheConfig``'s policy resolution, pool rounding and placements
    (``cache_shardings``) against the JAX package's.
  * The per-shard allocator at 1, 2 and 4 shards, bitwise against the JAX
    package's through the same admissions, forks and retirements
    (round-robin striping, global-min admission, atomic refusal, the flat
    free list at one shard).
  * The port's meshes, one process per rank over gloo
    (``launch.mesh.spawn_ranks``; the rank programs are in
    ``tests/_torch_mesh_ranks.py``): the JAX package's reference trace of
    ``test_sharded_serving_parity_and_partitioning`` on meshes 2
    (``heads``) and 4 (``pages``) gives the JAX unsharded Scheduler's
    greedy tokens, as do int8 pools with prefix sharing on mesh 4; under
    w8a8 every sharded projection is bitwise the unsharded port's; every
    rank emits the same tokens at every tick; ``spec=`` degrades.
  * The plain versions of K1's and K2's row-parallel modes: absmax, then
    quantize with the maximum, is bitwise ``quant_act``; int32 partials
    over K slices, summed, then the epilogue, are bitwise
    ``tiled_matmul_ref``.

Each spawning test passes its ranks a timeout of at most 120 s.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.transformer import init_model as jax_init_model
from repro.serving import allocator as jal
from repro.serving import cache as jcache
from repro.serving.cache import CacheConfig as JaxCacheConfig
from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core.qkv_fusion import apply_fused_qkv
from repro_torch.core.quantization import QTensor, quantize
from repro_torch.core.quantized_linear import (apply_linear_swiglu,
                                               apply_linears,
                                               quantize_weight)
from repro_torch.kernels.quant_act.ops import (quant_act, quant_act_glu,
                                               row_absmax)
from repro_torch.kernels.tiled_matmul.ops import (int8_epilogue,
                                                  tiled_matmul,
                                                  tiled_matmul_int32)
from repro_torch.launch.mesh import Mesh, spawn_ranks
from repro_torch.models.attention import _project_out
from repro_torch.serving import allocator as al
from repro_torch.serving.cache import (CacheConfig, cache_shardings,
                                       init_cache)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402

RANK_TIMEOUT = 120


class FakeMesh:
    """Duck-typed mesh (axis extents only)."""

    def __init__(self, **axes):
        self.shape = axes
        self.size = axes.get("model", 1)


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if hasattr(tree, "values") and hasattr(tree, "scale"):
        return {"values": np.asarray(tree.values),
                "scale": np.asarray(tree.scale), "bits": tree.bits}
    return np.asarray(tree)


def qwen(quant="none"):
    jcfg = jax_smoke_config("qwen2_5_3b").replace(quant_proj=quant,
                                                  dtype="float32")
    tcfg = get_smoke_config("qwen2_5_3b").replace(quant_proj=quant,
                                                  dtype="float32")
    params = jax_init_model(jax.random.PRNGKey(0),
                            jcfg.replace(quant_proj="none"))
    if quant != "none":
        from repro.core.quantize_params import quantize_model_params
        params = quantize_model_params(params)
    return jcfg, params, tcfg, numpy_tree(params)


# ---------------------------------------------------------------------------
# CacheConfig: policy, pool rounding, placements
# ---------------------------------------------------------------------------
POLICY_CASES = [(kh, m, shard) for kh in (1, 2, 8) for m in (1, 2, 4, 8)
                for shard in ("auto", "heads", "pages", "seq", "zigzag")]


@pytest.mark.parametrize("kh,m,shard", POLICY_CASES)
def test_policy_resolution_equals_the_jax_packages(kh, m, shard):
    def resolve(cls):
        c = cls(layout="paged", mesh=FakeMesh(model=m), kv_shard=shard)
        try:
            return c.resolved_kv_shard(kh), c.shards(kh), c.model_size()
        except ValueError as e:
            return type(e), str(e).split(" ")[0]
    assert resolve(CacheConfig) == resolve(JaxCacheConfig)


@pytest.mark.parametrize("pool,shards", [(13, 4), (24, 4), (24, 2),
                                         (10, 1), (17, 3)])
def test_pool_rounds_up_to_a_shard_multiple(pool, shards):
    cfg, jcfg = get_smoke_config("qwen2_5_3b"), jax_smoke_config("qwen2_5_3b")
    kw = dict(layout="paged", page_size=8, alloc="dynamic", pool_pages=pool,
              pool_shards=shards)
    got = init_cache(cfg, 2, 64, torch.float32, CacheConfig(**kw),
                     device="cpu")
    want = jax_init_cache(jcfg, 2, 64, config=JaxCacheConfig(**kw))
    for key in ("k_pages", "alloc_free", "alloc_top", "alloc_ref",
                "page_table"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("kv_shard", ["auto", "pages"])
def test_cache_shardings_equal_the_jax_packages(m, kv_quant, kv_shard):
    """The placement of every paged-cache array (global shapes) equals the
    JAX package's ``cache_logical_axes`` resolved under ``SERVING_RULES``,
    and each rank's slab divides exactly the dims placed on ``model``."""
    cfg, jcfg = get_smoke_config("qwen2_5_3b"), jax_smoke_config("qwen2_5_3b")
    kw = dict(layout="paged", page_size=4, alloc="dynamic", pool_pages=24,
              kv_quant=kv_quant, kv_shard=kv_shard)
    mesh = FakeMesh(model=m)
    jc = JaxCacheConfig(**kw, pool_shards=JaxCacheConfig(
        **kw, mesh=mesh).shards(cfg.n_kv_heads))
    jax_cache = jax_init_cache(jcfg, 3, 64, config=jc)
    shapes = {k: tuple(v.shape) for k, v in jax_cache.items()}
    got = cache_shardings(cfg, shapes, CacheConfig(**kw, mesh=mesh))
    want = jcache.tree_specs(jax_cache, JaxCacheConfig(
        **kw, mesh=mesh).logical_axes(jcfg), mesh, jcache.SERVING_RULES)
    assert got == {k: tuple(v) for k, v in want.items()}
    local = init_cache(cfg, 3, 64, torch.float32,
                       CacheConfig(**kw, mesh=mesh), device="cpu")
    for key, spec in got.items():
        glob = shapes[key]
        want_local = tuple(
            n // m if key in ("k_pages", "v_pages", "k_scales", "v_scales")
            and p == "model" else n for n, p in zip(glob, spec))
        assert tuple(local[key].shape) == want_local, key


def test_dense_cache_splits_by_heads_only():
    cfg = get_smoke_config("qwen2_5_3b")
    heads = init_cache(cfg, 2, 16, torch.float32,
                       CacheConfig(mesh=FakeMesh(model=2)), device="cpu")
    assert tuple(heads["k"].shape) == (cfg.n_layers, 2, 16, 1,
                                       cfg.head_dim)
    # 2 KV heads on 4 ranks: split by sequence, as the JAX package's kv_seq
    # places it; 18 positions round up to 20, 5 a rank
    mesh = FakeMesh(model=4)
    seq = init_cache(cfg, 2, 18, torch.float32, CacheConfig(mesh=mesh),
                     device="cpu")
    assert seq["kv_shard"] == "pages"
    assert tuple(seq["k"].shape) == (cfg.n_layers, 2, 5, 2, cfg.head_dim)
    jcfg = jax_smoke_config("qwen2_5_3b")
    jax_cache = jax_init_cache(jcfg, 2, 20)
    shapes = {k: tuple(v.shape) for k, v in jax_cache.items()}
    want = jcache.tree_specs(jax_cache, JaxCacheConfig(
        mesh=mesh).logical_axes(jcfg), mesh, jcache.SERVING_RULES)
    assert cache_shardings(cfg, shapes, CacheConfig(mesh=mesh)) == \
        {k: tuple(v) for k, v in want.items()}
    assert want["k"][2] == "model"
    # the slot state splits by SSM heads since the SSM mesh path landed
    # (tests/test_torch_ssm_mesh.py)
    ssm_cfg = get_smoke_config("mamba2_370m")
    slots = init_cache(ssm_cfg, 2, 16, torch.float32,
                       CacheConfig(mesh=FakeMesh(model=2)), device="cpu")
    k = ssm_cfg.ssm_conv - 1
    assert slots["kv_shard"] == "heads"
    assert tuple(slots["ssm_h"].shape) == (
        ssm_cfg.n_layers, 2, ssm_cfg.ssm_n_heads // 2, ssm_cfg.ssm_head_dim,
        ssm_cfg.ssm_state)
    assert tuple(slots["conv_x"].shape) == (ssm_cfg.n_layers, 2, k,
                                            ssm_cfg.d_inner // 2)
    assert tuple(slots["conv_B"].shape) == (ssm_cfg.n_layers, 2, k,
                                            ssm_cfg.ssm_state)


@pytest.mark.parametrize("m,policy", [(2, "heads"), (4, "pages")])
def test_the_cache_carries_its_policy_and_a_mismatch_raises(m, policy):
    """A cache built under a mesh records its resolved policy
    (``kv_shard``), which the forward, the allocator and
    ``validate_decode_cache`` read; an unsharded model given a rank's slab,
    or a rank's model given a whole cache, raises instead of reading one as
    the other."""
    from repro_torch.bridge import shard_model
    from repro_torch.models.transformer import apply_model, init_model
    from repro_torch.serving.engine import validate_decode_cache
    cfg = get_smoke_config("qwen2_5_3b").replace(dtype="float32")
    kw = dict(layout="paged", alloc="dynamic", page_size=4, pool_pages=24)
    mesh = Mesh(m, 0, device="cpu")
    slab = init_cache(cfg, 2, 16, torch.float32,
                      CacheConfig(mesh=mesh, **kw), device="cpu")
    whole = init_cache(cfg, 2, 16, torch.float32, CacheConfig(**kw),
                       device="cpu")
    assert slab["kv_shard"] == policy and "kv_shard" not in whole
    validate_decode_cache(slab, cfg, mesh)
    if policy == "heads":
        with pytest.raises(ValueError, match="without the model's mesh"):
            validate_decode_cache(slab, cfg)
    tokens = torch.zeros((2, 1), dtype=torch.long)
    pos = torch.zeros((2,), dtype=torch.int32)
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match=r"CacheConfig\(mesh=\)"):
        apply_model(model, tokens, cfg, cache=slab, cache_pos=pos)
    shard_model(model, mesh)
    with pytest.raises(ValueError, match=r"CacheConfig\(mesh=\)"):
        apply_model(model, tokens, cfg, cache=whole, cache_pos=pos)


# ---------------------------------------------------------------------------
# the per-shard allocator, bitwise against the JAX package's
# ---------------------------------------------------------------------------
def _pair(pool=16, shards=4, batch=3, page=8):
    cfg, jcfg = get_smoke_config("qwen2_5_3b"), jax_smoke_config("qwen2_5_3b")
    kw = dict(layout="paged", page_size=page, alloc="dynamic",
              pool_pages=pool, pool_shards=shards)
    return (init_cache(cfg, batch, page * pool, torch.float32,
                       CacheConfig(**kw), device="cpu"),
            jax_init_cache(jcfg, batch, page * pool,
                           config=JaxCacheConfig(**kw)))


def _same(cache, jc):
    for key in al.ALLOC_KEYS + ("page_table", "seq_lens"):
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jc[key]), err_msg=key)
    assert al.pool_occupancy(cache) == jal.pool_occupancy(jc)
    assert al.shard_occupancy(cache) == jal.shard_occupancy(jc)


# (op, args): admissions of pages*page tokens, retirements, forks
ALLOC_SCRIPTS = {
    "round robin and retire": [("admit", 0, 8), ("admit", 1, 4),
                               ("free", 0), ("admit", 2, 3), ("free", 1),
                               ("free", 2)],
    "global-min refusal": [("admit", 0, 8), ("admit", 1, 5), ("admit", 1, 4),
                           ("free", 0), ("free", 1)],
    "fork and copy": [("admit", 0, 5), ("fork", 0, 1, 13, 6),
                      ("fork", 1, 2, 8, 3), ("free", 0), ("free", 1),
                      ("free", 2)],
    "full pool": [("admit", 0, 6), ("admit", 1, 6), ("admit", 2, 6),
                  ("free", 1), ("admit", 1, 2)],
}


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("script", list(ALLOC_SCRIPTS))
def test_allocator_is_bitwise_the_jax_packages(shards, script):
    cache, jc = _pair(shards=shards)
    page = 8
    for op, *args in ALLOC_SCRIPTS[script]:
        if op == "admit":
            slot, pages = args
            cache, ok = al.admit_sequence(cache, slot, pages * page)
            jc, jok = jal.admit_sequence(jc, slot, pages * page)
            assert bool(ok) == bool(jok)
        elif op == "free":
            cache = al.free_sequence(cache, args[0])
            jc = jal.free_sequence(jc, args[0])
        else:
            parent, child, prefix, pages = args
            cache["seq_lens"][parent] = prefix
            jc["seq_lens"] = jc["seq_lens"].at[parent].set(prefix)
            cache, ok = al.fork_sequence(cache, parent, child, prefix,
                                         pages * page)
            jc, jok = jal.fork_sequence(jc, parent, child, prefix,
                                        pages * page)
            assert bool(ok) == bool(jok)
        _same(cache, jc)


def test_round_robin_and_global_min_admission():
    """The JAX package's own cases: page j from shard j mod 4; 7 pages free
    but a 5-page request refused (shard 0 holds 1), atomically; then 4
    pages (1 a shard) admitted; retiring both restores the fresh stacks."""
    cache, _ = _pair()
    cache, ok = al.admit_sequence(cache, 0, 8 * 8)
    assert bool(ok)
    row = cache["page_table"][0].numpy()[:8]
    np.testing.assert_array_equal(row // 4, np.arange(8) % 4)
    np.testing.assert_array_equal(cache["alloc_top"].numpy(), [1, 2, 2, 2])
    assert al.pool_occupancy(cache) == (9, 16)
    snap = {k: cache[k].clone() for k in al.ALLOC_KEYS}
    assert not bool(al.can_admit(al.allocator_state(cache), 5))
    cache, ok = al.admit_sequence(cache, 1, 5 * 8)
    assert not bool(ok)
    for k in al.ALLOC_KEYS:
        assert torch.equal(cache[k], snap[k])
    cache, ok = al.admit_sequence(cache, 1, 4 * 8)
    assert bool(ok)
    assert al.shard_occupancy(cache) == ((4, 4), (3, 4), (3, 4), (3, 4))
    cache = al.free_sequence(al.free_sequence(cache, 0), 1)
    np.testing.assert_array_equal(cache["alloc_top"].numpy(), [3, 4, 4, 4])
    assert al.pool_occupancy(cache) == (1, 16)


def test_one_shard_is_the_flat_free_list():
    flat = al.init_allocator(10, shards=1)
    np.testing.assert_array_equal(flat["free"][0, :9].numpy(),
                                  np.arange(1, 10))
    _, row, ok = al.alloc_pages(flat, 3, 6)
    assert bool(ok)
    np.testing.assert_array_equal(row.numpy(), [9, 8, 7, 0, 0, 0])
    with pytest.raises(ValueError):
        al.init_allocator(10, shards=3)


# ---------------------------------------------------------------------------
# the meshes: one process per rank
# ---------------------------------------------------------------------------
def test_mesh_collectives_and_failures():
    out = spawn_ranks(ranks.collectives, 4, backend="gloo", device="cpu",
                      timeout=RANK_TIMEOUT)
    x = [np.arange(4, dtype=np.float32) + 10 * r for r in range(4)]
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["psum"], sum(x))
        np.testing.assert_array_equal(o["psum_int"], [10])
        np.testing.assert_array_equal(o["pmax"], -x[0])
        np.testing.assert_array_equal(o["gather"][0], np.concatenate(x))
        assert o["bounds"] == (2 * r, 2 * r + 2)
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(ranks.fails, 2, backend="gloo", device="cpu",
                    timeout=RANK_TIMEOUT)
    with pytest.raises(TimeoutError):
        spawn_ranks(ranks.stalls, 2, backend="gloo", device="cpu",
                    timeout=10)
    with pytest.raises(ValueError, match="backend"):
        Mesh(2, 0, backend="mpi")


def _reference_trace(cfg):
    """The JAX package's ``test_sharded_serving_parity_and_partitioning``
    trace: (tick, prompt, budget)."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, cfg.vocab_size, 13)
    prompts = [rng.integers(0, cfg.vocab_size, 9), base.copy(),
               np.concatenate([base[:11], rng.integers(0, cfg.vocab_size,
                                                       4)]),
               rng.integers(0, cfg.vocab_size, 5)]
    return list(zip((0, 0, 1, 2), prompts, (4, 5, 3, 4)))


def _jax_tokens(jcfg, params, trace, **cache_kw):
    sched = JaxScheduler(params, jcfg, slots=3, max_len=64, bucket=4,
                         config=JaxCacheConfig(layout="paged",
                                               alloc="dynamic", **cache_kw))
    rids, tick = [], 0
    pending = list(trace)
    while pending or sched.queue or sched.n_active:
        while pending and pending[0][0] <= tick:
            _, prompt, budget = pending.pop(0)
            rids.append(sched.submit(prompt, budget))
        sched.step()
        tick += 1
    return [np.asarray(sched.finished[r]) for r in rids]


@pytest.mark.parametrize("m", [2, 4])
def test_reference_trace_gives_the_jax_unsharded_tokens(m):
    """Meshes 2 (heads) and 4 (pages): the JAX unsharded Scheduler's greedy
    tokens; every rank emits the same tokens at every tick; the slabs are
    the rank's part (heads: K/2 heads of every page, a flat free list;
    pages: P/4 pages of every head, four free lists)."""
    jcfg, params, cfg, tree = qwen()
    trace = _reference_trace(cfg)
    cache_kw = dict(page_size=4, pool_pages=24)
    want = _jax_tokens(jcfg, params, trace, **cache_kw)
    out = spawn_ranks(ranks.sched_trace, m, backend="gloo", device="cpu",
                      args=(tree, cfg, trace,
                            dict(layout="paged", alloc="dynamic",
                                 **cache_kw),
                            dict(slots=3, max_len=64, bucket=4)),
                      timeout=RANK_TIMEOUT)
    for got in out:
        assert got["policy"] == got["kv_shard"] == {2: "heads",
                                                     4: "pages"}[m]
        for a, b in zip(got["tokens"], want):
            np.testing.assert_array_equal(a, b)
        assert got["ticks"] == out[0]["ticks"]
        assert got["per_shard"] == out[0]["per_shard"]
    shapes = out[0]["shapes"]
    pool = (cfg.n_layers, 24, 4, cfg.n_kv_heads, cfg.head_dim)
    if m == 2:
        assert shapes["k_pages"] == pool[:3] + (1, cfg.head_dim)
        assert shapes["alloc_free"] == (1, 24)
    else:
        assert shapes["k_pages"] == (pool[0], 6) + pool[2:]
        assert shapes["alloc_free"] == (4, 6)
        assert len(out[0]["per_shard"][0]) == 4


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_prefix_sharing_and_int8_pools_on_mesh_4(kv_quant):
    """The JAX package's ``test_sharded_prefix_sharing_and_int8``: shared
    prefixes (a fork copies its boundary page between ranks) and int8
    pools decode the JAX unsharded tokens on a 4-way pages split."""
    jcfg, params, cfg, tree = qwen()
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    prompts = [base, np.concatenate([base[:6], [1, 2, 3]]).astype(np.int32),
               rng.integers(0, cfg.vocab_size, 5).astype(np.int32)]
    trace = [(0, p, 4) for p in prompts]
    cache_kw = dict(page_size=4, pool_pages=16, kv_quant=kv_quant)
    sched = JaxScheduler(params, jcfg, slots=2, max_len=32, bucket=4,
                         config=JaxCacheConfig(layout="paged",
                                               alloc="dynamic", **cache_kw))
    for p in prompts:
        sched.submit(p, 4)
    want = sched.run(max_ticks=64)
    out = spawn_ranks(ranks.sched_trace, 4, backend="gloo", device="cpu",
                      args=(tree, cfg, trace,
                            dict(layout="paged", alloc="dynamic",
                                 **cache_kw),
                            dict(slots=2, max_len=32, bucket=4)),
                      timeout=RANK_TIMEOUT)
    for got in out:
        for rid, toks in enumerate(got["tokens"]):
            np.testing.assert_array_equal(toks, np.asarray(want[rid]))
        assert got["ticks"] == out[0]["ticks"]


def test_w8a8_projections_are_bitwise_the_unsharded_ports():
    """Under w8a8 on mesh 2: q, k, v, gate and up gathered, wo and down
    after their reduction, each bitwise the unsharded port's on the same
    inputs (wo and down through K1's absmax modes, K2's int32 partials and
    its epilogue); and the greedy tokens of a spec= run, which degrades to
    1-token decode, are the unsharded port's."""
    _, _, cfg, tree = qwen("w8a8")
    g = np.random.default_rng(11)
    x = g.standard_normal((5, cfg.d_model)).astype(np.float32)
    o_in = g.standard_normal((5, cfg.q_dim)).astype(np.float32)
    out = spawn_ranks(ranks.layer_projections, 2, backend="gloo",
                      device="cpu", args=(tree, cfg, x, o_in),
                      timeout=RANK_TIMEOUT)
    model = params_from_numpy(tree, cfg, device="cpu")
    attn, ffn = model.layers[0].attn, model.layers[0].ffn
    xt, ot = torch.from_numpy(x), torch.from_numpy(o_in)
    with torch.inference_mode():
        q, k, v = apply_fused_qkv(attn.wq, attn.wk, attn.wv, xt,
                                  mode="w8a8")
        gate, up = apply_linears((ffn.gate, ffn.up), xt, mode="w8a8")
        want = {"q": q, "k": k, "v": v, "wo": _project_out(attn, ot, cfg),
                "gate": gate, "up": up,
                "down": apply_linear_swiglu(ffn.down, gate, up,
                                            mode="w8a8")}
    for got, kinds in out:
        assert kinds == {"wq": "column", "wo": "row", "down": "row"}
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w.numpy(),
                                          err_msg=name)
    trace = _reference_trace(cfg)
    cache_kw = dict(layout="paged", alloc="dynamic", page_size=4,
                    pool_pages=24)
    sched_kw = dict(slots=3, max_len=64, bucket=4)
    one, two = (spawn_ranks(ranks.sched_trace, m, backend="gloo",
                            device="cpu",
                            args=(tree, cfg, trace, cache_kw, sched_kw, 1),
                            timeout=RANK_TIMEOUT) for m in (1, 2))
    assert one[0]["spec"] and not any(r["spec"] for r in two)
    assert all(any("degrading to 1-token decode" in w for w in r["warnings"])
               for r in two)
    # spec decode and plain decode give the same greedy tokens on the CPU
    for a, b in zip(two[0]["tokens"], one[0]["tokens"]):
        np.testing.assert_array_equal(a, b)


def test_shard_model_refuses_what_the_mesh_does_not_serve():
    """Every family shards now (MoE, SSM and hybrid in
    tests/test_torch_moe_mesh.py and tests/test_torch_ssm_mesh.py, the
    encoder-decoder in tests/test_torch_encdec_mesh.py): seamless's encoder
    layers and its decoder's cross projections slice by the decoder
    blocks' rules."""
    from repro_torch.bridge import shard_model
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config("seamless_m4t_medium")
    whole = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    for r in range(2):
        model = shard_model(init_model(torch.Generator().manual_seed(0), cfg,
                                       device="cpu"),
                            Mesh(2, r, device="cpu"))
        cols = slice(r * cfg.q_dim // 2, (r + 1) * cfg.q_dim // 2)
        for got, ref in ((model.encoder.layers[1].attn,
                          whole.encoder.layers[1].attn),
                         (model.layers[1].cross, whole.layers[1].cross)):
            for name in ("wq", "wk", "wv"):
                assert getattr(got, name).shard == "column"
                assert torch.equal(getattr(got, name).w,
                                   getattr(ref, name).w[:, cols])
            assert got.wo.shard == "row"
            assert torch.equal(got.wo.w, ref.wo.w[cols])
            assert got.mesh is model.mesh
        assert model.encoder.layers[0].ffn.down.shard == "row"
        assert torch.equal(model.encoder.final_norm.w,
                           whole.encoder.final_norm.w)


# ---------------------------------------------------------------------------
# the plain versions of K1's and K2's row-parallel modes
# ---------------------------------------------------------------------------
def _parts(x, n):
    k = x.shape[1] // n
    return [x[:, i * k:(i + 1) * k].contiguous() for i in range(n)]


@pytest.mark.parametrize("glu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", [((4, 96), 4), ((7, 64), 2),
                                     ((3, 40), 4)])
def test_k1_modes_rebuild_the_whole_rows_quantization(shape, n, dtype, glu):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(shape, generator=g) * 3).to(dtype)
    x[0] = 0
    up = torch.randn(shape, generator=g).to(dtype) if glu else None
    whole = quant_act_glu(x, up) if glu else quant_act(x)
    xs, ups = _parts(x, n), (_parts(up, n) if glu else [None] * n)
    absmax = torch.stack([row_absmax(a, u) for a, u in zip(xs, ups)]).amax(0)
    for i, (a, u) in enumerate(zip(xs, ups)):
        got = (quant_act_glu(a, u, absmax=absmax) if glu
               else quant_act(a, absmax=absmax))
        k = a.shape[1]
        assert torch.equal(got.values, whole.values[:, i * k:(i + 1) * k])
        assert torch.equal(got.scale, whole.scale)


@pytest.mark.parametrize("m,k,n,parts", [(4, 96, 48, 4), (9, 64, 40, 2),
                                         (1, 128, 8, 4)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k2_modes_rebuild_the_whole_product(m, k, n, parts, out_dtype):
    g = torch.Generator().manual_seed(2)
    a = quantize(torch.randn((m, k), generator=g), channel_axes=(0,))
    b = quantize_weight(torch.randn((k, n), generator=g) * 0.05)
    bias = torch.randn((n,), generator=g)
    step = k // parts
    acc = sum(tiled_matmul_int32(
        QTensor(a.values[:, i * step:(i + 1) * step], a.scale, 8),
        QTensor(b.values[i * step:(i + 1) * step], b.scale, 8))
        for i in range(parts))
    assert acc.dtype == torch.int32
    assert torch.equal(int8_epilogue(acc, a.scale, b, bias,
                                     out_dtype=out_dtype),
                       tiled_matmul(a, b, bias, out_dtype=out_dtype))
