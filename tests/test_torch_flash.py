"""Port's long-prompt path vs the JAX package on the same inputs: the
schedule of the block-sparse flash kernel K5, its plain version behind the
``flash_attention`` wrapper (against JAX's Pallas kernel in interpret mode
and its oracle), the plain blockwise attention, the cache-less
``apply_model`` at ``s >= blockwise_attn_threshold`` and ``prefill_step``.

Inputs are drawn with numpy from fixed seeds and given to both packages.
Tolerances (each test names its own):
  * f32 attention: atol 5e-6 / rtol 1e-5, the JAX package's own limit
    between its kernel and its oracle (``tests/test_flash_attention.py``);
  * bf16 attention: rel-err (max |port - jax| / max |jax|) 1e-2: both round
    p / l to bf16 and sum in f32, in different orders, so an output may
    land one bf16 ulp (2^-8 relative) apart;
  * logits, ``none`` and ``w8``: rel-err 1e-5, as ``test_torch_model.py``;
  * logits, ``w8a8``: closer to JAX's w8a8 logits than to JAX's w8 ones
    (so the activations were quantized), and the same argmax at >= 0.98
    of the positions.  No rel-err limit tells the two apart here: one ulp
    of difference entering ``quant_act`` can flip one int8 rounding, which
    moves its row by a quantum (1/127 of the row's absmax) and every later
    row of the sequence through attention.  On 2 x 80-token prompts such
    flips happen on the dense path as on the blockwise one, and the rel-err
    they leave is of the size of the w8a8 - w8 gap itself
    (``PYTHONPATH=src python tests/test_torch_flash.py`` prints both over
    8 prompt seeds); ``none``
    and ``w8`` hold the blockwise math itself to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_schedule as jax_flash_schedule
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref
from repro.models.attention import _attend_blockwise as jax_attend_blockwise
from repro.models.transformer import apply_model as jax_apply_model
from repro.serving.engine import prefill_step as jax_prefill_step
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention.kernel import (KERNEL_KV_TILE,
                                                        KERNEL_Q_TILE,
                                                        flash_schedule)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention as port_attention
from repro_torch.models.attention import _attend_blockwise
from repro_torch.models.transformer import apply_model, init_model
from repro_torch.serving.engine import prefill_step
from test_torch_bridge import paired_models, rel_err

ATOL, RTOL = 5e-6, 1e-5
BF16_REL = 1e-2
TOL = {"none": 1e-5, "w8": 1e-5}
ARGMAX_W8A8 = 0.98
# tokens per prompt in the model tests: past the smoke configs' threshold
# (64), not a multiple of their KV chunk (32), longer than gemma2's window
PROMPT = 80

SCHED_FIELDS = ("s_len", "t_len", "q_chunk", "kv_chunk", "num_q_blocks",
                "num_kv_blocks", "max_kv_steps", "blocks_touched",
                "blocks_dense")


def _same_schedule(s, t, **kw):
    ours, ref = flash_schedule(s, t, **kw), jax_flash_schedule(s, t, **kw)
    for field in SCHED_FIELDS:
        assert getattr(ours, field) == getattr(ref, field), field
    return ours


# ---------------------------------------------------------------------------
# Schedule: exact counters, equal to the JAX package's
# ---------------------------------------------------------------------------
# the cases of tests/test_flash_attention.py's schedule tests, with their
# pinned values
@pytest.mark.parametrize("s,t,qc,kc,causal,window,touched,dense,steps", [
    (512, 512, 128, 128, True, None, 10, 16, 4),
    (1024, 1024, 128, 128, True, 128, 15, 64, 2),
    (1024, 1024, 128, 64, True, 256, None, 128, 6),
    (512, 512, 64, 64, False, 64, 43, 64, 8),
    (512, 512, 64, 64, False, None, 64, 64, 8),
    (300, 300, 128, 128, True, None, 6, 9, 3),
])
def test_schedule_pinned_counters(s, t, qc, kc, causal, window, touched,
                                  dense, steps):
    sc = _same_schedule(s, t, q_chunk=qc, kv_chunk=kc, causal=causal,
                        window=window)
    if touched is not None:
        assert sc.blocks_touched == touched
    assert sc.blocks_touched <= sc.blocks_dense == dense
    assert sc.max_kv_steps == steps


@pytest.mark.parametrize("s,t", [(300, 300), (256, 200), (64, 300),
                                 (8192, 8192)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 1),
                                           (True, 100), (False, None),
                                           (False, 64)])
@pytest.mark.parametrize("chunks", [(KERNEL_Q_TILE, KERNEL_KV_TILE),
                                    (128, 32), (2048, 1024)])
def test_schedule_sweep_equals_jax(s, t, causal, window, chunks):
    _same_schedule(s, t, q_chunk=chunks[0], kv_chunk=chunks[1],
                   causal=causal, window=window)


def test_kernel_tiles_skip_masked_blocks():
    """At the served shape the kernel's walk streams half the blocks of a
    causal sweep plus the diagonal, and a 4096 window fewer still."""
    causal = flash_schedule(8192, 8192, q_chunk=KERNEL_Q_TILE,
                            kv_chunk=KERNEL_KV_TILE)
    local = flash_schedule(8192, 8192, q_chunk=KERNEL_Q_TILE,
                           kv_chunk=KERNEL_KV_TILE, window=4096)
    assert causal.blocks_dense == 128 * 128
    assert causal.blocks_touched == 128 * 129 // 2
    assert local.blocks_touched < causal.blocks_touched
    assert local.max_kv_steps == 4096 // KERNEL_KV_TILE + 1


# ---------------------------------------------------------------------------
# flash_attention on the CPU (the plain version of K5) vs JAX
# ---------------------------------------------------------------------------
# (b, s, t, h, kh, d, causal, softcap, window): g = h // kh in {1, 2, 4}
FLASH_CASES = {
    "gqa2_causal": (2, 128, 128, 4, 2, 64, True, None, None),
    "mha_noncausal": (1, 256, 256, 2, 2, 64, False, None, None),
    "mqa_softcap": (2, 128, 128, 4, 1, 64, True, 30.0, None),
    "window": (1, 256, 256, 4, 2, 64, True, None, 64),
    "partial": (1, 300, 300, 4, 4, 64, True, None, None),
    "window_softcap_partial": (1, 200, 200, 4, 1, 64, True, 30.0, 64),
    "noncausal_window": (1, 160, 160, 4, 2, 32, False, None, 48),
    "s_ne_t": (1, 100, 200, 4, 4, 16, False, 50.0, None),
}


def _flash_inputs(b, s, t, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, t, kh, d)).astype(np.float32),
            rng.normal(size=(b, t, kh, d)).astype(np.float32))


@pytest.mark.parametrize("jax_mode", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_cpu_matches_jax_f32(case, jax_mode):
    b, s, t, h, kh, d, causal, cap, win = FLASH_CASES[case]
    q, k, v = _flash_inputs(b, s, t, h, kh, d, seed=len(case))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          softcap=cap, window=win)
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                               softcap=cap, window=win, mode=jax_mode,
                               q_chunk=64, kv_chunk=64)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("jax_mode", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("case", ["gqa2_causal", "mqa_softcap",
                                  "window_softcap_partial"])
def test_flash_attention_cpu_matches_jax_bf16(case, jax_mode):
    b, s, t, h, kh, d, causal, cap, win = FLASH_CASES[case]
    q, k, v = (x.astype(jnp.bfloat16)
               for x in _flash_inputs(b, s, t, h, kh, d, seed=1))
    got = flash_attention(*(torch.from_numpy(np.asarray(x, np.float32))
                            .to(torch.bfloat16) for x in (q, k, v)),
                          causal=causal, softcap=cap, window=win)
    want = jax_flash_attention(q, k, v, causal=causal, softcap=cap,
                               window=win, mode=jax_mode, q_chunk=64,
                               kv_chunk=64)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) \
        <= BF16_REL


@pytest.mark.parametrize("case", ["gqa2_causal", "window_softcap_partial",
                                  "noncausal_window", "s_ne_t"])
def test_attention_ref_matches_jax_oracle(case):
    """The plain version itself, in the wrapper's layout, against the JAX
    package's oracle in its (B, H, S, D) one."""
    b, s, t, h, kh, d, causal, cap, win = FLASH_CASES[case]
    q, k, v = _flash_inputs(b, s, t, h, kh, d, seed=7)
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        softcap=cap, window=win)
    want = jax_attention_ref(*(jnp.asarray(x).transpose(0, 2, 1, 3)
                               for x in (q, k, v)), scale=d ** -0.5,
                             causal=causal, softcap=cap, window=win)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 2, 1, 3),
                               atol=ATOL, rtol=RTOL)


def test_flash_attention_cpu_counts_no_launch():
    reset_launch_counts()
    q, k, v = map(torch.from_numpy, _flash_inputs(1, 40, 40, 2, 1, 16, 4))
    flash_attention(q, k, v)
    assert launch_counts()["flash_attention"] == 0


def test_flash_attention_rejects_bad_arguments():
    q, k, v = map(torch.from_numpy, _flash_inputs(1, 8, 8, 3, 2, 16, 5))
    with pytest.raises(ValueError):                     # 3 heads over 2
        flash_attention(q, k, v)
    q, k, v = map(torch.from_numpy, _flash_inputs(1, 8, 8, 4, 2, 16, 5))
    with pytest.raises(ValueError):
        flash_attention(q, k, v[:, :4])
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, softcap=0.0)


def test_fully_masked_rows_give_zero():
    """Non-causal with a window: rows see keys t > s - window only, and a
    key range that ends before that leaves rows with nothing visible."""
    q, k, v = map(torch.from_numpy, _flash_inputs(1, 64, 16, 2, 2, 16, 6))
    out = flash_attention(q, k, v, causal=False, window=8)
    want = jax_flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                               causal=False, window=8, mode="ref")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert torch.count_nonzero(out[:, 24:]) == 0       # s - 8 >= 16 - 1


# ---------------------------------------------------------------------------
# _attend_blockwise (attn_impl="jnp") vs JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,qc,kc", [(80, 2048, 32), (100, 48, 32),
                                     (64, 64, 64)])
@pytest.mark.parametrize("causal,window,is_local,cap", [
    (True, None, False, None), (True, 16, True, 50.0),
    (True, 16, False, None), (False, 24, True, None)])
def test_attend_blockwise_matches_jax(s, qc, kc, causal, window, is_local,
                                      cap):
    rng = np.random.default_rng(s + qc)
    b, kh, g, hd = 2, 2, 2, 16
    q = rng.normal(size=(b, s, kh, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, hd)).astype(np.float32)
    kw = dict(scale=hd ** -0.5, cap=cap, causal=causal, window=window,
              is_local=is_local, q_chunk=qc, kv_chunk=kc)
    got = _attend_blockwise(*map(torch.from_numpy, (q, k, v)), 0, **kw)
    want = jax_attend_blockwise(*map(jnp.asarray, (q, k, v)), 0, **kw)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_attend_blockwise_runs_on_the_cpu_only():
    """``attn_impl="jnp"`` never takes a card's long prompt past K5."""
    q = torch.zeros((1, 8, 2, 2, 16), device="meta")
    k = v = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CPU only"):
        _attend_blockwise(q, k, v, 0, scale=0.25, cap=None, causal=True,
                          window=None, is_local=False, q_chunk=4, kv_chunk=4)


# ---------------------------------------------------------------------------
# The cache-less model and prefill_step at s >= blockwise_attn_threshold
# ---------------------------------------------------------------------------
def _tokens(vocab, seed=12):
    return np.random.default_rng(seed).integers(
        0, vocab, (2, PROMPT)).astype(np.int32)


def _holds(got, ref, mode, w8_logits):
    """The port's logits against JAX's (``ref``) in ``mode``; for w8a8,
    ``w8_logits`` are JAX's logits of the same weights in w8."""
    if mode != "w8a8":
        assert rel_err(got, ref) <= TOL[mode]
        return
    assert rel_err(got, ref) < rel_err(got, w8_logits)
    agree = (np.asarray(got).argmax(-1) == np.asarray(ref).argmax(-1)).mean()
    assert agree >= ARGMAX_W8A8, agree


def _jax_w8(fn, jcfg, mode):
    """JAX's logits of the same int8 weights without activation
    quantization, for a w8a8 case; else None."""
    return fn(jcfg.replace(quant_proj="w8")) if mode == "w8a8" else None


# gemma2: window 16 on the local layers, attention and final softcaps;
# chatglm3: partial rope; qwen2.5: GQA with QKV bias
@pytest.mark.parametrize("impl", ["flash", "jnp"])
@pytest.mark.parametrize("mode", ["none", "w8", "w8a8"])
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "gemma2_27b", "chatglm3_6b"])
def test_long_no_cache_forward_matches_jax(arch, mode, impl):
    jcfg, params, tcfg, model = paired_models(arch, quant_proj=mode,
                                              dtype="float32",
                                              attn_impl=impl)
    assert PROMPT >= tcfg.blockwise_attn_threshold
    toks = _tokens(jcfg.vocab_size)
    logits, cache, _ = apply_model(model, torch.from_numpy(toks), tcfg)

    def jax_logits(c):
        return np.asarray(jax_apply_model(params, jnp.asarray(toks), c)[0])

    assert cache is None and logits.dtype == torch.float32
    assert logits.shape == (2, PROMPT, jcfg.vocab_size)
    _holds(logits.numpy(), jax_logits(jcfg), mode,
           _jax_w8(jax_logits, jcfg, mode))


@pytest.mark.parametrize("impl,engine", [("auto", "flash"), ("flash", "flash"),
                                         ("jnp", "blockwise")])
def test_routing_by_attn_impl(impl, engine, monkeypatch):
    """Below the threshold the dense path; at it the engine attn_impl
    selects (``auto``: flash, whose kernels are always live here)."""
    calls = []
    for name in ("flash_attention", "_attend_blockwise", "_attend_dense"):
        fn = getattr(port_attention, name)
        monkeypatch.setattr(port_attention, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*a, **kw))
    cfg = get_smoke_config("gemma2_27b").replace(dtype="float32",
                                                 attn_impl=impl)
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    for s in (cfg.blockwise_attn_threshold - 1, cfg.blockwise_attn_threshold):
        calls.clear()
        apply_model(model, torch.zeros((1, s), dtype=torch.long), cfg)
        want = ("_attend_dense" if s < cfg.blockwise_attn_threshold
                else {"flash": "flash_attention",
                      "blockwise": "_attend_blockwise"}[engine])
        assert calls == [want] * cfg.n_layers


@pytest.mark.parametrize("mode", ["none", "w8a8"])
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "gemma2_27b"])
def test_prefill_step_matches_jax(arch, mode):
    jcfg, params, tcfg, model = paired_models(arch, quant_proj=mode,
                                              dtype="float32")
    toks = _tokens(jcfg.vocab_size, seed=3)
    logits, aux = prefill_step(model, torch.from_numpy(toks), tcfg)
    ref, jaux = jax_prefill_step(params, jnp.asarray(toks), jcfg)

    def jax_logits(c):
        return np.asarray(jax_prefill_step(params, jnp.asarray(toks), c)[0])

    assert logits.shape == (2, PROMPT, jcfg.vocab_size)
    _holds(logits.numpy(), np.asarray(ref), mode,
           _jax_w8(jax_logits, jcfg, mode))
    assert float(aux["load_balance_loss"]) == float(jaux["load_balance_loss"])


def test_prefill_step_refuses_other_families_inputs():
    """On a decoder-only model ``encoder_frames`` raise (the JAX package
    ignores them); ``frontend_embeds`` are spliced ahead of the text, as
    the JAX package splices them on any family."""
    cfg = get_smoke_config("qwen2_5_3b").replace(dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="not an encoder-decoder"):
        prefill_step(model, toks, cfg,
                     encoder_frames=torch.zeros((1, 2, cfg.d_model)))
    logits, _ = prefill_step(model, toks, cfg,
                             frontend_embeds=torch.zeros((1, 2, cfg.d_model)))
    assert logits.shape == (1, 6, cfg.vocab_size)


def test_windowed_layers_use_the_window_only_when_local():
    cfg = get_smoke_config("gemma2_27b")
    seen = [port_attention._run_windowed(lambda w: w, cfg, flag)
            for flag in (True, False)]
    assert seen == [cfg.sliding_window, None]
    plain = get_smoke_config("qwen2_5_3b")
    assert port_attention._run_windowed(lambda w: w, plain, True) is None
    assert [port_attention._flash_engine_live(plain.replace(attn_impl=i))
            for i in ("auto", "flash", "jnp")] == [True, True, False]


def w8a8_readings(seeds=8):
    """Per arch, over ``seeds`` prompts like the tests': the worst rel-err
    of the port's w8a8 logits against JAX's on the blockwise path (the
    smoke threshold) and on the dense path (threshold above the prompt),
    and the smallest gap between JAX's w8a8 and w8 logits."""
    for arch in ("qwen2_5_3b", "gemma2_27b", "chatglm3_6b"):
        worst, gap = {}, np.inf
        for path, threshold in (("blockwise", None), ("dense", PROMPT + 1)):
            kw = ({} if threshold is None
                  else {"blockwise_attn_threshold": threshold})
            jcfg, params, tcfg, model = paired_models(
                arch, quant_proj="w8a8", dtype="float32", **kw)
            errs = []
            for seed in range(seeds):
                toks = _tokens(jcfg.vocab_size, seed=12 + seed)
                got = apply_model(model, torch.from_numpy(toks), tcfg)[0]
                ref, w8 = (np.asarray(jax_apply_model(
                    params, jnp.asarray(toks), c)[0])
                    for c in (jcfg, jcfg.replace(quant_proj="w8")))
                errs.append(rel_err(got.numpy(), ref))
                gap = min(gap, rel_err(w8, ref))
            worst[path] = max(errs)
        print(f"{arch}: port vs JAX w8a8 rel-err, worst of {seeds} prompts: "
              f"blockwise {worst['blockwise']:.3e}, dense "
              f"{worst['dense']:.3e}; JAX w8a8 vs w8, smallest "
              f"{gap:.3e}")


if __name__ == "__main__":
    w8a8_readings()
