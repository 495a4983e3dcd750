"""Port's serving path (dense cache: prefill → greedy_decode) vs the JAX
engine on the same weights, prompts of mixed lengths, fixed seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.cache import init_cache as jax_init_cache
from repro.serving.engine import greedy_decode as jax_greedy_decode
from repro.serving.engine import prefill as jax_prefill
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import init_model
from repro_torch.serving.cache import init_cache
from repro_torch.serving.engine import greedy_decode, prefill, serve_step
from test_torch_bridge import SMOKE_ARCHS, numpy_tree, paired_models

LENS = np.array([12, 7, 3], np.int32)          # right-padded to 12
N_STEPS = 6


def _prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (len(LENS), int(LENS.max()))).astype(np.int32)


def _jax_serve(jcfg, params, prompts, cache_dtype):
    cache = jax_init_cache(jcfg, len(LENS), LENS.max() + N_STEPS + 1,
                           dtype=cache_dtype)
    nl, cache = jax_prefill(params, cache, jnp.asarray(prompts),
                            jnp.asarray(LENS), jcfg)
    first = jnp.argmax(nl, -1)[:, None].astype(jnp.int32)
    toks, _ = jax_greedy_decode(params, cache, first, jnp.asarray(LENS),
                                N_STEPS, jcfg)
    return np.array(nl), np.array(toks)          # writable copies


def _port_cache(tcfg):
    return init_cache(tcfg, len(LENS), int(LENS.max()) + N_STEPS + 1,
                      dtype=tcfg.activation_dtype, device="cpu")


@pytest.mark.parametrize("arch", SMOKE_ARCHS + ["gemma2_27b"])
@pytest.mark.parametrize("mode", ["w8a8", "none"])
def test_greedy_tokens_equal_jax_engine_f32(arch, mode):
    jcfg, params, tcfg, model = paired_models(arch, quant_proj=mode,
                                              dtype="float32")
    prompts = _prompts(jcfg.vocab_size, seed=3)
    _, ref = _jax_serve(jcfg, params, prompts, jnp.float32)

    cache = _port_cache(tcfg)
    nl, cache = prefill(model, cache, torch.from_numpy(prompts),
                        torch.from_numpy(LENS), tcfg)
    first = torch.argmax(nl, -1)[:, None]
    toks, cache = greedy_decode(model, cache, first,
                                torch.from_numpy(LENS).long(), N_STEPS, tcfg)
    assert toks.shape == (len(LENS), N_STEPS + 1)
    np.testing.assert_array_equal(toks.numpy(), ref)
    # the cache was written in place: the longest row's last decode slot
    assert cache["k"][:, 0, LENS[0] + N_STEPS - 1].abs().sum() > 0


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_bf16_top1_agreement(arch):
    """bf16 rounds at other places in the two frameworks: teacher-forced
    with the JAX engine's tokens, the port's argmax agrees >= 95%."""
    jcfg, params, tcfg, model = paired_models(arch, quant_proj="w8a8",
                                              dtype="bfloat16")
    prompts = _prompts(jcfg.vocab_size, seed=4)
    nl_ref, ref = _jax_serve(jcfg, params, prompts, jnp.bfloat16)

    cache = _port_cache(tcfg)
    nl, cache = prefill(model, cache, torch.from_numpy(prompts),
                        torch.from_numpy(LENS), tcfg)
    hits = [torch.argmax(nl, -1).numpy() == ref[:, 0]]
    pos = torch.from_numpy(LENS).long()
    for t in range(N_STEPS):
        logits, cache = serve_step(model, cache,
                                   torch.from_numpy(ref[:, t:t + 1]).long(),
                                   pos + t, tcfg)
        hits.append(torch.argmax(logits[:, -1], -1).numpy() == ref[:, t + 1])
    assert np.mean(hits) >= 0.95
    assert np.allclose(nl.numpy(), nl_ref, atol=0.1)


def test_batch_synchronous_scalar_position():
    """A scalar pos (one shared position) equals the (B,) vector form:
    ``apply_model`` makes it that vector."""
    cfg = get_smoke_config("qwen2_5_3b").replace(dtype="float32")
    model = init_model(torch.Generator().manual_seed(1), cfg, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 5),
                            generator=torch.Generator().manual_seed(2))
    outs = []
    for pos in (5, torch.tensor([5, 5])):
        cache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
        _, cache = prefill(model, cache, prompts, torch.tensor([5, 5]), cfg)
        logits, _ = serve_step(model, cache, prompts[:, :1], pos, cfg)
        outs.append(logits)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_prefill_past_capacity_raises():
    cfg = get_smoke_config("distilbert_paper")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        prefill(model, cache, torch.zeros((2, 12), dtype=torch.long),
                torch.tensor([12, 12]), cfg)


@pytest.mark.parametrize("field,delta", [("n_layers", 1), ("n_kv_heads", -1)])
def test_cache_of_another_config_raises(field, delta):
    """A dense cache built for another config is refused, not misread."""
    cfg = get_smoke_config("qwen2_5_3b").replace(dtype="float32")
    other = cfg.replace(**{field: getattr(cfg, field) + delta})
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = init_cache(other, 2, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="different model config"):
        prefill(model, cache, torch.zeros((2, 4), dtype=torch.long),
                torch.tensor([4, 4]), cfg)


def test_entry_points_raise_without_a_card():
    """Entry points default to the card and never move to the CPU alone."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_smoke_config("distilbert_paper")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_model(gen, cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_cache(cfg, 2, 8)
    _, params, _, _ = paired_models("distilbert_paper")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        params_from_numpy(numpy_tree(params), cfg)
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--arch", "distilbert_paper", "--smoke"])
