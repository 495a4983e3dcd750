"""The port's twin of the paper's demo (``examples/qkv_offload_distilbert_
torch.py``) against the JAX example (``examples/qkv_offload_distilbert.py``)
on the CPU, on the same inputs and bridged parameters.

The raw GEMM: both quantize the same f32 matrices bitwise alike and sum
int8 products exactly, so their rel-errs against the f32 oracle agree to
the f32 norms' last bits (1e-6).  The model demo: the unquantized logits
agree within the port's 1e-5 and the w8a8 logits within 2e-3
(``test_torch_model.py``), so the top-1 agreement may differ only where a
w8a8 row's top two logits lie within that: at most 2 of the 256 positions
(1/128), and the mean confidences within 1e-3.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.quantization import quantize as jax_quantize
from repro.core.quantize_params import quantize_model_params as jax_qparams
from repro.kernels.tiled_matmul.ops import tiled_matmul as jax_tiled_matmul
from repro.kernels.tiled_matmul.ref import matmul_f32_oracle as jax_oracle
from repro.models.transformer import apply_model as jax_apply_model
from repro.models.transformer import init_model as jax_init_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from test_torch_bridge import numpy_tree

ROOT = Path(__file__).resolve().parent.parent


def _example():
    path = ROOT / "examples" / "qkv_offload_distilbert_torch.py"
    spec = importlib.util.spec_from_file_location("qkv_offload_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_raw_kernel_demo_matches_the_jax_example():
    rel = _example().raw_kernel_demo("cpu")
    # the JAX example's raw_kernel_demo, its calls as they stand
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(64, 768)).astype(np.float32))
    b = jnp.asarray((rng.normal(size=(768, 3072)) * 0.05).astype(np.float32))
    out = jax_tiled_matmul(jax_quantize(a, channel_axes=(0,)),
                           jax_quantize(b, channel_axes=(1,)),
                           out_dtype=jnp.float32, mode="pallas_interpret")
    ref = jax_oracle(a, b)
    rel_jax = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
    assert abs(rel - rel_jax) <= 1e-6
    assert 0.005 < rel < 0.02                  # the paper GEMM's ~0.011


def test_model_demo_matches_the_jax_example():
    cfg = jax_smoke_config("distilbert_paper").replace(quant_proj="none",
                                                       dtype="float32")
    params = jax_init_model(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 64), 0,
                                cfg.vocab_size)
    fp_logits, _, _ = jax_apply_model(params, tokens, cfg)
    q_logits, _, _ = jax_apply_model(jax_qparams(params), tokens,
                                     cfg.replace(quant_proj="w8a8"))
    fp_conf = float(jnp.mean(jax.nn.softmax(fp_logits, -1).max(-1)))
    q_conf = float(jnp.mean(jax.nn.softmax(q_logits, -1).max(-1)))
    agree = float(jnp.mean((jnp.argmax(fp_logits, -1)
                            == jnp.argmax(q_logits, -1)).astype(jnp.float32)))

    tcfg = get_smoke_config("distilbert_paper").replace(quant_proj="none",
                                                        dtype="float32")
    model = params_from_numpy(numpy_tree(params), tcfg, device="cpu")
    got = _example().model_demo(
        "cpu", model, torch.from_numpy(np.array(tokens)).long())
    assert abs(got["agree"] - agree) <= 2 / 256
    assert abs(got["fp_conf"] - fp_conf) <= 1e-3
    assert abs(got["q_conf"] - q_conf) <= 1e-3
    assert got["agree"] >= 0.95


def _train_example():
    path = ROOT / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_example_twin_restarts_into_the_same_run(tmp_path):
    """The twin of examples/train_lm.py on the CPU at a small width (its
    loop, not its 100M model, is what runs here): 20 steps, logged every
    10, then the same with a failure injected at step 10.  No checkpoint
    has landed by then (every 50 steps), so the run restarts from scratch
    and must log the uninterrupted run's metrics bit for bit."""
    mod = _train_example()
    cfg = mod.CFG_100M.replace(n_layers=2, d_model=64, vocab_size=256,
                               n_heads=4, n_kv_heads=2, head_dim=16,
                               d_ff=128)
    runs = {}
    for name, extra in (("plain", []), ("failure", ["--inject-failure"])):
        runs[name] = mod.main(["--device", "cpu", "--steps", "20",
                               "--batch", "4", "--seq", "32", "--ckpt-dir",
                               str(tmp_path / name), *extra], cfg=cfg)
    (state, restarts, history), (state_f, restarts_f, history_f) = (
        runs["plain"], runs["failure"])
    assert (restarts, restarts_f) == (0, 1)
    assert history_f[0] == ("restart", 0)
    assert history_f[1:] == history
    assert int(state.step) == int(state_f.step) == 20
    assert [s for s, _ in history] == [10, 20]
    assert all(np.isfinite([m["loss"] for _, m in history]))
