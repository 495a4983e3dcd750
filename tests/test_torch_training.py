"""The port's training stack against the JAX package's, on the CPU.

Same smoke configs, bridged weights, the same SyntheticLM batches (bitwise
equal, ``test_torch_runtime.py``) of 64 tokens: the smoke configs'
``blockwise_attn_threshold``, so the port's flash path (K5's plain
version, differentiated by autograd) meets the JAX package's blockwise
attention.  Limits:

  * f32: the loss of each step within 1e-5 relative; each leaf's gradient
    within 1e-4 relative norm; each leaf's update (p - p0) after 3 steps
    within 1e-3 relative norm over its well-conditioned entries.  AdamW
    divides each entry's moment by the root of its second moment, so an
    entry whose gradients stay near zero (sqrt(v) ~ eps, where the two
    packages' sums differ in their last bits: the k-projection bias has
    such entries) has an update of either sign: entries whose JAX sqrt(v)
    lies below 1e-3 of the leaf's mean are left out (``ILL_CONDITIONED``);
    their gradients are held with the leaf's.
  * bf16 (ZeRO-1): XLA and PyTorch round to bf16 at other places, so the
    forward itself differs by bf16 ulps (2^-8).  The loss is held within
    1e-3 relative, the gradients within 2e-2 relative norm; AdamW's first
    steps scale each gradient entry to about +-lr, so the updates are held
    through the optimizer alone: JAX's AdamW given the port's gradients
    makes the port's update (within 1e-5 relative norm: the clip factor
    takes the global norm, an f32 sum in XLA's order); and the ZeRO-1
    layout exactly (f32 master and moments, the compute copy the master's
    bf16 cast, 1-D leaves shared).
  * the learning-rate schedule bitwise in its warmup, within 1e-6
    relative after it (XLA's and PyTorch's f32 cosine are different
    polynomials, an ulp apart at some arguments, and 1 + cos near cos = -1
    magnifies that);
    AdamW bitwise without clipping, and within 1e-6 with it (the global
    norm is an f32 sum whose order is XLA's own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JaxLM
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro.runtime.compression import GradCompressor as JaxCompressor
from repro.training.train_step import TrainState as JaxState
from repro.training.train_step import make_loss_fn as jax_loss_fn
from repro.training.train_step import make_train_step as jax_train_step
from repro_torch.bridge import stack_named
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.runtime.compression import GradCompressor
from repro_torch.tree import jax_key
from repro_torch.training.train_step import (TrainState, make_loss_fn,
                                             make_train_step, trainable,
                                             value_and_grad)
from test_torch_bridge import numpy_tree, paired_models

SEQ = 64
BATCH = 2
STEPS = 3
ILL_CONDITIONED = 1e-3


def flat(tree, prefix=""):
    """A nested numpy tree as {"a|b|c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}|"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def data_pair(jcfg, tcfg, seq=SEQ, batch=BATCH):
    kw = dict(seed=0, frontend=jcfg.frontend, frontend_len=jcfg.frontend_len,
              d_model=jcfg.d_model)
    return (JaxLM(jcfg.vocab_size, batch, seq, **kw),
            SyntheticLM(tcfg.vocab_size, batch, seq, **kw, device="cpu"))


def jax_batch(data, step):
    return {k: jnp.asarray(v) for k, v in data.batch_at(step).items()}


def grads_pair(jcfg, params, tcfg, model, jdata, tdata):
    """(jax loss, jax grads, port loss, port grads) on batch 0, grads as
    {JAX key: array}."""
    fn = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg), has_aux=True))
    (jl, _), jg = fn(params, jax_batch(jdata, 0))
    tg, tm = value_and_grad(make_loss_fn(tcfg), model, trainable(model),
                            tdata.batch_at(0),
                            cast=tcfg.dtype == "bfloat16")
    return (float(jl), flat(numpy_tree(jg)), float(tm["loss"]),
            stack_named(tg))


def check_grads(jg, tg, tol):
    """Each leaf's gradient within ``tol`` relative norm."""
    assert jg.keys() == tg.keys()
    for key, want in jg.items():
        assert rel_norm(tg[key], want) <= tol, (key, rel_norm(tg[key], want))


def schedule():
    return jax_warmup_cosine(1e-3, 2, 10), warmup_cosine(1e-3, 2, 10)


def run_both(arch, *, dtype="float32", microbatches=1, compress=False,
             steps=STEPS, seq=SEQ, **overrides):
    """The same training run in both packages; returns the per-step
    metrics, both final states and the initial params."""
    jcfg, params, tcfg, model = paired_models(arch, dtype=dtype, **overrides)
    jdata, tdata = data_pair(jcfg, tcfg, seq=seq)
    jl, jg, tl, tg = grads_pair(jcfg, params, tcfg, model, jdata, tdata)
    bf16 = dtype == "bfloat16"
    assert abs(tl - jl) <= (1e-3 if bf16 else 1e-5) * abs(jl)
    check_grads(jg, tg, 2e-2 if bf16 else 1e-4)
    p0 = flat(numpy_tree(params))
    jsched, tsched = schedule()
    jopt, topt = JaxAdamW(learning_rate=jsched), AdamW(learning_rate=tsched)
    jcomp = tcomp = None
    if compress:
        jgc, tgc = JaxCompressor(stochastic=False), GradCompressor(
            stochastic=False)
        jres = {"r": jgc.init_residual(params)}
        tres = {"r": tgc.init_residual(trainable(model))}

        def jcomp(grads):
            wire, jres["r"] = jgc.compress_decompress(
                grads, jres["r"], jax.random.PRNGKey(7))
            return wire

        def tcomp(grads):
            wire, tres["r"] = tgc.compress_decompress(grads, tres["r"])
            return wire
    jstate = JaxState.create(params, jopt, zero1=bf16)
    tstate = TrainState.create(model, topt, zero1=bf16)
    jstep = jax.jit(jax_train_step(jcfg, jopt, microbatches=microbatches,
                                   compressor=jcomp))
    tstep = make_train_step(tcfg, topt, microbatches=microbatches,
                            compressor=tcomp)
    metrics = []
    for i in range(steps):
        jstate, jm = jstep(jstate, jax_batch(jdata, i))
        tstate, tm = tstep(tstate, tdata.batch_at(i))
        metrics.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()}))
    return metrics, jstate, tstate, p0


def check_updates(jstate, tstate, p0, tol=1e-3):
    """Each leaf's update within ``tol`` relative norm over its
    well-conditioned entries (the module docstring)."""
    want = flat(numpy_tree(jstate.params if jstate.master is None
                           else jstate.master))
    got = (stack_named(trainable(tstate.params)) if tstate.master is None
           else stack_named(tstate.master))
    root_v = {k: np.sqrt(v) for k, v in
              flat(numpy_tree(jstate.opt_state.nu)).items()}
    assert want.keys() == got.keys()
    for key in want:
        ok = root_v[key] >= ILL_CONDITIONED * root_v[key].mean()
        assert rel_norm((got[key] - p0[key])[ok],
                        (want[key] - p0[key])[ok]) <= tol, key


@pytest.mark.parametrize("variant", ["f32", "microbatches2"])
def test_train_steps_match_jax_f32(variant):
    metrics, jstate, tstate, p0 = run_both(
        "qwen2_5_3b", microbatches=2 if variant == "microbatches2" else 1)
    for jm, tm in metrics:
        assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * abs(jm["loss"])
        assert abs(tm["grad_norm"] - jm["grad_norm"]) \
            <= 1e-4 * jm["grad_norm"]
        assert abs(tm["lr"] - jm["lr"]) <= 1e-6 * jm["lr"]
    assert int(tstate.step) == int(jstate.step) == STEPS
    assert int(tstate.opt_state.count) == STEPS
    check_updates(jstate, tstate, p0)


def test_train_steps_with_compressor_match_jax():
    """With the int8 compressor (stochastic=False, bitwise the JAX
    package's on the same gradients: ``test_torch_runtime.py``) the first
    step is held at the f32 limits.  Rounding to int8 is discontinuous:
    the packages' gradients, 1e-6 apart, round a few entries to
    neighbouring int8 values (a quantum, absmax / 127, each), and AdamW
    carries that on, so the later steps' loss is held within 1e-4 and
    grad norm within 1e-2, and the updates are not compared."""
    metrics, _, tstate, _ = run_both("qwen2_5_3b", compress=True)
    for i, (jm, tm) in enumerate(metrics):
        loss_tol, norm_tol = (1e-5, 1e-4) if i == 0 else (1e-4, 1e-2)
        assert abs(tm["loss"] - jm["loss"]) <= loss_tol * abs(jm["loss"])
        assert abs(tm["grad_norm"] - jm["grad_norm"]) \
            <= norm_tol * jm["grad_norm"]
    assert int(tstate.step) == STEPS


def test_train_steps_match_jax_bf16_zero1():
    metrics, jstate, tstate, _ = run_both("qwen2_5_3b", dtype="bfloat16")
    for jm, tm in metrics:
        assert abs(tm["loss"] - jm["loss"]) <= 1e-3 * abs(jm["loss"])
        assert abs(tm["grad_norm"] - jm["grad_norm"]) \
            <= 2e-2 * jm["grad_norm"]
    # the ZeRO-1 layout: f32 master and moments, the compute copy the
    # master's bf16 cast (a JAX leaf of >= 2 dimensions: a per-layer norm
    # scale is one) or the master's own tensor (the final norm's scale)
    compute = trainable(tstate.params)
    jcompute = flat(numpy_tree(jstate.params))
    for name, m in tstate.master.items():
        assert m.dtype == torch.float32
        assert tstate.opt_state.mu[name].dtype == torch.float32
        assert (compute[name].dtype == torch.bfloat16) == (
            jcompute[jax_key(name)].dtype != np.float32), name
        if compute[name].dtype == torch.bfloat16:
            assert compute[name].dtype == torch.bfloat16
            assert torch.equal(compute[name], m.to(torch.bfloat16))
        else:
            assert compute[name] is m


def test_bf16_zero1_update_is_jax_adamw_of_the_port_gradients():
    """One ZeRO-1 step: JAX's AdamW, given the port's own gradients, makes
    the port's master update."""
    jcfg, params, tcfg, model = paired_models("qwen2_5_3b", dtype="bfloat16")
    _, tdata = data_pair(jcfg, tcfg)
    jsched, tsched = schedule()
    tstate = TrainState.create(model, AdamW(learning_rate=tsched),
                               zero1=True)
    grads, _ = value_and_grad(make_loss_fn(tcfg), model,
                              trainable(model), tdata.batch_at(0))
    jgrads = {k: jnp.asarray(v) for k, v in stack_named(grads).items()}
    jopt = JaxAdamW(learning_rate=jsched)
    master0 = {k: jnp.asarray(v) for k, v in stack_named(tstate.master)
               .items()}
    want, _, _ = jopt.update(jgrads, jopt.init(master0), master0)
    tstate, _ = make_train_step(tcfg, AdamW(learning_rate=tsched))(
        tstate, tdata.batch_at(0))
    got = stack_named(tstate.master)
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        assert rel_norm(got[key] - np.asarray(master0[key]),
                        w - np.asarray(master0[key])) <= 1e-5, key


def test_remat_on_and_off_give_the_same_gradients():
    _, _, tcfg, model = paired_models("qwen2_5_3b")
    _, tdata = data_pair(tcfg, tcfg)
    batch = tdata.batch_at(0)
    got = {}
    for remat in ("block", "none"):
        cfg = tcfg.replace(remat=remat)
        got[remat], _ = value_and_grad(make_loss_fn(cfg), model,
                                       trainable(model), batch)
    for name, g in got["block"].items():
        assert torch.equal(g, got["none"][name]), name


def test_schedules_match_jax():
    jsched, tsched = jax_warmup_cosine(3e-4, 20, 100), warmup_cosine(
        3e-4, 20, 100)
    for step in range(0, 130):
        want = np.asarray(jsched(jnp.asarray(step, jnp.int32)))
        got = tsched(torch.tensor(step, dtype=torch.int32)).numpy()
        assert got.dtype == np.float32
        if step <= 20:
            assert got.tobytes() == want.tobytes(), step
        assert abs(float(got) - float(want)) <= 1e-6 * float(want), step
    assert float(constant(1e-3)(torch.tensor(5))) == np.float32(1e-3)


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_matches_jax(clip):
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (9,), "c": (3, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jsched, tsched = jax_warmup_cosine(1e-2, 2, 10), warmup_cosine(1e-2, 2,
                                                                   10)
    jopt = JaxAdamW(learning_rate=jsched, clip_norm=clip)
    topt = AdamW(learning_rate=tsched, clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(6):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 * (3.0 if i % 2 else 0.05) for k, s in shapes.items()}
        jp, js, jn = jopt.update({k: jnp.asarray(v)
                                  for k, v in grads.items()}, js, jp)
        tp, ts, tn = topt.update({k: torch.from_numpy(v)
                                  for k, v in grads.items()}, ts, tp)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for k in shapes:
            for want, got in ((jp[k], tp[k]), (js.mu[k], ts.mu[k]),
                              (js.nu[k], ts.nu[k])):
                want = np.asarray(want)
                if clip is None:
                    assert got.numpy().tobytes() == want.tobytes(), (i, k)
                else:
                    # the clip factor takes the global norm, an f32
                    # sum in XLA's order: 1e-6 of the values and of an
                    # update's size (lr)
                    np.testing.assert_allclose(got.numpy(), want,
                                               rtol=1e-6, atol=1e-8)
        assert int(ts.count) == int(js.count) == i + 1
