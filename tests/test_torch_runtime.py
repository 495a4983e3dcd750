"""The port's data pipeline, checkpoint store, fault-tolerance driver,
straggler monitor and gradient compressor, on the CPU, against the JAX
package's where both have the behaviour: batches bitwise equal for the same
(seed, step, host); a checkpoint written by either package restored by the
other (values exact; bf16 leaves through f32 arrays one way and the JAX
package's raw bf16 records the other); the compressor bitwise with
deterministic rounding.  The restart tests run the port's Trainer on a
smoke config: a run cut by an injected failure and restarted from its
checkpoint gives the uninterrupted run's losses bit for bit (every op of the
CPU step is deterministic)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import restore_checkpoint as jax_restore
from repro.checkpoint.store import save_checkpoint as jax_save
from repro.data.pipeline import SyntheticLM as JaxLM
from repro.optim.adamw import AdamW as JaxAdamW
from repro.runtime.compression import GradCompressor as JaxCompressor
from repro.training.train_step import TrainState as JaxState
from repro_torch.bridge import stack_named
from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models.transformer import init_model
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.compression import GradCompressor
from repro_torch.runtime.failures import (FailureOracle, InjectedFailure,
                                          run_with_restarts)
from repro_torch.runtime.stragglers import StragglerMonitor
from repro_torch.training.train_step import (TrainState, make_train_step,
                                             trainable)
from repro_torch.training.trainer import Trainer
from test_torch_bridge import numpy_tree, paired_models
from test_torch_training import flat


@pytest.mark.parametrize("frontend", [None, "vision", "audio"])
@pytest.mark.parametrize("host", [0, 1])
def test_synthetic_batches_are_bitwise_jax(frontend, host):
    kw = dict(seed=3, host_index=host, host_count=2, frontend=frontend,
              frontend_len=5, d_model=8)
    jax_lm = JaxLM(1000, 4, 48, **kw)
    lm = SyntheticLM(1000, 4, 48, **kw, device="cpu")
    for step in (0, 1, 17):
        want = jax_lm.batch_at(step)
        got = lm.batch_at(step)
        assert want.keys() == got.keys()
        for key, w in want.items():
            g = got[key].numpy()
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), key
    assert torch.equal(next(iter(lm))["inputs"], lm.batch_at(0)["inputs"])


def test_prefetcher_keeps_order():
    lm = SyntheticLM(100, 2, 16, seed=1, device="cpu")
    it = Prefetcher(iter(lm), depth=3)
    for step in range(6):
        assert torch.equal(next(it)["targets"], lm.batch_at(step)["targets"])


def _states(dtype):
    """The same fresh TrainState in both packages, moments nonzero."""
    jcfg, params, tcfg, model = paired_models("qwen2_5_3b", dtype=dtype)
    zero1 = dtype == "bfloat16"
    jstate = JaxState.create(params, JaxAdamW(1e-3), zero1=zero1)
    tstate = TrainState.create(model, AdamW(1e-3), zero1=zero1)
    rng = np.random.default_rng(0)
    mu = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in flat(numpy_tree(jstate.opt_state.mu)).items()}

    def put(tree, prefix=""):
        return {k: put(v, f"{prefix}{k}|") if isinstance(v, dict)
                else jnp.asarray(mu[prefix + k]) for k, v in tree.items()}
    jstate = dataclasses.replace(
        jstate, step=jnp.asarray(7, jnp.int32),
        opt_state=dataclasses.replace(jstate.opt_state,
                                      mu=put(jstate.opt_state.mu),
                                      count=jnp.asarray(7, jnp.int32)))
    return jstate, tstate, mu


def _fresh_like(tstate, dtype):
    """A second port state of the same structure, other values."""
    _, _, _, model = paired_models("qwen2_5_3b", seed=5, dtype=dtype)
    return TrainState.create(model, AdamW(1e-3),
                             zero1=tstate.master is not None)


def _assert_state_equals_jax(tstate, jstate):
    want = flat(numpy_tree(jstate.params))
    got = stack_named(trainable(tstate.params))
    for key, w in want.items():
        np.testing.assert_array_equal(got[key],
                                      np.asarray(w, np.float32), key)
    for jt, tt in ((jstate.opt_state.mu, tstate.opt_state.mu),
                   (jstate.opt_state.nu, tstate.opt_state.nu)):
        jt, tt = flat(numpy_tree(jt)), stack_named(tt)
        for key in jt:
            np.testing.assert_array_equal(tt[key], jt[key], key)
    assert int(tstate.step) == int(jstate.step)
    assert int(tstate.opt_state.count) == int(jstate.opt_state.count)
    if jstate.master is not None:
        jt, tt = flat(numpy_tree(jstate.master)), stack_named(tstate.master)
        for key in jt:
            np.testing.assert_array_equal(tt[key], jt[key], key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    jstate, tstate, _ = _states(dtype)
    jax_save(str(tmp_path), 7, jstate)
    like = _fresh_like(tstate, dtype)
    restored = restore_checkpoint(str(tmp_path), 7, like=like)
    assert restored is like
    _assert_state_equals_jax(restored, jstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype):
    jstate, tstate, _ = _states(dtype)
    jax_save(str(tmp_path / "j"), 7, jstate)      # the port takes its values
    restore_checkpoint(str(tmp_path / "j"), 7, like=tstate)
    save_checkpoint(str(tmp_path / "t"), 7, tstate)
    meta = json.load(open(tmp_path / "t" / "step_00000007" / "meta.json"))
    with np.load(tmp_path / "j" / "step_00000007" / "arrays.npz") as j:
        assert meta["keys"] == sorted(j.files)
    back = jax_restore(str(tmp_path / "t"), 7,
                       like=jax.tree.map(jnp.zeros_like, jstate))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_checkpoints_are_atomic_and_collected(tmp_path):
    d = str(tmp_path)
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "b": {"x": torch.ones(2, dtype=torch.bfloat16)}}
    for step in (1, 2, 3, 4):
        save_checkpoint(d, step, state, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a write cut short
    os.makedirs(os.path.join(d, "step_00000008"))       # no meta.json yet
    assert latest_step(d) == 4
    assert latest_step(str(tmp_path / "none")) is None
    back = restore_checkpoint(d, 4, like=state)
    assert torch.equal(back["w"], state["w"])
    assert back["b"]["x"].dtype == torch.bfloat16
    assert torch.equal(back["b"]["x"], state["b"]["x"])
    ck = AsyncCheckpointer(d, keep=5)
    ck.save(5, state)
    state["w"].add_(1.0)                  # after save: not in step 5
    ck.wait()
    assert ck.last_saved == 5
    assert torch.equal(restore_checkpoint(d, 5, like=state)["w"],
                       state["w"] - 1.0)


def _smoke_trainer(ckpt_dir, steps, oracle=None):
    cfg = get_smoke_config("qwen2_5_3b").replace(dtype="float32")
    model = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = AdamW(learning_rate=warmup_cosine(1e-3, 2, steps))
    data = SyntheticLM(cfg.vocab_size, 2, 32, seed=0, device="cpu")
    return Trainer(state=TrainState.create(model, opt),
                   step_fn=make_train_step(cfg, opt), data=data,
                   ckpt_dir=ckpt_dir, ckpt_every=2, oracle=oracle,
                   log_every=1)


def test_restart_after_an_injected_failure_continues_the_run(tmp_path):
    steps = 5
    oracle = FailureOracle(fail_at_steps=(3,))
    made = []

    def make():
        # the cut run's checkpoint writer may still be writing step 2 when
        # the failure lands (a thread of this process): let it finish, so
        # the restart restores step 2 every time
        if made:
            made[-1]._ckpt.wait()
        made.append(_smoke_trainer(str(tmp_path / "b"), steps, oracle))
        return made[-1]

    state, restarts, history = run_with_restarts(make, steps,
                                                 str(tmp_path / "b"))
    # the cut attempt (from step 0) logs only its restart; the second one
    # restores step 2's checkpoint and runs steps 3 to 5
    assert restarts == 1 and history[0] == ("restart", 0)
    resumed = dict(history[1:])
    assert sorted(resumed) == [3, 4, 5]
    trainer = _smoke_trainer(str(tmp_path / "c"), steps)
    _, plain = trainer.run(0, steps)
    for s, m in plain[2:]:               # bitwise: a deterministic step
        assert resumed[s]["loss"] == m["loss"], s
    assert int(state.step) == steps
    assert latest_step(str(tmp_path / "b")) == steps
    with pytest.raises(InjectedFailure):
        FailureOracle(fail_at_steps=(0,)).maybe_fail(0)


def test_straggler_monitor_flags_slow_steps():
    ticks = iter([0.0, 1.0, 1.0, 2.0, 2.0, 5.0, 5.0, 6.0])
    mon = StragglerMonitor(threshold=2.0, alpha=0.5, clock=lambda: next(ticks))
    flags = []
    for step in range(4):
        mon.step_start()
        flags.append(mon.step_end(step))
    assert flags == [False, False, True, False]
    assert mon.flagged_steps == [(2, 3.0, 1.0)]
    assert mon.mean_step_time == 0.5 * 1.0 + 0.5 * (0.5 * 3.0 + 0.5 * 1.0)


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"layers.0.a.w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers.1.a.w": rng.standard_normal((6, 5)).astype(np.float32)
            * 3,
            "embed.table": rng.standard_normal((7, 4)).astype(np.float32)
            * 1e-3}


def test_compressor_without_noise_is_bitwise_jax():
    grads = _grads()
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    jg = {"layers": {"a": {"w": jnp.stack([grads["layers.0.a.w"],
                                           grads["layers.1.a.w"]])}},
          "embed": {"table": jnp.asarray(grads["embed.table"])}}
    tc, jc = GradCompressor(stochastic=False), JaxCompressor(
        stochastic=False)
    tres, jres = tc.init_residual(tg), jc.init_residual(jg)
    for _ in range(3):
        twire, tres = tc.compress_decompress(tg, tres)
        jwire, jres = jc.compress_decompress(jg, jres, jax.random.PRNGKey(0))
        for got, want in ((twire, jwire), (tres, jres)):
            got, want = stack_named(got), flat(numpy_tree(want))
            for key in want:
                assert got[key].tobytes() == want[key].tobytes(), key
    assert tc.wire_bytes(tg) == jc.wire_bytes(jg)


def test_stochastic_compressor_error_feedback():
    grads = {k: torch.from_numpy(v) for k, v in _grads(1).items()}
    gc = GradCompressor()
    gen = torch.Generator().manual_seed(0)
    res = gc.init_residual(grads)
    errors = []
    for _ in range(200):
        wire, new_res = gc.compress_decompress(grads, res, gen)
        for key in ("layers.0.a.w", "layers.1.a.w"):
            g32 = grads[key] + res[key]
            # the residual is exactly what the wire did not carry
            assert torch.equal(new_res[key], g32 - wire[key])
        absmax = max(float((grads[k] + res[k]).abs().max())
                     for k in ("layers.0.a.w", "layers.1.a.w"))
        q = wire["layers.1.a.w"] / (absmax / 127)
        assert float(q.abs().max()) <= 127 + 1e-3
        errors.append(torch.cat([(wire[k] - grads[k]).flatten()
                                 for k in grads]))
        res = new_res
    # unbiased rounding with error feedback: the wire's mean error vanishes
    mean_err = torch.stack(errors).mean(0)
    assert float(mean_err.abs().max()) < 0.02 * float(
        grads["layers.1.a.w"].abs().max())


@pytest.mark.parametrize("arch,quant", [("qwen2_5_3b", "none"),
                                        ("qwen2_5_3b", "w8a8"),
                                        ("qwen3_moe_30b_a3b", "none"),
                                        ("zamba2_7b", "none"),
                                        ("seamless_m4t_medium", "none")])
def test_params_to_numpy_inverts_the_bridge(arch, quant):
    """The port's weights back as the JAX package's nested numpy tree:
    the tree they were bridged from, leaf for leaf and bit for bit (the
    layer-stacked leaves stacked again, QTensors with their bits)."""
    from repro_torch.bridge import params_to_numpy
    _, params, tcfg, model = paired_models(arch, quant_proj=quant)
    want, got = numpy_tree(params), params_to_numpy(model, tcfg)

    def same(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                same(a[k], b[k], f"{path}|{k}")
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, np.asarray(a, b.dtype), path)
            assert b.shape == a.shape, path
        else:
            assert a == b, path
    same(want, got, "")
