"""K5's gradients on the CPU: the port's ``flash_attention`` (its plain
version, differentiated by autograd) against ``jax.grad`` through the JAX
package's ``attention_ref``, and the step-by-step ``attention_bwd_ref``
(what K5's backward kernels compute) against autograd, on the same seeded
inputs in f32.  Cases: causal and not, a window, a softcap, GQA and MQA,
ragged S and T, and rows that see no key (their gradients exactly 0).
Limit: 1e-5 absolute and relative (``assert_allclose``): sums over at most
a few hundred keys of O(1) terms, in f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

# b, s, t, h, kh, d, options
CASES = {
    "causal_gqa": (2, 70, 70, 4, 2, 16, {}),
    "mha_partial": (1, 77, 77, 3, 3, 8, {}),
    "mqa_softcap": (1, 64, 64, 4, 1, 16, dict(softcap=5.0)),
    "window_softcap": (1, 90, 90, 4, 2, 8, dict(window=20, softcap=3.0)),
    "noncausal": (1, 50, 130, 4, 2, 12, dict(causal=False)),
    "noncausal_window_no_key": (1, 200, 64, 4, 2, 8,
                                dict(causal=False, window=32)),
    "s_ne_t_softcap": (1, 100, 130, 6, 2, 12,
                       dict(causal=False, softcap=50.0)),
}
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, s, t, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d),
                          (b, s, h, d))]


def _torch_grads(q, k, v, dout, opts):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(q, k, v, **opts)
    return [g.numpy() for g in torch.autograd.grad(out, (q, k, v),
                                                   torch.from_numpy(dout))]


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_grads_match_jax(case):
    b, s, t, h, kh, d, opts = CASES[case]
    q, k, v, dout = _inputs(b, s, t, h, kh, d)
    scale = d ** -0.5

    def f(q, k, v):     # the JAX layout is (B, H, S, D)
        o = jax_attention(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                          v.transpose(0, 2, 1, 3), scale=scale,
                          causal=opts.get("causal", True),
                          window=opts.get("window"),
                          softcap=opts.get("softcap"))
        return o.transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    got = _torch_grads(q, k, v, dout, opts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_step_by_step_backward_matches_autograd(case):
    b, s, t, h, kh, d, opts = CASES[case]
    q, k, v, dout = _inputs(b, s, t, h, kh, d, seed=1)
    want = _torch_grads(q, k, v, dout, opts)
    got = attention_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v, dout)),
                            **opts)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_rows_that_see_no_key_get_zero_gradients():
    b, s, t, h, kh, d, opts = CASES["noncausal_window_no_key"]
    q, k, v, dout = _inputs(b, s, t, h, kh, d, seed=2)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    lse = attention_lse_ref(tq, tk, **opts)
    dead = torch.isinf(lse)                     # (B, H, S)
    assert dead.any() and bool((lse[dead] > 0).all())
    rows = dead.any(dim=1)[0]                   # a row's heads die together
    out = attention_ref(tq, tk, tv, **opts)
    for dq in (attention_bwd_ref(tq, tk, tv, tdo, **opts)[0],
               torch.from_numpy(_torch_grads(q, k, v, dout, opts)[0])):
        assert torch.equal(dq[:, rows], torch.zeros_like(dq[:, rows]))
        assert bool(torch.isfinite(dq).all())
    assert torch.equal(out[:, rows], torch.zeros_like(out[:, rows]))


def test_attention_ref_is_the_same_with_and_without_autograd():
    """The plain version runs in place where no gradient is taken and out
    of place where one is: the same operations, the same bits."""
    q, k, v, _ = _inputs(1, 40, 40, 4, 2, 8, seed=3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with torch.no_grad():
        a = attention_ref(tq, tk, tv, window=9, softcap=2.0)
    b = attention_ref(tq.requires_grad_(), tk, tv, window=9, softcap=2.0)
    assert b.requires_grad and torch.equal(a, b.detach())
