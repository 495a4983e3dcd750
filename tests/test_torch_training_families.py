"""One train step of each family's smoke config, the port against the JAX
package on the CPU (f32, bridged weights, the same 64-token batches; the
limits and helpers of ``test_torch_training.py``): the loss within 1e-5
relative, each leaf's gradient within 1e-4 relative norm (the MoE's
load-balance loss included, the vision loss over the text tail, the
encoder-decoder's frames through its encoder), and each leaf's update
within 1e-3 relative norm over its well-conditioned entries."""
import pytest

from test_torch_training import check_updates, run_both

# one smoke config of each family the JAX package trains
FAMILIES = {"dense": "gemma2_27b", "moe": "qwen3_moe_30b_a3b",
            "ssm": "mamba2_370m", "hybrid": "zamba2_7b",
            "audio": "seamless_m4t_medium", "vlm": "phi3_vision_4_2b"}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_train_step_matches_jax(family):
    metrics, jstate, tstate, p0 = run_both(FAMILIES[family], steps=1)
    (jm, tm), = metrics
    assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * abs(jm["loss"])
    if family == "moe":
        assert abs(tm["load_balance"] - jm["load_balance"]) \
            <= 1e-5 * abs(jm["load_balance"])
    check_updates(jstate, tstate, p0)
