"""The walk of K5's bf16 dK dV kernel on the CPU: KV tile j visits the q
tiles ``q_tile_bounds`` gives (the inverse of the forward's walk), which
must be exactly the (q tile, KV tile) pairs the JAX package's
``_kv_block_bounds`` / ``flash_schedule`` give at the kernel's 64 x 64
tiles, as many as ``blocks_touched``; the blocks launch longest walks
first (``dkdv_tile_order``); and the wrapper sizes the kernels' f32
scratch (``bwd_scratch_floats``) from the shapes alone."""
import pytest
import torch

from repro.kernels.flash_attention.kernel import (_kv_block_bounds,
                                                  flash_schedule)
from repro_torch.kernels.flash_attention import kernel as walk
from repro_torch.kernels.flash_attention import ops

TILE = walk.KERNEL_Q_TILE

# s, t, causal, window: the training shape, gemma2-27b's local layer cut
# as in chip_smoke.py, ragged S and T, S != T both ways, non-causal with
# and without a window, a window past T (rows that see no key), a window
# wider than the sequence, a one-key window
CASES = {
    "qwen_training": (4096, 4096, True, None),
    "gemma_local": (2048, 2048, True, 1024),
    "ragged": (77, 77, True, None),
    "ragged_window": (300, 300, True, 70),
    "odd_window": (90, 90, True, 20),
    "s_lt_t_causal": (100, 200, True, None),
    "s_gt_t_causal": (200, 100, True, None),
    "s_lt_t_window": (130, 700, True, 48),
    "noncausal": (1024, 1024, False, None),
    "noncausal_s_ne_t": (100, 200, False, None),
    "noncausal_window": (160, 64, False, 48),
    "window_past_t": (200, 64, False, 32),
    "window_wider": (300, 300, True, 5000),
    "window_one_key": (257, 257, True, 1),
}


def _counts(s, t):
    return -(-s // TILE), -(-t // TILE)


def _forward_pairs(s, t, causal, window):
    num_q, num_kv = _counts(s, t)
    pairs = set()
    for i in range(num_q):
        j_lo, j_hi = _kv_block_bounds(i, q_chunk=TILE, kv_chunk=TILE,
                                      num_kv=num_kv, causal=causal,
                                      window=window, _min=min, _max=max)
        pairs |= {(i, j) for j in range(j_lo, j_hi + 1)}
    return pairs


def _walk(j, s, t, causal, window):
    num_q, num_kv = _counts(s, t)
    return walk.q_tile_bounds(j, q_chunk=TILE, kv_chunk=TILE, num_q=num_q,
                              num_kv=num_kv, causal=causal, window=window)


@pytest.mark.parametrize("case", list(CASES))
def test_transposed_walk_visits_the_forward_pairs(case):
    s, t, causal, window = CASES[case]
    _, num_kv = _counts(s, t)
    pairs = []
    for j in range(num_kv):
        i_lo, i_hi = _walk(j, s, t, causal, window)
        pairs += [(i, j) for i in range(i_lo, i_hi + 1)]
    assert len(pairs) == len(set(pairs))
    assert set(pairs) == _forward_pairs(s, t, causal, window)
    sched = flash_schedule(s, t, q_chunk=TILE, kv_chunk=TILE, causal=causal,
                           window=window)
    assert len(pairs) == sched.blocks_touched


@pytest.mark.parametrize("case", list(CASES))
def test_dkdv_blocks_launch_longest_walks_first(case):
    """Exact unless the walk is causal and windowed with more q tiles than
    KV tiles: there the last KV tile's walk (its j_lo is capped) runs to
    the last q tile and may be longer than the others'."""
    s, t, causal, window = CASES[case]
    num_q, num_kv = _counts(s, t)
    order = walk.dkdv_tile_order(s, t, causal=causal, window=window)
    assert sorted(order) == list(range(num_kv))
    lengths = [max(hi - lo + 1, 0)
               for lo, hi in (_walk(j, s, t, causal, window) for j in order)]
    if causal and window is not None and num_q > num_kv:
        lengths = lengths[:-1]
    assert all(a >= b for a, b in zip(lengths, lengths[1:])), lengths


def test_causal_windowed_order_misses_only_the_last_tile():
    """The one case the order does not sort: the last KV tile, with S > T,
    a causal window."""
    s, t, window = 300, 128, 20
    lengths = [max(hi - lo + 1, 0) for lo, hi in
               (_walk(j, s, t, True, window)
                for j in walk.dkdv_tile_order(s, t, causal=True,
                                              window=window))]
    assert lengths == [2, 4]


@pytest.mark.parametrize("b,s,t,h,kh,d,bf16,want", [
    # qwen2.5-3b's training layer: D_i, then 2 x (B, T, H, D): ~67 MB
    (1, 4096, 4096, 16, 2, 128, True, 65536 + 2 * 4096 * 16 * 128),
    # the same in f32: the ALU kernels sum the g heads in their blocks
    (1, 4096, 4096, 16, 2, 128, False, 65536),
    # MHA: each block writes dK and dV itself
    (2, 1024, 1024, 16, 16, 64, True, 32768),
    # D_i's length rounded up to 32 floats, so the shares start aligned
    (1, 77, 77, 4, 2, 64, True, 320 + 2 * 77 * 4 * 64),
    (1, 77, 90, 1, 1, 18, True, 96),
    (3, 100, 200, 4, 1, 16, True, 1216 + 2 * 3 * 200 * 4 * 16),
])
def test_bwd_scratch_floats(b, s, t, h, kh, d, bf16, want):
    got = walk.bwd_scratch_floats(b, s, t, h, kh, d, bf16=bf16)
    assert got == want
    assert (b * h * s + 31) // 32 * 32 <= got


class _FakeLibrary:
    """Stands in for the built library: records the launcher's
    arguments."""

    def __init__(self):
        self.calls = []

    def launch_flash_attention_bwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrapper_allocates_the_sized_scratch(monkeypatch, dtype):
    """``flash_attention_backward`` hands the launcher one f32 scratch of
    ``bwd_scratch_floats`` elements (the sizing is pure Python, so it runs
    here with the library faked)."""
    b, s, t, h, kh, d = 1, 130, 130, 8, 2, 64
    fake = _FakeLibrary()
    monkeypatch.setattr(ops._build, "library", lambda name: fake)
    sizes = []
    real = ops.torch.empty

    def empty(*shape, **kw):
        out = real(*shape, **kw)
        sizes.append((out.data_ptr(), out.numel(), out.dtype))
        return out
    monkeypatch.setattr(ops.torch, "empty", empty)
    monkeypatch.setattr(ops.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    q = torch.zeros((b, s, h, d), dtype=dtype)
    k = v = torch.zeros((b, t, kh, d), dtype=dtype)
    out32 = torch.zeros((b, s, h, d), dtype=torch.float32)
    lse = torch.zeros((b, h, s), dtype=torch.float32)
    before = ops.flash_attention.backward_launches
    dq, dk, dv = ops.flash_attention_backward(q, k, v, out32, lse, q,
                                              scale=d ** -0.5)
    assert ops.flash_attention.backward_launches == before + 1
    (args,) = fake.calls
    scratch = {ptr: (n, dt) for ptr, n, dt in sizes}[args[6]]
    want = walk.bwd_scratch_floats(b, s, t, h, kh, d,
                                   bf16=dtype == torch.bfloat16)
    assert scratch == (want, torch.float32)
    assert args[-3] == int(dtype == torch.bfloat16)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
