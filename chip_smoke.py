#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Device: name, count, power limit; TF32 off.
2. Build: every CUDA kernel from ``src/repro_torch/csrc`` with nvcc for
   sm_90a, printing ptxas' register, shared-memory and spill lines (and
   any performance warning, such as serialized wgmmas), and
   each kernel's tensor-core (HGMMA, HMMA, IGMMA, IMMA), IDP4A and FFMA
   counts from ``cuobjdump -sass``: K5's bf16 kernels must hold HGMMA,
   its f32 kernel none; its backward's bf16 dK dV and dQ kernels HGMMA,
   its f32 ones FFMA, the others (delta, the dK dV sum) no tensor-core
   instruction; K2 / K3's
   tensor-core variants (``gemm_tma``,
   every width) int8 tensor-core instructions and no IDP4A.  K1's 44
   instantiations (f32 / bf16, plain / SwiGLU, 8 values or one an access,
   block / cluster rows, register arrays) with their 16-byte
   loads, 8-byte stores, exponentials, reciprocals and cluster barriers:
   every vectorized one must load 16 and store 8 bytes an access.
3. Kernels against their plain PyTorch versions on the card at the main
   paths' shapes (and a few more): K1 bitwise at distilbert's, qwen2.5-3b's
   (4 / 20 / 8192 rows over 2048 and 11008) and gemma2-27b's (4 / 8192
   over 36864) shapes and ragged ones, with a zero row, a row of one huge
   value and a row on a tiny scale, in bf16 and f32, each case naming the
   row mapping ``quant_plan`` took; its SwiGLU mode ``quant_act_glu``
   bitwise its plain version at qwen2.5-3b's d_ff and ragged shapes, and
   its product h bitwise ``F.silu(gate) * up`` for every finite bf16 gate
   (u = 1 and u seeded, bf16 and f32).  K2 / K3 bitwise, also at
   qwen2.5-3b's served shapes (M = 4, 20 and 8192 over wo, gate / up,
   down and the fused 2048 | 256 | 256), at ragged M (5, 20, 129) on the
   tensor-core variants, bias on and off, bf16 and f32 out, each case
   naming the plan the dispatcher (``core/dispatch.py``, under the shipped
   table) took; qwen3-moe-30b-a3b's fused QKV
   2048 -> 4096 | 512 | 512 and wo 4096 -> 2048 at the same rows, on a
   tensor-core variant or failing (and K1 over its 4096); K4 (paged attention)
   within atol 5e-6 / rtol 1e-5 in f32 and int8 pools, rel-err 1e-2 in
   bf16 (each row against its own largest value), bitwise across page
   tables and against pre-dequantized pools; K5 (block-sparse flash
   attention) within the same limits at the served shapes (qwen2.5-3b
   causal, gemma2-27b local and global) in bf16 and in f32, and at
   further f32 ones (non-causal windowed, partial tiles, distilbert's
   width).  K4's verify mode (``new_lens``, speculative decode) at the
   served shape (4 x 5 rows, qwen2.5-3b's 16/2 heads of 128, contexts to
   560, an idle slot) and at the JAX package's test shapes, in f32, bf16
   and int8 pools at the same limits, dead rows exactly 0; a one-row
   verify launch bitwise the plain launch; live rows of a variable-row
   launch against exact-width launches per sequence.  K4 at contexts of
   ~4096 tokens whose page walks span many splits (pages of 16 and 64,
   plain and verify, every pool type): the same limits, and the four
   bitwise contracts (two launches, striped and contiguous tables, one-row
   verify against plain, int8 against pre-dequantized f32).  K5's
   backward (dQ, dK, dV through autograd) against the step-by-step plain
   backward and against autograd through the plain forward, in f32 and
   bf16, at qwen2.5-3b's training shape (1, 4096, 16/2, 128), gemma2-27b's
   local layer with S and window cut 4x (softcap 50), seamless's
   non-causal D = 64, D = 96 and 112, partial tiles and rows that see no
   key (their gradients exactly 0): f32 within atol 1e-5 / rtol 1e-4,
   bf16 each row within 2e-2 of its largest value (``BWD_*``); two
   backward runs bitwise equal, and K5's O bitwise the same with and
   without the log-sum-exps its forward writes for the backward.
4. The main paths: ``distilbert_paper`` (w8a8, bf16) at full width from a
   seeded generator, 4 requests of 64/48/33/17 prompt tokens through
   ``prefill`` then 32 steps of ``greedy_decode``, each with exact kernel
   launch counts: on the dense cache (the same serve is run again with
   the plain versions swapped in for the kernels: prefill logits, tokens
   and the whole KV cache must be bitwise equal), then on the paged cache
   (page 16, striped table) in bf16 pools and in int8 pools: each of the
   serve's K4 calls is held against the plain version on that call's own
   operands, at phase 3's limits, and layer 0's prompt rows must equal
   the dense serve's bit for bit.
   Plan selection (``core/dispatch.py``): under ``REPRO_TUNE=full``, a
   table of the script's own and the shipped one off, K2 and K3 are tuned
   at ``TUNE_SHAPES`` (the paper GEMM (64, 768) x (768, 3072) in bf16 and
   f32, the fused 64 x 768 -> 768 x 3, qwen2.5-3b's decode wo, zamba2-7b's
   N = 64 at 4 and at 8192 rows), each candidate held bitwise against the
   plain version and its device µs printed beside the analytic pick's;
   then under ``cached`` against that table the wrappers select and
   launch the stored plans (``launched_plans``), bitwise the analytic
   plan's output and the plain version's.  The dense distilbert serve
   under the shipped table and under ``REPRO_TUNE=off``: logits, tokens
   and the cache bitwise equal, the launches by plan each mode's
   selection.  The example twins (``examples/quickstart_torch.py``,
   ``serve_quantized_torch.py``, ``serve_zoo_torch.py``) on the card: on
   the plain versions, under ``full`` into a fresh table and under
   ``cached`` against it, bitwise equal.
   The long-prompt path: ``prefill_step`` of qwen2.5-3b (w8a8, bf16) at
   full width and all 36 layers, weights drawn on the card from a seeded
   generator, on one prompt of 8192 random tokens, with exact launch
   counts (every attention layer one launch of K5, the block-sparse flash
   kernel); each served K5 call is held against the plain version on its
   own operands at phase 3's limits, the logits must be finite, and the
   prefill time is printed.  Then gemma2-27b (w8a8, bf16) at full width,
   2 layers (one local with the 4096 window, one global; softcap 50), the
   same way.
   The continuous-batching path: qwen2.5-3b (w8a8, bf16) at full width
   and depth through the ``Scheduler`` (4 slots of 512 tokens, a dynamic
   pool of 40 16-token pages, prefix sharing, bucket 16, an EOS id) on a
   trace of 8 requests (prompts of 40-300 tokens, three sharing a
   100-token prefix; budgets 16-48; arrivals over 12 ticks), five ways:
   plain decode on bf16 and int8 pools, speculative decode with the
   first 2 layers as the draft on both, and with the target as its own
   draft (n_draft 4).  Each run is made twice: first with every K4 call
   held against the plain version on its own operands as it is made (dead
   verify rows 0) and the logit gaps recorded, then counted (launch
   counts exact from the request log) and timed, with one tick under
   ``torch.profiler``; the two must give equal tokens.  Speculative
   tokens equal the plain run's, or first differ at a near tie of it.
   After each path's counted run (counts set to 0 just before it), its
   launches by K1 row mapping and by K2 / K3 variant are read, must sum
   to its launch counts, and are printed; every K2 / K3 launch must have
   planned onto a tensor-core variant (``wide`` or ``swap``), never the
   general tile.  In qwen2.5-3b's SwiGLU FFN
   one K1 serves gate and up and ``quant_act_glu`` quantizes silu(gate) *
   up for the down projection: every such call of ``prefill_step`` and of
   the Scheduler runs is held bitwise against the plain version on its own
   operands as it is made, and the profiles of ``prefill_step`` and of a
   tick must hold no silu or bf16 product kernel of PyTorch's (a control
   first shows the check finds both in ``F.silu(g) * u``).
   The MoE path: qwen3-moe-30b-a3b (128 experts, top-8, QK-norm; w8a8
   attention, int8 w8 experts, bf16) at full width and all 48 layers, its
   weights drawn on the card from a seeded generator and quantized one
   block at a time as drawn (resident GB and the peak allocation
   printed): (a) the serve above on the paged cache (page 16, striped,
   bf16 pools), launch counts exact (an MoE layer: 2 K1, K3, K2 and K4;
   the experts run no kernel), each K4 call held against the plain
   version, then the same serve with the plain versions of K1-K3 swapped
   in: prefill logits, tokens and the whole KV cache bitwise equal; (b)
   ``prefill_step`` of 8192 tokens, one K5 a layer, each K5 call held
   against the plain version, profiled with the MoE block's stages
   (route, dequant, einsums, dispatch and combine) as named ranges; (c)
   the Scheduler trace plain and self_trunc (2-layer draft) on bf16
   pools, as the qwen2.5-3b runs are held, one tick of each profiled with
   the same ranges.
   The SSM and hybrid path: zamba2-7b (81 Mamba2 layers, d=3584,
   d_inner 7168, 112 SSD heads of 64, state 64; one shared attention +
   SwiGLU block of 32/32 heads of 112 and d_ff 14336 at 13 sites; w8a8,
   bf16) at full width and depth, drawn on the card and quantized block by
   block: (a) the dense serve above on its dense slot state, launch counts
   exact (a Mamba layer: 2 K1 and 6 K2; a site: a decoder layer's), then
   with the plain versions of K1-K3 and quant_act_glu swapped in: prefill
   logits, tokens and the whole state (``ssm_h``, conv tails,
   ``shared_k/v``) bitwise equal; (b) ``prefill_step`` of 8192 tokens, one
   K5 a site (D = 112, MHA), each K5 call held against the plain version,
   profiled with the Mamba2 stages and the shared block as named ranges
   (``SSM_RANGES``); (c) the Scheduler trace on the dense slots (no pool,
   no prefix sharing) on the model's first 12 layers (two shared sites),
   launch counts exact, one tick profiled, and again with ``spec=`` on the
   plain versions, which must warn that it degrades to 1-token decode and
   give the counted run's tokens and slot state after every tick.
   mamba2-370m (48 layers, d=1024) at full size through (a) and (c).
   The encoder-decoder path: seamless-m4t-medium (12 encoder + 12 decoder
   layers, d 1024, 16/16 heads of 64, d_ff 4096 GELU, vocab 256206
   untied; w8a8, bf16) at full width and depth, drawn on the card and
   quantized block by block: (a) 4 requests of 4096 seeded frames each,
   ``encode`` (12 K5, non-causal), then the serve above on the paged
   cache with ``memory=`` (cross-attention recomputes K and V over the
   16384 memory rows at every step), launch counts exact, each K4 and K5
   call held against the plain version, then bitwise against the plain
   K1-K3, memory included; 4 decode steps timed by stage with CUDA events
   (``ENCDEC_STAGES``) and profiled by kernel; (b) ``prefill_step`` of one
   request of 4096 frames and 256 tokens, timed by stage and profiled.
   The vision path: phi-3-vision-4.2b (32 layers, d 3072, 32/32 heads of
   96, d_ff 8192 SwiGLU) at full width and depth: (a) the text-only paged
   serve (K4 at head dim 96), bitwise against the plain versions; (b)
   ``prefill_step`` of 576 seeded patches and 7616 tokens, one K5 a layer,
   each held against the plain version, profiled.
   The training path: qwen2.5-3b (bf16, ``quant_proj="none"``, remat per
   block) at full width and all 36 layers, its ZeRO-1 state (bf16 compute
   copy, f32 master and AdamW moments, ~43 GB) drawn on the card from a
   seeded generator: the first step's loss and gradient norm with the
   plain attention swapped in (autograd through it), then 3 steps of
   ``make_train_step`` (``warmup_cosine`` AdamW) over 1 x 4096 SyntheticLM
   tokens, launch counts exact (K5 twice a layer, the forward and the
   remat recompute, its backward once, K1-K4 never), loss and gradient
   norm finite, the first step within 1e-2 / 5e-2 of the plain one; the
   step times, the peak allocation and a 4th step under
   ``torch.profiler``.  No checkpoint of that state is written (~43 GB).
   ``run_with_restarts`` at the smoke config on the card (checkpoints to a
   temporary directory, a failure injected at step 3): the restarted
   steps' losses equal the uninterrupted run's, bitwise or within 1e-6.
5. Card against CPU in f32, same weights, with exact launch counts on the
   card: unquantized (``none``) at full depth within rel-err 1e-5 on the
   dense cache and on the paged cache (one pass and chunked prefill);
   int8 KV pools and w8a8 (first 2 layers) printed; argmax agreement
   >= 0.99 for all (why: ``card_vs_cpu``).  ``prefill_step`` of
   qwen2.5-3b and of gemma2-27b at full width, 2 layers, 1024 tokens, in
   ``none``, with ``blockwise_attn_threshold=1024`` so K5 is on the path
   (and gemma2's window cut to 256 so it bites): within rel-err 1e-5,
   argmax agreement >= 0.99.  The Scheduler at qwen2.5-3b's width, 2
   layers, f32 ``none``: one ``spec_step`` from the same committed state
   (verify logits within rel-err 1e-5; pred, m, acc equal), and the
   phase 4 trace's plain and self_trunc runs (tokens equal, or first
   different at a near tie of the CPU run).  qwen3-moe-30b-a3b at full
   width, 2 layers, f32 ``none`` (float experts) on the dense and the
   paged cache: within rel-err 1e-5, argmax >= 0.99, and the routing of
   every token equal on both sides, or different only where the CPU's
   k-th and (k+1)-th router probabilities are a near tie (``ROUTE_TIE``;
   the count printed).  seamless-m4t-medium at full width, 2 + 2 layers,
   4 x 1024 frames with ``blockwise_attn_threshold`` 1024 (K5 non-causal
   in f32): the memory, then ``prefill(memory=)`` one pass and chunked and
   32 decode steps on the dense and the paged cache; phi-3-vision's
   ``prefill_step`` (576 patches + 448 tokens) beside qwen2.5-3b's and
   gemma2-27b's.  zamba2-7b at full width, 6 layers (layer 5 is a
   shared site), f32 ``none``, dense slots: the one-pass prefill and
   ``prefill(chunk=32)`` (each row's valid tokens as ``n_valid``), each
   with 32 decode steps, within rel-err 1e-5, argmax >= 0.99, launch
   counts exact, and the state each prefill commits within rel-err 1e-5.
   One f32 train step's gradients of qwen2.5-3b at full width, 2 layers,
   256 tokens with ``blockwise_attn_threshold=256`` (K5 and its backward on
   the card): loss within 1e-5, each leaf's gradient within 1e-4 relative
   norm, launch counts exact.
6. Timings at the slices' shapes: K5's backward at the training shape
   (the backward kernels alone in a CUDA graph and eagerly, the plain
   backward and SDPA's backward as the yardstick eagerly, between CUDA
   events; bound 10 D flops a visible pair and head at the bf16 peak; each
   backward kernel's device time a call comes from phase 4's profiled
   train step); K1 at every row
   mapping that takes each shape (distilbert's; qwen2.5-3b's decode, verify and prefill rows
   and the Scheduler trace's prefill rows over 2048 and 11008;
   gemma2-27b's 36864), each checked bitwise first, ``quant_act_glu``
   likewise at qwen2.5-3b's rows over 11008 beside the unfused path it
   replaces (PyTorch's silu and product, then K1; not a library call),
   and what binds it: L2-resident against cold operands (K1 the control)
   and f32 against bf16; each kernel, its plain version and a
   library yardstick (``torch._int_mm`` plus the epilogue, A zero-padded
   to M=32 at decode, and ``torch._int_mm`` alone beside it, the
   library's GEMM core without its unfused epilogue; K2 / K3 also at qwen2.5-3b's decode (M=4), verify
   (M=20) and 8192-token prefill shapes, and at qwen3-moe-30b-a3b's
   (the fused QKV and wo above, K1 over 4096) and zamba2-7b's (a Mamba
   layer's K1 over 3584 and 7168, K2 to 7168, 64, 112 and 7168 -> 3584;
   a site's K3 3584 -> 3584 x 3, K2 wo, gate / up, down, quant_act_glu
   over 14336; at 4 and 8192 rows; K5 at (1, 8192, 32/32, 112)),
   seamless-m4t-medium's (a decoder layer's at decode with the cross k /
   v over 16384 memory rows, an encoder layer's at 16384 rows, K4 at 16/16
   heads of 64, K5 at (4, 4096, 16/16, 64) non-causal) and phi-3-vision's
   (decode and 8192 rows, K4 at 32/32 heads of 96, K5 at (1, 8192, 32/32,
   96)), 10
   launches there and the plain versions timed eagerly; ``scaled_dot_product_attention`` over the gathered
   K/V for K4, and on the same q/k/v for K5 where it computes the same
   function: not with a softcap), beside the kernel's bound (for K4, the
   bytes of the K/V rows the lengths make visible; for K5, the flops of
   the visible (q, k) pairs at the tensor-core or f32 peak of the dtype;
   K5 also in f32 at qwen2.5-3b's shape).  K4's rows
   include the Scheduler's plain decode launch and name their split of
   the page walk; the profiler breakdowns of phase 4 sum K4's two kernels
   (the split walk and the combine) and K5's.  Times are
   device times: CUDA graphs of many launches, timed with CUDA events,
   over enough input copies (drawn on the card from seeded generators)
   that each launch finds its operands outside L2 (K5's plain version, which allocates GBs, eagerly between events).

Exits non-zero on any failure.  The last line is a JSON object naming the
device; the line before it lists each kernel's numbers.
"""
import collections
import contextlib
import copy
import importlib
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM data-sheet peaks (dense): memory, int8 and bf16 tensor cores,
# f32 ALUs; L2
from repro_torch.core.tiling import (BF16_OPS_PER_S, F32_OPS_PER_S,  # noqa: E402
                                     HBM_BYTES_PER_S, INT8_OPS_PER_S,
                                     L2_BYTES)
# phase 6's launches in one timed CUDA graph (each graph replayed 3 times):
# LAUNCHES at decode and chunk shapes, LONG_LAUNCHES at 8192-row ones (200,
# 10 and 5 replays until the training path's phases made room for
# themselves in the script's time: these rows' kernels are unchanged and
# their numbers stand in PERF.md)
LAUNCHES = 50
LONG_LAUNCHES = 4

BATCH_LENS = (64, 48, 33, 17)
DECODE_STEPS = 32
PAGE = 16
# K4 and K5 against their plain versions: the JAX package's own f32
# limits, and a rel-err for bf16 held in each row (one head of one query)
# at that row's scale (the kernels round the unnormalised p to bf16, the
# plain versions p / l)
ATTN_ATOL, ATTN_RTOL = 5e-6, 1e-5
ATTN_BF16_REL = 1e-2
# card vs CPU (phase 5): the unquantized model's limit (as the port's CPU
# tests hold 'none' against JAX), the w8a8 yardstick's depth, and argmax
CHECK_LAYERS = 2
TOL_NONE = 1e-5
TOL_ARGMAX = 0.99
# the long-prompt path: one prompt of this many tokens through
# prefill_step (phase 4), and the card-vs-CPU one (phase 5)
LONG_PROMPT = 8192
CHECK_PROMPT = 1024
# qwen2.5-3b's rows of K2 / K3 at decode, verify and the long prefill, and
# its K2 shapes (K, N): wo, gate / up, down
QWEN_M = (4, 20, LONG_PROMPT)
QWEN_GEMMS = ((2048, 2048), (2048, 11008), (11008, 2048))
# qwen3-moe-30b-a3b (the MoE path): its attention's fused QKV 2048 -> 4096 |
# 512 | 512 and wo 4096 -> 2048, at the same rows; its experts run no
# kernel (w8: dequantized, then PyTorch's einsums, as the reference)
MOE_ARCH = "qwen3_moe_30b_a3b"
MOE_QKV = (2048, 4096, 512)
MOE_WO = (4096, 2048)
# the wgmma widths of K2 / K3's tensor-core variants (wide: 256; swap: the
# activation rows padded), each built for K2 and for K3
GEMM_TMA_COLS = (256, 64, 32, 16, 8)
# the encoder-decoder and vision paths: seamless-m4t-medium serves 4
# requests of its config's fixed 4096 encoder frames each (so its cross
# K / V run over 16384 memory rows); its prefill_step takes one request of
# 4096 frames and 256 decoder tokens (a speech-to-text decoder prompt is
# short: the encoder carries the long sequence).  phi-3-vision's 576
# patches lead its prefill_step's LONG_PROMPT positions.
ENCDEC_ARCH, VLM_ARCH = "seamless_m4t_medium", "phi3_vision_4_2b"
ENC_FRAMES = 4096
ENCDEC_TEXT = 256
MEMORY_ROWS = 4 * ENC_FRAMES


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def randn(shape, seed, dev, scale=1.0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype).to(dev)


def device_randn(shape, seed, dev, scale=1.0, dtype=torch.float32):
    """``randn``'s normals drawn on ``dev`` by its own seeded generator:
    phase 6's operand copies (GBs over a phase), which the host's
    generator took most of the phase to draw."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------
def device_info():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}  torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    return smi


def build_kernels():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)})")
    for name, path in paths.items():
        print(f"  {path.relative_to(ROOT)}")
        for line in _build.ptxas_log(name).splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line or "Performance Loss" in line):
                print(f"    {line.strip()}")
        _build.library(name)
    check_sass()
    check_k1_sass()


# instruction → its SASS opcode
SASS_OPS = {"HGMMA": "HGMMA", "HMMA": "HMMA", "IGMMA": "IGMMA",
            "IMMA": "IMMA", "IDP4A": "IDP.4A", "FFMA": "FFMA"}


def sass_counts(name, ops=SASS_OPS):
    """Per kernel function of library ``name``: its instructions of each
    opcode in ``ops`` (by default tensor-core HGMMA / IGMMA: wgmma in bf16
    / int8, HMMA / IMMA: mma.sync; int8 ALU dot product IDP4A; f32 ALU
    FFMA) in ``cuobjdump -sass``; None without cuobjdump beside nvcc."""
    from repro_torch.kernels import _build
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    listing = subprocess.run(
        [str(tool), "-sass", str(_build.library_path(name))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op, code in ops.items():
                counts[fn][op] += f" {code}." in line or f" {code} " in line
    return counts


# K1's instructions by what they show: 16-byte loads, 8-byte stores, the
# exponential of SwiGLU's silu, the reciprocal behind each IEEE division
# (static counts: the rare exact-quotient path included), the wait at a
# cluster barrier
K1_SASS = {"LDG.128": "LDG.E.128", "STG.64": "STG.E.64",
           "MUFU.EX2": "MUFU.EX2", "MUFU.RCP": "MUFU.RCP",
           "cluster barrier": "UCGABAR_WAIT"}
K1_NAME = re.compile(
    r"quant_rowsI(f|13__nv_bfloat16)Lb([01])ELi(\d+)ELi(\d)ELi(\d+)E")
K1_ROWS = ("block", "cluster")
# plain / SwiGLU x block / cluster rows x the register arrays: bf16
# vectors of 1, 2, 4, 8; f32 vectors of 1, 2, 4; single values 4, 16 (each
# type)
K1_KERNELS = 2 * 2 * (4 + 3 + 2 + 2)


def check_k1_sass():
    """K1's variants in ``cuobjdump -sass``: each instantiation's counts of
    ``K1_SASS`` (per function, so per row held NV units); every vectorized
    one must load 16 bytes and store 8 bytes an access."""
    listing = sass_counts("quant_act", K1_SASS)
    if listing is None:
        fail("cuobjdump not found: K1's SASS cannot be checked")
    counts = {K1_NAME.search(fn).groups(): c for fn, c in listing.items()
              if K1_NAME.search(fn)}
    if len(counts) != K1_KERNELS:
        fail(f"K1: {len(counts)} kernel instantiations in the SASS listing, "
             f"expected {K1_KERNELS}")
    for (dt, glu, vec, rows, nv), c in sorted(counts.items()):
        label = (f"{'bf16' if dt != 'f' else 'f32'} "
                 f"{'swiglu' if glu == '1' else 'plain'} v{vec} "
                 f"{K1_ROWS[int(rows)]} nv{nv}")
        print(f"  sass quant_act: {label:28s} " + ", ".join(
            f"{op} {n}" for op, n in c.items()))
        if vec == "8" and not (c["LDG.128"] and c["STG.64"]):
            fail(f"K1 {label}: no 16-byte loads or 8-byte stores")


# K5's backward kernels (``csrc/flash_attention_bwd.cu``) by name: the
# bf16 products by wgmma, the f32 ones on the ALUs, and the passes that do
# no product (rowsum(dO * O) in both dtypes; the sum of the g heads' dK dV
# shares in bf16)
BWD_WGMMA = ("attention_bwd_dkdv_bf16", "attention_bwd_dq_bf16")
BWD_ALU = ("attention_bwd_dkdv_f32", "attention_bwd_dq_f32")
BWD_KERNELS = BWD_WGMMA + BWD_ALU + ("attention_bwd_delta",
                                     "attention_bwd_dkdv_sum")


def bwd_role(fn):
    """The name in BWD_KERNELS a (mangled) backward function carries."""
    return next((k for k in sorted(BWD_KERNELS, key=len, reverse=True)
                 if k in fn), fn)


def check_sass():
    """K5's bf16 kernels must run their products on the tensor cores
    (HGMMA in their SASS) and its f32 kernel on the ALUs (no tensor-core
    instruction: no TF32).  Its backward likewise: HGMMA in the bf16 dK dV
    and dQ kernels and in no other, FFMA in the f32 ones, no mma.sync
    anywhere.  K2 / K3's tensor-core variants (``gemm_tma``) must hold int8
    tensor-core instructions (IGMMA or IMMA) and no IDP4A."""
    bwd_seen = set()
    for name in ("flash_attention", "flash_attention_bwd", "paged_decode",
                 "int8_gemm"):
        counts = sass_counts(name)
        if counts is None:
            if name == "int8_gemm":
                fail("cuobjdump not found: K2 / K3's SASS cannot be checked")
            print(f"  sass {name}: cuobjdump not found (not listed)")
            continue
        for fn, c in counts.items():
            print(f"  sass {name}: {fn[:72]}: " + ", ".join(
                f"{op} {c[op]}" for op in SASS_OPS if c[op]
                or op in ("HGMMA", "FFMA")))
            if "gemm_tma" in fn and (not (c["IGMMA"] or c["IMMA"])
                                     or c["IDP4A"]):
                fail(f"{fn}: a K2 / K3 tensor-core variant without int8 "
                     "tensor-core instructions, or with IDP4A")
            if "flash_attention_bf16" in fn and not c["HGMMA"]:
                fail(f"{fn}: no HGMMA, K5's bf16 path is not on the tensor "
                     "cores")
            if "flash_attention_f32" in fn and (c["HGMMA"] or c["HMMA"]):
                fail(f"{fn}: tensor-core instructions in K5's f32 path")
            if "attention_bwd" in fn:
                bwd_seen.add(bwd_role(fn))
                if c["HMMA"] or (bool(c["HGMMA"])
                                 != (bwd_role(fn) in BWD_WGMMA)):
                    fail(f"{fn}: K5's backward products are to run by wgmma "
                         "in bf16 (HGMMA) and nowhere else (no other "
                         "tensor-core instruction)")
                if bwd_role(fn) in BWD_ALU and not c["FFMA"]:
                    fail(f"{fn}: K5's f32 backward is to run on the f32 "
                         "ALUs (FFMA)")
        if name == "flash_attention" and not any(
                "flash_attention_bf16" in fn for fn in counts):
            fail("K5's bf16 kernel not found in the SASS listing")
        if name == "flash_attention_bwd" and bwd_seen != set(BWD_KERNELS):
            fail(f"K5's backward kernels in the SASS listing: "
                 f"{sorted(bwd_seen)}, expected {sorted(BWD_KERNELS)}")
        if name == "int8_gemm" and sum("gemm_tma" in fn
                                       for fn in counts) < 2 * len(
                                           GEMM_TMA_COLS):
            fail("K2 / K3's tensor-core variants not all in the SASS "
                 "listing")


# ---------------------------------------------------------------------------
# 3. kernels vs plain versions
# ---------------------------------------------------------------------------
def zamba_shapes():
    """zamba2-7b's (the hybrid path's) kernel shapes: K2 (K, N) in a Mamba
    layer (in_z / in_x, in_B / in_C, in_dt, out_proj) and at a shared site
    (wo, gate / up, down), and the site's MHA fused QKV (K, Nq, Nkv)."""
    from repro_torch.configs import get_config
    cfg = get_config("zamba2_7b")
    d, di, f = cfg.d_model, cfg.d_inner, cfg.d_ff
    return (((d, di), (d, cfg.ssm_state), (d, cfg.ssm_n_heads), (di, d)),
            ((cfg.q_dim, d), (d, f), (f, d)), (d, cfg.q_dim, cfg.kv_dim))


def model_shapes(arch):
    """``arch``'s K2 shapes (K, N) in a decoder layer (wo, up or gate / up,
    down) and its fused QKV (K, Nq, Nkv).  seamless-m4t-medium's cross q,
    k, v and wo are its wo's shape, 1024 -> 1024."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    d, f = cfg.d_model, cfg.d_ff
    return ((cfg.q_dim, d), (d, f), (f, d)), (d, cfg.q_dim, cfg.kv_dim)


def quantized_operands(m, k, ns, dev, seed, draw=randn):
    """Per-row quantized A and per-channel quantized weights, K-major as
    the model stores them, from ``draw``'s normals."""
    from repro_torch.core.quantization import quantize
    from repro_torch.core.quantized_linear import quantize_weight
    a = quantize(draw((m, k), seed, dev), channel_axes=(0,))
    ws = [quantize_weight(draw((k, n), seed + 1 + i, dev, 0.05))
          for i, n in enumerate(ns)]
    return a, ws


def max_err(got, want, what):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        fail(f"{what}: kernel differs from its plain version (max |err| {err})")
    return err


# K1's shapes: distilbert's (prefill 256 rows, decode 4), qwen2.5-3b's
# decode, verify and 8192-token prefill rows over d_model and d_ff (and
# qwen3-moe's wo input, 4096),
# gemma2-27b's d_ff, and ragged ones (K not a multiple of 8: one value an
# access; rows past a multiple of the SMs)
K1_SHAPES = [(256, 768), (256, 3072), (4, 768), (4, 3072),
             *[(m, k) for m in QWEN_M for k in (2048, 11008)],
             *[(m, MOE_WO[0]) for m in QWEN_M],
             (4, 36864), (LONG_PROMPT, 36864), (5, 770), (129, 11008),
             *[(m, k) for m in QWEN_M for k in (3584, 7168)],
             # seamless-m4t-medium's rows (decode, the serve's prefill, the
             # memory of one request and of four) over d_model and d_ff;
             # phi-3-vision's (decode, prefill, prefill_step) over its own
             *[(m, k) for m in (4, 256, ENC_FRAMES, MEMORY_ROWS)
               for k in (1024, 4096)],
             *[(m, k) for m in (4, 256, LONG_PROMPT) for k in (3072, 8192)]]
# quant_act_glu's: qwen2.5-3b's d_ff at decode, verify and prefill, ragged,
# zamba2-7b's shared d_ff
GLU_SHAPES = [*[(m, 11008) for m in QWEN_M], (5, 770), (129, 11008),
              (3, 64), *[(m, 14336) for m in QWEN_M],
              *[(m, 8192) for m in (4, 20, 256, LONG_PROMPT)]]


def k1_rows(shape, seed, dev, dtype):
    """Rows of normal values, among them a zero row, a row of one huge
    value (its others quantize to 0) and a row on a tiny scale."""
    x = randn(shape, seed, dev, 3.0)
    x[0] = 0
    if shape[0] > 2:
        x[1, shape[1] // 3] = 3e4
        x[2] *= 1e-3
    return x.to(dtype)


def k1_plan_text(x):
    from repro_torch.kernels.quant_act.ops import is_aligned, quant_plan
    return str(quant_plan(*x.shape, x.dtype, is_aligned(x)))


def check_glu_h(dev):
    """quant_act_glu's h = silu(g) * u bitwise PyTorch's for g every finite
    bf16 value (in bf16, and as f32), u = 1 and u drawn from a seed; with
    u = 1 (no product overflows) its quantization too."""
    from repro_torch.kernels.quant_act.ops import quant_act_glu
    from repro_torch.kernels.quant_act.ref import quant_act_glu_ref
    g = torch.arange(2 ** 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    g = g[torch.isfinite(g)]
    n = len(g)
    g = torch.cat([g, g.new_zeros(-n % 1024)]).reshape(-1, 1024).to(dev)
    for dt in (torch.bfloat16, torch.float32):
        gd = g.to(dt)
        for name, u in (("u = 1", torch.ones_like(gd)),
                        ("u seeded", randn(tuple(gd.shape), 9, dev, 1.0, dt))):
            h = torch.empty_like(gd)
            q = quant_act_glu(gd, u, h_out=h)
            max_err(h, torch.nn.functional.silu(gd) * u,
                    f"quant_act_glu h over every finite bf16 gate, {dt}, "
                    f"{name}")
            if name == "u = 1":
                v, s = quant_act_glu_ref(gd, u)
                max_err(q.values, v, f"quant_act_glu of every bf16 gate {dt}")
                max_err(q.scale, s, f"quant_act_glu of every bf16 gate {dt}")
        print(f"  ok quant_act_glu h bitwise F.silu(gate) * up over all {n} "
              f"finite bf16 gates, {dt}, u = 1 and u seeded")


def check_kernels(dev):
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.fused_qkv.ref import fused_qkv_ref
    from repro_torch.kernels.quant_act.ops import quant_act, quant_act_glu
    from repro_torch.kernels.quant_act.ref import (quant_act_glu_ref,
                                                   quant_act_ref)
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref

    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"quant_act": 0.0, "quant_act_glu": 0.0, "tiled_matmul": 0.0,
            "fused_qkv": 0.0}
    for m, k in K1_SHAPES:
        for dt in (bf16, f32):
            x = k1_rows((m, k), m + k, dev, dt)
            q = quant_act(x)
            v, s = quant_act_ref(x)
            what = f"quant_act ({m},{k}) {dt} [{k1_plan_text(x)}]"
            errs["quant_act"] = max(errs["quant_act"],
                                    max_err(q.values, v, what),
                                    max_err(q.scale, s, what + " scale"))
            del x, q, v, s
            print(f"  ok {what}")
    for m, k in GLU_SHAPES:
        for dt in (bf16, f32):
            g = k1_rows((m, k), m, dev, dt)
            u = randn((m, k), m + 1, dev, 1.0, dt)
            h = torch.empty_like(g)
            q = quant_act_glu(g, u, h_out=h)
            v, s = quant_act_glu_ref(g, u)
            what = (f"quant_act_glu ({m},{k}) {dt} [{k1_plan_text(g)}], h "
                    "against F.silu(gate) * up")
            errs["quant_act_glu"] = max(
                errs["quant_act_glu"], max_err(q.values, v, what),
                max_err(q.scale, s, what + " scale"),
                max_err(h, torch.nn.functional.silu(g) * u, what + " h"))
            del g, u, h, q, v, s
            print(f"  ok {what}")
    check_glu_h(dev)
    gemms = [(64, 768, 3072, f32, False), (64, 768, 3072, f32, True),
             (256, 768, 768, bf16, False), (256, 768, 3072, bf16, False),
             (256, 3072, 768, bf16, False), (256, 768, 3072, bf16, True),
             (4, 768, 768, bf16, False), (4, 768, 3072, bf16, False),
             (4, 3072, 768, bf16, False), (5, 770, 100, f32, True),
             (5, 770, 100, bf16, False)]
    # qwen2.5-3b's served shapes at decode, verify and an 8192-token
    # prefill (wo, gate / up, down), then ragged M on the tensor-core
    # variants; bias on and off, bf16 and f32 out
    for m in QWEN_M:
        for k, n in QWEN_GEMMS:
            gemms.append((m, k, n, bf16, False))
        gemms.append((m, 2048, 2048, f32, True))
    gemms += [(5, 2048, 2048, bf16, True), (20, 11008, 2048, f32, False),
              (129, 2048, 11008, bf16, True), (129, 11008, 2048, f32, False)]
    # qwen3-moe's wo at decode, verify and the long prefill
    gemms += [(m, *MOE_WO, bf16, False) for m in QWEN_M]
    # zamba2-7b's, the narrowest outputs served (64, 112) among them
    z_mamba, z_site, z_qkv = zamba_shapes()
    zamba = z_mamba + z_site
    gemms += [(m, k, n, bf16, False) for m in QWEN_M for k, n in zamba]
    # seamless-m4t-medium's (wo and cross q / k / v / wo, up, down) at
    # decode, the serve's prefill rows, and the memory rows of one request
    # and of four (the cross k / v of every decode step); phi-3-vision's
    # (wo, gate / up, down) at decode, prefill and prefill_step
    (s_gemms, s_qkv), (v_gemms, v_qkv) = (model_shapes(ENCDEC_ARCH),
                                          model_shapes(VLM_ARCH))
    served = zamba + s_gemms + v_gemms
    gemms += [(m, k, n, bf16, False) for m in (4, 256, ENC_FRAMES,
                                               MEMORY_ROWS)
              for k, n in s_gemms]
    gemms += [(m, k, n, bf16, False) for m in (4, 256, LONG_PROMPT)
              for k, n in v_gemms]
    for m, k, n, out_dtype, bias in gemms:
        a, (b,) = quantized_operands(m, k, [n], dev, seed=m + n)
        bi = randn((n,), 7, dev) if bias else None
        out = tiled_matmul(a, b, bi, out_dtype=out_dtype)
        ref = tiled_matmul_ref(a.values, a.scale, b.values, b.scale, bi,
                               out_dtype)
        what = (f"tiled_matmul ({m},{k})x({k},{n}) {out_dtype} bias={bias} "
                f"[{plan_text(m, [n], k, out_dtype, a, [b])}]")
        if (k, n) == MOE_WO or (k, n) in served:
            tensor_cores(what)
        errs["tiled_matmul"] = max(errs["tiled_matmul"],
                                   max_err(out, ref, what))
        del a, b, out, ref
        print(f"  ok {what}")

    qkv = [(256, 768, 768, 768, f32), (64, 2048, 2048, 256, f32),
           (4, 768, 768, 768, f32)]
    qkv += [(m, 2048, 2048, 256, dt) for m in QWEN_M + (5, 129)
            for dt in (f32, bf16)]
    qkv += [(m, *MOE_QKV, dt) for m in QWEN_M for dt in (f32, bf16)]
    qkv += [(m, *z_qkv, dt) for m in QWEN_M for dt in (f32, bf16)]
    qkv += [(m, *s_qkv, dt) for m in (4, 256, MEMORY_ROWS)
            for dt in (f32, bf16)]
    qkv += [(m, *v_qkv, dt) for m in (4, 256, LONG_PROMPT)
            for dt in (f32, bf16)]
    for m, k, nq, nkv, out_dtype in qkv:
        a, ws = quantized_operands(m, k, [nq, nkv, nkv], dev, seed=m + nq)
        outs = fused_qkv(a, *ws, out_dtype=out_dtype)
        refs = fused_qkv_ref(a.values, a.scale, ws[0].values, ws[0].scale,
                             ws[1].values, ws[1].scale, ws[2].values,
                             ws[2].scale, out_dtype=out_dtype)
        what = (f"fused_qkv ({m},{k})x({k},{nq}|{nkv}|{nkv}) {out_dtype} "
                f"[{plan_text(m, [nq, nkv, nkv], k, out_dtype, a, ws)}]")
        if (k, nq, nkv) in (MOE_QKV, z_qkv, s_qkv, v_qkv):
            tensor_cores(what)
        for o, r in zip(outs, refs):
            errs["fused_qkv"] = max(errs["fused_qkv"], max_err(o, r, what))
        print(f"  ok {what}")
    return errs


def tensor_cores(what):
    """Fail unless ``what`` (a case named by ``plan_text``) planned onto a
    tensor-core variant, as every served shape must."""
    if "[general]" in what:
        fail(f"{what}: planned onto the general (__dp4a) variant")


def plan_text(m, ns, k, out_dtype, a, ws):
    """The plan the wrappers launch at these operands: the dispatcher's
    (``core/dispatch.py``: the shipped table's where it has the shape)."""
    from repro_torch.kernels.tiled_matmul.ops import plan_for
    plan = plan_for(m, tuple(ns), k, out_dtype, a.values,
                    *(w.values for w in ws))
    if plan.variant == "general":
        return "general"
    return f"{plan.variant} n{plan.cols} split {plan.split}"


def paged_inputs(b, t, h, kh, d, lens, dev, *, qs=1, page=PAGE, kv="bf16",
                 q_dtype=None, alloc="striped", seed=0):
    """The wrapper's operands for a random K/V history of ``t`` tokens per
    sequence, scattered into page pools through a ``default_page_table``:
    pools in f32, bf16, or int8 with scale pools (``kv``); q of
    ``q_dtype`` (default: bf16 with bf16 pools, else f32)."""
    from repro_torch.core.quantization import quantize_kv
    from repro_torch.serving.cache import default_page_table
    table = default_page_table(b, t // page, alloc).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def pool():
        hist = torch.randn((b * (t // page), page, kh, d), generator=gen,
                           device=dev)
        out = torch.empty_like(hist)
        out[table.flatten().long()] = hist      # page j of sequence b
        return out.to(torch.bfloat16) if kv == "bf16" else out

    c = {"k_pages": pool(), "v_pages": pool(), "page_table": table,
         "lengths": torch.tensor(lens, dtype=torch.int32, device=dev)}
    q_dtype = q_dtype or (torch.bfloat16 if kv == "bf16" else torch.float32)
    c["q"] = torch.randn((b, qs, h, d), generator=gen, device=dev).to(q_dtype)
    if kv == "int8":
        c["k_pages"], c["k_scales"] = quantize_kv(c["k_pages"])
        c["v_pages"], c["v_scales"] = quantize_kv(c["v_pages"])
    return c


# name, b, t, h, kh, d, lens, options: distilbert decode (the first decode
# step's lengths) and prefill (one 64-row q block), a chunked prefill in
# 128-row q blocks, GQA at head_dim 128, window + softcap
PAGED_CHECKS = [
    ("decode", 4, 96, 12, 12, 64, [65, 49, 34, 18], {}),
    ("prefill", 4, 96, 12, 12, 64, [64] * 4, dict(qs=64, q_chunk=128)),
    ("chunked", 2, 208, 12, 12, 64, [200, 200], dict(qs=200, q_chunk=128)),
    ("gqa", 2, 256, 16, 2, 128, [256, 77], {}),
    ("window_softcap", 2, 128, 12, 12, 64, [100, 23],
     dict(window=20, softcap=50.0)),
    # phi-3-vision's text decoder: MHA, 32/32 heads of 96
    ("phi3 decode", 4, 96, 32, 32, 96, [65, 49, 34, 18], {}),
    ("phi3 prefill", 4, 96, 32, 32, 96, [64] * 4, dict(qs=64, q_chunk=128)),
]
# the cases held to K4's bitwise contracts
PAGED_BITWISE = PAGED_CHECKS[:3] + PAGED_CHECKS[-2:]
# kv pools, q dtype (the limit follows q's dtype: attention_agrees)
PAGED_MODES = [("f32", torch.float32), ("bf16", torch.bfloat16),
               ("int8", torch.float32), ("int8", torch.bfloat16)]


def row_rel_err(got, want):
    """The worst row's rel-err, a row being one head of one query (the
    last axis): max |got - want| / max |want| within the row.  A long walk
    averages thousands of values into a row far smaller than the first
    rows' single ones, so each row is held at its own scale; a row the
    masks leave empty (want 0) must be 0."""
    diff = (got.double() - want.double()).abs().amax(-1)
    size = want.double().abs().amax(-1)
    ratio = torch.where(size > 0, diff / size.clamp_min(1e-300),
                        torch.where(diff > 0, float("inf"), 0.0))
    return ratio.max().item()


def attention_agrees(got, want, what="paged_decode"):
    """An attention kernel's output (K4's or K5's) against its plain
    version's on the same operands: within atol/rtol for f32 q, within the
    per-row rel-err limit for bf16 q (the limits of K4 and K5 are the
    same).  Returns (ok, max |err|, per-row rel-err, the limit as text)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(want.shape)} {want.dtype}")
    diff = (got.double() - want.double()).abs()
    err, rel = diff.max().item(), row_rel_err(got, want)
    if got.dtype == torch.float32:
        ok = bool((diff <= ATTN_ATOL + ATTN_RTOL * want.double().abs()).all())
        return ok, err, rel, f"atol {ATTN_ATOL}, rtol {ATTN_RTOL}"
    return (rel <= ATTN_BF16_REL, err, rel,
            f"per-row rel-err limit {ATTN_BF16_REL}")


def split_opts(opts):
    opts = dict(opts)
    return opts.pop("qs", 1), opts


def check_paged(dev):
    """K4 against its plain version on the same CUDA tensors, and its two
    bitwise invariants.  Returns (max |err| under the f32 limits, max
    rel-err under the bf16 limit)."""
    from repro_torch.kernels.flash_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ref import \
        paged_decode_attention_ref
    worst_abs = worst_rel = 0.0
    for name, b, t, h, kh, d, lens, opts in PAGED_CHECKS:
        qs, opts = split_opts(opts)
        for kv, q_dtype in PAGED_MODES:
            c = paged_inputs(b, t, h, kh, d, lens, dev, qs=qs, kv=kv,
                             q_dtype=q_dtype, seed=b * t + h)
            got = paged_decode_attention(**c, **opts)
            want = paged_decode_attention_ref(**c, **opts)
            torch.cuda.synchronize()
            ok, err, rel, limit = attention_agrees(got, want)
            what = (f"paged_decode {name} kv={kv} q={str(q_dtype)[6:]} "
                    f"({b}x{qs}x{h}x{d}, KH={kh}, lens={lens}"
                    f"{', ' + str(opts) if opts else ''})")
            if q_dtype == torch.float32:
                worst_abs = max(worst_abs, err)
            else:
                worst_rel = max(worst_rel, rel)
            print(f"  {'ok' if ok else 'FAIL'} {what}: max |err| {err:.3e}, "
                  f"per-row rel-err {rel:.3e} ({limit})")
            if not ok:
                fail(f"{what}: kernel differs from its plain version")

    # bitwise: the same history through two page tables, and the int8
    # pools against the f32 launch on the pools dequantized beforehand
    for name, b, t, h, kh, d, lens, opts in PAGED_BITWISE:
        qs, opts = split_opts(opts)
        outs = [paged_decode_attention(**paged_inputs(
                    b, t, h, kh, d, lens, dev, qs=qs, kv="bf16", alloc=alloc,
                    seed=1), **opts) for alloc in ("striped", "contiguous")]
        c = paged_inputs(b, t, h, kh, d, lens, dev, qs=qs, kv="int8", seed=2)
        ks, vs = c.pop("k_scales"), c.pop("v_scales")
        got = paged_decode_attention(**c, k_scales=ks, v_scales=vs, **opts)
        fp = paged_decode_attention(**dict(
            c, k_pages=c["k_pages"].float() * ks[..., None],
            v_pages=c["v_pages"].float() * vs[..., None]), **opts)
        torch.cuda.synchronize()
        if not torch.equal(outs[0], outs[1]):
            fail(f"paged_decode {name}: striped and contiguous tables differ")
        if not torch.equal(got, fp):
            fail(f"paged_decode {name}: int8 pools differ from the f32 "
                 "launch on the pools dequantized beforehand")
        print(f"  ok paged_decode {name}: striped == contiguous table, "
              "int8 == f32 on pre-dequantized pools (bitwise)")
    return worst_abs, worst_rel


# name, b, t, h, kh, d, page, committed lengths, new_lens, options: the
# served verify pass (qwen2.5-3b's heads, n_draft 4 so 5 rows, an idle
# slot), the JAX package's own verify-test shapes, a window
VERIFY_Q = 5
VERIFY_LENS = [45, 205, 365, 560]          # the timed verify launch
VERIFY_CHECKS = [
    ("served", 4, 576, 16, 2, 128, PAGE, [40, 300, 200, 555], [5, 5, 0, 5],
     {}),
    ("served all live", 4, 576, 16, 2, 128, PAGE, [40, 200, 360, 555],
     [5] * 4, {}),
    ("reference", 2, 64, 4, 2, 16, 8, [36, 20], [3, 1], {}),
    ("window", 3, 128, 8, 1, 64, PAGE, [100, 10, 60], [2, 4, 1],
     dict(window=20)),
]


def verify_inputs(name, kv, q_dtype, dev, seed=0):
    """One VERIFY_CHECKS case's operands: lengths are the committed
    lengths plus the live rows."""
    _, b, t, h, kh, d, page, committed, new_lens, opts = next(
        c for c in VERIFY_CHECKS if c[0] == name)
    lens = [c + n for c, n in zip(committed, new_lens)]
    c = paged_inputs(b, t, h, kh, d, lens, dev, qs=VERIFY_Q, page=page,
                     kv=kv, q_dtype=q_dtype, seed=seed)
    c["new_lens"] = torch.tensor(new_lens, dtype=torch.int32, device=dev)
    return c, dict(opts)


def dead_rows_zero(out, new_lens):
    return all(not out[b, n:].any() for b, n in enumerate(new_lens.tolist()))


def check_verify(dev):
    """K4's verify mode (``new_lens``) against its plain version on the same
    CUDA tensors at phase 3's limits, dead rows (and an idle slot) exactly
    0; a one-row verify launch bitwise the plain launch; live rows of a
    variable-row launch against exact-width launches per sequence.
    Returns (max |err| under the f32 limits, max rel-err under the bf16
    limit)."""
    from repro_torch.kernels.flash_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ref import \
        paged_decode_attention_ref
    worst_abs = worst_rel = 0.0
    for name, b, t, h, kh, d, page, committed, new_lens, _ in VERIFY_CHECKS:
        for kv, q_dtype in PAGED_MODES:
            c, opts = verify_inputs(name, kv, q_dtype, dev, seed=b * t + h)
            got = paged_decode_attention(**c, **opts)
            want = paged_decode_attention_ref(**c, **opts)
            torch.cuda.synchronize()
            ok, err, rel, limit = attention_agrees(got, want)
            ok = ok and dead_rows_zero(got, c["new_lens"])
            what = (f"paged_decode verify {name} kv={kv} q="
                    f"{str(q_dtype)[6:]} ({b}x{VERIFY_Q}x{h}x{d}, KH={kh}, "
                    f"page {page}, committed {committed}, new_lens "
                    f"{new_lens}{', ' + str(opts) if opts else ''})")
            if q_dtype == torch.float32:
                worst_abs = max(worst_abs, err)
            else:
                worst_rel = max(worst_rel, rel)
            print(f"  {'ok' if ok else 'FAIL'} {what}: max |err| {err:.3e}, "
                  f"per-row rel-err {rel:.3e} ({limit}), dead rows 0")
            if not ok:
                fail(f"{what}: kernel differs from its plain version")

    # one live row: bitwise the plain launch, every pool type, window
    # on and off, at the served heads
    for kv, q_dtype in PAGED_MODES:
        for window in (None, 20):
            c = paged_inputs(4, 576, 16, 2, 128, [45, 301, 201, 560], dev,
                             kv=kv, q_dtype=q_dtype, seed=5)
            plain = paged_decode_attention(**c, window=window)
            one = paged_decode_attention(
                **c, window=window, new_lens=torch.ones_like(c["lengths"]))
            torch.cuda.synchronize()
            if not torch.equal(plain, one):
                fail(f"paged_decode verify: new_lens=1 differs from the plain "
                     f"launch (kv={kv}, q={q_dtype}, window={window})")
    print("  ok paged_decode verify: new_lens = 1 is bitwise the plain launch "
          "(f32, bf16, int8 pools; window none and 20)")

    # variable rows against exact-width launches per sequence, f32
    for name in ("served", "reference"):
        c, _ = verify_inputs(name, "f32", torch.float32, dev, seed=7)
        got = paged_decode_attention(**c)
        worst = 0.0
        for b, n in enumerate(c["new_lens"].tolist()):
            if n == 0:
                continue
            want = paged_decode_attention(
                c["q"][b:b + 1, :n].contiguous(), c["k_pages"], c["v_pages"],
                c["page_table"][b:b + 1], c["lengths"][b:b + 1])
            ok, err, _, limit = attention_agrees(got[b:b + 1, :n], want)
            worst = max(worst, err)
            if not ok:
                fail(f"paged_decode verify {name}: sequence {b}'s live rows "
                     f"differ from its exact-width launch ({err:.3e})")
        print(f"  ok paged_decode verify {name}: live rows against "
              f"exact-width launches per sequence, max |err| {worst:.3e} "
              f"({limit})")
    return worst_abs, worst_rel


# K4's walk split over blocks: contexts of ~4096 tokens (qwen2.5-3b's
# heads) in pages of 16 and of 64, plain (1 row) and verify (5 rows, 5 and
# 3 live)
SPLIT_LENS = [4096, 3001]
SPLIT_NEW_LENS = [5, 3]


def check_paged_splits(dev):
    """K4 at contexts whose walks span several splits, every pool type,
    plain and verify: within phase 3's limits of the plain version, dead
    rows 0, and its four bitwise contracts (two launches agree, striped and
    contiguous tables agree, a one-row verify launch is the plain launch,
    int8 pools are their f32 pools dequantized beforehand).  Returns (max
    |err| under the f32 limits, max rel-err under the bf16 limit)."""
    from repro_torch.kernels.flash_attention.decode import (
        flash_decode_schedule, split_plan)
    from repro_torch.kernels.flash_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ref import \
        paged_decode_attention_ref
    worst_abs = worst_rel = 0.0
    b, t, h, kh, d = 2, 4096, 16, 2, 128
    for page in (16, 64):
        for qs in (1, VERIFY_Q):
            plan = split_plan(b, kh, h // kh, flash_decode_schedule(
                t // page, page, q_len=qs))
            if plan.n_splits < 2:
                fail(f"paged_decode splits page {page}: {plan} is one split")
            for kv, q_dtype in PAGED_MODES:
                def inputs(alloc, seed=3):
                    c = paged_inputs(b, t, h, kh, d, SPLIT_LENS, dev, qs=qs,
                                     page=page, kv=kv, q_dtype=q_dtype,
                                     alloc=alloc, seed=seed)
                    if qs > 1:
                        c["new_lens"] = torch.tensor(
                            SPLIT_NEW_LENS, dtype=torch.int32, device=dev)
                    return c
                c = inputs("striped")
                got = paged_decode_attention(**c)
                again = paged_decode_attention(**c)
                other = paged_decode_attention(**inputs("contiguous"))
                one = {k: v for k, v in c.items() if k != "new_lens"}
                one["q"] = c["q"][:, :1].contiguous()
                plain = paged_decode_attention(**one)
                verify = paged_decode_attention(
                    **one, new_lens=torch.ones_like(c["lengths"]))
                want = paged_decode_attention_ref(**c)
                torch.cuda.synchronize()
                what = (f"paged_decode splits page {page} kv={kv} q="
                        f"{str(q_dtype)[6:]} ({b}x{qs}x{h}x{d}, KH={kh}, "
                        f"lens {SPLIT_LENS}"
                        + (f", new_lens {SPLIT_NEW_LENS}" if qs > 1 else "")
                        + f"; {plan.n_splits} splits of "
                        f"{plan.pages_per_split} pages)")
                ok, err, rel, limit = attention_agrees(got, want)
                if qs > 1:
                    ok = ok and dead_rows_zero(got, c["new_lens"])
                if not ok:
                    fail(f"{what}: kernel differs from its plain version: "
                         f"max |err| {err:.3e}, per-row rel-err {rel:.3e}")
                if not torch.equal(got, again):
                    fail(f"{what}: two launches differ")
                if not torch.equal(got, other):
                    fail(f"{what}: striped and contiguous tables differ")
                if not torch.equal(plain, verify):
                    fail(f"{what}: a one-row verify launch differs from the "
                         "plain launch")
                if kv == "int8" and q_dtype == torch.float32:
                    ks, vs = c.pop("k_scales"), c.pop("v_scales")
                    fp = paged_decode_attention(**dict(
                        c, k_pages=c["k_pages"].float() * ks[..., None],
                        v_pages=c["v_pages"].float() * vs[..., None]))
                    torch.cuda.synchronize()
                    if not torch.equal(got, fp):
                        fail(f"{what}: int8 pools differ from the f32 launch "
                             "on the pools dequantized beforehand")
                if q_dtype == torch.float32:
                    worst_abs = max(worst_abs, err)
                else:
                    worst_rel = max(worst_rel, rel)
                print(f"  ok {what}: max |err| {err:.3e}, per-row rel-err "
                      f"{rel:.3e} ({limit}); bitwise: repeat, striped == "
                      "contiguous, one-row verify == plain"
                      + (", int8 == pre-dequantized f32"
                         if kv == "int8" and q_dtype == torch.float32
                         else ""))
    return worst_abs, worst_rel


def flash_inputs(b, s, t, h, kh, d, dev, dtype, seed):
    """q (B, S, H, D) and k, v (B, T, KH, D), normal, drawn on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))


# name, b, s (= t), h, kh, d, dtype, options: the served shapes (qwen2.5-3b
# causal, gemma2-27b's local and global layers with their scale and
# softcap) in bf16 and again in f32, whose limit holds every row of a long
# walk to 1e-5 of itself; then f32 ones: non-causal windowed, partial
# tiles at benchmarks/flash_attention.py's smoke shape, distilbert's width
SERVED_FLASH = [
    ("qwen2.5-3b causal", 1, LONG_PROMPT, 16, 2, 128, {}),
    ("gemma2-27b local", 1, LONG_PROMPT, 32, 16, 128,
     dict(scale=144 ** -0.5, window=4096, softcap=50.0)),
    ("gemma2-27b global", 1, LONG_PROMPT, 32, 16, 128,
     dict(scale=144 ** -0.5, softcap=50.0)),
    # MHA (one head a KV group) at head dim 112, zero-padded to 128 in the
    # bf16 kernel
    ("zamba2-7b causal", 1, LONG_PROMPT, 32, 32, 112, {}),
    # seamless-m4t-medium's encoder (MHA at head dim 64, bidirectional,
    # each row over all 4096 frames) and phi-3-vision (MHA at head dim 96)
    ("seamless-m4t-medium encoder", 4, ENC_FRAMES, 16, 16, 64,
     dict(causal=False)),
    ("phi-3-vision causal", 1, LONG_PROMPT, 32, 32, 96, {}),
]
FLASH_CHECKS = [
    *[(n, b, s, h, kh, d, dt, o) for dt in (torch.bfloat16, torch.float32)
      for n, b, s, h, kh, d, o in SERVED_FLASH],
    ("non-causal window", 2, 1000, 8, 2, 64, torch.float32,
     dict(causal=False, window=300)),
    ("partial tiles", 1, 300, 4, 2, 64, torch.float32, dict(window=128)),
    ("distilbert width", 4, 512, 12, 12, 64, torch.float32, {}),
]


def check_flash(dev):
    """K5 against its plain version on the same CUDA tensors.  Returns (max
    |err| under the f32 limits, max rel-err under the bf16 limit)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    worst_abs = worst_rel = 0.0
    for i, (name, b, s, h, kh, d, dtype, opts) in enumerate(FLASH_CHECKS):
        q, k, v = flash_inputs(b, s, s, h, kh, d, dev, dtype, seed=10 + i)
        got = flash_attention(q, k, v, **opts)
        want = attention_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        ok, err, rel, limit = attention_agrees(got, want, "flash_attention")
        if dtype == torch.float32:
            worst_abs = max(worst_abs, err)
        else:
            worst_rel = max(worst_rel, rel)
        what = (f"flash_attention {name} ({b}x{s}x{h}x{d}, KH={kh}, "
                f"{str(dtype)[6:]}{', ' + str(opts) if opts else ''})")
        print(f"  {'ok' if ok else 'FAIL'} {what}: max |err| {err:.3e}, "
              f"per-row rel-err {rel:.3e} ({limit})")
        if not ok:
            fail(f"{what}: kernel differs from its plain version")
        del q, k, v, got, want
    return worst_abs, worst_rel


# ---------------------------------------------------------------------------
# 4-5. the main path, and card vs CPU
# ---------------------------------------------------------------------------
def make_prompts(cfg, dev):
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (len(BATCH_LENS), max(BATCH_LENS)), generator=g)
    return prompts.to(dev), torch.tensor(BATCH_LENS, device=dev)


def embeds_for(cfg, b, t, dev, seed=5):
    """``b`` requests of ``t`` input embeddings (B, T, D) f32, drawn on
    ``dev`` from a seed: an encoder-decoder's frames, the vision family's
    patches."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((b, t, cfg.d_model), generator=g, device=dev)


def serve(model, cfg, dev, config=None):
    """The smoke serve on a dense cache, or on the paged one ``config``
    describes (whose decode starts from the cache's own ``seq_lens``).  An
    encoder-decoder first encodes ENC_FRAMES seeded frames a request (in
    the prefill time), serves with that memory, and returns it in the
    cache dict as ``memory``, for the checks."""
    from repro_torch.models import transformer
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import greedy_decode, prefill
    prompts, lens = make_prompts(cfg, dev)
    cache = init_cache(cfg, len(BATCH_LENS), max(BATCH_LENS) + DECODE_STEPS,
                       dtype=cfg.activation_dtype, config=config, device=dev)
    frames = (embeds_for(cfg, len(BATCH_LENS), ENC_FRAMES, dev)
              if cfg.is_encoder_decoder else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    memory = (None if frames is None
              else transformer.encode(model, frames, cfg))
    next_logits, cache = prefill(model, cache, prompts, lens, cfg,
                                 memory=memory)
    first = torch.argmax(next_logits, dim=-1)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, cache = greedy_decode(model, cache, first,
                                lens if config is None else None,
                                DECODE_STEPS, cfg, memory=memory)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if memory is not None:
        cache["memory"] = memory
    return next_logits, toks, cache, t1 - t0, t2 - t1


# the modules of the dense main path that call the kernel wrappers
WRAPPER_CALLERS = ("repro_torch.core.quantized_linear",
                   "repro_torch.core.qkv_fusion")


@contextlib.contextmanager
def plain_versions():
    """Within the block, the dense main path calls the kernels' plain
    versions (on whatever device its tensors are) where it called the
    wrappers."""
    from repro_torch.core.quantization import QTensor
    from repro_torch.kernels.fused_qkv.ref import fused_qkv_ref
    from repro_torch.kernels.quant_act.ref import (quant_act_glu_ref,
                                                   quant_act_ref)
    from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref

    def quant_act(x):
        values, scale = quant_act_ref(x)
        return QTensor(values=values, scale=scale, bits=8)

    def quant_act_glu(gate, up):
        values, scale = quant_act_glu_ref(gate, up)
        return QTensor(values=values, scale=scale, bits=8)

    def tiled_matmul(a, b, bias=None, *, out_dtype=torch.bfloat16):
        return tiled_matmul_ref(a.values, a.scale, b.values, b.scale, bias,
                                out_dtype)

    def fused_qkv(a, wq, wk, wv, *, out_dtype=torch.bfloat16):
        return fused_qkv_ref(a.values, a.scale, wq.values, wq.scale,
                             wk.values, wk.scale, wv.values, wv.scale,
                             out_dtype=out_dtype)

    plain = {"quant_act": quant_act, "quant_act_glu": quant_act_glu,
             "tiled_matmul": tiled_matmul, "fused_qkv": fused_qkv}
    saved = []
    for mod in map(importlib.import_module, WRAPPER_CALLERS):
        for name, fn in plain.items():
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def layer_launches(cfg, *, paged=False, flash=False, verify=False,
                   cross=False) -> dict:
    """One layer's kernel launches in one forward of ``cfg``.  Under w8a8:
    one quant_act for the fused QKV (one fused_qkv), one for wo, one for
    the FFN's input, which serves gate and up alike; the down projection's
    input is one quant_act_glu in SwiGLU (silu(gate) * up fused into K1),
    else one quant_act (GELU stays unfused); one tiled_matmul each for wo,
    up, down and gate (gated FFNs).  With ``cross`` (an encoder-decoder's
    decoder layer) its cross-attention adds a quant_act each for q's input,
    the memory rows (one serves k and v) and wo's input, and a tiled_matmul
    each for q, k, v and wo: it attends densely, with no kernel.
    Unquantized, none.  One attention launch: paged_decode on the paged
    cache (paged_decode_verify in a speculative verify pass),
    flash_attention on a cache-less prompt of at least
    ``blockwise_attn_threshold`` tokens.  An MoE layer's experts run no
    kernel (w8: dequantized, then PyTorch's einsums, as the reference): its
    FFN launches are those of its shared experts' dense FFN, if any."""
    w8a8 = int(cfg.quant_proj == "w8a8")
    ffn = int(not cfg.is_moe or cfg.n_shared_experts > 0)
    gated = int(cfg.ffn_type in ("swiglu", "geglu")) * ffn
    glu = int(cfg.ffn_type == "swiglu") * ffn
    return {"quant_act": (2 + 2 * ffn - glu + 3 * cross) * w8a8,
            "quant_act_glu": glu * w8a8, "fused_qkv": w8a8,
            "tiled_matmul": (1 + 2 * ffn + gated + 4 * cross) * w8a8,
            "paged_decode": int(paged and not verify),
            "paged_decode_verify": int(verify),
            "flash_attention": int(flash), "flash_attention_backward": 0,
            "row_absmax": 0, "tiled_matmul_int32": 0, "int8_epilogue": 0}


def forward_launches(cfg, *, paged=False, flash=False) -> dict:
    """Each kernel's launches in one forward of ``cfg``: ``layer_launches``
    for each of its layers; for the SSM and hybrid families, under w8a8,
    one quant_act for the five in-projections (one K1 serves them all) and
    one for out_proj, and one tiled_matmul each, a Mamba layer, plus a
    decoder layer's launches at each application site of the hybrid's
    shared block (its dense KV cache runs no K4; a cache-less prompt past
    the threshold runs K5 there)."""
    from repro_torch.models.transformer import is_ssm_family
    from repro_torch.serving.cache import n_shared_sites
    if not is_ssm_family(cfg):
        return {k: cfg.n_layers * n
                for k, n in layer_launches(
                    cfg, paged=paged, flash=flash,
                    cross=cfg.is_encoder_decoder).items()}
    w8a8 = int(cfg.quant_proj == "w8a8")
    sites = n_shared_sites(cfg)
    want = {k: sites * n for k, n in layer_launches(cfg, flash=flash).items()}
    want["quant_act"] += 2 * w8a8 * cfg.n_layers
    want["tiled_matmul"] += 6 * w8a8 * cfg.n_layers
    return want


def encoder_launches(cfg, frames: int) -> dict:
    """Each kernel's launches in one ``encode`` of ``frames`` frames a
    request: ``layer_launches`` of each encoder layer (no cross-attention;
    flash_attention, non-causal, from the threshold on)."""
    flash = frames >= cfg.blockwise_attn_threshold and cfg.attn_impl != "jnp"
    return {k: cfg.n_encoder_layers * n
            for k, n in layer_launches(cfg, flash=flash).items()}


def plus(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def expected_launches(cfg, paged: bool, prefill_forwards: int = 1,
                      frames: int | None = None) -> dict:
    """Each kernel's launches in a smoke serve of ``cfg``: its prefill
    forwards and one forward per decode step, ``forward_launches`` each,
    and an encoder-decoder's one ``encode`` of ``frames`` frames."""
    forwards = prefill_forwards + DECODE_STEPS
    want = {k: forwards * n
            for k, n in forward_launches(cfg, paged=paged).items()}
    return want if frames is None else plus(want,
                                            encoder_launches(cfg, frames))


def prefill_step_launches(cfg, s: int, frames: int | None = None) -> dict:
    """Each kernel's launches in one ``prefill_step`` of ``s`` positions
    (patches and tokens), and of an encoder-decoder's ``frames``."""
    flash = s >= cfg.blockwise_attn_threshold and cfg.attn_impl != "jnp"
    want = forward_launches(cfg, flash=flash)
    return want if frames is None else plus(want,
                                            encoder_launches(cfg, frames))


def check_serve(what, counts, want, next_logits, toks, cfg, t_prefill,
                t_decode):
    """Launch counts exact, outputs in range; returns decode tok/s."""
    print(f"{what}: launches {counts} (expected {want})")
    if counts != want:
        fail(f"{what}: launch counts {counts} != {want}")
    if toks.shape != (len(BATCH_LENS), DECODE_STEPS + 1):
        fail(f"{what}: tokens shape {tuple(toks.shape)}")
    if not bool(torch.isfinite(next_logits).all()):
        fail(f"{what}: non-finite prefill logits")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail(f"{what}: token ids out of the vocabulary")
    tps = len(BATCH_LENS) * DECODE_STEPS / t_decode
    print(f"  prefill: {t_prefill * 1e3:.3f} ms for {len(BATCH_LENS)} x "
          f"{max(BATCH_LENS)} tokens; decode: {DECODE_STEPS} steps in "
          f"{t_decode * 1e3:.3f} ms = {tps:.1f} tok/s (host clock)")
    return tps


def main_path(model, cfg, dev, config=None, what="dense serve",
              label="distilbert dense serve"):
    """The serve on the dense cache (or the paged one ``config``
    describes), then the same serve with the plain versions of the exact
    kernels (K1-K3) swapped in: prefill logits, tokens and the whole KV
    cache (and an encoder-decoder's memory) must be bitwise equal.  On the
    paged cache each K4 call of the first serve is held against the plain
    version on its own operands, and so is each K5 call of an
    encoder-decoder's encoder; K4 and K5 sum in another order than their
    plain versions, so they run in both serves."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    calls, k5_calls = [], []
    with recorded_k4_calls(calls), recorded_k5_calls(k5_calls):  # warm-up
        w_logits, w_toks, _, _, _ = serve(model, cfg, dev, config)
    reset_launch_counts()
    next_logits, toks, cache, t_prefill, t_decode = serve(model, cfg, dev,
                                                          config)
    counts = launch_counts()
    tps = check_serve(what, counts,
                      expected_launches(cfg, config is not None,
                                        frames=ENC_FRAMES
                                        if cfg.is_encoder_decoder else None),
                      next_logits, toks, cfg, t_prefill, t_decode)
    check_served_plans(label, counts)
    for b, row in enumerate(toks.tolist()):
        print(f"  request {b} (prompt {BATCH_LENS[b]}): {row}")
    if config is not None and cache["seq_lens"].tolist() != [
            n + DECODE_STEPS for n in BATCH_LENS]:
        fail(f"{what}: seq_lens {cache['seq_lens'].tolist()}")
    if calls or k5_calls:
        # the warm-up is the same serve, bit for bit, so the K4 and K5
        # operands it recorded are the counted serve's
        if not (torch.equal(w_logits, next_logits)
                and torch.equal(w_toks, toks)):
            fail(f"{what}: two runs of the same serve differ")
    if config is not None:
        check_served_k4(what, calls, counts["paged_decode"])
    if counts["flash_attention"]:
        check_served_k5(what, k5_calls, counts["flash_attention"])
    del calls, k5_calls, w_logits, w_toks

    # the same serve with the plain versions in place of the exact
    # kernels: everything must match bit for bit
    reset_launch_counts()
    with plain_versions():
        p_logits, p_toks, p_cache, _, _ = serve(model, cfg, dev, config)
    left = {k: n for k, n in launch_counts().items() if n}
    if left != {k: n for k, n in counts.items()
                if n and k in ("paged_decode", "flash_attention")}:
        fail(f"the plain-version serve launched kernels: {left}")
    reset_launch_counts()
    keys = ("k", "v") if config is None else ("k_pages", "v_pages")
    if "ssm_h" in cache:
        keys = tuple(k for k in cache if k != "seq_lens")
    if "memory" in cache:
        keys += ("memory",)
    for name, got, want_ in (("prefill logits", next_logits, p_logits),
                             ("tokens", toks, p_toks),
                             *((f"cache {k}", cache[k], p_cache[k])
                               for k in keys)):
        if not torch.equal(got, want_):
            fail(f"{what} vs plain versions on the card: {name} differ "
                 f"(max |err| {(got.double() - want_.double()).abs().max()})")
    print(f"{what} vs plain versions (K1-K3) on the card: prefill logits, "
          f"tokens and the {cfg.n_layers}-layer cache ({', '.join(keys)}) "
          "bitwise equal")
    cache.pop("memory", None)
    return counts, t_prefill, tps, toks, cache


@contextlib.contextmanager
def recorded_k4_calls(calls):
    """Within the block, every K4 call of the main paths appends to
    ``calls`` its operands as the call found them (copies: the pools
    change in place afterwards) and its output."""
    mod = importlib.import_module("repro_torch.models.attention")
    wrapper = mod.paged_decode_attention

    def record(*args, **kwargs):
        snap = [a.clone() for a in args], {
            k: v.clone() if torch.is_tensor(v) else v
            for k, v in kwargs.items()}
        out = wrapper(*args, **kwargs)
        calls.append((*snap, out.clone()))
        return out

    mod.paged_decode_attention = record
    try:
        yield
    finally:
        mod.paged_decode_attention = wrapper


def readings(rels):
    """The per-row rel-err of every call of a run, summarised: count, min,
    median, max, and how many exceed 8e-3."""
    if not rels:
        return "no calls"
    r = sorted(rels)
    return (f"per-row rel-err of each of its {len(r)} calls: min {r[0]:.3e}"
            f", median {r[len(r) // 2]:.3e}, max {r[-1]:.3e}, above 8e-3: "
            f"{sum(x > 8e-3 for x in r)}")


def check_served_k4(what, calls, n):
    """Each of a serve's K4 calls against the plain version on that call's
    own operands, at phase 3's limits; returns the worst rel-err."""
    from repro_torch.kernels.flash_attention.ref import \
        paged_decode_attention_ref
    if len(calls) != n:
        fail(f"{what}: {len(calls)} K4 calls recorded, {n} launched")
    worst_err = worst_rel = 0.0
    rels = []
    for i, (args, kwargs, out) in enumerate(calls):
        ok, err, rel, limit = attention_agrees(
            out, paged_decode_attention_ref(*args, **kwargs))
        if not ok:
            fail(f"{what}: K4 call {i} (q {tuple(args[0].shape)}) differs "
                 f"from its plain version: max |err| {err:.3e}, per-row "
                 f"rel-err "
                 f"{rel:.3e} ({limit})")
        worst_err, worst_rel = max(worst_err, err), max(worst_rel, rel)
        rels.append(rel)
    print(f"  each of its {n} K4 calls against the plain version on the "
          f"call's own operands: worst max |err| {worst_err:.3e}, worst "
          f"per-row rel-err {worst_rel:.3e} ({limit})")
    print(f"  {readings(rels)}")
    return worst_rel


def paged_paths(model, cfg, dev, dense_toks, dense_cache):
    """The smoke serve on the paged cache, in bf16 pools and in int8 pools,
    each with exact launch counts and each K4 call held against the plain
    version on its own operands; returns the bf16 run's (counts, prefill
    s, decode tok/s)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.ref import paged_gather
    from repro_torch.serving.cache import CacheConfig
    out = None
    for kv_quant in ("none", "int8"):
        config = CacheConfig(layout="paged", page_size=PAGE, alloc="striped",
                             kv_quant=kv_quant)
        what = f"paged serve (page {PAGE}, striped, kv_quant={kv_quant})"
        calls = []
        with recorded_k4_calls(calls):                   # warm-up
            w_logits, w_toks, _, _, _ = serve(model, cfg, dev, config)
        reset_launch_counts()
        next_logits, toks, cache, t_prefill, t_decode = serve(model, cfg, dev,
                                                              config)
        counts = launch_counts()
        tps = check_serve(what, counts, expected_launches(cfg, True),
                          next_logits, toks, cfg, t_prefill, t_decode)
        check_served_plans(f"distilbert paged serve, kv_quant={kv_quant}",
                           counts)
        if cache["seq_lens"].tolist() != [n + DECODE_STEPS
                                          for n in BATCH_LENS]:
            fail(f"{what}: seq_lens {cache['seq_lens'].tolist()}")
        # the warm-up is the same serve, bit for bit, so the K4 operands it
        # recorded are the counted serve's
        if not (torch.equal(w_logits, next_logits)
                and torch.equal(w_toks, toks)):
            fail(f"{what}: two runs of the same serve differ")
        check_served_k4(what, calls, counts["paged_decode"])
        del calls
        agree = (toks == dense_toks).float().mean().item()
        print(f"  token agreement with the dense serve: {agree:.4f} over "
              f"{toks.numel()} tokens (printed: the two attend with "
              "different roundings)")
        if kv_quant == "none":
            out = (counts, t_prefill, tps)
            # layer 0's K/V come from exact kernels on equal inputs: its
            # prompt rows, read through the table, equal the dense cache's
            for name in ("k", "v"):
                rows = paged_gather(cache[f"{name}_pages"][0],
                                    cache["page_table"])
                for b, n in enumerate(BATCH_LENS):
                    if not torch.equal(rows[b, :n], dense_cache[name][0, b, :n]):
                        fail(f"{what}: layer 0 {name} rows of request {b} "
                             "differ from the dense cache")
            print(f"  layer 0 prompt rows through the page table == dense "
                  "cache rows (bitwise)")
    return out


@contextlib.contextmanager
def recorded_k5_calls(calls):
    """Within the block, every K5 call of the model appends to ``calls``
    its operands and its output (none of them is changed in place
    afterwards, so references suffice)."""
    mod = importlib.import_module("repro_torch.models.attention")
    wrapper = mod.flash_attention

    def record(*args, **kwargs):
        out = wrapper(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    mod.flash_attention = record
    try:
        yield
    finally:
        mod.flash_attention = wrapper


def check_served_k5(what, calls, n):
    """Each K5 call of a run against the plain version on that call's own
    operands, at phase 3's limits; returns the worst rel-err."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    if len(calls) != n:
        fail(f"{what}: {len(calls)} K5 calls recorded, {n} launched")
    worst_err = worst_rel = 0.0
    rels = []
    for i, (args, kwargs, out) in enumerate(calls):
        ok, err, rel, limit = attention_agrees(
            out, attention_ref(*args, **kwargs), "flash_attention")
        if not ok:
            fail(f"{what}: K5 call {i} (q {tuple(args[0].shape)}) differs "
                 f"from its plain version: max |err| {err:.3e}, per-row "
                 f"rel-err "
                 f"{rel:.3e} ({limit})")
        worst_err, worst_rel = max(worst_err, err), max(worst_rel, rel)
        rels.append(rel)
    print(f"  each of its {n} K5 calls against the plain version on the "
          f"call's own operands: worst max |err| {worst_err:.3e}, worst "
          f"per-row rel-err {worst_rel:.3e} ({limit})")
    print(f"  {readings(rels)}")
    return worst_rel


@contextlib.contextmanager
def checked_glu_calls(stats):
    """Within the block, every quant_act_glu call of the FFN is held, as it
    is made, bitwise against the plain version on its own operands;
    ``stats["calls"]`` counts them."""
    from repro_torch.kernels.quant_act.ref import quant_act_glu_ref
    mod = importlib.import_module("repro_torch.core.quantized_linear")
    wrapper = mod.quant_act_glu

    def check(gate, up):
        out = wrapper(gate, up)
        v, s = quant_act_glu_ref(gate, up)
        what = (f"served quant_act_glu call {stats['calls']} "
                f"({tuple(gate.shape)} {gate.dtype})")
        max_err(out.values, v, what)
        max_err(out.scale, s, what + " scale")
        stats["calls"] += 1
        stats["shapes"].add(tuple(gate.shape))
        return out

    mod.quant_act_glu = check
    try:
        yield
    finally:
        mod.quant_act_glu = wrapper


def check_served_glu(what, stats, launched):
    if stats["calls"] != launched:
        fail(f"{what}: {stats['calls']} quant_act_glu calls checked, "
             f"{launched} launched")
    print(f"  each of its {launched} quant_act_glu calls bitwise the plain "
          f"version on the call's own operands (shapes "
          f"{sorted(stats['shapes'])})")


# each served path's counted run (counts set to 0 just before it): its
# launch counts and its launches by plan (K1) or variant (K2, K3)
SERVED_PLANS = {}


def check_served_plans(what, counts):
    """Read the launches by plan of the counted run just made (``counts``
    its launch counts): each wrapper's sum to its count, printed, and
    every K2 / K3 launch on a tensor-core variant; kept in SERVED_PLANS
    under ``what``."""
    from repro_torch.kernels import plan_counts
    plans = plan_counts()
    for name, by in plans.items():
        if sum(by.values()) != counts[name]:
            fail(f"{what}: {name} launches by plan {by} do not sum to its "
                 f"{counts[name]} launches")
        print(f"  {what}: {name} launches by "
              f"{'plan' if name.startswith('quant') else 'variant'} "
              f"{dict(sorted(by.items()))}")
        if by.get("general"):
            fail(f"{what}: {by['general']} {name} calls planned onto the "
                 "general (__dp4a) variant")
    SERVED_PLANS[what] = {"counts": counts, "plans": plans}


@contextlib.contextmanager
def profiled_ranges(ranges):
    """Within the block, each function ``ranges`` names ({range: (module,
    function)}) runs inside a ``torch.profiler`` range of that name."""
    saved = []
    for name, (mod_name, fn_name) in ranges.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def ranged(*args, _fn=fn, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)

        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, ranged)
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


# the MoE block's stages, named in its profiles: the routing, the whole
# dispatch-experts-combine, the experts (dequant, einsums and silu), the
# dequant of the int8 experts to bf16
MOE_MODULE = "repro_torch.models.moe"
MOE_RANGES = {"moe route": (MOE_MODULE, "route"),
              "moe dispatch+experts+combine": (MOE_MODULE,
                                               "_dispatch_compute"),
              "moe experts": (MOE_MODULE, "expert_ffn"),
              "moe dequant": (MOE_MODULE, "expert_weight")}


# the Mamba2 block's stages and the hybrid's shared block, named in their
# profiles: the five in-projections (one K1, five K2), the three convs
# (the cache-less form, and the prefill form with its carried tails), the
# chunked SSD scan and the one-token step, the gated RMSNorm, out_proj
# (K1 + K2: ssm's own calls of apply_linear), the shared attention + FFN
# block (the hybrid runs _decoder_block for it alone)
SSM_MODULE = "repro_torch.models.ssm"
SSM_RANGES = {"ssm in-projections": (SSM_MODULE, "apply_linears"),
              "ssm conv": (SSM_MODULE, "_causal_conv"),
              "ssm conv (prefill)": (SSM_MODULE, "_conv_prefill"),
              "ssm scan (ssd_chunked)": (SSM_MODULE, "ssd_chunked"),
              "ssm step": (SSM_MODULE, "ssm_step"),
              "ssm gated norm": (SSM_MODULE, "_gated_norm"),
              "ssm out_proj": (SSM_MODULE, "apply_linear"),
              "shared block": ("repro_torch.models.transformer",
                               "_decoder_block")}


def family_ranges(cfg):
    """The profiler ranges of ``cfg``'s family, or None."""
    from repro_torch.models.transformer import is_ssm_family
    if cfg.is_moe:
        return MOE_RANGES
    if is_ssm_family(cfg):
        return SSM_RANGES
    return None


def swiglu_is_fused(cfg):
    """Must a profile of ``cfg`` hold no PyTorch silu or bf16 product
    kernel?  Yes for a dense SwiGLU model under w8a8 (quant_act_glu takes
    their place); an MoE model's experts and a Mamba2 block (its convs'
    silu and its gate ``y * silu(z)``) run them as the reference does.
    The vision family's decoder is a dense one."""
    return (cfg.ffn_type == "swiglu" and cfg.family in ("dense", "vlm")
            and cfg.quant_proj == "w8a8")


def range_times(ranges, averages):
    """Device ms of the kernels launched inside each range (its CPU
    event's device total), and the stages they imply; None where the
    profiler attributed none."""
    from torch.autograd import DeviceType
    got = {e.key: e.device_time_total / 1e3 for e in averages
           if e.key in ranges and e.device_type == DeviceType.CPU}
    if not got or not any(got.values()):
        return None
    if "moe experts" in got:
        got["moe einsums+silu (experts - dequant)"] = (
            got.get("moe experts", 0.0) - got.get("moe dequant", 0.0))
        got["moe dispatch+combine (the whole - experts)"] = (
            got.get("moe dispatch+experts+combine", 0.0)
            - got.get("moe experts", 0.0))
    return got


def device_breakdown(fn, top=10, label="one more run", ranges=None):
    """``fn()`` (one more run, or what ``label`` says) under
    ``torch.profiler`` (CUDA activity): device time by kernel name, the
    sum, and the device's idle share of the run's host-clock time.  With
    ``ranges`` (``profiled_ranges``) the CPU activity is traced too, and
    the device time of the kernels each range launched is printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges
                                      else [])
    with profiled_ranges(ranges or {}), profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    rows = [(e.key, e.count, e.device_time_total / 1e3)
            for e in averages if e.device_time_total > 0
            and (not ranges or (e.device_type != DeviceType.CPU
                                and e.key not in ranges))]
    total = sum(ms for _, _, ms in rows)
    if not rows:
        print("  torch.profiler saw no device time (not measured)")
        return rows
    print(f"  device time by kernel (torch.profiler, {label}: "
          f"{wall_ms:.3f} ms on the host clock): total {total:.3f} ms, so "
          f"the device idles {1 - total / wall_ms:.3f} of the run")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:top]:
        print(f"    {ms:10.3f} ms {ms / total:6.3f} x{count:<5d} {key[:90]}")
    # K4 runs as two kernels (the split walk, then the combine), K2 / K3
    # with K split as two (the partial products, then their sum and the
    # epilogue): both count.  K2's kernels take 1 product, K3's 3.
    for kernel, names in (
            ("K4 (paged_decode_kernel + paged_decode_combine)",
             ("paged_decode",)),
            ("K5 (flash_attention_*)", ("flash_attention",)),
            ("K5's backward (attention_bwd_delta, _dkdv_*, _dkdv_sum, "
             "_dq_*)", ("attention_bwd",)),
            ("K2 (gemm_tma / gemm_kernel + splitk_epilogue, 1 product)",
             ("Params<1>", "Args<1>")),
            ("K3 (the same, 3 products)", ("Params<3>", "Args<3>")),
            ("K1 (quant_rows<..., false, ...>)", ("quant_rows<",)),
            ("K1's SwiGLU mode (quant_rows<..., true, ...>)",
             ("quant_rows<",))):
        glu = "SwiGLU" in kernel
        sel = [(count, ms) for key, count, ms in rows
               if any(name in key for name in names)
               and (not kernel.startswith("K1") or glu == (", true," in key))]
        if sel:
            ms = sum(m for _, m in sel)
            print(f"    {kernel}: {ms:.3f} ms {ms / total:.3f}, "
                  f"{sum(c for c, _ in sel)} kernel launches")
    swiglu = swiglu_kernels(rows)
    print(f"    PyTorch's silu and bf16 product kernels: "
          f"{sum(c for _, c, _ in swiglu)} launches, "
          f"{sum(ms for _, _, ms in swiglu):.3f} ms")
    if ranges:
        stages = range_times(ranges, averages)
        if stages is None:
            print("    the ranges' device time: not measured (the profiler "
                  "attributed no kernel to them)")
        else:
            print("    (a range holds the device time of the PyTorch kernels "
                  "launched inside it; K1-K5, launched through ctypes, are "
                  "not attributed to ranges: their time is in the rows "
                  "above)")
        for name, ms in (stages or {}).items():
            print(f"    range {name}: {ms:.3f} ms {ms / total:.3f}")
    return rows


def swiglu_kernels(rows):
    """The profiler rows of PyTorch's silu kernel and of its bf16
    tensor-by-tensor product kernel: the unfused SwiGLU's two passes (the
    served models' other products are f32, or by a scalar: the residual
    multiplier)."""
    return [r for r in rows if "silu" in r[0].lower()
            or ("MulFunctor" in r[0] and "BinaryFunctor<c10::BFloat16" in r[0])]


def no_swiglu_kernels(what, rows):
    """Fail if a profiled run of a SwiGLU model ran PyTorch's silu or bf16
    product kernel: quant_act_glu takes their place."""
    found = swiglu_kernels(rows)
    if found:
        fail(f"{what}: PyTorch's SwiGLU kernels ran: "
             + "; ".join(f"{c} x {k[:100]}" for k, c, _ in found))
    print(f"    no silu or bf16 product kernel in the profile of {what}")


def check_swiglu_detector(dev):
    """The detector's control: the unfused SwiGLU, F.silu(g) * u in bf16,
    under the profiler shows both of its kernels to ``swiglu_kernels``."""
    from torch.profiler import ProfilerActivity, profile
    g, u = (randn((64, 11008), i, dev, 1.0, torch.bfloat16) for i in (1, 2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.nn.functional.silu(g) * u
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total / 1e3)
            for e in prof.key_averages() if e.device_time_total > 0]
    found = swiglu_kernels(rows)
    if len(found) != 2:
        fail("the SwiGLU kernel detector found "
             f"{[k[:100] for k, _, _ in found]} in F.silu(g) * u, not its "
             f"silu and product kernels (the profile: "
             f"{[k[:100] for k, _, _ in rows]})")
    print("  the silu / bf16 product detector finds both kernels of the "
          "unfused F.silu(g) * u: "
          + "; ".join(k[:80] for k, _, _ in found))


def describe(cfg):
    from repro_torch.models.transformer import is_ssm_family
    if cfg.is_encoder_decoder:
        return (f"{cfg.name} {cfg.quant_proj} {cfg.dtype}, "
                f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder "
                f"layers, d={cfg.d_model}, heads {cfg.n_heads}/"
                f"{cfg.n_kv_heads}x{cfg.head_dim}, d_ff={cfg.d_ff} "
                f"{cfg.ffn_type}, vocab={cfg.vocab_size} untied")
    if is_ssm_family(cfg):
        from repro_torch.serving.cache import n_shared_sites
        text = (f"{cfg.name} {cfg.quant_proj} {cfg.dtype}, {cfg.n_layers} "
                f"layers, d={cfg.d_model}, d_inner={cfg.d_inner}, "
                f"{cfg.ssm_n_heads} SSD heads of {cfg.ssm_head_dim}, state "
                f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}")
        if cfg.family == "hybrid":
            text += (f"; shared block at {n_shared_sites(cfg)} sites: heads "
                     f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}, d_ff="
                     f"{cfg.d_ff}")
        return text + f", vocab={cfg.vocab_size}"
    ffn = (f"{cfg.n_experts} experts top-{cfg.top_k} x d_ff "
           f"{cfg.d_ff_expert}" if cfg.is_moe else f"d_ff={cfg.d_ff}")
    patches = (f", {cfg.frontend_len} patches ahead of the text"
               if cfg.frontend == "vision" else "")
    return (f"{cfg.name} {cfg.quant_proj} {cfg.dtype}, {cfg.n_layers} "
            f"layers, d={cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}"
            f"x{cfg.head_dim}, {ffn}, vocab={cfg.vocab_size}{patches}")


def long_prompt_path(arch, dev, n_layers=None):
    """``prefill_step`` of ``arch`` (w8a8, bf16, fused QKV) at full width
    (and ``n_layers`` layers, if given), weights drawn on the card from a
    seeded generator (``long_prompt_run``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch).replace(quant_proj="w8a8")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    master = init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    model = quantize_model_params(master)
    del master
    out = long_prompt_run(model, cfg, dev)
    del model
    torch.cuda.empty_cache()
    return out


def prefill_inputs(cfg, dev, seed=2):
    """``prefill_step``'s inputs for ``cfg``: one prompt of LONG_PROMPT
    random tokens; for the vision family LONG_PROMPT positions, its
    ``frontend_len`` seeded patches first; for an encoder-decoder
    ENCDEC_TEXT tokens and ENC_FRAMES seeded frames.  Returns (tokens,
    keyword inputs, positions of the logits, frames a request or None)."""
    text, kw, frames = LONG_PROMPT, {}, None
    if cfg.frontend == "vision":
        text -= cfg.frontend_len
        kw["frontend_embeds"] = embeds_for(cfg, 1, cfg.frontend_len, dev,
                                           seed + 1)
    if cfg.is_encoder_decoder:
        text, frames = ENCDEC_TEXT, ENC_FRAMES
        kw["encoder_frames"] = embeds_for(cfg, 1, frames, dev, seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (1, text),
                           generator=torch.Generator().manual_seed(seed))
    n_pos = text + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    return tokens.to(dev), kw, n_pos, frames


def long_prompt_run(model, cfg, dev, ranges=None, stages=None):
    """``prefill_step`` of ``model`` on ``prefill_inputs``: a prompt of
    LONG_PROMPT random tokens (positions, patches included, for the vision
    family; an encoder-decoder's ENC_FRAMES frames and ENCDEC_TEXT
    tokens).  A warm-up run records every K5 call; the counted run must
    equal it bit for bit, have exact launch counts and finite logits; each
    recorded call is held against the plain version; one more run is
    profiled (with ``ranges`` named), and with ``stages`` one more is
    timed by stage (``stage_times``).  Returns (launch counts, prefill s on
    the host clock, the window of each K5 call)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import prefill_step
    tokens, kw, n_pos, frames = prefill_inputs(cfg, dev)
    inputs = ", ".join([f"1 x {tokens.shape[1]} tokens"]
                       + [f"{x.shape[1]} seeded {k}" for k, x in kw.items()])
    what = f"prefill_step {describe(cfg)}, {inputs}"
    calls = []
    glu = dict(calls=0, shapes=set())
    with recorded_k5_calls(calls), checked_glu_calls(glu):   # warm-up
        w_logits, _ = prefill_step(model, tokens, cfg, **kw)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = prefill_step(model, tokens, cfg, **kw)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts = launch_counts()
    want = prefill_step_launches(cfg, n_pos, frames)
    print(f"{what}: launches {counts} (expected {want})")
    if counts != want:
        fail(f"{what}: launch counts {counts} != {want}")
    check_served_plans(f"{cfg.name} prefill_step", counts)
    if logits.shape != (1, n_pos, cfg.vocab_size) \
            or logits.dtype != torch.float32:
        fail(f"{what}: logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{what}: non-finite logits")
    # the warm-up is the same run, bit for bit, so the K5 operands it
    # recorded are the counted run's
    if not torch.equal(w_logits, logits):
        fail(f"{what}: two runs of the same prefill_step differ")
    del w_logits, logits
    print(f"  prefill_step: {t_prefill * 1e3:.3f} ms for {inputs} (host "
          "clock, after torch.cuda.synchronize())")
    if stages:
        stage_times(lambda: prefill_step(model, tokens, cfg, **kw), stages,
                    f"one more prefill_step of {cfg.name}")
    rows = device_breakdown(lambda: prefill_step(model, tokens, cfg, **kw),
                            label=f"one more prefill_step of {cfg.name}",
                            ranges=ranges)
    if swiglu_is_fused(cfg):
        no_swiglu_kernels(what, rows)
    check_served_k5(what, calls, counts["flash_attention"])
    check_served_glu(what, glu, counts["quant_act_glu"])
    windows = [kw.get("window") for _, kw, _ in calls]
    del calls
    torch.cuda.empty_cache()
    return counts, t_prefill, windows


def long_prompt_paths(dev):
    """Phase 4's long-prompt path: qwen2.5-3b at full depth, then gemma2-27b
    at 2 layers (layer 0 local, layer 1 global), whose local call must
    stream fewer KV tiles than its global one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import (KERNEL_KV_TILE,
                                                            KERNEL_Q_TILE,
                                                            flash_schedule)
    qwen = long_prompt_path("qwen2_5_3b", dev)
    gemma = long_prompt_path("gemma2_27b", dev, n_layers=2)
    window = get_config("gemma2_27b").sliding_window
    if gemma[2] != [window, None]:
        fail(f"gemma2-27b: K5 windows per layer {gemma[2]}, expected "
             f"[{window}, None] (local, then global)")
    tiles = [flash_schedule(LONG_PROMPT, LONG_PROMPT, q_chunk=KERNEL_Q_TILE,
                            kv_chunk=KERNEL_KV_TILE, window=w).blocks_touched
             for w in gemma[2]]
    print(f"  K5's walk at its {KERNEL_Q_TILE}x{KERNEL_KV_TILE} tiles, per "
          f"head: local layer {tiles[0]} KV tiles, global layer {tiles[1]} "
          f"(dense sweep {(LONG_PROMPT // KERNEL_Q_TILE) ** 2})")
    if not tiles[0] < tiles[1]:
        fail("gemma2-27b: the local layer does not stream fewer KV tiles")
    return qwen, gemma


def rel_err(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


def first_layers(model, n):
    """A model sharing ``model``'s tensors, cut to its first ``n`` layers
    (and the hybrid family's shared block, an encoder-decoder's encoder)."""
    from repro_torch.models.transformer import Model
    return Model(model.embed, model.final_norm, list(model.layers[:n]),
                 model.lm_head, model.shared_attn, model.encoder)


def teacher_forced(model, cfg, d, tokens=None, config=None, chunk=None,
                   frames=None):
    """Prefill (in chunks of ``chunk``, if given), then decode in f32:
    greedy, or fed ``tokens`` when given.  On the dense cache, or on the
    paged one ``config`` describes (positions from its ``seq_lens``).  An
    encoder-decoder encodes ``frames`` first and serves with that memory.
    Returns (the logits of each position, on the CPU; the tokens fed)."""
    from repro_torch.models.transformer import encode
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import prefill, serve_step
    prompts, lens = make_prompts(cfg, d)
    cache = init_cache(cfg, len(BATCH_LENS), max(BATCH_LENS) + DECODE_STEPS,
                       dtype=torch.float32, config=config, device=d)
    memory = None if frames is None else encode(model, frames.to(d), cfg)
    nl, cache = prefill(model, cache, prompts, lens, cfg, chunk=chunk,
                        memory=memory)
    logits = [nl]
    fed = [torch.argmax(nl, -1)[:, None] if tokens is None
           else tokens[:, :1].to(d)]
    for t in range(DECODE_STEPS):
        lg, cache = serve_step(model, cache, fed[-1],
                               lens + t if config is None else None, cfg,
                               memory=memory)
        logits.append(lg[:, -1])
        fed.append(torch.argmax(lg[:, -1], -1)[:, None] if tokens is None
                   else tokens[:, t + 1:t + 2].to(d))
    return [x.cpu() for x in logits], torch.cat(fed, 1).cpu()


def compare(model_cpu, cfg, dev, what, config=None, chunk=None,
            frames=None):
    """The card (kernels) against the CPU (plain versions) on the same f32
    weights, the CPU teacher-forced with the card's tokens (an
    encoder-decoder's memory encoded from ``frames`` on each side); the
    card's launch counts must be exact.  Returns (prefill rel-err, worst
    decode step rel-err, argmax agreement)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    model = copy.deepcopy(model_cpu).to(dev)
    reset_launch_counts()
    card, tokens = teacher_forced(model, cfg, dev, config=config, chunk=chunk,
                                  frames=frames)
    counts = launch_counts()
    del model
    prefill_forwards = 1 if chunk is None else -(-max(BATCH_LENS) // chunk)
    want = expected_launches(cfg, config is not None, prefill_forwards,
                             frames=None if frames is None
                             else frames.shape[1])
    if counts != want:
        fail(f"card vs CPU ({what}): launch counts {counts} != {want}")
    cpu, _ = teacher_forced(model_cpu, cfg, torch.device("cpu"), tokens,
                            config=config, chunk=chunk, frames=frames)
    agree = torch.cat([(a.argmax(-1) == b.argmax(-1)).float()
                       for a, b in zip(card, cpu)]).mean().item()
    return (rel_err(card[0], cpu[0]),
            max(rel_err(a, b) for a, b in zip(card[1:], cpu[1:])), agree)


def card_vs_cpu(model_cpu, master_cpu, cfg, dev):
    """Same weights in f32, card against CPU.

    Unquantized (``none``), at full depth, no int8 rounding sits between
    the two: they differ by the last bits of the ops' reductions, and the
    limit is the 1e-5 the CPU tests hold the port to against JAX.  This
    holds the ops around the kernels on the card to their CPU results.

    Under w8a8 one such ulp entering quant_act can flip one int8 rounding,
    and a flip moves its row by a whole quantum (1/127 of the row's
    absmax), so it flips more roundings downstream and the flips multiply
    layer by layer, up to about the w8a8 quantization error itself.  So no
    rel-err limit on w8a8 tells a sound card from one that skipped the
    quantization: the w8a8 numbers are printed, on the first 2 layers,
    beside that error (CPU w8a8 against CPU ``none``) as a yardstick, and
    only their argmax agreement is held.  The kernels' exactness on the
    card is phase 3's check and phase 4's bitwise serve.

    The paged cache is held to the same 1e-5 in ``none``, in one prefill
    pass and in chunks of 32 (K4 against its plain version, which sums in
    another order).  Its int8 pools are printed and only their argmax
    held, for w8a8's reason: an ulp in a K/V row can flip its int8
    rounding.
    """
    from repro_torch.serving.cache import CacheConfig, init_cache
    from repro_torch.serving.engine import prefill
    cfg = cfg.replace(dtype="float32")
    n = len(BATCH_LENS) * (DECODE_STEPS + 1)
    paged = dict(layout="paged", page_size=PAGE, alloc="striped")
    runs = [("dense", None, None, True),
            ("paged", CacheConfig(**paged), None, True),
            ("paged, chunk=32", CacheConfig(**paged), 32, True),
            ("paged int8 KV", CacheConfig(**paged, kv_quant="int8"), None,
             False)]
    for label, config, chunk, held in runs:
        e_pre, e_dec, agree = compare(master_cpu,
                                      cfg.replace(quant_proj="none"), dev,
                                      f"'none', {label}", config=config,
                                      chunk=chunk)
        limit = f"limit {TOL_NONE}" if held else "printed, no limit"
        print(f"card vs CPU: {cfg.name} f32 'none', {label}, n_layers="
              f"{cfg.n_layers}, launches exact: rel-err (max |card - cpu| "
              f"/ max |cpu|) "
              f"prefill {e_pre:.3e}, worst decode step {e_dec:.3e} "
              f"({limit}); argmax agreement {agree:.4f} over {n} positions "
              f"(limit {TOL_ARGMAX})")
        if held and not (e_pre <= TOL_NONE and e_dec <= TOL_NONE):
            fail(f"card vs CPU ('none', {label}) rel-err above {TOL_NONE}")
        if agree < TOL_ARGMAX:
            fail(f"card vs CPU ('none', {label}) argmax agreement {agree} "
                 f"< {TOL_ARGMAX}")

    cut = cfg.replace(n_layers=CHECK_LAYERS)
    q_pre, q_dec, q_agree = compare(first_layers(model_cpu, CHECK_LAYERS),
                                    cut, dev, "w8a8")
    prompts, lens = make_prompts(cut, "cpu")
    nl_q, nl_none = (
        prefill(first_layers(m, CHECK_LAYERS),
                init_cache(c, len(BATCH_LENS), max(BATCH_LENS),
                           dtype=torch.float32, device="cpu"),
                prompts, lens, c)[0]
        for m, c in ((model_cpu, cut),
                     (master_cpu, cut.replace(quant_proj="none"))))
    print(f"card vs CPU: {cfg.name} f32 w8a8, n_layers={CHECK_LAYERS}, "
          f"launches exact: "
          f"rel-err prefill {q_pre:.3e}, worst decode step {q_dec:.3e} "
          f"(printed, no limit); yardstick: CPU w8a8 vs CPU 'none' prefill "
          f"rel-err {rel_err(nl_q, nl_none):.3e}; argmax agreement "
          f"{q_agree:.4f} over {n} positions (limit {TOL_ARGMAX})")
    if q_agree < TOL_ARGMAX:
        fail(f"card vs CPU (w8a8) argmax agreement {q_agree} < {TOL_ARGMAX}")


def card_vs_cpu_long(dev):
    """``prefill_step`` in f32 ``none``, the card (K5) against the CPU (its
    plain version) on the same weights: qwen2.5-3b, gemma2-27b and
    phi-3-vision (its 576 seeded patches ahead of the text) at full width,
    CHECK_LAYERS layers, one prompt of CHECK_PROMPT positions.
    ``blockwise_attn_threshold`` is cut to the prompt so K5 is on the
    path, and gemma2's window to 256 so it bites (layer 0 local); these
    change routing and the window, not width.  Limits as ``card_vs_cpu``'s
    ``none``: rel-err 1e-5, argmax agreement 0.99; launch counts exact."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.engine import prefill_step
    for arch, extra in (("qwen2_5_3b", {}),
                        ("gemma2_27b", {"sliding_window": 256}),
                        (VLM_ARCH, {})):
        cfg = get_config(arch).replace(
            n_layers=CHECK_LAYERS, quant_proj="none", dtype="float32",
            blockwise_attn_threshold=CHECK_PROMPT, **extra)
        model_cpu = init_model(torch.Generator(device=dev).manual_seed(3),
                               cfg, device="cpu")
        model = copy.deepcopy(model_cpu).to(dev)
        # phi-3-vision: its patches, then the text, CHECK_PROMPT in all
        patches = (embeds_for(cfg, 1, cfg.frontend_len, "cpu", 6)
                   if cfg.frontend == "vision" else None)
        text = CHECK_PROMPT - (0 if patches is None else patches.shape[1])
        tokens = torch.randint(0, cfg.vocab_size, (1, text),
                               generator=torch.Generator().manual_seed(4))
        reset_launch_counts()
        card, _ = prefill_step(model, tokens.to(dev), cfg,
                               frontend_embeds=None if patches is None
                               else patches.to(dev))
        torch.cuda.synchronize()
        counts = launch_counts()
        want = prefill_step_launches(cfg, CHECK_PROMPT)
        what = (f"card vs CPU: prefill_step {cfg.name} f32 'none', "
                f"{cfg.n_layers} layers, 1 x {CHECK_PROMPT} positions ("
                f"{text} tokens), threshold {cfg.blockwise_attn_threshold}, "
                f"window {cfg.sliding_window}")
        if counts != want:
            fail(f"{what}: launch counts {counts} != {want}")
        card = card.cpu()
        del model
        torch.cuda.empty_cache()
        cpu, _ = prefill_step(model_cpu, tokens, cfg,
                              frontend_embeds=patches)
        if card.shape != (1, CHECK_PROMPT, cfg.vocab_size):
            fail(f"{what}: logits {tuple(card.shape)}")
        err = rel_err(card, cpu)
        agree = (card.argmax(-1) == cpu.argmax(-1)).float().mean().item()
        print(f"{what}, launches exact ({counts['flash_attention']} K5): "
              f"rel-err {err:.3e} (limit {TOL_NONE}); argmax agreement "
              f"{agree:.4f} over {CHECK_PROMPT} positions (limit "
              f"{TOL_ARGMAX})")
        if err > TOL_NONE or agree < TOL_ARGMAX:
            fail(f"{what}: card and CPU disagree")
        del model_cpu, card, cpu


# ---------------------------------------------------------------------------
# 4-5. the continuous-batching Scheduler with speculative decode
# ---------------------------------------------------------------------------
# qwen2.5-3b served through the Scheduler: 4 slots of 512 tokens over a
# dynamic pool of 40 16-token pages, prefix sharing, bucket 16, an EOS id
# (qwen2.5's <|endoftext|>); drafts of N_DRAFT tokens.  The trace's first
# two requests reserve 12 + 20 pages and the fork at tick 2 four more, so
# of the 39 usable pages 3 are free when the fourth request (4 pages)
# arrives at tick 3: admission waits for a retire in every run
SCHED_SLOTS, SCHED_MAX_LEN, SCHED_POOL, SCHED_BUCKET = 4, 512, 40, 16
SCHED_EOS = 151643
N_DRAFT = 4
DRAFT_LAYERS = 2
# the ticks profiled with torch.profiler in the timed plain and
# speculative runs (the speculative trace drains in ~4x fewer ticks)
PROFILE_TICK_PLAIN, PROFILE_TICK_SPEC = 16, 6
# a near tie: the plain run's top-2 logit gap below this share of the
# row's largest |logit|.  Spec and plain runs differ in the rows per step
# (4 against 20), so cuBLAS's f32 logits GEMM and PyTorch's reductions
# (RMSNorm's mean) may sum in another order; under w8a8 such a last-bit
# difference ahead of quant_act flips int8 roundings, which move logits by
# up to the quantization error (7.7e-3 of the largest logit at 2 layers,
# PERF.md): the limit allows 2.6x that for 36 layers.  In f32 'none' (card
# against CPU) only the last bits differ (rel-err 1e-5 at most): 1e-4.
NEAR_TIE = 2e-2
NEAR_TIE_F32 = 1e-4
# the rows of the Scheduler's prefill forwards on the trace (phase 4's
# served quant_act_glu shapes between verify's 20 and 8192): phase 6
# times K1 and quant_act_glu in every row mapping there
SCHED_CHUNK_ROWS = (32, 48, 64, 144, 160, 192, 304)


def sched_trace(vocab):
    """8 requests: prompts of 40-300 tokens (three over 128, so their
    prefill runs K4 in several q blocks), three of them sharing a
    100-token prefix (not a page multiple: a fork copies the boundary
    page); budgets of 16-48; arrivals over ticks 0-11."""
    g = torch.Generator().manual_seed(21)

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=g)

    prefix = toks(100)
    prompts = [torch.cat([prefix, toks(40)]), toks(300),
               torch.cat([prefix, toks(20)]), toks(40), toks(180),
               torch.cat([prefix, toks(150)]), toks(64), toks(129)]
    budgets = [48, 16, 32, 24, 40, 20, 48, 16]
    arrivals = [0, 0, 2, 3, 5, 7, 9, 11]
    return list(zip(prompts, budgets)), arrivals


def make_scheduler(model, cfg, dev, kv_quant, draft, dtype):
    """``draft``: None (plain decode), or (draft model, draft cfg)."""
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.scheduler import Scheduler, SpecConfig
    spec = None if draft is None else SpecConfig(*draft, n_draft=N_DRAFT)
    return Scheduler(model, cfg, slots=SCHED_SLOTS, max_len=SCHED_MAX_LEN,
                     config=CacheConfig(layout="paged", alloc="dynamic",
                                        page_size=PAGE,
                                        pool_pages=SCHED_POOL,
                                        kv_quant=kv_quant),
                     share_prefix=True, bucket=SCHED_BUCKET,
                     eos_id=SCHED_EOS, dtype=dtype, spec=spec, device=dev)


def drive(sched, trace, profile_tick=None, after_tick=None):
    """Serve ``trace`` to the end; returns (host s, the ms of each tick,
    the ticks whose admission stopped at a full pool with a request
    queued and a slot free).  Each tick ends in a synchronize.  With
    ``profile_tick``, stop instead at the first tick from it on that
    admits nothing (nothing queued, or no slot free) and run that tick
    under ``torch.profiler``.  ``after_tick`` is called after each tick,
    outside the timings."""
    reqs, arrivals = trace
    i, tick_ms, page_waits, aside = 0, [], 0, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while i < len(reqs) or sched.queue or sched.n_active:
        while i < len(reqs) and arrivals[i] <= sched._ticks:
            sched.submit(*reqs[i])
            i += 1
        if (profile_tick is not None and sched._ticks >= profile_tick
                and (not sched.queue or None not in sched.slots)):
            tick = sched._ticks
            print(f"  tick {tick} ({sched.n_active} live rows) of the same "
                  "run again:")
            rows = device_breakdown(
                sched.step, top=14,
                label=f"this tick ({sched.cfg.name}, "
                      f"{'plain' if sched.spec is None else 'spec'})",
                ranges=family_ranges(sched.cfg))
            if swiglu_is_fused(sched.cfg):
                no_swiglu_kernels(f"tick {tick}", rows)
            break
        # _admit pops the queue in order until no slot is free or the
        # pool cannot cover the head: fewer admissions than both allow
        # means it waited for pages
        can = min(len(sched.queue), sched.slots.count(None))
        queued = len(sched.queue)
        t = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t) * 1e3)
        page_waits += queued - len(sched.queue) < can
        if sched._ticks > 1000:
            fail("the scheduler did not drain in 1000 ticks")
        if after_tick is not None:
            t = time.perf_counter()
            after_tick()
            aside += time.perf_counter() - t
    return time.perf_counter() - t0 - aside, tick_ms, page_waits


def decode_ticks(sched):
    """Ticks that ran a decode step, from the request log: a request sits
    in its slot from its admission tick through its last token's tick."""
    ticks = set()
    for log in sched.request_log.values():
        ticks.update(range(log["admitted"], log["token_ticks"][-1] + 1))
    return len(ticks)


def sched_launches(cfg, draft_cfg, n_admit, n_ticks):
    """Each kernel's launches in a scheduler run: per admission the
    target's prefill forward (and the draft's, dense: K1-K3 only); per
    plain tick one forward; per spec tick N_DRAFT draft forwards and one
    target verify forward (K4 in verify mode)."""
    want = dict.fromkeys(layer_launches(cfg), 0)

    def add(per_layer, times):
        for k, n in per_layer.items():
            want[k] += n * times

    add(layer_launches(cfg, paged=True), n_admit * cfg.n_layers)
    if draft_cfg is None:
        add(layer_launches(cfg, paged=True), n_ticks * cfg.n_layers)
    else:
        add(layer_launches(draft_cfg),
            (n_admit + n_ticks * N_DRAFT) * draft_cfg.n_layers)
        add(layer_launches(cfg, paged=True, verify=True),
            n_ticks * cfg.n_layers)
    return want


@contextlib.contextmanager
def recorded_gaps(sched, gaps, top2):
    """Within the block, the top-2 logit gap (over the row's largest
    |logit|) and the top-2 tokens of every token ``sched`` emits, keyed
    (rid, index): from its prefills (index 0; requests are admitted in
    submission order), its plain decode steps and its verify passes."""
    sched_mod = importlib.import_module("repro_torch.serving.scheduler")
    engine = importlib.import_module("repro_torch.serving.engine")
    saved = (sched_mod.prefill, sched_mod.serve_step, engine.apply_model)
    admitted = [0]

    def record(logits, keys):
        vals, idx = logits.float().topk(2, dim=-1)
        rel = ((vals[..., 0] - vals[..., 1])
               / logits.float().abs().amax(-1)).tolist()
        for key, r, i in zip(keys, rel, idx.tolist()):
            if key is not None:
                gaps[key], top2[key] = r, i

    def live_keys(offset=0):
        return [None if s is None else (s.req.rid, len(s.generated) + offset)
                for s in sched.slots]

    def prefill(*args, **kwargs):
        next_logits, view = saved[0](*args, **kwargs)
        record(next_logits, [(admitted[0], 0)])
        admitted[0] += 1
        return next_logits, view

    def serve_step(*args, **kwargs):
        logits, cache = saved[1](*args, **kwargs)
        record(logits[:, -1], live_keys())
        return logits, cache

    def apply_model(*args, **kwargs):
        out = saved[2](*args, **kwargs)
        if kwargs.get("n_valid") is not None:       # the verify pass
            for r in range(out[0].shape[1]):
                record(out[0][:, r], live_keys(r))
        return out

    sched_mod.prefill, sched_mod.serve_step = prefill, serve_step
    engine.apply_model = apply_model
    try:
        yield
    finally:
        sched_mod.prefill, sched_mod.serve_step, engine.apply_model = saved


@contextlib.contextmanager
def checked_k4_calls(stats):
    """Within the block, every K4 call is held, as it is made, against the
    plain version on its own operands (the pools change in place after
    it), at phase 3's limits; a verify call's dead rows must be 0."""
    from repro_torch.kernels.flash_attention.ref import \
        paged_decode_attention_ref
    mod = importlib.import_module("repro_torch.models.attention")
    wrapper = mod.paged_decode_attention

    def check(*args, **kwargs):
        out = wrapper(*args, **kwargs)
        ok, err, rel, limit = attention_agrees(
            out, paged_decode_attention_ref(*args, **kwargs))
        new_lens = kwargs.get("new_lens")
        verify = new_lens is not None
        if verify and not dead_rows_zero(out, new_lens):
            fail(f"served K4 verify call {stats['calls']}: dead rows not 0")
        if not ok:
            fail(f"served K4 call {stats['calls']} (q {tuple(args[0].shape)}"
                 f", verify={verify}) differs from its plain version: max "
                 f"|err| {err:.3e}, per-row rel-err {rel:.3e} ({limit})")
        stats["calls"] += 1
        stats["verify"] += int(verify)
        stats["multi_block"] += int(args[0].shape[1] > 128)
        stats["err"] = max(stats["err"], err)
        stats["rel"] = max(stats["rel"], rel)
        stats["rels"].append(rel)
        stats["limit"] = limit
        return out

    mod.paged_decode_attention = check
    try:
        yield
    finally:
        mod.paged_decode_attention = wrapper


def first_divergence(a, b):
    """First index where token lists differ or one ends; None if equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def near_tie_rule(what, ref, other, gaps, top2, limit):
    """Each request's tokens in ``other`` equal ``ref``'s, or first differ
    where ``ref`` had a near tie (top-2 gap below ``limit`` of the largest
    |logit|) and ``other`` took ``ref``'s second choice.  Returns the share
    of identical requests."""
    same, notes = 0, []
    for rid, toks in ref.items():
        i = first_divergence(toks.tolist(), other[rid].tolist())
        if i is None:
            same += 1
            continue
        gap = gaps.get((rid, i))
        took = other[rid][i].item() if i < len(other[rid]) else None
        if gap is None or gap >= limit or took != top2[(rid, i)][1]:
            fail(f"{what}: request {rid} first differs at token {i} (took "
                 f"{took}, top-2 {top2.get((rid, i))}), where the top-2 gap "
                 f"was {gap} of the largest |logit| (near tie below {limit})")
        notes.append(f"request {rid} at token {i}, gap {gap:.3e}")
    share = same / len(ref)
    below = sum(g < limit for g in gaps.values()) / len(gaps)
    print(f"  {what}: {same} of {len(ref)} requests identical ({share:.3f})"
          f"{'; near ties at ' + ', '.join(notes) if notes else ''} (a "
          f"near tie: top-2 gap < {limit} of the largest |logit|; "
          f"{below:.3f} of the reference run's tokens are one)")
    return share


def sched_run(what, model, cfg, dev, kv_quant, draft, dtype, trace, *,
              ref=None, profile_tick=None):
    """One scheduler run of ``trace``: first with every K4 call held
    against the plain version and the logit gaps recorded, then the same
    run again, counted and timed, whose tokens must equal the first's
    (launch counts exact, the pool back to the scratch page); then, with
    ``profile_tick``, once more up to that tick, which is profiled.
    ``ref``: (finished, gaps, top2) of the plain run to hold a speculative
    run to by the near-tie rule.  Returns (finished, gaps, top2, the
    run's numbers)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gaps, top2 = {}, {}
    stats = dict(calls=0, verify=0, multi_block=0, err=0.0, rel=0.0,
                 rels=[], limit="")
    glu = dict(calls=0, shapes=set())
    sched = make_scheduler(model, cfg, dev, kv_quant, draft, dtype)
    with checked_k4_calls(stats), recorded_gaps(sched, gaps, top2), \
            checked_glu_calls(glu):
        drive(sched, trace)
    first = sched.finished
    sched = make_scheduler(model, cfg, dev, kv_quant, draft, dtype)
    reset_launch_counts()
    seconds, tick_ms, page_waits = drive(sched, trace)
    counts = launch_counts()
    n_ticks = decode_ticks(sched)
    draft_cfg = None if draft is None else draft[1]
    want = sched_launches(cfg, draft_cfg, len(trace[0]), n_ticks)
    st = sched.spec_stats
    if draft is not None and st["ticks"] != n_ticks:
        fail(f"{what}: {st['ticks']} spec ticks, {n_ticks} from the log")
    print(f"{what}: launches {counts} (expected {want})")
    if counts != want:
        fail(f"{what}: launch counts {counts} != {want}")
    check_served_plans(what, counts)
    if stats["calls"] != counts["paged_decode"] + \
            counts["paged_decode_verify"]:
        fail(f"{what}: {stats['calls']} K4 calls checked, "
             f"{counts['paged_decode']} + {counts['paged_decode_verify']} "
             "launched")
    for rid, toks in first.items():
        if not torch.equal(torch.as_tensor(toks),
                           torch.as_tensor(sched.finished[rid])):
            fail(f"{what}: two runs of the same trace differ (request "
                 f"{rid})")
    print(f"  each of its {stats['calls']} K4 calls ({stats['verify']} "
          f"verify, {stats['multi_block']} prefill calls of more than 128 "
          f"rows) against the plain version on the call's own operands: "
          f"worst max |err| {stats['err']:.3e}, worst per-row rel-err "
          f"{stats['rel']:.3e} ({stats['limit']})")
    print(f"  {readings(stats['rels'])}")
    check_served_glu(what, glu, counts["quant_act_glu"])
    occ = sched.pool_occupancy()
    if occ.used != 1:
        fail(f"{what}: {occ.used} pages held after the run (scratch only: 1)")
    for rid, toks in sched.finished.items():
        if len(toks) < 1 or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_size:
            fail(f"{what}: request {rid} tokens out of range")
    n_tok = sum(len(v) for v in sched.finished.values())
    out = {"ticks": sched._ticks, "decode_ticks": n_ticks, "tokens": n_tok,
           "seconds": seconds, "tok_s": n_tok / seconds,
           "ms_per_tick": sum(tick_ms) / len(tick_ms),
           "pages_peak": max(sched.occupancy_log),
           "page_wait_ticks": page_waits,
           "k4_plain": counts["paged_decode"],
           "k4_verify": counts["paged_decode_verify"],
           "acceptance": (st["accepted"] / st["proposed"]
                          if st["proposed"] else None)}
    print(f"  {out['ticks']} ticks ({n_ticks} decoding), {n_tok} tokens in "
          f"{seconds * 1e3:.3f} ms = {out['tok_s']:.1f} tok/s, "
          f"{out['ms_per_tick']:.3f} ms per tick (host clock after "
          f"torch.cuda.synchronize()), pages_peak {out['pages_peak']} of "
          f"{SCHED_POOL}, admission waited for pages in {page_waits} "
          f"ticks; acceptance "
          + ("-" if draft is None else
             f"{st['accepted']} / {st['proposed']} = {out['acceptance']:.3f}")
          + f"; K4 launches: {out['k4_verify']} verify, {out['k4_plain']} "
          "plain")
    if not page_waits:
        fail(f"{what}: admission never waited for pages (pool of "
             f"{SCHED_POOL}): the trace no longer drives admission control")
    if ref is not None:
        near_tie_rule(f"{what} against the plain run", ref[0],
                      sched.finished, ref[1], ref[2],
                      NEAR_TIE if cfg.quant_proj == "w8a8" else NEAR_TIE_F32)
    if profile_tick is not None:
        drive(make_scheduler(model, cfg, dev, kv_quant, draft, dtype), trace,
              profile_tick)
    return sched.finished, gaps, top2, out


def scheduler_paths(dev):
    """Phase 4: qwen2.5-3b (w8a8, bf16, fused QKV) at full width and depth,
    weights drawn on the card from a seeded generator, serving one trace
    through the Scheduler five ways: plain decode on bf16 and on int8
    pools, speculative decode with the first DRAFT_LAYERS target layers as
    the draft on both, and with the target as its own draft on bf16."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models.transformer import init_model
    cfg = get_config("qwen2_5_3b").replace(quant_proj="w8a8")
    master = init_model(torch.Generator(device=dev).manual_seed(5), cfg,
                        device=dev)
    model = quantize_model_params(master)
    del master
    torch.cuda.empty_cache()
    trace = sched_trace(cfg.vocab_size)
    print(f"scheduler: {cfg.name} {cfg.quant_proj} {cfg.dtype}, "
          f"{cfg.n_layers} layers, d={cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads}x{cfg.head_dim}; {len(trace[0])} requests, "
          f"prompts {[len(p) for p, _ in trace[0]]}, budgets "
          f"{[n for _, n in trace[0]]}, arrivals {trace[1]}; {SCHED_SLOTS} "
          f"slots x {SCHED_MAX_LEN} tokens, {SCHED_POOL} pages of {PAGE}, "
          f"n_draft {N_DRAFT}")
    trunc = (first_layers(model, DRAFT_LAYERS),
             cfg.replace(n_layers=DRAFT_LAYERS))
    runs = {}
    for kv in ("none", "int8"):
        pool = "bf16" if kv == "none" else "int8"
        plain = sched_run(f"scheduler plain, {pool} pools", model, cfg, dev,
                          kv, None, torch.bfloat16, trace,
                          profile_tick=PROFILE_TICK_PLAIN if kv == "none"
                          else None)
        runs[f"plain-{pool}"] = plain[3]
        spec = sched_run(f"scheduler self_trunc ({DRAFT_LAYERS}-layer draft), "
                         f"{pool} pools", model, cfg, dev, kv, trunc,
                         torch.bfloat16, trace, ref=plain[:3],
                         profile_tick=PROFILE_TICK_SPEC if kv == "none"
                         else None)
        runs[f"self_trunc-{pool}"] = spec[3]
        if kv == "none":
            full = sched_run("scheduler self_full (the target as its draft), "
                             "bf16 pools", model, cfg, dev, kv, (model, cfg),
                             torch.bfloat16, trace, ref=plain[:3])
            runs["self_full-bf16"] = full[3]
    del model, trunc
    torch.cuda.empty_cache()
    return runs


def card_vs_cpu_scheduler(dev):
    """Phase 5 for the Scheduler: qwen2.5-3b at full width, CHECK_LAYERS
    layers, f32 'none', the draft its first layer.  One ``spec_step`` from
    the same committed state on both sides (verify logits within rel-err
    1e-5; pred, m and acc equal), then the whole plain and self_trunc runs
    of the phase 4 trace on both (launch counts exact on the card; tokens
    equal, or first different at a near tie of the CPU run)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.engine import spec_step
    cfg = get_config("qwen2_5_3b").replace(
        n_layers=CHECK_LAYERS, quant_proj="none", dtype="float32")
    cpu = torch.device("cpu")
    model_cpu = init_model(torch.Generator().manual_seed(6), cfg,
                           device="cpu")
    model = copy.deepcopy(model_cpu).to(dev)
    dcfg = cfg.replace(n_layers=1)
    trace = sched_trace(cfg.vocab_size)
    what = (f"card vs CPU: scheduler {cfg.name} f32 'none', {cfg.n_layers} "
            f"layers, 1-layer draft")

    # a committed state: the CPU serves the trace's first 3 ticks
    sched = make_scheduler(model_cpu, cfg, cpu, "none",
                           (first_layers(model_cpu, 1), dcfg), torch.float32)
    reqs, arrivals = trace
    i = 0
    while sched._ticks < 3:
        while arrivals[i] <= sched._ticks:
            sched.submit(*reqs[i])
            i += 1
        sched.step()
    active = torch.tensor([s is not None for s in sched.slots])
    tok = torch.tensor([[s.last_token if s else 0] for s in sched.slots])
    budget = torch.tensor([s.req.max_new_tokens - len(s.generated) if s
                           else 0 for s in sched.slots])
    engine = importlib.import_module("repro_torch.serving.engine")
    wrapped = engine.apply_model
    results = {}
    for side, d, m in (("card", dev, model), ("cpu", cpu, model_cpu)):
        cache = {k: v.clone().to(d) for k, v in sched.cache.items()}
        dense = {k: v.clone().to(d) for k, v in sched.draft_cache.items()}
        verify = []

        def capture(*args, **kwargs):
            out = wrapped(*args, **kwargs)
            if kwargs.get("n_valid") is not None:      # the verify pass
                verify.append(out[0])
            return out

        engine.apply_model = capture
        try:
            pred, mm, acc, cache, _ = spec_step(
                m, first_layers(m, 1), cache, dense, tok.to(d), budget.to(d),
                active.to(d), cfg, dcfg, n_draft=N_DRAFT, eos_id=SCHED_EOS)
        finally:
            engine.apply_model = wrapped
        results[side] = [x.cpu() for x in (verify[0], pred, mm, acc,
                                           cache["seq_lens"])]
    card, host = results["card"], results["cpu"]
    live = active.nonzero().flatten()
    err = rel_err(card[0][live], host[0][live])
    same = torch.equal(card[1][live], host[1][live]) and all(
        torch.equal(a, b) for a, b in zip(card[2:], host[2:]))
    print(f"{what}: one spec_step from the same committed state (after 3 "
          f"ticks, {int(active.sum())} live rows): verify logits rel-err "
          f"{err:.3e} (limit {TOL_NONE}); live rows' pred, m, acc, seq_lens "
          f"{'equal' if same else 'DIFFER'} (m {host[2].tolist()}, acc "
          f"{host[3].tolist()})")
    if err > TOL_NONE or not same:
        fail(f"{what}: spec_step on the card and the CPU disagree")
    del sched
    shares = {}

    for label, draft in (("plain", None), ("self_trunc", 1)):
        outs = {}
        for side, d, m in (("cpu", cpu, model_cpu), ("card", dev, model)):
            sched = make_scheduler(
                m, cfg, d, "none",
                None if draft is None else (first_layers(m, draft), dcfg),
                torch.float32)
            gaps, top2 = {}, {}
            reset_launch_counts()
            with recorded_gaps(sched, gaps, top2):
                seconds, _, _ = drive(sched, trace)
            if side == "card":
                counts = launch_counts()
                want = sched_launches(cfg, None if draft is None else dcfg,
                                      len(reqs), decode_ticks(sched))
                if counts != want:
                    fail(f"{what}, {label}: launch counts {counts} != {want}")
            outs[side] = (sched.finished, gaps, top2, sched._ticks, seconds)
        share = near_tie_rule(
            f"{what}, {label} run, card against CPU ({outs['cpu'][3]} / "
            f"{outs['card'][3]} ticks, CPU {outs['cpu'][4]:.1f} s)",
            outs["cpu"][0], outs["card"][0], outs["cpu"][1], outs["cpu"][2],
            NEAR_TIE_F32)
        shares[label] = share
    del model, model_cpu
    torch.cuda.empty_cache()
    return shares


# ---------------------------------------------------------------------------
# 4-5. the MoE family: qwen3-moe-30b-a3b
# ---------------------------------------------------------------------------
# a near tie of the routing, card against CPU: the CPU's k-th and (k+1)-th
# router probabilities within this share of the k-th.  The two sides' f32
# router logits differ in their last bits (the model's logits by 1e-5 at
# most, TOL_NONE), which can swap only such a pair: the limit is 10x that
ROUTE_TIE = 1e-4


def resident_gb(model):
    return sum(b.numel() * b.element_size() for b in model.buffers()) / 1e9


def blockwise_model(arch, dev, seed):
    """``arch`` (w8a8, bf16, fused QKV; an MoE model's experts int8) at full
    width and depth, its weights drawn on the card from a seeded generator
    and quantized one block at a time as drawn: the f32 model never exists
    whole."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch).replace(quant_proj="w8a8")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(
        torch.Generator(device=dev).manual_seed(seed),
        cfg.replace(quant_proj="none"), device=dev,
        each_block=lambda block: quantize_model_params(
            block, quantize_experts=cfg.is_moe))
    torch.cuda.synchronize()
    print(f"{cfg.family}: {describe(cfg)}; drawn and quantized block by "
          f"block in {time.perf_counter() - t0:.1f} s: resident "
          f"{resident_gb(model):.2f} GB, torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return model, cfg


def moe_scheduler(model, cfg, dev):
    """Phase 4's Scheduler trace through the MoE model, plain and
    self_trunc (its first DRAFT_LAYERS layers as the draft), bf16 pools;
    spec tokens held to the plain run's by the near-tie rule."""
    trace = sched_trace(cfg.vocab_size)
    trunc = (first_layers(model, DRAFT_LAYERS),
             cfg.replace(n_layers=DRAFT_LAYERS))
    plain = sched_run(f"moe scheduler plain ({cfg.name}), bf16 pools", model,
                      cfg, dev, "none", None, torch.bfloat16, trace,
                      profile_tick=PROFILE_TICK_PLAIN)
    spec = sched_run(f"moe scheduler self_trunc ({cfg.name}, {DRAFT_LAYERS}"
                     "-layer draft), bf16 pools", model, cfg, dev, "none",
                     trunc, torch.bfloat16, trace, ref=plain[:3],
                     profile_tick=PROFILE_TICK_SPEC)
    return {"plain-bf16": plain[3], "self_trunc-bf16": spec[3]}


def moe_paths(dev):
    """Phase 4's MoE path: (a) the paged serve with the plain versions
    swapped in, (b) ``prefill_step`` of LONG_PROMPT tokens, (c) the
    Scheduler, plain and self_trunc; all on one model at full depth."""
    from repro_torch.serving.cache import CacheConfig
    model, cfg = blockwise_model(MOE_ARCH, dev, 7)
    config = CacheConfig(layout="paged", page_size=PAGE, alloc="striped")
    counts, t_prefill, tps, _, _ = main_path(
        model, cfg, dev, config,
        what=f"moe paged serve ({describe(cfg)}; page {PAGE}, striped, "
             "bf16 pools)", label=f"{cfg.name} paged serve")
    long = long_prompt_run(model, cfg, dev, ranges=MOE_RANGES)
    sched = moe_scheduler(model, cfg, dev)
    print(f"moe: torch.cuda.max_memory_allocated over the path "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model
    torch.cuda.empty_cache()
    return {"cfg": cfg, "serve": (counts, t_prefill, tps), "long": long,
            "sched": sched}


@contextlib.contextmanager
def recorded_routes(routes):
    """Within the block, every routing of an MoE block appends to
    ``routes[device type]`` (on the CPU) its experts, sorted, and the gap
    between its k-th and (k+1)-th probabilities over the k-th."""
    mod = importlib.import_module(MOE_MODULE)
    wrapped = mod.route

    def record(router, x, cfg):
        out = wrapped(router, x, cfg)
        top = torch.softmax(x.float() @ router.w.float(), dim=-1).topk(
            cfg.top_k + 1, dim=-1).values
        gap = (top[..., -2] - top[..., -1]) / top[..., -2]
        routes[x.device.type].append((out[1].sort(dim=-1).values.cpu(),
                                      gap.cpu()))
        return out

    mod.route = record
    try:
        yield
    finally:
        mod.route = wrapped


def routing_agrees(what, routes):
    """The card's routing equals the CPU's, call by call, or differs only
    at rows where the CPU had a near tie (ROUTE_TIE)."""
    card, cpu = routes["cuda"], routes["cpu"]
    if len(card) != len(cpu) or not cpu:
        fail(f"{what}: {len(card)} routings on the card, {len(cpu)} on the "
             "CPU")
    rows = differ = near = 0
    for (idx_card, _), (idx_cpu, gap) in zip(card, cpu):
        if idx_card.shape != idx_cpu.shape:
            fail(f"{what}: routing shapes {tuple(idx_card.shape)} and "
                 f"{tuple(idx_cpu.shape)}")
        bad = (idx_card != idx_cpu).any(dim=-1)
        rows += bad.numel()
        differ += int(bad.sum())
        near += int((gap < ROUTE_TIE).sum())
        if bool((bad & (gap >= ROUTE_TIE)).any()):
            fail(f"{what}: the card routes a token to other experts than "
                 f"the CPU where the CPU's k-th and (k+1)-th probabilities "
                 f"are {float(gap[bad].max()):.3e} of the k-th apart (a near "
                 f"tie is below {ROUTE_TIE})")
    print(f"  routing, card against CPU, over {len(cpu)} calls and {rows} "
          f"token rows: {differ} differ, each at a near tie; {near} near "
          f"ties on the CPU (k-th and (k+1)-th probabilities within "
          f"{ROUTE_TIE} of the k-th)")
    return differ, near


def card_vs_cpu_moe(dev):
    """Phase 5 for the MoE family: qwen3-moe-30b-a3b at full width,
    CHECK_LAYERS layers, f32 ``none`` (float experts), card against CPU on
    the dense and the paged cache: limits as ``card_vs_cpu``'s ``none``
    (rel-err 1e-5, argmax agreement 0.99; launch counts exact), routing
    equal or different only at near ties (``routing_agrees``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.cache import CacheConfig
    cfg = get_config(MOE_ARCH).replace(
        n_layers=CHECK_LAYERS, quant_proj="none", dtype="float32")
    model_cpu = init_model(torch.Generator(device=dev).manual_seed(9), cfg,
                           device="cpu")
    n = len(BATCH_LENS) * (DECODE_STEPS + 1)
    out = {}
    for label, config in (("dense", None),
                          ("paged", CacheConfig(layout="paged",
                                                page_size=PAGE,
                                                alloc="striped"))):
        what = (f"card vs CPU: {describe(cfg)}, {label}, launches exact")
        routes = {"cuda": [], "cpu": []}
        t0 = time.perf_counter()
        with recorded_routes(routes):
            e_pre, e_dec, agree = compare(model_cpu, cfg, dev, what,
                                          config=config)
        print(f"{what}: rel-err prefill {e_pre:.3e}, worst decode step "
              f"{e_dec:.3e} (limit {TOL_NONE}); argmax agreement "
              f"{agree:.4f} over {n} positions (limit {TOL_ARGMAX}); "
              f"{time.perf_counter() - t0:.1f} s")
        differ, near = routing_agrees(what, routes)
        if not (e_pre <= TOL_NONE and e_dec <= TOL_NONE):
            fail(f"{what}: rel-err above {TOL_NONE}")
        if agree < TOL_ARGMAX:
            fail(f"{what}: argmax agreement {agree} < {TOL_ARGMAX}")
        out[label] = {"prefill_rel_err": e_pre, "decode_rel_err": e_dec,
                      "argmax": agree, "routing_differ": differ,
                      "near_ties": near}
    del model_cpu
    return out


# ---------------------------------------------------------------------------
# 4-5. the SSM and hybrid families: zamba2-7b and mamba2-370m
# ---------------------------------------------------------------------------
HYBRID_ARCH, SSM_ARCH = "zamba2_7b", "mamba2_370m"
# phase 5's depth for zamba2-7b: layer 5 is its first shared site (every
# 6th layer), so 6 layers hold one application of the shared block
HYBRID_CHECK_LAYERS = 6
# the depth of the slot families' Scheduler runs (zamba2-7b: two shared
# sites, layers 5 and 11).  At full depth they took ~70 s of the
# script's 1200 s; what they check (exact launch counts, tokens and the
# slot state after every tick bitwise against the plain versions) holds
# at any depth, and the serve and prefill_step keep full depth.
SLOT_SCHED_LAYERS = 12


def slot_scheduler(model, cfg, dev, spec=None):
    """The Scheduler on the slot families' dense state: SCHED_SLOTS slots of
    SCHED_MAX_LEN tokens, bucket SCHED_BUCKET; no pool, no prefix sharing
    (the handler has none), no EOS id."""
    from repro_torch.serving.scheduler import Scheduler
    return Scheduler(model, cfg, slots=SCHED_SLOTS, max_len=SCHED_MAX_LEN,
                     bucket=SCHED_BUCKET, dtype=torch.bfloat16, spec=spec,
                     device=dev)


def state_digests(sched, digests):
    """An ``after_tick`` for ``drive`` that appends an exact fingerprint of
    ``sched``'s slot state: each state tensor's bits, read as integers of
    its width, summed per (layer or site, slot) in int64 on the card, and
    ``seq_lens``."""
    def after_tick():
        parts = []
        for t in sched.cache.values():
            bits = t.view({1: torch.int8, 2: torch.int16,
                           4: torch.int32}[t.element_size()])
            parts.append(bits.sum(dim=tuple(range(2, t.dim())),
                                  dtype=torch.int64).flatten()
                         if t.dim() > 1 else bits.long())
        digests.append(torch.cat(parts))
    return after_tick


def slot_sched_run(what, model, cfg, dev, trace):
    """The Scheduler trace through a slot family: counted and timed
    (launch counts exact: one forward per admission and per decoding
    tick; every slot recycled), the slot state fingerprinted after every
    tick (``state_digests``); then the same trace with ``spec=`` (the
    first DRAFT_LAYERS layers as the draft) and the plain versions of
    K1-K3 and quant_act_glu swapped in, which must warn that it degrades
    to 1-token decode, launch no kernel, and give the counted run's
    tokens and fingerprints bit for bit: every kernel call of the counted
    run, at each per-row prefill's shapes too, is held to its plain
    version in place.  Then once more up to PROFILE_TICK_PLAIN, whose
    tick is profiled by stage.  Returns the counted run's numbers."""
    import warnings

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.scheduler import SpecConfig
    sched = slot_scheduler(model, cfg, dev)
    digests = []
    reset_launch_counts()
    seconds, tick_ms, _ = drive(sched, trace,
                                after_tick=state_digests(sched, digests))
    counts = launch_counts()
    n_ticks = decode_ticks(sched)
    per = forward_launches(cfg)
    want = {k: (len(trace[0]) + n_ticks) * n for k, n in per.items()}
    print(f"{what}: launches {counts} (expected {want})")
    if counts != want:
        fail(f"{what}: launch counts {counts} != {want}")
    check_served_plans(what, counts)
    occ = sched.pool_occupancy()
    if occ.used != 0:
        fail(f"{what}: {occ.used} slots held after the run")
    n_tok = sum(len(t) for t in sched.finished.values())
    out = {"ticks": sched._ticks, "decode_ticks": n_ticks, "tokens": n_tok,
           "seconds": seconds, "tok_s": n_tok / seconds,
           "ms_per_tick": sum(tick_ms) / len(tick_ms),
           "slots_peak": max(sched.occupancy_log)}
    print(f"  {out['ticks']} ticks ({n_ticks} decoding), {n_tok} tokens in "
          f"{seconds * 1e3:.3f} ms = {out['tok_s']:.1f} tok/s, "
          f"{out['ms_per_tick']:.3f} ms per tick (host clock after "
          f"torch.cuda.synchronize()), slots_peak {out['slots_peak']} of "
          f"{SCHED_SLOTS}")

    draft = SpecConfig(first_layers(model, DRAFT_LAYERS),
                       cfg.replace(n_layers=DRAFT_LAYERS), N_DRAFT)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        spec = slot_scheduler(model, cfg, dev, spec=draft)
    said = [str(w.message) for w in caught]
    if spec.spec is not None or not any(
            "degrading to 1-token decode" in m for m in said):
        fail(f"{what}: spec= did not degrade to 1-token decode with the "
             f"reference's warning (warnings: {said})")
    plain_digests = []
    reset_launch_counts()
    with plain_versions():
        drive(spec, trace, after_tick=state_digests(spec, plain_digests))
    left = {k: n for k, n in launch_counts().items() if n}
    if left:
        fail(f"{what}: the plain-version run launched kernels: {left}")
    for rid, toks in sched.finished.items():
        if not torch.equal(torch.as_tensor(toks),
                           torch.as_tensor(spec.finished[rid])):
            fail(f"{what}: the spec= run on the plain versions gives other "
                 f"tokens than the counted run (request {rid})")
    if len(digests) != len(plain_digests) or not all(
            torch.equal(a, b) for a, b in zip(digests, plain_digests)):
        tick = next((t for t, (a, b) in enumerate(zip(digests,
                                                      plain_digests))
                     if not torch.equal(a, b)), None)
        fail(f"{what}: the slot state on the plain versions differs from "
             f"the counted run's ({len(plain_digests)} ticks against "
             f"{len(digests)}; first differing tick {tick})")
    print(f"  with spec= ({DRAFT_LAYERS}-layer draft) and the plain versions "
          f"of K1-K3 and quant_act_glu: warned {said[0]!r}; no kernel "
          f"launched; all {len(sched.finished)} requests' tokens and the "
          f"slot state ({', '.join(sched.cache)}) after each of the "
          f"{len(digests)} ticks bitwise equal the counted run's")
    drive(slot_scheduler(model, cfg, dev), trace, PROFILE_TICK_PLAIN)
    return out


def ssm_paths(dev):
    """Phase 4's SSM and hybrid path: zamba2-7b (w8a8, bf16) at full width
    and all 81 layers through (a) the dense serve with the plain versions
    swapped in, (b) ``prefill_step`` of LONG_PROMPT tokens, profiled by
    stage, (c) the Scheduler, plain and with ``spec=``, on the model's
    first SLOT_SCHED_LAYERS layers; then mamba2-370m at full size through
    (a) and (c)."""
    out = {}
    for arch, seed, long in ((HYBRID_ARCH, 12, True), (SSM_ARCH, 13, False)):
        model, cfg = blockwise_model(arch, dev, seed)
        counts, t_prefill, tps, _, cache = main_path(
            model, cfg, dev, what=f"{cfg.family} dense serve "
            f"({describe(cfg)})", label=f"{cfg.name} dense serve")
        del cache
        res = {"cfg": cfg, "serve": (counts, t_prefill, tps)}
        if long:
            res["long"] = long_prompt_run(model, cfg, dev, ranges=SSM_RANGES)
        depth = min(SLOT_SCHED_LAYERS, cfg.n_layers)
        res["sched"] = slot_sched_run(
            f"{cfg.family} scheduler plain ({cfg.name}, first {depth} "
            "layers), dense slots", first_layers(model, depth),
            cfg.replace(n_layers=depth), dev, sched_trace(cfg.vocab_size))
        print(f"{cfg.family}: torch.cuda.max_memory_allocated over the path "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del model
        torch.cuda.empty_cache()
        out[arch] = res
    return out


def card_vs_cpu_ssm(dev):
    """Phase 5 for the SSM families: zamba2-7b at full width,
    HYBRID_CHECK_LAYERS layers (one shared site), f32 ``none``, card
    against CPU on the same weights: the one-pass prefill and decode steps,
    and ``prefill(chunk=32)`` (two passes, each row's valid tokens as
    ``n_valid``) and decode steps, within rel-err 1e-5, argmax >= 0.99,
    launch counts exact; and the state each prefill commits (``ssm_h``,
    the conv tails, ``shared_k/v``) within rel-err 1e-5 of the CPU's, with
    equal ``seq_lens``."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import prefill
    cfg = get_config(HYBRID_ARCH).replace(
        n_layers=HYBRID_CHECK_LAYERS, quant_proj="none", dtype="float32")
    model_cpu = init_model(torch.Generator(device=dev).manual_seed(14), cfg,
                           device="cpu")
    model = copy.deepcopy(model_cpu).to(dev)
    n = len(BATCH_LENS) * (DECODE_STEPS + 1)
    out = {}
    for label, chunk in (("one pass", None), ("chunk=32", 32)):
        what = f"card vs CPU: {describe(cfg)}, prefill {label}"
        t0 = time.perf_counter()
        e_pre, e_dec, agree = compare(model_cpu, cfg, dev, what, chunk=chunk)
        states = {}
        for side, d, m in (("card", dev, model), ("cpu", "cpu", model_cpu)):
            prompts, lens = make_prompts(cfg, d)
            cache = init_cache(cfg, len(BATCH_LENS), max(BATCH_LENS),
                               dtype=torch.float32, device=d)
            _, cache = prefill(m, cache, prompts, lens, cfg, chunk=chunk)
            states[side] = {k: v.cpu() for k, v in cache.items()}
        card, cpu = states["card"], states["cpu"]
        if not torch.equal(card["seq_lens"], cpu["seq_lens"]):
            fail(f"{what}: seq_lens {card['seq_lens'].tolist()} against "
                 f"{cpu['seq_lens'].tolist()}")
        e_state = {k: rel_err(card[k], cpu[k]) for k in cpu
                   if k != "seq_lens"}
        print(f"{what}, launches exact: rel-err prefill {e_pre:.3e}, worst "
              f"decode step {e_dec:.3e} (limit {TOL_NONE}); argmax "
              f"agreement {agree:.4f} over {n} positions (limit "
              f"{TOL_ARGMAX}); committed state rel-err "
              + ", ".join(f"{k} {e:.3e}" for k, e in e_state.items())
              + f" (limit {TOL_NONE}); {time.perf_counter() - t0:.1f} s")
        if not (e_pre <= TOL_NONE and e_dec <= TOL_NONE):
            fail(f"{what}: rel-err above {TOL_NONE}")
        if max(e_state.values()) > TOL_NONE:
            fail(f"{what}: the committed state differs by more than "
                 f"{TOL_NONE}")
        if agree < TOL_ARGMAX:
            fail(f"{what}: argmax agreement {agree} < {TOL_ARGMAX}")
        out[label] = {"prefill_rel_err": e_pre, "decode_rel_err": e_dec,
                      "argmax": agree, "state_rel_err": max(e_state.values())}
    del model, model_cpu
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 4-5. the encoder-decoder and vision families: seamless-m4t-medium and
# phi-3-vision-4.2b
# ---------------------------------------------------------------------------
TRANSFORMER = "repro_torch.models.transformer"
ATTENTION = "repro_torch.models.attention"
# an encoder-decoder's stages, timed with CUDA events (which see K1-K5's
# ctypes launches, unlike the profiler's ranges): {stage: (module,
# function, pick)}, ``pick(kwargs, active)`` choosing the calls of the
# stage (``active``: the stages running now).  The cross K / V
# projections are attention.py's only apply_linears call (one K1 of the
# memory rows, two K2); its only non-causal dense attend outside the
# encoder is cross-attention's
ENCDEC_STAGES = {
    "encoder": (TRANSFORMER, "encode", None),
    "encoder self-attention": (
        TRANSFORMER, "apply_attention",
        lambda kw, active: not kw.get("causal", True)),
    "decoder self-attention": (
        TRANSFORMER, "apply_attention",
        lambda kw, active: kw.get("causal", True)
        and kw.get("memory") is None),
    "cross-attention": (TRANSFORMER, "apply_attention",
                        lambda kw, active: kw.get("memory") is not None),
    "cross k / v projections (K1 + 2 K2)": (ATTENTION, "apply_linears",
                                            None),
    "cross attend (dense, f32 scores)": (
        ATTENTION, "_attend_dense",
        lambda kw, active: not kw.get("causal", True)
        and not active["encoder"]),
    "decoder FFN": (TRANSFORMER, "apply_ffn",
                    lambda kw, active: not active["encoder"]),
    "logits": (TRANSFORMER, "unembed", None),
}


@contextlib.contextmanager
def timed_stages(stages, spans):
    """Within the block, each call of a function ``stages`` names that its
    pick chooses is bracketed by two CUDA events on the current stream,
    appended to ``spans`` as (stage, start, end)."""
    import collections
    active = collections.Counter()
    saved = []
    for name, (mod_name, fn_name, pick) in stages.items():
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def timed(*args, _fn=fn, _name=name, _pick=pick, **kwargs):
            if _pick is not None and not _pick(kwargs, active):
                return _fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            active[_name] += 1
            start.record()
            try:
                return _fn(*args, **kwargs)
            finally:
                end.record()
                active[_name] -= 1
                spans.append((_name, start, end))

        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, timed)
    try:
        yield
    finally:
        for mod, fn_name, fn in reversed(saved):
            setattr(mod, fn_name, fn)


def stage_times(fn, stages, label, calls=1):
    """``fn()`` with ``stages`` timed (``timed_stages``): the stream's ms
    between each stage's two CUDA events, summed over its calls, and its
    share of the whole run's (events around ``fn()``), per one of
    ``calls`` calls of what ``fn`` repeats.  A span holds the stage's
    device work and the gaps the host leaves in it, so in a host-bound
    run it measures the host; ``device_breakdown`` gives device time by
    kernel.  Stages nest (the encoder holds its attention and FFN).
    Returns {stage: ms}, and the whole as "total"."""
    spans = []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with timed_stages(stages, spans):
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    total = start.elapsed_time(end) / calls
    got = {name: 0.0 for name in stages}
    count = {name: 0 for name in stages}
    for name, a, b in spans:
        got[name] += a.elapsed_time(b) / calls
        count[name] += 1
    print(f"  stream time by stage (CUDA events: device work and the host's "
          f"gaps; {label}): {total:.3f} ms{' a call' if calls > 1 else ''}")
    for name, ms in got.items():
        print(f"    {ms:10.3f} ms {ms / total:6.3f} x{count[name] // calls:<4d}"
              f" {name}")
    return {**got, "total": total}


def encdec_step_breakdown(model, cfg, dev, steps=4):
    """A decode step of the encoder-decoder serve by stage: the serve's
    requests prefilled on a fresh paged cache with their memory, then
    ``steps`` steps timed (``stage_times``, per step) and profiled by
    kernel.  Each step's cross-attention projects K and V from all
    MEMORY_ROWS rows again in every decoder layer, as the reference
    does."""
    from repro_torch.models.transformer import encode
    from repro_torch.serving.cache import CacheConfig, init_cache
    from repro_torch.serving.engine import prefill, serve_step
    prompts, lens = make_prompts(cfg, dev)
    cache = init_cache(cfg, len(BATCH_LENS), max(BATCH_LENS) + DECODE_STEPS,
                       dtype=cfg.activation_dtype,
                       config=CacheConfig(layout="paged", page_size=PAGE,
                                          alloc="striped"), device=dev)
    memory = encode(model, embeds_for(cfg, len(BATCH_LENS), ENC_FRAMES, dev),
                    cfg)
    nl, cache = prefill(model, cache, prompts, lens, cfg, memory=memory)
    tok = torch.argmax(nl, dim=-1)[:, None]

    def run():
        nonlocal tok, cache
        for _ in range(steps):
            lg, cache = serve_step(model, cache, tok, None, cfg,
                                   memory=memory)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]

    run()                                                     # warm-up
    label = (f"{steps} decode steps of the {cfg.name} serve, "
             f"{len(BATCH_LENS)} x {ENC_FRAMES} memory rows")
    out = stage_times(run, ENCDEC_STAGES, label, calls=steps)
    # at M = 4 every K2 but the cross k / v over the memory rows plans
    # onto swap: its wide rows (gemm_tma<256, 1>) are those
    device_breakdown(run, top=12, label=label)
    del cache, memory
    torch.cuda.empty_cache()
    return out


def encdec_paths(dev):
    """Phase 4's encoder-decoder path: seamless-m4t-medium (w8a8, bf16) at
    full width and depth (12 + 12 layers), drawn on the card and quantized
    block by block: (a) the serve on the paged cache (``encode`` of
    ENC_FRAMES frames a request, 12 K5 non-causal; ``prefill(memory=)``;
    ``greedy_decode(memory=)``), launch counts exact, every K4 and K5 call
    held against the plain version, then bitwise against the plain K1-K3
    (memory included); a decode step by stage; (b) ``prefill_step(
    encoder_frames=)`` of one request, profiled by kernel and timed by
    stage."""
    from repro_torch.serving.cache import CacheConfig
    model, cfg = blockwise_model(ENCDEC_ARCH, dev, 15)
    config = CacheConfig(layout="paged", page_size=PAGE, alloc="striped")
    counts, t_prefill, tps, _, cache = main_path(
        model, cfg, dev, config,
        what=f"encoder-decoder paged serve ({describe(cfg)}; {ENC_FRAMES} "
             f"frames a request; page {PAGE}, striped, bf16 pools)",
        label=f"{cfg.name} paged serve")
    del cache
    step = encdec_step_breakdown(model, cfg, dev)
    long = long_prompt_run(model, cfg, dev, stages=ENCDEC_STAGES)
    print(f"{cfg.family}: torch.cuda.max_memory_allocated over the path "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model
    torch.cuda.empty_cache()
    return {"cfg": cfg, "serve": (counts, t_prefill, tps), "step": step,
            "long": long}


def vlm_paths(dev):
    """Phase 4's vision path: phi-3-vision-4.2b (w8a8, bf16) at full width
    and all 32 layers, drawn on the card and quantized block by block: (a)
    the text-only serve on the paged cache (K4 at head dim 96, 32/32
    heads), bitwise against the plain K1-K3; (b) ``prefill_step`` of its
    576 seeded patches and LONG_PROMPT - 576 tokens, one K5 a layer, each
    held against the plain version, profiled by kernel."""
    from repro_torch.serving.cache import CacheConfig
    model, cfg = blockwise_model(VLM_ARCH, dev, 16)
    config = CacheConfig(layout="paged", page_size=PAGE, alloc="striped")
    counts, t_prefill, tps, _, cache = main_path(
        model, cfg, dev, config,
        what=f"vision paged serve, text-only ({describe(cfg)}; page {PAGE}, "
             "striped, bf16 pools)", label=f"{cfg.name} paged serve")
    del cache
    long = long_prompt_run(model, cfg, dev)
    print(f"{cfg.family}: torch.cuda.max_memory_allocated over the path "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model
    torch.cuda.empty_cache()
    return {"cfg": cfg, "serve": (counts, t_prefill, tps), "long": long}


def card_vs_cpu_encdec(dev):
    """Phase 5 for the encoder-decoder: seamless-m4t-medium at full width,
    CHECK_LAYERS encoder and CHECK_LAYERS decoder layers, f32 ``none``,
    card against CPU on the same weights and CHECK_PROMPT seeded frames a
    request, with ``blockwise_attn_threshold`` cut to CHECK_PROMPT so the
    encoder runs K5 (non-causal, f32): the memory, then ``prefill(
    memory=)`` (one pass and ``chunk=32``) and 32 decode steps on the
    dense and the paged cache, each within rel-err 1e-5, argmax >= 0.99,
    launch counts exact."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import encode, init_model
    from repro_torch.serving.cache import CacheConfig
    cfg = get_config(ENCDEC_ARCH).replace(
        n_layers=CHECK_LAYERS, n_encoder_layers=CHECK_LAYERS,
        quant_proj="none", dtype="float32",
        blockwise_attn_threshold=CHECK_PROMPT)
    model_cpu = init_model(torch.Generator(device=dev).manual_seed(17), cfg,
                           device="cpu")
    frames = embeds_for(cfg, len(BATCH_LENS), CHECK_PROMPT, "cpu", 18)
    model = copy.deepcopy(model_cpu).to(dev)
    reset_launch_counts()
    memory = encode(model, frames.to(dev), cfg).cpu()
    counts = launch_counts()
    del model
    torch.cuda.empty_cache()
    want = encoder_launches(cfg, CHECK_PROMPT)
    e_mem = rel_err(memory, encode(model_cpu, frames, cfg))
    what = (f"card vs CPU: {describe(cfg)}, {len(BATCH_LENS)} x "
            f"{CHECK_PROMPT} frames, threshold {cfg.blockwise_attn_threshold}")
    print(f"{what}: memory rel-err {e_mem:.3e} (limit {TOL_NONE}), "
          f"launches {counts['flash_attention']} K5 (expected "
          f"{want['flash_attention']})")
    if counts != want:
        fail(f"{what}: encode's launch counts {counts} != {want}")
    if e_mem > TOL_NONE:
        fail(f"{what}: the memory differs by more than {TOL_NONE}")
    n = len(BATCH_LENS) * (DECODE_STEPS + 1)
    paged = dict(layout="paged", page_size=PAGE, alloc="striped")
    out = {"memory_rel_err": e_mem}
    for label, config, chunk in (("dense", None, None),
                                 ("dense, chunk=32", None, 32),
                                 ("paged", CacheConfig(**paged), None),
                                 ("paged, chunk=32", CacheConfig(**paged),
                                  32)):
        t0 = time.perf_counter()
        e_pre, e_dec, agree = compare(model_cpu, cfg, dev,
                                      f"{what}, {label}", config=config,
                                      chunk=chunk, frames=frames)
        print(f"{what}, {label}, prefill(memory=) and {DECODE_STEPS} decode "
              f"steps, launches exact: rel-err prefill {e_pre:.3e}, worst "
              f"decode step {e_dec:.3e} (limit {TOL_NONE}); argmax agreement "
              f"{agree:.4f} over {n} positions (limit {TOL_ARGMAX}); "
              f"{time.perf_counter() - t0:.1f} s")
        if not (e_pre <= TOL_NONE and e_dec <= TOL_NONE):
            fail(f"{what}, {label}: rel-err above {TOL_NONE}")
        if agree < TOL_ARGMAX:
            fail(f"{what}, {label}: argmax agreement {agree} < {TOL_ARGMAX}")
        out[label] = {"prefill_rel_err": e_pre, "decode_rel_err": e_dec,
                      "argmax": agree}
    del model_cpu
    return out


# ---------------------------------------------------------------------------
# 4. plan selection (core/dispatch.py) and the example twins
# ---------------------------------------------------------------------------
# the tuner's shapes (M, K, widths, out dtype): the paper GEMM in bf16 and
# f32, the paper's fused QKV, qwen2.5-3b's decode wo, and the two plan misses
# (zamba2-7b's in_B / in_C, N = 64, at decode and at 8192 rows)
TUNE_SHAPES = [(64, 768, (3072,), torch.bfloat16),
               (64, 768, (3072,), torch.float32),
               (64, 768, (768, 768, 768), torch.bfloat16),
               (4, 2048, (2048,), torch.bfloat16),
               (4, 3584, (64,), torch.bfloat16),
               (8192, 3584, (64,), torch.bfloat16)]
TUNE_ITERS = 3
TWINS = ("quickstart", "serve_quantized", "serve_zoo")
PLAN_SELECTION = {}


@contextlib.contextmanager
def tune_env(**values):
    """Within the block, the dispatcher's REPRO_TUNE* variables are
    ``values`` (None: unset), its table state and the wrappers' plan memo
    dropped on the way in and out."""
    from repro_torch.core import dispatch
    names = {"mode": dispatch.TUNE_ENV, "cache": dispatch.CACHE_ENV,
             "seed": dispatch.SEED_ENV, "iters": dispatch.ITERS_ENV}
    saved = {v: os.environ.get(v) for v in names.values()}
    for key, value in values.items():
        os.environ.pop(names[key], None)
        if value is not None:
            os.environ[names[key]] = str(value)
    dispatch.reset_cache_state()
    try:
        yield
    finally:
        for name, value in saved.items():
            os.environ.pop(name, None)
            if value is not None:
                os.environ[name] = value
        dispatch.reset_cache_state()


def gemm_call(ns, a, ws, out_dtype, plan=None):
    """K2 (one width) or K3 (three) on these operands; a tuple of outputs."""
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    if len(ns) == 1:
        return (tiled_matmul(a, ws[0], out_dtype=out_dtype, plan=plan),)
    return fused_qkv(a, *ws, out_dtype=out_dtype, plan=plan)


def gemm_plain(ns, a, ws, out_dtype):
    from repro_torch.kernels.fused_qkv.ref import fused_qkv_ref
    from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref
    if len(ns) == 1:
        return (tiled_matmul_ref(a.values, a.scale, ws[0].values,
                                 ws[0].scale, None, out_dtype),)
    return fused_qkv_ref(a.values, a.scale,
                         *(x for w in ws for x in (w.values, w.scale)),
                         out_dtype=out_dtype)


def plan_selection(dev, scratch):
    """(a) Under REPRO_TUNE=full, the shipped table off and a table in
    ``scratch``: tune K2 / K3 at TUNE_SHAPES, printing each candidate's
    device µs beside the analytic pick's.  Then under ``cached`` against
    the same file, through the wrappers: the stored plans are selected and
    launched (``launched_plans``), and the outputs are bitwise those of the
    analytic plan and of the plain version."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.tiled_matmul.ops import gemm_plan, tiled_matmul
    table = os.path.join(scratch, "plan_selection.json")
    rows, winners = [], {}
    with tune_env(mode="full", cache=table, seed=0, iters=TUNE_ITERS):
        for m, k, ns, dt in TUNE_SHAPES:
            results = []
            if len(ns) == 1:
                win = dispatch.tune(m, k, ns[0], out_dtype=dt,
                                    results=results)
                again = dispatch.select_plan(m, k, ns[0], out_dtype=dt)
            else:
                win = dispatch.tune_fused(m, k, ns[0], ns[1], out_dtype=dt,
                                          results=results)
                again = dispatch.select_fused_plan(m, k, ns[0], ns[1],
                                                   out_dtype=dt)
            if again != win:
                fail(f"plan selection: full mode re-tuned ({m}, {k}) x "
                     f"{list(ns)}: {again} after storing {win}")
            analytic = gemm_plan(m, ns, k, True)
            if results[0][0] != analytic:
                fail(f"plan selection: the first candidate {results[0][0]} "
                     f"is not the analytic pick {analytic}")
            what = f"({m},{k})x{'|'.join(map(str, ns))} {dt}"
            print(f"  tune {what}: " + ", ".join(
                f"{p.variant} n{p.cols} split {p.split}"
                f"{'*' if p == analytic else ''}{'>' if p == win else ''} "
                f"{us:.3f}" for p, us in results) + " µs")
            winners[(m, k, ns, dt)] = win
            rows.append({"shape": what, "analytic": list(analytic),
                         "analytic_us": results[0][1], "tuned": list(win),
                         "tuned_us": dict(results)[win],
                         "candidates": [[list(p), us] for p, us in results]})
    with tune_env(mode="cached", cache=table, seed=0):
        for (m, k, ns, dt), win in winners.items():
            a, ws = quantized_operands(m, k, list(ns), dev, seed=m + ns[0])
            reset_launch_counts()
            outs = gemm_call(ns, a, ws, dt)
            wrapper = tiled_matmul if len(ns) == 1 else fused_qkv
            name = "tiled_matmul" if len(ns) == 1 else "fused_qkv"
            launched = dict(wrapper.launched_plans)
            if launched != {win: 1} or launch_counts()[name] != 1:
                fail(f"plan selection, cached: ({m}, {k}) x {list(ns)} "
                     f"launched {launched}, the table holds {win}")
            analytic_outs = gemm_call(ns, a, ws, dt,
                                      plan=gemm_plan(m, ns, k, True))
            for got, ana, plain in zip(outs, analytic_outs,
                                       gemm_plain(ns, a, ws, dt)):
                if not (torch.equal(got, ana) and torch.equal(got, plain)):
                    fail(f"plan selection, cached: {win} at ({m}, {k}) x "
                         f"{list(ns)} is not bitwise the analytic plan's "
                         "and the plain version's output")
            reset_launch_counts()
            del a, ws, outs, analytic_outs
    print(f"plan selection: {len(winners)} shapes tuned (full, "
          f"{TUNE_ITERS} replays a candidate), then selected, launched and "
          "bitwise the analytic plan and the plain version (cached)")
    PLAN_SELECTION["tuned"] = rows
    torch.cuda.empty_cache()


def distilbert_plans(cfg):
    """Each K2 / K3 plan the dense distilbert serve launches, with its
    count: the prefill's rows (4 x 64) once and the decode's (4) at each
    step, every layer's fused QKV, wo, up and down, as the dispatcher
    selects them now."""
    from repro_torch.core import dispatch
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.activation_dtype
    want = collections.Counter()
    for m, forwards in ((len(BATCH_LENS) * max(BATCH_LENS), 1),
                        (len(BATCH_LENS), DECODE_STEPS)):
        n = cfg.n_layers * forwards
        want[("fused_qkv", dispatch.select_fused_plan(
            m, d, cfg.q_dim, cfg.kv_dim, out_dtype=dt))] += n
        for k, width in ((cfg.q_dim, d), (d, f), (f, d)):
            want[("tiled_matmul", dispatch.select_plan(
                m, k, width, out_dtype=dt))] += n
    return want


def served_plan_modes(model, cfg, dev):
    """(b) The full-width distilbert dense serve under the shipped table
    (``cached``) and under ``off``: logits, tokens and the KV cache bitwise
    equal, and the launches by plan (counts set to 0 just before each
    serve) what each mode selects at the served shapes."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    runs = {}
    for mode in ("cached", "off"):
        with tune_env(mode=mode, seed=None):
            want = distilbert_plans(cfg)
            reset_launch_counts()
            logits, toks, cache, _, _ = serve(model, cfg, dev)
            got = collections.Counter(
                {("tiled_matmul", p): n
                 for p, n in tiled_matmul.launched_plans.items()})
            got.update({("fused_qkv", p): n
                        for p, n in fused_qkv.launched_plans.items()})
            reset_launch_counts()
        if got != want:
            fail(f"distilbert serve under REPRO_TUNE={mode}: launches by "
                 f"plan {dict(got)} != the selected {dict(want)}")
        runs[mode] = (logits, toks, cache, got)
        print(f"  distilbert dense serve, REPRO_TUNE={mode}: launches by "
              "plan " + ", ".join(
                  f"{name} {p.variant} n{p.cols} split {p.split}: {n}"
                  for (name, p), n in sorted(got.items())))
    (l1, t1, c1, g1), (l2, t2, c2, g2) = runs["cached"], runs["off"]
    for name, x, y in (("prefill logits", l1, l2), ("tokens", t1, t2),
                       ("cache k", c1["k"], c2["k"]),
                       ("cache v", c1["v"], c2["v"])):
        if not torch.equal(x, y):
            fail(f"distilbert serve: {name} differ between the shipped "
                 "table's plans and REPRO_TUNE=off's")
    differ = sum(n for key, n in g1.items() if key not in g2)
    print(f"distilbert dense serve under the shipped table and under "
          f"REPRO_TUNE=off: logits, tokens and cache bitwise equal "
          f"({differ} of {sum(g1.values())} K2 / K3 launches on another "
          "plan than off's)")
    PLAN_SELECTION["distilbert_launches_by_plan"] = {
        mode: {f"{name} {p.variant} n{p.cols} split {p.split}": n
               for (name, p), n in sorted(r[3].items())}
        for mode, r in runs.items()}


def load_twin(name):
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin_outputs(name):
    """One run of the twin on the card, its printing kept: its tensors
    (quickstart) or each request's tokens (the serving twins)."""
    mod = load_twin(name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if name == "quickstart":
            res = mod.main(["--device", "cuda"])
            got = {k: res[k] for k in ("fp_logits", "q_logits", "tokens")}
        elif name == "serve_quantized":
            got = {f"request {r}": torch.as_tensor(t)
                   for r, t in mod.main(["--device", "cuda"]).finished.items()}
        else:
            got = {f"{arch} request {r}": torch.as_tensor(t)
                   for arch, sched in mod.main(["--device", "cuda"]).items()
                   for r, t in sched.finished.items()}
    return got, out.getvalue()


def twins_on_card(scratch):
    """(c) The three example twins on the card: each run on the plain
    versions of K1-K3, under REPRO_TUNE=full into a fresh table (the
    shipped one under it) and under ``cached`` against that table: all
    three bitwise equal."""
    for name in TWINS:
        table = os.path.join(scratch, f"{name}.json")
        with plain_versions():
            plain, _ = twin_outputs(name)
        with tune_env(mode="full", cache=table, seed=None, iters=1):
            full, _ = twin_outputs(name)
        with tune_env(mode="cached", cache=table, seed=None):
            cached, text = twin_outputs(name)
        for what, other in (("the plain versions", plain),
                            ("REPRO_TUNE=full", full)):
            if other.keys() != cached.keys() or not all(
                    torch.equal(cached[k], other[k]) for k in cached):
                fail(f"examples/{name}_torch.py on the card: the cached "
                     f"run differs from {what}")
        tuned = len(json.load(open(table))) if os.path.exists(table) else 0
        last = [ln for ln in text.splitlines() if ln.strip()][-1]
        print(f"  examples/{name}_torch.py: {len(cached)} outputs bitwise "
              f"equal on the plain versions, under full ({tuned} shapes "
              f"tuned) and cached; last line: {last}")


# ---------------------------------------------------------------------------
# 6. timings
# ---------------------------------------------------------------------------
def device_ms(fn, sets, launches=None, replays=3):
    """Device time of one ``fn(*set)`` call: a CUDA graph of ``launches``
    (default LAUNCHES) calls that rotate over ``sets`` (so operands are
    cold in L2), replayed and timed with CUDA events."""
    launches = launches or LAUNCHES
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for s in sets[:3]:
            fn(*s)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def n_copies(set_bytes):
    return max(2, min(256, -(-2 * L2_BYTES // set_bytes)))


def bound(bytes_moved, ops, ops_rate):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_plans(fn, ref, sets, m, k, launches):
    """``fn``'s device ms at each row mapping that takes (m, k) bf16 (its
    plan forced by patching ``quant_plan``, so the wrapper still checks
    it), each first held bitwise against ``ref``; returns (quant_plan's
    choice, {plan: ms})."""
    from repro_torch.kernels.quant_act import ops
    chosen = ops.quant_plan(m, k, torch.bfloat16, True)
    plans = {}
    for plan in ops.candidate_plans(m, k, torch.bfloat16, True):
        def run(*x, plan=plan):
            with mock.patch.object(ops, "quant_plan", lambda *_: plan):
                return fn(*x)
        got, want = run(*sets[0]), ref(*sets[0])
        max_err(got.values, want[0], f"{fn.__name__} ({m},{k}) [{plan}]")
        max_err(got.scale, want[1], f"{fn.__name__} ({m},{k}) [{plan}]")
        plans[str(plan)] = device_ms(run, sets, launches)
    return str(chosen), plans


def time_quant_act(m, k, dev, launches=None):
    """K1 at x (m, k) bf16: every row mapping (``k1_plans``), the plain
    version; the bound from one read of x and one write of the int8
    values and scales."""
    from repro_torch.kernels.quant_act.ops import quant_act
    from repro_torch.kernels.quant_act.ref import quant_act_ref
    elt = 2
    sets = [(device_randn((m, k), i, dev, 1.0, torch.bfloat16),)
            for i in range(n_copies(m * k * elt))]
    b_ms, by = bound(m * k * elt + m * k + 4 * m, 3 * m * k, F32_OPS_PER_S)
    chosen, plans = k1_plans(quant_act, quant_act_ref, sets, m, k, launches)
    return {"ms": plans[chosen], "plan": chosen, "plans": plans,
            "plain_ms": plain_timer(m, launches)(quant_act_ref, sets),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def unfused_swiglu(gate, up):
    """The path quant_act_glu replaces: PyTorch's silu and product, then
    K1 (the yardstick; not a library call)."""
    from repro_torch.kernels.quant_act.ops import quant_act
    return quant_act(torch.nn.functional.silu(gate) * up)


def time_quant_glu(m, k, dev, launches=None):
    """quant_act_glu at gate, up (m, k) bf16: every row mapping, the plain
    version and the unfused path it replaces; the bound from one read of
    gate and of up and one write of the int8 values and scales (7 f32
    operations an element: exp, add, two divisions, product, max,
    round)."""
    from repro_torch.kernels.quant_act.ops import quant_act_glu
    from repro_torch.kernels.quant_act.ref import quant_act_glu_ref
    elt = 2
    sets = [(device_randn((m, k), 2 * i, dev, 1.0, torch.bfloat16),
             device_randn((m, k), 2 * i + 1, dev, 1.0, torch.bfloat16))
            for i in range(n_copies(2 * m * k * elt))]
    b_ms, by = bound(2 * m * k * elt + m * k + 4 * m, 7 * m * k,
                     F32_OPS_PER_S)
    chosen, plans = k1_plans(quant_act_glu, quant_act_glu_ref, sets, m, k,
                             launches)
    return {"ms": plans[chosen], "plan": chosen, "plans": plans,
            "plain_ms": plain_timer(m, launches)(quant_act_glu_ref, sets),
            "unfused_ms": plain_timer(m, launches)(unfused_swiglu, sets),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


# rows at which K1's and quant_act_glu's operands at d_ff fit in L2
L2_ROWS = 256


def glu_alu_check(dev, k=11008):
    """Whether HBM's bytes bind quant_act_glu, against K1 alone as the
    control: each at (L2_ROWS, k) bf16 with its operands cold (copies
    beyond L2) and L2-resident (one set, launched again and again); and
    quant_act_glu at (LONG_PROMPT, k) in f32 beside bf16 (1.8x the bytes,
    the same operations, fewer roundings).  A kernel the bytes bind runs
    faster from L2 than cold, and in f32 about 1.8x as long."""
    from repro_torch.kernels.quant_act.ops import quant_act, quant_act_glu
    out = {}
    for name, fn, n_in in (("quant_act", quant_act, 1),
                           ("quant_act_glu", quant_act_glu, 2)):
        sets = [tuple(randn((L2_ROWS, k), n_in * i + j, dev, 1.0,
                            torch.bfloat16) for j in range(n_in))
                for i in range(n_copies(n_in * L2_ROWS * k * 2))]
        cold, warm = device_ms(fn, sets), device_ms(fn, sets[:1])
        out[name] = {"shape": f"({L2_ROWS},{k}) bf16", "cold_ms": cold,
                     "l2_ms": warm, "l2_over_cold": warm / cold}
        del sets
    by_dtype = {}
    for dtype in (torch.bfloat16, torch.float32):
        elt = torch.finfo(dtype).bits // 8
        sets = [tuple(randn((LONG_PROMPT, k), 2 * i + j, dev, 1.0, dtype)
                      for j in (0, 1))
                for i in range(n_copies(2 * LONG_PROMPT * k * elt))]
        by_dtype[str(dtype).split(".")[1]] = device_ms(quant_act_glu, sets,
                                                       10)
        del sets
        torch.cuda.empty_cache()
    out["quant_act_glu"].update(
        prefill_bf16_ms=by_dtype["bfloat16"], prefill_f32_ms=by_dtype[
            "float32"],
        f32_over_bf16=by_dtype["float32"] / by_dtype["bfloat16"],
        f32_over_bf16_if_bytes_bind=(2 * 4 + 1) / (2 * 2 + 1))
    for name, r in out.items():
        print(f"  ALU check {name} {r['shape']}: cold {r['cold_ms']:.5f} ms, "
              f"L2-resident {r['l2_ms']:.5f} ms ({r['l2_over_cold']:.3f} of "
              "cold)" + ("" if "prefill_f32_ms" not in r else
                         f"; ({LONG_PROMPT},{k}) bf16 "
                         f"{r['prefill_bf16_ms']:.5f} ms, f32 "
                         f"{r['prefill_f32_ms']:.5f} ms ("
                         f"{r['f32_over_bf16']:.3f}x; bytes alone would "
                         f"give {r['f32_over_bf16_if_bytes_bind']:.1f}x)"))
    return out


def int_mm_epilogue(a, sa, b_cm, sb, out_dtype):
    """The library yardstick: torch._int_mm, then the dequant epilogue."""
    return (torch._int_mm(a, b_cm).float() * (sa * sb)).to(out_dtype)


def int_mm_alone(a, sa, b_cm, sb):
    """torch._int_mm without the epilogue: the library's GEMM core, timed
    beside the yardstick (whose unfused epilogue can cost more than its
    GEMM)."""
    return torch._int_mm(a, b_cm)


# torch._int_mm refuses M <= 16: at decode its yardstick runs on A
# zero-padded (before timing) to this many rows
INT_MM_MIN_M = 32


def pad_rows(x, m):
    return torch.cat([x, x.new_zeros((m - x.shape[0],) + x.shape[1:])])


def plain_timer(m, launches):
    """The plain versions' timer: past 1024 rows each call allocates GBs
    in f64, which a graph of many calls would hold at once, so they run
    eagerly."""
    if m > 1024:
        return eager_ms
    return lambda fn, sets: device_ms(fn, sets, launches)


def time_gemm(m, k, n, out_dtype, dev, launches=None):
    from repro_torch.kernels.tiled_matmul.ops import tiled_matmul
    from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref
    out_b = torch.tensor([], dtype=out_dtype).element_size()
    nbytes = m * k + 4 * m + k * n + 4 * n + m * n * out_b
    ops = [quantized_operands(m, k, [n], dev, seed=i, draw=device_randn)
           for i in range(n_copies(nbytes))]
    sets = [(a, b) for a, (b,) in ops]
    plain_sets = [(a.values, a.scale, b.values, b.scale) for a, b in sets]
    b_ms, by = bound(nbytes, 2 * m * n * k, INT8_OPS_PER_S)
    row = {"ms": device_ms(lambda a, b: tiled_matmul(a, b, out_dtype=out_dtype),
                           sets, launches),
           "plain_ms": plain_timer(m, launches)(
               lambda *s: tiled_matmul_ref(*s, out_dtype=out_dtype),
               plain_sets),
           "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    if k % 8 == 0 and n % 8 == 0:
        mp = max(m, INT_MM_MIN_M)
        # the weights rest K-major: _int_mm's column-major second operand
        lib_sets = [(pad_rows(a.values, mp), pad_rows(a.scale, mp),
                     b.values, b.scale) for a, b in sets]
        row["library_ms"] = device_ms(
            lambda *s: int_mm_epilogue(*s, out_dtype)[:m], lib_sets, launches)
        row["int_mm_ms"] = device_ms(int_mm_alone, lib_sets, launches)
        if mp != m:
            row["library_note"] = f"padded to M={mp}"
    return row


def time_fused(m, k, nq, nkv, dev, launches=None):
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.fused_qkv.ref import fused_qkv_ref
    n_all = nq + 2 * nkv
    nbytes = m * k + 4 * m + k * n_all + 4 * n_all + 4 * m * n_all
    ops = [quantized_operands(m, k, [nq, nkv, nkv], dev, seed=i,
                              draw=device_randn)
           for i in range(n_copies(nbytes))]
    sets = [(a, *ws) for a, ws in ops]
    plain_sets = [(a.values, a.scale) + sum(((w.values, w.scale) for w in ws),
                                            ()) for a, ws in ops]
    b_ms, by = bound(nbytes, 2 * m * k * n_all, INT8_OPS_PER_S)
    row = {"ms": device_ms(
               lambda *s: fused_qkv(*s, out_dtype=torch.float32), sets,
               launches),
           "plain_ms": plain_timer(m, launches)(
               lambda *s: fused_qkv_ref(*s, out_dtype=torch.float32),
               plain_sets),
           "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    if k % 8 == 0 and n_all % 8 == 0:
        mp = max(m, INT_MM_MIN_M)
        lib_sets = [(pad_rows(a.values, mp), pad_rows(a.scale, mp),
                     torch.cat([w.values for w in ws], 1).t().contiguous().t(),
                     torch.cat([w.scale for w in ws], 1)) for a, ws in ops]
        row["library_ms"] = device_ms(
            lambda *s: int_mm_epilogue(*s, torch.float32)[:m], lib_sets,
            launches)
        row["int_mm_ms"] = device_ms(int_mm_alone, lib_sets, launches)
        if mp != m:
            row["library_note"] = f"padded to M={mp}"
    return row


def sdpa_gathered(q, k, v, mask):
    """The library yardstick for K4: scaled_dot_product_attention over K/V
    already gathered into dense (B, KH, T, D) form, one mask per
    sequence."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def time_paged(b, t, h, kh, d, lens, dev, *, qs=1, page=PAGE, kv="bf16",
               q_dtype=None, q_chunk=None, window=None, launches=None,
               new_lens=None):
    """K4 at one shape: kernel, plain version and library yardstick, and
    the bound from the K/V rows this run's lengths make visible.  With
    ``new_lens`` (a list) the verify launch, whose rows past the live
    count see nothing (and a sequence with none reads nothing)."""
    from repro_torch.kernels.flash_attention.decode import (
        flash_decode_schedule, pages_touched, split_plan)
    from repro_torch.kernels.flash_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ref import (
        dequantize_gathered, paged_decode_attention_ref, paged_gather,
        paged_gather_scales)
    elt = {"f32": 4, "bf16": 2, "int8": 1}[kv]
    q_dt = q_dtype or (torch.bfloat16 if kv == "bf16" else torch.float32)
    q_elt = 2 if q_dt == torch.bfloat16 else 4
    # the products run at the rate of q's type (int8 pages meet a bf16 q)
    peak = BF16_OPS_PER_S if q_dt == torch.bfloat16 else F32_OPS_PER_S
    # the K/V rows some new row of a sequence sees, once per KV head: its
    # whole context, or with a window its last window + qs - 1 rows; and
    # the table entries of their pages (the one-block schedule's walk)
    live = [qs] * b if new_lens is None else list(new_lens)
    kv_rows = sum(min(n, window + nl - 1) if window else n
                  for n, nl in zip(lens, live) if nl)
    pages = pages_touched([n for n, nl in zip(lens, live) if nl],
                          flash_decode_schedule(t // page, page, q_len=qs,
                                                window=window))
    nbytes = (kv_rows * kh * (2 * d * elt + (8 if kv == "int8" else 0))
              + 2 * b * qs * h * d * q_elt + 4 * pages
              + 4 * b * (1 if new_lens is None else 2))
    # QK and PV: 4·d flops per (query head, live row, visible key)
    visible = sum(min(n - nl + r + 1, window or t)
                  for n, nl in zip(lens, live) for r in range(nl))
    b_ms, by = bound(nbytes, 4 * d * h * visible, peak)
    opts = dict(q_chunk=q_chunk, window=window)
    sets = [(paged_inputs(b, t, h, kh, d, lens, dev, qs=qs, page=page, kv=kv,
                          q_dtype=q_dtype, seed=i),)
            for i in range(n_copies(nbytes))]
    if new_lens is not None:
        for (c,) in sets:
            c["new_lens"] = torch.tensor(new_lens, dtype=torch.int32,
                                         device=dev)

    def library_operands(c):
        k, v = (paged_gather(c[f"{n}_pages"], c["page_table"])
                for n in ("k", "v"))
        if kv == "int8":
            k = dequantize_gathered(k, paged_gather_scales(c["k_scales"],
                                                           c["page_table"]))
            v = dequantize_gathered(v, paged_gather_scales(c["v_scales"],
                                                           c["page_table"]))
        n_live = c.get("new_lens", torch.full_like(c["lengths"], qs)).long()
        rows = torch.arange(qs, device=dev)
        q_pos = c["lengths"].long()[:, None] - n_live[:, None] + rows
        k_pos = torch.arange(k.shape[1], device=dev)
        mask = k_pos <= q_pos[..., None]                   # (B, qs, T)
        mask &= (rows < n_live[:, None])[..., None]        # dead rows
        if window is not None:
            mask &= k_pos > q_pos[..., None] - window
        dt = c["q"].dtype
        return (c["q"].transpose(1, 2), k.transpose(1, 2).to(dt),
                v.transpose(1, 2).to(dt), mask[:, None])

    plan = split_plan(b, kh, h // kh, flash_decode_schedule(
        t // page, page, q_len=qs, window=window, q_chunk=q_chunk))
    row = {"splits": f"{plan.n_splits} x {plan.pages_per_split} pages",
           "ms": device_ms(lambda c: paged_decode_attention(**c, **opts),
                           sets, launches),
           "plain_ms": device_ms(
               lambda c: paged_decode_attention_ref(**c, **opts), sets,
               launches),
           "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    try:
        row["library_ms"] = device_ms(
            sdpa_gathered, [library_operands(c) for (c,) in sets], launches)
    except RuntimeError as e:        # a yardstick only: report, go on
        print(f"  (library yardstick unavailable: {e})")
    return row


def eager_ms(fn, sets, calls=3):
    """Device time of one ``fn(*set)`` call run eagerly between CUDA events
    (for a function that allocates GBs per call, which a graph of many
    calls would hold at once), after one warm-up call."""
    fn(*sets[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def visible_pairs(s_len, t_len, *, causal=True, window=None):
    """The (query, key) pairs the masks leave visible: key t for query s
    when t <= s (causal) and t > s - window."""
    total = 0
    for s in range(s_len):
        hi = min(s, t_len - 1) if causal else t_len - 1
        lo = max(s - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def time_flash(b, s, h, kh, d, dev, *, dtype=torch.bfloat16,
               launches=None,
               **opts):
    """K5 at one shape (t = s): kernel, plain version and, where it
    computes the same function (causal or not, no window, no softcap),
    ``scaled_dot_product_attention``; the bound from the visible pairs'
    flops (QK and PV: 4 * d per pair and head) at the tensor-core peak of
    the dtype, and from q, k, v and out moved once."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    launches = launches or LONG_LAUNCHES
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = elt * 2 * (b * s * h * d + b * s * kh * d)
    pairs = visible_pairs(s, s, causal=opts.get("causal", True),
                          window=opts.get("window"))
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    b_ms, by = bound(nbytes, 4 * d * h * b * pairs, peak)
    sets = [flash_inputs(b, s, s, h, kh, d, dev, dtype, seed=i)
            for i in range(n_copies(nbytes))]
    row = {"ms": device_ms(lambda *x: flash_attention(*x, **opts), sets,
                           launches, replays=3),
           "plain_ms": eager_ms(lambda *x: attention_ref(*x, **opts), sets),
           "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    if not opts.get("window") and not opts.get("softcap"):
        lib_sets = [tuple(x.transpose(1, 2).contiguous() for x in st)
                    for st in sets]
        try:
            row["library_ms"] = device_ms(
                lambda q, k, v:
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=opts.get("causal", True),
                    enable_gqa=True, scale=opts.get("scale")), lib_sets,
                launches, replays=3)
        except RuntimeError as e:    # a yardstick only: report, go on
            print(f"  (library yardstick unavailable: {e})")
    return row


def timings(cfg, dev):
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.q_dim, cfg.kv_dim
    bf16 = torch.bfloat16
    shapes = {"quant_act": [], "fused_qkv": [], "tiled_matmul": []}
    for phase, m in (("prefill", 256), ("decode", len(BATCH_LENS))):
        # one layer's launches at this M: 3 quant_act of width d (qkv, wo,
        # up) and one of width d_ff (down); the fused QKV; wo, up and down
        for k, times in ((d, 3), (f, 1)):
            shapes["quant_act"].append(
                (phase, f"({m},{k}) bf16", times, time_quant_act(m, k, dev)))
        shapes["fused_qkv"].append(
            (phase, f"({m},{d})x({d},{q}|{kv}|{kv}) f32", 1,
             time_fused(m, d, q, kv, dev)))
        for name, k, n in (("wo", q, d), ("up", d, f), ("down", f, d)):
            shapes["tiled_matmul"].append(
                (phase, f"{name} ({m},{k})x({k},{n}) bf16", 1,
                 time_gemm(m, k, n, bf16, dev)))
    # qwen2.5-3b's K1-K3 launches of one layer at decode (M=4), verify
    # (M=20) and an 8192-token prefill (fewer launches there): K1 three
    # times at d_model (QKV, wo, the FFN's input), quant_act_glu once at
    # d_ff; K1 alone at d_ff is the unfused down input of earlier PRs (x 0)
    stamp("phase 6: qwen2.5-3b's K1-K3 rows")
    for name in ("quant_act", "quant_act_glu", "fused_qkv", "tiled_matmul"):
        shapes[f"qwen {name}"] = []
    for phase, m in (("decode", 4), ("verify", 20), ("prefill", LONG_PROMPT)):
        n = LONG_LAUNCHES if m == LONG_PROMPT else LAUNCHES
        shapes["qwen quant_act"] += [
            (phase, f"({m},2048) bf16", 3, time_quant_act(m, 2048, dev, n)),
            (phase, f"({m},11008) bf16", 0, time_quant_act(m, 11008, dev, n))]
        shapes["qwen quant_act_glu"].append(
            (phase, f"({m},11008) bf16", 1, time_quant_glu(m, 11008, dev, n)))
        shapes["qwen fused_qkv"].append(
            (phase, f"({m},2048)x(2048,2048|256|256) f32", 1,
             time_fused(m, 2048, 2048, 256, dev, launches=n)))
        for name, k, nn, times in (("wo", 2048, 2048, 1),
                                   ("gate/up", 2048, 11008, 2),
                                   ("down", 11008, 2048, 1)):
            shapes["qwen tiled_matmul"].append(
                (phase, f"{name} ({m},{k})x({k},{nn}) bf16", times,
                 time_gemm(m, k, nn, bf16, dev, launches=n)))
    # qwen3-moe-30b-a3b's attention launches of one layer at the same rows:
    # K1 at d_model (the fused QKV's input; the row above) and at 4096 (wo's
    # input), the fused QKV 2048 -> 4096 | 512 | 512, wo 4096 -> 2048
    stamp("phase 6: qwen3-moe's rows")
    for name in ("quant_act", "fused_qkv", "tiled_matmul"):
        shapes[f"moe {name}"] = []
    for phase, m in (("decode", 4), ("verify", 20), ("prefill", LONG_PROMPT)):
        n = LONG_LAUNCHES if m == LONG_PROMPT else LAUNCHES
        d_row = next(r for p, desc, _, r in shapes["qwen quant_act"]
                     if p == phase and desc == f"({m},2048) bf16")
        shapes["moe quant_act"] += [
            (phase, f"({m},2048) bf16", 1, d_row),
            (phase, f"({m},{MOE_WO[0]}) bf16", 1,
             time_quant_act(m, MOE_WO[0], dev, n))]
        k, nq, nkv = MOE_QKV
        shapes["moe fused_qkv"].append(
            (phase, f"({m},{k})x({k},{nq}|{nkv}|{nkv}) f32", 1,
             time_fused(m, k, nq, nkv, dev, launches=n)))
        shapes["moe tiled_matmul"].append(
            (phase, f"wo ({m},{MOE_WO[0]})x({MOE_WO[0]},{MOE_WO[1]}) bf16",
             1, time_gemm(m, *MOE_WO, bf16, dev, launches=n)))
    # zamba2-7b's launches at decode (M=4) and prefill_step (8192 rows):
    # a Mamba layer's (phase "decode" / "prefill") K1 over d_model (the five
    # in-projections' input) and d_inner (out_proj's), K2 in_z / in_x,
    # in_B / in_C, in_dt and out_proj; a shared site's ("... site") K1 over
    # d_model (x 3), quant_act_glu over d_ff, K3 (MHA), K2 wo, gate / up,
    # down
    stamp("phase 6: zamba2-7b's rows")
    for name in ("quant_act", "quant_act_glu", "fused_qkv", "tiled_matmul"):
        shapes[f"zamba2 {name}"] = []
    z_mamba, z_site, (zd, zq, zkv) = zamba_shapes()
    zdi, zf = z_mamba[0][1], z_site[1][1]
    for phase, m in (("decode", 4), ("prefill", LONG_PROMPT)):
        n = LONG_LAUNCHES if m == LONG_PROMPT else LAUNCHES
        site = f"{phase} site"
        d_row = time_quant_act(m, zd, dev, n)
        shapes["zamba2 quant_act"] += [
            (phase, f"({m},{zd}) bf16", 1, d_row),
            (phase, f"({m},{zdi}) bf16", 1, time_quant_act(m, zdi, dev, n)),
            (site, f"({m},{zd}) bf16", 3, d_row)]
        shapes["zamba2 quant_act_glu"].append(
            (site, f"({m},{zf}) bf16", 1, time_quant_glu(m, zf, dev, n)))
        shapes["zamba2 fused_qkv"].append(
            (site, f"({m},{zd})x({zd},{zq}|{zkv}|{zkv}) f32", 1,
             time_fused(m, zd, zq, zkv, dev, launches=n)))
        for p_, names, gemm_shapes in (
                (phase, (("in_z/in_x", 2), ("in_B/in_C", 2), ("in_dt", 1),
                         ("out_proj", 1)), z_mamba),
                (site, (("wo", 1), ("gate/up", 2), ("down", 1)), z_site)):
            for (name, times), (k, nn) in zip(names, gemm_shapes):
                shapes["zamba2 tiled_matmul"].append(
                    (p_, f"{name} ({m},{k})x({k},{nn}) bf16", times,
                     time_gemm(m, k, nn, bf16, dev, launches=n)))
    # the Scheduler's prefill forwards: K1 at d_model (x 3), quant_act_glu
    # at d_ff
    stamp("phase 6: the Scheduler's chunk rows")
    for m in SCHED_CHUNK_ROWS:
        shapes["qwen quant_act"].append(
            (f"chunk-{m}", f"({m},2048) bf16", 3, time_quant_act(m, 2048, dev)))
        shapes["qwen quant_act_glu"].append(
            (f"chunk-{m}", f"({m},11008) bf16", 1,
             time_quant_glu(m, 11008, dev)))
    # seamless-m4t-medium: a decoder layer's launches at decode ("decode",
    # M = 4: K1 over d_model for the self QKV, wo, cross q, cross wo and up
    # (x 5), over d_ff for down; every step's K1 of the MEMORY_ROWS memory
    # rows and its cross k / v K2; K3; K2 wo, cross q and wo (x 3), up,
    # down) and an encoder layer's at the serve's MEMORY_ROWS frames
    # ("encoder"); phi-3-vision's at decode and prefill_step (LONG_PROMPT
    # rows): K1 over d_model (x 3), quant_act_glu over d_ff, K3 (MHA), K2
    # wo, gate / up, down
    stamp("phase 6: seamless and phi-3 rows")
    for fam in ("seamless", "phi3"):
        for name in ("quant_act", "quant_act_glu", "fused_qkv",
                     "tiled_matmul"):
            shapes[f"{fam} {name}"] = []
    (s_wo, s_up, s_down), s_qkv = model_shapes(ENCDEC_ARCH)
    sd, sf = s_up
    mem_k1 = time_quant_act(MEMORY_ROWS, sd, dev, LONG_LAUNCHES)
    shapes["seamless quant_act"] += [
        ("decode", f"(4,{sd}) bf16", 5, time_quant_act(4, sd, dev)),
        ("decode", f"(4,{sf}) bf16", 1, time_quant_act(4, sf, dev)),
        ("decode", f"memory ({MEMORY_ROWS},{sd}) bf16", 1, mem_k1),
        ("encoder", f"({MEMORY_ROWS},{sd}) bf16", 3, mem_k1),
        ("encoder", f"({MEMORY_ROWS},{sf}) bf16", 1,
         time_quant_act(MEMORY_ROWS, sf, dev, LONG_LAUNCHES))]
    shapes["seamless fused_qkv"] += [
        (phase, f"({m},{s_qkv[0]})x({s_qkv[0]},{s_qkv[1]}|{s_qkv[2]}|"
                f"{s_qkv[2]}) f32", 1,
         time_fused(m, *s_qkv, dev,
                    launches=LONG_LAUNCHES if m > 1024 else LAUNCHES))
        for phase, m in (("decode", 4), ("encoder", MEMORY_ROWS))]
    mem_kv = time_gemm(MEMORY_ROWS, *s_wo, bf16, dev, launches=LONG_LAUNCHES)
    shapes["seamless tiled_matmul"] += [
        ("decode", f"wo, cross q / wo (4,{s_wo[0]})x({s_wo[0]},{s_wo[1]}) "
                   "bf16", 3, time_gemm(4, *s_wo, bf16, dev)),
        ("decode", f"cross k / v ({MEMORY_ROWS},{s_wo[0]})x({s_wo[0]},"
                   f"{s_wo[1]}) bf16", 2, mem_kv),
        ("decode", f"up (4,{sd})x({sd},{sf}) bf16", 1,
         time_gemm(4, *s_up, bf16, dev)),
        ("decode", f"down (4,{sf})x({sf},{sd}) bf16", 1,
         time_gemm(4, *s_down, bf16, dev)),
        ("encoder", f"wo ({MEMORY_ROWS},{s_wo[0]})x({s_wo[0]},{s_wo[1]}) "
                    "bf16", 1, mem_kv),
        ("encoder", f"up ({MEMORY_ROWS},{sd})x({sd},{sf}) bf16", 1,
         time_gemm(MEMORY_ROWS, *s_up, bf16, dev, launches=LONG_LAUNCHES)),
        ("encoder", f"down ({MEMORY_ROWS},{sf})x({sf},{sd}) bf16", 1,
         time_gemm(MEMORY_ROWS, *s_down, bf16, dev, launches=LONG_LAUNCHES))]
    (v_wo, v_up, v_down), v_qkv = model_shapes(VLM_ARCH)
    vd, vf = v_up
    for phase, m in (("decode", 4), ("prefill", LONG_PROMPT)):
        n = LONG_LAUNCHES if m == LONG_PROMPT else LAUNCHES
        shapes["phi3 quant_act"].append(
            (phase, f"({m},{vd}) bf16", 3, time_quant_act(m, vd, dev, n)))
        shapes["phi3 quant_act_glu"].append(
            (phase, f"({m},{vf}) bf16", 1, time_quant_glu(m, vf, dev, n)))
        shapes["phi3 fused_qkv"].append(
            (phase, f"({m},{vd})x({vd},{v_qkv[1]}|{v_qkv[2]}|{v_qkv[2]}) "
                    "f32", 1, time_fused(m, *v_qkv, dev, launches=n)))
        for name, (k, nn), times in (("wo", v_wo, 1), ("gate/up", v_up, 2),
                                     ("down", v_down, 1)):
            shapes["phi3 tiled_matmul"].append(
                (phase, f"{name} ({m},{k})x({k},{nn}) bf16", times,
                 time_gemm(m, k, nn, bf16, dev, launches=n)))
    stamp("phase 6: gemma2-27b's K1 and K4 rows")
    # gemma2-27b's K1 at d_ff (its GELU stays unfused): decode, prefill
    shapes["gemma2 quant_act"] = [
        (phase, f"({m},36864) bf16", 1,
         time_quant_act(m, 36864, dev,
                        LONG_LAUNCHES if m == LONG_PROMPT else LAUNCHES))
        for phase, m in (("decode", 4), ("prefill", LONG_PROMPT))]
    # K4: one launch per layer; the serve's prefill (one 64-row q block)
    # and first decode step, in bf16 and int8 pools; then long contexts
    # whose bound is more than launch latency (bf16 pools, page 64)
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = -(-(max(BATCH_LENS) + DECODE_STEPS) // PAGE) * PAGE
    first_step = [n + 1 for n in BATCH_LENS]
    rows = []
    for pool in ("bf16", "int8"):
        sfx = "" if pool == "bf16" else "-int8"
        rows.append((f"prefill{sfx}",
                     f"{len(BATCH_LENS)}x64 {pool} page {PAGE}", 1,
                     time_paged(len(BATCH_LENS), t, h, kh, hd,
                                [max(BATCH_LENS)] * len(BATCH_LENS), dev,
                                qs=max(BATCH_LENS), kv=pool,
                                q_dtype=torch.bfloat16, q_chunk=128)))
        rows.append((f"decode{sfx}", f"lens {first_step} {pool}", 1,
                     time_paged(len(BATCH_LENS), t, h, kh, hd, first_step,
                                dev, kv=pool, q_dtype=torch.bfloat16)))
    # the Scheduler's plain decode launch (qwen2.5-3b's heads, 4 x 1 row
    # over the verify row's contexts)
    rows.append(("sched-decode", f"4x1 H16 KH2 D128 bf16 lens {VERIFY_LENS}",
                 1, time_paged(4, 576, 16, 2, 128, VERIFY_LENS, dev,
                               kv="bf16")))
    for label, hh, kk, dd in (("long", 12, 12, 64), ("long-gqa", 16, 2, 128)):
        rows.append((label, f"8x4096 H{hh} KH{kk} D{dd} bf16 page 64", 1,
                     time_paged(8, 4096, hh, kk, dd, [4096] * 8, dev,
                                page=64, kv="bf16", launches=LAUNCHES // 2)))
    shapes["paged_decode"] = rows
    # the serve's K4 launches of seamless-m4t-medium's decoder (16/16 heads
    # of 64) and phi-3-vision's (32/32 of 96): the prefill's 4 x 64 rows,
    # the first decode step; bf16 pools
    for fam, hh, dd in (("seamless", 16, 64), ("phi3", 32, 96)):
        shapes[f"{fam} paged_decode"] = [
            ("prefill", f"{len(BATCH_LENS)}x64 H{hh} KH{hh} D{dd} bf16 page "
                        f"{PAGE}", 1,
             time_paged(len(BATCH_LENS), t, hh, hh, dd,
                        [max(BATCH_LENS)] * len(BATCH_LENS), dev,
                        qs=max(BATCH_LENS), kv="bf16",
                        q_dtype=torch.bfloat16, q_chunk=128)),
            ("decode", f"H{hh} KH{hh} D{dd} lens {first_step} bf16", 1,
             time_paged(len(BATCH_LENS), t, hh, hh, dd, first_step, dev,
                        kv="bf16", q_dtype=torch.bfloat16))]
    # K4's verify mode: one launch per layer of a spec tick's verify pass,
    # at the served shape (qwen2.5-3b's heads, 4 sequences of 5 rows over
    # contexts of 45-560 tokens), bf16 and int8 pools
    shapes["paged_decode_verify"] = [
        (f"verify{'' if pool == 'bf16' else '-int8'}",
         f"4x{VERIFY_Q} H16 KH2 D128 {pool} lens {VERIFY_LENS}", 1,
         time_paged(4, 576, 16, 2, 128, VERIFY_LENS, dev, qs=VERIFY_Q,
                    kv=pool, q_dtype=torch.bfloat16,
                    new_lens=[VERIFY_Q] * 4))
        for pool in ("bf16", "int8")]
    stamp("phase 6: K5 rows")
    # K5: one launch per layer of prefill_step at the served shapes
    shapes["flash_attention"] = [
        ("prefill", f"qwen2.5-3b 1x{LONG_PROMPT} H16 KH2 D128 bf16", 1,
         time_flash(1, LONG_PROMPT, 16, 2, 128, dev)),
        ("local", f"gemma2-27b 1x{LONG_PROMPT} H32 KH16 W4096 cap50", 1,
         time_flash(1, LONG_PROMPT, 32, 16, 128, dev, scale=144 ** -0.5,
                    window=4096, softcap=50.0)),
        ("global", f"gemma2-27b 1x{LONG_PROMPT} H32 KH16 cap50", 1,
         time_flash(1, LONG_PROMPT, 32, 16, 128, dev, scale=144 ** -0.5,
                    softcap=50.0)),
        ("zamba2", f"zamba2-7b 1x{LONG_PROMPT} H32 KH32 D112 bf16", 1,
         time_flash(1, LONG_PROMPT, 32, 32, 112, dev)),
        ("seamless", f"seamless-m4t-medium encoder 4x{ENC_FRAMES} H16 KH16 "
                     "D64 bf16 non-causal", 1,
         time_flash(4, ENC_FRAMES, 16, 16, 64, dev, causal=False)),
        ("phi3", f"phi-3-vision 1x{LONG_PROMPT} H32 KH32 D96 bf16", 1,
         time_flash(1, LONG_PROMPT, 32, 32, 96, dev)),
        # the f32 path (the ALUs; phase 5's card-vs-CPU runs take it)
        ("prefill-f32", f"qwen2.5-3b 1x{LONG_PROMPT} H16 KH2 D128 f32", 1,
         time_flash(1, LONG_PROMPT, 16, 2, 128, dev, dtype=torch.float32,
                    launches=4)),
    ]

    print("timings (device ms per launch; bound = max(bytes / 3.35 TB/s, "
          "ops / peak)):")
    print(f"  {'kernel':18s} {'phase':13s} {'shape':38s} {'x':>2s} "
          f"{'ms':>9s} {'plain_ms':>9s} {'lib_ms':>9s} {'bound_ms':>9s} by")
    for kname, rows in shapes.items():
        for phase, desc, times, r in rows:
            lib = ("-" if r["library_ms"] is None
                   else f"{r['library_ms']:.5f}")
            note = f" (library {r['library_note']})" if "library_note" in r \
                else ""
            if "splits" in r:
                note += f"; {r['splits']}"
            if "int_mm_ms" in r:
                note += f"; _int_mm alone {r['int_mm_ms']:.5f}"
            if "unfused_ms" in r:
                note += (f"; the unfused path (F.silu * up, then K1) "
                         f"{r['unfused_ms']:.5f}")
            if "plans" in r:
                note += "; by plan: " + ", ".join(
                    f"{p}{'*' if p == r['plan'] else ''} {ms:.5f}"
                    for p, ms in r["plans"].items())
            print(f"  {kname:18s} {phase:13s} {desc:38s} {times:2d} "
                  f"{r['ms']:9.5f} {r['plain_ms']:9.5f} {lib:>9s} "
                  f"{r['bound_ms']:9.5f} {r['bound_by']}{note}")
    return shapes


def per_layer(rows, phase):
    """Sum of one layer's launches in ``phase``: kernel, plain, library
    (None if any shape has none) and bound."""
    sel = [(times, r) for p, _, times, r in rows if p == phase]
    out = {key: sum(t * r[key] for t, r in sel)
           for key in ("ms", "plain_ms", "bound_ms")}
    libs = [r["library_ms"] for _, r in sel]
    out["library_ms"] = (None if any(x is None for x in libs)
                         else sum(t * r["library_ms"] for t, r in sel))
    out["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                     for _, r in sel) else "operations"
    notes = {r["library_note"] for _, r in sel if "library_note" in r}
    if notes:
        out["library_note"] = ", ".join(sorted(notes))
    return out


KERNELS = {
    "quant_act": ("src/repro_torch/csrc/quant_act.cu",
                  "src/repro/kernels/quant_act/kernel.py:20"),
    "fused_qkv": ("src/repro_torch/csrc/int8_gemm.cu",
                  "src/repro/kernels/fused_qkv/kernel.py:60"),
    "tiled_matmul": ("src/repro_torch/csrc/int8_gemm.cu",
                     "src/repro/kernels/tiled_matmul/kernel.py:67"),
    "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/flash_attention/decode.py:178"),
}
# what each kernel's row times: one layer's launches at prefill
WORK = {"paged_decode": "one prefill layer: 4 x 64 rows over bf16 pages"}
VERIFY_KERNEL = ("src/repro_torch/csrc/paged_decode.cu",
                 "src/repro/kernels/flash_attention/decode.py:178 (the "
                 "has_new_lens branch, :181 and :232)")
FLASH_KERNEL = ("src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/kernel.py:133")


def served_plans(name):
    """``name``'s launches and launches by plan in each served path's
    counted run that launched it (SERVED_PLANS)."""
    return {what: {"launches": r["counts"][name],
                   "by_plan": r["plans"][name]}
            for what, r in SERVED_PLANS.items() if r["counts"][name]}


def path_launches(name, model_name):
    """``name``'s launches in each counted run of ``model_name``'s path."""
    return {what: r["counts"][name] for what, r in SERVED_PLANS.items()
            if model_name in what}


# the per-shape timing rows of each model's path in the kernels line, and
# the phases they are summed over (zamba2-7b's: one Mamba layer, and one
# shared site)
PATH_ROWS = {"qwen": ("qwen2_5_3b", ("decode", "verify", "prefill")),
             "moe": ("qwen3_moe_30b_a3b", ("decode", "verify", "prefill")),
             "zamba2": ("zamba2_7b", ("decode", "prefill", "decode site",
                                      "prefill site")),
             "seamless": ("seamless_m4t_medium", ("decode", "encoder",
                                                  "prefill")),
             "phi3": ("phi3_vision_4_2b", ("decode", "prefill"))}


def path_rows(rows, phases):
    """One layer's launches summed per phase (those ``rows`` has), and the
    rows."""
    have = {p for p, _, _, _ in rows}
    return {"work": "one layer's launches (sum over them)",
            **{phase: per_layer(rows, phase) for phase in phases
               if phase in have},
            "shapes": [dict(phase=phase, shape=desc, times=times, **r)
                       for phase, desc, times, r in rows]}


# ---------------------------------------------------------------------------
# K5's backward (phase 3) and the training path (phases 4-6)
# ---------------------------------------------------------------------------
TRAIN_ARCH = "qwen2_5_3b"
TRAIN_SEQ = 4096
TRAIN_STEPS = 3
TRAIN_CHECK_SEQ = 256                      # phase 5: the threshold, lowered
RESTART_STEPS = 5
# K5's gradients against the plain backward: f32 within atol / rtol; bf16
# each row (one head of one query or key) within BWD_BF16_REL of its
# largest value, floored at bf16's resolution of the tensor
# (``grad_row_rel_err``).  Against autograd through the plain forward the
# f32 rtol is of each row's largest value: autograd's dV is one f32 sum
# over the g heads' S queries (32768 terms at qwen2.5-3b's training
# shape), whose own rounding reaches ~1e-4 on an H100 where the early keys
# gather large terms that cancel, while the kernel and the step-by-step
# plain backward agree to ~2e-6 there
BWD_ATOL, BWD_RTOL, BWD_BF16_REL = 1e-5, 1e-4, 2e-2
BWD_GRAPH_CALLS = 4                        # phase 6: backward calls a graph
# the training path's first step with the plain attention against K5's:
# the loss and the global gradient norm, in bf16 end to end over 36 layers
PLAIN_STEP_LOSS, PLAIN_STEP_GNORM = 1e-2, 5e-2
# name, b, s, t, h, kh, d, options: qwen2.5-3b's training shape; gemma2-
# 27b's local layer with its S and window both cut 4x (8192 / 4096 to
# 2048 / 1024, so the window bites); seamless-m4t-medium's non-causal
# encoder at head dim 64; phi-3-vision's 96 and zamba2-7b's 112 (MHA);
# partial tiles; rows that see no key (a non-causal window past T)
BWD_SHAPES = [
    ("qwen2.5-3b training", 1, TRAIN_SEQ, TRAIN_SEQ, 16, 2, 128, {}),
    ("gemma2-27b local, S and window / 4", 1, 2048, 2048, 32, 16, 128,
     dict(scale=144 ** -0.5, window=1024, softcap=50.0)),
    ("seamless-m4t-medium encoder", 2, 1024, 1024, 16, 16, 64,
     dict(causal=False)),
    ("phi-3-vision D 96", 1, 1024, 1024, 32, 32, 96, {}),
    ("zamba2-7b D 112", 1, 1024, 1024, 32, 32, 112, {}),
    ("partial tiles", 1, 77, 77, 4, 4, 64, {}),
    ("partial tiles, window + softcap", 1, 300, 300, 8, 4, 128,
     dict(window=70, softcap=50.0)),
    ("rows that see no key", 1, 200, 64, 4, 2, 32,
     dict(causal=False, window=32)),
]
FLASH_BWD_KERNEL = (
    "src/repro_torch/csrc/flash_attention_bwd.cu",
    "none: the JAX package differentiates the attention of "
    "src/repro/kernels/flash_attention/kernel.py:133 by autodiff of its "
    "blockwise jnp path (src/repro/models/attention.py:166)")


def grad_row_rel_err(got, want):
    """The bf16 rule for K5's gradients: each row's max |got - want| over
    its largest |want| or, where that lies below bf16's resolution of the
    tensor (2^-8 of its largest |want|), over that resolution: a row whose
    exact gradient cancels to ~0 (the first query of a causal row sees one
    key, and dS = P (dP - D) = 0) is rounding noise on both sides."""
    floor = want.double().abs().max() * 2.0 ** -8
    diff = (got.double() - want.double()).abs().amax(-1)
    size = want.double().abs().amax(-1).clamp_min(floor)
    return (diff / size).max().item()


def kernel_grads(q, k, v, dout, opts):
    """K5 under autograd on the card: (out, dq, dk, dv)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = flash_attention(q, k, v, **opts)
    return (out.detach(),) + torch.autograd.grad(out, (q, k, v), dout)


def check_flash_bwd(dev):
    """K5's backward kernels against the step-by-step plain backward and
    against autograd through the plain forward (in f32) on the same CUDA
    tensors, at BWD_SHAPES in f32 and bf16; then two runs bitwise equal and
    K5's O bitwise the same with and without the log-sum-exps, at the
    training shape.  Returns (max |err| against the plain backward in f32,
    max rel-err in bf16)."""
    from repro_torch.kernels.flash_attention.ops import _flash_forward
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    worst_abs = worst_rel = 0.0
    for i, (name, b, s, t, h, kh, d, opts) in enumerate(BWD_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(b, s, t, h, kh, d, dev, dtype, seed=40 + i)
            dout = flash_inputs(b, s, s, h, h, d, dev, dtype, seed=60 + i)[0]
            out, *got = kernel_grads(q, k, v, dout, opts)
            plain = attention_bwd_ref(q, k, v, dout, **opts)
            qa, ka, va = (x.detach().float().requires_grad_()
                          for x in (q, k, v))
            auto = torch.autograd.grad(attention_ref(qa, ka, va, **opts),
                                       (qa, ka, va), dout.float())
            torch.cuda.synchronize()
            errs, ok = [], True
            for g, want_plain, want_auto in zip(got, plain, auto):
                for want, scale in ((want_plain.float(), None),
                                    (want_auto, "row")):
                    diff = (g.double() - want.double()).abs()
                    if dtype == torch.float32:
                        size = want.double().abs()
                        if scale:       # autograd's own f32 sums: per row
                            size = size.amax(-1, keepdim=True)
                        ok &= bool((diff <= BWD_ATOL + BWD_RTOL
                                    * size).all())
                        errs.append(diff.max().item())
                    else:
                        errs.append(grad_row_rel_err(g, want))
                        ok &= errs[-1] <= BWD_BF16_REL
            if "no key" in name:
                dead = out.abs().amax(dim=(0, 2, 3)) == 0      # (S,) rows
                ok &= bool(dead.any()) and bool(
                    (got[0][:, dead] == 0).all())
            if dtype == torch.float32:        # errs: plain, autograd, ...
                worst_abs = max(worst_abs, max(errs[::2]))
                limit = f"atol {BWD_ATOL}, rtol {BWD_RTOL}"
            else:
                worst_rel = max(worst_rel, max(errs))
                limit = f"per-row rel-err limit {BWD_BF16_REL}"
            what = (f"flash_attention backward {name} ({b}x{s}x{t}x{h}x{d}, "
                    f"KH={kh}, {str(dtype)[6:]}"
                    f"{', ' + str(opts) if opts else ''})")
            print(f"  {'ok' if ok else 'FAIL'} {what}: dq / dk / dv against "
                  f"the plain backward and autograd "
                  + " ".join(f"{e:.3e}" for e in errs) + f" ({limit})")
            if not ok:
                fail(f"{what}: K5's backward differs from its plain version")
            del q, k, v, dout, out, got, plain, qa, ka, va, auto
    name, b, s, t, h, kh, d, opts = BWD_SHAPES[0]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(b, s, t, h, kh, d, dev, dtype, seed=90)
        dout = flash_inputs(b, s, s, h, h, d, dev, dtype, seed=91)[0]
        runs = [kernel_grads(q, k, v, dout, opts) for _ in range(2)]
        fwd = [_flash_forward(q, k, v, d ** -0.5, True, None, None,
                              with_lse=lse)[0] for lse in (False, True)]
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        o_same = torch.equal(*fwd)
        print(f"  {'ok' if same and o_same else 'FAIL'} {name} "
              f"{str(dtype)[6:]}: two backward runs bitwise equal {same}; "
              f"K5's O with and without the log-sum-exps bitwise equal "
              f"{o_same}")
        if not (same and o_same):
            fail(f"{name}: K5's backward is not deterministic, or the lse "
                 "output moved O")
        del q, k, v, dout, runs, fwd
    return worst_abs, worst_rel


def plain_attention():
    """The models' K5 calls swapped for the plain version, which autograd
    differentiates on the card."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def plain(q, k, v, **opts):
        return attention_ref(q, k, v, **opts).to(q.dtype)
    return mock.patch("repro_torch.models.attention.flash_attention", plain)


def train_launches(cfg, steps):
    """The launches of ``steps`` train steps of ``cfg`` past its blockwise
    threshold: K5 twice a layer (the forward, then the remat recompute in
    the backward), its backward once, K1-K4 never (quant_proj none)."""
    want = {k: 0 for k in layer_launches(cfg)}
    want["flash_attention"] = 2 * cfg.n_layers * steps
    want["flash_attention_backward"] = cfg.n_layers * steps
    return want


def new_train_state(cfg, dev, generator_device, lr=3e-4, total=100):
    """A TrainState of ``cfg`` (ZeRO-1 in bf16) from a seeded generator on
    ``generator_device``, and its AdamW (warmup_cosine)."""
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.training.train_step import TrainState
    model = init_model(torch.Generator(device=generator_device)
                       .manual_seed(0), cfg, device=dev)
    opt = AdamW(learning_rate=warmup_cosine(lr, min(20, total), total))
    return TrainState.create(model, opt, zero1=cfg.dtype == "bfloat16"), opt


def training_path(dev):
    """qwen2.5-3b (bf16, quant_proj none, remat per block) at full width
    and all 36 layers, its ZeRO-1 state drawn on the card: the first step's
    loss and gradient norm with the plain attention (autograd through it),
    then TRAIN_STEPS counted train steps of TRAIN_SEQ tokens through K5 and
    its backward (launch counts exact), each timed, the peak allocation,
    and one more step under torch.profiler."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim.adamw import global_norm
    from repro_torch.training.train_step import (make_loss_fn,
                                                 make_train_step, trainable,
                                                 value_and_grad)
    cfg = get_config(TRAIN_ARCH)
    state, opt = new_train_state(cfg, dev, dev)
    n_params = sum(t.numel() for t in state.master.values())
    resident = torch.cuda.memory_allocated(dev) / 1e9
    print(f"training path: {cfg.name} {cfg.dtype} quant_proj "
          f"{cfg.quant_proj} remat {cfg.remat}, {cfg.n_layers} layers, "
          f"d={cfg.d_model}, d_ff={cfg.d_ff}, vocab={cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B parameters, ZeRO-1 state {resident:.2f} "
          f"GB resident; batch 1 x {TRAIN_SEQ} tokens (SyntheticLM)")
    data = SyntheticLM(cfg.vocab_size, 1, TRAIN_SEQ, seed=0, device=dev)
    with plain_attention():
        t0 = time.perf_counter()
        grads, metrics = value_and_grad(make_loss_fn(cfg), state.params,
                                        trainable(state.params),
                                        data.batch_at(0), cast=True)
        plain = (float(metrics["loss"]), float(global_norm(grads)))
        t_plain = time.perf_counter() - t0
    del grads
    torch.cuda.empty_cache()
    step_fn = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    times, history = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data.batch_at(i))
        history.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    want = train_launches(cfg, TRAIN_STEPS)
    print(f"  launches in {TRAIN_STEPS} steps: {counts} (expected {want})")
    if counts != want:
        fail(f"training path: launch counts {counts} != {want}")
    for i, (m, t) in enumerate(zip(history, times)):
        print(f"  step {i + 1}: loss {m['loss']:.6f} grad_norm "
              f"{m['grad_norm']:.6f} lr {m['lr']:.3e}, {t * 1e3:.1f} ms "
              "(host clock, synchronized)")
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"training path: step {i + 1} loss or gradient norm not "
                 "finite")
    rel_loss = abs(history[0]["loss"] - plain[0]) / abs(plain[0])
    rel_norm = abs(history[0]["grad_norm"] - plain[1]) / plain[1]
    ok = rel_loss <= PLAIN_STEP_LOSS and rel_norm <= PLAIN_STEP_GNORM
    print(f"  {'ok' if ok else 'FAIL'} step 1 against the plain attention "
          f"(loss {plain[0]:.6f}, grad_norm {plain[1]:.6f}, "
          f"{t_plain * 1e3:.1f} ms for its forward and backward): rel-err "
          f"loss {rel_loss:.3e} (limit {PLAIN_STEP_LOSS}), grad_norm "
          f"{rel_norm:.3e} (limit {PLAIN_STEP_GNORM})")
    if not ok:
        fail("training path: K5's step differs from the plain attention's")
    print(f"  peak allocation {peak:.2f} GB of "
          f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.1f}; "
          f"steady step {min(times[1:]) * 1e3:.1f} ms")
    rows = device_breakdown(
        lambda: step_fn(state, data.batch_at(TRAIN_STEPS))[1]["loss"].item(),
        top=12, label="a 4th train step")
    split = bwd_split(rows)
    print("  K5's backward by kernel, device ms a call in that step: "
          + (", ".join(f"{k} {v:.5f}" for k, v in split.items())
             or "not measured"))
    del state, data
    torch.cuda.empty_cache()
    return {"counts": counts, "times": times, "peak_gb": peak,
            "history": history, "plain": plain, "rows": rows,
            "resident_gb": resident, "bwd_split": split}


def restart_path(dev):
    """``run_with_restarts`` on the card at qwen2.5-3b's smoke config (bf16
    ZeRO-1, 64 tokens: K5 and its backward): checkpoints every 2 steps to a
    temporary directory, a failure injected at step 3; the steps after the
    restart against an uninterrupted run's.  Returns (whether the losses
    are bitwise equal, the largest relative difference)."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.failures import FailureOracle, run_with_restarts
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.trainer import Trainer
    cfg = get_smoke_config(TRAIN_ARCH)
    seq = cfg.blockwise_attn_threshold

    def trainer(ckpt_dir, oracle=None):
        state, opt = new_train_state(cfg, dev, dev, lr=1e-3,
                                     total=RESTART_STEPS)
        return Trainer(state=state, step_fn=make_train_step(cfg, opt),
                       data=SyntheticLM(cfg.vocab_size, 2, seq, seed=0,
                                        device=dev),
                       ckpt_dir=ckpt_dir, ckpt_every=2, oracle=oracle,
                       log_every=1)

    oracle = FailureOracle(fail_at_steps=(3,))
    made = []

    def restarted():
        # the cut run's checkpoint writer may still be writing step 2 when
        # the failure lands (a thread of the same process): let it finish,
        # so the restart restores step 2 every time
        if made:
            made[-1]._ckpt.wait()
        made.append(trainer(f"{tmp}/cut", oracle))
        return made[-1]

    with tempfile.TemporaryDirectory() as tmp:
        _, whole = trainer(f"{tmp}/whole").run(0, RESTART_STEPS)
        _, restarts, history = run_with_restarts(restarted, RESTART_STEPS,
                                                 f"{tmp}/cut")
    resumed = dict(history[1:])
    if restarts != 1 or sorted(resumed) != [3, 4, 5]:
        fail(f"restart path: {restarts} restarts, steps {sorted(resumed)} "
             "after them")
    pairs = [(resumed[s]["loss"], m["loss"]) for s, m in whole if s >= 3]
    bitwise = all(a == b for a, b in pairs)
    worst = max(abs(a - b) / abs(b) for a, b in pairs)
    print(f"  {'ok' if worst <= 1e-6 else 'FAIL'} run_with_restarts "
          f"({cfg.name} smoke, bf16 ZeRO-1, {seq} tokens, a failure at "
          f"step 3, restored from step 2's checkpoint): losses of steps 3-5 "
          f"{[f'{a:.7f}' for a, _ in pairs]} against the uninterrupted "
          f"run's {[f'{b:.7f}' for _, b in pairs]}: bitwise {bitwise}, "
          f"max rel-diff {worst:.3e} (limit 1e-6 where not bitwise)")
    if worst > 1e-6:
        fail("restart path: the restarted run left the uninterrupted one")
    return bitwise, worst


def card_vs_cpu_train(dev):
    """One f32 train step's gradients of qwen2.5-3b at full width and
    CHECK_LAYERS layers over TRAIN_CHECK_SEQ tokens, its blockwise threshold
    lowered to that length so the card runs K5 and its backward: card
    against CPU (the plain versions), the same weights (drawn on the CPU)
    and batch.  Loss within 1e-5 relative, each leaf's gradient within 1e-4
    relative norm, launch counts exact on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training.train_step import (make_loss_fn, trainable,
                                                 value_and_grad)
    cfg = get_config(TRAIN_ARCH).replace(
        n_layers=CHECK_LAYERS, dtype="float32",
        blockwise_attn_threshold=TRAIN_CHECK_SEQ)
    out = {}
    for d in ("cpu", dev):
        state, _ = new_train_state(cfg, d, "cpu")
        batch = SyntheticLM(cfg.vocab_size, 1, TRAIN_CHECK_SEQ, seed=0,
                            device=d).batch_at(0)
        reset_launch_counts()
        grads, metrics = value_and_grad(make_loss_fn(cfg), state.params,
                                        trainable(state.params), batch)
        out[str(d)] = (float(metrics["loss"]),
                       {n: g.cpu() for n, g in grads.items()},
                       launch_counts())
        del state, grads
    (loss_c, grads_c, _), (loss_g, grads_g, counts) = (out["cpu"],
                                                       out[str(dev)])
    want = train_launches(cfg, 1)
    if counts != want:
        fail(f"card vs CPU train step: launch counts {counts} != {want}")
    rels = {n: float(torch.linalg.norm(grads_g[n] - g)
                     / torch.linalg.norm(g).clamp_min(1e-30))
            for n, g in grads_c.items()}
    worst = max(rels, key=rels.get)
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    ok = loss_rel <= 1e-5 and rels[worst] <= 1e-4
    print(f"  {'ok' if ok else 'FAIL'} card vs CPU train step ({cfg.name}, "
          f"{CHECK_LAYERS} layers f32, {TRAIN_CHECK_SEQ} tokens, threshold "
          f"{TRAIN_CHECK_SEQ}): loss {loss_g:.7f} / {loss_c:.7f} rel-err "
          f"{loss_rel:.3e} (limit 1e-5); worst gradient {worst} rel-err "
          f"{rels[worst]:.3e} over {len(rels)} leaves (limit 1e-4); "
          f"launches {counts}")
    if not ok:
        fail("card vs CPU train step: the card's gradients differ")
    return loss_rel, rels[worst]


def time_flash_bwd(dev, b=1, s=TRAIN_SEQ, h=16, kh=2, d=128,
                   dtype=torch.bfloat16, calls=3):
    """K5's backward at the training shape (causal): the backward kernels
    alone (``flash_attention_backward`` on a forward's saved output and
    log-sum-exps) in a CUDA graph of BWD_GRAPH_CALLS calls (their inputs,
    ~70 MB, exceed L2), and eagerly between CUDA events beside the host's
    time to enqueue a call; the step-by-step plain backward, and PyTorch's
    ``scaled_dot_product_attention`` backward (autograd of one call) as the
    yardstick, each eagerly between CUDA events; the bound from the
    visible pairs' flops (10 D per pair and head: QK, dO V^T, P^T dO,
    dA^T Q, dA K) at the dtype's peak and from the bytes of q, k, v, dO,
    O (f32), lse and the three gradients moved once."""
    from repro_torch.kernels.flash_attention.ops import (
        _flash_forward, flash_attention_backward)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    scale = d ** -0.5
    q, k, v = flash_inputs(b, s, s, h, kh, d, dev, dtype, seed=70)
    dout = flash_inputs(b, s, s, h, h, d, dev, dtype, seed=71)[0]
    _, lse, out32 = _flash_forward(q, k, v, scale, True, None, None,
                                   with_lse=True)
    elt = q.element_size()
    nbytes = (elt * 2 * (q.numel() + k.numel() + v.numel()) + elt
              * dout.numel() + 4 * (out32.numel() + lse.numel()))
    pairs = visible_pairs(s, s)
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    b_ms, by = bound(nbytes, 10 * d * h * b * pairs, peak)

    def kernels():
        return flash_attention_backward(q, k, v, out32, lse, dout,
                                        scale=scale)
    row = {"ms": device_ms(kernels, [()], BWD_GRAPH_CALLS),
           "eager_ms": eager_ms(kernels, [()], calls),
           "plain_ms": eager_ms(lambda: attention_bwd_ref(q, k, v, dout),
                                [()], 1),
           "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        kernels()
    row["host_ms"] = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    os_ = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True)
    dos = dout.transpose(1, 2).contiguous()
    try:
        row["library_ms"] = eager_ms(lambda: torch.autograd.grad(
            os_, (qs, ks, vs), dos, retain_graph=True), [()], calls)
    except RuntimeError as e:    # a yardstick only: report, go on
        print(f"  (library yardstick unavailable: {e})")
    print(f"  flash_attention backward ({b}x{s}x{h}x{d}, KH={kh}, "
          f"{str(dtype)[6:]}, causal): {row['ms']:.5f} ms (a CUDA graph "
          f"of {BWD_GRAPH_CALLS} calls; eagerly {row['eager_ms']:.5f} ms, "
          f"the host {row['host_ms']:.5f} ms a call to enqueue), plain "
          f"{row['plain_ms']:.3f} ms, SDPA's backward "
          f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 5)}"
          f" ms, bound {row['bound_ms']:.5f} ms ({by})")
    return row


def bwd_split(rows):
    """Device ms a call of each of K5's backward kernels (by its name from
    ``attention_bwd_`` on) in profile rows (key, launches, ms), so the part
    that sets the pace shows."""
    parts = {}
    for key, count, ms in rows:
        name = re.search(r"attention_bwd_\w+", key)
        if name:
            parts[name.group()] = parts.get(name.group(), 0.0) + ms / count
    return dict(sorted(parts.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# the mesh phase: mesh-sharded serving, its ranks sharing the card
# ---------------------------------------------------------------------------
# one process a rank (launch/mesh.py); gloo, since NCCL refuses two ranks
# on one device: its collectives copy through pinned host buffers
MESH_BACKEND, MESH_DEVICE = "gloo", "cuda:0"
MESH_TIMEOUT = 600
MESH_QWEN = "qwen2_5_3b"
# qwen2.5-3b's depth on each mesh.  Mesh 2 (heads) is bitwise mesh 1 but
# for the head's f32 GEMM (8 of 8 requests identical at 36, 12 and 8
# layers).  Mesh 4's split-KV attention and K4 are each within about a
# bf16 rounding of the f32 attention (the witness below), but they round
# differently, and through the w8a8 layers the tokens part past the
# near-tie rule: a request first differed at a top-2 gap of 0.046 at 36
# layers and 0.028 at 8 (PERF.md §6).  gloo's ~2-7 ms a collective on one
# card sets the depths' cost
MESH_QWEN_LAYERS = {2: 8, 4: 2}
# the pages mesh's depth witness: qwen2.5-3b at all its layers on 4 ranks,
# 4 requests served for a few ticks, every layer's split-KV attention
# output held against the plain f32 reference (paged_decode_attention_ref)
# on the whole pools gathered from the ranks, the error over each output
# row's largest |value|; K4 on the same inputs is measured beside it.  The
# split path computes in f32 and rounds once to bf16 (half an ulp is 2^-8
# of a value): the limit, one ulp, leaves room for f32 sums in another
# order
PAGES_WITNESS_LAYERS = 36
PAGES_WITNESS_TICKS = 2
PAGES_WITNESS_REL = 2 ** -7
MISTRAL_ARCH = "mistral_large_123b"
# 12 of its 88 layers: 16.6 GB of int8 weights, where all 88 (121.8 GB)
# take two cards or more
MISTRAL_LAYERS = 12
MISTRAL_SEED = 7
MISTRAL_PROMPTS = (64, 128, 192, 256)
MISTRAL_STEPS = 16
# mesh 4's logits against mesh 1's, over the row's largest |logit|: every
# projection and every attention output is bitwise mesh 1's (checked), so
# only the head's f32 product differs (each rank's 8192 vocabulary
# columns against 32768 in one product: cuBLAS may sum the 12288 terms in
# another order)
MESH_LOGIT_REL = 1e-4
# decode steps timed with a synchronize around every collective
COLLECTIVE_STEPS = 8
# the new K1 / K2 modes at the mesh paths' shapes: decode and the serve's
# prefill rows over one rank's K slice of wo and down (K, N): mistral on
# 4 ranks, qwen2.5-3b on 2 and on 4
MESH_MODE_ROWS = (4, 256)
MESH_MODE_SHAPES = {"mistral wo": (3072, 12288), "mistral down": (7168, 12288),
                    "qwen2 wo": (1024, 2048), "qwen2 down": (5504, 2048),
                    "qwen4 wo": (512, 2048), "qwen4 down": (2752, 2048)}
MESH_KERNELS = {
    "row_absmax": ("src/repro_torch/csrc/quant_act.cu",
                   "src/repro/kernels/quant_act/kernel.py:20 (its absmax, "
                   "a row split over ranks: K1's absmax mode)"),
    "tiled_matmul_int32": ("src/repro_torch/csrc/int8_gemm.cu",
                           "src/repro/kernels/tiled_matmul/kernel.py:83 "
                           "(K2 without its epilogue: the int32-out mode)"),
    "int8_epilogue": ("src/repro_torch/csrc/int8_gemm.cu",
                      "src/repro/kernels/tiled_matmul/kernel.py:67 (K2's "
                      "epilogue alone)"),
}


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def mesh_configs(smoke, world=2):
    """(qwen2.5-3b at mesh ``world``'s depth, mistral-large-123b at
    MISTRAL_LAYERS), w8a8 bf16 at full width; their smoke configs for a
    rehearsal on the CPU."""
    from repro_torch.configs import get_config, get_smoke_config
    get = get_smoke_config if smoke else get_config
    qwen = get(MESH_QWEN).replace(quant_proj="w8a8", dtype="bfloat16")
    mistral = get(MISTRAL_ARCH).replace(quant_proj="w8a8", dtype="bfloat16")
    if not smoke:
        qwen = qwen.replace(n_layers=MESH_QWEN_LAYERS[world])
        mistral = mistral.replace(n_layers=MISTRAL_LAYERS)
    return qwen, mistral


def mesh_model(cfg, mesh, seed):
    """``cfg``'s model on ``mesh``'s device, this rank's shard of it: each
    whole layer drawn from one seeded generator on the device (the same
    numbers on every rank and as the unsharded phases draw), quantized in
    place, sliced, and the rest freed, so a rank never holds more than one
    f32 layer; the ranks draw in turn.  Returns (model, seconds: the
    ranks' turns included)."""
    from repro_torch.bridge import shard_model
    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models.transformer import init_model
    dev = mesh.device
    t0 = time.perf_counter()
    # one rank draws at a time (a psum is the barrier): drawing and
    # quantizing a mistral layer takes ~16 GB a rank, four at once more
    # than the card holds
    for turn in range(mesh.size):
        if turn == mesh.rank:
            gen = torch.Generator(device=dev).manual_seed(seed)
            model = init_model(gen, cfg, device=dev,
                               each_block=lambda b: shard_model(
                                   quantize_model_params(b, in_place=True),
                                   mesh))
            model = shard_model(model, mesh)
            sync(dev)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        mesh.psum(torch.zeros(1, device=dev))
    return model, time.perf_counter() - t0


def mesh_layer_launches(cfg, by) -> dict:
    """One layer's launches in one forward on a mesh (w8a8): wo and down
    row-parallel, each one K1 absmax launch, one K1 given-absmax launch
    (quant_act, or quant_act_glu in SwiGLU), one K2 int32-out and one K2
    epilogue in place of its K2; the column projections as unsharded; K4
    under ``heads``, none under ``pages`` (plain PyTorch, as the
    reference's combine)."""
    want = layer_launches(cfg, paged=by == "heads")
    want["tiled_matmul"] -= 2
    want.update(row_absmax=2, tiled_matmul_int32=2, int8_epilogue=2)
    return want


@contextlib.contextmanager
def timed_collectives(mesh, stats):
    """Within the block, every collective of ``mesh`` runs between two
    synchronizes and adds its host seconds to ``stats["s"]``."""
    names = ("psum", "pmax", "all_gather")
    saved = {n: getattr(mesh, n) for n in names}

    def timed(fn):
        def run(*args, **kwargs):
            sync(mesh.device)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(mesh.device)
            stats["s"] += time.perf_counter() - t
            stats["n"] += 1
            return out
        return run

    for n, fn in saved.items():
        setattr(mesh, n, timed(fn))
    try:
        yield
    finally:
        for n in names:
            delattr(mesh, n)


def collective_share(step, mesh, steps=COLLECTIVE_STEPS):
    """The share of ``steps`` calls of ``step`` (decode steps) spent in
    collectives, each collective between two synchronizes: (share, ms a
    step, collectives a step)."""
    stats = {"s": 0.0, "n": 0}
    sync(mesh.device)
    t = time.perf_counter()
    with timed_collectives(mesh, stats):
        for _ in range(steps):
            step()
    sync(mesh.device)
    total = time.perf_counter() - t
    return stats["s"] / total, total * 1e3 / steps, stats["n"] / steps


def slab_shapes(cache):
    return {k: list(v.shape) for k, v in cache.items()
            if k in ("k_pages", "v_pages", "k_scales", "v_scales",
                     "alloc_free")}


def mesh_sched_rank(mesh, smoke=False):
    """A rank of qwen2.5-3b's Scheduler trace (phase 4's: 4 slots, 40
    pages of 16, 8 requests, bf16 pools) on its shard: tokens, exact
    launch counts, time, peak memory, slab shapes; then the collective
    share of a few decode steps of 4 requests."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.scheduler import Scheduler
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, _ = mesh_configs(smoke, mesh.size)
    model, draw_s = mesh_model(cfg, mesh, 5)

    def scheduler():
        return Scheduler(model, cfg, slots=SCHED_SLOTS,
                         max_len=SCHED_MAX_LEN,
                         config=CacheConfig(layout="paged", alloc="dynamic",
                                            page_size=PAGE,
                                            pool_pages=SCHED_POOL,
                                            mesh=mesh),
                         share_prefix=True, bucket=SCHED_BUCKET,
                         eos_id=SCHED_EOS, dtype=torch.bfloat16, device=dev)

    trace = sched_trace(cfg.vocab_size)
    sched = scheduler()
    by = sched.config.resolved_kv_shard(cfg.n_kv_heads)
    with torch.inference_mode():
        reset_launch_counts()
        seconds, tick_ms, page_waits = drive(sched, trace)
        counts = launch_counts()
        n_tok = sum(len(v) for v in sched.finished.values())
        forwards = len(trace[0]) + decode_ticks(sched)
        want = {k: n * cfg.n_layers * forwards
                for k, n in mesh_layer_launches(cfg, by).items()}
        shapes = slab_shapes(sched.cache)
        per_shard_peak = [max(u[s] for u in sched.shard_occupancy_log)
                          for s in range(len(sched.shard_occupancy_log[0]))]
        # decode steps alone: 4 requests admitted at the first tick
        probe = scheduler()
        g = torch.Generator().manual_seed(23)
        for _ in range(SCHED_SLOTS):
            probe.submit(torch.randint(0, cfg.vocab_size, (32,),
                                       generator=g), 4 * COLLECTIVE_STEPS)
        probe.step()
        share, step_ms, n_coll = collective_share(probe.step, mesh)
    return {"rank": mesh.rank, "policy": by,
            "finished": {r: t.tolist() for r, t in sched.finished.items()},
            "counts": counts, "want": want, "seconds": seconds,
            "tok_s": n_tok / seconds, "ticks": sched._ticks,
            "ms_per_tick": sum(tick_ms) / len(tick_ms),
            "page_waits": page_waits, "draw_s": draw_s,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else 0.0),
            "shapes": shapes, "per_shard_peak": per_shard_peak,
            "collective_share": share, "decode_step_ms": step_ms,
            "collectives_a_step": n_coll}


def pages_witness_rank(mesh, smoke=False):
    """A rank of the pages mesh's depth witness (PAGES_WITNESS_LAYERS):
    4 requests admitted at the first tick, PAGES_WITNESS_TICKS ticks, and
    every call of ``_paged_attend_split`` held against the plain f32
    reference over the whole pools (gathered from the ranks), with K4 run
    on the same inputs: each layer's largest error over its output row's
    largest |value|, for the split path and for K4."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels.flash_attention.ops import (
        paged_decode_attention)
    from repro_torch.kernels.flash_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.scheduler import Scheduler
    dev = mesh.device
    cfg, _ = mesh_configs(smoke, mesh.size)
    if not smoke:
        cfg = cfg.replace(n_layers=PAGES_WITNESS_LAYERS)
    model, _ = mesh_model(cfg, mesh, 5)
    split = attention._paged_attend_split
    err = {"split": [0.0] * cfg.n_layers, "k4": [0.0] * cfg.n_layers}
    calls = [0]

    def rel(o, ref):
        den = ref.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        return float(((o.float() - ref).abs() / den).max())

    def checked(q, tok_pos, page_table, pools, c, *, scale, is_local,
                mesh):
        o = split(q, tok_pos, page_table, pools, c, scale=scale,
                  is_local=is_local, mesh=mesh)
        if len(pools) != 2:
            raise ValueError("the witness reads bf16 pools")
        # both pools in one collective, each whole and contiguous
        kw, vw = mesh.all_gather(torch.stack(pools), dim=1)
        s = q.shape[1]
        lengths = (tok_pos[:, -1] + 1).to(torch.int32)
        window = c.sliding_window if is_local else None
        ref = paged_decode_attention_ref(
            q.float(), kw.float(), vw.float(), page_table, lengths,
            scale=scale, window=window, softcap=c.attn_logit_softcap)
        k4 = paged_decode_attention(
            q.contiguous(), kw, vw, page_table, lengths, scale=scale,
            window=window, softcap=c.attn_logit_softcap,
            q_chunk=(None if s <= attention.PAGED_FLASH_MAX_Q
                     else attention.PAGED_PREFILL_CHUNK_Q),
            split_heads=c.n_kv_heads)
        layer = calls[0] % c.n_layers
        calls[0] += 1
        err["split"][layer] = max(err["split"][layer], rel(o, ref))
        err["k4"][layer] = max(err["k4"][layer], rel(k4, ref))
        return o

    attention._paged_attend_split = checked
    try:
        sched = Scheduler(model, cfg, slots=SCHED_SLOTS,
                          max_len=SCHED_MAX_LEN,
                          config=CacheConfig(layout="paged",
                                             alloc="dynamic",
                                             page_size=PAGE,
                                             pool_pages=SCHED_POOL,
                                             mesh=mesh),
                          bucket=SCHED_BUCKET, eos_id=SCHED_EOS,
                          dtype=torch.bfloat16, device=dev)
        g = torch.Generator().manual_seed(23)
        for _ in range(SCHED_SLOTS):
            sched.submit(torch.randint(0, cfg.vocab_size, (32,),
                                       generator=g),
                         4 * PAGES_WITNESS_TICKS)
        t = time.perf_counter()
        for _ in range(PAGES_WITNESS_TICKS):
            sched.step()
        sync(dev)
    finally:
        attention._paged_attend_split = split
    return {"rank": mesh.rank, "policy": sched.cache["kv_shard"],
            "layers": cfg.n_layers, "calls": calls[0],
            "seconds": time.perf_counter() - t, **err}


def mistral_prompts(cfg, dev):
    """4 prompts of 64-256 tokens, right-padded: (prompts, lengths)."""
    g = torch.Generator().manual_seed(31)
    lens = torch.tensor(MISTRAL_PROMPTS if cfg.vocab_size > 1000
                        else [8, 12, 5, 16])
    prompts = torch.randint(0, cfg.vocab_size, (len(lens), int(lens.max())),
                            generator=g)
    return prompts.to(dev), lens.to(dev)


def layer0_projections(model, cfg, mesh):
    """Layer 0's seven projections on seeded inputs at decode and prefill
    rows, whole: q, k, v, gate and up gathered over the mesh, wo and down
    after their reduction (a rank's wo takes its columns of the whole
    attention output)."""
    from repro_torch.core.qkv_fusion import apply_fused_qkv
    from repro_torch.core.quantized_linear import (apply_linear_swiglu,
                                                   apply_linears)
    from repro_torch.models.attention import _project_out
    attn, ffn = model.layers[0].attn, model.layers[0].ffn
    dev = mesh.device

    def whole(t, lin):
        return mesh.all_gather(t, dim=-1) if lin.shard == "column" else t

    out = {}
    for m in MESH_MODE_ROWS:
        x = device_randn((m, cfg.d_model), 40 + m, dev, 1.0, torch.bfloat16)
        o_in = device_randn((m, cfg.q_dim), 41 + m, dev, 1.0, torch.bfloat16)
        q, k, v = apply_fused_qkv(attn.wq, attn.wk, attn.wv, x, mode="w8a8")
        gate, up = apply_linears((ffn.gate, ffn.up), x, mode="w8a8")
        got = {"q": whole(q, attn.wq), "k": whole(k, attn.wk),
               "v": whole(v, attn.wv),
               "wo": _project_out(attn, o_in, cfg, whole=True),
               "gate": whole(gate, ffn.gate), "up": whole(up, ffn.up),
               "down": apply_linear_swiglu(ffn.down, gate, up, mode="w8a8")}
        out.update({f"{name} ({m} rows)": t.cpu() for name, t in got.items()})
    return out


def mistral_rank(mesh, smoke=False):
    """A rank of mistral-large-123b's greedy serve: layer 0's projections,
    then ``prefill`` of the 4 prompts into paged bf16 pools and
    MISTRAL_STEPS ``serve_step``s, logits kept, exact launch counts, times,
    peak memory and slab shapes; then the collective share of more decode
    steps.  Rank 0 (or mesh 1) returns the logits and projections."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.cache import CacheConfig, init_cache
    from repro_torch.serving.engine import prefill, serve_step
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _, cfg = mesh_configs(smoke)
    model, draw_s = mesh_model(cfg, mesh, MISTRAL_SEED)
    prompts, lens = mistral_prompts(cfg, dev)
    max_len = prompts.shape[1] + MISTRAL_STEPS + COLLECTIVE_STEPS + PAGE
    config = CacheConfig(layout="paged", page_size=PAGE, mesh=mesh)
    by = config.resolved_kv_shard(cfg.n_kv_heads)
    with torch.inference_mode():
        proj = layer0_projections(model, cfg, mesh)
        cache = init_cache(cfg, len(lens), max_len, torch.bfloat16, config,
                           device=dev)
        reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        next_logits, cache = prefill(model, cache, prompts, lens, cfg)
        sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = next_logits.argmax(-1)[:, None]
        toks, logits = [tok], [next_logits.float()]
        t0 = time.perf_counter()
        for _ in range(MISTRAL_STEPS):
            step_logits, cache = serve_step(model, cache, tok, None, cfg)
            tok = step_logits[:, -1].argmax(-1)[:, None]
            toks.append(tok)
            logits.append(step_logits[:, -1].float())
        sync(dev)
        t_decode = time.perf_counter() - t0
        counts = launch_counts()
        want = {k: n * cfg.n_layers * (1 + MISTRAL_STEPS)
                for k, n in mesh_layer_launches(cfg, by).items()}
        state = {"tok": tok}

        def step():
            lg, _ = serve_step(model, cache, state["tok"], None, cfg)
            state["tok"] = lg[:, -1].argmax(-1)[:, None]

        share, step_ms, n_coll = collective_share(step, mesh)
    out = {"rank": mesh.rank, "policy": by, "counts": counts, "want": want,
           "tokens": torch.cat(toks, dim=1).cpu(),
           "prefill_s": t_prefill,
           "tok_s": len(lens) * MISTRAL_STEPS / t_decode,
           "draw_s": draw_s,
           "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                       if dev.type == "cuda" else 0.0),
           "shapes": slab_shapes(cache), "collective_share": share,
           "decode_step_ms": step_ms, "collectives_a_step": n_coll,
           "resident_gb": resident_gb(model)}
    if mesh.rank == 0:
        out.update(logits=torch.stack(logits).cpu(), projections=proj)
    return out


def check_mesh_modes(dev):
    """K1's absmax and given-absmax modes and K2's int32-out and epilogue
    modes at ``MESH_MODE_SHAPES``, each launch bitwise its plain version,
    and the whole-row identities the row-parallel projections rest on: a
    row's slices quantized with their maximum absmax are the whole row's
    K1 (and its SwiGLU mode's), and the slices' int32 products summed,
    then the epilogue, are the whole K2.  Returns the worst max |err|
    (0: bitwise)."""
    from repro_torch.core.quantization import QTensor
    from repro_torch.kernels.quant_act.ops import (quant_act, quant_act_glu,
                                                   row_absmax)
    from repro_torch.kernels.quant_act.ref import (quant_act_glu_ref,
                                                   quant_act_ref,
                                                   row_absmax_glu_ref,
                                                   row_absmax_ref)
    from repro_torch.kernels.tiled_matmul.ops import (int8_epilogue,
                                                      tiled_matmul,
                                                      tiled_matmul_int32)
    from repro_torch.kernels.tiled_matmul.ref import (int8_epilogue_ref,
                                                      int_matmul_exact)
    errs = {"row_absmax": 0.0, "tiled_matmul_int32": 0.0,
            "int8_epilogue": 0.0}
    seed = 60
    for name, (k, n) in MESH_MODE_SHAPES.items():
        ranks = 4 if name.startswith(("mistral", "qwen4")) else 2
        for m in MESH_MODE_ROWS:
            seed += 10
            what = f"{name} ({m}, {k}) x {ranks} ranks"
            glu = "down" in name
            x = [device_randn((m, k), seed + r, dev, 3.0, torch.bfloat16)
                 for r in range(ranks)]
            up = [device_randn((m, k), seed + 5 + r, dev, 1.0,
                               torch.bfloat16) for r in range(ranks)]
            maxes = []
            for r in range(ranks):
                got = row_absmax(x[r], up[r] if glu else None)
                want = (row_absmax_glu_ref(x[r], up[r]) if glu
                        else row_absmax_ref(x[r]))
                errs["row_absmax"] = max(errs["row_absmax"], max_err(
                    got, want, f"row_absmax {what}"))
                maxes.append(got)
            absmax = torch.stack(maxes).amax(0)
            whole_x = torch.cat(x, dim=1)
            whole = (quant_act_glu(whole_x, torch.cat(up, dim=1)) if glu
                     else quant_act(whole_x))
            parts = []
            for r in range(ranks):
                got = (quant_act_glu(x[r], up[r], absmax=absmax) if glu
                       else quant_act(x[r], absmax=absmax))
                want = (quant_act_glu_ref(x[r], up[r], absmax=absmax) if glu
                        else quant_act_ref(x[r], absmax=absmax))
                max_err(got.values, want[0], f"given absmax {what}")
                max_err(got.scale, want[1], f"given absmax scale {what}")
                max_err(got.values, whole.values[:, r * k:(r + 1) * k],
                        f"given absmax vs the whole row {what}")
                max_err(got.scale, whole.scale, f"scale vs whole {what}")
                parts.append(got)
            _, ws = quantized_operands(1, k * ranks, [n], dev, seed + 9,
                                       draw=device_randn)
            w = ws[0]
            bias = device_randn((n,), seed + 8, dev)
            acc = None
            for r in range(ranks):
                wr = QTensor(w.values[r * k:(r + 1) * k].t().contiguous().t(),
                             w.scale, 8)
                got = tiled_matmul_int32(parts[r], wr)
                errs["tiled_matmul_int32"] = max(
                    errs["tiled_matmul_int32"],
                    max_err(got, int_matmul_exact(parts[r].values, wr.values),
                            f"tiled_matmul_int32 {what}"))
                acc = got if acc is None else acc + got
            got = int8_epilogue(acc, whole.scale, w, bias)
            errs["int8_epilogue"] = max(errs["int8_epilogue"], max_err(
                got, int8_epilogue_ref(acc, whole.scale, w.scale, bias,
                                       torch.bfloat16),
                f"int8_epilogue {what}"))
            max_err(got, tiled_matmul(whole, w, bias),
                    f"row-parallel sum vs the whole K2 {what}")
    print(f"mesh modes: K1's absmax and given-absmax modes and K2's "
          f"int32-out and epilogue modes bitwise their plain versions at "
          f"{len(MESH_MODE_SHAPES) * len(MESH_MODE_ROWS)} shapes "
          f"({', '.join(MESH_MODE_SHAPES)} at {MESH_MODE_ROWS} rows); "
          "slices with their maximum absmax bitwise the whole row's K1, "
          "int32 partials summed then the epilogue bitwise the whole K2")
    return errs


def time_mesh_modes(dev, m, k, n, glu):
    """The new modes at one rank's slice (m, k) of a row-parallel projection
    onto n outputs (``glu``: down's, of the SwiGLU product): K1's absmax
    and given-absmax modes, K2's int32-out and epilogue modes; each its
    ms, its plain version's, its bound and a library call's where one
    computes the same."""
    from repro_torch.kernels.quant_act.ops import (quant_act, quant_act_glu,
                                                   row_absmax)
    from repro_torch.kernels.quant_act.ref import (quant_act_glu_ref,
                                                   quant_act_ref,
                                                   row_absmax_glu_ref,
                                                   row_absmax_ref)
    from repro_torch.kernels.tiled_matmul.ops import (int8_epilogue,
                                                      tiled_matmul_int32)
    from repro_torch.kernels.tiled_matmul.ref import (int8_epilogue_ref,
                                                      int_matmul_exact)
    rows = {}
    ins = 2 if glu else 1
    xs = [tuple(device_randn((m, k), 3 * i + j, dev, 1.0, torch.bfloat16)
                for j in range(ins)) for i in range(n_copies(2 * ins * m * k))]
    b_ms, by = bound(2 * ins * m * k + 4 * m, (6 if glu else 1) * m * k,
                     F32_OPS_PER_S)
    lib = None if glu else device_ms(
        lambda x: torch.linalg.vector_norm(x, float("inf"), dim=1,
                                           keepdim=True), xs)
    rows["row_absmax"] = {
        "ms": device_ms(row_absmax, xs),
        "plain_ms": device_ms(row_absmax_glu_ref if glu else row_absmax_ref,
                              xs),
        "bound_ms": b_ms, "bound_by": by, "library_ms": lib}
    given = [x + (torch.rand((m, 1), device=dev) * 4 + 1,) for x in xs]
    q_fn = quant_act_glu if glu else quant_act
    q_ref = quant_act_glu_ref if glu else quant_act_ref
    b_ms, by = bound(2 * ins * m * k + 8 * m + m * k,
                     (7 if glu else 3) * m * k, F32_OPS_PER_S)
    rows["given_absmax"] = {
        "ms": device_ms(lambda *a: q_fn(*a[:-1], absmax=a[-1]), given),
        "plain_ms": device_ms(lambda *a: q_ref(*a[:-1], absmax=a[-1]), given),
        "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    nbytes = m * k + k * n + 4 * m * n
    ops = [quantized_operands(m, k, [n], dev, seed=i, draw=device_randn)
           for i in range(n_copies(nbytes))]
    sets = [(a, b) for a, (b,) in ops]
    b_ms, by = bound(nbytes, 2 * m * n * k, INT8_OPS_PER_S)
    mp = max(m, INT_MM_MIN_M)
    rows["tiled_matmul_int32"] = {
        "ms": device_ms(tiled_matmul_int32, sets),
        # f64 products of GBs a call: eagerly, not in a graph of many
        "plain_ms": eager_ms(lambda a, b: int_matmul_exact(a.values,
                                                           b.values), sets),
        "bound_ms": b_ms, "bound_by": by,
        "library_ms": device_ms(
            int_mm_alone, [(pad_rows(a.values, mp), a.scale, b.values,
                            b.scale) for a, b in sets]),
        "library": "torch._int_mm" + (f", A padded to M={mp}"
                                      if mp != m else "")}
    accs = [(torch.randint(-2 ** 20, 2 ** 20, (m, n), dtype=torch.int32,
                           device=dev), a.scale, b) for a, b in sets]
    bias = device_randn((n,), 3, dev)
    b_ms, by = bound(4 * m * n + 4 * m + 8 * n + 2 * m * n, 3 * m * n,
                     F32_OPS_PER_S)
    rows["int8_epilogue"] = {
        "ms": device_ms(lambda acc, sa, b: int8_epilogue(acc, sa, b, bias),
                        accs),
        "plain_ms": device_ms(lambda acc, sa, b: int8_epilogue_ref(
            acc, sa, b.scale, bias, torch.bfloat16), accs),
        "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    return rows


def mesh_layer_rows(rows, m):
    """One mistral rank's layer at m rows (wo, then down): each mode's
    numbers summed over its two launches (a library time only where both
    have one)."""
    out = {}
    for mode in ("row_absmax", "given_absmax", "tiled_matmul_int32",
                 "int8_epilogue"):
        parts = [rows[f"mistral {p} {m}"][mode] for p in ("wo", "down")]
        out[mode] = {key: sum(p[key] for p in parts)
                     for key in ("ms", "plain_ms", "bound_ms")}
        libs = [p["library_ms"] for p in parts]
        out[mode]["library_ms"] = (None if None in libs else sum(libs))
        out[mode]["bound_by"] = parts[1]["bound_by"]
    return out


def unsharded_sched_ref(cfg, dev):
    """qwen2.5-3b's Scheduler trace at ``cfg``'s depth, unsharded, in this
    process (the weights the ranks draw): (finished, the top-2 logit gaps
    and tokens of every emitted token) for the near-tie rule, and its
    seconds."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.scheduler import Scheduler
    model, _ = mesh_model(cfg, Mesh(1, backend=MESH_BACKEND, device=dev), 5)
    sched = Scheduler(model, cfg, slots=SCHED_SLOTS, max_len=SCHED_MAX_LEN,
                      config=CacheConfig(layout="paged", alloc="dynamic",
                                         page_size=PAGE,
                                         pool_pages=SCHED_POOL),
                      share_prefix=True, bucket=SCHED_BUCKET,
                      eos_id=SCHED_EOS, dtype=torch.bfloat16, device=dev)
    gaps, top2 = {}, {}
    with recorded_gaps(sched, gaps, top2):
        seconds, _, _ = drive(sched, sched_trace(cfg.vocab_size))
    n_tok = sum(len(v) for v in sched.finished.values())
    return (sched.finished, gaps, top2), n_tok / seconds


def mesh_paths(dev, smi, smoke=False):
    """The mesh phase: the new K1 / K2 modes checked and timed in this
    process; then qwen2.5-3b's Scheduler trace on meshes 2 (heads) and 4
    (pages), each at its MESH_QWEN_LAYERS depth, unsharded here first,
    their tokens held against the unsharded run's by the near-tie rule;
    the pages mesh's depth witness (``pages_witness_rank``); then
    mistral-large-123b at full width, MISTRAL_LAYERS layers: mesh 1
    here, mesh 4 in four ranks, every projection of layer 0 bitwise, the
    tokens by the near-tie rule, the logits within MESH_LOGIT_REL.  Each
    rank's counts are exact and every rank emits the same tokens."""
    from repro_torch.launch.mesh import Mesh, spawn_ranks
    res = {"errs": check_mesh_modes(dev), "rows": {}}
    for name in ("mistral wo", "mistral down"):
        k, n = MESH_MODE_SHAPES[name]
        for m in MESH_MODE_ROWS:
            res["rows"][f"{name} {m}"] = time_mesh_modes(
                dev, m, k, n, glu=name.endswith("down"))
    for m in MESH_MODE_ROWS:
        for mode, r in mesh_layer_rows(res["rows"], m).items():
            lib = ("-" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            print(f"  mesh mode {mode:18s} mistral rank layer, {m:3d} rows: "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}), library {lib} "
                  f"[{smi}]")
    _, mistral_cfg = mesh_configs(smoke)
    res["qwen"] = {}
    for world in (2, 4):
        qwen_cfg, _ = mesh_configs(smoke, world)
        stamp(f"mesh phase: {qwen_cfg.name} unsharded, {qwen_cfg.n_layers} "
              "layers")
        qwen_ref, ref_tok_s = unsharded_sched_ref(qwen_cfg, dev)
        print(f"{qwen_cfg.name} Scheduler unsharded, {qwen_cfg.n_layers} "
              f"layers: {ref_tok_s:.1f} tok/s (host clock) [{smi}]")
        torch.cuda.empty_cache()
        stamp(f"mesh phase: {qwen_cfg.name} on {world} ranks")
        runs = spawn_ranks(mesh_sched_rank, world, backend=MESH_BACKEND,
                           device=MESH_DEVICE, args=(smoke,),
                           timeout=MESH_TIMEOUT)
        r0 = runs[0]
        what = (f"mesh {world} ({r0['policy']}) {qwen_cfg.name} Scheduler, "
                f"{qwen_cfg.n_layers} layers")
        for r in runs:
            if r["counts"] != r["want"]:
                fail(f"{what}: rank {r['rank']} launches {r['counts']} != "
                     f"{r['want']}")
            if r["finished"] != r0["finished"]:
                fail(f"{what}: rank {r['rank']}'s tokens differ from rank "
                     "0's")
        print(f"{what}: launches a rank {r0['counts']} (exact on every "
              "rank)")
        other = {rid: torch.tensor(t) for rid, t in r0["finished"].items()}
        share = near_tie_rule(f"{what} against the unsharded run",
                              qwen_ref[0], other, qwen_ref[1], qwen_ref[2],
                              NEAR_TIE)
        for r in runs:
            print(f"  rank {r['rank']}: peak {r['peak_gb']:.2f} GB "
                  f"(torch.cuda.max_memory_allocated), slabs {r['shapes']}, "
                  f"drawn in {r['draw_s']:.1f} s")
        print(f"  {r0['ticks']} ticks, {r0['tok_s']:.1f} tok/s, "
              f"{r0['ms_per_tick']:.3f} ms per tick (host clock, rank 0), "
              f"page waits {r0['page_waits']} ticks, per-shard pages peak "
              f"{r0['per_shard_peak']}; decode step {r0['decode_step_ms']:.3f}"
              f" ms with a synchronize around each of its "
              f"{r0['collectives_a_step']:.0f} collectives, "
              f"{r0['collective_share']:.3f} of it in them (gloo through "
              f"host buffers, {world} ranks on one card: an artefact of "
              f"host staging) [{smi}]")
        res["qwen"][world] = dict(r0, identical_share=share,
                                  layers=qwen_cfg.n_layers,
                                  unsharded_tok_s=ref_tok_s)
    stamp("mesh phase: the pages mesh's depth witness on 4 ranks")
    runs = spawn_ranks(pages_witness_rank, 4, backend=MESH_BACKEND,
                       device=MESH_DEVICE, args=(smoke,),
                       timeout=MESH_TIMEOUT)
    w0 = runs[0]
    what = (f"mesh 4 ({w0['policy']}) qwen2.5-3b, {w0['layers']} layers: "
            "split-KV attention against the plain f32 reference on the "
            "gathered pools")
    for r in runs:
        if r["policy"] != "pages" or r["calls"] != w0["calls"]:
            fail(f"{what}: rank {r['rank']} policy {r['policy']}, "
                 f"{r['calls']} calls (rank 0: {w0['calls']})")
        worst = max(r["split"])
        if worst > PAGES_WITNESS_REL:
            fail(f"{what}: rank {r['rank']} layer "
                 f"{r['split'].index(worst)} at {worst:.3e} of its row's "
                 f"largest |value| (limit {PAGES_WITNESS_REL:.3e})")
    res["witness"] = {k: w0[k] for k in ("layers", "calls", "seconds",
                                          "split", "k4")}
    print(f"{what}: {w0['calls']} calls over {PAGES_WITNESS_TICKS} ticks "
          f"in {w0['seconds']:.1f} s; worst split-KV {max(w0['split']):.3e}"
          f" of its row's largest |value| (layer "
          f"{w0['split'].index(max(w0['split']))}; limit "
          f"{PAGES_WITNESS_REL:.3e}), K4 on the same inputs "
          f"{max(w0['k4']):.3e} (layer {w0['k4'].index(max(w0['k4']))})")
    print("  by layer, split-KV: "
          + " ".join(f"{e:.2e}" for e in w0["split"]))
    print("  by layer, K4:       "
          + " ".join(f"{e:.2e}" for e in w0["k4"]))
    stamp(f"mesh phase: {mistral_cfg.name} on 1 rank (here)")
    one = mistral_rank(Mesh(1, backend=MESH_BACKEND, device=dev), smoke)
    print(f"mesh 1 {mistral_cfg.name}: {describe(mistral_cfg)}; resident "
          f"{one['resident_gb']:.2f} GB, peak {one['peak_gb']:.2f} GB, drawn "
          f"in {one['draw_s']:.1f} s")
    torch.cuda.empty_cache()
    stamp(f"mesh phase: {mistral_cfg.name} on 4 ranks")
    runs = spawn_ranks(mistral_rank, 4, backend=MESH_BACKEND,
                       device=MESH_DEVICE, args=(smoke,),
                       timeout=MESH_TIMEOUT)
    r0 = runs[0]
    what = (f"mesh 4 ({r0['policy']}) {mistral_cfg.name}, "
            f"{mistral_cfg.n_layers} layers")
    for r in runs:
        if r["counts"] != r["want"]:
            fail(f"{what}: rank {r['rank']} launches {r['counts']} != "
                 f"{r['want']}")
        if not torch.equal(r["tokens"], r0["tokens"]):
            fail(f"{what}: rank {r['rank']}'s tokens differ from rank 0's")
    if one["counts"] != {k: n for k, n in expected_mistral_one(
            mistral_cfg).items()}:
        fail(f"mesh 1 {mistral_cfg.name}: launches {one['counts']}")
    for name, want in one["projections"].items():
        got = r0["projections"][name]
        if not torch.equal(got, want):
            fail(f"{what}: {name} differs from mesh 1's (max |err| "
                 f"{(got.double() - want.double()).abs().max():.3e})")
    print(f"{what}: launches a rank {r0['counts']} (exact on every rank); "
          f"layer 0's {len(one['projections'])} projection outputs (q, k, v, "
          f"gate, up gathered; wo, down reduced; at {MESH_MODE_ROWS} rows) "
          "bitwise mesh 1's")
    ref_toks, got_toks = one["tokens"], r0["tokens"]
    gaps, top2, worst = {}, {}, 0.0
    for step in range(got_toks.shape[1]):
        lg = one["logits"][step]
        vals, idx = lg.topk(2, dim=-1)
        rel = (vals[:, 0] - vals[:, 1]) / lg.abs().amax(-1)
        for b in range(lg.shape[0]):
            gaps[(b, step)], top2[(b, step)] = float(rel[b]), idx[b].tolist()
    first = [first_divergence(ref_toks[b].tolist(), got_toks[b].tolist())
             for b in range(ref_toks.shape[0])]
    # the logits at the first differing token still share their inputs
    live = min(min(f if f is not None else got_toks.shape[1] for f in first)
               + 1, got_toks.shape[1])
    for step in range(live):
        diff = (r0["logits"][step] - one["logits"][step]).abs().amax(-1)
        rel = float((diff / one["logits"][step].abs().amax(-1)).max())
        worst = max(worst, rel)
    if worst > MESH_LOGIT_REL:
        fail(f"{what}: logits differ from mesh 1's by {worst:.3e} of the "
             f"largest |logit| (limit {MESH_LOGIT_REL})")
    share = near_tie_rule(
        f"{what} against mesh 1",
        {b: ref_toks[b] for b in range(ref_toks.shape[0])},
        {b: got_toks[b] for b in range(got_toks.shape[0])}, gaps, top2,
        NEAR_TIE)
    print(f"  logits (prefill and the {live - 1} decode steps whose inputs "
          f"agree) within {worst:.3e} of the largest |logit| (limit "
          f"{MESH_LOGIT_REL})")
    for r in runs:
        print(f"  rank {r['rank']}: resident {r['resident_gb']:.2f} GB, peak "
              f"{r['peak_gb']:.2f} GB (torch.cuda.max_memory_allocated: one "
              f"f32 layer drawn at a time), slabs {r['shapes']}, drawn in "
              f"{r['draw_s']:.1f} s")
    print(f"  prefill of {list(MISTRAL_PROMPTS)} tokens: mesh 1 "
          f"{one['prefill_s'] * 1e3:.3f} ms, mesh 4 "
          f"{r0['prefill_s'] * 1e3:.3f} ms; decode: mesh 1 "
          f"{one['tok_s']:.1f} tok/s, mesh 4 {r0['tok_s']:.1f} tok/s (host "
          f"clock); mesh 4's decode step {r0['decode_step_ms']:.3f} ms with "
          f"a synchronize around each of its {r0['collectives_a_step']:.0f} "
          f"collectives, {r0['collective_share']:.3f} of it in them (gloo "
          "through host buffers, 4 ranks on one card: an artefact of host "
          f"staging) [{smi}]")
    res["mistral"] = {"one": {k: v for k, v in one.items()
                              if k not in ("logits", "projections")},
                      "four": {k: v for k, v in r0.items()
                               if k not in ("logits", "projections")},
                      "logit_rel": worst, "identical_share": share}
    return res


def expected_mistral_one(cfg):
    """Mesh 1's launches in the mistral serve: the unsharded layer's."""
    return {k: n * cfg.n_layers * (1 + MISTRAL_STEPS)
            for k, n in layer_launches(cfg, paged=True).items()}


T_START = time.perf_counter()


def stamp(what):
    """The script's time so far, at the start of ``what``."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {what}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.quantize_params import quantize_model_params
    from repro_torch.models.transformer import init_model

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = device_info()
    # the dispatcher reads the shipped table and, under it, a table of the
    # script's own that holds nothing: no user table outside the checkout
    from repro_torch.core import dispatch
    scratch_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_tune_")
    scratch = scratch_dir.name
    os.environ[dispatch.CACHE_ENV] = os.path.join(scratch, "none.json")
    dispatch.reset_cache_state()
    stamp("build")
    build_kernels()
    stamp("phase 3: kernels against their plain versions")

    print("kernels vs plain versions (K1-K3 bitwise, K4 and K5 within "
          "limits):")
    errs = check_kernels(dev)
    errs["paged_decode"], paged_rel_bf16 = check_paged(dev)
    errs["paged_decode_verify"], verify_rel_bf16 = check_verify(dev)
    split_abs, split_rel = check_paged_splits(dev)
    errs["paged_decode"] = max(errs["paged_decode"], split_abs)
    paged_rel_bf16 = max(paged_rel_bf16, split_rel)
    errs["flash_attention"], flash_rel_bf16 = check_flash(dev)
    stamp("phase 3: K5's backward against its plain version")
    errs["flash_attention_backward"], bwd_rel_bf16 = check_flash_bwd(dev)

    cfg = get_config("distilbert_paper")
    print(f"main path: {cfg.name} {cfg.quant_proj} {cfg.dtype}, "
          f"{cfg.n_layers} layers, d={cfg.d_model}, d_ff={cfg.d_ff}, "
          f"vocab={cfg.vocab_size}")
    master = init_model(torch.Generator().manual_seed(0),
                        cfg.replace(quant_proj="none"), device="cpu")
    model_cpu = quantize_model_params(master)
    model = copy.deepcopy(model_cpu).to(dev)
    with torch.inference_mode():
        stamp("phase 4: distilbert serves")
        counts, t_prefill, tps, toks, cache = main_path(model, cfg, dev)
        paged_counts, paged_prefill, paged_tps = paged_paths(
            model, cfg, dev, toks, cache)
        del cache
        stamp("phase 4: plan selection (core/dispatch.py)")
        plan_selection(dev, scratch)
        served_plan_modes(model, cfg, dev)
        stamp("phase 4: the example twins")
        twins_on_card(scratch)
        stamp("phase 4: the SwiGLU detector")
        check_swiglu_detector(dev)
        stamp("phase 4: prefill_step")
        qwen, gemma = long_prompt_paths(dev)
        stamp("phase 4: the Scheduler")
        sched_runs = scheduler_paths(dev)
        stamp("phase 4: the MoE path")
        moe = moe_paths(dev)
        stamp("phase 4: the SSM and hybrid path")
        ssm_res = ssm_paths(dev)
        stamp("phase 4: the encoder-decoder path")
        encdec = encdec_paths(dev)
        stamp("phase 4: the vision path")
        vlm = vlm_paths(dev)
        stamp("phase 5: card vs CPU")
        card_vs_cpu(model_cpu, master, cfg, dev)
        card_vs_cpu_long(dev)
        stamp("phase 5: the Scheduler, card vs CPU")
        sched_check = card_vs_cpu_scheduler(dev)
        stamp("phase 5: the MoE family, card vs CPU")
        moe_check = card_vs_cpu_moe(dev)
        stamp("phase 5: the hybrid family, card vs CPU")
        ssm_check = card_vs_cpu_ssm(dev)
        stamp("phase 5: the encoder-decoder family, card vs CPU")
        encdec_check = card_vs_cpu_encdec(dev)
    counts["paged_decode"] = paged_counts["paged_decode"]
    torch.cuda.empty_cache()
    stamp("phase 4: the training path")
    train = training_path(dev)
    stamp("phase 4: run_with_restarts")
    restart = restart_path(dev)
    stamp("phase 5: the training step, card vs CPU")
    train_check = card_vs_cpu_train(dev)
    stamp("mesh phase: mesh-sharded serving")
    torch.cuda.empty_cache()
    with torch.inference_mode():
        mesh = mesh_paths(dev, smi)
    stamp("phase 6: timings")
    bwd_row = time_flash_bwd(dev)
    shapes = timings(cfg, dev)
    alu = glu_alu_check(dev)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        pre = per_layer(shapes[name], "prefill")
        dec = per_layer(shapes[name], "decode")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": errs[name], "ms": pre["ms"],
            "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
            "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
            "work": WORK.get(name, "one prefill layer, M=256 (sum over "
                             "its launches)"),
            "decode": {k: dec[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "library_ms", "library_note")
                       if k in dec},
        })
        for prefix, (key, phases) in PATH_ROWS.items():
            if f"{prefix} {name}" in shapes:
                kernels[-1][key] = path_rows(shapes[f"{prefix} {name}"],
                                             phases)
    for k in kernels:
        if k["name"] in ("tiled_matmul", "fused_qkv"):
            k["plan_selection"] = {
                "tuned": [r for r in PLAN_SELECTION["tuned"]
                          if ("|" in r["shape"]) == (k["name"] == "fused_qkv")],
                "distilbert_launches_by_plan": {
                    mode: {p: n for p, n in by.items()
                           if p.startswith(k["name"])}
                    for mode, by in PLAN_SELECTION[
                        "distilbert_launches_by_plan"].items()}}
    k1 = kernels[0]
    k1["gemma2"] = {phase: {k: r[k] for k in (
        "ms", "plan", "plans", "plain_ms", "bound_ms", "bound_by",
        "library_ms")} for phase, _, _, r in shapes["gemma2 quant_act"]}
    k1["launches_by_plan"] = served_plans("quant_act")[
        "distilbert dense serve"]["by_plan"]
    k1["launches_by_path"] = served_plans("quant_act")
    kernels[-1]["max_row_rel_err_bf16"] = paged_rel_bf16
    pd = {phase: r for phase, _, _, r in shapes["paged_decode"]}
    kernels[-1]["scheduler_decode"] = {
        k: pd["sched-decode"][k]
        for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    fa = {phase: r for phase, _, _, r in shapes["flash_attention"]}
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_KERNEL[0],
        "replaces": FLASH_KERNEL[1],
        "launches": qwen[0]["flash_attention"],
        "max_abs_err": errs["flash_attention"], "ms": fa["prefill"]["ms"],
        "plain_ms": fa["prefill"]["plain_ms"],
        "bound_ms": fa["prefill"]["bound_ms"],
        "bound_by": fa["prefill"]["bound_by"],
        "library_ms": fa["prefill"]["library_ms"],
        "work": f"one qwen2.5-3b layer of prefill_step: (1, {LONG_PROMPT}, "
                "16/2, 128) bf16, causal",
        "max_row_rel_err_bf16": flash_rel_bf16,
        "launches_gemma2": gemma[0]["flash_attention"],
        "gemma2": {phase: {k: fa[phase][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for phase in ("local", "global")},
        "f32": {k: fa["prefill-f32"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "zamba2": {"work": f"one zamba2-7b shared site of prefill_step: (1, "
                           f"{LONG_PROMPT}, 32/32, 112) bf16, causal",
                   **{k: fa["zamba2"][k] for k in (
                       "ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")}},
        "seamless_m4t_medium": {
            "work": f"one seamless-m4t-medium encoder layer of the serve: "
                    f"(4, {ENC_FRAMES}, 16/16, 64) bf16, non-causal",
            **{k: fa["seamless"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        "phi3_vision_4_2b": {
            "work": f"one phi-3-vision layer of prefill_step: (1, "
                    f"{LONG_PROMPT}, 32/32, 96) bf16, causal",
            **{k: fa["phi3"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
    })
    kernels[-1]["launches_training"] = train["counts"]["flash_attention"]
    kernels.append({
        "name": "flash_attention_backward", "route": "cuda",
        "source": FLASH_BWD_KERNEL[0], "replaces": FLASH_BWD_KERNEL[1],
        "launches": train["counts"]["flash_attention_backward"],
        "max_abs_err": errs["flash_attention_backward"],
        **{k: bwd_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
        "library": "autograd of one scaled_dot_product_attention call",
        "work": f"one qwen2.5-3b layer of a train step: (1, {TRAIN_SEQ}, "
                "16/2, 128) bf16, causal: the delta, dK dV, dK dV sum and "
                "dQ kernels (parts_ms: each one's device ms a call in the "
                "profiled train step)",
        "parts_ms": train["bwd_split"],
        "max_row_rel_err_bf16": bwd_rel_bf16,
    })
    ver = {phase: r for phase, _, _, r in shapes["paged_decode_verify"]}
    kernels.append({
        "name": "paged_decode_verify", "route": "cuda",
        "source": VERIFY_KERNEL[0], "replaces": VERIFY_KERNEL[1],
        "launches": sum(r["k4_verify"] for r in sched_runs.values()),
        "max_abs_err": errs["paged_decode_verify"],
        "ms": ver["verify"]["ms"], "plain_ms": ver["verify"]["plain_ms"],
        "bound_ms": ver["verify"]["bound_ms"],
        "bound_by": ver["verify"]["bound_by"],
        "library_ms": ver["verify"]["library_ms"],
        "work": f"one verify launch of a qwen2.5-3b spec tick: 4 x "
                f"{VERIFY_Q} rows, H16/KH2, D128, bf16 pages, lengths "
                f"{VERIFY_LENS}",
        "max_row_rel_err_bf16": verify_rel_bf16,
        "int8": {k: ver["verify-int8"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "launches_per_run": {k: r["k4_verify"]
                             for k, r in sched_runs.items()},
    })
    glu = {phase: r for phase, _, _, r in shapes["qwen quant_act_glu"]}
    kernels.append({
        "name": "quant_act_glu", "route": "cuda",
        "source": KERNELS["quant_act"][0],
        "replaces": f"{KERNELS['quant_act'][1]} with the SwiGLU product of "
                    "src/repro/models/ffn.py:39-40 fused in",
        "launches": qwen[0]["quant_act_glu"],
        "max_abs_err": errs["quant_act_glu"],
        **{k: glu["prefill"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "unfused_ms", "plan", "plans")},
        "unfused": "F.silu(gate) * up, then K1: the path it replaces, timed "
                   "as its yardstick (not a library call)",
        "work": f"one qwen2.5-3b layer of prefill_step: gate and up "
                f"({LONG_PROMPT}, 11008) bf16",
        **{phase: {k: glu[phase][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "unfused_ms", "plan",
            "plans")} for phase in ("decode", "verify")},
        "scheduler_chunks": {phase: {k: r[k] for k in (
            "ms", "bound_ms", "unfused_ms", "plan", "plans")}
            for phase, r in glu.items() if phase.startswith("chunk")},
        "alu_check": alu,
        "launches_by_plan": served_plans("quant_act_glu")[
            "qwen2.5-3b prefill_step"]["by_plan"],
        "launches_by_path": served_plans("quant_act_glu"),
        "zamba2_7b": path_rows(shapes["zamba2 quant_act_glu"],
                               PATH_ROWS["zamba2"][1]),
        "phi3_vision_4_2b": path_rows(shapes["phi3 quant_act_glu"],
                                      PATH_ROWS["phi3"][1]),
    })
    mistral4 = mesh["mistral"]["four"]
    for name, (source, replaces) in MESH_KERNELS.items():
        layer = {m: mesh_layer_rows(mesh["rows"], m)[name]
                 for m in MESH_MODE_ROWS}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": mistral4["counts"][name],
            "max_abs_err": mesh["errs"][name],
            **{k: layer[256][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "work": "one mistral-large-123b rank's layer on 4 ranks, M=256:"
                    " wo (256, 3072) x (3072, 12288) and down (256, 7168) x "
                    "(7168, 12288) (sum over its two launches; launches: "
                    "rank 0 of the mesh-4 serve)",
            "decode": {k: layer[4][k] for k in ("ms", "plain_ms",
                                                "bound_ms", "library_ms")},
            "launches_qwen2_5_3b_mesh": {
                f"mesh {w} ({r['policy']})": r["counts"][name]
                for w, r in mesh["qwen"].items()},
        })
    kernels[0]["given_absmax_mode"] = {
        "work": "K1's given-absmax mode (quant_act, or quant_act_glu for "
                "down), one mistral rank's layer, M=256",
        **mesh_layer_rows(mesh["rows"], 256)["given_absmax"],
        "launches_mistral_mesh4": mistral4["counts"]["quant_act"]}
    for k in kernels:
        k["launches_qwen3_moe"] = path_launches(k["name"], "qwen3-moe")
        k["launches_zamba2_7b"] = path_launches(k["name"], "zamba2-7b")
        k["launches_mamba2_370m"] = path_launches(k["name"], "mamba2-370m")
        k["launches_seamless_m4t_medium"] = path_launches(
            k["name"], "seamless-m4t-medium")
        k["launches_phi3_vision_4_2b"] = path_launches(k["name"],
                                                       "phi-3-vision-4.2b")
    sched_all = {**{(k, "qwen2.5-3b w8a8 bf16, 36 layers"): r
                    for k, r in sched_runs.items()},
                 **{(k, f"{MOE_ARCH} w8a8 bf16, 48 layers"): r
                    for k, r in moe["sched"].items()}}
    for (k, model_text), r in sched_all.items():
        accept = ("-" if r["acceptance"] is None
                  else f"{r['acceptance']:.3f}")
        print(f"scheduler {k} ({model_text}): "
              f"{r['ticks']} ticks, {r['tok_s']:.1f} tok/s, "
              f"{r['ms_per_tick']:.3f} ms/tick, acceptance {accept}, "
              f"pages_peak {r['pages_peak']} of {SCHED_POOL}, page waits "
              f"{r['page_wait_ticks']} ticks, K4 {r['k4_verify']} verify + "
              f"{r['k4_plain']} plain")
    print(f"card vs CPU scheduler (2 layers f32): identical share "
          f"{sched_check}")
    print(f"card vs CPU {MOE_ARCH} (2 layers f32 'none'): {moe_check}")
    print(f"card vs CPU {HYBRID_ARCH} ({HYBRID_CHECK_LAYERS} layers f32 "
          f"'none'): {ssm_check}")
    for arch, res in ssm_res.items():
        s_counts, s_prefill, s_tps = res["serve"]
        sc = res["sched"]
        line = (f"{res['cfg'].family} serve ({arch}, "
                f"{res['cfg'].n_layers} layers, w8a8 bf16, dense slots): "
                f"prefill_ms={s_prefill * 1e3:.3f} decode_tok_s={s_tps:.1f}; "
                f"scheduler plain (first "
                f"{min(SLOT_SCHED_LAYERS, res['cfg'].n_layers)} layers) "
                f"{sc['ticks']} ticks, {sc['tok_s']:.1f} tok/s, "
                f"{sc['ms_per_tick']:.3f} ms/tick")
        if "long" in res:
            line += (f"; prefill_step (1 x {LONG_PROMPT}) "
                     f"{res['long'][1] * 1e3:.3f} ms, "
                     f"{res['long'][0]['flash_attention']} K5 launches")
        print(line)
    print(f"card vs CPU {ENCDEC_ARCH} ({CHECK_LAYERS} + {CHECK_LAYERS} "
          f"layers f32 'none'): {encdec_check}")
    for res, text in ((encdec, f"{ENC_FRAMES} frames a request"),
                      (vlm, "text-only")):
        r_counts, r_prefill, r_tps = res["serve"]
        print(f"{res['cfg'].family} serve ({res['cfg'].name}, "
              f"{res['cfg'].n_layers} layers, w8a8 bf16, paged bf16 pools, "
              f"{text}): prefill_ms={r_prefill * 1e3:.3f} "
              f"decode_tok_s={r_tps:.1f}; prefill_step "
              f"{res['long'][1] * 1e3:.3f} ms, "
              f"{res['long'][0]['flash_attention']} K5 launches")
    step = encdec["step"]
    cross = step["cross k / v projections (K1 + 2 K2)"]
    print(f"{ENCDEC_ARCH} decode step (stream time, CUDA events): "
          f"{step['total']:.3f} ms, cross-attention "
          f"{step['cross-attention']:.3f} ms, its k / v projections over "
          f"{MEMORY_ROWS} memory rows {cross:.3f} ms ("
          f"{cross / step['total']:.3f} of the step)")
    m_counts, m_prefill, m_tps = moe["serve"]
    print(f"moe serve ({MOE_ARCH}, 48 layers, w8a8 bf16, paged bf16 "
          f"pools): prefill_ms={m_prefill * 1e3:.3f} decode_tok_s="
          f"{m_tps:.1f}; prefill_step (1 x {LONG_PROMPT}) "
          f"{moe['long'][1] * 1e3:.3f} ms, {moe['long'][0]['flash_attention']}"
          " K5 launches")
    print(f"serve: dense prefill_ms={t_prefill * 1e3:.3f} "
          f"decode_tok_s={tps:.1f}; paged prefill_ms="
          f"{paged_prefill * 1e3:.3f} decode_tok_s={paged_tps:.1f}")
    print(f"prefill_step (1 x {LONG_PROMPT} tokens, w8a8 bf16): qwen2.5-3b "
          f"{qwen[0]['flash_attention']} layers {qwen[1] * 1e3:.3f} ms, K5 "
          f"{qwen[0]['flash_attention'] * fa['prefill']['ms']:.3f} ms of "
          f"it (launches x device ms); gemma2-27b 2 layers "
          f"{gemma[1] * 1e3:.3f} ms")
    steady = min(train["times"][1:])
    print(f"training ({TRAIN_ARCH}, 36 layers, bf16 ZeRO-1, 1 x "
          f"{TRAIN_SEQ} tokens): steady step {steady * 1e3:.1f} ms = "
          f"{TRAIN_SEQ / steady:.1f} tok/s, peak {train['peak_gb']:.2f} GB; "
          f"K5 backward {train['counts']['flash_attention_backward']} calls "
          f"x {bwd_row['ms']:.3f} ms; restart bitwise {restart[0]} "
          f"(max rel-diff {restart[1]:.3e}); card vs CPU train step loss "
          f"rel-err {train_check[0]:.3e}, worst gradient {train_check[1]:.3e}")
    for w, r in mesh["qwen"].items():
        print(f"mesh {w} ({r['policy']}) qwen2.5-3b Scheduler ({r['layers']}"
              f" layers, w8a8 bf16, {w} ranks on one card over gloo): "
              f"{r['tok_s']:.1f} tok/s (unsharded "
              f"{r['unsharded_tok_s']:.1f}), {r['ms_per_tick']:.3f} ms/tick, "
              f"identical share {r['identical_share']:.3f}, rank 0 peak "
              f"{r['peak_gb']:.2f} GB, collective share "
              f"{r['collective_share']:.3f} [{smi}]")
    wit = mesh["witness"]
    print(f"mesh 4 (pages) qwen2.5-3b depth witness ({wit['layers']} layers, "
          f"{wit['calls']} split-KV calls): worst {max(wit['split']):.3e} of "
          f"the row's largest |value| against the plain f32 reference "
          f"(limit {PAGES_WITNESS_REL:.3e}); K4 on the same inputs "
          f"{max(wit['k4']):.3e}")
    m1, m4 = mesh["mistral"]["one"], mesh["mistral"]["four"]
    print(f"mistral-large-123b ({MISTRAL_LAYERS} layers, w8a8 bf16): mesh 1 "
          f"{m1['tok_s']:.1f} tok/s, mesh 4 ({m4['policy']}) "
          f"{m4['tok_s']:.1f} tok/s; peak GB mesh 1 {m1['peak_gb']:.2f}, "
          f"mesh 4 rank 0 {m4['peak_gb']:.2f}; collective share "
          f"{m4['collective_share']:.3f}; logits within "
          f"{mesh['mistral']['logit_rel']:.3e}; identical share "
          f"{mesh['mistral']['identical_share']:.3f} [{smi}]")
    scratch_dir.cleanup()
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
