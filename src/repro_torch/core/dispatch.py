"""GEMM dispatch on Hopper: plan selection for the port's int8 GEMMs K2
(``tiled_matmul``) and K3 (``fused_qkv``), the counterpart of
``repro.core.dispatch``.

The paper picks its tile size T by measuring candidates on the hardware
(§5, "Tile size selection"); the JAX package automates that search, and so
does this module.  Both wrappers take every plan from ``select_plan`` /
``select_fused_plan``, which layer a measured table over the analytic pick
``gemm_plan`` (``core.tiling.choose_plan``).  A plan is a
``core.tiling.GemmPlan``: the variant (``wide``, ``swap`` or ``general``),
wgmma's width, and the K split.

Modes (env var ``REPRO_TUNE``), as in the JAX package:

  * ``off``    — the analytic ``gemm_plan``.
  * ``cached`` — default: a measured plan where the table has one for this
                 (M, K, N, dtype) key, else the analytic plan.  Never
                 measures, never writes.
  * ``full``   — on a miss, measure the candidates on the card, store the
                 winner in the table, and use it from then on.

The table is ``$REPRO_TUNE_CACHE`` (default
``~/.cache/repro_torch/gemm_tune.json``, never the JAX package's file,
whose unqualified entries are TPU picks) merged over the table shipped
with the package (``core/gemm_tune.json``, measured on an H100; disable
with ``REPRO_TUNE_SEED=0``).  Keys take the JAX package's forms:
``MxKxN:dtype[:backend]`` for K2 and ``MxKxNq+Nkv:dtype[:backend]`` for
K3, the dtype spelled as JAX spells it (``bfloat16``, ``float32``) and the
backend ``cuda``.  A lookup tries the backend-qualified key first, then
the unqualified one (a shipped table's); a fused lookup falls back to the
single-GEMM key ``MxKxNq``.  An entry holds ``variant``, ``cols``,
``split`` and ``chunk`` where the JAX package's holds ``block_m`` /
``block_n`` / ``block_k``, and never those three, so neither package reads
the other's entries: one file may hold both.  An entry becomes a plan only
if the wrappers' ``check_plan`` takes it at that shape; any other entry is
a miss, the counterpart of the JAX package's VMEM check.

Schedules: ``Schedule.PANEL`` is split == 1 (one block walks all of K);
``K_SPLIT`` is split > 1.  Unlike the JAX package, whose K split carries
its accumulators across K steps inside one block, a port K split runs
over *blocks*: each writes int32 partials, and a second kernel sums them.

Where the port departs from the JAX package, on purpose:

  (i)   under ``full`` a measurement that fails raises (JAX warns and takes
        the analytic plan): on the card that would hide a kernel that does
        not launch or does not match its plain version;
  (ii)  tuning during CUDA graph capture raises: the tuner launches and
        synchronizes; a lookup that hits the table is host-only and
        captures fine;
  (iii) operands TMA cannot read (K % 16 != 0, a base off 16 bytes) take
        the general tile without a lookup: the key does not hold
        alignment;
  (iv)  CPU tensors never reach the dispatcher: the wrappers run the plain
        version;
  (v)   the tuner keeps the analytic plan unless a candidate beats it by
        more than the spread of the two's timed replays, so noise does not
        enter the table;
  (vi)  the wrappers memoize each shape's plan (``plan_memo``), the
        counterpart of the JAX package's selection at trace time: after
        changing ``REPRO_TUNE*`` mid-process, call ``reset_cache_state()``
        (``_store`` does so itself).
"""
from __future__ import annotations

import enum
import json
import os
import statistics
import subprocess
import tempfile

import torch

from repro_torch.core.tiling import (BK, L2_BYTES, ROWS, SWAP_COLS,
                                     SWAP_MAX_M, WIDE_COLS, GemmPlan,
                                     PlanModel, ceil_div, swap_cols)

__all__ = [
    "Schedule",
    "select_plan",
    "select_fused_plan",
    "candidate_plans",
    "fused_candidate_plans",
    "tune",
    "tune_fused",
    "tune_mode",
    "cache_path",
    "seed_table_path",
    "load_cache",
    "clear_cache",
    "reset_cache_state",
]

TUNE_ENV = "REPRO_TUNE"
CACHE_ENV = "REPRO_TUNE_CACHE"
ITERS_ENV = "REPRO_TUNE_ITERS"
SEED_ENV = "REPRO_TUNE_SEED"
_VALID_MODES = ("off", "cached", "full")
BACKEND = "cuda"
# the keys of the JAX package's entries: an entry holding any is not ours
_JAX_FIELDS = ("block_m", "block_n", "block_k")
# a timed replay of the tuner's CUDA graph lasts about this long
_REPLAY_S = 2e-4


class Schedule(str, enum.Enum):
    """K schedule of a GEMM plan.  ``PANEL``: one block walks all of K
    (split == 1).  ``K_SPLIT``: K split over blocks (split > 1), each
    writing int32 partials that a second kernel sums.  str-valued, so it
    serialises into the JSON table and compares equal to
    ``GemmPlan.schedule``."""
    PANEL = "panel"
    K_SPLIT = "k_split"


def plan_schedule(plan: GemmPlan) -> Schedule:
    return Schedule.PANEL if plan.split == 1 else Schedule.K_SPLIT


# in-process mirror of the merged table, so repeated lookups do not re-read
# the files
_mem_cache: dict[str, dict] | None = None
_mem_cache_file: tuple[str, bool] | None = None
# the wrappers' memo of selected plans (tiled_matmul.ops.plan_for), emptied
# in place whenever the table may have changed
plan_memo: dict = {}


def tune_mode() -> str:
    mode = os.environ.get(TUNE_ENV, "cached")
    if mode not in _VALID_MODES:
        raise ValueError(
            f"{TUNE_ENV} must be one of {_VALID_MODES}, got {mode!r}")
    return mode


def cache_path() -> str:
    return os.environ.get(
        CACHE_ENV,
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "gemm_tune.json"))


def seed_table_path() -> str:
    """The table shipped with the package (measured on an H100)."""
    return os.path.join(os.path.dirname(__file__), "gemm_tune.json")


def _seed_enabled() -> bool:
    return os.environ.get(SEED_ENV, "1").lower() not in ("0", "off", "false")


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"``, as JAX names its dtypes."""
    return str(dtype).rsplit(".", 1)[-1]


def _key(m: int, k: int, n: int, out_dtype, backend: str | None = None) -> str:
    """Cache key.  Measured entries are backend-qualified; the unqualified
    key is a shipped table's."""
    base = f"{m}x{k}x{n}:{_dtype_name(out_dtype)}"
    return f"{base}:{backend}" if backend else base


def _fused_key(m: int, k: int, nq: int, nkv: int, out_dtype,
               backend: str | None = None) -> str:
    """Fused-QKV key: the (Nq, Nkv) split is part of it (GQA's K / V
    columns change the winning plan)."""
    base = f"{m}x{k}x{nq}+{nkv}:{_dtype_name(out_dtype)}"
    return f"{base}:{backend}" if backend else base


def _read_table(path: str) -> dict[str, dict]:
    try:
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            return {k: v for k, v in raw.items() if isinstance(v, dict)}
    except (OSError, ValueError):
        pass                       # missing or corrupt cache = empty table
    return {}


def load_cache() -> dict[str, dict]:
    """The user's table merged over the shipped one (the user's entries
    win)."""
    global _mem_cache, _mem_cache_file
    path = cache_path()
    state = (path, _seed_enabled())
    if _mem_cache is not None and _mem_cache_file == state:
        return _mem_cache
    table = _read_table(seed_table_path()) if _seed_enabled() else {}
    table.update(_read_table(path))
    _mem_cache = table
    _mem_cache_file = state
    return table


def _store(key: str, entry: dict) -> None:
    """Read-merge-write through a temporary file and ``os.replace``, so
    concurrent tuners lose at most their own entry; only the user's
    entries are written, never the shipped table's."""
    path = cache_path()
    table = _read_table(path)
    table[key] = entry
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    reset_cache_state()            # next lookup re-merges shipped + user


def reset_cache_state() -> None:
    """Drop the in-process mirror of the table and the wrappers' plan memo
    (the files are untouched).  Call after changing ``REPRO_TUNE``,
    ``REPRO_TUNE_CACHE`` or ``REPRO_TUNE_SEED`` mid-process."""
    global _mem_cache, _mem_cache_file
    _mem_cache = None
    _mem_cache_file = None
    plan_memo.clear()


def clear_cache() -> None:
    reset_cache_state()
    try:
        os.unlink(cache_path())
    except OSError:
        pass


def _ops():
    """The K2 wrapper's module (``gemm_plan``, ``check_plan``), imported on
    first use: it imports this module."""
    from repro_torch.kernels.tiled_matmul import ops
    return ops


def _analytic(m: int, ns: tuple, k: int, aligned: bool) -> GemmPlan:
    # read through the wrapper's module, so a patched gemm_plan is taken
    return _ops().gemm_plan(m, ns, k, aligned)


def _fits(plan: GemmPlan, m: int, ns: tuple, k: int, aligned: bool) -> bool:
    try:
        _ops().check_plan(plan, m, ns, k, aligned)
    except ValueError:
        return False
    return True


def _plan_from_entry(m: int, ns: tuple, k: int, aligned: bool,
                     entry: dict) -> GemmPlan | None:
    """The entry's plan if it is one of the port's that the kernel takes
    at this shape; a stored ``schedule`` must agree with its split (an
    entry without one is inferred from it)."""
    if any(f in entry for f in _JAX_FIELDS):
        return None
    try:
        plan = GemmPlan(str(entry["variant"]), int(entry["cols"]),
                        int(entry["split"]), int(entry["chunk"]))
        if "schedule" in entry and \
                Schedule(entry["schedule"]) is not plan_schedule(plan):
            return None
    except (KeyError, TypeError, ValueError):
        return None
    return plan if _fits(plan, m, ns, k, aligned) else None


# ---------------------------------------------------------------------------
# Candidate generation — the analytic pick seeds the search space
# ---------------------------------------------------------------------------
def _candidates(m: int, ns: tuple, k: int, aligned: bool, out_bytes: int,
                max_candidates: int) -> list[GemmPlan]:
    seed = _analytic(m, ns, k, aligned)
    if seed.variant == "general":
        return [seed]              # TMA cannot read these operands
    nk = ceil_div(k, BK)
    plans = []
    if m > SWAP_COLS[-1]:
        plans.append(GemmPlan("wide", WIDE_COLS, 1, nk))
    if m <= SWAP_MAX_M or max(ns) <= ROWS:
        for split in (1, 2, 4, 8, 16):
            if split <= nk:
                chunk = ceil_div(nk, split)
                plans.append(GemmPlan("swap", swap_cols(m),
                                      ceil_div(nk, chunk), chunk))
    out = [seed]
    for plan in dict.fromkeys(plans):
        if plan != seed and _fits(plan, m, ns, k, aligned):
            out.append(plan)
    # rank the others by the Hopper model, so a small max_candidates still
    # measures the likeliest
    head, tail = out[:1], out[1:]
    tail.sort(key=lambda p: PlanModel(p, m, ns, k, out_bytes).time_estimate())
    return (head + tail)[:max_candidates]


def candidate_plans(m: int, k: int, n: int, *, out_bytes: int = 2,
                    aligned: bool = True,
                    max_candidates: int = 8) -> list[GemmPlan]:
    """K2's candidates at (M, K, N), the analytic pick first: the wide
    plan where M > 64; the swap plan at M's padded width at each split of
    1, 2, 4, 8 and 16 that K allows, for M <= 512 or where N <= 128; each
    one ``check_plan`` takes; the rest ranked by ``time_estimate``."""
    return _candidates(m, (n,), k, aligned, out_bytes, max_candidates)


def fused_candidate_plans(m: int, k: int, nq: int, nkv: int, *,
                          out_bytes: int = 2, aligned: bool = True,
                          max_candidates: int = 8) -> list[GemmPlan]:
    """K3's candidates at (M, K, Nq, Nkv): ``candidate_plans`` over the
    three widths [Nq | Nkv | Nkv]."""
    return _candidates(m, (nq, nkv, nkv), k, aligned, out_bytes,
                       max_candidates)


# ---------------------------------------------------------------------------
# Measurement on the card
# ---------------------------------------------------------------------------
_card_text: str | None = None


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (torch's name for it
    alone where nvidia-smi does not answer)."""
    global _card_text
    if _card_text is None:
        try:
            _card_text = subprocess.run(
                ["nvidia-smi", "-i", str(torch.cuda.current_device()),
                 "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True,
                timeout=60).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            _card_text = (torch.cuda.get_device_name()
                          if torch.cuda.is_available() else "no CUDA card")
    return _card_text


def _operand_sets(m: int, ns: tuple, k: int, out_bytes: int, dev):
    """Seeded sets of quantized operands, A (m, k) and one K-major weight
    per width with positive scales: enough copies that together they
    exceed L2 twice over."""
    from repro_torch.core.quantization import QTensor
    g = torch.Generator(device=dev).manual_seed(0)

    def q(rows, cols, scale_shape, k_major):
        v = torch.randint(-127, 128, (cols, rows) if k_major else (rows, cols),
                          generator=g, device=dev, dtype=torch.int8)
        s = torch.rand(scale_shape, generator=g, device=dev) * 1e-2 + 1e-3
        return QTensor(values=v.t() if k_major else v, scale=s, bits=8)

    n_all = sum(ns)
    set_bytes = (m * k + k * n_all + 4 * (m + n_all)
                 + out_bytes * m * n_all)
    copies = max(2, min(256, ceil_div(2 * L2_BYTES, set_bytes)))
    return [(q(m, k, (m, 1), False),
             *(q(k, n, (1, n), True) for n in ns)) for _ in range(copies)]


def _measure_plan(plan: GemmPlan, sets: list, m: int, ns: tuple, k: int,
                  out_dtype, iters: int) -> tuple[float, float]:
    """(median, max - min) of the device µs a call of the wrapper under
    ``plan`` takes, over ``iters`` timed replays of a CUDA graph of calls
    rotating over operand copies that together exceed L2 (each call finds
    its operands cold), timed with CUDA events.  The plan goes through the
    wrapper's ``check_plan`` and C launcher; its output is first held
    bitwise against the plain version on the same card, and a mismatch
    raises."""
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    from repro_torch.kernels.fused_qkv.ref import fused_qkv_ref
    from repro_torch.kernels.tiled_matmul.ref import tiled_matmul_ref

    ops = _ops()
    if len(ns) == 1:
        def call(a, b):
            return (ops.tiled_matmul(a, b, out_dtype=out_dtype, plan=plan),)

        def plain(a, b):
            return (tiled_matmul_ref(a.values, a.scale, b.values, b.scale,
                                     None, out_dtype),)
    else:
        def call(a, *ws):
            return fused_qkv(a, *ws, out_dtype=out_dtype, plan=plan)

        def plain(a, *ws):
            return fused_qkv_ref(a.values, a.scale,
                                 *(x for w in ws for x in (w.values, w.scale)),
                                 out_dtype=out_dtype)
    for got, want in zip(call(*sets[0]), plain(*sets[0])):
        if not torch.equal(got, want):
            raise RuntimeError(
                f"tune: {plan} at ({m}, {k}) x {list(ns)} {out_dtype} differs "
                "from the plain version on the card")
    model = PlanModel(plan, m, ns, k,
                      torch.tensor([], dtype=out_dtype).element_size())
    launches = max(4, min(64, round(_REPLAY_S / model.time_estimate())))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for s in sets[:3]:
            call(*s)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            call(*sets[i % len(sets)])
    graph.replay()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / launches)
    del graph
    return statistics.median(times), max(times) - min(times)


def _measure_all(plans: list, m: int, ns: tuple, k: int, out_dtype,
                 iters: int) -> list[tuple[float, float]]:
    """``_measure_plan`` of each plan on one set of operands; the tuner's
    launches are not the caller's, so the wrapper's counts are restored."""
    from repro_torch.kernels.fused_qkv.ops import fused_qkv
    if not torch.cuda.is_available():
        raise RuntimeError("tune: measuring a plan needs a CUDA card")
    out_bytes = torch.tensor([], dtype=out_dtype).element_size()
    sets = _operand_sets(m, ns, k, out_bytes,
                         torch.device("cuda", torch.cuda.current_device()))
    wrapper = _ops().tiled_matmul if len(ns) == 1 else fused_qkv
    saved = (wrapper.launches, wrapper.plans.copy(),
             wrapper.launched_plans.copy())
    try:
        return [_measure_plan(plan, sets, m, ns, k, out_dtype, iters)
                for plan in plans]
    finally:
        wrapper.launches = saved[0]
        for counter, kept in zip((wrapper.plans, wrapper.launched_plans),
                                 saved[1:]):
            counter.clear()
            counter.update(kept)


def _tune(m: int, k: int, ns: tuple, key: str, out_dtype, iters,
          max_candidates: int, results) -> GemmPlan:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"tune: no table entry for {key} during CUDA graph capture; "
            "tune before capturing (a lookup that hits the table captures)")
    if iters is None:
        iters = int(os.environ.get(ITERS_ENV, "3"))
    out_bytes = torch.tensor([], dtype=out_dtype).element_size()
    plans = _candidates(m, ns, k, True, out_bytes, max_candidates)
    timed = [(plan, us, spread) for plan, (us, spread) in
             zip(plans, _measure_all(plans, m, ns, k, out_dtype, iters))]
    if results is not None:
        results.extend((plan, us) for plan, us, _ in timed)
    # the analytic plan stays unless another beats it by more than the
    # replays' spread
    _, analytic_us, analytic_spread = timed[0]
    best, best_us, best_spread = min(timed, key=lambda r: r[1])
    if analytic_us - best_us <= max(analytic_spread, best_spread):
        best, best_us, best_spread = timed[0]
    _store(key, {
        "variant": best.variant,
        "cols": best.cols,
        "split": best.split,
        "chunk": best.chunk,
        "schedule": plan_schedule(best).value,
        "us": best_us,
        "spread_us": best_spread,
        "analytic_us": analytic_us,
        "backend": BACKEND,
        "candidates": len(timed),
        "card": card(),
    })
    return best


def tune(m: int, k: int, n: int, *, out_dtype=torch.bfloat16,
         iters: int | None = None, max_candidates: int = 8,
         results: list | None = None) -> GemmPlan:
    """Measure K2's candidates at (M, K, N) on the card, store the winner
    under ``MxKxN:dtype:cuda`` and return it.  ``results`` receives every
    ``(plan, µs)``.  Raises if a candidate fails or differs from the plain
    version, and during CUDA graph capture."""
    return _tune(m, k, (n,), _key(m, k, n, out_dtype, BACKEND), out_dtype,
                 iters, max_candidates, results)


def tune_fused(m: int, k: int, nq: int, nkv: int, *,
               out_dtype=torch.bfloat16, iters: int | None = None, max_candidates: int = 8,
               results: list | None = None) -> GemmPlan:
    """``tune`` for K3 at (M, K, Nq, Nkv), stored under
    ``MxKxNq+Nkv:dtype:cuda``."""
    return _tune(m, k, (nq, nkv, nkv),
                 _fused_key(m, k, nq, nkv, out_dtype, BACKEND), out_dtype,
                 iters, max_candidates, results)


# ---------------------------------------------------------------------------
# The dispatch entry points
# ---------------------------------------------------------------------------
def _select(m: int, k: int, ns: tuple, aligned: bool, keys, measure):
    mode = tune_mode()
    analytic = _analytic(m, ns, k, aligned)
    if mode == "off" or analytic.variant == "general":
        return analytic
    table = load_cache()
    for key in keys:
        entry = table.get(key)
        if entry is not None:
            plan = _plan_from_entry(m, ns, k, aligned, entry)
            if plan is not None:
                return plan
    return measure() if mode == "full" else analytic


def select_plan(m: int, k: int, n: int, *, out_dtype=torch.bfloat16,
                aligned: bool = True) -> GemmPlan:
    """K2's plan for C[M, N] = A[M, K] @ B[K, N]: the table's where it has
    one, measured under ``full`` where it has none, else analytic.
    ``aligned``: every operand's base is 16-byte aligned."""
    return _select(m, k, (n,), aligned,
                   (_key(m, k, n, out_dtype, BACKEND),
                    _key(m, k, n, out_dtype)),
                   lambda: tune(m, k, n, out_dtype=out_dtype))


def select_fused_plan(m: int, k: int, nq: int, nkv: int, *,
                      out_dtype=torch.bfloat16, aligned: bool = True) -> GemmPlan:
    """K3's plan for (M, K) times [Nq | Nkv | Nkv].  Lookup order under
    ``cached`` / ``full``: the fused key (backend-qualified, then
    shipped), then the single-GEMM key ``MxKxNq`` (its split 1 / > 1 maps
    to the panel / k_split schedule), then (``full`` only) a fused
    measurement."""
    return _select(m, k, (nq, nkv, nkv), aligned,
                   (_fused_key(m, k, nq, nkv, out_dtype, BACKEND),
                    _fused_key(m, k, nq, nkv, out_dtype),
                    _key(m, k, nq, out_dtype, BACKEND),
                    _key(m, k, nq, out_dtype)),
                   lambda: tune_fused(m, k, nq, nkv, out_dtype=out_dtype))
