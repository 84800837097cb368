"""Run one cell of the benchmark of ``deepi2p_tpu_torch`` on the card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``.  A cell is
``portbench/workloads/<cell>.json``: its configuration
(``portbench/configs/<config>.json``), its loop (``portbench/loops/
<loop>.py``), its traffic, and the limits of its check.  A metric is
``portbench/metrics/<name>.py`` (or the file of the name's part before
its first dot), whose ``read(rec)`` returns the value or None.  ``BENCHMARK.json`` says which metrics a cell reports.

A run makes its inputs and weights from the seed, warms up (set-up), runs
the loop for ``--seconds``, with ``--trace 1`` also a short profiled
window, reads the peak device memory, frees the program, holds the
sampled answers to the plain reference in ``portbench/reference/`` and
prints each compared number beside its limit on standard error and, last
on standard output, one JSON line.  It exits nonzero and prints no result
without the cards the cell asks for, or if JAX or the JAX package was
imported.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CACHE = CHECKOUT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deepi2p_tpu")
NO_CARD, IMPORTED_JAX = 3, 5


def pin_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    name = "portbench._file_" + path.stem.replace(".", "_") + "_" + \
        path.parent.name
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_file(root: Path, name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or, for a
    name split by the end-to-end metric it moves (``idle_pct.train``),
    the reader of the part before the first dot (``metrics/idle_pct.py``)
    where the name has no file of its own."""
    own = root / "metrics" / f"{name}.py"
    return own if own.is_file() else \
        root / "metrics" / f"{name.split('.')[0]}.py"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX
    package, each compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: end-to-end ones
    without ``--trace``, per-layer ones with it."""
    def e2e_in(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = {m["name"]: m for m in bench["end_to_end"] if e2e_in(m)}
    if not trace:
        return list(e2e.values())
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def port_config(cfg: dict):
    from deepi2p_tpu_torch.config import Config
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in cfg.items() if k in names})


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", bench: dict | None = None,
             overrides: dict | None = None, controls=None, t0: float = T0,
             root: Path = HERE) -> tuple:
    """One run of a cell: (result dict, checks {name: (value, limit)}).

    ``overrides`` ({"config": {...}, "traffic": {...}}) shrink a cell for
    the CPU tests.  Where ``controls`` is given, each of them
    (``"control"``: the reference at the next lower precision; the train
    loop also takes ``"half"`` and ``"sign"``) is judged in the program's
    place after the program's own check, and every number of the program
    and of each control goes under ``result["readings"]``."""
    import torch

    from . import harness, trace as tr

    bench = bench if bench is not None else load_json(
        root.parent / "BENCHMARK.json")
    cell = load_json(root / "workloads" / f"{cell_name}.json")
    cfg = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = dict(cell["traffic"])
    if overrides:
        cfg.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
    loop = load_module(root / "loops" / f"{cell['loop']}.py")
    spans = tr.Spans(events=trace and device == "cuda")
    ctx = harness.Ctx(cfg=cfg, port=port_config(cfg), traffic=traffic,
                      seed=seed, device=device, spans=spans)
    st = loop.setup(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    batches = []
    start = time.monotonic()
    while True:
        ts = time.monotonic()
        items = loop.batch(st, len(batches))
        te = time.monotonic()
        batches.append((ts, te, items))
        if te - start >= seconds:
            break
    loop.finish(st)
    if device == "cuda":
        torch.cuda.synchronize()
    window_s = time.monotonic() - start
    spans.collect()

    rec = SimpleNamespace(cell=cell_name, cfg=cfg, traffic=traffic,
                          setup_s=setup_s, window_s=window_s, batches=batches,
                          span_ms=dict(spans.ms), profile=None, extra={})
    if trace:
        n = traffic["profile_batches"]
        extra = {}

        def profiled():
            extra.update(loop.profiled(st, len(batches), n))
            if device == "cuda":
                torch.cuda.synchronize()
        rec.profile = tr.profile(profiled, spans)
        rec.profile_batches = n
        rec.extra = extra

    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    attempted = sum(b[2] for b in batches)
    failed = st.failed
    t_check = time.monotonic()
    nums = loop.check(st, None)
    check_s = time.monotonic() - t_check
    checks = {k: (float(nums[k]), float(lim))
              for k, lim in cell["limits"].items()}
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())

    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        reader = load_module(metric_file(root, m["name"]))
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell["chips"], "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and rec.profile["window"] is not None:
        dev["busy_s"] = tr.busy_s(rec.profile)
        dev["window_s"] = rec.profile["window"][1] / 1e6
        result["breakdown"] = tr.breakdown(rec.profile)
    if controls is not None:
        result["readings"] = {"program": nums}
        result["readings"].update((c, loop.check(st, c)) for c in controls)
    result["check_s"] = check_s
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(CHECKOUT / "BENCHMARK.json")
    cell = load_json(HERE / "workloads" / f"{args.workload}.json")
    pin_caches()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return NO_CARD
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return IMPORTED_JAX
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
