#!/usr/bin/env python3
"""The benchmark of repro_torch: one run of one cell.

    python3 bench/run.py --workload <config>.<mix> --seed N --seconds S
                         --trace 0|1

Run from the root of a checkout on a machine with an NVIDIA GPU.  The cell
comes from BENCHMARK.json: its configuration file (bench/configs/), its
traffic mix (bench/traffic/<mix>.json, read by bench/generator.py) and the
readers of its metrics (bench/metrics/<name>.py) are found by name.  With
--trace 0 the run reports the cell's end-to-end metrics, with --trace 1
its per-layer ones from a profiled window.  Standard error ends with each
number compared against the reference beside its limit; standard output
ends with one JSON line.  Without a card, or with fewer cards than the
cell asks for, it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# one process with one compute thread: the program's host path is
# single-threaded, and idle pools of worker threads only add noise
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# build and kernel caches of the program, and the built index, at fixed
# paths inside the checkout
CACHE = ROOT / ".bench_cache"


def find_cell(spec: dict, workload: str) -> tuple[dict, dict]:
    """(cell, configuration entry) of `workload` in BENCHMARK.json."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    return cell, configs[cell["config"]]


def cell_metrics(spec: dict, workload: str, trace: bool) -> dict:
    """{name: unit} of the metrics this run reports."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return {m["name"]: m["unit"] for m in group
            if workload in m.get("workloads", [workload])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg_entry = find_cell(spec, args.workload)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import cell as cellrun
    import generator
    cfg = cellrun.load_json(ROOT / cfg_entry["file"])
    mix = generator.load_mix(cell["traffic"])
    log = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731
    log(f"[cell] {args.workload} seed={args.seed} seconds={args.seconds} "
        f"trace={args.trace} card={power_limit()}")
    result = cellrun.run_cell(
        cfg, mix, args.seed, args.seconds, bool(args.trace), "cuda",
        cell_metrics(spec, args.workload, bool(args.trace)), T_START, log,
        index_cache=CACHE / "index")
    # the window has closed: the port must not have loaded the JAX stack
    bad = cellrun.forbidden_modules()
    if bad:
        log(f"[forbidden] modules of the JAX stack are loaded: {bad}")
        return 3
    # the numbers compared, beside their limits, last on standard error
    for k, v in result["compared"].items():
        log(f"{k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return json.dumps(out.stdout.strip().splitlines()[:1])


if __name__ == "__main__":
    sys.exit(main())
