#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the program's
place, one step below what the configuration states, judged as a run's
answers are.  It has to come out not correct.

    python3 bench/control.py --workload <config>.<mix> --seeds 1 2 3

The ranked service states float32 scores: its control scores in
bfloat16.  The exact services state that every occurrence is returned:
their control returns each document's first occurrence only.  The control
answers as many requests of the cell's stream, at the cell's size, as a
run compares; it needs no card and no window.  The benchmark's own runs do
not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def control_numbers(cfg: dict, mix: dict, seed: int) -> dict:
    import numpy as np

    import cell
    import generator
    import judge
    from inputs import make_corpus, make_lexicon, rng_for

    lex = make_lexicon(cfg)
    off, tok = make_corpus(cfg, lex)
    specs = [s for b in generator.pool(mix, off, tok, lex, seed) for s in b]
    n = min(int(mix["sample"]), len(specs))
    pick = np.sort(rng_for(seed, 0x5A).choice(len(specs), size=n,
                                              replace=False))
    specs = [specs[k] for k in pick]
    service = cfg["service"]
    rank, top_k = bool(service["rank"]), service["top_k"]
    kw = {"score_dtype": "bfloat16"} if rank else {"first_per_doc": True}

    def answers(**k):
        ref = cell.reference_for(cfg, lex, off, tok, **k)
        return [ref.answer(s["surface_ids"], s["mode"], s["window"], rank,
                           top_k) for s in specs]

    control = [judge.AsResponse(a, top_k) for a in answers(**kw)]
    got, _ = judge.judge(specs, control, answers(), rank, top_k,
                         cfg["limits"].get("score_rel_gap", 0.0))
    limits = cfg["limits"]
    got["correct"] = all(got[k] <= limits[k] for k in limits)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    import cell
    import generator
    from run import find_cell
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    w, cfg_entry = find_cell(spec, args.workload)
    cfg = cell.load_json(ROOT / cfg_entry["file"])
    mix = generator.load_mix(w["traffic"])
    failed = 0
    for seed in args.seeds:
        got = control_numbers(cfg, mix, seed)
        failed += not got["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, **got}),
              flush=True)
    # every seed's control must come out not correct
    return 0 if failed == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
