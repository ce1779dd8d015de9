"""The readings that a cell's limits are set from, in one process.

    python3 perfbench/readings.py --workload yi-9b.longdoc --seeds 101,102,103 --control 3

For each seed: the weights are drawn, one round of the mix's batches (every
prompt length of the mix, the longest included) runs through the engine as
a run's window does, the run's sample of requests is compared with the
reference, and, for the first ``--control`` seeds, so is the control: the
reference with float8 products in the program's place
(:func:`perfbench.check.control`).  One JSON line per seed, with every
row's readings; the last line gives the largest program reading and the
smallest control reading of each number, the two ends a limit is set
between.  The benchmark's own runs do
not run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench import check, manifest, reference
    from perfbench.harness import Sampler, build, closed_loop, prompts_of

    cell = manifest.load_cell(args.workload)
    dev = torch.device(args.device)
    model = cell.model
    program, controls = [], []
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        params, schedule, engine = build(cell, seed, dev)
        sampler = Sampler(cell.check_requests, schedule.sampler_rng())
        closed_loop(engine, schedule, 0.0, sampler=sampler, batches=len(cell.traffic.lengths))
        del engine
        samples = sampler.samples()
        prompts = prompts_of(samples, schedule)
        t1 = time.perf_counter()
        ref = reference.last_logits(params, model, prompts)
        logits, tokens = [s.logits for s in samples], [s.token for s in samples]
        line = {"seed": seed, "requests": len(samples),
                "program": check.numbers(logits, tokens, ref),
                "rows": check.per_row(logits, tokens, ref)}
        t2 = time.perf_counter()
        program.append(line["program"])
        if n < args.control:
            rows, served = check.control(params, model, prompts)
            line["control"] = check.numbers(rows, served, ref)
            line["control_rows"] = check.per_row(rows, served, ref)
            controls.append(line["control"])
        line["seconds"] = {"window": t1 - t0, "reference": t2 - t1,
                           "control": time.perf_counter() - t2}
        print(json.dumps(line), flush=True)
        del params, ref, samples
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    summary = {k: {"program_max": max(p[k] for p in program),
                   "control_min": min((c[k] for c in controls), default=None)}
               for k in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
