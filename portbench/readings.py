"""The two readings that each correctness limit is set from.

    python3 portbench/readings.py --workload <name> [--workload ...] \
        --seeds 1,2,... --control-seeds 7,8,9 [--seconds 3] [--out FILE]

Lower reading: the program, driven through each named cell's own timed
path for a short window at the cell's load, on every seed of ``--seeds``;
each number the cell compares, the worst over its sampled outputs.
Upper reading (the control): the plain reference computed a step below
the configuration's precision (float32 with TF32 products) put in the
program's place, compared the same way, on every seed of
``--control-seeds``. One process reads them all; each reading is one JSON
line on standard output (and in ``--out``). Needs the card, like a run.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(name, seed, device, overrides=None):
    """The control's numbers on one seed: the cell's pool made from the
    seed, the reference in TF32 in the program's place on as many pool
    entries as a run samples, each compared as a run compares."""
    import numpy as np
    from portbench.lib import harness, spec
    cell = spec.workload(spec.benchmark(), name)
    cfg = dict(spec.config(cell["config"]), **(overrides or {}))
    mix = spec.mix(cell["traffic"])
    system = spec.module("configs", cell["config"]).System(cfg, seed, device)
    pool = harness.make_pool(system, mix)
    ref_mod = spec.module("reference", cell["config"])
    low = ref_mod.Reference(cfg, system.traj, system.maps, "tf32", device)
    picks = np.random.default_rng([seed, 2]).choice(
        len(pool), size=min(int(mix["sample"]), len(pool)), replace=False)
    kept = [(int(i), low.image(pool[i]).cpu().numpy()) for i in picks]
    del low
    return harness.check(ref_mod, cfg, (system.traj, system.maps), device,
                         pool, kept, spec.limits(name))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench.lib import harness
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for name in args.workload:
        for seed in seeds:
            r = harness.run_cell(name, seed, args.seconds, False)
            emit({"workload": name, "seed": seed, "kind": "program",
                  "correct": r["correct"], "attempted": r["attempted"],
                  "checks": r["checks"], "metrics": r["metrics"]})
            torch.cuda.empty_cache()
        for seed in controls:
            emit({"workload": name, "seed": seed, "kind": "control_tf32",
                  "checks": control(name, seed, dev)})
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
