"""The readings that the limits of `correct` are set from, on the card at a
cell's own size: the control and the planted faults.

    python3 -m segbench.control --workload <cell> --seeds 1 2 3

For each seed it makes the cell's inputs and weights as a run does and puts
the reference in the program's place three ways: in fp8 (every conv's input
and kernel rounded to float8_e4m3fn with a scale a tensor: the step below
the configurations' bf16 that would tempt a later change), and with each
fault the cell can have (training: the state left unchanged, half of each
batch left out and the mean taken over the rest; evaluation: a batch's
answers altered where they are produced, the last, partial batch left
out). Training reads the window's step from the reference's own leaves
after the steps before the window. Each is compared with the f32
reference by the cell's own comparison, and every number is printed; for
training, with `--look`, also the f32 reference against itself in f64 (its
own rounding, which the gradients' conditioning magnifies). The
benchmark's runs do not run this; the program's own readings come from
them.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from segbench import harness


def readings(traffic, cell: dict, look: bool = False) -> dict[str, tuple[list, dict]]:
    """{variant: (checks, the numbers read but not compared)} for one seed;
    with `look`, for training also the f32 reference against itself in f64."""
    kind = cell["traffic"]
    traffic.make_inputs()

    def compare(got, ref):
        checks = traffic.compare(got, ref)
        return checks, dict(traffic.info)

    if kind == "train_loop":
        start = traffic.reference_window_start()
        ref = traffic.reference("f32", window_start=start)
        unchanged = dict(ref, g1={k: 0.0 for k in ref["g1"]}, dp={k: 0.0 for k in ref["dp"]})
        out = {"control_fp8": compare(traffic.reference("fp8", window_start=start), ref),
               "fault_half_batch": compare(
                   traffic.reference("f32", half=True, window_start=start), ref),
               "fault_state_unchanged": compare(unchanged, ref)}
        if look:
            out["look_f32_against_f64"] = compare(
                ref, traffic.reference("f64", window_start=start))
        return out
    if kind == "eval_passes":
        ref = traffic.reference("f32")
        moved = ref.copy()
        moved[0] = np.roll(ref[0], 1, axis=1)  # the first batch's answers moved by a class

        def whole(batches):
            return {"pass": batches.sum(0), "batches": batches}

        return {"control_fp8": compare(whole(traffic.reference("fp8")), ref),
                "fault_answer_altered": compare(whole(moved), ref),
                "fault_last_batch_dropped": compare(
                    {"pass": ref[:-1].sum(0), "batches": np.concatenate(
                        [ref[:-1], np.zeros_like(ref[-1:])])}, ref)}
    raise ValueError(f"no control for traffic {kind!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--look", action="store_true",
                   help="training: also the f32 reference against itself in f64")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("segbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell, cfg = harness.cell(args.workload)
    cell = dict(cell, num_classes=cfg["num_classes"])
    module = harness.load_module("traffic", cell["traffic"])
    for seed in args.seeds:
        traffic = module.Traffic(cell, cfg, seed, torch.device("cuda"))
        for variant, (checks, info) in readings(traffic, cell, args.look).items():
            print(json.dumps({"workload": cell["name"], "seed": seed, "variant": variant,
                              "checks": {c.name: harness.finite(c.value) for c in checks},
                              "info": info}), flush=True)
        del traffic
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
