"""The controls of ``correct``: the cell run with one guarantee of its
configuration switched off in the program, which the comparison has to
refuse.  The benchmark's own runs never run this.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 (--set cdef_level=0 [--set qp=41] | --fault NAME)

Each seed is one run of ``run.py``'s path with the encoder settings
``--set`` changed (the reference still holds the stream to the
configuration as stated), or with a fault of ``faults.py`` planted in
each channel's encoder; each prints its result line.
"""
from __future__ import annotations

import argparse
import json
import sys

import run
from faults import FAULTS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="an encoder setting, name=JSON value")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    control = dict(overrides={k: json.loads(v) for k, v in
                              (s.split("=", 1) for s in args.set)},
                   fault=args.fault)
    refused = 0
    for seed in args.seeds.split(","):
        print(f"control {control} seed {seed}", file=sys.stderr,
              flush=True)
        rc = run.main(["--workload", args.workload, "--seed", seed,
                       "--seconds", str(args.seconds), "--trace", "0"],
                      control)
        sys.stdout.flush()
        refused += rc != 0
    return 1 if refused else 0


if __name__ == "__main__":
    sys.exit(main())
