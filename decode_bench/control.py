#!/usr/bin/env python3
"""The control of `correct`: the reference in the program's place, at a
lower precision than the configuration states.

    python3 decode_bench/control.py --workload <cell> --seeds 1,2,3

The configurations state Main10: 10-bit samples, bit-exact with the
reference decoder.  The nearest precision below is 8-bit video, so the
control hands out the reference's own pictures with each sample kept to
8 bits (its two low bits dropped), every picture of every clip of the
cell once, and puts them to the same comparison a run makes
(reference.compare).  It has to come out not correct; its numbers are
the upper readings of the limits.  It needs no card and runs the
reference on the host.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [HERE] + [p for p in sys.path
                        if os.path.abspath(p or ".") != HERE]

CACHE = os.path.join(HERE, ".cache")


def to_8_bits(planes) -> list:
    """10-bit planes kept to 8 bits of precision."""
    return [(p >> 2) << 2 for p in planes]


def control_numbers(cell, seed: int, cache: str | None, workers: int
                    ) -> dict:
    """The comparison's numbers for the control of one seed."""
    import clips as clipmod
    import reference as refmod
    clips = clipmod.make_clips(cell.config, cell.traffic, seed, cache,
                               workers)
    refs = refmod.decode_clips([c.stream for c in clips], workers)
    handed, fed = [], []
    for ci, (c, rc) in enumerate(zip(clips, refs)):
        fed.append((ci, len(c.pocs)))
        handed += [(ci, poc, to_8_bits(rc.planes[poc])) for poc in c.pocs]
    return refmod.compare(handed, fed, clips, refs, workers)


def main(argv=None) -> int:
    import manifest
    import reference as refmod
    from run import ref_workers
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    out = {}
    for s in (int(x) for x in args.seeds.split(",")):
        numbers = control_numbers(cell, s, CACHE, ref_workers())
        out[s] = numbers
        print(json.dumps({"workload": cell.name, "seed": s,
                          "correct": refmod.is_correct(numbers),
                          "numbers": numbers}), flush=True)
    return 0 if all(not refmod.is_correct(n) for n in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
