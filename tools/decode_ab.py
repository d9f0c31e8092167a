#!/usr/bin/env python3
"""Decode speed of two checkouts of the port on one CUDA card, in turns.

    python3 tools/decode_ab.py ROOT_A ROOT_B [--rounds N] [--out FILE]

ROOT_A and ROOT_B are checkouts of this repository (for example a parent
commit unpacked with `git archive` and the working tree).  The headline
stream (832x480, 8 frames) and the SAO/ALF 1080p stream (1920x1080, 4
frames) are made once, with ROOT_B's test encoder, into a temporary
directory.  Each round then runs four turns, A, B, B, A, each a fresh
process that imports vvdec_tpu_torch from its checkout (and so builds its
own kernels): per stream one decode to warm up, one timed decode and one
with the stage profiler on, through StreamDecoder on CUDA (push, flush,
synchronise), each held to the stream's pinned MD5.  Prints, per turn
and stream, frames/s of the timed and profiled decodes and the profiled
"intra" and "filter" stages in ms per frame; then the card's name and
power limit.
Compare the two checkouts only within one run: hosts differ from run to
run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

STREAMS = ("headline", "SAO/ALF 1080p")


def make_streams(root: str, out_dir: str) -> None:
    sys.path.insert(0, root)
    from vvdec_tpu_torch.streams import STREAMS as S
    for name in STREAMS:
        t0 = time.perf_counter()
        data = S[name][0]()
        with open(os.path.join(out_dir, name.replace("/", "_")), "wb") as f:
            f.write(data)
        print(f"[streams] {name}: {len(data)} bytes in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def turn(root: str, stream_dir: str) -> dict:
    """One turn, in this process: the streams decoded by root's port."""
    sys.path.insert(0, root)
    import hashlib

    import numpy as np
    import torch

    from vvdec_tpu_torch.decoder import StreamDecoder
    from vvdec_tpu_torch.streams import STREAMS as S
    from vvdec_tpu_torch.utils.trace import profiler
    out = {}
    for name in STREAMS:
        with open(os.path.join(stream_dir, name.replace("/", "_")), "rb") as f:
            data = f.read()
        _, n_frames, pin = S[name]

        def decode():
            t0 = time.perf_counter()
            dec = StreamDecoder()
            frames = [p.planes for p in dec.push(data) + dec.flush()]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            md5 = hashlib.md5()
            for f in frames:
                for p in f:
                    md5.update(np.ascontiguousarray(p).astype(
                        np.uint16).tobytes())
            if md5.hexdigest() != pin or len(frames) != n_frames:
                raise SystemExit(f"{root}: {name} decoded to "
                                 f"{md5.hexdigest()}, pinned {pin}")
            return n_frames / dt

        decode()
        fps = decode()
        profiler.reset()
        profiler.enabled = True
        try:
            fps_prof = decode()
        finally:
            profiler.enabled = False
        stages = {k: v / n_frames * 1e3 for k, v in profiler.totals.items()
                  if k.startswith(("intra", "filter"))}
        out[name] = dict(fps=fps, fps_profiled=fps_prof,
                         stages_ms_per_frame=stages)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--turn", nargs=2, metavar=("ROOT", "STREAM_DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--make", nargs=2, metavar=("ROOT", "STREAM_DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.make:
        make_streams(*map(os.path.abspath, args.make))
        return 0
    if args.turn:
        print(json.dumps(turn(*map(os.path.abspath, args.turn))))
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkouts, ROOT_A and ROOT_B")
    roots = [os.path.abspath(r) for r in args.roots]
    me = os.path.abspath(__file__)
    results = []
    with tempfile.TemporaryDirectory() as stream_dir:
        subprocess.run([sys.executable, me, "--make", roots[1], stream_dir],
                       check=True)
        for _ in range(args.rounds):
            for label in "ABBA":
                root = roots["AB".index(label)]
                r = subprocess.run([sys.executable, me, "--turn", root,
                                    stream_dir], cwd=root,
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    print(r.stdout[-3000:], r.stderr[-3000:])
                    return 1
                res = json.loads(r.stdout.strip().splitlines()[-1])
                results.append(dict(checkout=label, root=root, **res))
                for name, v in res.items():
                    stages = ", ".join(f"{k} {ms:.3f}" for k, ms in sorted(
                        v["stages_ms_per_frame"].items()))
                    print(f"[{label}] {name}: {v['fps']:.2f} frames/s, "
                          f"profiled {v['fps_profiled']:.2f}; ms per frame: "
                          f"{stages}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, turns=results), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
