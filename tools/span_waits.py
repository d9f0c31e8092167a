#!/usr/bin/env python3
"""Where the host blocks on the card, in one clip of each named cell.

    python3 tools/span_waits.py <cell> ... [--out FILE]

from the root of a checkout, on CUDA.  For each decode_bench cell it
decodes the first clip once to warm up, once under
torch.cuda.set_sync_debug_mode("warn"), counting each synchronising
call by its innermost vvdec_tpu_torch frames, and once under
torch.profiler with stacks, counting the pageable host-to-device copies
by their launch sites.  Prints a JSON object a cell.
"""
import argparse
import collections
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "decode_bench"), ROOT]


def rel(fn):
    i = fn.find("vvdec_tpu_torch")
    return fn[i:] if i >= 0 else os.path.basename(fn)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--out")
    a = ap.parse_args()
    import clips as clipmod
    import manifest
    import window as winmod
    import torch
    from torch.profiler import ProfilerActivity, profile
    import vvdec_tpu_torch.api as api
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        "torch": torch.__version__}
    for name in a.cells:
        cell = manifest.load_cell(name)
        t = time.time()
        cl = clipmod.make_clips(cell.config, cell.traffic, 2 ** 31 + 99,
                                os.path.join(ROOT, "decode_bench", ".cache"),
                                6)[0]
        print(name, "clip made", time.time() - t, flush=True)
        winmod.decode_clip(api, cl, 0, "cuda", None, winmod.Window())
        torch.cuda.synchronize()
        sites = collections.Counter()
        msgs = collections.Counter()

        def show(message, category, filename, lineno, file=None, line=None):
            st = traceback.extract_stack()[:-1]
            fr = [f for f in st if "vvdec_tpu_torch" in f.filename]
            key = " < ".join(f"{rel(f.filename)}:{f.lineno} {f.name}"
                             for f in fr[::-1][:4])
            sites[key] += 1
            msgs[str(message)[:80]] += 1

        old = warnings.showwarning
        warnings.showwarning = show
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                winmod.decode_clip(api, cl, 0, "cuda", None, winmod.Window())
            finally:
                torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = old
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=True) as prof:
            winmod.decode_clip(api, cl, 0, "cuda", None, winmod.Window())
            torch.cuda.synchronize()
        memcpy = collections.Counter()
        pageable = collections.Counter()
        for e in prof.events():
            if "Memcpy" in e.name or "Memset" in e.name:
                memcpy[e.name] += 1
            for k in getattr(e, "kernels", []) or []:
                kn = getattr(k, "name", str(k))
                if "Pageable" in kn:
                    st = [s for s in (e.stack or []) if "vvdec_tpu_torch" in s]
                    pageable[" < ".join(rel(s) for s in st[:3]) or e.name] += 1
        out[name] = {"pictures": len(cl.aus),
                     "sync_sites": sites.most_common(),
                     "messages": msgs.most_common(),
                     "memcpy_events": memcpy.most_common(),
                     "pageable_sites": pageable.most_common()}
        print(name, json.dumps(out[name], indent=1), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
