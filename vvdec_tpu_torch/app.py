"""CLI decoder app — the vvdecapp analog (source/App/vvdecapp/vvdecapp.cpp).

Options mirror the reference CLI (CmdLineParser.h:267-441): bitstream in,
YUV/Y4M out, frame-count limit, thread (worker) count, loops for
benchmarking, output-MD5 check, decoded-picture-hash verification, film
grain toggle, error-handling policy, verbosity, per-stream fps reporting.

A copy of vvdec_tpu/app.py with `--device {cuda,cpu}` (default cuda,
failing without a card) in place of `--jax`.  Run it as
`python -m vvdec_tpu_torch.app -b IN.266 -o OUT.yuv`.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time


def _y4m_header(w: int, h: int, bit_depth: int, chroma_idc: int,
                fps: tuple[int, int]) -> bytes:
    cf = {0: "mono", 1: "420", 2: "422", 3: "444"}[chroma_idc]
    if bit_depth > 8:
        cf += f"p{bit_depth}"
    return (f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip A0:0 C{cf}\n"
            .encode())


def weave_fields(frames: list) -> list:
    """Pair interlaced fields into woven frames, driven by the frame-field
    info SEI (vvdecapp.cpp interlaced pairing).  `frames` is a list of
    (planes, sei_list); returns a list of plane-lists."""
    import numpy as np

    from vvdec_tpu_torch.hls.sei import (SEI_FRAME_FIELD_INFO,
                                         parse_sei_payload)
    out = []
    pending = None  # (planes, bottom_first)
    for planes, seis in frames:
        ffi = next((parse_sei_payload(m) for m in seis
                    if m.payload_type == SEI_FRAME_FIELD_INFO), None)
        if ffi is None or not getattr(ffi, "field_pic_flag", False):
            out.append(planes)
            continue
        if pending is None:
            pending = (planes, ffi.bottom_field_flag)
            continue
        first, first_bottom = pending
        pending = None
        top, bot = (planes, first) if first_bottom else (first, planes)
        woven = []
        for t, b in zip(top, bot):
            fh, fw = t.shape
            full = np.empty((fh * 2, fw), dtype=t.dtype)
            full[0::2] = t
            full[1::2] = b
            woven.append(full)
        out.append(woven)
    if pending is not None:
        out.append(pending[0])  # unpaired trailing field
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="vvdec_tpu_torch",
        description="PyTorch/CUDA H.266/VVC decoder (vvdecapp analog)")
    ap.add_argument("-b", "--bitstream", required=True,
                    help="Annex-B .266 input file")
    ap.add_argument("-o", "--output", help="YUV output file ('-' = stdout)")
    ap.add_argument("--y4m", action="store_true", help="write Y4M container")
    ap.add_argument("-f", "--frames", type=int, default=-1,
                    help="max frames to decode")
    ap.add_argument("-t", "--threads", type=int, default=-1,
                    help="worker processes for GOP-parallel decode "
                         "(<=0: auto-detect hardware concurrency, as "
                         "the reference does, DecLib.cpp:121-133)")
    ap.add_argument("-L", "--loops", type=int, default=1,
                    help="decode loops for benchmarking")
    ap.add_argument("-md5", "--CheckYuvMD5", dest="md5",
                    help="expected MD5 of the uncropped output")
    ap.add_argument("-dph", "--SEIDecodedPictureHash", dest="dph",
                    action="store_true",
                    help="verify decoded-picture-hash SEIs (strict)")
    ap.add_argument("-fg", "--filmGrain", dest="fg", type=int, default=1,
                    help="film grain synthesis on output (default on)")
    ap.add_argument("-eh", "--errHandling", dest="eh", type=int, default=0,
                    help="0 = strict, 1 = try continue (conceal)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the reconstruction runs (default cuda)")
    ap.add_argument("-tf", "--TraceFile", dest="trace_file",
                    help="syntax trace output file")
    ap.add_argument("-tr", "--TraceRule", dest="trace_rule", default="",
                    help='trace rule, e.g. "D_PIC:poc==0"')
    ap.add_argument("--profile", action="store_true",
                    help="print the per-stage timing report: inclusive and "
                    "self ms a picture, calls, by picture type")
    ap.add_argument("-v", "--verbosity", type=int, default=2)
    args = ap.parse_args(argv)
    if args.threads <= 0:
        import os
        args.threads = os.cpu_count() or 1

    from vvdec_tpu_torch.utils.trace import (profiler, set_log_level,
                                             set_tracing)
    set_log_level(args.verbosity)
    if args.trace_file:
        set_tracing(args.trace_file, args.trace_rule)
    if args.profile:
        profiler.enabled = True

    data = open(args.bitstream, "rb").read()

    from vvdec_tpu_torch.api import Decoder, DecoderParams
    params = DecoderParams(
        threads=args.threads,
        verify_picture_hash=args.dph,
        film_grain_synthesis=bool(args.fg),
        device=args.device,
        err_handling="conceal" if args.eh else "strict")

    total_frames = 0
    dt = 0.0
    md5 = hashlib.md5()
    out_f = None
    if args.output == "-":
        out_f = sys.stdout.buffer
    elif args.output:
        out_f = open(args.output, "wb")

    try:
        for loop in range(max(1, args.loops)):
            t0 = time.monotonic()
            if args.threads > 1 and not (args.dph or args.fg or args.eh):
                # GOP-segment worker pool; each worker also runs the
                # recon-while-parse threads (the per-frame SEI paths
                # need the in-process decoder below)
                from vvdec_tpu_torch.parallel import decode_annexb_parallel
                all_planes = decode_annexb_parallel(
                    data, workers=args.threads, device=args.device,
                    threads=min(args.threads, 2))
                frames = None
            else:
                dec = Decoder(params)
                frames = dec.decode(data) + dec.flush()
                if any(m.payload_type == 168  # frame-field info SEI
                       for f in frames for m in f.sei):
                    all_planes = weave_fields(
                        [(f.planes, f.sei) for f in frames])
                    frames = None  # woven output: plain plane lists
                else:
                    all_planes = [f.planes for f in frames]
            dt += time.monotonic() - t0
            if args.frames >= 0:
                all_planes = all_planes[:args.frames]
            for i, planes in enumerate(all_planes):
                total_frames += 1
                fr = frames[i] if frames else None
                if loop == 0:
                    if out_f is not None and args.y4m and i == 0:
                        bd = fr.bit_depth if fr else 10
                        cf = fr.chroma_format_idc if fr else 1
                        h, w = planes[0].shape
                        out_f.write(_y4m_header(w, h, bd, cf, (50, 1)))
                    if out_f is not None and args.y4m:
                        out_f.write(b"FRAME\n")
                    for p in planes:
                        bd = fr.bit_depth if fr else 10
                        raw = p.astype("u1" if bd == 8 else "<u2").tobytes()
                        if out_f is not None:
                            out_f.write(raw)
                        md5.update(raw)
                if fr is not None:
                    dec.frame_unref(fr)
    finally:
        if out_f is not None and out_f is not sys.stdout.buffer:
            out_f.close()

    if args.profile:
        profiler.enabled = False     # resolves the device stages' times
        print(profiler.report(), file=sys.stderr)
        from vvdec_tpu_torch.ops.cuda._build import setup_counts as k
        print(f"kernel set-up: {k['builds']} builds ({k['build_s']:.3f} s),"
              f" {k['loads']} loads ({k['load_s']:.3f} s); host C:"
              f" {k['host_builds']} builds ({k['host_build_s']:.3f} s),"
              f" {k['host_loads']} loads ({k['host_load_s']:.3f} s)",
              file=sys.stderr)
    fps = total_frames / dt if dt > 0 else 0.0
    if args.verbosity >= 2:
        print(f"vvdec_tpu_torch: {total_frames} frames decoded in "
              f"{dt:.3f}s ({fps:.2f} fps)", file=sys.stderr)
    if args.md5:
        got = md5.hexdigest()
        if got != args.md5.lower():
            print(f"MD5 mismatch: expected {args.md5}, got {got}",
                  file=sys.stderr)
            return 1
        if args.verbosity >= 2:
            print(f"MD5 check OK: {got}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
