#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vvdec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]

Phases; any failure ends the run with a non-zero exit code and no
result line:

1. the card: torch / CUDA versions and the card's name and power limit;
2. the build: nvcc compiles every kernel of the decode path from
   vvdec_tpu_torch/csrc/ into build/kernels/ (itx.cu, intra_wavefront.cu,
   deblock.cu and sao_alf.cu, one nvcc each, started together), and prints each
   kernel's registers and spills as -Xptxas -v reports them;
3. each kernel against its plain PyTorch version on the card, bit-equal,
   with its time, the plain version's time and its bound per shape,
   through the one-group wrapper itx_batch_cuda; the deblock kernel
   (deblock_dense_cuda) against deblock_dense_ref on fuzzed grids with
   overlapping write windows at 832x480 and 1920x1080 4:2:0 (also with
   a frame axis of 3 pictures), 4:0:0, 4:2:2 and 4:4:4, 8 and 10 bits,
   one and two slices, each with its device time, the plain version's
   and the bound; the SAO/ALF kernels (sao_alf_cuda) against
   sao_alf_ref on fuzzed planes and parameters at 832x480 (also with a
   frame axis of 3 pictures) and 1920x1080 4:2:0, 4:0:0, 4:2:2 and
   4:4:4, 8 and 10 bits, CTU 32, 64 and 128, each with each kernel's
   device time, the plain version's and the bound;
4. the main path: the headline all-intra 832x480 Main10 stream (8
   frames, made by the port's own test encoder) decoded through
   vvdec_tpu_torch.decoder.decode_annexb on CUDA; the ITX kernel must be
   launched exactly once per decoded frame (itx_frame_cuda) and the
   decoded YUV must have the MD5 the CPU tests pin to the reference
   decoder, and the intra wavefront kernel launched once per picture
   with intra units (intra_wavefront_cuda, in every timed decode of
   phases 4-8, 10 and 13); then the ITX kernel is held to its plain
   version, and timed, on every frame's inputs as the main path gave
   them, the per-shape table is redone from one-group launches of those
   frames' TUs, the stage split of a profiled decode is printed with the
   intra steps a frame by mode class, and the intra wavefront kernel is
   held to intra_wavefront_ref on every frame's recorded inputs (the
   planes before the scan, residuals, step batches and step levels, LMCS
   table), with per picture the kernel's device time and us a phase, its
   empty-phase floor (the same phases with every unit masked), the plain
   version's (frame 0), the bound, the steps, the dependency levels and
   the phases; frame 0 also runs at every cluster size (1, 2, 4, 8, 16),
   each bit-equal, with its time and floor.  The deblock kernel
   (deblock_dense_cuda, two launches per picture the device filters:
   checked in every timed decode of phases 4-8 and 13) is held to
   deblock_dense_ref on every recorded picture's pre-deblock planes of
   phases 4-8 and 13, and timed per headline frame (and per 1080p frame
   in phase 13);
5. intra LMCS: the intra LMCS stream (chroma residual scaling; 2
   frames, 832x480, made by the port's own test encoder,
   vvdec_tpu_torch/streams.py): a warm-up decode that records the ITX
   kernel's inputs, a timed decode (one ITX launch per frame, the MD5
   the CPU tests pin to the reference decoder) and a profiled decode
   with its stage split; the kernel is held to its plain version on
   every recorded frame, and the intra wavefront kernel to its plain
   version on the first picture (as in phases 6-8: the first picture
   with intra units of every stream);
6. inter pictures: the inter-LD stream (bench.py "inter-LD 832x480": an
   IDR and 11 low-delay P pictures) and the inter-LDB tools stream (an
   IDR and 5 low-delay B pictures with affine + PROF, SbTMVP, MMVD, GPM,
   CIIP, BCW, AMVR), each decoded as in phase 5 (recording, timed with
   one ITX launch per frame and the pinned MD5, profiled: the stage split
   now has "motion (host)", the MC stages "mc: ..." and the CIIP steps);
   the ITX kernel is held to its plain version on every recorded frame
   and timed on the inter-LD frames;
7. random access: the RA stream (a hierarchical-B GOP of 5 pictures
   with DMVR, BDOF, TMVP, MMVD, AMVR, BCW, affine + PROF and SbTMVP),
   decoded as in phase 5 with an empty fallback census; the profiled
   decode's stage split shows "mc: DMVR" and "mc: BDOF", and the DMVR
   and BDOF CUs and subblocks per B picture are printed;
8. the host reconstruction: the inter-LMCS stream (an IDR and two B
   pictures with LMCS), whose B pictures the device pipeline rejects:
   the pinned MD5 and the exact pinned fallback census, one ITX launch
   per device picture and none per host picture, and the host stages
   ("recon", "filter(submit)") beside the device ones;
9. the device's busy share over a one-frame decode (headline), and over
   the second picture, a P picture, of the inter-LD stream, from
   torch.profiler;
10. the public surface: (a) api.Decoder on CUDA fed access unit by
   access unit, the headline stream with threads 0, 2 and the
   inter-LD stream with threads 3, each with its pinned MD5, an empty
   census and one ITX launch per frame, printing frames/s and the
   first-frame delay (from a new decoder's first decode() to the first
   Frame it hands out); (b) err_handling="conceal" over the concealment
   cases of streams.CONCEAL_CASES (a lost P picture, a broken slice,
   four cuts of the inter-LD stream), each on its pins, with one ITX
   launch per picture not grey-filled, then the headline's first frame
   on its pin to show the CUDA context survived; (c) the vvdecapp CLI,
   `python -m vvdec_tpu_torch.app -b headline.266 -o ... -t 1 -md5 ...`,
   in a subprocess, at rc 0; (d) decode_annexb_parallel with a pool of 2
   spawned workers over the headline stream against serial decodes in
   alternating order, each on HEADLINE_MD5, with the workers' ITX
   launches, their CUDA caching allocators' peaks and the card's used
   memory before and while the pool is up.  The ITX kernel is held to
   its plain version on every frame (a) and (b) record;
11. the multi-device path, every mesh device cuda:0 (the machine has
   one card): (a) the SAO/ALF stream's first 2 pictures over a
   ("frame", "row") = (2, 2) mesh and its first picture over a ("row",)
   = 4 mesh (480 rows padded to 512), each bit-equal to the whole-frame
   chain; (b) filter_frames_device_batch over its 4 pictures, bit-equal
   to the per-frame chain, with the batch's device kernels beside 4x
   one picture's; (c) the device-resident DPB: the inter-LD stream's
   first 4 pictures round robin over 4 mesh devices, bit-equal to the
   per-frame decode; (d) the sequential intra scan of the headline's
   first 2 pictures through frame_parallel over the frame axis,
   bit-equal to the wavefront, with units per frame and ms per unit;
   (e) decode_annexb_multihost in 2 spawned gloo ranks (file store) on
   the card over the headline stream, on HEADLINE_MD5, with each rank's
   card memory.  Every device picture of (a)-(d) makes one ITX launch,
   held to the plain version; (a) deblocks every band through
   deblock_dense_cuda, (b) its 4 stacked pictures in one call of 2
   launches, and one call of 2 SAO/ALF launches;
12. the whole-frame stages of vvdec_tpu_torch/ops/pipeline.py: the first
   picture of the headline, tool-rich and SAO/ALF streams, and both
   pictures of the vb and tiles-ALF streams (virtual boundaries; a 2x2
   tile grid of four
   slices with loop filtering across them off, so ALF clamp windows and
   per-slice deblocking offsets; the dense chain rejects both), each
   through reconstruct_frame_torch, sao_frame_torch and alf_frame_torch
   on the card and bit-equal to the vendored host golden on the same
   parsed picture; every plain 2-D TU group without a scaling list is one
   itx_batch_cuda launch, held to itx_batch_ref.  Per picture and stage
   it prints host wall and CUDA-event ms, the ITX groups by route and
   the deblocking cells per direction;
13. bench configurations: every configuration of bench.py that the
   earlier phases leave out, made by three spawned background processes
   while phase 3 runs (phase 4 waits for them): dense q27 (8 frames)
   and max-density q22 (6 frames; QP 22, the heaviest residual load of
   the test encoder) at 832x480, all 8 frames of tool-rich and SAO/ALF
   (whose first 4 frames must also give the 4-frame streams' pins,
   TOOL_RICH_MD5 and SAO_ALF_MD5; phases 11 and 12 take those 4-frame
   streams from them), SAO/ALF 1920x1080 (4 frames) and inter-LD
   1920x1080 (an IDR and 5 P pictures).  Per stream its size and build
   time, then one decode: a StreamDecoder with the stage profiler on,
   which records the ITX kernel's inputs in host memory and must give
   the pinned MD5, an empty fallback census and one itx_frame_cuda
   launch per frame; it prints
   the stage split, intra steps a frame, frames/s and the card's peak
   allocated memory.  The ITX kernel is held to its plain version on
   every recorded frame, the intra wavefront kernel on the first picture
   and on every 1080p IDR picture (the first SAO/ALF 1080p one also at
   every cluster size), the deblock kernel on every picture (and timed
   per 1080p frame), the SAO/ALF kernels (two launches a picture) on
   every picture of the SAO/ALF streams (and timed per frame); on the
   max-density and 1080p frames
   the ITX kernel prints per
   frame the kernel's device ms (torch.profiler, as for the headline,
   over a trace of 300 launches of the frame: short traces lose most of
   their events), the wrapper calls' ms, the bound and the TU count.

Every timed decode also checks the decoder's fallback census: empty on
every stream but inter-LMCS and the concealment cases' grey pictures.
The background builders are shut down before the script exits, also
when a phase fails.

Each phase prints its wall time.  The last three lines of standard
output are the kernels' JSON summary, the card's name and power limit,
and {"ok": true, "device": ...}.  The summary has two entries for the
ITX kernel, one per entry point, and one for the intra wavefront.  In
the itx_frame entry, launches counts the ITX launches of the timed decodes of phases 4-8 and 13 and of phase 10's
and 11's in-process decodes (not those of the CLI's, the pool's or the
ranks' processes),
and max_abs_err covers every comparison of the kernel with its plain
version; ms,
plain_ms and bound_ms are per decoded frame of the headline stream: ms
is the kernel's device time and plain_ms the plain version's,
both read from torch.profiler; call_ms is the wrapper calls' stream time
by CUDA events, which adds the host's cost between launches.  bound_ms
counts int16 levels in and int32 residuals out, the work table and the
matrices, and the hi/lo split's two int8 products at the int8
tensor-core peak; the int32-level, float32-peak bound of the first port
is printed beside it.  In the itx_batch entry, launches counts phase
12's itx_batch_cuda launches (the comparisons of phases 3 and 4 are not
counted), max_abs_err covers phases 3 and 12, and ms, plain_ms,
call_ms and bound_ms (int32 levels in) are per frame of phase 12's
headline picture, summed over the frame's group launches.  In the
intra_wavefront entry, launches counts the intra_wavefront_cuda launches
of the timed decodes of phases 4-8 and 13 and of phase 10's decodes,
max_abs_err covers every comparison with intra_wavefront_ref, and ms,
plain_ms and bound_ms are the headline's first picture's: the kernel's
device time (torch.profiler, 100 launches), the plain version's (one
run) and the bytes it must move (wavefront_work) over HBM_BYTES_PER_S;
floor_ms is its empty-phase floor's device time and phases its phases.
In the deblock entry, launches counts the deblock_dense_cuda launches of
the timed decodes of phases 4-8 and 13, max_abs_err covers phase 3's
cases and every recorded picture, and ms, plain_ms, call_ms and bound_ms
are per headline frame: the kernel's device time (torch.profiler over
TRACE_LAUNCHES launches), the plain version's (its kernels in one traced
run), the wrapper calls' stream time (CUDA events) and the bytes of
reading each input once and writing each plane once over
HBM_BYTES_PER_S (bound_two_pass_ms: each plane read and written once
per direction).  In the sao_alf entry, launches counts the sao_alf_cuda
launches of the timed decodes of phases 4-8 and 13 and of phase 11's
batched chain, max_abs_err covers phase 3's cases and every recorded
picture, and ms (sao_ms + alf_ms), plain_ms, call_ms and bound_ms are
per picture of the 832x480 "SAO/ALF 8" stream, measured as the deblock's
(bound_two_launch_ms also writes and reads the post-SAO planes).
Needs a CUDA device; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# dense int8 tensor-core peak (2 ops per multiply-add): the kernel's
# products are the hi/lo split's two int8 products
PEAK_INT8_OPS_PER_S = 1979e12
# the card's peak outside the tensor cores (float32), which bounded the
# first port's int32 products; printed beside the int8 bound
PEAK_F32_OPS_PER_S = 67e12
TABLE_ROW_BYTES = 40        # one TU row of the work table (10 int32)
BIT_DEPTH = 10
# the sources of csrc/ the decode path runs, built in phase 2
KERNELS = ("itx", "intra_wavefront", "deblock", "sao_alf")


class SmokeFailure(Exception):
    pass


def fail_unless(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int, match: str | None = None,
              launches: int | None = None) -> float:
    """Device ms per fn() call, from torch.profiler over reps calls after
    one warm call: the summed durations of the device kernels fn()
    launches, or only of those whose name contains `match`.  Unlike
    cuda_ms it leaves out the host's time between launches.  With
    `launches` (the matching kernels one call launches), the result is
    their mean duration times `launches`, which stays right when the
    trace drops an event.  A trace that holds no matching kernel, or
    fewer than half of `launches`, is taken again, up to three times in
    all: the tracer loses events, up to 17 of 40 in one trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    what = "device kernel" + ("" if match is None else f" named {match}")
    want = None if launches is None else reps * launches
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and (match is None or match in e.name)]
        if spans and (want is None or len(spans) >= 0.5 * want):
            break
        print(f"[profile] the trace holds {len(spans)} {what} launches"
              f"{'' if want is None else f' of {want}'}; taking it again")
    else:
        raise SmokeFailure(f"torch.profiler lost the {what} launches in "
                           f"three traces")
    if want is None:
        return sum(spans) / 1e3 / reps
    if len(spans) != want:
        print(f"[profile] the trace holds {len(spans)} of {want} {what} "
              f"launches")
    return sum(spans) / len(spans) / 1e3 * launches


def trace_device_ms(fn) -> float:
    """Device ms of one fn() call: the summed durations of the device
    kernels and copies in a torch.profiler trace of CUDA activity alone,
    read from the raw kineto events.  For calls of ~10^5 small kernels
    (the intra wavefront's plain version), where turning the trace into
    FunctionEvents (device_ms) takes longer than the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA)
    fail_unless(ns > 0, "torch.profiler recorded no device activity")
    return ns / 1e6


def itx_work(n: int, h: int, w: int, level_bytes: int = 2
             ) -> tuple[int, int, int, int]:
    """(bytes, int8 operations, first-port bytes, first-port operations)
    of n TUs of h x w.  Bytes: levels in (level_bytes each), int32
    residuals out, one table row per TU, both matrices as s8; operations:
    two int8 products (hi and lo) of 2 ops per multiply-add, h + w
    multiply-adds per coefficient.  The first port's count: int32 levels,
    three int32 per-TU scalars, int32 matrices, one int32 product."""
    coefs = n * h * w
    macs = coefs * (h + w)
    return (coefs * (level_bytes + 4) + TABLE_ROW_BYTES * n + h * h + w * w,
            2 * 2 * macs,
            coefs * 8 + 12 * n + 4 * (h * h + w * w),
            2 * macs)


def bound_ms(nbytes: float, ops: float, peak: float = PEAK_INT8_OPS_PER_S
             ) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def frame_work(rows) -> tuple[int, int, int, int]:
    """itx_work summed over a work table's TU rows (numpy [N, 10]), the
    matrices counted once per distinct matrix."""
    import numpy as np
    coefs = (1 << (rows[:, 3] + rows[:, 4])).astype(np.int64)
    macs = int((coefs * ((1 << rows[:, 3]) + (1 << rows[:, 4]))).sum())
    mats = {(int(o), 1 << int(lg)) for o, lg in
            np.concatenate([rows[:, [5, 3]], rows[:, [6, 4]]])}
    mat = sum(n * n for _, n in mats)
    return (int(coefs.sum()) * 6 + TABLE_ROW_BYTES * len(rows) + mat,
            4 * macs, int(coefs.sum()) * 8 + 12 * len(rows) + 4 * mat,
            2 * macs)


def phase_card() -> str:
    import torch
    print(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    fail_unless(r.returncode == 0 and r.stdout.strip(),
                f"nvidia-smi failed: {r.stderr.strip()}")
    card = r.stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch sees {torch.cuda.device_count()} x "
          f"{torch.cuda.get_device_name(0)}")
    return card


def phase_build() -> None:
    """Every kernel of the decode path, one nvcc each, all started
    together; then each library is loaded."""
    import concurrent.futures

    from vvdec_tpu_torch.ops.cuda._build import (build_kernel, build_log,
                                                 library_path, load_kernel)

    def build(name):
        cached = os.path.exists(library_path(name))
        t0 = time.perf_counter()
        build_kernel(name)
        return cached, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as ex:
        done = dict(zip(KERNELS, ex.map(build, KERNELS)))
    for name, (cached, dt) in done.items():
        load_kernel(name)
        print(f"[build] csrc/{name}.cu -> "
              f"{os.path.relpath(library_path(name))} "
              f"{'(already built) ' if cached else ''}in {dt:.2f} s")
        # ptxas -v: each kernel's registers, stack and spills
        for line in build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {name}: {line.strip()}")
    print(f"[build] {len(KERNELS)} kernels in "
          f"{time.perf_counter() - t0:.2f} s")


def _itx_inputs(h, w, n, hor, ver, dep_quant, seed, extreme=False):
    import numpy as np
    import torch

    from vvdec_tpu_torch.ops.cuda.itx import dequant_params
    from vvdec_tpu_torch.ops.tables import tr_matrix
    rng = np.random.default_rng(seed)
    lo, hi = (-32768, 32768) if extreme else (-1024, 1024)
    levels = rng.integers(lo, hi, size=(n, h, w)).astype(np.int32)
    if extreme:
        levels[:, 0, 0] = -32768
        levels[:, -1, -1] = 32767
    levels[rng.random((n, h, w)) < 0.3] = 0
    qp = rng.integers(1, 69, size=(n,)).astype(np.int32)
    arrays = (levels,) + tuple(dequant_params(qp, w, h, BIT_DEPTH,
                                              dep_quant)) \
        + (np.asarray(tr_matrix(ver, h), np.int32),
           np.asarray(tr_matrix(hor, w), np.int32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in arrays)


def phase_kernel_vs_plain(errs: list) -> None:
    """Every tests/test_pallas.py case (8 shapes, the transform pairs it
    allows, dep_quant on and off, all-zero levels), the 2-row and
    2-column shapes, N = 17 and N = 4096, levels at +-32768."""
    import torch

    from vvdec_tpu_torch.ops.cuda.itx import itx_batch_cuda, itx_batch_ref
    kinds = [("DCT2", "DCT2"), ("DST7", "DST7"), ("DCT8", "DST7"),
             ("DST7", "DCT8")]
    shapes = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 16), (32, 8), (64, 64),
              (8, 32), (2, 8), (2, 16), (2, 32), (8, 2), (16, 2), (32, 2)]
    print(f"[kernel] itx_batch_cuda vs itx_batch_ref, bit-equal; ms per call "
          f"at N=4096 DCT2: device time of itx_kernel and of the plain "
          f"version's kernels (torch.profiler), and each call's stream "
          f"time with the host's launch cost (CUDA events)")
    print(f"[kernel] bound_ms: int32 levels (this wrapper's input), int8 "
          f"tensor-core peak; bound_i32: the first port's count")
    print(f"[kernel] {'h x w':>7} {'ms':>9} {'plain_ms':>9} {'bound_ms':>9} "
          f"{'bound_i32':>9} {'call_ms':>9} {'plain_call':>10} bound_by")
    n_cases = 0
    for h, w in shapes:
        for hor, ver in kinds:
            if (hor, ver) != ("DCT2", "DCT2") \
                    and not (4 <= h <= 32 and 4 <= w <= 32):
                continue
            for dep_quant in (False, True):
                for n in (17, 4096):
                    for extreme in (False, True):
                        args = _itx_inputs(h, w, n, hor, ver, dep_quant,
                                           seed=n_cases, extreme=extreme)
                        got = itx_batch_cuda(*args, h=h, w=w,
                                             bit_depth=BIT_DEPTH)
                        want = itx_batch_ref(*args, h=h, w=w,
                                             bit_depth=BIT_DEPTH)
                        torch.cuda.synchronize()
                        err = int((got - want).abs().max())
                        errs.append(err)
                        fail_unless(err == 0, f"itx {h}x{w} {hor}/{ver} "
                                    f"dq={dep_quant} N={n}: max |err| {err}")
                        n_cases += 1
        zero = list(_itx_inputs(h, w, 3, "DCT2", "DCT2", False, seed=1))
        zero[0] = torch.zeros_like(zero[0])
        out = itx_batch_cuda(*zero, h=h, w=w, bit_depth=BIT_DEPTH)
        fail_unless(not bool(out.any()), f"itx {h}x{w}: zero levels gave "
                    f"a non-zero residual")
        args = _itx_inputs(h, w, 4096, "DCT2", "DCT2", True, seed=7)

        def run_kernel():
            itx_batch_cuda(*args, h=h, w=w, bit_depth=BIT_DEPTH)

        def run_plain():
            itx_batch_ref(*args, h=h, w=w, bit_depth=BIT_DEPTH)

        k_ms = device_ms(run_kernel, 20, "itx_kernel", launches=1)
        p_ms = device_ms(run_plain, 3)
        kc_ms = cuda_ms(run_kernel, 20)
        pc_ms = cuda_ms(run_plain, 3)
        nb, ops, nb1, ops1 = itx_work(4096, h, w, level_bytes=4)
        b_ms, by = bound_ms(nb, ops)
        b1_ms = bound_ms(nb1, ops1, PEAK_F32_OPS_PER_S)[0]
        print(f"[kernel] {h:>3} x{w:>3} {k_ms:9.4f} {p_ms:9.4f} {b_ms:9.5f} "
              f"{b1_ms:9.5f} {kc_ms:9.4f} {pc_ms:10.4f} {by}")
    print(f"[kernel] {n_cases} cases bit-equal, all-zero levels give 0")


def yuv_md5(frames) -> str:
    return hashlib.md5(b"".join(p.astype("<u2", copy=False).tobytes()
                                for f in frames for p in f)).hexdigest()


# the streams the phases built, by name of vvdec_tpu_torch.streams.STREAMS,
# for the later phases that decode them again
BUILT: dict = {}
# phase 13's streams as the background builders make them, by name: a
# future of build_stream(name) (start_bench_builds)
BACKGROUND: dict = {}


def built(name: str) -> bytes:
    """The stream `name` of streams.STREAMS, built once per run; a stream
    of streams.PREFIXES is the first pictures of its longer stream from
    the background builders."""
    from vvdec_tpu_torch.parallel.dryrun import first_pictures
    from vvdec_tpu_torch.streams import PREFIXES, STREAMS
    if name not in BUILT:
        if name in BACKGROUND:
            BUILT[name] = BACKGROUND[name].result()[0]
        elif PREFIXES.get(name) in BACKGROUND:
            BUILT[name] = first_pictures(built(PREFIXES[name]),
                                         STREAMS[name][1])
        else:
            BUILT[name] = STREAMS[name][0]()
    return BUILT[name]


def itx_recorder(recorded: list, host: bool = False):
    """A stand-in for frame_device.itx_frame_cuda that appends each
    call's inputs to `recorded` as the decode gives them (the residual
    planes as they were before the call), then runs the wrapper.  With
    `host`, the copies go to host memory (the copy waits for the
    stream), so that they add nothing to the card's memory."""
    from vvdec_tpu_torch.ops.cuda.itx import itx_frame_cuda

    def keep(t):
        return t.cpu() if host else t.clone()

    def recorder(coef, resi, table, pool, *, n_tasks, bit_depth):
        recorded.append(dict(
            coef=[None if c is None else keep(c) for c in coef],
            resi=[keep(r) for r in resi], table=keep(table),
            n_tasks=n_tasks, bit_depth=bit_depth))
        return itx_frame_cuda(coef, resi, table, pool, n_tasks=n_tasks,
                              bit_depth=bit_depth)
    return recorder


def on_card(rec: dict) -> dict:
    """A recorded call (itx_recorder) with its tensors on the card."""
    return dict(rec, coef=[None if c is None else c.cuda()
                           for c in rec["coef"]],
                resi=[r.cuda() for r in rec["resi"]],
                table=rec["table"].cuda())


@contextlib.contextmanager
def itx_recording(recorded: list, host: bool = False, census=None,
                  refined=None):
    """While open, every itx_frame_cuda call's inputs are appended to
    `recorded` (itx_recorder); with `census` (a dict), the TUs of the
    PyTorch residual paths are counted in it; with `refined` (a list),
    per picture with DMVR or BDOF CUs (POC, DMVR CUs, DMVR subblocks,
    BDOF CUs, BDOF regions) is appended to it.  Everything is put back on
    exit."""
    import vvdec_tpu_torch.ops.frame_device as frame_device
    import vvdec_tpu_torch.ops.pipeline as pipeline
    from vvdec_tpu_torch.ops.cuda.itx import itx_frame_cuda

    def counting(name, factory):
        def make(*args, **kw):
            fn = factory(*args, **kw)

            def run(levels, *rest):
                census[name] += levels.shape[0]
                return fn(levels, *rest)
            return run
        return make

    saved = (pipeline._ts_fn, pipeline._itx_lfnst_fn, pipeline._itx_fn)
    plan_refinement = frame_device.McFrame.plan_refinement

    def counting_plan(mf):
        plan_refinement(mf)
        refined.append((mf.cs.sh.poc, len(mf.dmvr),
                        sum(p.n for p in mf.dmvr_plans), len(mf.bdof),
                        sum(p.n for p in mf.bdof_plans)))

    frame_device.itx_frame_cuda = itx_recorder(recorded, host)
    if refined is not None:
        frame_device.McFrame.plan_refinement = counting_plan
    if census is not None:
        pipeline._ts_fn = counting("transform skip", saved[0])
        pipeline._itx_lfnst_fn = counting("lfnst", saved[1])
        pipeline._itx_fn = counting("scaling list", saved[2])
    try:
        yield recorded
    finally:
        frame_device.itx_frame_cuda = itx_frame_cuda
        frame_device.McFrame.plan_refinement = plan_refinement
        pipeline._ts_fn, pipeline._itx_lfnst_fn, pipeline._itx_fn = saved


def recording_decode(stream: bytes, label: str, census=None,
                     refined=None, wavefront=None, deblock=None) -> list:
    """One decode on CUDA inside itx_recording(census=, refined=) and,
    with `wavefront` (a WavefrontLog), wavefront_recording, with
    `deblock` (a DeblockLog), deblock_recording.  Returns the recorded
    ITX calls."""
    import torch

    from vvdec_tpu_torch.decoder import decode_annexb
    recorded: list = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(itx_recording(recorded, census=census,
                                          refined=refined))
        if wavefront is not None:
            stack.enter_context(wavefront_recording(wavefront))
        if deblock is not None:
            stack.enter_context(deblock_recording(deblock))
        t0 = time.perf_counter()
        decode_annexb(stream)
        torch.cuda.synchronize()
        print(f"[{label}] warm-up decode {time.perf_counter() - t0:.2f} s")
    return recorded


def timed_decode(stream: bytes, n_frames: int, md5_pin: str,
                 label: str, census=None, device_frames=None,
                 size=(832, 480), recorded=None, prefix=None,
                 profile=False, wavefront=None, deblock=None,
                 sao_alf=None) -> dict:
    """The path as a user drives it: a StreamDecoder on CUDA fed the
    whole stream, then flushed (what decode_annexb does), with the
    kernels' launch counts set to 0 just before and read just after.
    Fails unless the YUV has its pinned MD5, the pictures are `size`
    (width, height) 4:2:0, the decoder's fallback census equals `census`
    (default: empty, every picture on the device), the ITX kernel was
    launched once per device picture (`device_frames`, default every
    frame), the intra wavefront kernel once per picture whose scan
    has a step, at least once, and the deblock kernel twice per picture,
    every picture being filtered on the device (its calls go through
    `deblock`, a DeblockLog, default one that keeps no inputs), and the
    SAO/ALF kernels at most twice per picture whose SAO or ALF is on
    (its calls go through `sao_alf`, a SaoAlfLog, likewise).  The wavefront calls go through
    `wavefront` (a WavefrontLog, default one that keeps no inputs), which
    counts their steps by mode class.  With `recorded` (a list) the
    decode also records each
    itx_frame_cuda call's inputs there, in host memory (itx_recording);
    with `prefix` (n, pin) the YUV of the first n frames must have the
    MD5 `pin` (the pin of the stream's first n pictures alone: a picture
    depends on none that follows); with `profile` the stage profiler is
    on and the result holds the stage split (stage_split): each device
    stage's time runs to the end of its device work (CUDA events)."""
    import torch

    from vvdec_tpu_torch.decoder import StreamDecoder
    from vvdec_tpu_torch.ops.cuda.intra import intra_wavefront_cuda
    from vvdec_tpu_torch.ops.cuda.itx import itx_batch_cuda, itx_frame_cuda
    from vvdec_tpu_torch.utils.trace import profiler
    census = census or {}
    device_frames = n_frames if device_frames is None else device_frames
    from vvdec_tpu_torch.ops.cuda.deblock import deblock_dense_cuda
    from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda
    log = WavefrontLog() if wavefront is None else wavefront
    dlog = DeblockLog() if deblock is None else deblock
    slog = SaoAlfLog() if sao_alf is None else sao_alf
    profiler.reset()
    profiler.enabled = profile
    try:
        with contextlib.ExitStack() as stack:
            if recorded is not None:
                stack.enter_context(itx_recording(recorded, host=True))
            stack.enter_context(wavefront_recording(log))
            stack.enter_context(deblock_recording(dlog))
            stack.enter_context(sao_alf_recording(slog))
            itx_frame_cuda.launches = 0
            itx_batch_cuda.launches = 0
            intra_wavefront_cuda.launches = 0
            deblock_dense_cuda.launches = 0
            sao_alf_cuda.launches = 0
            t0 = time.perf_counter()
            dec = StreamDecoder()
            frames = [p.planes for p in dec.push(stream) + dec.flush()]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = itx_frame_cuda.launches
            batch_launches = itx_batch_cuda.launches
            intra_launches = intra_wavefront_cuda.launches
            deblock_launches = deblock_dense_cuda.launches
            sao_alf_launches = sao_alf_cuda.launches
    finally:
        profiler.enabled = False
    md5 = yuv_md5(frames)
    got = dict(dec.fallback_census)
    print(f"[{label}] StreamDecoder on cuda{' (profiled)' if profile else ''}"
          f": {len(frames)} frames in {dt:.3f} s = {len(frames) / dt:.2f} "
          f"frames/s; itx launches {launches} (itx_batch_cuda "
          f"{batch_launches}); intra_wavefront launches {intra_launches} "
          f"for {log.pictures} pictures with intra units; deblock launches "
          f"{deblock_launches} for {dlog.pictures} pictures; SAO/ALF "
          f"launches {sao_alf_launches} for {slog.pictures} pictures; md5 "
          f"{md5}; "
          f"fallback census {got}")
    fail_unless(len(frames) == n_frames, f"{label}: {len(frames)} frames "
                f"decoded, expected {n_frames}")
    w, h = size
    fail_unless(all(f[0].shape == (h, w) and f[1].shape == (h // 2, w // 2)
                    for f in frames), f"{label}: unexpected plane shapes")
    if prefix is not None:
        n, pin = prefix
        got_prefix = yuv_md5(frames[:n])
        print(f"[{label}] its first {n} frames: md5 {got_prefix}")
        fail_unless(got_prefix == pin, f"{label}: the first {n} frames' md5 "
                    f"{got_prefix} != pinned {pin}")
    fail_unless(launches == device_frames, f"{label}: {launches} ITX kernel "
                f"launches for {device_frames} pictures decoded on the "
                f"device")
    fail_unless(intra_launches == log.pictures and intra_launches > 0,
                f"{label}: {intra_launches} intra_wavefront kernel launches "
                f"for {log.pictures} pictures with intra units")
    fail_unless(deblock_launches == 2 * dlog.pictures == 2 * n_frames,
                f"{label}: {deblock_launches} deblock kernel launches for "
                f"{dlog.pictures} deblocked pictures of {n_frames}")
    fail_unless(sao_alf_launches <= 2 * slog.pictures <= 2 * n_frames,
                f"{label}: {sao_alf_launches} SAO/ALF kernel launches for "
                f"{slog.pictures} pictures with SAO or ALF of {n_frames}")
    fail_unless(md5 == md5_pin, f"{label}: decoded YUV md5 {md5} != pinned "
                f"{md5_pin}")
    fail_unless(got == census, f"{label}: fallback census {got} != "
                f"{census}")
    out = dict(fps=len(frames) / dt, decode_s=dt, launches=launches,
               intra_launches=intra_launches,
               deblock_launches=deblock_launches,
               sao_alf_launches=sao_alf_launches,
               sao_alf_pictures=slog.pictures, md5=md5, census=got,
               intra_steps_by_class=log.steps_by_class(n_frames))
    if profile:
        out["stages_ms_per_frame"] = stage_split(n_frames, dt, label, log)
    return out


def stage_split(n_frames: int, seconds: float, label: str,
                log: WavefrontLog) -> dict:
    """The profiler's totals of a decode of n_frames that took `seconds`,
    printed and returned as ms per frame by stage, with the filter and
    MC stages in all, the intra wavefront's steps a frame by mode class
    (from `log`) and the frames/s."""
    from vvdec_tpu_torch.utils.trace import profiler
    stages = {k: v / n_frames * 1e3 for k, v in profiler.totals.items()}
    fps = n_frames / seconds
    print(f"[{label}] profiled decode {seconds:.3f} s = {fps:.2f} frames/s;"
          f" stage ms per frame (with device work):")
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"[{label}]   {k:<26} {v:9.3f} ms in {profiler.counts[k]} "
              f"calls")
    steps = log.steps_by_class(n_frames)
    print(f"[{label}]   intra steps a frame by class: "
          + ", ".join(f"{k} {v:.1f}" for k, v in steps.items())
          + f"; in all {sum(steps.values()):.1f}")
    stages["intra steps by class"] = steps
    # the device filter chain in all (what earlier runs called
    # filter+pack) and the MC stage in all
    for prefix, key in (("filter: ", "filter (all)"), ("mc: ", "mc (all)")):
        stages[key] = sum(v for k, v in stages.items()
                          if isinstance(v, float) and k.startswith(prefix))
        print(f"[{label}]   {key:<26} {stages[key]:9.3f}")
    stages["intra steps a frame"] = sum(steps.values())
    stages["profiled frames/s"] = fps
    return stages


def check_frames(recorded, errs: list, label: str) -> None:
    """The ITX kernel against its plain version on every recorded frame."""
    import torch

    from vvdec_tpu_torch.ops.cuda.itx import itx_frame_cuda, itx_frame_ref
    for i, rec in enumerate(recorded):
        got = run_frame(itx_frame_cuda, rec, [r.clone() for r in rec["resi"]])
        want = run_frame(itx_frame_ref, rec, [r.clone() for r in rec["resi"]])
        err = max(int((a - b).abs().max()) for a, b in zip(got, want))
        errs.append(err)
        fail_unless(err == 0, f"{label}: itx frame {i} on the path's inputs:"
                    f" max |err| {err}")
    torch.cuda.synchronize()
    print(f"[{label}] itx kernel == plain version on all {len(recorded)} "
          f"recorded frames")


class DeblockLog:
    """What the deblock_dense_cuda calls of the device filter chain did
    while `deblock_recording(log)` is open: the pictures they filtered
    (a call filters one picture, or a stack of them) and the inputs of
    the first `keep` calls (the pre-deblock planes, the grids, the slice
    tables; in host memory with `host`)."""

    def __init__(self, keep: int = 0, host: bool = False):
        self.keep, self.host = keep, host
        self.pictures = 0
        self.recorded: list = []


@contextlib.contextmanager
def deblock_recording(log: DeblockLog):
    """While open, every deblock_dense_cuda call of the filter chain goes
    through `log` (DeblockLog), then runs the wrapper."""
    import vvdec_tpu_torch.ops.device_pipeline as device_pipeline
    from vvdec_tpu_torch.ops.cuda.deblock import deblock_dense_cuda

    def keep(t):
        return None if t is None else t.cpu() if log.host else t.clone()

    def recorder(planes, grids, si, sltab, **kw):
        log.pictures += planes[0].shape[0] if planes[0].dim() == 3 else 1
        if len(log.recorded) < log.keep:
            log.recorded.append(dict(
                planes=[keep(p) for p in planes],
                grids=[keep(g) for g in grids], si=keep(si),
                sltab=keep(sltab), kw=dict(kw)))
        return deblock_dense_cuda(planes, grids, si, sltab, **kw)

    device_pipeline.deblock_dense_cuda = recorder
    try:
        yield log
    finally:
        device_pipeline.deblock_dense_cuda = deblock_dense_cuda


def deblock_on_card(rec: dict) -> dict:
    """A recorded deblock call (deblock_recording) with its tensors on
    the card."""
    def card(t):
        return None if t is None else t.cuda()
    return dict(rec, planes=[card(p) for p in rec["planes"]],
                grids=[card(g) for g in rec["grids"]], si=card(rec["si"]),
                sltab=card(rec["sltab"]))


def run_deblock(fn, rec: dict):
    """One recorded call (tensors on the card) through fn, the wrapper or
    its plain version."""
    return fn(rec["planes"], rec["grids"], rec["si"], rec["sltab"],
              **rec["kw"])


def check_deblock(recorded, derrs: list, label: str) -> None:
    """The deblock kernel against its plain version on every recorded
    picture (its pre-deblock planes as the path gave them), bit-equal;
    each picture's max |err| goes into `derrs`."""
    import torch

    from vvdec_tpu_torch.ops.cuda.deblock import (deblock_dense_cuda,
                                                  deblock_dense_ref)
    for i, rec in enumerate(recorded):
        rec = deblock_on_card(rec)
        got = run_deblock(deblock_dense_cuda, rec)
        want = run_deblock(deblock_dense_ref, rec)
        torch.cuda.synchronize()
        err = max(int((a - b).abs().max()) for a, b in zip(got, want))
        derrs.append(err)
        fail_unless(err == 0, f"{label}: deblock picture {i} on the path's "
                    f"inputs: max |err| {err}")
    print(f"[{label}] deblock kernel == plain version on all "
          f"{len(recorded)} recorded pictures")


def deblock_work(rec: dict) -> tuple[int, int]:
    """(bytes, two-pass bytes) of one recorded call: each input read once
    at the width the kernel reads it (the int32 planes; the int16 grids,
    slice-index grid and slice tables as the host packs them; the int32
    constant pool) and each plane written once; the two-pass count reads
    and writes each plane once per direction."""
    from vvdec_tpu_torch.ops.cuda.deblock import CONST_LEN
    planes = sum(p.numel() for p in rec["planes"]) * 4
    params = sum(t.numel() * t.element_size() for t in
                 [*rec["grids"], rec["si"], rec["sltab"]] if t is not None)
    return 2 * planes + params + 4 * CONST_LEN, \
        4 * planes + params + 4 * CONST_LEN


def deblock_times(recorded, label: str) -> dict:
    """Per picture of `recorded` (deblock_recording's calls): the
    kernel's device time (torch.profiler over about TRACE_LAUNCHES
    launches), the plain version's (its kernels in one traced run), the
    wrapper calls' stream time (CUDA events, the host's cost between
    launches included) and the bounds."""
    from vvdec_tpu_torch.ops.cuda.deblock import (deblock_dense_cuda,
                                                  deblock_dense_ref)
    recs = [deblock_on_card(r) for r in recorded]
    n = len(recs)

    def run(fn=deblock_dense_cuda):
        for rec in recs:
            run_deblock(fn, rec)

    k_ms = device_ms(run, -(-TRACE_LAUNCHES // (2 * n)), "deblock_kernel",
                     launches=2 * n) / n
    p_ms = trace_device_ms(lambda: run(deblock_dense_ref)) / n
    c_ms = cuda_ms(run, 10) / n
    nb, nb2 = (sum(v) / n for v in zip(*map(deblock_work, recs)))
    b_ms = nb / HBM_BYTES_PER_S * 1e3
    b2_ms = nb2 / HBM_BYTES_PER_S * 1e3
    print(f"[{label}] deblock per picture (mean of {n}): 2 launches; device "
          f"time kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms; bound "
          f"{b_ms:.6f} ms (bytes; two passes {b2_ms:.6f} ms); stream time "
          f"of the wrapper calls {c_ms:.4f} ms")
    return dict(deblock_ms=k_ms, deblock_plain_ms=p_ms,
                deblock_call_ms=c_ms, deblock_bound_ms=b_ms,
                deblock_bound_by="bytes", deblock_bound_two_pass_ms=b2_ms,
                deblock_pictures=n)


# phase 3's deblock cases: label, height, width, chroma format, bit
# depth, slices, frames (0: no frame axis)
DEBLOCK_SHAPES = (("832x480 4:2:0 10-bit", 480, 832, 1, 10, 1, 0),
                  ("832x480 4:2:0 10-bit, 3 frames", 480, 832, 1, 10, 1, 3),
                  ("1920x1080 4:2:0 10-bit", 1080, 1920, 1, 10, 1, 0),
                  ("832x480 4:0:0 8-bit", 480, 832, 0, 8, 1, 0),
                  ("832x480 4:2:2 10-bit, 2 slices", 480, 832, 2, 10, 2, 0),
                  ("832x480 4:4:4 8-bit, 2 slices", 480, 832, 3, 8, 2, 0))


def phase_deblock_vs_plain(derrs: list) -> None:
    """The deblock kernel against its plain version on fuzzed grids
    (ops/cuda/deblock.random_inputs: every bS, QP 0..127, filter lengths
    {1, 2, 3, 5, 7} on neighbouring cells, so write windows overlap;
    slice offsets past both ends of the tables) over blocky planes, CTU
    64, bit-equal; per case the kernel's device time (torch.profiler, 50
    calls of 2 launches), the plain version's and the bound."""
    import torch

    from vvdec_tpu_torch.ops.cuda.deblock import (deblock_dense_cuda,
                                                  deblock_dense_ref,
                                                  random_inputs)
    print(f"[kernel] deblock_dense_cuda vs deblock_dense_ref, fuzzed grids "
          f"with overlapping windows, bit-equal; ms per call (2 launches): "
          f"device time of deblock_kernel and of the plain version's "
          f"kernels (torch.profiler), bound of one read and one write of "
          f"each plane")
    for i, (label, h, w, cfmt, bd, n_sl, frames) in enumerate(
            DEBLOCK_SHAPES):
        planes, grids, si, sltab, kw = random_inputs(
            100 + i, h, w, cfmt=cfmt, bd=bd, n_sl=n_sl, frames=frames)

        def card(a):
            return None if a is None else torch.from_numpy(a).cuda()
        rec = dict(planes=[card(p) for p in planes],
                   grids=[card(g) for g in grids], si=card(si),
                   sltab=card(sltab), kw=dict(kw, ctu=64))
        got = run_deblock(deblock_dense_cuda, rec)
        want = run_deblock(deblock_dense_ref, rec)
        torch.cuda.synchronize()
        err = max(int((a - b).abs().max()) for a, b in zip(got, want))
        derrs.append(err)
        fail_unless(err == 0, f"deblock {label}: max |err| {err}")
        changed = sum(int((a != b).sum()) for a, b in zip(got,
                                                          rec["planes"]))
        k_ms = device_ms(lambda: run_deblock(deblock_dense_cuda, rec), 50,
                         "deblock_kernel", launches=2)
        p_ms = trace_device_ms(lambda: run_deblock(deblock_dense_ref, rec))
        b_ms = deblock_work(rec)[0] / HBM_BYTES_PER_S * 1e3
        print(f"[kernel] deblock {label}: {changed} samples changed; kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.6f} ms "
              f"(bytes); bit-equal")


class SaoAlfLog:
    """What the sao_alf_cuda calls of the device filter chain did while
    `sao_alf_recording(log)` is open: the pictures they filtered (a call
    filters one picture, or a stack of them) and the inputs of the first
    `keep` calls (the post-deblock planes, the packed parameter vector,
    the chain's key; in host memory with `host`)."""

    def __init__(self, keep: int = 0, host: bool = False):
        self.keep, self.host = keep, host
        self.pictures = 0
        self.recorded: list = []


@contextlib.contextmanager
def sao_alf_recording(log: SaoAlfLog):
    """While open, every sao_alf_cuda call of the filter chain goes
    through `log` (SaoAlfLog), then runs the wrapper."""
    import vvdec_tpu_torch.ops.device_pipeline as device_pipeline
    from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda

    def keep(t):
        return t.cpu() if log.host else t.clone()

    def recorder(planes, flat, key):
        log.pictures += planes[0].shape[0] if planes[0].dim() == 3 else 1
        if len(log.recorded) < log.keep:
            log.recorded.append(dict(planes=[keep(p) for p in planes],
                                     flat=keep(flat), key=key))
        return sao_alf_cuda(planes, flat, key)

    device_pipeline.sao_alf_cuda = recorder
    try:
        yield log
    finally:
        device_pipeline.sao_alf_cuda = sao_alf_cuda


def sao_alf_on_card(rec: dict) -> dict:
    """A recorded SAO/ALF call (sao_alf_recording) with its tensors on
    the card."""
    return dict(rec, planes=[p.cuda() for p in rec["planes"]],
                flat=rec["flat"].cuda())


def run_sao_alf(fn, rec: dict):
    """One recorded call (tensors on the card) through fn, the wrapper or
    its plain version."""
    return fn(rec["planes"], rec["flat"], rec["key"])


def sao_alf_launches(key) -> tuple[int, int]:
    """The SAO and the ALF launches of one wrapper call under `key`."""
    return int(key[12]), int(any(key[13:16]))


def check_sao_alf(recorded, serrs: list, label: str) -> None:
    """The SAO/ALF kernels against their plain version on every recorded
    picture (its post-deblock planes as the path gave them), bit-equal;
    each picture's max |err| goes into `serrs`."""
    import torch

    from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda, sao_alf_ref
    for i, rec in enumerate(recorded):
        rec = sao_alf_on_card(rec)
        got = run_sao_alf(sao_alf_cuda, rec)
        want = run_sao_alf(sao_alf_ref, rec)
        torch.cuda.synchronize()
        err = max(int((a - b).abs().max()) for a, b in zip(got, want))
        serrs.append(err)
        fail_unless(err == 0, f"{label}: SAO/ALF picture {i} on the path's "
                    f"inputs: max |err| {err}")
    print(f"[{label}] SAO/ALF kernels == plain version on all "
          f"{len(recorded)} recorded pictures")


def sao_alf_work(rec: dict) -> tuple[int, int]:
    """(bytes, two-launch bytes) of one recorded call: each input plane
    read once and each output plane written once, the int16 parameter
    vector read once; the two-launch count also writes the post-SAO
    planes and reads them again, and reads the vector twice."""
    planes = sum(p.numel() for p in rec["planes"]) * 4
    params = rec["flat"].numel() * 2
    return 2 * planes + params, 4 * planes + 2 * params


def sao_alf_times(recorded, label: str) -> dict:
    """Per picture of `recorded` (sao_alf_recording's calls): each
    kernel's device time (torch.profiler over about TRACE_LAUNCHES
    launches), the plain version's (its kernels in one traced run), the
    wrapper calls' stream time (CUDA events, the host's cost between
    launches included) and the bounds."""
    from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda, sao_alf_ref
    recs = [sao_alf_on_card(r) for r in recorded]
    n = len(recs)
    n_sao, n_alf = (sum(v) for v in zip(*(sao_alf_launches(r["key"])
                                          for r in recs)))

    def run(fn=sao_alf_cuda):
        for rec in recs:
            run_sao_alf(fn, rec)

    reps = -(-TRACE_LAUNCHES // (n_sao + n_alf))
    sao_ms = device_ms(run, reps, "sao_kernel", launches=n_sao) / n \
        if n_sao else 0.0
    alf_ms = device_ms(run, reps, "alf_ccalf_kernel", launches=n_alf) / n \
        if n_alf else 0.0
    p_ms = trace_device_ms(lambda: run(sao_alf_ref)) / n
    c_ms = cuda_ms(run, 10) / n
    nb, nb2 = (sum(v) / n for v in zip(*map(sao_alf_work, recs)))
    b_ms = nb / HBM_BYTES_PER_S * 1e3
    b2_ms = nb2 / HBM_BYTES_PER_S * 1e3
    print(f"[{label}] SAO/ALF per picture (mean of {n}): "
          f"{(n_sao + n_alf) / n:.2f} launches; device time sao_kernel "
          f"{sao_ms:.4f} ms, alf_ccalf_kernel {alf_ms:.4f} ms, plain "
          f"{p_ms:.3f} ms; bound {b_ms:.6f} ms (bytes; two launches "
          f"{b2_ms:.6f} ms); stream time of the wrapper calls {c_ms:.4f} "
          f"ms")
    return dict(sao_alf_ms=sao_ms + alf_ms, sao_ms=sao_ms, alf_ms=alf_ms,
                sao_alf_plain_ms=p_ms, sao_alf_call_ms=c_ms,
                sao_alf_bound_ms=b_ms, sao_alf_bound_by="bytes",
                sao_alf_bound_two_launch_ms=b2_ms,
                sao_alf_launches_per_picture=(n_sao + n_alf) / n,
                sao_alf_pictures=n)


# phase 3's SAO/ALF cases: label, height, width, CTU, chroma format, bit
# depth, frames (0: no frame axis); every stage on
SAO_ALF_SHAPES = (("832x480 4:2:0 10-bit CTU 128", 480, 832, 128, 1, 10, 0),
                  ("832x480 4:2:0 10-bit CTU 128, 3 frames", 480, 832, 128,
                   1, 10, 3),
                  ("1920x1080 4:2:0 10-bit CTU 128", 1080, 1920, 128, 1, 10,
                   0),
                  ("832x480 4:0:0 8-bit CTU 64", 480, 832, 64, 0, 8, 0),
                  ("832x480 4:2:2 10-bit CTU 64", 480, 832, 64, 2, 10, 0),
                  ("832x480 4:4:4 8-bit CTU 32", 480, 832, 32, 3, 8, 0))


def phase_sao_alf_vs_plain(serrs: list) -> None:
    """The SAO/ALF kernels against their plain version on fuzzed planes
    and parameters (ops/cuda/sao_alf.random_inputs: every SAO type,
    bands wrapping past 31, several luma banks, chroma alternatives,
    CC-ALF banks, indices past both ends), bit-equal; per case each
    kernel's device time (torch.profiler, 50 calls of 2 launches), the
    plain version's and the bound."""
    import torch

    from vvdec_tpu_torch.ops.cuda.sao_alf import (random_inputs,
                                                  sao_alf_cuda, sao_alf_ref)
    print("[kernel] sao_alf_cuda vs sao_alf_ref, fuzzed planes and "
          "parameters, bit-equal; ms per call (2 launches): device time of "
          "sao_kernel and alf_ccalf_kernel and of the plain version's "
          "kernels (torch.profiler), bound of one read and one write of "
          "each plane")
    for i, (label, h, w, ctu, cfmt, bd, frames) in enumerate(
            SAO_ALF_SHAPES):
        planes, flat, key = random_inputs(200 + i, h, w, cfmt=cfmt, bd=bd,
                                          ctu=ctu, frames=frames)
        rec = dict(planes=[torch.from_numpy(p).cuda() for p in planes],
                   flat=torch.from_numpy(flat).cuda(), key=key)
        got = run_sao_alf(sao_alf_cuda, rec)
        want = run_sao_alf(sao_alf_ref, rec)
        torch.cuda.synchronize()
        err = max(int((a - b).abs().max()) for a, b in zip(got, want))
        serrs.append(err)
        fail_unless(err == 0, f"SAO/ALF {label}: max |err| {err}")
        changed = sum(int((a != b).sum()) for a, b in zip(got,
                                                          rec["planes"]))
        sao_ms = device_ms(lambda: run_sao_alf(sao_alf_cuda, rec), 50,
                           "sao_kernel", launches=1)
        alf_ms = device_ms(lambda: run_sao_alf(sao_alf_cuda, rec), 50,
                           "alf_ccalf_kernel", launches=1)
        p_ms = trace_device_ms(lambda: run_sao_alf(sao_alf_ref, rec))
        b_ms = sao_alf_work(rec)[0] / HBM_BYTES_PER_S * 1e3
        print(f"[kernel] SAO/ALF {label}: {changed} samples changed; "
              f"sao_kernel {sao_ms:.4f} ms, alf_ccalf_kernel {alf_ms:.4f} "
              f"ms, plain {p_ms:.3f} ms, bound {b_ms:.6f} ms (bytes); "
              f"bit-equal")


class WavefrontLog:
    """What the intra_wavefront_cuda calls of a decode did, while
    `wavefront_recording(log)` is open: the pictures it ran (calls with
    at least one step, each one kernel launch on the card), their steps
    by mode class, and the inputs of the first `keep` such calls (the
    planes as they were before the call; in host memory with `host`)."""

    def __init__(self, keep: int = 0, host: bool = False):
        import collections
        self.keep, self.host = keep, host
        self.pictures = 0
        self.steps: collections.Counter = collections.Counter()
        self.recorded: list = []

    def steps_by_class(self, n_frames: int) -> dict:
        """Steps a frame by mode class name."""
        names = ("planar", "DC", "angular", "MIP", "CCLM", "CIIP")
        return {names[mc]: n / n_frames
                for mc, n in sorted(self.steps.items())}


@contextlib.contextmanager
def wavefront_recording(log: WavefrontLog):
    """While open, every intra_wavefront_cuda call of the decoder goes
    through `log` (WavefrontLog), then runs the wrapper."""
    import numpy as np

    import vvdec_tpu_torch.ops.intra_device as intra_device
    from vvdec_tpu_torch.ops.cuda.intra import intra_wavefront_cuda

    def keep(t):
        return t.cpu() if log.host else t.clone()

    def recorder(buf, resi, batches, consts, lm, **kw):
        b = np.asarray(batches)
        if b.shape[0]:
            log.pictures += 1
            log.steps.update(b[:, 0, 7].tolist())
            if len(log.recorded) < log.keep:
                log.recorded.append(dict(
                    buf=keep(buf), resi=keep(resi), batches=b.copy(),
                    lm=None if lm is None else keep(lm), kw=dict(kw)))
        return intra_wavefront_cuda(buf, resi, batches, consts, lm, **kw)

    intra_device.intra_wavefront_cuda = recorder
    try:
        yield log
    finally:
        intra_device.intra_wavefront_cuda = intra_wavefront_cuda


def wavefront_work(batches, has_lmcs: bool) -> int:
    """The bytes one picture's wavefront must move at least: the step
    batches and the constant tables in, each unit's output written once,
    its residual read where it has one (d[9]), CIIP's inter prediction
    read, the LMCS table where the picture has one.  References and
    CCLM's luma are earlier units' outputs, which need not leave the
    chip."""
    import numpy as np

    from vvdec_tpu_torch.ops.cuda.intra import CONST_LEN
    from vvdec_tpu_torch.ops.intra_device import LM_LEN
    rows = batches.reshape(-1, batches.shape[-1])
    rows = rows[rows[:, 28] == 1]
    area = (np.clip(rows[:, 3], 0, 64) * np.clip(rows[:, 4], 0, 64)
            ).astype(np.int64)
    return int(4 * (batches.size + area.sum() + area[rows[:, 9] == 1].sum()
                    + area[rows[:, 7] == 5].sum() + CONST_LEN
                    + (LM_LEN if has_lmcs else 0)))


def run_wavefront(fn, rec, buf):
    """One recorded picture's wavefront through fn (the wrapper or its
    plain version) on the card, in place on buf."""
    import torch

    from vvdec_tpu_torch.ops.cuda.intra import intra_consts
    dev = torch.device("cuda")
    lm = rec["lm"]
    return fn(buf, rec["resi"].to(dev), rec["batches"], intra_consts(dev),
              None if lm is None else lm.to(dev), **rec["kw"])


def planned_launch(rec, buf, cluster: int, masked: bool = False):
    """A function of no arguments that launches the kernel over one
    recorded picture's plan for a cluster of `cluster` blocks (made and
    uploaded once, here) in place on buf, uncounted (launch_plan); with
    `masked`, the empty-phase floor: the same phases, barriers and
    descriptor loads, every unit masked.  Also returns the phase count."""
    import torch

    from vvdec_tpu_torch.ops.cuda.intra import (intra_consts, launch_plan,
                                                wavefront_phases,
                                                wavefront_plan)
    dev = torch.device("cuda")
    kw = dict(rec["kw"])
    levels = kw.pop("levels", None)
    kw.pop("K")
    phases = wavefront_phases(rec["batches"], levels, buf.shape[1],
                              buf.shape[2])
    plan = torch.as_tensor(wavefront_plan(rec["batches"], phases, cluster,
                                          masked), device=dev)
    resi, lm = rec["resi"].to(dev), rec["lm"]
    lm = None if lm is None else lm.to(dev)
    consts = intra_consts(dev)

    def run():
        err = launch_plan(buf, resi, plan, len(phases) - 1, consts, lm,
                          cluster=cluster, **kw)
        fail_unless(err == 0, f"intra_wavefront launch failed: cudaError "
                    f"{err} on a cluster of {cluster}")

    return run, len(phases) - 1


def cluster_sweep(rec, label: str, picture: int) -> dict:
    """One recorded picture's kernel at every cluster size the kernel
    takes: each over the same phases, bit-equal to the wrapper's result,
    with its device time and its empty-phase floor's (CUDA events over 20
    back-to-back planned launches; the plan made and uploaded before)."""
    import torch

    from vvdec_tpu_torch.ops.cuda.intra import (CLUSTER, CLUSTER_SIZES,
                                                intra_wavefront_cuda)
    buf0 = rec["buf"].cuda()
    want = run_wavefront(intra_wavefront_cuda, rec, buf0.clone())
    out = {}
    for cluster in CLUSTER_SIZES:
        got = buf0.clone()
        run, n_ph = planned_launch(rec, got, cluster)
        run()
        torch.cuda.synchronize()
        fail_unless(torch.equal(got, want), f"{label}: picture {picture} on "
                    f"a cluster of {cluster} differs from the wrapper's")
        k_ms = cuda_ms(run, 20)
        f_ms = cuda_ms(planned_launch(rec, got, cluster, masked=True)[0], 20)
        out[cluster] = dict(ms=k_ms, floor_ms=f_ms)
        print(f"[{label}] picture {picture} on a cluster of {cluster:2d}"
              f"{' (the default)' if cluster == CLUSTER else ''}: "
              f"{k_ms:.4f} ms ({k_ms / n_ph * 1e3:.2f} us a phase), "
              f"empty-phase floor {f_ms:.4f} ms ({f_ms / n_ph * 1e3:.2f} us "
              f"a phase); bit-equal")
    return out


def check_wavefront(recorded, errs: list, label: str, schedule: list,
                    plain_time: int = 1, sweep: int = 0) -> list:
    """The intra wavefront kernel against its plain version on every
    recorded picture, bit-equal over the three planes, and each
    picture's device times (torch.profiler): the kernel over 100
    launches (device_ms), its empty-phase floor over 100 (the same
    phases with every unit masked: the barriers and descriptor loads
    alone), the plain version over one run (trace_device_ms) on the
    first `plain_time` pictures; the bound (wavefront_work over
    HBM_BYTES_PER_S), the steps, the phases and, from `schedule`
    (wavefront_schedule's pictures with intra units, in decode order),
    the dependency levels and units; on the first `sweep` pictures the
    kernel at every cluster size (cluster_sweep).  Returns a dict per
    picture."""
    import torch

    from vvdec_tpu_torch.ops.cuda.intra import (CLUSTER, intra_wavefront_cuda,
                                                intra_wavefront_ref)
    out = []
    for i, rec in enumerate(recorded):
        buf0 = rec["buf"].cuda()
        got = run_wavefront(intra_wavefront_cuda, rec, buf0.clone())
        want = run_wavefront(intra_wavefront_ref, rec, buf0.clone())
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        errs.append(err)
        fail_unless(err == 0, f"{label}: intra wavefront picture {i} on the "
                    f"path's inputs: max |err| {err}")
        scratch = buf0.clone()
        k_ms = device_ms(lambda: run_wavefront(intra_wavefront_cuda, rec,
                                               scratch), 100,
                         "intra_wavefront_kernel", launches=1)
        floor, phases = planned_launch(rec, scratch, CLUSTER, masked=True)
        f_ms = device_ms(floor, 100, "intra_wavefront_kernel", launches=1)
        p_ms = trace_device_ms(lambda: run_wavefront(
            intra_wavefront_ref, rec, scratch)) if i < plain_time else None
        steps = rec["batches"].shape[0]
        sched = schedule[i]
        fail_unless(sched["steps"] == steps, f"{label}: picture {i} has "
                    f"{steps} steps, the host planner {sched['steps']}")
        fail_unless(sched["phases"] == phases, f"{label}: picture {i} has "
                    f"{phases} phases, the host planner {sched['phases']}")
        b_ms = wavefront_work(rec["batches"], rec["kw"]["has_lmcs"]) \
            / HBM_BYTES_PER_S * 1e3
        print(f"[{label}] intra_wavefront picture {sched['picture']}: "
              f"{steps} steps, {sched['levels']} levels, {phases} phases, "
              f"{sched['units']} units; device time kernel {k_ms:.4f} ms ("
              f"{k_ms / phases * 1e3:.2f} us a phase), empty-phase floor "
              f"{f_ms:.4f} ms ({f_ms / phases * 1e3:.2f} us a phase), plain "
              + ("not measured" if p_ms is None else f"{p_ms:.3f} ms")
              + f"; bound {b_ms:.6f} ms (bytes); bit-equal")
        pic = dict(sched, ms=k_ms, floor_ms=f_ms, plain_ms=p_ms,
                   bound_ms=b_ms, bound_by="bytes",
                   us_per_phase=k_ms / phases * 1e3)
        if i < sweep:
            pic["clusters"] = cluster_sweep(rec, label, sched["picture"])
        out.append(pic)
        del buf0, got, want, scratch
    return out


def run_frame(fn, rec, resi):
    import torch

    from vvdec_tpu_torch.ops.cuda.itx import matrix_pool
    return fn(rec["coef"], resi, rec["table"],
              matrix_pool(torch.device("cuda")), n_tasks=rec["n_tasks"],
              bit_depth=rec["bit_depth"])


def frame_times(recorded, n_frames: int) -> dict:
    """Per frame: the kernel's and the plain version's device time
    (torch.profiler); the wrapper's and the plain version's stream time,
    which adds the host's cost (CUDA events); the bounds."""
    from vvdec_tpu_torch.ops.cuda.itx import (itx_frame_cuda, itx_frame_ref,
                                              table_rows)
    rows = [table_rows(r["table"], r["n_tasks"]) for r in recorded]
    scratch = [[r.clone() for r in rec["resi"]] for rec in recorded]

    def run_kernel():
        for rec, resi in zip(recorded, scratch):
            run_frame(itx_frame_cuda, rec, resi)

    def run_plain():
        for rec, resi in zip(recorded, scratch):
            run_frame(itx_frame_ref, rec, resi)

    k_ms = device_ms(run_kernel, 10, "itx_kernel",
                     launches=n_frames) / n_frames
    p_ms = device_ms(run_plain, 3) / n_frames
    kc_ms = cuda_ms(run_kernel, 10) / n_frames
    pc_ms = cuda_ms(run_plain, 3) / n_frames
    work = [sum(v) / n_frames for v in zip(*map(frame_work, rows))]
    b_ms, by = bound_ms(work[0], work[1])
    b1_ms, by1 = bound_ms(work[2], work[3], PEAK_F32_OPS_PER_S)
    return dict(rows=rows, itx_ms=k_ms, itx_plain_ms=p_ms, itx_call_ms=kc_ms,
                itx_plain_call_ms=pc_ms, itx_bound_ms=b_ms, itx_bound_by=by,
                itx_bound_int32_f32_ms=b1_ms, itx_bound_int32_f32_by=by1)


def phase_main_path(errs: list, werrs: list, derrs: list) -> dict:
    from vvdec_tpu_torch.streams import (HEADLINE_MD5, HEADLINE_STREAM_KW,
                                         headline_stream)

    t0 = time.perf_counter()
    stream = BUILT["headline"] = headline_stream()
    n_frames = HEADLINE_STREAM_KW["n_frames"]
    print(f"[main] headline stream {HEADLINE_STREAM_KW['width']}x"
          f"{HEADLINE_STREAM_KW['height']} x {n_frames} frames, "
          f"{len(stream)} bytes, made in {time.perf_counter() - t0:.1f} s")

    # warm-up decode; it also records the kernel's inputs as the main
    # path gives them and counts the TUs of the PyTorch residual paths
    census = {"transform skip": 0, "lfnst": 0, "scaling list": 0}
    wf = WavefrontLog(keep=n_frames)
    db = DeblockLog(keep=n_frames)
    recorded = recording_decode(stream, "main", census, wavefront=wf,
                                deblock=db)
    fail_unless(len(recorded) == n_frames, f"the warm-up decode made "
                f"{len(recorded)} itx_frame_cuda calls for {n_frames} "
                f"frames")
    res = timed_decode(stream, n_frames, HEADLINE_MD5, "main")
    check_frames(recorded, errs, "main")
    check_deblock(db.recorded, derrs, "main")
    fail_unless(len(db.recorded) == n_frames, f"the warm-up decode made "
                f"{len(db.recorded)} deblock calls for {n_frames} frames")
    deblock = deblock_times(db.recorded, "main")
    del db
    times = frame_times(recorded, n_frames)
    rows = times.pop("rows")
    print(f"[main] TUs per frame: kernel {sum(map(len, rows)) / n_frames:.1f}"
          f" ({sum(r['n_tasks'] for r in recorded) / n_frames:.1f} blocks); "
          + "; ".join(f"{k} {v / n_frames:.1f}" for k, v in census.items()))
    print(f"[main] itx per frame: {res['launches'] / n_frames:.2f} launches; "
          f"device time kernel {times['itx_ms']:.4f} ms, plain "
          f"{times['itx_plain_ms']:.4f} ms; bound {times['itx_bound_ms']:.6f} "
          f"ms ({times['itx_bound_by']}; int32 levels at the float32 peak: "
          f"{times['itx_bound_int32_f32_ms']:.6f} ms, "
          f"{times['itx_bound_int32_f32_by']}); stream time of the calls: "
          f"wrapper {times['itx_call_ms']:.4f} ms, plain "
          f"{times['itx_plain_call_ms']:.4f} ms")
    shapes = phase_shape_groups(recorded, rows, n_frames)
    stages = timed_decode(stream, n_frames, HEADLINE_MD5, "main",
                          profile=True)["stages_ms_per_frame"]
    wave = wavefront_checks(stream, n_frames, stages, "main", wf, werrs,
                            sweep=1)
    pics = wave["intra_kernel"]
    print(f"[main] intra_wavefront per frame (mean of {len(pics)}): "
          f"{res['intra_launches'] / n_frames:.2f} launches; device time "
          f"kernel {sum(p['ms'] for p in pics) / len(pics):.4f} ms, "
          f"empty-phase floor "
          f"{sum(p['floor_ms'] for p in pics) / len(pics):.4f} ms; bound "
          f"{sum(p['bound_ms'] for p in pics) / len(pics):.6f} ms (bytes); "
          f"plain version on picture 0 {pics[0]['plain_ms']:.3f} ms")
    return dict(res, launches_per_frame=res["launches"] / n_frames,
                census_per_frame=dict(
                    kernel=sum(map(len, rows)) / n_frames,
                    **{k: v / n_frames for k, v in census.items()}),
                **times, **deblock, shapes=shapes,
                stages_ms_per_frame=stages, **wave)


def phase_lmcs(errs: list, werrs: list, derrs: list) -> dict:
    """The intra LMCS stream, decoded as the headline is, its ITX inputs
    held to the plain version."""
    from vvdec_tpu_torch.streams import STREAMS
    name = "LMCS"
    builder, n_frames, md5_pin = STREAMS[name]
    t0 = time.perf_counter()
    stream = BUILT[name] = builder()
    print(f"[{name}] stream 832x480 x {n_frames} frames, {len(stream)} "
          f"bytes, made in {time.perf_counter() - t0:.1f} s")
    wf = WavefrontLog(keep=1)
    db = DeblockLog(keep=n_frames)
    recorded = recording_decode(stream, name, wavefront=wf, deblock=db)
    fail_unless(len(recorded) == n_frames, f"{name}: the warm-up decode "
                f"made {len(recorded)} itx_frame_cuda calls for {n_frames} "
                f"frames")
    res = timed_decode(stream, n_frames, md5_pin, name)
    check_frames(recorded, errs, name)
    check_deblock(db.recorded, derrs, name)
    stages = timed_decode(stream, n_frames, md5_pin, name,
                          profile=True)["stages_ms_per_frame"]
    res.update(stages_ms_per_frame=stages,
               **wavefront_checks(stream, n_frames, stages, name, wf, werrs))
    return res


def phase_shape_groups(recorded, rows, n_frames) -> list:
    """Per TU shape, per frame: the main path's recorded TUs run as
    one-group itx_batch_cuda launches (one per frame, shape and matrix
    pair), timed as in the first port's per-group table: launches, TUs,
    device time of the kernel and the plain version, bounds, stream
    time of the calls."""
    import numpy as np
    import torch

    from vvdec_tpu_torch.ops.cuda.itx import (itx_batch_cuda, itx_batch_ref,
                                              matrix_pool)
    from vvdec_tpu_torch.ops.frame_device import _extract_fn
    pool = matrix_pool(torch.device("cuda"))
    batches: dict = {}
    for rec, r in zip(recorded, rows):
        keys, inv = np.unique(r[:, [0, 3, 4, 5, 6]], axis=0,
                              return_inverse=True)
        for gi, (comp, lh, lw, mv_off, mh_off) in enumerate(keys.tolist()):
            sel = torch.as_tensor(r[inv.reshape(-1) == gi], device="cuda")
            h, w = 1 << lh, 1 << lw
            levels = _extract_fn(h, w)(rec["coef"][comp], sel[:, 1],
                                       sel[:, 2])
            mv = pool[mv_off:mv_off + h * h].view(h, h).t().to(torch.int32)
            mh = pool[mh_off:mh_off + w * w].view(w, w).t().to(torch.int32)
            batches.setdefault((h, w), []).append(
                (levels.contiguous(), sel[:, 7].contiguous(),
                 sel[:, 8].contiguous(), sel[:, 9].contiguous(),
                 mv.contiguous(), mh.contiguous()))
    print(f"[main] itx per shape, one-group launches of the recorded TUs, "
          f"ms per frame (of {n_frames}); ms and plain_ms are device time, "
          f"call_ms the calls' stream time; bound_i32 is the first port's")
    print(f"[main] {'h x w':>7} {'launch':>6} {'TUs':>6} {'ms':>8} "
          f"{'plain_ms':>9} {'bound_ms':>9} {'bound_i32':>9} {'call_ms':>8}")
    out = []
    for (h, w), args in sorted(batches.items(), key=lambda kv: -sum(
            a[0].shape[0] for a in kv[1]) * kv[0][0] * kv[0][1]):
        def run_kernel(args=args, h=h, w=w):
            for a in args:
                itx_batch_cuda(*a, h=h, w=w, bit_depth=BIT_DEPTH)

        def run_plain(args=args, h=h, w=w):
            for a in args:
                itx_batch_ref(*a, h=h, w=w, bit_depth=BIT_DEPTH)

        for a in args:
            got = itx_batch_cuda(*a, h=h, w=w, bit_depth=BIT_DEPTH)
            fail_unless(torch.equal(got, itx_batch_ref(
                *a, h=h, w=w, bit_depth=BIT_DEPTH)), f"itx {h}x{w} one-group "
                f"launch of recorded TUs differs from its plain version")
        k_ms = device_ms(run_kernel, 10, "itx_kernel",
                         launches=len(args)) / n_frames
        p_ms = device_ms(run_plain, 3) / n_frames
        kc_ms = cuda_ms(run_kernel, 10) / n_frames
        tus = sum(a[0].shape[0] for a in args)
        nb, ops, nb1, ops1 = itx_work(tus, h, w)
        b_ms, by = bound_ms(nb / n_frames, ops / n_frames)
        b1_ms = bound_ms(nb1 / n_frames, ops1 / n_frames,
                         PEAK_F32_OPS_PER_S)[0]
        print(f"[main] {h:>3} x{w:>3} {len(args) / n_frames:6.2f} "
              f"{tus / n_frames:6.1f} {k_ms:8.4f} {p_ms:9.4f} {b_ms:9.6f} "
              f"{b1_ms:9.6f} {kc_ms:8.4f}")
        out.append(dict(h=h, w=w, launches_per_frame=len(args) / n_frames,
                        tus_per_frame=tus / n_frames, ms=k_ms, plain_ms=p_ms,
                        bound_ms=b_ms, bound_by=by, bound_int32_f32_ms=b1_ms,
                        call_ms=kc_ms))
    return out


def wavefront_schedule(stream: bytes, n_frames: int, stages: dict,
                       label: str) -> dict:
    """Intra units, wavefront steps and dependency levels per frame of
    the stream, from the port's host planner (WAVEFRONT_K units per step,
    as run_intra_scan uses; pictures build_intra_descriptors rejects,
    and inter pictures with LMCS, which the decoder reconstructs on the
    host as "lmcs_inter", count none), the profiled intra stage's ms per step,
    and per picture with intra units, in decode order, its index, units,
    steps and levels."""
    from vvdec_tpu_torch.decoder import parse_annexb
    from vvdec_tpu_torch.frame.structure import MODE_INTRA
    from vvdec_tpu_torch.ops.cuda.intra import wavefront_phases
    from vvdec_tpu_torch.ops.frame_device import _lmcs_on
    from vvdec_tpu_torch.ops.intra_device import (PB, RL, WAVEFRONT_K,
                                                  build_intra_descriptors,
                                                  build_wavefront_batches,
                                                  compute_unit_levels,
                                                  wavefront_step_levels)
    pictures = []
    for i, f in enumerate(parse_annexb(stream)):
        if _lmcs_on(f.cs) and any(cu.pred_mode != MODE_INTRA
                                  for cu in f.cs.cus):
            continue
        desc, reason = build_intra_descriptors(f.cs)
        if reason is not None or desc.shape[0] == 0:
            continue
        lvl = compute_unit_levels(desc, f.cs.sps.chroma_format_idc)
        batches = build_wavefront_batches(desc, lvl, WAVEFRONT_K)
        phases = wavefront_phases(
            batches, wavefront_step_levels(desc, lvl, WAVEFRONT_K),
            max(f.cs.h + PB, RL), max(f.cs.w + PB, RL))
        pictures.append(dict(
            picture=i, units=desc.shape[0], levels=int(lvl.max()),
            steps=batches.shape[0], phases=len(phases) - 1))
    units, steps, levels, phases = (sum(p[k] for p in pictures) for k in
                                    ("units", "steps", "levels", "phases"))
    kernel = stages.get("intra: kernel", 0.0) * n_frames
    print(f"[{label}] intra wavefront: {units / n_frames:.1f} units, "
          f"{steps / n_frames:.1f} steps, {levels / n_frames:.1f} "
          f"dependency levels and {phases / n_frames:.1f} phases per frame;"
          f" {kernel / max(phases, 1) * 1e3:.2f} us of the \"intra: "
          f"kernel\" stage (launch and wait) per phase")
    return dict(intra_units=units / n_frames, intra_steps=steps / n_frames,
                intra_levels=levels / n_frames,
                intra_phases=phases / n_frames, intra_pictures=pictures)


def wavefront_checks(stream: bytes, n_frames: int, stages: dict,
                     label: str, log: WavefrontLog, werrs: list,
                     plain_time: int = 1, sweep: int = 0) -> dict:
    """wavefront_schedule of the stream, then check_wavefront on the
    pictures `log` recorded (the first ones with intra units)."""
    sched = wavefront_schedule(stream, n_frames, stages, label)
    fail_unless(len(sched["intra_pictures"]) == log.pictures, f"{label}: "
                f"the host planner has {len(sched['intra_pictures'])} "
                f"pictures with intra units, the decode ran {log.pictures}")
    fail_unless(len(log.recorded) == min(log.keep, log.pictures),
                f"{label}: {len(log.recorded)} wavefront inputs recorded")
    return dict(sched, intra_kernel=check_wavefront(
        log.recorded, werrs, label, sched["intra_pictures"], plain_time,
        sweep))


def phase_ra(errs: list, werrs: list, derrs: list) -> dict:
    """The RA stream: decoded as the inter streams are, with an empty
    fallback census; the profiled decode must show the DMVR and BDOF
    stages, and the warm-up decode counts their CUs and subblocks."""
    from vvdec_tpu_torch.streams import STREAMS
    name = "RA"
    builder, n_frames, md5_pin = STREAMS[name]
    t0 = time.perf_counter()
    stream = builder()
    print(f"[{name}] stream 832x480 x {n_frames} frames, {len(stream)} "
          f"bytes, made in {time.perf_counter() - t0:.1f} s")
    refined: list = []
    wf = WavefrontLog(keep=1)
    db = DeblockLog(keep=n_frames)
    recorded = recording_decode(stream, name, refined=refined, wavefront=wf,
                                deblock=db)
    fail_unless(len(recorded) == n_frames, f"{name}: the warm-up decode "
                f"made {len(recorded)} itx_frame_cuda calls for {n_frames} "
                f"frames")
    res = timed_decode(stream, n_frames, md5_pin, name)
    check_frames(recorded, errs, name)
    check_deblock(db.recorded, derrs, name)
    for poc, dmvr_cus, dmvr_sub, bdof_cus, bdof_reg in refined:
        print(f"[{name}] POC {poc}: DMVR {dmvr_cus} CUs, {dmvr_sub} "
              f"subblocks; standalone BDOF {bdof_cus} CUs, {bdof_reg} "
              f"regions")
    fail_unless(any(r[1] for r in refined) and any(r[3] for r in refined),
                f"{name}: no DMVR or no BDOF CU in the stream")
    stages = timed_decode(stream, n_frames, md5_pin, name,
                          profile=True)["stages_ms_per_frame"]
    fail_unless(stages.get("mc: DMVR", 0) > 0 and stages.get("mc: BDOF", 0)
                > 0, f"{name}: the stage split lacks mc: DMVR or mc: BDOF")
    res.update(stages_ms_per_frame=stages, refined_per_picture=refined,
               **wavefront_checks(stream, n_frames, stages, name, wf, werrs))
    return res


def phase_host_recon(errs: list, werrs: list, derrs: list) -> dict:
    """The inter-LMCS stream: the IDR on the device, the two B pictures
    (inter LMCS) reconstructed on the host and filtered on the device.
    The pinned MD5 and census, one ITX launch per device picture, and the
    host stages beside the device ones in the profiled decode."""
    from vvdec_tpu_torch.streams import LMCS_INTER_CENSUS, STREAMS
    name = "inter-LMCS"
    builder, n_frames, md5_pin = STREAMS[name]
    device_frames = n_frames - LMCS_INTER_CENSUS["device_recon:lmcs_inter"]
    t0 = time.perf_counter()
    stream = builder()
    print(f"[{name}] stream 832x480 x {n_frames} frames, {len(stream)} "
          f"bytes, made in {time.perf_counter() - t0:.1f} s")
    wf = WavefrontLog(keep=1)
    db = DeblockLog(keep=n_frames)
    recorded = recording_decode(stream, name, wavefront=wf, deblock=db)
    fail_unless(len(recorded) == device_frames, f"{name}: the warm-up "
                f"decode made {len(recorded)} itx_frame_cuda calls for "
                f"{device_frames} device pictures")
    res = timed_decode(stream, n_frames, md5_pin, name,
                       census=LMCS_INTER_CENSUS, device_frames=device_frames)
    check_frames(recorded, errs, name)
    # the host pictures too: the device filters every picture
    check_deblock(db.recorded, derrs, name)
    stages = timed_decode(stream, n_frames, md5_pin, name,
                          census=LMCS_INTER_CENSUS,
                          device_frames=device_frames,
                          profile=True)["stages_ms_per_frame"]
    fail_unless(stages.get("recon", 0) > 0 and stages.get(
        "filter(submit)", 0) > 0, f"{name}: the stage split lacks the host "
                f"reconstruction or the device filter submit")
    res.update(stages_ms_per_frame=stages, device_frames=device_frames,
               **wavefront_checks(stream, n_frames, stages, name, wf, werrs))
    return res


def busy_in(spans, a: float, b: float) -> float:
    """The union of the device intervals `spans` (sorted (start, end,
    name)) clipped to [a, b], in the profiler's microseconds."""
    busy = 0.0
    end = a
    for s0, s1, _ in spans:
        s0, s1 = max(s0, end), min(s1, b)
        if s1 > s0:
            busy += s1 - s0
            end = s1
    return busy


def phase_device_busy() -> dict:
    """torch.profiler over the decode of the headline configuration's
    first frame (one frame: the trace of all eight takes minutes to
    read back): the device's busy share, as the union of its kernel and
    copy intervals over the decode's wall time, and the kernels that take
    the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vvdec_tpu_torch.decoder import decode_annexb
    from vvdec_tpu_torch.streams import HEADLINE_STREAM_KW
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    stream, _ = generate_stream(**dict(HEADLINE_STREAM_KW, n_frames=1))
    n_frames = 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_annexb(stream)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    fail_unless(spans, "torch.profiler recorded no device activity")
    busy = busy_in(spans, spans[0][0], max(s1 for _, s1, _ in spans))
    by_name: dict = {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    print(f"[profile] 1-frame decode under torch.profiler: wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({busy / wall_us:.1%}), {len(spans) / n_frames:.0f} device "
          f"kernels/copies per frame")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile]   {t / 1e3 / n_frames:8.3f} ms/frame  {name[:90]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / wall_us,
                device_ops_per_frame=len(spans) / n_frames)


def phase_inter(errs: list, werrs: list, derrs: list) -> dict:
    """The inter-LD and inter-LDB tools streams, each decoded as the
    tool-set streams are; the ITX kernel's per-frame times on the
    inter-LD frames."""
    from vvdec_tpu_torch.streams import STREAMS
    out = {}
    for name in ("inter-LD", "inter-LDB tools"):
        builder, n_frames, md5_pin = STREAMS[name]
        t0 = time.perf_counter()
        stream = BUILT[name] = builder()
        print(f"[{name}] stream 832x480 x {n_frames} frames, {len(stream)} "
              f"bytes, made in {time.perf_counter() - t0:.1f} s")
        wf = WavefrontLog(keep=1)
        db = DeblockLog(keep=n_frames)
        recorded = recording_decode(stream, name, wavefront=wf, deblock=db)
        fail_unless(len(recorded) == n_frames, f"{name}: the warm-up decode "
                    f"made {len(recorded)} itx_frame_cuda calls for "
                    f"{n_frames} frames")
        res = timed_decode(stream, n_frames, md5_pin, name)
        check_frames(recorded, errs, name)
        check_deblock(db.recorded, derrs, name)
        del db
        if name == "inter-LD":
            times = frame_times(recorded, n_frames)
            rows = times.pop("rows")
            tus = sum(map(len, rows)) / n_frames
            res.update(times, kernel_tus_per_frame=tus)
            print(f"[{name}] itx per frame: {tus:.1f} kernel TUs; device "
                  f"time kernel {times['itx_ms']:.4f} ms, "
                  f"plain {times['itx_plain_ms']:.4f} ms; bound "
                  f"{times['itx_bound_ms']:.6f} ms ({times['itx_bound_by']}); "
                  f"stream time of the calls: wrapper "
                  f"{times['itx_call_ms']:.4f} ms")
        stages = timed_decode(stream, n_frames, md5_pin, name,
                              profile=True)["stages_ms_per_frame"]
        res.update(stages_ms_per_frame=stages, **wavefront_checks(
            stream, n_frames, stages, name, wf, werrs))
        out[name] = res
    return out


def phase_inter_busy() -> dict:
    """torch.profiler over the reconstruction of the inter-LD stream's
    second picture, a P picture: the decoder reconstructs a picture when
    the next one begins, so pushing the first two pictures reconstructs
    the IDR outside the trace, and the traced flush reconstructs the P
    picture, closed by a synchronise.  Prints the device's busy share of
    that window and the kernels that take the most device time in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from vvdec_tpu_torch.decoder import StreamDecoder
    from vvdec_tpu_torch.streams import INTER_LD_STREAM_KW, inter_ld_stream
    stream = inter_ld_stream(**dict(INTER_LD_STREAM_KW, n=2))
    dec = StreamDecoder()
    pics = dec.push(stream)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("P picture"):
            pics += dec.flush()
            torch.cuda.synchronize()
    fail_unless([p.poc for p in pics] == [0, 1], f"the flush gave "
                f"pictures {[p.poc for p in pics]}")
    events = prof.events()
    win = [e for e in events if e.name == "P picture"
           and e.device_type == DeviceType.CPU]
    fail_unless(len(win) == 1, f"the trace holds {len(win)} P-picture ranges")
    a, b = win[0].time_range.start, win[0].time_range.end
    # the device side of the trace also shows the annotation itself
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name != "P picture")
    fail_unless(spans, "torch.profiler recorded no device activity")
    busy = busy_in(spans, a, b)
    by_name: dict = {}
    n_ops = 0
    for s0, s1, name in spans:
        if s1 > a and s0 < b:
            n_ops += 1
            by_name[name] = by_name.get(name, 0.0) + min(s1, b) - max(s0, a)
    print(f"[profile] P picture (inter-LD POC 1) under torch.profiler: wall "
          f"{(b - a) / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({busy / (b - a):.1%}), {n_ops} device kernels/copies")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile]   {t / 1e3:8.3f} ms  {name[:90]}")
    return dict(wall_ms=(b - a) / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / (b - a), device_ops=n_ops)


def access_units(stream: bytes) -> list:
    """The stream cut into access units: each VCL NAL with the non-VCL
    NALs before it (the streams here have one slice per picture);
    trailing non-VCL NALs join the last unit."""
    from vvdec_tpu_torch.bitstream.nal import is_vcl, split_annexb
    nals = split_annexb(stream)
    # each NAL with its start code (3 bytes, or 4 with a zero before)
    starts = [0] + [off - 4 if stream[off - 4] == 0 else off - 3
                    for off, _ in nals[1:]]
    units, cur = [], b""
    for (off, _), a, b in zip(nals, starts, starts[1:] + [len(stream)]):
        cur += stream[a:b]
        if is_vcl(stream[off + 1] >> 3):
            units.append(cur)
            cur = b""
    if cur:
        units[-1] += cur
    fail_unless(b"".join(units) == stream, "access units do not rejoin "
                "into the stream")
    return units


def api_decode(stream: bytes, n_frames: int, md5_pin: str, label: str,
               recorded: list, threads: int = 0, conceal=None) -> dict:
    """api.Decoder(DecoderParams(threads=...)) on CUDA fed access unit by
    access unit, then flushed, recording the ITX kernel's inputs, with
    the kernels' launch counts set to 0 just before and read just after.
    Fails unless the YUV has its pinned MD5, the census is empty, the
    ITX kernel ran once per frame and the deblock kernel twice per
    picture its wrapper filtered.  With `conceal` (a CONCEAL_CASES
    entry) the decoder conceals, and the output pictures, their error
    flags, error_pictures and the grey pictures must be the pinned ones,
    with one ITX launch per picture that is not grey."""
    import numpy as np
    import torch

    import vvdec_tpu_torch.ops.frame_device as frame_device
    from vvdec_tpu_torch.api import Decoder, DecoderParams
    from vvdec_tpu_torch.ops.cuda.deblock import deblock_dense_cuda
    from vvdec_tpu_torch.ops.cuda.intra import intra_wavefront_cuda
    from vvdec_tpu_torch.ops.cuda.itx import itx_batch_cuda, itx_frame_cuda
    aus = access_units(stream)
    log = WavefrontLog()
    dlog = DeblockLog()
    itx_frame_cuda.launches = 0
    itx_batch_cuda.launches = 0
    intra_wavefront_cuda.launches = 0
    deblock_dense_cuda.launches = 0
    frame_device.itx_frame_cuda = itx_recorder(recorded)
    try:
        with wavefront_recording(log), deblock_recording(dlog):
            t0 = time.perf_counter()
            dec = Decoder(DecoderParams(
                threads=threads, err_handling="conceal" if conceal else
                "strict"))
            frames, first = [], None
            for au in aus:
                frames += dec.decode(au)
                if frames and first is None:
                    first = time.perf_counter() - t0
            frames += dec.flush()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if first is None:   # every frame came out of the flush
                first = dt
    finally:
        frame_device.itx_frame_cuda = itx_frame_cuda
    launches = itx_frame_cuda.launches
    intra_launches = intra_wavefront_cuda.launches
    deblock_launches = deblock_dense_cuda.launches
    md5 = yuv_md5([f.planes for f in frames])
    census = dec.get_fallback_census()
    errors = tuple(f.poc for f in frames if f.picture.error)
    grey = sum(all(bool((p == 512).all()) for p in f.planes) for f in frames)
    n_err = dec._core.error_pictures
    shapes_ok = all(np.asarray(f.planes[0]).shape == (480, 832)
                    for f in frames)
    for f in frames:
        dec.frame_unref(f)
    print(f"[{label}] api.Decoder threads={threads} on cuda, {len(aus)} "
          f"access units: {len(frames)} frames in {dt:.3f} s = "
          f"{len(frames) / dt:.2f} frames/s; first frame after "
          f"{first:.3f} s; itx launches {launches} (itx_batch_cuda "
          f"{itx_batch_cuda.launches}); intra_wavefront launches "
          f"{intra_launches} for {log.pictures} pictures with intra units; "
          f"deblock launches {deblock_launches} for {dlog.pictures} "
          f"pictures; md5 {md5}; census {census}"
          + (f"; error POCs {errors}, error_pictures {n_err}, grey {grey}"
             if conceal else ""))
    fail_unless(len(frames) == n_frames, f"{label}: {len(frames)} frames, "
                f"expected {n_frames}")
    fail_unless(shapes_ok, f"{label}: unexpected plane shapes")
    fail_unless(md5 == md5_pin, f"{label}: md5 {md5} != pinned {md5_pin}")
    fail_unless(census == {}, f"{label}: fallback census {census}")
    if conceal:
        want = conceal[3:6]
        fail_unless((errors, n_err, grey) == want, f"{label}: error POCs, "
                    f"error_pictures, grey {(errors, n_err, grey)} != "
                    f"pinned {want}")
    fail_unless(launches == n_frames - grey, f"{label}: {launches} ITX "
                f"launches for {n_frames - grey} pictures decoded on the "
                f"device")
    fail_unless(intra_launches == log.pictures and intra_launches > 0,
                f"{label}: {intra_launches} intra_wavefront launches for "
                f"{log.pictures} pictures with intra units")
    fail_unless(deblock_launches == 2 * dlog.pictures > 0, f"{label}: "
                f"{deblock_launches} deblock launches for {dlog.pictures} "
                f"deblocked pictures")
    return dict(fps=len(frames) / dt, decode_s=dt, first_frame_s=first,
                launches=launches, intra_launches=intra_launches,
                deblock_launches=deblock_launches, md5=md5)


def phase_api(errs: list) -> dict:
    """(a) api.Decoder: the headline with threads 0, then 2, then the
    inter-LD stream with threads 3."""
    from vvdec_tpu_torch.streams import STREAMS
    runs = []
    for name, threads in (("headline", 0), ("headline", 2),
                          ("inter-LD", 3)):
        _, n_frames, md5_pin = STREAMS[name]
        recorded: list = []
        res = api_decode(built(name), n_frames, md5_pin, f"api {name}",
                         recorded, threads=threads)
        check_frames(recorded, errs, f"api {name}")
        runs.append(dict(res, stream=name, threads=threads))
    for threads in (0, 2):
        sel = [r for r in runs if r["stream"] == "headline"
               and r["threads"] == threads]
        print(f"[api] headline threads={threads}: frames/s "
              f"{[round(r['fps'], 3) for r in sel]}, first-frame delay "
              f"{[round(r['first_frame_s'], 3) for r in sel]} s")
    return dict(runs=runs, **{k: sum(r[k] for r in runs) for k in (
        "launches", "intra_launches", "deblock_launches")})


def phase_conceal(errs: list) -> dict:
    """(b) err_handling="conceal" over every concealment case, then the
    headline's first frame on a fresh decoder."""
    from vvdec_tpu_torch.streams import (CONCEAL_CASES, HEADLINE_FIRST_MD5,
                                         HEADLINE_STREAM_KW, conceal_variant)
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    base = built("inter-LD")
    runs = {}
    for name, case in CONCEAL_CASES.items():
        fault, poc, n_out = case[:3]
        recorded: list = []
        runs[name] = api_decode(conceal_variant(base, fault, poc), n_out,
                                case[6], name, recorded, conceal=case)
        check_frames(recorded, errs, name)
    one, _ = generate_stream(**dict(HEADLINE_STREAM_KW, n_frames=1))
    recorded = []
    after = api_decode(one, 1, HEADLINE_FIRST_MD5, "after concealment",
                       recorded)
    check_frames(recorded, errs, "after concealment")
    return dict(cases=runs, after=after, **{
        k: after[k] + sum(r[k] for r in runs.values()) for k in (
            "launches", "intra_launches", "deblock_launches")})


def phase_cli() -> dict:
    """(c) the vvdecapp CLI in a subprocess on the headline stream."""
    import tempfile

    from vvdec_tpu_torch.streams import HEADLINE_MD5
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "headline.266")
        out = os.path.join(tmp, "headline.yuv")
        with open(src, "wb") as f:
            f.write(built("headline"))
        cmd = [sys.executable, "-m", "vvdec_tpu_torch.app", "-b", src,
               "-o", out, "-t", "1", "-md5", HEADLINE_MD5]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        dt = time.perf_counter() - t0
        for line in (r.stdout + r.stderr).strip().splitlines()[-3:]:
            print(f"[cli]   {line}")
        print(f"[cli] python -m vvdec_tpu_torch.app -b headline.266 -o ... "
              f"-t 1 -md5 {HEADLINE_MD5}: rc {r.returncode} in {dt:.1f} s "
              f"(process start included)")
        fail_unless(r.returncode == 0, f"the CLI exited with rc "
                    f"{r.returncode}: {r.stderr[-2000:]}")
        with open(out, "rb") as f:
            md5 = hashlib.md5(f.read()).hexdigest()
        fail_unless(md5 == HEADLINE_MD5, f"the CLI's YUV md5 {md5}")
    return dict(rc=r.returncode, wall_s=dt)


def phase_pool() -> dict:
    """(d) decode_annexb_parallel over 2 spawned workers against serial
    decodes of the headline stream, alternating: pool, serial, pool,
    serial; the card's used memory before and while the pool is up."""
    import torch

    from vvdec_tpu_torch.decoder import decode_annexb
    from vvdec_tpu_torch.parallel import (decode_annexb_parallel,
                                          make_worker_pool)
    from vvdec_tpu_torch.streams import HEADLINE_MD5, STREAMS
    stream = built("headline")
    n_frames = STREAMS["headline"][1]
    workers = 2

    def used_mib():
        free, total = torch.cuda.mem_get_info()
        return (total - free) / 2**20

    torch.cuda.synchronize()
    before = used_mib()
    t0 = time.perf_counter()
    ex = make_worker_pool(workers, "cuda")
    try:
        start_s = time.perf_counter() - t0
        warm = used_mib()
        print(f"[pool] {workers} spawned workers up in {start_s:.1f} s; card "
              f"memory used {before:.0f} MiB before, {warm:.0f} MiB with the "
              f"pool up: {(warm - before) / workers:.0f} MiB per worker")
        runs, peak = [], warm
        for kind in ("pool", "serial", "pool", "serial"):
            t1 = time.perf_counter()
            if kind == "pool":
                frames = decode_annexb_parallel(stream, workers=workers,
                                                device="cuda", executor=ex)
                peak = max(peak, used_mib())
            else:
                frames = decode_annexb(stream)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            md5 = yuv_md5(frames)
            run = dict(kind=kind, fps=len(frames) / dt, decode_s=dt, md5=md5)
            if kind == "pool":
                reps = decode_annexb_parallel.worker_reports
                run["workers"] = reps
                fail_unless(sum(r["itx_launches"] for r in reps) == n_frames
                            == sum(r["frames"] for r in reps),
                            f"pool: worker reports {reps}")
                fail_unless(len({r["pid"] for r in reps}) == workers,
                            f"pool: the chunks ran in {reps}")
            print(f"[pool] {kind}: {len(frames)} frames in {dt:.3f} s = "
                  f"{len(frames) / dt:.2f} frames/s; md5 {md5}"
                  + ("".join(f"; worker {r['pid']}: {r['frames']} frames, "
                             f"{r['itx_launches']} itx launches, max memory "
                             f"reserved {r['max_memory_reserved'] / 2**20:.0f}"
                             f" MiB" for r in run.get("workers", ()))))
            fail_unless(len(frames) == n_frames and md5 == HEADLINE_MD5,
                        f"pool: {kind} decode gave {len(frames)} frames, md5 "
                        f"{md5}")
            runs.append(run)
    finally:
        ex.shutdown()
    pool = [r["fps"] for r in runs if r["kind"] == "pool"]
    serial = [r["fps"] for r in runs if r["kind"] == "serial"]
    print(f"[pool] frames/s pool {[round(x, 3) for x in pool]} vs serial "
          f"{[round(x, 3) for x in serial]}: "
          f"{sum(pool) / sum(serial):.2f}x; card memory with the pool up "
          f"{warm:.0f} MiB, at most {peak:.0f} MiB read during its decodes")
    return dict(runs=runs, start_s=start_s, used_mib_before=before,
                used_mib_pool_up=warm, used_mib_peak=peak,
                per_worker_mib=(warm - before) / workers)


def device_kernel_count(fn) -> int:
    """The device kernels and copies one fn() puts in a torch.profiler
    trace (after a warm call); the tracer can lose events, so this is a
    floor of what fn() launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def phase_multidevice(errs: list) -> dict:
    """11. The multi-device path on the one card, every mesh device
    cuda:0: (a) the SAO/ALF stream's first 2 pictures over a ("frame",
    "row") = (2, 2) mesh and its first picture over a ("row",) = 4 mesh
    (480 rows padded to 512), each bit-equal to the whole-frame chain;
    (b) filter_frames_device_batch over its 4 pictures, bit-equal to the
    per-frame chain, with the device kernels of the batch beside 4x one
    picture's; (c) the device-resident DPB over the inter-LD stream's
    first 4 pictures, round robin over 4 mesh devices, bit-equal to the
    per-frame decode; (d) the sequential intra scan of the headline's
    first 2 pictures through frame_parallel over a 2-device frame axis,
    bit-equal to the wavefront, with units per frame and ms per unit;
    (e) decode_annexb_multihost in 2 spawned gloo ranks over the
    headline stream, on HEADLINE_MD5, with each rank's card memory.  In
    (a)-(d) every device picture makes one ITX launch, held to the plain
    version."""
    import numpy as np
    import torch

    import vvdec_tpu_torch.ops.frame_device as frame_device
    import vvdec_tpu_torch.ops.sharded_chain as sharded_chain
    from vvdec_tpu_torch.ops import device_pipeline as dp
    from vvdec_tpu_torch.ops.cuda.deblock import deblock_dense_cuda
    from vvdec_tpu_torch.ops.cuda.itx import itx_frame_cuda
    from vvdec_tpu_torch.parallel import dryrun
    from vvdec_tpu_torch.parallel.distributed import decode_annexb_spawned
    from vvdec_tpu_torch.parallel.sharding import Mesh, make_decode_mesh
    from vvdec_tpu_torch.streams import HEADLINE_MD5, STREAMS
    card = torch.device("cuda:0")
    out: dict = {}
    recorded: list = []
    itx_frame_cuda.launches = 0
    pictures = 0
    frame_device.itx_frame_cuda = itx_recorder(recorded)
    try:
        # (a) the sharded chain
        items = dryrun.capture_filter_inputs(built("SAO/ALF"), card, n=4)
        pictures += 4
        fail_unless(len(items) == 4, f"captured {len(items)} pictures")
        keys = [dp._frame_key_arrays(cs, [tuple(p.shape) for p in pl])[0]
                for cs, pl in items]
        # every band's deblock goes through the kernel's wrapper
        bands: list = []

        def band_deblock(planes, *a, **k):
            before = deblock_dense_cuda.launches
            out = deblock_dense_cuda(planes, *a, **k)
            bands.append((tuple(planes[0].shape),
                          deblock_dense_cuda.launches - before))
            return out

        sharded_chain.deblock_dense_cuda = band_deblock
        try:
            fr = dryrun.sharded_chain_parity(
                items[:2], make_decode_mesh(4, rows=2, devices=[card] * 4))
            row = dryrun.sharded_chain_parity(
                items[:1], Mesh(np.array([card] * 4), ("row",)))
        finally:
            sharded_chain.deblock_dense_cuda = deblock_dense_cuda
        print(f"[multi] (a) deblock_dense_cuda on the bands: "
              f"{len(bands)} calls, {sum(n for _, n in bands)} launches, "
              f"bands {sorted(set(b for b, _ in bands))}")
        fail_unless(len(bands) == 2 * 2 + 4 and all(n == 2 for _, n in bands),
                    f"the sharded chains' deblock calls {bands}")
        h, ctu = items[0][1][0].shape[0], items[0][0].sps.ctu_size
        print(f"[multi] (a) SAO/ALF (ALF bank counts "
              f"{[k[16] for k in keys]}): 2 pictures over ('frame', 'row') "
              f"= (2, 2) in {fr['seconds'] * 1e3:.1f} ms and 1 picture over "
              f"('row',) = 4 ({h} rows padded to "
              f"{-(-h // (4 * ctu)) * ctu * 4}) in "
              f"{row['seconds'] * 1e3:.1f} ms, bit-equal to the whole-frame "
              f"chain")
        out["sharded"] = dict(frame_row=fr, row=row, deblock_bands=bands)

        # (b) the batched chain
        from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda
        before = deblock_dense_cuda.launches
        sa_before = sao_alf_cuda.launches
        batch = dp.filter_frames_device_batch(items)
        batch_launches = deblock_dense_cuda.launches - before
        sa_launches = sao_alf_cuda.launches - sa_before
        fail_unless(batch_launches == 2, f"the batched chain of 4 pictures "
                    f"made {batch_launches} deblock launches, not 2")
        fail_unless(sa_launches == 2, f"the batched chain of 4 pictures "
                    f"made {sa_launches} SAO/ALF launches, not 2")
        for i, (pf, (cs, planes)) in enumerate(zip(batch, items)):
            for c, (a, b) in enumerate(zip(
                    pf.resolve(), dp.filter_frame_device(cs, planes)
                    .resolve())):
                fail_unless(np.array_equal(a, b), f"batched chain picture "
                            f"{i} plane {c} != per-frame chain")

        def run_batch():
            dp.filter_frames_device_batch(items)

        def run_frames():
            for cs, planes in items:
                dp.filter_frame_device(cs, planes)

        k_batch = device_kernel_count(run_batch)
        k_one = device_kernel_count(lambda: dp.filter_frame_device(*items[0]))
        ms_batch = cuda_ms(run_batch, 3)
        ms_frames = cuda_ms(run_frames, 3)
        print(f"[multi] (b) filter_frames_device_batch of 4 pictures: "
              f"{batch_launches} deblock launches, {sa_launches} SAO/ALF "
              f"launches; "
              f"{k_batch} device kernels/copies against 4 x {k_one} = "
              f"{4 * k_one} for 4 per-frame chains; {ms_batch:.2f} ms against"
              f" {ms_frames:.2f} ms per 4 pictures (stream time); bit-equal")
        out["batch"] = dict(kernels=k_batch, kernels_one=k_one,
                            ms=ms_batch, ms_per_frame_chains=ms_frames,
                            deblock_launches=batch_launches,
                            sao_alf_launches=sa_launches)

        # (c) the device-resident DPB
        dpb = dryrun.device_dpb_parity(built("inter-LD"), [card] * 4, n=4)
        pictures += 8   # the per-frame decode and the DPB's
        print(f"[multi] (c) device-resident DPB: inter-LD's first "
              f"{dpb['pictures']} pictures round robin over 4 mesh devices "
              f"in {dpb['seconds']:.2f} s, {dpb['itx_launches']} ITX "
              f"launches; bit-equal to the per-frame decode")
        fail_unless(dpb["itx_launches"] == dpb["pictures"],
                    f"{dpb['itx_launches']} ITX launches for "
                    f"{dpb['pictures']} DPB pictures")
        out["dpb"] = dpb

        # (d) the sequential scan over the frame axis
        scan = dryrun.frame_parallel_scan_parity(
            built("headline"), Mesh(np.array([card] * 2), ("frame",)), n=2)
        pictures += 2
        print(f"[multi] (d) sequential intra scan, headline's first 2 "
              f"pictures over a 2-device frame axis: "
              f"{scan['units_per_frame']:.1f} units per frame, "
              f"{scan['seconds']:.2f} s = {scan['ms_per_unit']:.3f} ms per "
              f"unit; bit-equal to the wavefront")
        out["seq_scan"] = scan
    finally:
        frame_device.itx_frame_cuda = itx_frame_cuda
    launches = itx_frame_cuda.launches
    fail_unless(launches == pictures == len(recorded), f"{launches} ITX "
                f"launches, {len(recorded)} recorded, for {pictures} device "
                f"pictures")
    check_frames(recorded, errs, "multi")

    # (e) two gloo ranks on the card
    t0 = time.perf_counter()
    frames, reports = decode_annexb_spawned(built("headline"), ranks=2)
    dt = time.perf_counter() - t0
    md5 = yuv_md5([planes for _, planes in frames])
    n_frames = STREAMS["headline"][1]
    for r in reports:
        print(f"[multi] (e) rank {r['rank']} (pid {r['pid']}, {r['device']}):"
              f" decode {r['decode_s']:.2f} s, {r['itx_launches']} ITX "
              f"launches, card memory: max allocated "
              f"{r['max_memory_allocated'] / 2**20:.0f} MiB, max reserved "
              f"{r['max_memory_reserved'] / 2**20:.0f} MiB")
    print(f"[multi] (e) decode_annexb_multihost, 2 gloo ranks (file store): "
          f"{len(frames)} frames in {dt:.2f} s (spawn included); md5 {md5}")
    fail_unless(len(frames) == n_frames and md5 == HEADLINE_MD5,
                f"2 ranks: {len(frames)} frames, md5 {md5}")
    fail_unless(sum(r["itx_launches"] for r in reports) == n_frames,
                f"the ranks' ITX launches {reports}")
    out["ranks"] = dict(reports=reports, seconds=dt, md5=md5)
    return dict(out, launches=launches, deblock_launches=sum(
        n for _, n in bands) + batch_launches)


# phase 12: the streams (name in streams.STREAMS or a builder here) and
# how many of their first pictures go through the whole-frame stages;
# the three streams earlier phases decode give one picture each, to keep
# the whole run near its time
FRAME_STAGE_STREAMS = (("headline", 1), ("tool-rich", 1), ("SAO/ALF", 1),
                       ("vb", 2), ("tiles-ALF", 2))


def _stage_streams() -> dict:
    from vvdec_tpu_torch.streams import (TILES_ALF_STREAM_KW, VB_STREAM_KW,
                                         tiles_alf_stream, vb_stream)
    return {"vb": lambda: vb_stream(**VB_STREAM_KW),
            "tiles-ALF": lambda: tiles_alf_stream(**TILES_ALF_STREAM_KW)}


def frame_stage_pictures(name: str, n: int) -> list:
    """The first n parsed pictures of a phase-12 stream."""
    from vvdec_tpu_torch.decoder import parse_annexb
    from vvdec_tpu_torch.parallel.dryrun import first_pictures
    extra = _stage_streams()
    if name in extra:
        stream = BUILT.get(name) or BUILT.setdefault(name, extra[name]())
        pics = parse_annexb(stream)[:n]
    else:
        pics = parse_annexb(first_pictures(built(name), n))
    fail_unless(len(pics) == n, f"{name}: {len(pics)} pictures, not {n}")
    return [p.cs for p in pics]


def _host_golden(cs) -> list:
    """The vendored host decoder's reconstruction and filters."""
    from vvdec_tpu_torch.frame.alf_np import alf_frame_vec
    from vvdec_tpu_torch.frame.deblock_np import deblock_frame
    from vvdec_tpu_torch.frame.recon_np import IntraReconstructor
    from vvdec_tpu_torch.frame.sao_np import sao_frame
    planes = IntraReconstructor(cs).run()
    deblock_frame(cs, planes)
    sao_frame(cs, planes)
    return alf_frame_vec(cs, planes)


class StageClock:
    """Per stage: host wall ms and the stream's ms between two CUDA
    events around the call (each stage ends in a readback, so the two
    agree but for the host's own work before the first launch)."""

    def __init__(self):
        self.ms: dict = {}

    def wrap(self, name, fn):
        import torch

        def run(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            ev[0].record()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            wall = (time.perf_counter() - t0) * 1e3
            ev[1].record()
            ev[1].synchronize()
            self.ms[name] = (wall, ev[0].elapsed_time(ev[1]))
            return out
        return run


def phase_frame_stages(errs: list) -> dict:
    """12. The whole-frame stages of vvdec_tpu_torch/ops/pipeline.py on
    the card: per picture reconstruct_frame_torch (itx_frame_torch, the
    host prediction, deblock_frame_torch), sao_frame_torch and
    alf_frame_torch, each picture bit-equal to the vendored host golden
    on the same parsed picture; every plain 2-D TU group without a
    scaling list one itx_batch_cuda launch, held to itx_batch_ref."""
    import collections

    import numpy as np
    import torch

    import vvdec_tpu_torch.frame.recon_np as recon_np
    import vvdec_tpu_torch.ops.pipeline as P
    from vvdec_tpu_torch.ops.cuda.itx import itx_batch_cuda, itx_batch_ref
    from vvdec_tpu_torch.ops.device_pipeline import \
        device_filter_reject_reason
    dev = torch.device("cuda")
    saved = {k: getattr(P, k) for k in (
        "itx_batch_cuda", "_itx_fn", "_itx_lfnst_fn", "itx_frame_torch",
        "deblock_frame_torch", "_deblock_luma_cells_core",
        "_deblock_chroma_cells_core")}
    saved_ts = recon_np.ts_residual
    groups: list = []
    routes: collections.Counter = collections.Counter()
    cells: collections.Counter = collections.Counter()

    def recorder(levels, scale, rshift, imax, mv, mh, *, h, w, bit_depth):
        out = saved["itx_batch_cuda"](levels, scale, rshift, imax, mv, mh,
                                      h=h, w=w, bit_depth=bit_depth)
        # the inputs are views of the stage's upload, never written again
        groups.append(dict(args=(levels, scale, rshift, imax, mv, mh), h=h,
                           w=w, bit_depth=bit_depth, out=out))
        return out

    def itx_factory(h, w, hor, ver, bd, dq, use_sl=False):
        routes["scaling list" if use_sl else "1-D" if min(h, w) == 1
               else "kernel"] += 1
        return saved["_itx_fn"](h, w, hor, ver, bd, dq, use_sl=use_sl)

    def lfnst_factory(*a, **k):
        routes["lfnst"] += 1
        return saved["_itx_lfnst_fn"](*a, **k)

    def ts_residual(*a):
        routes["transform skip (host)"] += 1
        return saved_ts(*a)

    def cell_factory(kind, factory):
        def make(*a):
            fn = factory(*a)

            def run(plane, c, prm, n_valid):
                cells[(kind, a[2])] += n_valid
                return fn(plane, c, prm, n_valid)
            return run
        return make

    out: dict = {}
    stage_names = ("itx", "host recon", "deblock", "sao", "alf")
    print(f"[stages] per picture: ms of each stage, host wall / CUDA "
          f"events; 'host recon' is reconstruct_frame_torch less its ITX "
          f"and deblocking; ITX groups by route and itx_batch_cuda "
          f"launches; deblocking cells (luma, chroma) per direction")
    headline_groups: list = []
    try:
        for name, n in FRAME_STAGE_STREAMS:
            t0 = time.perf_counter()
            css = frame_stage_pictures(name, n)
            reasons = {device_filter_reject_reason(cs) for cs in css}
            print(f"[stages] {name}: {n} pictures parsed in "
                  f"{time.perf_counter() - t0:.2f} s; the device filter "
                  f"chain's verdict: {sorted(map(str, reasons))}")
            if name in ("vb", "tiles-ALF"):
                fail_unless(None not in reasons, f"{name}: the device filter "
                            f"chain accepts it")
            per_pic = []
            for i, cs in enumerate(css):
                t_gold = time.perf_counter()
                want = _host_golden(cs)
                t_gold = time.perf_counter() - t_gold
                clock = StageClock()
                groups.clear()
                routes.clear()
                cells.clear()
                P.itx_batch_cuda = recorder
                P._itx_fn = itx_factory
                P._itx_lfnst_fn = lfnst_factory
                recon_np.ts_residual = ts_residual
                P.itx_frame_torch = clock.wrap("itx", saved["itx_frame_torch"])
                P.deblock_frame_torch = clock.wrap(
                    "deblock", saved["deblock_frame_torch"])
                P._deblock_luma_cells_core = cell_factory(
                    "luma", saved["_deblock_luma_cells_core"])
                P._deblock_chroma_cells_core = cell_factory(
                    "chroma", saved["_deblock_chroma_cells_core"])
                itx_batch_cuda.launches = 0
                try:
                    t_run = time.perf_counter()
                    planes = clock.wrap("recon", P.reconstruct_frame_torch)(
                        cs, dev)
                    clock.wrap("sao", P.sao_frame_torch)(cs, planes, dev)
                    got = clock.wrap("alf", P.alf_frame_torch)(cs, planes,
                                                               dev)
                    t_run = time.perf_counter() - t_run
                finally:
                    for k, v in saved.items():
                        setattr(P, k, v)
                    recon_np.ts_residual = saved_ts
                launches = itx_batch_cuda.launches
                for c, (a, b) in enumerate(zip(got, want)):
                    fail_unless(a.shape == b.shape and np.array_equal(a, b),
                                f"{name} picture {i} plane {c}: the stages "
                                f"differ from the host golden")
                fail_unless(launches == routes["kernel"] == len(groups),
                            f"{name} picture {i}: {launches} itx_batch_cuda "
                            f"launches for {routes['kernel']} plain groups "
                            f"({len(groups)} recorded)")
                for g in groups:
                    ref = itx_batch_ref(*g["args"], h=g["h"], w=g["w"],
                                        bit_depth=g["bit_depth"])
                    err = int((g["out"] - ref).abs().max()) \
                        if ref.numel() else 0
                    errs.append(err)
                    fail_unless(err == 0, f"{name} picture {i}: itx "
                                f"{g['h']}x{g['w']} group of "
                                f"{ref.shape[0]} TUs: max |err| {err}")
                if name == "headline":
                    headline_groups.append(list(groups))
                ms = dict(clock.ms)
                ms["host recon"] = tuple(r - a - b for r, a, b in zip(
                    ms.pop("recon"), ms["itx"], ms["deblock"]))
                line = "; ".join(f"{k} {ms[k][0]:.1f}/{ms[k][1]:.1f}"
                                 for k in stage_names)
                cell_line = ", ".join(
                    f"dir {d}: {cells[('luma', d)]} + {cells[('chroma', d)]}"
                    for d in (0, 1))
                print(f"[stages] {name} #{i}: {line} ms (all {t_run * 1e3:.0f}"
                      f" ms; host golden {t_gold * 1e3:.0f} ms); groups "
                      f"{dict(routes)}, {launches} itx_batch_cuda launches; "
                      f"cells {cell_line}; bit-equal")
                per_pic.append(dict(
                    ms={k: ms[k] for k in stage_names}, all_ms=t_run * 1e3,
                    golden_ms=t_gold * 1e3, routes=dict(routes),
                    launches=launches,
                    cells={f"{k}/{d}": v for (k, d), v in cells.items()}))
            out[name] = per_pic
    finally:
        for k, v in saved.items():
            setattr(P, k, v)
        recon_np.ts_residual = saved_ts
    launches = sum(p["launches"] for pics in out.values() for p in pics)
    fail_unless(launches > 0, "phase 12 launched itx_batch_cuda no time")
    out["launches"] = launches
    out.update(batch_times(headline_groups))
    return out


def batch_times(frames: list) -> dict:
    """Per frame (the groups one picture's itx_frame_torch launched):
    the kernel's and the plain version's device time (torch.profiler),
    the wrapper calls' stream time (CUDA events) and the bound, with the
    wrapper's int32 levels."""
    from vvdec_tpu_torch.ops.cuda.itx import itx_batch_cuda, itx_batch_ref
    n_frames = len(frames)
    groups = [g for f in frames for g in f]

    def run(fn):
        for g in groups:
            fn(*g["args"], h=g["h"], w=g["w"], bit_depth=g["bit_depth"])

    k_ms = device_ms(lambda: run(itx_batch_cuda), 10, "itx_kernel",
                     launches=len(groups)) / n_frames
    p_ms = device_ms(lambda: run(itx_batch_ref), 3) / n_frames
    c_ms = cuda_ms(lambda: run(itx_batch_cuda), 10) / n_frames
    work = [sum(v) for v in zip(*(itx_work(g["args"][0].shape[0], g["h"],
                                           g["w"], level_bytes=4)
                                  for g in groups))]
    b_ms, by = bound_ms(work[0] / n_frames, work[1] / n_frames)
    print(f"[stages] itx_batch per headline frame (mean of {n_frames}): "
          f"{len(groups) / n_frames:.1f} launches; device time kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms;"
          f" bound {b_ms:.6f} ms ({by}); stream time of the wrapper calls "
          f"{c_ms:.4f} ms (each call waits for its int8 check)")
    return dict(batch_ms=k_ms, batch_plain_ms=p_ms, batch_call_ms=c_ms,
                batch_bound_ms=b_ms, batch_bound_by=by,
                batch_launches_per_frame=len(groups) / n_frames)


def build_stream(name: str) -> tuple:
    """(the stream `name` of streams.STREAMS, seconds it took to make);
    phase 13's streams are made by this in the background builders."""
    from vvdec_tpu_torch.streams import STREAMS
    t0 = time.perf_counter()
    stream = STREAMS[name][0]()
    return stream, time.perf_counter() - t0


def start_bench_builds():
    """Three spawned processes that make phase 13's streams (about 80 s
    of the host's CPU in all) while phase 3 measures the kernel on the
    card, the largest first.  Fills BACKGROUND; returns the executor."""
    import concurrent.futures
    import multiprocessing

    from vvdec_tpu_torch.streams import BENCH_STREAMS, STREAMS, picture_size

    def area(name):
        w, h = picture_size(BENCH_STREAMS[name])
        return w * h * STREAMS[name][1]
    ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    order = sorted(BENCH_STREAMS, key=area, reverse=True)
    BACKGROUND.update((name, ex.submit(build_stream, name))
                      for name in order)
    return ex


def wait_bench_builds() -> None:
    """Wait for the background builds, so that no build competes with
    the host work of the decodes that phases 4-13 time."""
    for name, fut in BACKGROUND.items():
        stream, seconds = fut.result()
        print(f"[builds] {name}: {len(stream)} bytes in {seconds:.1f} s")


# phase 13: the streams whose every frame's ITX launch is timed and
# printed on its own; the launches of one frame that each of those
# torch.profiler traces holds (short traces lose most of their events,
# long ones nearly none: PERF.md §7)
PER_FRAME_ITX = ("max-density q22", "SAO/ALF 1080p", "inter-LD 1080p")
TRACE_LAUNCHES = 300


def itx_per_frame(recorded, label: str, verbose: bool, reps: int = 11
                  ) -> dict:
    """The ITX kernel on the recorded frames (tensors on the card), timed
    as the headline's frames are (frame_times): the kernel's device time
    by torch.profiler (device_ms) over TRACE_LAUNCHES launches, the
    wrapper calls' stream time (cuda_ms over reps back-to-back calls, the
    host's cost between launches included), the bound (frame_work) and
    the plain version's device time.  With `verbose`, per frame (each in
    a trace of its own, printed) and their means; else only the means,
    from one trace of every frame."""
    from vvdec_tpu_torch.ops.cuda.itx import (itx_frame_cuda, itx_frame_ref,
                                              table_rows)
    resis = [[r.clone() for r in rec["resi"]] for rec in recorded]
    n = len(recorded)
    frames = []
    for i, (rec, resi) in enumerate(zip(recorded, resis)):
        def run(rec=rec, resi=resi):
            run_frame(itx_frame_cuda, rec, resi)

        rows = table_rows(rec["table"], rec["n_tasks"])
        b_ms, by = bound_ms(*frame_work(rows)[:2])
        f = dict(tus=len(rows), blocks=rec["n_tasks"], bound_ms=b_ms,
                 bound_by=by)
        if verbose:
            f.update(ms=device_ms(run, TRACE_LAUNCHES, "itx_kernel",
                                  launches=1),
                     call_ms=cuda_ms(run, reps))
            print(f"[{label}] itx frame {i}: {len(rows)} TUs in "
                  f"{rec['n_tasks']} blocks; kernel {f['ms']:.4f} ms device"
                  f", {f['call_ms']:.4f} ms call; bound {b_ms:.6f} ms ({by})")
        frames.append(f)

    def run_all(fn=itx_frame_cuda):
        for rec, resi in zip(recorded, resis):
            run_frame(fn, rec, resi)

    mean = {k: sum(f[k] for f in frames) / n
            for k in frames[0] if k not in ("blocks", "bound_by")}
    if not verbose:
        mean["ms"] = device_ms(run_all, -(-TRACE_LAUNCHES // n),
                               "itx_kernel", launches=n) / n
        mean["call_ms"] = cuda_ms(run_all, reps) / n
    p_ms = device_ms(lambda: run_all(itx_frame_ref), 1) / n
    print(f"[{label}] itx per frame (mean of {n}): {mean['tus']:.1f} kernel "
          f"TUs; device time kernel {mean['ms']:.4f} ms, plain {p_ms:.4f} "
          f"ms; bound {mean['bound_ms']:.6f} ms; stream time of the calls: "
          f"wrapper {mean['call_ms']:.4f} ms")
    return dict(frames=frames, kernel_tus_per_frame=mean["tus"],
                itx_ms=mean["ms"], itx_plain_ms=p_ms,
                itx_call_ms=mean["call_ms"], itx_bound_ms=mean["bound_ms"])


def phase_bench_configs(errs: list, werrs: list, derrs: list,
                        serrs: list) -> dict:
    """13. The rest of bench.py's configurations: dense q27, max-density
    q22, all eight frames of tool-rich and SAO/ALF, SAO/ALF 1920x1080 and
    inter-LD 1920x1080, made by the background builders.  Per stream two
    decodes through a StreamDecoder: the first records in host memory
    the ITX kernel's inputs, the intra wavefront's (of the first picture,
    of every 1080p IDR picture) and the deblock's (every picture); the
    second, with the stage profiler on, records nothing and gives the
    stage split, the intra steps a frame, frames/s and the card's peak
    allocated memory.  Each must give the pinned MD5 (and the 4-frame
    pin on an 8-frame stream's first 4 frames), an empty census, one
    itx_frame_cuda launch per frame, one intra_wavefront_cuda launch per
    picture with intra units and two deblock launches per picture.  The ITX kernel is held to its plain version on
    every recorded frame and timed (itx_per_frame) per frame on the
    PER_FRAME_ITX streams and over all the tool-rich frames; the intra
    wavefront kernel on every recorded picture (check_wavefront); the
    deblock kernel on every picture's pre-deblock planes (check_deblock),
    timed per frame on the 1080p streams (deblock_times); on the SAO/ALF
    streams, the SAO/ALF kernels (two launches a picture) on every
    picture's post-deblock planes (check_sao_alf), timed per frame
    (sao_alf_times)."""
    import torch

    from vvdec_tpu_torch.streams import (BENCH_STREAMS, PREFIXES, STREAMS,
                                         picture_size)
    # an 8-frame stream's first pictures must give the pin of the shorter
    # stream they are
    prefix_pins = {long: STREAMS[short][1:] for short, long in
                   PREFIXES.items()}
    out = {}
    for name, kw in BENCH_STREAMS.items():
        _, n_frames, md5_pin = STREAMS[name]
        w, h = picture_size(kw)
        stream, build_s = BACKGROUND[name].result()
        print(f"[{name}] stream {w}x{h} x {n_frames} frames, {len(stream)} "
              f"bytes, made in {build_s:.1f} s in the background")
        recorded: list = []
        # every picture of SAO/ALF 1080p is an IDR; inter-LD 1080p's first
        wf = WavefrontLog(keep=n_frames if name == "SAO/ALF 1080p" else 1,
                          host=True)
        db = DeblockLog(keep=n_frames, host=True)
        sa = SaoAlfLog(keep=n_frames, host=True)
        # the first decode records the kernels' inputs in host memory;
        # the stage split, frames/s and peak memory come from the second,
        # which records nothing
        first = timed_decode(stream, n_frames, md5_pin, name, size=(w, h),
                             recorded=recorded, prefix=prefix_pins.get(name),
                             wavefront=wf, deblock=db, sao_alf=sa)
        if name.startswith("SAO/ALF"):
            fail_unless(first["sao_alf_launches"] == 2 * n_frames
                        == 2 * sa.pictures, f"{name}: "
                        f"{first['sao_alf_launches']} SAO/ALF launches for "
                        f"{sa.pictures} pictures of {n_frames}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = timed_decode(stream, n_frames, md5_pin, name, size=(w, h),
                           prefix=prefix_pins.get(name), profile=True)
        peak = torch.cuda.max_memory_allocated()
        steps = res["stages_ms_per_frame"]["intra steps a frame"]
        print(f"[{name}] {steps:.1f} intra steps a frame; card memory: peak "
              f"allocated {peak / 2**20:.1f} MiB in the profiled decode")
        res.update(bytes=len(stream), build_s=build_s, peak_allocated=peak)
        fail_unless(len(recorded) == n_frames, f"{name}: the decode made "
                    f"{len(recorded)} itx_frame_cuda calls for {n_frames} "
                    f"frames")
        t0 = time.perf_counter()
        recorded = [on_card(r) for r in recorded]
        check_frames(recorded, errs, name)
        check_deblock(db.recorded, derrs, name)
        if w == 1920:
            res.update(deblock_times(db.recorded, name))
        del db
        check_sao_alf(sa.recorded, serrs, name)
        if sa.recorded:
            res.update(sao_alf_times(sa.recorded, name))
        del sa
        if name in PER_FRAME_ITX or name == "tool-rich 8":
            res.update(itx_per_frame(recorded, name,
                                     verbose=name in PER_FRAME_ITX))
        del recorded
        res.update(wavefront_checks(stream, n_frames, res[
            "stages_ms_per_frame"], name, wf, werrs, plain_time=wf.keep,
            sweep=int(name == "SAO/ALF 1080p")))
        print(f"[{name}] the checks and times of the recorded frames took "
              f"{time.perf_counter() - t0:.1f} s")
        del wf
        torch.cuda.empty_cache()
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the details as JSON here")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "vvdec_tpu_torch")):
        print(f"chip_smoke: no vvdec_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    t_run = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s "
              f"(run so far {time.perf_counter() - t_run:.1f} s)")
        return out

    builder = None
    try:
        card = timed("card", phase_card)
        timed("build", phase_build)
        builder = start_bench_builds()
        errs: list = []
        # the one-group comparisons of phase 3 count for both entries
        errs_kernel: list = []
        timed("kernel", phase_kernel_vs_plain, errs_kernel)
        derrs: list = []   # the deblock kernel's comparisons
        timed("deblock kernel", phase_deblock_vs_plain, derrs)
        serrs: list = []   # the SAO/ALF kernels' comparisons
        timed("SAO/ALF kernels", phase_sao_alf_vs_plain, serrs)
        timed("stream builds", wait_bench_builds)
        errs += errs_kernel
        werrs: list = []   # the intra wavefront kernel's comparisons
        main_path = timed("main", phase_main_path, errs, werrs, derrs)
        lmcs = timed("LMCS", phase_lmcs, errs, werrs, derrs)
        inter = timed("inter", phase_inter, errs, werrs, derrs)
        ra = timed("RA", phase_ra, errs, werrs, derrs)
        host = timed("host recon", phase_host_recon, errs, werrs, derrs)
        main_path["profile"] = timed("profile", phase_device_busy)
        inter["profile P picture"] = timed("profile P", phase_inter_busy)
        surface = dict(api=timed("public surface: api", phase_api, errs),
                       conceal=timed("public surface: conceal",
                                     phase_conceal, errs),
                       cli=timed("public surface: cli", phase_cli),
                       pool=timed("public surface: pool", phase_pool))
        multi = timed("multi-device", phase_multidevice, errs)
        batch_errs = list(errs_kernel)
        stages = timed("frame stages", phase_frame_stages, batch_errs)
        errs += batch_errs
        bench = timed("bench configurations", phase_bench_configs, errs,
                      werrs, derrs, serrs)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if builder is not None:
            builder.shutdown(wait=True, cancel_futures=True)
    launches = main_path["launches"] + sum(
        r["launches"] for r in (lmcs, inter["inter-LD"],
                                inter["inter-LDB tools"], ra, host,
                                surface["api"], surface["conceal"],
                                multi, *bench.values()))
    intra_launches = sum(
        r["intra_launches"] for r in (main_path, lmcs, inter["inter-LD"],
                                      inter["inter-LDB tools"], ra, host,
                                      surface["api"], surface["conceal"],
                                      *bench.values()))
    # the same decodes', and phase 11's sharded and batched chains'
    deblock_launches = sum(
        r["deblock_launches"] for r in (main_path, lmcs, inter["inter-LD"],
                                        inter["inter-LDB tools"], ra, host,
                                        surface["api"], surface["conceal"],
                                        multi, *bench.values()))
    # the timed decodes' and phase 11's batched chain's
    sao_alf_launches = multi["batch"]["sao_alf_launches"] + sum(
        r["sao_alf_launches"] for r in (main_path, lmcs, inter["inter-LD"],
                                        inter["inter-LDB tools"], ra, host,
                                        *bench.values()))
    sa8 = bench["SAO/ALF 8"]
    # the headline's first picture, the one both versions were timed on
    head = main_path["intra_kernel"][0]
    kernels = [dict(
        name="itx_frame", route="cuda", source="vvdec_tpu_torch/csrc/itx.cu",
        replaces="vvdec_tpu/ops/pallas/itx.py:96",
        launches=launches, max_abs_err=max(errs),
        ms=main_path["itx_ms"], plain_ms=main_path["itx_plain_ms"],
        bound_ms=main_path["itx_bound_ms"],
        bound_by=main_path["itx_bound_by"], library_ms=None,
        call_ms=main_path["itx_call_ms"]), dict(
        name="itx_batch", route="cuda", source="vvdec_tpu_torch/csrc/itx.cu",
        replaces="vvdec_tpu/ops/pallas/itx.py:96",
        launches=stages["launches"], max_abs_err=max(batch_errs),
        ms=stages["batch_ms"], plain_ms=stages["batch_plain_ms"],
        bound_ms=stages["batch_bound_ms"],
        bound_by=stages["batch_bound_by"], library_ms=None,
        call_ms=stages["batch_call_ms"]), dict(
        name="intra_wavefront", route="cuda",
        source="vvdec_tpu_torch/csrc/intra_wavefront.cu",
        replaces="vvdec_tpu/ops/intra_device.py:823",
        launches=intra_launches, max_abs_err=max(werrs),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None,
        floor_ms=head["floor_ms"], phases=head["phases"]), dict(
        name="deblock", route="cuda", source="vvdec_tpu_torch/csrc/deblock.cu",
        replaces="vvdec_tpu/ops/device_pipeline.py:634",
        launches=deblock_launches, max_abs_err=max(derrs),
        ms=main_path["deblock_ms"], plain_ms=main_path["deblock_plain_ms"],
        bound_ms=main_path["deblock_bound_ms"],
        bound_by=main_path["deblock_bound_by"], library_ms=None,
        call_ms=main_path["deblock_call_ms"],
        bound_two_pass_ms=main_path["deblock_bound_two_pass_ms"]), dict(
        name="sao_alf", route="cuda", source="vvdec_tpu_torch/csrc/sao_alf.cu",
        replaces="vvdec_tpu/ops/device_pipeline.py:503-634",
        launches=sao_alf_launches, max_abs_err=max(serrs),
        ms=sa8["sao_alf_ms"], sao_ms=sa8["sao_ms"], alf_ms=sa8["alf_ms"],
        plain_ms=sa8["sao_alf_plain_ms"], bound_ms=sa8["sao_alf_bound_ms"],
        bound_by=sa8["sao_alf_bound_by"], library_ms=None,
        call_ms=sa8["sao_alf_call_ms"],
        bound_two_launch_ms=sa8["sao_alf_bound_two_launch_ms"])]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, kernels=kernels, main_path=main_path,
                           lmcs=lmcs, inter=inter, ra=ra,
                           host_recon=host, public_surface=surface,
                           multi_device=multi, frame_stages=stages,
                           bench_configurations=bench), f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
