"""GOP/segment-parallel decoding (host plane).

The frame-level pipeline-parallelism analog (reference P2: parse-ahead +
2 rotating DecLibRecon instances, DecLib.cpp:612-635) taken to its
distributed form (BASELINE config 5): an Annex-B stream splits at IRAP
boundaries into independently decodable segments, decoded concurrently
across worker processes (one per host core) or, multi-host, across hosts.

A copy of vvdec_tpu/parallel/gop.py with `device` in place of `use_jax`.
Workers are spawned, never forked, so each opens its own CUDA context on
the card; the parent builds the CUDA kernels and the host C extensions
before it spawns them, so workers only load the built libraries.  A
worker that fails to build, load or launch fails the whole decode: no
worker drops to the CPU.  Each worker reports, per chunk of segments,
its pid, its frames, its ITX kernel launches and its CUDA caching
allocator's peak (`decode_annexb_parallel.worker_reports`).
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np


def split_irap_segments(data: bytes) -> list[bytes]:
    """Split a stream into (header + segment) chunks at IRAP pictures.

    Non-VCL NALs seen before the first VCL of a segment travel with that
    segment; parameter sets seen anywhere are replicated into the shared
    header so later segments can tune in independently (the reference's
    random-access semantics: any IRAP is a valid tune-in point)."""
    from vvdec_tpu_torch.bitstream.nal import (NalUnitType, is_irap, is_vcl,
                                         split_annexb)

    header = bytearray()
    segments: list[bytearray] = []
    seg_hdr_len: list[int] = []  # header prefix active at segment start
    pending = bytearray()  # non-VCL NALs preceding the next VCL
    for off, size in split_annexb(data):
        raw = b"\x00\x00\x01" + data[off:off + size]
        t = data[off + 1] >> 3  # nal_unit_type (2nd header byte, bits 7..3)
        if t in (NalUnitType.SPS, NalUnitType.PPS, NalUnitType.VPS,
                 NalUnitType.PREFIX_APS, NalUnitType.SUFFIX_APS):
            # parameter sets (incl. APS) replicate into the header so
            # later segments tune in independently; each segment gets
            # only the prefix seen before its first VCL plus its own
            # in-segment NALs, preserving slot-overwrite order
            header += raw
            pending += raw
            continue
        if not is_vcl(t):
            pending += raw
            continue
        if is_irap(t) or not segments:
            segments.append(bytearray())
            seg_hdr_len.append(len(header))
        segments[-1] += pending
        pending = bytearray()
        segments[-1] += raw
    if pending and segments:
        segments[-1] += pending
    return [bytes(header[:hl]) + bytes(s)
            for hl, s in zip(seg_hdr_len, segments)]


def _decode_segment_shm(args):
    """Decode a chunk of segments and return all frames through ONE
    shared-memory block (descriptor only over the pipe) — the result
    pipe otherwise serializes ~1-2 MB per frame, and per-segment tasks
    pay pool dispatch + shm setup per frame; both cap pool scaling.
    The third item is this worker's report of the chunk."""
    segs, device, threads = args
    from multiprocessing import shared_memory

    import torch

    from vvdec_tpu_torch.decoder import decode_annexb
    from vvdec_tpu_torch.device import resolve_device
    from vvdec_tpu_torch.ops.cuda.itx import itx_frame_cuda
    dev = resolve_device(device)
    launches0 = itx_frame_cuda.launches
    frames = []
    for seg in segs:
        frames.extend(decode_annexb(seg, device=dev, threads=threads))
    report = dict(pid=os.getpid(), frames=len(frames),
                  itx_launches=itx_frame_cuda.launches - launches0,
                  max_memory_reserved=torch.cuda.max_memory_reserved(dev)
                  if dev.type == "cuda" else None)
    total = sum(p.nbytes for planes in frames for p in planes)
    if total == 0:
        return None, [], report
    shm = shared_memory.SharedMemory(create=True, size=total)
    metas, off = [], 0
    for planes in frames:
        meta = []
        for p in planes:
            dst = np.ndarray(p.shape, dtype=p.dtype,
                             buffer=shm.buf[off:off + p.nbytes])
            dst[:] = p
            meta.append((off, p.shape, p.dtype.str))
            off += p.nbytes
        metas.append(meta)
    name = shm.name
    try:  # the parent owns (and unlinks) the block; silence the worker's
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass
    shm.close()
    return name, metas, report


class _OwnedArray(np.ndarray):
    """ndarray view that pins its shared-memory owner (attribute chain
    keeps the block mapped until the last view dies)."""


class _ShmFrames:
    """Keeps a result shared-memory block alive for returned plane views
    and unlinks it when the last view is garbage-collected."""

    def __init__(self, name: str):
        from multiprocessing import shared_memory
        self.shm = shared_memory.SharedMemory(name=name)
        # unlink immediately: POSIX keeps the mapping alive until the
        # last close, so views stay valid and nothing can leak even on
        # a crash; __del__ then only needs to close the mapping
        try:
            self.shm.unlink()
        except Exception:
            pass

    def view(self, off, shape, dtype):
        a = np.ndarray(shape, dtype=np.dtype(dtype),
                       buffer=self.shm.buf[off:]).view(_OwnedArray)
        a._owner = self
        return a

    def __del__(self):
        try:
            self.shm.close()
        except Exception:
            pass


def make_worker_pool(workers: int, device=None) -> ProcessPoolExecutor:
    """Persistent decode worker pool (the reference's thread pool analog;
    create once per process, reuse across streams).  `device` is where
    the workers reconstruct (default CUDA, raising without a card).  The
    kernels and the host C extensions are built here, before any worker
    is spawned; each worker then loads them, and on CUDA opens its
    context, as it starts (`_warm_worker`)."""
    import multiprocessing as mp

    from vvdec_tpu_torch.device import resolve_device
    from vvdec_tpu_torch.native import native_cabac, native_recon
    dev = resolve_device(device)
    native_cabac(), native_recon()
    if dev.type == "cuda":
        from vvdec_tpu_torch.ops.cuda._build import build_kernel
        build_kernel("itx")
    ex = ProcessPoolExecutor(max_workers=workers,
                             mp_context=mp.get_context("spawn"),
                             initializer=_warm_worker, initargs=(str(dev),))
    # start every worker now (imports + native extension load + context)
    list(ex.map(_warm_worker, [str(dev)] * workers))
    return ex


def _warm_worker(device=None):
    import vvdec_tpu_torch.decoder  # noqa: F401
    from vvdec_tpu_torch.device import resolve_device
    from vvdec_tpu_torch.native import native_cabac, native_recon
    native_cabac(), native_recon()
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        from vvdec_tpu_torch.ops.cuda._build import load_kernel
        load_kernel("itx")
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    return os.getpid()


def decode_annexb_parallel(data: bytes, workers: int | None = None,
                           device=None,
                           executor: ProcessPoolExecutor | None = None,
                           threads: int = 0) -> list:
    """Parallel decode across IRAP segments; output order preserved.

    Worker processes are the host-plane analog of the reference thread
    pool (each worker owns a full parse+recon pipeline); on multi-host
    deployments the same split maps segments across hosts.  `device`
    (default CUDA) is where every worker reconstructs; an `executor`
    must come from make_worker_pool on the same device.  The workers'
    reports of this call land in `decode_annexb_parallel.worker_reports`
    (empty when no worker ran)."""
    from vvdec_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    decode_annexb_parallel.worker_reports = []
    segments = split_irap_segments(data)
    if workers is None:
        workers = min(len(segments), os.cpu_count() or 1)
    if (workers <= 1 or len(segments) <= 1) and executor is None:
        from vvdec_tpu_torch.decoder import decode_annexb
        return decode_annexb(data, device=dev, threads=threads)
    # contiguous chunks, one per worker, balanced by byte size (the
    # decode-time proxy): amortizes pool dispatch + shm setup across
    # the whole chunk while preserving output order
    nchunks = min(len(segments), workers)
    total = sum(len(s) for s in segments)
    chunks, cur, acc = [], [], 0
    for s in segments:
        cur.append(s)
        acc += len(s)
        if len(chunks) < nchunks - 1 and acc >= total / nchunks:
            chunks.append(cur)
            cur, acc = [], 0
    if cur:
        chunks.append(cur)
    out = []
    own = executor is None
    ex = executor or make_worker_pool(workers, dev)
    try:
        for name, metas, report in ex.map(
                _decode_segment_shm,
                [(c, str(dev), threads) for c in chunks]):
            decode_annexb_parallel.worker_reports.append(report)
            if name is None:
                continue
            blk = _ShmFrames(name)
            out.extend([blk.view(*m) for m in meta] for meta in metas)
    finally:
        if own:
            ex.shutdown()
    return out


decode_annexb_parallel.worker_reports = []
