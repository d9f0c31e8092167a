"""Multi-process GOP-parallel decoding over torch.distributed.

Port of vvdec_tpu/parallel/distributed.py, the distributed form of the
frame-level pipeline parallelism: the stream splits at IRAP pictures
into independently decodable segments (parallel/gop.py, the reference's
random-access tune-in, DecLibParser.cpp:658-684), the segments go round
robin to the ranks of a torch.distributed job, each rank decodes its
share on its own device (CUDA by default: card LOCAL_RANK modulo the
cards it sees), and the decoded pictures travel to rank 0, which
returns them in stream order.

Within a segment the DPB never leaves its rank, so the only traffic
between ranks is the decoded output: host uint16 planes, sent over the
gloo backend (a job on another backend raises).  The reference
broadcasts each segment to every process; here each owner sends its
segments to rank 0 alone, the only rank that assembles them.

`ensure_distributed()` joins the job torchrun describes (its env://
variables) and raises when that fails; the reference's version swallows
the failure.  `decode_annexb_spawned` runs a whole job on this host:
it spawns the ranks, which meet through a file store (no network), and
returns rank 0's output with every rank's report.
"""

from __future__ import annotations

import json
import os
import tempfile
from datetime import timedelta

import numpy as np

INIT_TIMEOUT = timedelta(seconds=300)


def _segment_payload(pics) -> tuple[np.ndarray, np.ndarray]:
    """(meta int64, payload uint16) for one decoded segment.

    meta = [n_frames, then per frame: poc, n_planes, h0, w0, h1, w1,
    h2, w2] (zeros for absent planes); payload = all planes raveled in
    order."""
    meta = [len(pics)]
    parts = []
    for pic in pics:
        planes = [np.asarray(p) for p in pic.planes]
        meta.append(pic.poc)
        meta.append(len(planes))
        for k in range(3):
            if k < len(planes):
                meta.append(planes[k].shape[0])
                meta.append(planes[k].shape[1])
                parts.append(planes[k].astype(np.uint16).ravel())
            else:
                meta.append(0)
                meta.append(0)
    payload = np.concatenate(parts) if parts \
        else np.zeros(0, dtype=np.uint16)
    return np.asarray(meta, dtype=np.int64), payload


def _unpack_payload(meta: np.ndarray, payload: np.ndarray) -> list:
    """Inverse of _segment_payload: [(poc, [planes])] in decode order."""
    out = []
    pos = 0
    mpos = 1
    for _ in range(int(meta[0])):
        poc = int(meta[mpos])
        n_pl = int(meta[mpos + 1])
        dims = meta[mpos + 2: mpos + 8].reshape(3, 2)
        mpos += 8
        planes = []
        for k in range(n_pl):
            h, w = int(dims[k, 0]), int(dims[k, 1])
            planes.append(payload[pos: pos + h * w].reshape(h, w))
            pos += h * w
        out.append((poc, planes))
    return out


def _rank_device(device=None):
    """The device this rank decodes on: `device` when given, else card
    LOCAL_RANK (or RANK) modulo the cards this host sees."""
    import torch

    from vvdec_tpu_torch.device import resolve_device
    if device is not None or not torch.cuda.is_available():
        return resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return resolve_device(f"cuda:{local % torch.cuda.device_count()}")


def decode_annexb_multihost(data: bytes, device=None,
                            threads: int = 0) -> list:
    """Decode a stream GOP-parallel across the ranks of a torch.distributed
    job (one rank per process; a single process when none is set up).
    Returns, on rank 0, a list of (poc, [uint16 planes]) in stream order;
    [] on the other ranks."""
    import torch
    import torch.distributed as dist

    from vvdec_tpu_torch.decoder import StreamDecoder
    from vvdec_tpu_torch.parallel.gop import split_irap_segments

    multi = dist.is_available() and dist.is_initialized()
    n_proc = dist.get_world_size() if multi else 1
    pid = dist.get_rank() if multi else 0
    segments = split_irap_segments(data)
    dev = _rank_device(device)

    mine: dict[int, list] = {}
    for si, seg in enumerate(segments):
        if si % n_proc != pid:
            continue
        dec = StreamDecoder(device=dev, threads=threads)
        pics = dec.push(seg)
        pics.extend(dec.flush())
        mine[si] = pics

    if n_proc == 1:
        return [(pic.poc, [np.asarray(p) for p in pic.planes])
                for si in range(len(segments)) for pic in mine.get(si, [])]

    # each segment's owner sends it to rank 0: its sizes, then the meta,
    # then the planes as bytes (gloo has no 16-bit integer type)
    if dist.get_backend() != "gloo":
        raise ValueError(f"decode_annexb_multihost sends host planes over "
                         f"gloo, not {dist.get_backend()}")
    out = []
    for si in range(len(segments)):
        owner = si % n_proc
        if owner == pid == 0:
            out.extend((pic.poc, [np.asarray(p) for p in pic.planes])
                       for pic in mine[si])
        elif pid == owner:
            meta, payload = _segment_payload(mine[si])
            raw = payload.view(np.uint8)
            dist.send(torch.tensor([meta.size, raw.size]), 0)
            dist.send(torch.from_numpy(meta), 0)
            dist.send(torch.from_numpy(raw.copy()), 0)
        elif pid == 0:
            sizes = torch.zeros(2, dtype=torch.int64)
            dist.recv(sizes, owner)
            meta = torch.zeros(int(sizes[0]), dtype=torch.int64)
            raw = torch.zeros(int(sizes[1]), dtype=torch.uint8)
            dist.recv(meta, owner)
            dist.recv(raw, owner)
            out.extend(_unpack_payload(meta.numpy(),
                                       raw.numpy().view(np.uint16)))
    return out


def ensure_distributed() -> int:
    """Join the torch.distributed job torchrun describes (MASTER_ADDR and
    WORLD_SIZE set: env:// initialisation, gloo backend) unless this
    process is in one already; returns the world size (1 when no job is
    configured).  A failed initialisation raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        dist.init_process_group(backend="gloo", init_method="env://",
                                timeout=INIT_TIMEOUT)
        return dist.get_world_size()
    return 1


def _rank_main(rank: int, world: int, tmp: str, data: bytes, device,
               threads: int) -> None:
    """One spawned rank of decode_annexb_spawned: join the job through
    the file store in `tmp`, decode its share, write its report (and on
    rank 0 the output) into `tmp`."""
    import time

    import torch
    import torch.distributed as dist

    from vvdec_tpu_torch.ops.cuda.itx import itx_frame_cuda
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=INIT_TIMEOUT)
    try:
        dev = _rank_device(device)
        itx_frame_cuda.launches = 0
        t0 = time.perf_counter()
        out = decode_annexb_multihost(data, device=dev, threads=threads)
        report = dict(rank=rank, pid=os.getpid(), device=str(dev),
                      decode_s=time.perf_counter() - t0,
                      itx_launches=itx_frame_cuda.launches)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            report.update(
                max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                max_memory_reserved=torch.cuda.max_memory_reserved(dev))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:

        class _Pic:
            def __init__(self, poc, planes):
                self.poc, self.planes = poc, planes

        meta, payload = _segment_payload([_Pic(p, pl) for p, pl in out])
        np.savez(os.path.join(tmp, "out.npz"), meta=meta, payload=payload)
    with open(os.path.join(tmp, f"report{rank}.json"), "w") as f:
        json.dump(report, f)


def decode_annexb_spawned(data: bytes, ranks: int = 2, device=None,
                          threads: int = 0) -> tuple[list, list]:
    """Run decode_annexb_multihost as a job of `ranks` spawned processes
    on this host, which meet through a file store in a temporary
    directory (no network).  Returns (rank 0's output, the ranks'
    reports: pid, device, decode seconds, ITX launches and, on CUDA,
    the caching allocator's peaks).  A failed rank raises here.  A
    script that calls this needs an `if __name__ == "__main__":` guard."""
    import torch.multiprocessing as mp

    from vvdec_tpu_torch.device import resolve_device
    from vvdec_tpu_torch.native import native_cabac, native_recon
    # the kernels and the host C extensions are built here, once, before
    # any rank is spawned; the ranks load them
    native_cabac(), native_recon()
    if resolve_device(device).type == "cuda":
        from vvdec_tpu_torch.ops.cuda._build import build_kernel
        build_kernel("itx")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(ranks, tmp, data, device,
                                             threads),
                           nprocs=ranks, join=True, start_method="spawn")
        with np.load(os.path.join(tmp, "out.npz")) as z:
            out = _unpack_payload(z["meta"], z["payload"])
        reports = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"report{r}.json")) as f:
                reports.append(json.load(f))
    return out, reports
