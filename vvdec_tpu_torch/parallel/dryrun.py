"""The multi-device path, driven end to end and held to the per-frame path.

Port of __graft_entry__.dryrun_multichip's four parts, each a function
that runs one part on the devices it is given and raises when a result
differs from what the port's unsharded or per-frame path gives:

1. `sharded_chain_parity`: the filter chain row-sharded (and
   frame-sharded) over a mesh (ops/sharded_chain.py) against the
   whole-frame chain (`filter_frame_device`);
2. `device_dpb_parity`: a device-resident DPB, each picture
   reconstructed on its own device (round robin) with its references
   moved to that device, against the port's decode of the same
   pictures;
3. `frame_parallel_scan_parity`: the sequential intra scan run per
   frame over the mesh's frame axis (parallel/sharding.frame_parallel)
   against the wavefront;
4. the filter chain over a pure row mesh (part 1 on a ("row",) mesh).

`dryrun_multidevice(n_devices, devices)` runs the four on small streams;
chip_smoke.py runs them at 832x480 on one card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vvdec_tpu_torch.parallel.sharding import Mesh, make_decode_mesh


class ParityError(AssertionError):
    """A result of the multi-device path differs from the per-frame path."""


def _check(cond, what: str) -> None:
    if not cond:
        raise ParityError(what)


def _sync(devices) -> None:
    for d in {torch.device(x) for x in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def first_pictures(stream: bytes, n: int) -> bytes:
    """`stream` (one slice per picture) cut before the NAL that follows
    its n-th VCL NAL: the parameter sets and the first n pictures."""
    from vvdec_tpu_torch.bitstream.nal import is_vcl, split_annexb
    nals = split_annexb(stream)
    vcl = [i for i, (off, _) in enumerate(nals)
           if is_vcl(stream[off + 1] >> 3)]
    if len(vcl) < n:
        raise ValueError(f"the stream has {len(vcl)} pictures, not {n}")
    if vcl[n - 1] + 1 == len(nals):
        return stream
    off = nals[vcl[n - 1] + 1][0]
    # the next NAL's start code: 3 bytes, or 4 with a zero before
    return stream[:off - 4 if stream[off - 4] == 0 else off - 3]


def capture_filter_inputs(stream: bytes, device, n: int | None = None
                          ) -> list:
    """Decode `stream` (its first n pictures) on `device` and return each
    picture's filter-chain inputs, [(cs, planes)] with the planes as the
    reconstruction left them (int32 tensors on `device`)."""
    import vvdec_tpu_torch.ops.frame_device as frame_device
    from vvdec_tpu_torch.decoder import decode_annexb
    captured = []
    real = frame_device.filter_frame_device

    def spy(cs, planes):
        captured.append((cs, [p.clone() for p in planes]))
        return real(cs, planes)

    frame_device.filter_frame_device = spy
    try:
        decode_annexb(stream if n is None else first_pictures(stream, n),
                      device=device)
    finally:
        frame_device.filter_frame_device = real
    return captured


def sharded_chain_parity(items, mesh: Mesh, axis: str = "row") -> dict:
    """filter_frames_sharded(items, mesh, axis) against the whole-frame
    chain on each picture's own inputs: every plane bit-equal."""
    from vvdec_tpu_torch.ops.device_pipeline import filter_frame_device
    from vvdec_tpu_torch.ops.sharded_chain import filter_frames_sharded
    ref = [filter_frame_device(cs, planes).resolve() for cs, planes in items]
    t0 = time.perf_counter()
    out = filter_frames_sharded(items, mesh, axis)
    _sync(mesh.devices.flat)
    dt = time.perf_counter() - t0
    for f, (r, o) in enumerate(zip(ref, out)):
        for c, (a, b) in enumerate(zip(r, o)):
            _check(np.array_equal(a, b.cpu().numpy()),
                   f"sharded chain != unsharded: frame {f} plane {c} on "
                   f"{mesh}")
    return dict(frames=len(items), mesh=dict(mesh.shape), seconds=dt)


def _resolve_refs(cs, poc: int, dev_refs: dict, cols: dict) -> None:
    """cs's reference sets from the device-resident DPB `dev_refs`
    (short-term entries of the first slice's lists, which every slice
    shares: per_slice_rpl is off)."""
    sh = cs.sh
    cs.ref_pocs = [[], []]
    cs.ref_planes = [[], []]
    cs.ref_cols = [[], []]
    cs.ref_scaled = [[], []]
    cs.per_slice_rpl = False
    if not sh.is_intra:
        for lst in range(2):
            if sh.rpl[lst] is None:
                continue
            for e in sh.rpl[lst].entries:
                _check(not e.is_long_term, "a long-term reference")
                rp = poc + e.value
                cs.ref_pocs[lst].append(rp)
                cs.ref_planes[lst].append(dev_refs[rp])
                cs.ref_cols[lst].append(cols[rp])
                cs.ref_scaled[lst].append(None)
    cs.check_ldc = all(p <= poc for lst in range(2)
                       for p in cs.ref_pocs[lst][:sh.num_ref_idx_active[lst]])


def device_dpb_parity(stream: bytes, devices, n: int | None = None) -> dict:
    """The first n pictures of a low-delay `stream` (one slice each,
    output order = decode order, so no DMVR) reconstructed with a
    device-resident DPB: picture k on devices[k % len(devices)], its
    references moved there from the devices that reconstructed them.
    Each picture's planes must stay on its device, and the output must
    equal the port's decode of the same pictures on devices[0]."""
    from vvdec_tpu_torch.decoder import FrameParser, decode_annexb
    from vvdec_tpu_torch.frame.inter_np import ColMotion
    from vvdec_tpu_torch.ops.cuda.itx import itx_frame_cuda
    from vvdec_tpu_torch.ops.frame_device import (plan_frame_device,
                                                  reconstruct_frame_device)
    devices = [torch.device(d) for d in devices]
    data = stream if n is None else first_pictures(stream, n)
    golden = decode_annexb(data, device=devices[0])
    launches0 = itx_frame_cuda.launches
    t0 = time.perf_counter()
    dev_refs: dict = {}
    cols: dict = {}
    outs = []
    for k, pf in enumerate(FrameParser().parse_stream(data)):
        cs = pf.cs
        dev = devices[k % len(devices)]
        _resolve_refs(cs, pf.poc, dev_refs, cols)
        desc, reason = plan_frame_device(cs)
        _check(desc is not None, f"picture {pf.poc} not device-eligible: "
               f"{reason}")

        def get_ref(lst, ref_idx, comp, _cs=cs, _dev=dev):
            # the reference lives on the device that reconstructed it;
            # .to moves it to this picture's device
            return _cs.ref_planes[lst][ref_idx][comp].to(_dev)

        pending = reconstruct_frame_device(cs, desc, get_ref, device=dev)
        planes = tuple(pending.planes_dev)
        _check(all(p.device == dev for p in planes),
               f"picture {pf.poc} is not resident on {dev}")
        dev_refs[pf.poc] = planes
        cols[pf.poc] = ColMotion(cs, pf.poc)
        outs.append(pending.resolve())
    _sync(devices)
    dt = time.perf_counter() - t0
    _check(len(outs) == len(golden), f"{len(outs)} pictures, the per-frame "
           f"decode gave {len(golden)}")
    for k, (g, o) in enumerate(zip(golden, outs)):
        for c, (a, b) in enumerate(zip(g, o)):
            _check(np.array_equal(np.asarray(a, np.int64),
                                  np.asarray(b, np.int64)),
                   f"device-resident DPB != per-frame decode: picture {k} "
                   f"plane {c}")
    return dict(pictures=len(outs), devices=[str(d) for d in devices],
                itx_launches=itx_frame_cuda.launches - launches0,
                seconds=dt)


def frame_parallel_scan_parity(stream: bytes, mesh: Mesh,
                               n: int | None = None) -> dict:
    """The sequential intra scan of the first n pictures of an intra
    `stream` (n a multiple of the mesh's frame axis), run through
    frame_parallel over the mesh's frame axis: each band of frames on its
    device, zero planes and the pictures' residuals stacked on a leading
    frame axis, the descriptors padded with zero rows to one power of
    two.  Every plane must equal the wavefront's for the same picture."""
    from vvdec_tpu_torch.decoder import FrameParser
    from vvdec_tpu_torch.ops.frame_device import (itx_residual_device,
                                                  plan_frame_device)
    from vvdec_tpu_torch.ops.intra_device import (D, _intra_scan_fn,
                                                  run_intra_scan, scan_key)
    from vvdec_tpu_torch.parallel.sharding import frame_parallel
    home = mesh.axis_devices("frame")[0]
    data = stream if n is None else first_pictures(stream, n)
    parsed = FrameParser().parse_stream(data)
    key = scan_key(parsed[0].cs)
    descs, resis = [], []
    for pf in parsed:
        _check(scan_key(pf.cs) == key, "pictures of one scan key")
        desc, reason = plan_frame_device(pf.cs)
        _check(desc is not None, f"picture not device-eligible: {reason}")
        descs.append(desc)
        resis.append(itx_residual_device(pf.cs, home))
    units = [d.shape[0] for d in descs]
    n_pad = 1 << max(0, max(units) - 1).bit_length()
    desc_b = np.stack([np.concatenate(
        [d, np.zeros((n_pad - d.shape[0], D), dtype=np.int32)])
        for d in descs])
    resi_b = tuple(torch.stack([r[c] for r in resis]) for c in range(3))
    planes_b = tuple(torch.zeros_like(r) for r in resi_b)
    scan = _intra_scan_fn(*key)

    def band(args):
        planes, res, desc = args
        outs = [scan(tuple(p[i] for p in planes), tuple(r[i] for r in res),
                     desc[i]) for i in range(desc.shape[0])]
        return tuple(torch.stack([o[c] for o in outs]) for c in range(3))

    _sync([home])
    t0 = time.perf_counter()
    got = frame_parallel(band, (planes_b, resi_b, desc_b), mesh)
    _sync(mesh.devices.flat)
    dt = time.perf_counter() - t0
    for i, (d, r) in enumerate(zip(descs, resis)):
        want = run_intra_scan(tuple(torch.zeros_like(x) for x in r), r, d,
                              key)
        for c in range(3):
            _check(torch.equal(got[c][i], want[c]),
                   f"frame-parallel sequential scan != wavefront: frame "
                   f"{i} plane {c}")
    return dict(frames=len(parsed), units_per_frame=sum(units) / len(units),
                seconds=dt, ms_per_unit=dt * 1e3 / sum(units))


def dryrun_multidevice(n_devices: int, devices=None) -> dict:
    """The four parts of the multi-device path over n_devices devices
    (default every visible CUDA card; repeats allowed) on small streams
    made by the port's test encoder.  Returns what each part compared;
    raises ParityError on any difference."""
    from vvdec_tpu_torch.streams import inter_ld_stream, sao_alf_stream
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    mesh = make_decode_mesh(n_devices, devices=devices)
    frames_ax = mesh.shape["frame"]
    home = mesh.devices.flat[0]
    flat = list(mesh.devices.flat)
    out = {}
    # 1. the sharded chain over ("frame", "row")
    stream, _ = generate_stream(
        width=128, height=96, ctu=32, n_frames=frames_ax, seed=21, qp=30,
        sps_kw=dict(sao_enabled=True),
        sh_kw=dict(sao_enabled_luma=True, sao_enabled_chroma=True),
        dec_kw=dict(split_prob=0.5, sao_prob=0.8))
    out["sharded_chain"] = sharded_chain_parity(
        capture_filter_inputs(stream, home), mesh)
    # 2. the device-resident DPB, pictures round robin over the devices
    n_gop = max(2, min(n_devices, 4))
    out["device_dpb"] = device_dpb_parity(
        inter_ld_stream(96, 64, n_gop, seed=3,
                        dec_kw=dict(split_prob=0.4, inter_prob=0.8,
                                    skip_prob=0.3, mv_range=16)), flat)
    # 3. the sequential intra scan over the frame axis of a pure frame
    # mesh
    mesh_f = Mesh(mesh.devices.reshape(-1), ("frame",))
    sts, _ = generate_stream(
        width=96, height=64, ctu=32, n_frames=n_devices, seed=31, qp=30,
        dec_kw=dict(split_prob=0.5, density=0.3))
    out["frame_parallel_scan"] = frame_parallel_scan_parity(sts, mesh_f)
    # 4. every filter stage (ALF and CC-ALF too) over a pure row mesh
    mesh_r = Mesh(mesh.devices.reshape(-1), ("row",))
    out["row_sharded_alf"] = sharded_chain_parity(
        capture_filter_inputs(sao_alf_stream(w=96, h=128, n=1, seed=5),
                              home), mesh_r)
    return out
