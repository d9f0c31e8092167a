"""Concealment in the port against the JAX package, on the CPU.

The cases of tests/test_error_handling.py on its 96x64 inter stream (an
IDR and P pictures, each on the previous picture): the lost IDR, the
corrupted IDR slice, 20 fuzz blobs and the truncation cuts.  Each is
decoded by vvdec_tpu_torch's StreamDecoder(device="cpu",
err_policy="conceal") and by vvdec_tpu's StreamDecoder(use_jax=True,
err_policy="conceal"), the JAX device path; the host golden
(use_jax=False) is decoded too, and a case where it differs from the
JAX device path is named in the failure.  Tolerance: the output planes
byte for byte, DecodedPicture.error per picture, error_pictures and
hash_errors equal; the fuzz blobs only need the same outcome class
(decoded, concealed, raised).  Fifteen single-byte corruptions of the
slices are held to the JAX device path the same way.  Faults of the device (a kernel's build,
load or launch, CUDA out of memory, a CUDA error) are never concealed,
and concealment leaves the DPB the reference's: grey and substituted
pictures enter the device DPB, a picture that fails halfway leaves only
its grey planes.
"""

import numpy as np
import pytest
import torch


def _inter_stream(n=3, seed=5):
    """IDR + trailing P frames, each referencing the previous picture
    (tests/test_error_handling.py's builder)."""
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import P_SLICE, RandomDecisions, make_nal
    from vvdec_tpu.testenc.hls_writer import write_pps, write_sps

    sps = E.make_sps(96, 64, temporal_mvp_enabled=True)
    pps = E.make_pps(sps)
    w = BitWriter()
    write_sps(w, sps)
    head = make_nal(NalUnitType.SPS, w.bytes())
    w = BitWriter()
    write_pps(w, pps, sps)
    head += make_nal(NalUnitType.PPS, w.bytes())
    nals = [head]
    for f in range(n):
        dec = RandomDecisions(seed=seed * 100 + f, split_prob=0.3,
                              inter_prob=0.7, mv_range=24)
        if f == 0:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=0, idr=True)
        else:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=f, idr=False,
                                    slice_type=P_SLICE, ref_deltas=((1,), ()))
        nals.append(nal)
    return nals


def _fuzz_blobs():
    """test_fuzz_random_bytes_do_not_crash's 20 blobs."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(20):
        blob = bytearray(rng.integers(0, 256, size=400, dtype=np.uint8)
                         .tobytes())
        for pos in range(0, len(blob) - 4, 57):
            blob[pos:pos + 3] = b"\x00\x00\x01"
        out.append(bytes(blob))
    return out


TRUNC_STREAM = b"".join(_inter_stream(2))
CUTS = list(range(8, len(TRUNC_STREAM), max(1, len(TRUNC_STREAM) // 23)))


def _outcome(dec):
    """What a conceal decoder gave: (class, planes, error flags,
    error_pictures, hash_errors), or ("raised", exception type)."""

    def run(data):
        try:
            pics = dec.push(data) + dec.flush()
        except Exception as e:   # noqa: BLE001 - the outcome is compared
            return ("raised", type(e).__name__)
        planes = [[np.asarray(p).copy() for p in pic.planes] for pic in pics]
        errors = [pic.error for pic in pics]
        kind = "concealed" if dec.error_pictures else "decoded"
        return (kind, planes, errors, dec.error_pictures, dec.hash_errors)
    return run


def _port(data, **kw):
    from vvdec_tpu_torch.decoder import StreamDecoder
    return _outcome(StreamDecoder(device="cpu", err_policy="conceal",
                                  **kw))(data)


def _ref(data, use_jax=True):
    from vvdec_tpu.decoder import StreamDecoder
    return _outcome(StreamDecoder(use_jax=use_jax,
                                  err_policy="conceal"))(data)


def _same(a, b) -> bool:
    if a[0] != b[0] or a[0] == "raised":
        return a == b
    return (len(a[1]) == len(b[1]) and all(
        len(x) == len(y) and all(np.array_equal(p, q) for p, q in zip(x, y))
        for x, y in zip(a[1], b[1])) and a[2:] == b[2:])


def _check(case, data):
    port, jax_dev = _port(data), _ref(data)
    note = "" if _same(jax_dev, _ref(data, use_jax=False)) else \
        f" (the JAX device path and the host golden differ on {case})"
    assert _same(port, jax_dev), f"{case}: port {port[0]} {port[2:]} vs " \
        f"JAX {jax_dev[0]} {jax_dev[2:]}{note}"
    return port


def test_lost_reference_concealed():
    """Dropping the IDR: strict raises, conceal substitutes a grey
    reference and continues."""
    from vvdec_tpu_torch.decoder import StreamDecoder
    nals = _inter_stream(3)
    broken = nals[0] + b"".join(nals[2:])
    dec = StreamDecoder(device="cpu", err_policy="strict")
    with pytest.raises(ValueError, match="missing reference"):
        dec.push(broken)
        dec.flush()
    port = _check("lost IDR", broken)
    assert port[0] == "concealed" and len(port[1]) == 2
    assert port[2] == [True, False] and port[3] == 1


def test_corrupt_slice_grey_filled():
    """A corrupted IDR slice is grey-filled and the stream keeps
    decoding off the grey picture."""
    nals = _inter_stream(3)
    idr = bytearray(nals[1])
    idr[-8:] = b"\xff" * 8
    port = _check("corrupted IDR", nals[0] + bytes(idr) + b"".join(nals[2:]))
    assert port[0] == "concealed" and len(port[1]) == 3
    assert all((p == 512).all() for p in port[1][0])


@pytest.mark.parametrize("trial", range(20))
def test_fuzz_blob_outcome_class(trial):
    data = _fuzz_blobs()[trial]
    assert _port(data)[0] == _ref(data)[0]


@pytest.fixture(scope="module")
def truncation_refs():
    """The JAX device path's and the host golden's outcome per cut."""
    return {cut: (_ref(TRUNC_STREAM[:cut]),
                  _ref(TRUNC_STREAM[:cut], use_jax=False)) for cut in CUTS}


@pytest.mark.parametrize("cut", CUTS)
def test_truncated_stream(truncation_refs, cut):
    jax_dev, host = truncation_refs[cut]
    port = _port(TRUNC_STREAM[:cut])
    note = "" if _same(jax_dev, host) else " (JAX device != host golden)"
    assert _same(port, jax_dev), f"cut {cut}{note}"


def _corruptions():
    """Five single-byte corruptions in each picture's slice of the
    3-picture inter stream: (picture, byte offset, xor mask)."""
    rng = np.random.default_rng(1)
    nals = _inter_stream(3)
    return [(k, int(rng.integers(12, len(nals[k]))),
             int(rng.integers(1, 256))) for k in (1, 2, 3) for _ in range(5)]


@pytest.mark.parametrize("corruption", _corruptions(), ids=str)
def test_corrupted_byte(corruption):
    """A flipped byte inside a slice: the port's outcome is the JAX
    device path's (in these cases the parse rejects the picture, so no
    garbage picture reaches a device gather)."""
    k, off, mask = corruption
    nals = _inter_stream(3)
    b = bytearray(nals[k])
    b[off] ^= mask
    port = _check(f"byte {off} of picture {k - 1}", b"".join(
        nals[:k]) + bytes(b) + b"".join(nals[k + 1:]))
    assert port[0] == "concealed"


@pytest.mark.parametrize("threads", [0, 2])
def test_strict_parse_error_raises(threads):
    """Without concealment a truncated slice raises the parser's own
    error, as in the reference, with and without the parse thread."""
    import vvdec_tpu.decoder as R
    import vvdec_tpu_torch.decoder as T
    msgs = []
    for dec in (T.StreamDecoder(device="cpu", threads=threads),
                R.StreamDecoder(threads=threads)):
        with pytest.raises(ValueError) as info:
            dec.push(TRUNC_STREAM[:CUTS[12]])
            dec.flush()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def _device_faults():
    from vvdec_tpu_torch.ops.cuda._build import KernelError
    out = [KernelError("nvcc failed for csrc/itx.cu (rc 1)"),
           torch.cuda.OutOfMemoryError("CUDA out of memory"),
           RuntimeError("CUDA error: device-side assert triggered")]
    if hasattr(torch, "AcceleratorError"):
        out.append(torch.AcceleratorError("an illegal memory access"))
    return out


@pytest.mark.parametrize("fault", _device_faults(),
                         ids=lambda e: type(e).__name__)
def test_device_fault_is_not_concealed(monkeypatch, fault):
    """A kernel-build error (or any device fault) raised where the ITX
    stage calls its wrapper propagates through err_policy="conceal";
    the decoder greys nothing."""
    import vvdec_tpu_torch.ops.frame_device as fd
    from vvdec_tpu_torch.decoder import StreamDecoder, is_device_fault
    assert is_device_fault(fault)

    def failing(*a, **k):
        raise fault

    monkeypatch.setattr(fd, "itx_frame_cuda", failing)
    dec = StreamDecoder(device="cpu", err_policy="conceal")
    with pytest.raises(type(fault)):
        dec.push(b"".join(_inter_stream(2)))
        dec.flush()
    assert dec.error_pictures == 0 and not dec.plm.pictures()


def test_stream_fault_in_itx_is_concealed(monkeypatch):
    """The control: a ValueError at the same place is a stream fault,
    concealed with a grey picture."""
    import vvdec_tpu_torch.ops.frame_device as fd
    from vvdec_tpu_torch.decoder import StreamDecoder, is_device_fault
    assert not is_device_fault(ValueError("bad level"))

    def failing(*a, **k):
        raise ValueError("bad level")

    monkeypatch.setattr(fd, "itx_frame_cuda", failing)
    dec = StreamDecoder(device="cpu", err_policy="conceal")
    pics = dec.push(b"".join(_inter_stream(2))) + dec.flush()
    assert [p.error for p in pics] == [True, True]
    assert dec.error_pictures == 2


def _dpb_after_each_picture(dec) -> dict:
    """POC -> (device DPB, host planes, motion) as each picture left
    them, recorded while `dec` decodes."""
    after = {}
    inner = dec._reconstruct_inner

    def spy(f):
        inner(f)
        after[f.poc] = (dict(dec._refs_dev), dict(dec._refs_host),
                        dict(dec._ref_cols))

    dec._reconstruct_inner = spy
    return after


def test_grey_and_substituted_refs_enter_device_dpb():
    """Lost IDR: POC 1 substitutes a grey POC 0 (no picture decoded yet),
    which enters the device DPB as torch planes, the host planes and the
    motion; POC 2 reads POC 1, decoded on the device, and the grey POC 0,
    which POC 2's RPL no longer names, leaves the DPB."""
    from vvdec_tpu_torch.decoder import StreamDecoder
    nals = _inter_stream(3)
    dec = StreamDecoder(device="cpu", err_policy="conceal")
    after = _dpb_after_each_picture(dec)
    pics = dec.push(nals[0] + b"".join(nals[2:])) + dec.flush()
    assert [p.poc for p in pics] == [1, 2]
    dev, host, cols = after[1]
    assert sorted(dev) == sorted(host) == sorted(cols) == [0, 1]
    grey = dev[0]
    assert all(t.dtype == torch.int32 and t.device == dec.device
               and bool((t == 512).all()) for t in grey)
    assert all((p == 512).all() for p in host[0])
    assert [t.shape for t in grey] == [t.shape for t in dev[1]]
    assert sorted(dec._refs_dev) == sorted(dec._refs_host) \
        == sorted(dec._ref_cols) == [1, 2]


def test_substitute_takes_closest_poc():
    """Dropping POC 2 of four pictures: POC 3 reads POC 1 in its place
    (the closest POC, the lower one on a tie), the very same device
    planes, and the output matches the JAX device path."""
    from vvdec_tpu_torch.decoder import StreamDecoder
    nals = _inter_stream(4)
    data = b"".join(nals[:3]) + nals[4]
    port = _check("lost POC 2", data)
    assert port[2] == [False, False, True]
    dec = StreamDecoder(device="cpu", err_policy="conceal")
    after = _dpb_after_each_picture(dec)
    dec.push(data)
    dec.flush()
    assert after[3][0][2] is after[1][0][1]
    assert after[3][2][2] is after[1][2][1]
    assert sorted(after[3][0]) == [2, 3]
    assert dec.error_pictures == 1


def test_failure_after_device_recon_leaves_only_grey(monkeypatch):
    """A stream fault after reconstruct_frame_device has stored POC 1 in
    the device DPB: the grey picture replaces every entry of POC 1, its
    refined-MV fixups are dropped, and POC 2 predicts from the grey
    planes, as in the reference's host golden with the same fault
    injected.  The reference's JAX device path differs here (a fault of
    the reference, ROADMAP.md queue 3): its grey fallback replaces
    `_refs` but not `_refs_dev`, so POC 2 reads the failed picture's
    device planes."""
    import vvdec_tpu.frame.inter_np as ref_inter
    import vvdec_tpu_torch.frame.inter_np as port_inter
    from vvdec_tpu_torch.decoder import StreamDecoder
    data = b"".join(_inter_stream(3))
    failed = []

    def failing_once(real):
        def col(cs, poc):
            if poc == 1 and not failed.count((real, 1)):
                failed.append((real, 1))
                failed.append(cs)
                raise ValueError("broken motion field")
            return real(cs, poc)
        return col

    monkeypatch.setattr(port_inter, "ColMotion",
                        failing_once(port_inter.ColMotion))
    dec = StreamDecoder(device="cpu", err_policy="conceal")
    pics = dec.push(data) + dec.flush()
    cs = failed[1]
    assert cs.dmvr_fixups == ()
    assert all(bool((t == 512).all()) for t in dec._refs_dev[1])
    assert all((p == 512).all() for p in dec._refs_host[1])
    port = ("concealed", [[np.asarray(p).copy() for p in pic.planes]
                          for pic in pics], [p.error for p in pics],
            dec.error_pictures, dec.hash_errors)
    monkeypatch.setattr(ref_inter, "ColMotion",
                        failing_once(ref_inter.ColMotion))
    assert _same(port, _ref(data, use_jax=False))
    assert port[2] == [False, True, False]
    failed.clear()
    jax_dev = _ref(data)
    assert jax_dev[2] == port[2]
    assert np.array_equal(jax_dev[1][0][0], port[1][0][0])
    assert not _same(jax_dev, port)
