"""The port's multi-process GOP decode (parallel/distributed.py) and the
multi-device path's driver (parallel/dryrun.py) on the CPU.

Tolerance: bit-equal output planes.  The payload format and the
single-process decode are held to the JAX reference's
(vvdec_tpu/parallel/distributed.py, host golden decode); two gloo ranks
spawned on this host, meeting through a file store, are held to the
port's serial decode; `ensure_distributed` raises on a configuration
torch.distributed rejects.  `dryrun_multidevice` runs the four parts of
the multi-device path (the sharded chain over a ("frame", "row") mesh,
the device-resident DPB, the frame-parallel sequential intra scan, every
filter stage over a row mesh) on 2 and 4 CPU "devices" and raises on
any difference from the per-frame path.
"""

import functools

import numpy as np
import pytest


@functools.lru_cache(maxsize=None)
def _stream():
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    # tests/test_parallel.py::TestMultihost's: 4 IDRs, 4 segments
    return generate_stream(width=96, height=64, ctu=32, n_frames=4, seed=9,
                           qp=30, dec_kw=dict(split_prob=0.4,
                                              density=0.3))[0]


def _same(out, frames):
    assert len(out) == len(frames)
    for (_, planes), f in zip(out, frames):
        assert len(planes) == len(f)
        for a, b in zip(planes, f):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_payload_roundtrip_matches_jax():
    """_segment_payload gives the reference's meta and payload, and
    _unpack_payload returns the pictures."""
    import vvdec_tpu.parallel.distributed as R
    import vvdec_tpu_torch.parallel.distributed as T

    class _Pic:
        def __init__(self, poc, planes):
            self.poc = poc
            self.planes = planes

    rng = np.random.default_rng(0)
    pics = [_Pic(3, [rng.integers(0, 1023, (16, 24), dtype=np.uint16),
                     rng.integers(0, 1023, (8, 12), dtype=np.uint16),
                     rng.integers(0, 1023, (8, 12), dtype=np.uint16)]),
            _Pic(4, [rng.integers(0, 1023, (16, 24), dtype=np.uint16)])]
    meta, payload = T._segment_payload(pics)
    meta_r, payload_r = R._segment_payload(pics)
    assert np.array_equal(meta, meta_r) and np.array_equal(payload, payload_r)
    back = T._unpack_payload(meta, payload)
    assert [p for p, _ in back] == [3, 4]
    for (_, planes), pic in zip(back, pics):
        assert len(planes) == len(pic.planes)
        for a, b in zip(planes, pic.planes):
            assert np.array_equal(a, b)


def test_single_process_matches_jax():
    """Without a process group every segment decodes here: the output
    equals the reference's decode_annexb_multihost (host golden) and the
    port's decode_annexb."""
    from vvdec_tpu.parallel.distributed import decode_annexb_multihost as ref
    from vvdec_tpu_torch.decoder import decode_annexb
    from vvdec_tpu_torch.parallel.distributed import decode_annexb_multihost
    s = _stream()
    out = decode_annexb_multihost(s, device="cpu")
    want = ref(s, use_jax=False)
    assert [p for p, _ in out] == [p for p, _ in want]
    _same(out, [planes for _, planes in want])
    _same(out, decode_annexb(s, device="cpu"))


def test_two_gloo_ranks_match_serial():
    """Two spawned ranks (gloo, file store): rank 0 returns every segment
    in stream order, equal to the serial decode; each rank decoded two
    of the four segments."""
    from vvdec_tpu_torch.decoder import decode_annexb
    from vvdec_tpu_torch.parallel.distributed import decode_annexb_spawned
    s = _stream()
    out, reports = decode_annexb_spawned(s, ranks=2, device="cpu")
    _same(out, decode_annexb(s, device="cpu"))
    assert [r["rank"] for r in reports] == [0, 1]
    assert len({r["pid"] for r in reports}) == 2
    assert all(r["device"] == "cpu" for r in reports)


def test_ensure_distributed(monkeypatch):
    """No job configured: world size 1, nothing initialised.  A job
    torchrun's variables describe badly (no RANK; a WORLD_SIZE that is
    not a number) raises rather than running on alone."""
    import torch.distributed as dist

    from vvdec_tpu_torch.parallel.distributed import ensure_distributed
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert ensure_distributed() == 1
    assert not dist.is_initialized()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29517")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError):
        ensure_distributed()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "two")
    with pytest.raises(ValueError):
        ensure_distributed()
    assert not dist.is_initialized()


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multidevice(n_devices):
    """The four parts of the multi-device path on n_devices CPU devices,
    each bit-equal to the per-frame path."""
    from vvdec_tpu_torch.parallel.dryrun import dryrun_multidevice
    out = dryrun_multidevice(n_devices, ["cpu"] * n_devices)
    assert out["sharded_chain"]["mesh"] == {"frame": n_devices // 2,
                                            "row": 2}
    assert out["sharded_chain"]["frames"] == n_devices // 2
    assert out["device_dpb"]["pictures"] == max(2, min(n_devices, 4))
    assert out["frame_parallel_scan"]["frames"] == n_devices
    assert out["row_sharded_alf"]["mesh"] == {"row": n_devices}
