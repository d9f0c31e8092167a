"""Recon-while-parse in the port, on the CPU.

StreamDecoder(threads >= 2) parses on a thread of its own, and with
threads >= 3 runs each picture's CABAC walk (each slice's, for
multi-slice pictures) on a walk pool, while the calling thread
reconstructs.  Tolerance: bit-equal.  Every decode must equal the
port's threads=0 decode and vvdec_tpu's StreamDecoder with the same
threads and parse_delay: a small all-intra and a small inter stream
with threads 0, 2, 3 and parse_delay None, 1, and threads 4 on the
multi-slice streams of tests/test_multislice.py's TestParallelSliceParse.
The device is touched only from the thread that calls push and flush.
"""

import threading

import numpy as np
import pytest

from tests.test_torch_conceal import _inter_stream

TILES_2X2 = dict(no_pic_partition=False, num_exp_tile_cols=2,
                 num_exp_tile_rows=2, tile_col_widths=[2, 1],
                 tile_row_heights=[1, 1])


def _header(sps_kw, pps_kw, wh=(96, 64), ctu=32):
    """tests/test_multislice.py's parameter sets."""
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import make_nal
    from vvdec_tpu.testenc.hls_writer import write_pps, write_sps

    sps = E.make_sps(wh[0], wh[1], ctu=ctu,
                     entry_point_offsets_present=True, **sps_kw)
    sps.ptl.level_idc = 83
    pps = E.make_pps(sps, **pps_kw)
    w = BitWriter()
    write_sps(w, sps)
    stream = make_nal(NalUnitType.SPS, w.bytes())
    w = BitWriter()
    write_pps(w, pps, sps)
    stream += make_nal(NalUnitType.PPS, w.bytes())
    return sps, pps, stream


def _slices(n, base_seed, dec_kw, types=None, ref_deltas=((1,), ()),
            **extra):
    """tests/test_multislice.py's slice specs."""
    from vvdec_tpu.testenc.encoder import RandomDecisions
    out = []
    for i in range(n):
        spec = dict(decisions=RandomDecisions(seed=base_seed + i, **dec_kw),
                    **extra)
        t = 2 if types is None else types[i]
        spec["slice_type"] = t
        if t != 2:
            spec["ref_deltas"] = (ref_deltas[0],
                                  ref_deltas[1] if t == 0 else ())
        out.append(spec)
    return out


def _four_slices_inter(seed):
    from vvdec_tpu.testenc.encoder import encode_picture
    pps_kw = dict(**TILES_2X2, rect_slice=True,
                  single_slice_per_subpic=False, num_slices_in_pic=4,
                  slice_top_left_tile_idx=[0, 1, 2, 3],
                  slice_width_in_tiles=[1, 1, 1, 1],
                  slice_height_in_tiles=[1, 1, 1, 1],
                  loop_filter_across_slices=seed % 2 == 0,
                  loop_filter_across_tiles=True)
    sps, pps, stream = _header(dict(temporal_mvp_enabled=True), pps_kw)
    dec_kw = dict(split_prob=0.4, inter_prob=0.7, skip_prob=0.2,
                  mv_range=24)
    for f in range(4):
        if f == 0:
            sl = _slices(4, seed * 100 + f * 10, dict(split_prob=0.5))
        else:
            d = tuple(range(1, min(f, 2) + 1))
            sl = _slices(4, seed * 100 + f * 10, dec_kw, types=[1] * 4,
                         ref_deltas=(d, ()))
        nal, _ = encode_picture(sps, pps, poc=f, idr=f == 0, slices=sl)
        stream += nal
    return stream


def _raster_slices():
    from vvdec_tpu.testenc.encoder import encode_picture
    pps_kw = dict(**TILES_2X2, rect_slice=False,
                  loop_filter_across_slices=True,
                  loop_filter_across_tiles=True)
    sps, pps, stream = _header({}, pps_kw)
    for f in range(2):
        sl = _slices(2, 7 + f * 10, dict(split_prob=0.5))
        sl[0]["address"], sl[0]["num_tiles"] = 0, 3
        sl[1]["address"], sl[1]["num_tiles"] = 3, 1
        nal, _ = encode_picture(sps, pps, poc=f, idr=True, slices=sl)
        stream += nal
    return stream


def _mixed_slice_types():
    from vvdec_tpu.testenc.encoder import encode_picture
    pps_kw = dict(**TILES_2X2, rect_slice=True,
                  single_slice_per_subpic=False, num_slices_in_pic=2,
                  slice_top_left_tile_idx=[0, 2],
                  slice_width_in_tiles=[2, 2],
                  slice_height_in_tiles=[1, 1],
                  loop_filter_across_slices=True,
                  loop_filter_across_tiles=True)
    sps, pps, stream = _header({}, pps_kw)
    dec_kw = dict(split_prob=0.4, inter_prob=0.7, skip_prob=0.2,
                  mv_range=16)
    for f in range(3):
        if f == 0:
            sl = _slices(2, 21, dict(split_prob=0.5))
        else:
            sl = _slices(1, 22 + f, dec_kw, types=[1], ref_deltas=((1,), ()))
            sl += _slices(1, 25 + f, dict(split_prob=0.5), types=[2])
        nal, _ = encode_picture(sps, pps, poc=f, idr=f == 0, slices=sl)
        stream += nal
    return stream


def _intra():
    from vvdec_tpu.testenc.encoder import generate_stream
    return generate_stream(width=96, height=64, ctu=32, n_frames=3, seed=2,
                           qp=32, dec_kw=dict(split_prob=0.3,
                                              density=0.1))[0]


STREAMS = {
    "intra": (_intra, 3),
    "inter": (lambda: b"".join(_inter_stream(3)), 3),
    "four slices inter 0": (lambda: _four_slices_inter(0), 4),
    "four slices inter 1": (lambda: _four_slices_inter(1), 4),
    "raster slices": (_raster_slices, 2),
    "mixed slice types": (_mixed_slice_types, 3),
}


def _port(stream, threads=0, parse_delay=None):
    from vvdec_tpu_torch.decoder import StreamDecoder
    dec = StreamDecoder(device="cpu", threads=threads,
                        parse_delay=parse_delay)
    return [[np.asarray(p).copy() for p in pic.planes]
            for pic in dec.push(stream) + dec.flush()]


def _ref(stream, threads, parse_delay):
    from vvdec_tpu.decoder import StreamDecoder
    dec = StreamDecoder(threads=threads, parse_delay=parse_delay)
    return [[np.asarray(p).copy() for p in pic.planes]
            for pic in dec.push(stream) + dec.flush()]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(
        all(np.array_equal(p, q) for p, q in zip(x, y)) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def serial():
    """{name: (stream, the port's threads=0 frames)}."""
    out = {}
    for name, (build, n) in STREAMS.items():
        s = build()
        frames = _port(s)
        assert len(frames) == n
        out[name] = (s, frames)
    return out


@pytest.mark.parametrize("parse_delay", [None, 1])
@pytest.mark.parametrize("threads", [0, 2, 3])
@pytest.mark.parametrize("name", ["intra", "inter"])
def test_threads_bit_equal(serial, name, threads, parse_delay):
    stream, frames0 = serial[name]
    got = _port(stream, threads, parse_delay)
    assert _equal(got, frames0)
    assert _equal(got, _ref(stream, threads, parse_delay))


@pytest.mark.parametrize("name", ["four slices inter 0",
                                  "four slices inter 1", "raster slices",
                                  "mixed slice types"])
def test_parallel_slice_parse(serial, name, monkeypatch):
    """threads=4 parses each slice of a multi-slice picture as a walk
    task of its own; the result equals the serial parse."""
    from vvdec_tpu_torch.decoder import FrameParser
    submitted = []
    real = FrameParser._submit_slice_walk

    def spy(self, cs, sh, dec, slice_idx):
        submitted.append(slice_idx)
        return real(self, cs, sh, dec, slice_idx)

    monkeypatch.setattr(FrameParser, "_submit_slice_walk", spy)
    stream, frames0 = serial[name]
    got = _port(stream, 4)
    assert max(submitted) >= 1
    assert _equal(got, frames0)
    assert _equal(got, _ref(stream, 4, None))


def test_device_stays_on_the_calling_thread(serial, monkeypatch):
    """With threads=3 the CABAC walks run on the walk pool, while the
    plan and the reconstruction (uploads, launches) run on the thread
    that called push and flush."""
    import vvdec_tpu_torch.ops.frame_device as fd
    from vvdec_tpu_torch.cabac.ctu_decoder import CtuDecoder
    seen = {"plan": set(), "recon": set(), "walk": set()}

    def spy(key, fn):
        def run(*a, **k):
            seen[key].add(threading.current_thread())
            return fn(*a, **k)
        return run

    monkeypatch.setattr(fd, "plan_frame_device",
                        spy("plan", fd.plan_frame_device))
    monkeypatch.setattr(fd, "reconstruct_frame_device",
                        spy("recon", fd.reconstruct_frame_device))
    monkeypatch.setattr(CtuDecoder, "decode_slice",
                        spy("walk", CtuDecoder.decode_slice))
    stream, frames0 = serial["inter"]
    assert _equal(_port(stream, 3), frames0)
    me = threading.current_thread()
    assert seen["plan"] == seen["recon"] == {me}
    assert seen["walk"] and me not in seen["walk"]
    assert all(t.name.startswith("vvdec-walk") for t in seen["walk"])
