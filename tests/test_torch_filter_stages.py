"""The port's whole-frame filters (vvdec_tpu_torch/ops/pipeline.py:
deblock_frame_torch, sao_frame_torch, alf_frame_torch) and
reconstruct_frame_torch against vvdec_tpu/ops/pipeline.py, on the CPU.

Tolerance: bit-equal (integer arithmetic).  The filters get the
pre-filter planes each package's own decode reaches: the reference's
host golden decoder at its deblocking, the port's CPU decode at its
filter chain or, for the pictures that chain rejects, at its host
deblocking; the two must be equal.  Then each stage runs on the
reference's output of the stage before it: deblocking, SAO, ALF and
CC-ALF, on tests/test_pipeline_jax.py's three inter streams (96x64) and
on the virtual-boundary and tiles streams (streams.vb_stream,
streams.tiles_alf_stream at 96x64: virtual boundaries, ALF clamp
windows, per-slice deblocking offsets).  Every cell batch of the
deblocking writes distinct samples.  reconstruct_frame_torch ==
reconstruct_frame_jax on the intra pictures of those last two streams.
The reference's deblocking pads its cell batches to at least 512 rows
here, which leaves its result as it is but lets every picture of this
size reuse one XLA program per direction (it runs after the filter
tests, which compile them).  The cuda-marked test runs
the filters on the card against the CPU.
"""

import functools

import numpy as np
import pytest
import torch

import vvdec_tpu_torch.ops.pipeline as TP

TILES_PPS = dict(no_pic_partition=False, num_exp_tile_cols=2,
                 num_exp_tile_rows=2, tile_col_widths=[2, 1],
                 tile_row_heights=[1, 1], rect_slice=True,
                 single_slice_per_subpic=False, num_slices_in_pic=4,
                 slice_top_left_tile_idx=[0, 1, 2, 3],
                 slice_width_in_tiles=[1, 1, 1, 1],
                 slice_height_in_tiles=[1, 1, 1, 1],
                 loop_filter_across_tiles=False,
                 loop_filter_across_slices=False)


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


def _filter_streams():
    from tests.test_alf import _alf_stream
    from tests.test_oracle import _inter_stream
    from vvdec_tpu.hls.params import B_SLICE
    from vvdec_tpu_torch.streams import tiles_alf_stream, vb_stream
    return {
        # tests/test_pipeline_jax.py's SAO, ALF and deblocking streams
        "sao": lambda: _inter_stream(
            5, 4, B_SLICE, lambda f: ((1,), (1,)),
            dict(split_prob=0.4, inter_prob=0.6, skip_prob=0.2, mv_range=24),
            sao=True),
        "alf": lambda: _alf_stream(
            2, 4, 1, dict(temporal_mvp_enabled=True),
            dict(split_prob=0.4, inter_prob=0.7, skip_prob=0.2, mv_range=40,
                 bi_prob=0.5), n_aps=3),
        "deblock": lambda: _inter_stream(
            9, 4, B_SLICE, lambda f: ((1,), (1,)),
            dict(split_prob=0.25, inter_prob=0.7, skip_prob=0.2, mv_range=32,
                 bi_prob=0.5)),
        "vb": lambda: vb_stream(3),
        "tiles": lambda: tiles_alf_stream(1, TILES_PPS),
    }


FILTER_STREAMS = ("sao", "alf", "deblock", "vb", "tiles")


def _capture_reference(stream):
    """[(cs, planes)] at the host golden decoder's deblocking."""
    import vvdec_tpu.frame.deblock_np as dnp
    from vvdec_tpu.decoder import decode_annexb
    got = []
    real = dnp.deblock_frame

    def spy(cs, planes):
        got.append((cs, [p.copy() for p in planes]))
        return real(cs, planes)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(dnp, "deblock_frame", spy)
        decode_annexb(stream)
    return got


def _capture_port(stream):
    """[(cs, planes)] where the port's CPU decode filters: the device
    chain's inputs, or the host deblocking's for the pictures the chain
    rejects."""
    import vvdec_tpu_torch.frame.deblock_np as dnp
    import vvdec_tpu_torch.ops.frame_device as fd
    from vvdec_tpu_torch.decoder import decode_annexb
    got = []
    real_dev, real_host = fd.filter_frame_device, dnp.deblock_frame

    def spy_dev(cs, planes):
        got.append((cs, [p.numpy().copy() for p in planes[:cs.num_comp]]))
        return real_dev(cs, planes)

    def spy_host(cs, planes):
        got.append((cs, [p.copy() for p in planes]))
        return real_host(cs, planes)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(fd, "filter_frame_device", spy_dev)
        m.setattr(dnp, "deblock_frame", spy_host)
        decode_annexb(stream, device="cpu")
    return got


@functools.lru_cache(maxsize=None)
def _prefilter(name):
    stream = _filter_streams()[name]()
    ref, port = _capture_reference(stream), _capture_port(stream)
    assert len(ref) == len(port) > 0
    for (_, a), (_, b) in zip(ref, port):
        assert _equal(a, b)
    return ref, port


def _one_cell_bucket(m):
    """Pad every cell batch of the reference's deblocking to one size,
    so its XLA programs compile once per picture size and direction (the
    padding rows are never written, so the result is the same)."""
    import vvdec_tpu.ops.pipeline as JP
    pad = JP._pad_pow2
    m.setattr(JP, "_pad_pow2", lambda n, lo=64: pad(n, 512))


@functools.lru_cache(maxsize=None)
def _staged(name):
    """Per picture: the reference's planes before deblocking, after it,
    after SAO and after ALF (each stage run on the previous stage's
    output)."""
    from vvdec_tpu.ops.pipeline import (
        alf_frame_jax,
        deblock_frame_jax,
        sao_frame_jax,
    )
    out = []
    for cs, planes in _prefilter(name)[0]:
        pre = [p.copy() for p in planes]
        db = [p.copy() for p in planes]
        with pytest.MonkeyPatch.context() as m:
            _one_cell_bucket(m)
            deblock_frame_jax(cs, db)
        sao = [p.copy() for p in db]
        sao_frame_jax(cs, sao)
        out.append((pre, db, sao, alf_frame_jax(cs, [p.copy() for p in sao])))
    return out


@pytest.mark.parametrize("name", FILTER_STREAMS)
def test_deblock_frame_matches_jax(name, monkeypatch):
    """deblock_frame_torch == deblock_frame_jax, with every picture's
    writes distinct within each cell batch."""
    n_writes = []
    real = TP._scatter_cells

    def distinct(flat, idx, val):
        assert idx.unique().numel() == idx.numel()
        n_writes.append(idx.numel())
        return real(flat, idx, val)

    monkeypatch.setattr(TP, "_scatter_cells", distinct)
    for (cs, _), (pre, want, _, _) in zip(_prefilter(name)[1],
                                          _staged(name)):
        got = [p.copy() for p in pre]
        TP.deblock_frame_torch(cs, got, device="cpu")
        assert _equal(got, want)
    assert sum(n_writes) > 0


@pytest.mark.parametrize("name", FILTER_STREAMS)
def test_sao_frame_matches_jax(name):
    for (cs, _), (_, db, want, _) in zip(_prefilter(name)[1],
                                         _staged(name)):
        got = [p.copy() for p in db]
        TP.sao_frame_torch(cs, got, device="cpu")
        assert _equal(got, want)


@pytest.mark.parametrize("name", FILTER_STREAMS)
def test_alf_frame_matches_jax(name):
    n_alf = 0
    for (cs, _), (_, _, sao, want) in zip(_prefilter(name)[1],
                                          _staged(name)):
        got = TP.alf_frame_torch(cs, [p.copy() for p in sao], device="cpu")
        assert _equal(got, want)
        n_alf += not _equal(want, sao)
    assert n_alf or name in ("sao", "deblock")


@pytest.mark.parametrize("name", ("vb", "tiles"))
def test_reconstruct_frame_matches_jax(name):
    """Stage 1 on the device, prediction on the host, deblocking on the
    device, on intra pictures (each package's own parse)."""
    from vvdec_tpu.decoder import parse_annexb as parse_ref
    from vvdec_tpu.ops.pipeline import reconstruct_frame_jax
    from vvdec_tpu_torch.decoder import parse_annexb
    stream = _filter_streams()[name]()
    for fr, fp in zip(parse_ref(stream), parse_annexb(stream)):
        assert fp.cs.sh.is_intra
        with pytest.MonkeyPatch.context() as m:
            _one_cell_bucket(m)
            want = reconstruct_frame_jax(fr.cs)
        assert _equal(TP.reconstruct_frame_torch(fp.cs, device="cpu"), want)


@pytest.mark.cuda
def test_filters_on_card_match_cpu():
    """On the card: the three filters equal their CPU runs on the
    virtual-boundary and tiles pictures (port only, no JAX there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vvdec_tpu_torch.streams import tiles_alf_stream, vb_stream
    for stream in (vb_stream(3), tiles_alf_stream(1, TILES_PPS)):
        for cs, planes in _capture_port(stream):
            a, b = ([p.copy() for p in planes] for _ in range(2))
            TP.deblock_frame_torch(cs, a, device="cuda")
            TP.deblock_frame_torch(cs, b, device="cpu")
            assert _equal(a, b)
            TP.sao_frame_torch(cs, a, device="cuda")
            TP.sao_frame_torch(cs, b, device="cpu")
            assert _equal(a, b)
            assert _equal(TP.alf_frame_torch(cs, a, device="cuda"),
                          TP.alf_frame_torch(cs, b, device="cpu"))


@pytest.mark.parametrize("which", ["vb", "vb-chip", "tiles"])
def test_stream_builders_match_test_builders(which):
    """streams.vb_stream and streams.tiles_alf_stream are byte-equal to
    the test builders they copy (tests/test_virtual_boundaries.py's
    _vb_stream, tests/test_alf.py's TestAlfAcrossBoundaries._stream),
    the virtual-boundary stream also with chip_smoke.py's boundary
    positions on a 96x64 picture."""
    from tests.test_alf import TestAlfAcrossBoundaries
    from tests.test_virtual_boundaries import _vb_stream
    from vvdec_tpu_torch.streams import tiles_alf_stream, vb_stream
    port, ref = {
        "vb": lambda: (vb_stream(3), _vb_stream(3, alf=True)),
        "vb-chip": lambda: (vb_stream(5, 1, vbx=(16, 64), vby=(24,)),
                            _vb_stream(5, 1, alf=True, vbx=(16, 64),
                                       vby=(24,))),
        "tiles": lambda: (tiles_alf_stream(1, TILES_PPS),
                          TestAlfAcrossBoundaries()._stream(1, TILES_PPS)),
    }[which]()
    assert port == ref
