"""The port's command-line decoders and GOP worker pool against the JAX
package's, on the CPU.

vvdec_tpu_torch.app.main (the vvdecapp analog) with -o, --y4m and -md5
must write the bytes vvdec_tpu.app.main writes (its default path, no
--jax) and exit 0 on the right MD5, 1 on a wrong one; with -t 2 -fg 0
it takes the worker pool and writes the same bytes.  weave_fields and
split_irap_segments equal the reference's; decode_annexb_parallel with
2 spawned workers on the CPU equals the reference's serial decode;
decoder.main writes what the reference's does.  Without a card the
entry points raise unless the CPU is asked for.  Tolerance: bit-equal.
"""

import hashlib

import numpy as np
import pytest
import torch


def _stream(n_frames=4, seed=9):
    from vvdec_tpu.testenc.encoder import generate_stream
    return generate_stream(width=96, height=64, ctu=32, n_frames=n_frames,
                           seed=seed, qp=32,
                           dec_kw=dict(split_prob=0.3, density=0.1))[0]


def _two_gops():
    """An IDR with two P pictures, then a 2-picture all-IDR stream: three
    segments, which the pool splits into two chunks by size."""
    from tests.test_torch_conceal import _inter_stream
    return b"".join(_inter_stream(3)) + _stream(2, seed=2)


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("app") / "in.266"
    path.write_bytes(_stream())
    return path


@pytest.mark.parametrize("y4m", [False, True], ids=["yuv", "y4m"])
def test_app_output_equals_reference(stream_file, tmp_path, y4m):
    import vvdec_tpu.app as R
    import vvdec_tpu_torch.app as T
    from vvdec_tpu.decoder import decode_to_yuv
    md5 = hashlib.md5(decode_to_yuv(stream_file.read_bytes())).hexdigest()
    extra = ["--y4m"] if y4m else []
    out_t, out_r = tmp_path / "port.yuv", tmp_path / "ref.yuv"
    assert T.main(["-b", str(stream_file), "-o", str(out_t), "-t", "1",
                   "-md5", md5, "--device", "cpu", *extra]) == 0
    assert R.main(["-b", str(stream_file), "-o", str(out_r), "-t", "1",
                   "-md5", md5, *extra]) == 0
    assert out_t.read_bytes() == out_r.read_bytes()
    assert out_t.read_bytes().startswith(b"YUV4MPEG2 W96 H64") == y4m


def test_app_wrong_md5_exits_1(stream_file):
    import vvdec_tpu_torch.app as T
    assert T.main(["-b", str(stream_file), "-t", "1", "-md5", "0" * 32,
                   "--device", "cpu"]) == 1


def test_app_worker_pool_path(stream_file, tmp_path):
    """-t 2 with no -dph/-fg/-eh takes decode_annexb_parallel."""
    import vvdec_tpu_torch.app as T
    from vvdec_tpu.decoder import decode_to_yuv
    out = tmp_path / "pool.yuv"
    assert T.main(["-b", str(stream_file), "-o", str(out), "-t", "2",
                   "-fg", "0", "--device", "cpu"]) == 0
    assert out.read_bytes() == decode_to_yuv(stream_file.read_bytes())


def test_app_needs_cuda_unless_cpu_is_asked(stream_file):
    import vvdec_tpu_torch.app as T
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.main(["-b", str(stream_file), "-t", "1"])


def _ffi(bottom):
    from vvdec_tpu.hls.sei import SEI_FRAME_FIELD_INFO, SeiMessage
    from vvdec_tpu.testenc.bitwriter import BitWriter
    w = BitWriter()
    w.u(1, 1)           # field_pic
    w.u(int(bottom), 1)
    w.u(1, 1)           # pairing indicated
    w.u(1, 1)           # paired with next
    w.u(0, 2)
    w.u(0, 1)
    w.u(0, 1)
    return SeiMessage(SEI_FRAME_FIELD_INFO, w.bytes())


def test_weave_fields_equals_reference():
    import vvdec_tpu.app as R
    import vvdec_tpu_torch.app as T
    rng = np.random.default_rng(3)

    def field():
        return [rng.integers(0, 1024, (4, 8), dtype=np.uint16),
                rng.integers(0, 1024, (2, 4), dtype=np.uint16)]

    frames = [(field(), [_ffi(True)]), (field(), [_ffi(False)]),
              (field(), []), (field(), [_ffi(False)]),
              (field(), [_ffi(True)]), (field(), [_ffi(False)])]
    got, want = T.weave_fields(frames), R.weave_fields(frames)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert all(np.array_equal(p, q) for p, q in zip(a, b))
    assert got[0][0].shape == (8, 8)


@pytest.mark.parametrize("which", ["all IDR", "two GOPs"])
def test_split_irap_segments_equals_reference(which):
    from vvdec_tpu.parallel import split_irap_segments as ref_split
    from vvdec_tpu_torch.parallel import split_irap_segments
    data = _stream(3, seed=2) if which == "all IDR" else _two_gops()
    segs = split_irap_segments(data)
    assert segs == ref_split(data)
    assert len(segs) == 3


def test_gop_parallel_decode_equals_reference_serial():
    from vvdec_tpu.decoder import decode_annexb
    from vvdec_tpu_torch.parallel import decode_annexb_parallel
    data = _two_gops()
    serial = decode_annexb(data)
    par = decode_annexb_parallel(data, workers=2, device="cpu")
    assert len(par) == len(serial) == 5
    for a, b in zip(serial, par):
        assert all(np.array_equal(p, q) for p, q in zip(a, b))
    reps = decode_annexb_parallel.worker_reports
    assert sum(r["frames"] for r in reps) == 5 and len(reps) == 2
    assert all(r["max_memory_reserved"] is None for r in reps)


def test_gop_parallel_needs_cuda_unless_cpu_is_asked():
    from vvdec_tpu_torch.parallel import decode_annexb_parallel
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_annexb_parallel(_two_gops(), workers=2)


def test_decoder_main_equals_reference(stream_file, tmp_path):
    import vvdec_tpu.decoder as R
    import vvdec_tpu_torch.decoder as T
    out_t, out_r = tmp_path / "port.yuv", tmp_path / "ref.yuv"
    assert T.main([str(stream_file), str(out_t), "--device", "cpu"]) == 0
    assert R.main([str(stream_file), str(out_r)]) == 0
    assert out_t.read_bytes() == out_r.read_bytes()
    assert len(out_t.read_bytes()) == 4 * 96 * 64 * 3
