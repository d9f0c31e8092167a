"""The rest of bench.py's configurations, held to the reference on the CPU.

vvdec_tpu_torch/streams.py carries builders and pins for every
configuration of bench.py (bench.py:239-253) that chip_smoke.py phase 13
decodes on the card: dense q27, max-density q22, all eight frames of
tool-rich and SAO/ALF, SAO/ALF 1920x1080 and inter-LD 1920x1080.

This file holds, bit-equal:
- the port's builders to bench.py's, made with vvdec_tpu.testenc, for the
  1080p streams at a cut size through the same code path (192x120, 2
  frames); the full-size streams and pins are in
  test_torch_bench_configs_{q27,q22,8f,1080}.py;
- small analogs of the new decodes, through the port on device="cpu",
  to vvdec_tpu's device path (use_jax=True) and to its host golden, each
  with an empty fallback census: here the dense q27 and max-density q22
  decisions at 128x64, 2 frames; the 1080p geometry (128x120: a width of
  two CTUs and a bottom CTU row of 56 rows, as 1080 = 16 * 64 + 56) in
  test_torch_bench_configs_geometry.py (SAO, ALF and CC-ALF, 2 intra
  frames) and test_torch_bench_configs_inter.py (inter-LD, 3 frames),
  apart so that the JAX device path's compiles spread over the workers.
"""

import numpy as np
import pytest

import bench
import vvdec_tpu_torch.streams as S

# bench.py's inter-LD decisions (bench.py:211-212)
BENCH_INTER_KW = dict(split_prob=0.35, inter_prob=0.85, skip_prob=0.3,
                      mv_range=32)
# bench.py's dense q27 (bench.py:215-217) and max-density q22
# (bench.py:231-235) generate_stream parameters
BENCH_DENSE = dict(width=832, height=480, ctu=64, n_frames=8, seed=3,
                   qp=27, dec_kw=dict(split_prob=0.35, density=0.5))
BENCH_MAX_DENSITY = dict(width=832, height=480, ctu=64, n_frames=6, seed=7,
                         qp=22, dec_kw=dict(split_prob=0.4, density=0.85,
                                            max_level=120))
# bench.py's tool-rich intra configuration (bench.py:219-226)
BENCH_TOOL_RICH = dict(
    width=832, height=480, ctu=64, n_frames=8, seed=3, qp=30,
    sps_kw=dict(mip_enabled=True, cclm_enabled=True,
                lfnst_enabled=True, mts_enabled=True,
                explicit_mts_intra=True),
    dec_kw=dict(split_prob=0.35, density=0.3, mip_prob=0.25))


def test_stream_parameters_match_bench():
    """Each new builder's parameters are bench.py's configuration's, and
    phase 13 decodes the six in bench.py's order at their sizes."""
    assert S.DENSE_Q27_STREAM_KW == BENCH_DENSE
    assert S.MAX_DENSITY_Q22_STREAM_KW == BENCH_MAX_DENSITY
    assert S.TOOL_RICH_8_STREAM_KW == BENCH_TOOL_RICH
    assert S.SAO_ALF_8_STREAM_KW == dict(w=832, h=480, n=8, seed=1)
    assert S.SAO_ALF_1080P_STREAM_KW == dict(w=1920, h=1080, n=4, seed=1)
    assert S.INTER_LD_1080P_STREAM_KW == dict(w=1920, h=1080, n=6, seed=5,
                                              dec_kw=BENCH_INTER_KW)
    assert {name: S.picture_size(kw)
            for name, kw in S.BENCH_STREAMS.items()} == {
        "dense q27": (832, 480), "max-density q22": (832, 480),
        "tool-rich 8": (832, 480), "SAO/ALF 8": (832, 480),
        "SAO/ALF 1080p": (1920, 1080), "inter-LD 1080p": (1920, 1080)}
    assert S.PREFIXES == {"tool-rich": "tool-rich 8", "SAO/ALF": "SAO/ALF 8"}
    for name in S.BENCH_STREAMS:
        assert name in S.STREAMS
    assert S.STREAMS["tool-rich 8"][1:] == (8, S.TOOL_RICH_8_MD5)
    assert S.STREAMS["SAO/ALF 8"][1:] == (8, S.SAO_ALF_8_MD5)
    assert S.STREAMS["dense q27"][1:] == (8, S.DENSE_Q27_MD5)
    assert S.STREAMS["max-density q22"][1:] == (6, S.MAX_DENSITY_Q22_MD5)
    assert S.STREAMS["SAO/ALF 1080p"][1:] == (4, S.SAO_ALF_1080P_MD5)
    assert S.STREAMS["inter-LD 1080p"][1:] == (6, S.INTER_LD_1080P_MD5)


CUT = dict(w=192, h=120, n=2)


@pytest.mark.parametrize("name", ["SAO/ALF 1080p", "inter-LD 1080p"])
def test_1080p_builders_match_bench_at_a_cut_size(name):
    """The 1080p builders' code path, cut to 192x120 and 2 frames, makes
    bench.py's stream byte for byte."""
    if name == "SAO/ALF 1080p":
        port = S.sao_alf_stream(**dict(S.SAO_ALF_1080P_STREAM_KW, **CUT))
        ref = bench._intra_stream(CUT["w"], CUT["h"], CUT["n"], 1,
                                  filters=True)
    else:
        port = S.inter_ld_stream(**dict(S.INTER_LD_1080P_STREAM_KW, **CUT))
        ref = bench._ld_stream(CUT["w"], CUT["h"], CUT["n"], 5,
                               BENCH_INTER_KW)
    assert len(port) > 1000
    assert port == ref


# the small analogs of this file, each made by bench.py's builder (with
# vvdec_tpu)
ANALOGS = {
    "dense q27 128x64": lambda: _generate(
        dict(BENCH_DENSE, width=128, height=64, n_frames=2)),
    "max-density q22 128x64": lambda: _generate(
        dict(BENCH_MAX_DENSITY, width=128, height=64, n_frames=2)),
}


def _generate(kw):
    from vvdec_tpu.testenc.encoder import generate_stream
    return generate_stream(**kw)[0]


def port_decode(stream):
    """(frames, fallback census) of the port's StreamDecoder on the CPU."""
    from vvdec_tpu_torch.decoder import StreamDecoder
    dec = StreamDecoder(device="cpu")
    pics = dec.push(stream) + dec.flush()
    return [p.planes for p in pics], dict(dec.fallback_census)


def reference_decodes(stream):
    """(host golden frames, device path frames, device path census) of
    vvdec_tpu's StreamDecoder."""
    from vvdec_tpu.decoder import StreamDecoder, decode_annexb
    dec = StreamDecoder(use_jax=True)
    pics = dec.push(stream) + dec.flush()
    return (decode_annexb(stream), [p.planes for p in pics],
            dict(dec.fallback_census))


def assert_frames_equal(want, got):
    assert len(want) == len(got) > 0
    for fw, fg in zip(want, got):
        assert len(fw) == len(fg) == 3
        for pw, pg in zip(fw, fg):
            pw = np.asarray(pw)
            assert pg.dtype == pw.dtype and pg.shape == pw.shape
            assert np.array_equal(pw, pg)


def check_analog(stream, port_stream, n_frames, wh):
    """The port's builder made `stream`; its decode on the CPU equals the
    reference's device path and host golden, every picture on the
    device on both sides."""
    assert port_stream == stream
    golden, jax_dev, jax_census = reference_decodes(stream)
    port, census = port_decode(stream)
    assert jax_census == {} and census == {}
    assert len(port) == n_frames
    assert port[0][0].shape == (wh[1], wh[0])
    assert_frames_equal(golden, jax_dev)
    assert_frames_equal(jax_dev, port)
    assert_frames_equal(golden, port)


def check_full_size(name, bench_kw):
    """STREAMS[name]'s builder makes generate_stream(**bench_kw) of
    vvdec_tpu.testenc byte for byte, and its pin is the host golden's
    (tests/test_torch_bench_configs_q27.py and _q22.py)."""
    import hashlib

    from vvdec_tpu.decoder import decode_to_yuv
    builder, n_frames, md5 = S.STREAMS[name]
    port = builder()
    ref = _generate(bench_kw)
    assert len(port) > 100000
    assert port == ref
    yuv = decode_to_yuv(ref)
    assert len(yuv) == n_frames * 832 * 480 * 3   # 4:2:0, two bytes
    assert hashlib.md5(yuv).hexdigest() == md5


@pytest.mark.parametrize("name", list(ANALOGS))
def test_analog_matches_jax_device_path_and_host_golden(name):
    kw = S.DENSE_Q27_STREAM_KW if name.startswith("dense") \
        else S.MAX_DENSITY_Q22_STREAM_KW
    port_stream = S.intra_stream(**dict(kw, width=128, height=64,
                                        n_frames=2))
    check_analog(ANALOGS[name](), port_stream, 2, (128, 64))
