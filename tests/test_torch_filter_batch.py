"""The port's batched filter chain (`filter_frames_device_batch`, one
pass over a stack of pictures through torch.func.vmap of `_chain_fn`)
against the JAX reference's, and against the port's per-frame chain.

Tolerance: bit-equal (integer arithmetic).  Both packages get the same
inputs: pictures parsed by each package from the same stream and the
pre-filter planes of the port's CPU decode (bit-equal to the
reference's).  The reference batches only pictures of one static key;
the port also takes pictures whose ALF bank counts differ
(`device_pipeline.batch_key`), held to its per-frame chain.
"""

import numpy as np
import pytest

from tests.test_torch_sharded_chain import capture_both


def test_batched_chain_matches_jax():
    """tests/test_device_pipeline.py's batch: three 96x64 SAO pictures
    in one pass, each picture equal to the reference's batch and to the
    port's per-frame chain."""
    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    s, _ = generate_stream(
        width=96, height=64, ctu=32, n_frames=3, seed=5, qp=30,
        sps_kw=dict(sao_enabled=True),
        sh_kw=dict(sao_enabled_luma=True, sao_enabled_chroma=True),
        dec_kw=dict(split_prob=0.5, sao_prob=0.7))
    port, ref = capture_both(s)
    got = T.filter_frames_device_batch(port)
    want = R.filter_frames_device_batch(ref)
    assert len(got) == len(want) == 3
    for g, w, (cs, planes) in zip(got, want, port):
        one = T.filter_frame_device(cs, planes).resolve()
        for a, b, c in zip(g.resolve(), w.resolve(), one):
            assert np.array_equal(a, b) and np.array_equal(a, c)


def test_batched_chain_every_stage_mixed_banks():
    """Deblock, SAO, ALF and CC-ALF on, the pictures' luma ALF bank
    counts 2, 3, 2: the batch pads the banks and each picture equals its
    per-frame chain; pictures of two geometries raise."""
    import vvdec_tpu_torch.ops.device_pipeline as T
    from vvdec_tpu_torch.parallel.dryrun import capture_filter_inputs
    from vvdec_tpu_torch.streams import sao_alf_stream
    port = capture_filter_inputs(sao_alf_stream(w=128, h=96, n=3, seed=1),
                                 "cpu")
    keys = [T._frame_key_arrays(cs, [tuple(p.shape) for p in planes])[0]
            for cs, planes in port]
    assert len({k[16] for k in keys}) > 1 and all(k[13:16] for k in keys)
    for g, (cs, planes) in zip(T.filter_frames_device_batch(port), port):
        for a, b in zip(g.resolve(),
                        T.filter_frame_device(cs, planes).resolve()):
            assert np.array_equal(a, b)
    other = capture_filter_inputs(sao_alf_stream(w=96, h=64, n=1, seed=1),
                                  "cpu")
    with pytest.raises(ValueError):
        T.filter_frames_device_batch(port[:1] + other)
