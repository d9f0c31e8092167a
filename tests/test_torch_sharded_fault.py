"""A fault of the reference's sharded filter chain that the port does not
share (ROADMAP.md, queue 3).

With ALF or CC-ALF on, vvdec_tpu/ops/sharded_chain.py leaves the halo's
replicated pre-chain rows above the picture's first row (and below its
last) when ALF, its classification and CC-ALF read there, while the
whole-frame chain clamps those reads to the picture's rows as deblocking
and SAO left them.  On the port's 128x96 SAO/ALF picture (every stage
on) the reference's sharded chain therefore differs from its own
unsharded chain in rows next to the picture's top and bottom edges, and
nowhere else; the port's sharded chain
(which replicates the filtered border rows before ALF) equals both
unsharded chains.  Tolerance: bit-equal; the reference runs on 2 of the
8 virtual CPU devices of tests/conftest.py.
"""

import numpy as np


def test_reference_sharded_chain_differs_at_picture_edge():
    import jax
    from jax.sharding import Mesh

    from tests.test_torch_sharded_chain import _captured, _port_mesh
    from vvdec_tpu.ops import device_pipeline as R
    from vvdec_tpu.ops.sharded_chain import filter_frames_sharded as ref_fn
    from vvdec_tpu_torch.ops.device_pipeline import filter_frame_device
    from vvdec_tpu_torch.ops.sharded_chain import filter_frames_sharded
    from vvdec_tpu_torch.state import to_numpy
    port, ref = _captured("sao_alf")
    ref_unsharded = R.filter_frame_device(*ref[0]).resolve()
    ref_sharded = ref_fn(ref[:1], Mesh(np.array(jax.devices()[:2]), ("row",)),
                         axis="row")[0]
    got = filter_frames_sharded(port[:1], _port_mesh(None, 2))[0]
    unsharded = filter_frame_device(*port[0]).resolve()
    edge_faults = 0
    for a, b, c, d in zip(got, unsharded, ref_unsharded, ref_sharded):
        assert np.array_equal(to_numpy(a), b)
        assert np.array_equal(b, np.asarray(c))
        h = b.shape[0]
        rows = set(np.nonzero((np.asarray(d) != b).any(1))[0].tolist())
        assert rows <= {0, 1, h - 2, h - 1}, rows
        edge_faults += len(rows)
    assert edge_faults
