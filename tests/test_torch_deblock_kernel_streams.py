"""The dense deblock's kernel wrapper (vvdec_tpu_torch/ops/cuda/deblock.py)
on stream pictures against the deblock of the JAX reference's filter
chain (vvdec_tpu/ops/device_pipeline.py::_chain_fn with SAO and ALF off
in its key).

Tolerance: bit-equal (integer arithmetic).  Both packages get the same
inputs: the packed grids of tests/test_torch_stages.py's two 128x96
stage-stream pictures (4:2:0 and 4:4:4), each package's own (held
equal), under the port's CPU decode's pre-filter reconstruction
(bit-equal to the reference's, tests/test_torch_decode.py) and under
blocky planes made with numpy from a seed.  On the CPU the wrapper runs
its plain version; tests/test_torch_deblock_kernel.py holds the kernel
to it on the card.
"""

import numpy as np
import pytest

from tests.test_torch_deblock_kernel import (STAGE_STREAMS, _jax_deblock,
                                             _run, _wrapper)


@pytest.mark.parametrize("name", list(STAGE_STREAMS))
def test_stream_pictures_match_jax_chain(name):
    """The stage stream's first picture: its grids under the real
    reconstruction and under blocky planes, the wrapper == the reference
    chain's deblock."""
    from vvdec_tpu.decoder import parse_annexb as parse_ref
    from vvdec_tpu.ops.device_pipeline import \
        _deblock_grid_inputs as grids_ref
    from vvdec_tpu_torch.ops.cuda.deblock import random_inputs
    from vvdec_tpu_torch.ops.device_pipeline import \
        _deblock_grid_inputs as grids_port
    from vvdec_tpu_torch.parallel.dryrun import capture_filter_inputs
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    s, _ = generate_stream(width=128, height=96, ctu=32,
                           **STAGE_STREAMS[name])
    cs_ref = parse_ref(s)[0].cs
    cs_port, real = capture_filter_inputs(s, "cpu")[0]
    db, db_port = grids_ref(cs_ref), grids_port(cs_port)
    assert sorted(db) == sorted(db_port)
    for k, v in db.items():
        assert np.array_equal(v, db_port[k]), k
    kw = dict(bd=cs_ref.sps.bit_depth, ctu=cs_ref.sps.ctu_size,
              sub_w=cs_ref.sub_w, sub_h=cs_ref.sub_h, n_sl=len(cs_ref.shs))
    grids = [db[k] for k in ("db_y", "db_cb", "db_cr")]
    blocky = random_inputs(7, 96, 128, cfmt=cs_ref.sps.chroma_format_idc,
                           bd=kw["bd"])[0]
    for kind, planes in (("real", [p.numpy() for p in real]),
                         ("blocky", blocky)):
        # the slice table as the host packs it for the upload
        case = (planes, grids, db.get("db_si"),
                db["db_sltab"].astype(np.int16), kw)
        got = _run(_wrapper(), case)
        want = _jax_deblock(case)
        for c, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (kind, c)
        assert any(not np.array_equal(a, p) for a, p in zip(got, planes))
