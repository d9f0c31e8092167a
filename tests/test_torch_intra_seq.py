"""The port's sequential intra scan (`_intra_scan_fn`, one unit a step)
against the JAX reference's, and against the port's own wavefront.

Tolerance: bit-equal (integer arithmetic).  Both packages get the same
inputs: a 128x96 intra picture with MIP, CCLM and LMCS chroma residual
scaling (tests/test_torch_intra_tools.py's "lmcs_mip_cclm" stream),
parsed by the reference, its residual planes and descriptors, and
planes of seeded noise, so every sample a unit reads shows in the
output.  The descriptors are padded with zero rows to a power of two,
as the reference's run_intra_scan pads them; a zero row writes nothing.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_intra_tools import _scan_inputs
from vvdec_tpu_torch.state import to_numpy, to_torch

BD = 10


@functools.lru_cache(maxsize=None)
def _inputs():
    from vvdec_tpu_torch.ops.intra_device import D
    resi, desc, key, lm = _scan_inputs("lmcs_mip_cclm")
    cls = set(desc[:, 7].tolist())
    assert {3, 4} <= cls and (desc[:, 29] & 1).any()
    n_pad = 1 << max(0, desc.shape[0] - 1).bit_length()
    padded = np.concatenate(
        [desc, np.zeros((n_pad - desc.shape[0], D), dtype=np.int32)])
    rng = np.random.default_rng(7)
    planes = tuple(rng.integers(0, 1 << BD, size=r.shape).astype(np.int32)
                   for r in resi)
    return resi, desc, padded, key, lm, planes


def _port_seq(planes, resi, desc, key, lm):
    import vvdec_tpu_torch.ops.intra_device as T
    return to_numpy(T._intra_scan_fn(*key, True)(
        to_torch(planes, "cpu"), to_torch(resi, "cpu"), desc,
        to_torch(lm, "cpu")))


def test_intra_scan_fn_matches_jax():
    """_intra_scan_fn(key, has_lmcs=True) == the reference's on the
    zero-padded descriptors."""
    import vvdec_tpu.ops.intra_device as R
    resi, _, padded, key, lm, planes = _inputs()
    want = R._intra_scan_fn(*key, True)(
        *(tuple(jnp.asarray(p) for p in planes),
          tuple(jnp.asarray(r) for r in resi), jnp.asarray(padded),
          jnp.asarray(lm)))
    got = _port_seq(planes, resi, padded, key, lm)
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))
    assert any(not np.array_equal(a, p) for a, p in zip(got, planes))


def test_seq_equals_wavefront_and_padding_writes_nothing():
    """The sequential scan equals the port's wavefront on the same
    picture (run_intra_scan with scan="seq" and "wavefront"), and the
    zero-padded descriptors give what the unpadded ones give."""
    from vvdec_tpu_torch.ops.intra_device import run_intra_scan
    resi, desc, padded, key, lm, planes = _inputs()
    assert padded.shape[0] > desc.shape[0]
    args = (to_torch(planes, "cpu"), to_torch(resi, "cpu"))
    lm_t = to_torch(lm, "cpu")
    wave = to_numpy(run_intra_scan(*args, desc, key, lm_t))
    seq = to_numpy(run_intra_scan(*args, desc, key, lm_t, scan="seq"))
    seq_pad = _port_seq(planes, resi, padded, key, lm)
    for a, b, c in zip(wave, seq, seq_pad):
        assert np.array_equal(a, b) and np.array_equal(b, c)
    # the input planes are left as they were
    assert all(np.array_equal(to_numpy(a), p) for a, p in zip(args[0],
                                                              planes))
    with pytest.raises(ValueError):
        run_intra_scan(*args, desc, key, lm_t, scan="diagonal")
