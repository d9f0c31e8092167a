"""Random-access B pictures through the port's entry point, on the CPU:
the seed streams and the device-residency stream of
tests/test_dmvr_device.py::TestDmvrDevice (test_dmvr_bdof_seeds,
test_stays_on_device), DMVR and BDOF both on.

Tolerance: bit-equal.  Each decodes through vvdec_tpu_torch's
StreamDecoder on the CPU equal to the JAX device pipeline and the host
golden, with an empty fallback census, through both refinement stages,
and with the JAX decode's motion field after the refined-MV fixups
(tests/test_torch_ra.py holds the helpers).
"""

import pytest

from tests.test_torch_ra import check_frames, check_motion, decode_streams

NAMES = ["dmvr_bdof_seed4", "dmvr_bdof_seed5", "stays_on_device"]


@pytest.fixture(scope="module")
def decoded():
    """Each decode of this file's streams runs once."""
    return decode_streams(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_matches_jax_device_pipeline_and_host_golden(decoded, name):
    check_frames(decoded[name], ("DMVR", "BDOF"))


@pytest.mark.parametrize("name", NAMES)
def test_refined_motion_field_matches_jax(decoded, name):
    check_motion(decoded[name], refined=True)
