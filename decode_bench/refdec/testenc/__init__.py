"""Test encoder: a constrained VVC bitstream writer.

Used to synthesize legal Main10 bitstreams for testing (the environment has no
network access to the JVET conformance suite).  Streams produced here are
validated against the reference vvdec binary, which then acts as the
bit-exactness oracle for the TPU decoder.
"""

from refdec.testenc.bitwriter import BitWriter  # noqa: F401
