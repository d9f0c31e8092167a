"""refdec: the benchmark's plain reference VVC (H.266) decoder.

A frozen copy of the host plane that vvdec_tpu_torch vendors (its
`_vendored.VENDORED` list) with the imports renamed to this package, in
Python and NumPy alone: `native` answers None for every C accelerator.
`decoder` drives it (a host-only copy of the original driver), and
`testenc` is the test encoder that makes the benchmark's clips.  One
repair differs from the original: `frame.alf_np.filter_cc_frame` clamps
to the whole picture when it has no clamp window.  Nothing here imports
jax, vvdec_tpu or vvdec_tpu_torch.
"""
