"""The host-plane files this package carries as copies of vvdec_tpu's.

The port may not import the JAX package, so it keeps its own copy of
every host-plane module the decode reaches.  Each copy equals the
original, byte for byte, after `translate`: the token `vvdec_tpu`
becomes `vvdec_tpu_torch` (imports, the native loader's module name,
comments) and `VVDEC_TPU` becomes `VVDEC_TPU_TORCH` (environment
variable names).  tests/test_torch_isolation.py checks every file listed
here against its original, so the two host planes cannot drift apart.
To resync after a change to the original, copy the file and apply
`translate`.

`utils/trace.py` is no longer a copy but the port's own: its stage
profiler keeps a span log and times device stages with CUDA events,
where the JAX package's has no card to wait for.  Its logging and
channel tracer are still the original's.
"""

VENDORED = (
    "bitstream/__init__.py", "bitstream/nal.py", "bitstream/reader.py",
    "cabac/__init__.py", "cabac/ctu_decoder.py", "cabac/ctx_tables.py",
    "cabac/engine.py", "cabac/native_walk.py", "cabac/partitioner.py",
    "hls/__init__.py", "hls/params.py", "hls/reader.py",
    "hls/weight_table.py", "hls/sei.py", "hls/alf_aps.py",
    "hls/scaling_list.py",
    "frame/__init__.py", "frame/structure.py", "frame/recon_np.py",
    "frame/deblock_np.py", "frame/inter_np.py", "frame/rpr_np.py",
    "frame/lmcs_np.py", "frame/alf_np.py", "frame/dmvr_np.py",
    "frame/geo_np.py", "frame/affine_np.py", "frame/recon_native.py",
    "frame/inter_native.py", "frame/sao_np.py", "frame/film_grain.py",
    "native/__init__.py", "native/cabac.c", "native/walk.c",
    "native/walk2.c", "native/walk3.c", "native/walk4.c", "native/walk5.c",
    "native/walk6.c", "native/walk7.c", "native/walk8.c", "native/walk9.c",
    "native/recon.c",
    "dpb.py", "utils/__init__.py",
    "ops/rom.py", "ops/tables.py", "ops/tables_tr.npz", "ops/tables_mip.npz",
    "ops/tables_if.npz", "ops/tables_rpr.npz", "ops/tables_alf.npz",
    "ops/tables_vfgs.npz",
    "testenc/__init__.py", "testenc/bitwriter.py", "testenc/encoder.py",
    "testenc/hls_writer.py",
)


def translate(data: bytes) -> bytes:
    """The original file's bytes -> the port's copy."""
    return (data.replace(b"vvdec_tpu", b"vvdec_tpu_torch")
            .replace(b"VVDEC_TPU", b"VVDEC_TPU_TORCH"))
