"""The port does what the JAX package does: for every module of
vvdec_tpu/, each top-level function and class has a counterpart of the
same name (`_jax` becomes `_torch`) at the top level of the port's
module of the same path (ops/pallas/ becomes ops/cuda/), or stands in
NO_COUNTERPART below with the reason.  The list holds exactly the names
that have no counterpart, so a name that gains one must leave it.

The modules are read with ast: nothing of either package is imported.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "vvdec_tpu")
PORT = os.path.join(ROOT, "vvdec_tpu_torch")

NO_COUNTERPART = {
    # jax.jit wrappers of a core: the port's core is already the
    # function over tensors, and PyTorch has no trace to cache
    ("ops/pipeline.py", "_sao_apply_fn"): "jit wrapper of _sao_apply_core",
    ("ops/pipeline.py", "_alf_diamond_fn"):
        "jit wrapper of _alf_diamond_core",
    ("ops/pipeline.py", "_ccalf_fn"): "jit wrapper of _ccalf_core",
    ("ops/pipeline.py", "_deblock_luma_cells_fn"):
        "jit wrapper of _deblock_luma_cells_core",
    ("ops/pipeline.py", "_deblock_chroma_cells_fn"):
        "jit wrapper of _deblock_chroma_cells_core",
    ("ops/frame_device.py", "_lmcs_inv_fn"):
        "jit wrapper of intra_device.lmcs_inv_map, which the port calls",
    # backend switch: the tensor's device decides, no environment switch
    ("ops/pipeline.py", "_use_pallas"):
        "the input's device picks itx_batch_cuda's kernel or its plain "
        "version",
    # the Pallas kernel and its helpers: the hand-written CUDA kernel
    ("ops/pallas/itx.py", "_itx_kernel"): "csrc/itx.cu itx_kernel",
    ("ops/pallas/itx.py", "_exact_i32_dot"):
        "csrc/itx.cu (int8 tensor-core products with the hi/lo split)",
    ("ops/pallas/itx.py", "itx_batch_pallas"):
        "ops/cuda/itx.itx_batch_cuda (same interface, csrc/itx.cu)",
    # the port's chain takes a leading frame axis itself
    ("ops/device_pipeline.py", "_chain_fn_batched"):
        "vmap of _chain_fn; the port's _chain_fn takes the stacked "
        "pictures, each kernel launching once for them",
    # a second ALF classifier of the reference; the port keeps the dense
    # one, and tests/test_torch_filters.py holds it against both
    ("ops/device_pipeline.py", "_classify_jnp"):
        "second classifier; the port's _classify_dense is tested "
        "against it",
    # a TPU trick: gathers as one-hot matmuls on the MXU
    ("ops/intra_device.py", "_take1d"):
        "one-hot matmul gather for the TPU; the port indexes directly",
    # dead code in the reference: its pool submits _decode_segment_shm
    ("parallel/gop.py", "_decode_segment"):
        "unused by the reference; the pool runs _decode_segment_shm",
}


def _modules():
    out = []
    for root, _, files in os.walk(REF):
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), REF))
    return sorted(out)


def _port_path(rel: str) -> str:
    return os.path.join(PORT, rel.replace("ops/pallas/", "ops/cuda/"))


def _defined(path: str) -> list:
    """Top-level functions and classes."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))]


def _bound(path: str) -> set:
    """Every name bound at the top level: definitions, assignments and
    imports (a counterpart may be an alias of another function)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set(_defined(path))
    for n in tree.body:
        if isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update(a.asname or a.name.split(".")[0] for a in n.names)
    return out


def _missing() -> set:
    miss = set()
    for rel in _modules():
        port = _port_path(rel)
        have = _bound(port) if os.path.exists(port) else set()
        miss.update((rel, n) for n in _defined(os.path.join(REF, rel))
                    if n.replace("_jax", "_torch") not in have)
    return miss


def test_every_module_has_a_counterpart():
    assert _modules()
    for rel in _modules():
        assert os.path.exists(_port_path(rel)), rel


@pytest.mark.parametrize("rel", ["ops/pipeline.py", "ops/device_pipeline.py",
                                 "ops/frame_device.py", "decoder.py"])
def test_entry_modules_are_whole(rel):
    """The modules of the device pipeline and the decoder: every name
    has a counterpart or a listed reason."""
    miss = {m for m in _missing() if m[0] == rel}
    assert miss <= set(NO_COUNTERPART), sorted(miss - set(NO_COUNTERPART))


def test_every_name_has_a_counterpart_or_a_reason():
    miss = _missing()
    assert miss - set(NO_COUNTERPART) == set(), \
        sorted(miss - set(NO_COUNTERPART))
    # no stale entry: each listed name exists in the reference and has
    # no counterpart
    assert set(NO_COUNTERPART) - miss == set(), \
        sorted(set(NO_COUNTERPART) - miss)
    assert all(NO_COUNTERPART.values())


def test_pipeline_entry_points_are_ported():
    names = set(_defined(_port_path("ops/pipeline.py")))
    for n in ("itx_frame_torch", "reconstruct_frame_torch", "sao_frame_torch",
              "alf_frame_torch", "deblock_frame_torch", "_itx_fn",
              "_sao_apply_core", "_alf_diamond_core", "_ccalf_core",
              "_deblock_luma_cells_core", "_deblock_chroma_cells_core",
              "_deblock_chroma_dir_torch", "_pad_pow2", "_db_round"):
        assert n in names, n
