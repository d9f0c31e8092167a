"""The port's multi-device filter layer against the JAX reference: the
CTU-row-sharded chain (ops/sharded_chain.py), the mesh helpers
(parallel/sharding.py) and SAO's shard-border trimming.

Tolerance: bit-equal (integer arithmetic).  Both packages get the same
inputs: pictures parsed by each package from the same streams, the
pre-filter planes the port's CPU decode leaves (bit-equal to the
reference's, tests/test_torch_decode.py), and planes and parameters
made with numpy from a seed.  The reference runs on the 8 virtual CPU
devices tests/conftest.py gives JAX; the port's meshes name the CPU 8
times.  The two sharded configurations are tests/test_parallel.py's
TestShardedChain: SAO + deblock over ("frame", "row") = (2, 4), a
96-row picture padded to 128, and its second stream over a row mesh of
8.  Every filter stage at once (SAO, ALF, CC-ALF) is held to the port's
unsharded chain; tests/test_torch_sharded_fault.py shows the reference's
sharded chain differs there.
"""

import functools

import numpy as np
import pytest
import torch

from vvdec_tpu_torch.state import to_numpy, to_torch

BD = 10


def _streams():
    from vvdec_tpu_torch.streams import sao_alf_stream
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    return {
        "sao_deblock": generate_stream(
            width=128, height=96, ctu=32, n_frames=2, seed=21, qp=30,
            sps_kw=dict(sao_enabled=True),
            sh_kw=dict(sao_enabled_luma=True, sao_enabled_chroma=True),
            dec_kw=dict(split_prob=0.5, sao_prob=0.8))[0],
        "alf_ccalf": generate_stream(
            width=96, height=128, ctu=32, n_frames=1, seed=5, qp=30,
            sps_kw=dict(sao_enabled=True, alf_enabled=True,
                        ccalf_enabled=True),
            sh_kw=dict(sao_enabled_luma=True, sao_enabled_chroma=True),
            dec_kw=dict(split_prob=0.5, sao_prob=0.5))[0],
        # every stage on; the two pictures differ in their ALF bank count
        "sao_alf": sao_alf_stream(w=128, h=96, n=2, seed=1),
    }


def capture_both(stream):
    """(port items, reference items) of the stream's pictures: the
    port's CPU decode's filter inputs, and the same planes as numpy with
    the reference's own parse."""
    from vvdec_tpu.decoder import parse_annexb as parse_ref
    from vvdec_tpu_torch.parallel.dryrun import capture_filter_inputs
    port = capture_filter_inputs(stream, "cpu")
    ref = [(f.cs, [to_numpy(p) for p in planes])
           for f, (_, planes) in zip(parse_ref(stream), port)]
    return port, ref


@functools.lru_cache(maxsize=None)
def _captured(name):
    return capture_both(_streams()[name])


def _unsharded(items):
    from vvdec_tpu_torch.ops.device_pipeline import filter_frame_device
    return [filter_frame_device(cs, planes).resolve() for cs, planes in items]


def _port_mesh(frames, rows):
    from vvdec_tpu_torch.parallel.sharding import Mesh
    if frames is None:
        return Mesh(np.array([torch.device("cpu")] * rows), ("row",))
    from vvdec_tpu_torch.parallel import make_decode_mesh
    return make_decode_mesh(frames * rows, rows=rows,
                            devices=["cpu"] * (frames * rows))


def _jax_mesh(frames, rows):
    import jax
    from jax.sharding import Mesh
    if frames is None:
        return Mesh(np.array(jax.devices()[:rows]), ("row",))
    from vvdec_tpu.parallel import make_decode_mesh
    return make_decode_mesh(frames * rows, rows=rows)


@pytest.mark.parametrize("name,frames,rows", [
    ("sao_deblock", 2, 4), ("alf_ccalf", None, 8)])
def test_sharded_chain_matches_jax(name, frames, rows):
    """filter_frames_sharded == the reference's filter_frames_sharded ==
    the port's unsharded chain, plane for plane."""
    from vvdec_tpu.ops.sharded_chain import filter_frames_sharded as ref_fn
    from vvdec_tpu_torch.ops.sharded_chain import filter_frames_sharded
    port, ref = _captured(name)
    out = filter_frames_sharded(port, _port_mesh(frames, rows))
    want = ref_fn(ref, _jax_mesh(frames, rows), axis="row")
    for o, w, u in zip(out, want, _unsharded(port)):
        for a, b, c in zip(o, w, u):
            assert a.device == torch.device("cpu")
            assert np.array_equal(to_numpy(a), np.asarray(b))
            assert np.array_equal(to_numpy(a), c)


@pytest.mark.parametrize("frames,rows", [(2, 2), (2, 1), (None, 4),
                                         (None, 3)])
def test_every_stage_sharded_matches_unsharded(frames, rows):
    """SAO, ALF and CC-ALF all on, pictures with different ALF bank
    counts in one batch: the sharded chain equals the port's unsharded
    chain, the picture's top and bottom rows included (4 and 3 row
    shards pad 96 rows to 256 and 192)."""
    from vvdec_tpu_torch.ops.sharded_chain import filter_frames_sharded
    port, _ = _captured("sao_alf")
    items = port if frames else port[:1]
    out = filter_frames_sharded(items, _port_mesh(frames, rows))
    for o, u in zip(out, _unsharded(items)):
        for a, b in zip(o, u):
            assert np.array_equal(to_numpy(a), b)


@pytest.mark.parametrize("name,rows", [("sao_deblock", 4), ("alf_ccalf", 8),
                                       ("sao_alf", 2), ("sao_alf", 3)])
def test_layout_and_frame_inputs_match(name, rows):
    """_frame_inputs (the static key and the packed padded grids) and
    _sharded_layout from each package's own parse are identical."""
    import vvdec_tpu.ops.sharded_chain as R
    import vvdec_tpu_torch.ops.sharded_chain as T
    port, ref = _captured(name)
    jmesh = _jax_mesh(None, rows)
    for (cs_p, _), (cs_r, _) in zip(port, ref):
        skey, flat = R._frame_inputs(cs_r, jmesh, "row")
        skey_p, flat_p = T._frame_inputs(cs_p, _port_mesh(None, rows), "row")
        assert skey_p == skey
        assert T._sharded_layout(skey) == R._sharded_layout(skey)
        assert flat_p.dtype == flat.dtype and np.array_equal(flat_p, flat)


@pytest.mark.parametrize("row0,img_h", [(-32, 96), (32, 96), (64, 80),
                                        (-16, 40)])
def test_sao_plane_row0_matches(row0, img_h):
    """_sao_plane with the shard's absolute row offset and the picture
    height == the reference's, every SAO type (EO classes 0-3, BO, off)
    on seeded planes and offsets; without row0 it still trims at the
    plane's own border."""
    import jax.numpy as jnp

    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    rng = np.random.default_rng(img_h - row0)
    h, w, ctu, w_ctu = 64, 48, 16, 3
    n_ctu = (h // ctu) * w_ctu
    plane = rng.integers(0, 1 << BD, size=(h, w)).astype(np.int32)
    typ = rng.choice([0, 1, 2, 3, 4, 255], size=n_ctu).astype(np.int32)
    vals = rng.integers(-7, 8, size=(n_ctu, 6)).astype(np.int32)
    vals[:, 0] = rng.integers(0, 32, size=n_ctu)
    kw = dict(h=h, w=w, ctu_w=ctu, ctu_h=ctu, w_ctu=w_ctu, bd=BD)
    for extra in (dict(row0=row0, img_h=img_h), {}):
        want = np.asarray(R._sao_plane(*(jnp.asarray(a) for a in
                                         (plane, typ, vals)), **kw, **extra))
        got = to_numpy(T._sao_plane(*to_torch((plane, typ, vals), "cpu"),
                                    **kw, **extra))
        assert np.array_equal(got, want)


def test_halo_map_rows_and_frame_parallel_match():
    """halo_map_rows(vertical_121) over 8 row shards and frame_parallel
    over 8 frame shards == the reference's, and == the unsharded
    computation."""
    import jax.numpy as jnp

    import vvdec_tpu.parallel as R
    import vvdec_tpu_torch.parallel as T
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1023, size=(64, 128)).astype(np.int32)
    want = np.asarray(R.halo_map_rows(R.vertical_121, jnp.asarray(x), halo=1,
                                      mesh=R.make_decode_mesh(8, rows=8)))
    mesh = T.make_decode_mesh(8, rows=8, devices=["cpu"] * 8)
    got = T.halo_map_rows(T.vertical_121, torch.from_numpy(x), halo=1,
                          mesh=mesh)
    xp = np.pad(x, ((1, 1), (0, 0)), mode="edge")
    assert np.array_equal(to_numpy(got), want)
    assert np.array_equal(want, (xp[:-2] + 2 * xp[1:-1] + xp[2:] + 2) >> 2)

    b = rng.integers(0, 1023, size=(16, 32, 64)).astype(np.int32)
    want = np.asarray(R.frame_parallel(
        lambda v: jnp.clip((v * 3 + 2) >> 2, 0, 1023), jnp.asarray(b),
        R.make_decode_mesh(8, rows=1)))
    fmesh = T.make_decode_mesh(8, rows=1, devices=["cpu"] * 8)
    got = T.frame_parallel(lambda v: torch.clamp((v * 3 + 2) >> 2, 0, 1023),
                           torch.from_numpy(b), fmesh)
    assert np.array_equal(to_numpy(got), want)
    # nested tuples with host arrays: each band sees its own frames
    got = T.frame_parallel(lambda t: (t[0] + int(t[1].sum()),),
                           (torch.from_numpy(b), np.arange(16)), fmesh)
    sums = np.arange(16).reshape(8, 2).sum(1).repeat(2)
    assert np.array_equal(to_numpy(got[0]), b + sums[:, None, None])


def test_mesh_never_shrinks_or_drops_to_cpu():
    """make_decode_mesh lays out exactly what it is given: it raises when
    asked for more devices than listed or for rows that do not divide
    them, and by default takes the CUDA cards, raising without one."""
    from vvdec_tpu_torch.parallel import make_decode_mesh
    m = make_decode_mesh(devices=["cpu"] * 6)
    assert m.shape == {"frame": 3, "row": 2}
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert make_decode_mesh(3, devices=["cpu"] * 4).shape == \
        {"frame": 3, "row": 1}
    with pytest.raises(ValueError):
        make_decode_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_decode_mesh(6, rows=4, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        m.axis_devices("tile")
    if torch.cuda.is_available():
        default = make_decode_mesh()
        assert all(d.type == "cuda" for d in default.devices.flat)
        with pytest.raises(ValueError):
            make_decode_mesh(devices=[f"cuda:{torch.cuda.device_count()}"])
    else:
        with pytest.raises(RuntimeError):
            make_decode_mesh()


def test_mapped_chain_cache_is_keyed_by_value():
    """Two meshes built apart over equal devices share one cached mapped
    chain; another layout of the same devices gets its own."""
    import vvdec_tpu_torch.ops.sharded_chain as T
    port, _ = _captured("sao_deblock")
    skey = T._frame_inputs(port[0][0], _port_mesh(None, 4), "row")[0]
    a = T._get_mapped(skey, _port_mesh(None, 4), "row")
    assert T._get_mapped(skey, _port_mesh(None, 4), "row") is a
    assert T._get_mapped(skey, _port_mesh(1, 4), "row") is not a
